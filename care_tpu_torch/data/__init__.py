"""The data pipeline: corpora, datasets, samplers, caption targets and the
batch loader (port of ``care_tpu/data``, without the device feature bank)."""

from care_tpu_torch.data.datasets import (JointDataset, TextOnlyDataset,
                                          VideoOnlyDataset)
from care_tpu_torch.data.loader import get_loader

__all__ = ["get_loader", "JointDataset", "VideoOnlyDataset", "TextOnlyDataset"]
