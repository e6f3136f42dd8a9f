"""The data pipeline: corpora, datasets, samplers, caption targets, the
batch loader and the device feature bank (port of ``care_tpu/data``)."""

from care_tpu_torch.data.datasets import (JointDataset, TextOnlyDataset,
                                          VideoOnlyDataset)
from care_tpu_torch.data.loader import get_loader

__all__ = ["get_loader", "JointDataset", "VideoOnlyDataset", "TextOnlyDataset"]
