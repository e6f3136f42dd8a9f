"""Training: the criterion, the optimizer recipe and the fit loop."""

from care_tpu_torch.training.trainer import Trainer

__all__ = ["Trainer"]
