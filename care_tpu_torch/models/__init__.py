from care_tpu_torch.models.framework import Captioner, build_captioner

__all__ = ["Captioner", "build_captioner"]
