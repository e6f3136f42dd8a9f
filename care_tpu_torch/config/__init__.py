from care_tpu_torch.config.loader import get_opt

__all__ = ["get_opt"]
