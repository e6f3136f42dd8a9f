"""Device resolution for the port's entry points.

The port serves on a CUDA card. Its entry points take ``device=None`` to
mean that card and run on the CPU only when the caller asks for it by
name, as the CPU tests do; with no card and no explicit ``"cpu"`` they
raise instead of carrying on slowly on the host.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; anything else is taken
    as given. Raises ``RuntimeError`` when a CUDA device is asked for
    (explicitly or by default) and none is available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "care_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the host")
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device `{device}`")
    return device
