"""The benchmark of the PyTorch and CUDA port, ``care_tpu_torch``."""
