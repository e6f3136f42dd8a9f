"""PyTorch/CUDA port of CARE-TPU: the serving path of the CARE flagship.

Beside the JAX package ``care_tpu`` and held against it by the
``tests/test_torch_*.py`` suite. Imports ``torch``, numpy and the standard
library only.
"""
