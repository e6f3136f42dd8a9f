"""PyTorch/CUDA port of CARE-TPU: the CARE flagship's serving, training and
main path (data, validation, checkpoints, test), and long-key serving.

Beside the JAX package ``care_tpu`` and held against it by the
``tests/test_torch_*.py`` suite. Imports ``torch``, numpy and the standard
library; ``h5py``, ``pandas``, ``nltk`` and ``tensorboardX`` only inside the
functions that use them, and never JAX or ``care_tpu``.
"""
