"""PyTorch/CUDA port of CARE-TPU: the CARE flagship's serving, training and
main path (data, the device feature bank, validation, checkpoints, test),
long-key and half-precision serving, the ``translate`` / ``eval_json``
entry points, and the visual front (image backbones inside the captioner,
the patch encoders, and the image and retrieval pretreatment).

Beside the JAX package ``care_tpu`` and held against it by the
``tests/test_torch_*.py`` suite. Imports ``torch``, numpy and the standard
library; ``h5py``, ``pandas``, ``nltk`` and ``tensorboardX`` only inside the
functions that use them, and never JAX or ``care_tpu``.
"""
