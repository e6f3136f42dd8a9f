"""Vocabulary ids, default paths and modality maps.

The same values as the JAX package's ``care_tpu/constants.py`` (and the
reference's ``config/Constants.py``), so corpora and option dicts carry over.
"""

PAD = 0
UNK = 1
BOS = 2
EOS = 3
MASK = 4
VIS = 5

BASE_CHECKPOINT_PATH = "./exps"
BASE_DATA_PATH = "./data/video_datasets"

# map "decoder/predictor modality flags" to modality-character strings
# a=audio, m=motion, i=image, r=retrieved caption embs, t=retrieved token ids
FLAG2MODALITY = {
    "I": "i",
    "IT": "ir",
    "V": "mi",
    "VA": "ami",
    "VAT": "amir",
    "VT": "mir",
    "A": "a",
    "T": "r",
}
