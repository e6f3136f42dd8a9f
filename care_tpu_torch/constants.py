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

PAD_WORD = "<pad>"
UNK_WORD = "<unk>"
BOS_WORD = "<bos>"
EOS_WORD = "<eos>"
MASK_WORD = "<mask>"
VIS_WORD = "<vis>"

SPECIAL_WORDS = [PAD_WORD, UNK_WORD, BOS_WORD, EOS_WORD, MASK_WORD, VIS_WORD]

# vocabulary ids reserved for "attribute" (concept) words: the most frequent
# non-stop-words are sorted first when the vocab is built (attribute-first
# sorting), occupying ids [ATTRIBUTE_START, ATTRIBUTE_END).
ATTRIBUTE_START = 6
ATTRIBUTE_END = 3006

# maximum number of uniformly sampled frames representing one video; used by
# both feature extraction and the frame-id samplers.
N_TOTAL_FRAMES = 60

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
# coarse POS-tag mapping (Penn Treebank tag -> universal-ish coarse tag)
POS_TAG_MAPPING = {}
_content = [
    [["``", "''", ",", "-LRB-", "-RRB-", ".", ":", "HYPH", "NFP"], "PUNCT"],
    [["$", "SYM"], "SYM"],
    [["VB", "VBD", "VBG", "VBN", "VBP", "VBZ", "MD"], "VERB"],
    [["WDT", "WP$", "PRP$", "DT", "PDT"], "DET"],
    [["NN", "NNP", "NNPS", "NNS"], "NOUN"],
    [["WP", "EX", "PRP"], "PRON"],
    [["JJ", "JJR", "JJS", "AFX"], "ADJ"],
    [["ADD", "FW", "GW", "LS", "NIL", "XX"], "X"],
    [["SP", "_SP"], "SPACE"],
    [["RB", "RBR", "RBS", "WRB"], "ADV"],
    [["IN", "RP"], "ADP"],
    [["CC"], "CCONJ"],
    [["CD"], "NUM"],
    [["POS", "TO"], "PART"],
    [["UH"], "INTJ"],
]
for _ks, _v in _content:
    for _k in _ks:
        POS_TAG_MAPPING[_k] = _v

INDEX2CATEGORY = {
    0: "music",
    1: "people",
    2: "gaming",
    3: "sports/actions",
    4: "news/events/politics",
    5: "education",
    6: "tv-shows",
    7: "movie/comedy",
    8: "animation",
    9: "vehicles/autos",
    10: "how-to",
    11: "travel",
    12: "science/technology",
    13: "animals/pets",
    14: "kids/family",
    15: "documentary",
    16: "food/drink",
    17: "cooking",
    18: "beauty/fashion",
    19: "advertisement",
}
