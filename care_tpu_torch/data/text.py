"""Caption target builders (pure functions over an explicit RandomState).

Port of ``care_tpu/data/text.py``, the same functions and draws.

Parity targets: reference ``dataloader.py`` —
* ``_padding`` (``:661-675``),
* AR source/target shift (``:559-581``),
* NAR MLM masking with beta-range random masking at train / all-MASK at eval
  (``:583-615``),
* visual-word two-stage targets (``:617-659``),
* visual-tagging / non-stop-word / attribute masks (``:455-522``).
"""

from typing import Dict, List, Optional

import numpy as np

from care_tpu_torch import constants


def padding(seq: Optional[List[int]], max_len: int, add_eos: bool = True,
            padding_token_id: int = constants.PAD):
    if seq is None:
        return None
    res = list(seq)
    if len(res) > max_len:
        res = res[:max_len]
        if add_eos:
            res[-1] = constants.EOS
    else:
        res = res + [padding_token_id] * (max_len - len(res))
    return res


def source_target_mlm(target_core: List[int], max_len: int, mode: str,
                      rng: np.random.RandomState, beta=(0, 1)):
    """NAR MLM canvases; ``target_core`` excludes BOS/EOS."""
    assert len(target_core) == 0 or target_core[0] != constants.BOS
    assert len(target_core) == 0 or target_core[-1] != constants.EOS
    beta_low, beta_high = beta
    min_num_masks = 1

    dec_source = np.asarray(target_core, dtype=np.int64)
    dec_target = np.full(len(dec_source), constants.PAD, dtype=np.int64)

    if mode == "train":
        if min_num_masks >= len(dec_source):
            ind = np.array([], dtype=np.int64)
        else:
            low = max(int(len(dec_source) * beta_low), min_num_masks)
            high = max(int(len(dec_source) * beta_high), min_num_masks)
            if high == low:
                high += 1
            sample_size = rng.randint(low, high)
            ind = rng.choice(len(dec_source), size=sample_size, replace=False)
        if len(ind):
            dec_target[ind] = dec_source[ind]
            dec_source[ind] = constants.MASK
    else:
        dec_target = np.asarray(target_core, dtype=np.int64)
        dec_source = np.where(dec_source != constants.PAD,
                              constants.MASK, dec_source)

    return {
        "dec_source": padding(dec_source.tolist(), max_len, add_eos=False),
        "dec_target": padding(dec_target.tolist(), max_len, add_eos=False),
    }


def source_target_visual_word(target: List[int], pos_tag: List[int],
                              itow: Dict[int, str], itop: Dict[int, str],
                              max_len: int, mode: str, decoding_type: str,
                              demand=("VERB", "NOUN")):
    """Two-stage visual-word targets (reference ``dataloader.py:617-659``)."""
    sent_length = len(target[1:-1])
    visual_tag = constants.VIS
    target_tag = constants.MASK

    if mode != "train":
        return {"dec_source_1": [0], "dec_target_1": [0]}

    assert len(target) == len(pos_tag)
    if decoding_type == "NARFormer":
        dec_source_1 = padding([visual_tag] * sent_length, max_len,
                               add_eos=False)
    else:
        dec_source_1 = padding([visual_tag] * len(target), max_len,
                               add_eos=True)

    ban = {"is", "are", "was", "were", "be"}
    dec_target_1_core = [target_tag] * sent_length
    for i, item in enumerate(pos_tag[1:-1]):
        w = itow[target[i + 1]]
        if itop[item] in demand and w not in ban:
            dec_target_1_core[i] = target[i + 1]

    if decoding_type == "NARFormer":
        dec_target_1 = padding(dec_target_1_core, max_len, add_eos=False)
    else:
        dec_target_1 = padding([target[0]] + dec_target_1_core
                               + [constants.EOS], max_len, add_eos=True)
    return {"dec_source_1": dec_source_1, "dec_target_1": dec_target_1}


def make_source_target(target: List[int], tagging, max_len: int, mode: str,
                       decoding_type: str, rng: np.random.RandomState,
                       beta=(0, 1), visual_word_generation: bool = False,
                       itow=None, itop=None, demand=("VERB", "NOUN")):
    """reference ``dataloader.py:559-581``."""
    if decoding_type == "NARFormer":
        results = source_target_mlm(target[1:-1], max_len, mode, rng, beta)
    else:
        src = padding(target, max_len, add_eos=True)
        results = {"dec_source": src[:-1], "dec_target": src[1:]}

    assert len(results["dec_source"]) == len(results["dec_target"])

    if visual_word_generation:
        results.update(source_target_visual_word(
            target, tagging, itow, itop, max_len, mode, decoding_type,
            demand))

    if "tagging" not in results and tagging is not None:
        results["tagging"] = padding(tagging, max_len, add_eos=True)
    return results


def prepare_tgt_visual_taggings(labels: List[int], pos_tagging: List[int],
                                itow, itop, max_len: int) -> List[int]:
    """Binary visual-word tags aligned with labels
    (reference ``dataloader.py:455-480``)."""
    ban = {"is", "are", "was", "were", "be"}
    visual_word_tag = [0]  # BOS
    for i, item in enumerate(pos_tagging[1:-1]):
        w = itow[labels[i + 1]]
        if itop[item] in ("VERB", "NOUN") and w not in ban:
            visual_word_tag.append(1)
        else:
            visual_word_tag.append(0)
    return padding(visual_word_tag, max_len, add_eos=True)[1:]


def prepare_non_stop_words_mask(labels, itow, stop_words) -> List[int]:
    if isinstance(labels, list) and labels and isinstance(labels[0], list):
        labels = labels[-1]
    mask = []
    for label in labels:
        if label in (constants.PAD, constants.EOS):
            mask.append(0)
        else:
            mask.append(0 if itow[label] in stop_words else 1)
    return mask


def prepare_attribute_mask(labels, attribute_k: Optional[int] = None):
    if isinstance(labels, list) and labels and isinstance(labels[0], list):
        labels = labels[-1]
    start = constants.ATTRIBUTE_START
    end = start + attribute_k if attribute_k else constants.ATTRIBUTE_END
    return [1 if start <= label < end else 0 for label in labels]


def vid2attribute_mappings(ids_set, captions) -> Dict[str, np.ndarray]:
    """Multi-hot concept labels per video
    (reference ``misc/utils_corpora.py:424-441``)."""
    num_attributes = constants.ATTRIBUTE_END - constants.ATTRIBUTE_START
    vid2attr = {}
    for _id in ids_set:
        vid = "video%d" % _id
        attr = np.zeros(num_attributes, dtype=np.float32)
        for cap in captions[vid]:
            assert cap[0] == constants.BOS and cap[-1] == constants.EOS
            for wid in cap[1:-1]:
                if constants.ATTRIBUTE_START <= wid < constants.ATTRIBUTE_END:
                    attr[wid - constants.ATTRIBUTE_START] = 1
        vid2attr[vid] = attr
    return vid2attr
