"""Model ensembles: the merged options of several checkpoints and the
split of a batch's features between them.

Port of ``care_tpu/models/ensemble.py`` (reference ``ModelEnsemble``,
``Wrapper.py:617-714``): the modalities of the members are unioned (a
modality two members share must come from the same feature files), and a
batch read with the union's modalities is split into one feature list per
member before the decode. The per-step averaging of the members'
log-probabilities lives in ``decoding/translator.py``.
"""

from typing import Any, List


class EnsembleSpec:
    """``opt``: the first member's options with the union of the
    modalities (in first-seen order) and each modality's feature files and
    width; ``need_to_split_feats``: whether the members' modalities
    differ."""

    def __init__(self, opts: List[dict]):
        if not opts:
            raise ValueError("an ensemble needs at least one model")
        self.model_modalities = [o["modality"] for o in opts]
        merged = dict(opts[0])
        full = ""
        for o in opts:
            for char in o["modality"]:
                if char in full:
                    # shared modalities must use the same feature files
                    a, b = o.get(f"feats_{char}"), merged.get(f"feats_{char}")
                    if a != b:
                        raise ValueError(
                            f"modality `{char}` reads {a} in one model and "
                            f"{b} in another")
                else:
                    full += char
                    merged[f"feats_{char}"] = o.get(f"feats_{char}")
                    merged[f"dim_{char}"] = o.get(f"dim_{char}")
        merged["modality"] = full
        self.opt = merged
        self.need_to_split_feats = len(set(self.model_modalities)) > 1

    def split_feats(self, feats: List[Any]) -> List[Any]:
        """Features in the union's modality order -> one list per model
        (``feats`` itself when the members share their modalities)."""
        if not self.need_to_split_feats:
            return feats
        union = self.opt["modality"]
        return [[feats[union.index(c)] for c in modality]
                for modality in self.model_modalities]
