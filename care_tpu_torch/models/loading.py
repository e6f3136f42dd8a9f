"""Model loading: a checkpoint of the port -> (models, opt), with the opt
override and the rewrite of data paths to the local data root.

Port of ``care_tpu/models/loading.py:43-131`` (reference
``models/__init__.py``: ``load_model`` with its opt override and
base-data-path rewrite ``:93-152``, the retrieval-database plug-in
``:7-32``). It reads the port's own checkpoints
(``training/checkpoints.py``: the variables under the flax tree's names and
the ``.json`` side-car's opt). Ensembles of several checkpoints, teacher
weight surgery and the vocabulary mapping are not ported yet and raise.
"""

import os
from typing import List, Optional

from care_tpu_torch import constants
from care_tpu_torch.models.common import unsupported
from care_tpu_torch.models.framework import build_captioner
from care_tpu_torch.models.weights import variables_from_jax
from care_tpu_torch.training.checkpoints import load_checkpoint


def replace_paths(opt: dict, base_data_path: Optional[str] = None) -> dict:
    """Rewrite feature/corpus paths to the local data root
    (reference ``models/__init__.py:122-148``)."""
    ori = os.path.dirname(opt["info_corpus"])
    assert os.path.basename(ori) == opt["dataset"], (ori, opt["dataset"])
    ori = os.path.dirname(ori)
    now = base_data_path if base_data_path is not None \
        else constants.BASE_DATA_PATH

    def _replace(item):
        if isinstance(item, (list, tuple)):
            return [_replace(x) for x in item]
        assert isinstance(item, str)
        return item.replace(ori, now)

    for key in ["feats_a", "feats_m", "feats_i", "feats_o", "feats_t",
                "feats_r", "reference", "info_corpus"]:
        if key in opt and opt[key]:
            opt[key] = _replace(opt[key])
    return opt


def modify_opt_if_necessary(opt: dict, retrieval_datasets: List[str] = None,
                            retrieval_db_ratio: float = 100) -> dict:
    """Retrieval-database swap / corruption-ratio plug-in
    (reference ``models/__init__.py:7-32``)."""
    if retrieval_datasets:
        assert opt.get("feats_r") and "unique" in opt["feats_r"]
        d = os.path.dirname(opt["feats_r"])
        if retrieval_datasets == ["MSRVTT"]:
            opt["feats_r"] = os.path.join(d, "CLIP_ViT-B-32_unique.hdf5")
        else:
            opt["feats_r"] = os.path.join(
                d, "CLIP_ViT-B-32_{}_unique.hdf5".format(
                    "-".join(retrieval_datasets)))
    if retrieval_db_ratio < 100:
        for key in ("feats_r", "feats_t"):
            if opt.get(key):
                v = opt[key]
                if isinstance(v, (list, tuple)):
                    assert len(v) == 1
                    v = v[0]
                opt[key] = v.replace(".hdf5",
                                     "_ratio%.1f.hdf5" % retrieval_db_ratio)
    return opt


def load_model(checkpoint_path, new_opt_used_to_override: dict = None,
               do_replace_paths: bool = True,
               base_data_path: Optional[str] = None,
               return_spec: bool = False, strict: bool = True, device=None):
    """Load one checkpoint of the port.

    Returns (models, opt): ``models`` is a one-element list of the
    ``Captioner`` in eval mode on ``device`` (None = the CUDA card; raises
    without one unless ``"cpu"``), what ``get_translator(opt)`` serves. With
    ``return_spec`` a third value, the ensemble spec, is None. The weights
    load strictly: a missing, unused or misshapen parameter raises.
    """
    paths = (checkpoint_path if isinstance(checkpoint_path, (list, tuple))
             else [checkpoint_path])
    if len(paths) > 1:
        raise unsupported("ensembles of several models")
    if not strict:
        raise unsupported("strict", strict)
    variables, opt, _ = load_checkpoint(paths[0])
    if new_opt_used_to_override:
        opt = {**opt, **new_opt_used_to_override}
    if do_replace_paths and opt.get("info_corpus"):
        opt = replace_paths(opt, base_data_path)
    model = build_captioner(opt, device=device)
    variables_from_jax(model, variables)
    models = [model]
    if return_spec:
        return models, opt, None
    return models, opt
