"""Model loading: a checkpoint of the port -> (models, opt), with the opt
override and the rewrite of data paths to the local data root, and the
NACF teacher-weight surgery.

Port of ``care_tpu/models/loading.py`` (reference ``models/__init__.py``:
``load_model`` with its opt override and base-data-path rewrite
``:93-152``, the retrieval-database plug-in ``:7-32``, and
``manually_load_pretrained_teacher_model`` ``:155-190``, which copies the
teacher's parameters of matching shape into a fresh student and remaps the
vocabulary rows of the word embeddings and the head through the id
mapping). It reads the port's own checkpoints (``training/checkpoints.py``:
the variables under the flax tree's names and the ``.json`` side-car's
opt) and those ``care_tpu`` saved (flax msgpack of the same tree). Several
checkpoints load as an ensemble (``models/ensemble.py``).
"""

import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from care_tpu_torch import constants
from care_tpu_torch.models.ensemble import EnsembleSpec
from care_tpu_torch.models.framework import build_captioner
from care_tpu_torch.models.weights import (batch_stats_leaves, flat_leaves,
                                           from_flax_layout, jax_leaf_key,
                                           variables_from_jax,
                                           variables_to_jax)
from care_tpu_torch.training.checkpoints import load_checkpoint


def get_vocab_mapping(opt: dict, teacher_opt: dict):
    """Student-vocab-id -> teacher-vocab-id array (reference
    ``Translator.py:321-339``); None when the vocabularies are the same."""
    if teacher_opt is None:
        return None
    with open(opt["info_corpus"], "rb") as f:
        vocab = pickle.load(f)["info"]["itow"]
    with open(teacher_opt["info_corpus"], "rb") as f:
        teacher_vocab = pickle.load(f)["info"]["itow"]
    if vocab == teacher_vocab:
        return None
    teacher_w2i = {v: k for k, v in teacher_vocab.items()}
    mapping = np.zeros(len(vocab), dtype=np.int64)
    for k, v in vocab.items():
        mapping[int(k)] = int(teacher_w2i[v])
    if mapping[constants.PAD] != constants.PAD:
        raise ValueError("the vocabularies disagree on PAD")
    return mapping


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
    """Load one checkpoint of the port, or several (an ensemble).

    Returns (models, opt): ``models`` is the list of the ``Captioner``s in
    eval mode on ``device`` (None = the CUDA card; raises without one
    unless ``"cpu"``), what ``get_translator(opt)`` serves. With several
    paths ``opt`` is the first model's options with the union of the
    modalities (``models/ensemble.py``), and ``return_spec`` returns the
    ``EnsembleSpec`` as a third value, whose ``split_feats`` gives each
    model its own features of a batch read with the union (None for one
    model). With ``strict`` the weights load strictly: a missing, unused
    or misshapen parameter raises; without it a parameter the checkpoint
    lacks keeps its fresh init and a leaf the model does not take is
    dropped, both named (``_restore_into_template``).
    """
    paths = (checkpoint_path if isinstance(checkpoint_path, (list, tuple))
             else [checkpoint_path])
    models, all_opts = [], []
    for path in paths:
        variables, opt, _ = load_checkpoint(path)
        if new_opt_used_to_override:
            opt = {**opt, **new_opt_used_to_override}
        if do_replace_paths and opt.get("info_corpus"):
            opt = replace_paths(opt, base_data_path)
        model = build_captioner(opt, device=device)
        if not strict:
            variables = _restore_into_template(model, opt, variables,
                                               strict=False)
        variables_from_jax(model, variables)
        models.append(model)
        all_opts.append(opt)
    spec, opt = None, all_opts[0]
    if len(all_opts) > 1:
        spec = EnsembleSpec(all_opts)
        opt = {**all_opts[0],
               **{k: v for k, v in spec.opt.items() if v is not None}}
    if return_spec:
        return models, opt, spec
    return models, opt


def init_variables_template(model, opt: dict = None) -> dict:
    """The model's variables as the flax tree (``variables_to_jax``): the
    template a checkpoint is restored into. The port builds its modules
    eagerly, so no synthetic batch is needed (``opt`` is accepted for the
    JAX package's signature)."""
    return variables_to_jax(model)


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = value
    return tree


def _restore_into_template(model, opt, raw_state, strict: bool = True,
                           verbose: bool = True) -> dict:
    """The template's tree with each leaf the checkpoint ``raw_state``
    holds taken from it (shapes must match). ``strict`` raises when the
    checkpoint lacks any leaf of the template (a renamed module or a cut
    checkpoint must not evaluate with fresh weights, reference
    ``models/__init__.py:97``); without it such leaves keep the model's
    own values. Leaves the template lacks are dropped; both are named when
    ``verbose``."""
    flat_t = dict(flat_leaves(init_variables_template(model, opt)))
    flat_r = dict(flat_leaves(raw_state))
    missing = sorted("/".join(k) for k in set(flat_t) - set(flat_r))
    extra = sorted("/".join(k) for k in set(flat_r) - set(flat_t))
    if missing and strict:
        raise KeyError(
            f"checkpoint is missing {len(missing)} parameter(s) present in "
            f"the model: {missing[:10]}{'…' if len(missing) > 10 else ''}")
    if verbose and missing:
        print("- Missing Keys (kept at fresh init):", missing[:10])
    if verbose and extra:
        print("- Extra Keys in the Checkpoint:", extra[:10])
    out = {}
    for k, v in flat_t.items():
        if k in flat_r:
            rv = np.asarray(flat_r[k])
            if rv.shape != v.shape:
                raise ValueError(f"{'/'.join(k)}: checkpoint shape "
                                 f"{rv.shape} != model shape {v.shape}")
            out[k] = rv
        else:
            out[k] = v
    return _unflat(out)


def _student_leaves(model):
    """(flax path, transpose?, port tensor, name) of every parameter and
    BatchNorm running statistic of ``model``."""
    for name, param in model.named_parameters():
        key, transpose = jax_leaf_key(model, name)
        yield ("params",) + key, transpose, param, name
    for key, module, attr in batch_stats_leaves(model):
        yield (("batch_stats",) + key, False, getattr(module, attr),
               ".".join(key))


@torch.no_grad()
def load_teacher_weights_into_student(model, teacher_ckpt_path: str,
                                      vocab_mapping=None,
                                      verbose: bool = True) -> int:
    """NACF teacher init (reference ``models/__init__.py:155-190``): every
    parameter (and BatchNorm statistic) of ``model`` whose flax path the
    teacher's checkpoint holds at the same shape takes the teacher's
    value, in place. A word table or vocab head of another shape takes
    the teacher's rows through ``vocab_mapping`` (student id -> teacher
    id). The port's head weight is ``[V, H]``, so its vocabulary is the
    rows, where the JAX package remaps the columns of its ``[H, V]``
    kernel. Anything else keeps the student's value. Returns the number
    of leaves the teacher filled."""
    raw, _, _ = load_checkpoint(teacher_ckpt_path)
    flat_t = dict(flat_leaves(raw))
    leaves = list(_student_leaves(model))
    if verbose:
        keys = {k for k, _, _, _ in leaves}
        missing = sorted("/".join(k) for k in keys - set(flat_t))
        extra = sorted("/".join(k) for k in set(flat_t) - keys)
        if missing:
            print("- Unexpected Keys:", missing[:10])
        if extra:
            print("- Extra Keys in the Checkpoint:", extra[:10])
    filled = 0
    for key, transpose, tensor, name in leaves:
        if key not in flat_t:
            continue
        value = np.asarray(flat_t[key], dtype=np.float32)
        if transpose:
            value = from_flax_layout(value)
        if value.shape != tuple(tensor.shape):
            if verbose:
                print(f"- Incompatible Shape of `{'/'.join(key)}`: Student "
                      f"{tuple(tensor.shape)}; Teacher {value.shape}")
            if vocab_mapping is None or not (
                    "word_embeddings" in name or "tgt_word_prj" in name):
                continue
            value = value[np.asarray(vocab_mapping)]
            if value.shape != tuple(tensor.shape):
                raise ValueError(f"{name}: the vocabulary-mapped teacher "
                                 f"rows {value.shape} do not fit "
                                 f"{tuple(tensor.shape)}")
        tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))
        filled += 1
    return filled
