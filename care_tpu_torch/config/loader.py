"""Option assembly: defaults -> preset overlays -> derived keys.

The same cascade as the JAX package's ``care_tpu/config/loader.py`` (and
the reference's ``opts.py:260-266`` + ``misc/utils.py:12-59``), read from
``presets.PRESETS`` instead of YAML files:

* overlay order: method -> task -> setup -> feats -> arch, with a task's
  ``weights_from_inherit`` resolved between method and task;
* each entry may recursively ``inherit_from`` one or several siblings;
* the task entry (or an inherited one) may carry a ``scope_format``
  ``[fmt, [key, ...]]`` pair that names the experiment folder;
* feature-file *names* become paths under
  ``<base_data_path>/<dataset>/{feats|retrieval}/``;
* the predictors' argument checks map flag strings to modalities and
  extend ``crits``.
"""

import copy
import os
import pickle

from care_tpu_torch import constants
from care_tpu_torch.config.defaults import default_opt
from care_tpu_torch.config.presets import PRESETS


def _format_scope(opt: dict, format_spec) -> str:
    fmt, names = format_spec
    values = []
    for name in names:
        v = opt.get(name)
        if isinstance(v, list):
            v = "-".join(str(item) for item in v)
        values.append(v)
    return fmt.format(*values)


def load_preset(opt: dict, key, group: str, modify_scope: bool = False,
                name_to_path: bool = False) -> None:
    """Overlay one preset entry (with recursive inheritance) onto ``opt``."""
    if not key:
        return
    data = PRESETS[group]
    if key not in data:
        raise KeyError(f"`{key}` not found in the {group} presets")

    entry = dict(data[key])  # shallow copy; we pop below

    inherit_from = entry.pop("inherit_from", None)
    if inherit_from is not None:
        if not isinstance(inherit_from, list):
            inherit_from = [inherit_from]
        for parent in inherit_from:
            load_preset(opt, parent, group, name_to_path=name_to_path)

    new_scope = key
    format_spec = None
    if modify_scope:
        if "scope_format" in entry:
            format_spec = entry.pop("scope_format")
        elif "scope_format" in opt:
            format_spec = opt.pop("scope_format")
    elif "scope_format" in entry:
        # keep an inherited scope_format around so a child overlay can use it
        opt["scope_format"] = entry.pop("scope_format")

    for k, v in entry.items():
        if name_to_path and "name" in k:
            base = opt.get("base_data_path") or constants.BASE_DATA_PATH
            opt[k.replace("name", "path")] = os.path.join(
                base, opt["dataset"], v)
        else:
            opt[k] = copy.deepcopy(v)

    if modify_scope:
        if format_spec is not None:
            new_scope = _format_scope(opt, format_spec)
        opt["scope"] = ((new_scope + "_" + opt["scope"]) if opt.get("scope")
                        else new_scope)


def check_whether_to_load_weights(opt: dict) -> None:
    """Task-level weight inheritance (reference ``misc/utils.py:62-98``):
    a task preset with ``weights_from_inherit: true`` starts from the
    ``best.ckpt`` of its parent task, whose folder the parent's
    ``scope_format`` names from ``opt`` (the options before the task's own
    overlay). No shipped task sets it."""
    if not opt.get("task"):
        return
    tasks = PRESETS["tasks"]
    entry = tasks.get(opt["task"], {})
    if not entry.get("weights_from_inherit", False):
        return
    if "inherit_from" not in entry:
        raise ValueError(f"task `{opt['task']}` inherits weights but no "
                         f"parent task")

    def get_scope_format(key):
        if isinstance(key, list):
            key = key[0]
        if "scope_format" in tasks[key]:
            return tasks[key]["scope_format"]
        return get_scope_format(tasks[key]["inherit_from"])

    parent = entry["inherit_from"]
    if isinstance(parent, list):
        parent = parent[0]
    opt["load_model_weights_from"] = os.path.join(
        constants.BASE_CHECKPOINT_PATH, opt["dataset"], opt.get("method", ""),
        parent, _format_scope(opt, get_scope_format(entry["inherit_from"])),
        "best.ckpt")


def apply_presets(opt: dict) -> None:
    """Apply the five-level overlay: method, task, setup, feats, arch."""
    load_preset(opt, opt.get("method"), "methods")
    check_whether_to_load_weights(opt)
    load_preset(opt, opt.get("task"), "tasks", modify_scope=True,
                name_to_path=True)
    load_preset(opt, opt.get("setup"), "setups")
    load_preset(opt, opt.get("feats"), "feats")
    load_preset(opt, opt.get("arch"), "archs")
    opt.pop("scope_format", None)


# ---------------------------------------------------------------------------
# predictor-contributed argument checks
# ---------------------------------------------------------------------------

def _retrieval_arch_mapping(opt: dict) -> dict:
    base = opt.get("base_data_path") or constants.BASE_DATA_PATH
    root = os.path.join(base, opt["dataset"], "retrieval")
    return {
        "ViT": (512, os.path.join(root, "CLIP_ViT-B-32_unique.hdf5")),
        "ViT16": (512, os.path.join(root, "CLIP_ViT-B-16_unique.hdf5")),
        "RN101": (512, os.path.join(root, "CLIP_RN101_unique.hdf5")),
        "RN50": (1024, os.path.join(root, "CLIP_RN50_unique.hdf5")),
        "RN50x4": (640, os.path.join(root, "CLIP_RN50x4_unique.hdf5")),
        "RN50x16": (768, os.path.join(root, "CLIP_RN50x16_unique.hdf5")),
    }


def _append_crit(opt: dict, crit: str) -> None:
    crits = opt["crits"]
    if not isinstance(crits, list):
        crits = [crits]
    if crit not in crits:
        crits = crits + [crit]
    opt["crits"] = crits


def check_attribute_args(opt: dict) -> None:
    """Concept-detector arg plumbing (reference ``pred_attribute.py:168-210``)."""
    if opt.get("attribute_prediction"):
        _append_crit(opt, "attribute")

    arch_mapping = _retrieval_arch_mapping(opt)

    if opt.get("retrieval"):
        if opt.get("pointer") is None:
            raise ValueError("retrieval-based methods require a pointer network")
        opt["modality"] = opt["modality"] + "t"
        opt["dim_t"], opt["feats_t"] = arch_mapping[opt["retrieval_arch"]]

    if opt.get("attribute_prediction"):
        if not any(k in (opt.get("task") or "") for k in ["VAP", "TAP", "DAP"]):
            if not (opt.get("decoder_modality_flags")
                    and opt.get("predictor_modality_flags")):
                raise ValueError("please specify decoder_modality_flags and "
                                 "predictor_modality_flags instead of modality")
            opt["modality_for_decoder"] = constants.FLAG2MODALITY[
                opt["decoder_modality_flags"]]
            opt["modality_for_predictor"] = constants.FLAG2MODALITY[
                opt["predictor_modality_flags"]]
            union = opt["modality_for_decoder"] + opt["modality_for_predictor"]
            opt["modality"] = "".join(c for c in "amir" if c in union)

        if opt.get("pointer"):
            opt["modality"] = opt["modality"] + "t"

        if "r" in opt["modality"]:
            opt["dim_r"], opt["feats_r"] = arch_mapping[opt["retrieval_arch"]]


def check_semantic_container_args(opt: dict) -> None:
    """G-LSG flag mapping (reference ``pred_attribute.py:308-341``)."""
    if not opt.get("use_attr_type") and opt.get("use_attr_flags") == "G0L0":
        opt["use_attr"] = False

    if opt.get("use_attr"):
        if not opt.get("attribute_prediction"):
            raise ValueError("`attribute_prediction` must be on to use "
                             "predicted concepts")
        if not opt.get("use_attr_type"):
            mapping = {"G0": "", "G1": "emb", "Gp": "pp_emb",
                       "L0": "", "L1": "att", "Lc": "concat"}
            flags = opt["use_attr_flags"]
            if len(flags) != 4:
                raise ValueError(f"use_attr_flags `{flags}` is not G?L?")
            opt["use_attr_type"] = mapping[flags[:2]] + "_" + mapping[flags[2:]]

        to_add = opt.get("predictors_to_be_added", [])
        if not isinstance(to_add, list):
            to_add = [to_add]
        if "SemanticContainer" not in to_add:
            to_add = to_add + ["SemanticContainer"]
        opt["predictors_to_be_added"] = to_add


def check_predictor_args(opt: dict) -> None:
    check_attribute_args(opt)
    check_semantic_container_args(opt)
    if opt.get("length_prediction"):
        _append_crit(opt, "length")


# ---------------------------------------------------------------------------
# top-level assembly
# ---------------------------------------------------------------------------

def get_opt(overrides: dict = None, resolve_paths: bool = True,
            read_vocab: bool = True) -> dict:
    """Assemble the full option dict.

    ``overrides`` play the role of CLI arguments: they are applied before the
    preset overlays, which overwrite them, as argparse values are in the
    reference; ``overrides["final_overrides"]`` is applied after the
    presets. Set ``resolve_paths=False`` / ``read_vocab=False`` for
    synthetic-data runs where no corpus exists on disk (``vocab_size`` must
    then be supplied via ``overrides``).
    """
    opt = default_opt()
    if overrides:
        opt.update(copy.deepcopy(overrides))

    apply_presets(opt)
    final = opt.pop("final_overrides", None)
    if final:
        opt.update(final)

    if opt["dataset"] in ("MSVD", "VATEX") and opt.get("with_category"):
        opt["with_category"] = False

    opt["checkpoint_path"] = os.path.join(
        constants.BASE_CHECKPOINT_PATH, opt["dataset"], opt.get("method") or "",
        opt.get("task") or "", opt.get("scope") or "")

    # NACF teacher path inference (reference ``opts.py:311-324``)
    if (opt.get("decoding_type") == "NARFormer"
            and opt.get("with_teacher_during_training")):
        if not opt.get("teacher_path") and "NACF" in opt["checkpoint_path"]:
            opt["teacher_path"] = os.path.join(
                opt["checkpoint_path"].replace("NACF", "ARB"), "best.ckpt")
        if opt.get("load_teacher_weights") and opt.get("teacher_path"):
            opt["load_model_weights_from"] = opt["teacher_path"]
            opt["load_strictly"] = False

    if resolve_paths:
        base = opt.get("base_data_path") or constants.BASE_DATA_PATH

        def to_dir(mid_path, value):
            if not value:
                return ""
            if isinstance(value, list):
                return [to_dir(mid_path, v) for v in value]
            return os.path.join(base, opt["dataset"], mid_path, value)

        for key in ["feats_a_name", "feats_m_name", "feats_i_name",
                    "feats_o_name", "feats_t_name", "feats_r_name",
                    "reference_name", "info_corpus_name"]:
            mid = ("retrieval" if key == "feats_r_name"
                   else ("feats" if "feats" in key else ""))
            if key == "info_corpus_name" and opt.get("distilled_info_corpus_name"):
                # NAR distillation corpus swap (reference opts.py:337-342)
                if opt["decoding_type"] != "NARFormer":
                    raise ValueError("a distilled corpus needs NARFormer")
                opt["info_corpus"] = to_dir(
                    mid, opt.pop("distilled_info_corpus_name"))
                opt.pop(key, None)
                continue
            opt[key[:-5]] = to_dir(mid, opt.get(key, ""))
            opt.pop(key, None)

        if (read_vocab and opt.get("info_corpus")
                and os.path.exists(opt["info_corpus"])):
            # the corpus pickle is the data-preparation step's own output
            with open(opt["info_corpus"], "rb") as f:
                opt["vocab_size"] = len(pickle.load(f)["info"]["itow"])

    check_predictor_args(opt)
    return opt
