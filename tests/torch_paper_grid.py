"""The paper's autoregressive Transformer commands as data, each with the
``script:line`` it comes from, and their options at test size.

``COMMANDS`` holds every Transformer command of
``scripts/exp_main_{MSRVTT,MSVD,VATEX}.sh``, ``exp_ablation_GLSG.sh`` and
``exp_ablation_main.sh`` (both ``feats`` of its loop), and the ``ARB``
lines of ``exp_versatility_of_CARE.sh``: the flags each line passes to
``train.py``, as ``get_opt`` overrides. ``tiny_opt`` builds a command's
options with both packages' loader and cuts them to test size: the
hidden width is 4 per attention head of the command's arch, the feature
widths 1/64 of the command's (at least 4), 4 frames, 8 tokens, a
40-word vocabulary, 16 concepts of which 4 are used.

``NAR_COMMANDS`` holds the NACF lines of ``exp_versatility_of_CARE.sh``
and the ``NAB`` preset, ``teacher_overrides`` the ARB command that trains
each one's teacher.

``RNN_COMMANDS`` holds the eight SALSTM and TopDown lines of
``exp_versatility_of_CARE.sh``, the ``VOE`` preset and the ``TAP_RNN`` /
``DAP_RNN`` tasks on SALSTM.

``held_against_jax`` builds a command's model in both packages, carries
the weights (and BatchNorm running statistics) across with
``variables_from_jax``, and returns the largest logit difference of the
full forward and both packages' beams. The ``test_torch_paper_grid*``
files hold every command to it, a share of the scripts each so that each
file stays short on one worker. This module holds no tests.
"""

import json

import numpy as np
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu_torch.config import get_opt
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import flagship_pair, synthetic_batch

GLSG = dict(dataset="MSRVTT", arch="base", method="Transformer",
            task="Concept", feats="ViT", decoder_modality_flags="VA",
            predictor_modality_flags="VAT")
MAIN = dict(dataset="MSRVTT", arch="base", method="Transformer",
            modality="ami", decoder_modality_flags="VA")
VERS_MSVD = dict(dataset="MSVD", arch="base", feats="ViT", modality="mi",
                 decoder_modality_flags="V", predictor_modality_flags="VT")
VERS_MSRVTT = dict(dataset="MSRVTT", arch="base", feats="ViT",
                   modality="ami", decoder_modality_flags="VA",
                   predictor_modality_flags="VAT")


def _main(dataset, arch="base"):
    return dict(dataset=dataset, arch=arch, method="Transformer")


def _care(dataset, feats, dm, pm, arch="base"):
    return dict(_main(dataset, arch), task="CARE", feats=feats,
                decoder_modality_flags=dm, predictor_modality_flags=pm)


# (id, script:line, overrides)
COMMANDS = [
    ("MSRVTT-CARE-IRv2-VA-VAT", "scripts/exp_main_MSRVTT.sh:15",
     _care("MSRVTT", "IRv2", "VA", "VAT")),
    ("MSRVTT-CARE-R101-V-VT", "scripts/exp_main_MSRVTT.sh:18",
     _care("MSRVTT", "R101", "V", "VT")),
    ("MSRVTT-CARE-IRv2-V-VT", "scripts/exp_main_MSRVTT.sh:21",
     _care("MSRVTT", "IRv2", "V", "VT")),
    ("MSRVTT-CARE-IRv2-I-IT", "scripts/exp_main_MSRVTT.sh:24",
     _care("MSRVTT", "IRv2", "I", "IT")),
    ("MSRVTT-CARE-ViT-VA-VAT", "scripts/exp_main_MSRVTT.sh:27",
     _care("MSRVTT", "ViT", "VA", "VAT")),
    ("MSRVTT-CARE-ViTft-I-IT", "scripts/exp_main_MSRVTT.sh:30",
     _care("MSRVTT", "ViT~ft", "I", "IT")),
    ("MSRVTT-CABase-ViT-VA", "scripts/exp_main_MSRVTT.sh:34",
     dict(_main("MSRVTT"), task="CABase", feats="ViT",
          decoder_modality_flags="VA")),
    ("MSRVTT-Base-ViT-ami", "scripts/exp_main_MSRVTT.sh:39",
     dict(_main("MSRVTT"), task="Base", feats="ViT", modality="ami")),
    ("MSVD-CARE-R101-V-VT", "scripts/exp_main_MSVD.sh:15",
     _care("MSVD", "R101", "V", "VT")),
    ("MSVD-CARE-IRv2-V-VT", "scripts/exp_main_MSVD.sh:18",
     _care("MSVD", "IRv2", "V", "VT")),
    ("MSVD-CARE-IRv2-I-IT", "scripts/exp_main_MSVD.sh:21",
     _care("MSVD", "IRv2", "I", "IT")),
    ("MSVD-CARE-ViT-V-VT", "scripts/exp_main_MSVD.sh:24",
     _care("MSVD", "ViT", "V", "VT")),
    ("MSVD-CABase-ViT-V", "scripts/exp_main_MSVD.sh:28",
     dict(_main("MSVD"), task="CABase", feats="ViT",
          decoder_modality_flags="V")),
    ("MSVD-Base-ViT-mi", "scripts/exp_main_MSVD.sh:33",
     dict(_main("MSVD"), task="Base", feats="ViT", modality="mi")),
    ("VATEX-CARE-median-IRv2-V-VT", "scripts/exp_main_VATEX.sh:24",
     _care("VATEX", "IRv2", "V", "VT", arch="median")),
    ("VATEX-CARE-median-ViT-VA-VAT", "scripts/exp_main_VATEX.sh:27",
     _care("VATEX", "ViT", "VA", "VAT", arch="median")),
    ("VATEX-CARE-large-ViT-VA-VAT", "scripts/exp_main_VATEX.sh:30",
     _care("VATEX", "ViT", "VA", "VAT", arch="large")),
    ("VATEX-CABase-median-ViT-VA", "scripts/exp_main_VATEX.sh:34",
     dict(_main("VATEX", "median"), task="CABase", feats="ViT",
          decoder_modality_flags="VA")),
    ("VATEX-Base-median-ViT-ami", "scripts/exp_main_VATEX.sh:38",
     dict(_main("VATEX", "median"), task="Base", feats="ViT",
          modality="ami")),
    ("GLSG-G0L0", "scripts/exp_ablation_GLSG.sh:21",
     dict(GLSG, use_attr_flags="G0L0")),
    ("GLSG-G1L0", "scripts/exp_ablation_GLSG.sh:25",
     dict(GLSG, use_attr_flags="G1L0")),
    ("GLSG-G0L0-SC", "scripts/exp_ablation_GLSG.sh:29",
     dict(GLSG, use_attr_flags="G0L0", compositional_intra=True,
          compositional_ffn=True, scope="SC")),
    ("GLSG-G1Lc-bias", "scripts/exp_ablation_GLSG.sh:33",
     dict(GLSG, use_attr_flags="G1Lc", add_hybrid_attention_bias=True)),
    ("GLSG-G0Lc-SC-bias", "scripts/exp_ablation_GLSG.sh:37",
     dict(GLSG, use_attr_flags="G0Lc", compositional_intra=True,
          compositional_ffn=True, scope="SC",
          add_hybrid_attention_bias=True)),
    ("GLSG-G0Lc-bias", "scripts/exp_ablation_GLSG.sh:41",
     dict(GLSG, use_attr_flags="G0Lc", add_hybrid_attention_bias=True)),
    ("GLSG-G0Lc", "scripts/exp_ablation_GLSG.sh:45",
     dict(GLSG, use_attr_flags="G0Lc")),
    ("GLSG-G0L1-cross2attr", "scripts/exp_ablation_GLSG.sh:49",
     dict(GLSG, use_attr_flags="G0L1", attr_layer_pos="cross2attr",
          scope="cross2semantic")),
    ("GLSG-G0L1-attr2cross", "scripts/exp_ablation_GLSG.sh:51",
     dict(GLSG, use_attr_flags="G0L1", attr_layer_pos="attr2cross",
          scope="semantic2cross")),
    ("GLSG-G0L1-parallel", "scripts/exp_ablation_GLSG.sh:53",
     dict(GLSG, use_attr_flags="G0L1", attr_layer_pos="parallel",
          scope="parallel")),
    ("GLSG-G1Lc", "scripts/exp_ablation_GLSG.sh:57",
     dict(GLSG, use_attr_flags="G1Lc")),
    ("GLSG-G1L1-cross2attr", "scripts/exp_ablation_GLSG.sh:61",
     dict(GLSG, use_attr_flags="G1L1", attr_layer_pos="cross2attr",
          scope="cross2semantic")),
    ("GLSG-G1L1-attr2cross", "scripts/exp_ablation_GLSG.sh:63",
     dict(GLSG, use_attr_flags="G1L1", attr_layer_pos="attr2cross",
          scope="semantic2cross")),
    ("GLSG-G1L1-parallel", "scripts/exp_ablation_GLSG.sh:65",
     dict(GLSG, use_attr_flags="G1L1", attr_layer_pos="parallel",
          scope="parallel")),
]
for _feats in ("R101", "ViT"):
    for _pm in ("VAT", "VT", "VA", "V"):
        COMMANDS.append((
            f"ablation-{_feats}-{_pm}-G1Lc-bias",
            "scripts/exp_ablation_main.sh:20",
            dict(MAIN, task="Concept", feats=_feats,
                 predictor_modality_flags=_pm, use_attr_flags="G1Lc",
                 add_hybrid_attention_bias=True)))
    COMMANDS += [
        (f"ablation-{_feats}-VAT-G0Lc-bias",
         "scripts/exp_ablation_main.sh:25",
         dict(MAIN, task="Concept", feats=_feats,
              predictor_modality_flags="VAT", use_attr_flags="G0Lc",
              add_hybrid_attention_bias=True)),
        (f"ablation-{_feats}-VAT-G1L0", "scripts/exp_ablation_main.sh:28",
         dict(MAIN, task="Concept", feats=_feats,
              predictor_modality_flags="VAT", use_attr_flags="G1L0")),
        (f"ablation-{_feats}-VAT-G0L0", "scripts/exp_ablation_main.sh:31",
         dict(MAIN, task="Concept", feats=_feats,
              predictor_modality_flags="VAT", use_attr_flags="G0L0")),
        (f"ablation-{_feats}-Base", "scripts/exp_ablation_main.sh:35",
         dict(MAIN, task="Base", feats=_feats)),
    ]
COMMANDS += [
    ("ARB-Base-MSVD", "scripts/exp_versatility_of_CARE.sh:48",
     dict(VERS_MSVD, method="ARB", task="Base")),
    ("ARB-Base-MSRVTT", "scripts/exp_versatility_of_CARE.sh:50",
     dict(VERS_MSRVTT, method="ARB", task="Base")),
    ("ARB-CARE-MSVD", "scripts/exp_versatility_of_CARE.sh:58",
     dict(VERS_MSVD, method="ARB", task="CARE")),
    ("ARB-CARE-MSRVTT", "scripts/exp_versatility_of_CARE.sh:60",
     dict(VERS_MSRVTT, method="ARB", task="CARE")),
]

# the non-autoregressive commands: the four NACF lines of
# scripts/exp_versatility_of_CARE.sh, each trained after (and rescored by)
# the ARB command of its dataset and task above, and the NAB preset; held
# by tests/test_torch_paper_grid_nar.py
NAR_COMMANDS = [
    ("NACF-Base-MSVD", "scripts/exp_versatility_of_CARE.sh:52",
     dict(VERS_MSVD, method="NACF", task="Base",
          with_teacher_during_training=True)),
    ("NACF-Base-MSRVTT", "scripts/exp_versatility_of_CARE.sh:54",
     dict(VERS_MSRVTT, method="NACF", task="Base",
          with_teacher_during_training=True)),
    ("NACF-CARE-MSVD", "scripts/exp_versatility_of_CARE.sh:62",
     dict(VERS_MSVD, method="NACF", task="CARE",
          with_teacher_during_training=True)),
    ("NACF-CARE-MSRVTT", "scripts/exp_versatility_of_CARE.sh:64",
     dict(VERS_MSRVTT, method="NACF", task="CARE",
          with_teacher_during_training=True)),
    ("NAB-Base-MSRVTT", "care_tpu/config/yamls/methods.yaml:47",
     dict(VERS_MSRVTT, method="NAB", task="Base")),
]


# the RNN captioners: the SALSTM and TopDown lines of
# scripts/exp_versatility_of_CARE.sh, the VOE preset and the TAP_RNN /
# DAP_RNN tasks on SALSTM; held by tests/test_torch_paper_grid_rnn.py
RNN_COMMANDS = [
    ("SALSTM-Base-MSVD", "scripts/exp_versatility_of_CARE.sh:28",
     dict(VERS_MSVD, method="SALSTM", task="Base")),
    ("SALSTM-Base-MSRVTT", "scripts/exp_versatility_of_CARE.sh:30",
     dict(VERS_MSRVTT, method="SALSTM", task="Base")),
    ("SALSTM-CARE-MSVD", "scripts/exp_versatility_of_CARE.sh:32",
     dict(VERS_MSVD, method="SALSTM", task="CARE")),
    ("SALSTM-CARE-MSRVTT", "scripts/exp_versatility_of_CARE.sh:34",
     dict(VERS_MSRVTT, method="SALSTM", task="CARE")),
    ("TopDown-Base-MSVD", "scripts/exp_versatility_of_CARE.sh:38",
     dict(VERS_MSVD, method="TopDown", task="Base")),
    ("TopDown-Base-MSRVTT", "scripts/exp_versatility_of_CARE.sh:40",
     dict(VERS_MSRVTT, method="TopDown", task="Base")),
    ("TopDown-CARE-MSVD", "scripts/exp_versatility_of_CARE.sh:42",
     dict(VERS_MSVD, method="TopDown", task="CARE")),
    ("TopDown-CARE-MSRVTT", "scripts/exp_versatility_of_CARE.sh:44",
     dict(VERS_MSRVTT, method="TopDown", task="CARE")),
    ("VOE-Base-MSRVTT", "care_tpu/config/yamls/methods.yaml:30",
     dict(VERS_MSRVTT, method="VOE", task="Base")),
    ("SALSTM-TAP_RNN-MSRVTT", "care_tpu/config/yamls/tasks.yaml:85",
     dict(VERS_MSRVTT, method="SALSTM", task="TAP_RNN")),
    ("SALSTM-DAP_RNN-MSRVTT", "care_tpu/config/yamls/tasks.yaml:95",
     dict(VERS_MSRVTT, method="SALSTM", task="DAP_RNN")),
]


def teacher_overrides(overrides: dict) -> dict:
    """The ARB command a NAR command's teacher is trained by."""
    out = {k: v for k, v in overrides.items()
           if k != "with_teacher_during_training"}
    return dict(out, method="ARB")


NO_DROPOUT = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}


def tiny_opt(overrides: dict, loader=get_opt) -> dict:
    """``loader``'s options for ``overrides`` at test size, dropout off."""
    opt = loader(dict(overrides, vocab_size=40), read_vocab=False,
                 resolve_paths=False)
    dim = 4 * opt["num_attention_heads"]
    opt.update(dim_hidden=dim, intermediate_size=2 * dim, n_frames=4,
               max_len=8, attribute_prediction_k=16, use_attr_topk=4,
               retrieval_topk=4, **NO_DROPOUT)
    for char in "amir":
        if opt.get(f"dim_{char}"):
            opt[f"dim_{char}"] = max(4, opt[f"dim_{char}"] // 64)
    return opt


def family(opt: dict) -> str:
    """The model family a command's options build."""
    if opt["encoder"] == "EncoderWithHighWayBN":
        return "ARB"
    if opt.get("compositional_intra") or opt.get("compositional_ffn"):
        return "SC"
    t = opt.get("use_attr_type") or ""
    if opt.get("use_attr") and "att" in t:
        return "L1"
    return "CARE" if opt.get("use_attr") else "Base"


def commands_of(*scripts):
    """The commands of the named scripts (file names without ``.sh``)."""
    return [c for c in COMMANDS
            if c[1].split("/")[1].split(".")[0] in scripts]


def case_ids(commands):
    return [f"{c[0]}@{c[1]}" for c in commands]


_RESULTS = {}


def _key(opt: dict) -> str:
    return json.dumps({k: v for k, v in opt.items()
                       if k not in ("scope", "checkpoint_path")},
                      sort_keys=True, default=str)


def held_against_jax(opt: dict):
    """(max |logit difference|, JAX beams, port beams, JAX scores, port
    scores) of the command's model on a batch of 3; commands whose
    test-size options coincide (up to the scope) share one computation."""
    key = _key(opt)
    if key not in _RESULTS:
        jmodel, variables, port = flagship_pair(opt, seed=3)
        batch = synthetic_batch(opt, 3, seed=4)
        want = jmodel.apply(variables, batch, deterministic=True)["logits"]
        with torch.no_grad():
            got = port(device_batch(batch, "cpu"))["logits"]
        err = float(np.abs(got.numpy() - np.asarray(want)).max())
        feats = {"feats": batch["feats"]}
        want_h, want_s = jax_get_translator(opt).translate_batch(
            [(jmodel, variables)], feats)
        got_h, got_s = get_translator(opt, device="cpu").translate_batch(
            port, feats)
        _RESULTS[key] = (err, want_h, got_h, want_s, got_s)
    return _RESULTS[key]
