"""The port's options and boundaries: ``care_tpu_torch.config.get_opt``
against the JAX package's, its presets against the YAML grid, the import
boundary (the port loads neither JAX nor ``care_tpu``), CUDA as the default
device, and ``NotImplementedError`` for every option the serving slice
does not implement.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from care_tpu.config import get_opt as jax_get_opt
from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu_torch.config import get_opt as port_get_opt
from care_tpu_torch.config.presets import PRESETS
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.training.trainer import device_batch

from helpers import cpu_subprocess_env, tiny_opt
from test_torch_support import (flagship_pair, flagship_small_opt,
                                synthetic_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = {"dataset": "MSRVTT", "method": "Transformer", "task": "CARE",
            "feats": "ViT", "decoder_modality_flags": "VA",
            "predictor_modality_flags": "VAT", "vocab_size": 11000}
TINY = {"dataset": "MSRVTT", "method": "Transformer", "task": "Base",
        "feats": "ViT", "modality": "mi", "vocab_size": 60, "max_len": 10,
        "n_frames": 6, "num_hidden_layers_decoder": 1, "beam_size": 5,
        "topk": 1}


@pytest.mark.parametrize("overrides,kwargs", [
    (FLAGSHIP, dict(read_vocab=False, resolve_paths=False)),
    (FLAGSHIP, {}),
    (TINY, dict(read_vocab=False, resolve_paths=False)),
    ({"method": "NACF", "task": "Base"}, {}),
    ({"task": "DAP_RNN", "arch": "large", "feats": "SwinBERTDense"}, {}),
    ({**FLAGSHIP, "task": "CABase",
      "final_overrides": {"beam_size": 3}}, {}),
])
def test_get_opt_matches_jax(overrides, kwargs):
    assert port_get_opt(overrides, **kwargs) == jax_get_opt(overrides,
                                                            **kwargs)


def test_tiny_opt_matches_jax():
    opt = tiny_opt()
    port = port_get_opt(TINY, read_vocab=False, resolve_paths=False)
    port.setdefault("dim_m", 24)
    port.setdefault("dim_i", 16)
    assert port == opt


@pytest.mark.parametrize("group", sorted(PRESETS))
def test_presets_equal_yaml_grid(group):
    path = os.path.join(REPO, "care_tpu", "config", "yamls", group + ".yaml")
    with open(path) as f:
        assert PRESETS[group] == yaml.safe_load(f)


def test_yaml_grid_has_no_other_files():
    names = {os.path.basename(p)[:-5] for p in glob.glob(
        os.path.join(REPO, "care_tpu", "config", "yamls", "*.yaml"))}
    assert names == set(PRESETS)


def test_port_imports_neither_jax_nor_care_tpu():
    """Import every module of the port, and chip_smoke.py, in a fresh
    interpreter: neither JAX nor the JAX package may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import care_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    care_tpu_torch.__path__, 'care_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'care_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 45, mods\n"
        "for m in ('ops.fused_xent', 'ops.flash_attention',\n"
        "          'training.losses', 'training.optim', 'training.trainer',\n"
        "          'training.checkpoints', 'data.text', 'data.samplers',\n"
        "          'data.corpus', 'data.datasets', 'data.loader',\n"
        "          'data.feature_bank', 'models.loading',\n"
        "          'metrics.tokenizer', 'metrics.bleu', 'metrics.rouge',\n"
        "          'metrics.cider', 'metrics.meteor', 'metrics.cocoscorer',\n"
        "          'native', 'utils.logger', 'config.cli', 'train',\n"
        "          'translate', 'eval_json', 'models.layers',\n"
        "          'models.encoders', 'models.predictors', 'models.heads',\n"
        "          'models.embeddings', 'models.decoders',\n"
        "          'models.framework', 'models.weights',\n"
        "          'models.pointer', 'models.ensemble',\n"
        "          'models.loading', 'decoding.nar', 'decoding.translator',\n"
        "          'config.loader', 'models.cnn', 'models.backbone',\n"
        "          'pretreatment.clip', 'pretreatment.bpe',\n"
        "          'pretreatment.frames', 'pretreatment.retrieval',\n"
        "          'pretreatment_cli'):\n"
        "    assert 'care_tpu_torch.' + m in mods, m\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=cpu_subprocess_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = flagship_small_opt()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_captioner(opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_translator(opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_captioner(opt, device="cuda")
    model = build_captioner(opt, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert not model.training


UNSUPPORTED = [
    ("fused_head_backend", "xla"), ("compute_dtype_decode", "float16"),
    ("compute_dtype_decode", "fp8"),
]


@pytest.mark.parametrize("key,value", UNSUPPORTED)
def test_unsupported_options_raise(key, value):
    opt = dict(flagship_small_opt(), **{key: value})
    with pytest.raises(NotImplementedError, match=key):
        build_captioner(opt, device="cpu")
        get_translator(opt, device="cpu")


@pytest.mark.parametrize("key,value", [
    ("encoder", "CNN3"), ("encoder", "CNN2"), ("encoder", "CNN1"),
    ("with_backbones", True), ("encoder", "SingleStreamEmbedder")])
def test_visual_front_options_build_and_serve(key, value):
    """The patch encoders and ``with_backbones`` used to raise; each now
    builds and decodes (``with_backbones`` as ResNet-18 on the image
    stream's raw frames; ``tests/test_torch_backbone.py`` and
    ``tests/test_torch_patch_encoders.py`` hold them to ``care_tpu``)."""
    opt = port_get_opt({**TINY, "modality": "m" if key == "encoder"
                        and value != "SingleStreamEmbedder" else "mi",
                        key: value if key == "encoder" else []},
                       read_vocab=False, resolve_paths=False)
    opt.update(dim_m=16, dim_i=512 if key == "with_backbones" else 16,
               n_frames=8)
    rs = np.random.RandomState(1)
    if key == "with_backbones":
        opt["with_backbones"] = ["", "resnet18"]
        feats = [rs.randn(2, 8, 16), rs.randn(2, 8, 32, 32, 3)]
    elif value == "SingleStreamEmbedder":
        feats = [rs.randn(2, 8, 16), rs.randn(2, 8, 16)]
    else:
        feats = [rs.randn(2, 8, 3, 16)]
    feats = [f.astype(np.float32) for f in feats]
    model = build_captioner(opt, device="cpu")
    assert type(model.encoder).__name__ == (
        "MultipleStreams" if key == "with_backbones" else
        value if value == "SingleStreamEmbedder" else "CNNPatchEncoder")
    assert (model.backbone is not None) == (key == "with_backbones")
    hyps, scores = get_translator(opt, device="cpu").translate_batch(
        model, {"feats": feats})
    assert len(hyps) == len(scores) == 2 and all(len(h[0]) for h in hyps)


@pytest.mark.parametrize("key,value", [
    ("pointer", "Pointer"), ("retrieval", True), ("has_retrieval_rnn", True)])
def test_retrieval_options_build_and_serve(key, value):
    """The pointer and the retrieved-caption options used to raise; a
    PointerGen model now builds with each and decodes through the dense
    step (``tests/test_torch_pointer.py`` and
    ``tests/test_torch_paper_grid_pointer.py`` hold them to
    ``care_tpu``)."""
    opt = port_get_opt({**TINY, "method": "PointerGen"}, read_vocab=False,
                       resolve_paths=False)
    opt.update(dim_m=24, dim_i=16, retrieval_topk=3, **{key: value})
    assert opt["pointer"] == "Pointer" and opt["modality"].endswith("t")
    model = build_captioner(opt, device="cpu")
    assert (model.text_embedder.rnn_fwd is not None) == (
        key == "has_retrieval_rnn")
    translator = get_translator(opt, device="cpu")
    assert not translator.fused_head
    hyps, scores = translator.translate_batch(
        model, {"feats": synthetic_batch(opt, 2, seed=1)["feats"]})
    assert len(hyps) == len(scores) == 2 and all(len(h[0]) for h in hyps)


@pytest.mark.parametrize("key,value", [
    ("use_pallas_attention", True), ("RPE", True),
    ("transformer_pre_ln", True)])
def test_options_the_long_key_slice_implements_match_jax(key, value):
    """Options that used to raise: the model builds with each of them set
    and agrees with the JAX package, full forward and beam search."""
    opt = dict(flagship_small_opt(vocab_size=40), **{key: value})
    jmodel, variables, port = flagship_pair(
        opt, seed=5, jax_opt=dict(opt, use_pallas_attention=False))
    batch = synthetic_batch(opt, 2, seed=6)
    want = jmodel.apply(variables, batch, deterministic=True)["logits"]
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    want_h, want_s = jax_get_translator(
        dict(opt, use_pallas_attention=False)).translate_batch(
            [(jmodel, variables)], {"feats": batch["feats"]})
    before = fa.plain_forward_calls
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        port, {"feats": batch["feats"]})
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
    # only the forced switch reaches the flash function at 16 keys
    assert (fa.plain_forward_calls > before) == (key == "use_pallas_attention")


@pytest.mark.parametrize("method", ["NAB", "NACF"])
def test_nar_methods_build_and_serve(method):
    """``decoding_type: NARFormer``, the two-stage decoder and the
    ``length`` crit used to raise; the NAR methods now build (a length
    predictor last in the predictor chain) and decode through the NAR
    translator (``tests/test_torch_nar*.py`` hold them to ``care_tpu``)."""
    opt = port_get_opt({**TINY, "method": method}, read_vocab=False,
                       resolve_paths=False)
    opt.update(dim_m=24, dim_i=16)
    assert opt["decoding_type"] == "NARFormer" and "length" in opt["crits"]
    model = build_captioner(opt, device="cpu")
    assert model.predictor.net_names[-1] == "Predictor_length"
    assert type(model.decoder).__name__ == (
        "TwoStageTransformerDecoder" if method == "NACF"
        else "TransformerDecoder")
    translator = get_translator(opt, device="cpu")
    hyps, scores = translator.translate_batch(
        model, {"feats": synthetic_batch(opt, 2, seed=1)["feats"]})
    assert np.shape(hyps) == np.shape(scores) == (2, 1, opt["max_len"])


@pytest.mark.parametrize("method", ["SALSTM", "TopDown", "VOE"])
def test_rnn_methods_build_and_serve(method):
    """The three RNN decoders and the ``VOE`` encoder used to raise; the
    RNN methods now build and decode through the AR translator off the
    fused head (``tests/test_torch_rnn*.py`` and
    ``tests/test_torch_paper_grid_rnn*.py`` hold them to ``care_tpu``)."""
    opt = port_get_opt({**TINY, "method": method}, read_vocab=False,
                       resolve_paths=False)
    opt.update(dim_m=24, dim_i=16)
    model = build_captioner(opt, device="cpu")
    assert model.is_rnn and type(model.decoder).__name__ == {
        "SALSTM": "SingleLayerRNNDecoder", "VOE": "SingleLayerRNNDecoder",
        "TopDown": "TopDownAttentionRNNDecoder"}[method]
    assert type(model.encoder).__name__ == (
        "VOE" if method == "VOE" else "MultipleStreams")
    translator = get_translator(opt, device="cpu")
    assert not translator.fused_head
    hyps, scores = translator.translate_batch(
        model, {"feats": synthetic_batch(opt, 2, seed=1)["feats"]})
    assert len(hyps) == len(scores) == 2 and all(len(h[0]) for h in hyps)


def test_ensembles_and_fused_batches_raise():
    """Ensembles and fused batches used to raise. An ensemble of a model
    with itself now decodes as the model alone does (its averaged
    log-probabilities are the model's), and fused batches as the batches
    one by one do."""
    opt = flagship_small_opt()
    model = build_captioner(opt, device="cpu")
    translator = get_translator(opt, device="cpu")
    alone = {"feats": synthetic_batch(opt, 2, seed=3)["feats"]}
    got_h, got_s = translator.translate_batch([model, model], alone)
    want_h, want_s = translator.translate_batch(model, alone)
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    batches = [{"feats": synthetic_batch(opt, 2, seed=s)["feats"]}
               for s in (1, 2)]
    assert translator.translate_batches_fused([model], batches) == [
        translator.translate_batch(model, b) for b in batches]


def test_half_precision_decode_builds_and_serves():
    """``compute_dtype_decode: bfloat16`` used to raise; now the
    translator serves a bf16 copy of the model, and the caller's model
    stays f32."""
    opt = dict(flagship_small_opt(), compute_dtype_decode="bfloat16")
    model = build_captioner(opt, device="cpu")
    translator = get_translator(opt, device="cpu")
    hyps, scores = translator.translate_batch(
        model, {"feats": synthetic_batch(opt, 2, seed=3)["feats"]})
    assert len(hyps) == 2 and all(np.isfinite(s[0]) for s in scores)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    served = translator.serving_model(model)
    assert all(p.dtype == torch.bfloat16 for p in served.parameters())
