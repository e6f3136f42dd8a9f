"""The reference-checkpoint transplant of the port
(``care_tpu_torch/models/transplant.py``) against ``care_tpu``'s.

A reference-layout state dict (``tests/reference_layout.py``: the
reference's key names and torch layouts, seeded noise) is written for each
family ``transplant_reference_state_dict`` dispatches on, at the paper
grid's test size (``torch_paper_grid.tiny_opt``, dropout off, f32):

* its coverage, proven by ``care_tpu``'s transplant: no unmapped key, and
  no NaN left in a NaN-filled template of the JAX model's variables;
* the port's transplant into its own template gives a tree bit-equal to
  ``care_tpu``'s (the same numpy transposes, slices and sums);
* the transplanted JAX model and the port model loaded with
  ``variables_from_jax`` give logits within 2e-4 (the suite's bound);
* ``strip_wrapper_prefix`` with a mean teacher's ``teacher_captioner.*``
  keys, the buffer report, and the same ``NotImplementedError`` for an
  encoder or decoder the transplant does not support.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.models import build_captioner as jax_build_captioner
from care_tpu.models import transplant as jax_transplant
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models import transplant
from care_tpu_torch.models.weights import variables_from_jax, variables_to_jax
from care_tpu_torch.training.trainer import device_batch

from reference_layout import reference_state_dict
from test_torch_support import synthetic_batch
from torch_paper_grid import tiny_opt

MSRVTT = {"dataset": "MSRVTT", "feats": "ViT"}
CARE_FLAGS = {"decoder_modality_flags": "VA", "predictor_modality_flags": "VAT"}
# one case per family of transplant_reference_state_dict
FAMILIES = {
    "Transformer-Base": {"method": "Transformer", "task": "Base"},
    "Transformer-CARE": {"method": "Transformer", "task": "CARE",
                         **CARE_FLAGS},
    "ARB-HighWayBN-CARE": {"method": "ARB", "task": "CARE", **CARE_FLAGS},
    "NAB": {"method": "NAB", "task": "Base"},
    "NACF-TwoStage-length-CARE": {"method": "NACF", "task": "CARE",
                                  **CARE_FLAGS},
    "SALSTM": {"method": "SALSTM", "task": "Base"},
    "SALSTM-mha": {"method": "SALSTM", "task": "Base", "rnn_use_mha": True},
    "SALSTM-multilevel": {"method": "SALSTM", "task": "Base",
                          "with_multileval_attention": True},
    "TopDown": {"method": "TopDown", "task": "Base"},
    "TopDown-mha": {"method": "TopDown", "task": "Base",
                    "rnn_use_mha": True},
    "VOE": {"method": "VOE"},
    "PointerGen-biLSTM-CARE": {"method": "PointerGen", "task": "CARE",
                               "has_retrieval_rnn": True, **CARE_FLAGS},
    "ReLUEmbedder": {"method": "Transformer", "task": "Base",
                     "encoder": "ReLUEmbedder"},
    "Identity": {"method": "Transformer", "task": "Base",
                 "encoder": "Identity", "modality": "m"},
    "SingleStreamEmbedder": {"method": "Transformer", "task": "Base",
                             "encoder": "SingleStreamEmbedder",
                             "modality": "ami"},
    "MultiTransformerEncoder": {"method": "Transformer", "task": "Base",
                                "encoder": "MultiTransformerEncoder",
                                "num_hidden_layers_encoder": 2},
    "TransformerEncoder": {"method": "Transformer", "task": "Base",
                           "encoder": "TransformerEncoder",
                           "num_hidden_layers_encoder": 2},
    "CNN1": {"method": "Transformer", "task": "Base", "encoder": "CNN1",
             "modality": "m"},
    "CNN2": {"method": "Transformer", "task": "Base", "encoder": "CNN2",
             "modality": "m"},
    "CNN3": {"method": "Transformer", "task": "Base", "encoder": "CNN3",
             "modality": "m"},
}


def family_opt(name: str) -> dict:
    opt = tiny_opt(dict(MSRVTT, **FAMILIES[name]))
    if opt["encoder"].startswith("CNN"):
        # a square grid of patches a frame (dim_m), 3 layers
        opt.update(dim_m=16, dim_t=16)
    return opt


def family_batch(opt: dict, batch_size: int, seed: int) -> dict:
    batch = synthetic_batch(opt, batch_size, seed)
    if opt["encoder"].startswith("CNN"):
        rs = np.random.RandomState(seed)
        batch["feats"] = [rs.randn(batch_size, opt["n_frames"], 3,
                                   opt["dim_m"]).astype(np.float32)]
    return batch


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _jax_template(opt, batch):
    jmodel = jax_build_captioner(opt)
    key = jax.random.PRNGKey(0)
    variables = jmodel.init({"params": key, "dropout": key,
                             "sampling": key},
                            jax.tree.map(jnp.asarray, batch),
                            deterministic=True)
    return jmodel, jax.tree.map(lambda x: np.array(x, np.float32),
                                dict(variables))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_transplant_matches_care_tpu(name):
    opt = family_opt(name)
    batch = family_batch(opt, 2, seed=3)
    jmodel, jax_template = _jax_template(opt, batch)
    port = build_captioner(opt, device="cpu", seed=0)
    sd = reference_state_dict(opt, variables_to_jax(port), seed=7)

    # coverage: care_tpu's transplant fills every leaf and maps every key
    nan = jax.tree.map(lambda x: np.full_like(x, np.nan), jax_template)
    want, want_report = jax_transplant.transplant_reference_state_dict(
        dict(sd), nan, opt, verbose=False)
    assert want_report["unmapped"] == []
    left = [p for p, v in _leaves(want) if np.isnan(v).any()]
    assert not left, left

    # the port's transplant into its own template: bit-equal trees
    got, report = transplant.transplant_reference_state_dict(
        dict(sd), variables_to_jax(port), opt, verbose=False)
    assert report == want_report
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, value in want_leaves.items():
        assert got_leaves[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got_leaves[path], value, err_msg=path)

    # the loaded models: logits within 2e-4
    variables_from_jax(port, got)
    out = jmodel.apply(want, jax.tree.map(jnp.asarray, batch),
                       deterministic=True)
    key = "probs" if opt.get("pointer") else "logits"
    want_logits = out[key]
    with torch.no_grad():
        got_logits = port(device_batch(batch, "cpu"))[key]
    if isinstance(want_logits, list):
        want_logits, got_logits = want_logits[-1], got_logits[-1]
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=2e-4)


def test_strip_wrapper_prefix_and_buffer_report():
    """A mean-teacher Lightning state dict splits into the student's and
    the teacher's keys as in ``care_tpu``; BatchNorm step counters and
    other buffers are reported as skipped, not unmapped."""
    opt = family_opt("ARB-HighWayBN-CARE")
    port = build_captioner(opt, device="cpu", seed=0)
    template = variables_to_jax(port)
    student = reference_state_dict(opt, template, seed=1)
    teacher = reference_state_dict(opt, template, seed=2)
    student["decoder.embedding.position_ids"] = torch.arange(8)
    lightning = {**{f"captioner.{k}": v for k, v in student.items()},
                 **{f"teacher_captioner.{k}": v for k, v in teacher.items()}}
    for source in ("captioner", "teacher_captioner"):
        got = transplant.strip_wrapper_prefix(lightning, source)
        want = jax_transplant.strip_wrapper_prefix(lightning, source)
        assert [sorted(g) for g in got] == [sorted(w) for w in want]
        picked = student if source == "captioner" else teacher
        assert sorted(got[0]) == sorted(picked)
        assert all(got[0][k] is picked[k] for k in picked)
    # a bare state dict passes through
    assert transplant.strip_wrapper_prefix(student) == (student, {})

    _, report = transplant.transplant_reference_state_dict(
        lightning, variables_to_jax(port), opt, verbose=False)
    _, want_report = jax_transplant.transplant_reference_state_dict(
        lightning, jax.tree.map(np.copy, template), opt, verbose=False)
    assert report == want_report
    assert report["unmapped"] == []
    assert report["buffers_skipped"] == sorted(
        [k for k in student if k.endswith("num_batches_tracked")]
        + ["decoder.embedding.position_ids"])
    assert transplant._BUFFER_PATTERNS == jax_transplant._BUFFER_PATTERNS


@pytest.mark.parametrize("key,value", [("encoder", "GRU"),
                                       ("decoder", "LSTMDecoder")])
def test_unsupported_modules_raise_as_in_care_tpu(key, value):
    opt = dict(family_opt("Transformer-Base"), **{key: value})
    template = variables_to_jax(build_captioner(family_opt(
        "Transformer-Base"), device="cpu", seed=0))
    sd = reference_state_dict(family_opt("Transformer-Base"), template)
    with pytest.raises(NotImplementedError) as want:
        jax_transplant.transplant_reference_state_dict(
            dict(sd), jax.tree.map(np.copy, template), opt, verbose=False)
    with pytest.raises(NotImplementedError) as got:
        transplant.transplant_reference_state_dict(dict(sd), template, opt,
                                                   verbose=False)
    assert str(got.value) == str(want.value) and value in str(got.value)
