"""The port's ``Criterion`` against ``care_tpu.training.losses.Criterion`` on
the same results dict: total, per-loss dict and every recorder (word
accuracy, perplexity sums, F1@k, mAP), dense and fused. f32 on both sides,
inputs from a numpy seed; tolerance 2e-5 relative + 2e-5 absolute (the
log-softmax and the chunked log-sum-exp sum in different orders)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from care_tpu import constants
from care_tpu.training.losses import Criterion as JaxCriterion
from care_tpu_torch.training.losses import Criterion
from test_torch_support import flagship_small_opt

TOL = dict(rtol=2e-5, atol=2e-5)


def _results(opt, seed, extra_positions=0, B=5):
    rs = np.random.RandomState(seed)
    L, V, H = opt["max_len"] - 1, opt["vocab_size"], opt["dim_hidden"]
    K = opt["attribute_prediction_k"]
    hidden = rs.randn(B, L + extra_positions, H).astype(np.float32)
    kernel = (rs.randn(H, V) * 0.3).astype(np.float32)       # JAX layout
    labels = rs.randint(6, V, (B, L)).astype(np.int32)
    for n in range(B):                                        # ragged lengths
        labels[n, L - n:] = constants.PAD
    preds = rs.rand(B, K).astype(np.float32)
    preds[:, :3] = 0.999            # ties at the clamp, above and below
    preds[:, 3:6] = 0.001
    labels_attr = (rs.rand(B, K + 3) > 0.7).astype(np.float32)
    labels_attr[0] = 0.0            # a sample without positives
    return {"hidden_states": hidden, "kernel": kernel,
            "logits": hidden @ kernel, "labels": labels,
            "preds_attr": preds, "avg_prob_attr": rs.rand(B).astype(np.float32),
            "labels_attr": labels_attr}


def _both(opt, res, fused, with_metrics=True):
    shared = ("labels", "preds_attr", "avg_prob_attr", "labels_attr")
    jres = {k: jnp.asarray(res[k]) for k in shared}
    pres = {k: torch.tensor(res[k]) for k in shared}
    pres["labels"] = pres["labels"].long()
    if fused:
        jres["hidden_states"] = jnp.asarray(res["hidden_states"])
        jres["cls_head_kernel"] = jnp.asarray(res["kernel"])
        pres["hidden_states"] = torch.tensor(res["hidden_states"])
        pres["cls_head_kernel"] = torch.tensor(res["kernel"].T.copy())
    else:
        jres["logits"] = jnp.asarray(res["logits"])
        pres["logits"] = torch.tensor(res["logits"])
    want = JaxCriterion(opt, with_metrics=with_metrics)(jres)
    got = Criterion(opt, with_metrics=with_metrics)(pres)
    return got, want


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("extra_positions", [0, 1])
def test_criterion_matches_jax(fused, label_smoothing, extra_positions):
    opt = dict(flagship_small_opt(), label_smoothing=label_smoothing,
               fused_xent_chunk=32, fused_xent_backend="xla")
    res = _results(opt, 7 + extra_positions, extra_positions)
    (total, losses, metrics), (jt, jl, jm) = _both(opt, res, fused)
    np.testing.assert_allclose(total.item(), float(jt), **TOL)
    assert sorted(losses) == sorted(jl) == ["Lang Loss", "V-Attr"]
    for k in jl:
        np.testing.assert_allclose(losses[k].item(), float(jl[k]), **TOL)
    assert sorted(metrics) == sorted(jm)
    assert {"V_f1_5_sum", "V_f1_30_count", "V_ap_sum", "V_ap_count",
            "word_acc_num0", "xent_sum"} <= set(metrics)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), **TOL)


def test_fused_equals_dense_in_the_port():
    opt = dict(flagship_small_opt(), label_smoothing=0.1, fused_xent_chunk=32)
    res = _results(opt, 11)
    (tf, lf, mf), _ = _both(opt, res, True)
    (td, ld, md), _ = _both(opt, res, False)
    np.testing.assert_allclose(tf.item(), td.item(), **TOL)
    for k in md:
        np.testing.assert_allclose(float(mf[k]), float(md[k]), **TOL)


@pytest.mark.parametrize("use_attr_type,extra", [("prefix", 4), ("pp", 1)])
def test_prefix_positions_are_stripped(use_attr_type, extra):
    opt = dict(flagship_small_opt(), use_attr_type=use_attr_type,
               crits=["lang"])
    res = _results(opt, 13, extra)
    (total, _, metrics), (jt, _, jm) = _both(opt, res, False, False)
    np.testing.assert_allclose(total.item(), float(jt), **TOL)
    np.testing.assert_allclose(float(metrics["word_acc_num0"]),
                               float(jm["word_acc_num0"]), **TOL)


def test_scales_and_sparse_sampling_term():
    opt = dict(flagship_small_opt(), attribute_prediction_sparse_sampling=True,
               language_generation_scale=0.5)
    res = _results(opt, 17)
    crit, jcrit = Criterion(opt), JaxCriterion(opt)
    for c in (crit, jcrit):
        c.set_scales({"attribute": 2.0})
    pres = {k: torch.tensor(v) for k, v in res.items() if k != "kernel"}
    pres["labels"] = pres["labels"].long()
    jres = {k: jnp.asarray(v) for k, v in res.items() if k != "kernel"}
    total, losses, metrics = crit(pres)
    jt, jl, _ = jcrit(jres)
    np.testing.assert_allclose(total.item(), float(jt), **TOL)
    np.testing.assert_allclose(losses["V-Attr"].item(), float(jl["V-Attr"]),
                               **TOL)
    assert not any(k.startswith("V_") for k in metrics)


@pytest.mark.parametrize("crit,extra", [
    ("attn", {}), ("attn", {"use_attr_attn_loss_mask": True,
                            "use_attr_attn_loss_threshold": 0.6}),
    ("gate", {}), ("gate", {"attentive_loss_wise": True})])
def test_auxiliary_crits_match_jax(crit, extra):
    """The ``attn`` and ``gate`` crits, which no shipped configuration
    reaches, on the same injected results: the concept-attention
    probabilities of two layers, gate probabilities of two gated
    sublayers, ragged labels, the attribute and non-stop-word masks."""
    opt = dict(flagship_small_opt(), crits=[crit], **extra)
    rs = np.random.RandomState(7)
    B, L, H, K = 4, 6, 4, 5
    labels = rs.randint(6, 40, (B, L)).astype(np.int32)
    labels[1, 4:] = constants.PAD
    labels[3, 2:] = constants.PAD
    probs = rs.rand(B, H, L, K).astype(np.float32)
    probs[0] *= 0.1                 # masses below the threshold
    res = {"labels": labels,
           "attr_attention_probs": [rs.rand(B, H, L, K).astype(np.float32),
                                    probs],
           "attribute_mask": (rs.rand(B, L) > 0.5).astype(np.float32),
           "non_stop_words_mask": (rs.rand(B, L) > 0.5).astype(np.float32),
           "gate_probs": [rs.uniform(0.05, 0.95, (B, L, 8)).astype(
               np.float32) for _ in range(2)]}

    def conv(x, f):
        return [f(v) for v in x] if isinstance(x, list) else f(x)
    want = JaxCriterion(opt)({k: conv(v, jnp.asarray)
                              for k, v in res.items()})
    got = Criterion(opt)({k: conv(v, torch.tensor) for k, v in res.items()})
    name = "Attn Loss" if crit == "attn" else "Gate Loss"
    assert set(got[1]) == set(want[1]) == {name}
    np.testing.assert_allclose(got[0].item(), float(want[0]), **TOL)
    np.testing.assert_allclose(got[1][name].item(), float(want[1][name]),
                               **TOL)
    assert got[0].item() > 0


@pytest.mark.parametrize("key,value", [("probs", 1.0)])
def test_unported_lang_branches_raise(key, value):
    """The pointer's ``probs`` used to raise; they now replace the softmax
    of the logits, the NLL taken of ``log(probs + 1e-6)``
    (``tests/test_torch_pointer.py`` holds the loss to ``care_tpu``'s)."""
    opt = dict(flagship_small_opt(), crits=["lang"])
    V = opt["vocab_size"]
    labels = torch.full((1, 11), 7, dtype=torch.long)
    res = {"logits": torch.zeros(1, 11, V), "labels": labels,
           key: torch.full((1, 11, V), value / V)}
    total = Criterion(opt)(res)[0]
    np.testing.assert_allclose(total.item(), -11 * np.log(1 / V + 1e-6),
                               rtol=1e-5)
