"""The port's encoding phase (``care_tpu_torch/models/encoders.py``,
``predictors.py`` and ``framework.py:Captioner.encoding_phase``) against the
JAX package's on the same randomized weights, at the CARE flagship's test
size: four streams (a, m, i, r), the decoder's view a-m-i, the noisy-OR
concept head over the mean-pooled, channel-concatenated streams, and the
SemanticContainer (top-k concept slots, GSG vector). Tolerance 2e-4, the
JAX suite's logit tolerance.
"""

import numpy as np
import jax
import pytest
import torch

from care_tpu.models import encoders as jenc
from care_tpu.models import predictors as jpred
from care_tpu.models.framework import Captioner as JaxCaptioner
from care_tpu_torch.models import encoders as penc
from care_tpu_torch.models import predictors as ppred
from care_tpu_torch.models.weights import params_from_jax

from test_torch_support import (flagship_pair, flagship_small_opt,
                                randomized, synthetic_feats, tensors,
                                to_numpy)

TOL = 2e-4


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def _init(module, *args, **kwargs):
    key = jax.random.PRNGKey(0)
    variables = module.init({"params": key, "dropout": key}, *args, **kwargs)
    return randomized(to_numpy(variables["params"]), seed=3)


def test_multiple_streams_matches_jax():
    opt = flagship_small_opt()
    feats = synthetic_feats(opt, 3, seed=0)
    jm = jenc.MultipleStreams(opt, "embedder")
    params = _init(jm, feats)
    want = jm.apply({"params": params}, feats)
    pm = params_from_jax(penc.MultipleStreams(
        opt, torch.Generator().manual_seed(0)).eval(), params)
    with torch.no_grad():
        got = pm(tensors(feats))
    assert set(got) == set(want)
    _close(got["encoder_hidden_states"], want["encoder_hidden_states"])
    for g, w in zip(got["mean_encoder_hidden_states"],
                    want["mean_encoder_hidden_states"]):
        _close(g, w)
    view_g, view_w = got["inputs_for_decoder"], want["inputs_for_decoder"]
    _close(view_g["encoder_hidden_states"], view_w["encoder_hidden_states"])
    assert len(view_g["mean_encoder_hidden_states"]) == len(
        opt["modality_for_decoder"])


def test_predictor_attribute_matches_jax():
    opt = flagship_small_opt()
    rs = np.random.RandomState(1)
    means = [rs.randn(3, opt["dim_hidden"]).astype(np.float32)
             for _ in opt["modality"]]
    enc = rs.randn(3, 8, opt["dim_hidden"]).astype(np.float32)
    jm = jpred.PredictorAttribute(opt)
    params = _init(jm, enc, mean_encoder_hidden_states=means)
    want = jm.apply({"params": params}, enc, mean_encoder_hidden_states=means)
    pm = params_from_jax(ppred.PredictorAttribute(
        opt, torch.Generator().manual_seed(0)).eval(), params)
    with torch.no_grad():
        got = pm(torch.as_tensor(enc),
                 mean_encoder_hidden_states=tensors(means))
    _close(got["preds_attr"], want["preds_attr"])
    _close(got["avg_prob_attr"], want["avg_prob_attr"])


def test_semantic_container_tie_order_matches_jax():
    """Concept scores with exact ties, across the top-k border too: the
    slots must follow ``lax.top_k``'s lowest-index-first order."""
    opt = flagship_small_opt()
    k = opt["attribute_prediction_k"]
    rs = np.random.RandomState(2)
    preds = (rs.randint(0, 4, (3, k)) / 4).astype(np.float32)
    jm = jpred.SemanticContainer(opt)
    params = _init(jm, preds_attr=preds)
    want = jm.apply({"params": params}, preds_attr=preds)
    pm = params_from_jax(ppred.SemanticContainer(
        opt, torch.Generator().manual_seed(0)).eval(), params)
    with torch.no_grad():
        got = pm(preds_attr=torch.as_tensor(preds))
    np.testing.assert_array_equal(got["semantic_labels"].numpy(),
                                  np.asarray(want["semantic_labels"]))
    _close(got["semantic_embs"], want["semantic_embs"])
    _close(got["semantic_hidden_states"], want["semantic_hidden_states"])


@pytest.mark.parametrize("batch_size", [1, 3])
def test_captioner_encoding_phase_matches_jax(batch_size):
    opt = flagship_small_opt()
    jmodel, variables, port = flagship_pair(opt)
    feats = synthetic_feats(opt, batch_size, seed=4)
    want = jmodel.apply(variables, feats, method=JaxCaptioner.encoding_phase)
    with torch.no_grad():
        got = port.encoding_phase(tensors(feats))
    for key in ("encoder_hidden_states", "semantic_embs",
                "semantic_hidden_states", "preds_attr"):
        _close(got[key], want[key])
    np.testing.assert_array_equal(got["semantic_labels"].numpy(),
                                  np.asarray(want["semantic_labels"]))
    # the decoder sees a, m, i frames and then the concept slots
    assert got["encoder_hidden_states"].shape[1] == (
        opt["n_frames"] * len(opt["modality_for_decoder"])
        + opt["use_attr_topk"])
