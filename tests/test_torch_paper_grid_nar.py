"""The non-autoregressive commands of the paper grid
(``torch_paper_grid.NAR_COMMANDS``: the four NACF lines of
``scripts/exp_versatility_of_CARE.sh`` and the ``NAB`` preset), built in
both packages at test size and held against each other.

Each case checks that both packages' loaders make the same options, that
the full forward's logits agree within 2e-4 for each pass (NACF's
visual-word and masked-language passes, NAB's one) and its length
distribution too, and that NAR decoding with the command's ARB teacher
rescoring the candidates (mask-predict, the preset's template and
iterations; ``masking_decision`` on, so the teacher scores every pass)
gives token-identical hypotheses, log-probs within 2e-4. f32, dropout off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.config import get_opt as jax_get_opt
from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu_torch import constants
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import (NAR_COMMANDS, case_ids, teacher_overrides,
                              tiny_opt)


def _passes(opt, batch):
    """The batch's token ids as the command's decoder takes them: NACF's
    all-``<vis>`` pass and its masked pass, NAB's masked pass."""
    ids = batch["input_ids"].copy()
    ids[0, 4:] = constants.PAD
    ids[1, ::3] = constants.MASK
    if opt["decoder"] != "TwoStageTransformerDecoder":
        return ids
    vis = np.where(ids == constants.PAD, constants.PAD, constants.VIS)
    return [vis.astype(ids.dtype), ids]


@pytest.mark.parametrize("overrides", [c[2] for c in NAR_COMMANDS],
                         ids=case_ids(NAR_COMMANDS))
def test_nar_command_matches_jax(overrides):
    opt = tiny_opt(overrides)
    assert opt == tiny_opt(overrides, jax_get_opt)
    assert opt["decoding_type"] == "NARFormer"
    t_opt = tiny_opt(teacher_overrides(overrides))
    jteacher, t_vars, teacher = flagship_pair(t_opt, seed=7)
    jmodel, variables, port = flagship_pair(opt, seed=3)

    batch = synthetic_batch(opt, 3, seed=4)
    batch["input_ids"] = _passes(opt, batch)
    want = jmodel.apply(variables, jax.tree.map(jnp.asarray, batch),
                        deterministic=True)
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))
    want_logits, got_logits = want["logits"], got["logits"]
    if not isinstance(want_logits, list):
        want_logits, got_logits = [want_logits], [got_logits]
    assert len(got_logits) == len(want_logits) == (
        2 if opt["decoder"] == "TwoStageTransformerDecoder" else 1)
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)
    np.testing.assert_allclose(got["preds_length"].numpy(),
                               np.asarray(want["preds_length"]), rtol=0,
                               atol=2e-4)

    opt = dict(opt, masking_decision=True)
    feats = {"feats": batch["feats"]}
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], feats, teacher=(jteacher, t_vars))
    tr = get_translator(opt, device="cpu")
    got_h, got_s = tr.translate_batch(port, feats, teacher=teacher)
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=2e-4)
    passes = opt["iterations"] + int(opt["use_ct"])
    assert (tr.decoder_passes, tr.teacher_passes) == (passes, passes)
