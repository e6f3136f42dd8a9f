"""The RNN captioners of the paper grid (``torch_paper_grid.RNN_COMMANDS``:
the eight SALSTM and TopDown lines of ``scripts/exp_versatility_of_CARE.sh``,
the ``VOE`` preset and the ``TAP_RNN`` / ``DAP_RNN`` tasks on SALSTM), built
in both packages at test size and held against each other.

Each case checks that both packages' loaders make the same options, that
the full forward's logits agree within 2e-4 and that beam search (beam 5)
gives identical tokens with scores within 1e-4 (``held_against_jax``);
``test_torch_paper_grid_rnn_train.py`` trains each two steps in both. f32,
dropout off.
"""

import os

import numpy as np
import pytest

from care_tpu.config import get_opt as jax_get_opt
from torch_paper_grid import RNN_COMMANDS, case_ids, held_against_jax, tiny_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("overrides", [c[2] for c in RNN_COMMANDS],
                         ids=case_ids(RNN_COMMANDS))
def test_rnn_command_matches_jax(overrides):
    opt = tiny_opt(overrides)
    assert opt == tiny_opt(overrides, jax_get_opt)
    assert "RNN" in opt["decoder"]
    err, want_h, got_h, want_s, got_s = held_against_jax(opt)
    assert err <= 2e-4, err
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


def test_rnn_grid_covers_the_scripts():
    """Eight script lines (SALSTM and TopDown, Base and CARE, MSVD and
    MSRVTT), each citing a line that runs its method and task, and the
    three presets, each citing its YAML block."""
    assert len(RNN_COMMANDS) == 11
    assert len({c[0] for c in RNN_COMMANDS}) == 11
    for _, where, overrides in RNN_COMMANDS:
        path, line = where.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.readlines()[int(line) - 1]
        if path.endswith(".sh"):
            assert f"--method {overrides['method']} " in text, where
            assert text.rstrip().rstrip('"').endswith(
                f"--task {overrides['task']}"), where
            assert ("msvd" in text) == (overrides["dataset"] == "MSVD")
        else:
            name = (overrides["method"] if path.endswith("methods.yaml")
                    else overrides["task"])
            assert text.startswith(f"{name}:"), where
