"""The commands of ``scripts/exp_ablation_main.sh`` (both feature sets of
its loop: the concept-detection modality grid and the guidance ablation),
built in both packages and held against each other.

Each case cuts the command's options to test size
(``torch_paper_grid.tiny_opt``), builds the JAX model and the port with the
same weights, and checks that both packages' loaders make the same options,
that the full forward's logits agree within 2e-4 (f32, dropout off), and
that beam search (beam 5) gives identical tokens with scores within 1e-4.
"""

import numpy as np
import pytest

from care_tpu.config import get_opt as jax_get_opt
from torch_paper_grid import (case_ids, commands_of, held_against_jax,
                              tiny_opt)

CASES = commands_of("exp_ablation_main")


@pytest.mark.parametrize("overrides", [c[2] for c in CASES],
                         ids=case_ids(CASES))
def test_paper_command_matches_jax(overrides):
    opt = tiny_opt(overrides)
    assert opt == tiny_opt(overrides, jax_get_opt)
    err, want_h, got_h, want_s, got_s = held_against_jax(opt)
    assert err <= 2e-4, err
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
