"""The commands of ``scripts/exp_main_{MSRVTT,MSVD,VATEX}.sh``, built in
both packages and held against each other (``tests/torch_paper_grid.py``
lists every command with its ``script:line``).

Each case cuts the command's options to test size
(``torch_paper_grid.tiny_opt``), builds the JAX model and the port with the
same weights, and checks that both packages' loaders make the same options,
that the full forward's logits agree within 2e-4 (f32, dropout off), and
that beam search (beam 5) gives identical tokens with scores within 1e-4.
"""

import os

import numpy as np
import pytest

from care_tpu.config import get_opt as jax_get_opt
from torch_paper_grid import (COMMANDS, case_ids,
                              commands_of, held_against_jax, tiny_opt)

CASES = commands_of("exp_main_MSRVTT", "exp_main_MSVD", "exp_main_VATEX")


@pytest.mark.parametrize("overrides", [c[2] for c in CASES],
                         ids=case_ids(CASES))
def test_paper_command_matches_jax(overrides):
    opt = tiny_opt(overrides)
    assert opt == tiny_opt(overrides, jax_get_opt)
    err, want_h, got_h, want_s, got_s = held_against_jax(opt)
    assert err <= 2e-4, err
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_grid_covers_the_scripts():
    """53 commands: the 19 of the three main scripts, the 14 of the G-LSG
    ablation, the 16 of the main ablation's two feature sets and the 4 ARB
    lines; every cited line holds its command's flags."""
    assert len(COMMANDS) == 53
    assert len({c[0] for c in COMMANDS}) == 53
    assert [len(commands_of(s)) for s in (
        "exp_main_MSRVTT", "exp_main_MSVD", "exp_main_VATEX",
        "exp_ablation_GLSG", "exp_ablation_main",
        "exp_versatility_of_CARE")] == [8, 6, 5, 14, 16, 4]
    for _, where, overrides in COMMANDS:
        path, line = where.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.readlines()[int(line) - 1]
        assert "--" in text, where
        for flag in ("task", "feats", "use_attr_flags", "attr_layer_pos",
                     "decoder_modality_flags", "predictor_modality_flags",
                     "method"):
            if flag in overrides and f"--{flag} " in text:
                value = text.split(f"--{flag} ")[1].split()[0].strip("\"")
                assert value.startswith("$") or value == overrides[flag], (
                    where, flag)
