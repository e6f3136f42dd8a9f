"""The captioner with CLIP ViT-B/32 at its published size as its image
backbone (``with_backbones: clip~ViT-B/32``) against the JAX package, on 1
video of 2 frames of 224 x 224: the checks and bounds of
``tests/test_torch_backbone.py``, which runs them with ``resnet18``.
"""

import pytest

from test_torch_backbone import (check_logits_and_beams,
                                 check_three_train_steps, make_case)
from test_torch_backbone_card import two_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def case():
    return make_case("clip~ViT-B/32")


def test_logits_and_beams_match_jax(case):
    check_logits_and_beams(case)


def test_three_train_steps_match_jax(case, tmp_path, monkeypatch):
    check_three_train_steps(case, tmp_path, monkeypatch)
