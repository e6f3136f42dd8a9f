"""The RNN captioners on the card (``-m gpu``): an RNN model's beams there
equal the CPU port's. This file imports neither JAX nor ``care_tpu`` (the
card's machine has no flax), so the ``gpu`` run can collect it;
``tests/test_torch_rnn.py`` holds the port to ``care_tpu`` on the CPU.
"""

import numpy as np
import pytest
import torch

from care_tpu_torch.config import get_opt
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner

VERSATILITY_MSRVTT = {"dataset": "MSRVTT", "arch": "base", "feats": "ViT",
                      "modality": "ami", "decoder_modality_flags": "VA",
                      "predictor_modality_flags": "VAT", "vocab_size": 40}


def _opt(method, task):
    """The command's options at the grid's test size
    (``tests/torch_paper_grid.py:tiny_opt``)."""
    opt = get_opt(dict(VERSATILITY_MSRVTT, method=method, task=task),
                  read_vocab=False, resolve_paths=False)
    dim = 4 * opt["num_attention_heads"]
    opt.update(dim_hidden=dim, intermediate_size=2 * dim, n_frames=4,
               max_len=8, attribute_prediction_k=16, use_attr_topk=4,
               retrieval_topk=4, hidden_dropout_prob=0.0,
               encoder_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    for char in "amir":
        if opt.get(f"dim_{char}"):
            opt[f"dim_{char}"] = max(4, opt[f"dim_{char}"] // 64)
    return opt


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("method,task", [
    ("SALSTM", "CARE"), ("TopDown", "CARE"), ("VOE", "Base")])
def test_rnn_translate_on_the_card_equals_the_cpu(cuda_device, method,
                                                  task):
    """Beam search (beam 5) over the same weights and features on the card
    (TF32 off) and on the CPU: identical tokens, scores within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = _opt(method, task)
    rs = np.random.RandomState(32)
    feats = [rs.randn(4, opt["retrieval_topk"] if c == "r" else
                      opt["n_frames"], opt[f"dim_{c}"]).astype(np.float32)
             for c in opt["modality"]]
    out = []
    for device in ("cpu", cuda_device):
        model = build_captioner(opt, device=device, seed=31)
        out.append(get_translator(opt, device=device).translate_batch(
            model, {"feats": feats}))
    (want_h, want_s), (got_h, got_s) = out
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
