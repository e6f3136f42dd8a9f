"""PointerGen on the card (``-m gpu``): beams there equal the CPU port's,
also those of a CPU decode whose every step projects the retrieved
captions, training repeats bit for bit, and the copy scatter repeats on
ids that repeat. This file imports neither JAX nor ``care_tpu`` (the
card's machine has no flax), so the ``gpu`` run can collect it;
``tests/test_torch_pointer.py`` and ``tests/test_torch_paper_grid_pointer.py``
hold the port to ``care_tpu`` on the CPU.
"""

import numpy as np
import pytest
import torch

from care_tpu_torch import constants
from care_tpu_torch.config import get_opt
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.decoding.beam_search import beam_search
from care_tpu_torch.decoding.translator import _gather_self_kv
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models import pointer as pointer_module
from care_tpu_torch.models.pointer import copy_scatter
from care_tpu_torch.models.weights import params_to_jax
from care_tpu_torch.training import Trainer

VERSATILITY_MSRVTT = {"dataset": "MSRVTT", "arch": "base", "feats": "ViT",
                      "modality": "ami", "decoder_modality_flags": "VA",
                      "predictor_modality_flags": "VAT", "vocab_size": 40}


def _opt(task, dropout=0.0):
    """The PointerGen command's options at the grid's test size
    (``tests/torch_paper_grid.py:tiny_opt``)."""
    opt = get_opt(dict(VERSATILITY_MSRVTT, method="PointerGen", task=task),
                  read_vocab=False, resolve_paths=False)
    dim = 4 * opt["num_attention_heads"]
    opt.update(dim_hidden=dim, intermediate_size=2 * dim, n_frames=4,
               max_len=8, attribute_prediction_k=16, use_attr_topk=4,
               retrieval_topk=4, hidden_dropout_prob=dropout,
               encoder_dropout_prob=dropout,
               attention_probs_dropout_prob=dropout)
    for char in "amir":
        if opt.get(f"dim_{char}"):
            opt[f"dim_{char}"] = max(4, opt[f"dim_{char}"] // 64)
    return opt


def _feats(opt, n, seed):
    """Feature streams and retrieved captions whose ids repeat."""
    rs = np.random.RandomState(seed)
    feats = []
    for c in opt["modality"]:
        if c == "t":
            ids = rs.randint(4, 12, (n, opt["retrieval_topk"],
                                     opt["max_len"]))
            ids[:, :, -2:] = constants.PAD
            feats.append(ids.astype(np.int64))
        else:
            feats.append(rs.randn(n, opt["retrieval_topk"] if c == "r" else
                                  opt["n_frames"],
                                  opt[f"dim_{c}"]).astype(np.float32))
    return feats


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["Base", "CARE"])
def test_pointer_translate_on_the_card_equals_the_cpu(cuda_device, task):
    """Beam search (beam 5) over the same weights and features on the card
    (TF32 off) and on the CPU: identical tokens, scores within 1e-4."""
    opt = _opt(task)
    feats = _feats(opt, 4, seed=32)
    out = []
    for device in ("cpu", cuda_device):
        model = build_captioner(opt, device=device, seed=31)
        out.append(get_translator(opt, device=device).translate_batch(
            model, {"feats": feats}))
    (want_h, want_s), (got_h, got_s) = out
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


@torch.no_grad()
def decode_projecting_every_step(tr, model, batch):
    """``tr.translate_batch(model, batch)`` of one f32 pointer model with
    the retrieved captions' projection left in the loop: every beam step
    hands ``decode_step`` the raw captions enlarged to the beam's rows,
    and the copy head projects them."""
    inputs = model.prepare_inputs_for_decoder(
        model.encoding_phase(tr._feats(batch)), tr._batch_inputs(batch))
    beam = tr.beam_size
    raw = {n: inputs[n].repeat_interleave(beam, dim=0)
           for n in ("ret_text_embs", "ret_input_ids")}

    def step_fn(tokens, position, carry):
        out, carry, is_prob = model.decode_step(tokens, position, carry, raw)
        assert is_prob
        return out.float(), carry
    return tr.collect(beam_search(
        step_fn, model.init_decode_state(inputs, tr.max_len, beam),
        batch_size=inputs["ret_input_ids"].shape[0],
        vocab_size=tr.opt["vocab_size"], gather_carry=_gather_self_kv,
        device=tr.device, beam_size=beam, max_len=tr.max_len,
        beam_alpha=tr.beam_alpha, topk=tr.topk))


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["Base", "CARE"])
def test_hoisted_decode_on_the_card_equals_the_cpu_projecting_each_step(
        cuda_device, task):
    """The card's decode, which projects the retrieved captions once a
    batch, against the CPU's with the projection at every beam step:
    identical tokens, scores within 1e-4."""
    opt = _opt(task)
    batch = {"feats": _feats(opt, 4, seed=33)}
    want_h, want_s = decode_projecting_every_step(
        get_translator(opt, device="cpu"),
        build_captioner(opt, device="cpu", seed=31), batch)
    model = build_captioner(opt, device=cuda_device, seed=31)
    before = pointer_module.kv_launches
    got_h, got_s = get_translator(opt, device=cuda_device).translate_batch(
        model, batch)
    assert pointer_module.kv_launches - before == 1
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def _batches(opt, n_batches, batch_size, seed):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n_batches):
        tokens = rs.randint(6, opt["vocab_size"],
                            (batch_size, opt["max_len"]))
        tokens[:, 0] = constants.BOS
        out.append({"feats": _feats(opt, batch_size, seed + i),
                    "input_ids": tokens[:, :-1], "labels": tokens[:, 1:],
                    "labels_attr": (rs.rand(batch_size, opt[
                        "attribute_prediction_k"]) < 0.2).astype(np.float32)})
    return out


@pytest.mark.gpu
def test_pointer_training_repeats_bit_for_bit(cuda_device, tmp_path):
    """Two runs of 2 epochs of 3 steps, dropout on, from one seed: equal
    parameters, bit for bit."""
    opt = dict(_opt("CARE", dropout=0.3), epochs=2,
               checkpoint_path=str(tmp_path / "exps"))
    batches = _batches(opt, 3, 8, seed=5)
    runs = []
    for _ in range(2):
        tr = Trainer(opt, ListLoader(batches), device=cuda_device)
        tr.init_model()
        tr.fit()
        runs.append(params_to_jax(tr.model))
    flat = [[], []]
    for i, run in enumerate(runs):
        stack = [run]
        while stack:
            node = stack.pop()
            for k in sorted(node):
                if isinstance(node[k], dict):
                    stack.append(node[k])
                else:
                    flat[i].append(node[k])
    assert len(flat[0]) == len(flat[1]) > 0
    for a, b in zip(*flat):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_copy_scatter_repeats_on_the_card(cuda_device):
    """Many repeated ids a row: the result and the gradient repeat bit for
    bit and agree with ``scatter_add``."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    N, S, V = 4096, 30, 11000
    ids = torch.randint(0, 40, (N, S), device=cuda_device, generator=g)
    base = torch.rand(N, V, device=cuda_device, generator=g,
                      requires_grad=True)
    src = torch.rand(N, S, device=cuda_device, generator=g,
                     requires_grad=True)
    cot = torch.randn(N, V, device=cuda_device, generator=g)
    first = copy_scatter(base, ids, src)
    grads = torch.autograd.grad(first, (base, src), cot)
    for _ in range(5):
        again = copy_scatter(base, ids, src)
        assert torch.equal(again, first)
        for a, b in zip(torch.autograd.grad(again, (base, src), cot), grads):
            assert torch.equal(a, b)
    want = base.detach().scatter_add(1, ids, src.detach())
    torch.testing.assert_close(first.detach(), want, rtol=0, atol=1e-6)
