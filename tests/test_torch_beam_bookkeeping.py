"""The beam step's reorder and finished bookkeeping
(``care_tpu_torch/ops/beam_bookkeeping.py``, ``csrc/beam_bookkeeping.cu``).

On the CPU the plain version is held against a per-instance loop written
from the reference ``Beam`` (each new EOS row enters a finished buffer of
capacity ``max(beam, topk)`` in beam order while it has room), on random
states: one instance and 64, beams of 1, 5 and 32, ``topk`` 1 and 7, the
first step and the last, several EOS rows a step, buffers that fill
within the step and buffers already full. The ``gpu`` tests hold the
kernel to the plain version bit for bit on the same states and on the
flagship's serving and latency states, and a dense decode on the card to
the plain loop's; ``torch_card_cases`` makes every state and holds the
check. This file imports neither JAX nor ``care_tpu``, so the ``gpu`` run
can collect it.
"""

import sys

import pytest
import torch
import torch_card_cases as cc

from care_tpu_torch import constants
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.decoding.step_graphs import kernel_counters
from care_tpu_torch.ops import beam_bookkeeping as bb

V, L = 40, 12
EOS = constants.EOS
STATE = ("tokens", "scores", "last_tokens", "fin_scores", "fin_lengths",
         "fin_tokens", "fin_count")
CASES = [(N, K, topk, t, mode) for N in (1, 64) for K in (1, 5, 32)
         for topk in (1, 7) for t in (1, L - 1)
         for mode in ("mixed", "fills", "full")]


def _case_id(case):
    return "N{}-K{}-topk{}-t{}-{}".format(*case)


def reference_step(best_scores, best_ids, t, state):
    """One step instance by instance, as the reference ``Beam.advance``
    does it: the histories reordered, then each EOS row in beam order
    appended to the finished buffer while it has room."""
    out = {k: v.tolist() for k, v in state.items()}
    N, K, _ = state["tokens"].shape
    Fb = state["fin_scores"].shape[1]
    row_idx = []
    for n in range(N):
        old = out["tokens"][n]
        hist = []
        for k in range(K):
            prev_k, tok = divmod(int(best_ids[n, k]), V)
            row = list(old[prev_k])
            row[t] = tok
            hist.append(row)
            out["last_tokens"][n][k] = tok
            out["scores"][n][k] = float(best_scores[n, k])
            row_idx.append(n * K + prev_k)
        out["tokens"][n] = hist
        for k in range(K):
            count = out["fin_count"][n]
            if hist[k][t] == EOS and count < Fb:
                out["fin_scores"][n][count] = float(best_scores[n, k])
                out["fin_lengths"][n][count] = t
                out["fin_tokens"][n][count] = hist[k][1:] + [0]
                out["fin_count"][n] = count + 1
    return out, row_idx


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_follows_the_reference_beam(case):
    best_scores, best_ids, state = cc.bookkeeping_state(
        *case, sum(case[:4]), V, L)
    t = case[3]
    want, want_rows = reference_step(best_scores, best_ids, t, state)
    admits = [min(Fb_left, n_eos) for Fb_left, n_eos in zip(
        (max(case[1], case[2]) - state["fin_count"]).tolist(),
        (best_ids % V == EOS).sum(dim=1).tolist())]
    row_idx = bb.beam_bookkeeping_plain(best_scores, best_ids, V, t, EOS,
                                        **state)
    assert row_idx.tolist() == want_rows
    for name in STATE:
        assert state[name].tolist() == want[name], name
    # the cases reach what they name
    if case[4] == "full":
        assert not any(admits)
    elif case[4] == "fills":
        assert all(a == 1 for a in admits)
        assert (state["fin_count"] == max(case[1], case[2])).all()


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    case = (64, 5, 7, 1, "mixed")
    best_scores, best_ids, state = cc.bookkeeping_state(*case, 11, V, L)
    plain = {k: v.clone() for k, v in state.items()}
    launches = bb.launches
    rows = bb.beam_bookkeeping(best_scores, best_ids, V, 1, EOS, **state)
    want = bb.beam_bookkeeping_plain(best_scores, best_ids, V, 1, EOS,
                                     **plain)
    assert torch.equal(rows, want)
    assert all(torch.equal(state[k], plain[k]) for k in STATE)
    assert bb.launches == launches


def test_the_graphs_count_the_kernel():
    assert (bb, "launches") in kernel_counters()


def test_a_cpu_decode_launches_no_kernel():
    from test_torch_beam_graph import _feats, _model, _opt
    opt = _opt()
    tr = get_translator(opt, device="cpu")
    launches = bb.launches
    tr.translate_batch(_model(opt), _feats(opt, 3, seed=2))
    assert tr.beam_steps > 0
    assert bb.launches == launches


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the flagship's serving (64 instances) and latency (1) states: beam 5,
# topk 1, V 11 000, max_len 30; the first step, a middle one and the last
FLAGSHIP_CASES = [(N, cc.BEAM, cc.TOPK, t, mode) for N in (cc.BATCH, 1)
                  for t in (1, cc.MAX_LEN // 2, cc.MAX_LEN - 1)
                  for mode in ("mixed", "fills", "full")]
CARD_CASES = ([pytest.param(c, V, L, id=_case_id(c)) for c in CASES]
              + [pytest.param(c, cc.V, cc.MAX_LEN,
                              id="flagship-" + _case_id(c))
                 for c in FLAGSHIP_CASES])


@pytest.mark.gpu
@pytest.mark.parametrize("case,vocab,length", CARD_CASES)
def test_kernel_equals_plain_on_the_card(cuda_device, case, vocab, length):
    """The kernel against the plain version bit for bit on this file's
    states and on the flagship's
    (``torch_card_cases.check_bookkeeping``)."""
    cc.check_bookkeeping(case, 2**31 + sum(case[:4]), vocab, length)


@pytest.mark.gpu
@pytest.mark.parametrize("length,t", [(64, 63), (130, 1), (130, 64),
                                      (130, 129)])
def test_kernel_walks_long_histories(cuda_device, length, t):
    """Histories wider than one pass of the kernel's shared memory."""
    cc.check_bookkeeping((5, 5, 7, t, "mixed"), length + t, V, length)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    def state(K=5, topk=1, device=cuda_device):
        return cc.bookkeeping_state(3, K, topk, 1, "mixed", K, V, L,
                                    device)

    best_scores, best_ids, st = state(K=33)
    with pytest.raises(ValueError, match="beam 33"):
        bb.beam_bookkeeping(best_scores, best_ids, V, 1, EOS, **st)
    best_scores, best_ids, st = state()
    with pytest.raises(ValueError, match="is on cpu"):
        bb.beam_bookkeeping(best_scores.cpu(), best_ids, V, 1, EOS, **st)
    with pytest.raises(ValueError, match="tokens must be contiguous"):
        bb.beam_bookkeeping(best_scores, best_ids, V, 1, EOS, **dict(
            st, tokens=st["tokens"].transpose(0, 1).contiguous()
            .transpose(0, 1)))
    with pytest.raises(ValueError, match="along K"):
        bb.beam_bookkeeping(best_scores.t().contiguous().t(), best_ids, V,
                            1, EOS, **st)
    with pytest.raises(TypeError, match="fin_count"):
        bb.beam_bookkeeping(best_scores, best_ids, V, 1, EOS,
                            **dict(st, fin_count=st["fin_count"].int()))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ensemble", "rnn"])
def test_dense_decode_on_the_card_equals_the_plain_loop(cuda_device,
                                                        monkeypatch, kind):
    """A dense decode (no graphs) through the kernel gives the plain
    loop's beams, one launch a beam step."""
    from test_torch_beam_graph import _dense_case, _feats
    opt, model = _dense_case(kind)
    models = model if isinstance(model, list) else [model]
    for m in models:
        m.to(cuda_device)
    batch = _feats(opt, 6, seed=5)
    search = sys.modules["care_tpu_torch.decoding.beam_search"]
    monkeypatch.setattr(search, "beam_bookkeeping",
                        bb.beam_bookkeeping_plain)
    want = get_translator(opt, device=cuda_device).translate_batch(model,
                                                                   batch)
    monkeypatch.undo()
    tr = get_translator(opt, device=cuda_device)
    launches = bb.launches
    got = tr.translate_batch(model, batch)
    assert got == want
    assert bb.launches - launches == tr.beam_steps > 0
