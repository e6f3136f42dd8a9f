"""The beam step's reorder and finished bookkeeping
(``care_tpu_torch/ops/beam_bookkeeping.py``, ``csrc/beam_bookkeeping.cu``).

On the CPU the plain version is held against a per-instance loop written
from the reference ``Beam`` (each new EOS row enters a finished buffer of
capacity ``max(beam, topk)`` in beam order while it has room), on random
states: one instance and 64, beams of 1, 5 and 32, ``topk`` 1 and 7, the
first step and the last, several EOS rows a step, buffers that fill
within the step and buffers already full. The ``gpu`` tests hold the
kernel to the plain version bit for bit on the same states, and a dense
decode on the card to the plain loop's. This file imports neither JAX nor
``care_tpu``, so the ``gpu`` run can collect it.
"""

import sys

import numpy as np
import pytest
import torch

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


def make_state(N, K, topk, t, mode, seed, device="cpu", length=L):
    """(best_scores, best_ids, state) of one step. ``mode``: ``mixed``,
    random EOS rows and counts; ``fills``, one slot left and at least two
    EOS rows where the beam has them; ``full``, no slot left. The top-k's
    scores sit in rows of a wider tensor, as ``top_k`` returns them."""
    rs = np.random.RandomState(seed)
    Fb = max(K, topk)
    new_tok = rs.randint(4, V, (N, K))
    if mode == "mixed":
        new_tok[rs.rand(N, K) < 0.4] = EOS
        count = rs.randint(0, Fb + 1, N)
    else:
        for n in range(N):
            new_tok[n, rs.choice(K, min(K, rs.randint(2, 5)),
                                 replace=False)] = EOS
        count = np.full(N, Fb - 1 if mode == "fills" else Fb)
    prev_k = rs.randint(0, K, (N, K))
    wide = rs.randn(N, 2 * K).astype(np.float32)
    as_t = lambda a, dtype=torch.long: torch.as_tensor(a, dtype=dtype,
                                                      device=device)
    state = dict(
        tokens=as_t(rs.randint(0, V, (N, K, length))),
        scores=as_t(rs.randn(N, K), torch.float32),
        last_tokens=as_t(rs.randint(0, V, (N, K))),
        fin_scores=as_t(rs.randn(N, Fb), torch.float32),
        fin_lengths=as_t(rs.randint(1, length, (N, Fb))),
        fin_tokens=as_t(rs.randint(0, V, (N, Fb, length))),
        fin_count=as_t(count))
    best_scores = as_t(wide, torch.float32)[:, :K]
    return best_scores, as_t(prev_k * V + new_tok), state


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
    best_scores, best_ids, state = make_state(*case, seed=sum(case[:4]))
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
    best_scores, best_ids, state = make_state(*case, seed=11)
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


def _both(case, seed, device, length=L):
    """The kernel's and the plain version's results on one state."""
    best_scores, best_ids, state = make_state(*case, seed=seed,
                                              device=device, length=length)
    plain = {k: v.clone() for k, v in state.items()}
    t = case[3]
    launches = bb.launches
    got = bb.beam_bookkeeping(best_scores, best_ids, V, t, EOS, **state)
    assert bb.launches == launches + 1
    want = bb.beam_bookkeeping_plain(best_scores, best_ids, V, t, EOS,
                                     **plain)
    torch.cuda.synchronize()
    return (got, state), (want, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_equals_plain_on_the_card(cuda_device, case):
    (got, state), (want, plain) = _both(case, 2**31 + sum(case[:4]),
                                        cuda_device)
    assert torch.equal(got, want)
    for name in STATE:
        assert torch.equal(state[name], plain[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("length,t", [(64, 63), (130, 1), (130, 64),
                                      (130, 129)])
def test_kernel_walks_long_histories(cuda_device, length, t):
    """Histories wider than one pass of the kernel's shared memory."""
    (got, state), (want, plain) = _both((5, 5, 7, t, "mixed"), length + t,
                                        cuda_device, length)
    assert torch.equal(got, want)
    for name in STATE:
        assert torch.equal(state[name], plain[name]), name


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    def state(K=5, topk=1, device=cuda_device):
        return make_state(3, K, topk, 1, "mixed", seed=K, device=device)

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
