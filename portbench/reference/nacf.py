"""Plain PyTorch reference of NACF CARE served with its ARB CARE teacher:
the non-autoregressive, coarse-to-fine student (highway-BatchNorm
encoder, concept detector, length predictor, a decoder that sees every
word of its canvas), mask-predict decoding from the coarse-grained
template, and the autoregressive teacher's rescoring of the candidates. In
float32, as it serves: no dropout, BatchNorm on its running statistics.

Written from the paper's versatility experiments (Yang et al.,
"Concept-Aware Video Captioning", TIP 2023) and its public implementation
(https://github.com/yangbang18/CARE: ``models/Encoder.py:210-241``,
``models/Predictor/pred_length.py``, ``models/Decoder/Transformer.py``,
``misc/Decoding/na_algorithms.py:146-197``, ``models/Translator.py``). It
imports nothing of the program; the products, LayerNorms, concept slots
and attention sublayers are ``reference/care.py``'s, and it computes under
``precision("f32")``: TF32 off for the products and for cuDNN. Parameters are looked
up by the state-dict names of the program's two ``Captioner``s, the
teacher's under ``TEACHER``.

Departures from the original, each the program's rule as well:

* a length beam whose lengths fall below 4 takes 4 (the program's clamp
  of ``length_beam`` to ``[4, max_len]``), so a candidate may repeat;
* the mask counts ``int(len * (1 - k / T))`` multiply in float32, and a
  refinement masks at least one position;
* among equal probabilities the lower position is masked first, and
  among equal lengths or logits the lower index ranks first;
* the coarse-grained template's canvas is every masked position as
  ``<vis>``, and a position it still predicts as ``<mask>`` has
  probability 0.
"""

import contextlib

import torch

from portbench.reference import care
from portbench.reference.care import (BOS, NEG, PAD, _attention,
                                      decoder_inputs, layer_norm, linear,
                                      log_probs)

MASK, VIS = 4, 5
TEACHER = "teacher."
BN_EPS = 1e-5


@contextlib.contextmanager
def precision(name: str):
    """Compute in ``name`` as ``care.precision`` does, with cuDNN's TF32
    set alike: in ``f32`` TF32 is off for the products and for cuDNN."""
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32
    cudnn.allow_tf32 = name == "tf32"
    try:
        with care.precision(name):
            yield
    finally:
        cudnn.allow_tf32 = old


def _encoder_shapes(m: dict, prefix: str) -> dict:
    H = m["dim_hidden"]
    s = {}
    for c in m["modality"]:
        pre = f"{prefix}encoder.Encoder_{c.upper()}"
        s[pre + ".linear.weight"] = (H, m["dims"][c])
        s[pre + ".linear.bias"] = (H,)
        for w in ("w1", "w2"):
            s[f"{pre}.highway.{w}.weight"] = (H, H)
            s[f"{pre}.highway.{w}.bias"] = (H,)
        for b in ("weight", "bias", "running_mean", "running_var"):
            s[f"{pre}.bn.bn.{b}"] = (H,)
        s[pre + ".bn.bn.num_batches_tracked"] = ()
    return s


def _model_shapes(m: dict, prefix: str, length: bool) -> dict:
    """One model's names: CARE's, its encoder streams highway-BatchNorm
    ones, and with ``length`` the length predictor."""
    s = _encoder_shapes(m, prefix)
    s.update({prefix + k: v for k, v in care.param_shapes(m).items()
              if not k.startswith("encoder.")})
    if length:
        H = m["dim_hidden"]
        pl = prefix + "predictor.Predictor_length"
        s[pl + ".net1.weight"] = (H, H)
        s[pl + ".net1.bias"] = (H,)
        s[pl + ".net2.weight"] = (m["max_len"], H)
        s[pl + ".net2.bias"] = (m["max_len"],)
    return s


def param_shapes(m: dict) -> dict:
    """The student's state-dict names and shapes, then the teacher's under
    ``TEACHER``."""
    return {**_model_shapes(m, "", True),
            **_model_shapes(m, TEACHER, False)}


def split(P: dict) -> tuple:
    """(student's parameters, teacher's parameters), each by its own
    model's names."""
    student = {k: v for k, v in P.items() if not k.startswith(TEACHER)}
    teacher = {k[len(TEACHER):]: v for k, v in P.items()
               if k.startswith(TEACHER)}
    return student, teacher


def encode(P, m, feats):
    """Each stream through Linear, the highway block and BatchNorm on its
    running statistics (``Encoder.py:210-241``), and the concept
    detector's probabilities. ``feats``: modality char -> [B, rows,
    dim]."""
    states = {}
    for c in m["modality"]:
        pre = f"encoder.Encoder_{c.upper()}"
        x = linear(feats[c], P[pre + ".linear.weight"],
                   P[pre + ".linear.bias"])
        hw = pre + ".highway"
        y = torch.tanh(linear(x, P[hw + ".w1.weight"], P[hw + ".w1.bias"]))
        g = torch.sigmoid(linear(x, P[hw + ".w2.weight"],
                                 P[hw + ".w2.bias"]))
        x = g * x + (1 - g) * y
        bn = pre + ".bn.bn"
        states[c] = ((x - P[bn + ".running_mean"])
                     * torch.rsqrt(P[bn + ".running_var"] + BN_EPS)
                     * P[bn + ".weight"] + P[bn + ".bias"])
    # as ``care.concept_scores``: the noisy-OR over one pooled instance
    pooled = torch.cat([states[c].mean(dim=1)
                        for c in m["modality_for_predictor"]], -1)[:, None]
    pa = "predictor.Predictor_attribute.attribute_heads.prj"
    p = torch.sigmoid(linear(pooled, P[pa + ".weight"], P[pa + ".bias"]))
    log_not = torch.log(torch.clamp(1.0 - p, 1e-12, 1.0))
    return states, 1.0 - torch.exp(log_not.sum(dim=1))


def length_log_probs(P, m, states):
    """The length predictor's log-probabilities [B, max_len] of lengths 0
    to ``max_len - 1``, from the mean over every row of the predictor's
    streams."""
    rows = torch.cat([states[c] for c in m["modality_for_predictor"]], 1)
    pl = "predictor.Predictor_length"
    x = torch.relu(linear(rows.mean(dim=1), P[pl + ".net1.weight"],
                          P[pl + ".net1.bias"]))
    out = linear(x, P[pl + ".net2.weight"], P[pl + ".net2.bias"])
    return torch.log_softmax(out, dim=-1)


def decode(P, m, ids, enc, gsg, causal: bool):
    """A decoder's full forward over ``ids`` [R, L] against ``enc`` [R,
    keys, H]: hidden states [R, L, H]. PAD keys are hidden; the student
    (``causal`` False) sees every other word and adds the mean of the
    encoder rows to each word's embedding (``enhance_input`` 2,
    ``decoders.py:185-196``), the teacher (``causal``) sees the words
    before each."""
    eps = m["layer_norm_eps"]
    L = ids.shape[1]
    e = "decoder.embedding"
    x = (P[e + ".word_embeddings"][ids]
         + P[e + ".position_embeddings.embedding"][None, :L])
    if not causal:
        x = x + enc.mean(dim=1, keepdim=True)
    x = layer_norm(x + gsg[:, None], P, e + ".LayerNorm", eps)
    bias = torch.zeros(ids.shape, device=ids.device).masked_fill(
        ids == PAD, NEG)[:, None, None, :]
    if causal:
        future = torch.ones(L, L, dtype=torch.bool,
                            device=ids.device).triu(1)
        bias = bias + torch.zeros(L, L, device=ids.device).masked_fill(
            future, NEG)
    for l in range(m["num_hidden_layers_decoder"]):
        pre = f"decoder.layer_{l}"
        x = _attention(P, m, pre + ".intra_attention", x, x, bias)
        hb = P[pre + ".inter_attention.hybrid_bias"][None, :, None, :]
        x = _attention(P, m, pre + ".inter_attention", x, enc, hb)
        f = pre + ".ffn"
        h = torch.relu(linear(x, P[f + ".dense1.weight"],
                              P[f + ".dense1.bias"]))
        y = linear(h, P[f + ".dense2.weight"], P[f + ".dense2.bias"])
        x = layer_norm(y + x, P, f + ".LayerNorm", eps)
    return x


def teacher_probs(Pt, m, tokens, pad, enc, gsg):
    """The teacher's probability of each token of ``tokens`` [R, L] given
    BOS and the tokens before it; the canvas's PAD positions ``pad``
    1."""
    prev = torch.cat([torch.full_like(tokens[:, :1], BOS), tokens[:, :-1]],
                     dim=1)
    logp = log_probs(Pt, decode(Pt, m, prev, enc, gsg, causal=True))
    p = torch.exp(logp.gather(2, tokens[:, :, None])[:, :, 0])
    return torch.where(pad, 1.0, p)


def length_beam(lp, lbs: int, max_len: int):
    """The ``lbs`` most likely lengths of each video [B, lbs], the lower
    length first among equal scores, below 4 taken as 4."""
    order = torch.sort(-lp, dim=-1, stable=True)[1][:, :lbs]
    return torch.clamp(order, 4, max_len)


def mask_count(length: int, k: int, T: int) -> int:
    """How many positions refinement ``k`` of ``T`` masks in a candidate
    of ``length`` words: ``int(length * (1 - k / T))`` in float32, at
    least one."""
    n = (torch.tensor(float(length), dtype=torch.float32)
         * torch.tensor(1.0 - k / T, dtype=torch.float32))
    return max(int(n), 1)


def _pass(P, m, canvas, pad, enc, gsg):
    """One student pass over ``canvas`` [R, L]: (argmax ids, their
    probabilities), the first canvas's PAD positions ``pad`` kept PAD at
    probability 1."""
    logp = log_probs(P, decode(P, m, canvas, enc, gsg, causal=False))
    best, ids = logp.max(dim=-1)
    return torch.where(pad, PAD, ids), torch.where(pad, 1.0, torch.exp(best))


def mask_predict(P, Pt, m, feats, labels=None):
    """The whole decode of one video (``feats``: modality char -> [1,
    rows, dim]): the length beam, the template pass, ``iterations``
    refinements (``na_algorithms.py:146-197``) and the teacher's
    rescoring. Returns the record the judge reads: each pass's canvas,
    argmax ids and probabilities, each refinement's mask, and the served
    tokens and per-position log-probabilities of the best candidate."""
    lbs, T = m["length_beam_size"], m["iterations"] + 1
    states, preds = encode(P, m, feats)
    if labels is None:
        labels = care.concept_order(preds, m["use_attr_topk"])
    enc, gsg = decoder_inputs(P, m, states, preds, labels)
    lengths = length_beam(length_log_probs(P, m, states), lbs,
                          m["max_len"])[0]
    pos = torch.arange(m["max_len"], device=lengths.device)
    canvas = torch.where(pos[None] < lengths[:, None], MASK, PAD)
    pad = canvas == PAD
    enc, gsg = enc.expand(lbs, -1, -1), gsg.expand(lbs, -1)
    passes, masks = [], []

    vis = torch.where(canvas == MASK, VIS, canvas)
    tokens, probs = _pass(P, m, vis, pad, enc, gsg)
    passes.append((vis, tokens, probs))
    probs = torch.where(tokens == MASK, 0.0, probs)
    for k in range(1, T):
        if k == 1:
            mask = (tokens == MASK) & ~pad
        else:
            mask = torch.zeros_like(canvas, dtype=torch.bool)
            for r in range(lbs):
                n = mask_count(int(lengths[r]), k, T)
                order = torch.sort(probs[r], stable=True)[1]
                mask[r, order[:n]] = True
            mask &= ~pad
        masks.append(mask)
        step_canvas = torch.where(mask, MASK, tokens)
        new, new_p = _pass(P, m, step_canvas, pad, enc, gsg)
        passes.append((step_canvas, new, new_p))
        tokens = torch.where(mask, new, tokens)
        probs = torch.where(mask, new_p, probs)

    t_states, t_preds = encode(Pt, m, feats)
    t_enc, t_gsg = decoder_inputs(Pt, m, t_states, t_preds,
                                   care.concept_order(t_preds,
                                                      m["use_attr_topk"]))
    t = teacher_probs(Pt, m, tokens, pad, t_enc.expand(lbs, -1, -1),
                      t_gsg.expand(lbs, -1))
    lp = torch.log(probs * t + 1e-20)
    score = lp.sum(-1) / lengths.to(torch.float32) ** m["beam_alpha"]
    best = int(score.argmax())
    return {"passes": passes, "masks": masks,
            "tokens": tokens[best].tolist(), "lprobs": lp[best].tolist()}
