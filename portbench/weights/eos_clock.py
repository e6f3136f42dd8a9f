"""Weights whose captions end (``"weights": "eos_clock"``): the
``xavier_normal`` draw, with one hidden coordinate of the decoder made a
clock of the position that only the vocab head's EOS row reads, so that
beams emit EOS after about ``model["eos_clock"]["words"]`` words, give or
take ``spread`` words from video to video, as MSRVTT's captions end after
8 to 12, where random weights end none.

The clock is the last coordinate ``j`` of the decoder's residual stream.
The position table holds ``slope * (p - words)`` there. The word table and
the concept vector's projection write nothing there; no projection that
reads the stream (queries, self-attention keys and values, the FFN's first
layer) reads it; no projection that writes the stream (attention outputs,
the FFN's second layer) writes it; every LayerNorm keeps it with gain 1
and bias 0. So it rides the stream, scaled by the LayerNorms alone, and
the head's EOS row reads it alone, times ``gain``, while no other row
reads it.

The video moves its caption's end through its concepts: the concept
vector's projection writes ``preds @ w`` into the clock, with ``w`` drawn
from the seed and scaled so that, over ``CALIBRATION`` videos drawn as the
generator draws them and scored by the plain reference, it spreads the end
by ``spread`` words; the position table takes off its mean. So every seed
gives the same spread of lengths around ``words``.
"""

import torch

from portbench.reference import care
from portbench.weights import xavier_normal

EOS = 3
CALIBRATION = 256


@torch.no_grad()
def make(shapes: dict, seed: int, device, model: dict) -> dict:
    P = xavier_normal.make(shapes, seed, device, model)
    clock = model["eos_clock"]
    j = model["dim_hidden"] - 1
    e = "decoder.embedding"
    pos = P[e + ".position_embeddings.embedding"]
    p = torch.arange(pos.shape[0], device=pos.device, dtype=pos.dtype)
    P[e + ".word_embeddings"][:, j] = 0
    s2h = P["predictor.SemanticContainer.semantic2hidden.weight"]
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1000003 + 7) % 2**63)
    w = torch.randn(s2h.shape[1], generator=gen, device=device)
    feats = {c: torch.randn((CALIBRATION, model["rows"][c],
                             model["dims"][c]), generator=gen,
                            device=device) for c in model["modality"]}
    with care.precision("f32"):
        _, preds = care.concept_scores(P, model, feats)
    shift = preds @ w
    w *= clock["spread"] * clock["slope"] / shift.std()
    s2h[j] = w
    pos[:, j] = (clock["slope"] * (p - clock["words"])
                 - float((preds @ w).mean()))
    reads, writes, norms = [], [], [e + ".LayerNorm"]
    for l in range(model["num_hidden_layers_decoder"]):
        pre = f"decoder.layer_{l}"
        reads += [f"{pre}.intra_attention.{x}" for x in
                  ("query", "key", "value")]
        reads += [f"{pre}.inter_attention.query", f"{pre}.ffn.dense1"]
        writes += [f"{pre}.intra_attention.dense",
                   f"{pre}.inter_attention.dense", f"{pre}.ffn.dense2"]
        norms += [f"{pre}.{x}.LayerNorm" for x in
                  ("intra_attention", "inter_attention", "ffn")]
    for name in reads:
        P[name + ".weight"][:, j] = 0
    for name in writes:
        P[name + ".weight"][j] = 0
        P[name + ".bias"][j] = 0
    for name in norms:
        P[name + ".weight"][j] = 1
        P[name + ".bias"][j] = 0
    head = P["cls_head.tgt_word_prj.weight"]
    head[:, j] = 0
    head[EOS] = 0
    head[EOS, j] = clock["gain"]
    return P
