"""The judge of PointerGen CARE (``"judge": "pointer"``): CARE's
comparisons (``judges/care.py``) on the scores of the copy head, held
against the plain reference ``reference/pointer.py``.

Serving. For each sampled caption the reference encodes the video's float
streams with the others of its batch, embeds its concepts and the video's
retrieved captions, and runs the decoder's full forward over BOS and the
served tokens, then the copy head; a token's score is ``log(probs +
1e-9)``, as the program's decode step gives it. ``score_gap`` and
``rank_gap`` are CARE's on those scores, with its concept-tie variants.

The CPU check (``check_forward``) holds the program's concept scores, the
decoder's inputs (the retrieved captions' embeddings among them), the full
forward's ``probs`` and the KV-cached decode step, given the retrieved
captions enlarged to the beam's rows, against the reference at every
position. The faults: the copy gate forced to 0 (``copy_dropped``), the
retrieved captions enlarged by tiling instead of repeating, so that a row
copies another video's words (``retrieval_tiled``), and CARE's
``stale_cache``.
"""

import importlib

import numpy as np
import torch

from portbench import lookup, program
from portbench.generators import retrieved_captions
from portbench.judges import care as care_judge
from portbench.reference import care
from portbench.reference import pointer as ref

param_shapes = ref.param_shapes
precision = ref.precision

# the retrieved captions of the CPU check, by the cell's generator
CAPTIONS = {"caption_words": [5, 20], "mean_words": 9.3, "zipf": 1.0}


def _encode(P, m, batch, device):
    """The float streams' states and concept probabilities of a batch
    (its host streams in modality order), and its retrieved ids."""
    feats = {c: torch.as_tensor(np.asarray(x), device=device)
             for c, x in zip(m["modality"], batch)}
    ids = feats.pop("t").long()
    states, preds = ref.concept_scores(P, m, feats)
    return states, preds, ids


@torch.no_grad()
def serve_readings(P, m, batches, requests, device, control=None) -> dict:
    """``batches``: pool index -> the batch's host streams; ``requests``:
    (pool index, row, served tokens, served score). The widest
    ``score_gap`` and ``rank_gap`` over the requests; with ``control`` (a
    precision name) also those of the reference in that precision in the
    program's place, on the same tokens."""
    beam, alpha, k = m["beam_size"], m["beam_alpha"], m["use_attr_topk"]
    out = {"score_gap": 0.0, "rank_gap": 0.0}
    if control:
        out.update(control_score_gap=0.0, control_rank_gap=0.0)
    by_batch = {}
    for r in requests:
        by_batch.setdefault(r[0], []).append(r)
    for b, reqs in by_batch.items():
        states, preds, ids = _encode(P, m, batches[b], device)
        if control:
            with precision(control):
                c_states, c_preds, _ = _encode(P, m, batches[b], device)
        for _, row, tokens, score in reqs:
            st = {c: s[row:row + 1] for c, s in states.items()}
            pr, rid = preds[row:row + 1], ids[row:row + 1]
            best = None
            for labels in care_judge.concept_variants(pr, k):
                logp = ref.token_log_probs(P, m, st, pr, labels, rid, tokens)
                gap = abs(score - care_judge._score(logp, tokens, alpha))
                if best is None or gap < best[0]:
                    best = (gap, logp)
            gap, logp = best
            out["score_gap"] = max(out["score_gap"], gap)
            out["rank_gap"] = max(out["rank_gap"],
                                  care_judge._rank_gap(logp, tokens, beam))
            if control:
                cst = {c: s[row:row + 1] for c, s in c_states.items()}
                cpr = c_preds[row:row + 1]
                with precision(control):
                    clogp = ref.token_log_probs(
                        P, m, cst, cpr, care.concept_order(cpr, k), rid,
                        tokens)
                out["control_score_gap"] = max(
                    out["control_score_gap"],
                    abs(care_judge._score(clogp, tokens, alpha)
                        - care_judge._score(logp, tokens, alpha)))
                out["control_rank_gap"] = max(
                    out["control_rank_gap"],
                    care_judge._kth_gap(logp, clogp, beam))
    return out


def inputs(m: dict, videos: int, seed: int) -> tuple:
    """A CPU check's inputs: the float streams (modality char -> tensor)
    and the retrieved ids [videos, R, S] (int64)."""
    feats = care_judge._feats(ref.float_model(m), videos, seed)
    ids = torch.as_tensor(retrieved_captions.retrieved_ids(
        m, CAPTIONS, videos, seed))
    return feats, ids


def model_and_weights(cfg: dict, seed: int):
    """The program's model on the CPU and the weights from ``seed`` it
    holds."""
    m = cfg["model"]
    P = lookup.module("weights", cfg["weights"]).make(
        param_shapes(m), seed, "cpu", m)
    return program.build_model(program.program_opt(cfg), P, "cpu"), P


@torch.no_grad()
def check_forward(cfg: dict, seed: int) -> None:
    """At test size on the CPU (``cfg`` at test widths): the program's
    concept scores and labels, its decoder's inputs, its full forward's
    ``probs``, and its KV-cached decode step at every position (the
    retrieved captions enlarged to the beam's rows, a token sequence a
    row) against the reference's on the weights drawn from ``seed``;
    raises on a mismatch."""
    m = cfg["model"]
    model, P = model_and_weights(cfg, seed)
    B, L, V, beam = 3, m["max_len"], m["vocab_size"], m["beam_size"]
    feats, ret = inputs(m, B, 4)
    enc = model.encoding_phase([ret if c == "t" else feats[c]
                                for c in m["modality"]])
    states, preds = ref.concept_scores(P, m, feats)
    assert torch.equal(preds, enc["preds_attr"])
    labels = care.concept_order(preds, m["use_attr_topk"])
    assert torch.equal(labels, enc["semantic_labels"])
    ref_enc, gsg = care.decoder_inputs(P, m, states, preds, labels)
    dec_in = model.prepare_inputs_for_decoder(enc, {})
    torch.testing.assert_close(ref_enc, dec_in["encoder_hidden_states"],
                               rtol=0, atol=1e-6)
    embs = ref.retrieved_embs(P, m, ret)
    torch.testing.assert_close(embs, dec_in["ret_text_embs"], rtol=0,
                               atol=1e-6)
    assert torch.equal(dec_in["ret_input_ids"], ret)

    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(6, V, (B, L), generator=g)
    ids[:, 0] = care.BOS
    got = model.decoding_phase(ids, dec_in)["probs"]
    hidden = care.decode(P, m, ids, ref_enc, gsg)
    logits = care.linear(hidden, P["cls_head.tgt_word_prj.weight"])
    want = ref.copy_probs(P, m, hidden, logits, embs, ret)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    # the KV-cached step: row n * beam + k belongs to video n
    video = torch.arange(B * beam) // beam
    tokens = torch.randint(6, V, (B * beam, L), generator=g)
    tokens[:, 0] = care.BOS
    want = ref.log_probs(P, m, care.decode(P, m, tokens, ref_enc[video],
                                           gsg[video]),
                         embs[video], ret[video])
    state = model.init_decode_state(dec_in, L, beam)
    step_in = {k: dec_in[k].repeat_interleave(beam, dim=0)
               for k in ("ret_text_embs", "ret_input_ids")}
    for t in range(L):
        out, state, is_prob = model.decode_step(tokens[:, t], t, state,
                                                step_in)
        assert is_prob
        torch.testing.assert_close(out, want[:, t], rtol=1e-5, atol=1e-5)


def _copy_dropped(driver, setattr):
    """The copy gate forced to 0: the generator's mass alone."""
    setattr(driver.model.pointer, "copy_scale", 0.0)


def _retrieval_tiled(driver, setattr):
    """The retrieved captions enlarged to the beam's rows by tiling the
    batch (row n * beam + k takes video (n * beam + k) mod N) instead of
    repeating each video."""
    tr = importlib.import_module("care_tpu_torch.decoding.translator")

    def tiled(tree, beam):
        if isinstance(tree, dict):
            return {k: tiled(v, beam) for k, v in tree.items()}
        return tree.repeat(beam, *[1] * (tree.dim() - 1))
    setattr(tr, "auto_enlarge", tiled)


# each fault this cell's serving can have, planted under a run at test size
FAULTS = {"copy_dropped": _copy_dropped,
          "retrieval_tiled": _retrieval_tiled,
          "stale_cache": care_judge._stale_cache}
