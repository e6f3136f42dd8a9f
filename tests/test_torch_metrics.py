"""The port's COCO metrics (``care_tpu_torch.metrics``) against the JAX
package's (``care_tpu.metrics``) on fixed predictions: BLEU, METEOR,
ROUGE-L, CIDEr and ``COCOScorer.score`` give equal numbers (compared with
``==``), the PTB tokenizer reproduces the golden corpus, and the port's own
native aligner and LCS match its pure-Python paths.
"""

import json
import os

import pytest

from care_tpu.metrics import COCOScorer as JaxCOCOScorer
from care_tpu.metrics import score_predictions as jax_score_predictions
from care_tpu.metrics.bleu import compute_bleu as jax_bleu
from care_tpu.metrics.cider import compute_cider as jax_cider
from care_tpu.metrics.meteor import compute_meteor as jax_meteor
from care_tpu.metrics.rouge import compute_rouge as jax_rouge
from care_tpu_torch import native
from care_tpu_torch.data import corpus
from care_tpu_torch.metrics import COCOScorer, score_predictions
from care_tpu_torch.metrics import meteor, rouge
from care_tpu_torch.metrics.bleu import compute_bleu
from care_tpu_torch.metrics.cider import compute_cider
from care_tpu_torch.metrics.meteor import compute_meteor
from care_tpu_torch.metrics.rouge import compute_rouge
from care_tpu_torch.metrics.tokenizer import ptb_tokenize, tokenize_corpus

from test_metrics import GTS, SAMPLES

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                       "ptb_tokenizer_golden.json")
with open(_GOLDEN) as f:
    _DATA = json.load(f)
_CASES = [(section, inp, out)
          for section, cases in _DATA.items() if section != "_comment"
          for inp, out in cases]


@pytest.mark.parametrize("section,inp,expected", _CASES,
                         ids=[f"{s}:{i[:30]}" for s, i, _ in _CASES])
def test_tokenizer_golden_case(section, inp, expected):
    assert " ".join(ptb_tokenize(inp)) == expected


def _synthetic_predictions(n_videos=30, seed=5):
    """References from the synthetic corpus and predictions that mix exact
    references, shuffled words, truncations and unrelated captions."""
    c = corpus.build_synthetic_corpus(n_videos=n_videos, seed=seed)
    refs = corpus.build_synthetic_references(c)
    preds = {}
    for i, (vid, entries) in enumerate(sorted(refs.items())):
        words = entries[i % len(entries)]["caption"].split()
        kind = i % 5
        if kind == 1:
            words = words[::-1]
        elif kind == 2:
            words = words[:3]
        elif kind == 3:
            words = ["dogs", "were", "running", "on", "roads"]
        elif kind == 4:
            words = words + ["Quickly!", "(again)"]
        preds[vid] = [{"image_id": vid, "caption": " ".join(words)}]
    return refs, preds


def _tokenized(refs, preds):
    gts = tokenize_corpus({k: [{"caption": e["caption"]} for e in v]
                           for k, v in refs.items()})
    res = tokenize_corpus({k: [{"caption": e["caption"]} for e in v]
                           for k, v in preds.items()})
    return gts, res


METRICS = {"bleu": (compute_bleu, jax_bleu),
           "meteor": (compute_meteor, jax_meteor),
           "rouge": (compute_rouge, jax_rouge),
           "cider": (compute_cider, jax_cider)}


@pytest.mark.parametrize("fixture", ["coco", "synthetic"])
@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_equals_jax(metric, fixture):
    refs, preds = ((GTS, SAMPLES) if fixture == "coco"
                   else _synthetic_predictions())
    gts, res = _tokenized(refs, preds)
    got_fn, want_fn = METRICS[metric]
    assert got_fn(gts, res) == want_fn(gts, res)


@pytest.mark.parametrize("fixture", ["coco", "synthetic", "identity"])
def test_cocoscorer_equals_jax(fixture):
    if fixture == "coco":
        refs, preds = GTS, SAMPLES
    elif fixture == "synthetic":
        refs, preds = _synthetic_predictions()
    else:
        refs, _ = _synthetic_predictions(n_videos=6)
        preds = {k: v[:1] for k, v in refs.items()}
    ids = sorted(preds)
    got = COCOScorer().score(refs, preds, ids)
    want = JaxCOCOScorer().score(refs, preds, ids)
    assert got == want
    assert set(got[0]) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                           "ROUGE_L", "CIDEr"}
    assert score_predictions(refs, preds) == jax_score_predictions(refs,
                                                                   preds)


METEOR_CASES = [
    ({"v": ["cat dog bird fish"]}, {"v": ["cat dog bird fish"]}),
    ({"v": ["the cat sat"]}, {"v": ["cat sat"]}),
    ({"v": ["dog running"]}, {"v": ["dogs runs"]}),
    ({"v": ["the cat sat"]}, {"v": ["cat sat the"]}),
    ({"a": ["cat dog bird fish"], "b": ["the cat sat"]},
     {"a": ["cat dog bird fish"], "b": ["cat sat"]}),
    ({"v": ["zebra yak emu owl", "cat dog bird fish"]},
     {"v": ["cat dog bird fish"]}),
    ({"v": ["the the cat sat"]}, {"v": ["the cat sat"]}),
]


@pytest.mark.parametrize("case", range(len(METEOR_CASES)))
def test_meteor_analytic_cases_equal_jax(case):
    """The analytic cases of ``tests/test_metrics.py``, whose closed forms
    that file pins for the JAX package: the port gives the same numbers."""
    gts, res = METEOR_CASES[case]
    assert compute_meteor(gts, res) == jax_meteor(gts, res)


ALIGN_CASES = [
    ("a man runs", "a man is running"),
    ("the quick brown fox jumped", "a quick fox jumps over the dog"),
    ("a a b b", "b b a a"),
    ("walking walking", "a person is walking and walking"),
    ("the cat sat", "the the cat sat"),
    ("dog cat", "cat x dog"),
]


@pytest.mark.parametrize("hyp,ref", ALIGN_CASES)
def test_native_aligner_matches_python(hyp, ref, monkeypatch):
    """The port's own native core (built into ``care_tpu_torch/build/``)
    aligns as its Python beam does."""
    assert native.available()
    assert native.LIB_PATH.startswith(native.BUILD_DIR)
    h, r = hyp.split(), ref.split()
    nat = meteor._align_native(h, r)
    assert nat is not None
    monkeypatch.setattr(meteor, "_align_native", lambda *a: None)
    assert sorted(nat) == sorted(meteor._align(h, r)), (hyp, ref)


@pytest.mark.parametrize("a,b", [("abcde", "ace"), ("", "abc"),
                                 ("aaaa", "aa"), ("xyz", "zyx")])
def test_native_lcs_matches_python(a, b, monkeypatch):
    got = rouge._lcs_len(list(a), list(b))
    monkeypatch.setattr(native, "available", lambda: False)
    assert got == rouge._lcs_len(list(a), list(b))


def test_scores_without_the_native_core_are_the_same(monkeypatch):
    refs, preds = _synthetic_predictions()
    ids = sorted(preds)
    with_native = COCOScorer().score(refs, preds, ids)[0]
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(meteor, "_align_native", lambda *a: None)
    assert COCOScorer().score(refs, preds, ids)[0] == with_native
