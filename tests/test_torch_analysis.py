"""``care_tpu_torch/analysis.py`` and ``care_tpu_torch/utils/profiling.py``
against ``care_tpu``'s on carried weights (f32, dropout off, the CPU):

* ``hybrid_attention_bias`` of the flax-named tree: the same paths, biases
  and means;
* ``concept_usage``: the same ratio;
* ``retrieval_robustness_sweep``: one ``care_tpu`` checkpoint of PointerGen
  CARE over a synthetic dataset with a retrieval database and its
  corrupted copy, loaded by each package's ``load_model`` (the port reads
  the msgpack file): the COCO dict of every ratio equal (``==``);
* ``topic_classification_probe``: the same accuracies from the GSG latent
  and from the mean semantic embedding;
* ``LatencyRecorder``'s ``latency.txt`` row equal; ``profile_trace`` writes
  a trace holding the ``trace_annotation`` range.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

from care_tpu import analysis as jax_analysis
from care_tpu.training.checkpoints import save_checkpoint as jax_save
from care_tpu.utils import profiling as jax_profiling
from care_tpu_torch import analysis
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.models.weights import variables_to_jax
from care_tpu_torch.utils import profiling

from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import tiny_opt

MSRVTT = {"dataset": "MSRVTT", "feats": "ViT",
          "decoder_modality_flags": "VA", "predictor_modality_flags": "VAT"}
CARE = dict(MSRVTT, method="Transformer", task="CARE")
POINTER_CARE = dict(MSRVTT, method="PointerGen", task="CARE")


def test_hybrid_attention_bias_equals_care_tpu():
    opt = tiny_opt(CARE)
    assert opt["add_hybrid_attention_bias"]
    _, variables, port = flagship_pair(opt, seed=3)
    got = analysis.hybrid_attention_bias(variables_to_jax(port), opt)
    want = jax_analysis.hybrid_attention_bias(variables, opt)
    assert got and sorted(got) == sorted(want)
    for path, info in want.items():
        np.testing.assert_array_equal(got[path]["bias"], info["bias"])
        assert {k: v for k, v in got[path].items() if k != "bias"} == {
            k: v for k, v in info.items() if k != "bias"}
    # the params subtree alone reads the same
    assert sorted(analysis.hybrid_attention_bias(
        variables_to_jax(port)["params"], opt)) == sorted(want)


def test_concept_usage_equals_care_tpu():
    rs = np.random.RandomState(0)
    itow = {i: f"w{i}" for i in range(40)}
    labels = rs.randint(0, 20, (3, 4))
    preds = {f"video{v}": [{"caption": " ".join(
        f"w{i}" for i in rs.randint(0, 40, 6))}] for v in range(4)}
    args = (preds, labels, ["video0", "video1", "video2"], itow)
    got = analysis.concept_usage(*args)
    assert got == jax_analysis.concept_usage(*args)
    assert 0 < got["concept_word_ratio"] < 1


def test_retrieval_robustness_sweep_equals_care_tpu(tmp_path):
    opt = dict(tiny_opt(POINTER_CARE), beam_size=3, batch_size=4)
    root = str(tmp_path)
    data_dir, paths, corpus, _ = write_synthetic_dataset(root, opt,
                                                         n_videos=12)
    opt["vocab_size"] = len(corpus["info"]["itow"])
    for c in ("r", "t"):
        shutil.copy(paths[c], paths[c].replace(".hdf5", "_ratio10.0.hdf5"))
    opt.update(info_corpus=os.path.join(data_dir, "info_corpus.pkl"),
               reference=os.path.join(data_dir, "refs.pkl"),
               **{f"feats_{c}": [p] for c, p in paths.items()})
    _, variables, _ = flagship_pair(opt, seed=4)
    ckpt = os.path.join(root, "exps", "best.ckpt")
    jax_save(ckpt, jax.tree.map(jnp.asarray, variables), opt)

    got = analysis.retrieval_robustness_sweep(ckpt, ratios=(10, 100),
                                              device="cpu",
                                              base_data_path=root)
    want = jax_analysis.retrieval_robustness_sweep(ckpt, ratios=(10, 100),
                                                   base_data_path=root)
    assert got == want and sorted(got) == [10, 100]
    assert {"CIDEr", "Bleu_4", "METEOR"} <= set(got[10])


def test_topic_classification_probe_equals_care_tpu():
    opt = tiny_opt(CARE)
    jmodel, variables, port = flagship_pair(opt, seed=5)
    batches = [{"feats": synthetic_batch(opt, 6, seed=s)["feats"]}
               for s in (6, 7)]
    cats = np.asarray([0, 1, 2] * 4)

    class Loader:
        def __init__(self, as_jax):
            self.as_jax = as_jax

        def __iter__(self):
            for b in batches:
                yield ({"feats": [jnp.asarray(f) for f in b["feats"]]}
                       if self.as_jax else b)

    for use_latent in (True, False):
        got = analysis.topic_classification_probe(
            port, Loader(False), cats, n_train=8, use_latent=use_latent)
        want = jax_analysis.topic_classification_probe(
            jmodel, variables, Loader(True), cats, n_train=8,
            use_latent=use_latent)
        assert got == want and got["n_test"] == 4


def test_latency_row_and_profile_trace_equal_care_tpu(tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    for mod, name in ((profiling, "port.txt"), (jax_profiling, "jax.txt")):
        rec = mod.LatencyRecorder("Transformer", "CARE")
        with rec.measure(n=4):
            pass
        rec.total = 0.75           # the wall time is the host's own
        rec.append_to(name)
        rec.append_to(name)
        assert rec.avg == 0.1875
    with open("port.txt") as f, open("jax.txt") as g:
        rows = f.read()
        assert rows == g.read()
    assert rows.splitlines()[0].split("\t") == [
        "Transformer", "CARE", "0.75", "4", "0.1875"]

    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        with profiling.trace_annotation("encode_phase"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "encode_phase" in {e.key for e in prof.key_averages()}
    with open(tmp_path / "trace" / "trace.json") as f:
        assert any(e.get("name") == "encode_phase"
                   for e in json.load(f)["traceEvents"])
