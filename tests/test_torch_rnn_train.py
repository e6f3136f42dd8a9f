"""The RNN captioners' training and entry points in the port, held against
the JAX package where it can be (f32, dropout off unless named):

* scheduled sampling: at probability 0 the training forward equals the JAX
  package's; at 1 the tokens the port fed, teacher-forced through the JAX
  package's step, give its logits; at 0.25 over many rows the sampled
  share lies within a binomial bound and the same seed repeats bit for
  bit; a resumed run equals the uninterrupted one bit for bit;
* pretrained word tables: read from a local ``.npy`` and frozen;
* the entry points on an RNN checkpoint: ``train.run``, ``load_model``,
  ``translate.main`` and ``eval_json``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu_torch import eval_json as port_eval_json
from care_tpu_torch import train as port_train
from care_tpu_torch import translate as port_translate
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.models import build_captioner, loading
from care_tpu_torch.models import decoders as port_decoders
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.optim import freeze_mask
from care_tpu_torch.training.trainer import device_batch

from test_torch_paper_grid_train import ListLoader
from test_torch_rnn import SALSTM_CARE, TOPDOWN_CARE, _opt, _step_logits
from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import VERS_MSRVTT


# ---------------------------------------------------------------------------
# scheduled sampling
# ---------------------------------------------------------------------------

def _sampling(port, batch, p, seed):
    port.train()
    port_decoders.set_sampling_generator(
        port, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        out = port(device_batch(batch, "cpu"), schedule_sampling_prob=p)
    port.eval()
    return out


def test_sampling_at_probability_zero_equals_jax():
    """Training mode at probability 0 (dropout 0): the teacher's tokens,
    and the JAX package's sampling scan, which draws but keeps them."""
    opt = _opt(SALSTM_CARE)
    jmodel, variables, port = flagship_pair(opt, seed=16)
    batch = synthetic_batch(opt, 3, seed=17)
    key = jax.random.PRNGKey(0)
    want = jmodel.apply(variables, jax.tree.map(jnp.asarray, batch),
                        deterministic=False, schedule_sampling_prob=0.0,
                        rngs={"dropout": key, "sampling": key})["logits"]
    got = _sampling(port, batch, 0.0, 0)
    assert "fed_input_ids" not in got
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("overrides", [SALSTM_CARE, TOPDOWN_CARE],
                         ids=["SALSTM", "TopDown"])
def test_sampling_at_probability_one_replays_through_jax(overrides):
    """At probability 1 every step after the first feeds a sample of the
    previous step's distribution; the JAX package's step over the tokens
    the port fed gives the port's logits."""
    opt = _opt(overrides)
    jmodel, variables, port = flagship_pair(opt, seed=18)
    batch = synthetic_batch(opt, 3, seed=19)
    out = _sampling(port, batch, 1.0, 1)
    fed, mask = out["fed_input_ids"].numpy(), out["scheduled_sampling_mask"]
    assert not mask[:, 0].any() and mask[:, 1:].all()
    assert (fed[:, 0] == batch["input_ids"][:, 0]).all()
    assert (fed[:, 1:] != batch["input_ids"][:, 1:]).any()
    _, want, _ = _step_logits(jmodel, variables, port, batch, fed)
    np.testing.assert_allclose(out["logits"].numpy(), want, rtol=0,
                               atol=2e-4)


def test_sampling_share_and_repeatability():
    """At probability 0.25 over 512 rows the share of positions fed a
    sample lies within 4 standard deviations of 0.25; the same seed feeds
    the same tokens and gives the same logits bit for bit, another seed
    other tokens."""
    opt = _opt(SALSTM_CARE)
    port = build_captioner(opt, device="cpu", seed=20)
    batch = synthetic_batch(opt, 512, seed=21)
    a = _sampling(port, batch, 0.25, 2)
    b = _sampling(port, batch, 0.25, 2)
    c = _sampling(port, batch, 0.25, 3)
    mask = a["scheduled_sampling_mask"][:, 1:]
    n = mask.numel()
    share = mask.float().mean().item()
    assert abs(share - 0.25) <= 4 * (0.25 * 0.75 / n) ** 0.5, share
    assert torch.equal(a["fed_input_ids"], b["fed_input_ids"])
    assert torch.equal(a["logits"], b["logits"])
    assert not torch.equal(a["fed_input_ids"], c["fed_input_ids"])


def test_resumed_rnn_run_equals_the_uninterrupted_one(tmp_path):
    """Two epochs with dropout on and sampling at 0.25 in the second: a run
    of one epoch resumed to two by a fresh trainer ends on the same
    parameters and losses, bit for bit."""
    opt = dict(_opt(SALSTM_CARE), hidden_dropout_prob=0.3,
               scheduled_sampling_increase_every=1,
               scheduled_sampling_increase_prob=0.25,
               checkpoint_path=str(tmp_path / "exps"))
    batches = [synthetic_batch(opt, 4, seed=22 + i) for i in range(2)]

    def run(epochs, state_dir, resume=True):
        tr = Trainer(dict(opt, epochs=epochs, resume=resume,
                          train_state_dir=str(state_dir)),
                     ListLoader(batches), device="cpu")
        tr.fit()
        return tr

    whole = run(2, tmp_path / "whole")
    assert whole.history[1]["schedule_sampling_prob"] == 0.25
    assert 0 < whole.history[1]["Sampled Share"] < 1
    run(1, tmp_path / "parts")
    resumed = run(2, tmp_path / "parts")
    assert [h["epoch"] for h in resumed.history] == [1]
    assert resumed.history[0]["step_losses"] == whole.history[1][
        "step_losses"]
    for (name, a), (_, b) in zip(whole.model.state_dict().items(),
                                 resumed.model.state_dict().items()):
        assert torch.equal(a, b), name


def test_pretrained_word_embeddings_are_read_and_frozen(tmp_path):
    opt = _opt(SALSTM_CARE)
    table = np.random.RandomState(26).randn(
        opt["vocab_size"], opt["dim_hidden"]).astype(np.float32)
    path = str(tmp_path / "embs.npy")
    np.save(path, table)
    # without weight decay: the JAX package adds the L2 term after the
    # freeze, so a frozen table still decays (ROADMAP.md Queue 3)
    opt = dict(opt, pretrained_embs_path=path, weight_decay=0.0,
               checkpoint_path=str(tmp_path / "exps"), epochs=1)
    tr = Trainer(opt, ListLoader([synthetic_batch(opt, 4, seed=27)]),
                 device="cpu")
    tr.init_model()
    np.testing.assert_array_equal(
        tr.model.decoder.word_embeddings.detach().numpy(), table)
    mask = freeze_mask(tr.model, opt)
    assert mask["decoder.word_embeddings"] is False
    assert sum(1 for v in mask.values() if not v) == 1
    tr.fit()
    np.testing.assert_array_equal(
        tr.model.decoder.word_embeddings.detach().numpy(), table)
    with pytest.raises(ValueError, match="pretrained"):
        build_captioner(dict(opt, dim_hidden=opt["dim_hidden"] * 2),
                        device="cpu")


# ---------------------------------------------------------------------------
# the entry points on an RNN checkpoint
# ---------------------------------------------------------------------------

def test_train_checkpoint_reload_and_translate_a_salstm(tmp_path,
                                                        monkeypatch, capsys):
    """``train.run`` trains a tiny SALSTM with the dataset's one-hot
    category on a synthetic dataset and keeps its best checkpoint;
    ``load_model`` reloads it; ``translate.main`` decodes the test split
    (the predictions equal the reloaded model's ``translate_batch``); and
    ``eval_json`` scores the written predictions."""
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    opt = _opt(dict(VERS_MSRVTT, method="SALSTM", task="Base"),
               with_category=True)
    data_dir, paths, corpus, refs = write_synthetic_dataset(root, opt,
                                                            n_videos=24)
    opt = dict(_opt(dict(VERS_MSRVTT, method="SALSTM", task="Base",
                         vocab_size=len(corpus["info"]["itow"])),
                    with_category=True),
               vocab_size=len(corpus["info"]["itow"]), batch_size=8,
               eval_batch_size=4, epochs=2, beam_size=3,
               scheduled_sampling_increase_every=1,
               info_corpus=os.path.join(data_dir, "info_corpus.pkl"),
               reference=os.path.join(data_dir, "refs.pkl"),
               checkpoint_path=str(tmp_path / "exps"))
    for c, p in paths.items():
        opt[f"feats_{c}"] = [p]
    scores = port_train.run(opt, device="cpu")
    assert "CIDEr" in scores
    ckpt = os.path.join(opt["checkpoint_path"], "best.ckpt")
    models, lopt = loading.load_model(ckpt, base_data_path=root,
                                      device="cpu")
    assert models[0].is_rnn and not models[0].training
    out = str(tmp_path / "out")
    (result,) = port_translate.main(["-cp", ckpt, "--device", "cpu",
                                     "--batch_size", "4", "--base_data_path",
                                     root, "--json_path", out])
    assert "CIDEr" in result
    with open(os.path.join(out, os.listdir(out)[0])) as f:
        preds = json.load(f)
    assert preds
    capsys.readouterr()
    port_eval_json.main(["-json", os.path.join(out, os.listdir(out)[0]),
                         "-ref", opt["reference"]])
    assert "CIDEr" in capsys.readouterr().out
