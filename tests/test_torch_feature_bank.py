"""The port's device feature bank (``care_tpu_torch/data/feature_bank.py``)
against the host-shipped features and against the JAX package's bank, on a
synthetic dataset on disk (``write_synthetic_dataset``), dropout off.

* the bank's gather equals the host features bit for bit, and the JAX
  bank's gather;
* training through the bank follows the JAX trainer's (which banks too)
  step losses at 1e-4 relative, and equals the port's own run without the
  bank;
* validation through the bank gives the COCO dict of validation without it
  (``==``) and the JAX trainer's;
* unsupported configurations return ``None``; an unreadable host table
  falls back, while an error in the copy to the device propagates;
* bf16 storage halves the bytes and gathers f32;
* resume with the bank reproduces the uninterrupted run bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.data import get_loader as jax_get_loader
from care_tpu.data.feature_bank import build_feature_bank as jax_build_bank
from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch.data import get_loader
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.data.feature_bank import build_feature_bank
from care_tpu_torch.models.weights import params_from_jax, params_to_jax
from care_tpu_torch.training import Trainer
from test_torch_support import flagship_small_opt, randomized, to_numpy

NO_DROPOUT = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}
COCO_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
             "CIDEr", "Sum")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_feature_bank"))
    opt = flagship_small_opt()
    data_dir, paths, corpus, refs = write_synthetic_dataset(root, opt,
                                                            n_videos=24)
    return data_dir, paths, corpus, refs


def _opt(data, tmp_path, **extra):
    data_dir, paths, corpus, _ = data
    opt = dict(flagship_small_opt(vocab_size=len(corpus["info"]["itow"])),
               batch_size=8, eval_batch_size=4, epochs=2, beam_size=3,
               eval_fused_k=1, device_feature_cache=True,
               check_val_every_n_epoch=10, **NO_DROPOUT)
    opt.update(extra)
    opt["info_corpus"] = os.path.join(data_dir, "info_corpus.pkl")
    opt["reference"] = os.path.join(data_dir, "refs.pkl")
    for c, p in paths.items():
        opt[f"feats_{c}"] = [p]
    opt["checkpoint_path"] = str(tmp_path / "exps")
    return opt


def _val_loader(get, opt):
    return get(opt, "validate", is_validation=True, not_shuffle=True,
               batch_size=opt["eval_batch_size"], pad_to_batch=True)


def _port_trainer(data, opt, params, val=False):
    _, _, corpus, refs = data
    tr = Trainer(opt, train_loader=get_loader(opt, "train"),
                 val_loader=_val_loader(get_loader, opt) if val else None,
                 references=refs, vocab=corpus["info"]["itow"], device="cpu")
    tr.init_model()
    params_from_jax(tr.model, params)
    return tr


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX trainer with its bank: 2 epochs, every step's loss, and the
    weights it started from."""
    _, _, corpus, refs = data
    opt = _opt(data, tmp_path_factory.mktemp("jax_bank"))
    jt = JaxTrainer(opt, train_loader=jax_get_loader(opt, "train"),
                    references=refs, vocab=corpus["info"]["itow"])
    jt.init_model(next(iter(jt.train_loader)))
    params = randomized(to_numpy(jt.variables["params"]), 1)
    jt.variables = {"params": jax.tree.map(jnp.asarray, params)}
    losses = []
    make = jt._make_train_step

    def make_recording():
        fn = make()

        def step(*args):
            out = fn(*args)
            losses.append(float(out[3]))
            return out
        return step

    jt._make_train_step = make_recording
    jt.fit()
    assert jt._feature_bank is not None
    return params, losses


def test_bank_gather_matches_host_feats(data, tmp_path):
    opt = _opt(data, tmp_path)
    loader = get_loader(opt, "train")
    bank = build_feature_bank(loader.dataset, opt, device="cpu")
    jbank = jax_build_bank(jax_get_loader(opt, "train").dataset, opt)
    assert bank is not None and bank.kinds == jbank.kinds
    assert bank.vid_to_row == jbank.vid_to_row
    loader.set_epoch(0)
    n_checked = 0
    for batch in loader:
        got = bank.lookup(batch["video_ids"], batch["frame_ids"])
        want = jbank.lookup(batch["video_ids"], batch["frame_ids"])
        assert len(got) == len(batch["feats"]) == len(want)
        for g, h, w in zip(got, batch["feats"], want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), h)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        n_checked += 1
    assert n_checked > 0 and bank.lookups == n_checked
    assert f"{len(bank.vid_to_row)} videos" in bank.describe()


def test_train_with_bank_follows_jax_and_shipping(data, tmp_path, jax_run):
    """Two epochs through the bank: the JAX trainer's (banked) step losses
    at 1e-4 relative; the port's run without the bank step for step
    (``==``: the gathered features are the shipped ones, bit for bit)."""
    params, want = jax_run
    bank_tr = _port_trainer(data, _opt(data, tmp_path / "bank"), params)
    bank_tr.fit()
    assert bank_tr._feature_bank is not None
    assert bank_tr.train_loader.dataset.skip_feats
    assert bank_tr._feature_bank.lookups == bank_tr.global_step
    ship_tr = _port_trainer(data, _opt(data, tmp_path / "ship",
                                       device_feature_cache=False), params)
    ship_tr.fit()
    assert ship_tr._feature_bank is None
    assert not getattr(ship_tr.train_loader.dataset, "skip_feats", False)
    got = [l for h in bank_tr.history for l in h["step_losses"]]
    shipped = [l for h in ship_tr.history for l in h["step_losses"]]
    assert len(got) == len(want) == bank_tr.global_step > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got == shipped


def test_skip_feats_samples_collate_without_feats(data, tmp_path):
    """With ``skip_feats`` a sample carries its frame ids and no features,
    and ``collate`` passes the batch through; the sampling draws stay the
    ones of the shipping path."""
    opt = _opt(data, tmp_path)
    ship, skip = get_loader(opt, "train"), get_loader(opt, "train")
    skip.dataset.skip_feats = True
    for a, b in zip(ship, skip):
        assert "feats" in a and "feats" not in b
        assert a["video_ids"] == b["video_ids"]
        np.testing.assert_array_equal(np.asarray(a["frame_ids"]),
                                      np.asarray(b["frame_ids"]))
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


def test_validation_with_bank_gives_the_same_scores(data, tmp_path,
                                                    jax_run):
    """Validation through the validation bank == without it (``==``), and
    == the JAX trainer's validation with its bank on the same weights."""
    params, _ = jax_run
    _, _, corpus, refs = data
    scores = {}
    for cache in (True, False):
        opt = _opt(data, tmp_path / str(cache), device_feature_cache=cache)
        tr = _port_trainer(data, opt, params, val=True)
        scores[cache] = tr.validate(0)
        banks = [b for b, _ in tr._val_banks.values()]
        assert any(b is not None for b in banks) == cache
    opt = _opt(data, tmp_path / "jax")
    jt = JaxTrainer(opt, train_loader=jax_get_loader(opt, "train"),
                    val_loader=_val_loader(jax_get_loader, opt),
                    references=refs, vocab=corpus["info"]["itow"])
    jt.init_model(next(iter(jt.train_loader)))
    jt.variables = {"params": jax.tree.map(jnp.asarray, params)}
    jt._build_tx(1)
    want = jt.validate(0)
    for k in COCO_KEYS:
        assert scores[True][k] == scores[False][k] == want[k], k


def test_bank_unsupported_configs_fall_back(data, tmp_path):
    opt = _opt(data, tmp_path)
    dataset = get_loader(opt, "train").dataset
    assert build_feature_bank(dataset, {**opt, "load_feats_type": 1},
                              device="cpu") is None
    assert build_feature_bank(dataset, {**opt, "feats": "SwinBERTDense"},
                              device="cpu") is None
    assert build_feature_bank(object(), opt, device="cpu") is None

    class Unreadable(type(dataset)):
        def _load_feats(self, *args, **kwargs):
            raise KeyError("video ids named another way")

    unreadable = Unreadable(opt, "train")
    assert build_feature_bank(unreadable, opt, device="cpu") is None
    # a trainer over it keeps shipping features
    tr = Trainer(opt, train_loader=get_loader(opt, "train"), device="cpu")
    tr.train_loader.dataset = unreadable
    tr._maybe_build_feature_bank()
    assert tr._feature_bank is None
    assert not getattr(unreadable, "skip_feats", False)


def test_bank_default_device_is_the_card(data, tmp_path):
    """As every entry point of the port, the bank takes ``None`` for the
    CUDA card and raises without one."""
    opt = _opt(data, tmp_path)
    dataset = get_loader(opt, "train").dataset
    if torch.cuda.is_available():
        bank = build_feature_bank(dataset, opt)
        assert all(t.device.type == "cuda" for t in bank.tables)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_feature_bank(dataset, opt)


def test_bank_copy_errors_propagate(data, tmp_path, monkeypatch):
    """The fall-back covers reading the host tables, not the copy to the
    device: there an error raises."""
    opt = _opt(data, tmp_path)
    dataset = get_loader(opt, "train").dataset

    def fail(self, *args, **kwargs):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(torch.Tensor, "to", fail)
    with pytest.raises(RuntimeError, match="out of memory"):
        build_feature_bank(dataset, opt, device="cpu")


def test_bank_bf16_storage_halves_bytes(data, tmp_path):
    opt = _opt(data, tmp_path)
    dataset = get_loader(opt, "train").dataset
    f32 = build_feature_bank(dataset, opt, device="cpu")
    bf16 = build_feature_bank(
        dataset, {**opt, "feature_cache_dtype": "bfloat16"}, device="cpu")
    assert bf16.nbytes() * 2 == f32.nbytes()
    assert all(t.dtype == torch.bfloat16 for t in bf16.tables)
    vids = sorted(f32.vid_to_row)[:2]
    frames = [list(range(opt["n_frames"]))] * 2
    got = bf16.lookup(vids, frames)
    ref = f32.lookup(vids, frames)
    # the gather returns f32 (the model's contract), values bf16-rounded
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(),
                                      r.bfloat16().float().numpy())


def test_resume_with_bank_is_bit_exact(data, tmp_path):
    """Dropout on and random frame sampling: 2 epochs straight against 1
    epoch with its state saved and a fresh trainer resuming to 2, all
    through the bank; the probe that checks the bank's coverage draws
    nothing from the sampling streams. Losses and parameters equal."""
    _, _, corpus, refs = data

    def run(path, epochs, state_dir):
        opt = _opt(data, path, epochs=epochs, resume=bool(state_dir),
                   train_state_dir=state_dir, hidden_dropout_prob=0.1,
                   random_type="all_random", lowlr_start_epoch=1)
        tr = Trainer(opt, train_loader=get_loader(opt, "train"),
                     references=refs, vocab=corpus["info"]["itow"],
                     device="cpu")
        tr.fit()
        assert tr._feature_bank is not None
        return tr

    full = run(tmp_path / "a", 2, "")
    state_dir = str(tmp_path / "state")
    run(tmp_path / "b", 1, state_dir)
    resumed = run(tmp_path / "b", 2, state_dir)
    assert [h["epoch"] for h in resumed.history] == [1]
    assert resumed.history[0]["step_losses"] == full.history[1]["step_losses"]
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(full.model),
                 params_to_jax(resumed.model))
