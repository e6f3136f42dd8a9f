"""The port's checkpoints (``care_tpu_torch.training.checkpoints``) and
plateau rule against the JAX package's: a torch-format round trip under the
flax tree's names, the same side-car JSON, the same files and ``best.ckpt``
choice from ``CheckpointManager`` over one sequence of scores, the same
train-state bookkeeping, and the same ``PlateauController`` scales.
"""

import json
import os

import numpy as np
import pytest

from care_tpu.training import checkpoints as jax_ckpt
from care_tpu.training.optim import PlateauController as JaxPlateau
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.weights import params_from_jax, params_to_jax
from care_tpu_torch.training import checkpoints as ckpt
from care_tpu_torch.training.optim import PlateauController
from test_torch_support import flagship_small_opt


def _tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_round_trip_keeps_the_flax_names_and_the_side_car(tmp_path):
    opt = flagship_small_opt()
    model = build_captioner(opt, device="cpu", seed=3)
    variables = {"params": params_to_jax(model)}
    path = str(tmp_path / "run" / "model.ckpt")
    meta = {"epoch": 2, "scores": {"CIDEr": np.float64(0.5)}}
    ckpt.save_checkpoint(path, variables, opt, meta)

    loaded, got_opt, got_meta = ckpt.load_checkpoint(path)
    _tree_equal(loaded, variables)
    again, _, _ = ckpt.load_checkpoint(path, variables)
    _tree_equal(again, variables)
    # the side-car is the JAX package's
    assert got_opt == jax_ckpt._jsonable(opt)
    assert got_meta == jax_ckpt._jsonable(meta)
    with open(path + ".json") as f:
        assert json.load(f) == {"opt": jax_ckpt._jsonable(opt),
                                "metadata": jax_ckpt._jsonable(meta)}
    # and the weights load back into a fresh model bit for bit
    other = params_from_jax(build_captioner(opt, device="cpu", seed=4),
                            loaded["params"])
    for (n, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert np.array_equal(a.detach().numpy(), b.detach().numpy()), n


def test_load_refuses_a_template_of_another_shape(tmp_path):
    path = str(tmp_path / "a.ckpt")
    ckpt.save_checkpoint(path, {"params": {"w": np.ones((2, 3), np.float32)}},
                         {})
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(path, {"params": {"w": np.ones((3, 2))}})
    with pytest.raises(ValueError, match="tree"):
        ckpt.load_checkpoint(path, {"params": {"v": np.ones((2, 3))}})


MANAGER_CASES = {
    "max_top1": (dict(), [0.1, 0.3, 0.2, 0.5, 0.5]),
    "max_top2": (dict(save_topk=2), [0.1, 0.3, 0.2, 0.5, 0.4]),
    "min_top2": (dict(monitor_metric="loss", monitor_mode="min",
                      save_topk=2), [0.9, 0.5, 0.7, 0.2, 0.6]),
    "start_late": (dict(save_topk=2, start_saving_epoch=2),
                   [0.9, 0.8, 0.1, 0.3, 0.2]),
}


def _drive(module, ckpt_dir, kwargs, values):
    mgr = module.CheckpointManager(ckpt_dir, **kwargs)
    metric = kwargs.get("monitor_metric", "CIDEr")
    for epoch, v in enumerate(values):
        variables = {"params": {"w": np.full((2,), epoch, np.float32)}}
        mgr.on_epoch_end(epoch, variables, {"seed": 0},
                         {metric: v, "Bleu_4": 0.1 * epoch})
    return mgr


@pytest.mark.parametrize("case", sorted(MANAGER_CASES))
def test_manager_keeps_the_files_and_best_of_jax(tmp_path, case):
    kwargs, values = MANAGER_CASES[case]
    got = _drive(ckpt, str(tmp_path / "port"), kwargs, values)
    want = _drive(jax_ckpt, str(tmp_path / "jax"), kwargs, values)
    assert sorted(os.listdir(got.ckpt_dir)) == sorted(
        os.listdir(want.ckpt_dir))
    assert got.state_dict()["topk"] == [
        [m, p.replace(want.ckpt_dir, got.ckpt_dir)]
        for m, p in want.state_dict()["topk"]]
    for name in ("best.ckpt", "last.ckpt"):
        with open(os.path.join(got.ckpt_dir, name + ".json")) as f:
            a = json.load(f)
        with open(os.path.join(want.ckpt_dir, name + ".json")) as f:
            assert a == json.load(f)
        port_w = ckpt.load_checkpoint(os.path.join(got.ckpt_dir, name))[0]
        jax_w = jax_ckpt.load_checkpoint(os.path.join(want.ckpt_dir, name))[0]
        np.testing.assert_array_equal(port_w["params"]["w"],
                                      np.asarray(jax_w["params"]["w"]))
    restored = ckpt.CheckpointManager(got.ckpt_dir, **kwargs)
    restored.load_state_dict(got.state_dict())
    assert restored.topk == got.topk


def test_train_state_checkpointer_keeps_the_newest(tmp_path):
    import torch
    ts = ckpt.TrainStateCheckpointer(str(tmp_path / "state"), max_to_keep=2)
    assert ts.latest_epoch() is None
    gen = torch.Generator().manual_seed(5)
    for epoch in range(4):
        torch.rand(3, generator=gen)
        ts.save(epoch, {"x": torch.full((2,), float(epoch)),
                        "generator": gen.get_state()},
                {"epoch": epoch, "best": np.float32(0.25)})
    assert ts.epochs() == [2, 3] and ts.latest_epoch() == 3
    assert ts.restore_meta(3) == {"epoch": 3, "best": 0.25}
    state = ts.restore_state(3)
    assert state["x"].tolist() == [3.0, 3.0]
    other = torch.Generator()
    other.set_state(state["generator"])
    assert torch.equal(torch.rand(4, generator=other),
                       torch.rand(4, generator=gen))


@pytest.mark.parametrize("extra", [
    dict(), dict(lr_monitor_patience=0), dict(lr_monitor_mode="min"),
    dict(lr_decay=0.5, min_lr=2e-4, lr_monitor_patience=2)])
def test_plateau_controller_gives_the_jax_scales(extra):
    opt = dict(flagship_small_opt(), lr_scheduler_type="plateau", **extra)
    got, want = PlateauController(opt), JaxPlateau(opt)
    seq = [0.1, 0.2, 0.2, 0.15, 0.1, 0.3, 0.3, 0.3, 0.05, 0.4, 0.4, 0.4]
    for v in seq:
        scores = {"CIDEr": v}
        assert got.update(scores) == want.update(scores)
        assert (got.best, got.bad_epochs) == (want.best, want.bad_epochs)
        assert got.current_lr(5e-4) == want.current_lr(5e-4)
    assert got.update({}) == want.update({})
