"""The port's ``parallel`` package in one process, held against
``care_tpu.parallel``; no world is spawned here but by the tools' own
checks.

* ``param_pspec`` and ``shard_params`` agree leaf for leaf with
  ``care_tpu``'s rules (the flagship and a head-split tiny model, model
  axes of 2 and 4), including the three fall-backs to "replicated"; the
  one leaf where the two differ, the ``bias`` of a ``CompositionalLinear``,
  stays whole in the port;
* ``make_mesh`` refuses a shape that is not its world, naming both sizes;
* ``process_slice``, ``global_batch_from_local`` and
  ``HostShardedBatches`` pass the cases of ``tests/test_multihost_input.py``
  (simulated processes by data coordinate);
* the fused head's merge of vocab shards (``merge_vocab_shards``) gives the
  whole vocabulary's beam step, ``care_tpu``'s ids and scores within 1e-5,
  with a tie between two shards resolved lower id first;
* a world of one: ``Trainer(mesh={data: 1})`` steps ``torch.equal`` to the
  mesh-less trainer, fused and dense;
* ``tools/dryrun_multichip.py`` on host worlds of 4 and 3 (the pure-DP
  branch), and its default, the card, refused where there is none;
  ``tools/merge_csv.py`` gives ``tests/test_merge_csv.py``'s row and
  ``tools/retrieval_db_ratio.py`` builds the 15 commands.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.parallel import make_mesh as jax_make_mesh
from care_tpu.parallel import param_pspec as jax_param_pspec
from care_tpu.ops.fused_head_topk import (
    fused_head_beam_topk as jax_fused_head_beam_topk)
from care_tpu_torch.models.common import CompositionalLinear
from care_tpu_torch.models.weights import jax_leaf_key
from care_tpu_torch.ops import fused_head_topk as fht
from care_tpu_torch.parallel import (make_mesh, param_pspec, process_slice,
                                     global_batch_from_local, shard_batch,
                                     shard_params, HostShardedBatches)
from care_tpu_torch.parallel import input as parallel_input
from care_tpu_torch.parallel.mesh import Axis, Mesh
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.trainer import device_batch

import torch_parallel_world as world
from helpers import tiny_opt
from test_torch_support import (flagship_pair, flagship_small_opt,
                                synthetic_batch)
from test_torch_compositional import GLSG
from test_torch_parallel_train import leaves
from torch_paper_grid import tiny_opt as grid_opt


def fake_mesh(data=(1, 0), model=(1, 0)) -> Mesh:
    """A mesh seen from the process at the given (size, rank) of each
    axis, with no process group: for the functions that only slice."""
    return Mesh({"data": data[0], "model": model[0]}, 0,
                Axis("data", data[0], data[1], -1),
                Axis("model", model[0], model[1], -1),
                Axis("all", data[0] * model[0], 0, -1), 0)


# ---------------------------------------------------------------------------
# the Megatron rules
# ---------------------------------------------------------------------------

def _spec_dim(spec, relaid):
    """``care_tpu``'s PartitionSpec as the split dim of the port's tensor
    (None: replicated)."""
    dims = [i for i, a in enumerate(tuple(spec)) if a is not None]
    if not dims:
        return None
    (i,) = dims
    return (len(tuple(spec)) - 1 - i) if relaid else i


CASES = {
    "flagship": lambda: flagship_small_opt(),
    "tiny_tp": lambda: tiny_opt(vocab_size=40, dim_hidden=64,
                                num_attention_heads=4,
                                intermediate_size=128),
    "odd_vocab": lambda: tiny_opt(vocab_size=37, dim_hidden=64,
                                  num_attention_heads=4,
                                  intermediate_size=128),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("m", [1, 2, 4])
def test_param_pspec_agrees_with_care_tpu(case, m):
    jmodel, variables, port = flagship_pair(CASES[case](), seed=0)
    jmesh = jax_make_mesh({"data": 8 // m, "model": m},
                          devices=jax.devices("cpu")[:8])
    params = dict(leaves(variables["params"]))
    pmesh = fake_mesh(data=(8 // m, 0), model=(m, 0))
    n_split = 0
    for name, p in port.named_parameters():
        key, relaid = jax_leaf_key(port, name)
        path = "params/" + "/".join(key)
        want = _spec_dim(jax_param_pspec(path, params["/".join(key)],
                                         jmesh), relaid)
        assert param_pspec(name, p, pmesh) == want, name
        n_split += want is not None
    assert (n_split > 0) == (m > 1)


def test_param_pspec_fallbacks():
    """No model axis, a rule with more dims than the leaf, a split dim
    that does not divide: replicated, as in ``care_tpu``."""
    jmesh = jax_make_mesh({"data": 4, "model": 2},
                          devices=jax.devices("cpu")[:8])
    jdata = jax_make_mesh({"data": 8}, devices=jax.devices("cpu")[:8])
    two = fake_mesh(data=(4, 0), model=(2, 0))
    one = fake_mesh(data=(8, 0))
    w = torch.zeros(6, 4)
    assert param_pspec("a.query.weight", w, one) is None
    assert tuple(jax_param_pspec("a/query/kernel", np.zeros((4, 6)),
                                 jdata)) == ()
    flat = torch.zeros(6)
    assert param_pspec("a.query.weight", flat, two) is None
    assert tuple(jax_param_pspec("a/query/kernel", np.zeros(6),
                                 jmesh)) == ()
    odd = torch.zeros(5, 4)
    assert param_pspec("a.query.weight", odd, two) is None
    assert tuple(jax_param_pspec("a/query/kernel", np.zeros((4, 5)),
                                 jmesh)) == ()
    assert param_pspec("a.query.weight", w, two) == 0
    assert param_pspec("a.attention.dense.weight", w, two) == 1


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_params_keeps_the_care_tpu_block(rank):
    opt = tiny_opt(vocab_size=40, dim_hidden=64, num_attention_heads=4,
                   intermediate_size=128)
    jmodel, variables, port = flagship_pair(opt, seed=0)
    params = dict(leaves(variables["params"]))
    shard_params(port, fake_mesh(model=(2, rank)))
    split = 0
    for name, p in port.named_parameters():
        key, relaid = jax_leaf_key(port, name)
        whole = params["/".join(key)]
        whole = whole.T if relaid else whole
        dim = getattr(port.get_submodule(name.rsplit(".", 1)[0]),
                      "_tp_split", {}).get(name.rsplit(".", 1)[1])
        if dim is not None:
            n = whole.shape[dim] // 2
            whole = np.take(whole, range(rank * n, (rank + 1) * n), axis=dim)
            split += 1
        np.testing.assert_array_equal(p.detach().numpy(), whole, name)
    assert split >= 8


def test_shard_params_keeps_compositional_maps_whole():
    """A ``CompositionalLinear``'s ``bias`` carries a rule's name, and
    ``care_tpu`` splits that leaf (XLA gathers it again); the port runs
    those maps whole on every process. Every leaf of one stays whole, and
    the other leaves split as ``care_tpu``'s."""
    opt = grid_opt(dict(GLSG, use_attr_flags="G0Lc", final_overrides=dict(
        compositional_intra=True, compositional_ffn=True)))
    _, variables, port = flagship_pair(opt, seed=0)
    jmesh = jax_make_mesh({"data": 4, "model": 2},
                          devices=jax.devices("cpu")[:8])
    params = dict(leaves(variables["params"]))
    shard_params(port, fake_mesh(data=(4, 0), model=(2, 1)))
    kept = split = 0
    for name, p in port.named_parameters():
        key, relaid = jax_leaf_key(port, name)
        *path, attr = name.split(".")
        module = port.get_submodule(".".join(path))
        want = _spec_dim(jax_param_pspec("params/" + "/".join(key),
                                         params["/".join(key)], jmesh),
                         relaid)
        got = getattr(module, "_tp_split", {}).get(attr)
        if isinstance(module, CompositionalLinear):
            assert got is None, name
            kept += want is not None
        else:
            assert got == want, name
            split += got is not None
    assert kept > 0 and split > 0


def test_make_mesh_refuses_another_world():
    with pytest.raises(ValueError, match="holds 2 processes but the world "
                                         "has 1"):
        make_mesh({"data": 2})
    with pytest.raises(ValueError, match="axis"):
        make_mesh({"pipeline": 1})
    mesh = make_mesh()
    assert dict(mesh.shape) == {"data": 1} and mesh.model.size == 1


# ---------------------------------------------------------------------------
# per-process input (tests/test_multihost_input.py's cases)
# ---------------------------------------------------------------------------

def test_process_slice_partitions_batch():
    slices = [process_slice(64, process_index=i, process_count=4)
              for i in range(4)]
    rows = np.concatenate([np.arange(64)[s] for s in slices])
    np.testing.assert_array_equal(rows, np.arange(64))
    assert all(s.stop - s.start == 16 for s in slices)
    with pytest.raises(AssertionError):
        process_slice(10, process_index=0, process_count=4)


def test_global_batch_single_process_equals_shard_batch():
    rs = np.random.RandomState(0)
    batch = {"feats": [rs.randn(8, 6, 4).astype(np.float32)],
             "input_ids": rs.randint(0, 50, (8, 9)),
             "batch_mask": np.ones((8,), np.float32)}
    mesh = make_mesh({"data": 1})
    ours = global_batch_from_local(batch, mesh)
    ref = device_batch(shard_batch(batch, mesh), "cpu")
    assert ours["input_ids"].dtype == torch.int64
    for a, b in zip([ours["feats"][0], ours["input_ids"],
                     ours["batch_mask"]],
                    [ref["feats"][0], ref["input_ids"], ref["batch_mask"]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pc", [2, 4])
def test_simulated_processes_assemble_global_batch(pc):
    """``HostShardedBatches`` once per simulated data coordinate: the local
    batches reassemble the global batch row for row, and a leaf that is
    not per-row passes whole."""
    rs = np.random.RandomState(7)
    B = 8
    batch = {"feats": [rs.randn(B, 3, 4).astype(np.float32)],
             "input_ids": rs.randint(0, 50, (B, 5)),
             "scalar": np.float32(3.5)}
    locals_ = []
    for pi in range(pc):
        out = list(HostShardedBatches([batch],
                                      fake_mesh(data=(pc, pi))))
        assert len(out) == 1
        local = out[0]
        assert local["feats"][0].shape[0] == B // pc
        assert local["input_ids"].shape[0] == B // pc
        assert float(local["scalar"]) == 3.5
        locals_.append(local)
        assert process_slice(B, pi, pc) == slice(pi * B // pc,
                                                 (pi + 1) * B // pc)
    np.testing.assert_array_equal(
        torch.cat([l["feats"][0] for l in locals_]).numpy(),
        batch["feats"][0])
    np.testing.assert_array_equal(
        torch.cat([l["input_ids"] for l in locals_]).numpy(),
        batch["input_ids"])


def test_process_slice_defaults_to_the_data_coordinate():
    parallel_input.set_default_mesh(fake_mesh(data=(2, 1), model=(2, 1)))
    try:
        assert process_slice(8) == slice(4, 8)
    finally:
        parallel_input.set_default_mesh(None)
    assert process_slice(8) == slice(0, 8)


def test_host_sharded_batches_wraps_loader():
    rs = np.random.RandomState(1)
    batches = [{"feats": [rs.randn(8, 4).astype(np.float32)],
                "input_ids": rs.randint(0, 50, (8, 5))}
               for _ in range(3)]

    class FakeLoader:
        epoch = None

        def set_epoch(self, e):
            self.epoch = e

        def __len__(self):
            return len(batches)

        def __iter__(self):
            return iter(batches)

    wrapped = HostShardedBatches(FakeLoader(), make_mesh({"data": 1}))
    wrapped.set_epoch(2)
    assert wrapped.loader.epoch == 2
    assert len(wrapped) == 3
    out = list(wrapped)
    for got, src in zip(out, batches):
        np.testing.assert_array_equal(got["feats"][0].numpy(),
                                      src["feats"][0])
    np.testing.assert_allclose(float(out[0]["feats"][0].sum()),
                               batches[0]["feats"][0].sum(), rtol=1e-6)


# ---------------------------------------------------------------------------
# the fused head on vocab shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards,chunk", [(2, 1024), (2, 128), (4, 128)])
def test_merged_vocab_shards_give_the_whole_beam_step(n_shards, chunk):
    rs = np.random.RandomState(3)
    N, K, H, V = 3, 4, 16, 512
    h = rs.randn(N * K, H).astype(np.float32)
    W = rs.randn(V, H).astype(np.float32)
    b = rs.randn(V).astype(np.float32)
    # a tie across the first shard boundary: equal rows, larger than all
    W[V // n_shards - 5] = W[V // n_shards + 9] = 3 * W[0]
    b[V // n_shards - 5] = b[V // n_shards + 9]
    scores = rs.randn(N, K).astype(np.float32)
    eos = np.zeros((N, K), bool)
    eos[0, 1] = True
    th = lambda x: torch.from_numpy(x)
    n = V // n_shards
    parts = [fht._stats_plain(th(h), th(W[r * n:(r + 1) * n]),
                              th(b[r * n:(r + 1) * n]), K, chunk)
             for r in range(n_shards)]
    cv = torch.stack([p[0] for p in parts], 1)
    ids = torch.stack([p[1] + r * n for r, p in enumerate(parts)], 1)
    m = torch.stack([p[2] for p in parts], 1)
    s = torch.stack([p[3] for p in parts], 1)
    got = fht._finalize(*fht.merge_vocab_shards(cv, ids, m, s, K),
                        th(scores), th(eos), K, V)
    whole = fht.fused_head_beam_topk(th(h), th(W), th(b), th(scores),
                                     th(eos), K, chunk)
    want = jax_fused_head_beam_topk(jnp.asarray(h), jnp.asarray(W.T),
                                    jnp.asarray(b), jnp.asarray(scores),
                                    jnp.asarray(eos), K)
    assert torch.equal(got[1], whole[1])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-5)
    # the tied ids both compete: the lower one ranks first
    flat = got[1].numpy() % V
    tied = {V // n_shards - 5, V // n_shards + 9}
    assert tied <= set(flat.ravel().tolist())


# ---------------------------------------------------------------------------
# a world of one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_world_of_one_steps_equal_the_mesh_less_trainer(fused):
    opt = dict(flagship_small_opt(), fused_xent=fused)
    batches = [synthetic_batch(opt, 4, seed=s) for s in (1, 2)]
    runs = []
    for mesh in (None, make_mesh({"data": 1})):
        tr = Trainer(opt, world.ListLoader(batches), device="cpu",
                     mesh=mesh)
        tr.init_model()
        tr._build_tx(2)
        step = tr._make_train_step()
        losses = [step(tr._device_batch(b))[0] for b in batches]
        assert tr._fused_xent == fused
        runs.append((losses, dict(tr.model.named_parameters())))
    (la, pa), (lb, pb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 3])
def test_dryrun_multichip_passes(n, capfd):
    from care_tpu_torch.tools.dryrun_multichip import dryrun_multichip
    dryrun_multichip(n, "cpu")
    out = capfd.readouterr().out
    for check in ("OK: mesh=", "grads OK", "fused-xent OK", "decode OK"):
        assert f"dryrun_multichip {check}" in out, out
    shape = "{'data': 2, 'model': 2}" if n == 4 else "{'data': 3}"
    assert shape in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_dryrun_multichip_runs_on_the_card_unless_asked():
    """The tool's default is the card: with none it raises before it
    spawns a process, and says how to ask for the host."""
    from care_tpu_torch.tools.dryrun_multichip import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["2"])


def test_merge_csv_gives_the_seed_row(tmp_path):
    import pandas as pd
    from care_tpu_torch.tools.merge_csv import merge
    scope_dir = tmp_path / "MSRVTT" / "Transformer" / "CARE" / "base_ViT"
    scope_dir.mkdir(parents=True)
    pd.DataFrame([
        {"Bleu_4": 0.40, "CIDEr": 0.50, "Sum": 1.5, "seed": 0},
        {"Bleu_4": 0.42, "CIDEr": 0.52, "Sum": 1.6, "seed": 1},
    ]).to_csv(scope_dir / "test_result.csv", index=False)
    out = merge(str(tmp_path), "MSRVTT")
    assert len(out) == 1
    row = out.iloc[0]
    assert row["method"] == "Transformer" and row["n_seeds"] == 2
    assert row["Bleu_4"] == "41.0 (1.0)" and row["CIDEr"] == "51.0 (1.0)"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "misc_tools"))
    from merge_csv import merge as jax_merge
    assert out.equals(jax_merge(str(tmp_path), "MSRVTT"))


def test_retrieval_db_ratio_builds_the_fifteen_commands(capsys):
    from care_tpu_torch.tools import retrieval_db_ratio as rdr
    cmds = rdr.commands("exp", device="cpu")
    assert len(cmds) == 15
    assert [c[c.index("--retrieval_db_ratio") + 1] for c in cmds] == (
        ["0.1"] * 5 + ["1"] * 5 + ["10"] * 5)
    assert cmds[6][1:] == [
        "-m", "care_tpu_torch.translate", "-cp",
        os.path.join("exp", "best-v1.ckpt"), "--retrieval_db_ratio", "1",
        "--save_csv", "--csv_name", "retrieval_db_ratio_1.csv", "--mode",
        "test", "--device", "cpu"]
    assert rdr.main(["exp", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert out.count("cmd: ") == 15 and "retrieval_db_ratio=10" in out
    from care_tpu_torch.translate import parse_args
    args = parse_args(cmds[0][3:])
    assert args.retrieval_db_ratio == 0.1 and args.save_csv
