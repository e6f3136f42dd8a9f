"""Spawned ``torch.distributed`` worlds for the ``test_torch_parallel*``
files: one gloo world of a few processes on the CPU per test module, over a
``file://`` rendezvous, serving all of the module's checks.

The pytest process (which holds the JAX reference) pickles a payload
(options, ``care_tpu`` parameters as numpy trees, numpy batches); every
child runs the named scenario of ``SCENARIOS`` and the first writes its
results back. A child imports torch, numpy and ``care_tpu_torch`` only,
never JAX, and runs on one thread at test widths.
"""

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.weights import variables_from_jax
from care_tpu_torch.parallel import make_mesh, shard_batch, shard_params
from care_tpu_torch.parallel.mesh import full_values, split_params
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.trainer import device_batch


def run_world(n: int, scenario: str, payload, tmp_dir: str,
              timeout: float = 240.0):
    """Run ``scenario`` on a gloo world of ``n`` processes; returns what
    its first process returned."""
    import torch.multiprocessing as mp
    os.makedirs(tmp_dir, exist_ok=True)
    payload_path = os.path.join(tmp_dir, f"{scenario}_payload.pkl")
    out_path = os.path.join(tmp_dir, f"{scenario}_out.pkl")
    init_file = os.path.join(tmp_dir, f"{scenario}_rendezvous")
    for stale in (init_file, out_path):
        if os.path.exists(stale):
            os.remove(stale)
    with open(payload_path, "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(
        _entry, args=(n, init_file, scenario, payload_path, out_path),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.time() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"world {scenario} did not end in {timeout}s")
    with open(out_path, "rb") as f:
        return pickle.load(f)


def _entry(rank, n, init_file, scenario, payload_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=n)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        out = SCENARIOS[scenario](payload)
        if rank == 0:
            with open(out_path + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(out_path + ".tmp", out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# helpers the scenarios share
# ---------------------------------------------------------------------------

class ListLoader:
    """The trainer's loader contract over fixed numpy batches."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def to_rank0(value, mesh):
    """Every model group's first process's ``value`` on rank 0, in data
    order (None elsewhere); every process of the world calls it."""
    mine = (None if mesh is None else
            (mesh.data.rank, mesh.model.rank, value))
    everyone = [None] * dist.get_world_size() if dist.get_rank() == 0 \
        else None
    dist.gather_object(mine, everyone, dst=0)
    if everyone is None:
        return None
    firsts = sorted((e for e in everyone if e is not None and e[1] == 0),
                    key=lambda e: e[0])
    return [e[2] for e in firsts]


def port_model(opt, variables, mesh):
    """The port's model from ``care_tpu``'s ``variables``, split over
    ``mesh``, in eval mode."""
    model = build_captioner(opt, device="cpu")
    variables_from_jax(model, variables)
    if mesh is not None:
        shard_params(model, mesh)
    return model.eval()


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def forward_logits(payload):
    """Eval-mode logits of each mesh's processes on their rows."""
    out = {}
    for name, shape, ranks in payload["meshes"]:
        mesh = make_mesh(shape, ranks)
        value = None
        if mesh is not None:
            model = port_model(payload["opt"], payload["variables"], mesh)
            with torch.no_grad():
                b = device_batch(shard_batch(payload["batch"], mesh), "cpu")
                value = model(b, collect_aux=False)["logits"].numpy()
        got = to_rank0(value, mesh)
        if got is not None:
            out[name] = np.concatenate(got)
    return out


def train_steps(payload):
    """Per config: the global step losses and the whole parameters after
    the steps of ``Trainer``'s train step on the config's mesh."""
    out = {}
    for cfg in payload["configs"]:
        mesh = make_mesh(cfg["shape"], cfg["ranks"])
        value = None
        if mesh is not None:
            tr = Trainer(cfg["opt"], ListLoader(cfg["batches"]),
                         device="cpu", mesh=mesh)
            tr.init_model()
            tr.load_variables(cfg["variables"])
            tr._build_tx(len(cfg["batches"]))
            step = tr._make_train_step()
            stats = [step(tr._device_batch(b)) for b in cfg["batches"]]
            losses = [lv for lv, _, _ in tr._drain_step_stats(stats)]
            variables = tr.variables()
            value = {"losses": losses, "variables": variables,
                     "fused": tr._fused_xent}
        got = to_rank0(value, mesh)
        if got is not None:
            out[cfg["name"]] = got[0]
    return out


def beam_search(payload):
    """Hypotheses and scores of each mesh's sharded decode: every process
    decodes its rows, the first collects the beams' arrays of all rows in
    order (the reference's hypothesis cap runs over the whole batch)."""
    out = {}
    opt = payload["opt"]
    for name, shape, ranks in payload["meshes"]:
        mesh = make_mesh(shape, ranks)
        value = None
        translator = get_translator(opt, "cpu")
        if mesh is not None:
            model = port_model(opt, payload["variables"], mesh)
            feats = shard_batch({"feats": payload["feats"]}, mesh)["feats"]
            value = [t.numpy() for t in
                     translator.dispatch(model, {"feats": feats})]
        got = to_rank0(value, mesh)
        if got is not None:
            out[name] = translator._collect_arrays(
                tuple(np.concatenate(a) for a in zip(*got)))
    return out


def _loaders(opt):
    from care_tpu_torch.data import get_loader
    from care_tpu_torch.data.corpus import load_info_corpus, load_references
    corpus = load_info_corpus(opt["info_corpus"])
    return (get_loader(opt, "train"),
            get_loader(opt, "validate", is_validation=True, not_shuffle=True,
                       batch_size=opt["eval_batch_size"]),
            load_references(opt["reference"]), corpus["info"]["itow"])


def fit(payload):
    """``Trainer.fit`` on each mesh for an epoch with validation; the first
    process then validates the gathered weights without a mesh and loads
    the mesh's checkpoint into a single-process model."""
    from care_tpu_torch.training.checkpoints import load_checkpoint
    out = {}
    for cfg in payload["configs"]:
        mesh = make_mesh(cfg["shape"], cfg["ranks"])
        if mesh is None:
            continue
        opt = cfg["opt"]
        train, val, refs, vocab = _loaders(opt)
        tr = Trainer(opt, train, val, references=refs, vocab=vocab,
                     device="cpu", mesh=mesh)
        tr.fit(epochs=1)
        variables = tr.variables()
        gathered = full_values(tr.model)
        resumed = None
        if opt.get("resume"):
            # a fresh trainer on the mesh takes every process's blocks of
            # the whole train state the first process wrote
            again = Trainer(opt, train, val, references=refs, vocab=vocab,
                            device="cpu", mesh=mesh)
            again.init_model()
            again._build_tx(len(train))
            assert again._try_resume({}) == 1
            mine = dict(tr.model.named_parameters())
            assert all(torch.equal(p, mine[n])
                       for n, p in again.model.named_parameters())
            a, b = tr.tx.adam.state, again.tx.adam.state
            assert all(torch.equal(a[p]["exp_avg_sq"], b[q]["exp_avg_sq"])
                       for p, q in zip(tr._adam_params(),
                                       again._adam_params()))
            assert torch.equal(tr.dropout_generator.get_state(),
                               again.dropout_generator.get_state())
            resumed = True
        if not tr.is_main:
            continue
        alone = Trainer(opt, val_loader=val, references=refs, vocab=vocab,
                        device="cpu")
        alone.init_model()
        alone.load_variables(variables)
        single = alone.validate(0)
        # the same epoch without a mesh, from the same seed
        plain = Trainer(dict(opt, checkpoint_path=opt["checkpoint_path"]
                             + "_plain", resume=False),
                        _loaders(opt)[0], device="cpu")
        plain.fit(epochs=1)
        ckpt, _, _ = load_checkpoint(tr.ckpt_manager.best_path)
        loaded = build_captioner(opt, device="cpu")
        variables_from_jax(loaded, ckpt)
        out[cfg["name"]] = {
            "scores": tr.history[-1]["scores"], "single": single,
            "n_steps": tr.history[-1]["n_steps"],
            "ckpt_equal": {n: bool(torch.equal(p, gathered[n]))
                           for n, p in loaded.named_parameters()},
            "resumed": resumed,
            "losses": tr.history[-1]["step_losses"],
            "plain_losses": plain.history[-1]["step_losses"],
            "split": sorted(split_params(tr.model))}
    return out


def several(payload):
    """The (label, scenario, payload) triples of ``payload``, one after
    the other, in one world: {label: result}."""
    return {label: SCENARIOS[name](p) for label, name, p in payload}


SCENARIOS = {"forward_logits": forward_logits, "train_steps": train_steps,
             "beam_search": beam_search, "fit": fit, "several": several}
