"""The sharded train step and decode on a world of processes: the port of
``__graft_entry__.py:dryrun_multichip``.

    python -m care_tpu_torch.tools.dryrun_multichip [N] [--device cpu]

spawns ``N`` processes (default 8) joined over gloo through a ``file://``
rendezvous, on a mesh ``{data: N/2, model: 2}`` for an even ``N`` (else
``{data: N}``), and runs the flagship at test widths (vocab 128), each
process on its rows of a batch of ``2 * data`` videos. The processes run
on the CUDA cards (process ``r`` on card ``r`` modulo their number, so
that several share one card; gloo carries CUDA tensors, and TF32 is off
so that the comparisons are held in f32) unless ``--device cpu`` asks for
the host:

* one train step of ``Trainer``'s (dropout on): the loss is finite;
* with dropout off, the sharded loss and gradient norm equal those of the
  whole model on the whole batch in one process (rtol 1e-4 and 1e-3);
* the fused cross-entropy's loss (the statistics of
  ``ops/fused_xent.py``, the head's rows gathered when they are split)
  equals the dense one (rtol 1e-5);
* beam search on the sharded model, each process decoding its rows, is
  token-identical to the single-process decode, scores within 1e-4.

The first process prints one line a check. Dropout is off in the
comparisons because each process draws its own masks: the JAX package's
masks do not depend on the sharding, the port's do.
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from care_tpu_torch.utils.device import resolve_device

NO_DROPOUT = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}


def flagship_opt(vocab_size: int = 128) -> dict:
    """The CARE flagship at test widths (``_flagship_opt(small=True)``)."""
    from care_tpu_torch.config import get_opt
    overrides = {"dataset": "MSRVTT", "method": "Transformer",
                 "task": "CARE", "feats": "ViT",
                 "decoder_modality_flags": "VA",
                 "predictor_modality_flags": "VAT", "vocab_size": vocab_size,
                 "max_len": 12, "n_frames": 4, "dim_hidden": 64,
                 "intermediate_size": 128, "num_attention_heads": 4,
                 "attribute_prediction_k": 32, "use_attr_topk": 4,
                 "retrieval_topk": 4}
    opt = get_opt(overrides, read_vocab=False, resolve_paths=False)
    opt.update({"dim_a": 8, "dim_m": 16, "dim_i": 12, "dim_r": 12,
                "dim_hidden": 64, "intermediate_size": 128,
                "num_attention_heads": 4, "attribute_prediction_k": 32,
                "use_attr_topk": 4, "retrieval_topk": 4, "max_len": 12,
                "n_frames": 4, "vocab_size": vocab_size})
    return opt


def synthetic_batch(opt: dict, batch_size: int, seed: int = 0) -> dict:
    """Feature streams, token ids, labels and concept labels as numpy
    arrays, drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    feats = [rs.randn(batch_size, opt["n_frames"],
                      opt[f"dim_{c}"]).astype(np.float32)
             for c in opt["modality"]]
    ids = lambda: rs.randint(6, opt["vocab_size"],
                             (batch_size, opt["max_len"] - 1))
    return {"feats": feats, "input_ids": ids(), "labels": ids(),
            "labels_attr": rs.randint(
                0, 2, (batch_size, opt["attribute_prediction_k"])
            ).astype(np.float32)}


def mesh_shape(n: int) -> dict:
    return ({"data": n // 2, "model": 2} if n % 2 == 0 and n > 1
            else {"data": n})


def _grad_norm(model) -> float:
    from care_tpu_torch.parallel.mesh import model_axis, split_params
    split = split_params(model)
    sq = [0.0, 0.0]
    for name, p in model.named_parameters():
        if p.grad is not None:
            sq[name in split] += float(p.grad.double().square().sum())
    blocks = torch.tensor([sq[1]], dtype=torch.float64)
    ax = model_axis(model)
    if ax is not None:
        dist.all_reduce(blocks, group=ax.group())
    return float(np.sqrt(sq[0] + float(blocks[0])))


def _loss(model, criterion, batch, fused: bool = False):
    from care_tpu_torch.parallel.mesh import (gather_full, is_split,
                                              model_axis)
    outputs = model(batch, compute_logits=not fused, collect_aux=False)
    results = {**outputs, **batch}
    if fused:
        layer = model.cls_head.tgt_word_prj
        ax = model_axis(model)
        results["cls_head_kernel"] = (
            gather_full(layer.weight, 0, ax)
            if is_split(layer) else layer.weight)
    return criterion(results, model.project_attribute)[0]


def _mean_over_data(value: float, mesh) -> float:
    t = torch.tensor([value], dtype=torch.float64)
    if mesh.data.size > 1:
        dist.all_reduce(t, group=mesh.data.group())
    return float(t[0]) / mesh.data.size


def _child(rank: int, n: int, init_file: str, device: str) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=n)
    try:
        _checks(rank, n, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _checks(rank: int, n: int, device: str) -> None:
    from care_tpu_torch.decoding import get_translator
    from care_tpu_torch.models import build_captioner
    from care_tpu_torch.parallel import make_mesh, shard_batch, shard_params
    from care_tpu_torch.training import Trainer
    from care_tpu_torch.training.losses import Criterion
    from care_tpu_torch.training.trainer import device_batch, sync_data_grads

    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = make_mesh(mesh_shape(n))
    opt = flagship_opt()
    batch_size = 2 * mesh.data.size
    batch = synthetic_batch(opt, batch_size)

    class OneBatch(list):
        def set_epoch(self, epoch):
            pass

    trainer = Trainer(opt, OneBatch([batch]), device=device, mesh=mesh)
    trainer.init_model()
    trainer._build_tx(1)
    loss = trainer._make_train_step()(trainer._device_batch(batch))[0]
    loss = _mean_over_data(float(loss), mesh)
    assert np.isfinite(loss), loss
    say(f"dryrun_multichip OK: mesh={dict(mesh.shape)}, loss={loss:.4f}")

    # the same weights, dropout off: sharded against whole
    opt = dict(opt, **NO_DROPOUT)
    criterion = Criterion(opt, override_opt={"calculate_mAP": False})
    whole = build_captioner(opt, device=device, seed=0).train()
    sharded = build_captioner(opt, device=device, seed=0).train()
    shard_params(sharded, mesh)
    local = device_batch(shard_batch(batch, mesh), device)
    sh_loss = _loss(sharded, criterion, local)
    sh_loss.backward()
    sync_data_grads(list(sharded.parameters()), mesh.data)
    sh_loss, sh_gnorm = _mean_over_data(float(sh_loss.detach()), mesh), \
        _grad_norm(sharded)
    un_loss = _loss(whole, criterion, device_batch(batch, device))
    un_loss.backward()
    un_loss, un_gnorm = float(un_loss.detach()), _grad_norm(whole)
    assert np.allclose(sh_loss, un_loss, rtol=1e-4), (sh_loss, un_loss)
    assert np.allclose(sh_gnorm, un_gnorm, rtol=1e-3), (sh_gnorm, un_gnorm)
    say(f"dryrun_multichip grads OK: dp={mesh.data.size}, "
        f"tp={mesh.model.size}, sharded loss/gnorm={sh_loss:.6f}/"
        f"{sh_gnorm:.4f} == unsharded {un_loss:.6f}/{un_gnorm:.4f}")

    with torch.no_grad():
        fused = _mean_over_data(float(_loss(sharded, criterion, local,
                                            fused=True)), mesh)
        dense = _mean_over_data(float(_loss(sharded, criterion, local)),
                                mesh)
    assert np.allclose(fused, dense, rtol=1e-5), (fused, dense)
    say(f"dryrun_multichip fused-xent OK: {fused:.6f} == {dense:.6f} "
        "(dense)")

    sharded.eval()
    whole.eval()
    translator = get_translator(opt, device)
    feats = shard_batch({"feats": batch["feats"]}, mesh)["feats"]
    hyps, scores = translator.translate_batch(sharded, {"feats": feats})
    mine = (mesh.data.rank, mesh.model.rank, hyps, scores)
    everyone = [None] * n if rank == 0 else None
    dist.gather_object(mine, everyone, dst=0)
    if rank != 0:
        return
    firsts = sorted((e for e in everyone if e[1] == 0), key=lambda e: e[0])
    hyps = [h for e in firsts for h in e[2]]
    scores = [s for e in firsts for s in e[3]]
    assert len(hyps) == batch_size and all(len(h) >= 1 for h in hyps)
    hyps_1, scores_1 = translator.translate_batch(
        whole, {"feats": batch["feats"]})
    assert hyps == hyps_1, "sharded decode != single-process decode"
    for a, b in zip(scores, scores_1):
        assert np.allclose(a, b, atol=1e-4), (a, b)
    say(f"dryrun_multichip decode OK: mesh={dict(mesh.shape)}, "
        f"batch={batch_size}, beam={opt.get('beam_size', 5)}, "
        f"hyp0_len={len(hyps[0][0])}, sharded==unsharded: True")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the four checks on a gloo world of ``n_devices`` processes on
    ``device`` (None: the CUDA cards; "cpu": the host); raises when a
    process fails."""
    import torch.multiprocessing as mp
    device = resolve_device(device).type
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_child, args=(n_devices,
                                         os.path.join(tmp, "rendezvous"),
                                         device),
                           nprocs=n_devices, start_method="spawn")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=8,
                        help="processes in the world (default 8)")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the host (default: the card)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
