"""Training CLI of the port.

Port of ``train.py`` (reference ``train.py:30-145``): seeds, builds the
train, validation and test loaders, trains with per-epoch validation and
top-k checkpoints, reloads the best checkpoint and runs the test pass.

    python -m care_tpu_torch.train --dataset MSRVTT --method Transformer \\
        --task CARE --feats ViT -dm_flags VA -pm_flags VAT

runs on the CUDA card; ``--device cpu`` runs on the host. With
``load_model_weights_from`` (which the NACF commands get from their
``teacher_path``) the model starts from that checkpoint's weights where
their shapes fit (``models/loading.py:load_teacher_weights_into_student``).
``wrapper: InterplayModel`` trains with the mean teacher
(``training/mean_teacher.py``).

``--mesh data=2,model=2`` trains on a ``(data, model)`` mesh of processes
(``parallel/mesh.py``), one a device, started by ``torchrun``:

    torchrun --nproc_per_node 4 -m care_tpu_torch.train ... --mesh \
        data=2,model=2 [--device cpu]

Each process takes ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the
environment, the card ``cuda:LOCAL_RANK`` and NCCL (gloo with
``--device cpu``). Without ``torchrun`` the world is one process, and only
a mesh of one fits it.
"""

import argparse
import json
import os
import random

import numpy as np



def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--dataset", type=str, default="MSRVTT",
                   choices=["MSVD", "MSRVTT", "VATEX"])
    p.add_argument("-m", "--modality", type=str, default="mi")
    p.add_argument("-method", "--method", type=str, default="")
    p.add_argument("-task", "--task", type=str, default="")
    p.add_argument("-feats", "--feats", type=str, default="")
    p.add_argument("-arch", "--arch", type=str, default="base")
    p.add_argument("-setup", "--setup", type=str, default="naive")
    p.add_argument("-scope", "--scope", type=str, default="")
    p.add_argument("-seed", "--seed", type=int, default=0)
    p.add_argument("-e", "--epochs", type=int, default=None)
    p.add_argument("-b", "--batch_size", type=int, default=None)
    p.add_argument("--base_data_path", type=str, default="")
    p.add_argument("-dm_flags", "--decoder_modality_flags", type=str)
    p.add_argument("-pm_flags", "--predictor_modality_flags", type=str)
    p.add_argument("--load_model_weights_from", type=str, default="")
    p.add_argument("--mesh", type=str, default="",
                   help="process mesh, e.g. data=2,model=2 (under "
                        "torchrun)")
    p.add_argument("--override", type=str, default="",
                   help="JSON dict of extra opt overrides")
    p.add_argument("--devices", type=str, default="",
                   help="accepted for script parity with the reference CLI "
                        "(GPU index); a no-op")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card, `cpu` for "
                        "the host")
    # every remaining option key becomes a flag (reference opts.py:15-257)
    from care_tpu_torch.config.cli import add_opt_arguments
    add_opt_arguments(p)
    return p.parse_args(argv)


def seed_everything(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def load_weights_from(trainer, path: str) -> int:
    """Build the trainer's model and fill it from the checkpoint at
    ``path`` (root ``train.py:104-113``), through the vocabulary mapping
    when the checkpoint's corpus differs; returns the leaves filled."""
    from care_tpu_torch.models.loading import (
        get_vocab_mapping, load_teacher_weights_into_student)
    from care_tpu_torch.training.checkpoints import load_checkpoint

    trainer.init_model()
    _, teacher_opt, _ = load_checkpoint(path)
    vm = get_vocab_mapping(trainer.opt, teacher_opt) if teacher_opt else None
    return load_teacher_weights_into_student(trainer.model, path, vm)


def init_mesh(spec: str, device=None):
    """(mesh, this process's device) for ``--mesh``: the default process
    group from torchrun's environment (NCCL on the card, gloo on the CPU;
    none for a world of one), then the mesh over it."""
    import torch
    import torch.distributed as dist
    from care_tpu_torch.parallel import make_mesh, parse_mesh
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    cpu = device is not None and str(device) == "cpu"
    if not cpu:
        device = f"cuda:{local}"
        if torch.cuda.is_available():
            torch.cuda.set_device(local)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl")
    return make_mesh(parse_mesh(spec)), device


def run(opt, device=None, mesh=None):
    """The reference's ``run``: loaders, ``Trainer.fit`` (validation and
    checkpoints every epoch), ``load_best``, ``test``. ``device`` None
    means the CUDA card (raises without one); ``mesh`` this process's
    ``parallel.Mesh``."""
    from care_tpu_torch.data import get_loader
    from care_tpu_torch.data.corpus import load_info_corpus, load_references
    from care_tpu_torch.training.trainer import Trainer
    from care_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    seed_everything(opt["seed"])

    info_corpus = load_info_corpus(opt["info_corpus"])
    references = load_references(opt["reference"])
    vocab = info_corpus["info"]["itow"]

    # eval loaders pad partial batches to one shape (batch_mask marks the
    # real rows); the train loader stays exact so the loss weighs every
    # sample once
    train_loader = get_loader(opt, "train")
    val_loader = get_loader(opt, "validate", is_validation=True,
                            not_shuffle=True,
                            batch_size=opt.get("eval_batch_size", 128),
                            pad_to_batch=True)
    test_loader = get_loader(opt, "test", not_shuffle=True,
                             batch_size=opt.get("eval_batch_size", 128),
                             pad_to_batch=True)

    trainer_cls = Trainer
    if opt.get("wrapper") == "InterplayModel":
        from care_tpu_torch.training.mean_teacher import MeanTeacherTrainer
        trainer_cls = MeanTeacherTrainer
    trainer = trainer_cls(
        opt, train_loader=train_loader, val_loader=val_loader,
        test_loader=test_loader, references=references, vocab=vocab,
        log_dir=os.path.join(opt["checkpoint_path"], "tb"), device=device,
        mesh=mesh)
    if opt.get("load_model_weights_from"):
        load_weights_from(trainer, opt["load_model_weights_from"])
    trainer.fit()
    trainer.load_best()
    scores = trainer.test(info_corpus=info_corpus)
    if trainer.is_main:
        print("- test scores:", {k: v for k, v in scores.items()})
    return scores


def main(argv=None):
    from care_tpu_torch.config import get_opt
    from care_tpu_torch.config.cli import overrides_from_args
    from care_tpu_torch.training.checkpoints import _jsonable

    args = parse_args(argv)
    mesh, device = None, args.device
    if args.mesh:
        mesh, device = init_mesh(args.mesh, args.device)
    overrides = overrides_from_args(args, exclude=("override", "mesh",
                                                   "devices", "device"))
    if args.override:
        overrides["final_overrides"] = json.loads(args.override)
    opt = get_opt(overrides)
    os.makedirs(opt["checkpoint_path"], exist_ok=True)
    if mesh is None or mesh.all.rank == 0:
        with open(os.path.join(opt["checkpoint_path"], "opt_info.json"),
                  "w") as f:
            json.dump(_jsonable(opt), f, indent=1)
    return run(opt, device=device, mesh=mesh)


if __name__ == "__main__":
    main()
