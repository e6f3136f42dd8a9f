"""Optimizers and LR schedules.

Port of ``care_tpu/training/optim.py`` (reference ``models/Wrapper.py:316-386``
and ``:460-547``): Adam with a per-epoch StepLR, cosine or linear-warmup
schedule, optional gradient clipping and weight-decay filtering, and the
CARE dual-optimizer recipe, where after ``lowlr_start_epoch`` a *fresh* Adam
takes over with a low LR on the encoder and the concept detector and the
base LR elsewhere, both schedules decaying per epoch from step 0.

The JAX package chains, per update: freeze (zero the gradient) -> clip by
the global norm -> add ``weight_decay * param`` to the gradient -> Adam ->
the schedule's LR at the optimizer's own step count. ``ChainedAdam`` does
the same around one ``torch.optim.Adam``, whose ``weight_decay`` is that
L2-on-gradient term. Two rules are written out because torch's own helpers
differ: the clip scales by ``max_norm / max(norm, max_norm)`` (not
``max_norm / (norm + 1e-6)``), and the LR is a function of the step,
``epoch = step // steps_per_epoch``, set on the optimizer before every
update. In the dual recipe each of the two groups runs its own chain, so
each clips by the norm of its own gradients.

Parameters are named by their path in the JAX package's tree
(``encoder/Encoder_A/linear/kernel``), which the freeze, decay and low-LR
filters match substrings of.
"""

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from care_tpu_torch.models.weights import jax_leaf_key
from care_tpu_torch.parallel.mesh import model_axis, split_params


def make_lr_schedule(opt: dict, steps_per_epoch: int,
                     base_lr: Optional[float] = None) -> Callable:
    """step (int) -> learning rate (float)."""
    lr = base_lr if base_lr is not None else opt.get("learning_rate", 5e-4)
    kind = opt.get("lr_scheduler_type", "linear")
    if kind == "linear":  # StepLR per epoch
        decay = opt.get("lr_decay", 0.9)
        step_size = opt.get("lr_step_size", 1)

        def sched(step):
            epoch = step // steps_per_epoch
            return lr * (decay ** (epoch // step_size))
        return sched
    if kind == "cosine":
        total = opt.get("max_steps") or (opt["epochs"] * steps_per_epoch)
        alpha = opt.get("min_lr", 1e-6) / lr

        def sched(step):
            cosine = 0.5 * (1.0 + math.cos(math.pi * min(step, total) / total))
            return lr * ((1.0 - alpha) * cosine + alpha)
        return sched
    if kind == "linear_with_warmup":
        total = opt.get("max_steps") or (opt["epochs"] * steps_per_epoch)
        if opt.get("learning_rate_warmup_ratio"):
            warmup = int(total * opt["learning_rate_warmup_ratio"])
        else:
            warmup = opt.get("learning_rate_warmup_steps", 1000)
        down = max(total - warmup, 1)

        def sched(step):
            if step < warmup:
                return lr * step / warmup
            return lr * (1.0 - min(step - warmup, down) / down)
        return sched
    # 'plateau' is handled by the trainer scaling the LR after validation
    # (PlateauController); before that, and for any other kind, a constant
    return lambda step: lr


class PlateauController:
    """Host-side ReduceLROnPlateau (reference ``Wrapper.py:362-376``):
    multiply the learning rate by ``factor`` after ``patience`` epochs
    without improvement of the monitored metric."""

    def __init__(self, opt: dict):
        self.mode = opt.get("lr_monitor_mode", "max")
        self.metric = opt.get("lr_monitor_metric", "CIDEr")
        self.patience = opt.get("lr_monitor_patience", 1)
        self.factor = opt.get("lr_decay", 0.9)
        self.min_lr = opt.get("min_lr", 1e-6)
        self.best = None
        self.bad_epochs = 0
        self.scale = 1.0

    def update(self, scores: dict) -> float:
        """Feed this epoch's scores; returns the current LR scale."""
        v = scores.get(self.metric)
        if v is None:
            return self.scale
        better = (self.best is None
                  or (v > self.best if self.mode == "max" else v < self.best))
        if better:
            self.best = v
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale

    def current_lr(self, base_lr: float) -> float:
        return max(base_lr * self.scale, self.min_lr)


def param_paths(model: nn.Module) -> Dict[str, str]:
    """Port parameter name -> its '/'-joined path in the JAX package's tree."""
    return {name: "/".join(jax_leaf_key(model, name)[0])
            for name, _ in model.named_parameters()}


def _decay_mask(model: nn.Module, filter_biases: bool,
                skip_substr_list=()) -> Dict[str, bool]:
    """True = apply weight decay. Mirrors ``add_weight_decay`` /
    ``filter_weight_decay`` (reference ``misc/utils.py:282-304``): 1-D
    params (biases, LN gains) are excluded when filtering, as are params
    whose path contains any listed substring."""
    paths = param_paths(model)
    mask = {}
    for name, param in model.named_parameters():
        keep = param.dim() > 1 if filter_biases else True
        if any(s in paths[name] for s in skip_substr_list):
            keep = False
        mask[name] = keep
    return mask


def freeze_mask(model: nn.Module, opt: dict) -> Optional[Dict[str, bool]]:
    """True = trainable; None = nothing frozen. ``freeze_parameters_except``
    freezes everything whose path contains none of the given substrings;
    frozen pretrained word embeddings freeze their own table unless
    ``train_emb``."""
    keep = opt.get("freeze_parameters_except") or []
    frozen_substr = []
    if opt.get("pretrained_embs_path", "") and not opt.get("train_emb",
                                                           False):
        frozen_substr += ["embedding/word_embeddings",
                          "decoder/word_embeddings"]
    if not keep and not frozen_substr:
        return None
    mask = {}
    for name, path in param_paths(model).items():
        trainable = any(s in path for s in keep) if keep else True
        if any(s in path for s in frozen_substr):
            trainable = False
        mask[name] = trainable
    return mask


def lowlr_param_labels(model: nn.Module, opt: dict) -> Dict[str, str]:
    """Label params 'low' (encoder + concept detector) vs 'normal'
    (reference ``Wrapper.py:493-508``)."""
    names = ["encoder", "Predictor_attribute"]
    if opt.get("decoding_type") == "NARFormer":
        names.append("SemanticContainer")
    return {name: "low" if any(n in path for n in names) else "normal"
            for name, path in param_paths(model).items()}


class ChainedAdam:
    """One ``torch.optim.Adam`` driven like the JAX package's optax chains.

    ``chains`` is a list of (parameter names, schedule): each chain zeroes
    the gradients of its frozen parameters, clips its gradients by their
    global norm, and sets its schedule's LR at the current ``count``; then
    one Adam step (with the L2 term on the parameters that decay) updates
    everything and ``count`` advances. A parameter without a gradient counts
    as a zero gradient, as in a functional update. Nothing here reads a
    value back from the device.

    On a mesh's model axis a split parameter's squared sum counts the
    blocks of every process of the model group (one all-reduce a chain);
    a replicated one counts once.
    """

    def __init__(self, opt: dict, model: nn.Module, chains: List[tuple]):
        wd = opt.get("weight_decay", 0.001)
        params = dict(model.named_parameters())
        if wd and opt.get("filter_weight_decay", False):
            decays = _decay_mask(model, opt.get("filter_biases", False),
                                 opt.get("skip_substr_list", []))
        else:
            decays = {name: bool(wd) for name in params}
        frozen = freeze_mask(model, opt) or {}
        split = split_params(model)
        self.model_axis = model_axis(model)
        self.max_norm = opt.get("gradient_clip_val", 0.0)
        self.count = 0
        self.chains = []
        groups = []
        for names, schedule in chains:
            chain = {"params": [params[n] for n in names],
                     "frozen": [params[n] for n in names
                                if not frozen.get(n, True)],
                     "schedule": schedule, "groups": [],
                     "split": (torch.tensor([n in split for n in names])
                               if self.model_axis else None)}
            for decay in (True, False):
                members = [params[n] for n in names if decays[n] == decay]
                if members:
                    group = {"params": members, "lr": schedule(0),
                             "weight_decay": wd if decay else 0.0}
                    groups.append(group)
                    chain["groups"].append(len(groups) - 1)
            self.chains.append(chain)
        self.adam = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        for chain in self.chains:
            for p in chain["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            for p in chain["frozen"]:
                p.grad.zero_()
            if self.max_norm:
                grads = [p.grad for p in chain["params"]]
                norms = torch.stack(torch._foreach_norm(grads))
                if chain["split"] is None:
                    norm = torch.linalg.vector_norm(norms)
                else:
                    norm = self._global_norm(norms, chain["split"])
                scale = self.max_norm / torch.clamp_min(norm, self.max_norm)
                torch._foreach_mul_(grads, scale)
            lr = chain["schedule"](self.count)
            for g in chain["groups"]:
                self.adam.param_groups[g]["lr"] = lr
        self.adam.step()
        self.count += 1

    def _global_norm(self, norms, split):
        """The norm of a chain whose ``split`` leaves hold blocks over the
        model axis."""
        sq = norms.square()
        split = split.to(sq.device)
        blocks = torch.where(split, sq, 0.0).sum().reshape(1)
        dist.all_reduce(blocks, group=self.model_axis.group())
        return torch.sqrt(blocks[0] + torch.where(split, 0.0, sq).sum())

    def set_constant_lr(self, lr: float) -> None:
        """Every chain at the constant ``lr`` from now on; the moments and
        the count are kept (the plateau rule's rebuild)."""
        for chain in self.chains:
            chain["schedule"] = lambda step: lr

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])

    def learning_rates(self) -> List[float]:
        """Each chain's LR at the current count."""
        return [chain["schedule"](self.count) for chain in self.chains]


def make_adam(opt: dict, schedule: Callable, model: nn.Module) -> ChainedAdam:
    return ChainedAdam(opt, model,
                       [([n for n, _ in model.named_parameters()], schedule)])


def make_dual_adam(opt: dict, model: nn.Module, steps_per_epoch: int,
                   offset_steps: int = 0) -> ChainedAdam:
    """The post-switch optimizer of the CARE recipe: low LR on encoder +
    concept detector, base LR elsewhere, both with per-epoch StepLR decay
    counted from training step 0. ``offset_steps`` accounts for the
    optimizer being freshly initialised at the switch epoch while its
    schedule has already decayed."""
    low = make_lr_schedule(opt, steps_per_epoch,
                           base_lr=opt.get("low_learning_rate", 5e-5))
    base = make_lr_schedule(opt, steps_per_epoch)
    labels = lowlr_param_labels(model, opt)
    chains = []
    for label, sched in (("low", low), ("normal", base)):
        names = [n for n, lab in labels.items() if lab == label]
        if names:
            chains.append((names, lambda step, s=sched: s(step + offset_steps)))
    return ChainedAdam(opt, model, chains)
