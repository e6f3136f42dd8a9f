"""Training runtime: the fit loop of the port.

Port of ``care_tpu/training/trainer.py`` (reference ``train.py:30-145`` and
``models/Wrapper.py``) for what training needs before validation exists:
the train step (forward in training mode, multi-task loss, backward, the
Adam recipe), the epoch loop with the epoch-indexed ``training_scales``
re-weighting and the CARE dual-optimizer switch at ``lowlr_start_epoch``,
the scheduled-sampling ramp, and the per-epoch ``history``.

With ``fused_xent`` the step skips the model's vocab projection and the
language loss takes its statistics from (hidden states, head weight)
through ``ops/fused_xent.py``, whose forward and backward are hand-written
CUDA kernels on the card: the ``[B, L, V]`` logits and their gradient never
exist. The eligibility rule and the ``auto`` threshold are the JAX
package's, term by term.

Per-step scalars stay on the device during an epoch and are fetched in one
transfer at its end; nothing in the step loop waits for the device.

Not ported yet, each rejected with ``NotImplementedError``: validation and
test loaders (caption generation + COCO scoring), checkpoints and
``resume``, a ``mesh``, a ``log_dir`` (TensorBoard), ``lr_scheduler_type:
plateau``, a ``fused_xent_backend`` other than ``auto``, ``profile_dir``,
``backbone_weights``, teachers. The device
feature bank is simply not built: batches carry their features.
"""

import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.common import set_dropout_generator, unsupported
from care_tpu_torch.training import optim as optim_lib
from care_tpu_torch.training.losses import Criterion
from care_tpu_torch.utils.device import resolve_device

ARRAY_BATCH_KEYS_SKIP = ("video_ids", "caption_ids", "frame_ids")


def device_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Keep only array-valued entries, as tensors on ``device``; integer
    arrays become int64, the index type."""
    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if not t.is_floating_point():
            t = t.long()
        return t.to(device, non_blocking=True)
    out = {}
    for k, v in batch.items():
        if k in ARRAY_BATCH_KEYS_SKIP:
            continue
        if isinstance(v, np.ndarray):
            out[k] = put(v)
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            out[k] = [put(x) for x in v]
    return out


def schedule_sampling_prob(opt: dict, epoch: int) -> float:
    """reference ``Framework.py:221-229``."""
    start = opt.get("scheduled_sampling_start", -1)
    if start < 0 or epoch <= start:
        return 0.0
    frac = (epoch - start) // opt.get("scheduled_sampling_increase_every", 5)
    return min(opt.get("scheduled_sampling_increase_prob", 0.05) * frac,
               opt.get("scheduled_sampling_max_prob", 0.25))


def _check_opt(opt: dict) -> None:
    for key in ("resume", "profile_dir", "backbone_weights", "teacher_path",
                "with_teacher_during_training"):
        if opt.get(key):
            raise unsupported(key, opt[key])
    if opt.get("lr_scheduler_type") == "plateau":
        raise unsupported("lr_scheduler_type", "plateau")
    # the JAX package's "xla" forces its scan form and "pallas" its kernel;
    # the port has one rule per device (the kernels on a CUDA tensor)
    if opt.get("fused_xent_backend", "auto") != "auto":
        raise unsupported("fused_xent_backend", opt["fused_xent_backend"])


class Trainer:
    """``Trainer(opt, train_loader).fit(epochs)``. ``train_loader`` is any
    object with ``__iter__``, ``__len__`` and ``set_epoch``, yielding dicts
    of numpy arrays (``feats`` a list per modality, ``input_ids``,
    ``labels``, ``labels_attr``). ``device`` None means the CUDA card
    (raises without one); the CPU only when asked for by name."""

    def __init__(self, opt: dict, train_loader=None, val_loader=None,
                 test_loader=None, references=None, vocab=None,
                 log_dir: Optional[str] = None, mesh=None, device=None):
        for name, value in (("val_loader", val_loader),
                            ("test_loader", test_loader), ("mesh", mesh),
                            ("log_dir", log_dir)):
            if value is not None:
                raise unsupported(name)
        _check_opt(opt)
        self.opt = opt
        self.device = resolve_device(device)
        self.criterion = Criterion(opt, override_opt={"calculate_mAP": False})
        self.train_loader = train_loader
        self.references = references
        self.vocab = vocab

        self.model = None
        self.tx = None
        self.global_step = 0
        self.best_scores: Dict[str, float] = {}
        self.history: list = []   # per-epoch log dicts (loss, time, scores)
        self._train_step_fn = None

    # ------------------------------------------------------------------
    def init_model(self, seed: int = None):
        """Build the Captioner on the trainer's device, weights drawn from
        ``seed`` (default ``opt['seed']``), in training mode, with the
        trainer's dropout generator."""
        seed = self.opt.get("seed", 0) if seed is None else seed
        self.model = build_captioner(self.opt, device=self.device,
                                     seed=seed).train()
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(self.opt.get("seed", 0) + 1)
        set_dropout_generator(self.model, self.dropout_generator)
        return self.model

    def _build_tx(self, steps_per_epoch: int):
        opt = self.opt
        sched = optim_lib.make_lr_schedule(opt, steps_per_epoch)
        self.tx = optim_lib.make_adam(opt, sched, self.model)
        self.lr_sched = sched
        self.steps_per_epoch = steps_per_epoch
        self._is_multi_optimizer = (opt.get("wrapper") ==
                                    "MultipleOptimizerModel")
        self._switched = False

    def _maybe_switch_optimizer(self, epoch: int):
        """CARE recipe: a fresh low-LR-on-(encoder, detector) Adam takes
        over at ``lowlr_start_epoch`` (reference ``Wrapper.py:529-537``)."""
        if (self._is_multi_optimizer and not self._switched
                and epoch >= self.opt.get("lowlr_start_epoch", 10)):
            self.tx = optim_lib.make_dual_adam(
                self.opt, self.model, self.steps_per_epoch,
                offset_steps=self.global_step)
            self._train_step_fn = None
            self._switched = True
            self._switch_offset = self.global_step

    # ------------------------------------------------------------------
    def _make_train_step(self):
        model = self.model
        criterion = self.criterion
        tx = self.tx
        opt = self.opt
        # fused-xent training (ops/fused_xent.py): skip the model's vocab
        # projection and stream the criterion's statistics from
        # (hidden_states, head weight). Static eligibility: one hidden
        # stream through a plain NaiveHead, no pointer copy-probs, no
        # visual-word multi-pass, transformer decoder, lang crit present.
        fx_opt = opt.get("fused_xent", "auto")
        if fx_opt == "auto":
            # the fusion's gain is the [B, L, V] logits + gradient
            # activations, which only matter once they are a real slice of
            # device memory: fuse when that term clears the threshold, keep
            # the dense step otherwise. True/False still force.
            logits_mb = (opt.get("batch_size", 64)
                         * (opt.get("max_len", 30) + 2)
                         * opt.get("vocab_size", 11000) * 4 * 2) / 2**20
            fx_opt = logits_mb >= float(
                opt.get("fused_xent_auto_threshold_mb", 512))
        fused_xent = (bool(fx_opt)
                      and "lang" in opt.get("crits", [])
                      and opt.get("cls_head") == "NaiveHead"
                      and not opt.get("pointer")
                      and not opt.get("visual_word_generation", False)
                      and "rnn" not in opt.get("decoder", "").lower())
        self._fused_xent = fused_xent

        def train_step(batch):
            outputs = model(batch, compute_logits=not fused_xent)
            results = {**outputs, **batch}
            if fused_xent and "logits" not in outputs:
                results["cls_head_kernel"] = model.cls_head.tgt_word_prj.weight
            total, losses, metrics = criterion(results)
            tx.zero_grad()
            total.backward()
            tx.step()
            return (total.detach(),
                    {k: v.detach() for k, v in losses.items()},
                    {k: v.detach() for k, v in metrics.items()})

        return train_step

    # ------------------------------------------------------------------
    @staticmethod
    def _drain_step_stats(step_stats):
        """Fetch an epoch's worth of per-step device scalars in ONE stacked
        device->host transfer; yields (loss, losses_dict, metrics_dict) as
        python floats per step."""
        if not step_stats:
            return
        _, losses0, metrics0 = step_stats[0]
        lk, mk = sorted(losses0), sorted(metrics0)
        flat = [x.float().reshape(()) for loss, losses, metrics in step_stats
                for x in ([loss] + [losses[k] for k in lk]
                          + [metrics[k] for k in mk])]
        mat = torch.stack(flat).reshape(len(step_stats), -1).cpu().numpy()
        for row in mat:
            yield (float(row[0]),
                   {k: float(v) for k, v in zip(lk, row[1:1 + len(lk)])},
                   {k: float(v) for k, v in zip(mk, row[1 + len(lk):])})

    # ------------------------------------------------------------------
    def fit(self, epochs: Optional[int] = None):
        opt = self.opt
        epochs = epochs if epochs is not None else opt["epochs"]
        if self.train_loader is None:
            raise ValueError("fit needs a train_loader")
        if self.model is None:
            self.init_model()
        if self.tx is None:
            self._build_tx(max(len(self.train_loader), 1))
        self.model.train()

        training_scales = opt.get("training_scales", {}) or {}
        for epoch in range(epochs):
            self._maybe_switch_optimizer(epoch)
            if epoch in training_scales:
                self.criterion.set_scales(training_scales[epoch])
            if self._train_step_fn is None:
                self._train_step_fn = self._make_train_step()

            ss_prob = schedule_sampling_prob(opt, epoch)
            self.train_loader.set_epoch(epoch)
            t0 = time.time()
            # per-step stats stay ON DEVICE during the epoch and drain in
            # one stacked fetch at its end, so steps queue back to back
            step_stats = []
            for batch in self.train_loader:
                step_stats.append(self._train_step_fn(
                    device_batch(batch, self.device)))
                self.global_step += 1

            step_losses, loss_sums, metric_sums = [], {}, {}
            for lv, ld, md in self._drain_step_stats(step_stats):
                step_losses.append(lv)
                for sums, d in ((loss_sums, ld), (metric_sums, md)):
                    for k, v in d.items():
                        sums[k] = sums.get(k, 0.0) + v
            n_steps = len(step_losses)
            epoch_time = time.time() - t0

            log = {"train_loss": sum(step_losses) / max(n_steps, 1),
                   "epoch_time": epoch_time,
                   "schedule_sampling_prob": ss_prob}
            for k, v in loss_sums.items():
                log[k] = v / max(n_steps, 1)
            # criterion recorders: word accuracy + perplexity
            if metric_sums.get("word_acc_den0"):
                log["Word Acc0"] = (metric_sums["word_acc_num0"]
                                    / metric_sums["word_acc_den0"])
            if metric_sums.get("xent_count"):
                log["Perplexity"] = math.exp(metric_sums["xent_sum"]
                                             / metric_sums["xent_count"])
            self.history.append({"epoch": epoch, **log, "n_steps": n_steps,
                                 "step_losses": step_losses, "scores": {}})
            print(f"- epoch {epoch}: loss={log['train_loss']:.4f} "
                  f"({epoch_time:.1f}s)")
        return self.best_scores
