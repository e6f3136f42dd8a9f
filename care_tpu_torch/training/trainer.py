"""Training runtime: the fit loop, validation, test and resume of the port.

Port of ``care_tpu/training/trainer.py`` (reference ``train.py:30-145`` and
``models/Wrapper.py``): the train step (forward in training mode, multi-task
loss, backward, the Adam recipe), the epoch loop with the epoch-indexed
``training_scales`` re-weighting, the CARE dual-optimizer switch at
``lowlr_start_epoch`` and the scheduled-sampling ramp; per-epoch caption
generation and COCO scoring on the validation set, CIDEr-monitored top-k
checkpoints, the plateau LR rule, the best-checkpoint reload and the test
pass with its CSV and caption-quality analysis; the train state saved every
epoch under ``resume``, so an interrupted run continues where it stopped.
An RNN decoder takes the epoch's scheduled-sampling probability into its
forward and draws its coins and samples from the trainer's sampling
generator, which the train state saves beside the dropout generator.

With ``fused_xent`` the step skips the model's vocab projection and the
language loss takes its statistics from (hidden states, head weight)
through ``ops/fused_xent.py``, whose forward and backward are hand-written
CUDA kernels on the card: the ``[B, L, V]`` logits and their gradient never
exist. The eligibility rule and the ``auto`` threshold are the JAX
package's, term by term. Validation and test decode through the
translator's beam search, whose vocab expansion is the fused head + top-k
kernel on the card.

Per-step scalars stay on the device during an epoch and are fetched in one
transfer at its end; nothing in the step loop waits for the device. The
loader's batches are prepared on a background thread (``prefetch``) and
copied to the device on the thread that runs the step.

With ``device_feature_cache`` (the default) the train dataset's feature
tables go to the device once (``data/feature_bank.py``), the dataset stops
reading features (``skip_feats``) and every train batch gathers its
features there from its video and frame ids; validation keeps a bank of its
own dataset. Validation decodes through ``translate_batches_grouped`` with
up to ``eval_fused_k`` decodes in flight (at least 2).

A NAR model with a ``teacher_path`` decodes with its AR teacher
(``_get_teacher``): loaded once from its checkpoint, with the vocabulary
mapping between the two corpora, and handed to the translator with every
validation and test batch, which rescores the candidates with it.

A model with ``with_backbones`` trains its image tower end to end on raw
frames; ``backbone_weights`` fills the tower from local torch state dicts
after the model is built (``models/backbone.py``).

On a ``mesh`` (``parallel/mesh.py:make_mesh``; one process a device) the
parameters are split over its model axis after ``init_model`` and every
process trains on its rows of each batch over the data axis (a world of
more than one process reads through ``HostShardedBatches``). After the
backward the gradients are averaged over the data axis, explicitly, before
the clip; a model axis turns the fused cross-entropy off, as in the JAX
package, and the head's logits come back whole. No feature bank is built.
Validation and test decode each process's rows; the first process gathers
the captions, scores them and sends the scores to every process, so that
all take the same checkpoint, plateau and early-stop decisions.
Checkpoints hold the whole parameters (and Adam moments), written by the
first process; loading one cuts them again. Only the first process logs.

A ``fused_xent_backend`` other than ``auto`` is rejected with
``NotImplementedError``.
"""

import contextlib
import json
import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from care_tpu_torch.data.loader import prefetch
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.metrics import COCOScorer
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.backbone import maybe_load_backbone_weights
from care_tpu_torch.models.common import set_dropout_generator, unsupported
from care_tpu_torch.models.decoders import (is_rnn_decoder,
                                            set_sampling_generator)
from care_tpu_torch.models.weights import (variables_from_jax,
                                           variables_to_jax)
from care_tpu_torch.parallel import input as parallel_input
from care_tpu_torch.parallel import mesh as mesh_lib
from care_tpu_torch.parallel import tensor_parallel as tp
from care_tpu_torch.training import optim as optim_lib
from care_tpu_torch.training.checkpoints import (CheckpointManager,
                                                 TrainStateCheckpointer,
                                                 load_checkpoint)
from care_tpu_torch.training.losses import Criterion
from care_tpu_torch.utils.device import resolve_device
from care_tpu_torch.utils.profiling import profile_trace
from care_tpu_torch.utils.logger import (MetricTracker,
                                         analyze_length_novel_unique,
                                         save_dict_to_csv, to_sentence)

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
        elif isinstance(v, torch.Tensor):
            # already placed (HostShardedBatches)
            out[k] = v.to(device, non_blocking=True)
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            out[k] = [put(x) for x in v]
        elif isinstance(v, list) and v and isinstance(v[0], torch.Tensor):
            out[k] = [x.to(device, non_blocking=True) for x in v]
    return out


def sync_data_grads(params, data_axis) -> None:
    """Average the gradients over a mesh's data axis (a parameter without
    a gradient counts as zeros, as the optimizer takes it); nothing runs on
    an axis of one."""
    if not tp.axis_active(data_axis):
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    tp.all_reduce_grads_mean(params, data_axis)


def schedule_sampling_prob(opt: dict, epoch: int) -> float:
    """reference ``Framework.py:221-229``."""
    start = opt.get("scheduled_sampling_start", -1)
    if start < 0 or epoch <= start:
        return 0.0
    frac = (epoch - start) // opt.get("scheduled_sampling_increase_every", 5)
    return min(opt.get("scheduled_sampling_increase_prob", 0.05) * frac,
               opt.get("scheduled_sampling_max_prob", 0.25))


def _check_opt(opt: dict) -> None:
    # the JAX package's "xla" forces its scan form and "pallas" its kernel;
    # the port has one rule per device (the kernels on a CUDA tensor)
    if opt.get("fused_xent_backend", "auto") != "auto":
        raise unsupported("fused_xent_backend", opt["fused_xent_backend"])


def _rng_state(rs: np.random.RandomState) -> dict:
    key, state, pos, has_gauss, cached = rs.get_state()
    return {"key": key, "state": torch.from_numpy(state.astype(np.int64)),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached": float(cached)}


def _set_rng_state(rs: np.random.RandomState, st: dict) -> None:
    rs.set_state((st["key"], st["state"].numpy().astype(np.uint32),
                  st["pos"], st["has_gauss"], st["cached"]))


class Trainer:
    """``Trainer(opt, train_loader, val_loader, test_loader, references,
    vocab, log_dir).fit(epochs)``. A loader is any object with
    ``__iter__``, ``__len__`` and (for training) ``set_epoch``, yielding
    dicts of numpy arrays (``feats`` a list per modality, ``input_ids``,
    ``labels``, ``labels_attr``; validation and test batches also
    ``video_ids`` and, from a padding loader, ``batch_mask``).
    ``device`` None means the CUDA card (raises without one); the CPU only
    when asked for by name. ``mesh`` a ``parallel.Mesh`` this process
    belongs to (``device`` is then this process's device)."""

    def __init__(self, opt: dict, train_loader=None, val_loader=None,
                 test_loader=None, references=None, vocab=None,
                 log_dir: Optional[str] = None, mesh=None, device=None):
        _check_opt(opt)
        if mesh is not None and not isinstance(mesh, mesh_lib.Mesh):
            raise TypeError(f"mesh must be a care_tpu_torch.parallel.Mesh "
                            f"(make_mesh), not {type(mesh).__name__}")
        self.opt = opt
        self.device = resolve_device(device)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.all.rank == 0
        # the processes of the mesh, which gather and share evaluation
        self._world = 1 if mesh is None else mesh.all.size
        if mesh is not None:
            parallel_input.set_default_mesh(mesh)
            if self._world > 1 and train_loader is not None and not \
                    isinstance(train_loader,
                               parallel_input.HostShardedBatches):
                train_loader = parallel_input.HostShardedBatches(
                    train_loader, mesh, self.device)
        self.criterion = Criterion(opt, override_opt={"calculate_mAP": False})
        self.eval_criterion = Criterion(opt, skip_crit_list=["lang"],
                                        override_opt={"calculate_mAP": True},
                                        with_metrics=True)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.references = references
        self.vocab = vocab

        self.ckpt_manager = CheckpointManager(
            opt.get("checkpoint_path", "./exps/run"),
            monitor_metric=opt.get("monitor_metric", "CIDEr"),
            monitor_mode=opt.get("monitor_mode", "max"),
            save_topk=opt.get("save_topk_models", 1),
            start_saving_epoch=opt.get("start_saving_epoch", 0))

        self.tb = None
        if log_dir and self.is_main:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(log_dir)

        self.model = None
        self.tx = None
        self._translator = None
        self._teacher = None
        self._ts_ckpt = None
        self._plateau = None
        self.global_step = 0
        self.best_scores: Dict[str, float] = {}
        self.history: list = []   # per-epoch log dicts (loss, time, scores)
        self._train_step_fn = None
        self._feature_bank = None
        self._val_banks: Dict[int, Any] = {}
        # the decoder-side concept flags read the decoder's aux outputs
        self._needs_aux = any(
            f != "V" for f in (opt.get("attribute_prediction_flags") or "V")
        ) and "attribute" in opt["crits"]

    # ------------------------------------------------------------------
    def init_model(self, seed: int = None):
        """Build the Captioner on the trainer's device, weights drawn from
        ``seed`` (default ``opt['seed']``) and the backbones' from
        ``backbone_weights`` where given, in training mode, with the
        trainer's dropout generator."""
        seed = self.opt.get("seed", 0) if seed is None else seed
        self.model = build_captioner(self.opt, device=self.device,
                                     seed=seed).train()
        if self.opt.get("backbone_weights"):
            maybe_load_backbone_weights(self.model, self.opt)
        if self.mesh is not None:
            mesh_lib.shard_params(self.model, self.mesh)
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(self.opt.get("seed", 0) + 1
                                           + self._stream())
        set_dropout_generator(self.model, self.dropout_generator)
        # the scheduled sampling of an RNN decoder: coins and samples
        self.sampling_generator = torch.Generator(device=self.device)
        self.sampling_generator.manual_seed(self.opt.get("seed", 0) + 2
                                            + self._stream())
        set_sampling_generator(self.model, self.sampling_generator)
        return self.model

    def _stream(self) -> int:
        """The offset of this process's generator seeds: on a mesh the
        processes of one model group draw the same masks (their replicated
        activations must stay equal), those of other data coordinates their
        own."""
        return 0 if self.mesh is None else 7919 * self.mesh.data.rank

    @property
    def translator(self):
        if self._translator is None:
            self._translator = get_translator(self.opt, self.device)
        return self._translator

    def variables(self) -> Dict[str, Any]:
        """The model's parameters (and BatchNorm running statistics) as the
        flax ``{"params": ..., "batch_stats": ...}`` tree, the layout of the
        checkpoints; on a mesh the whole parameters (collective: every
        process calls it)."""
        if self.mesh is None:
            return variables_to_jax(self.model)
        return variables_to_jax(self.model, mesh_lib.full_values(self.model))

    def load_variables(self, variables: Dict[str, Any]) -> None:
        """Fill the model from a whole ``variables`` tree (a checkpoint's,
        ``care_tpu``'s); on a mesh each process keeps its blocks."""
        variables_from_jax(self.model, variables,
                           None if self.mesh is None
                           else mesh_lib.local_cut(self.model))

    # ------------------------------------------------------------------
    # the device feature bank
    # ------------------------------------------------------------------
    def _device_batch(self, batch):
        """A train batch on the device: its features gathered from the
        bank when it covers the batch, else shipped from the host; on a
        mesh this process's rows (a batch of ``HostShardedBatches`` holds
        them already, as tensors)."""
        if self.mesh is not None:
            feats = batch["feats"]
            lead = feats[0] if isinstance(feats, (list, tuple)) else feats
            if not isinstance(lead, torch.Tensor):
                batch = mesh_lib.shard_batch(batch, self.mesh)
            return device_batch(batch, self.device)
        bank = self._feature_bank
        served = self._bank_serve(bank, batch)
        if served is not None:
            return served
        if bank is not None and "feats" not in batch:
            # skip_feats stripped the host features but the bank cannot
            # serve this batch: fail here, not deep in the model (the
            # build-time coverage check makes this unreachable for a
            # consistent dataset)
            missing = [v for v in batch.get("video_ids", [])
                       if v not in bank.vid_to_row]
            raise RuntimeError(
                "device feature bank cannot serve batch (uncovered "
                f"video_ids {missing[:5]}...) and host feats were "
                "skipped; set opt['device_feature_cache']=False")
        return device_batch(batch, self.device)

    def _bank_serve(self, bank, batch):
        """The batch on the device with its features gathered from
        ``bank``; None when the bank cannot serve it."""
        if bank is None or "video_ids" not in batch \
                or not bank.covers(batch["video_ids"]):
            return None
        b = device_batch({k: v for k, v in batch.items() if k != "feats"},
                         self.device)
        b["feats"] = bank.lookup(batch["video_ids"], batch.get("frame_ids"))
        return b

    def _maybe_val_bank(self, loader):
        """Feature bank of an eval loader's dataset (built on first use,
        kept per dataset). Unlike the train bank it never sets
        ``skip_feats``: the host features stay the fall-back. None on a
        mesh, as in the JAX package."""
        if not self.opt.get("device_feature_cache", True) \
                or self.mesh is not None:
            return None
        ds = getattr(loader, "dataset", None)
        if ds is None:
            return None
        key = id(ds)
        if key not in self._val_banks:
            from care_tpu_torch.data.feature_bank import build_feature_bank
            bank = build_feature_bank(ds, self.opt, self.device)
            # the dataset is kept with its bank so its id stays its own
            self._val_banks[key] = (bank, ds)
            if bank is not None:
                print(f"- validation feature cache: {bank.describe()}")
        return self._val_banks[key][0]

    def _maybe_build_feature_bank(self):
        """Upload the train dataset's feature tables once and gather each
        batch's features on the device from then on."""
        opt = self.opt
        if self._feature_bank is not None \
                or not opt.get("device_feature_cache", True) \
                or self.mesh is not None \
                or self.train_loader is None \
                or not hasattr(self.train_loader, "dataset"):
            return
        from care_tpu_torch.data.feature_bank import build_feature_bank
        dataset = self.train_loader.dataset
        bank = build_feature_bank(dataset, opt, self.device)
        if bank is None:
            return
        # coverage check on a real sample before committing to the bank: a
        # video-naming mismatch must fall back, not fail mid-epoch. The
        # probe must not advance the dataset's sampling streams (resume and
        # loss trajectories repeat exactly)
        rngs = [r for r in (getattr(dataset, a, None) for a in ("rng",
                                                                "random"))
                if isinstance(r, np.random.RandomState)]
        states = [r.get_state() for r in rngs]
        probe = dataset[0]
        for r, st in zip(rngs, states):
            r.set_state(st)
        if probe.get("video_ids") not in bank.vid_to_row:
            return
        # full coverage where the samples are enumerable (the JointDataset
        # infoset), before skip_feats strips features from any batch
        infoset = getattr(dataset, "infoset", None)
        if infoset is not None:
            if not all(e.get("vid") in bank.vid_to_row for e in infoset):
                return
        self._feature_bank = bank
        dataset.skip_feats = True
        print(f"- device feature cache: {bank.describe()}")

    def _build_tx(self, steps_per_epoch: int):
        opt = self.opt
        sched = optim_lib.make_lr_schedule(opt, steps_per_epoch)
        self.tx = optim_lib.make_adam(opt, sched, self.model)
        self.lr_sched = sched
        self.steps_per_epoch = steps_per_epoch
        self._is_multi_optimizer = (opt.get("wrapper") ==
                                    "MultipleOptimizerModel")
        self._switched = False
        self._switch_offset = 0

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
        # under a model axis the vocab head is split: the dense step's
        # gathered logits, as the JAX package keeps its dense CE there
        tp_mesh = self.mesh is not None and self.mesh.model.size > 1
        fused_xent = (bool(fx_opt)
                      and not tp_mesh
                      and "lang" in opt.get("crits", [])
                      and opt.get("cls_head") == "NaiveHead"
                      and not opt.get("pointer")
                      and not opt.get("visual_word_generation", False)
                      and not is_rnn_decoder(opt))
        self._fused_xent = fused_xent

        collect_aux = self._needs_aux
        data_axis = None if self.mesh is None else self.mesh.data
        params = list(model.parameters())

        def train_step(batch, ss_prob: float = 0.0):
            # training mode: the BatchNorm running statistics move here
            outputs = model(batch, compute_logits=not fused_xent,
                            collect_aux=collect_aux,
                            schedule_sampling_prob=ss_prob)
            results = {**outputs, **batch}
            if fused_xent and "logits" not in outputs:
                results["cls_head_kernel"] = model.cls_head.tgt_word_prj.weight
            total, losses, metrics = criterion(results,
                                               model.project_attribute)
            tx.zero_grad()
            total.backward()
            sync_data_grads(params, data_axis)
            tx.step()
            mask = outputs.get("scheduled_sampling_mask")
            if mask is not None:
                # the share of the positions after the first, where a
                # sample may be fed, that took one
                metrics = {**metrics,
                           "ss_share": mask[:, 1:].float().mean()}
            return (total.detach(),
                    {k: v.detach() for k, v in losses.items()},
                    {k: v.detach() for k, v in metrics.items()})

        return train_step

    # ------------------------------------------------------------------
    def _drain_step_stats(self, step_stats):
        """Fetch an epoch's worth of per-step device scalars in ONE stacked
        device->host transfer; yields (loss, losses_dict, metrics_dict) as
        python floats per step. On a data axis the losses (batch means) are
        averaged and the recorders (sums) summed over its processes."""
        if not step_stats:
            return
        _, losses0, metrics0 = step_stats[0]
        lk, mk = sorted(losses0), sorted(metrics0)
        flat = [x.float().reshape(()) for loss, losses, metrics in step_stats
                for x in ([loss] + [losses[k] for k in lk]
                          + [metrics[k] for k in mk])]
        mat = torch.stack(flat).reshape(len(step_stats), -1)
        ax = None if self.mesh is None else self.mesh.data
        if tp.axis_active(ax):
            mat = mat.contiguous()
            dist.all_reduce(mat, group=ax.group())
            means = [True] * (1 + len(lk)) + [k == "ss_share" for k in mk]
            mat = torch.where(torch.tensor(means, device=mat.device),
                              mat / ax.size, mat)
        mat = mat.cpu().numpy()
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
        self._maybe_build_feature_bank()

        training_scales = opt.get("training_scales", {}) or {}
        start_epoch = 0
        if opt.get("resume"):
            start_epoch = self._try_resume(training_scales)

        profile_dir = opt.get("profile_dir", "")
        for epoch in range(start_epoch, epochs):
            self.model.train()
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
            # a profiler trace over steps 5-10 of epoch 0
            with contextlib.ExitStack() as trace:
                for step_in_epoch, batch in enumerate(prefetch(
                        self.train_loader,
                        n=opt.get("prefetch_batches", 2))):
                    if profile_dir and epoch == 0 and step_in_epoch == 5:
                        trace.enter_context(profile_trace(profile_dir))
                    if step_in_epoch == 10:
                        trace.close()
                    step_stats.append(self._train_step_fn(
                        self._device_batch(batch), ss_prob))
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
            if "ss_share" in metric_sums:
                # the share of an RNN's positions fed a sampled token
                log["Sampled Share"] = metric_sums["ss_share"] / n_steps
            if self.tb:
                for k, v in log.items():
                    self.tb.add_scalar(k, v, epoch)

            # validation: generation + COCO scoring
            scores = {}
            if self.val_loader is not None and (
                    (epoch + 1) % opt.get("check_val_every_n_epoch", 1) == 0):
                scores = self.validate(epoch)

            # host-side ReduceLROnPlateau (reference Wrapper.py:362-376):
            # when the monitored metric stalls, every chain continues at a
            # scaled constant LR with its Adam moments kept
            if opt.get("lr_scheduler_type") == "plateau" and scores:
                if self._plateau is None:
                    self._plateau = optim_lib.PlateauController(opt)
                prev = self._plateau.scale
                self._plateau.update(scores)
                if self._plateau.scale != prev:
                    self.tx.set_constant_lr(
                        self._plateau.current_lr(opt["learning_rate"]))

            variables = self.variables()
            if self.is_main:
                self.ckpt_manager.on_epoch_end(epoch, variables, opt, scores)
            if opt.get("resume"):
                self._save_train_state(epoch)
            self.history.append({"epoch": epoch, **log, "n_steps": n_steps,
                                 "step_losses": step_losses,
                                 "scores": dict(scores)})
            if self.is_main:
                print(f"- epoch {epoch}: loss={log['train_loss']:.4f} "
                      f"{self._fmt_scores(scores)} ({epoch_time:.1f}s)")
        if self._world > 1:
            # the first process's checkpoints are on disk for every process
            dist.barrier(group=self.mesh.all.group())
        return self.best_scores

    # ------------------------------------------------------------------
    # mid-run resume (beyond the reference, which restarts from scratch)
    # ------------------------------------------------------------------
    def _train_state_ckpt(self) -> TrainStateCheckpointer:
        if self._ts_ckpt is None:
            state_dir = self.opt.get("train_state_dir") or os.path.join(
                self.opt.get("checkpoint_path", "./exps/run"), "train_state")
            self._ts_ckpt = TrainStateCheckpointer(state_dir)
        return self._ts_ckpt

    def _loader_rngs(self) -> Dict[str, np.random.RandomState]:
        """The train dataset's sampling streams (frame ids, caption
        subsets), so that a resumed epoch draws what the uninterrupted one
        would."""
        dataset = getattr(self.train_loader, "dataset", None)
        return {attr: getattr(dataset, attr) for attr in ("rng", "random")
                if isinstance(getattr(dataset, attr, None),
                              np.random.RandomState)}

    def _adam_params(self):
        """The parameters in the index order of the optimizer's state
        dict."""
        return [p for g in self.tx.adam.param_groups for p in g["params"]]

    def _optimizer_state(self, whole: bool, sd: dict = None) -> dict:
        """The optimizer's state dict with the moments of split parameters
        gathered whole (``whole``) or, from ``sd``, cut to this process's
        blocks."""
        sd = self.tx.state_dict() if sd is None else sd
        split = mesh_lib.split_params(self.model)
        if not split:
            return sd
        names = {id(p): n for n, p in self.model.named_parameters()}
        state = dict(sd["adam"]["state"])
        for idx, p in enumerate(self._adam_params()):
            name = names[id(p)]
            if name not in split or idx not in state:
                continue
            dim, ax = split[name]
            st = dict(state[idx])
            for k in ("exp_avg", "exp_avg_sq"):
                n = st[k].shape[dim]
                st[k] = (mesh_lib.gather_full(st[k], dim, ax) if whole else
                         st[k].narrow(dim, ax.rank * (n // ax.size),
                                      n // ax.size).contiguous())
            state[idx] = st
        return {**sd, "adam": {**sd["adam"], "state": state}}

    def _generator_states(self) -> dict:
        """Every process's dropout and sampling generator states, by
        rank."""
        mine = (self.dropout_generator.get_state(),
                self.sampling_generator.get_state())
        if self._world == 1:
            return {0: mine}
        states = [None] * self._world
        dist.all_gather_object(states, mine, group=self.mesh.all.group())
        return dict(enumerate(states))

    def _save_train_state(self, epoch: int):
        meta = {"epoch": epoch, "global_step": self.global_step,
                "switched": self._switched,
                "switch_offset": self._switch_offset,
                "ckpt_manager": self.ckpt_manager.state_dict()}
        if self._plateau is not None:
            meta["plateau"] = {"best": self._plateau.best,
                               "bad_epochs": self._plateau.bad_epochs,
                               "scale": self._plateau.scale}
        model_state = self.model.state_dict()
        optimizer = self.tx.state_dict()
        generators = {0: (self.dropout_generator.get_state(),
                          self.sampling_generator.get_state())}
        if self.mesh is not None:
            model_state.update(mesh_lib.full_values(self.model))
            optimizer = self._optimizer_state(whole=True)
            generators = self._generator_states()
        if not self.is_main:
            return
        state = {"model": model_state, "optimizer": optimizer,
                 "generator": generators[0][0],
                 "sampling_generator": generators[0][1],
                 "loader_rngs": {k: _rng_state(r)
                                 for k, r in self._loader_rngs().items()}}
        if self.mesh is not None:
            state["generators"] = {str(r): list(g)
                                   for r, g in generators.items()}
        self._train_state_ckpt().save(epoch, state, meta)

    def _try_resume(self, training_scales) -> int:
        """Restore the latest epoch's train state (if any); returns the
        epoch to continue from."""
        ts = self._train_state_ckpt()
        latest = ts.latest_epoch()
        if latest is None:
            return 0
        opt = self.opt
        meta = ts.restore_meta(latest)
        self.global_step = int(meta["global_step"])

        # replay the optimizer phase so the optimizer's chains line up
        for e in range(latest + 1):
            if e in training_scales:
                self.criterion.set_scales(training_scales[e])
        if meta.get("switched"):
            self._switch_offset = int(meta.get("switch_offset", 0))
            self.tx = optim_lib.make_dual_adam(
                opt, self.model, self.steps_per_epoch,
                offset_steps=self._switch_offset)
            self._switched = True
        if meta.get("plateau"):
            self._plateau = optim_lib.PlateauController(opt)
            self._plateau.best = meta["plateau"]["best"]
            self._plateau.bad_epochs = int(meta["plateau"]["bad_epochs"])
            self._plateau.scale = float(meta["plateau"]["scale"])
            if self._plateau.scale != 1.0:
                self.tx.set_constant_lr(
                    self._plateau.current_lr(opt["learning_rate"]))
        self.ckpt_manager.load_state_dict(meta.get("ckpt_manager", {}))

        state = ts.restore_state(latest)
        if self.mesh is None:
            self.model.load_state_dict(state["model"])
            self.tx.load_state_dict(state["optimizer"])
            self.dropout_generator.set_state(state["generator"])
            self.sampling_generator.set_state(state["sampling_generator"])
        else:
            self.model.load_state_dict(mesh_lib.local_values(self.model,
                                                             state["model"]))
            self.tx.load_state_dict(self._optimizer_state(
                whole=False, sd=state["optimizer"]))
            dropout, sampling = state["generators"][str(self.mesh.all.rank)]
            self.dropout_generator.set_state(dropout)
            self.sampling_generator.set_state(sampling)
        rngs = self._loader_rngs()
        for k, st in state["loader_rngs"].items():
            _set_rng_state(rngs[k], st)
        self._train_step_fn = None
        if self.is_main:
            print(f"- resumed train state from epoch {latest}")
        return latest + 1

    def _fmt_scores(self, scores):
        keys = ["CIDEr", "Bleu_4", "METEOR", "ROUGE_L", "Sum"]
        return " ".join(f"{k}={scores[k]:.4f}" for k in keys if k in scores)

    # ------------------------------------------------------------------
    # caption generation and scoring
    # ------------------------------------------------------------------
    def _get_teacher(self):
        """(the AR teacher Captioner, the vocabulary mapping) for NAR
        rescoring (reference ``Wrapper.py:287-294``), loaded once onto the
        trainer's device; (None, None) for an AR model or without a
        ``teacher_path``. The mapping is None where the corpora cannot be
        read or have the same vocabulary, as in the JAX package."""
        if (self.opt.get("decoding_type") != "NARFormer"
                or not self.opt.get("teacher_path")):
            return None, None
        if self._teacher is None:
            from care_tpu_torch.models.loading import (get_vocab_mapping,
                                                       load_model)
            models, t_opt = load_model(self.opt["teacher_path"],
                                       device=self.device)
            try:
                vm = get_vocab_mapping(self.opt, t_opt)
            except Exception:
                vm = None
            self._teacher = (models[0], vm)
        return self._teacher

    def _teacher_kwargs(self) -> Dict[str, Any]:
        teacher, vocab_mapping = self._get_teacher()
        if teacher is None:
            return {}
        return {"teacher": teacher, "vocab_mapping": vocab_mapping}

    # ------------------------------------------------------------------
    # evaluation on a mesh
    # ------------------------------------------------------------------
    def _local_batches(self, loader):
        """(this process's rows of each evaluation batch, whether its
        concept metrics count here): on a mesh the rows of its data
        coordinate, or the whole of a batch that does not split; the
        metrics of each batch count once, on the first process of a model
        group that holds its rows."""
        for b in loader:
            if self.mesh is None:
                yield b, True
                continue
            split = mesh_lib.batch_divides(b, self.mesh)
            counts = self.mesh.model.rank == 0 and (
                split or self.mesh.data.rank == 0)
            yield mesh_lib.local_rows(b, self.mesh), counts

    def _gather_eval(self, pred_batches, metric_rows):
        """The captions of every batch (a dict per batch) and the concept
        metric rows of every process, in the global row order, on the
        first process (None on the others); as they are without a mesh."""
        if self._world == 1:
            preds = {}
            for p in pred_batches:
                preds.update(p)
            return preds, metric_rows
        mine = (self.mesh.data.rank, self.mesh.model.rank, pred_batches,
                metric_rows)
        everyone = [None] * self._world if self.is_main else None
        dist.gather_object(mine, everyone, dst=self.mesh.root,
                           group=self.mesh.all.group())
        if not self.is_main:
            return None, None
        firsts = sorted((e for e in everyone if e[1] == 0),
                        key=lambda e: e[0])
        preds, rows = {}, []
        for i in range(len(pred_batches)):
            for e in firsts:
                preds.update(e[2][i])
        for e in firsts:
            rows.extend(e[3])
        return preds, rows

    def _share(self, value):
        """The first process's ``value`` on every process."""
        if self._world == 1:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=self.mesh.root,
                                   group=self.mesh.all.group())
        return box[0]

    def translate_step(self, batch) -> Dict[str, list]:
        """Generate captions for a batch; returns dict[vid] -> preds."""
        hyps, scores = self.translator.translate_batch(
            self.model, device_batch(batch, self.device),
            **self._teacher_kwargs())
        return self._collect_preds(batch, hyps, scores)

    def _collect_preds(self, batch, hyps, scores) -> Dict[str, list]:
        preds = {}
        mask = batch.get("batch_mask")
        for i, vid in enumerate(batch["video_ids"]):
            if mask is not None and not bool(mask[i]):
                continue  # padded duplicate row (pad_to_batch loaders)
            entries = []
            hyps_i = hyps[i] if isinstance(hyps[i][0], list) else [hyps[i]]
            for k, hyp in enumerate(hyps_i):
                caption = to_sentence(hyp, self.vocab)
                score = scores[i][k] if isinstance(scores[i], list) \
                    else scores[i]
                entries.append({"image_id": vid, "caption": caption,
                                "score": float(np.ravel(score)[0])})
            preds[vid] = entries
        return preds

    def _sum_score(self, scores: dict) -> float:
        candidate = [scores["Bleu_4"], scores["METEOR"], scores["ROUGE_L"],
                     scores["CIDEr"]]
        return sum(s for s, flag in zip(candidate, self.opt["metric_sum"])
                   if flag)

    @torch.no_grad()
    def validate(self, epoch: int = 0, loader=None, references=None,
                 log_prefix: str = "") -> Dict[str, float]:
        """Caption the validation set with beam search (the model in eval
        mode), score it with the COCO metrics, add the concept detector's
        F1@k and mAP from the eval criterion, ``Sum`` by ``metric_sum``, and
        keep the best ``Sum`` and ``CIDEr``."""
        loader = loader or self.val_loader
        references = references or self.references
        was_training = self.model.training
        self.model.eval()
        run_concept_metrics = "attribute" in self.eval_criterion.crits
        pred_batches = []
        # per-batch metric scalars stay on the device until the pass ends
        batch_metrics = []
        # the validation set's features upload once; the dataset keeps
        # reading host features (no skip_feats), so a batch the bank does
        # not cover ships them
        val_bank = self._maybe_val_bank(loader)
        tkw = self._teacher_kwargs()

        def to_device(b):
            served = (self._bank_serve(val_bank, b) if "feats" in b
                      else None)
            return served if served is not None else device_batch(
                b, self.device)

        def tagged():
            for b, counts in self._local_batches(loader):
                db = to_device(b)
                yield (b, db, counts), db

        # up to eval_fused_k decodes in flight before their outputs are
        # fetched
        stream = self.translator.translate_batches_grouped(
            self.model, tagged(), int(self.opt.get("eval_fused_k", 4)),
            **tkw)

        try:
            for (batch, db, counts), (hyps, scores) in stream:
                pred_batches.append(self._collect_preds(batch, hyps, scores))
                if run_concept_metrics and "labels_attr" in batch:
                    outputs = self.model(db, compute_logits=False,
                                         collect_aux=self._needs_aux)
                    m = self.eval_criterion(
                        {**outputs, **db}, self.model.project_attribute)[2]
                    if counts:
                        batch_metrics.append(m)
        finally:
            self.model.train(was_training)

        rows = []
        if batch_metrics:
            keys = sorted(batch_metrics[0])
            mat = torch.stack([m[k].float().reshape(()) for m in batch_metrics
                               for k in keys]).reshape(len(batch_metrics), -1)
            rows = [dict(zip(keys, row)) for row in mat.cpu().numpy()]
        preds, rows = self._gather_eval(pred_batches, rows)
        scores = (self._score_validation(references, preds, rows)
                  if self.is_main else None)
        scores = self._share(scores)

        for key in ("Sum", "CIDEr"):
            if scores[key] > self.best_scores.get(key, float("-inf")):
                self.best_scores[key] = scores[key]
        if self.tb:
            for k, v in scores.items():
                if isinstance(v, (int, float)):
                    self.tb.add_scalar(f"{log_prefix or 'vali'}_{k}", v,
                                       epoch)
        return scores

    def _score_validation(self, references, preds, rows) -> Dict[str, float]:
        tracker = MetricTracker()
        for row in rows:
            tracker.update(row)
        scorer = COCOScorer()
        scores, _ = scorer.score(references, preds, list(preds.keys()))
        for topk in (5, 10, 20, 30, 40, 50):
            if tracker.sums.get(f"V_f1_{topk}_count"):
                scores[f"F1-{topk:02d}"] = tracker.ratio(
                    f"V_f1_{topk}_sum", f"V_f1_{topk}_count")
        if tracker.sums.get("V_ap_count"):
            scores["mAP"] = tracker.ratio("V_ap_sum", "V_ap_count")
        scores["Sum"] = self._sum_score(scores)
        return scores

    @torch.no_grad()
    def test(self, loader=None, references=None, info_corpus=None,
             save_csv_path: Optional[str] = None,
             keys_added_to_scores=("seed",)) -> Dict[str, float]:
        """Best-checkpoint evaluation + caption-quality analysis + CSV
        (reference ``Wrapper.py:75-149``). On a mesh the first process
        scores and writes; every process returns its scores."""
        loader = loader or self.test_loader
        references = references or self.references
        was_training = self.model.training
        self.model.eval()
        pred_batches = []
        try:
            for batch, _ in self._local_batches(loader):
                pred_batches.append(self.translate_step(batch))
        finally:
            self.model.train(was_training)
        preds, _ = self._gather_eval(pred_batches, [])
        scores = (self._score_test(references, preds, info_corpus,
                                   save_csv_path, keys_added_to_scores)
                  if self.is_main else None)
        return self._share(scores)

    def _score_test(self, references, preds, info_corpus, save_csv_path,
                    keys_added_to_scores) -> Dict[str, float]:
        # VATEX missing-video completion from an I3D model's predictions
        # (reference ``Wrapper.py:94-105``)
        if (self.opt.get("dataset") == "VATEX"
                and self.opt.get("feats", "") != "I3D"
                and self.opt.get("VATEX_I3D_preds_json", "")):
            with open(self.opt["VATEX_I3D_preds_json"]) as f:
                completion = json.load(f)
            n_missing = 0
            for key, val in completion.items():
                if key not in preds:
                    preds[key] = val
                    n_missing += 1
            if n_missing:
                print(f"- Adding {n_missing} missing predictions")

        scorer = COCOScorer()
        scores, detail = scorer.score(references, preds, list(preds.keys()))
        scores["Sum"] = self._sum_score(scores)

        for key in keys_added_to_scores:
            v = self.opt.get(key)
            scores[key] = ("-".join(map(str, v))
                           if isinstance(v, (list, tuple)) else v)

        if info_corpus is not None:
            ave_length, novel, unique, usage = analyze_length_novel_unique(
                info_corpus["captions"], preds, vocab=self.vocab,
                splits=info_corpus["info"]["split"], n=1)
            scores.update({"ave_length": ave_length, "novel": novel,
                           "unique": unique, "usage": usage})

        if self.opt.get("save_csv", False):
            path = save_csv_path or self.opt["checkpoint_path"]
            save_dict_to_csv(path, self.opt.get("csv_name",
                                                "test_result.csv"), scores)

        # prediction/detail dumps (reference ``Wrapper.py:136-140`` +
        # ``translate.py:78-81``)
        if self.opt.get("json_path", ""):
            os.makedirs(self.opt["json_path"], exist_ok=True)
            with open(os.path.join(self.opt["json_path"],
                                   self.opt.get("json_name", "preds.json")),
                      "w") as f:
                json.dump(preds, f)
        if self.opt.get("save_detail_scores_path", ""):
            p = self.opt["save_detail_scores_path"]
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
            with open(p, "w") as f:
                json.dump(detail, f)
        return scores

    def load_best(self):
        """Load the best checkpoint's weights into the model (no-op when no
        checkpoint was kept); returns the model."""
        path = self.ckpt_manager.best_path
        if path:
            variables, _, _ = load_checkpoint(path, self.variables())
            self.load_variables(variables)
        return self.model
