"""Mean-teacher training (reference ``InterplayModel``, ``Wrapper.py:550-614``).

Port of ``care_tpu/training/mean_teacher.py``. A second copy of the
captioner's parameters (the teacher) follows the student as an exponential
moving average; the train step adds an MSE distillation term between the
student's and the teacher's logits; the checkpoint and the test decode take
the teacher (``eval_model``, default ``teacher``). The student's BatchNorm
running statistics are shared: only the parameters are copied.

As in ``care_tpu``, the step runs on dense logits (the fused cross-entropy
is never taken here), and the epoch loop is the JAX package's own: no
dual-Adam switch, no feature bank, no resume and no profiler; validation
every epoch decodes the student, the checkpoint it selects stores the
teacher, and ``test`` decodes the teacher in memory. On a mesh the step
averages the student's gradients over the data axis and the checkpoint
holds the teacher's gathered parameters, as ``Trainer`` does.
"""

import contextlib
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.func import functional_call

from care_tpu_torch.models.weights import params_to_jax
from care_tpu_torch.parallel.mesh import gather_full, split_params
from care_tpu_torch.training.trainer import (Trainer,
                                             schedule_sampling_prob,
                                             sync_data_grads)


class MeanTeacherTrainer(Trainer):
    def __init__(self, opt: dict, **kwargs):
        super().__init__(opt, **kwargs)
        # parameter name -> the teacher's tensor
        self.teacher_params: Optional[Dict[str, torch.Tensor]] = None

    def init_model(self, seed: int = None):
        model = super().init_model(seed)
        self.teacher_params = {name: p.detach().clone()
                               for name, p in model.named_parameters()}
        return model

    def _make_train_step(self):
        model = self.model
        criterion = self.criterion
        tx = self.tx
        opt = self.opt
        distillation_weight = opt.get("distillation_weight", 0.01)
        ema_weight = opt.get("ema_weight", 0.999)
        collect_aux = self._needs_aux
        names = [name for name, _ in model.named_parameters()]
        student = [p for _, p in model.named_parameters()]
        teacher = [self.teacher_params[name] for name in names]
        self._fused_xent = False
        data_axis = None if self.mesh is None else self.mesh.data

        def train_step(batch, ss_prob: float = 0.0):
            # the teacher: the same module on the teacher's parameters and
            # the student's running statistics, dropout off, no gradient
            model.eval()
            with torch.no_grad():
                teacher_logits = functional_call(
                    model, self.teacher_params, (batch,),
                    {"collect_aux": False})["logits"]
            model.train()

            outputs = model(batch, collect_aux=collect_aux,
                            schedule_sampling_prob=ss_prob)
            cap_loss, losses, metrics = criterion({**outputs, **batch},
                                                  model.project_attribute)
            logits = outputs["logits"]
            if isinstance(logits, list):
                logits = logits[-1]
            t_logits = (teacher_logits[-1]
                        if isinstance(teacher_logits, list)
                        else teacher_logits)
            dist_loss = torch.mean((logits - t_logits) ** 2)
            total = cap_loss + distillation_weight * dist_loss
            losses = {**losses, "Distillation Loss": dist_loss}
            tx.zero_grad()
            total.backward()
            sync_data_grads(student, data_axis)
            tx.step()
            # the EMA update, in care_tpu's form: ema * t + (1 - ema) * s
            with torch.no_grad():
                scaled = torch._foreach_mul(student, 1 - ema_weight)
                torch._foreach_mul_(teacher, ema_weight)
                torch._foreach_add_(teacher, scaled)
            return (total.detach(),
                    {k: v.detach() for k, v in losses.items()},
                    {k: v.detach() for k, v in metrics.items()})

        return train_step

    def fit(self, epochs: Optional[int] = None):
        opt = self.opt
        epochs = epochs if epochs is not None else opt["epochs"]
        if self.model is None:
            self.init_model()
        if self.tx is None:
            self._build_tx(max(len(self.train_loader), 1))

        # the step generators start from the run's seed, as care_tpu's
        # step key does (seed + 1)
        self.dropout_generator.manual_seed(opt.get("seed", 0) + 1
                                           + self._stream())
        self.sampling_generator.manual_seed(opt.get("seed", 0) + 2
                                            + self._stream())
        step_fn = self._make_train_step()
        for epoch in range(epochs):
            self.model.train()
            self.train_loader.set_epoch(epoch)
            ss_prob = schedule_sampling_prob(opt, epoch)
            t0 = time.time()
            step_stats = []
            for batch in self.train_loader:
                step_stats.append(step_fn(self._device_batch(batch),
                                          ss_prob))
                self.global_step += 1
            step_losses = [lv for lv, _, _ in
                           self._drain_step_stats(step_stats)]
            loss = sum(step_losses) / max(len(step_losses), 1)
            epoch_time = time.time() - t0

            scores = {}
            if self.val_loader is not None:
                scores = self.validate(epoch)
            variables = self._eval_variables()
            if self.is_main:
                self.ckpt_manager.on_epoch_end(epoch, variables, opt, scores)
            self.history.append({"epoch": epoch, "train_loss": loss,
                                 "epoch_time": epoch_time,
                                 "n_steps": len(step_losses),
                                 "step_losses": step_losses,
                                 "scores": dict(scores)})
            if self.is_main:
                print(f"- epoch {epoch}: loss={loss:.4f} "
                      f"{self._fmt_scores(scores)}")
        if self._world > 1:
            dist.barrier(group=self.mesh.all.group())
        return self.best_scores

    def _eval_variables(self):
        """The checkpoint's variables: the teacher's parameters with the
        student's running statistics (``eval_model: teacher``), else the
        student's."""
        variables = self.variables()
        if self.opt.get("eval_model", "teacher") == "teacher":
            teacher = self.teacher_params
            # on a mesh's model axis the teacher's split blocks, gathered
            for name, (dim, ax) in split_params(self.model).items():
                teacher = {**teacher,
                           name: gather_full(teacher[name], dim, ax)}
            variables["params"] = params_to_jax(self.model, teacher)
        return variables

    @contextlib.contextmanager
    def _eval_weights(self):
        """The model holds the weights ``_eval_variables`` names for the
        block (the teacher's copied in, the student's restored after)."""
        if self.opt.get("eval_model", "teacher") != "teacher":
            yield
            return
        params = [p for _, p in self.model.named_parameters()]
        teacher = [self.teacher_params[name]
                   for name, _ in self.model.named_parameters()]
        with torch.no_grad():
            saved = [p.detach().clone() for p in params]
            torch._foreach_copy_(params, teacher)
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(params, saved)

    def translate_step(self, batch):
        # evaluate with the teacher (reference swap_captioners)
        with self._eval_weights():
            return super().translate_step(batch)
