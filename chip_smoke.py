"""Chip smoke test of the PyTorch/CUDA port (``care_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero
before the last line:

1. device: the card's name, ``nvidia-smi``'s name and power limit, the
   torch and CUDA versions, which optional packages import (``h5py``,
   ``pandas``, ``nltk``, ``tensorboardX``). Fails at once without a CUDA
   device.
2. build: every kernel of the serving and training paths (seven sources)
   is compiled with ``nvcc`` from ``care_tpu_torch/csrc``, all at once,
   printing the build seconds and the ``-Xptxas -v`` register and
   shared-memory summary.
3. check: each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it and in the tie, bf16, bias
   and ragged cases; the flash-attention kernels also against the dense
   attention and its autograd, at the decode shape q [64, 8, 5, 64] x 1654
   keys, the square shape [4, 8, 1568, 64], ragged tiles, every bias shape,
   an all-masked instance and bf16.
4. serve: the full-width CARE flagship (MSRVTT, Transformer, CARE, ViT,
   VA/VAT; random weights from a seed) captions 3 batches of 64 synthetic
   videos and one ragged batch of 17 through
   ``get_translator(opt).translate_batch``; then the long-key configuration
   (``--feats SwinBERTDense``: 1568 rows of motion, 1654 cross-attention
   keys) captions 2 batches of 64 and one of 17 with task ``CARE`` and one
   batch of 64 with task ``Base``, the cross attention of every beam step
   going through the flash-attention kernel. The kernel launch counts must
   match the beam steps run (times the decoder layers for the flash
   kernel), and every returned score must equal the teacher-forced score of
   its tokens from the full forward, which runs the dense attention. One
   batch of each configuration is profiled. Then half precision
   (``compute_dtype_decode: bfloat16``): the flagship, the flagship with
   ``decode_head_f32``, and the long-key ``CARE`` and ``Base``
   configurations, each beside its f32 run; the scores re-checked by
   teacher forcing the served bf16 model. Modules compute in the promoted
   dtype of their operands, as the JAX package's do: the ``CARE`` task's
   f32 concept vector makes its decoder f32, so its K1 and K4a launch in
   f32, while ``Base`` launches both in bf16 (the counts are asserted).
5. flash gradient: three descent steps through
   ``flash_attention(backward="kernel")`` at the square shape, which is the
   entry point of the two backward kernels (no model path reaches them).
6. train: ``Trainer(opt, loader).fit()`` trains the flagship with
   ``fused_xent: True`` for 2 epochs of 4 synthetic batches of 64, dropout
   on, through the dual-Adam switch. Every step's cross-entropy must go
   forward through the argmax/lse kernel and backward through the dh and
   dW kernels (launch counts == steps), every loss must be finite and the
   last steps' mean below the first. Then fused against dense from one
   seed with dropout off, the ``auto`` policy at batch 64 and 192, ms per
   step and peak memory for both, a profile of one fused step, and the
   scratch of the dh and dW kernels.
7. pipeline: the port's main path as ``care_tpu_torch.train.run`` drives
   it, on the flagship at full width: a synthetic dataset of 400 videos in
   the reference's layout (HDF5 when ``h5py`` imports, else the same
   arrays in memory through a ``JointDataset`` whose stores are dicts; the
   vocabulary widened to 11 000 words), 2 epochs of ``Trainer.fit`` at
   batch 64 through the port's loader with the fused cross-entropy, beam
   search validation and COCO scores after each epoch, top-1 checkpoints on
   CIDEr, ``load_best`` and ``test``. The vocab head + top-k kernel must
   launch once per beam step of every validation and test batch, the
   cross-entropy kernels once per train step. It prints the losses, every
   COCO dict, the loader's host time per batch against a step's device
   time, validation captions per second, the scorer's seconds, checkpoint
   seconds and bytes; then a run of 1 epoch and a fresh trainer resuming
   it to 2 must reproduce the main run's epoch-1 loss (1e-5 relative) and
   final parameters (1e-5 absolute). It runs on ``care_tpu``'s defaults:
   the train batches' features come from the device feature bank (lookups
   == train steps; the loader with ``skip_feats`` timed beside the loader
   that reads features), and validation decodes in groups of
   ``eval_fused_k`` batches, whose captions, scores and COCO dict must
   equal batch-by-batch validation's (``==``).
7b. entry: ``care_tpu_torch.translate.main`` on the pipeline's best
   checkpoint through ``load_model``: ``--fused_k 4`` against pipelined
   (equal predictions JSON and COCO dict), ``--latency`` at
   batch 1 (a ``latency.txt`` line in a temporary directory), and
   ``care_tpu_torch.eval_json`` on the written predictions (the scores of
   ``run_eval``); K1 launches == beam steps.
7c. bank: the device feature bank at the flagship's MSRVTT size (10 000
   videos x 60 frames x (128 + 2048 + 512) plus 20 x 512 retrieval rows),
   in f32 and bf16 storage: resident bytes, build seconds, gather ms at
   batch 64.
7d. family: the rest of the CARE Transformer family at full width
   (``--arch base``, V 11 000, batch 64, beam 5): CABase
   (``scripts/exp_main_MSRVTT.sh:34``), the concept-attention sublayer
   ``G1L1`` in the ``parallel`` and ``attr2cross`` placements, semantic
   composition ``G0Lc --compositional_intra --compositional_ffn
   --add_hybrid_attention_bias``, ``--method ARB --task CARE`` (the
   HighWay / BatchNorm encoder) and ``G1L1 parallel`` at ``--feats
   SwinBERTDense``. Each trains 4 steps with ``fused_xent: True`` (K2, K3a
   and K3b once per step; ARB's running statistics must move) and serves
   one batch of 64 (K1 once per beam step, K4a once per beam step and layer
   at long keys, every score re-checked by teacher forcing, caps/s and ms
   per beam step); the CABase batch and the long-key one are profiled.
7e. nar: non-autoregressive decoding at full width (``--arch base``,
   MSRVTT ViT, V 11 000, batch 64, ``max_len`` 30): the ARB CARE teacher
   (``scripts/exp_versatility_of_CARE.sh:60``) trains 4 steps and is
   checkpointed; the NACF CARE student (``:64``,
   ``--with_teacher_during_training``) takes the teacher's weights
   (``load_teacher_weights_into_student``; the leaves filled are printed)
   and trains 4 steps (no vocab-kernel launch: NACF's multi-pass loss
   stays dense); one batch of 64 is served with teacher rescoring by
   mask-predict with the template (``use_ct``, 5 iterations, length beam
   6; K2 launches == 1 template pass + 5 iterations + 1 rescoring = 7),
   then by ``l2r`` and ``ef`` (K2 == passes); the mask-predict batch again
   with the plain version in K2's place (hypotheses identical, log-probs
   within 1e-5); K2 against its plain version at the decode's shape
   [11 520, 512] x [11 000, 512] with token ids, f32 and bf16.
7f. rnn: the RNN captioners at full width (``--arch base``, MSRVTT ViT,
   ``--modality ami -dm VA -pm VAT``, V 11 000, batch 64, beam 5,
   ``max_len`` 30): SALSTM CARE (``scripts/exp_versatility_of_CARE.sh:34``),
   TopDown CARE (``:44``) and the ``VOE`` preset each train 2 epochs of 2
   batches with dropout on and scheduled sampling at 0.25 in epoch 1 (the
   share of positions fed a sample printed and held to a binomial bound;
   VOE's running statistics must move) and serve one batch of 64 and the
   ragged 17, every score re-checked by teacher forcing; no kernel
   launches, as ``care_tpu`` keeps these models off the fused head and the
   fused cross-entropy. The SALSTM batch is profiled, and SALSTM is served
   in bf16 beside f32 (decode-step log-probs within 2% of the step's
   largest |log-prob|).
7g. pointer: PointerGen Base and PointerGen CARE on MSRVTT
   (``scripts/exp_versatility_of_CARE.sh:70, :74``) at full width, 20
   retrieved captions of 30 token ids a video (``exclude_eos``; half the
   words from 20 frequent ids, so ids repeat): each trains 2 epochs of 2
   batches of 64 with dropout on, then again from the same seed (losses
   equal, parameter gap exactly 0.0: the copy scatter repeats bit for
   bit), the peak of allocated memory and ms a step printed; the pointer
   of one beam step is timed alone at the serving shape; ``_serve``
   decodes one batch of 64 and the ragged 17 through the dense pointer
   step (scores re-checked by teacher forcing on the pointer's
   probabilities), the batch of 64 profiled with the pointer's share of
   device time; no kernel launches, as ``care_tpu`` keeps pointer models
   off K1, the fused cross-entropy and flash attention.
7h. ensemble: PointerGen CARE with itself decodes what it decodes alone
   (``==``); the heterogeneous ensemble of the flagship (``amir``) and
   PointerGen CARE (``amirt``) decodes 3 batches of 64 and the ragged 17,
   features split from the union by ``EnsembleSpec``, batch by batch and
   grouped (fused-K 4) with equal results, caps/s of each; then
   ``care_tpu_torch.translate.main -cp a b`` on the two checkpoints the
   phase writes, over a synthetic dataset with a retrieval database. No
   kernel launches.
7i. backbone: the visual front at full width. The flagship with CLIP
   ViT-B/32 (patch 32, width 768, 12 layers, 12 heads, output 512, 224 x
   224; ``with_backbones`` on the image stream) serves 64 + 17 videos of 28
   raw frames (K1 == beam steps, scores re-checked by teacher forcing, one
   batch profiled with the backbone's share of device time, the 1.08 GB
   frame copy timed alone, 2 videos equal to the CPU's beams) and trains 4
   fused steps at batch 16 twice from one seed (K2, K3a, K3b == steps; ms
   a step, peak memory; parameter gap 0.0 with cuDNN deterministic); CLIP
   ViT-B/32, ResNet-50 and InceptionResNetV2 encode 448 frames each
   (images/s, held to the CPU on 4 frames); the retrieval database at
   MSRVTT's size (10 000 videos x 20 captions of 512: top-k indices equal
   to the CPU's, evaluation metrics, ranks of 500 videos equal to the
   CPU's); the patch encoders ``CNN1``-``CNN3`` and
   ``SingleStreamEmbedder`` with the flagship's decoder take one fused
   train step and decode 64 each (beams of 2 videos equal to the CPU's).
8. time: each kernel, its plain version, the unfused torch sequence and,
   for the flash kernels, ``F.scaled_dot_product_attention`` (timed here,
   used nowhere in the port), warm launches timed with CUDA events, beside
   the kernel's bound on the tensor cores (3xTF32 for f32 work) and its f32
   CUDA-core bound; the four vocab kernels and the two flash backward
   kernels also in bf16. The yardstick of the dh kernel is the autograd
   backward of the unfused sequence for dh alone, of the dW kernel the same
   for dW alone; of the dq kernel SDPA's autograd backward for dq alone, of
   the dk/dv/dbias kernel the same for dk and dv alone (the joint ones
   beside), event-timed and as device time. K2 also at the NAR decode's
   shape (11 520 rows, with and without token ids, f32 and bf16) beside
   the unfused library sequence and its bound, under ``nar_`` keys of its
   line.

The line before the last is a JSON object with one entry per kernel; the
last line is the device JSON object.
"""

import concurrent.futures
import functools
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from care_tpu_torch import constants
from care_tpu_torch.config import get_opt
from care_tpu_torch.data import corpus as corpus_lib
from care_tpu_torch.data import get_loader
from care_tpu_torch.data.datasets import JointDataset
from care_tpu_torch.data.loader import Loader
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.metrics import COCOScorer
from care_tpu_torch.models import build_captioner
from care_tpu_torch.ops import _build
from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.ops import fused_head_topk as fht
from care_tpu_torch.ops import fused_xent as fx
from care_tpu_torch.ops.attention import dot_product_attention
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.trainer import device_batch

SEED = 0
BATCH, RAGGED = 64, 17
TRAIN_BATCHES, TRAIN_EPOCHS = 4, 2
# NVIDIA H100 SXM data-sheet peaks at 700 W: HBM3 bandwidth; f32 on the
# CUDA cores (no tensor cores); dense TF32 and bf16 on the tensor cores. An
# f32 product as accurate as f32 takes three TF32 products on the tensor
# cores (3xTF32, csrc/tile_logits_tc.cuh), so its bound is 3 x flops at the
# TF32 rate; the CUDA-core bound is kept beside it for the earlier readings
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

KERNELS = {
    "fused_head_topk": dict(
        route="cuda", source="care_tpu_torch/csrc/fused_head_topk.cu",
        replaces="care_tpu/ops/fused_head_topk.py:151"),
    "vocab_argmax_lse": dict(
        route="cuda", source="care_tpu_torch/csrc/vocab_argmax_lse.cu",
        replaces="care_tpu/ops/fused_head_topk.py:307"),
    "fused_xent_bwd_dh": dict(
        route="cuda", source="care_tpu_torch/csrc/fused_xent_bwd_dh.cu",
        replaces="care_tpu/ops/fused_xent.py:147"),
    "fused_xent_bwd_dw": dict(
        route="cuda", source="care_tpu_torch/csrc/fused_xent_bwd_dw.cu",
        replaces="care_tpu/ops/fused_xent.py:169"),
    "flash_attention_fwd": dict(
        route="cuda", source="care_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="care_tpu/ops/pallas/flash_attention.py:25"),
    "flash_attention_bwd_dq": dict(
        route="cuda", source="care_tpu_torch/csrc/flash_attention_bwd_dq.cu",
        replaces="care_tpu/ops/pallas/flash_attention.py:182"),
    "flash_attention_bwd_dkv": dict(
        route="cuda", source="care_tpu_torch/csrc/flash_attention_bwd_dkv.cu",
        replaces="care_tpu/ops/pallas/flash_attention.py:219"),
}
# device kernels of each entry, as the profiler names them
DEVICE_KERNELS = {
    "fused_head_topk": ("head_stats_tc_kernel", "merge_kernel"),
    "vocab_argmax_lse": ("xent_stats_tc_kernel", "xent_stats_reduce_kernel"),
    "fused_xent_bwd_dh": ("xent_dh_tc_kernel",),
    "fused_xent_bwd_dw": ("xent_dw_tc_kernel",),
    "flash_attention_fwd": ("flash_fwd_kernel", "flash_fwd_decode_kernel"),
    "flash_attention_bwd_dq": ("flash_bwd_dq_kernel",),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_kernel",),
}


def _bf16_launch_counts() -> dict:
    """The launches of the two kernels that serving runs in either dtype
    that ran their bf16 instance."""
    return {"fused_head_topk": fht.bf16_launches,
            "flash_attention_fwd": fa.fwd_bf16_launches}


def _launch_counts() -> dict:
    return {"fused_head_topk": fht.launches,
            "vocab_argmax_lse": fht.argmax_lse_launches,
            "fused_xent_bwd_dh": fx.dh_launches,
            "fused_xent_bwd_dw": fx.dw_launches,
            "flash_attention_fwd": fa.fwd_launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches}


def _zero_launch_counts() -> None:
    fht.launches = fht.argmax_lse_launches = fht.bf16_launches = 0
    fx.dh_launches = fx.dw_launches = 0
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    fa.fwd_bf16_launches = 0


def flagship_opt(arch: str = "base") -> dict:
    """The flagship serving configuration at full width
    (``__graft_entry__.py:_flagship_opt``); ``arch`` picks another width
    preset (``median`` H 768, ``large`` H 1024)."""
    opt = get_opt({"dataset": "MSRVTT", "method": "Transformer",
                   "task": "CARE", "feats": "ViT",
                   "decoder_modality_flags": "VA",
                   "predictor_modality_flags": "VAT", "vocab_size": 11000,
                   "arch": arch},
                  read_vocab=False, resolve_paths=False)
    opt["dim_a"], opt["dim_m"], opt["dim_i"], opt["dim_r"] = 128, 2048, 512, 512
    return opt


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}"
    print(f"device: {name}; count {torch.cuda.device_count()}")
    print(smi_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("optional packages: " + ", ".join(
        f"{p} {'present' if importlib.util.find_spec(p) else 'absent'}"
        for p in OPTIONAL_PACKAGES))
    return name, smi_line


def phase_build() -> None:
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, info in builds.items():
        # the -Xptxas -v summary: one "Used N registers" and one spill line
        # for each entry function (template instance) of the source
        registers = [int(m) for m in re.findall(r"Used (\d+) registers",
                                                info["log"])]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             info["log"])]
        print(f"build {name}: {info['seconds']:.1f} s; {len(registers)} "
              f"entry functions, {min(registers, default=0)}-"
              f"{max(registers, default=0)} registers, at most "
              f"{max(spills, default=0)} bytes of spill stores")


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def _head_inputs(rows, H, V, dtype, exact, seed):
    """h [rows, H], W [V, H] on the card. ``exact`` draws small dyadic
    values whose products and sums are exact in f32, so any summation order
    gives bit-identical logits (and exact ties where columns repeat)."""
    g = torch.Generator().manual_seed(seed)
    if exact:
        h = torch.randint(-4, 5, (rows, H), generator=g).float() / 8
        W = torch.randint(-8, 9, (V, H), generator=g).float() / 64
    else:
        h = torch.randn((rows, H), generator=g)
        W = (torch.rand((V, H), generator=g) * 2 - 1) * (6 / (H + V)) ** 0.5
    return h.to("cuda", dtype), W.to("cuda", dtype)


def _check_head_case(label, h, W, K, ties_exact, b=None):
    got = fht._stats_cuda(h, W, b, K)
    want = fht._stats_plain(h, W, b, K + 1, 1024)
    torch.cuda.synchronize()
    cv, ids, m, s = (t.cpu() for t in got)
    pv, pi, pm, ps = (t.cpu() for t in want)
    err_m = (m - pm).abs().max().item()
    err_logs = (s.log() - ps.log()).abs().max().item()
    err_cv = (cv - pv[:, :K]).abs().max().item()
    assert torch.allclose(m, pm, rtol=1e-5, atol=1e-6), (label, err_m)
    assert torch.allclose(s.log(), ps.log(), rtol=1e-5, atol=1e-6), \
        (label, err_logs)
    assert err_cv <= 1e-4, (label, err_cv)
    ids = ids.long()
    if ties_exact:
        assert torch.equal(ids, pi[:, :K]), label
    else:
        # ids must agree wherever a candidate is separated from both its
        # neighbours in the ranking by more than the value tolerance
        gap_prev = torch.cat([torch.full((pv.shape[0], 1), float("inf")),
                              pv[:, :K - 1] - pv[:, 1:K]], dim=1)
        gap_next = pv[:, :K] - pv[:, 1:K + 1]
        sep = (gap_prev > 1e-4) & (gap_next > 1e-4)
        assert torch.equal(ids[sep], pi[:, :K][sep]), label
    print(f"check fused_head_topk {label}: rows {h.shape[0]} H {h.shape[1]} "
          f"V {W.shape[0]} K {K} {str(h.dtype)[6:]} bias {b is not None}: "
          f"max|dm| {err_m:.2e} "
          f"max|dlog s| {err_logs:.2e} max|dcv| {err_cv:.2e} ids ok "
          f"(tolerance: m, log s 1e-5 relative; cv 1e-4; ids "
          f"{'all' if ties_exact else 'where separated by > 1e-4'})")
    return err_cv


def phase_check(opt) -> dict:
    K, H, V = opt["beam_size"], opt["dim_hidden"], opt["vocab_size"]
    rows = BATCH * K
    h, W = _head_inputs(rows, H, V, torch.float32, False, 1)
    err = _check_head_case("flagship", h, W, K, ties_exact=False)
    _check_head_case("ragged", *_head_inputs(RAGGED * K, H, V, torch.float32,
                                             False, 2), K, ties_exact=False)
    _check_head_case("bf16", *_head_inputs(rows, H, V, torch.bfloat16, True,
                                           3), K, ties_exact=True)
    h, W = _head_inputs(rows, H, V, torch.float32, True, 4)
    # every column repeats 37 columns later, across tile and chunk borders
    W = W[torch.arange(V, device="cuda") % 37].contiguous()
    _check_head_case("ties", h, W, K, ties_exact=True)
    # beams above 8 take the kernel's 32-long lists: ragged rows, ties
    h, W, b, _, _ = _xent_inputs(RAGGED * 16, H, V, torch.float32, True, True,
                                 11)
    W = W[torch.arange(V, device="cuda") % 37].contiguous()
    _check_head_case("K 16 ties", h, W, 16, ties_exact=True, b=b)
    return {"fused_head_topk": err, **_check_xent(opt), **_check_flash()}


def _xent_inputs(rows, H, V, dtype, exact, with_bias, seed):
    """The operands of the fused cross-entropy on the card: h, W (as
    ``_head_inputs``), an optional bias, labels with a fifth of the rows on
    PAD (id 0) and zero cotangents there, and non-zero cotangents g_lse,
    g_label, g_sum elsewhere, sized like a mean over 64 captions."""
    h, W = _head_inputs(rows, H, V, dtype, exact, seed)
    g = torch.Generator().manual_seed(seed + 100)
    b = None
    if with_bias:
        b = (torch.randint(-8, 9, (V,), generator=g).float() / 16 if exact
             else torch.randn((V,), generator=g) * 0.2).to("cuda", dtype)
    labels = torch.randint(6, V, (rows,), generator=g)
    pad = torch.rand((rows,), generator=g) < 0.2
    labels[pad] = 0
    keep = (~pad).float() / 64
    cot = [keep * (0.9 + 0.2 * torch.rand((rows,), generator=g)),
           -keep * (0.8 + 0.2 * torch.rand((rows,), generator=g)),
           -keep * 0.1 / V * (1 + torch.rand((rows,), generator=g))]
    return h, W, b, labels.cuda(), [c.cuda() for c in cot]


def _max_err(label, what, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert torch.allclose(got, want, rtol=rtol, atol=atol), (label, what, err)
    return err


def _check_xent_case(label, h, W, b, labels, cot, exact):
    """K2 (forward statistics), K3a (dh) and K3b (dW, db) against their
    plain versions on one set of operands. Returns the three errors."""
    f32 = h.dtype == torch.float32
    got = fht._argmax_lse_cuda(h, W, b, labels, True)
    want = fht._argmax_lse_plain(h, W, b, labels, 1024, True)
    torch.cuda.synchronize()
    amax = got[0].long()
    if exact:
        # exact arithmetic: the maxima, the label logits and the sums are
        # the same numbers in any order, and ties are exact ties
        assert torch.equal(amax, want[0]), label
        for k, what in ((1, "max"), (3, "label logit"), (4, "sum")):
            assert torch.equal(got[k], want[k]), (label, what)
    else:
        top2 = fht._logits(h, W, b).topk(2, dim=-1).values
        sep = top2[:, 0] - top2[:, 1] > 1e-4
        assert torch.equal(amax[sep], want[0][sep]), label
        _max_err(label, "max", got[1], want[1], 1e-5, 1e-5)
        _max_err(label, "label logit", got[3], want[3], 1e-5, 1e-5)
        # 11000 f32 terms of size ~0.5 added in another order
        _max_err(label, "sum", got[4], want[4], 1e-4, 1e-3)
    err_lse = _max_err(label, "lse", got[2], want[2], 1e-5, 1e-5)

    lse = want[2]
    gdh, gdw, gdb = fx._bwd_cuda(h, W, b, labels, lse, *cot)
    wdh, wdw, wdb = fx._bwd_plain(h, W, b, labels, lse, *cot, 1024)
    torch.cuda.synchronize()
    # f32: sums over 11000 columns (dh) or the rows (dW, db) in another
    # order, and expf against torch.exp. bf16: one-ulp differences of exp
    # can flip the bf16 rounding of a dlogits entry (2**-8 relative), and
    # the outputs are themselves rounded to bf16
    rtol, atol = (1e-4, 2e-7) if f32 else (2 ** -6, 1e-4)
    err_dh = _max_err(label, "dh", gdh, wdh, rtol, atol)
    err_dw = _max_err(label, "dW", gdw, wdw, rtol, atol)
    _max_err(label, "db", gdb, wdb, rtol, atol)
    assert gdh.dtype == h.dtype and gdw.dtype == W.dtype
    pad = labels == 0
    if pad.any():
        assert float(gdh[pad].float().abs().max()) == 0.0, label
    print(f"check fused xent {label}: rows {h.shape[0]} H {h.shape[1]} "
          f"V {W.shape[0]} {str(h.dtype)[6:]} bias {b is not None}: "
          f"argmax ok ({'all rows, bit-equal max/label/sum' if exact else 'rows separated by > 1e-4; max, label 1e-5; sum 1e-4 rel + 1e-3'}); "
          f"max|dlse| {err_lse:.2e} (1e-5); max|d dh| {err_dh:.2e} "
          f"max|d dW| {err_dw:.2e} (rtol {rtol:.1e} + atol {atol:.0e}: "
          f"{'summation order, expf' if f32 else 'bf16 rounding of dlogits and outputs'}); "
          f"PAD rows' dh exactly 0")
    return {"vocab_argmax_lse": err_lse, "fused_xent_bwd_dh": err_dh,
            "fused_xent_bwd_dw": err_dw}


def _check_xent(opt) -> dict:
    H, V = opt["dim_hidden"], opt["vocab_size"]
    rows = BATCH * (opt["max_len"] - 1)          # 1856: the trainer's shape
    f32, bf16 = torch.float32, torch.bfloat16
    errors = _check_xent_case(
        "flagship", *_xent_inputs(rows, H, V, f32, False, False, 5), False)
    _check_xent_case(
        "ragged+bias", *_xent_inputs(RAGGED * (opt["max_len"] - 1), H, V, f32,
                                     False, True, 6), False)
    _check_xent_case("bf16", *_xent_inputs(rows, H, V, bf16, True, True, 7),
                     True)
    # two calls on the same operands repeat bit for bit (no atomics)
    for dtype in (f32, bf16):
        h, W, b, labels, cot = _xent_inputs(rows, H, V, dtype, False, True, 5)
        lse = fht._argmax_lse_plain(h, W, b, labels, 1024, False)[2]
        first, second = (fx._bwd_cuda(h, W, b, labels, lse, *cot)
                         for _ in range(2))
        assert all(torch.equal(a, c) for a, c in zip(first, second)), dtype
        first, second = (fht._argmax_lse_cuda(h, W, b, labels, True)
                         for _ in range(2))
        assert all(torch.equal(a, c) for a, c in zip(first, second)), dtype
    print("check fused xent: K2 (argmax, max, lse, label logit, sum), K3a "
          "(dh) and K3b (dW, db) repeat bit for bit, f32 and bf16")
    h, W, b, labels, cot = _xent_inputs(rows, H, V, f32, True, False, 8)
    # every column repeats 37 columns later, across tile and chunk borders
    W = W[torch.arange(V, device="cuda") % 37].contiguous()
    _check_xent_case("ties", h, W, b, labels, cot, True)
    # heads too wide for the resident tiles of K2, K3a and K3b (the median
    # preset's H 768 in f32) take their streaming variants
    _check_xent_case("median H 768", *_xent_inputs(
        RAGGED * (opt["max_len"] - 1), 768, V, f32, False, True, 10), False)
    # the serving entry: no token ids, with a bias, leading dims kept
    h, W, b, labels, _ = _xent_inputs(rows, H, V, f32, False, True, 9)
    got = fht.vocab_argmax_lse(h.reshape(BATCH, -1, H), W, b)
    want = fht._argmax_lse_plain(h, W, b, None, 1024, False)
    torch.cuda.synchronize()
    assert len(got) == 3 and got[0].shape == (BATCH, rows // BATCH)
    assert want[3] is None and want[4] is None
    _max_err("token_ids=None", "max", got[1].reshape(-1), want[1], 1e-5, 1e-5)
    err = _max_err("token_ids=None", "lse", got[2].reshape(-1), want[2], 1e-5,
                   1e-5)
    print(f"check vocab_argmax_lse token_ids=None, bias: 3 outputs, "
          f"max|dlse| {err:.2e} (1e-5)")
    return errors


# the decode step of the long-key configuration (batch 64, 8 heads, beam 5
# folded into the query rows, 1654 keys) and the square shape of the
# backward kernels
DECODE_SHAPE = (BATCH, 8, 5, 1654, 64)
SQUARE_SHAPE = (4, 8, 1568, 1568, 64)
# the decode step of the ragged batch of 17: 136 (batch, head) pairs, about
# one per SM, which K4a splits over a cluster of blocks
RAGGED_DECODE_SHAPE = (RAGGED, 8, 5, 1654, 64)
FLASH_FWD_SHAPES = (("decode", DECODE_SHAPE),
                    ("decode17", RAGGED_DECODE_SHAPE),
                    ("square", SQUARE_SHAPE))


def _flash_inputs(shape, dtype, bias_kind, seed):
    """q, k, v, do on the card and a bias of the given kind: ``hybrid``
    [1, H, 1, Lk] with a -1e9 tail, ``pad`` [B, 1, 1, Lk] with -1e9 tails of
    different lengths, ``rpe`` [1, H, Lq, Lk], ``masked`` (as ``pad``, with
    every key of instance 0 masked) or None. bf16 inputs are small dyadic
    numbers, exact in bf16."""
    b, h, lq, lk, dh = shape
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bfloat16:
        q, k, v, do = (torch.randint(-4, 5, (b, h, n, dh), generator=g).float()
                       / 8 for n in (lq, lk, lk, lq))
    else:
        q, k, v, do = (torch.randn((b, h, n, dh), generator=g)
                       for n in (lq, lk, lk, lq))
    bias = None
    if bias_kind == "hybrid":
        bias = torch.randn((1, h, 1, lk), generator=g) * 0.5
        bias[..., -lk // 4:] = -1e9
    elif bias_kind in ("pad", "masked"):
        bias = torch.zeros((b, 1, 1, lk))
        for n in range(b):
            bias[n, ..., lk - 1 - (n * 7) % (lk // 2):] = -1e9
        if bias_kind == "masked":
            bias[0] = -1e9
    elif bias_kind == "rpe":
        bias = torch.randn((1, h, lq, lk), generator=g) * 0.5
    return ([t.to("cuda", dtype) for t in (q, k, v, do)],
            None if bias is None else bias.cuda())


def _check_flash_case(label, shape, dtype, bias_kind, seed):
    """K4a against its plain version and the dense attention; then the
    gradients of ``flash_attention(backward="kernel")`` (K4b, K4c) against
    the plain backward and against autograd of the dense attention. A row
    whose keys are all masked has lse = -1e9 + log(Lk), which f32 rounds to
    -1e9, so the recomputed weights of that row are 1 and not 1/Lk, in the
    kernels as in the TPU kernels they replace: the ``masked`` case holds
    its gradients against the plain backward only."""
    (q, k, v, do), bias = _flash_inputs(shape, dtype, bias_kind, seed)
    f32 = dtype == torch.float32
    # f32: the key tiles are summed in another order and expf is not
    # torch.exp; bf16: an ulp of exp can flip the bf16 rounding of a weight
    # (2**-8 relative), and the outputs are themselves rounded to bf16
    tol = dict(rtol=1e-4, atol=2e-5) if f32 else dict(rtol=2**-6, atol=2e-2)
    gtol = dict(rtol=1e-4, atol=1e-4) if f32 else dict(rtol=2**-5, atol=5e-2)
    out, lse = fa._flash_fwd_cuda(q, k, v, bias)
    want, want_lse = fa._flash_fwd_plain(q, k, v, bias)
    dense, _ = dot_product_attention(q, k, v, bias=bias, return_probs=False)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all(), label
    err = _max_err(label, "out vs plain", out, want, **tol)
    _max_err(label, "out vs dense", out, dense, **tol)
    _max_err(label, "lse", lse, want_lse, 1e-5, 2e-5)

    before = _launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    if bias is not None:
        leaves.append(bias.clone().requires_grad_(True))
    got = torch.autograd.grad(
        fa.flash_attention(*leaves[:3], bias=leaves[3] if bias is not None
                           else None, backward="kernel"), leaves, do)
    after = _launch_counts()
    kernel_rule = bias_kind != "rpe"
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] - before[name] == int(kernel_rule), (label, name)
    assert after["flash_attention_fwd"] - before["flash_attention_fwd"] == 1
    dense_out, _ = dot_product_attention(
        *leaves[:3], bias=leaves[3] if bias is not None else None,
        return_probs=False)
    want_dense = torch.autograd.grad(dense_out, leaves, do)
    names = ("dq", "dk", "dv", "dbias")
    errs = {}
    for name, a, d in zip(names, got, want_dense):
        assert a.shape == d.shape and a.dtype == d.dtype, (label, name)
        errs[name] = 0.0
        if bias_kind != "masked":
            errs[name] = _max_err(label, name + " vs dense autograd", a, d,
                                  **gtol)
    if kernel_rule:
        delta = (do.float() * want.float()).sum(-1)
        plain = fa._flash_bwd_plain(q, k, v, bias, want_lse, do, delta)
        for name, a, p in zip(names, got, plain):
            if p is not None:
                p = fa._unbroadcast(p, a.shape) if name == "dbias" else p
                errs[name] = max(errs[name], _max_err(
                    label, name + " vs plain", a, p, **gtol))
    torch.cuda.synchronize()
    print(f"check flash attention {label}: q {list(q.shape)} x {shape[3]} "
          f"keys {str(dtype)[6:]} bias "
          f"{None if bias is None else list(bias.shape)}: max|d out| "
          f"{err:.2e} (rtol {tol['rtol']:.1e} + atol {tol['atol']:.0e}, "
          f"against plain and dense), lse ok (2e-5); gradients by "
          f"{'K4b, K4c' if kernel_rule else 'the dense rule (K4b, K4c not launched)'}: "
          + ", ".join(f"max|d {n}| {e:.2e}" for n, e in errs.items())
          + f" (rtol {gtol['rtol']:.1e} + atol {gtol['atol']:.0e}, against "
          + ("plain" if bias_kind == "masked" else
             "plain and dense autograd" if kernel_rule else "dense autograd")
          + ")")
    return err, errs


def _check_flash() -> dict:
    f32, bf16 = torch.float32, torch.bfloat16
    err_fwd, _ = _check_flash_case("decode", DECODE_SHAPE, f32, "hybrid", 11)
    _check_flash_case("decode, no bias", DECODE_SHAPE, f32, None, 12)
    _, errs = _check_flash_case("square", SQUARE_SHAPE, f32, "hybrid", 13)
    _check_flash_case("ragged", (2, 2, 37, 1568, 32), f32, "hybrid", 14)
    _check_flash_case("ragged", (2, 2, 100, 200, 128), f32, "hybrid", 15)
    _check_flash_case("pad mask", (3, 4, 70, 333, 64), f32, "pad", 16)
    _check_flash_case("query-extent bias", (2, 4, 70, 333, 64), f32, "rpe",
                      17)
    _check_flash_case("all-masked instance", (2, 4, 5, 333, 64), f32,
                      "masked", 18)
    _check_flash_case("bf16", (2, 4, 70, 333, 64), bf16, "hybrid", 19)
    _check_flash_case("bf16 decode", (RAGGED, 8, 5, 1654, 64), bf16, "hybrid",
                      20)
    # the ragged decode batch: each (batch, head)'s keys split over a
    # cluster of blocks, merged in rank order through distributed shared
    # memory; the split repeats bit for bit
    for dh in (32, 64, 128):
        for dtype in (f32, bf16):
            shape = (RAGGED, 8, 5, 1654, dh)
            (q, k, _, _), _ = _flash_inputs(shape, dtype, "hybrid", 22)
            splits = fa.fwd_key_splits(q, k)
            assert splits > 1, (shape, splits)
            _check_flash_case(f"decode split over {splits} blocks", shape,
                              dtype, "hybrid", 22)
            (q, k, v, _), bias = _flash_inputs(shape, dtype, "hybrid", 22)
            first = fa._flash_fwd_cuda(q, k, v, bias)
            second = fa._flash_fwd_cuda(q, k, v, bias)
            assert all(torch.equal(a, b) for a, b in zip(first, second))
    # two calls on the same operands repeat bit for bit (no atomics)
    for dtype in (f32, bf16):
        (q, k, v, do), bias = _flash_inputs((2, 4, 70, 333, 64), dtype,
                                            "hybrid", 21)
        out, lse = fa._flash_fwd_cuda(q, k, v, bias)
        delta = (do.float() * out.float()).sum(-1)
        first = fa._flash_bwd_cuda(q, k, v, bias, lse, do, delta)
        second = fa._flash_bwd_cuda(q, k, v, bias, lse, do, delta)
        assert torch.equal(out, fa._flash_fwd_cuda(q, k, v, bias)[0])
        assert all(torch.equal(a, b) for a, b in zip(first, second)), dtype
    for bad in (q[..., :48].contiguous(), q.double()):
        try:
            fa.flash_attention(bad, bad, bad)
        except (ValueError, TypeError) as e:
            print(f"check flash attention: refused "
                  f"{str(bad.dtype)[6:]} Dh {bad.shape[-1]}: {e}")
        else:
            raise AssertionError("the wrapper took what the kernel does not")
    print("check flash attention: forward and backward repeat bit for bit "
          "in f32 and bf16, the forward's cluster split too")
    return {"flash_attention_fwd": err_fwd,
            "flash_attention_bwd_dq": errs["dq"],
            "flash_attention_bwd_dkv": max(errs["dk"], errs["dv"],
                                           errs["dbias"])}


# ---------------------------------------------------------------------------
# serving the flagship
# ---------------------------------------------------------------------------

def _retrieved_ids(opt, n, seed):
    """The ``t`` stream: ``retrieval_topk`` retrieved captions of
    ``max_len`` token ids a video, half of the words from 20 frequent ids
    (captions share their common words, so ids repeat within and across
    retrievals), PAD after a length of 8 to ``max_len`` (no EOS:
    ``exclude_eos``)."""
    rs = np.random.RandomState(seed)
    shape = (n, opt["retrieval_topk"], opt["max_len"])
    ids = np.where(rs.rand(*shape) < 0.5, rs.randint(6, 26, shape),
                   rs.randint(6, opt["vocab_size"], shape))
    lengths = rs.randint(8, opt["max_len"] + 1, shape[:2])
    ids[np.arange(opt["max_len"]) >= lengths[..., None]] = constants.PAD
    return ids.astype(np.int64)


def _synthetic_feats(opt, n, seed):
    rs = np.random.RandomState(seed)
    feats = []
    backbones = dict(zip(opt["modality"], opt.get("with_backbones") or []))
    for char in opt["modality"]:
        if char == "t":
            feats.append(_retrieved_ids(opt, n, seed + 7))
            continue
        if backbones.get(char):
            # raw frames for the image backbone
            feats.append(_frames(n, opt["n_frames"], seed))
            continue
        if opt["encoder"].startswith("CNN"):
            # dense patch features [n, frames, layers, patches]
            feats.append(np.random.default_rng(seed).standard_normal(
                (n, opt["n_frames"], PATCH_LAYERS, opt[f"dim_{char}"]),
                dtype=np.float32))
            continue
        if char == "m" and opt["feats"] == "SwinBERTDense":
            # the dense motion stream is loaded whole: 1568 patches a video
            feats.append(np.random.default_rng(seed).standard_normal(
                (n, 1568, opt["dim_m"]), dtype=np.float32))
            continue
        length = opt["retrieval_topk"] if char == "r" else opt["n_frames"]
        feats.append(rs.randn(n, length, opt[f"dim_{char}"]).astype(np.float32))
    return feats


@torch.no_grad()
def _teacher_forced_scores(model, opt, feats, hyps, dtype=torch.float32):
    """Σ log p(token) / len**alpha of each hypothesis from the full forward
    of ``model`` on the features in ``dtype`` (the served model and its
    feature dtype; token ids stay integers). Filler after a hypothesis is EOS, not PAD: causal
    attention keeps the filler out of earlier positions, while a PAD input
    would be masked."""
    dev = next(model.parameters()).device
    tf = [torch.as_tensor(f, device=dev) for f in feats]
    tf = [t.to(dtype) if t.is_floating_point() else t for t in tf]
    inputs = model.prepare_inputs_for_decoder(model.encoding_phase(tf), {})
    L = max(len(h[0]) for h in hyps)
    ids = torch.full((len(hyps), L), constants.EOS, dtype=torch.long)
    ids[:, 0] = constants.BOS
    usable = []
    for n, h in enumerate(hyps):
        toks = h[0]
        ids[n, 1:len(toks)] = torch.as_tensor(toks[:-1])
        # a generated PAD token as decoder input is masked by the full
        # forward but not by the KV-cached step; such rows are not compared
        usable.append(constants.PAD not in toks[:-1])
    out = model.decoding_phase(ids.to(dev), inputs)
    # a pointer model scores by its copy-mixed probabilities, as its step
    logp = (torch.log(out["probs"].float() + 1e-9) if "probs" in out
            else torch.log_softmax(out["logits"].float(), dim=-1))
    scores = []
    for n, h in enumerate(hyps):
        toks = torch.as_tensor(h[0], device=dev)
        total = logp[n, torch.arange(len(toks), device=dev), toks].sum()
        scores.append(total.item() / len(toks) ** opt["beam_alpha"])
    return scores, usable


def long_key_opt(task: str) -> dict:
    """The long-key serving configuration at full width: MSRVTT
    ``--method Transformer --task <task> --feats SwinBERTDense --modality
    ami -dm_flags VA -pm_flags VAT`` (``scripts/exp_versatility_of_CARE.sh``):
    28 frames of audio and image, 1568 rows of motion, so 1654 (``CARE``) or
    1624 (``Base``) cross-attention keys and the flash kernel in every beam
    step."""
    opt = get_opt({"dataset": "MSRVTT", "method": "Transformer", "task": task,
                   "feats": "SwinBERTDense", "modality": "ami",
                   "decoder_modality_flags": "VA",
                   "predictor_modality_flags": "VAT", "vocab_size": 11000},
                  read_vocab=False, resolve_paths=False)
    if task == "CARE":
        opt["dim_r"] = 512           # the retrieval rows the predictor reads
    assert opt["dim_m"] == 1024 and opt["use_pallas_attention"] == "auto"
    return opt


# the teacher-forced re-check of served scores: f32 serving against the
# full forward agrees to SCORE_TOL; bf16 serving (a bf16 KV cache and bf16
# weights, the full forward without the cache) to SCORE_TOL_BF16 per
# length-normalised score, a few times the largest sound reading on an H100
# (8.1e-4, the Base decoder in bf16; 2.7e-4 to 4.4e-4 for the others)
SCORE_TOL, SCORE_TOL_BF16 = 1e-3, 3e-3


def _serve(label, opt, batch_sizes, flash: bool, profile_kernels,
           bf16_kernels=(), profile_ranges=(), time_copy=False) -> dict:
    """Caption synthetic batches of the given sizes through
    ``get_translator(opt).translate_batch`` with the launch counts set to 0
    just before and read just after; hold the counts against the beam steps
    (``bf16_kernels``: the kernels whose every launch must be bf16, the
    others' none) and every score against teacher forcing through the full
    forward of the served model (the dense attention). Returns the launch
    counts, caps/s, ms per beam step and the first hypotheses.
    ``profile_ranges``: modules whose share of the profiled batch's device
    time to print (``_profile``). The first batch's feature copy is timed
    alone at long keys, or with ``time_copy``."""
    t0 = time.perf_counter()
    model = build_captioner(opt, seed=SEED)
    translator = get_translator(opt)
    served = translator.serving_model(model)
    torch.cuda.synchronize()
    layers = opt["num_hidden_layers_decoder"]
    # an RNN decoder has no Transformer layers and stays off the fused head
    assert all(l.inter_attention.use_flash is flash
               for l in getattr(model.decoder, "layers", []))
    head = translator.fused_head
    dtype = translator.compute_dtype or torch.float32
    print(f"serve {label}: built the Captioner "
          f"({sum(p.numel() for p in model.parameters())} parameters, served "
          f"in {str(next(served.parameters()).dtype)[6:]}, vocab head "
          f"{str(served.cls_head.tgt_word_prj.weight.dtype)[6:]}"
          f"{'' if head else ', dense'}) in "
          f"{time.perf_counter() - t0:.1f} s")
    batches = [_synthetic_feats(opt, n, SEED + 10 + i)
               for i, n in enumerate(batch_sizes)]
    translator.translate_batch(model, {"feats": batches[0]})      # warm-up

    _zero_launch_counts()
    translator.beam_steps = 0
    results, seconds = [], []
    for feats in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(translator.translate_batch(model, {"feats": feats}))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = _launch_counts()
    bf16 = _bf16_launch_counts()
    steps = translator.beam_steps
    assert steps > 0 and counts["fused_head_topk"] == steps * head, \
        (counts, steps)
    assert counts["flash_attention_fwd"] == (steps * layers if flash else 0), \
        (counts, steps)
    for name, n in bf16.items():
        assert n == (counts[name] if name in bf16_kernels else 0), \
            (name, bf16, counts)

    tol = SCORE_TOL if dtype == torch.float32 else SCORE_TOL_BF16
    # control of the bf16 check: the same hypotheses teacher-forced through
    # the caller's f32 model, the gap a decode that lost the cast would show
    worst, control, checked, total = 0.0, 0.0, 0, 0
    for feats, (hyps, scores) in zip(batches, results):
        assert len(hyps) == feats[0].shape[0]
        assert all(len(h) == 1 and len(h[0]) >= 1 for h in hyps)
        assert all(np.isfinite(s[0]) for s in scores)
        ref, usable = _teacher_forced_scores(served, opt, feats, hyps, dtype)
        f32_ref = (ref if served is model else
                   _teacher_forced_scores(model, opt, feats, hyps)[0])
        for s, r, r32, ok in zip(scores, ref, f32_ref, usable):
            total += 1
            if ok:
                checked += 1
                worst = max(worst, abs(s[0] - r))
                control = max(control, abs(s[0] - r32))
    assert worst <= tol, (worst, tol)
    assert checked >= total // 2, (checked, total)
    full = [s for s, n in zip(seconds, batch_sizes) if n == BATCH]
    caps = BATCH * len(full) / sum(full)
    step_ms = 1e3 * sum(seconds) / steps
    print(f"serve {label}: batches of {list(batch_sizes)} videos, "
          f"{steps} beam steps, launches "
          f"{ {k: v for k, v in counts.items() if v} } (of them bf16: "
          f"{ {k: v for k, v in bf16.items() if v} })")
    print(f"serve {label}: batch seconds {[round(s, 4) for s in seconds]}; "
          f"{caps:.1f} caps/s at batch {BATCH}; {step_ms:.3f} ms per beam "
          f"step")
    print(f"serve {label}: scores re-checked by teacher forcing: "
          f"{checked}/{total} hypotheses, max |diff| {worst:.2e} "
          f"(tolerance {tol:g})"
          + ("" if served is model else
             f"; control, against the f32 model's teacher forcing: max "
             f"|diff| {control:.2e}"))
    print(f"serve {label}: first caption tokens {results[0][0][0][0][:12]}")
    if flash or time_copy:
        # what of a batch's wall time is the copy of its features
        n_bytes = sum(f.nbytes for f in batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = translator._feats({"feats": batches[0]})
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        del on_card
        cast = "" if dtype == torch.float32 else ", then the cast to bf16"
        print(f"serve {label}: host-to-device copy of one batch's features "
              f"({n_bytes / 1e6:.1f} MB of pageable numpy{cast}): "
              f"{1e3 * copy_s:.3f} ms ({n_bytes / copy_s / 1e9:.2f} GB/s), "
              f"{100 * copy_s / seconds[0]:.1f}% of the batch's wall time")
    profiled = None
    if profile_kernels or profile_ranges:
        profiled = _profile(
            f"{label}, batch {BATCH}",
            lambda: translator.translate_batch(model, {"feats": batches[0]}),
            seconds[0], profile_kernels, steps=steps // len(batches),
            ranges=profile_ranges)
    return {"counts": counts, "caps": caps, "step_ms": step_ms,
            "first": [h[0] for r in results for h in r[0]],
            "profile": profiled}


def _half(opt, head_f32=False) -> dict:
    return dict(opt, compute_dtype_decode="bfloat16",
                decode_head_f32=head_f32)


def _against_f32(label, got, f32) -> None:
    same = np.mean([a == b for a, b in zip(got["first"], f32["first"])])
    print(f"serve {label}: {got['caps']:.1f} caps/s and {got['step_ms']:.3f} "
          f"ms per beam step against f32's {f32['caps']:.1f} and "
          f"{f32['step_ms']:.3f} in this run; first hypotheses equal to "
          f"f32's: {100 * same:.1f}% (a reading: random weights give "
          f"near-ties)")


def phase_serve(opt) -> dict:
    """The flagship (short keys, dense decode step), then the long-key
    configuration with and without the concept stack; then each again in
    half precision (``compute_dtype_decode: bfloat16``), the flagship also
    with ``decode_head_f32``. Under bf16 weights every module computes in
    the promoted dtype of its operands, as the JAX package's flax modules
    do: the ``CARE`` task's f32 concept vector (``semantic2hidden`` of the
    f32 concept probabilities) promotes the decoder's embeddings, so its
    decoder runs f32 on bf16 weights and K1 and K4a launch in f32 there;
    the ``Base`` task's decoder runs bf16 and launches both in bf16.
    Returns the launch counts summed over the runs."""
    f32 = _serve("flagship", opt, [BATCH] * 3 + [RAGGED], False,
                 ["fused_head_topk"])
    long_f32 = _serve("long keys, CARE", long_key_opt("CARE"),
                      [BATCH] * 2 + [RAGGED], True,
                      ["flash_attention_fwd", "fused_head_topk"])
    base_f32 = _serve("long keys, Base", long_key_opt("Base"), [BATCH],
                      True, ["flash_attention_fwd", "fused_head_topk"])
    runs = [f32, long_f32, base_f32]
    for label, cfg, ref, flash, bf16 in (
            ("flagship, bf16", _half(opt), f32, False, ()),
            ("flagship, bf16, f32 head", _half(opt, True), f32, False, ()),
            ("long keys, CARE, bf16", _half(long_key_opt("CARE")), long_f32,
             True, ()),
            ("long keys, Base, bf16", _half(long_key_opt("Base")), base_f32,
             True, ("fused_head_topk", "flash_attention_fwd"))):
        # device time of one batch beside the f32 run's: the host clock of
        # these host-bound runs swings more than the difference
        run = _serve(label, cfg, [BATCH] * (3 if ref is f32 else 1), flash,
                     ["fused_head_topk"] + ["flash_attention_fwd"] * flash,
                     bf16)
        _against_f32(label, run, ref)
        runs.append(run)
    return {k: sum(r["counts"][k] for r in runs)
            for k in ("fused_head_topk", "flash_attention_fwd")}


def phase_flash_gradient() -> dict:
    """``flash_attention`` as the differentiable function a caller would
    use: a few gradient steps on q, k, v and a hybrid bias at the square
    shape through ``backward="kernel"``, the launch counts set to 0 just
    before. No model path reaches the backward kernels, as in the JAX
    package; this is their entry point."""
    (q, k, v, do), bias = _flash_inputs(SQUARE_SHAPE, torch.float32,
                                        "hybrid", 31)
    leaves = [t.requires_grad_(True) for t in (q, k, v, bias)]
    steps = 3
    _zero_launch_counts()
    losses = []
    for _ in range(steps):
        out = fa.flash_attention(q, k, v, bias=bias, backward="kernel")
        loss = ((out - do) ** 2).mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                assert torch.isfinite(g).all() and g.shape == t.shape
                t -= 2000.0 * g
        losses.append(loss.item())
    torch.cuda.synchronize()
    counts = _launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == steps, (name, counts)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    print(f"flash gradient: {steps} descent steps on q, k, v and the bias at "
          f"{list(q.shape)} through backward='kernel': losses "
          f"{[round(l, 6) for l in losses]}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return {k: counts[k] for k in ("flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv")}


def _profile(label, run, unprofiled_seconds, kernel_names, steps=None,
             ranges=()):
    """``run`` once more under torch.profiler: the device time by kernel,
    and the device's busy share of the same work's unprofiled wall time
    (the profiler slows the host, not the device). ``steps``: the beam
    steps of the run, for the device operations per step. ``ranges``:
    (name, module class) pairs; each class's ``forward`` runs inside a
    ``record_function`` of that name for the profile, and the range's
    device time is printed as a share. Returns the busy ms and the ranges'
    device ms (None where the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def traced(name, forward):
        def wrapper(*args, **kwargs):
            with record_function(name):
                return forward(*args, **kwargs)
        return wrapper

    originals = [(cls, cls.forward) for _, cls in ranges]
    for (name, cls), (_, forward) in zip(ranges, originals):
        cls.forward = traced(name, forward)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for cls, forward in originals:
            cls.forward = forward
    # device-side events are kernels and copies, plus the device-track
    # copies of the optimizer's host annotation (``Optimizer.step#Adam.step``)
    # and of each range, which span kernels already counted
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Optimizer.")
               and e.key not in dict(ranges)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print("profile: the profiler saw no device time: not measured")
        return None, None
    shares = []
    for name in kernel_names:
        us = sum(e.self_device_time_total for e in kernels
                 if any(k in e.key for k in DEVICE_KERNELS[name]))
        shares.append(f"{name} {100 * us / busy_us:.1f}%")
    range_ms = {}
    for name, _ in ranges:
        # a range's device time: the kernels launched inside it, which its
        # host event sums
        events = [e for e in prof.key_averages() if e.key == name
                  and e.device_type == DeviceType.CPU]
        us = sum(e.device_time_total for e in events)
        range_ms[name] = us / 1e3
        shares.append(f"{name} {100 * us / busy_us:.1f}% ({us / 1e3:.3f} ms "
                      f"in {sum(e.count for e in events)} calls)")
    print(f"profile: {label}: device busy "
          f"{busy_us / 1e3:.3f} ms of {1e3 * unprofiled_seconds:.3f} ms wall "
          f"({100 * busy_us / 1e6 / unprofiled_seconds:.1f}% busy); "
          f"{sum(e.count for e in kernels)} device operations (kernels "
          f"and copies"
          + (f", {sum(e.count for e in kernels) / steps:.0f} per beam step"
             if steps else "")
          + f"); of device time: {', '.join(shares)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile:   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x {e.key[:90]}")
    return busy_us / 1e3, range_ms


# ---------------------------------------------------------------------------
# training the flagship
# ---------------------------------------------------------------------------

class SyntheticLoader:
    """``n_batches`` fixed batches of ``batch_size`` synthetic videos with
    captions (numpy from a seed): feature streams, BOS-led input ids, labels
    with PAD after a random length, multi-hot concept labels. Every batch
    has the same caption lengths, so that the summed losses of different
    batches compare."""

    def __init__(self, opt, n_batches, batch_size, seed):
        rs = np.random.RandomState(seed)
        L, V = opt["max_len"] - 1, opt["vocab_size"]
        self.batches = []
        lengths = rs.randint(5, L + 1, (batch_size, 1))
        for i in range(n_batches):
            tokens = rs.randint(6, V, (batch_size, L + 1))
            tokens[:, 0] = constants.BOS
            valid = np.arange(L)[None, :] < lengths
            labels = np.where(valid, tokens[:, 1:], constants.PAD)
            inputs = np.where(valid, tokens[:, :-1], constants.PAD)
            self.batches.append({
                "feats": _synthetic_feats(opt, batch_size, seed + 1000 + i),
                "input_ids": inputs.astype(np.int32),
                "labels": labels.astype(np.int32),
                "labels_attr": (rs.rand(
                    batch_size, opt["attribute_prediction_k"]) < 0.02
                ).astype(np.float32)})

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def _step_losses(trainer):
    return [l for h in trainer.history for l in h["step_losses"]]


def _timed_fit(opt, loader):
    """A trainer warmed by one epoch, then one epoch on the host clock (the
    fit loop's ``epoch_time``, which ends in the epoch's one device-to-host
    fetch and leaves out the checkpoint written after it) with the peak of
    allocated device memory above what was resident before it. Returns
    (trainer, ms per step, peak MiB above resident)."""
    trainer = Trainer(opt, loader)
    trainer.fit(1)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(1)
    torch.cuda.synchronize()
    ms = 1e3 * trainer.history[-1]["epoch_time"] / len(loader)
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**20
    return trainer, ms, peak, resident / 2**20


def phase_train(opt, scratch) -> dict:
    # the trainer keeps a checkpoint every epoch: in the scratch directory
    base = dict(opt, epochs=TRAIN_EPOCHS, lowlr_start_epoch=1,
                checkpoint_path=os.path.join(scratch, "train"))
    loader = SyntheticLoader(opt, TRAIN_BATCHES, BATCH, SEED + 30)
    steps = TRAIN_EPOCHS * TRAIN_BATCHES

    # the main path: Trainer.fit with the fused cross-entropy, dropout on
    _zero_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(dict(base, fused_xent=True), loader)
    trainer.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    losses = _step_losses(trainer)
    assert trainer._fused_xent and trainer.model.training
    assert trainer.global_step == len(losses) == steps, (losses, steps)
    assert all(np.isfinite(losses)), losses
    trained = ("vocab_argmax_lse", "fused_xent_bwd_dh", "fused_xent_bwd_dw")
    for name, n in counts.items():
        # the serving kernels stay out of training: its attention returns
        # probabilities, which is the dense path at any key length
        assert n == (steps if name in trained else 0), (name, counts, steps)
    assert trainer._switched and trainer._switch_offset == TRAIN_BATCHES
    last = float(np.mean(losses[-TRAIN_BATCHES:]))
    assert last < losses[0], (last, losses)
    assert last < np.mean(losses[:TRAIN_BATCHES]), (last, losses)
    log = trainer.history[-1]
    print(f"train: {steps} steps of batch {BATCH} "
          f"({BATCH * (opt['max_len'] - 1)} rows into the vocab head), "
          f"fused_xent on, dropout on, in {seconds:.1f} s with model build "
          f"and first-launch costs; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    print(f"train: step losses {[round(l, 4) for l in losses]}; optimizer "
          f"switched at step {trainer._switch_offset}; last epoch: Lang "
          f"{log['Lang Loss']:.4f}, V-Attr {log['V-Attr']:.4f}, word acc "
          f"{log['Word Acc0']:.4f}, perplexity {log['Perplexity']:.1f}")

    # fused against dense from one seed, dropout off
    quiet = dict(base, epochs=1, hidden_dropout_prob=0.0,
                 encoder_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    short = SyntheticLoader(opt, 3, BATCH, SEED + 40)
    pair = {}
    for fused in (True, False):
        t = Trainer(dict(quiet, fused_xent=fused), short)
        t.fit()
        assert t._fused_xent is fused
        pair[fused] = _step_losses(t)
    rel0 = abs(pair[True][0] - pair[False][0]) / abs(pair[False][0])
    gaps = [abs(a - b) for a, b in zip(pair[True], pair[False])]
    assert rel0 <= 1e-5, (rel0, pair)
    assert max(gaps) <= 1e-3, (gaps, pair)
    print(f"train: fused vs dense, one seed, dropout off: step-0 relative "
          f"gap {rel0:.2e} (<= 1e-5: the same function of the same weights),"
          f" |gap| of steps 0-2 {[f'{g:.2e}' for g in gaps]} (<= 1e-3: "
          f"rounding drift through the updates)")

    # the auto policy: dense at the flagship's batch 64, fused at 192
    policy = {}
    for batch_size in (64, 192):
        t = Trainer(dict(base, fused_xent="auto", batch_size=batch_size),
                    loader)
        t.init_model()
        t._build_tx(len(loader))
        t._make_train_step()
        policy[batch_size] = t._fused_xent
    assert policy == {64: False, 192: True}, policy
    print(f"train: fused_xent auto policy: batch 64 -> dense, batch 192 -> "
          f"fused (threshold {opt['fused_xent_auto_threshold_mb']} MB of "
          f"logits + gradient)")
    del t, trainer

    # step time and peak memory, fused and dense in turns, dropout on
    for fused in (True, False, False, True):
        t = None                    # free the last trainer before the next
        t, ms, peak, resident = _timed_fit(
            dict(base, epochs=1, fused_xent=fused), loader)
        print(f"train: {'fused' if fused else 'dense'} step "
              f"{ms:.3f} ms (host clock over {len(loader)} steps, batch "
              f"{BATCH}), peak device memory {peak:.1f} MiB above the "
              f"{resident:.1f} MiB resident")
    batch = device_batch(loader.batches[0], "cuda")
    _profile("one fused train step", lambda: t._train_step_fn(batch),
             ms / 1e3, trained)
    _xent_scratch(opt)
    return {name: counts[name] for name in trained}


# ---------------------------------------------------------------------------
# the rest of the CARE family
# ---------------------------------------------------------------------------

FAMILY_STEPS = 4
MSRVTT_GLSG = {"task": "Concept", "feats": "ViT",
               "decoder_modality_flags": "VA",
               "predictor_modality_flags": "VAT"}
# (label, the command's flags, where the paper's scripts run it)
FAMILY = [
    ("CABase", {"task": "CABase", "feats": "ViT",
                "decoder_modality_flags": "VA"},
     "scripts/exp_main_MSRVTT.sh:34"),
    ("G1L1 parallel", dict(MSRVTT_GLSG, use_attr_flags="G1L1",
                           attr_layer_pos="parallel"),
     "scripts/exp_ablation_GLSG.sh:65"),
    ("G1L1 attr2cross", dict(MSRVTT_GLSG, use_attr_flags="G1L1",
                             attr_layer_pos="attr2cross"),
     "scripts/exp_ablation_GLSG.sh:63"),
    ("G0Lc SC bias", dict(MSRVTT_GLSG, use_attr_flags="G0Lc",
                          compositional_intra=True, compositional_ffn=True,
                          add_hybrid_attention_bias=True),
     "scripts/exp_ablation_GLSG.sh:37"),
    ("ARB CARE", {"method": "ARB", "task": "CARE", "feats": "ViT",
                  "modality": "ami", "decoder_modality_flags": "VA",
                  "predictor_modality_flags": "VAT"},
     "scripts/exp_versatility_of_CARE.sh:60"),
    ("G1L1 parallel, long keys",
     dict(MSRVTT_GLSG, use_attr_flags="G1L1", attr_layer_pos="parallel",
          feats="SwinBERTDense", modality="ami"),
     "scripts/exp_ablation_GLSG.sh:65 at --feats SwinBERTDense"),
]


def family_opt(flags: dict) -> dict:
    """A family configuration at full width (``--arch base``: H 512, FFN
    2048, 8 heads; V 11 000; 28 frames; beam 5; ``max_len`` 30)."""
    opt = get_opt(dict({"dataset": "MSRVTT", "method": "Transformer",
                        "vocab_size": 11000, "arch": "base"}, **flags),
                  read_vocab=False, resolve_paths=False)
    if "r" in opt["modality"]:
        opt["dim_r"] = 512
    return opt


def _bn_stats(model) -> list:
    return [t.detach().clone() for m in model.modules()
            if isinstance(m, torch.nn.BatchNorm1d)
            for t in (m.running_mean, m.running_var)]


def phase_family(scratch) -> dict:
    """The rest of the CARE Transformer family at full width: for each
    configuration of ``FAMILY`` (the concept-attention sublayer in CABase
    and the ``parallel`` / ``attr2cross`` placements, semantic composition
    with the hybrid bias, ARB's HighWay / BatchNorm encoder, and the
    ``parallel`` placement at long keys), ``Trainer.fit`` for
    ``FAMILY_STEPS`` steps of batch 64 with ``fused_xent: True`` (K2, K3a
    and K3b once per step; ARB's running statistics must move), then
    ``_serve`` of one batch of 64 (K1 once per beam step; K4a once per beam
    step and layer at long keys; every score re-checked by teacher
    forcing; caps/s and ms per beam step). One CABase batch is profiled.
    Returns the launch counts summed over the configurations."""
    totals = dict.fromkeys(_launch_counts(), 0)
    trained = ("vocab_argmax_lse", "fused_xent_bwd_dh", "fused_xent_bwd_dw")
    for i, (label, flags, where) in enumerate(FAMILY):
        opt = family_opt(flags)
        flash = opt["feats"] == "SwinBERTDense"
        print(f"family {label} ({where}): encoder {opt['encoder']}, "
              f"use_attr_type {opt.get('use_attr_type')!r}, attr_layer_pos "
              f"{opt['attr_layer_pos']}, modality {opt['modality']}")
        loader = SyntheticLoader(opt, FAMILY_STEPS, BATCH, SEED + 50 + i)
        trainer = Trainer(dict(opt, epochs=1, fused_xent=True,
                               checkpoint_path=os.path.join(
                                   scratch, f"family{i}")), loader)
        trainer.init_model()
        stats = _bn_stats(trainer.model)
        torch.cuda.synchronize()
        _zero_launch_counts()
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
        losses = _step_losses(trainer)
        assert trainer._fused_xent and len(losses) == FAMILY_STEPS, losses
        assert all(np.isfinite(losses)), losses
        for name, n in counts.items():
            assert n == (FAMILY_STEPS if name in trained else 0), \
                (label, name, counts)
        moved = [float((a - b).abs().max())
                 for a, b in zip(_bn_stats(trainer.model), stats)]
        assert (opt["encoder"] == "EncoderWithHighWayBN") == bool(stats)
        assert all(m > 0 for m in moved), moved
        print(f"family {label}: train {FAMILY_STEPS} steps of batch {BATCH},"
              f" fused_xent on, in {seconds:.2f} s with model build and "
              f"first-launch costs; losses {[round(l, 4) for l in losses]};"
              f" launches { {k: v for k, v in counts.items() if v} }"
              + (f"; BatchNorm running statistics moved by up to "
                 f"{max(moved):.3e} ({len(stats)} buffers)" if stats else ""))
        del trainer, loader
        for k, n in counts.items():
            totals[k] += n
        run = _serve(f"family {label}", opt, [BATCH], flash,
                     ["fused_head_topk"] + ["flash_attention_fwd"] * flash
                     if i == 0 or flash else [])
        for k, n in run["counts"].items():
            totals[k] += n
    return totals


# ---------------------------------------------------------------------------
# non-autoregressive decoding: NACF with its ARB teacher
# ---------------------------------------------------------------------------

NAR_STEPS = 4
# (flags, where the paper's scripts run it): the ARB CARE teacher, then the
# NACF CARE student it initialises and rescores
NAR_TEACHER = ({"method": "ARB", "task": "CARE", "feats": "ViT",
                "modality": "ami", "decoder_modality_flags": "VA",
                "predictor_modality_flags": "VAT"},
               "scripts/exp_versatility_of_CARE.sh:60")
NAR_STUDENT = (dict(NAR_TEACHER[0], method="NACF",
                    with_teacher_during_training=True),
               "scripts/exp_versatility_of_CARE.sh:64")
# K2 launches of one batch of mask-predict with the template and the
# teacher's final rescoring: 1 template pass + 5 iterations + 1 rescoring
NAR_MP_LAUNCHES = 7


class NarSyntheticLoader(SyntheticLoader):
    """``SyntheticLoader``'s batches as NACF trains on them: the visual-word
    pass (``<vis>`` over the caption, content words or MASK as targets) and
    the masked-language pass (a random half of the words masked and
    predicted), with the one-hot length target."""

    def __init__(self, opt, n_batches, batch_size, seed):
        super().__init__(opt, n_batches, batch_size, seed)
        rs = np.random.RandomState(seed + 1)
        L = opt["max_len"]
        for b in self.batches:
            words = np.pad(np.where(b["labels"] == constants.PAD, 0,
                                    b["labels"]), ((0, 0), (0, 1)))
            valid = words != constants.PAD
            masked = valid & (rs.rand(*words.shape) < 0.5)
            target = np.zeros(words.shape, np.float32)
            # the length's own index, as the translator reads the beam
            target[np.arange(len(words)), valid.sum(1)] = 1.0
            b.update(
                input_ids=[np.where(valid, constants.VIS, constants.PAD),
                           np.where(masked, constants.MASK, words)],
                labels=[np.where(valid & (rs.rand(*words.shape) < 0.5),
                                 words, np.where(valid, constants.MASK,
                                                 constants.PAD)),
                        np.where(masked, words, constants.PAD)],
                length_target=target)
            assert words.shape[1] == L


def _check_argmax_lse_nar(h, W, tokens):
    """K2 against its plain version at the NAR decode's shape, with token
    ids: max, lse and the token logit within 1e-5 relative, the argmax ids
    wherever the top logit is separated from the next by more than 1e-4."""
    got = fht._argmax_lse_cuda(h, W, None, tokens, False)
    want = fht._argmax_lse_plain(h, W, None, tokens, 1024, False)
    errs = [_max_err("NAR shape", what, g, w, 1e-5, 1e-5)
            for what, g, w in zip(("max", "lse", "token logit"),
                                  (got[1], got[2], got[3]),
                                  (want[1], want[2], want[3]))]
    top2 = torch.topk((h.float() @ W.float().t()), 2, dim=-1).values
    sep = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert torch.equal(got[0].long()[sep], want[0][sep]), "NAR argmax"
    print(f"check vocab_argmax_lse at the NAR shape [{h.shape[0]}, "
          f"{h.shape[1]}] x [{W.shape[0]}, {W.shape[1]}] "
          f"{str(h.dtype)[6:]} with token ids: max|d| max, lse, token logit "
          f"{errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e} (1e-5 relative); "
          f"argmax equal on the {int(sep.sum())} of {h.shape[0]} rows "
          f"separated by > 1e-4")
    return max(errs)


def _nar_decode(label, student, opt, feats, teacher, vm):
    """One batch through ``get_translator(opt).translate_batch`` with the
    teacher, the launch counts set to 0 just before and read just after.
    Returns (hypotheses, log-probs, counts, translator, seconds)."""
    translator = get_translator(opt)
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.perf_counter()
    hyps, lprobs = translator.translate_batch(
        student, {"feats": feats}, teacher=teacher, vocab_mapping=vm)
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    passes = translator.decoder_passes + translator.teacher_passes
    assert counts["vocab_argmax_lse"] == passes, (label, counts, passes)
    assert all(n == 0 for k, n in counts.items()
               if k != "vocab_argmax_lse"), (label, counts)
    lp = np.asarray(lprobs)
    assert np.shape(hyps) == (len(feats[0]), 1, opt["max_len"]), label
    assert np.isfinite(lp).all() and (lp <= 0).all(), label
    words = np.asarray(hyps)[:, 0]
    print(f"nar {label}: batch {len(feats[0])} in {seconds:.4f} s "
          f"({len(feats[0]) / seconds:.1f} caps/s), "
          f"{translator.decoder_passes} student passes + "
          f"{translator.teacher_passes} teacher rescoring, K2 launches "
          f"{counts['vocab_argmax_lse']}, "
          f"{1e3 * seconds / passes:.3f} ms per pass; mean length "
          f"{(words != constants.PAD).sum(1).mean():.2f}, MASK tokens "
          f"{(words == constants.MASK).mean():.3f} of the canvas; first "
          f"caption ids {words[0][:12].tolist()}")
    return hyps, lprobs, counts, translator, seconds


def phase_nar(scratch) -> dict:
    """NACF at full width (``--arch base``, MSRVTT ViT, V 11 000, batch 64,
    ``max_len`` 30, random weights from a seed): the ARB CARE teacher
    trained ``NAR_STEPS`` steps and checkpointed; the NACF CARE student
    filled from that checkpoint (``load_teacher_weights_into_student``) and
    trained
    ``NAR_STEPS`` steps, which launch no vocab kernel (the multi-pass
    loss stays dense, as in ``care_tpu``); one batch of 64 served with
    teacher rescoring by mask-predict with the template (K2 launches ==
    ``NAR_MP_LAUNCHES``), then by ``l2r`` and ``ef``; the mask-predict
    batch profiled, and again with the plain version in K2's place
    (hypotheses identical, log-probs within 1e-5); K2 against its plain
    version at the decode's shape. Returns the launch counts of the four
    decodes."""
    from care_tpu_torch.models.loading import \
        load_teacher_weights_into_student
    from care_tpu_torch.training.checkpoints import save_checkpoint

    (t_flags, t_where), (s_flags, s_where) = NAR_TEACHER, NAR_STUDENT
    t_opt = family_opt(t_flags)
    teacher = Trainer(dict(t_opt, epochs=1, checkpoint_path=os.path.join(
        scratch, "nar_teacher")), SyntheticLoader(t_opt, NAR_STEPS, BATCH,
                                                  SEED + 70))
    teacher.fit()
    teacher_ckpt = os.path.join(scratch, "nar_teacher", "best.ckpt")
    save_checkpoint(teacher_ckpt, teacher.variables(), t_opt)
    t_losses = _step_losses(teacher)
    assert all(np.isfinite(t_losses)), t_losses
    print(f"nar teacher ARB CARE ({t_where}): {NAR_STEPS} steps of batch "
          f"{BATCH}, losses {[round(l, 4) for l in t_losses]}; checkpoint "
          f"{os.path.getsize(teacher_ckpt)} bytes")
    del teacher

    s_opt = dict(family_opt(s_flags), teacher_path=teacher_ckpt,
                 load_model_weights_from=teacher_ckpt)
    assert s_opt["decoder"] == "TwoStageTransformerDecoder"
    assert s_opt["use_ct"] and s_opt["visual_word_generation"]
    student = Trainer(dict(s_opt, epochs=1, checkpoint_path=os.path.join(
        scratch, "nar_student")), NarSyntheticLoader(s_opt, NAR_STEPS, BATCH,
                                                     SEED + 80))
    # the same corpus (none on disk here): no vocabulary mapping
    student.init_model()
    filled = load_teacher_weights_into_student(student.model, teacher_ckpt,
                                               None, verbose=False)
    n_leaves = sum(1 for _ in student.model.parameters()) + sum(
        2 for m in student.model.modules()
        if isinstance(m, torch.nn.BatchNorm1d))
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.perf_counter()
    student.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    losses = _step_losses(student)
    log = student.history[-1]
    assert all(n == 0 for n in counts.values()), counts
    assert not student._fused_xent and len(losses) == NAR_STEPS
    assert all(np.isfinite(losses)), losses
    assert np.isfinite(log["Word Acc0"]) and np.isfinite(log["Length Loss"])
    print(f"nar student NACF CARE ({s_where}): the teacher filled {filled} "
          f"of its {n_leaves} leaves; {NAR_STEPS} steps of batch {BATCH} in "
          f"{seconds:.2f} s, losses {[round(l, 4) for l in losses]}, Word "
          f"Acc0 {log['Word Acc0']:.4f}, Length Loss "
          f"{log['Length Loss']:.4f}; vocab-kernel launches {counts}")

    model = student.model.eval()
    teacher_model, vm = student._get_teacher()
    feats = _synthetic_feats(s_opt, BATCH, SEED + 90)
    totals = dict.fromkeys(_launch_counts(), 0)
    runs = {}
    for paradigm in ("mp", "mp", "l2r", "ef"):
        label = paradigm + (" (warm)" if paradigm in runs else "")
        runs[paradigm] = _nar_decode(label, model, dict(s_opt,
                                                        paradigm=paradigm),
                                     feats, teacher_model, vm)
        for k, n in runs[paradigm][2].items():
            totals[k] += n
    assert runs["mp"][2]["vocab_argmax_lse"] == NAR_MP_LAUNCHES, runs["mp"][2]
    mp = dict(s_opt, paradigm="mp")
    _profile(f"nar mp, batch {BATCH}", lambda: get_translator(mp).
             translate_batch(model, {"feats": feats}, teacher=teacher_model,
                             vocab_mapping=vm),
             runs["mp"][4], ["vocab_argmax_lse"])

    # the kernel path against the plain version on the same batch
    kernel = fht._argmax_lse_cuda
    fht._argmax_lse_cuda = (lambda h, W, b, tokens, want_sum:
                            fht._argmax_lse_plain(h, W, b, tokens, 1024,
                                                  want_sum))
    try:
        hyps, lprobs = get_translator(mp).translate_batch(
            model, {"feats": feats}, teacher=teacher_model, vocab_mapping=vm)
    finally:
        fht._argmax_lse_cuda = kernel
    assert hyps == runs["mp"][0], "NAR hypotheses: kernel != plain"
    err = float(np.abs(np.asarray(lprobs) - np.asarray(runs["mp"][1])).max())
    assert err <= 1e-5, err
    print(f"nar mp: the plain version in K2's place gives the same "
          f"{BATCH} hypotheses, log-probs within {err:.2e} (1e-5)")

    rows = BATCH * s_opt["length_beam_size"] * s_opt["max_len"]
    H, V = s_opt["dim_hidden"], s_opt["vocab_size"]
    h, W = _head_inputs(rows, H, V, torch.float32, False, 12)
    tokens = torch.randint(0, V, (rows,), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    _check_argmax_lse_nar(h, W, tokens)
    _check_argmax_lse_nar(*_head_inputs(rows, H, V, torch.bfloat16, True, 13),
                          tokens)
    return totals


# ---------------------------------------------------------------------------
# the RNN captioners
# ---------------------------------------------------------------------------

RNN_EPOCHS, RNN_BATCHES = 2, 2
VERSATILITY_MSRVTT = {"feats": "ViT", "modality": "ami",
                      "decoder_modality_flags": "VA",
                      "predictor_modality_flags": "VAT"}
# (label, the command's flags, where the paper runs it)
RNN = [
    ("SALSTM CARE", dict(VERSATILITY_MSRVTT, method="SALSTM", task="CARE"),
     "scripts/exp_versatility_of_CARE.sh:34"),
    ("TopDown CARE", dict(VERSATILITY_MSRVTT, method="TopDown",
                          task="CARE"),
     "scripts/exp_versatility_of_CARE.sh:44"),
    ("VOE", dict(VERSATILITY_MSRVTT, method="VOE", task="Base"),
     "care_tpu/config/yamls/methods.yaml:30"),
]
# scheduled sampling from epoch 0, at 0.25 in epoch 1
RNN_SAMPLING = {"scheduled_sampling_start": 0,
                "scheduled_sampling_increase_every": 1,
                "scheduled_sampling_increase_prob": 0.25}
# bf16 against f32 decode-step log-probs, relative to the step's largest
# |log-prob|: the bound the bf16 decode is held to on the host
# (tests/test_torch_fused_decode.py, tests/test_torch_rnn.py)
BF16_LOGP_REL = 2e-2


@torch.no_grad()
def _bf16_step_gap(opt, f32_model, feats, steps=3):
    """The largest |bf16 - f32| of the decode-step log-probs (BOS, then the
    f32 model's greedy token) over ``steps`` steps, relative to the step's
    largest |log-prob|, for the bf16 serving copy of ``f32_model``."""
    worst = 0.0
    runs = []
    for cfg in (opt, _half(opt)):
        tr = get_translator(cfg)
        served = tr.serving_model(f32_model)
        inputs = served.prepare_inputs_for_decoder(
            served.encoding_phase(tr._feats({"feats": feats})), {})
        runs.append((served, inputs, served.init_rnn_carry(inputs)))
    tokens = torch.full((len(feats[0]),), constants.BOS, device="cuda")
    for _ in range(steps):
        logps = []
        for i, (served, inputs, carry) in enumerate(runs):
            logits, carry = served.rnn_decode_step(tokens, carry, inputs)
            runs[i] = (served, inputs, carry)
            logps.append(torch.log_softmax(logits.float(), dim=-1))
        scale = logps[0].abs().max().item()
        worst = max(worst, (logps[1] - logps[0]).abs().max().item() / scale)
        tokens = logps[0].argmax(dim=-1)
    return worst


def phase_rnn(scratch) -> dict:
    """The RNN captioners at full width (``--arch base``: H 512; V 11 000;
    28 frames of audio, motion and image; 30 concept slots; batch 64, beam
    5, ``max_len`` 30, random weights from a seed): SALSTM CARE, TopDown
    CARE and the VOE preset. Each trains ``RNN_EPOCHS`` epochs of
    ``RNN_BATCHES`` batches with dropout on and scheduled sampling at 0.25
    in epoch 1 (no kernel launches: the RNN loss stays dense, as in
    ``care_tpu``; VOE's running statistics must move), then ``_serve``
    decodes one batch of 64 and the ragged 17 off the fused head (no
    kernel launches; every score re-checked by teacher forcing; caps/s and
    ms per beam step); the SALSTM batch is profiled, and SALSTM is served
    in bf16 beside f32. Returns the launch counts of the phase, all 0."""
    totals = dict.fromkeys(_launch_counts(), 0)
    for i, (label, flags, where) in enumerate(RNN):
        opt = dict(family_opt(flags), **RNN_SAMPLING)
        print(f"rnn {label} ({where}): encoder {opt['encoder']}, decoder "
              f"{opt['decoder']}, rnn_type {opt['rnn_type']}, use_attr_type "
              f"{opt.get('use_attr_type')!r}, hybrid bias "
              f"{opt['add_hybrid_attention_bias']}, modality "
              f"{opt['modality']}")
        loader = SyntheticLoader(opt, RNN_BATCHES, BATCH, SEED + 100 + i)
        trainer = Trainer(dict(opt, epochs=RNN_EPOCHS,
                               checkpoint_path=os.path.join(
                                   scratch, f"rnn{i}")), loader)
        trainer.init_model()
        stats = _bn_stats(trainer.model)
        torch.cuda.synchronize()
        _zero_launch_counts()
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
        losses = _step_losses(trainer)
        assert not trainer._fused_xent, label
        assert len(losses) == RNN_EPOCHS * RNN_BATCHES, losses
        assert all(np.isfinite(losses)), losses
        assert all(n == 0 for n in counts.values()), (label, counts)
        epoch1 = trainer.history[1]
        share = epoch1["Sampled Share"]
        positions = RNN_BATCHES * BATCH * (opt["max_len"] - 2)
        sigma = (0.25 * 0.75 / positions) ** 0.5
        assert epoch1["schedule_sampling_prob"] == 0.25, epoch1
        assert abs(share - 0.25) <= 4 * sigma, (share, sigma)
        moved = [float((a - b).abs().max())
                 for a, b in zip(_bn_stats(trainer.model), stats)]
        assert (opt["encoder"] == "VOE") == bool(stats), label
        assert all(m > 0 for m in moved), moved
        print(f"rnn {label}: train {len(losses)} steps of batch {BATCH} "
              f"({RNN_EPOCHS} epochs), dropout on, in {seconds:.2f} s with "
              f"model build and first-launch costs; epoch 1 "
              f"{1e3 * epoch1['epoch_time'] / RNN_BATCHES:.1f} ms a step "
              f"(host clock, the epoch's one fetch included); losses "
              f"{[round(l, 4) for l in losses]}; epoch 1 fed a sampled token "
              f"at {100 * share:.2f}% of {positions} positions (p 0.25, "
              f"4 sigma {400 * sigma:.2f}%); kernel launches "
              f"{sum(counts.values())}"
              + (f"; BatchNorm running statistics moved by up to "
                 f"{max(moved):.3e}" if stats else ""))
        for k, n in counts.items():
            totals[k] += n
        del trainer, loader
        run = _serve(f"rnn {label}", opt, [BATCH, RAGGED], False,
                     ["fused_head_topk"] if i == 0 else [])
        for k, n in run["counts"].items():
            totals[k] += n
        if i == 0:
            bf16 = _serve(f"rnn {label}, bf16", _half(opt), [BATCH], False,
                          [])
            _against_f32(f"rnn {label}, bf16", bf16, run)
            for k, n in bf16["counts"].items():
                totals[k] += n
            model = build_captioner(opt, seed=SEED)
            gap = _bf16_step_gap(opt, model,
                                 _synthetic_feats(opt, BATCH, SEED + 10))
            assert gap <= BF16_LOGP_REL, gap
            print(f"serve rnn {label}, bf16: decode-step log-probs within "
                  f"{100 * gap:.3f}% of the step's largest |log-prob| of "
                  f"f32's (bound {100 * BF16_LOGP_REL:g}%)")
            del model
    assert all(n == 0 for n in totals.values()), totals
    return totals


# ---------------------------------------------------------------------------
# PointerGen: the copy head over the retrieved captions
# ---------------------------------------------------------------------------

POINTER_EPOCHS, POINTER_BATCHES = 2, 2
# (label, the command's flags, where the paper runs it)
POINTER = [
    ("PointerGen Base", dict(VERSATILITY_MSRVTT, method="PointerGen",
                             task="Base"),
     "scripts/exp_versatility_of_CARE.sh:70"),
    ("PointerGen CARE", dict(VERSATILITY_MSRVTT, method="PointerGen",
                             task="CARE"),
     "scripts/exp_versatility_of_CARE.sh:74"),
]


def _pointer_fit(opt, scratch, name, seed):
    """``Trainer.fit`` of ``POINTER_EPOCHS`` epochs of ``POINTER_BATCHES``
    synthetic batches of 64, dropout on, with the launch counts set to 0
    just before and read just after. Returns (trainer, counts, seconds,
    the peak of allocated device memory)."""
    loader = SyntheticLoader(opt, POINTER_BATCHES, BATCH, seed)
    trainer = Trainer(dict(opt, epochs=POINTER_EPOCHS,
                           checkpoint_path=os.path.join(scratch, name)),
                      loader)
    trainer.init_model()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    return (trainer, _launch_counts(), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


@torch.no_grad()
def _time_pointer_step(opt, model) -> tuple:
    """The pointer of one beam step alone at the serving shape (batch 64 x
    beam 5 rows, the retrieved captions enlarged to them, as the decode
    step gives them), warm calls between CUDA events: (ms, the GFLOP of
    its K/V projection, its bytes of enlarged embeddings)."""
    rows = BATCH * opt["beam_size"]
    R, S, H, V = (opt["retrieval_topk"], opt["max_len"], opt["dim_hidden"],
                  opt["vocab_size"])
    g = torch.Generator("cuda").manual_seed(3)
    h = torch.randn(rows, 1, H, device="cuda", generator=g)
    embs = torch.randn(rows, R, S, H, device="cuda", generator=g)
    ids = torch.as_tensor(_retrieved_ids(opt, BATCH, 5),
                          device="cuda").repeat_interleave(
                              opt["beam_size"], dim=0)
    logits = torch.randn(rows, 1, V, device="cuda", generator=g)
    ms = _time_ms(lambda: model.pointer(h, embs, ids, logits), n=10, warm=3)
    return ms, 2 * 2 * rows * R * S * H * H / 1e9, embs.nbytes


def phase_pointer(scratch) -> dict:
    """PointerGen Base and PointerGen CARE on MSRVTT at full width
    (``--arch base``: H 512; V 11 000; ViT features, ``--modality ami``;
    ``retrieval_topk`` 20 retrieved captions of ``max_len`` 30 token ids,
    ``exclude_eos``; batch 64, beam 5; random weights from a seed). Each
    trains ``POINTER_EPOCHS`` epochs of ``POINTER_BATCHES`` steps with
    dropout on (the dense cross-entropy on the pointer's probabilities),
    then again from the same seed: the parameters must be equal bit for
    bit (the copy scatter's determinism; the gap is printed). ``_serve``
    then decodes one batch of 64 and the ragged 17 through the dense
    pointer step, every score re-checked by teacher forcing; the batch of
    64 is profiled with the pointer's share of device time, and the
    pointer of one beam step is timed alone. K1-K4c launch 0 times in the
    phase, as ``care_tpu`` keeps pointer models off the fused head, the
    fused cross-entropy and flash attention. Returns the launch counts,
    all 0."""
    from care_tpu_torch.models.pointer import Pointer
    totals = dict.fromkeys(_launch_counts(), 0)
    for i, (label, flags, where) in enumerate(POINTER):
        opt = family_opt(flags)
        assert opt["pointer"] == "Pointer" and opt["modality"].endswith("t")
        print(f"pointer {label} ({where}): modality {opt['modality']}, "
              f"{opt['retrieval_topk']} retrieved captions of "
              f"{opt['max_len']} ids, exclude_eos {opt['exclude_eos']}, "
              f"copy_scale {opt['copy_scale']}, use_attr_type "
              f"{opt.get('use_attr_type')!r}")
        runs = []
        for repeat in range(2):
            trainer, counts, seconds, peak = _pointer_fit(
                opt, scratch, f"pointer{i}_{repeat}", SEED + 120 + i)
            assert not trainer._fused_xent, label
            assert all(n == 0 for n in counts.values()), (label, counts)
            runs.append((trainer, seconds, peak))
        losses = _step_losses(runs[0][0])
        assert len(losses) == POINTER_EPOCHS * POINTER_BATCHES, losses
        assert all(np.isfinite(losses)), losses
        assert losses == _step_losses(runs[1][0]), label
        gap = max(float((a - b).detach().abs().max()) for a, b in zip(
            runs[0][0].model.parameters(), runs[1][0].model.parameters()))
        assert gap == 0.0, (label, gap)
        epoch1 = runs[0][0].history[1]
        print(f"pointer {label}: train {len(losses)} steps of batch {BATCH} "
              f"({POINTER_EPOCHS} epochs), dropout on, dense "
              f"cross-entropy on the pointer's probabilities, in "
              f"{runs[0][1]:.2f} s with model build and first-launch costs; "
              f"epoch 1 {1e3 * epoch1['epoch_time'] / POINTER_BATCHES:.1f} "
              f"ms a step (host clock, the epoch's one fetch included); "
              f"peak device memory {runs[0][2] / 2**30:.3f} GiB allocated "
              f"(repeat {runs[1][2] / 2**30:.3f}); losses "
              f"{[round(l, 4) for l in losses]}; a repeat from the same "
              f"seed: losses equal, parameter gap {gap!r}; kernel "
              f"launches 0")
        model = runs[0][0].model.eval()
        del runs
        pointer_ms, gflop, n_bytes = _time_pointer_step(opt, model)
        print(f"pointer {label}: the pointer of one beam step alone "
              f"([{BATCH * opt['beam_size']}, 1, {opt['dim_hidden']}] "
              f"queries over {opt['retrieval_topk']} x {opt['max_len']} "
              f"enlarged captions, {n_bytes / 1e6:.1f} MB of embeddings; "
              f"K/V projection {gflop:.1f} GFLOP): {pointer_ms:.3f} ms "
              f"({gflop / pointer_ms:.1f} TFLOP/s on the projection)")
        del model
        run = _serve(f"pointer {label}", opt, [BATCH, RAGGED], False, [],
                     profile_ranges=[("pointer", Pointer)])
        for k, n in run["counts"].items():
            totals[k] += n
        if run["profile"] and run["profile"][0]:
            busy, ranges = run["profile"]
            print(f"pointer {label}: device busy {busy:.3f} ms a batch of "
                  f"{BATCH}, the pointer {ranges['pointer']:.3f} ms of it "
                  f"({100 * ranges['pointer'] / busy:.1f}%)")
    assert all(n == 0 for n in totals.values()), totals
    return totals


# ---------------------------------------------------------------------------
# ensembles
# ---------------------------------------------------------------------------

# the flagship and PointerGen CARE on the same MSRVTT features: the
# ensemble's modalities are amir and amirt
ENSEMBLE = [("flagship", dict(VERSATILITY_MSRVTT, method="Transformer",
                              task="CARE"),
             "__graft_entry__.py:_flagship_opt"),
            POINTER[1]]


def phase_ensemble(scratch) -> dict:
    """Ensembles at full width (batch 64, beam 5), with the launch counts
    set to 0 just before and read just after: (1) PointerGen CARE with
    itself decodes what it decodes alone (``==`` on hypotheses and scores:
    the mean of equal log-probabilities is themselves); (2) the
    heterogeneous ensemble of the CARE flagship (``amir``) and PointerGen
    CARE (``amirt``): 3 batches of 64 and the ragged 17, split from the
    union's features by ``EnsembleSpec``, decoded batch by batch and
    grouped (``translate_batches_grouped``, fused-K 4), equal results
    (``==``), caps/s of each; (3) ``care_tpu_torch.translate.main`` with
    the two checkpoints the phase writes (``-cp a b``) on the test split of
    a synthetic dataset of the union's modalities with a retrieval
    database. No kernel launches: ensembles take the dense step, as in
    ``care_tpu``."""
    import care_tpu_torch.data as data_pkg
    from care_tpu_torch import translate
    from care_tpu_torch.models.ensemble import EnsembleSpec
    from care_tpu_torch.models.weights import variables_to_jax
    from care_tpu_torch.training.checkpoints import save_checkpoint
    opts = [family_opt(flags) for _, flags, _ in ENSEMBLE]
    assert [o["modality"] for o in opts] == ["amir", "amirt"], opts
    models = [build_captioner(o, seed=SEED + 30 + i)
              for i, o in enumerate(opts)]
    spec = EnsembleSpec(opts)
    assert spec.need_to_split_feats and spec.opt["modality"] == "amirt"
    merged = {**opts[0], **{k: v for k, v in spec.opt.items()
                            if v is not None}}
    translator = get_translator(merged)
    union = dict(opts[1])
    feats = [_synthetic_feats(union, n, SEED + 60 + j)
             for j, n in enumerate([BATCH] * 3 + [RAGGED])]
    batches = [{"feats": spec.split_feats(f)} for f in feats]
    pointer_alone = get_translator(opts[1])
    torch.cuda.synchronize()
    _zero_launch_counts()

    alone = pointer_alone.translate_batch(models[1],
                                          {"feats": feats[0]})
    pair = pointer_alone.translate_batch([models[1], models[1]],
                                         {"feats": feats[0]})
    assert pair == alone
    print(f"ensemble: PointerGen CARE with itself == PointerGen CARE alone "
          f"on a batch of {BATCH} (hypotheses and scores)")

    translator.translate_batch(models, batches[0])             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_by_one = [translator.translate_batch(models, b) for b in batches]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grouped = [out for _, out in translator.translate_batches_grouped(
        models, enumerate(batches), 4)]
    torch.cuda.synchronize()
    grouped_s = time.perf_counter() - t0
    assert grouped == one_by_one
    n_caps = sum(len(f[0]) for f in feats)
    assert all(len(h) == len(f[0]) and all(len(x[0]) >= 1 for x in h)
               for (h, _), f in zip(one_by_one, feats))
    print(f"ensemble: flagship (amir) + PointerGen CARE (amirt), features "
          f"split from the union {spec.opt['modality']}: {len(batches)} "
          f"batches ({n_caps} videos) batch by batch {single_s:.3f} s "
          f"({n_caps / single_s:.1f} caps/s), grouped fused-K 4 "
          f"{grouped_s:.3f} s ({n_caps / grouped_s:.1f} caps/s), results "
          f"equal (==)")

    root = os.path.join(scratch, "ensemble")
    data_opt, _, corpus, _, loader_fn = _pipeline_data(
        dict(union, eval_batch_size=BATCH), root)
    paths = []
    for i, (model, o) in enumerate(zip(models, opts)):
        o = dict(o, info_corpus=data_opt["info_corpus"],
                 reference=data_opt["reference"])
        for c in o["modality"]:
            o[f"feats_{c}"] = data_opt[f"feats_{c}"]
        paths.append(os.path.join(root, f"member{i}", "best.ckpt"))
        save_checkpoint(paths[-1], variables_to_jax(model), o)
    out = os.path.join(scratch, "ensemble_out")
    inner_loader = data_pkg.get_loader
    data_pkg.get_loader = loader_fn
    try:
        t0 = time.perf_counter()
        (scores,) = translate.main(["-cp", *paths, "--base_data_path", root,
                                    "--batch_size", str(BATCH),
                                    "--json_path", out])
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t0
    finally:
        data_pkg.get_loader = inner_loader
    counts = _launch_counts()
    with open(os.path.join(out, "preds.json")) as f:
        preds = json.load(f)
    n_test = len(corpus["info"]["split"]["test"])
    assert len(preds) == n_test, (len(preds), n_test)
    assert all(n == 0 for n in counts.values()), counts
    print(f"ensemble: translate -cp <flagship> <PointerGen CARE> on "
          f"{n_test} test videos in {entry_s:.3f} s (load_model, loader and "
          f"scoring included): CIDEr {scores['CIDEr']:.6f}; kernel "
          f"launches in the phase 0")
    return counts


# ---------------------------------------------------------------------------
# the visual front: the CLIP backbone inside the flagship, the towers'
# pretreatment, the retrieval database, the patch encoders
# ---------------------------------------------------------------------------

BACKBONE = "clip~ViT-B/32"
FRAME_SIDE = 224
BACKBONE_TRAIN_BATCH, BACKBONE_TRAIN_BATCHES = 16, 2
TOWERS = (("clip ViT-B/32", 224), ("resnet50", 224),
          ("inceptionresnetv2", 299))
TOWER_FRAMES = 448
TOWER_CPU_FRAMES = 4
# MSRVTT's size: 10 000 videos x 20 captions, CLIP ViT-B/32's 512 wide
RETRIEVAL_VIDEOS, RETRIEVAL_CAPTIONS, RETRIEVAL_DIM = 10000, 20, 512
RETRIEVAL_TOPK, RETRIEVAL_CPU_RANK_ROWS = 20, 500
PATCH_LAYERS, PATCH_SIDE = 4, 7
PATCH_ENCODERS = (("CNN1", "m"), ("CNN2", "m"), ("CNN3", "m"),
                  ("SingleStreamEmbedder", "ami"))


def backbone_opt() -> dict:
    """The flagship with CLIP ViT-B/32 on its image stream: raw frames
    [B, 28, 224, 224, 3] in, the tower's 512-wide features to
    ``Encoder_I`` (the flagship's ``amir`` streams, ``with_backbones``
    ``["", "", "clip~ViT-B/32", ""]``)."""
    opt = flagship_opt()
    opt["with_backbones"] = ["" if c != "i" else BACKBONE
                             for c in opt["modality"]]
    assert opt["modality"] == "amir" and opt["dim_i"] == 512
    return opt


def _frames(n, n_frames, seed, side=FRAME_SIDE):
    """Raw frames of normalized values [n, n_frames, side, side, 3]."""
    return np.random.default_rng(seed).standard_normal(
        (n, n_frames, side, side, 3), dtype=np.float32)


def _tower(name, seed):
    from care_tpu_torch.models.cnn import create_cnn
    from care_tpu_torch.pretreatment.clip import CLIPVisionTransformer
    g = torch.Generator().manual_seed(seed)
    model = (CLIPVisionTransformer(generator=g) if name.startswith("clip")
             else create_cnn(name, g))
    return model.eval()


def _backbone_train(opt, loader, scratch, label):
    """``Trainer.fit`` with the counts set to 0 just before: (trainer,
    counts, seconds, peak MiB allocated above what was resident)."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(dict(opt, checkpoint_path=os.path.join(scratch,
                                                             label)), loader)
    trainer.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**20
    return trainer, _launch_counts(), seconds, peak


def phase_backbone(scratch) -> dict:
    """The visual front at full width, on raw frames of normalized values
    from the seed. (1) Serve: the flagship with CLIP ViT-B/32 (patch 32,
    width 768, 12 layers, 12 heads, output 512, 224 x 224; random weights)
    captions 64 + 17 videos of 28 frames through ``translate_batch``
    (``_serve``: K1 == beam steps, scores re-checked by teacher forcing,
    one batch profiled with the backbone's share of device time, the 1.08
    GB frame copy of a batch timed alone), and 2 videos are decoded on the
    card and on the CPU (beams equal). (2) Train: ``Trainer.fit`` with ``fused_xent:
    True`` at batch 16 (448 frames a step through the tower), K2, K3a and
    K3b once per step, ms a step and the peak of allocated memory; then
    the run again from one seed with cuDNN deterministic: losses equal and
    a parameter gap of exactly 0.0. (3) Pretreatment: ``encode_images`` of
    CLIP ViT-B/32, ResNet-50 and InceptionResNetV2 on 448 frames each
    (images/s from numpy and of the device forward alone), held to the CPU
    port on 4 frames; ``retrieve_topk`` and ``evaluate_retrieval`` on
    MSRVTT's size (10 000 videos x 20 captions of 512), indices equal to
    the CPU's (all top-k rows; the ranks of 500 videos). (4) The patch
    encoders (``CNN1``, ``CNN2``, ``CNN3`` on 28 frames of 4 layers x 49
    patches; ``SingleStreamEmbedder`` on ``ami``) with the flagship's
    decoder (``Transformer Base``, H 512, V 11 000): one fused train step
    and one decode of 64 each (K2, K3a, K3b == 1, K1 == beam steps), beams
    of 2 videos equal to the CPU's. Returns the launch counts of (1), (2)
    and (4), each read right after its own run."""
    from care_tpu_torch.models.backbone import BackboneManager
    from care_tpu_torch.models.cnn import encode_images as encode_cnn
    from care_tpu_torch.models.weights import params_to_jax
    from care_tpu_torch.pretreatment import retrieval
    from care_tpu_torch.pretreatment.clip import encode_images as encode_clip

    opt = backbone_opt()
    totals = dict.fromkeys(KERNELS, 0)

    # (1) serving
    served = _serve("backbone", opt, [BATCH, RAGGED], False,
                    ["fused_head_topk"], time_copy=True,
                    profile_ranges=(("backbone", BackboneManager),))
    for k, n in served["counts"].items():
        totals[k] += n
    feats = _synthetic_feats(opt, 2, SEED + 70)
    beams = []
    for device in ("cuda", "cpu"):
        model = build_captioner(opt, device=device, seed=SEED)
        beams.append(get_translator(opt, device=device).translate_batch(
            model, {"feats": feats}))
    assert beams[0][0] == beams[1][0], beams
    gap = float(np.max(np.abs(np.asarray(beams[0][1])
                              - np.asarray(beams[1][1]))))
    assert gap <= 1e-4, gap
    print(f"backbone: 2 videos decoded on the card and on the CPU: beams "
          f"equal, scores within {gap:.2e}")

    # (2) training, twice from one seed
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        loader = SyntheticLoader(opt, BACKBONE_TRAIN_BATCHES,
                                 BACKBONE_TRAIN_BATCH, SEED + 80)
        train_opt = dict(opt, fused_xent=True, epochs=2,
                         batch_size=BACKBONE_TRAIN_BATCH)
        steps = 2 * BACKBONE_TRAIN_BATCHES
        runs = []
        for label in ("backbone_train", "backbone_repeat"):
            trainer, counts, seconds, peak = _backbone_train(
                train_opt, loader, scratch, label)
            assert trainer._fused_xent and trainer.global_step == steps
            for name, n in counts.items():
                assert n == (steps if name in (
                    "vocab_argmax_lse", "fused_xent_bwd_dh",
                    "fused_xent_bwd_dw") else 0), (name, counts)
            losses = _step_losses(trainer)
            assert all(np.isfinite(losses)), losses
            ms = 1e3 * trainer.history[-1]["epoch_time"] / len(loader)
            runs.append((losses, params_to_jax(trainer.model), counts))
            print(f"backbone: train {steps} steps of batch "
                  f"{BACKBONE_TRAIN_BATCH} ({BACKBONE_TRAIN_BATCH * 28} "
                  f"frames a step through the tower), fused_xent on, "
                  f"dropout on, in {seconds:.2f} s with model build; epoch "
                  f"1 {ms:.1f} ms a step (host clock); peak device memory "
                  f"{peak / 1024:.3f} GiB allocated; losses "
                  f"{[round(l, 4) for l in losses]}; launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
            del trainer
        (loss_a, params_a, counts), (loss_b, params_b, _) = runs
        assert loss_a == loss_b, (loss_a, loss_b)

        def leaves(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from leaves(v, prefix + k + "/")
                else:
                    yield prefix + k, v
        b = dict(leaves(params_b))
        param_gap = max(float(np.abs(v - b[k]).max())
                        for k, v in leaves(params_a))
        assert param_gap == 0.0, param_gap
        for k, n in counts.items():
            totals[k] += n
        print(f"backbone: the run repeated from one seed (cuDNN "
              f"deterministic): losses equal, parameter gap {param_gap}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = cudnn

    # (3) pretreatment: the towers, then the retrieval database
    for name, side in TOWERS:
        model = _tower(name.split()[0], SEED + 90)
        frames = _frames(1, TOWER_FRAMES, SEED + 91, side)[0]
        encode = encode_clip if name.startswith("clip") else encode_cnn
        want = encode(model, frames[:TOWER_CPU_FRAMES])
        model = model.cuda()
        encode(model, frames[:64])                             # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = encode(model, frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        on_card = torch.as_tensor(frames, device="cuda")
        with torch.no_grad():
            fwd_ms = _time_ms(lambda: model(on_card), n=3, warm=1)
        atol = 5e-4 if name == "inceptionresnetv2" else 2e-4
        err = float(np.max(np.abs(got[:TOWER_CPU_FRAMES] - want)))
        np.testing.assert_allclose(got[:TOWER_CPU_FRAMES], want, rtol=1e-3,
                                   atol=atol)
        assert np.isfinite(got).all() and got.shape[0] == TOWER_FRAMES
        print(f"pretreatment {name} at {side}x{side}: encode_images of "
              f"{TOWER_FRAMES} frames from numpy {wall:.3f} s "
              f"({TOWER_FRAMES / wall:.1f} images/s); the device forward "
              f"of the {TOWER_FRAMES} alone {fwd_ms:.2f} ms "
              f"({1e3 * TOWER_FRAMES / fwd_ms:.1f} images/s); features "
              f"{list(got.shape)}, |max| {float(np.abs(got).max()):.3g}, "
              f"against the CPU on {TOWER_CPU_FRAMES} frames max |diff| "
              f"{err:.2e} (atol {atol:g}, rtol 1e-3)")
        del model, on_card

    rs = np.random.default_rng(SEED + 100)
    n_text = RETRIEVAL_VIDEOS * RETRIEVAL_CAPTIONS
    image = rs.standard_normal((RETRIEVAL_VIDEOS, RETRIEVAL_DIM),
                               dtype=np.float32)
    # each video's captions near its embedding, as CLIP places them
    text = (np.repeat(image, RETRIEVAL_CAPTIONS, axis=0)
            + 10.0 * rs.standard_normal((n_text, RETRIEVAL_DIM),
                                        dtype=np.float32))
    own = [(RETRIEVAL_CAPTIONS * i, RETRIEVAL_CAPTIONS * (i + 1))
           for i in range(RETRIEVAL_VIDEOS)]
    refs = [f"caption {j % (n_text * 3 // 4)}" for j in range(n_text)]
    k = RETRIEVAL_TOPK * 20 + 64
    retrieval.sims_topk(image[:64], text, k)                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top_card = retrieval.sims_topk(image, text, k)
    topk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    top_cpu = retrieval.sims_topk(image, text, k, device="cpu")
    cpu_s = time.perf_counter() - t0
    assert np.array_equal(top_card, top_cpu), \
        int((top_card != top_cpu).any(axis=1).sum())
    t0 = time.perf_counter()
    ids = retrieval.retrieve_topk(image, text, RETRIEVAL_TOPK,
                                  own_ranges=own, refs=refs, unique=True)
    filter_s = time.perf_counter() - t0
    assert all(len(r) == RETRIEVAL_TOPK for r in ids)
    assert all(not s <= i < e for r, (s, e) in zip(ids, own) for i in r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = retrieval.evaluate_retrieval(image, text, own)
    eval_s = time.perf_counter() - t0
    rows = RETRIEVAL_CPU_RANK_ROWS
    ranks_card = retrieval.own_caption_ranks(image[:rows], text, own[:rows])
    ranks_cpu = retrieval.own_caption_ranks(image[:rows], text, own[:rows],
                                            device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(ranks_card, ranks_cpu))
    print(f"pretreatment retrieval: {RETRIEVAL_VIDEOS} videos x "
          f"{n_text} captions of {RETRIEVAL_DIM}: similarity top-{k} on the "
          f"card {topk_s:.3f} s, on the CPU {cpu_s:.3f} s, indices equal "
          f"(all rows, ties lowest index first); retrieve_topk with the "
          f"own-range and duplicate filters {filter_s:.3f} s; "
          f"evaluate_retrieval {eval_s:.3f} s: "
          f"{ {m: round(v, 4) for m, v in metrics.items()} }; own-caption "
          f"ranks of {rows} videos equal to the CPU's")

    # (4) the patch encoders with the flagship's decoder
    for encoder, modality in PATCH_ENCODERS:
        popt = get_opt({"dataset": "MSRVTT", "method": "Transformer",
                        "task": "Base", "feats": "ViT", "modality": modality,
                        "encoder": encoder, "vocab_size": 11000},
                       read_vocab=False, resolve_paths=False)
        popt.update(dim_a=128, dim_m=2048, dim_i=512)
        if encoder.startswith("CNN"):
            popt["dim_m"] = PATCH_SIDE ** 2
        loader = SyntheticLoader(popt, 1, BATCH, SEED + 110)
        trainer, counts, seconds, peak = _backbone_train(
            dict(popt, fused_xent=True, epochs=1), loader, scratch,
            f"patch_{encoder}")
        for name, n in counts.items():
            assert n == (1 if name in ("vocab_argmax_lse",
                                       "fused_xent_bwd_dh",
                                       "fused_xent_bwd_dw") else 0), counts
            totals[name] += n
        loss = _step_losses(trainer)[0]
        assert np.isfinite(loss)
        model = trainer.model.eval()
        translator = get_translator(popt)
        feats = _synthetic_feats(popt, BATCH, SEED + 120)
        _zero_launch_counts()
        translator.beam_steps = 0
        t0 = time.perf_counter()
        hyps, scores = translator.translate_batch(model, {"feats": feats})
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counts, steps = _launch_counts(), translator.beam_steps
        assert counts["fused_head_topk"] == steps > 0, (counts, steps)
        totals["fused_head_topk"] += counts["fused_head_topk"]
        assert all(np.isfinite(s[0]) for s in scores)
        cpu_model = build_captioner(popt, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        few = [f[:2] for f in feats]
        want_h, want_s = get_translator(popt, device="cpu").translate_batch(
            cpu_model, {"feats": few})
        got_h, got_s = translator.translate_batch(model, {"feats": few})
        assert got_h == want_h, (got_h, want_h)
        gap = float(np.max(np.abs(np.asarray(got_s) - np.asarray(want_s))))
        assert gap <= 1e-4, gap
        print(f"patch encoder {encoder} ({type(model.encoder).__name__}, "
              f"modality {modality}, stream "
              f"{list(feats[0].shape)}): one fused train step of {BATCH} "
              f"(loss {loss:.4f}, {seconds:.2f} s with model build, peak "
              f"{peak / 1024:.3f} GiB), a decode of {BATCH} in "
              f"{decode_s:.3f} s with K1 == {steps} beam steps; 2 videos "
              f"on the CPU: beams equal, scores within "
              f"{gap:.2e}")
        del trainer, model, cpu_model
    return totals


def _xent_scratch(opt) -> None:
    """What the wrappers of K3a and K3b allocate beyond their outputs (dh;
    dW and db) at the training shape: the peak of allocated device memory
    during one call."""
    rows, H, V = BATCH * (opt["max_len"] - 1), opt["dim_hidden"], \
        opt["vocab_size"]
    h, W, _, labels, cot = _xent_inputs(rows, H, V, torch.float32, False,
                                        False, 5)
    lse = fht._argmax_lse_plain(h, W, None, labels, 1024, False)[2]
    for label, want_dh in (("K3a", True), ("K3b", False)):
        # the bytes asked for, not the allocator's rounded blocks
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        out = fx._bwd_cuda(h, W, None, labels, lse, *cot, want_dh=want_dh,
                           want_dw=not want_dh)
        torch.cuda.synchronize()
        peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
        extra = peak - before - sum(t.nbytes for t in out if t is not None)
        print(f"train: {label} scratch at [{rows}, {H}] x [{V}, {H}]: "
              f"{extra} bytes allocated beyond its outputs (the int32 copy "
              f"of the labels; no partials in device memory)")
        del out


# ---------------------------------------------------------------------------
# the main path end to end: data on disk, train, validate, checkpoints, test
# ---------------------------------------------------------------------------

PIPELINE_VIDEOS, PIPELINE_EPOCHS = 400, 2
OPTIONAL_PACKAGES = ("h5py", "pandas", "nltk", "tensorboardX")


def _synthetic_stores(opt, corpus, n_videos, seed):
    """The features ``write_synthetic_dataset(root, opt, n_videos, seed)``
    writes, drawn in the same order from the same ``RandomState``, as
    dicts."""
    vocab_size = len(corpus["info"]["itow"])
    rng = np.random.RandomState(seed + 1)
    stores = {}
    for char in opt["modality"]:
        if char == "t":
            # the retrieval database: training-caption indices a video
            train = corpus_lib.get_ids_set("train", corpus["info"]["split"])
            n_flat = sum(len(corpus["captions"]["video%d" % v])
                         for v in train)
            topk = max(opt["retrieval_topk"], 20)
            stores["memory:t"] = {"video%d_i" % v: rng.randint(0, n_flat,
                                                               topk)
                                  for v in range(n_videos)}
            continue
        dim = opt[f"dim_{char}"]
        rng.randn(vocab_size, dim)          # the writer's word codes
        stores[f"memory:{char}"] = {
            "video%d" % v: rng.randn(opt["n_total_frames"], dim
                                     ).astype(np.float32)
            for v in range(n_videos)}
    return stores


def _pipeline_data(opt, root):
    """Write the synthetic dataset under ``root`` (HDF5 when ``h5py``
    imports, else the same arrays in memory), widen the written corpus's
    vocabulary to ``opt["vocab_size"]`` with unused words, and point the
    options at it. Returns (opt, loaders, corpus, references, a
    ``get_loader`` over the store)."""
    import pickle
    opt = dict(opt)
    hdf5 = importlib.util.find_spec("h5py") is not None
    if hdf5:
        data_dir, paths, _, _ = corpus_lib.write_synthetic_dataset(
            root, opt, n_videos=PIPELINE_VIDEOS, seed=SEED)
        for char, path in paths.items():
            opt[f"feats_{char}"] = [path]
    else:
        data_dir = os.path.join(root, opt["dataset"])
        os.makedirs(data_dir, exist_ok=True)
        corpus = corpus_lib.build_synthetic_corpus(
            n_videos=PIPELINE_VIDEOS, seed=SEED, max_len=opt["max_len"],
            attribute_k=opt["attribute_prediction_k"])
        for name, obj in (("info_corpus.pkl", corpus), ("refs.pkl",
                          corpus_lib.build_synthetic_references(corpus))):
            with open(os.path.join(data_dir, name), "wb") as f:
                pickle.dump(obj, f)
        stores = _synthetic_stores(opt, corpus, PIPELINE_VIDEOS, SEED)

        class InMemoryJointDataset(JointDataset):
            """``JointDataset`` over the feature stores held in memory:
            ``opt["feats_<c>"]`` names a key of ``stores``, a dict vid ->
            [frames, dim] array, which answers ``vid in db`` and
            ``db[vid]`` as an open HDF5 file does."""

            def _load_database(self, path):
                return [stores[p] for p in path]

        for char in opt["modality"]:
            opt[f"feats_{char}"] = [f"memory:{char}"]
    print(f"pipeline: feature store: "
          f"{'hdf5' if hdf5 else 'dict (h5py absent)'}")
    opt["info_corpus"] = os.path.join(data_dir, "info_corpus.pkl")
    opt["reference"] = os.path.join(data_dir, "refs.pkl")
    # the vocab head at the serving phase's width: words the captions never
    # use, written into the corpus before anything reads it
    corpus = corpus_lib.load_info_corpus(opt["info_corpus"])
    itow = corpus["info"]["itow"]
    used = len(itow)
    for i in range(used, opt["vocab_size"]):
        itow[i] = f"unused{i}"
    with open(opt["info_corpus"], "wb") as f:
        pickle.dump(corpus, f)
    split = [len(corpus["info"]["split"][m])
             for m in ("train", "validate", "test")]
    print(f"pipeline: {PIPELINE_VIDEOS} videos, split {split}, {used} words "
          f"used of the {len(itow)} in the vocabulary")

    def loader(opt, mode, specific=-1, batch_size=None, not_shuffle=False,
               is_validation=False, pad_to_batch=False):
        """``get_loader`` over either store (its signature, so that the
        entry phase can stand it in for ``care_tpu_torch.data.get_loader``
        where the store is in memory)."""
        if hdf5:
            return get_loader(opt, mode, specific=specific,
                              is_validation=is_validation,
                              not_shuffle=not_shuffle, batch_size=batch_size,
                              pad_to_batch=pad_to_batch)
        dataset = InMemoryJointDataset(opt, mode, specific=specific,
                                       is_validation=is_validation)
        return Loader(dataset, batch_size or opt["batch_size"],
                      mode == "train" and not not_shuffle, seed=opt["seed"],
                      pad_to_batch=pad_to_batch)

    # the loaders of care_tpu_torch.train.run
    eval_kwargs = dict(not_shuffle=True, batch_size=opt["eval_batch_size"],
                       pad_to_batch=True)
    loaders = dict(
        train_loader=loader(opt, "train"),
        val_loader=loader(opt, "validate", is_validation=True, **eval_kwargs),
        test_loader=loader(opt, "test", **eval_kwargs))
    return (opt, loaders, corpus,
            corpus_lib.load_references(opt["reference"]), loader)


def _loader_ms(loader) -> float:
    """Host milliseconds per batch of one pass over ``loader`` alone: HDF5
    reads, frame sampling, targets and collation."""
    loader.set_epoch(0)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return 1e3 * (time.perf_counter() - t0) / n


def _timed(obj, name, seconds):
    """Wrap ``obj.name`` so that each call adds its wall time (ending in a
    synchronise) to the list ``seconds``."""
    inner = getattr(obj, name)

    @functools.wraps(inner)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, timed)
    return inner


def _resume_run(opt, loaders, refs, vocab, epochs, state_dir, ckpt_dir):
    trainer = Trainer(dict(opt, epochs=epochs, resume=True,
                           train_state_dir=state_dir,
                           checkpoint_path=ckpt_dir),
                      train_loader=loaders["train_loader"], references=refs,
                      vocab=vocab)
    trainer.fit()
    return trainer


def _validate_preds(trainer, fused_k):
    """``trainer.validate()`` with ``eval_fused_k`` set to ``fused_k``;
    returns its scores and the predictions it scored."""
    preds = {}
    collect = trainer._collect_preds

    def spy(*args):
        out = collect(*args)
        preds.update(out)
        return out

    trainer._collect_preds = spy
    kept, trainer.opt["eval_fused_k"] = trainer.opt["eval_fused_k"], fused_k
    try:
        return trainer.validate(), preds
    finally:
        trainer.opt["eval_fused_k"] = kept
        del trainer._collect_preds


def phase_pipeline(opt, scratch) -> dict:
    """The port's main path as ``care_tpu_torch.train.run`` drives it, on
    the flagship at full width (fused cross-entropy, dropout on, the
    dual-Adam switch at epoch 1): a synthetic dataset in the reference's
    layout, 2 epochs of ``Trainer.fit`` through the port's loader with
    beam-search validation and COCO scores after each, top-1 checkpoints on
    CIDEr, ``load_best`` and ``test``; the launch counts set to 0 just
    before and read just after. It runs on ``care_tpu``'s defaults: every
    train batch's features come from the device feature bank, and
    validation decodes in groups of ``eval_fused_k`` batches, whose COCO
    dict must equal batch-by-batch validation's. Then a resume check, the
    bank on: 1 epoch, and a second trainer resuming it to 2, against the
    main run. Returns the launch counts and what the entry phase needs."""
    from care_tpu_torch import native
    from care_tpu_torch.metrics import meteor
    from care_tpu_torch.training import checkpoints as ckpt_lib
    base = dict(opt, epochs=PIPELINE_EPOCHS, batch_size=BATCH,
                eval_batch_size=BATCH, fused_xent=True, lowlr_start_epoch=1,
                checkpoint_path=os.path.join(scratch, "pipeline", "exps"))
    # care_tpu's defaults, which the port now takes: the device feature
    # bank and fused-K validation
    assert base["device_feature_cache"] and base["eval_fused_k"] == 4, base
    t0 = time.perf_counter()
    base, loaders, corpus, refs, loader_fn = _pipeline_data(
        base, os.path.join(scratch, "pipeline"))
    vocab = corpus["info"]["itow"]
    print(f"pipeline: dataset written and loaders built in "
          f"{time.perf_counter() - t0:.1f} s")
    loader_ms = _loader_ms(loaders["train_loader"])
    # the loader as the bank leaves it (its own dataset, so that the main
    # run's sampling streams stay where they are): no feature reads
    skip_loader = loader_fn(base, "train")
    skip_loader.dataset.skip_feats = True
    skip_ms = _loader_ms(skip_loader)

    trainer = Trainer(base, **loaders, references=refs, vocab=vocab,
                      log_dir=os.path.join(base["checkpoint_path"], "tb"))
    trainer.init_model()
    t0 = time.perf_counter()
    trainer._maybe_build_feature_bank()
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    bank = trainer._feature_bank
    assert bank is not None, "the device feature bank was not built"
    assert loaders["train_loader"].dataset.skip_feats
    translator = trainer.translator
    grouped_calls = []
    inner_grouped = translator.translate_batches_grouped

    def grouped(*args, **kwargs):
        grouped_calls.append(args[2] if len(args) > 2 else kwargs["fused_k"])
        return inner_grouped(*args, **kwargs)

    translator.translate_batches_grouped = grouped
    val_s, score_s, save_s = [], [], []
    _timed(trainer, "validate", val_s)
    _timed(trainer.ckpt_manager, "on_epoch_end", save_s)
    score = _timed(COCOScorer, "score", score_s)
    try:
        _zero_launch_counts()
        t0 = time.perf_counter()
        trainer.fit()
        # the uninterrupted run the resume check holds a resumed one to
        trainer_history = list(trainer.history)
        final_state = {k: v.clone()
                       for k, v in trainer.model.state_dict().items()}
        t_load = time.perf_counter()
        trainer.load_best()
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t_load
        test_scores = trainer.test(info_corpus=corpus)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
    finally:
        COCOScorer.score = score
    steps = trainer.global_step
    beam_steps = trainer.translator.beam_steps
    n_val = len(loaders["val_loader"]) * PIPELINE_EPOCHS
    n_test = len(loaders["test_loader"])
    trained = ("vocab_argmax_lse", "fused_xent_bwd_dh", "fused_xent_bwd_dw")
    assert steps == PIPELINE_EPOCHS * len(loaders["train_loader"]), steps
    assert beam_steps > 0 and counts["fused_head_topk"] == beam_steps, \
        (counts, beam_steps)
    # a batch runs at most max_len - 1 beam steps (fewer once every beam
    # has emitted EOS)
    assert beam_steps <= (n_val + n_test) * (base["max_len"] - 1), beam_steps
    for name in trained:
        assert counts[name] == steps, (name, counts, steps)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == 0, (name, counts)
    assert trainer._switched and trainer._fused_xent
    # every train step's features came from the bank, and every validation
    # decoded in groups (K clamped to the validation set's batches)
    lookups = bank.lookups
    assert lookups == steps, (lookups, steps)
    fused_k = min(base["eval_fused_k"], len(loaders["val_loader"]))
    assert grouped_calls == ([fused_k] * PIPELINE_EPOCHS if fused_k > 1
                             else []), (grouped_calls, fused_k)
    losses = [h["train_loss"] for h in trainer.history]
    assert all(np.isfinite(l) for h in trainer.history
               for l in h["step_losses"]), losses
    assert losses[-1] < losses[0], losses

    coco = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
            "CIDEr", "Sum")
    n_val_videos = len(corpus["info"]["split"]["validate"])
    for h in trainer.history:
        s = h["scores"]
        assert all(np.isfinite(s[k]) and s[k] >= 0 for k in coco), s
        print(f"pipeline: epoch {h['epoch']}: {h['n_steps']} steps, loss "
              f"{h['train_loss']:.4f} (steps "
              f"{[round(l, 4) for l in h['step_losses']]}); validation "
              f"{ {k: round(float(v), 6) for k, v in s.items()} }")
    assert all(np.isfinite(test_scores[k]) for k in coco), test_scores
    assert test_scores["ave_length"] > 0
    print(f"pipeline: test {test_scores}")
    print(f"pipeline: {seconds:.1f} s for fit + load_best + test; launches "
          f"{ {k: v for k, v in counts.items() if v} }: K1 == {beam_steps} "
          f"beam steps over {n_val} validation and {n_test} test batches, "
          f"K2 == K3a == K3b == {steps} train steps")

    ckpt_dir = base["checkpoint_path"]
    best = os.path.join(ckpt_dir, "best.ckpt")
    ckpt_bytes = os.path.getsize(best)
    print(f"pipeline: checkpoints {sorted(os.listdir(ckpt_dir))}; "
          f"on_epoch_end seconds {[round(s, 3) for s in save_s]} (last + "
          f"top-1 + best, {ckpt_bytes} bytes each); load_best "
          f"{t_load:.3f} s")
    step_ms = [1e3 * h["epoch_time"] / h["n_steps"] for h in trainer.history]
    val_caps = [n_val_videos / s for s in val_s]
    vids = next(iter(skip_loader))
    gather_ms = _time_ms(lambda: bank.lookup(vids["video_ids"],
                                             vids["frame_ids"]), n=50)
    print(f"pipeline: device feature bank {bank.describe()}; built and "
          f"uploaded in {bank_s:.3f} s; gather {gather_ms:.4f} ms per batch "
          f"of {BATCH}; {lookups} lookups == {steps} train steps")
    print(f"pipeline: loader alone {loader_ms:.3f} ms of host time per "
          f"train batch of {BATCH} with the feature reads, {skip_ms:.3f} ms "
          f"with skip_feats; train step {[round(m, 3) for m in step_ms]} "
          f"ms on the host clock per epoch, the loader feeding it "
          f"(prefetch on)")
    print(f"pipeline: validation {[round(s, 3) for s in val_s]} s for "
          f"{n_val_videos} videos ({[round(c, 1) for c in val_caps]} caps/s,"
          f" scoring included); COCOScorer.score "
          f"{[round(s, 3) for s in score_s]} s; native evaluation core "
          f"{'loaded' if native.available() else 'absent (Python paths)'}; "
          f"METEOR stemmer "
          f"{'nltk Porter' if meteor._STEMMER is not None else 'none'}")
    batch = trainer._device_batch(next(iter(skip_loader)))
    step_dev = _device_ms(lambda: trainer._train_step_fn(batch), reps=3)
    print(f"pipeline: one train step's device time {step_dev:.3f} ms "
          f"(profiler) against the loader's {loader_ms:.3f} ms of host time "
          f"per batch")

    # grouped validation against per-batch validation of the same weights:
    # the captions and their scores, and the COCO dict
    fused_scores, fused_preds = _validate_preds(trainer, 4)
    batch_scores, batch_preds = _validate_preds(trainer, 1)
    assert len(fused_preds) == n_val_videos, len(fused_preds)
    assert fused_preds == batch_preds
    assert fused_scores == batch_scores, (fused_scores, batch_scores)
    distinct = len({e["caption"] for v in fused_preds.values() for e in v})
    print(f"pipeline: validation with eval_fused_k 4 (grouped) == 1 (batch "
          f"by batch): {len(fused_preds)} videos' captions and scores equal "
          f"({distinct} distinct captions), {len(fused_scores)} COCO scores "
          f"equal (CIDEr {fused_scores['CIDEr']:.6f}); grouped "
          f"{val_s[-2]:.3f} s, batch by batch {val_s[-1]:.3f} s")

    # a standalone save and load of the flagship's weights
    path = os.path.join(scratch, "pipeline", "probe.ckpt")
    t0 = time.perf_counter()
    ckpt_lib.save_checkpoint(path, trainer.variables(), base)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_lib.load_checkpoint(path)
    t_read = time.perf_counter() - t0
    print(f"pipeline: save_checkpoint {t_save:.3f} s, load_checkpoint "
          f"{t_read:.3f} s, {os.path.getsize(path)} bytes")
    del trainer, batch

    # resume: 1 epoch with its state saved, then a fresh trainer resumes
    # to 2 epochs; the main run is the uninterrupted one
    state_dir = os.path.join(scratch, "pipeline", "state")
    resume_ckpt = os.path.join(scratch, "pipeline", "resume")
    _resume_run(base, loaders, refs, vocab, 1, state_dir, resume_ckpt)
    resumed = _resume_run(base, loaders, refs, vocab, 2, state_dir,
                          resume_ckpt)
    assert [h["epoch"] for h in resumed.history] == [1]
    full = {h["epoch"]: h for h in trainer_history}
    got, want = resumed.history[0]["train_loss"], full[1]["train_loss"]
    rel = abs(got - want) / abs(want)
    assert rel <= 1e-5, (got, want)
    worst = max(float((a - b).abs().max()) for a, b in zip(
        resumed.model.state_dict().values(), final_state.values()))
    assert worst <= 1e-5, worst
    assert resumed._switched and resumed.global_step == steps
    assert resumed._feature_bank is not None
    assert resumed._feature_bank.lookups == steps // PIPELINE_EPOCHS
    print(f"pipeline: resume: epoch 1 loss {got:.6f} against the "
          f"uninterrupted {want:.6f} (relative gap {rel:.2e} <= 1e-5), "
          f"parameters within {worst:.2e} (<= 1e-5)")
    return ({name: counts[name] for name in ("fused_head_topk",) + trained},
            base, loader_fn, corpus, refs)


# ---------------------------------------------------------------------------
# the device feature bank at the flagship's MSRVTT size
# ---------------------------------------------------------------------------

BANK_VIDEOS, BANK_FRAMES = 10000, 60


class _RowStore:
    """A feature store that answers video ``i`` with the window at offset
    ``i`` of one seeded-noise vector, shaped [rows, dim]: a distinct array
    for every video at the memory of one, what ``_load_feats`` and
    ``load_r_feats`` read from an HDF5 file at the full scale without the
    host memory of 10 000 arrays."""

    def __init__(self, rows, dim, seed):
        self.shape = (rows, dim)
        self.noise = np.random.default_rng(seed).standard_normal(
            rows * dim + BANK_VIDEOS, dtype=np.float32)

    def __contains__(self, vid):
        return vid.startswith("video")

    def __getitem__(self, vid):
        i = int(vid[len("video"):])
        return self.noise[i:i + self.shape[0] * self.shape[1]].reshape(
            self.shape)


def phase_bank(opt) -> None:
    """The device feature bank of the flagship's MSRVTT size: 10 000 videos
    x 60 frames x (128 + 2048 + 512) plus 20 retrieval rows x 512, 6.9 GB in
    f32, read from the stores, stacked one modality at a time and copied to
    the card; its resident bytes, build seconds and gather ms at batch 64,
    for ``feature_cache_dtype`` None and ``bfloat16``."""
    from care_tpu_torch.data.datasets import VideoOnlyDataset
    from care_tpu_torch.data.feature_bank import build_feature_bank

    class Stores(VideoOnlyDataset):
        def __init__(self, opt):       # the stores, no corpus
            self.opt = opt
            self.ids_set = list(range(BANK_VIDEOS))
            self.vid2id = None
            self._databases = [
                [c, [_RowStore(opt["retrieval_topk"] if c == "r"
                               else BANK_FRAMES, opt[f"dim_{c}"], i)],
                 opt[f"dim_{c}"]] for i, c in enumerate(opt["modality"])]

    cfg = dict(opt, n_total_frames=BANK_FRAMES)
    assert cfg["modality"] == "amir" and cfg["load_feats_type"] == 0, cfg
    rs = np.random.RandomState(SEED)
    vids = [f"video{v}" for v in rs.randint(0, BANK_VIDEOS, BATCH)]
    frames = np.stack([np.sort(rs.choice(BANK_FRAMES, cfg["n_frames"],
                                         replace=False))
                       for _ in range(BATCH)])
    for dtype in (None, "bfloat16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        stores = Stores(cfg)
        bank = build_feature_bank(stores, dict(
            cfg, feature_cache_dtype=dtype), "cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        assert bank is not None, "the full-scale bank was not built"
        resident = torch.cuda.memory_allocated() - before
        assert resident >= bank.nbytes(), (resident, bank.nbytes())
        out = bank.lookup(vids, frames)
        assert [tuple(t.shape) for t in out] == [
            (BATCH, cfg["n_frames"], cfg[f"dim_{c}"]) for c in "ami"] + [
            (BATCH, cfg["retrieval_topk"], cfg["dim_r"])]
        assert all(t.dtype == torch.float32 for t in out)
        # every video's rows are its own: a few gathered rows against the
        # stores' values, rounded as the bank stores them
        for b in range(0, BATCH, 9):
            for (c, (store,), _), got in zip(stores.databases, out):
                want = torch.as_tensor(
                    store[vids[b]] if c == "r" else store[vids[b]][frames[b]])
                if dtype is not None:
                    want = want.to(torch.bfloat16).float()
                assert torch.equal(got[b].cpu(), want), (dtype, c, b)
        gather_ms = _time_ms(lambda: bank.lookup(vids, frames), n=50)
        print(f"bank feature_cache_dtype={dtype}: {bank.describe()}; "
              f"{resident} bytes resident on the card; built (stores read, "
              f"stacked and copied) in {seconds:.3f} s, "
              f"{bank.nbytes() / seconds / 1e9:.2f} GB/s of table; gather "
              f"{gather_ms:.4f} ms per batch of {BATCH}")
        del bank, out
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the serving entry points on the pipeline's checkpoint
# ---------------------------------------------------------------------------

def phase_entry(opt, loader_fn, corpus, refs, scratch) -> dict:
    """``python -m care_tpu_torch.translate`` (``main``) on the pipeline's
    best checkpoint through ``load_model``, on the test split: with
    ``--fused_k 4`` and pipelined (equal predictions JSON and COCO dicts),
    then
    ``--latency`` at batch 1 in a temporary directory (a ``latency.txt``
    line), then ``care_tpu_torch.eval_json`` on the written predictions
    (the scores of ``run_eval``). K1 launches == beam steps."""
    import care_tpu_torch.data as data_pkg
    import care_tpu_torch.decoding as decoding_pkg
    from care_tpu_torch import eval_json, translate
    root = os.path.join(scratch, "pipeline")
    ckpt = os.path.join(opt["checkpoint_path"], "best.ckpt")
    out = os.path.join(scratch, "entry")
    translators = []
    inner_get = decoding_pkg.get_translator

    def get_translator_counted(*args, **kwargs):
        translators.append(inner_get(*args, **kwargs))
        return translators[-1]

    common = ["-cp", ckpt, "--base_data_path", root, "--batch_size",
              str(BATCH), "--json_path", out]
    # the entry points read the dataset through care_tpu_torch.data's
    # get_loader: stand in the pipeline's (the in-memory store where h5py
    # is absent)
    inner_loader = data_pkg.get_loader
    data_pkg.get_loader = loader_fn
    decoding_pkg.get_translator = get_translator_counted
    cwd = os.getcwd()
    try:
        _zero_launch_counts()
        t0 = time.perf_counter()
        (fused,) = translate.main(common + ["--fused_k", "4", "--json_name",
                                            "fused.json"])
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (piped,) = translate.main(common + ["--json_name", "piped.json"])
        torch.cuda.synchronize()
        piped_s = time.perf_counter() - t0
        os.makedirs(os.path.join(scratch, "latency"))
        os.chdir(os.path.join(scratch, "latency"))
        translate.main(["-cp", ckpt, "--base_data_path", root, "--latency"])
        counts = _launch_counts()
    finally:
        os.chdir(cwd)
        data_pkg.get_loader = inner_loader
        decoding_pkg.get_translator = inner_get
    steps = sum(t.beam_steps for t in translators)
    assert len(translators) == 3 and steps > 0, (len(translators), steps)
    assert counts["fused_head_topk"] == steps, (counts, steps)
    assert fused == piped, (fused, piped)
    with open(os.path.join(out, "fused.json")) as f:
        fused_preds = json.load(f)
    with open(os.path.join(out, "piped.json")) as f:
        piped_preds = json.load(f)
    assert fused_preds == piped_preds
    n_test = len(corpus["info"]["split"]["test"])
    assert len(piped_preds) == n_test
    with open(os.path.join(scratch, "latency", "latency.txt")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1, lines
    method, task, total, n, avg = lines[0].split("\t")
    assert int(n) == n_test and float(avg) > 0, lines
    scores = eval_json.main(["-json", os.path.join(out, "piped.json"),
                             "-ref", opt["reference"]])
    assert scores == piped, (scores, piped)
    print(f"entry: translate --fused_k 4 == pipelined on {n_test} test "
          f"videos (predictions JSON and COCO dict equal, CIDEr "
          f"{piped['CIDEr']:.6f}); "
          f"{fused_s:.3f} / {piped_s:.3f} s a run "
          f"(load_model, loader and scoring included); --latency at batch "
          f"1: {1e3 * float(avg):.3f} ms a video over {n} videos "
          f"(latency.txt: {method} {task}); eval_json == run_eval's scores;"
          f" launches { {k: v for k, v in counts.items() if v} }: K1 == "
          f"{steps} beam steps")
    return {"fused_head_topk": counts["fused_head_topk"]}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _time_ms(fn, n=100, warm=10):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device_ms(fn, reps=5):
    """The device time of one call of ``fn``: the kernels' time per call as
    the profiler sees it, without the host's launch work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # the optimizer's host annotation also appears on the device track,
    # spanning kernels already counted
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith("Optimizer."))
    return us / 1e3 / reps


def _bound(flops, n_bytes, dtype=torch.float32):
    """(bound ms, what bounds it) on the engine that work of this dtype can
    use at its accuracy: 3xTF32 for f32, bf16 for bf16 products."""
    peak = (PEAK_TF32_FLOPS / 3 if dtype == torch.float32
            else PEAK_BF16_FLOPS)
    t_ops, t_bytes = flops / peak, n_bytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _entry(name, errors, counts, ms, plain_ms, unfused_ms, flops, n_bytes,
           shape, unfused_what, library_ms=None, library_what=None):
    """One kernel's line. ``library_ms``: the one PyTorch call that computes
    the same function, where there is one; the vocab kernels have none, and
    the unfused sequence of calls is timed beside them instead. ``bound_ms``
    is the 3xTF32 tensor-core bound; ``cuda_core_bound_ms`` the f32
    CUDA-core bound of the earlier readings."""
    bound_ms, bound_by = _bound(flops, n_bytes)
    core_ms = 1e3 * max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_PER_S)
    entry = dict(
        name=name, **KERNELS[name], launches=counts[name],
        max_abs_err=errors[name], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, cuda_core_bound_ms=core_ms,
        library_ms=library_ms, unfused_torch_ms=unfused_ms, shape=shape)
    print(f"time {name} at {shape} f32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {unfused_what} {unfused_ms:.4f} ms, "
          + (f"{library_what} {library_ms:.4f} ms, " if library_what else "")
          + f"bound {bound_ms:.4f} ms ({bound_by}, 3xTF32: {flops} flop, "
          f"{n_bytes} bytes); CUDA-core f32 bound {core_ms:.4f} ms")
    return entry


def _entry_bf16(entry, ms, plain_ms, unfused_ms, flops, n_bytes):
    """The same kernel's bf16 reading, added to its f32 line."""
    bound_ms, bound_by = _bound(flops, n_bytes, torch.bfloat16)
    entry.update(bf16_ms=ms, bf16_plain_ms=plain_ms,
                 bf16_unfused_torch_ms=unfused_ms, bf16_bound_ms=bound_ms,
                 bf16_bound_by=bound_by)
    print(f"time {entry['name']} at {entry['shape']} bf16: kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, unfused {unfused_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops} flop, {n_bytes} bytes)")


def _flash_fwd_work(shape, dtype, bias):
    """(flops, bytes) of one K4a call: q, k, v and the bias read once, out
    and lse written once."""
    b, h, lq, lk, dh = shape
    size = 2 if dtype == torch.bfloat16 else 4
    return (4 * b * h * lq * lk * dh,
            size * (2 * b * h * lq * dh + 2 * b * h * lk * dh)
            + 4 * bias.numel() + 4 * b * h * lq)


def _time_flash_forward() -> dict:
    """K4a in f32 and bf16 at the decode shape (batch 64), the ragged decode
    batch of 17 and the square shape, hybrid bias: the kernel (its library
    called with the outputs made once), the wrapper, its plain version, the
    port's dense attention (matmul, softmax, matmul) and
    ``F.scaled_dot_product_attention`` in the same dtype (the mask handed
    over in that dtype; the port never calls it), beside the bound. Returns
    {(label, dtype): readings}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    readings = {}
    for label, shape in FLASH_FWD_SHAPES:
        b, h, lq, lk, dh = shape
        for dtype in (torch.float32, torch.bfloat16):
            (q, k, v, _), bias = _flash_inputs(shape, dtype, "hybrid", 41)
            mask = bias.expand(b, h, lq, lk).to(dtype)
            flops, n_bytes = _flash_fwd_work(shape, dtype, bias)
            bound_ms, bound_by = _bound(flops, n_bytes, dtype)
            # the kernel alone, through its library with the outputs made
            # once, as the backward kernels are timed; the wrapper (operand
            # checks, allocations, the ctypes call) beside it
            out, lse = fa._flash_fwd_cuda(q, k, v, bias)
            call = functools.partial(
                getattr(fa._fwd_library(), "care_flash_fwd_" + (
                    "f32" if dtype == torch.float32 else "bf16")),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                *bias.expand(b, h, lq, lk).stride(), b, h, lq, lk, dh,
                out.data_ptr(), lse.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            r = dict(
                ms=_time_ms(call),
                wrapper_ms=_time_ms(lambda: fa._flash_fwd_cuda(q, k, v,
                                                               bias)),
                plain_ms=_time_ms(lambda: fa._flash_fwd_plain(q, k, v, bias),
                                  5, 1),
                unfused_torch_ms=_time_ms(lambda: dot_product_attention(
                    q, k, v, bias=bias, return_probs=False)),
                library_ms=_time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                n_bytes=n_bytes, key_splits=fa.fwd_key_splits(q, k),
                what=f"q {list(q.shape)} x {lk} keys, bias {list(bias.shape)}")
            readings[label, dtype] = r
            want = fa._flash_fwd_cuda(q, k, v, bias)
            assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
            print(f"time flash_attention_fwd {label} {str(dtype)[6:]} at "
                  f"{r['what']}: kernel {r['ms']:.4f} ms "
                  f"({100 * bound_ms / r['ms']:.1f}% of the bound; key "
                  f"splits {r['key_splits']}), through the wrapper "
                  f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"the port's dense attention {r['unfused_torch_ms']:.4f} "
                  f"ms, F.scaled_dot_product_attention "
                  f"{r['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {flops} flop, {n_bytes} bytes)")
    return readings


def _time_flash(errors, counts) -> list:
    """K4a at the decode shape (its entry; the ragged decode batch, the
    square shape and bf16 beside it), K4b and K4c at the square shape;
    beside each its plain version, the port's dense attention and
    ``F.scaled_dot_product_attention``, which the port never calls."""
    entries = []
    fwd = _time_flash_forward()
    main = fwd["decode", torch.float32]
    entry = _entry("flash_attention_fwd", errors, counts, main["ms"],
                   main["plain_ms"], main["unfused_torch_ms"], main["flops"],
                   main["n_bytes"], main["what"], "the port's dense attention",
                   main["library_ms"], "F.scaled_dot_product_attention")
    for (label, dtype), r in fwd.items():
        prefix = ("" if label == "decode" else label + "_") + (
            "" if dtype == torch.float32 else "bf16_")
        entry.update({prefix + key: r[key] for key in
                      ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "unfused_torch_ms", "key_splits")})
    entries.append(entry)

    # the backward kernels at the square shape, in f32 and in bf16
    b, h, lq, lk, dh = SQUARE_SHAPE
    flops_dq, flops_dkv = 6 * b * h * lq * lk * dh, 8 * b * h * lq * lk * dh
    for dtype in (torch.float32, torch.bfloat16):
        t = _time_flash_backward(dtype)
        size = 2 if dtype == torch.bfloat16 else 4
        qo, kv = size * b * h * lq * dh, size * b * h * lk * dh
        rows = 4 * b * h * lq
        bias_bytes = 4 * h * lk
        work = {"flash_attention_bwd_dq": (
                    flops_dq, 3 * qo + 2 * kv + bias_bytes + 2 * rows),
                "flash_attention_bwd_dkv": (
                    flops_dkv,
                    2 * qo + 4 * kv + bias_bytes + 2 * rows + 4 * b * h * lk)}
        for name, wrt in (("flash_attention_bwd_dq", "q"),
                          ("flash_attention_bwd_dkv", "kv")):
            flops, n_bytes = work[name]
            lib, lib_dev = t["sdpa"][wrt]
            joint, joint_dev = t["sdpa"]["qkv"]
            extra = {"library_device_ms": lib_dev, "joint_library_ms": joint,
                     "joint_library_device_ms": joint_dev}
            if dtype == torch.float32:
                entries.append(_entry(
                    name, errors, counts, t["ms"][name], t["plain"],
                    t["dense"], flops, n_bytes, t["what"],
                    "autograd backward of the port's dense attention (dq, "
                    "dk, dv together)", lib, SDPA_YARDSTICK[wrt]))
                entries[-1].update(extra)
            else:
                entry = next(e for e in entries if e["name"] == name)
                _entry_bf16(entry, t["ms"][name], t["plain"], t["dense"],
                            flops, n_bytes)
                entry.update(bf16_library_ms=lib, **{
                    "bf16_" + key: value for key, value in extra.items()})
    return entries


# what SDPA's autograd backward computes when only these inputs require a
# gradient: the yardstick of K4b (dq) and of K4c (dk, dv; SDPA has no bias
# gradient to give, K4c computes dbias besides)
SDPA_YARDSTICK = {
    "q": "autograd backward of F.scaled_dot_product_attention, dq alone",
    "kv": "autograd backward of F.scaled_dot_product_attention, dk and dv "
          "(no dbias)",
    "qkv": "autograd backward of F.scaled_dot_product_attention, dq, dk, dv"}


def _time_flash_backward(dtype) -> dict:
    """K4b and K4c at the square shape in ``dtype``: each kernel alone, both
    through the wrapper, the plain backward, the autograd backward of the
    port's dense attention, and SDPA's autograd backward for dq alone, for
    dk and dv alone and for all three, each as forward + backward less the
    same forward, event-timed and as device time (the profiler's kernel
    time, without autograd's host work). The kernels themselves are timed
    by events only: one launch each, and the profiler does not always see
    a launch made through ctypes. The mask is handed to SDPA in the
    inputs' dtype."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, lq, lk, dh = SQUARE_SHAPE
    (q, k, v, do), bias = _flash_inputs(SQUARE_SHAPE, dtype, "hybrid", 41)
    mask = bias.expand(b, h, lq, lk).to(dtype)
    out, lse = fa._flash_fwd_cuda(q, k, v, bias)
    delta = (do.float() * out.float()).sum(-1)
    label = str(dtype)[6:]

    def backward_ms(fn, wrt):
        leaves = [t.clone().requires_grad_(i in wrt)
                  for i, t in enumerate((q, k, v))]
        need = [leaves[i] for i in wrt]

        def forward():
            return fn(*leaves)

        def both():
            return torch.autograd.grad(forward(), need, do)
        return (_time_ms(both) - _time_ms(forward),
                _device_ms(both) - _device_ms(forward))

    sdpa_ms = {wrt: backward_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask),
                                idx)
               for wrt, idx in (("q", (0,)), ("kv", (1, 2)),
                                ("qkv", (0, 1, 2)))}
    dense_ms = backward_ms(lambda q, k, v: dot_product_attention(
        q, k, v, bias=bias, return_probs=False)[0], (0, 1, 2))[0]
    plain_ms = _time_ms(lambda: fa._flash_bwd_plain(q, k, v, bias, lse, do,
                                                    delta), 5, 1)
    both = _time_ms(lambda: fa._flash_bwd_cuda(q, k, v, bias, lse, do, delta))
    # the wrapper launches both kernels; each alone, through the libraries
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), 0,
            bias.stride(1), bias.stride(3), lse.data_ptr(), do.data_ptr(),
            delta.data_ptr(), b, h, lq, lk, dh)
    stream = torch.cuda.current_stream().cuda_stream
    suffix = "f32" if dtype == torch.float32 else "bf16"
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dbias = torch.empty((b, h, 1, lk), device="cuda")
    calls = {
        "flash_attention_bwd_dq": lambda: getattr(
            fa._dq_library(), "care_flash_bwd_dq_" + suffix)(
                *head, dq.data_ptr(), stream),
        "flash_attention_bwd_dkv": lambda: getattr(
            fa._dkv_library(), "care_flash_bwd_dkv_" + suffix)(
                *head, dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), stream)}
    ms = {name: _time_ms(call) for name, call in calls.items()}
    torch.cuda.synchronize()
    want = fa._flash_bwd_cuda(q, k, v, bias, lse, do, delta)
    assert all(torch.equal(a, w) for a, w in zip((dq, dk, dv, dbias), want))
    print(f"time flash backward at {list(q.shape)} {label}: dq kernel "
          f"{ms['flash_attention_bwd_dq']:.4f} ms, dk/dv/dbias kernel "
          f"{ms['flash_attention_bwd_dkv']:.4f} ms, both through the "
          f"wrapper {both:.4f} ms; plain (all four gradients in one pass) "
          f"{plain_ms:.4f} ms; autograd backward of the port's dense "
          f"attention {dense_ms:.4f} ms; "
          + "; ".join(f"{SDPA_YARDSTICK[w]} {e:.4f} ms (device {d:.4f})"
                      for w, (e, d) in sdpa_ms.items()))
    return {"ms": ms, "plain": plain_ms, "dense": dense_ms,
            "sdpa": sdpa_ms, "what": f"q {list(q.shape)} x {lk} keys, bias "
                                     f"{list(bias.shape)}"}


def _time_head(h, W, K):
    """K1, its plain version and the unfused sequence on one set of
    operands."""
    return (_time_ms(lambda: fht._stats_cuda(h, W, None, K)),
            _time_ms(lambda: fht._stats_plain(h, W, None, K, 1024)),
            _time_ms(lambda: torch.topk(torch.log_softmax(
                (h @ W.t()).float(), dim=-1), K)))


def phase_time(opt, errors, counts, nar_opt, nar_counts) -> list:
    K, H, V = opt["beam_size"], opt["dim_hidden"], opt["vocab_size"]
    rows = BATCH * K
    flops = 2 * rows * H * V
    out_bytes = 4 * rows * (2 + 2 * K)
    h, W = _head_inputs(rows, H, V, torch.float32, False, 1)
    entries = [_entry(
        "fused_head_topk", errors, counts, *_time_head(h, W, K), flops,
        4 * (rows * H + V * H) + out_bytes, f"[{rows}, {H}] x [{V}, {H}]",
        "unfused torch sequence (h @ W.T, log_softmax, topk)")]
    h, W = _head_inputs(rows, H, V, torch.bfloat16, False, 1)
    _entry_bf16(entries[0], *_time_head(h, W, K), flops,
                2 * (rows * H + V * H) + out_bytes)

    # the training shape: batch 64 x 29 positions, no bias
    rows = BATCH * (opt["max_len"] - 1)
    shape = f"[{rows}, {H}] x [{V}, {H}]"
    h, W, _, labels, cot = _xent_inputs(rows, H, V, torch.float32, False,
                                        False, 5)
    lse = fht._argmax_lse_plain(h, W, None, labels, 1024, False)[2]
    row_bytes = 4 * rows * 5          # lse, three cotangents, labels

    def dense_forward(h, W):
        logits = h @ W.t()
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(1, labels[:, None])[:, 0], logits.sum(dim=-1),
                logits.argmax(dim=-1))

    def unfused(h, W):
        """The unfused sequence's forward, and the autograd backward of its
        three statistics with the kernels' cotangents for dh alone (K3a's
        yardstick), dW alone (K3b's) and both, each timed as forward +
        backward less the forward: on CUDA events around 100 calls (which
        include the host's autograd work where it outlasts the device's),
        and as device time alone (the profiler's kernel time per call)."""
        forward_ms = _time_ms(lambda: dense_forward(h, W))
        forward_dev = _device_ms(lambda: dense_forward(h, W))
        backward, device = {}, {}
        for need in ("both", "h", "W"):
            hg = h.clone().requires_grad_(need in ("h", "both"))
            Wg = W.clone().requires_grad_(need in ("W", "both"))
            leaves = [t for t in (hg, Wg) if t.requires_grad]

            def run():
                loss = sum((c * o).sum()
                           for c, o in zip(cot, dense_forward(hg, Wg)))
                return torch.autograd.grad(loss, leaves)

            backward[need] = _time_ms(run) - forward_ms
            device[need] = _device_ms(run) - forward_dev
        return forward_ms, backward, forward_dev, device

    def time_kernels(h, W):
        """(kernel ms, plain ms) of K2, K3a and K3b on one set of operands."""
        return (
            (_time_ms(lambda: fht._argmax_lse_cuda(h, W, None, labels, True)),
             _time_ms(lambda: fht._argmax_lse_plain(h, W, None, labels, 1024,
                                                    True))),
            (_time_ms(lambda: fx._bwd_cuda(h, W, None, labels, lse, *cot,
                                           want_dw=False)),
             _time_ms(lambda: fx._bwd_plain(h, W, None, labels, lse, *cot,
                                            1024, want_dw=False))),
            (_time_ms(lambda: fx._bwd_cuda(h, W, None, labels, lse, *cot,
                                           want_dh=False)),
             _time_ms(lambda: fx._bwd_plain(h, W, None, labels, lse, *cot,
                                            1024, want_dh=False))))

    def work(itemsize):
        """(flops, bytes) of K2, K3a and K3b: each input read once, each
        output written once."""
        hb, wb = itemsize * rows * H, itemsize * V * H
        return ((2 * rows * H * V, hb + wb + 4 * rows + 4 * rows * 5),
                (4 * rows * H * V, 2 * hb + wb + row_bytes),
                (4 * rows * H * V, hb + 2 * wb + 4 * V + row_bytes))

    names = ("vocab_argmax_lse", "fused_xent_bwd_dh", "fused_xent_bwd_dw")
    whats = ("unfused torch sequence (h @ W.T, logsumexp, gather, sum, "
             "argmax)",
             "autograd backward of the unfused sequence, dh alone",
             "autograd backward of the unfused sequence, dW alone")
    def report(dtype, forward_ms, backward, forward_dev, device):
        print(f"time unfused sequence at {shape} {dtype}, event-timed / "
              f"device time: forward {forward_ms:.4f} / {forward_dev:.4f} "
              f"ms; backward, dh alone {backward['h']:.4f} / "
              f"{device['h']:.4f} ms, dW alone {backward['W']:.4f} / "
              f"{device['W']:.4f} ms, both {backward['both']:.4f} / "
              f"{device['both']:.4f} ms")
        return ({"unfused_device_ms": forward_dev},
                {"unfused_device_ms": device["h"],
                 "joint_unfused_torch_ms": backward["both"],
                 "joint_unfused_device_ms": device["both"]},
                {"unfused_device_ms": device["W"],
                 "joint_unfused_torch_ms": backward["both"],
                 "joint_unfused_device_ms": device["both"]})

    forward_ms, backward, forward_dev, device = unfused(h, W)
    extras = report("f32", forward_ms, backward, forward_dev, device)
    xent = []
    for name, times, (flops, n_bytes), what, unfused_ms, extra in zip(
            names, time_kernels(h, W), work(4), whats,
            (forward_ms, backward["h"], backward["W"]), extras):
        xent.append(_entry(name, errors, counts, *times, unfused_ms, flops,
                           n_bytes, shape, what))
        xent[-1].update(extra)
    # bf16: the same operands rounded, the unfused sequence in bf16
    h, W = h.bfloat16(), W.bfloat16()
    forward_ms, backward, forward_dev, device = unfused(h, W)
    extras = report("bf16", forward_ms, backward, forward_dev, device)
    for entry, times, (flops, n_bytes), unfused_ms, extra in zip(
            xent, time_kernels(h, W), work(2),
            (forward_ms, backward["h"], backward["W"]), extras):
        _entry_bf16(entry, *times, unfused_ms, flops, n_bytes)
        entry.update({"bf16_" + k: v for k, v in extra.items()})
    entries += xent
    _time_argmax_lse_nar(xent[0], nar_opt, nar_counts)
    return entries + _time_flash(errors, counts)


def _time_argmax_lse_nar(entry, opt, nar_counts) -> None:
    """K2 at the NAR decode's shape (batch 64 x length beam 6 x ``max_len``
    30 = 11 520 rows), without token ids (a refinement pass) and with them
    (the teacher's rescoring), f32 and bf16: the kernel, its plain version
    and the unfused library sequence (``h @ W.T``, then ``max`` and
    ``logsumexp``, and ``gather`` of the token logit), beside its bound.
    Added to K2's line under ``nar_`` keys, with the nar phase's launches."""
    rows = BATCH * opt["length_beam_size"] * opt["max_len"]
    H, V = opt["dim_hidden"], opt["vocab_size"]
    shape = f"[{rows}, {H}] x [{V}, {H}]"
    tokens = torch.randint(0, V, (rows,), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))

    def library(h, W, tok):
        logits = h @ W.t()
        mx, am = logits.max(dim=-1)
        lse = torch.logsumexp(logits.float(), dim=-1)
        if tok is None:
            return am, mx, lse
        return am, mx, lse, logits.gather(1, tok[:, None])[:, 0]

    readings = {"nar_shape": shape,
                "nar_launches": nar_counts["vocab_argmax_lse"]}
    for dtype, prefix in ((torch.float32, "nar_"), (torch.bfloat16,
                                                    "nar_bf16_")):
        h, W = _head_inputs(rows, H, V, dtype, False, 14)
        size = h.element_size()
        for tok, suffix in ((None, ""), (tokens, "tokens_")):
            n_bytes = (size * (rows * H + V * H) + 4 * rows * 3
                       + (8 * rows if tok is not None else 0))
            flops = 2 * rows * H * V
            bound_ms, bound_by = _bound(flops, n_bytes, dtype)
            ms = _time_ms(lambda: fht._argmax_lse_cuda(h, W, None, tok,
                                                       False), n=20)
            plain_ms = _time_ms(lambda: fht._argmax_lse_plain(
                h, W, None, tok, 1024, False), n=3, warm=1)
            library_ms = _time_ms(lambda: library(h, W, tok), n=20)
            readings.update({f"{prefix}{suffix}ms": ms,
                             f"{prefix}{suffix}plain_ms": plain_ms,
                             f"{prefix}{suffix}library_ms": library_ms,
                             f"{prefix}{suffix}bound_ms": bound_ms,
                             f"{prefix}{suffix}bound_by": bound_by})
            what = "max, logsumexp" + (", gather" if suffix else "")
            print(f"time vocab_argmax_lse at the NAR shape {shape} "
                  f"{str(dtype)[6:]}{' with token ids' * bool(suffix)}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
                  f"library sequence (h @ W.T, {what}) {library_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}: {flops} flop, "
                  f"{n_bytes} bytes)")
    entry.update(readings)


def main() -> None:
    name, smi_line = phase_device()
    opt = flagship_opt()
    phase_build()
    errors = phase_check(opt)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        counts = phase_serve(opt)
        counts.update(phase_flash_gradient())
        counts.update(phase_train(opt, scratch))
        # each path's launches, summed over the paths that run the kernel
        pipeline_counts, base, loader_fn, corpus, refs = phase_pipeline(
            opt, scratch)
        for k, n in pipeline_counts.items():
            counts[k] += n
        for k, n in phase_entry(base, loader_fn, corpus, refs,
                                scratch).items():
            counts[k] += n
        phase_bank(opt)
        for k, n in phase_family(scratch).items():
            counts[k] += n
        nar_counts = phase_nar(scratch)
        for k, n in nar_counts.items():
            counts[k] += n
        for k, n in phase_rnn(scratch).items():
            counts[k] += n
        for k, n in phase_pointer(scratch).items():
            counts[k] += n
        for k, n in phase_ensemble(scratch).items():
            counts[k] += n
        for k, n in phase_backbone(scratch).items():
            counts[k] += n
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    kernels = phase_time(opt, errors, counts, family_opt(NAR_STUDENT[0]),
                         nar_counts)
    # the card and its power limit once more, beside the numbers
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
