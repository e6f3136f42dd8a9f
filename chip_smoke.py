"""Chip smoke test of the PyTorch/CUDA port (``care_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

A correctness rehearsal of the paths the benchmark (``portbench/``) does
not run. The kernels themselves are held against their plain versions by
the ``gpu`` tests (``python3 -m pytest -q -m gpu``, operands and checks
in ``tests/torch_card_cases.py``), and the script runs each check once
(phase 2b); kernel times come from
``python3 -m care_tpu_torch.tools.kernel_probe --against DIR`` and from
the benchmark's roofline metrics. Phases, each printing its own lines; any
failure raises and exits nonzero before the last line:

1. device: the card's name, ``nvidia-smi``'s name and power limit, the
   torch and CUDA versions, which optional packages import (``h5py``,
   ``pandas``, ``nltk``, ``tensorboardX``). Fails at once without a CUDA
   device.
2. build: every kernel of the serving and training paths (eight sources)
   is compiled with ``nvcc`` from ``care_tpu_torch/csrc``, all at once,
   printing the ``-Xptxas -v`` register and spill summary.
2b. check: each kernel against its plain version once at the main path's
   shapes, through the ``gpu`` tests' checks: K1 at the flagship's 64 x 5
   serving rows, K2, K3a and K3b at its 64 x 29 training rows, K4a-c at
   the long-key decode step and the square shape, and the beam
   bookkeeping bit for bit at step 15 of 64 and of 1 instance.
3. serve: the full-width CARE flagship (MSRVTT, Transformer, CARE, ViT,
   VA/VAT; random weights from a seed) captions 3 batches of 64 synthetic
   videos and one ragged batch of 17 through
   ``get_translator(opt).translate_batch``; then the long-key configuration
   (``--feats SwinBERTDense``: 1568 rows of motion, 1654 cross-attention
   keys) captions 2 batches of 64 and one of 17 with task ``CARE`` and one
   batch of 64 with task ``Base``, the cross attention of every beam step
   going through the flash-attention kernel. The kernel launch counts must
   match the beam steps run (times the decoder layers for the flash
   kernel; the beam bookkeeping kernel once a beam step of every AR
   decode), and every returned score must equal the teacher-forced score
   of its tokens from the full forward, which runs the dense attention.
   Then half precision (``compute_dtype_decode: bfloat16``): the flagship,
   the flagship with ``decode_head_f32``, and the long-key ``CARE`` and
   ``Base`` configurations; the scores re-checked by teacher forcing the
   served bf16 model. Modules compute in the promoted dtype of their
   operands, as the JAX package's do: the ``CARE`` task's f32 concept
   vector makes its decoder f32, so its K1 and K4a launch in f32, while
   ``Base`` launches both in bf16 (the counts are asserted).
4. flash gradient: three descent steps through
   ``flash_attention(backward="kernel")`` at the square shape, which is the
   entry point of the two backward kernels (no model path reaches them).
5. train: ``Trainer(opt, loader).fit()`` trains the flagship with
   ``fused_xent: True`` for 2 epochs of 4 synthetic batches of 64, dropout
   on, through the dual-Adam switch. Every step's cross-entropy must go
   forward through the argmax/lse kernel and backward through the dh and
   dW kernels (launch counts == steps), every loss must be finite and the
   last steps' mean below the first. Then fused against dense from one
   seed with dropout off, and the ``auto`` policy at batch 64 and 192.
6. pipeline: the port's main path as ``care_tpu_torch.train.run`` drives
   it, on the flagship at full width: a synthetic dataset of 400 videos in
   the reference's layout (HDF5 when ``h5py`` imports, else the same
   arrays in memory through a ``JointDataset`` whose stores are dicts; the
   vocabulary widened to 11 000 words), 2 epochs of ``Trainer.fit`` at
   batch 64 through the port's loader with the fused cross-entropy, beam
   search validation and COCO scores after each epoch, top-1 checkpoints on
   CIDEr, ``load_best`` and ``test``. The vocab head + top-k kernel must
   launch once per beam step of every validation and test batch, the
   cross-entropy kernels once per train step. It prints the losses and
   every COCO dict; then a run of 1 epoch and a fresh trainer resuming it
   to 2 must reproduce the main run's epoch-1 loss (1e-5 relative) and
   final parameters (1e-5 absolute). It runs on ``care_tpu``'s defaults:
   the train batches' features come from the device feature bank (lookups
   == train steps), and validation keeps ``eval_fused_k`` decodes in
   flight, whose captions, scores and COCO dict must equal those of
   ``eval_fused_k`` 1 (``==``).
6b. entry: ``care_tpu_torch.translate.main`` on the pipeline's best
   checkpoint through ``load_model``: ``--fused_k 4`` against pipelined
   (equal predictions JSON and COCO dict), ``--latency`` at
   batch 1 (a ``latency.txt`` line in a temporary directory), and
   ``care_tpu_torch.eval_json`` on the written predictions (the scores of
   ``run_eval``); K1 launches == beam steps.
6c. bank: the device feature bank at the flagship's MSRVTT size (10 000
   videos x 60 frames x (128 + 2048 + 512) plus 20 x 512 retrieval rows),
   in f32 and bf16 storage: resident on the card, gathered rows equal to
   the stores'.
6d. family: the rest of the CARE Transformer family at full width
   (``--arch base``, V 11 000, batch 64, beam 5): CABase
   (``scripts/exp_main_MSRVTT.sh:34``), the concept-attention sublayer
   ``G1L1`` in the ``parallel`` and ``attr2cross`` placements, semantic
   composition ``G0Lc --compositional_intra --compositional_ffn
   --add_hybrid_attention_bias``, ``--method ARB --task CARE`` (the
   HighWay / BatchNorm encoder) and ``G1L1 parallel`` at ``--feats
   SwinBERTDense``. Each trains 4 steps with ``fused_xent: True`` (K2, K3a
   and K3b once per step; ARB's running statistics must move) and serves
   one batch of 64 (K1 once per beam step, K4a once per beam step and layer
   at long keys, every score re-checked by teacher forcing).
6e. nar: non-autoregressive decoding at full width (``--arch base``,
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
6f. rnn: the RNN captioners at full width (``--arch base``, MSRVTT ViT,
   ``--modality ami -dm VA -pm VAT``, V 11 000, batch 64, beam 5,
   ``max_len`` 30): SALSTM CARE (``scripts/exp_versatility_of_CARE.sh:34``),
   TopDown CARE (``:44``) and the ``VOE`` preset each train 2 epochs of 2
   batches with dropout on and scheduled sampling at 0.25 in epoch 1 (the
   share of positions fed a sample held to a binomial bound; VOE's running
   statistics must move) and serve one batch of 64 and the ragged 17,
   every score re-checked by teacher forcing; none of K1-K4c launches, as
   ``care_tpu`` keeps these models off the fused head and the fused
   cross-entropy (the beam bookkeeping kernel launches once a beam step,
   as in every AR decode on the card). SALSTM is served in bf16 beside f32
   (decode-step log-probs within 2% of the step's largest |log-prob|).
6g. pointer: PointerGen Base and PointerGen CARE on MSRVTT
   (``scripts/exp_versatility_of_CARE.sh:70, :74``) at full width, 20
   retrieved captions of 30 token ids a video (``exclude_eos``; half the
   words from 20 frequent ids, so ids repeat): each trains 2 epochs of 2
   batches of 64 with dropout on, then again from the same seed (losses
   equal, parameter gap exactly 0.0: the copy scatter repeats bit for
   bit); ``_serve`` decodes one batch of 64 and the ragged 17 through the
   dense pointer step (scores re-checked by teacher forcing on the
   pointer's probabilities); none of K1-K4c launches, as ``care_tpu``
   keeps pointer models off K1, the fused cross-entropy and flash
   attention (the beam bookkeeping kernel once a beam step).
6h. ensemble: PointerGen CARE with itself decodes what it decodes alone
   (``==``); the heterogeneous ensemble of the flagship (``amir``) and
   PointerGen CARE (``amirt``) decodes 3 batches of 64 and the ragged 17,
   features split from the union by ``EnsembleSpec``, batch by batch and
   grouped (fused-K 4) with equal results; then
   ``care_tpu_torch.translate.main -cp a b`` on the two checkpoints the
   phase writes, over a synthetic dataset with a retrieval database. None
   of K1-K4c launches; the beam bookkeeping kernel does.
6i. backbone: the visual front at full width. The flagship with CLIP
   ViT-B/32 (patch 32, width 768, 12 layers, 12 heads, output 512, 224 x
   224; ``with_backbones`` on the image stream) serves 64 + 17 videos of 28
   raw frames (K1 == beam steps, scores re-checked by teacher forcing, 2
   videos equal to the CPU's beams) and trains 4 fused steps at batch 16
   twice from one seed (K2, K3a, K3b == steps; parameter gap 0.0 with cuDNN
   deterministic); CLIP ViT-B/32, ResNet-50 and InceptionResNetV2 encode
   448 frames each (held to the CPU on 4 frames); the retrieval database
   at MSRVTT's size (10 000 videos x 20 captions of 512: top-k indices
   equal to the CPU's, evaluation metrics, ranks of 500 videos equal to the
   CPU's); the patch encoders ``CNN1``-``CNN3`` and
   ``SingleStreamEmbedder`` with the flagship's decoder take one fused
   train step and decode 64 each (beams of 2 videos equal to the CPU's).
6j. mean_teacher: ``wrapper: InterplayModel`` on the flagship at full
   width with the pipeline's synthetic data (405 videos: 81 validated and
   81 tested, 64 + 17 each): 2 epochs of 4 batches of 64 with validation
   every epoch (the student decodes), top-1 checkpoints of the teacher,
   ``load_best`` and ``test`` (the teacher in memory decodes). K1 ==
   beam steps, K2 / K3a / K3b == 0 (the dense step, as in ``care_tpu``);
   the teacher after the first step equals ``0.999 * t0 + 0.001 * s1``
   recomputed here; ``best.ckpt`` holds its epoch's teacher; the test's
   first 17 beams equal the host's decode of ``last.ckpt``; a second run
   from the seed gives a parameter gap of exactly 0.0 for the student and
   the teacher; the plain ``Trainer`` on the same batches takes the dense
   step too.
6k. convert: a reference-layout Lightning checkpoint of the flagship
   (``tests/reference_layout.py``, seeded noise) converted by
   ``care_tpu_torch.tools.convert_reference_ckpt`` and served through
   ``care_tpu_torch.translate`` over 64 + 17 test videos on the card and on
   the host: equal captions and COCO dict, K1 == beam steps.
6l. bert: ``BertEncoder`` at bert-base-uncased's published widths
   (random weights from the seed, a vocabulary file the phase writes)
   encodes 20 000 synthetic captions of 8-20 words and pools them by mean
   and max; 256 captions held to the host's (f32, TF32 off, 1e-4); none of
   the eight kernels launches.
6m. parallel: the flagship at full width on meshes of processes
   (``care_tpu_torch.parallel``). A world of one over NCCL, mesh
   ``{data: 1}``: 4 fused train steps at batch 64 (K2, K3a, K3b once a
   step) give parameters ``torch.equal`` to the mesh-less ``Trainer``'s on
   the same batches; 64 + 17 videos served (K1 once a beam step) decode
   the mesh-less beams. Then K1 on the two vocab halves [5 500, 512],
   merged, against K1 on the whole vocabulary; and a world of two
   processes over gloo sharing the card, mesh ``{data: 1, model: 2}``: the
   64 videos through K1 on each process's [5 500, 512] rows, merged over
   the model group (beams token-identical to the world of one, scores
   within 1e-4; K1 launches == beam steps on each process), and one dense
   train step (the fused cross-entropy is off on a model axis: no K2 / K3
   launch) whose loss is within 1e-5 of the unsharded step's and whose
   update follows it (each leaf's change within 1e-2 of the unsharded
   change in the 2-norm, the attention key biases aside).

The last line is the device JSON object, ``{"ok": true, ...}``.
"""

import concurrent.futures
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from care_tpu_torch import constants
from care_tpu_torch.config import get_opt
from care_tpu_torch.data import corpus as corpus_lib
from care_tpu_torch.data import get_loader
from care_tpu_torch.data.datasets import JointDataset
from care_tpu_torch.data.loader import Loader
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.ops import _build
from care_tpu_torch.ops import beam_bookkeeping as bb
from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.ops import fused_head_topk as fht
from care_tpu_torch.ops import fused_xent as fx
from care_tpu_torch.training import Trainer

# the card's operand makers, shared with the gpu tests, and the writer of
# reference-layout checkpoints; neither imports JAX
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from reference_layout import (lightning_checkpoint,  # noqa: E402
                              reference_state_dict)
from torch_card_cases import (FLASH_CASES, SQUARE_SHAPE,  # noqa: E402
                              check_bookkeeping, check_flash_case,
                              check_head_case, check_xent_case, flash_inputs,
                              head_inputs, max_err, xent_inputs)

SEED = 0
BATCH, RAGGED = 64, 17
TRAIN_BATCHES, TRAIN_EPOCHS = 4, 2

# the eight CUDA kernels (care_tpu_torch/csrc/<name>.cu): the seven TPU
# counterparts, and the beam bookkeeping, which XLA fuses in the JAX package
KERNELS = ("fused_head_topk", "vocab_argmax_lse", "fused_xent_bwd_dh",
           "fused_xent_bwd_dw", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "beam_bookkeeping")


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
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "beam_bookkeeping": bb.launches}


def _zero_launch_counts() -> None:
    fht.launches = fht.argmax_lse_launches = fht.bf16_launches = 0
    fx.dh_launches = fx.dw_launches = 0
    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = 0
    fa.fwd_bf16_launches = 0
    bb.launches = 0


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


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"device: {name}; count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("optional packages: " + ", ".join(
        f"{p} {'present' if importlib.util.find_spec(p) else 'absent'}"
        for p in OPTIONAL_PACKAGES))
    return name


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
        print(f"build {name}: {len(registers)} entry functions, "
              f"{min(registers, default=0)}-"
              f"{max(registers, default=0)} registers, at most "
              f"{max(spills, default=0)} bytes of spill stores")


def phase_check(opt) -> None:
    """Each kernel against its plain version once at the main path's
    shapes, through the ``gpu`` tests' checks: K1 at the flagship's serving
    rows, K2, K3a and K3b at its training rows, K4a-c at the long-key
    decode step and the square shape, the beam bookkeeping at a middle step
    of the serving and latency states. The tests run the other cases."""
    K, H, V, L = (opt["beam_size"], opt["dim_hidden"], opt["vocab_size"],
                  opt["max_len"])
    check_head_case("K1", *head_inputs(BATCH * K, H, V, torch.float32,
                                       False, 1), K, False)
    h, W, b, labels, cot = xent_inputs(BATCH * (L - 1), H, V, torch.float32,
                                       False, False, 5)
    check_xent_case("K2-K3b", h, W, b, labels, cot, False)
    for case in FLASH_CASES:
        if case[0] in ("decode", "square"):
            check_flash_case(*case)
    for n in (BATCH, 1):
        check_bookkeeping((n, K, opt["topk"], L // 2, "mixed"), n, V, L)
    print("check: K1, K2-K3b, K4a-c and the beam bookkeeping equal their "
          "plain versions at the main path's shapes")


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


def _serve(label, opt, batch_sizes, flash: bool, bf16_kernels=()) -> dict:
    """Caption synthetic batches of the given sizes through
    ``get_translator(opt).translate_batch`` with the launch counts set to 0
    just before and read just after; hold the counts against the beam steps
    (``bf16_kernels``: the kernels whose every launch must be bf16, the
    others' none) and every score against teacher forcing through the full
    forward of the served model (the dense attention). Returns the launch
    counts and the first hypotheses."""
    model = build_captioner(opt, seed=SEED)
    translator = get_translator(opt)
    served = translator.serving_model(model)
    layers = opt["num_hidden_layers_decoder"]
    # an RNN decoder has no Transformer layers and stays off the fused head
    assert all(l.inter_attention.use_flash is flash
               for l in getattr(model.decoder, "layers", []))
    head = translator.fused_head
    dtype = translator.compute_dtype or torch.float32
    print(f"serve {label}: the Captioner has "
          f"{sum(p.numel() for p in model.parameters())} parameters, served "
          f"in {str(next(served.parameters()).dtype)[6:]}, vocab head "
          f"{str(served.cls_head.tgt_word_prj.weight.dtype)[6:]}"
          f"{'' if head else ', dense'}")
    batches = [_synthetic_feats(opt, n, SEED + 10 + i)
               for i, n in enumerate(batch_sizes)]
    translator.translate_batch(model, {"feats": batches[0]})      # warm-up

    _zero_launch_counts()
    translator.beam_steps = 0
    results = [translator.translate_batch(model, {"feats": feats})
               for feats in batches]
    torch.cuda.synchronize()
    counts = _launch_counts()
    bf16 = _bf16_launch_counts()
    steps = translator.beam_steps
    assert steps > 0 and counts["fused_head_topk"] == steps * head, \
        (counts, steps)
    assert counts["flash_attention_fwd"] == (steps * layers if flash else 0), \
        (counts, steps)
    # every AR decode on the card, dense ones too, does each step's
    # reorder and finished bookkeeping in one kernel launch
    assert counts["beam_bookkeeping"] == steps, (counts, steps)
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
    print(f"serve {label}: batches of {list(batch_sizes)} videos, "
          f"{steps} beam steps, launches "
          f"{ {k: v for k, v in counts.items() if v} } (of them bf16: "
          f"{ {k: v for k, v in bf16.items() if v} })")
    print(f"serve {label}: scores re-checked by teacher forcing: "
          f"{checked}/{total} hypotheses, max |diff| {worst:.2e} "
          f"(tolerance {tol:g})"
          + ("" if served is model else
             f"; control, against the f32 model's teacher forcing: max "
             f"|diff| {control:.2e}"))
    print(f"serve {label}: first caption tokens {results[0][0][0][0][:12]}")
    return {"counts": counts,
            "first": [h[0] for r in results for h in r[0]]}


def _half(opt, head_f32=False) -> dict:
    return dict(opt, compute_dtype_decode="bfloat16",
                decode_head_f32=head_f32)


def _against_f32(label, got, f32) -> None:
    same = np.mean([a == b for a, b in zip(got["first"], f32["first"])])
    print(f"serve {label}: first hypotheses equal to f32's: "
          f"{100 * same:.1f}% (random weights give near-ties)")


def phase_serve(opt) -> None:
    """The flagship (short keys, dense decode step), then the long-key
    configuration with and without the concept stack; then each again in
    half precision (``compute_dtype_decode: bfloat16``), the flagship also
    with ``decode_head_f32``. Under bf16 weights every module computes in
    the promoted dtype of its operands, as the JAX package's flax modules
    do: the ``CARE`` task's f32 concept vector (``semantic2hidden`` of the
    f32 concept probabilities) promotes the decoder's embeddings, so its
    decoder runs f32 on bf16 weights and K1 and K4a launch in f32 there;
    the ``Base`` task's decoder runs bf16 and launches both in bf16."""
    f32 = _serve("flagship", opt, [BATCH] * 3 + [RAGGED], False)
    long_f32 = _serve("long keys, CARE", long_key_opt("CARE"),
                      [BATCH] * 2 + [RAGGED], True)
    base_f32 = _serve("long keys, Base", long_key_opt("Base"), [BATCH], True)
    for label, cfg, ref, flash, bf16 in (
            ("flagship, bf16", _half(opt), f32, False, ()),
            ("flagship, bf16, f32 head", _half(opt, True), f32, False, ()),
            ("long keys, CARE, bf16", _half(long_key_opt("CARE")), long_f32,
             True, ()),
            ("long keys, Base, bf16", _half(long_key_opt("Base")), base_f32,
             True, ("fused_head_topk", "flash_attention_fwd"))):
        run = _serve(label, cfg, [BATCH] * (3 if ref is f32 else 1), flash,
                     bf16)
        _against_f32(label, run, ref)


def phase_flash_gradient() -> None:
    """``flash_attention`` as the differentiable function a caller would
    use: a few gradient steps on q, k, v and a hybrid bias at the square
    shape through ``backward="kernel"``, the launch counts set to 0 just
    before. No model path reaches the backward kernels, as in the JAX
    package; this is their entry point."""
    (q, k, v, do), bias = flash_inputs(SQUARE_SHAPE, torch.float32, "hybrid",
                                       31)
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


def phase_train(opt, scratch) -> None:
    # the trainer keeps a checkpoint every epoch: in the scratch directory
    base = dict(opt, epochs=TRAIN_EPOCHS, lowlr_start_epoch=1,
                checkpoint_path=os.path.join(scratch, "train"))
    loader = SyntheticLoader(opt, TRAIN_BATCHES, BATCH, SEED + 30)
    steps = TRAIN_EPOCHS * TRAIN_BATCHES

    # the main path: Trainer.fit with the fused cross-entropy, dropout on
    _zero_launch_counts()
    trainer = Trainer(dict(base, fused_xent=True), loader)
    trainer.fit()
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
          f"fused_xent on, dropout on; launches "
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


# ---------------------------------------------------------------------------
# data and tensor parallelism
# ---------------------------------------------------------------------------

PARALLEL_STEPS = 4
QUIET = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
         "attention_probs_dropout_prob": 0.0}


def _serve_rows(translator, model, feats, rows):
    """(hyps, scores) of one decode of ``feats``' rows."""
    return translator.translate_batch(model,
                                      {"feats": [f[rows] for f in feats]})


def _check_vocab_shards(opt) -> None:
    """K1 on each half of the vocabulary, merged (``merge_vocab_shards``),
    against K1 on the whole at the serving shape: equal ids, scores within
    1e-5."""
    K, H, V = opt["beam_size"], opt["dim_hidden"], opt["vocab_size"]
    h, W = head_inputs(BATCH * K, H, V, torch.float32, False, 11)
    g = torch.Generator().manual_seed(12)
    scores = torch.randn((BATCH, K), generator=g).cuda()
    eos = torch.zeros((BATCH, K), dtype=torch.bool, device="cuda")
    n = V // 2
    parts = [fht._stats_cuda(h, W[r * n:(r + 1) * n].contiguous(), None, K)
             for r in range(2)]
    stack = lambda i: torch.stack([p[i] for p in parts], 1)
    ids = torch.stack([p[1].long() + r * n for r, p in enumerate(parts)], 1)
    got = fht._finalize(*fht.merge_vocab_shards(stack(0), ids, stack(2),
                                                stack(3), K),
                        scores, eos, K, V)
    want = fht.fused_head_beam_topk(h, W, None, scores, eos, K)
    assert torch.equal(got[1], want[1]), "merged shards pick other ids"
    err = float((got[0] - want[0]).abs().max())
    assert err <= 1e-5, err
    for r, p in enumerate(parts):
        plain = fht._stats_plain(h, W[r * n:(r + 1) * n], None, K, 1024)
        assert torch.equal(p[1].long(), plain[1]), r
    print(f"parallel: K1 on the vocab halves [{BATCH * K}, {H}] x [{n}, {H}]"
          f" merged == K1 on [{V}, {H}] (ids equal, scores within {err:.2e})"
          "; each half's ids == its plain version's")


def _parallel_child(rank, init_file, payload_path, out_dir) -> None:
    """One process of the world of two on the card (gloo): serve the
    payload's videos and take one dense train step on the mesh
    ``{data: 1, model: 2}``; writes its readings to ``out_dir``."""
    import torch.distributed as dist
    from care_tpu_torch.models.weights import variables_from_jax
    from care_tpu_torch.parallel import make_mesh, shard_params
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=2)
    try:
        payload = torch.load(payload_path, weights_only=False)
        opt = payload["opt"]
        mesh = make_mesh({"data": 1, "model": 2})
        model = build_captioner(opt, device="cuda", seed=SEED)
        variables_from_jax(model, payload["variables"])
        shard_params(model, mesh)
        model.eval()
        translator = get_translator(opt)
        feats = payload["feats"]
        _zero_launch_counts()
        hyps, scores = _serve_rows(translator, model, feats, slice(0, BATCH))
        served = dict(_launch_counts(), beam_steps=translator.beam_steps)

        class One(list):
            def set_epoch(self, epoch):
                pass

        trainer = Trainer(opt, One([payload["batch"]]), mesh=mesh)
        trainer.init_model()
        trainer.load_variables(payload["variables"])
        trainer._build_tx(1)
        step = trainer._make_train_step()
        _zero_launch_counts()
        loss = float(step(trainer._device_batch(payload["batch"]))[0])
        trained = _launch_counts()
        after = trainer.variables()["params"]
        torch.save({"hyps": hyps, "scores": scores, "served": served,
                    "loss": loss, "trained": trained, "after": after,
                    "fused": trainer._fused_xent,
                    "head_rows": tuple(
                        model.cls_head.tgt_word_prj.weight.shape)},
                   os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_parallel(opt, scratch) -> None:
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from care_tpu_torch.models.weights import variables_to_jax
    from care_tpu_torch.parallel import make_mesh
    base = dict(opt, fused_xent=True,
                checkpoint_path=os.path.join(scratch, "parallel"))
    loader = SyntheticLoader(opt, PARALLEL_STEPS, BATCH, SEED + 50)
    feats = _synthetic_feats(opt, BATCH + RAGGED, SEED + 51)
    trained = ("vocab_argmax_lse", "fused_xent_bwd_dh", "fused_xent_bwd_dw")

    # a world of one over NCCL: the mesh {data: 1} against no mesh
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(scratch, "nccl_world"),
        rank=0, world_size=1)
    try:
        mesh = make_mesh({"data": 1})
        runs = {}
        for label, m in (("no mesh", None), ("data=1", mesh)):
            trainer = Trainer(base, loader, mesh=m)
            trainer.init_model()
            trainer._build_tx(len(loader))
            step = trainer._make_train_step()
            assert trainer._fused_xent
            _zero_launch_counts()
            losses = [step(trainer._device_batch(b))[0]
                      for b in loader.batches]
            torch.cuda.synchronize()
            launched = _launch_counts()
            for name, n in launched.items():
                assert n == (PARALLEL_STEPS if name in trained else 0), (
                    label, launched)
            runs[label] = (trainer, [float(x) for x in losses])
        (plain, plain_losses), (meshed, mesh_losses) = runs.values()
        gap = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
            plain.model.parameters(), meshed.model.parameters()))
        assert gap == 0.0 and plain_losses == mesh_losses, (gap,
                                                            plain_losses,
                                                            mesh_losses)
        rounded = [round(l, 4) for l in mesh_losses]
        print(f"parallel: world of 1 over NCCL, mesh {{data: 1}}: "
              f"{PARALLEL_STEPS} fused steps at batch {BATCH} equal the "
              f"mesh-less trainer's (losses {rounded}, parameter gap {gap});"
              f" K2, K3a, K3b == {PARALLEL_STEPS}")

        # serving 64 + 17 on the mesh, beside the mesh-less model
        translator = get_translator(base)
        beams = {}
        for label in ("no mesh", "data=1"):
            model = runs[label][0].model.eval()
            _zero_launch_counts()
            steps0 = translator.beam_steps
            out = [_serve_rows(translator, model, feats, rows) for rows in
                   (slice(0, BATCH), slice(BATCH, BATCH + RAGGED))]
            launched = _launch_counts()
            steps = translator.beam_steps - steps0
            assert launched["fused_head_topk"] == steps > 0, (launched,
                                                              steps)
            assert launched["beam_bookkeeping"] == steps, (launched, steps)
            beams[label] = out
        assert beams["no mesh"] == beams["data=1"], "beams differ"
        print(f"parallel: world of 1 served {BATCH} + {RAGGED} videos, "
              f"beams == the mesh-less model's")
        world1 = beams["data=1"][0]
        variables = variables_to_jax(meshed.model)

        # the unsharded dense step's loss on the trained weights, dropout
        # off: what the model-parallel step must reproduce
        quiet = dict(opt, fused_xent=False, **QUIET)
        ref = Trainer(quiet, loader)
        ref.init_model()
        ref.load_variables(variables)
        ref._build_tx(1)
        ref_loss = float(ref._make_train_step()(ref._device_batch(
            loader.batches[0]))[0])
        ref_after = variables_to_jax(ref.model)["params"]
        del runs, plain, meshed, ref
    finally:
        dist.destroy_process_group()
    _check_vocab_shards(opt)

    # a world of two over gloo on the same card: {data: 1, model: 2}
    payload = os.path.join(scratch, "parallel_payload.pt")
    torch.save({"opt": quiet, "variables": variables,
                "feats": [f[:BATCH] for f in feats],
                "batch": loader.batches[0]}, payload)
    out_dir = os.path.join(scratch, "parallel_out")
    os.makedirs(out_dir, exist_ok=True)
    mp.start_processes(_parallel_child, args=(
        os.path.join(scratch, "gloo_world"), payload, out_dir), nprocs=2,
        start_method="spawn")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    hyps, scores = ranks[0]["hyps"], ranks[0]["scores"]
    assert hyps == world1[0], "the model-parallel beams differ"
    err = max(abs(a - b) for row, want in zip(scores, world1[1])
              for a, b in zip(row, want))
    assert err <= 1e-4, err
    for r in ranks:
        served, launched = r["served"], r["trained"]
        assert r["head_rows"] == (opt["vocab_size"] // 2, opt["dim_hidden"])
        assert served["fused_head_topk"] == served["beam_steps"] > 0, served
        assert served["beam_bookkeeping"] == served["beam_steps"], served
        assert not r["fused"] and all(launched[k] == 0 for k in trained), (
            launched)
        assert r["loss"] == ranks[0]["loss"]
    rel = abs(ranks[0]["loss"] - ref_loss) / abs(ref_loss)
    assert rel <= 1e-5, (ranks[0]["loss"], ref_loss)
    gap, change_err = _step_agreement(variables["params"], ref_after,
                                      ranks[0]["after"])
    assert change_err[0] <= 1e-2, change_err
    k1 = [r["served"]["fused_head_topk"] for r in ranks]
    print(f"parallel: world of 2 over gloo on one card, mesh {{data: 1, "
          f"model: 2}}: {BATCH} videos through K1 on each process's "
          f"{ranks[0]['head_rows']} rows, merged: beams == the world of "
          f"1's, scores within {err:.2e}; K1 launches {k1} == beam steps; "
          f"one dense step (fused CE off on a model axis, no K2/K3 "
          f"launch): loss {ranks[0]['loss']:.6f} vs unsharded "
          f"{ref_loss:.6f} (relative {rel:.2e}), parameters after it "
          f"within {gap:.2e} of the unsharded step's (worst leaf's change "
          f"off by {change_err[0]:.2e} of itself, {change_err[1]})")


def _step_agreement(before, want, got) -> tuple:
    """(largest gap between the parameter trees ``want`` and ``got``,
    (worst leaf's ``|got change - want change| / |want change|`` from
    ``before`` in the 2-norm, that leaf's name)). The attention key biases
    are left out of the second: their true gradient is 0, so Adam steps
    f32 noise on either side."""
    leaves = lambda t, pre="": [
        x for k, v in t.items()
        for x in (leaves(v, f"{pre}{k}/") if isinstance(v, dict)
                  else [(pre + k, np.asarray(v))])]
    b, w, g = (dict(leaves(t)) for t in (before, want, got))
    assert sorted(w) == sorted(g) == sorted(b)
    gap = max(float(np.abs(g[k] - w[k]).max()) for k in w)
    err = max((float(np.linalg.norm(g[k] - w[k])
                     / max(np.linalg.norm(w[k] - b[k]), 1e-30)), k)
              for k in w if not k.endswith("/key/bias"))
    return gap, err


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


def phase_family(scratch) -> None:
    """The rest of the CARE Transformer family at full width: for each
    configuration of ``FAMILY`` (the concept-attention sublayer in CABase
    and the ``parallel`` / ``attr2cross`` placements, semantic composition
    with the hybrid bias, ARB's HighWay / BatchNorm encoder, and the
    ``parallel`` placement at long keys), ``Trainer.fit`` for
    ``FAMILY_STEPS`` steps of batch 64 with ``fused_xent: True`` (K2, K3a
    and K3b once per step; ARB's running statistics must move), then
    ``_serve`` of one batch of 64 (K1 once per beam step; K4a once per beam
    step and layer at long keys; every score re-checked by teacher
    forcing)."""
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
        _zero_launch_counts()
        trainer.fit()
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
              f" fused_xent on; losses {[round(l, 4) for l in losses]};"
              f" launches { {k: v for k, v in counts.items() if v} }"
              + (f"; BatchNorm running statistics moved by up to "
                 f"{max(moved):.3e} ({len(stats)} buffers)" if stats else ""))
        del trainer, loader
        _serve(f"family {label}", opt, [BATCH], flash)


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
    errs = [max_err("NAR shape", what, g, w, 1e-5, 1e-5)
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


def _nar_decode(label, student, opt, feats, teacher, vm):
    """One batch through ``get_translator(opt).translate_batch`` with the
    teacher, the launch counts set to 0 just before and read just after.
    Returns (hypotheses, log-probs, counts)."""
    translator = get_translator(opt)
    _zero_launch_counts()
    hyps, lprobs = translator.translate_batch(
        student, {"feats": feats}, teacher=teacher, vocab_mapping=vm)
    counts = _launch_counts()
    passes = translator.decoder_passes + translator.teacher_passes
    assert counts["vocab_argmax_lse"] == passes, (label, counts, passes)
    assert all(n == 0 for k, n in counts.items()
               if k != "vocab_argmax_lse"), (label, counts)
    lp = np.asarray(lprobs)
    assert np.shape(hyps) == (len(feats[0]), 1, opt["max_len"]), label
    assert np.isfinite(lp).all() and (lp <= 0).all(), label
    words = np.asarray(hyps)[:, 0]
    print(f"nar {label}: batch {len(feats[0])}, "
          f"{translator.decoder_passes} student passes + "
          f"{translator.teacher_passes} teacher rescoring, K2 launches "
          f"{counts['vocab_argmax_lse']}; mean length "
          f"{(words != constants.PAD).sum(1).mean():.2f}, MASK tokens "
          f"{(words == constants.MASK).mean():.3f} of the canvas; first "
          f"caption ids {words[0][:12].tolist()}")
    return hyps, lprobs, counts


def phase_nar(scratch) -> None:
    """NACF at full width (``--arch base``, MSRVTT ViT, V 11 000, batch 64,
    ``max_len`` 30, random weights from a seed): the ARB CARE teacher
    trained ``NAR_STEPS`` steps and checkpointed; the NACF CARE student
    filled from that checkpoint (``load_teacher_weights_into_student``) and
    trained
    ``NAR_STEPS`` steps, which launch no vocab kernel (the multi-pass
    loss stays dense, as in ``care_tpu``); one batch of 64 served with
    teacher rescoring by mask-predict with the template (K2 launches ==
    ``NAR_MP_LAUNCHES``), then by ``l2r`` and ``ef``; the mask-predict
    batch again with the plain version in K2's place (hypotheses
    identical, log-probs within 1e-5); K2 against its plain version at the
    decode's shape."""
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
    _zero_launch_counts()
    student.fit()
    counts = _launch_counts()
    losses = _step_losses(student)
    log = student.history[-1]
    assert all(n == 0 for n in counts.values()), counts
    assert not student._fused_xent and len(losses) == NAR_STEPS
    assert all(np.isfinite(losses)), losses
    assert np.isfinite(log["Word Acc0"]) and np.isfinite(log["Length Loss"])
    print(f"nar student NACF CARE ({s_where}): the teacher filled {filled} "
          f"of its {n_leaves} leaves; {NAR_STEPS} steps of batch {BATCH}, "
          f"losses {[round(l, 4) for l in losses]}, Word "
          f"Acc0 {log['Word Acc0']:.4f}, Length Loss "
          f"{log['Length Loss']:.4f}; vocab-kernel launches {counts}")

    model = student.model.eval()
    teacher_model, vm = student._get_teacher()
    feats = _synthetic_feats(s_opt, BATCH, SEED + 90)
    runs = {paradigm: _nar_decode(paradigm, model,
                                  dict(s_opt, paradigm=paradigm), feats,
                                  teacher_model, vm)
            for paradigm in ("mp", "l2r", "ef")}
    assert runs["mp"][2]["vocab_argmax_lse"] == NAR_MP_LAUNCHES, runs["mp"][2]
    mp = dict(s_opt, paradigm="mp")

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
    h, W = head_inputs(rows, H, V, torch.float32, False, 12)
    tokens = torch.randint(0, V, (rows,), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    _check_argmax_lse_nar(h, W, tokens)
    _check_argmax_lse_nar(*head_inputs(rows, H, V, torch.bfloat16, True, 13),
                          tokens)


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


def phase_rnn(scratch) -> None:
    """The RNN captioners at full width (``--arch base``: H 512; V 11 000;
    28 frames of audio, motion and image; 30 concept slots; batch 64, beam
    5, ``max_len`` 30, random weights from a seed): SALSTM CARE, TopDown
    CARE and the VOE preset. Each trains ``RNN_EPOCHS`` epochs of
    ``RNN_BATCHES`` batches with dropout on and scheduled sampling at 0.25
    in epoch 1 (no kernel launches: the RNN loss stays dense, as in
    ``care_tpu``; VOE's running statistics must move), then ``_serve``
    decodes one batch of 64 and the ragged 17 off the fused head (the
    beam bookkeeping kernel once a beam step, no other; every score
    re-checked by teacher forcing), and SALSTM is served in bf16 beside
    f32. The launch counts of the phase are all 0 but the bookkeeping's."""
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
        _zero_launch_counts()
        trainer.fit()
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
              f"({RNN_EPOCHS} epochs), dropout on; losses "
              f"{[round(l, 4) for l in losses]}; epoch 1 fed a sampled token "
              f"at {100 * share:.2f}% of {positions} positions (p 0.25, "
              f"4 sigma {400 * sigma:.2f}%); kernel launches "
              f"{sum(counts.values())}"
              + (f"; BatchNorm running statistics moved by up to "
                 f"{max(moved):.3e}" if stats else ""))
        for k, n in counts.items():
            totals[k] += n
        del trainer, loader
        run = _serve(f"rnn {label}", opt, [BATCH, RAGGED], False)
        for k, n in run["counts"].items():
            totals[k] += n
        if i == 0:
            bf16 = _serve(f"rnn {label}, bf16", _half(opt), [BATCH], False)
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
    assert all(n == 0 for k, n in totals.items()
               if k != "beam_bookkeeping"), totals


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
    just before and read just after. Returns (trainer, counts)."""
    loader = SyntheticLoader(opt, POINTER_BATCHES, BATCH, seed)
    trainer = Trainer(dict(opt, epochs=POINTER_EPOCHS,
                           checkpoint_path=os.path.join(scratch, name)),
                      loader)
    trainer.init_model()
    _zero_launch_counts()
    trainer.fit()
    return trainer, _launch_counts()


def phase_pointer(scratch) -> None:
    """PointerGen Base and PointerGen CARE on MSRVTT at full width
    (``--arch base``: H 512; V 11 000; ViT features, ``--modality ami``;
    ``retrieval_topk`` 20 retrieved captions of ``max_len`` 30 token ids,
    ``exclude_eos``; batch 64, beam 5; random weights from a seed). Each
    trains ``POINTER_EPOCHS`` epochs of ``POINTER_BATCHES`` steps with
    dropout on (the dense cross-entropy on the pointer's probabilities),
    then again from the same seed: the parameters must be equal bit for
    bit (the copy scatter's determinism; the gap is printed). ``_serve``
    then decodes one batch of 64 and the ragged 17 through the dense
    pointer step, every score re-checked by teacher forcing. K1-K4c launch
    0 times in the phase, as ``care_tpu`` keeps pointer models off the
    fused head, the fused cross-entropy and flash attention; the beam
    bookkeeping kernel once a beam step."""
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
            trainer, counts = _pointer_fit(
                opt, scratch, f"pointer{i}_{repeat}", SEED + 120 + i)
            assert not trainer._fused_xent, label
            assert all(n == 0 for n in counts.values()), (label, counts)
            runs.append(trainer)
        losses = _step_losses(runs[0])
        assert len(losses) == POINTER_EPOCHS * POINTER_BATCHES, losses
        assert all(np.isfinite(losses)), losses
        assert losses == _step_losses(runs[1]), label
        gap = max(float((a - b).detach().abs().max()) for a, b in zip(
            runs[0].model.parameters(), runs[1].model.parameters()))
        assert gap == 0.0, (label, gap)
        print(f"pointer {label}: train {len(losses)} steps of batch {BATCH} "
              f"({POINTER_EPOCHS} epochs), dropout on, dense "
              f"cross-entropy on the pointer's probabilities; losses "
              f"{[round(l, 4) for l in losses]}; a repeat from the same "
              f"seed: losses equal, parameter gap {gap!r}; kernel "
              f"launches 0")
        del runs
        run = _serve(f"pointer {label}", opt, [BATCH, RAGGED], False)
        for k, n in run["counts"].items():
            totals[k] += n
    assert all(n == 0 for k, n in totals.items()
               if k != "beam_bookkeeping"), totals


# ---------------------------------------------------------------------------
# ensembles
# ---------------------------------------------------------------------------

# the flagship and PointerGen CARE on the same MSRVTT features: the
# ensemble's modalities are amir and amirt
ENSEMBLE = [("flagship", dict(VERSATILITY_MSRVTT, method="Transformer",
                              task="CARE"),
             "__graft_entry__.py:_flagship_opt"),
            POINTER[1]]


def phase_ensemble(scratch) -> None:
    """Ensembles at full width (batch 64, beam 5), with the launch counts
    set to 0 just before and read just after: (1) PointerGen CARE with
    itself decodes what it decodes alone (``==`` on hypotheses and scores:
    the mean of equal log-probabilities is themselves); (2) the
    heterogeneous ensemble of the CARE flagship (``amir``) and PointerGen
    CARE (``amirt``): 3 batches of 64 and the ragged 17, split from the
    union's features by ``EnsembleSpec``, decoded batch by batch and
    grouped (``translate_batches_grouped``, fused-K 4), equal results
    (``==``); (3) ``care_tpu_torch.translate.main`` with
    the two checkpoints the phase writes (``-cp a b``) on the test split of
    a synthetic dataset of the union's modalities with a retrieval
    database. None of K1-K4c launches: ensembles take the dense step, as
    in ``care_tpu``; the beam bookkeeping kernel does, as in every AR
    decode on the card."""
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
    _zero_launch_counts()

    alone = pointer_alone.translate_batch(models[1],
                                          {"feats": feats[0]})
    pair = pointer_alone.translate_batch([models[1], models[1]],
                                         {"feats": feats[0]})
    assert pair == alone
    print(f"ensemble: PointerGen CARE with itself == PointerGen CARE alone "
          f"on a batch of {BATCH} (hypotheses and scores)")

    one_by_one = [translator.translate_batch(models, b) for b in batches]
    grouped = [out for _, out in translator.translate_batches_grouped(
        models, enumerate(batches), 4)]
    assert grouped == one_by_one
    n_caps = sum(len(f[0]) for f in feats)
    assert all(len(h) == len(f[0]) and all(len(x[0]) >= 1 for x in h)
               for (h, _), f in zip(one_by_one, feats))
    print(f"ensemble: flagship (amir) + PointerGen CARE (amirt), features "
          f"split from the union {spec.opt['modality']}: {len(batches)} "
          f"batches ({n_caps} videos) batch by batch and grouped fused-K 4, "
          f"results equal (==)")

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
        (scores,) = translate.main(["-cp", *paths, "--base_data_path", root,
                                    "--batch_size", str(BATCH),
                                    "--json_path", out])
    finally:
        data_pkg.get_loader = inner_loader
    counts = _launch_counts()
    with open(os.path.join(out, "preds.json")) as f:
        preds = json.load(f)
    n_test = len(corpus["info"]["split"]["test"])
    assert len(preds) == n_test, (len(preds), n_test)
    assert all(n == 0 for k, n in counts.items()
               if k != "beam_bookkeeping"), counts
    assert counts["beam_bookkeeping"] > 0, counts
    print(f"ensemble: translate -cp <flagship> <PointerGen CARE> on "
          f"{n_test} test videos: CIDEr {scores['CIDEr']:.6f}; K1-K4c "
          f"launches in the phase 0, beam bookkeeping "
          f"{counts['beam_bookkeeping']}")


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
    counts)."""
    _zero_launch_counts()
    trainer = Trainer(dict(opt, checkpoint_path=os.path.join(scratch,
                                                             label)), loader)
    trainer.fit()
    return trainer, _launch_counts()


def phase_backbone(scratch) -> None:
    """The visual front at full width, on raw frames of normalized values
    from the seed. (1) Serve: the flagship with CLIP ViT-B/32 (patch 32,
    width 768, 12 layers, 12 heads, output 512, 224 x 224; random weights)
    captions 64 + 17 videos of 28 frames through ``translate_batch``
    (``_serve``: K1 == beam steps, scores re-checked by teacher forcing),
    and 2 videos are decoded on the card and on the CPU (beams equal). (2)
    Train: ``Trainer.fit`` with ``fused_xent: True`` at batch 16 (448
    frames a step through the tower), K2, K3a and K3b once per step; then
    the run again from one seed with cuDNN deterministic: losses equal and
    a parameter gap of exactly 0.0. (3) Pretreatment: ``encode_images`` of
    CLIP ViT-B/32, ResNet-50 and InceptionResNetV2 on 448 frames each, held
    to the CPU port on 4 frames; ``retrieve_topk`` and
    ``evaluate_retrieval`` on MSRVTT's size (10 000 videos x 20 captions of 512), indices equal to
    the CPU's (all top-k rows; the ranks of 500 videos). (4) The patch
    encoders (``CNN1``, ``CNN2``, ``CNN3`` on 28 frames of 4 layers x 49
    patches; ``SingleStreamEmbedder`` on ``ami``) with the flagship's
    decoder (``Transformer Base``, H 512, V 11 000): one fused train step
    and one decode of 64 each (K2, K3a, K3b == 1, K1 == beam steps), beams
    of 2 videos equal to the CPU's."""
    from care_tpu_torch.models.cnn import encode_images as encode_cnn
    from care_tpu_torch.models.weights import params_to_jax
    from care_tpu_torch.pretreatment import retrieval
    from care_tpu_torch.pretreatment.clip import encode_images as encode_clip

    opt = backbone_opt()

    # (1) serving
    _serve("backbone", opt, [BATCH, RAGGED], False)
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
            trainer, counts = _backbone_train(train_opt, loader, scratch,
                                              label)
            assert trainer._fused_xent and trainer.global_step == steps
            for name, n in counts.items():
                assert n == (steps if name in (
                    "vocab_argmax_lse", "fused_xent_bwd_dh",
                    "fused_xent_bwd_dw") else 0), (name, counts)
            losses = _step_losses(trainer)
            assert all(np.isfinite(losses)), losses
            runs.append((losses, params_to_jax(trainer.model)))
            print(f"backbone: train {steps} steps of batch "
                  f"{BACKBONE_TRAIN_BATCH} ({BACKBONE_TRAIN_BATCH * 28} "
                  f"frames a step through the tower), fused_xent on, "
                  f"dropout on; losses "
                  f"{[round(l, 4) for l in losses]}; launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
            del trainer
        (loss_a, params_a), (loss_b, params_b) = runs
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
        got = encode(model.cuda(), frames)
        atol = 5e-4 if name == "inceptionresnetv2" else 2e-4
        err = float(np.max(np.abs(got[:TOWER_CPU_FRAMES] - want)))
        np.testing.assert_allclose(got[:TOWER_CPU_FRAMES], want, rtol=1e-3,
                                   atol=atol)
        assert np.isfinite(got).all() and got.shape[0] == TOWER_FRAMES
        print(f"pretreatment {name} at {side}x{side}: encode_images of "
              f"{TOWER_FRAMES} frames: features {list(got.shape)}, |max| "
              f"{float(np.abs(got).max()):.3g}, against the CPU on "
              f"{TOWER_CPU_FRAMES} frames max |diff| {err:.2e} (atol "
              f"{atol:g}, rtol 1e-3)")
        del model

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
    top_card = retrieval.sims_topk(image, text, k)
    top_cpu = retrieval.sims_topk(image, text, k, device="cpu")
    assert np.array_equal(top_card, top_cpu), \
        int((top_card != top_cpu).any(axis=1).sum())
    ids = retrieval.retrieve_topk(image, text, RETRIEVAL_TOPK,
                                  own_ranges=own, refs=refs, unique=True)
    assert all(len(r) == RETRIEVAL_TOPK for r in ids)
    assert all(not s <= i < e for r, (s, e) in zip(ids, own) for i in r)
    metrics = retrieval.evaluate_retrieval(image, text, own)
    rows = RETRIEVAL_CPU_RANK_ROWS
    ranks_card = retrieval.own_caption_ranks(image[:rows], text, own[:rows])
    ranks_cpu = retrieval.own_caption_ranks(image[:rows], text, own[:rows],
                                            device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(ranks_card, ranks_cpu))
    print(f"pretreatment retrieval: {RETRIEVAL_VIDEOS} videos x "
          f"{n_text} captions of {RETRIEVAL_DIM}: similarity top-{k} on the "
          f"card and on the CPU, indices equal (all rows, ties lowest index "
          f"first); retrieve_topk with the own-range and duplicate filters; "
          f"evaluate_retrieval "
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
        trainer, counts = _backbone_train(
            dict(popt, fused_xent=True, epochs=1), loader, scratch,
            f"patch_{encoder}")
        for name, n in counts.items():
            assert n == (1 if name in ("vocab_argmax_lse",
                                       "fused_xent_bwd_dh",
                                       "fused_xent_bwd_dw") else 0), counts
        loss = _step_losses(trainer)[0]
        assert np.isfinite(loss)
        model = trainer.model.eval()
        translator = get_translator(popt)
        feats = _synthetic_feats(popt, BATCH, SEED + 120)
        _zero_launch_counts()
        translator.beam_steps = 0
        hyps, scores = translator.translate_batch(model, {"feats": feats})
        counts, steps = _launch_counts(), translator.beam_steps
        assert counts["fused_head_topk"] == steps > 0, (counts, steps)
        assert counts["beam_bookkeeping"] == steps, (counts, steps)
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
              f"(loss {loss:.4f}), a decode of {BATCH} with K1 == {steps} "
              f"beam steps; 2 videos "
              f"on the CPU: beams equal, scores within "
              f"{gap:.2e}")
        del trainer, model, cpu_model


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


def _pipeline_data(opt, root, n_videos=PIPELINE_VIDEOS, label="pipeline"):
    """Write the synthetic dataset of ``n_videos`` under ``root`` (HDF5
    when ``h5py`` imports, else the same arrays in memory), widen the
    written corpus's vocabulary to ``opt["vocab_size"]`` with unused words,
    and point the options at it. Returns (opt, loaders, corpus, references,
    a ``get_loader`` over the store)."""
    import pickle
    opt = dict(opt)
    hdf5 = importlib.util.find_spec("h5py") is not None
    if hdf5:
        data_dir, paths, _, _ = corpus_lib.write_synthetic_dataset(
            root, opt, n_videos=n_videos, seed=SEED)
        for char, path in paths.items():
            opt[f"feats_{char}"] = [path]
    else:
        data_dir = os.path.join(root, opt["dataset"])
        os.makedirs(data_dir, exist_ok=True)
        corpus = corpus_lib.build_synthetic_corpus(
            n_videos=n_videos, seed=SEED, max_len=opt["max_len"],
            attribute_k=opt["attribute_prediction_k"])
        for name, obj in (("info_corpus.pkl", corpus), ("refs.pkl",
                          corpus_lib.build_synthetic_references(corpus))):
            with open(os.path.join(data_dir, name), "wb") as f:
                pickle.dump(obj, f)
        stores = _synthetic_stores(opt, corpus, n_videos, SEED)

        class InMemoryJointDataset(JointDataset):
            """``JointDataset`` over the feature stores held in memory:
            ``opt["feats_<c>"]`` names a key of ``stores``, a dict vid ->
            [frames, dim] array, which answers ``vid in db`` and
            ``db[vid]`` as an open HDF5 file does."""

            def _load_database(self, path):
                return [stores[p] for p in path]

        for char in opt["modality"]:
            opt[f"feats_{char}"] = [f"memory:{char}"]
    print(f"{label}: feature store: "
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
    print(f"{label}: {n_videos} videos, split {split}, {used} words "
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


def phase_pipeline(opt, scratch) -> tuple:
    """The port's main path as ``care_tpu_torch.train.run`` drives it, on
    the flagship at full width (fused cross-entropy, dropout on, the
    dual-Adam switch at epoch 1): a synthetic dataset in the reference's
    layout, 2 epochs of ``Trainer.fit`` through the port's loader with
    beam-search validation and COCO scores after each, top-1 checkpoints on
    CIDEr, ``load_best`` and ``test``; the launch counts set to 0 just
    before and read just after. It runs on ``care_tpu``'s defaults: every
    train batch's features come from the device feature bank, and
    validation keeps ``eval_fused_k`` decodes in flight, whose COCO dict
    must equal that of ``eval_fused_k`` 1. Then a resume check, the bank
    on: 1 epoch, and a second trainer resuming it to 2, against the main
    run. Returns what the entry phase needs."""
    from care_tpu_torch import native
    from care_tpu_torch.metrics import meteor
    base = dict(opt, epochs=PIPELINE_EPOCHS, batch_size=BATCH,
                eval_batch_size=BATCH, fused_xent=True, lowlr_start_epoch=1,
                checkpoint_path=os.path.join(scratch, "pipeline", "exps"))
    # care_tpu's defaults, which the port now takes: the device feature
    # bank and fused-K validation
    assert base["device_feature_cache"] and base["eval_fused_k"] == 4, base
    base, loaders, corpus, refs, loader_fn = _pipeline_data(
        base, os.path.join(scratch, "pipeline"))
    vocab = corpus["info"]["itow"]

    trainer = Trainer(base, **loaders, references=refs, vocab=vocab,
                      log_dir=os.path.join(base["checkpoint_path"], "tb"))
    trainer.init_model()
    trainer._maybe_build_feature_bank()
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
    _zero_launch_counts()
    trainer.fit()
    # the uninterrupted run the resume check holds a resumed one to
    trainer_history = list(trainer.history)
    final_state = {k: v.clone()
                   for k, v in trainer.model.state_dict().items()}
    trainer.load_best()
    test_scores = trainer.test(info_corpus=corpus)
    counts = _launch_counts()
    steps = trainer.global_step
    beam_steps = trainer.translator.beam_steps
    n_val = len(loaders["val_loader"]) * PIPELINE_EPOCHS
    n_test = len(loaders["test_loader"])
    trained = ("vocab_argmax_lse", "fused_xent_bwd_dh", "fused_xent_bwd_dw")
    assert steps == PIPELINE_EPOCHS * len(loaders["train_loader"]), steps
    assert beam_steps > 0 and counts["fused_head_topk"] == beam_steps, \
        (counts, beam_steps)
    assert counts["beam_bookkeeping"] == beam_steps, (counts, beam_steps)
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
    # asked for eval_fused_k decodes in flight
    lookups = bank.lookups
    assert lookups == steps, (lookups, steps)
    assert grouped_calls == [base["eval_fused_k"]] * PIPELINE_EPOCHS, \
        grouped_calls
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
    print(f"pipeline: launches "
          f"{ {k: v for k, v in counts.items() if v} }: K1 == {beam_steps} "
          f"beam steps over {n_val} validation and {n_test} test batches, "
          f"K2 == K3a == K3b == {steps} train steps")
    ckpt_dir = base["checkpoint_path"]
    print(f"pipeline: checkpoints {sorted(os.listdir(ckpt_dir))}; device "
          f"feature bank {bank.describe()}, {lookups} lookups == {steps} "
          f"train steps; native evaluation core "
          f"{'loaded' if native.available() else 'absent (Python paths)'}; "
          f"METEOR stemmer "
          f"{'nltk Porter' if meteor._STEMMER is not None else 'none'}")

    # validation with 4 decodes in flight against 1 (at least 2 in
    # flight), the same weights: the captions and their scores, and the
    # COCO dict
    fused_scores, fused_preds = _validate_preds(trainer, 4)
    batch_scores, batch_preds = _validate_preds(trainer, 1)
    assert len(fused_preds) == n_val_videos, len(fused_preds)
    assert fused_preds == batch_preds
    assert fused_scores == batch_scores, (fused_scores, batch_scores)
    distinct = len({e["caption"] for v in fused_preds.values() for e in v})
    print(f"pipeline: validation with eval_fused_k 4 == 1: "
          f"{len(fused_preds)} videos' captions and scores equal "
          f"({distinct} distinct captions), {len(fused_scores)} COCO scores "
          f"equal (CIDEr {fused_scores['CIDEr']:.6f})")
    del trainer

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
    return base, loader_fn, corpus, refs


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
    the card, for ``feature_cache_dtype`` None and ``bfloat16``: resident
    on the card, and a batch of 64 gathered from it equal to the stores'
    rows (rounded as the bank stores them)."""
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
        before = torch.cuda.memory_allocated()
        stores = Stores(cfg)
        bank = build_feature_bank(stores, dict(
            cfg, feature_cache_dtype=dtype), "cuda")
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
        print(f"bank feature_cache_dtype={dtype}: {bank.describe()}; "
              f"gathered rows of a batch of {BATCH} equal to the stores'")
        del bank, out
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the serving entry points on the pipeline's checkpoint
# ---------------------------------------------------------------------------

def phase_entry(opt, loader_fn, corpus, refs, scratch) -> None:
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
        (fused,) = translate.main(common + ["--fused_k", "4", "--json_name",
                                            "fused.json"])
        (piped,) = translate.main(common + ["--json_name", "piped.json"])
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
    assert counts["beam_bookkeeping"] == steps, (counts, steps)
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
          f"{piped['CIDEr']:.6f}); --latency at batch 1: a latency.txt "
          f"line over {n} videos ({method} {task}); eval_json == run_eval's "
          f"scores; launches { {k: v for k, v in counts.items() if v} }: "
          f"K1 == {steps} beam steps")


# ---------------------------------------------------------------------------
# the mean teacher, reference-checkpoint conversion, BERT caption embeddings
# ---------------------------------------------------------------------------

# 405 videos: 243 train, 81 validation and 81 test (64 + 17 a pass)
MT_VIDEOS, MT_BATCHES, MT_EPOCHS, MT_CPU_VIDEOS = 405, 4, 2, 17


class _FirstBatches:
    """The first ``n`` batches of a train loader, every epoch."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __iter__(self):
        return iter([b for _, b in zip(range(self.n), self.loader)])

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)


def _params_gap(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _cpu_beams(ckpt, batch, n):
    """The beams ``load_model`` + the translator give on the host for the
    first ``n`` videos of ``batch`` (the plain kernel versions)."""
    from care_tpu_torch.models.loading import load_model
    models, opt = load_model(ckpt, do_replace_paths=False, device="cpu")
    hyps, _ = get_translator(opt, device="cpu").translate_batch(
        models[0], {"feats": [f[:n] for f in batch["feats"]]})
    return hyps


def phase_mean_teacher(opt, scratch) -> tuple:
    """The mean teacher (``wrapper: InterplayModel``) on the flagship at
    full width with the pipeline's synthetic data: 2 epochs of 4 batches
    of 64 with validation every epoch (the student decodes), top-1
    checkpoints of the teacher, ``load_best`` and ``test`` (the teacher in
    memory decodes), the launch counts set to 0 just before and read just
    after; then the same training again from the seed, and the plain
    ``Trainer`` on the same batches. Returns what the convert phase
    needs."""
    from care_tpu_torch.models.weights import flat_leaves, params_to_jax
    from care_tpu_torch.training import checkpoints as ckpt_lib
    from care_tpu_torch.training.mean_teacher import MeanTeacherTrainer
    root = os.path.join(scratch, "mean_teacher")
    base = dict(opt, wrapper="InterplayModel", epochs=MT_EPOCHS,
                batch_size=BATCH, eval_batch_size=BATCH,
                checkpoint_path=os.path.join(root, "exps"))
    base, loaders, corpus, refs, loader_fn = _pipeline_data(
        base, root, MT_VIDEOS, label="mean_teacher")
    vocab = corpus["info"]["itow"]
    train = _FirstBatches(loaders["train_loader"], MT_BATCHES)
    ema = base["ema_weight"]

    def trainer(**kw):
        tr = MeanTeacherTrainer(base, train_loader=train, references=refs,
                                vocab=vocab, **kw)
        tr.init_model()
        return tr

    tr = trainer(val_loader=loaders["val_loader"],
                 test_loader=loaders["test_loader"])
    names = [n for n, _ in tr.model.named_parameters()]
    t_start = {n: t.clone() for n, t in tr.teacher_params.items()}
    first = {}
    make = tr._make_train_step

    def make_watched():
        step = make()

        def watched(*args):
            out = step(*args)
            if not first:
                first["student"] = {n: p.detach().clone() for n, p in
                                    tr.model.named_parameters()}
                first["teacher"] = {n: t.clone()
                                    for n, t in tr.teacher_params.items()}
            return out
        return watched

    tr._make_train_step = make_watched
    saved = {}
    on_epoch_end = tr.ckpt_manager.on_epoch_end

    def keep(epoch, variables, *args):
        saved[epoch] = (variables, params_to_jax(tr.model))
        return on_epoch_end(epoch, variables, *args)

    tr.ckpt_manager.on_epoch_end = keep
    test_batches = []
    inner_translate = tr.translator.translate_batch

    def translate(model, batch, **kw):
        out = inner_translate(model, batch, **kw)
        test_batches.append((batch, out[0]))
        return out

    tr.translator.translate_batch = translate
    _zero_launch_counts()
    tr.fit()
    final = ({n: p.detach().clone() for n, p in tr.model.named_parameters()},
             {n: t.clone() for n, t in tr.teacher_params.items()})
    tr.load_best()
    test_batches.clear()
    test_scores = tr.test(info_corpus=corpus)
    counts = _launch_counts()
    beam_steps = tr.translator.beam_steps
    n_val, n_test = len(loaders["val_loader"]), len(loaders["test_loader"])
    assert tr.global_step == MT_EPOCHS * MT_BATCHES, tr.global_step
    assert beam_steps > 0 and counts["fused_head_topk"] == beam_steps, \
        (counts, beam_steps)
    assert beam_steps <= (MT_EPOCHS * n_val + n_test) * (base["max_len"] - 1)
    assert counts["beam_bookkeeping"] == counts["fused_head_topk"], counts
    for name, n in counts.items():
        assert name in ("fused_head_topk", "beam_bookkeeping") or n == 0, (
            name, counts)
    assert not tr._fused_xent
    losses = [l for h in tr.history for l in h["step_losses"]]
    assert all(np.isfinite(losses)), losses
    # the EMA after the first step, recomputed here: ema * t0 + (1 - ema) * s1
    for n in names:
        want = ema * t_start[n] + (1 - ema) * first["student"][n]
        assert torch.equal(first["teacher"][n], want), n
    # every checkpoint holds the teacher (with the student's statistics);
    # the best one is the teacher of its epoch
    best, _, meta = ckpt_lib.load_checkpoint(os.path.join(
        base["checkpoint_path"], "best.ckpt"))
    teacher_tree, student_tree = (dict(flat_leaves(t)) for t in saved[
        meta["epoch"]])
    best_leaves = dict(flat_leaves(best))
    assert best_leaves.keys() == teacher_tree.keys()
    assert all(np.array_equal(v, teacher_tree[k])
               for k, v in best_leaves.items())
    assert not all(np.array_equal(best_leaves[("params",) + k], v)
                   for k, v in student_tree.items())
    # test decoded the final teacher: its first batch's beams against the
    # host's decode of last.ckpt (the final teacher)
    batch, hyps = test_batches[0]
    cpu = _cpu_beams(os.path.join(base["checkpoint_path"], "last.ckpt"),
                     batch, MT_CPU_VIDEOS)
    assert hyps[:MT_CPU_VIDEOS] == cpu, "card and host beams differ"
    print(f"mean_teacher: fit + load_best + test: steps "
          f"{[round(l, 4) for l in losses]}; validation "
          f"{[round(h['scores']['CIDEr'], 6) for h in tr.history]} CIDEr "
          f"(student); test {test_scores['CIDEr']:.6f} CIDEr (teacher); "
          f"launches { {k: v for k, v in counts.items() if v} }: K1 == "
          f"{beam_steps} beam steps over {MT_EPOCHS * n_val} validation and "
          f"{n_test} test batches, K2 == K3a == K3b == 0 (dense step)")
    print(f"mean_teacher: teacher after step 1 == {ema} * t0 + {1 - ema:.6g}"
          f" * s1 on all {len(names)} leaves (torch.equal); best.ckpt (epoch "
          f"{meta['epoch']}) == that epoch's teacher; test beams of "
          f"{MT_CPU_VIDEOS} videos == the host's from last.ckpt")

    # the same training again from the seed (no validation): bit for bit;
    # then the plain Trainer on the same batches
    del tr
    again = trainer()
    again.fit()
    gaps = (_params_gap(final[0], {n: p.detach() for n, p in
                                   again.model.named_parameters()}),
            _params_gap(final[1], again.teacher_params))
    assert gaps == (0.0, 0.0), gaps
    del again
    plain = Trainer(dict(base, wrapper="Model", checkpoint_path=os.path.join(
        root, "plain")), train)
    plain.fit()
    assert not plain._fused_xent
    print(f"mean_teacher: a second run from the seed: parameter gap "
          f"{gaps[0]} (student), {gaps[1]} (teacher); the plain Trainer on "
          f"the same batches takes the dense step too")
    return base, loader_fn, corpus


def phase_convert(base, loader_fn, corpus, scratch) -> None:
    """A reference-layout Lightning checkpoint of the flagship
    (``tests/reference_layout.py``: the reference's key names and torch
    layouts, seeded noise), converted by
    ``care_tpu_torch.tools.convert_reference_ckpt`` and served through
    ``care_tpu_torch.translate`` over the 81 test videos (64 + 17) on the
    card, then on the host: equal predictions; K1 == beam steps."""
    import care_tpu_torch.data as data_pkg
    import care_tpu_torch.decoding as decoding_pkg
    from care_tpu_torch import translate
    from care_tpu_torch.models.weights import variables_to_jax
    from care_tpu_torch.tools.convert_reference_ckpt import convert
    root = os.path.join(scratch, "convert")
    os.makedirs(root)
    opt = {k: v for k, v in base.items() if k != "wrapper"}
    template = variables_to_jax(build_captioner(opt, device="cpu"))
    ref = os.path.join(root, "reference.ckpt")
    lightning_checkpoint(ref, opt, reference_state_dict(opt, template, SEED))
    out = os.path.join(root, "converted.ckpt")
    report = convert(ref, out, verbose=False)
    assert report["unmapped"] == [], report["unmapped"][:5]

    translators = []
    inner_get = decoding_pkg.get_translator

    def get_translator_counted(*args, **kwargs):
        translators.append(inner_get(*args, **kwargs))
        return translators[-1]

    inner_loader = data_pkg.get_loader
    data_pkg.get_loader = loader_fn
    decoding_pkg.get_translator = get_translator_counted
    common = ["-cp", out, "--base_data_path", os.path.join(
        scratch, "mean_teacher"), "--batch_size", str(BATCH)]
    try:
        _zero_launch_counts()
        (card,) = translate.main(common + ["--json_path",
                                           os.path.join(root, "card")])
        counts = _launch_counts()
        (host,) = translate.main(common + ["--device", "cpu", "--json_path",
                                           os.path.join(root, "host")])
    finally:
        data_pkg.get_loader = inner_loader
        decoding_pkg.get_translator = inner_get
    assert len(translators) == 2, len(translators)
    steps = translators[0].beam_steps
    assert steps > 0 and counts["fused_head_topk"] == steps, (counts, steps)
    assert counts["beam_bookkeeping"] == counts["fused_head_topk"], counts
    for name, n in counts.items():
        assert name in ("fused_head_topk", "beam_bookkeeping") or n == 0, (
            name, counts)
    preds = {}
    for side in ("card", "host"):
        with open(os.path.join(root, side, "preds.json")) as f:
            preds[side] = {v: [e["caption"] for e in p]
                           for v, p in json.load(f).items()}
    n_test = len(corpus["info"]["split"]["test"])
    assert len(preds["card"]) == n_test, len(preds["card"])
    assert preds["card"] == preds["host"], "card and host beams differ"
    assert card == host, (card, host)
    print(f"convert: {len(report['consumed'])} reference tensors mapped "
          f"({len(report['buffers_skipped'])} buffers skipped, 0 "
          f"unmapped); translate served {n_test} videos ({BATCH} + "
          f"{n_test - BATCH}) on the card and on the host: captions and "
          f"COCO dict equal (CIDEr {card['CIDEr']:.6f}); launches "
          f"{ {k: v for k, v in counts.items() if v} }: K1 == {steps} beam "
          f"steps")


# bert-base-uncased's published widths
BERT_BASE = dict(vocab_size=30522, hidden=768, layers=12, heads=12,
                 intermediate=3072, max_position=512, type_vocab=2)
BERT_CAPTIONS, BERT_BATCH, BERT_CPU_CAPTIONS = 20000, 512, 256


def _bert_vocab(path, n_words=2000):
    """A WordPiece vocabulary of bert-base's size: the special tokens, the
    synthetic words the captions use, then unused entries."""
    words = [f"w{i}" for i in range(n_words)]
    lines = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
    lines += [f"[unused{i}]" for i in range(99, 99 + BERT_BASE["vocab_size"]
                                            - len(lines))]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return words


def phase_bert(scratch) -> None:
    """``BertEncoder`` at bert-base-uncased's widths (random weights from
    the seed) encodes 20 000 synthetic captions of 8-20 words and pools
    them by mean and max; 256 captions' pooled vectors held to the host's
    (f32, TF32 off); none of the eight kernels launches."""
    from care_tpu_torch.pretreatment.bert import (BertEncoder,
                                                  WordPieceTokenizer,
                                                  embed_captions)
    os.makedirs(os.path.join(scratch, "bert"))
    words = _bert_vocab(os.path.join(scratch, "bert", "vocab.txt"))
    tok = WordPieceTokenizer(os.path.join(scratch, "bert", "vocab.txt"))
    assert len(tok.vocab) == BERT_BASE["vocab_size"]
    rs = np.random.RandomState(SEED)
    captions = [" ".join(words[i] for i in rs.randint(0, len(words), n))
                for n in rs.randint(8, 21, BERT_CAPTIONS)]
    model = BertEncoder(**BERT_BASE,
                        generator=torch.Generator().manual_seed(SEED)).eval()
    host = BertEncoder(**BERT_BASE)
    host.load_state_dict(model.state_dict())
    model = model.cuda()
    n_params = sum(p.numel() for p in model.parameters())
    _zero_launch_counts()
    embs = embed_captions(model, tok, captions, ("mean", "max"), BERT_BATCH)
    counts = _launch_counts()
    assert not any(counts.values()), counts
    for mode, e in embs.items():
        assert e.shape == (BERT_CAPTIONS, BERT_BASE["hidden"]), e.shape
        assert bool(torch.isfinite(e).all()), mode
    want = embed_captions(host, tok, captions[:BERT_CPU_CAPTIONS],
                          ("mean", "max"), BERT_BATCH)
    errs = {}
    for mode in ("mean", "max"):
        got = embs[mode][:BERT_CPU_CAPTIONS].cpu()
        errs[mode] = float((got - want[mode]).abs().max())
        torch.testing.assert_close(got, want[mode], rtol=1e-4, atol=1e-4)
    print(f"bert: bert-base widths ({n_params} parameters, 12 x 768, 12 "
          f"heads, FFN 3072, vocab 30 522), {BERT_CAPTIONS} captions of "
          f"8-20 words pooled by mean and max in batches of {BERT_BATCH} "
          f"(f32, TF32 off); {BERT_CPU_CAPTIONS} captions against "
          f"the host: max |d| mean {errs['mean']:.3e}, max {errs['max']:.3e} "
          f"(<= 1e-4); launches of the eight kernels: 0")


def main() -> None:
    name = phase_device()
    opt = flagship_opt()
    phase_build()
    phase_check(opt)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_serve(opt)
        phase_flash_gradient()
        phase_train(opt, scratch)
        base, loader_fn, corpus, refs = phase_pipeline(opt, scratch)
        phase_entry(base, loader_fn, corpus, refs, scratch)
        phase_bank(opt)
        phase_family(scratch)
        phase_nar(scratch)
        phase_rnn(scratch)
        phase_pointer(scratch)
        phase_ensemble(scratch)
        phase_backbone(scratch)
        mt_base, mt_loader_fn, mt_corpus = phase_mean_teacher(opt, scratch)
        phase_convert(mt_base, mt_loader_fn, mt_corpus, scratch)
        phase_bert(scratch)
        phase_parallel(opt, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
