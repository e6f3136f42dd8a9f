"""Training the NAR models in the port against the JAX package, f32, dropout
off where values are compared.

* the ``length`` KL, NACF's multi-pass language loss (``nv_weights``,
  perplexity over the caption pass only, the MASK-aware ``word_acc0``)
  and NAB's single pass, through ``Criterion`` on the same inputs;
* three NACF train steps (``--method NACF --task CARE``: the visual-word
  and masked-language passes, the concept and length losses), and three
  of NAB (one masked-language pass), of ``Trainer.fit`` against the JAX
  train step: losses within 1e-4
  relative, parameters within 2e-5 (the attention key biases within three
  learning rates, as ``tests/test_torch_paper_grid_train.py`` states);
* ``load_teacher_weights_into_student`` from an ARB checkpoint whose
  vocabulary differs, held through ``params_to_jax`` against the JAX
  function on the same weights (the port remaps the rows of its ``[V, H]``
  head, the JAX package the columns of its ``[H, V]`` kernel);
* the port's counterpart of ``tests/test_full_pipeline.py``: an ARB
  teacher trained and checkpointed, a NACF student initialised from it
  (``train.load_weights_from``), trained and validated with the teacher
  rescoring every candidate, grouped validation equal to batch by batch,
  and the translate CLI with ``--teacher_path`` and the NAR flags.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.models.loading import (
    load_teacher_weights_into_student as jax_load_teacher)
from care_tpu.training.checkpoints import save_checkpoint as jax_save
from care_tpu.training.losses import Criterion as JaxCriterion
from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch import constants
from care_tpu_torch import train as port_train
from care_tpu_torch import translate as port_translate
from care_tpu_torch.config import get_opt
from care_tpu_torch.data import get_loader
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.models.loading import (get_vocab_mapping,
                                           load_teacher_weights_into_student)
from care_tpu_torch.models.weights import (params_to_jax, variables_from_jax,
                                           variables_to_jax)
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.checkpoints import save_checkpoint
from care_tpu_torch.training.losses import Criterion

from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import VERS_MSRVTT, tiny_opt

NACF_CARE = dict(VERS_MSRVTT, method="NACF", task="CARE",
                 with_teacher_during_training=True)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _conv(x, f):
    return [f(v) for v in x] if isinstance(x, list) else f(x)


@pytest.mark.parametrize("method", ["NACF", "NAB"])
def test_nar_losses_match_jax(method):
    opt = tiny_opt(dict(NACF_CARE, method=method))
    assert "length" in opt["crits"]
    rs = np.random.RandomState(0)
    B, L, V = 4, opt["max_len"], opt["vocab_size"]
    passes = 2 if method == "NACF" else 1
    logits = [(3 * rs.randn(B, L, V)).astype(np.float32)
              for _ in range(passes)]
    labels = [rs.randint(6, V, (B, L)).astype(np.int64)
              for _ in range(passes)]
    labels[0][0, :3] = constants.MASK
    labels[0][1, 5:] = constants.PAD
    for lg, lb in zip(logits, labels):      # some predictions right
        for b in range(B):
            lg[b, np.arange(L), lb[b]] += 6.0 * (rs.rand(L) > 0.5)
    target = rs.dirichlet(np.ones(L), B).astype(np.float32)
    target[:, :3] = 0.0                     # lengths with no mass
    res = {"logits": logits if passes == 2 else logits[0],
           "labels": labels if passes == 2 else labels[0],
           "preds_length": np.log(rs.dirichlet(np.ones(L), B)).astype(
               np.float32),
           "length_target": target / target.sum(1, keepdims=True)}
    opt = dict(opt, crits=["lang", "length"])
    want = JaxCriterion(opt)({k: _conv(v, jnp.asarray)
                              for k, v in res.items()})
    got = Criterion(opt)({k: _conv(v, torch.tensor) for k, v in res.items()})
    np.testing.assert_allclose(got[0].item(), float(want[0]), **TOL)
    assert set(got[1]) == set(want[1]) == {"Lang Loss", "Length Loss"}
    for k in want[1]:
        np.testing.assert_allclose(got[1][k].item(), float(want[1][k]),
                                   **TOL)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k].item(), float(want[2][k]),
                                   **TOL)
    if method == "NACF":
        # the MASK targets are left out of the visual-word accuracy, and
        # the perplexity counts the caption pass alone
        keep0 = (labels[0] != constants.PAD) & (labels[0] != constants.MASK)
        assert got[2]["word_acc_den0"].item() == keep0.sum()
        assert got[2]["xent_count"].item() == (labels[1] != 0).sum()


def _nar_batch(opt, n, seed):
    """A NACF training batch: the visual-word pass (``<vis>`` sources,
    content words or MASK as targets), the masked-language pass, a length
    target, concept labels; NAB's has the masked-language pass only."""
    batch = synthetic_batch(opt, n, seed)
    rs = np.random.RandomState(seed + 7)
    L, V = opt["max_len"], opt["vocab_size"]
    lengths = rs.randint(3, L + 1, n)
    valid = np.arange(L)[None, :] < lengths[:, None]
    words = rs.randint(6, V, (n, L))
    vis_src = np.where(valid, constants.VIS, constants.PAD)
    vis_tgt = np.where(valid & (rs.rand(n, L) < 0.5), words, constants.MASK)
    vis_tgt = np.where(valid, vis_tgt, constants.PAD)
    masked = valid & (rs.rand(n, L) < 0.6)
    mlm_src = np.where(masked, constants.MASK, words)
    mlm_src = np.where(valid, mlm_src, constants.PAD)
    mlm_tgt = np.where(masked, words, constants.PAD)
    target = np.zeros((n, L), np.float32)
    target[np.arange(n), np.minimum(lengths, L - 1)] = 1.0
    batch.update(input_ids=[vis_src.astype(np.int32),
                            mlm_src.astype(np.int32)],
                 labels=[vis_tgt.astype(np.int32), mlm_tgt.astype(np.int32)],
                 length_target=target)
    if not opt.get("visual_word_generation"):
        # NAB: the masked-language pass alone
        batch["input_ids"] = batch["input_ids"][1]
        batch["labels"] = batch["labels"][1]
    return batch


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("overrides", [
    NACF_CARE, dict(VERS_MSRVTT, method="NAB", task="Base")],
    ids=["NACF-CARE", "NAB-Base"])
def test_nar_trains_as_jax(overrides, tmp_path):
    opt = dict(tiny_opt(overrides), epochs=1,
               checkpoint_path=str(tmp_path / "exps"))
    assert opt["visual_word_generation"] == (opt["method"] == "NACF")
    jmodel, variables, _ = flagship_pair(opt, seed=5)
    batches = [_nar_batch(opt, 4, seed=10 + i) for i in range(3)]

    jt = JaxTrainer(opt)
    jt.init_model(batches[0])
    jt.variables = jax.tree.map(jnp.asarray, variables)
    jt._build_tx(len(batches))
    step = jt._make_train_step()
    assert not jt._fused_xent
    params, opt_state, want_losses = jt.variables["params"], jt.opt_state, []
    extra = {k: v for k, v in jt.variables.items() if k != "params"}
    rng = jax.random.PRNGKey(1)
    for b in batches:
        rng, k = jax.random.split(rng)
        params, mutated, opt_state, loss, _, _ = step(
            params, extra, opt_state, jax.tree.map(jnp.asarray, b), k, 0.0)
        extra = {**extra, **mutated}
        want_losses.append(float(loss))

    class Loader(list):
        def set_epoch(self, epoch):
            pass

    tr = Trainer(opt, Loader(batches), device="cpu")
    tr.init_model()
    variables_from_jax(tr.model, variables)
    tr.fit()
    assert not tr._fused_xent
    got_losses = [l for h in tr.history for l in h["step_losses"]]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert np.isfinite(tr.history[0]["Word Acc0"])
    got = dict(_leaves(params_to_jax(tr.model)))
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    assert sorted(got) == sorted(want)
    assert any("Predictor_length" in p for p in want)
    for path, value in want.items():
        noise = path.endswith("/key/bias")
        np.testing.assert_allclose(
            got[path], value, rtol=0,
            atol=3 * opt["learning_rate"] if noise else 2e-5, err_msg=path)


def _with_vocab(opt, corpus_dir, vocab):
    """``opt`` reading a corpus pickle whose vocabulary is ``vocab``."""
    import pickle
    os.makedirs(corpus_dir, exist_ok=True)
    path = os.path.join(corpus_dir, "info_corpus.pkl")
    with open(path, "wb") as f:
        pickle.dump({"info": {"itow": vocab}}, f)
    return dict(opt, info_corpus=path)


def test_teacher_weights_with_another_vocabulary_match_jax(tmp_path):
    """An ARB teacher of 40 words into a NACF student of 44 whose words
    the teacher knows under other ids: the student's shared leaves and the
    remapped word table and head, as the JAX package fills them."""
    t_opt = tiny_opt(dict(VERS_MSRVTT, method="ARB", task="CARE"))
    s_opt = dict(tiny_opt(NACF_CARE), vocab_size=44)
    specials = {i: w for i, w in enumerate(constants.SPECIAL_WORDS)}
    t_vocab = {**specials, **{i: f"w{i}" for i in range(6, 40)}}
    order = 6 + np.random.RandomState(3).permutation(34)
    s_vocab = {**specials, **{6 + j: f"w{int(i)}" for j, i in
                              enumerate(order)}}
    s_vocab.update({40 + j: f"w{6 + j}" for j in range(4)})
    t_opt = _with_vocab(t_opt, str(tmp_path / "t"), t_vocab)
    s_opt = _with_vocab(s_opt, str(tmp_path / "s"), s_vocab)
    vm = get_vocab_mapping(s_opt, t_opt)
    assert vm.shape == (44,) and vm[0] == 0 and list(vm[40:]) == [6, 7, 8, 9]

    _, t_vars, t_port = flagship_pair(t_opt, seed=2)
    port_ckpt = str(tmp_path / "port" / "best.ckpt")
    jax_ckpt = str(tmp_path / "jax" / "best.ckpt")
    save_checkpoint(port_ckpt, variables_to_jax(t_port), t_opt)
    jax_save(jax_ckpt, t_vars, t_opt)

    _, s_vars, student = flagship_pair(s_opt, seed=4)
    want = jax_load_teacher(s_vars, jax_ckpt, vm, verbose=False)
    filled = load_teacher_weights_into_student(student, port_ckpt, vm,
                                               verbose=False)
    got = dict(_leaves(variables_to_jax(student)))
    want = dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=path)
    # every leaf of the teacher fits; the length predictor keeps the
    # student's init
    t_leaves = dict(_leaves(t_vars))
    assert filled == len(t_leaves)
    start = dict(_leaves(s_vars))
    for path in got:
        if "Predictor_length" in path:
            np.testing.assert_array_equal(got[path], start[path])
    head = "params/cls_head/tgt_word_prj/kernel"
    np.testing.assert_array_equal(got[head], t_leaves[head][:, vm])


# ---------------------------------------------------------------------------
# the pipeline: ARB teacher, NACF student, validation with rescoring
# ---------------------------------------------------------------------------

def _env(root, method, **extra):
    overrides = {"dataset": "MSRVTT", "method": method, "task": "Base",
                 "feats": "ViT", "modality": "mi", "max_len": 12,
                 "n_frames": 8, "batch_size": 8, "beam_size": 2,
                 "epochs": 1, "num_hidden_layers_decoder": 1,
                 "eval_batch_size": 4, "eval_fused_k": 1,
                 "final_overrides": extra}
    opt = get_opt(overrides, read_vocab=False, resolve_paths=False)
    opt["dim_m"], opt["dim_i"] = 32, 16
    data_dir, paths, corpus, refs = write_synthetic_dataset(root, opt,
                                                            n_videos=20)
    opt["info_corpus"] = os.path.join(data_dir, "info_corpus.pkl")
    opt["reference"] = os.path.join(data_dir, "refs.pkl")
    for c, p in paths.items():
        opt[f"feats_{c}"] = [p]
    opt["vocab_size"] = len(corpus["info"]["itow"])
    opt["checkpoint_path"] = os.path.join(root, "exps", method)
    return opt, corpus, refs


def _trainer(opt, corpus, refs):
    loaders = dict(
        train_loader=get_loader(opt, "train"),
        val_loader=get_loader(opt, "validate", is_validation=True,
                              not_shuffle=True, batch_size=4,
                              pad_to_batch=True),
        test_loader=get_loader(opt, "test", not_shuffle=True, batch_size=4,
                               pad_to_batch=True))
    return Trainer(opt, references=refs, vocab=corpus["info"]["itow"],
                   device="cpu", **loaders)


def test_arb_teacher_then_nacf_student(tmp_path, capsys):
    t_opt, corpus, refs = _env(str(tmp_path), "ARB")
    teacher = _trainer(t_opt, corpus, refs)
    teacher.fit()
    teacher_ckpt = os.path.join(t_opt["checkpoint_path"], "best.ckpt")
    assert os.path.exists(teacher_ckpt)

    # the student: its own copy of the same corpus, the teacher named by
    # teacher_path, which NACF's preset also loads weights from
    s_opt, s_corpus, s_refs = _env(str(tmp_path / "student"), "NACF",
                                   teacher_path=teacher_ckpt,
                                   masking_decision=True)
    assert s_opt["load_model_weights_from"] == teacher_ckpt
    assert s_opt["load_strictly"] is False
    student = _trainer(s_opt, s_corpus, s_refs)
    filled = port_train.load_weights_from(student, teacher_ckpt)
    assert filled == len(list(_leaves(teacher.variables())))
    teacher_model, vm = student._get_teacher()
    assert vm is None and not teacher_model.training
    trained = dict(_leaves(teacher.variables()))
    for k, v in _leaves(variables_to_jax(teacher_model)):
        np.testing.assert_array_equal(v, trained[k])

    student.fit()
    tr = student.translator
    n_batches = len(student.val_loader)
    passes = (tr.decoder_passes, tr.teacher_passes)
    # mask-predict with the template and the masking decision: 6 student
    # passes and 6 teacher rescorings a batch
    assert passes == (6 * n_batches, 6 * n_batches)
    scores = student.history[0]["scores"]
    assert np.isfinite(scores["CIDEr"])
    student.opt["eval_fused_k"] = 4
    assert student.validate(0) == scores
    student.opt["eval_fused_k"] = 1
    assert student.validate(0) == scores

    # the CLI: the student's checkpoint with the teacher and NAR flags
    student_ckpt = os.path.join(s_opt["checkpoint_path"], "best.ckpt")
    root = str(tmp_path / "student")
    runs = [port_translate.main(
        ["-cp", student_ckpt, "--teacher_path", teacher_ckpt, "--device",
         "cpu", "--base_data_path", root, "--mode", "validate",
         "--batch_size", "4"] + extra)[0]
        for extra in ([], ["-paradigm", "ef", "-q", "2"],
                      ["-paradigm", "l2r", "-i", "3", "-md", "-ncd"])]
    # the checkpoint's own options and the same teacher: validation's
    # captions, so its scores
    assert runs[0]["CIDEr"] == scores["CIDEr"]
    assert all(np.isfinite(r["CIDEr"]) for r in runs)
    capsys.readouterr()


def test_check_whether_to_load_weights_matches_jax(tmp_path, monkeypatch):
    """No shipped task sets ``weights_from_inherit``: a hand-built task
    that inherits the ``Concept`` task's weights (its scope format from
    ``opt`` before the task's own overlay) names the same checkpoint in
    both packages, and a task without the flag names none."""
    import yaml
    from care_tpu.config import get_opt as jax_get_opt
    from care_tpu.config import loader as jax_loader
    from care_tpu_torch.config import presets

    entry = {"inherit_from": "Concept", "weights_from_inherit": True,
             "use_attr_flags": "G1Lc"}
    tasks = dict(presets.PRESETS["tasks"], Inherit=entry)
    monkeypatch.setitem(presets.PRESETS, "tasks", tasks)
    path = tmp_path / "tasks.yaml"
    path.write_text(yaml.safe_dump(tasks))
    real = jax_loader._yaml_path
    monkeypatch.setattr(jax_loader, "_yaml_path", lambda name: str(path)
                        if name == "tasks" else real(name))
    for task in ("Inherit", "CARE"):
        overrides = dict(VERS_MSRVTT, method="Transformer", task=task)
        got = get_opt(overrides, read_vocab=False, resolve_paths=False)
        want = jax_get_opt(overrides, read_vocab=False, resolve_paths=False)
        assert got["load_model_weights_from"] == \
            want["load_model_weights_from"]
        assert got == want
    assert got["load_model_weights_from"] == ""
    inherit = get_opt(dict(VERS_MSRVTT, method="Transformer",
                           task="Inherit"), read_vocab=False,
                      resolve_paths=False)["load_model_weights_from"]
    assert inherit.endswith(os.path.join("Transformer", "Concept",
                                         "base_ViT_VA_VAT_Nc500_Nk30_G1Lc"
                                         "_ViT_Nr20_bias0", "best.ckpt")), \
        inherit
