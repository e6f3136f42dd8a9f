"""Shared fixtures of the ``test_torch_*`` files, which hold the PyTorch port
(``care_tpu_torch``) against the JAX package on the same weights and inputs.

Inputs are made with numpy from a seed and handed to both stacks; JAX runs
on the CPU with f32 matmuls (conftest pins that), the port on the CPU with
its plain kernel versions. This module holds no tests.
"""

import numpy as np
import jax
import torch

import __graft_entry__ as graft
from care_tpu.models import build_captioner as jax_build_captioner
from care_tpu_torch import constants
from care_tpu_torch.models import build_captioner as port_build_captioner
from care_tpu_torch.models.weights import variables_from_jax


def flagship_small_opt(vocab_size: int = 97) -> dict:
    """The CARE flagship's options at test size (``_flagship_opt(small)``)."""
    return graft._flagship_opt(vocab_size=vocab_size, small=True)


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def randomized(params, seed: int, scale: float = 0.1):
    """Every leaf plus seeded noise, so LayerNorm scales, biases and the
    hybrid bias differ from their constant inits and are really compared."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rs.randn(*np.shape(x))
                   ).astype(np.float32), params)


def stream_length(opt: dict, char: str) -> int:
    """Rows of one modality's feature stream: the retrieval rows, the 1568
    dense patches of ``feats: SwinBERTDense``'s motion stream (loaded whole,
    ``care_tpu/data/datasets.py``), else the sampled frames."""
    if char == "r":
        return opt["retrieval_topk"]
    if char == "m" and opt.get("feats") == "SwinBERTDense":
        return 1568
    return opt["n_frames"]


def retrieved_ids(opt: dict, batch_size: int, seed: int):
    """The ``t`` stream: ``retrieval_topk`` retrieved captions of
    ``max_len`` token ids per video [B, R, max_len] int32, drawn from a few
    ids so that ids repeat within and across retrievals, each caption
    followed by a PAD tail of its own length."""
    rs = np.random.RandomState(seed)
    shape = (batch_size, opt["retrieval_topk"], opt["max_len"])
    ids = rs.randint(4, min(opt["vocab_size"], 12), shape)
    lengths = rs.randint(2, opt["max_len"] + 1, shape[:2])
    pad = np.arange(opt["max_len"])[None, None, :] >= lengths[:, :, None]
    return np.where(pad, constants.PAD, ids).astype(np.int32)


def synthetic_feats(opt: dict, batch_size: int, seed: int):
    """Per-modality feature streams as numpy arrays (the ``t`` stream's
    token ids by ``retrieved_ids``)."""
    rs = np.random.RandomState(seed)
    return [retrieved_ids(opt, batch_size, seed + 7) if c == "t" else
            rs.randn(batch_size, stream_length(opt, c),
                     opt[f"dim_{c}"]).astype(np.float32)
            for c in opt["modality"]]


def synthetic_batch(opt: dict, batch_size: int, seed: int) -> dict:
    """A training batch as numpy arrays: ``synthetic_feats`` plus token ids,
    labels and multi-hot concept labels (and category ids with
    ``with_category``)."""
    rs = np.random.RandomState(seed + 1000)
    shape = (batch_size, opt["max_len"] - 1)
    batch = {"feats": synthetic_feats(opt, batch_size, seed),
             "input_ids": rs.randint(6, opt["vocab_size"], shape).astype(
                 np.int32),
             "labels": rs.randint(6, opt["vocab_size"], shape).astype(
                 np.int32),
             "labels_attr": rs.randint(
                 0, 2, (batch_size, opt["attribute_prediction_k"])).astype(
                     np.float32)}
    if opt.get("with_category"):
        batch["category"] = rs.randint(
            0, opt["num_category"], (batch_size, 1)).astype(np.int32)
        if opt.get("use_category_embs"):
            batch["category_embs"] = rs.randn(
                batch_size, opt["dim_category"]).astype(np.float32)
    return batch


def randomized_stats(batch_stats, seed: int):
    """BatchNorm running statistics away from their (0, 1) init: means
    plus noise, variances scaled by factors in [0.5, 1.5]."""
    rs = np.random.RandomState(seed)

    def one(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return (x * rs.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        return (x + 0.1 * rs.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, batch_stats)


def flagship_pair(opt: dict, seed: int = 0, jax_opt: dict = None):
    """(jax model, jax variables, port model) sharing randomized weights
    (and BatchNorm running statistics, where the model has them).
    ``jax_opt`` builds the JAX side from other options (say, with its flash
    dispatch off) where the parameters are the same."""
    jmodel = jax_build_captioner(jax_opt or opt)
    batch = synthetic_batch(opt, 2, seed)
    key = jax.random.PRNGKey(seed)
    variables = jmodel.init({"params": key, "dropout": key}, batch,
                            deterministic=True)
    out = {"params": randomized(to_numpy(variables["params"]), seed + 1)}
    if "batch_stats" in variables:
        out["batch_stats"] = randomized_stats(variables["batch_stats"],
                                              seed + 2)
    port = port_build_captioner(opt, device="cpu", seed=seed)
    variables_from_jax(port, out)
    return jmodel, out, port


def tensors(arrays, dtype=torch.float32):
    """Tensors of ``arrays``: floating ones in ``dtype``, integer ones (the
    ``t`` stream's ids) as int64."""
    return [torch.as_tensor(a, dtype=dtype)
            if np.issubdtype(np.asarray(a).dtype, np.floating)
            else torch.as_tensor(np.asarray(a)).long() for a in arrays]


def per_step_logits_jax(jmodel, variables, inputs, seq):
    """The JAX package's next-token logits [B, L, V] over the token
    sequence ``seq`` [B, L], from one full forward: under the causal mask
    position t sees what the forward over the first t + 1 tokens sees (the
    concept-prefix positions of the prefix modes are dropped)."""
    from care_tpu.models.framework import Captioner
    out = jmodel.apply(variables, seq, inputs,
                       method=Captioner.decoding_phase)
    return np.asarray(out["logits"])[:, -seq.shape[1]:]


def per_step_logits_jax_kv(jmodel, variables, inputs, seq, max_len: int):
    """The JAX package's next-token logits [B, L, V] over ``seq`` [B, L]
    by its KV-cached step."""
    import jax.numpy as jnp
    from care_tpu.models.framework import Captioner
    state = jmodel.apply(variables, inputs, max_len,
                         method=Captioner.init_decode_state)
    outs = []
    for t in range(seq.shape[1]):
        logits, state, _ = jmodel.apply(
            variables, seq[:, t], jnp.asarray(t), state, inputs,
            method=Captioner.decode_step)
        outs.append(np.asarray(logits))
    return np.stack(outs, axis=1)


def per_step_logits_port(port, inputs, seq, max_len: int = None):
    """The port's next-token logits [B, L, V] over the token sequence
    ``seq`` [B, L]: by the full forward over every prefix, or, with
    ``max_len``, by the KV-cached step from ``init_decode_state``."""
    outs = []
    with torch.no_grad():
        if max_len is None:
            for t in range(1, seq.shape[1] + 1):
                outs.append(port.decoding_phase(
                    seq[:, :t], inputs, last_time_step_logits=True)["logits"])
        else:
            state = port.init_decode_state(inputs, max_len)
            for t in range(seq.shape[1]):
                logits, state, _ = port.decode_step(seq[:, t], t, state)
                outs.append(logits)
    return torch.stack(outs, dim=1).numpy()


def decoder_inputs(jmodel, variables, port, batch: dict):
    """The decoder inputs of ``batch`` in both packages (the encoding phase
    and the batch's own entries, ``category``)."""
    import jax.numpy as jnp
    from care_tpu.models.framework import Captioner
    aux = {k: batch[k] for k in ("category", "category_embs") if k in batch}
    enc = jmodel.apply(variables, [jnp.asarray(f) for f in batch["feats"]],
                       method=Captioner.encoding_phase)
    jinputs = jmodel.apply(variables, enc,
                           {k: jnp.asarray(v) for k, v in aux.items()},
                           method=Captioner.prepare_inputs_for_decoder)
    with torch.no_grad():
        penc = port.encoding_phase(tensors(batch["feats"]))
    pinputs = port.prepare_inputs_for_decoder(penc, dict(zip(
        aux, tensors(list(aux.values())))))
    return jinputs, pinputs


def token_sequence(opt: dict, batch_size: int, seed: int):
    """[B, max_len - 1] token ids starting with BOS, as numpy int32."""
    rs = np.random.RandomState(seed)
    seq = rs.randint(6, opt["vocab_size"], (batch_size, opt["max_len"] - 1))
    seq[:, 0] = constants.BOS
    return seq.astype(np.int32)
