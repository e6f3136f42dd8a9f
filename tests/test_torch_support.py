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
from care_tpu_torch.models import build_captioner as port_build_captioner
from care_tpu_torch.models.weights import params_from_jax


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


def synthetic_feats(opt: dict, batch_size: int, seed: int):
    """Per-modality feature streams as numpy arrays."""
    rs = np.random.RandomState(seed)
    return [rs.randn(batch_size, stream_length(opt, c),
                     opt[f"dim_{c}"]).astype(np.float32)
            for c in opt["modality"]]


def synthetic_batch(opt: dict, batch_size: int, seed: int) -> dict:
    """A training batch as numpy arrays: ``synthetic_feats`` plus token ids,
    labels and multi-hot concept labels."""
    rs = np.random.RandomState(seed + 1000)
    shape = (batch_size, opt["max_len"] - 1)
    return {"feats": synthetic_feats(opt, batch_size, seed),
            "input_ids": rs.randint(6, opt["vocab_size"], shape).astype(
                np.int32),
            "labels": rs.randint(6, opt["vocab_size"], shape).astype(np.int32),
            "labels_attr": rs.randint(
                0, 2, (batch_size, opt["attribute_prediction_k"])).astype(
                    np.float32)}


def flagship_pair(opt: dict, seed: int = 0, jax_opt: dict = None):
    """(jax model, jax variables, port model) sharing randomized weights.
    ``jax_opt`` builds the JAX side from other options (say, with its flash
    dispatch off) where the parameters are the same."""
    jmodel = jax_build_captioner(jax_opt or opt)
    batch = synthetic_batch(opt, 2, seed)
    key = jax.random.PRNGKey(seed)
    variables = jmodel.init({"params": key, "dropout": key}, batch,
                            deterministic=True)
    params = randomized(to_numpy(variables["params"]), seed + 1)
    port = port_build_captioner(opt, device="cpu", seed=seed)
    params_from_jax(port, params)
    return jmodel, {"params": params}, port


def tensors(arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]
