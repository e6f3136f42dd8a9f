"""Checkpointing: metric-monitored top-k checkpoints + last, carrying the
full ``opt`` dict, and the train state a run resumes from.

Port of ``care_tpu/training/checkpoints.py`` (reference ``train.py:18-27,
76-96``: ``CheckpointCallback`` suppresses saving before
``start_saving_epoch``, monitors CIDEr by default, keeps top-k + last, and
file names embed metric values; ``models/Wrapper.py:27``: the opt dict is
persisted beside the weights so reloading rebuilds the exact model).

Format: ``torch.save`` of the variables tree, a nested dict of CPU tensors
under the flax tree's names and layouts (``models/weights.py``:
``variables_to_jax(model)``, the ``params`` and any ``batch_stats``), plus
the same side-car JSON as the JAX package (``{"opt", "metadata"}``).
``load_checkpoint`` also reads a checkpoint that ``care_tpu`` saved (flax's
msgpack of the same tree), told apart by its first bytes, so that a model
trained with the JAX package loads and serves in the port.
"""

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {str(k): _to_tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)).clone()


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, variables: Dict[str, Any], opt: dict,
                    metadata: Optional[dict] = None):
    """``variables``: a nested dict of arrays or tensors (the flax
    ``{"params": ...}`` tree)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _atomic_save(_to_tensors(variables), path)
    meta = {"opt": _jsonable(opt), "metadata": metadata or {}}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _check_like(tree, template, path=""):
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"checkpoint tree differs from the template at "
                             f"`{path or '/'}`")
        for k in template:
            _check_like(tree[k], template[k], f"{path}/{k}")
    elif tuple(np.shape(tree)) != tuple(np.shape(template)):
        raise ValueError(f"`{path}`: checkpoint shape {np.shape(tree)} != "
                         f"template shape {np.shape(template)}")


# flax's msgpack extension types of an array and a numpy scalar
# (``flax/serialization.py:_MsgpackExtType``)
_MSGPACK_NDARRAY, _MSGPACK_NPSCALAR = 1, 3


def _is_msgpack(head: bytes) -> bool:
    """Whether a checkpoint's first bytes open a msgpack map, the top of
    the tree ``care_tpu`` saves (a fixmap of 1-15 entries, a map16 or a
    map32). A ``torch.save`` file opens a zip archive (``PK``) or, in the
    legacy format, a pickle (``0x80``)."""
    return bool(head) and (0x81 <= head[0] <= 0x8f or head[0] in (0xde,
                                                                  0xdf))


def read_msgpack_variables(data: bytes) -> Dict[str, Any]:
    """The variables tree of a ``care_tpu`` checkpoint (flax's
    ``serialization.to_bytes``) as nested numpy arrays. Needs the
    ``msgpack`` package."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading a care_tpu (msgpack) checkpoint needs "
                          "the msgpack package, which is not installed"
                          ) from e

    def ext_hook(code, payload):
        if code not in (_MSGPACK_NDARRAY, _MSGPACK_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype_name, buffer = msgpack.unpackb(payload, raw=True)
        array = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                              ).reshape(shape).copy()
        return array if code == _MSGPACK_NDARRAY else array[()]

    return msgpack.unpackb(data, ext_hook=ext_hook, raw=False)


def load_checkpoint(path: str, variables_template: Dict[str, Any] = None
                    ) -> Tuple[Dict[str, Any], dict, dict]:
    """Returns (variables, opt, metadata); variables as nested numpy
    arrays. The file is the port's (``torch.save``) or ``care_tpu``'s
    (msgpack), told apart by its first bytes. A template (a nested dict of
    arrays) must have the same tree and shapes, or this raises."""
    with open(path, "rb") as f:
        head = f.read(1)
        if _is_msgpack(head):
            variables = read_msgpack_variables(head + f.read())
        else:
            variables = None
    if variables is None:
        variables = _to_numpy(torch.load(path, map_location="cpu",
                                         weights_only=True))
    if variables_template is not None:
        _check_like(variables, variables_template)
    meta_path = path + ".json"
    opt, metadata = {}, {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        opt = meta.get("opt", {})
        metadata = meta.get("metadata", {})
    return variables, opt, metadata


def _jsonable(d):
    def conv(v):
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, dict):
            return {str(k): conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, (str, int, float, bool)) or v is None:
            return v
        return str(v)
    return conv(d)


class CheckpointManager:
    """Top-k + last checkpoint manager with a monitored metric."""

    def __init__(self, ckpt_dir: str, monitor_metric: str = "CIDEr",
                 monitor_mode: str = "max", save_topk: int = 1,
                 start_saving_epoch: int = 0):
        self.ckpt_dir = ckpt_dir
        self.monitor_metric = monitor_metric
        self.monitor_mode = monitor_mode
        self.save_topk = save_topk
        self.start_saving_epoch = start_saving_epoch
        self.topk: List[Tuple[float, str]] = []   # (metric, path)
        os.makedirs(ckpt_dir, exist_ok=True)

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.monitor_mode == "max" else a < b

    def on_epoch_end(self, epoch: int, variables, opt, scores: dict):
        metric = float(scores.get(self.monitor_metric, float("-inf")))
        meta = {"epoch": epoch, "scores": _jsonable(scores)}
        # always refresh `last`
        save_checkpoint(os.path.join(self.ckpt_dir, "last.ckpt"),
                        variables, opt, meta)
        if epoch < self.start_saving_epoch:
            return

        name = f"epoch={epoch}_{self.monitor_metric}={metric:.4f}.ckpt"
        path = os.path.join(self.ckpt_dir, name)
        if len(self.topk) < self.save_topk:
            save_checkpoint(path, variables, opt, meta)
            self.topk.append((metric, path))
        else:
            worst = min(self.topk)[0] if self.monitor_mode == "max" \
                else max(self.topk)[0]
            if self._better(metric, worst):
                # drop the worst
                idx = min(range(len(self.topk)),
                          key=lambda i: self.topk[i][0]
                          if self.monitor_mode == "max"
                          else -self.topk[i][0])
                _, old_path = self.topk.pop(idx)
                for p in (old_path, old_path + ".json"):
                    if os.path.exists(p):
                        os.remove(p)
                save_checkpoint(path, variables, opt, meta)
                self.topk.append((metric, path))

        # refresh the copy of the best
        if self.topk:
            best = max(self.topk)[1] if self.monitor_mode == "max" \
                else min(self.topk)[1]
            best_target = os.path.join(self.ckpt_dir, "best.ckpt")
            shutil.copyfile(best, best_target)
            if os.path.exists(best + ".json"):
                shutil.copyfile(best + ".json", best_target + ".json")

    @property
    def best_path(self) -> Optional[str]:
        p = os.path.join(self.ckpt_dir, "best.ckpt")
        return p if os.path.exists(p) else None

    def state_dict(self) -> dict:
        return {"topk": [[m, p] for m, p in self.topk]}

    def load_state_dict(self, state: dict) -> None:
        self.topk = [(float(m), p) for m, p in state.get("topk", [])]


class TrainStateCheckpointer:
    """Mid-run train-state save and restore (the JAX package saves it with
    Orbax): one ``epoch=<e>.pt`` file per saved epoch under ``state_dir``,
    a ``torch.save`` of ``{"state": ..., "meta": ...}``, where the state
    holds tensors (model, optimizer and generator state) and the meta the
    epoch's bookkeeping as JSON-able values. Keeps the ``max_to_keep``
    newest epochs."""

    def __init__(self, state_dir: str, max_to_keep: int = 1):
        self.state_dir = os.path.abspath(state_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.state_dir, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.state_dir, f"epoch={epoch}.pt")

    def epochs(self) -> List[int]:
        out = []
        for name in os.listdir(self.state_dir):
            if name.startswith("epoch=") and name.endswith(".pt"):
                out.append(int(name[len("epoch="):-len(".pt")]))
        return sorted(out)

    def save(self, epoch: int, state_tree: Dict[str, Any], meta: dict):
        _atomic_save({"state": state_tree, "meta": _jsonable(meta)},
                     self._path(epoch))
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def _load(self, epoch: int) -> dict:
        return torch.load(self._path(epoch), map_location="cpu",
                          weights_only=True)

    def restore_meta(self, epoch: int) -> dict:
        return self._load(epoch)["meta"]

    def restore_state(self, epoch: int) -> Dict[str, Any]:
        """The saved state tree, tensors on the CPU."""
        return self._load(epoch)["state"]
