"""Per-process input feeding: the port of ``care_tpu/parallel/input.py``.

Every process computes the same deterministic global batch order (the
loaders seed their shuffling by ``(seed, epoch)``) and keeps a disjoint
contiguous slice of each global batch (:class:`HostShardedBatches`). In the
JAX package a process drives several devices and slices by process; in the
port a process is one device, and the processes of one model group must
read the same rows, so the slice goes by the process's **data**
coordinate and the data size (``process_slice``). ``global_batch_from_local``
puts the local rows on the process's device; a leaf that is not per-row
(a scalar, a per-batch constant) goes there whole.
"""

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from care_tpu_torch.parallel.mesh import Mesh

_DEFAULT_MESH: Optional[Mesh] = None


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """The mesh ``process_slice`` takes its coordinates from by default
    (the trainer sets its own)."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def _data_coordinate():
    if _DEFAULT_MESH is not None:
        return _DEFAULT_MESH.data.rank, _DEFAULT_MESH.data.size
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_slice(global_batch_size: int, process_index: int = None,
                  process_count: int = None) -> slice:
    """The contiguous rows of each global batch this process loads: by
    default those of its data coordinate among the data size."""
    pi, pc = _data_coordinate()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    assert global_batch_size % pc == 0, (global_batch_size, pc)
    per = global_batch_size // pc
    return slice(pi * per, (pi + 1) * per)


def _put(x, device):
    t = torch.from_numpy(np.ascontiguousarray(x))
    if not t.is_floating_point():
        t = t.long()
    return t.to(device, non_blocking=True)


def global_batch_from_local(local_batch: Dict[str, Any], mesh: Mesh,
                            global_batch_size: int = None,
                            device="cpu") -> Dict[str, Any]:
    """Every numeric array of ``local_batch`` (this process's rows, and
    whole the leaves that are not per-row) as a tensor on ``device``,
    integers as int64, the index type; a non-numeric array (video ids)
    stays on the host. ``mesh`` and ``global_batch_size`` are the JAX
    signature's: a process holds its rows only, so nothing is assembled."""
    def place(x):
        x = np.asarray(x)
        return _put(x, device) if x.dtype.kind in "biuf" else x

    def rec(v):
        if isinstance(v, dict):
            return {k: rec(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(rec(x) for x in v)
        return place(v)

    return rec(local_batch)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class HostShardedBatches:
    """Wrap a loader so each process yields only its slice of every global
    batch, on its device.

    ``loader`` must iterate numpy batches of the FULL global batch size in
    a deterministic order shared by all processes; each process keeps rows
    ``process_slice(B)`` of every array whose leading dim is the batch."""

    def __init__(self, loader, mesh: Mesh, device="cpu"):
        self.loader = loader
        self.mesh = mesh
        self.device = device

    @property
    def dataset(self):
        return getattr(self.loader, "dataset", None)

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for batch in self.loader:
            sizes = [np.shape(v)[0] for v in _leaves(batch)
                     if np.ndim(v) >= 1]
            gbs = max(sizes) if sizes else 0
            sl = process_slice(gbs, self.mesh.data.rank, self.mesh.data.size)

            def take(x):
                return (np.asarray(x)[sl] if np.ndim(x) >= 1
                        and np.shape(x)[0] == gbs else x)

            local = _map(take, batch)
            yield global_batch_from_local(local, self.mesh,
                                          global_batch_size=gbs,
                                          device=self.device)
