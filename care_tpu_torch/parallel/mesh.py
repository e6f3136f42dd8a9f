"""A ``(data, model)`` mesh over ``torch.distributed``: the port of
``care_tpu/parallel/mesh.py``.

The JAX package runs one program over a ``Mesh`` of devices and lets XLA
insert the collectives its ``NamedSharding`` placements imply. In the port
every device is a process of the default process group, and every
collective is written out:

* ``make_mesh`` lays the processes out over the axes (row-major in the
  shape's axis order, as the JAX mesh reshapes its device list) and makes
  one subgroup per line of each axis; each process keeps its coordinates
  and the two groups its collectives run in;
* ``shard_params`` slices, in place, every ``Linear`` parameter a
  Megatron rule of ``_TP_RULES`` matches to this process's block over
  ``model`` (column parallel: the q/k/v and FFN-in weights split their
  output rows; row parallel: the attention-out and FFN-out weights split
  their input columns; the vocab head and the concept heads split their
  output rows) and tells the modules which of their tensors are split, so
  that their forwards run the collectives of
  ``parallel/tensor_parallel.py``. The ``bias`` of a
  ``CompositionalLinear`` (the q/k/v and FFN-in projections of semantic
  composition) carries a rule's name but stays whole: those maps run
  replicated, where the JAX package lets XLA split that one leaf and
  gather it again;
* ``shard_batch`` keeps this process's rows of a batch over ``data``.

``param_pspec`` keeps the JAX package's three fall-backs to "replicated":
no model axis (or one of size 1), a rule with more dims than the leaf, a
split dim that does not divide.
"""

import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# regex on the '.'-joined parameter name -> (dim of torch's tensor split
# over `model`, rank of the JAX package's PartitionSpec). torch keeps a
# Linear weight as [out, in], the JAX kernel as [in, out]: the JAX
# P(None, model) on a kernel is dim 0 of the weight, P(model, None) dim 1.
_TP_RULES = [
    # attention projections: column parallel (split heads)
    (re.compile(r".*\.(query|key|value)\.weight$"), 0, 2),
    (re.compile(r".*\.(query|key|value)\.bias$"), 0, 1),
    # attention output dense: row parallel
    (re.compile(r".*attention\.dense\.weight$"), 1, 2),
    # FFN: column then row parallel
    (re.compile(r".*\.ffn\.dense1\.weight$"), 0, 2),
    (re.compile(r".*\.ffn\.dense1\.bias$"), 0, 1),
    (re.compile(r".*\.ffn\.dense2\.weight$"), 1, 2),
    # vocab head: column parallel over the vocabulary
    (re.compile(r".*\.tgt_word_prj\.weight$"), 0, 2),
    # concept-detector heads
    (re.compile(r".*\.attribute_heads\..*\.weight$"), 0, 2),
]

# the process groups of every mesh made in this process, by key: modules
# keep an `Axis` (a key and this process's coordinate), which copies and
# pickles where a process group would not
_GROUPS: Dict[int, Optional[dist.ProcessGroup]] = {}


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this process sees it: its ``size``, this process's
    ``rank`` along it, and the key of the group of the processes on its
    line (``group()``; None for an axis of size 1)."""
    name: str
    size: int
    rank: int
    key: int

    def group(self):
        return _GROUPS[self.key]


@dataclass(frozen=True)
class Mesh:
    """``shape`` {axis: size} in layout order; this process's ``rank`` in
    the default group; its ``Axis`` of ``data`` and ``model`` (size 1 when
    the shape leaves that axis out) and of ``all`` the mesh's processes;
    ``root`` the default-group rank of the mesh's first process."""
    shape: Dict[str, int]
    rank: int
    data: Axis
    model: Axis
    all: Axis
    root: int

    @property
    def axis_names(self) -> List[str]:
        return list(self.shape)


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(shape: Optional[Dict[str, int]] = None,
              ranks: Optional[List[int]] = None) -> Optional[Mesh]:
    """The mesh ``shape`` (e.g. {'data': 2, 'model': 2}; default: every
    process on ``data``) over the processes ``ranks`` of the default group
    (default: all of them; the JAX package's ``devices``). The product of
    the shape must equal their number. Every process of the default group
    must call it, since each subgroup is made collectively; a process
    outside ``ranks`` gets None. A world of one process needs no
    initialised group."""
    rank, world = _world()
    members = list(range(world)) if ranks is None else list(ranks)
    if shape is None:
        shape = {DATA_AXIS: len(members)}
    for axis in shape:
        if axis not in (DATA_AXIS, MODEL_AXIS):
            raise ValueError(f"unknown mesh axis `{axis}`")
    sizes = [int(shape[a]) for a in shape]
    n = int(np.prod(sizes))
    if n != len(members):
        what = "the world" if ranks is None else "the ranks given"
        raise ValueError(f"mesh {dict(shape)} holds {n} processes but "
                         f"{what} has {len(members)}")
    layout = np.asarray(members).reshape(sizes)
    mine = {}
    for i, axis in enumerate(shape):
        # every line of the axis: the other coordinates fixed
        for line in np.moveaxis(layout, i, -1).reshape(-1, sizes[i]):
            key = _register(line.tolist(), world)
            if rank in line:
                mine[axis] = Axis(axis, sizes[i],
                                  line.tolist().index(rank), key)
    key = _register(members, world)
    if rank not in members:
        return None
    for axis in (DATA_AXIS, MODEL_AXIS):
        mine.setdefault(axis, Axis(axis, 1, 0, _register([rank], world)))
    return Mesh(dict(shape), rank, mine[DATA_AXIS], mine[MODEL_AXIS],
                Axis("all", len(members), members.index(rank), key),
                members[0])


def _register(ranks: List[int], world: int) -> int:
    """The key of the process group of ``ranks`` (None for one process,
    the default group for all of them); every process of the world makes
    every group, in the same order."""
    key = len(_GROUPS)
    _GROUPS[key] = (None if len(ranks) == 1 else dist.group.WORLD
                    if len(ranks) == world else dist.new_group(ranks))
    return key


def parse_mesh(spec: str) -> Optional[Dict[str, int]]:
    """``"data=2,model=2"`` -> {'data': 2, 'model': 2} (the JAX CLI's
    ``--mesh``); "" -> None."""
    if not spec:
        return None
    shape = {}
    for part in spec.split(","):
        axis, size = part.split("=")
        shape[axis.strip()] = int(size)
    return shape


def param_pspec(name: str, value, mesh: Mesh) -> Optional[int]:
    """The dim of ``value`` (the parameter ``name``) split over ``model``,
    or None when it stays whole on every process."""
    m = mesh.shape.get(MODEL_AXIS, 1)
    if m <= 1:
        return None
    for pattern, dim, spec_rank in _TP_RULES:
        if not pattern.match(name):
            continue
        if spec_rank > value.dim():
            return None
        if value.shape[dim] % m != 0:
            return None
        return dim
    return None


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Slice every ``Linear`` parameter a rule matches to this process's
    block over ``model``, in place (the parameter objects stay), and record
    on each module which of its parameters are split (``_tp_split``: name
    -> dim) and its model axis (``_tp_axis``); every BatchNorm that takes
    batch statistics learns the data axis (``_data_axis``), and every
    module with a ``record_split`` (the attention's heads) is told once the
    cut is made. Returns ``model``."""
    ax = mesh.model
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = param_pspec(name, p, mesh)
            *path, attr = name.split(".")
            module = model.get_submodule(".".join(path))
            if dim is None or not isinstance(module, nn.Linear):
                continue
            n = p.shape[dim] // ax.size
            p.data = p.data.narrow(dim, ax.rank * n, n).clone()
            split = dict(getattr(module, "_tp_split", {}))
            split[attr] = dim
            module._tp_split = split
            module._tp_axis = ax
    for module in model.modules():
        if getattr(module, "SYNC_BATCH_STATS", False):
            module._data_axis = mesh.data
        if hasattr(module, "record_split"):
            module.record_split()
    return model


def is_split(module: nn.Module, attr: str = "weight") -> bool:
    """Whether ``shard_params`` split ``module``'s ``attr``."""
    return attr in getattr(module, "_tp_split", {})


def split_params(model: nn.Module) -> Dict[str, tuple]:
    """name -> (dim, model Axis) of every split parameter of ``model``."""
    out = {}
    for mname, module in model.named_modules():
        for attr, dim in getattr(module, "_tp_split", {}).items():
            out[f"{mname}.{attr}" if mname else attr] = (dim,
                                                         module._tp_axis)
    return out


def model_axis(model: nn.Module) -> Optional[Axis]:
    """The model axis ``model``'s parameters are split over (None when no
    parameter is split)."""
    for module in model.modules():
        ax = getattr(module, "_tp_axis", None)
        if ax is not None and ax.size > 1:
            return ax
    return None


def gather_full(t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The whole tensor of which ``t`` is this process's block along
    ``dim`` (no gradient): an all-reduce into zero-filled slots, the one
    collective gloo offers on CUDA tensors besides broadcast."""
    from care_tpu_torch.parallel.tensor_parallel import all_gather_slots
    return all_gather_slots(t.detach(), dim, ax)


def full_values(model: nn.Module) -> Dict[str, torch.Tensor]:
    """name -> the whole tensor of every parameter (the split ones gathered
    over their axis; collective: every process of the mesh calls it)."""
    split = split_params(model)
    out = {}
    for name, p in model.named_parameters():
        if name in split:
            dim, ax = split[name]
            out[name] = gather_full(p, dim, ax)
        else:
            out[name] = p.detach()
    return out


def local_cut(model: nn.Module):
    """A function (parameter name, whole tensor) -> the block of it this
    process's parameter holds (the tensor itself when it is not split)."""
    split = split_params(model)

    def cut(name, t):
        if name not in split:
            return t
        dim, ax = split[name]
        n = t.shape[dim] // ax.size
        return t.narrow(dim, ax.rank * n, n).contiguous()

    return cut


def local_values(model: nn.Module, full: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``full`` (name -> whole tensor; any other entries pass) with each
    split parameter's entry cut to this process's block."""
    cut = local_cut(model)
    return {name: cut(name, t) for name, t in full.items()}


def _rows(x, mesh: Mesh):
    d = mesh.data.size
    if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1 \
            and x.shape[0] % d == 0:
        n = x.shape[0] // d
        return x[mesh.data.rank * n:(mesh.data.rank + 1) * n]
    return x


def batch_divides(batch, mesh: Mesh) -> bool:
    """Whether ``shard_batch`` splits the rows of ``batch``'s features
    (else every process keeps the whole batch)."""
    feats = batch.get("feats")
    lead = feats[0] if isinstance(feats, (list, tuple)) else feats
    return lead is None or lead.shape[0] % mesh.data.size == 0


def local_rows(batch: dict, mesh: Mesh) -> dict:
    """A host evaluation batch (numpy arrays, lists of ids) cut to this
    process's rows over ``data``: every array and every list as long as the
    batch, the feature streams each; the whole batch when its rows do not
    split."""
    if mesh.data.size == 1 or not batch_divides(batch, mesh):
        return batch
    feats = batch["feats"]
    B = (feats[0] if isinstance(feats, (list, tuple)) else feats).shape[0]
    n = B // mesh.data.size
    sl = slice(mesh.data.rank * n, (mesh.data.rank + 1) * n)

    def take(v):
        if isinstance(v, (np.ndarray, torch.Tensor)):
            return v[sl] if v.ndim >= 1 and v.shape[0] == B else v
        if isinstance(v, (list, tuple)) and v and isinstance(
                v[0], (np.ndarray, torch.Tensor)):
            return type(v)(take(x) for x in v)
        if isinstance(v, (list, tuple)) and len(v) == B:
            return v[sl]
        return v

    return {k: take(v) for k, v in batch.items()}


def shard_batch(batch, mesh: Mesh):
    """This process's rows over ``data`` of every array (numpy or tensor)
    whose leading dim divides by the data size; any other array stays
    whole, as the JAX package's ``P()`` fall-back replicates it (the
    ragged last validation batch)."""
    if mesh.data.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return _rows(batch, mesh)
