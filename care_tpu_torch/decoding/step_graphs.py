"""Each beam step of one decode shape run as one CUDA graph.

A fused-head AR decode launches about 170 kernels a beam step, and
launched one by one from Python the launches take several times the
device's work. ``StepGraphs`` keeps, for one model at one shape, the
tensors a step reads and writes at fixed addresses (``static``) and one
CUDA graph per step position ``t``. The first run at a position runs the
step eagerly on a side stream (the warm-up a capture needs) and then
captures it there; every later run at that position replays the capture.
The graphs of one shape share one memory pool: a step's intermediates are
dead when its graph ends, so the graphs may replay in any order.

A replay runs no Python, so the counters a step moves (the kernels'
``*launches``, the caller's step counter) are read around each capture,
and each replay adds what its capture added. Off CUDA a step runs eagerly,
on the same static tensors.
"""

from typing import Callable, Optional, Sequence, Tuple

import torch

from care_tpu_torch.ops import flash_attention, fused_head_topk, fused_xent


def kernel_counters() -> list:
    """(module, name) of every kernel launch counter of the port's ops."""
    return [(mod, name)
            for mod in (flash_attention, fused_head_topk, fused_xent)
            for name, value in vars(mod).items()
            if name.endswith("launches") and type(value) is int]


def copy_tree_(dst, src) -> None:
    """Copy each tensor of ``src`` into the tensor at the same place of
    ``dst``: nested dicts, lists and tuples of tensors or None, of one
    structure and the same shapes."""
    if dst is src:
        return
    if isinstance(dst, dict):
        if not isinstance(src, dict) or dst.keys() != src.keys():
            raise ValueError("static and fresh state differ in their keys")
        for key in dst:
            copy_tree_(dst[key], src[key])
    elif isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(dst) != len(src):
            raise ValueError("static and fresh state differ in length")
        for d, s in zip(dst, src):
            copy_tree_(d, s)
    elif dst is None or src is None:
        raise ValueError("static and fresh state differ in a None")
    elif dst.shape != src.shape:
        raise ValueError(f"static {tuple(dst.shape)} and fresh "
                         f"{tuple(src.shape)} state differ in shape")
    else:
        dst.copy_(src)


class StepGraphs:
    """The static tensors and the per-step CUDA graphs of one decode shape.

    ``counters``: (holder, attribute) of the integer counters a step moves;
    ``on_replay``: called after each replay."""

    def __init__(self, device, counters: Sequence[Tuple[object, str]] = (),
                 on_replay: Optional[Callable[[], None]] = None):
        self.device = torch.device(device)
        self.counters = list(counters)
        self.on_replay = on_replay
        self._static = {}
        self._graphs = {}
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def static(self, name: str, tree):
        """The static tensors kept under ``name``: ``tree`` itself at the
        first call, later ``tree``'s values copied into them."""
        held = self._static.setdefault(name, tree)
        copy_tree_(held, tree)
        return held

    def run(self, t: int, body: Callable[[], None]) -> None:
        """Run ``body``, one step at position ``t`` over the static
        tensors: by a replay of its graph, else eagerly (capturing the
        graph on CUDA)."""
        if self.device.type != "cuda":
            body()
            return
        captured = self._graphs.get(t)
        if captured is None:
            self._graphs[t] = self._capture(body)
            return
        graph, added = captured
        graph.replay()
        for (holder, name), n in zip(self.counters, added):
            setattr(holder, name, getattr(holder, name) + n)
        if self.on_replay is not None:
            self.on_replay()

    def _capture(self, body):
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            body()
            before = [getattr(holder, name) for holder, name in self.counters]
            graph = torch.cuda.CUDAGraph()
            # other threads (a loader's copies) may go on while this one
            # captures
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            body()
            graph.capture_end()
            added = []
            for (holder, name), n in zip(self.counters, before):
                added.append(getattr(holder, name) - n)
                setattr(holder, name, n)
        current.wait_stream(self._stream)
        return graph, added
