"""K1 (``ops/fused_head_topk.py`` -> ``csrc/fused_head_topk.cu``): the least
time of its launches in the window (vocab projection and beam top-k at the
call's shapes, ``flops.k1_head_topk``) over their device time."""

from portbench import flops

LAUNCHES = "ops.fused_head_topk.launches"
KERNELS = r"head_stats_tc_kernel|(^|[\s:])merge_kernel\b"


def read(ctx):
    n = ctx.trace_counts.get(LAUNCHES, 0) if ctx.trace else 0
    if not n:
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    m, sh = ctx.model, ctx.shapes
    work = flops.k1_head_topk(sh["batch"] * sh["beam"], m["dim_hidden"],
                              m["vocab_size"], sh["beam"])
    return 100.0 * n * flops.bound_seconds(*work)[0] / seconds
