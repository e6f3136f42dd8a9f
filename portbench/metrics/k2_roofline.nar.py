"""K2 (``ops/fused_head_topk.py:vocab_argmax_lse`` ->
``csrc/vocab_argmax_lse.cu``) at the NAR passes' shape: its launches in
the traced window times the least time of one (every word of a batch's
candidates against the vocab head, ``flops_nar.k2_bound_seconds``) over
the device time of its kernels."""

from portbench import flops_nar

LAUNCHES = "ops.fused_head_topk.argmax_lse_launches"
KERNELS = r"xent_stats_tc_kernel|xent_stats_reduce_kernel"


def read(ctx):
    n = ctx.trace_counts.get(LAUNCHES, 0) if ctx.trace else 0
    if not n:
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * n * flops_nar.k2_bound_seconds(ctx.model,
                                                  ctx.shapes) / seconds
