"""K4a (``ops/flash_attention.py`` -> ``csrc/flash_attention_fwd.cu``) at
the decode shape: the least time of its launches in the window (the KV-
cached cross attention of the beams over every key, ``flops.k4a_decode``)
over their device time."""

from portbench import flops

LAUNCHES = "ops.flash_attention.fwd_launches"
KERNELS = r"flash_fwd_decode_kernel|flash_fwd_kernel"


def read(ctx):
    n = ctx.trace_counts.get(LAUNCHES, 0) if ctx.trace else 0
    if not n:
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    m, sh = ctx.model, ctx.shapes
    heads = m["num_attention_heads"]
    work = flops.k4a_decode(sh["batch"], heads, sh["beam"],
                            m["cross_attention_keys"],
                            m["dim_hidden"] // heads)
    return 100.0 * n * flops.bound_seconds(*work)[0] / seconds
