"""The 95th percentile of every video's latency in the window, from the
start of its feature copy to its caption on the host."""

from portbench import stats


def read(ctx):
    return 1e3 * stats.p95(ctx.samples["latencies_s"])
