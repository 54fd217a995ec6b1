"""The 95th percentile of every pair's latency in the window (CUDA events)."""
from perfbench.readings import latency_ms


def read(ctx):
    return latency_ms(ctx.window, 95)
