"""The median of every pair's latency in the window, from its backward_pair
call to its forward's completion (CUDA events)."""
from perfbench.readings import latency_ms


def read(ctx):
    return latency_ms(ctx.window, 50)
