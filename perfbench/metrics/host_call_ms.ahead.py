"""The host's ms inside backward_pair + forward_pair per pair, over the
window of the traced run (untraced itself; the profiled stretch follows it)."""
from perfbench.readings import host_call_ms


def read(ctx):
    return host_call_ms(ctx.window)
