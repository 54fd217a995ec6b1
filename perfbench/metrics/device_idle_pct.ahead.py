"""The share of the traced stretch in which nothing ran on the device:
1 - (union of kernel, memcpy and memset intervals) / the stretch."""
from perfbench.readings import idle_pct


def read(ctx):
    return idle_pct(ctx.profile)
