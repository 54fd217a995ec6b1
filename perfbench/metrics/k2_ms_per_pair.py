"""Device ms of K2 (row_gather_kernel) per pair of the traced stretch."""
from perfbench.readings import family_ms


def read(ctx):
    return family_ms(ctx.profile, "k2")
