"""Device ms of K1 (complex_matmul: tc_kernel, dmma_kernel) per pair of the
traced stretch."""
from perfbench.readings import family_ms


def read(ctx):
    return family_ms(ctx.profile, "k1")
