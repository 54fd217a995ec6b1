"""Device ms of the exchange (NCCL's kernels, which the group plan's CUDA
graphs hold: the `exchange` family of `kernels.json`) per pair of rank 0's
traced stretch, waits on the peers included."""
from perfbench.readings import family_ms


def read(ctx):
    return family_ms(ctx.profile, "exchange")
