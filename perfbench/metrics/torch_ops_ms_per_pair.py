"""Device ms of every kernel of no named family (the plain tensor code:
compression, the hermitian fills, scaling) and of the memsets, per pair; not
the harness's own multiply by V(r) (the `harness` family of `trace.py`)."""
from perfbench.readings import per_pair_ms


def read(ctx):
    return per_pair_ms(ctx.profile, lambda p: p.other_us())
