"""Device ms of the memcpy activities per pair: the fused graphs' copies in
and out (static inputs, cloned outputs)."""
from perfbench.readings import per_pair_ms


def read(ctx):
    return per_pair_ms(ctx.profile, lambda p: p.copy_us())
