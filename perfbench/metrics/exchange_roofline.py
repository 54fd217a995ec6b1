"""The exchange's share of its roofline on rank 0, in %: the bytes its
exchange has to move a pair (`perfbench.shards.exchange_bytes_per_pair`:
each of its sticks' planes that other ranks hold, out in the backward and
back in the forward, complex64) over `exchange_ms_per_pair` at NVLink's
bandwidth a direction (`readings.NVLINK_BYTES_PER_S`)."""
from perfbench.readings import NVLINK_BYTES_PER_S, family_ms


def read(ctx):
    ms = family_ms(ctx.profile, "exchange")
    nbytes = getattr(ctx, "exchange_bytes", None)
    if ms is None or not nbytes:
        return None
    return 100.0 * nbytes / (ms * 1e-3 * NVLINK_BYTES_PER_S)
