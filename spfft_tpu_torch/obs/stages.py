"""The canonical pipeline stage names, the JAX package's ``STAGES``
(``spfft_tpu/obs/stages.py``), the same literal tuple.

The stage-graph nodes carry these labels (:data:`spfft_tpu_torch.ir.NODES`
is the pipeline part of it); on the staged path each node runs under
``timing.trace_annotation(<its stage>)``, so a ``torch.profiler`` trace
names per-stage device time as a ``jax.profiler`` trace of the JAX package
does; and the perf report (:mod:`.perf`) attributes pair time to them. The
"A"/"B" labels are the pencil engines' two exchanges; the tuning phases
range a trial's round trips (:mod:`spfft_tpu_torch.tuning.runner`); the
"overlapped" exchange labels are the OVERLAPPED exchange's chunk
collectives, which run on a side stream (:mod:`spfft_tpu_torch.ir.compile`).
"""
from __future__ import annotations

STAGES = (
    # sparse value pack/unpack (reference: compression_host.hpp)
    "compression",
    # R2C hermitian completions (reference: symmetry_host.hpp)
    "stick symmetry",
    "plane symmetry",
    # DFT stages
    "z transform",
    "y transform",          # dense y-DFT
    "y transform sparse",   # per-slot sparse-y contraction
    "y transform blocked",  # blocked sparse-y buckets
    "x transform",
    # local stick -> plane relayout (the accelerator engine)
    "expand",
    # 1-D slab exchange phases (reference: transpose_mpi_*_host.cpp)
    "pack",
    "exchange",
    "unpack",
    # 2-D pencil engine: exchange A and exchange B
    "pack A",
    "exchange A",
    "unpack A",
    "pack B",
    "exchange B",
    "unpack B",
    # OVERLAPPED exchange discipline (overlap chunks > 1)
    "exchange overlapped",
    "exchange A overlapped",
    "exchange B overlapped",
    # autotuner trial phases
    "tune warmup",
    "tune trial",
)
