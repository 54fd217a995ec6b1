"""What the autotuner may try: the port of ``spfft_tpu/tuning/candidates.py``.

Every candidate is a JSON-plain dict: a ``label`` (what wisdom and the trial
tables store) and the constructor facts a trial builder needs
(``exchange_type`` and ``overlap`` on a mesh; ``engine`` and ``env``
overrides locally; ``width`` for scheduler placement; ``batch`` for the
fused batch size). Labels and order are the JAX package's, the OVERLAPPED
``BUFFERED/ovC`` exchange variants included: the tuner, not a constant,
owns the exchange's chunk count unless the caller pins it.
"""
from __future__ import annotations

import numpy as np

# Chunk counts of the OVERLAPPED exchange that the tuner tries when the
# caller leaves the knob to it (overlap=None): past a handful of chunks the
# hideable exchange time saturates at (C-1)/C of min(exchange, compute).
OVERLAP_CANDIDATE_CHUNKS = (2, 4)


def exchange_candidates(num_sticks_per_shard=None, local_z_lengths=None, *,
                        wire_scalar_bytes: int = 4, pencil2: bool = False,
                        overlap=None) -> list:
    """Exchange-discipline candidates of a mesh plan.

    On a slab mesh each carries ``model_cost_bytes``, the JAX package's
    model cost with its one-shot exchange: the wire bytes plus one collective
    round's latency (``ROUND_COST_BYTES``) for each of the discipline's
    rounds in the JAX package (COMPACT_BUFFERED's chain ``P - 1``, the
    others one, ``BUFFERED/ovC`` C), and the list is ordered by it. The
    port's own DEFAULT rule weighs wire bytes alone (``parallel/policy.py``);
    the costs here only order the trials. A pencil mesh's candidates come in
    enum order (its cost model lives in the engine, ``parallel/pencil2.py``).
    ``overlap=None`` adds the OVERLAPPED variants of the padded discipline
    (``BUFFERED/ovC`` for C in :data:`OVERLAP_CANDIDATE_CHUNKS`); an integer
    pins every candidate at that chunk count and drops them."""
    from ..parallel.pencil2 import ROUND_COST_BYTES
    from ..parallel.policy import discipline_volumes
    from ..types import ExchangeType

    disciplines = (ExchangeType.BUFFERED, ExchangeType.COMPACT_BUFFERED,
                   ExchangeType.UNBUFFERED)
    pinned = None if overlap is None else int(overlap)
    chunked = [] if pinned is not None else [
        {"label": f"BUFFERED/ov{c}", "exchange_type": ExchangeType.BUFFERED.name,
         "overlap": int(c)} for c in OVERLAP_CANDIDATE_CHUNKS]
    if pencil2 or num_sticks_per_shard is None:
        return [{"label": d.name, "exchange_type": d.name, "overlap": pinned or 1}
                for d in disciplines] + chunked
    volumes = discipline_volumes(num_sticks_per_shard, local_z_lengths)
    P = len(num_sticks_per_shard)
    rounds = {d: max(1, P - 1) if d == ExchangeType.COMPACT_BUFFERED else 1
              for d in disciplines}
    cost = lambda d, n: int(volumes[d] * 2 * wire_scalar_bytes + n * ROUND_COST_BYTES)
    cands = [{"label": d.name, "exchange_type": d.name, "overlap": pinned or 1,
              "model_cost_bytes": cost(d, rounds[d])} for d in disciplines]
    cands += [dict(c, model_cost_bytes=cost(ExchangeType.BUFFERED, c["overlap"]))
              for c in chunked]
    return sorted(cands, key=lambda c: c["model_cost_bytes"])


def sched_candidates(num_devices: int) -> list:
    """Placement-width candidates of the task-graph scheduler: powers of two
    up to the device count, and the count itself (``rr<width>``)."""
    n = max(1, int(num_devices))
    widths, w = [], 1
    while w <= n:
        widths.append(w)
        w *= 2
    if widths[-1] != n:
        widths.append(n)
    return [{"label": f"rr{w}", "width": int(w)} for w in widths]


# Fused batch sizes the batch axis tries: 1 (per-request dispatch) and small
# powers of two, capped by the batcher's bound.
BATCH_CANDIDATE_SIZES = (1, 4, 8)


def batch_candidates(batch_max=None) -> list:
    """Fused-batch-size candidates (``fused/bN``), capped by ``batch_max``."""
    sizes = [b for b in BATCH_CANDIDATE_SIZES if batch_max is None or b <= int(batch_max)]
    return [{"label": f"fused/b{b}", "batch": int(b)} for b in sizes or [1]]


def local_candidates(platform: str, dtype=None, fuse=None, precision: str = "highest") -> list:
    """Local-plan candidates: the matrix-product engine under the sparse-y
    auto knobs, forced dense, staged, and with bfloat16 DFT matrices
    (``mxu/bf16-twiddle``, ``SPFFT_TPU_TWIDDLE_BF16``: K1's ``"highest-bf16"``
    form); the ``torch.fft`` engine fused and staged. ``platform`` orders the
    list (``"cpu"``: ``torch.fft`` first). ``mxu/bf16-twiddle`` is a
    candidate of float32 ``"highest"`` plans only: elsewhere the knob runs
    the ``mxu`` kernels on rounded matrices, and a noise win would keep a
    less accurate plan (the JAX package drops it from float64 plans for that
    reason). An explicit ``fuse`` pins the fusion axis: the candidates that
    set ``SPFFT_TPU_FUSE`` go, since the kwarg would override their env while
    their label claimed it."""
    bf16 = (dtype is None or np.dtype(dtype) == np.dtype(np.float32)) and precision == "highest"
    mxu = [
        {"label": "mxu", "engine": "mxu", "env": {}},
        {"label": "mxu/dense-y", "engine": "mxu",
         "env": {"SPFFT_TPU_SPARSE_Y": "0", "SPFFT_TPU_SPARSE_Y_BLOCKS": "0"}},
        {"label": "mxu/staged", "engine": "mxu", "env": {"SPFFT_TPU_FUSE": "0"}},
    ]
    if bf16:
        mxu.append({"label": "mxu/bf16-twiddle", "engine": "mxu",
                    "env": {"SPFFT_TPU_TWIDDLE_BF16": "1"}})
    xla = [
        {"label": "xla", "engine": "xla", "env": {}},
        {"label": "xla/staged", "engine": "xla", "env": {"SPFFT_TPU_FUSE": "0"}},
    ]
    cands = xla + mxu if platform == "cpu" else mxu + xla
    if fuse is not None:
        cands = [c for c in cands if "SPFFT_TPU_FUSE" not in c["env"]]
    return cands
