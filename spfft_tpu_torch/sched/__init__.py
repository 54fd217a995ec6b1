"""spfft_tpu_torch.sched: task graphs of transforms, placed and scheduled.

The port of ``spfft_tpu/sched/``, the split-phase multi-transform
(:mod:`spfft_tpu_torch.multi_transform`) generalised from one batch to
graphs:

1. **Graphs** (:mod:`.graph`): :class:`TaskGraph` nodes are transform
   executions; edges are data dependencies (``after=`` / ``input_from=``)
   and the retained-buffer rule (tasks sharing a plan run in order).
   Cycles and dangling dependencies raise before anything runs.
2. **Placement** (:mod:`.placement`): spec'd tasks (geometry, no plan) get
   a device and a plan from a :class:`PlanPool`, the round-robin width
   tuned through wisdom (``policy="tuned"``) or the model (every device).
3. **Execution** (:mod:`.executor`): :func:`run_graph` keeps up to
   ``SPFFT_TPU_SCHED_INFLIGHT`` tasks in flight and finalizes them in
   completion order (a CUDA event per dispatch); a failed task retries,
   demotes through its plan's ``torch.fft`` reference rung, then resolves
   typed, and its dependents resolve ``upstream_failed``.

The fault sites ``sched.place`` and ``sched.run``, the ``sched`` trace
event and the ``sched_*`` metrics are the JAX package's.
``spfft_tpu_torch.programs.gbench`` measures scheduled against serial
throughput.
"""
from .graph import Task, TaskGraph  # noqa: F401
from .placement import (  # noqa: F401
    PlanPool,
    build_plan,
    default_devices,
    resolve_width,
    workload_key,
)
from .executor import (  # noqa: F401
    DEFAULT_INFLIGHT,
    LADDER_ERRORS,
    OUTCOMES,
    SCHED_INFLIGHT_ENV,
    GraphReport,
    resolve_inflight,
    run_graph,
    run_tasks,
)
