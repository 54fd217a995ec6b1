"""Programs of the port, run with ``python -m``: :mod:`.benchmark`, the
reference benchmark harness; :mod:`.bench`, the one-line GFLOP/s figure;
:mod:`.tune` and :mod:`.gbench`, tuning and the scheduler's benchmark;
:mod:`.serve_worker`, :mod:`.loadgen` and :mod:`.fleetstat`, a serving host,
the open-loop load generator and the fleet metrics CLI; and
:mod:`.multihost_smoke`, one rank of a distributed transform over gloo."""
