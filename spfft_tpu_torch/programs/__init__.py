"""Programs of the port, run with ``python -m``, each with a ``main(argv)``:
:mod:`.benchmark`, the reference benchmark harness; :mod:`.bench`, the
one-line GFLOP/s figure; :mod:`.tune` and :mod:`.gbench`, tuning and the
scheduler's benchmark; :mod:`.serve_worker`, :mod:`.loadgen` and
:mod:`.fleetstat`, a serving host, the open-loop load generator and the
fleet metrics CLI; :mod:`.multihost_smoke`, one rank of a distributed
transform over gloo; and the JAX package's diagnostic and benchmark
programs: :mod:`.report` (plan card and metrics), :mod:`.trace` (the flight
recorder), :mod:`.verify` (a verified round trip under fault injection),
:mod:`.profile` (``torch.profiler`` by stage), :mod:`.fbench` (fused
against staged), :mod:`.dbench` (scaling over shard counts),
:mod:`.perf_gate` (the regression gate) and :mod:`.discipline_compare`
(the exchange disciplines). They run on the card unless ``--device cpu``
is given."""
