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
is given. The static-analysis gate and its companions are run by their
paths, so that neither this package's ``__init__`` nor torch is imported:
``analyze.py`` (the gate and ``--lockdep-check``), ``lint.py`` (checkers
SA001-SA009), ``api_surface.py`` (the C and Fortran surface parsers) and
``gen_api_docs.py`` (``docs/torch/api`` and the tables of
``docs/torch/details.md``)."""
