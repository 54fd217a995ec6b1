"""Programs of the port, run with ``python -m``: :mod:`.benchmark`, the
reference benchmark harness, and :mod:`.bench`, the one-line GFLOP/s figure."""
