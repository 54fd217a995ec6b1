"""Seconds from the process's start to the window's: import, CUDA context, the
plan's build (and, in a new checkout, nvcc), the band data, the warm-up sweep
that captures the CUDA graphs (and, traced, the profiler's first use)."""


def read(ctx):
    return ctx.setup_s
