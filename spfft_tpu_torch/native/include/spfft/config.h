/*
 * spfft_tpu native API — build configuration (reference: include/spfft/config.h.in,
 * CMake-generated there; static here because this build has exactly one
 * configuration).
 *
 * Feature macros a ported caller may test:
 *  - SPFFT_SINGLE_PRECISION: always on — the float tier (TransformFloat /
 *    GridFloat / spfft_float_*) ships unconditionally (the reference gates it
 *    behind a CMake option).
 *  - SPFFT_CUDA / SPFFT_ROCM / SPFFT_MPI / SPFFT_OMP / SPFFT_GPU_DIRECT:
 *    never defined. The accelerator is a CUDA device driven through the
 *    PyTorch core spfft_tpu_torch (SPFFT_PU_GPU maps to it), distribution
 *    runs over a shard mesh instead of MPI, and threading is owned by the
 *    runtime.
 *  - SPFFT_TIMING: always on — the timing tree is runtime-collected
 *    (spfft_tpu_torch.timing) rather than compile-time gated.
 */
#ifndef SPFFT_CONFIG_H
#define SPFFT_CONFIG_H

#define SPFFT_SINGLE_PRECISION
#define SPFFT_TIMING

#include "spfft/spfft_export.h"

#endif
