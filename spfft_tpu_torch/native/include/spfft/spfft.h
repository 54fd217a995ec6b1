/* spfft_tpu native API — umbrella C header (reference: include/spfft/spfft.h).
 *
 * Scope: the reference's full C surface, double and single precision. MPI-only
 * entry points exist as linkable stubs returning SPFFT_MPI_SUPPORT_ERROR;
 * mesh-distributed transforms run single-controller through the
 * spfft_grid_create_distributed / spfft_dist_transform_* surface (one process
 * drives every shard of a shard mesh).
 */
#ifndef SPFFT_TPU_SPFFT_H
#define SPFFT_TPU_SPFFT_H

/* Version of the reference API surface this build mirrors (reference:
 * CMakeLists.txt:2 project VERSION 1.0.2). */
#define SPFFT_VERSION_MAJOR 1
#define SPFFT_VERSION_MINOR 0
#define SPFFT_VERSION_PATCH 2
#define SPFFT_VERSION_STRING "1.0.2-tpu"

#include <spfft/config.h>
#include <spfft/errors.h>
#include <spfft/grid.h>
#include <spfft/grid_float.h>
#include <spfft/multi_transform.h>
#include <spfft/multi_transform_float.h>
#include <spfft/transform.h>
#include <spfft/transform_float.h>
#include <spfft/types.h>

#endif /* SPFFT_TPU_SPFFT_H */
