/*
 * spfft_tpu native API — C Grid interface.
 *
 * Opaque-handle mirror of the C++ Grid (reference: include/spfft/grid.h).
 * Every function returns an SpfftError; out-parameters carry results.
 */
#ifndef SPFFT_TPU_GRID_H
#define SPFFT_TPU_GRID_H

#include <spfft/errors.h>
#include <spfft/types.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* SpfftGrid;

SpfftError spfft_grid_create(SpfftGrid* grid, int maxDimX, int maxDimY, int maxDimZ,
                             int maxNumLocalZColumns,
                             SpfftProcessingUnitType processingUnit, int maxNumThreads);

/* Distributed grid over a device mesh (the reference's MPI ctor in
 * single-controller form: one process drives all numShards mesh shards; the
 * mesh size replaces the MPI communicator). The shards of an SPFFT_PU_HOST
 * grid sit stacked on the CPU, those of an SPFFT_PU_GPU grid on the current
 * CUDA device. */
SpfftError spfft_grid_create_distributed(SpfftGrid* grid, int maxDimX, int maxDimY,
                                         int maxDimZ, int maxNumLocalZColumns,
                                         int maxLocalZLength, int numShards,
                                         SpfftExchangeType exchangeType,
                                         SpfftProcessingUnitType processingUnit,
                                         int maxNumThreads);

/* 2-D pencil mesh (p1 x p2 shards; z-slabs x y-slabs in space — lifts the
 * slab decomposition's P <= dimZ cap). Transforms created from this grid use
 * the same spfft_dist_transform_* surface; per-shard space blocks are
 * (local_z_length, local_y_length, dimX). */
SpfftError spfft_grid_create_distributed2(SpfftGrid* grid, int maxDimX, int maxDimY,
                                          int maxDimZ, int maxNumLocalZColumns,
                                          int maxLocalZLength, int p1, int p2,
                                          SpfftExchangeType exchangeType,
                                          SpfftProcessingUnitType processingUnit,
                                          int maxNumThreads);

SpfftError spfft_grid_destroy(SpfftGrid grid);

SpfftError spfft_grid_max_dim_x(SpfftGrid grid, int* dimX);
SpfftError spfft_grid_max_dim_y(SpfftGrid grid, int* dimY);
SpfftError spfft_grid_max_dim_z(SpfftGrid grid, int* dimZ);
SpfftError spfft_grid_max_num_local_z_columns(SpfftGrid grid, int* maxNumLocalZColumns);
SpfftError spfft_grid_max_local_z_length(SpfftGrid grid, int* maxLocalZLength);
SpfftError spfft_grid_processing_unit(SpfftGrid grid,
                                      SpfftProcessingUnitType* processingUnit);
SpfftError spfft_grid_device_id(SpfftGrid grid, int* deviceId);
SpfftError spfft_grid_num_threads(SpfftGrid grid, int* numThreads);
/* 1 for local grids; the mesh size for distributed ones. */
SpfftError spfft_grid_num_shards(SpfftGrid grid, int* numShards);

/* Single-precision grid — same capacity object (see grid.hpp). The full
 * reference float surface (reference: include/spfft/grid_float.h:30-190) is
 * mirrored so GridFloat callers recompile unchanged; precision itself lives
 * on the Transform in this build. */
typedef void* SpfftFloatGrid;

SpfftError spfft_float_grid_create(SpfftFloatGrid* grid, int maxDimX, int maxDimY,
                                   int maxDimZ, int maxNumLocalZColumns,
                                   SpfftProcessingUnitType processingUnit,
                                   int maxNumThreads);

SpfftError spfft_float_grid_create_distributed(SpfftFloatGrid* grid, int maxDimX,
                                               int maxDimY, int maxDimZ,
                                               int maxNumLocalZColumns,
                                               int maxLocalZLength, int numShards,
                                               SpfftExchangeType exchangeType,
                                               SpfftProcessingUnitType processingUnit,
                                               int maxNumThreads);

SpfftError spfft_float_grid_destroy(SpfftFloatGrid grid);

SpfftError spfft_float_grid_max_dim_x(SpfftFloatGrid grid, int* dimX);
SpfftError spfft_float_grid_max_dim_y(SpfftFloatGrid grid, int* dimY);
SpfftError spfft_float_grid_max_dim_z(SpfftFloatGrid grid, int* dimZ);
SpfftError spfft_float_grid_max_num_local_z_columns(SpfftFloatGrid grid,
                                                    int* maxNumLocalZColumns);
SpfftError spfft_float_grid_max_local_z_length(SpfftFloatGrid grid,
                                               int* maxLocalZLength);
SpfftError spfft_float_grid_processing_unit(SpfftFloatGrid grid,
                                            SpfftProcessingUnitType* processingUnit);
SpfftError spfft_float_grid_device_id(SpfftFloatGrid grid, int* deviceId);
SpfftError spfft_float_grid_num_threads(SpfftFloatGrid grid, int* numThreads);

/* Communicator accessors (reference: include/spfft/grid.h:184,
 * grid_float.h:190). This runtime has no MPI — the device mesh replaces the
 * communicator (docs/api/c_api.md) — so these are linkable stubs returning
 * SPFFT_MPI_SUPPORT_ERROR: a ported MPI caller links and gets a clean error
 * instead of a build failure. SpfftMpiComm (types.h) is MPI_Comm whenever the
 * caller compiles with MPI, so reference call sites compile unchanged. */
SpfftError spfft_grid_communicator(SpfftGrid grid, SpfftMpiComm* comm);
SpfftError spfft_float_grid_communicator(SpfftFloatGrid grid, SpfftMpiComm* comm);

#ifdef __cplusplus
}
#endif

#endif /* SPFFT_TPU_GRID_H */
