/*
 * spfft_tpu native API — C Transform interface.
 *
 * Opaque-handle mirror of the C++ Transform/TransformFloat (reference:
 * include/spfft/transform.h, transform_float.h). Handles are created either
 * grid-less or from an SpfftGrid; all functions return SpfftError.
 *
 * Embedding note: the library runs its compute core in an embedded Python
 * interpreter; loaded into a running Python process it uses that one. The
 * precision of a plan is explicit and changes no process-wide setting.
 */
#ifndef SPFFT_TPU_TRANSFORM_H
#define SPFFT_TPU_TRANSFORM_H

#include <spfft/errors.h>
#include <spfft/grid.h>
#include <spfft/types.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* SpfftTransform;

/* Grid-less creation (reference v1.0 feature). */
SpfftError spfft_transform_create_independent(
    SpfftTransform* transform, int maxNumThreads,
    SpfftProcessingUnitType processingUnit, SpfftTransformType transformType, int dimX,
    int dimY, int dimZ, int numLocalElements, SpfftIndexFormatType indexFormat,
    const int* indices);

/* Creation bound to a grid (reference: include/spfft/transform.h
 * spfft_transform_create). */
SpfftError spfft_transform_create(SpfftTransform* transform, SpfftGrid grid,
                                  SpfftProcessingUnitType processingUnit,
                                  SpfftTransformType transformType, int dimX, int dimY,
                                  int dimZ, int localZLength, int numLocalElements,
                                  SpfftIndexFormatType indexFormat, const int* indices);

SpfftError spfft_transform_destroy(SpfftTransform transform);
SpfftError spfft_transform_clone(SpfftTransform transform, SpfftTransform* newTransform);

SpfftError spfft_transform_backward(SpfftTransform transform, const double* input,
                                    SpfftProcessingUnitType outputLocation);
SpfftError spfft_transform_forward(SpfftTransform transform,
                                   SpfftProcessingUnitType inputLocation, double* output,
                                   SpfftScalingType scaling);
SpfftError spfft_transform_forward_ptr(SpfftTransform transform, const double* input,
                                       double* output, SpfftScalingType scaling);
/* Pointer-output backward: the space-domain slab is also written to
 * ``output`` (reference: transform.h spfft_transform_backward_ptr). */
SpfftError spfft_transform_backward_ptr(SpfftTransform transform, const double* input,
                                        double* output);
SpfftError spfft_transform_get_space_domain(SpfftTransform transform,
                                            SpfftProcessingUnitType dataLocation,
                                            double** data);

SpfftError spfft_transform_type(SpfftTransform transform, SpfftTransformType* type);
SpfftError spfft_transform_dim_x(SpfftTransform transform, int* dimX);
SpfftError spfft_transform_dim_y(SpfftTransform transform, int* dimY);
SpfftError spfft_transform_dim_z(SpfftTransform transform, int* dimZ);
SpfftError spfft_transform_local_z_length(SpfftTransform transform, int* localZLength);
SpfftError spfft_transform_local_z_offset(SpfftTransform transform, int* offset);
SpfftError spfft_transform_local_slice_size(SpfftTransform transform, int* size);
SpfftError spfft_transform_num_local_elements(SpfftTransform transform, int* numLocalElements);
SpfftError spfft_transform_num_global_elements(SpfftTransform transform,
                                               long long int* numGlobalElements);
SpfftError spfft_transform_global_size(SpfftTransform transform, long long int* globalSize);
SpfftError spfft_transform_processing_unit(SpfftTransform transform,
                                           SpfftProcessingUnitType* processingUnit);
SpfftError spfft_transform_device_id(SpfftTransform transform, int* deviceId);
SpfftError spfft_transform_num_threads(SpfftTransform transform, int* numThreads);
SpfftError spfft_transform_execution_mode(SpfftTransform transform, SpfftExecType* mode);
SpfftError spfft_transform_set_execution_mode(SpfftTransform transform, SpfftExecType mode);

/* ---- single precision ---------------------------------------------------- */

typedef void* SpfftFloatTransform;

SpfftError spfft_float_transform_create_independent(
    SpfftFloatTransform* transform, int maxNumThreads,
    SpfftProcessingUnitType processingUnit, SpfftTransformType transformType, int dimX,
    int dimY, int dimZ, int numLocalElements, SpfftIndexFormatType indexFormat,
    const int* indices);

SpfftError spfft_float_transform_create(SpfftFloatTransform* transform, SpfftFloatGrid grid,
                                        SpfftProcessingUnitType processingUnit,
                                        SpfftTransformType transformType, int dimX,
                                        int dimY, int dimZ, int localZLength,
                                        int numLocalElements,
                                        SpfftIndexFormatType indexFormat,
                                        const int* indices);

SpfftError spfft_float_transform_destroy(SpfftFloatTransform transform);
SpfftError spfft_float_transform_clone(SpfftFloatTransform transform,
                                       SpfftFloatTransform* newTransform);

SpfftError spfft_float_transform_backward(SpfftFloatTransform transform,
                                          const float* input,
                                          SpfftProcessingUnitType outputLocation);
SpfftError spfft_float_transform_forward(SpfftFloatTransform transform,
                                         SpfftProcessingUnitType inputLocation,
                                         float* output, SpfftScalingType scaling);
SpfftError spfft_float_transform_forward_ptr(SpfftFloatTransform transform,
                                             const float* input, float* output,
                                             SpfftScalingType scaling);
SpfftError spfft_float_transform_backward_ptr(SpfftFloatTransform transform,
                                              const float* input, float* output);
SpfftError spfft_float_transform_get_space_domain(SpfftFloatTransform transform,
                                                  SpfftProcessingUnitType dataLocation,
                                                  float** data);

SpfftError spfft_float_transform_type(SpfftFloatTransform transform,
                                      SpfftTransformType* type);
SpfftError spfft_float_transform_dim_x(SpfftFloatTransform transform, int* dimX);
SpfftError spfft_float_transform_dim_y(SpfftFloatTransform transform, int* dimY);
SpfftError spfft_float_transform_dim_z(SpfftFloatTransform transform, int* dimZ);
SpfftError spfft_float_transform_local_z_length(SpfftFloatTransform transform,
                                                int* localZLength);
SpfftError spfft_float_transform_local_z_offset(SpfftFloatTransform transform,
                                                int* offset);
SpfftError spfft_float_transform_local_slice_size(SpfftFloatTransform transform,
                                                  int* size);
SpfftError spfft_float_transform_num_local_elements(SpfftFloatTransform transform,
                                                    int* numLocalElements);
SpfftError spfft_float_transform_num_global_elements(SpfftFloatTransform transform,
                                                     long long int* numGlobalElements);
SpfftError spfft_float_transform_global_size(SpfftFloatTransform transform,
                                             long long int* globalSize);
SpfftError spfft_float_transform_processing_unit(SpfftFloatTransform transform,
                                                 SpfftProcessingUnitType* processingUnit);
SpfftError spfft_float_transform_device_id(SpfftFloatTransform transform, int* deviceId);
SpfftError spfft_float_transform_num_threads(SpfftFloatTransform transform,
                                             int* numThreads);
SpfftError spfft_float_transform_execution_mode(SpfftFloatTransform transform,
                                                SpfftExecType* mode);
SpfftError spfft_float_transform_set_execution_mode(SpfftFloatTransform transform,
                                                    SpfftExecType mode);

/* MPI-surface parity stubs (reference: include/spfft/transform.h:122,341 and
 * transform_float.h). No MPI exists in this runtime — the device mesh replaces
 * the communicator (use spfft_grid_create_distributed / the
 * spfft_dist_transform_* surface instead) — so these link and return
 * SPFFT_MPI_SUPPORT_ERROR, exactly what a ported caller can handle.
 * SpfftMpiComm (types.h) is MPI_Comm whenever the caller compiles with MPI. */
SpfftError spfft_transform_create_independent_distributed(
    SpfftTransform* transform, int maxNumThreads, SpfftMpiComm comm,
    SpfftExchangeType exchangeType, SpfftProcessingUnitType processingUnit,
    SpfftTransformType transformType, int dimX, int dimY, int dimZ, int localZLength,
    int numLocalElements, SpfftIndexFormatType indexFormat, const int* indices);
SpfftError spfft_float_transform_create_independent_distributed(
    SpfftFloatTransform* transform, int maxNumThreads, SpfftMpiComm comm,
    SpfftExchangeType exchangeType, SpfftProcessingUnitType processingUnit,
    SpfftTransformType transformType, int dimX, int dimY, int dimZ, int localZLength,
    int numLocalElements, SpfftIndexFormatType indexFormat, const int* indices);
SpfftError spfft_transform_communicator(SpfftTransform transform, SpfftMpiComm* comm);
SpfftError spfft_float_transform_communicator(SpfftFloatTransform transform,
                                              SpfftMpiComm* comm);

/* ---- distributed transforms (single-controller mesh) ----------------------
 * One process drives every shard; per-rank MPI arrays become shard-major
 * concatenated host arrays. Precision is fixed at creation
 * (doublePrecision != 0 -> double entry points, == 0 -> float ones). */

typedef void* SpfftDistTransform;

SpfftError spfft_dist_transform_create(SpfftDistTransform* transform, SpfftGrid grid,
                                       SpfftProcessingUnitType processingUnit,
                                       SpfftTransformType transformType, int dimX,
                                       int dimY, int dimZ, int numShards,
                                       const int* shardNumElements,
                                       SpfftIndexFormatType indexFormat,
                                       const int* indices, int doublePrecision);
/* Grid-less distributed ctor (reference: transform.h
 * spfft_transform_create_independent_distributed, single-controller form:
 * numShards + exchangeType replace the MPI communicator; the capacity
 * envelope a Grid would carry is derived internally). */
SpfftError spfft_dist_transform_create_independent(
    SpfftDistTransform* transform, int maxNumThreads, int numShards,
    SpfftExchangeType exchangeType, SpfftProcessingUnitType processingUnit,
    SpfftTransformType transformType, int dimX, int dimY, int dimZ,
    const int* shardNumElements, SpfftIndexFormatType indexFormat,
    const int* indices, int doublePrecision);
SpfftError spfft_dist_transform_destroy(SpfftDistTransform transform);

/* values: 2 * num_global_elements reals, shard-major complex-interleaved;
 * space: global (dimZ, dimY, dimX) slab (complex for C2C, real for R2C). */
SpfftError spfft_dist_transform_backward(SpfftDistTransform transform,
                                         const double* values, double* space);
SpfftError spfft_float_dist_transform_backward(SpfftDistTransform transform,
                                               const float* values, float* space);
/* space may be NULL to reuse the slabs retained by the last backward. */
SpfftError spfft_dist_transform_forward(SpfftDistTransform transform,
                                        const double* space, double* values,
                                        SpfftScalingType scaling);
SpfftError spfft_float_dist_transform_forward(SpfftDistTransform transform,
                                              const float* space, float* values,
                                              SpfftScalingType scaling);

SpfftError spfft_dist_transform_type(SpfftDistTransform transform,
                                     SpfftTransformType* type);
SpfftError spfft_dist_transform_dim_x(SpfftDistTransform transform, int* dimX);
SpfftError spfft_dist_transform_dim_y(SpfftDistTransform transform, int* dimY);
SpfftError spfft_dist_transform_dim_z(SpfftDistTransform transform, int* dimZ);
SpfftError spfft_dist_transform_num_shards(SpfftDistTransform transform, int* numShards);
SpfftError spfft_dist_transform_num_global_elements(SpfftDistTransform transform,
                                                    long long int* numGlobalElements);
SpfftError spfft_dist_transform_global_size(SpfftDistTransform transform,
                                            long long int* globalSize);
SpfftError spfft_dist_transform_exchange_type(SpfftDistTransform transform,
                                              SpfftExchangeType* exchangeType);
SpfftError spfft_dist_transform_exchange_wire_bytes(SpfftDistTransform transform,
                                                    long long int* wireBytes);
SpfftError spfft_dist_transform_exchange_rounds(SpfftDistTransform transform,
                                                int* rounds);
/* per-shard layout (the reference's per-rank accessors). On 2-D pencil grids
 * the space block is (local_z_length, local_y_length, dimX); on 1-D grids
 * local_y_length == dimY and local_y_offset == 0. */
SpfftError spfft_dist_transform_local_z_length(SpfftDistTransform transform, int shard,
                                               int* localZLength);
SpfftError spfft_dist_transform_local_z_offset(SpfftDistTransform transform, int shard,
                                               int* offset);
SpfftError spfft_dist_transform_local_y_length(SpfftDistTransform transform, int shard,
                                               int* localYLength);
SpfftError spfft_dist_transform_local_y_offset(SpfftDistTransform transform, int shard,
                                               int* offset);
SpfftError spfft_dist_transform_num_local_elements(SpfftDistTransform transform,
                                                   int shard, int* numLocalElements);

#ifdef __cplusplus
}
#endif

#endif /* SPFFT_TPU_TRANSFORM_H */
