/*
 * spfft_tpu_torch native API — extern-C handle functions.
 *
 * Same discipline as the reference C API (reference: src/spfft/transform.cpp:178+,
 * grid.cpp): handles are heap-allocated C++ objects behind void*, every entry
 * point is try/catch translating GenericError -> error_code and anything else
 * -> SPFFT_UNKNOWN_ERROR.
 */
#include <spfft/spfft.h>
#include <spfft/spfft.hpp>

#include <new>
#include <vector>

namespace {

template <typename Fn> SpfftError guarded(Fn&& fn) {
  try {
    fn();
  } catch (const spfft::GenericError& e) {
    return e.error_code();
  } catch (...) {
    return SPFFT_UNKNOWN_ERROR;
  }
  return SPFFT_SUCCESS;
}

spfft::Grid* as_grid(SpfftGrid h) { return static_cast<spfft::Grid*>(h); }
spfft::Transform* as_transform(SpfftTransform h) {
  return static_cast<spfft::Transform*>(h);
}
spfft::TransformFloat* as_float_transform(SpfftFloatTransform h) {
  return static_cast<spfft::TransformFloat*>(h);
}
spfft::DistributedTransform* as_dist_transform(SpfftDistTransform h) {
  return static_cast<spfft::DistributedTransform*>(h);
}

} // namespace

extern "C" {

/* ---- grid ----------------------------------------------------------------- */

SpfftError spfft_grid_create(SpfftGrid* grid, int maxDimX, int maxDimY, int maxDimZ,
                             int maxNumLocalZColumns,
                             SpfftProcessingUnitType processingUnit, int maxNumThreads) {
  if (grid == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    *grid = new spfft::Grid(maxDimX, maxDimY, maxDimZ, maxNumLocalZColumns,
                            processingUnit, maxNumThreads);
  });
}

SpfftError spfft_float_grid_create(SpfftFloatGrid* grid, int maxDimX, int maxDimY,
                                   int maxDimZ, int maxNumLocalZColumns,
                                   SpfftProcessingUnitType processingUnit,
                                   int maxNumThreads) {
  return spfft_grid_create(grid, maxDimX, maxDimY, maxDimZ, maxNumLocalZColumns,
                           processingUnit, maxNumThreads);
}

SpfftError spfft_grid_create_distributed(SpfftGrid* grid, int maxDimX, int maxDimY,
                                         int maxDimZ, int maxNumLocalZColumns,
                                         int maxLocalZLength, int numShards,
                                         SpfftExchangeType exchangeType,
                                         SpfftProcessingUnitType processingUnit,
                                         int maxNumThreads) {
  if (grid == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    *grid = new spfft::Grid(maxDimX, maxDimY, maxDimZ, maxNumLocalZColumns,
                            maxLocalZLength, numShards, exchangeType, processingUnit,
                            maxNumThreads);
  });
}

SpfftError spfft_grid_create_distributed2(SpfftGrid* grid, int maxDimX, int maxDimY,
                                          int maxDimZ, int maxNumLocalZColumns,
                                          int maxLocalZLength, int p1, int p2,
                                          SpfftExchangeType exchangeType,
                                          SpfftProcessingUnitType processingUnit,
                                          int maxNumThreads) {
  if (grid == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    *grid = new spfft::Grid(maxDimX, maxDimY, maxDimZ, maxNumLocalZColumns,
                            maxLocalZLength, p1, p2, exchangeType, processingUnit,
                            maxNumThreads);
  });
}

SpfftError spfft_grid_destroy(SpfftGrid grid) {
  if (grid == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { delete as_grid(grid); });
}

#define SPFFT_TPU_GRID_GETTER(FN, OUT_T, METHOD)                                         \
  SpfftError FN(SpfftGrid grid, OUT_T* out) {                                            \
    if (grid == nullptr || out == nullptr) return SPFFT_INVALID_HANDLE_ERROR;            \
    return guarded([&] { *out = as_grid(grid)->METHOD(); });                             \
  }

SPFFT_TPU_GRID_GETTER(spfft_grid_max_dim_x, int, max_dim_x)
SPFFT_TPU_GRID_GETTER(spfft_grid_max_dim_y, int, max_dim_y)
SPFFT_TPU_GRID_GETTER(spfft_grid_max_dim_z, int, max_dim_z)
SPFFT_TPU_GRID_GETTER(spfft_grid_max_num_local_z_columns, int, max_num_local_z_columns)
SPFFT_TPU_GRID_GETTER(spfft_grid_max_local_z_length, int, max_local_z_length)
SPFFT_TPU_GRID_GETTER(spfft_grid_processing_unit, SpfftProcessingUnitType,
                      processing_unit)
SPFFT_TPU_GRID_GETTER(spfft_grid_device_id, int, device_id)
SPFFT_TPU_GRID_GETTER(spfft_grid_num_threads, int, max_num_threads)
SPFFT_TPU_GRID_GETTER(spfft_grid_num_shards, int, num_shards)

#undef SPFFT_TPU_GRID_GETTER

/* ---- grid (float tier) ----------------------------------------------------
 * GridFloat is the same capacity object (precision lives on the Transform,
 * grid.hpp); the full reference surface (reference: include/spfft/
 * grid_float.h:30-190, instantiated in src/spfft/grid_float.cpp) delegates. */

SpfftError spfft_float_grid_create_distributed(SpfftFloatGrid* grid, int maxDimX,
                                               int maxDimY, int maxDimZ,
                                               int maxNumLocalZColumns,
                                               int maxLocalZLength, int numShards,
                                               SpfftExchangeType exchangeType,
                                               SpfftProcessingUnitType processingUnit,
                                               int maxNumThreads) {
  return spfft_grid_create_distributed(grid, maxDimX, maxDimY, maxDimZ,
                                       maxNumLocalZColumns, maxLocalZLength, numShards,
                                       exchangeType, processingUnit, maxNumThreads);
}

SpfftError spfft_float_grid_destroy(SpfftFloatGrid grid) {
  return spfft_grid_destroy(grid);
}

SpfftError spfft_float_grid_max_dim_x(SpfftFloatGrid grid, int* dimX) {
  return spfft_grid_max_dim_x(grid, dimX);
}
SpfftError spfft_float_grid_max_dim_y(SpfftFloatGrid grid, int* dimY) {
  return spfft_grid_max_dim_y(grid, dimY);
}
SpfftError spfft_float_grid_max_dim_z(SpfftFloatGrid grid, int* dimZ) {
  return spfft_grid_max_dim_z(grid, dimZ);
}
SpfftError spfft_float_grid_max_num_local_z_columns(SpfftFloatGrid grid, int* out) {
  return spfft_grid_max_num_local_z_columns(grid, out);
}
SpfftError spfft_float_grid_max_local_z_length(SpfftFloatGrid grid, int* out) {
  return spfft_grid_max_local_z_length(grid, out);
}
SpfftError spfft_float_grid_processing_unit(SpfftFloatGrid grid,
                                            SpfftProcessingUnitType* out) {
  return spfft_grid_processing_unit(grid, out);
}
SpfftError spfft_float_grid_device_id(SpfftFloatGrid grid, int* deviceId) {
  return spfft_grid_device_id(grid, deviceId);
}
SpfftError spfft_float_grid_num_threads(SpfftFloatGrid grid, int* numThreads) {
  return spfft_grid_num_threads(grid, numThreads);
}

/* ---- MPI-surface parity stubs ---------------------------------------------
 * No MPI exists in this runtime (the device mesh replaces the communicator,
 * docs/api/c_api.md); these keep ported callers LINKING (reference:
 * include/spfft/grid.h:184, transform.h:122,341) and fail with the same code
 * a feature-less reference build reports. The comm argument is declared
 * void* here and never read; callers compiled with an int-typed MPI_Comm
 * (MPICH) pass a technically different by-value type, which is benign on
 * every supported ABI because scalar arguments ride the same registers —
 * see the ABI note at the SpfftMpiComm typedef (types.h). The
 * *_fortran variants take the MPI_Fint the reference's Fortran module binds
 * (reference: src/spfft/grid.cpp *_fortran entries). */

SpfftError spfft_grid_communicator(SpfftGrid, SpfftMpiComm*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_float_grid_communicator(SpfftFloatGrid, SpfftMpiComm*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_transform_communicator(SpfftTransform, SpfftMpiComm*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_float_transform_communicator(SpfftFloatTransform, SpfftMpiComm*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_grid_communicator_fortran(SpfftGrid, int*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_float_grid_communicator_fortran(SpfftFloatGrid, int*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_transform_communicator_fortran(SpfftTransform, int*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_float_transform_communicator_fortran(SpfftFloatTransform, int*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}

SpfftError spfft_transform_create_independent_distributed(
    SpfftTransform*, int, SpfftMpiComm, SpfftExchangeType, SpfftProcessingUnitType,
    SpfftTransformType, int, int, int, int, int, SpfftIndexFormatType, const int*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_float_transform_create_independent_distributed(
    SpfftFloatTransform*, int, SpfftMpiComm, SpfftExchangeType, SpfftProcessingUnitType,
    SpfftTransformType, int, int, int, int, int, SpfftIndexFormatType, const int*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_transform_create_independent_distributed_fortran(
    SpfftTransform*, int, int, SpfftExchangeType, SpfftProcessingUnitType,
    SpfftTransformType, int, int, int, int, int, SpfftIndexFormatType, const int*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}
SpfftError spfft_float_transform_create_independent_distributed_fortran(
    SpfftFloatTransform*, int, int, SpfftExchangeType, SpfftProcessingUnitType,
    SpfftTransformType, int, int, int, int, int, SpfftIndexFormatType, const int*) {
  return SPFFT_MPI_SUPPORT_ERROR;
}

/* ---- transform (double) --------------------------------------------------- */

SpfftError spfft_transform_create_independent(
    SpfftTransform* transform, int /*maxNumThreads*/,
    SpfftProcessingUnitType processingUnit, SpfftTransformType transformType, int dimX,
    int dimY, int dimZ, int numLocalElements, SpfftIndexFormatType indexFormat,
    const int* indices) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    *transform = new spfft::Transform(processingUnit, transformType, dimX, dimY, dimZ,
                                      numLocalElements, indexFormat, indices);
  });
}

SpfftError spfft_transform_create(SpfftTransform* transform, SpfftGrid grid,
                                  SpfftProcessingUnitType processingUnit,
                                  SpfftTransformType transformType, int dimX, int dimY,
                                  int dimZ, int localZLength, int numLocalElements,
                                  SpfftIndexFormatType indexFormat, const int* indices) {
  if (transform == nullptr || grid == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    *transform = new spfft::Transform(as_grid(grid)->create_transform(
        processingUnit, transformType, dimX, dimY, dimZ, localZLength,
        numLocalElements, indexFormat, indices));
  });
}

SpfftError spfft_transform_destroy(SpfftTransform transform) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { delete as_transform(transform); });
}

SpfftError spfft_transform_clone(SpfftTransform transform, SpfftTransform* newTransform) {
  if (transform == nullptr || newTransform == nullptr)
    return SPFFT_INVALID_HANDLE_ERROR;
  return guarded(
      [&] { *newTransform = new spfft::Transform(as_transform(transform)->clone()); });
}

SpfftError spfft_transform_backward(SpfftTransform transform, const double* input,
                                    SpfftProcessingUnitType outputLocation) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_transform(transform)->backward(input, outputLocation); });
}

SpfftError spfft_transform_forward(SpfftTransform transform,
                                   SpfftProcessingUnitType inputLocation, double* output,
                                   SpfftScalingType scaling) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded(
      [&] { as_transform(transform)->forward(inputLocation, output, scaling); });
}

SpfftError spfft_transform_forward_ptr(SpfftTransform transform, const double* input,
                                       double* output, SpfftScalingType scaling) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_transform(transform)->forward(input, output, scaling); });
}

SpfftError spfft_transform_backward_ptr(SpfftTransform transform, const double* input,
                                        double* output) {
  if (transform == nullptr || output == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_transform(transform)->backward(input, output); });
}

SpfftError spfft_transform_get_space_domain(SpfftTransform transform,
                                            SpfftProcessingUnitType dataLocation,
                                            double** data) {
  if (transform == nullptr || data == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded(
      [&] { *data = as_transform(transform)->space_domain_data(dataLocation); });
}

#define SPFFT_TPU_TRANSFORM_GETTER(FN, OUT_T, METHOD)                                    \
  SpfftError FN(SpfftTransform transform, OUT_T* out) {                                  \
    if (transform == nullptr || out == nullptr) return SPFFT_INVALID_HANDLE_ERROR;       \
    return guarded([&] { *out = static_cast<OUT_T>(as_transform(transform)->METHOD()); });\
  }

SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_type, SpfftTransformType, type)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_dim_x, int, dim_x)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_dim_y, int, dim_y)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_dim_z, int, dim_z)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_local_z_length, int, local_z_length)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_local_z_offset, int, local_z_offset)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_local_slice_size, int, local_slice_size)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_num_local_elements, int, num_local_elements)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_num_global_elements, long long int,
                           num_global_elements)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_global_size, long long int, global_size)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_processing_unit, SpfftProcessingUnitType,
                           processing_unit)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_device_id, int, device_id)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_num_threads, int, num_threads)
SPFFT_TPU_TRANSFORM_GETTER(spfft_transform_execution_mode, SpfftExecType, execution_mode)

#undef SPFFT_TPU_TRANSFORM_GETTER

SpfftError spfft_transform_set_execution_mode(SpfftTransform transform,
                                              SpfftExecType mode) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_transform(transform)->set_execution_mode(mode); });
}

/* ---- transform (float) ---------------------------------------------------- */

SpfftError spfft_float_transform_create_independent(
    SpfftFloatTransform* transform, int /*maxNumThreads*/,
    SpfftProcessingUnitType processingUnit, SpfftTransformType transformType, int dimX,
    int dimY, int dimZ, int numLocalElements, SpfftIndexFormatType indexFormat,
    const int* indices) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    *transform = new spfft::TransformFloat(processingUnit, transformType, dimX, dimY,
                                           dimZ, numLocalElements, indexFormat, indices);
  });
}

SpfftError spfft_float_transform_create(SpfftFloatTransform* transform,
                                        SpfftFloatGrid grid,
                                        SpfftProcessingUnitType processingUnit,
                                        SpfftTransformType transformType, int dimX,
                                        int dimY, int dimZ, int localZLength,
                                        int numLocalElements,
                                        SpfftIndexFormatType indexFormat,
                                        const int* indices) {
  if (transform == nullptr || grid == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    *transform = new spfft::TransformFloat(as_grid(grid)->create_transform_float(
        processingUnit, transformType, dimX, dimY, dimZ, localZLength,
        numLocalElements, indexFormat, indices));
  });
}

SpfftError spfft_float_transform_destroy(SpfftFloatTransform transform) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { delete as_float_transform(transform); });
}

SpfftError spfft_float_transform_clone(SpfftFloatTransform transform,
                                       SpfftFloatTransform* newTransform) {
  if (transform == nullptr || newTransform == nullptr)
    return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    *newTransform = new spfft::TransformFloat(as_float_transform(transform)->clone());
  });
}

SpfftError spfft_float_transform_backward(SpfftFloatTransform transform,
                                          const float* input,
                                          SpfftProcessingUnitType outputLocation) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded(
      [&] { as_float_transform(transform)->backward(input, outputLocation); });
}

SpfftError spfft_float_transform_forward(SpfftFloatTransform transform,
                                         SpfftProcessingUnitType inputLocation,
                                         float* output, SpfftScalingType scaling) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded(
      [&] { as_float_transform(transform)->forward(inputLocation, output, scaling); });
}

SpfftError spfft_float_transform_forward_ptr(SpfftFloatTransform transform,
                                             const float* input, float* output,
                                             SpfftScalingType scaling) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded(
      [&] { as_float_transform(transform)->forward(input, output, scaling); });
}

SpfftError spfft_float_transform_backward_ptr(SpfftFloatTransform transform,
                                              const float* input, float* output) {
  if (transform == nullptr || output == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_float_transform(transform)->backward(input, output); });
}

SpfftError spfft_float_transform_get_space_domain(SpfftFloatTransform transform,
                                                  SpfftProcessingUnitType dataLocation,
                                                  float** data) {
  if (transform == nullptr || data == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded(
      [&] { *data = as_float_transform(transform)->space_domain_data(dataLocation); });
}

#define SPFFT_TPU_FLOAT_GETTER(FN, OUT_T, METHOD)                                        \
  SpfftError FN(SpfftFloatTransform transform, OUT_T* out) {                             \
    if (transform == nullptr || out == nullptr) return SPFFT_INVALID_HANDLE_ERROR;       \
    return guarded(                                                                      \
        [&] { *out = static_cast<OUT_T>(as_float_transform(transform)->METHOD()); });    \
  }

SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_type, SpfftTransformType, type)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_dim_x, int, dim_x)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_dim_y, int, dim_y)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_dim_z, int, dim_z)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_local_z_length, int, local_z_length)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_local_z_offset, int, local_z_offset)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_local_slice_size, int, local_slice_size)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_num_local_elements, int, num_local_elements)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_num_global_elements, long long int,
                       num_global_elements)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_global_size, long long int, global_size)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_processing_unit, SpfftProcessingUnitType,
                       processing_unit)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_device_id, int, device_id)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_num_threads, int, num_threads)
SPFFT_TPU_FLOAT_GETTER(spfft_float_transform_execution_mode, SpfftExecType,
                       execution_mode)

#undef SPFFT_TPU_FLOAT_GETTER

SpfftError spfft_float_transform_set_execution_mode(SpfftFloatTransform transform,
                                                    SpfftExecType mode) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_float_transform(transform)->set_execution_mode(mode); });
}

/* ---- multi-transform ------------------------------------------------------ */

SpfftError spfft_multi_transform_backward(int numTransforms, SpfftTransform* transforms,
                                          const double* const* input,
                                          const SpfftProcessingUnitType* outputLocations) {
  if (transforms == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    std::vector<spfft::Transform> objs;
    objs.reserve(numTransforms);
    for (int i = 0; i < numTransforms; ++i) objs.push_back(*as_transform(transforms[i]));
    spfft::multi_transform_backward(numTransforms, objs.data(), input, outputLocations);
  });
}

SpfftError spfft_multi_transform_forward(int numTransforms, SpfftTransform* transforms,
                                         const SpfftProcessingUnitType* inputLocations,
                                         double* const* output,
                                         const SpfftScalingType* scalingTypes) {
  if (transforms == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    std::vector<spfft::Transform> objs;
    objs.reserve(numTransforms);
    for (int i = 0; i < numTransforms; ++i) objs.push_back(*as_transform(transforms[i]));
    spfft::multi_transform_forward(numTransforms, objs.data(), inputLocations, output,
                                   scalingTypes);
  });
}

SpfftError spfft_float_multi_transform_backward(
    int numTransforms, SpfftFloatTransform* transforms, const float* const* input,
    const SpfftProcessingUnitType* outputLocations) {
  if (transforms == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    std::vector<spfft::TransformFloat> objs;
    objs.reserve(numTransforms);
    for (int i = 0; i < numTransforms; ++i)
      objs.push_back(*as_float_transform(transforms[i]));
    spfft::multi_transform_backward(numTransforms, objs.data(), input, outputLocations);
  });
}

SpfftError spfft_float_multi_transform_forward(
    int numTransforms, SpfftFloatTransform* transforms,
    const SpfftProcessingUnitType* inputLocations, float* const* output,
    const SpfftScalingType* scalingTypes) {
  if (transforms == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    std::vector<spfft::TransformFloat> objs;
    objs.reserve(numTransforms);
    for (int i = 0; i < numTransforms; ++i)
      objs.push_back(*as_float_transform(transforms[i]));
    spfft::multi_transform_forward(numTransforms, objs.data(), inputLocations, output,
                                   scalingTypes);
  });
}

/* Pointer-based batch overloads (reference: include/spfft/multi_transform.h:60-95). */

SpfftError spfft_multi_transform_backward_ptr(int numTransforms,
                                              SpfftTransform* transforms,
                                              const double* const* inputPointers,
                                              double* const* outputPointers) {
  if (transforms == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    std::vector<spfft::Transform> objs;
    objs.reserve(numTransforms);
    for (int i = 0; i < numTransforms; ++i) objs.push_back(*as_transform(transforms[i]));
    spfft::multi_transform_backward(numTransforms, objs.data(), inputPointers,
                                    outputPointers);
  });
}

SpfftError spfft_multi_transform_forward_ptr(int numTransforms,
                                             SpfftTransform* transforms,
                                             const double* const* inputPointers,
                                             double* const* outputPointers,
                                             const SpfftScalingType* scalingTypes) {
  if (transforms == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    std::vector<spfft::Transform> objs;
    objs.reserve(numTransforms);
    for (int i = 0; i < numTransforms; ++i) objs.push_back(*as_transform(transforms[i]));
    spfft::multi_transform_forward(numTransforms, objs.data(), inputPointers,
                                   outputPointers, scalingTypes);
  });
}

SpfftError spfft_float_multi_transform_backward_ptr(int numTransforms,
                                                    SpfftFloatTransform* transforms,
                                                    const float* const* inputPointers,
                                                    float* const* outputPointers) {
  if (transforms == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    std::vector<spfft::TransformFloat> objs;
    objs.reserve(numTransforms);
    for (int i = 0; i < numTransforms; ++i)
      objs.push_back(*as_float_transform(transforms[i]));
    spfft::multi_transform_backward(numTransforms, objs.data(), inputPointers,
                                    outputPointers);
  });
}

SpfftError spfft_float_multi_transform_forward_ptr(int numTransforms,
                                                   SpfftFloatTransform* transforms,
                                                   const float* const* inputPointers,
                                                   float* const* outputPointers,
                                                   const SpfftScalingType* scalingTypes) {
  if (transforms == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    std::vector<spfft::TransformFloat> objs;
    objs.reserve(numTransforms);
    for (int i = 0; i < numTransforms; ++i)
      objs.push_back(*as_float_transform(transforms[i]));
    spfft::multi_transform_forward(numTransforms, objs.data(), inputPointers,
                                   outputPointers, scalingTypes);
  });
}

/* ---- distributed transform ------------------------------------------------ */

SpfftError spfft_dist_transform_create(SpfftDistTransform* transform, SpfftGrid grid,
                                       SpfftProcessingUnitType processingUnit,
                                       SpfftTransformType transformType, int dimX,
                                       int dimY, int dimZ, int numShards,
                                       const int* shardNumElements,
                                       SpfftIndexFormatType indexFormat,
                                       const int* indices, int doublePrecision) {
  if (transform == nullptr || grid == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] {
    *transform = new spfft::DistributedTransform(
        as_grid(grid)->create_transform_distributed(
            processingUnit, transformType, dimX, dimY, dimZ, numShards,
            shardNumElements, indexFormat, indices, doublePrecision != 0));
  });
}

SpfftError spfft_dist_transform_create_independent(
    SpfftDistTransform* transform, int maxNumThreads, int numShards,
    SpfftExchangeType exchangeType, SpfftProcessingUnitType processingUnit,
    SpfftTransformType transformType, int dimX, int dimY, int dimZ,
    const int* shardNumElements, SpfftIndexFormatType indexFormat,
    const int* indices, int doublePrecision) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  /* The internal grid is only a capacity envelope consumed at plan creation
   * (the runtime keeps what it needs), so it is created wide and destroyed
   * immediately after — the reference's grid-less ctor does the same
   * internally (reference: src/spfft/transform.cpp grid-less path). */
  SpfftGrid grid = nullptr;
  SpfftError err = spfft_grid_create_distributed(
      &grid, dimX, dimY, dimZ, dimX * dimY, dimZ, numShards, exchangeType,
      processingUnit, maxNumThreads);
  if (err != SPFFT_SUCCESS) return err;
  err = spfft_dist_transform_create(transform, grid, processingUnit, transformType,
                                    dimX, dimY, dimZ, numShards, shardNumElements,
                                    indexFormat, indices, doublePrecision);
  SpfftError destroy_err = spfft_grid_destroy(grid);
  return err != SPFFT_SUCCESS ? err : destroy_err;
}

SpfftError spfft_dist_transform_destroy(SpfftDistTransform transform) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { delete as_dist_transform(transform); });
}

SpfftError spfft_dist_transform_backward(SpfftDistTransform transform,
                                         const double* values, double* space) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_dist_transform(transform)->backward(values, space); });
}

SpfftError spfft_float_dist_transform_backward(SpfftDistTransform transform,
                                               const float* values, float* space) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_dist_transform(transform)->backward(values, space); });
}

SpfftError spfft_dist_transform_forward(SpfftDistTransform transform,
                                        const double* space, double* values,
                                        SpfftScalingType scaling) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_dist_transform(transform)->forward(space, values, scaling); });
}

SpfftError spfft_float_dist_transform_forward(SpfftDistTransform transform,
                                              const float* space, float* values,
                                              SpfftScalingType scaling) {
  if (transform == nullptr) return SPFFT_INVALID_HANDLE_ERROR;
  return guarded([&] { as_dist_transform(transform)->forward(space, values, scaling); });
}

#define SPFFT_TPU_DIST_GETTER(FN, OUT_T, METHOD)                                         \
  SpfftError FN(SpfftDistTransform transform, OUT_T* out) {                              \
    if (transform == nullptr || out == nullptr) return SPFFT_INVALID_HANDLE_ERROR;       \
    return guarded(                                                                      \
        [&] { *out = static_cast<OUT_T>(as_dist_transform(transform)->METHOD()); });     \
  }

SPFFT_TPU_DIST_GETTER(spfft_dist_transform_type, SpfftTransformType, type)
SPFFT_TPU_DIST_GETTER(spfft_dist_transform_dim_x, int, dim_x)
SPFFT_TPU_DIST_GETTER(spfft_dist_transform_dim_y, int, dim_y)
SPFFT_TPU_DIST_GETTER(spfft_dist_transform_dim_z, int, dim_z)
SPFFT_TPU_DIST_GETTER(spfft_dist_transform_num_shards, int, num_shards)
SPFFT_TPU_DIST_GETTER(spfft_dist_transform_num_global_elements, long long int,
                      num_global_elements)
SPFFT_TPU_DIST_GETTER(spfft_dist_transform_global_size, long long int, global_size)
SPFFT_TPU_DIST_GETTER(spfft_dist_transform_exchange_type, SpfftExchangeType,
                      exchange_type)
SPFFT_TPU_DIST_GETTER(spfft_dist_transform_exchange_wire_bytes, long long int,
                      exchange_wire_bytes)
SPFFT_TPU_DIST_GETTER(spfft_dist_transform_exchange_rounds, int, exchange_rounds)

#undef SPFFT_TPU_DIST_GETTER

#define SPFFT_TPU_DIST_SHARD_GETTER(FN, OUT_T, METHOD)                                   \
  SpfftError FN(SpfftDistTransform transform, int shard, OUT_T* out) {                   \
    if (transform == nullptr || out == nullptr) return SPFFT_INVALID_HANDLE_ERROR;       \
    return guarded(                                                                      \
        [&] { *out = static_cast<OUT_T>(as_dist_transform(transform)->METHOD(shard)); });\
  }

SPFFT_TPU_DIST_SHARD_GETTER(spfft_dist_transform_local_z_length, int, local_z_length)
SPFFT_TPU_DIST_SHARD_GETTER(spfft_dist_transform_local_z_offset, int, local_z_offset)
SPFFT_TPU_DIST_SHARD_GETTER(spfft_dist_transform_local_y_length, int, local_y_length)
SPFFT_TPU_DIST_SHARD_GETTER(spfft_dist_transform_local_y_offset, int, local_y_offset)
SPFFT_TPU_DIST_SHARD_GETTER(spfft_dist_transform_num_local_elements, int,
                            num_local_elements)

#undef SPFFT_TPU_DIST_SHARD_GETTER

} /* extern "C" */
