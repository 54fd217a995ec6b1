/*
 * spfft_tpu native API — C++ Transform classes.
 *
 * Source-compatible with the reference spfft::Transform /
 * spfft::TransformFloat (reference: include/spfft/transform.hpp:56-318,
 * transform_float.hpp). The plan object is backed by the PyTorch compute core
 * (spfft_tpu_torch): construction builds the plan's device kernels and
 * constants; backward/forward run them and marshal host buffers across the
 * runtime boundary.
 *
 * Usage mirrors the reference: construct, fill space_domain_data() or pass a
 * frequency-value array to backward(), read results, forward() back.
 */
#ifndef SPFFT_TPU_TRANSFORM_HPP
#define SPFFT_TPU_TRANSFORM_HPP

#include <spfft/errors.h>
#include <spfft/types.h>

#include <memory>

namespace spfft {

class Grid;

class Transform;
class TransformFloat;
class DistributedTransform;

namespace detail {
struct Plan;
struct DistPlan;
std::shared_ptr<Plan> make_plan(const Grid* grid, bool double_precision,
                                SpfftProcessingUnitType pu, SpfftTransformType tt,
                                int dim_x, int dim_y, int dim_z, int local_z_length,
                                int num_local_elements, SpfftIndexFormatType fmt,
                                const int* indices);
Plan* plan_of(Transform& t);
Plan* plan_of(TransformFloat& t);
} // namespace detail

/* Double-precision sparse 3D FFT plan. */
class Transform {
public:
  /* Grid-less constructor (reference v1.0 feature, transform.hpp:76-105). */
  Transform(SpfftProcessingUnitType processing_unit, SpfftTransformType transform_type,
            int dim_x, int dim_y, int dim_z, int num_local_elements,
            SpfftIndexFormatType index_format, const int* indices);

  /* Independent plan with identical layout (reference: transform.hpp:133). */
  Transform clone() const;

  /* Frequency -> space. Result lands in space_domain_data(). */
  void backward(const double* input, SpfftProcessingUnitType output_location);

  /* Pointer-to-pointer overload: the space-domain result is also written to
   * ``output`` (reference: transform.h spfft_transform_backward_ptr). */
  void backward(const double* input, double* output);

  /* Space -> frequency, reading space_domain_data(). */
  void forward(SpfftProcessingUnitType input_location, double* output,
               SpfftScalingType scaling = SPFFT_NO_SCALING);

  /* Pointer-to-pointer overload: space input supplied directly. */
  void forward(const double* input, double* output,
               SpfftScalingType scaling = SPFFT_NO_SCALING);

  /* Writable (dimZ, dimY, dimX) slab; complex-interleaved for C2C, real for
   * R2C. Valid until the next transform call (reference: transform.hpp:245). */
  double* space_domain_data(SpfftProcessingUnitType data_location);

  SpfftTransformType type() const;
  int dim_x() const;
  int dim_y() const;
  int dim_z() const;
  int local_z_length() const;
  int local_z_offset() const;
  long long local_slice_size() const;
  long long num_local_elements() const;
  long long num_global_elements() const;
  long long global_size() const;
  SpfftProcessingUnitType processing_unit() const;
  int device_id() const;
  int num_threads() const;
  SpfftExecType execution_mode() const;
  void set_execution_mode(SpfftExecType mode);

private:
  friend class Grid;
  friend detail::Plan* detail::plan_of(Transform&);
  explicit Transform(std::shared_ptr<detail::Plan> plan) : plan_(std::move(plan)) {}

  std::shared_ptr<detail::Plan> plan_;
};

/* Single-precision plan (reference: include/spfft/transform_float.hpp; on the
 * GPU f32 runs on the tensor cores, so this is the fast path). */
class TransformFloat {
public:
  TransformFloat(SpfftProcessingUnitType processing_unit,
                 SpfftTransformType transform_type, int dim_x, int dim_y, int dim_z,
                 int num_local_elements, SpfftIndexFormatType index_format,
                 const int* indices);

  TransformFloat clone() const;

  void backward(const float* input, SpfftProcessingUnitType output_location);
  void backward(const float* input, float* output);
  void forward(SpfftProcessingUnitType input_location, float* output,
               SpfftScalingType scaling = SPFFT_NO_SCALING);
  void forward(const float* input, float* output,
               SpfftScalingType scaling = SPFFT_NO_SCALING);
  float* space_domain_data(SpfftProcessingUnitType data_location);

  SpfftTransformType type() const;
  int dim_x() const;
  int dim_y() const;
  int dim_z() const;
  int local_z_length() const;
  int local_z_offset() const;
  long long local_slice_size() const;
  long long num_local_elements() const;
  long long num_global_elements() const;
  long long global_size() const;
  SpfftProcessingUnitType processing_unit() const;
  int device_id() const;
  int num_threads() const;
  SpfftExecType execution_mode() const;
  void set_execution_mode(SpfftExecType mode);

private:
  friend class Grid;
  friend detail::Plan* detail::plan_of(TransformFloat&);
  explicit TransformFloat(std::shared_ptr<detail::Plan> plan) : plan_(std::move(plan)) {}

  std::shared_ptr<detail::Plan> plan_;
};

/* Mesh-distributed sparse 3D FFT plan (single-controller: one process drives
 * every shard; the reference's per-rank MPI contract becomes shard-major
 * concatenated host arrays). Created via Grid::create_transform_distributed.
 * Precision is chosen at creation; the double/float overloads must match it
 * (InvalidParameterError otherwise). */
class DistributedTransform {
public:
  /* values: shard-major concatenated packed frequency data
   * (2 * num_global_elements reals, complex-interleaved); space_output: the
   * assembled global (dimZ, dimY, dimX) slab (complex-interleaved for C2C,
   * real for R2C). */
  void backward(const double* values, double* space_output);
  void backward(const float* values, float* space_output);

  /* space: global (dimZ, dimY, dimX) array, or nullptr to reuse the slabs
   * retained by the last backward; values_output as above. */
  void forward(const double* space, double* values_output,
               SpfftScalingType scaling = SPFFT_NO_SCALING);
  void forward(const float* space, float* values_output,
               SpfftScalingType scaling = SPFFT_NO_SCALING);

  SpfftTransformType type() const;
  int dim_x() const;
  int dim_y() const;
  int dim_z() const;
  int num_shards() const;
  long long num_global_elements() const;
  long long global_size() const;
  SpfftProcessingUnitType processing_unit() const;
  SpfftExchangeType exchange_type() const;
  /* Off-shard interconnect bytes per slab<->pencil repartition. */
  long long exchange_wire_bytes() const;
  /* Sequential collective rounds per repartition under the plan's
   * discipline and active transport. 1-D grids: 1 (padded all_to_all /
   * one-shot ragged), P-1 (chains). 2-D pencil grids report the sum of
   * their two exchanges: 2 (padded/one-shot) or (P-1)+(P1-1) (chains). */
  int exchange_rounds() const;
  bool double_precision() const;

  /* Per-shard layout (the reference's per-rank accessors). On 2-D pencil
   * grids the space block is (local_z_length, local_y_length, dim_x); on 1-D
   * grids local_y_length == dim_y and local_y_offset == 0. */
  int local_z_length(int shard) const;
  int local_z_offset(int shard) const;
  int local_y_length(int shard) const;
  int local_y_offset(int shard) const;
  long long local_slice_size(int shard) const;
  long long num_local_elements(int shard) const;

private:
  friend class Grid;
  explicit DistributedTransform(std::shared_ptr<detail::DistPlan> plan)
      : plan_(std::move(plan)) {}

  std::shared_ptr<detail::DistPlan> plan_;
};

} // namespace spfft

#endif // SPFFT_TPU_TRANSFORM_HPP
