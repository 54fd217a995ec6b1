/*
 * spfft_tpu_torch native API — C++ classes and C interface core.
 *
 * Structure mirrors the reference's public layer (reference:
 * src/spfft/transform.cpp, grid.cpp, multi_transform.cpp): thin C++ classes
 * over a shared plan object, and extern-C handle functions (capi_c.cpp) that
 * catch GenericError and return its error code. The plan drives the PyTorch
 * compute core through the bridge (see bridge.hpp) and owns the host-side
 * space-domain buffer, which gives space_domain_data() the same
 * write-then-forward semantics as the reference (reference:
 * include/spfft/transform.hpp:245, examples/example.cpp usage).
 */
#include "bridge.hpp"

#include <spfft/spfft.hpp>

#include <cstring>
#include <memory>
#include <vector>

namespace spfft {
namespace detail {

namespace br = spfft::bridge;

struct Plan {
  br::Ref py;            /* the compute-core plan object */
  bool dbl = true;       /* double precision? */
  long long num_values = 0;
  long long space_reals = 0; /* reals in the space-domain slab */
  std::vector<unsigned char> space; /* host space-domain buffer */

  /* Immutable layout metadata, fetched once at plan creation so getters never
   * re-enter the embedded runtime. */
  struct Meta {
    int dim_x = 0, dim_y = 0, dim_z = 0;
    int local_z_length = 0, local_z_offset = 0;
    int device_id = 0, num_threads = 1;
    long long local_slice_size = 0, num_global_elements = 0, global_size = 0;
    int transform_type = 0, processing_unit = 0;
  } meta;

  std::size_t elem_bytes() const { return dbl ? sizeof(double) : sizeof(float); }

  long long get(const char* name) const {
    br::Gil gil;
    br::Ref r = br::call("transform_get", Py_BuildValue("(Os)", py.get(), name));
    return br::as_longlong(r.get());
  }

  void backward(const void* input) {
    br::Gil gil;
    br::Ref in =
        br::view_ro(input, static_cast<std::size_t>(2 * num_values) * elem_bytes());
    br::Ref out = br::view_rw(space.data(), space.size());
    br::call("transform_backward",
             Py_BuildValue("(OOO)", py.get(), in.get(), out.get()));
  }

  void forward(const void* space_input, void* output, int scaling) {
    br::Gil gil;
    br::Ref in = br::view_ro(space_input,
                             static_cast<std::size_t>(space_reals) * elem_bytes());
    br::Ref out =
        br::view_rw(output, static_cast<std::size_t>(2 * num_values) * elem_bytes());
    br::call("transform_forward",
             Py_BuildValue("(OOOi)", py.get(), in.get(), out.get(), scaling));
  }

  void set_execution_mode(int mode) {
    br::Gil gil;
    br::call("transform_set_execution_mode", Py_BuildValue("(Oi)", py.get(), mode));
  }
};

struct GridState {
  br::Ref py;
};

/* Mesh-distributed plan: shard-major concatenated host arrays over the
 * single-controller mesh (see spfft_tpu/capi.py dist_* functions). */
struct DistPlan {
  br::Ref py;
  bool dbl = true;
  long long num_global = 0; /* total packed values across shards */
  long long space_reals = 0;

  struct Meta {
    int dim_x = 0, dim_y = 0, dim_z = 0, num_shards = 0;
    int transform_type = 0, processing_unit = 0, exchange_type = 0;
    long long global_size = 0, wire_bytes = 0;
    int exchange_rounds = 0;
  } meta;
  std::vector<long long> shard_elems, shard_zlen, shard_zoff, shard_slice;
  std::vector<long long> shard_ylen, shard_yoff;

  std::size_t elem_bytes() const { return dbl ? sizeof(double) : sizeof(float); }

  long long get(const char* name) const {
    br::Gil gil;
    br::Ref r = br::call("dist_transform_get", Py_BuildValue("(Os)", py.get(), name));
    return br::as_longlong(r.get());
  }

  long long get_shard(const char* name, int shard) const {
    br::Gil gil;
    br::Ref r = br::call("dist_transform_get_shard",
                         Py_BuildValue("(Osi)", py.get(), name, shard));
    return br::as_longlong(r.get());
  }

  void check_shard(int shard) const {
    if (shard < 0 || shard >= meta.num_shards) {
      throw InvalidParameterError("spfft_tpu: shard index out of range");
    }
  }

  void check_precision(bool want_dbl) const {
    if (dbl != want_dbl) {
      throw InvalidParameterError(
          "spfft_tpu: value pointer precision does not match the plan");
    }
  }

  void backward(const void* values, void* space) {
    br::Gil gil;
    br::Ref in = br::view_ro(values,
                             static_cast<std::size_t>(2 * num_global) * elem_bytes());
    br::Ref out =
        br::view_rw(space, static_cast<std::size_t>(space_reals) * elem_bytes());
    br::call("dist_backward", Py_BuildValue("(OOO)", py.get(), in.get(), out.get()));
  }

  void forward(const void* space, void* values, int scaling) {
    br::Gil gil;
    br::Ref out =
        br::view_rw(values, static_cast<std::size_t>(2 * num_global) * elem_bytes());
    if (space == nullptr) {
      br::call("dist_forward",
               Py_BuildValue("(OOOi)", py.get(), Py_None, out.get(), scaling));
      return;
    }
    br::Ref in =
        br::view_ro(space, static_cast<std::size_t>(space_reals) * elem_bytes());
    br::call("dist_forward",
             Py_BuildValue("(OOOi)", py.get(), in.get(), out.get(), scaling));
  }
};

const std::shared_ptr<GridState>& grid_state(const Grid& grid) { return grid.state_; }

Plan* plan_of(Transform& t) { return t.plan_.get(); }
Plan* plan_of(TransformFloat& t) { return t.plan_.get(); }

namespace {

void finish_plan(const std::shared_ptr<Plan>& plan) {
  Plan::Meta& m = plan->meta;
  m.dim_x = static_cast<int>(plan->get("dim_x"));
  m.dim_y = static_cast<int>(plan->get("dim_y"));
  m.dim_z = static_cast<int>(plan->get("dim_z"));
  m.local_z_length = static_cast<int>(plan->get("local_z_length"));
  m.local_z_offset = static_cast<int>(plan->get("local_z_offset"));
  m.device_id = static_cast<int>(plan->get("device_id"));
  m.num_threads = static_cast<int>(plan->get("num_threads"));
  m.local_slice_size = plan->get("local_slice_size");
  m.num_global_elements = plan->get("num_global_elements");
  m.global_size = plan->get("global_size");
  m.transform_type = static_cast<int>(plan->get("transform_type"));
  m.processing_unit = static_cast<int>(plan->get("processing_unit"));
  plan->num_values = plan->get("num_local_elements");
  bool r2c = m.transform_type == SPFFT_TRANS_R2C;
  plan->space_reals = r2c ? m.local_slice_size : 2 * m.local_slice_size;
  plan->space.assign(static_cast<std::size_t>(plan->space_reals) * plan->elem_bytes(),
                     0);
}

} // namespace

std::shared_ptr<Plan> make_plan(const Grid* grid, bool double_precision,
                                SpfftProcessingUnitType pu, SpfftTransformType tt,
                                int dim_x, int dim_y, int dim_z, int local_z_length,
                                int num_local_elements, SpfftIndexFormatType fmt,
                                const int* indices) {
  if (fmt != SPFFT_INDEX_TRIPLETS) {
    throw InvalidParameterError("spfft_tpu: only SPFFT_INDEX_TRIPLETS is supported");
  }
  if (num_local_elements < 0 || (num_local_elements > 0 && indices == nullptr)) {
    throw InvalidParameterError("spfft_tpu: invalid index array");
  }
  auto plan = std::make_shared<Plan>();
  plan->dbl = double_precision;
  {
    br::Gil gil;
    br::Ref idx = br::view_ro(
        indices, static_cast<std::size_t>(3 * num_local_elements) * sizeof(int));
    if (grid != nullptr) {
      plan->py = br::call(
          "transform_create_from_grid",
          Py_BuildValue("(OiiiiiiiOi)", grid_state(*grid)->py.get(),
                        static_cast<int>(pu), static_cast<int>(tt), dim_x, dim_y,
                        dim_z, local_z_length, num_local_elements, idx.get(),
                        double_precision ? 1 : 0));
    } else {
      plan->py = br::call(
          "transform_create",
          Py_BuildValue("(iiiiiiOi)", static_cast<int>(pu), static_cast<int>(tt),
                        dim_x, dim_y, dim_z, num_local_elements, idx.get(),
                        double_precision ? 1 : 0));
    }
  }
  finish_plan(plan);
  return plan;
}

namespace {

std::shared_ptr<Plan> clone_plan(const std::shared_ptr<Plan>& plan) {
  auto out = std::make_shared<Plan>();
  out->dbl = plan->dbl;
  {
    br::Gil gil;
    out->py = br::call("transform_clone", Py_BuildValue("(O)", plan->py.get()));
  }
  finish_plan(out);
  return out;
}

long long grid_attr(const std::shared_ptr<GridState>& state, const char* name) {
  br::Gil gil;
  br::Ref r = br::call("grid_get", Py_BuildValue("(Os)", state->py.get(), name));
  return br::as_longlong(r.get());
}

std::shared_ptr<DistPlan> make_dist_plan(const Grid& grid, bool double_precision,
                                         SpfftProcessingUnitType pu,
                                         SpfftTransformType tt, int dim_x, int dim_y,
                                         int dim_z, int num_shards,
                                         const int* shard_num_elements,
                                         SpfftIndexFormatType fmt, const int* indices) {
  if (fmt != SPFFT_INDEX_TRIPLETS) {
    throw InvalidParameterError("spfft_tpu: only SPFFT_INDEX_TRIPLETS is supported");
  }
  if (num_shards < 1 || shard_num_elements == nullptr) {
    throw InvalidParameterError("spfft_tpu: invalid shard layout");
  }
  long long total = 0;
  for (int r = 0; r < num_shards; ++r) {
    if (shard_num_elements[r] < 0) {
      throw InvalidParameterError("spfft_tpu: negative shard element count");
    }
    total += shard_num_elements[r];
  }
  if (total > 0 && indices == nullptr) {
    throw InvalidParameterError("spfft_tpu: invalid index array");
  }
  auto plan = std::make_shared<DistPlan>();
  plan->dbl = double_precision;
  {
    br::Gil gil;
    br::Ref counts = br::view_ro(shard_num_elements,
                                 static_cast<std::size_t>(num_shards) * sizeof(int));
    br::Ref idx =
        br::view_ro(indices, static_cast<std::size_t>(3 * total) * sizeof(int));
    plan->py = br::call(
        "dist_transform_create",
        Py_BuildValue("(OiiiiiiOOi)", grid_state(grid)->py.get(), static_cast<int>(pu),
                      static_cast<int>(tt), dim_x, dim_y, dim_z, num_shards,
                      counts.get(), idx.get(), double_precision ? 1 : 0));
  }
  DistPlan::Meta& m = plan->meta;
  m.dim_x = static_cast<int>(plan->get("dim_x"));
  m.dim_y = static_cast<int>(plan->get("dim_y"));
  m.dim_z = static_cast<int>(plan->get("dim_z"));
  m.num_shards = static_cast<int>(plan->get("num_shards"));
  m.transform_type = static_cast<int>(plan->get("transform_type"));
  m.processing_unit = static_cast<int>(plan->get("processing_unit"));
  m.exchange_type = static_cast<int>(plan->get("exchange_type"));
  m.global_size = plan->get("global_size");
  m.wire_bytes = plan->get("exchange_wire_bytes");
  m.exchange_rounds = static_cast<int>(plan->get("exchange_rounds"));
  plan->num_global = plan->get("num_global_elements");
  for (int r = 0; r < m.num_shards; ++r) {
    plan->shard_elems.push_back(plan->get_shard("num_local_elements", r));
    plan->shard_zlen.push_back(plan->get_shard("local_z_length", r));
    plan->shard_zoff.push_back(plan->get_shard("local_z_offset", r));
    plan->shard_ylen.push_back(plan->get_shard("local_y_length", r));
    plan->shard_yoff.push_back(plan->get_shard("local_y_offset", r));
    plan->shard_slice.push_back(plan->get_shard("local_slice_size", r));
  }
  bool r2c = m.transform_type == SPFFT_TRANS_R2C;
  plan->space_reals = r2c ? m.global_size : 2 * m.global_size;
  return plan;
}

} // namespace
} // namespace detail

/* ---- Grid ----------------------------------------------------------------- */

Grid::Grid(int max_dim_x, int max_dim_y, int max_dim_z, int max_num_local_z_columns,
           SpfftProcessingUnitType processing_unit, int max_num_threads)
    : state_(std::make_shared<detail::GridState>()) {
  bridge::Gil gil;
  state_->py = bridge::call(
      "grid_create",
      Py_BuildValue("(iiiiii)", max_dim_x, max_dim_y, max_dim_z,
                    max_num_local_z_columns, static_cast<int>(processing_unit),
                    max_num_threads));
}

Grid::Grid(int max_dim_x, int max_dim_y, int max_dim_z, int max_num_local_z_columns,
           int max_local_z_length, int num_shards, SpfftExchangeType exchange_type,
           SpfftProcessingUnitType processing_unit, int max_num_threads)
    : state_(std::make_shared<detail::GridState>()) {
  bridge::Gil gil;
  state_->py = bridge::call(
      "grid_create_distributed",
      Py_BuildValue("(iiiiiiiii)", max_dim_x, max_dim_y, max_dim_z,
                    max_num_local_z_columns, max_local_z_length, num_shards,
                    static_cast<int>(processing_unit),
                    static_cast<int>(exchange_type), max_num_threads));
}

Grid::Grid(int max_dim_x, int max_dim_y, int max_dim_z, int max_num_local_z_columns,
           int max_local_z_length, int p1, int p2, SpfftExchangeType exchange_type,
           SpfftProcessingUnitType processing_unit, int max_num_threads)
    : state_(std::make_shared<detail::GridState>()) {
  bridge::Gil gil;
  state_->py = bridge::call(
      "grid_create_distributed2",
      Py_BuildValue("(iiiiiiiiii)", max_dim_x, max_dim_y, max_dim_z,
                    max_num_local_z_columns, max_local_z_length, p1, p2,
                    static_cast<int>(processing_unit),
                    static_cast<int>(exchange_type), max_num_threads));
}

Grid::Grid(const Grid& other) : state_(std::make_shared<detail::GridState>()) {
  /* Fresh capacity: re-create from the other grid's parameters (the PyTorch
   * core holds no shared host buffers, so metadata equality suffices —
   * matches the reference's fresh-buffer copy, grid_internal.cpp:233-262). */
  bridge::Gil gil;
  /* mesh presence, not shard count: a 1-shard distributed grid must copy to a
   * distributed grid (the dist1 pipeline configs in BASELINE.md rely on it) */
  if (detail::grid_attr(detail::grid_state(other), "has_mesh") != 0) {
    const int p1 =
        static_cast<int>(detail::grid_attr(detail::grid_state(other), "mesh_p1"));
    const int exch = static_cast<int>(
        detail::grid_attr(detail::grid_state(other), "exchange_type"));
    if (p1 > 0) {
      state_->py = bridge::call(
          "grid_create_distributed2",
          Py_BuildValue("(iiiiiiiiii)", other.max_dim_x(), other.max_dim_y(),
                        other.max_dim_z(), other.max_num_local_z_columns(),
                        other.max_local_z_length(), p1, other.num_shards() / p1,
                        static_cast<int>(other.processing_unit()), exch,
                        other.max_num_threads()));
      return;
    }
    state_->py = bridge::call(
        "grid_create_distributed",
        Py_BuildValue("(iiiiiiiii)", other.max_dim_x(), other.max_dim_y(),
                      other.max_dim_z(), other.max_num_local_z_columns(),
                      other.max_local_z_length(), other.num_shards(),
                      static_cast<int>(other.processing_unit()), exch,
                      other.max_num_threads()));
    return;
  }
  state_->py = bridge::call(
      "grid_create",
      Py_BuildValue("(iiiiii)", other.max_dim_x(), other.max_dim_y(),
                    other.max_dim_z(), other.max_num_local_z_columns(),
                    static_cast<int>(other.processing_unit()),
                    other.max_num_threads()));
}

Grid::Grid(Grid&&) noexcept = default;
Grid& Grid::operator=(Grid&&) noexcept = default;

/* bridge::Ref acquires the GIL in its own destructor, so default teardown is
 * safe from any thread. */
Grid::~Grid() = default;

Grid& Grid::operator=(const Grid& other) {
  if (this != &other) {
    Grid tmp(other);
    state_ = std::move(tmp.state_);
  }
  return *this;
}

int Grid::max_dim_x() const {
  return static_cast<int>(detail::grid_attr(state_, "max_dim_x"));
}
int Grid::max_dim_y() const {
  return static_cast<int>(detail::grid_attr(state_, "max_dim_y"));
}
int Grid::max_dim_z() const {
  return static_cast<int>(detail::grid_attr(state_, "max_dim_z"));
}
int Grid::max_num_local_z_columns() const {
  return static_cast<int>(detail::grid_attr(state_, "max_num_local_z_columns"));
}
int Grid::max_local_z_length() const {
  return static_cast<int>(detail::grid_attr(state_, "max_local_z_length"));
}
SpfftProcessingUnitType Grid::processing_unit() const {
  return static_cast<SpfftProcessingUnitType>(
      detail::grid_attr(state_, "processing_unit"));
}
int Grid::device_id() const {
  return static_cast<int>(detail::grid_attr(state_, "device_id"));
}
int Grid::max_num_threads() const {
  return static_cast<int>(detail::grid_attr(state_, "max_num_threads"));
}
int Grid::num_shards() const {
  return static_cast<int>(detail::grid_attr(state_, "num_shards"));
}

DistributedTransform Grid::create_transform_distributed(
    SpfftProcessingUnitType processing_unit, SpfftTransformType transform_type,
    int dim_x, int dim_y, int dim_z, int num_shards, const int* shard_num_elements,
    SpfftIndexFormatType index_format, const int* indices,
    bool double_precision) const {
  return DistributedTransform(detail::make_dist_plan(
      *this, double_precision, processing_unit, transform_type, dim_x, dim_y, dim_z,
      num_shards, shard_num_elements, index_format, indices));
}

Transform Grid::create_transform(SpfftProcessingUnitType processing_unit,
                                 SpfftTransformType transform_type, int dim_x, int dim_y,
                                 int dim_z, int local_z_length, int num_local_elements,
                                 SpfftIndexFormatType index_format,
                                 const int* indices) const {
  return Transform(detail::make_plan(this, true, processing_unit, transform_type, dim_x,
                                     dim_y, dim_z, local_z_length, num_local_elements,
                                     index_format, indices));
}

TransformFloat Grid::create_transform_float(SpfftProcessingUnitType processing_unit,
                                            SpfftTransformType transform_type, int dim_x,
                                            int dim_y, int dim_z, int local_z_length,
                                            int num_local_elements,
                                            SpfftIndexFormatType index_format,
                                            const int* indices) const {
  return TransformFloat(detail::make_plan(this, false, processing_unit, transform_type,
                                          dim_x, dim_y, dim_z, local_z_length,
                                          num_local_elements, index_format, indices));
}

/* ---- Transform (double) --------------------------------------------------- */

Transform::Transform(SpfftProcessingUnitType processing_unit,
                     SpfftTransformType transform_type, int dim_x, int dim_y, int dim_z,
                     int num_local_elements, SpfftIndexFormatType index_format,
                     const int* indices)
    : plan_(detail::make_plan(nullptr, true, processing_unit, transform_type, dim_x,
                              dim_y, dim_z, 0, num_local_elements, index_format,
                              indices)) {}

Transform Transform::clone() const { return Transform(detail::clone_plan(plan_)); }

void Transform::backward(const double* input, SpfftProcessingUnitType) {
  plan_->backward(input);
}

void Transform::backward(const double* input, double* output) {
  plan_->backward(input);
  std::memcpy(output, plan_->space.data(), plan_->space.size());
}

void Transform::forward(SpfftProcessingUnitType, double* output,
                        SpfftScalingType scaling) {
  plan_->forward(plan_->space.data(), output, static_cast<int>(scaling));
}

void Transform::forward(const double* input, double* output, SpfftScalingType scaling) {
  plan_->forward(input, output, static_cast<int>(scaling));
}

double* Transform::space_domain_data(SpfftProcessingUnitType) {
  return reinterpret_cast<double*>(plan_->space.data());
}

SpfftTransformType Transform::type() const {
  return static_cast<SpfftTransformType>(plan_->meta.transform_type);
}
int Transform::dim_x() const { return plan_->meta.dim_x; }
int Transform::dim_y() const { return plan_->meta.dim_y; }
int Transform::dim_z() const { return plan_->meta.dim_z; }
int Transform::local_z_length() const { return plan_->meta.local_z_length; }
int Transform::local_z_offset() const { return plan_->meta.local_z_offset; }
long long Transform::local_slice_size() const { return plan_->meta.local_slice_size; }
long long Transform::num_local_elements() const { return plan_->num_values; }
long long Transform::num_global_elements() const {
  return plan_->meta.num_global_elements;
}
long long Transform::global_size() const { return plan_->meta.global_size; }
SpfftProcessingUnitType Transform::processing_unit() const {
  return static_cast<SpfftProcessingUnitType>(plan_->meta.processing_unit);
}
int Transform::device_id() const { return plan_->meta.device_id; }
int Transform::num_threads() const { return plan_->meta.num_threads; }
SpfftExecType Transform::execution_mode() const {
  return static_cast<SpfftExecType>(plan_->get("execution_mode"));
}
void Transform::set_execution_mode(SpfftExecType mode) {
  plan_->set_execution_mode(static_cast<int>(mode));
}

/* ---- TransformFloat ------------------------------------------------------- */

TransformFloat::TransformFloat(SpfftProcessingUnitType processing_unit,
                               SpfftTransformType transform_type, int dim_x, int dim_y,
                               int dim_z, int num_local_elements,
                               SpfftIndexFormatType index_format, const int* indices)
    : plan_(detail::make_plan(nullptr, false, processing_unit, transform_type, dim_x,
                              dim_y, dim_z, 0, num_local_elements, index_format,
                              indices)) {}

TransformFloat TransformFloat::clone() const {
  return TransformFloat(detail::clone_plan(plan_));
}

void TransformFloat::backward(const float* input, float* output) {
  plan_->backward(input);
  std::memcpy(output, plan_->space.data(), plan_->space.size());
}

void TransformFloat::backward(const float* input, SpfftProcessingUnitType) {
  plan_->backward(input);
}

void TransformFloat::forward(SpfftProcessingUnitType, float* output,
                             SpfftScalingType scaling) {
  plan_->forward(plan_->space.data(), output, static_cast<int>(scaling));
}

void TransformFloat::forward(const float* input, float* output,
                             SpfftScalingType scaling) {
  plan_->forward(input, output, static_cast<int>(scaling));
}

float* TransformFloat::space_domain_data(SpfftProcessingUnitType) {
  return reinterpret_cast<float*>(plan_->space.data());
}

SpfftTransformType TransformFloat::type() const {
  return static_cast<SpfftTransformType>(plan_->meta.transform_type);
}
int TransformFloat::dim_x() const { return plan_->meta.dim_x; }
int TransformFloat::dim_y() const { return plan_->meta.dim_y; }
int TransformFloat::dim_z() const { return plan_->meta.dim_z; }
int TransformFloat::local_z_length() const { return plan_->meta.local_z_length; }
int TransformFloat::local_z_offset() const { return plan_->meta.local_z_offset; }
long long TransformFloat::local_slice_size() const {
  return plan_->meta.local_slice_size;
}
long long TransformFloat::num_local_elements() const { return plan_->num_values; }
long long TransformFloat::num_global_elements() const {
  return plan_->meta.num_global_elements;
}
long long TransformFloat::global_size() const { return plan_->meta.global_size; }
SpfftProcessingUnitType TransformFloat::processing_unit() const {
  return static_cast<SpfftProcessingUnitType>(plan_->meta.processing_unit);
}
int TransformFloat::device_id() const { return plan_->meta.device_id; }
int TransformFloat::num_threads() const { return plan_->meta.num_threads; }
SpfftExecType TransformFloat::execution_mode() const {
  return static_cast<SpfftExecType>(plan_->get("execution_mode"));
}
void TransformFloat::set_execution_mode(SpfftExecType mode) {
  plan_->set_execution_mode(static_cast<int>(mode));
}

/* ---- multi-transform ------------------------------------------------------ */

namespace {

/* space_override[i], when non-null, replaces transform i's internal space
 * buffer as the space-domain side (the reference's pointer-based overloads,
 * multi_transform.hpp:64-95); byte count matches the internal buffer. */
template <typename TransformT>
void multi_backward_impl(int n, TransformT* transforms, const void* const* input,
                         void* const* space_override = nullptr) {
  bridge::Gil gil;
  bridge::Ref transform_list(bridge::checked(PyList_New(n)));
  bridge::Ref inputs(bridge::checked(PyList_New(n)));
  bridge::Ref outputs(bridge::checked(PyList_New(n)));
  for (int i = 0; i < n; ++i) {
    detail::Plan* p = detail::plan_of(transforms[i]);
    Py_INCREF(p->py.get());
    PyList_SET_ITEM(transform_list.get(), i, p->py.get());
    bridge::Ref in = bridge::view_ro(
        input[i], static_cast<std::size_t>(2 * p->num_values) * p->elem_bytes());
    PyList_SET_ITEM(inputs.get(), i, in.release());
    void* space = space_override ? space_override[i] : p->space.data();
    bridge::Ref out = bridge::view_rw(space, p->space.size());
    PyList_SET_ITEM(outputs.get(), i, out.release());
  }
  bridge::call("multi_backward", Py_BuildValue("(OOO)", transform_list.get(),
                                               inputs.get(), outputs.get()));
}

template <typename TransformT>
void multi_forward_impl(int n, TransformT* transforms, void* const* output,
                        const SpfftScalingType* scaling_types,
                        const void* const* space_override = nullptr) {
  bridge::Gil gil;
  bridge::Ref transform_list(bridge::checked(PyList_New(n)));
  bridge::Ref spaces(bridge::checked(PyList_New(n)));
  bridge::Ref outputs(bridge::checked(PyList_New(n)));
  bridge::Ref scalings(bridge::checked(PyList_New(n)));
  for (int i = 0; i < n; ++i) {
    detail::Plan* p = detail::plan_of(transforms[i]);
    Py_INCREF(p->py.get());
    PyList_SET_ITEM(transform_list.get(), i, p->py.get());
    const void* space = space_override ? space_override[i] : p->space.data();
    bridge::Ref space_view = bridge::view_ro(space, p->space.size());
    PyList_SET_ITEM(spaces.get(), i, space_view.release());
    bridge::Ref out = bridge::view_rw(
        output[i], static_cast<std::size_t>(2 * p->num_values) * p->elem_bytes());
    PyList_SET_ITEM(outputs.get(), i, out.release());
    PyList_SET_ITEM(scalings.get(), i,
                    bridge::checked(PyLong_FromLong(
                        scaling_types ? static_cast<long>(scaling_types[i]) : 0)));
  }
  bridge::call("multi_forward", Py_BuildValue("(OOOO)", transform_list.get(),
                                              spaces.get(), outputs.get(),
                                              scalings.get()));
}

} // namespace

void multi_transform_backward(int num_transforms, Transform* transforms,
                              const double* const* input,
                              const SpfftProcessingUnitType*) {
  multi_backward_impl(num_transforms, transforms,
                      reinterpret_cast<const void* const*>(input));
}

void multi_transform_forward(int num_transforms, Transform* transforms,
                             const SpfftProcessingUnitType*, double* const* output,
                             const SpfftScalingType* scaling_types) {
  multi_forward_impl(num_transforms, transforms,
                     reinterpret_cast<void* const*>(const_cast<double**>(output)),
                     scaling_types);
}

void multi_transform_backward(int num_transforms, TransformFloat* transforms,
                              const float* const* input,
                              const SpfftProcessingUnitType*) {
  multi_backward_impl(num_transforms, transforms,
                      reinterpret_cast<const void* const*>(input));
}

void multi_transform_forward(int num_transforms, TransformFloat* transforms,
                             const SpfftProcessingUnitType*, float* const* output,
                             const SpfftScalingType* scaling_types) {
  multi_forward_impl(num_transforms, transforms,
                     reinterpret_cast<void* const*>(const_cast<float**>(output)),
                     scaling_types);
}

void multi_transform_backward(int num_transforms, Transform* transforms,
                              const double* const* input, double* const* space_output) {
  multi_backward_impl(num_transforms, transforms,
                      reinterpret_cast<const void* const*>(input),
                      reinterpret_cast<void* const*>(const_cast<double**>(space_output)));
}

void multi_transform_forward(int num_transforms, Transform* transforms,
                             const double* const* space_input, double* const* output,
                             const SpfftScalingType* scaling_types) {
  multi_forward_impl(num_transforms, transforms,
                     reinterpret_cast<void* const*>(const_cast<double**>(output)),
                     scaling_types,
                     reinterpret_cast<const void* const*>(space_input));
}

void multi_transform_backward(int num_transforms, TransformFloat* transforms,
                              const float* const* input, float* const* space_output) {
  multi_backward_impl(num_transforms, transforms,
                      reinterpret_cast<const void* const*>(input),
                      reinterpret_cast<void* const*>(const_cast<float**>(space_output)));
}

void multi_transform_forward(int num_transforms, TransformFloat* transforms,
                             const float* const* space_input, float* const* output,
                             const SpfftScalingType* scaling_types) {
  multi_forward_impl(num_transforms, transforms,
                     reinterpret_cast<void* const*>(const_cast<float**>(output)),
                     scaling_types,
                     reinterpret_cast<const void* const*>(space_input));
}

/* ---- DistributedTransform ------------------------------------------------- */

void DistributedTransform::backward(const double* values, double* space_output) {
  plan_->check_precision(true);
  plan_->backward(values, space_output);
}
void DistributedTransform::backward(const float* values, float* space_output) {
  plan_->check_precision(false);
  plan_->backward(values, space_output);
}
void DistributedTransform::forward(const double* space, double* values_output,
                                   SpfftScalingType scaling) {
  plan_->check_precision(true);
  plan_->forward(space, values_output, static_cast<int>(scaling));
}
void DistributedTransform::forward(const float* space, float* values_output,
                                   SpfftScalingType scaling) {
  plan_->check_precision(false);
  plan_->forward(space, values_output, static_cast<int>(scaling));
}

SpfftTransformType DistributedTransform::type() const {
  return static_cast<SpfftTransformType>(plan_->meta.transform_type);
}
int DistributedTransform::dim_x() const { return plan_->meta.dim_x; }
int DistributedTransform::dim_y() const { return plan_->meta.dim_y; }
int DistributedTransform::dim_z() const { return plan_->meta.dim_z; }
int DistributedTransform::num_shards() const { return plan_->meta.num_shards; }
long long DistributedTransform::num_global_elements() const {
  return plan_->num_global;
}
long long DistributedTransform::global_size() const { return plan_->meta.global_size; }
SpfftProcessingUnitType DistributedTransform::processing_unit() const {
  return static_cast<SpfftProcessingUnitType>(plan_->meta.processing_unit);
}
SpfftExchangeType DistributedTransform::exchange_type() const {
  return static_cast<SpfftExchangeType>(plan_->meta.exchange_type);
}
long long DistributedTransform::exchange_wire_bytes() const {
  return plan_->meta.wire_bytes;
}
int DistributedTransform::exchange_rounds() const {
  return plan_->meta.exchange_rounds;
}
bool DistributedTransform::double_precision() const { return plan_->dbl; }

int DistributedTransform::local_z_length(int shard) const {
  plan_->check_shard(shard);
  return static_cast<int>(plan_->shard_zlen[shard]);
}
int DistributedTransform::local_z_offset(int shard) const {
  plan_->check_shard(shard);
  return static_cast<int>(plan_->shard_zoff[shard]);
}
int DistributedTransform::local_y_length(int shard) const {
  plan_->check_shard(shard);
  return static_cast<int>(plan_->shard_ylen[shard]);
}
int DistributedTransform::local_y_offset(int shard) const {
  plan_->check_shard(shard);
  return static_cast<int>(plan_->shard_yoff[shard]);
}
long long DistributedTransform::local_slice_size(int shard) const {
  plan_->check_shard(shard);
  return plan_->shard_slice[shard];
}
long long DistributedTransform::num_local_elements(int shard) const {
  plan_->check_shard(shard);
  return plan_->shard_elems[shard];
}

} // namespace spfft
