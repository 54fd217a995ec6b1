/*
 * spfft_tpu native API — C++ Grid class.
 *
 * Source-compatible with the reference spfft::Grid (reference:
 * include/spfft/grid.hpp:49-205). A Grid declares maximum transform
 * dimensions and hands out Transform plans; the PyTorch core allocates each
 * plan's device buffers itself rather than sharing host arrays, so the Grid is pure capacity metadata plus a shared runtime handle.
 */
#ifndef SPFFT_TPU_GRID_HPP
#define SPFFT_TPU_GRID_HPP

#include <spfft/transform.hpp>
#include <spfft/types.h>

#include <memory>

namespace spfft {

class Grid;

namespace detail {
struct GridState;
const std::shared_ptr<GridState>& grid_state(const Grid& grid);
} // namespace detail

class Grid {
public:
  /* Local grid (reference: grid.hpp:65-66). */
  Grid(int max_dim_x, int max_dim_y, int max_dim_z, int max_num_local_z_columns,
       SpfftProcessingUnitType processing_unit, int max_num_threads);

  /* Distributed grid over a device mesh (the reference's MPI ctor,
   * grid.hpp:89-91, in single-controller form: ONE process drives every shard
   * of the mesh; num_shards replaces the MPI communicator). */
  Grid(int max_dim_x, int max_dim_y, int max_dim_z, int max_num_local_z_columns,
       int max_local_z_length, int num_shards, SpfftExchangeType exchange_type,
       SpfftProcessingUnitType processing_unit, int max_num_threads);

  /* 2-D pencil mesh (p1 x p2): z-slabs x y-slabs in space; lifts the slab
   * decomposition's P <= dimZ cap to dimZ * dimY shards. */
  Grid(int max_dim_x, int max_dim_y, int max_dim_z, int max_num_local_z_columns,
       int max_local_z_length, int p1, int p2, SpfftExchangeType exchange_type,
       SpfftProcessingUnitType processing_unit, int max_num_threads);

  /* Copy creates independent capacity (reference copy ctor allocates fresh
   * buffers, grid.hpp "copy = fresh buffers"). */
  Grid(const Grid&);
  Grid(Grid&&) noexcept;
  Grid& operator=(const Grid&);
  Grid& operator=(Grid&&) noexcept;
  ~Grid();

  /* Create a double-precision transform bound to this grid
   * (reference: grid.hpp:138-141). */
  Transform create_transform(SpfftProcessingUnitType processing_unit,
                             SpfftTransformType transform_type, int dim_x, int dim_y,
                             int dim_z, int local_z_length, int num_local_elements,
                             SpfftIndexFormatType index_format, const int* indices) const;

  /* Single-precision variant (reference: GridFloat::create_transform). */
  TransformFloat create_transform_float(SpfftProcessingUnitType processing_unit,
                                        SpfftTransformType transform_type, int dim_x,
                                        int dim_y, int dim_z, int local_z_length,
                                        int num_local_elements,
                                        SpfftIndexFormatType index_format,
                                        const int* indices) const;

  /* Distributed transform over this grid's mesh (grid must be distributed).
   * shard_num_elements: per-shard value counts; indices: shard-major
   * concatenated triplets (3 * sum(shard_num_elements) ints). */
  DistributedTransform create_transform_distributed(
      SpfftProcessingUnitType processing_unit, SpfftTransformType transform_type,
      int dim_x, int dim_y, int dim_z, int num_shards, const int* shard_num_elements,
      SpfftIndexFormatType index_format, const int* indices,
      bool double_precision = true) const;

  int max_dim_x() const;
  int max_dim_y() const;
  int max_dim_z() const;
  int max_num_local_z_columns() const;
  int max_local_z_length() const;
  SpfftProcessingUnitType processing_unit() const;
  int device_id() const;
  int max_num_threads() const;
  /* 1 for local grids; the mesh size for distributed ones. */
  int num_shards() const;

private:
  friend const std::shared_ptr<detail::GridState>& detail::grid_state(const Grid&);

  std::shared_ptr<detail::GridState> state_;
};

/* Precision lives on the Transform in this build; GridFloat is the same
 * capacity object (reference keeps two classes only because its buffers are
 * typed). */
typedef Grid GridFloat;

} // namespace spfft

#endif // SPFFT_TPU_GRID_HPP
