/*
 * C++-surface test: Grid copy fidelity across all three grid kinds (local,
 * 1-D distributed, 2-D pencil) — copies must rebuild the same mesh shape
 * (reference contract: copy = fresh buffers, same parameters,
 * grid_internal.cpp:233-262) — plus a transform from a copied pencil grid.
 */
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <spfft/spfft.hpp>

#define REQUIRE(cond)                                                                    \
  do {                                                                                   \
    if (!(cond)) {                                                                       \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);               \
      return 1;                                                                          \
    }                                                                                    \
  } while (0)

int main() {
  const int dim = 8;

  /* local grid copy */
  spfft::Grid local(dim, dim, dim, dim * dim, SPFFT_PU_HOST, 1);
  spfft::Grid local_copy(local);
  REQUIRE(local_copy.max_dim_x() == dim);
  REQUIRE(local_copy.num_shards() == 1);

  /* 1-D distributed grid copy keeps the mesh */
  spfft::Grid dist(dim, dim, dim, dim * dim, dim, 4, SPFFT_EXCH_COMPACT_BUFFERED,
                   SPFFT_PU_HOST, 1);
  spfft::Grid dist_copy(dist);
  REQUIRE(dist_copy.num_shards() == 4);

  /* 2-D pencil grid copy keeps the mesh SHAPE (2x2, not a 1-D 4-mesh) */
  spfft::Grid pencil(dim, dim, dim, dim * dim, dim, 2, 2, SPFFT_EXCH_DEFAULT,
                     SPFFT_PU_HOST, 1);
  spfft::Grid pencil_copy(pencil);
  REQUIRE(pencil_copy.num_shards() == 4);

  /* a transform from the COPIED pencil grid must use the 2-D decomposition:
   * per-shard y-split proves the mesh survived the copy */
  const int shards = 4;
  std::vector<int> counts(shards, 2 * dim * dim);
  std::vector<int> idx;
  for (int r = 0; r < shards; ++r)
    for (int x = 2 * r; x < 2 * r + 2; ++x)
      for (int y = 0; y < dim; ++y)
        for (int z = 0; z < dim; ++z) {
          idx.push_back(x);
          idx.push_back(y);
          idx.push_back(z);
        }
  spfft::DistributedTransform t = pencil_copy.create_transform_distributed(
      SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim, dim, dim, shards, counts.data(),
      SPFFT_INDEX_TRIPLETS, idx.data(), true);
  REQUIRE(t.num_shards() == 4);
  REQUIRE(t.local_y_length(0) == dim / 2); /* 2-D split, not full-Y slabs */
  REQUIRE(t.local_z_length(0) == dim / 2);

  const int n = dim * dim * dim;
  std::vector<double> freq(2 * n), space(2 * n), back(2 * n);
  for (int i = 0; i < 2 * n; ++i) freq[i] = (double)(i % 11) - 5.0;
  t.backward(freq.data(), space.data());
  t.forward(space.data(), back.data(), SPFFT_FULL_SCALING);
  double max_err = 0.0;
  for (int i = 0; i < 2 * n; ++i) max_err = std::max(max_err, std::fabs(back[i] - freq[i]));
  std::printf("pencil-copy roundtrip max err: %g\n", max_err);
  REQUIRE(max_err < 1e-10);

  std::printf("ALL NATIVE C++ TESTS PASSED\n");
  return 0;
}
