/*
 * Distributed spfft-tpu C API example: a 4-shard mesh transform from C.
 *
 * Single-controller model: this ONE process drives every shard of the device
 * mesh (the reference's per-rank MPI arrays become shard-major concatenated
 * buffers): with SPFFT_PU_HOST the four shards sit stacked on the CPU.
 *
 * Build: python -m spfft_tpu_torch.native builds libspfft_tpu_torch.so and
 * this example into build/spfft_tpu_torch/native/<hash>/ and prints the
 * directory and the PYTHONPATH the embedded interpreter needs. By hand:
 *   cc spfft_tpu_torch/examples/example_distributed.c \
 *      -Ispfft_tpu_torch/native/include -L<dir> -lspfft_tpu_torch -o example_distributed
 *   LD_LIBRARY_PATH=<dir> PYTHONPATH=<checkout>:<site-packages> ./example_distributed
 */
#include <stdio.h>
#include <stdlib.h>

#include <spfft/spfft.h>

int main(void) {
  const int dim = 8;
  const int shards = 4;
  const int n = dim * dim * dim;

  /* shard r owns the z-sticks with x in {2r, 2r+1} (whole sticks per shard —
   * the hard constraint of the decomposition) */
  int counts[4];
  int* indices = (int*)malloc((size_t)(3 * n) * sizeof(int));
  int k = 0;
  for (int r = 0; r < shards; ++r) {
    counts[r] = 2 * dim * dim;
    for (int x = 2 * r; x < 2 * r + 2; ++x)
      for (int y = 0; y < dim; ++y)
        for (int z = 0; z < dim; ++z) {
          indices[k++] = x;
          indices[k++] = y;
          indices[k++] = z;
        }
  }

  /* Exact-counts exchange (the reference's COMPACT_BUFFERED / Alltoallv). */
  SpfftGrid grid = NULL;
  if (spfft_grid_create_distributed(&grid, dim, dim, dim, dim * dim, dim, shards,
                                    SPFFT_EXCH_COMPACT_BUFFERED, SPFFT_PU_HOST,
                                    1) != SPFFT_SUCCESS) {
    fprintf(stderr, "grid creation failed\n");
    return 1;
  }

  SpfftDistTransform t = NULL;
  if (spfft_dist_transform_create(&t, grid, SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim, dim,
                                  dim, shards, counts, SPFFT_INDEX_TRIPLETS, indices,
                                  1) != SPFFT_SUCCESS) {
    fprintf(stderr, "transform creation failed\n");
    return 1;
  }

  long long wire = 0;
  spfft_dist_transform_exchange_wire_bytes(t, &wire);
  printf("4-shard plan; %lld interconnect bytes per repartition\n", wire);

  /* shard-major concatenated complex values; global (Z, Y, X) space slab */
  double* values = (double*)malloc((size_t)(2 * n) * sizeof(double));
  double* space = (double*)malloc((size_t)(2 * n) * sizeof(double));
  double* back = (double*)malloc((size_t)(2 * n) * sizeof(double));
  for (int i = 0; i < 2 * n; ++i) values[i] = (double)(i % 7) - 3.0;

  if (spfft_dist_transform_backward(t, values, space) != SPFFT_SUCCESS) return 1;
  if (spfft_dist_transform_forward(t, space, back, SPFFT_FULL_SCALING) !=
      SPFFT_SUCCESS)
    return 1;

  double max_err = 0.0;
  for (int i = 0; i < 2 * n; ++i) {
    double d = back[i] - values[i];
    if (d < 0) d = -d;
    if (d > max_err) max_err = d;
  }
  printf("distributed roundtrip max error: %g\n", max_err);

  spfft_dist_transform_destroy(t);
  spfft_grid_destroy(grid);
  free(values);
  free(space);
  free(back);
  free(indices);
  return max_err < 1e-10 ? 0 : 1;
}
