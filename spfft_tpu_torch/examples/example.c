/*
 * Minimal spfft-tpu C API example — the reference example flow
 * (reference: examples/example.c behavior): triplets -> grid -> transform ->
 * backward -> space pointer -> forward with scaling.
 *
 * Build: python -m spfft_tpu_torch.native builds libspfft_tpu_torch.so and
 * this example into build/spfft_tpu_torch/native/<hash>/ and prints the
 * directory and the PYTHONPATH the embedded interpreter needs. By hand:
 *   cc spfft_tpu_torch/examples/example.c -Ispfft_tpu_torch/native/include \
 *      -L<dir> -lspfft_tpu_torch -o example
 *   LD_LIBRARY_PATH=<dir> PYTHONPATH=<checkout>:<site-packages> ./example
 */
#include <stdio.h>
#include <stdlib.h>

#include <spfft/spfft.h>

int main(void) {
  const int dim = 4;
  const int n = dim * dim * dim;

  int* indices = (int*)malloc((size_t)(3 * n) * sizeof(int));
  int k = 0;
  for (int x = 0; x < dim; ++x)
    for (int y = 0; y < dim; ++y)
      for (int z = 0; z < dim; ++z) {
        indices[k++] = x;
        indices[k++] = y;
        indices[k++] = z;
      }

  SpfftGrid grid = NULL;
  if (spfft_grid_create(&grid, dim, dim, dim, dim * dim, SPFFT_PU_HOST, 1) !=
      SPFFT_SUCCESS)
    return 1;

  SpfftTransform transform = NULL;
  if (spfft_transform_create(&transform, grid, SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim, dim,
                             dim, dim, n, SPFFT_INDEX_TRIPLETS, indices) != SPFFT_SUCCESS)
    return 1;
  /* The grid handle may be destroyed right away: the transform keeps the
   * shared resources alive (reference semantics). */
  spfft_grid_destroy(grid);

  double* freq = (double*)malloc((size_t)(2 * n) * sizeof(double));
  for (int i = 0; i < n; ++i) {
    freq[2 * i] = (double)(i + 1) / n;      /* re */
    freq[2 * i + 1] = -(double)(i + 1) / n; /* im */
  }

  if (spfft_transform_backward(transform, freq, SPFFT_PU_HOST) != SPFFT_SUCCESS) return 1;

  double* space = NULL;
  if (spfft_transform_get_space_domain(transform, SPFFT_PU_HOST, &space) != SPFFT_SUCCESS)
    return 1;
  printf("space domain, first element: %f + %fi\n", space[0], space[1]);

  if (spfft_transform_forward(transform, SPFFT_PU_HOST, freq, SPFFT_FULL_SCALING) !=
      SPFFT_SUCCESS)
    return 1;
  printf("roundtrip, first element: %f + %fi (expected %f + %fi)\n", freq[0], freq[1],
         1.0 / n, -1.0 / n);

  /* `space` points into transform-owned memory; only the handles are freed. */
  spfft_transform_destroy(transform);
  free(freq);
  free(indices);
  return 0;
}
