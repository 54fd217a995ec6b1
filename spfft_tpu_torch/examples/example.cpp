/*
 * Minimal spfft-tpu C++ API example — the reference example flow
 * (reference: examples/example.cpp behavior): triplets -> Grid -> Transform ->
 * backward -> space_domain_data -> forward with scaling.
 *
 * Build: python -m spfft_tpu_torch.native builds libspfft_tpu_torch.so and
 * this example into build/spfft_tpu_torch/native/<hash>/ and prints the
 * directory and the PYTHONPATH the embedded interpreter needs. By hand:
 *   c++ -std=c++17 spfft_tpu_torch/examples/example.cpp \
 *       -Ispfft_tpu_torch/native/include -L<dir> -lspfft_tpu_torch -o example_cpp
 *   LD_LIBRARY_PATH=<dir> PYTHONPATH=<checkout>:<site-packages> ./example_cpp
 */
#include <cstdio>
#include <vector>

#include <spfft/spfft.hpp>

int main() {
  const int dim = 4;
  const int n = dim * dim * dim;

  std::vector<int> indices;
  indices.reserve(3 * n);
  for (int x = 0; x < dim; ++x)
    for (int y = 0; y < dim; ++y)
      for (int z = 0; z < dim; ++z) {
        indices.push_back(x);
        indices.push_back(y);
        indices.push_back(z);
      }

  spfft::Grid grid(dim, dim, dim, dim * dim, SPFFT_PU_HOST, 1);
  spfft::Transform transform = grid.create_transform(
      SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim, dim, dim, dim, n, SPFFT_INDEX_TRIPLETS,
      indices.data());

  std::vector<double> freq(2 * n);
  for (int i = 0; i < n; ++i) {
    freq[2 * i] = double(i + 1) / n;
    freq[2 * i + 1] = -double(i + 1) / n;
  }

  transform.backward(freq.data(), SPFFT_PU_HOST);
  const double* space = transform.space_domain_data(SPFFT_PU_HOST);
  std::printf("space domain, first element: %f + %fi\n", space[0], space[1]);

  transform.forward(SPFFT_PU_HOST, freq.data(), SPFFT_FULL_SCALING);
  std::printf("roundtrip, first element: %f + %fi (expected %f + %fi)\n", freq[0],
              freq[1], 1.0 / n, -1.0 / n);
  return 0;
}
