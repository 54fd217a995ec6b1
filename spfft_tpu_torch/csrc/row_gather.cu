// K2: row gather, out[r, :] = src[idx[r], :] for 0 <= idx[r] < n_src, else a zero row.
//
// Replaces the TPU row-gather kernels of programs/microbench_pallas_dma.py:140
// (grid kernel :115) and :193 (ring kernel :157), microbench_pallas_dma2.py:112
// and microbench_pallas_dma3.py:119. All four gather rows by a scalar-prefetched
// index table, the copy-plan gather that the accelerator engine's expand
// (sticks -> (Y, A, Z) planes) and pack (planes -> sticks) perform.
//
// Bound: no arithmetic, so bytes over the card's memory rate. At the 256^3 /
// radius 0.659 C2C headline the expand reads 22 365 sticks of 256 and writes
// 11.5 M elements per plane, about 138 MB in float32. Design: one warp per
// output row (8 rows per 256-thread block, grid-stride over rows), each row
// read once and written once, 16-byte vector loads and stores when the row
// width and the pointers allow (float4, double2), and both planes (re, im) of a
// row in the same pass so that the index is read once. An out-of-range index
// (the engine's sentinel for an empty (y, x) slot) writes zeros, so no
// zero-padded source is ever built. Rows sit ld_src (ld_out) elements apart, so
// a plane may be a column block of a wider buffer: the exchange's collective
// route packs (re, im) side by side into one (rows, 2 W) send buffer and
// unpacks from the received one, with no copy around the collective.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <typename V>
__global__ void __launch_bounds__(THREADS) row_gather_kernel(
    const V* __restrict__ src_re, const V* __restrict__ src_im,
    V* __restrict__ out_re, V* __restrict__ out_im,
    const int32_t* __restrict__ idx, int64_t n_rows, int64_t n_src, int64_t width,
    int64_t ld_src, int64_t ld_out) {
  const int lane = threadIdx.x % 32;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * ROWS_PER_BLOCK;
  const bool two = out_im != nullptr;
  for (int64_t r = warp; r < n_rows; r += stride) {
    const int64_t s = idx[r];
    const bool ok = s >= 0 && s < n_src;
    V* dre = out_re + r * ld_out;
    V* dim = two ? out_im + r * ld_out : nullptr;
    if (ok) {
      const V* sre = src_re + s * ld_src;
      const V* sim = two ? src_im + s * ld_src : nullptr;
      for (int64_t c = lane; c < width; c += 32) {
        dre[c] = sre[c];
        if (two) dim[c] = sim[c];
      }
    } else {
      V zero;
      char* z = reinterpret_cast<char*>(&zero);
      for (unsigned b = 0; b < sizeof(V); ++b) z[b] = 0;
      for (int64_t c = lane; c < width; c += 32) {
        dre[c] = zero;
        if (two) dim[c] = zero;
      }
    }
  }
}

template <typename V>
cudaError_t launch(const void* src_re, const void* src_im, void* out_re, void* out_im,
                   const void* idx, int64_t n_rows, int64_t n_src, int64_t width,
                   int64_t ld_src, int64_t ld_out, cudaStream_t stream) {
  const int64_t want = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const unsigned blocks = static_cast<unsigned>(want < 65536 * 8 ? want : 65536 * 8);
  row_gather_kernel<V><<<blocks, THREADS, 0, stream>>>(
      static_cast<const V*>(src_re), static_cast<const V*>(src_im),
      static_cast<V*>(out_re), static_cast<V*>(out_im),
      static_cast<const int32_t*>(idx), n_rows, n_src, width, ld_src, ld_out);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = float64. idx is int32; src_im/out_im may both be null
// for a single plane. ld_src, ld_out: elements between consecutive rows of the
// source and output planes (>= width). Returns the cudaError_t of the launch
// (0 on success).
extern "C" int spfft_row_gather(int dtype, const void* src_re, const void* src_im,
                                void* out_re, void* out_im, const void* idx,
                                int64_t n_rows, int64_t n_src, int64_t width,
                                int64_t ld_src, int64_t ld_out, void* stream) {
  if (n_rows < 1 || width < 1 || n_src < 0 || ld_src < width || ld_out < width ||
      (src_im == nullptr) != (out_im == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t item = dtype == 0 ? 4 : 8;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_vec = 16 / item;
  const bool vec = width % per_vec == 0 && ld_src % per_vec == 0 && ld_out % per_vec == 0 &&
                   aligned16(src_re) && aligned16(out_re) &&
                   (src_im == nullptr || (aligned16(src_im) && aligned16(out_im)));
  if (vec) {
    const int64_t w = width / per_vec, ls = ld_src / per_vec, lo = ld_out / per_vec;
    return static_cast<int>(dtype == 0
        ? launch<float4>(src_re, src_im, out_re, out_im, idx, n_rows, n_src, w, ls, lo, s)
        : launch<double2>(src_re, src_im, out_re, out_im, idx, n_rows, n_src, w, ls, lo, s));
  }
  return static_cast<int>(dtype == 0
      ? launch<float>(src_re, src_im, out_re, out_im, idx, n_rows, n_src, width, ld_src,
                      ld_out, s)
      : launch<double>(src_re, src_im, out_re, out_im, idx, n_rows, n_src, width, ld_src,
                       ld_out, s));
}
