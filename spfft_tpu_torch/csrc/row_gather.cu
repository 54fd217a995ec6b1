// K2: row gather, out[r, :] = src[idx[r], :] for 0 <= idx[r] < n_src, else a zero row.
//
// Replaces the TPU row-gather kernels of programs/microbench_pallas_dma.py:140
// (grid kernel :115) and :193 (ring kernel :157), microbench_pallas_dma2.py:112
// and microbench_pallas_dma3.py:119. All four gather rows by a scalar-prefetched
// index table, the copy-plan gather that the accelerator engine's expand
// (sticks -> (Y, A, Z) planes) and pack (planes -> sticks), and the slab
// exchange's pack and unpack, perform.
//
// Bound: no arithmetic, so bytes over the card's memory rate (3.35 TB/s); the
// only lever is to keep the memory pipe full. The rows are narrow: 32 float32
// (128 bytes) in the 512^3 exchange, 64 or 70 in the 256^3 mesh plans, 256 in
// the local expand and pack. A warp per row, as this kernel first was, left
// 24 of 32 lanes idle on 128-byte rows. Design, for every width:
//   - the copy is of bytes, in vectors of 16, 8 or 4 bytes: the widest that
//     divides the row's bytes, both row strides and all four plane pointers
//     (vector_bytes()). A float64 row, or a column block at an 8-byte offset
//     (the skewed plan's 70-float rows), still moves in 8-byte vectors, and
//     float32 and float64 share one kernel;
//   - the output is a flat list of n_rows x C vectors (C = row bytes / vector
//     bytes), one thread a vector: consecutive threads take consecutive
//     vectors across row boundaries, so a warp covers four 128-byte rows at
//     once and every lane is busy at every width. Neighbouring threads read
//     the same index: a broadcast. The source goes through ld.global.nc (it is
//     read once), the output through st.global.cs (nothing here reads it);
//   - one short-lived block per 256 vectors, left to the hardware's block
//     scheduler, which keeps every SM busy to the end. On an H100 this was
//     0-7 % faster than a persistent grid (the SMs times the resident
//     blocks) with one, two or four vectors' loads in flight a thread, on
//     every form but the smallest (0.5 MB, where the persistent grid was
//     0.1 us faster), and four vectors a thread on short-lived blocks were
//     no faster (k2_ab.py at the root of the repo; PERF.md, section 6);
//   - an out-of-range index (the engine's sentinels are -1 and n_src) writes
//     zeros with the same vector stores, so no zero-padded source is built.
// A ring of whole-row bulk copies (cp.async.bulk, the TMA) through shared
// memory, for rows of 1 KB and more, was no faster on an H100 and is not
// kept (PERF.md, section 6).
// Rows sit ld_src (ld_out) elements apart, so a plane may be a column block
// of a wider buffer: the exchange's collective route packs (re, im) side by
// side into one (rows, 2 W) send buffer and unpacks from the received one,
// with no copy around the collective; the kernel writes only its own columns.
// Offsets are 64-bit (a 512^3 float64 plane is about 1 GB). The output must
// not alias the source. The launch is on the caller's stream; nothing is
// allocated and nothing synchronises.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 2147483647;  // the grid's x limit

struct Args {
  const char* src_re;
  const char* src_im;
  char* out_re;
  char* out_im;  // null for one plane (then src_im is null too)
  const int32_t* idx;
  int64_t n_rows, n_src;
  int64_t row_bytes, ld_src, ld_out;  // bytes
};

// V: int4, int2 or int, the vector of 16, 8 or 4 bytes. chunks: vectors a
// row; ld_src, ld_out in vectors.
template <typename V>
__global__ void __launch_bounds__(THREADS) row_gather_kernel(
    const V* __restrict__ src_re, const V* __restrict__ src_im, V* __restrict__ out_re,
    V* __restrict__ out_im, const int32_t* __restrict__ idx, int64_t n_rows, int64_t n_src,
    int64_t chunks, int64_t ld_src, int64_t ld_out) {
  const bool two = out_im != nullptr;
  const int64_t total = n_rows * chunks;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; v < total;
       v += static_cast<int64_t>(gridDim.x) * THREADS) {
    const int64_t r = v / chunks, c = v - r * chunks;
    const int64_t s = __ldg(idx + r);
    const bool ok = s >= 0 && s < n_src;
    const V a = ok ? __ldg(src_re + s * ld_src + c) : V{};
    const V b = two && ok ? __ldg(src_im + s * ld_src + c) : V{};
    __stcs(out_re + r * ld_out + c, a);
    if (two) __stcs(out_im + r * ld_out + c, b);
  }
}

template <typename V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int64_t vec = sizeof(V);
  const int64_t chunks = a.row_bytes / vec;
  const int64_t want = (a.n_rows * chunks + THREADS - 1) / THREADS;
  const int64_t blocks = want < MAX_BLOCKS ? want : MAX_BLOCKS;
  row_gather_kernel<V><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      reinterpret_cast<const V*>(a.src_re), reinterpret_cast<const V*>(a.src_im),
      reinterpret_cast<V*>(a.out_re), reinterpret_cast<V*>(a.out_im), a.idx, a.n_rows, a.n_src,
      chunks, a.ld_src / vec, a.ld_out / vec);
  return cudaGetLastError();
}

// The widest vector (16, 8 or 4 bytes) dividing the row's bytes, both row
// strides and every plane pointer; 0 if none does.
int vector_bytes(const Args& a) {
  const uint64_t bits = static_cast<uint64_t>(a.row_bytes) | static_cast<uint64_t>(a.ld_src) |
                        static_cast<uint64_t>(a.ld_out) |
                        reinterpret_cast<uintptr_t>(a.src_re) |
                        reinterpret_cast<uintptr_t>(a.src_im) |
                        reinterpret_cast<uintptr_t>(a.out_re) |
                        reinterpret_cast<uintptr_t>(a.out_im);
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 0;
}

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
      (src_im == nullptr) != (out_im == nullptr) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t item = dtype == 0 ? 4 : 8;
  const Args a{static_cast<const char*>(src_re), static_cast<const char*>(src_im),
               static_cast<char*>(out_re), static_cast<char*>(out_im),
               static_cast<const int32_t*>(idx), n_rows, n_src, width * item, ld_src * item,
               ld_out * item};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vector_bytes(a)) {
    case 16: return static_cast<int>(launch<int4>(a, s));
    case 8: return static_cast<int>(launch<int2>(a, s));
    case 4: return static_cast<int>(launch<int>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
