// K1: planar batched strided complex matrix product, C[b] = A[b] . B[b].
//
// Replaces the TPU kernel spfft_tpu/ops/pallas_fft.py:95 complex_matmul_fused
// (kernel body :37): (xr + i xi) @ (wr + i wi) -> (yr, yi) as four real dots
// with f32 accumulation. Here it carries every DFT stage of the accelerator
// engine (z, y and x, both directions) with no transpose materialised.
//
// float32: on the tensor cores (wgmma), at the plan's precision (k1_tc.cuh):
//   "highest" 3xTF32 at FP32 accuracy (this library), "high" bf16x3 and
//   "default" one bf16 pass (complex_matmul_bf16x3.cu, _bf16x1.cu).
//   Bound: at the 256^3 / radius 0.659 C2C headline the stages do 59 GFLOP per
//   backward. Without tensor cores the card does 67 TFLOP/s in FP32; TF32 on
//   the tensor cores does 495, and FP32 accuracy from TF32 costs three
//   products per real product, so the least time is 3 F / 495 TFLOP/s, about
//   2.5x below the FP32 bound. BF16 runs at 989 TFLOP/s: "high" is bounded by
//   3 F / 989, "default" by F / 989. At every stage shape that least time is
//   set by the tensor cores, not by HBM.
//   Each f32 value a is split as a = hi + lo with hi = rna_tf32(a) and
//   lo = rna_tf32(a - hi) (a - hi is exact), and a.b = lo.hi + hi.lo + hi.hi
//   with FP32 accumulation: the small terms first ("high": the same with
//   round-to-nearest BF16 parts; "default": hi.hi alone). Raw f32 is never
//   handed to the tensor cores, which would read only its top 19 bits.
//   Every stage has one operand that is a plan constant (a DFT matrix,
//   shared by the batch or one per batch entry) and one that is data. The
//   kernel computes O = D . V with
//   D the data (P x K, any strides) and V the constant (K x Q): for the z
//   stage D = A and V = B, for the y and x stages O = C^T, D = B^T, V = A^T.
//   V comes prepared (ops/complex_matmul.py: tile_constant): split into hi
//   and lo planes, transposed to K-major, padded to the tile and laid out in
//   the 128-byte swizzle, one contiguous block per (Q tile, K tile), so that
//   a linear copy lands it in shared memory as wgmma's B operand wants it.
//   D is copied in its native layout ([p][k] when k is contiguous, else
//   [k][p]) and split in registers as wgmma's A operand is read: TF32 wgmma
//   takes a shared-memory operand only K-major, which D is not in the y and
//   x stages. Block: two warpgroups of 64 rows of P each, a Q tile of 64 or
//   88 (whichever pads Q least: 256 = 4 x 64, 176 = 2 x 88, 88), K tiles of
//   128 bytes of V (32 tf32, 64 bf16) through a ring of stages (three where
//   they fit, else two),
//   so that the next tiles load while the tensor cores run. The tensor
//   cores round each wgmma's sum toward zero, so they sum one K tile at a
//   time and FP32 registers add the K tiles (see the main loop); that costs a
//   second set of accumulators, and so the Q tile is 64 and not 128. One
//   block fits on an SM (shared memory and registers), so the kernel is
//   persistent: one block per SM walks over the output tiles and streams
//   their K tiles through one ring, and the next tile loads while this one
//   finishes. The output is stored straight from the accumulators, eight
//   lanes to a 32-byte sector of its contiguous axis, through any strides
//   (the sparse-y stages write columns of the (Y, A, Z) grid).
//
// float64: the SIMT body, a 64x64 output tile per 256-thread block, K-slices
//   of 16 staged in shared memory, a 4x4 register micro-tile of complex
//   accumulators, FMA in double. The FP64 tensor cores (DMMA) are a later step.
//
// A null imaginary pointer means that part is absent: a real operand (the
// R2C forward x stage), or only the real part of the product kept (the R2C
// backward x stage, Re = Ar Br - Ai Bi).
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "k1_tc.cuh"

namespace {

// ---- float64: the SIMT body ----------------------------------------------------

namespace simt {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = 256;  // 16 x 16 threads, each TM x TN outputs
constexpr int PAD = 1;        // breaks bank conflicts of k-major tile stores

template <typename T, bool A_IM, bool B_IM, bool C_IM>
__global__ void __launch_bounds__(THREADS) complex_matmul_kernel(
    const T* __restrict__ ar, const T* __restrict__ ai,
    int64_t a_sb, int64_t a_sm, int64_t a_sk,
    const T* __restrict__ br, const T* __restrict__ bi,
    int64_t b_sb, int64_t b_sk, int64_t b_sn,
    T* __restrict__ cr, T* __restrict__ ci,
    int64_t c_sb, int64_t c_sm, int64_t c_sn,
    int64_t M, int64_t N, int64_t K) {
  __shared__ T as_r[BK][BM + PAD];
  __shared__ T as_i[A_IM ? BK : 1][BM + PAD];
  __shared__ T bs_r[BK][BN + PAD];
  __shared__ T bs_i[B_IM ? BK : 1][BN + PAD];

  const int64_t batch = blockIdx.z;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  ar += batch * a_sb;
  br += batch * b_sb;
  if constexpr (A_IM) ai += batch * a_sb;
  if constexpr (B_IM) bi += batch * b_sb;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // Neighbouring threads load neighbouring addresses: along m when A's rows
  // are its contiguous axis, else along k; along n for B unless k is contiguous.
  const bool a_m_fast = (a_sm == 1);
  const bool b_n_fast = (b_sn == 1) || (b_sk != 1);

  T acc_r[TM][TN];
  T acc_i[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_r[i][j] = T(0);
      acc_i[i][j] = T(0);
    }
  }

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int mm = a_m_fast ? e % BM : e / BK;
      const int kk = a_m_fast ? e / BM : e % BK;
      const int64_t gm = m0 + mm, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      const int64_t off = gm * a_sm + gk * a_sk;
      as_r[kk][mm] = ok ? ar[off] : T(0);
      if constexpr (A_IM) as_i[kk][mm] = ok ? ai[off] : T(0);
    }
#pragma unroll
    for (int l = 0; l < BN * BK / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int nn = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const int64_t gn = n0 + nn, gk = k0 + kk;
      const bool ok = gn < N && gk < K;
      const int64_t off = gk * b_sk + gn * b_sn;
      bs_r[kk][nn] = ok ? br[off] : T(0);
      if constexpr (B_IM) bs_i[kk][nn] = ok ? bi[off] : T(0);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a_r[TM], a_i[TM], b_r[TN], b_i[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a_r[i] = as_r[kk][ty + 16 * i];
        if constexpr (A_IM) a_i[i] = as_i[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b_r[j] = bs_r[kk][tx + 16 * j];
        if constexpr (B_IM) b_i[j] = bs_i[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_r[i][j] = fma(a_r[i], b_r[j], acc_r[i][j]);
          if constexpr (A_IM && B_IM) acc_r[i][j] = fma(-a_i[i], b_i[j], acc_r[i][j]);
          if constexpr (C_IM && B_IM) acc_i[i][j] = fma(a_r[i], b_i[j], acc_i[i][j]);
          if constexpr (C_IM && A_IM) acc_i[i][j] = fma(a_i[i], b_r[j], acc_i[i][j]);
        }
      }
    }
    __syncthreads();
  }

  cr += batch * c_sb;
  if constexpr (C_IM) ci += batch * c_sb;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const int64_t off = gm * c_sm + gn * c_sn;
      cr[off] = acc_r[i][j];
      if constexpr (C_IM) ci[off] = acc_i[i][j];
    }
  }
}

template <bool A_IM, bool B_IM, bool C_IM>
cudaError_t launch(const void* ar, const void* ai, int64_t a_sb, int64_t a_sm, int64_t a_sk,
                   const void* br, const void* bi, int64_t b_sb, int64_t b_sk, int64_t b_sn,
                   void* cr, void* ci, int64_t c_sb, int64_t c_sm, int64_t c_sn,
                   int64_t batch, int64_t M, int64_t N, int64_t K, cudaStream_t stream) {
  using T = double;
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>(batch));
  complex_matmul_kernel<T, A_IM, B_IM, C_IM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(ar), static_cast<const T*>(ai), a_sb, a_sm, a_sk,
      static_cast<const T*>(br), static_cast<const T*>(bi), b_sb, b_sk, b_sn,
      static_cast<T*>(cr), static_cast<T*>(ci), c_sb, c_sm, c_sn, M, N, K);
  return cudaGetLastError();
}

}  // namespace simt

}  // namespace

// float32, 3xTF32. D (P x K) is the data, with element (b, p, k) at
// d + b d_sb + p d_sp + k d_sk (di may be null); d_kmajor picks the [p][k]
// shared-memory layout (else [k][p]), d_tma the TMA copies (the contiguous
// axis of D has stride 1, its other strides are multiples of 4 and its
// pointers 16-byte aligned; else D is copied element by element). V is the
// prepared constant (tile_constant in ops/complex_matmul.py) for a Q tile of bn (64 or 88),
// with v_im saying whether it has imaginary planes and v_sb its batch stride
// in bytes (0 when shared). O (P x Q) gets element (b, p, q) at
// o + b o_sb + p o_sp + q o_sq (o_i null keeps the real part only). Strides
// are in elements. Returns the cudaError_t of the launch (0 on success).
extern "C" int spfft_complex_matmul_tf32x3(
    const float* dr, const float* di, int64_t d_sb, int64_t d_sp, int64_t d_sk,
    int d_kmajor, int d_tma,
    const void* v, int64_t v_sb, int v_im, int bn,
    float* o_r, float* o_i, int64_t o_sb, int64_t o_sp, int64_t o_sq,
    int64_t batch, int64_t P, int64_t Q, int64_t K, void* stream) {
  return tc::run<tc::Tf32x3>(dr, di, d_sb, d_sp, d_sk, d_kmajor, d_tma, v, v_sb, v_im, bn,
                             o_r, o_i, o_sb, o_sp, o_sq, batch, P, Q, K, stream);
}

// float64, SIMT: C[b] = A[b] . B[b] with (batch, row, col) strides in elements.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int spfft_complex_matmul_f64(
    const void* ar, const void* ai, int64_t a_sb, int64_t a_sm, int64_t a_sk,
    const void* br, const void* bi, int64_t b_sb, int64_t b_sk, int64_t b_sn,
    void* cr, void* ci, int64_t c_sb, int64_t c_sm, int64_t c_sn,
    int64_t batch, int64_t M, int64_t N, int64_t K, void* stream) {
  using namespace simt;
  if (batch < 1 || M < 1 || N < 1 || K < 0 || batch > 65535 ||
      (M + BM - 1) / BM > 65535 || (N + BN - 1) / BN > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPFFT_K1_ARGS ar, ai, a_sb, a_sm, a_sk, br, bi, b_sb, b_sk, b_sn, \
                      cr, ci, c_sb, c_sm, c_sn, batch, M, N, K, s
  const int key = (ai != nullptr) * 4 + (bi != nullptr) * 2 + (ci != nullptr);
  cudaError_t e;
  switch (key) {
    case 0: e = launch<false, false, false>(SPFFT_K1_ARGS); break;
    case 1: e = launch<false, false, true>(SPFFT_K1_ARGS); break;
    case 2: e = launch<false, true, false>(SPFFT_K1_ARGS); break;
    case 3: e = launch<false, true, true>(SPFFT_K1_ARGS); break;
    case 4: e = launch<true, false, false>(SPFFT_K1_ARGS); break;
    case 5: e = launch<true, false, true>(SPFFT_K1_ARGS); break;
    case 6: e = launch<true, true, false>(SPFFT_K1_ARGS); break;
    default: e = launch<true, true, true>(SPFFT_K1_ARGS); break;
  }
#undef SPFFT_K1_ARGS
  return static_cast<int>(e);
}
