// K1: planar batched strided complex matrix product, C[b] = A[b] . B[b].
//
// Replaces the TPU kernel spfft_tpu/ops/pallas_fft.py:95 complex_matmul_fused
// (kernel body :37): (xr + i xi) @ (wr + i wi) -> (yr, yi) as four real dots
// with f32 accumulation. Here it carries every DFT stage of the accelerator
// engine (z, y and x, both directions) with no transpose materialised: each
// operand comes with (batch, row, col) strides, a batch stride of 0 shares one
// matrix across the batch, and a transposed matrix is a swap of its strides.
//
// A null imaginary pointer means that part is absent: a null ai or bi is a real
// operand (the R2C forward x stage), a null ci keeps only the real part of the
// product (the R2C backward x stage, Re = Ar Br - Ai Bi).
//
// Bound: at the 256^3 / radius 0.659 C2C headline the stages do 59 GFLOP per
// backward at K = 176..256, so in float32 without tensor cores (the precision
// of Precision.HIGHEST) the kernel is bound by the card's FP32 FMA rate, not by
// its memory. The design is the plain first step toward that bound: a 64x64
// output tile per 256-thread block, K-slices of 16 of A and B (real and
// imaginary planes) staged in shared memory, a 4x4 register micro-tile of
// complex accumulators per thread, the four-product form with FMA
// accumulation in the operand type (float or double), and masked edges so that
// any M, N and K work. wgmma, TMA and 3xTF32 are later steps.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = 256;  // 16 x 16 threads, each TM x TN outputs
constexpr int PAD = 1;        // breaks bank conflicts of k-major tile stores

__device__ __forceinline__ float fmadd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return fma(a, b, c); }

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
          acc_r[i][j] = fmadd(a_r[i], b_r[j], acc_r[i][j]);
          if constexpr (A_IM && B_IM) acc_r[i][j] = fmadd(-a_i[i], b_i[j], acc_r[i][j]);
          if constexpr (C_IM && B_IM) acc_i[i][j] = fmadd(a_r[i], b_i[j], acc_i[i][j]);
          if constexpr (C_IM && A_IM) acc_i[i][j] = fmadd(a_i[i], b_r[j], acc_i[i][j]);
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

template <typename T, bool A_IM, bool B_IM, bool C_IM>
cudaError_t launch(const void* ar, const void* ai, int64_t a_sb, int64_t a_sm, int64_t a_sk,
                   const void* br, const void* bi, int64_t b_sb, int64_t b_sk, int64_t b_sn,
                   void* cr, void* ci, int64_t c_sb, int64_t c_sm, int64_t c_sn,
                   int64_t batch, int64_t M, int64_t N, int64_t K, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>(batch));
  complex_matmul_kernel<T, A_IM, B_IM, C_IM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(ar), static_cast<const T*>(ai), a_sb, a_sm, a_sk,
      static_cast<const T*>(br), static_cast<const T*>(bi), b_sb, b_sk, b_sn,
      static_cast<T*>(cr), static_cast<T*>(ci), c_sb, c_sm, c_sn, M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* ar, const void* ai, int64_t a_sb, int64_t a_sm, int64_t a_sk,
                     const void* br, const void* bi, int64_t b_sb, int64_t b_sk, int64_t b_sn,
                     void* cr, void* ci, int64_t c_sb, int64_t c_sm, int64_t c_sn,
                     int64_t batch, int64_t M, int64_t N, int64_t K, cudaStream_t stream) {
#define SPFFT_K1_ARGS ar, ai, a_sb, a_sm, a_sk, br, bi, b_sb, b_sk, b_sn, \
                      cr, ci, c_sb, c_sm, c_sn, batch, M, N, K, stream
  const int key = (ai != nullptr) * 4 + (bi != nullptr) * 2 + (ci != nullptr);
  switch (key) {
    case 0: return launch<T, false, false, false>(SPFFT_K1_ARGS);
    case 1: return launch<T, false, false, true>(SPFFT_K1_ARGS);
    case 2: return launch<T, false, true, false>(SPFFT_K1_ARGS);
    case 3: return launch<T, false, true, true>(SPFFT_K1_ARGS);
    case 4: return launch<T, true, false, false>(SPFFT_K1_ARGS);
    case 5: return launch<T, true, false, true>(SPFFT_K1_ARGS);
    case 6: return launch<T, true, true, false>(SPFFT_K1_ARGS);
    default: return launch<T, true, true, true>(SPFFT_K1_ARGS);
  }
#undef SPFFT_K1_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Strides are in elements. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int spfft_complex_matmul(
    int dtype,
    const void* ar, const void* ai, int64_t a_sb, int64_t a_sm, int64_t a_sk,
    const void* br, const void* bi, int64_t b_sb, int64_t b_sk, int64_t b_sn,
    void* cr, void* ci, int64_t c_sb, int64_t c_sm, int64_t c_sn,
    int64_t batch, int64_t M, int64_t N, int64_t K, void* stream) {
  if (batch < 1 || M < 1 || N < 1 || K < 0 || batch > 65535 ||
      (M + BM - 1) / BM > 65535 || (N + BN - 1) / BN > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(dispatch<float>(ar, ai, a_sb, a_sm, a_sk, br, bi, b_sb, b_sk, b_sn,
                                            cr, ci, c_sb, c_sm, c_sn, batch, M, N, K, s));
  }
  if (dtype == 1) {
    return static_cast<int>(dispatch<double>(ar, ai, a_sb, a_sm, a_sk, br, bi, b_sb, b_sk, b_sn,
                                             cr, ci, c_sb, c_sm, c_sn, batch, M, N, K, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
