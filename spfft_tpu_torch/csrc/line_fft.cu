// The line FFT: a batched radix FFT of power-of-two length N (64 to 1024)
// along one axis, float32 on the CUDA cores, for the local engine's z and x
// stages (ops/line_fft.py).
//
// It replaces no TPU kernel. It takes the z and x stages from K1
// (complex_matmul.cu, the counterpart of spfft_tpu/ops/pallas_fft.py:95),
// which keeps the y stage and every plan the rule of ops/line_fft.py leaves
// out. K1 runs a length-N DFT as a dense N x N product: O(N^2) work a line
// on the tensor cores, whose TF32 rate bounds it. As an FFT the line is
// about 5 N log2 N operations, under 0.1 ms of FP32 at the 512^3 forms, and
// the stage is bound by its bytes in HBM (3.35 TB/s on an H100): each value
// read once and written once. Design, to meet that bound:
//   - a block holds 4096 values of 512 threads' lines in shared memory and
//     registers: 8 values a thread, at the positions t + e N/8 of its line
//     (e = 0..7), the only positions it reads from and writes to HBM; three
//     blocks an SM, so that one's loads are in flight while the others run
//     their passes (a persistent block that prefetched its next values
//     through cp.async spilled registers and was slower);
//   - Stockham passes of radix 8 (then one 2 or 4): a pass runs its
//     butterflies in registers, exchanges the values through shared memory
//     (two barriers), and needs no bit reversal; the twiddles come from one
//     table of exp(2 pi i m / N), computed in float64 on the host and
//     rounded once to float32, read through the read-only cache;
//   - the z stage (mode rows) reads and writes whole rows, 32 lanes on 32
//     consecutive floats; the x stages (to_space, from_space) read a y plane
//     in chunks of L = 4096 / N z columns (8 floats, one 32-byte sector, at
//     N = 512), lanes along z, so every access is coalesced and the line's
//     stride costs nothing;
//   - shared memory is padded (a word every 8 in a row; columns at an odd or
//     2 mod 4 pitch) so that the strided writes of the passes fall in
//     distinct banks, at worst two to a bank;
//   - the slot maps of the x stage live in the load (to_space: position n
//     reads slot inv[n], zero where none; the hermitian weights for a real
//     output) and in the store (from_space: slot a takes position ux[a]
//     through shared memory, a padding slot zero), so no copy surrounds it;
//   - every product and sum is rounded on its own (__fmul_rn, __fadd_rn:
//     no fused multiply-add), in the order of the plain version
//     (ops/line_fft.fft_plain), so the two agree to the bit on the card.
// The launch is on the caller's stream; nothing is allocated and nothing
// synchronises. Offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PER = 8;         // values of a line a thread holds
constexpr int THREADS = 512;   // a block
// Blocks an SM holds: 40 registers a thread, no spill. At two (64
// registers) the x forms took 4-18 % longer: with a block's loads in flight
// only while it has not begun its passes, HBM's latency needs the third.
constexpr int BLOCKS_PER_SM = 3;
constexpr int VALUES = PER * THREADS;  // values a block holds
constexpr int ROWS = 0, TO_SPACE = 1, FROM_SPACE = 2;
constexpr float HALF_SQRT2 = 0.70710678118654752f;

struct Args {
  const float* in_re;
  const float* in_im;  // null: a real input (from_space)
  float* out_re;
  float* out_im;       // null: a real output (to_space, with the hermitian weights)
  const float2* table; // (N,): cos, sin of 2 pi m / N
  const int32_t* map;  // to_space: inv (N,); from_space: ux (A,)
  int64_t d0, d1, d2;  // rows: rows; x modes: Y, A, Z
  int64_t in_s0, in_s1, out_s0, out_s1;  // element strides of the two outer axes
  float scale;
};

// Lines of one block: rows (mode rows) or z columns (x modes).
template <int N>
__host__ __device__ constexpr int lines() { return VALUES / N; }

// The x modes' column pitch in shared memory: the block's z columns, padded
// where the passes' strided writes would meet in one bank.
template <int N>
__host__ __device__ constexpr int pitch() {
  return lines<N>() >= 32 ? lines<N>() : lines<N>() == 16 ? 18 : lines<N>() + 1;
}

template <int N, int MODE>
__host__ __device__ constexpr int smem_floats() {
  return MODE == ROWS ? VALUES + VALUES / 8 : N * pitch<N>();
}

// Where position n of line l lives in shared memory.
template <int N, int MODE>
__device__ __forceinline__ int at(int l, int n) {
  if constexpr (MODE == ROWS) {
    return l * (N + N / 8) + n + (n >> 3);
  } else {
    return n * pitch<N>() + l;
  }
}

// (dr, di) times W8^k, W8 = exp(SIGN 2 pi i / 8), as ops/line_fft._radix.
template <int SIGN>
__device__ __forceinline__ void w8(int k, float& dr, float& di) {
  const float sdr = SIGN > 0 ? dr : -dr, sdi = SIGN > 0 ? di : -di;
  if (k == 1) {
    const float r = __fmul_rn(HALF_SQRT2, __fsub_rn(dr, sdi));
    di = __fmul_rn(HALF_SQRT2, __fadd_rn(di, sdr));
    dr = r;
  } else if (k == 2) {
    dr = -sdi;
    di = sdr;
  } else if (k == 3) {
    const float r = -__fmul_rn(HALF_SQRT2, __fadd_rn(dr, sdi));
    di = __fmul_rn(HALF_SQRT2, __fsub_rn(sdr, di));
    dr = r;
  }
}

// The radix-R DFT in registers: radix-2 decimation in frequency, then the
// outputs from bit-reversed to natural order.
template <int R, int SIGN>
__device__ __forceinline__ void dft(float (&xr)[R], float (&xi)[R]) {
  constexpr int STAGES = R == 8 ? 3 : R == 4 ? 2 : 1;
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    const int h = R >> (s + 1);
#pragma unroll
    for (int b = 0; b < R; b += 2 * h) {
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float ar = xr[b + i], ai = xi[b + i], cr = xr[b + i + h], ci = xi[b + i + h];
        xr[b + i] = __fadd_rn(ar, cr);
        xi[b + i] = __fadd_rn(ai, ci);
        float dr = __fsub_rn(ar, cr), di = __fsub_rn(ai, ci);
        w8<SIGN>(4 * i / h, dr, di);
        xr[b + i + h] = dr;
        xi[b + i + h] = di;
      }
    }
  }
  float yr[R], yi[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = R == 8   ? ((q & 1) << 2) | (q & 2) | (q >> 2)
                  : R == 4 ? ((q & 1) << 1) | (q >> 1)
                           : q;  // q bit-reversed
    yr[q] = xr[r];
    yi[q] = xi[r];
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    xr[q] = yr[q];
    xi[q] = yi[q];
  }
}

// The pass of stride NS and every pass after it. On entry the thread holds
// positions t + e N/8 of the pass's input; on return, of the FFT's output.
template <int N, int NS, int MODE, int SIGN>
__device__ __forceinline__ void passes(float (&vr)[PER], float (&vi)[PER], float* sre,
                                       float* sim, int l, int t, const float2* __restrict__ table) {
  constexpr int T = N / PER;
  constexpr int R = (N / NS) % 8 == 0 ? 8 : N / NS;
  constexpr int STEP = PER / R;  // butterflies a thread runs in this pass
#pragma unroll
  for (int m = 0; m < STEP; ++m) {
    const int j = t + m * T;
    const int k = j & (NS - 1);
    float ur[R], ui[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ur[r] = vr[m + r * STEP];
      ui[r] = vi[m + r * STEP];
    }
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = __ldg(table + r * k * (N / (NS * R)));
        const float ws = SIGN > 0 ? w.y : -w.y;
        const float xr = ur[r], xi = ui[r];
        ur[r] = __fsub_rn(__fmul_rn(xr, w.x), __fmul_rn(xi, ws));
        ui[r] = __fadd_rn(__fmul_rn(xr, ws), __fmul_rn(xi, w.x));
      }
    }
    dft<R, SIGN>(ur, ui);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      vr[m + q * STEP] = ur[q];
      vi[m + q * STEP] = ui[q];
    }
  }
  if constexpr (NS * R < N) {
    if constexpr (NS > 1) __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int m = 0; m < STEP; ++m) {
      const int j = t + m * T;
      const int base = (j / NS) * NS * R + (j & (NS - 1));
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int s = at<N, MODE>(l, base + q * NS);
        sre[s] = vr[m + q * STEP];
        sim[s] = vi[m + q * STEP];
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int s = at<N, MODE>(l, t + e * T);
      vr[e] = sre[s];
      vi[e] = sim[s];
    }
    passes<N, NS * R, MODE, SIGN>(vr, vi, sre, sim, l, t, table);
  }
}

template <int N, int MODE, int SIGN>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) line_fft_kernel(const Args a) {
  constexpr int T = N / PER, L = lines<N>();
  __shared__ float sre[smem_floats<N, MODE>()], sim[smem_floats<N, MODE>()];
  const int tid = threadIdx.x;
  const int t = MODE == ROWS ? tid % T : tid / L;
  const int l = MODE == ROWS ? tid / T : tid % L;
  float vr[PER], vi[PER];
  const float scale = a.scale;

  if constexpr (MODE == ROWS) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * L + l;
    const bool live = row < a.d0;
    const float* pr = a.in_re + (live ? row * a.in_s0 : 0);
    const float* pi = a.in_im + (live ? row * a.in_s0 : 0);
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      vr[e] = live ? __ldg(pr + t + e * T) : 0.0f;
      vi[e] = live ? __ldg(pi + t + e * T) : 0.0f;
    }
    passes<N, 1, MODE, SIGN>(vr, vi, sre, sim, l, t, a.table);
    if (live) {
      float* qr = a.out_re + row * a.out_s0;
      float* qi = a.out_im + row * a.out_s0;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        qr[t + e * T] = scale != 1.0f ? __fmul_rn(vr[e], scale) : vr[e];
        qi[t + e * T] = scale != 1.0f ? __fmul_rn(vi[e], scale) : vi[e];
      }
    }
    return;
  }
  // x modes: one y plane, the z columns [z0, z0 + L)
  const int64_t chunks = (a.d2 + L - 1) / L;
  const int64_t y = blockIdx.x / chunks;
  const int64_t z = (blockIdx.x - y * chunks) * L + l;
  const bool live = z < a.d2;
  if constexpr (MODE == TO_SPACE) {
    const bool weights = a.out_im == nullptr;  // C2R: the hermitian weights
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int n = t + e * T;
      const int slot = __ldg(a.map + n);
      float xr = 0.0f, xi = 0.0f;
      if (live && slot >= 0) {
        const int64_t off = y * a.in_s0 + slot * a.in_s1 + z;
        xr = __ldg(a.in_re + off);
        xi = __ldg(a.in_im + off);
        if (weights && n != 0 && n != N / 2) {
          xr = __fmul_rn(xr, 2.0f);
          xi = __fmul_rn(xi, 2.0f);
        }
      }
      vr[e] = xr;
      vi[e] = xi;
    }
    passes<N, 1, MODE, SIGN>(vr, vi, sre, sim, l, t, a.table);
    if (live) {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int64_t off = y * a.out_s0 + static_cast<int64_t>(t + e * T) * a.out_s1 + z;
        a.out_re[off] = scale != 1.0f ? __fmul_rn(vr[e], scale) : vr[e];
        if (!weights) a.out_im[off] = scale != 1.0f ? __fmul_rn(vi[e], scale) : vi[e];
      }
    }
  } else if constexpr (MODE == FROM_SPACE) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int64_t off = y * a.in_s0 + static_cast<int64_t>(t + e * T) * a.in_s1 + z;
      vr[e] = live ? __ldg(a.in_re + off) : 0.0f;
      vi[e] = live && a.in_im != nullptr ? __ldg(a.in_im + off) : 0.0f;
    }
    passes<N, 1, MODE, SIGN>(vr, vi, sre, sim, l, t, a.table);
    // slot a takes position ux[a]: through shared memory
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int s = at<N, MODE>(l, t + e * T);
      sre[s] = vr[e];
      sim[s] = vi[e];
    }
    __syncthreads();
    if (live) {
      for (int64_t slot = t; slot < a.d1; slot += T) {
        const int n = __ldg(a.map + slot);
        float xr = 0.0f, xi = 0.0f;
        if (n >= 0) {
          xr = sre[at<N, MODE>(l, n)];
          xi = sim[at<N, MODE>(l, n)];
          if (scale != 1.0f) {
            xr = __fmul_rn(xr, scale);
            xi = __fmul_rn(xi, scale);
          }
        }
        const int64_t off = y * a.out_s0 + slot * a.out_s1 + z;
        a.out_re[off] = xr;
        a.out_im[off] = xi;
      }
    }
  }
}

template <int N, int MODE, int SIGN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int L = lines<N>();
  const int64_t blocks = MODE == ROWS ? (a.d0 + L - 1) / L : a.d0 * ((a.d2 + L - 1) / L);
  if (blocks < 1 || blocks > 2147483647) return cudaErrorInvalidValue;
  line_fft_kernel<N, MODE, SIGN><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_mode(int mode, int sign, const Args& a, cudaStream_t stream) {
  if (mode == ROWS) {
    return sign > 0 ? launch<N, ROWS, 1>(a, stream) : launch<N, ROWS, -1>(a, stream);
  }
  if (mode == TO_SPACE && sign > 0) return launch<N, TO_SPACE, 1>(a, stream);
  if (mode == FROM_SPACE && sign < 0) return launch<N, FROM_SPACE, -1>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 rows (the z stage: d0 rows of n, row strides in_s0, out_s0), 1
// to_space (the backward x stage: the (d0 = Y, d1 = A, d2 = Z) grid to the
// (Y, n, Z) space; map = inv, (n,); out_im null: the real part, with the
// hermitian weights), 2 from_space (the forward x stage: the (Y, n, Z) space,
// in_im null for a real one, to the (Y, A, Z) grid; map = ux, (A,)). in_s0,
// in_s1, out_s0, out_s1: element strides of the outer axes (z has stride 1).
// sign: +1 or -1 (to_space +1, from_space -1). scale multiplies every value
// stored. Returns the cudaError_t of the launch (0 on success).
extern "C" int spfft_line_fft(int mode, int n, int sign, const void* in_re, const void* in_im,
                              void* out_re, void* out_im, const void* table, const void* map,
                              int64_t d0, int64_t d1, int64_t d2, int64_t in_s0, int64_t in_s1,
                              int64_t out_s0, int64_t out_s1, float scale, void* stream) {
  const bool rows = mode == ROWS;
  if (in_re == nullptr || out_re == nullptr || table == nullptr || d0 < 1 ||
      (sign != 1 && sign != -1) || (mode != ROWS && mode != TO_SPACE && mode != FROM_SPACE) ||
      (rows && (in_im == nullptr || out_im == nullptr)) ||
      (!rows && (map == nullptr || d1 < 1 || d2 < 1)) ||
      (mode == TO_SPACE && in_im == nullptr) || (mode == FROM_SPACE && out_im == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(in_re), static_cast<const float*>(in_im),
               static_cast<float*>(out_re), static_cast<float*>(out_im),
               static_cast<const float2*>(table), static_cast<const int32_t*>(map),
               d0, d1, d2, in_s0, in_s1, out_s0, out_s1, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 64: return static_cast<int>(launch_mode<64>(mode, sign, a, s));
    case 128: return static_cast<int>(launch_mode<128>(mode, sign, a, s));
    case 256: return static_cast<int>(launch_mode<256>(mode, sign, a, s));
    case 512: return static_cast<int>(launch_mode<512>(mode, sign, a, s));
    case 1024: return static_cast<int>(launch_mode<1024>(mode, sign, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
