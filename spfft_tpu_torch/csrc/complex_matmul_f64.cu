// K1's float64 body: planar batched strided complex matrix product on the
// FP64 tensor cores (DMMA, mma.sync m16n8k8 f64).
//
// Replaces the TPU kernel spfft_tpu/ops/pallas_fft.py:95 complex_matmul_fused
// (kernel body :37) for float64 plans: every DFT stage of the accelerator
// engine (z, y and x, both directions) with no transpose materialised. As in
// the float32 body (complex_matmul.cu, k1_tc.cuh), every stage has one
// operand that is a plan constant and one that is data, and the kernel
// computes O = D . V: D the data (P x K, any strides), V the constant (K x Q,
// shared by the batch or one per batch entry), O the result (any strides).
//
// Bound: the card does 67 TFLOP/s in FP64 on its tensor cores (DMMA) and half
// that on its FMA pipes, so the products go to DMMA. A float64 stage at the
// main path's shapes (K = 88 to 256, every output reads K values of D and of
// V) does far more operations per byte than the 20 FLOP per byte at which
// 67 TFLOP/s meets 3.35 TB/s, so DMMA bounds it, not HBM. The complex product
// takes Gauss's three real products where all four parts exist (the JAX
// package's default form, spfft_tpu/ops/fft.py:524-543):
//   t1 = Dr Vr, t2 = Di Vi, t3 = (Dr + Di)(Vr + Vi);  Re = t1 - t2,
//   Im = (t3 - t1) - t2
// so its bound is 3 products, not 4. Dr + Di and Vr + Vi are added in
// registers from the loaded fragments (a float64 sum rounds the same
// wherever it is made, so this is the plan constant's vr + vi bit for bit,
// and it costs no bytes to load). The forms with a part missing take their
// two products (real data: Dr Vr and Dr Vi; the real part only:
// Dr Vr - Di Vi), or one.
//
// Design:
//   Block: 8 warps (2 along P by 4 along Q), each owning a 32 x 16 tile of O
//   as 2 x 2 DMMA tiles of 16 x 8: a 64 x 64 block tile. Three accumulator
//   sets (t1, t2, t3) of 4 x 4 doubles a thread and the fragments of one
//   k step stay in registers (about 240 of them), so one block fits on an
//   SM; a larger warp tile spills. The four-product form needs two sets
//   where Gauss needs three, but at the 32 x 32 warp tile (128 x 64 a block)
//   that would halve its shared-memory traffic per product it spills, and it
//   ran slower than Gauss at the z and x forms, so Gauss stays.
//   Operand feed: a ring of 3 stages of K = 32 in shared memory. V comes from
//   the plan constant already in the order the B fragments read
//   (tile_constant_f64 in ops/complex_matmul.py): one (Q tile, K tile) block
//   of its planes is one bulk copy (TMA, no tensor map). D keeps its native
//   layout, rows of its contiguous axis (k when k-major, else p) at a padded
//   pitch, copied 16 bytes (two values) at a time with cp.async where its
//   contiguous axis has stride 1 and 16-byte alignment, else 8 bytes at a
//   time (any strides), zeros past P and K. The k order inside a stage is
//   permuted the same way for D and V (DMMA k slot t + 4c of lane 4g + t
//   holds k = 2t + c of its k step), and for a p-major D the rows of a DMMA
//   tile too (row g + 8h holds p = 2g + h), so that each thread's fragment
//   is one 16-byte load per (16-row tile, part, pair of values), and the
//   pads make a warp's loads free of bank conflicts.
//   A stage's full mbarrier completes when the V bytes and every thread's
//   copies have landed, its empty mbarrier when every thread is done with it.
//   Persistent: one block per SM walks over the output tiles (Q tile
//   fastest, then P tile, then batch) and streams their K tiles through one
//   ring, so the next tile loads while this one finishes. The result is
//   stored from the accumulators through any strides (the sparse-y stages
//   write columns of the (Y, A, Z) grid).
//   DMMA rounds like FMA, so the sums agree with the plain float64 product
//   to within its rounding (about 1e-15 of the largest output at K = 256).
//
// A null imaginary pointer means that part is absent: real data (the R2C
// forward x stage), a real constant, or only the real part of the product
// kept (the R2C backward x stage).
#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {
namespace f64 {

constexpr int THREADS = 256;
constexpr int WARPS_Q = 4;        // warps along Q; 2 along P
constexpr int WM = 2, WN = 2;     // 16 x 8 DMMA tiles per warp along P and Q
constexpr int BP = 64, BQ = 64;   // the block tile
constexpr int BK = 32;            // K per stage
constexpr int STEPS = BK / 8;     // DMMA k steps per stage
constexpr int STAGES = 3;
constexpr int PLANE = BQ * BK;    // doubles of one V plane per stage
// D in shared memory: k-major rows of BK values at a pitch of BK + 8, or
// p-major rows of BP values at a pitch of BP + 2 (conflict-free fragment loads)
constexpr int PITCH_K = BK + 8, PITCH_P = BP + 2;
constexpr int DPART = BP * PITCH_K > BK * PITCH_P ? BP * PITCH_K : BK * PITCH_P;

// d = a . b + d for a 16 x 8 x 8 f64 tile. Fragments (lane = 4 g + t):
// a[2c + h] = A(g + 8h, t + 4c), b[c] = B(t + 4c, g), d[2h + e] = D(g + 8h, 2t + e).
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

struct Args {
  const double* dr; const double* di;
  int64_t d_sb, d_sp, d_sk;
  const double* v; int64_t v_sb;  // V's batch stride in doubles (0 when shared)
  double* o_r; double* o_i;
  int64_t o_sb, o_sp, o_sq;
  int64_t P, Q, K;
  int d_vec, v_planes, q_tiles, p_tiles, k_tiles;
  int64_t tiles;  // batch x p_tiles x q_tiles
};

template <bool D_IM, bool V_IM, bool C_IM>
struct Form {
  static constexpr bool GAUSS = D_IM && V_IM && C_IM;
  // accumulator sets: t1 = Dr Vr; then t2 = Di Vi (Gauss, or the real part
  // only), Dr Vi (real data) or Di Vr (real constant); then t3 (Gauss)
  static constexpr bool TWO = (D_IM && V_IM) || (C_IM && (D_IM || V_IM));
  static constexpr int SETS = GAUSS ? 3 : (TWO ? 2 : 1);
  // D parts and V planes copied: Dr, and Di where a set reads it; Vr, and
  // Vi where a set reads it (Dr + Di and Vr + Vi are made in registers)
  static constexpr int DP = (D_IM && TWO) ? 2 : 1;
  static constexpr int VPL = (V_IM && (D_IM || C_IM)) ? 2 : 1;
  // the D part (Dr, Di, Dr + Di) and the V plane (Vr, Vi, Vr + Vi) of set n
  static __host__ __device__ constexpr int a_of(int n) { return n == 0 ? 0 : (n == 1 ? DP - 1 : 2); }
  static __host__ __device__ constexpr int b_of(int n) { return n == 0 ? 0 : (n == 1 ? VPL - 1 : 2); }
  static constexpr int STAGE = VPL * PLANE + DP * DPART;  // doubles
  static constexpr int SMEM = STAGES * (STAGE * 8 + 16) + 128;
};

template <bool D_IM, bool V_IM, bool C_IM, bool KMAJOR>
__global__ void __launch_bounds__(THREADS, 1) dmma_kernel(const __grid_constant__ Args args) {
  using F = Form<D_IM, V_IM, C_IM>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  double* smem = reinterpret_cast<double*>(smem_raw + ((128 - (raw & 127)) & 127));
  const uint32_t sbase = sm90::smem_addr(smem);
  const uint32_t bars = sbase + STAGES * F::STAGE * 8;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full(s), THREADS);
      sm90::mbar_init(empty(s), THREADS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int KT = args.k_tiles;
  const int64_t my_tiles =
      blockIdx.x < args.tiles ? (args.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  struct Tile { int64_t batch, p0, q0; int qt; };
  auto tile = [&](int64_t j) {
    const int64_t t = blockIdx.x + j * gridDim.x;
    const int64_t pq = static_cast<int64_t>(args.p_tiles) * args.q_tiles;
    const int qt = static_cast<int>(t % args.q_tiles);
    return Tile{t / pq, (t % pq) / args.q_tiles * BP, static_cast<int64_t>(qt) * BQ, qt};
  };

  // Fills ring slot s with K tile kt of output tile tl: V's planes in one
  // bulk copy; D in pairs of values along its contiguous axis, neighbouring
  // threads on neighbouring pairs, zeros past P and K.
  auto load = [&](int s, const Tile& tl, int kt) {
    const int64_t k0 = static_cast<int64_t>(kt) * BK;
    const uint32_t bar = full(s);
    const uint32_t stage = sbase + s * F::STAGE * 8;
    if (tid == 0) {
      const double* vsrc = args.v + tl.batch * args.v_sb +
                           (static_cast<int64_t>(tl.qt) * KT + kt) * args.v_planes * PLANE;
      sm90::mbar_expect_tx(bar, F::VPL * PLANE * 8);
      sm90::bulk_copy(stage, vsrc, F::VPL * PLANE * 8, bar);
    }
    const int64_t fast = KMAJOR ? args.d_sk : args.d_sp;  // stride within a pair
#pragma unroll
    for (int part = 0; part < F::DP; ++part) {
      const double* src = (part ? args.di : args.dr) + tl.batch * args.d_sb;
      const uint32_t ds = stage + (F::VPL * PLANE + part * DPART) * 8;
#pragma unroll
      for (int e = tid; e < BP * BK / 2; e += THREADS) {
        const int p = KMAJOR ? e / (BK / 2) : 2 * (e % (BP / 2));
        const int k = KMAJOR ? 2 * (e % (BK / 2)) : e / (BP / 2);
        // values of the pair inside D: 0, 1 or 2
        const int64_t left = KMAJOR ? args.K - (k0 + k) : args.P - (tl.p0 + p);
        const bool row_in = KMAJOR ? tl.p0 + p < args.P : k0 + k < args.K;
        const int n = row_in ? static_cast<int>(left < 0 ? 0 : (left > 2 ? 2 : left)) : 0;
        const double* gp = n ? src + (tl.p0 + p) * args.d_sp + (k0 + k) * args.d_sk : src;
        const uint32_t dst = ds + 8 * (KMAJOR ? p * PITCH_K + k : k * PITCH_P + p);
        if (args.d_vec) {
          sm90::cp_async_16(dst, gp, 8 * n);
        } else {
          sm90::cp_async_8(dst, gp, n > 0);
          sm90::cp_async_8(dst + 8, n > 1 ? gp + fast : src, n > 1);
        }
      }
    }
    sm90::mbar_arrive_cp_async(bar);
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wp = warp / WARPS_Q, wq = warp % WARPS_Q;
  const int g = lane / 4, t = lane % 4;
  double acc[F::SETS][WM][WN][4];
#pragma unroll
  for (int n = 0; n < F::SETS; ++n)
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][i][j][e] = 0.0;

  // Writes the finished tile j from the accumulators and clears them.
  auto store = [&](int64_t j) {
    const Tile tl = tile(j);
    double* o_r = args.o_r + tl.batch * args.o_sb;
    double* o_i = C_IM ? args.o_i + tl.batch * args.o_sb : nullptr;
#pragma unroll
    for (int i = 0; i < WM; ++i) {
#pragma unroll
      for (int jj = 0; jj < WN; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;  // DMMA row g + 8h: p = g + 8h, or 2g + h (p-major)
          const int64_t p = tl.p0 + (wp * WM + i) * 16 + (KMAJOR ? g + 8 * h : 2 * g + h);
          const int64_t q = tl.q0 + (wq * WN + jj) * 8 + 2 * t + (e & 1);
          const double t1 = acc[0][i][jj][e];
          const double t2 = F::SETS > 1 ? acc[F::SETS > 1 ? 1 : 0][i][jj][e] : 0.0;
          if (p < args.P && q < args.Q) {
            const int64_t off = p * args.o_sp + q * args.o_sq;
            if constexpr (F::GAUSS) {
              o_r[off] = t1 - t2;
              o_i[off] = (acc[F::SETS - 1][i][jj][e] - t1) - t2;
            } else if constexpr (D_IM && V_IM) {  // the real part only
              o_r[off] = t1 - t2;
            } else {
              o_r[off] = t1;
              if constexpr (C_IM) o_i[off] = t2;  // 0.0 when neither part is complex
            }
          }
#pragma unroll
          for (int n = 0; n < F::SETS; ++n) acc[n][i][jj][e] = 0.0;
        }
      }
    }
  };

  if (KT == 0) {
    for (int64_t j = 0; j < my_tiles; ++j) store(j);
    return;
  }
  // The ring's two ends, counted without divisions in the loop (a 64-bit
  // division costs hundreds of instructions, issued beside the DMMA): the
  // producer's next (tile, K tile, slot, round) and the consumer's.
  const int64_t total = my_tiles * KT;
  int64_t ld_j = 0;
  Tile ld_tl = tile(0);
  int ld_kt = 0, ld_slot = 0, ld_round = 0;
  auto load_next = [&]() {
    // a slot's fill of round r > 0 waits for the consumers of round r - 1
    if (ld_round > 0) sm90::mbar_wait(empty(ld_slot), static_cast<uint32_t>((ld_round - 1) & 1));
    load(ld_slot, ld_tl, ld_kt);
    if (++ld_kt == KT) {
      ld_kt = 0;
      if (++ld_j < my_tiles) ld_tl = tile(ld_j);
    }
    if (++ld_slot == STAGES) {
      ld_slot = 0;
      ++ld_round;
    }
  };
  int64_t issued = 0;
  for (; issued < STAGES - 1 && issued < total; ++issued) load_next();
  int s = 0, kt = 0;
  uint32_t s_round = 0;
  int64_t j = 0;
  for (int64_t it = 0; it < total; ++it) {
    // refill the slot of K tile it - 1 with K tile it + STAGES - 1, once
    // every thread is done with it
    if (issued < total) {
      load_next();
      ++issued;
    }
    sm90::mbar_wait(full(s), s_round & 1);

    const double* vs = smem + s * F::STAGE;
    const double* ds = vs + F::VPL * PLANE;
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      // A fragments: a[2c + h] holds (DMMA row g + 8h, k = 8 st + 2t + c)
      double a[3][WM][4];
#pragma unroll
      for (int part = 0; part < F::DP; ++part) {
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          const double* d = ds + part * DPART;
          const int r = (wp * WM + i) * 16, k = 8 * st + 2 * t;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if constexpr (KMAJOR) {  // row g + 8u, values c = 0, 1
              const double2 x = *reinterpret_cast<const double2*>(d + (r + g + 8 * u) * PITCH_K + k);
              a[part][i][u] = x.x;
              a[part][i][2 + u] = x.y;
            } else {  // k + u, rows p = 2g + h for h = 0, 1
              const double2 x = *reinterpret_cast<const double2*>(d + (k + u) * PITCH_P + r + 2 * g);
              a[part][i][2 * u] = x.x;
              a[part][i][2 * u + 1] = x.y;
            }
          }
        }
      }
      double b[3][WN][2];
#pragma unroll
      for (int pl = 0; pl < F::VPL; ++pl) {
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const double2 x = *reinterpret_cast<const double2*>(
              vs + pl * PLANE + (((wq * WN + j) * STEPS + st) * 32 + lane) * 2);
          b[pl][j][0] = x.x;
          b[pl][j][1] = x.y;
        }
      }
      if constexpr (F::GAUSS) {
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[2][i][e] = a[0][i][e] + a[1][i][e];
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) b[2][j][c] = b[0][j][c] + b[1][j][c];
      }
#pragma unroll
      for (int n = 0; n < F::SETS; ++n)
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j) dmma(acc[n][i][j], a[F::a_of(n)][i], b[F::b_of(n)][j]);
    }
    sm90::mbar_arrive(empty(s));
    if (++kt == KT) {
      store(j++);
      kt = 0;
    }
    if (++s == STAGES) {
      s = 0;
      ++s_round;
    }
  }
}

template <bool D_IM, bool V_IM, bool C_IM, bool KMAJOR>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  auto kernel = dmma_kernel<D_IM, V_IM, C_IM, KMAJOR>;
  constexpr int bytes = Form<D_IM, V_IM, C_IM>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = args.tiles < sms ? args.tiles : sms;
  kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(args);
  return cudaGetLastError();
}

template <bool D_IM, bool V_IM, bool C_IM>
cudaError_t launch(const Args& args, bool kmajor, cudaStream_t stream) {
  return kmajor ? launch<D_IM, V_IM, C_IM, true>(args, stream)
                : launch<D_IM, V_IM, C_IM, false>(args, stream);
}

}  // namespace f64
}  // namespace

// float64 on DMMA. D (P x K) is the data, with element (b, p, k) at
// d + b d_sb + p d_sp + k d_sk (di may be null); d_kmajor says which of its
// axes has the smaller stride (the one its rows run along in shared memory),
// d_vec that this axis has stride 1 and every pair of values along it is
// 16-byte aligned (then each pair is one copy, else two). V is the prepared
// constant (tile_constant_f64 in ops/complex_matmul.py), v_im saying whether
// it has imaginary planes (then Vr and Vi) and v_sb its batch stride in
// bytes (0 when shared). O (P x Q) gets element (b, p, q) at
// o + b o_sb + p o_sp + q o_sq (o_i null keeps the real part only). Strides
// are in elements. Returns the cudaError_t of the launch (0 on success).
extern "C" int spfft_complex_matmul_f64(
    const double* dr, const double* di, int64_t d_sb, int64_t d_sp, int64_t d_sk, int d_kmajor,
    int d_vec, const void* v, int64_t v_sb, int v_im,
    double* o_r, double* o_i, int64_t o_sb, int64_t o_sp, int64_t o_sq,
    int64_t batch, int64_t P, int64_t Q, int64_t K, void* stream) {
  using namespace f64;
  if (batch < 1 || P < 1 || Q < 1 || K < 0 || v_sb % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t q_tiles = (Q + BQ - 1) / BQ;
  const int64_t p_tiles = (P + BP - 1) / BP;
  const int64_t k_tiles = (K + BK - 1) / BK;
  if (q_tiles * p_tiles > 2147483647LL / batch || k_tiles > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{dr, di, d_sb, d_sp, d_sk, static_cast<const double*>(v), v_sb / 8,
                  o_r, o_i, o_sb, o_sp, o_sq, P, Q, K, d_vec, v_im ? 2 : 1,
                  static_cast<int>(q_tiles), static_cast<int>(p_tiles),
                  static_cast<int>(k_tiles), batch * p_tiles * q_tiles};
  const bool km = d_kmajor != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((di != nullptr) * 4 + (v_im != 0) * 2 + (o_i != nullptr)) {
    case 0: e = launch<false, false, false>(args, km, s); break;
    case 1: e = launch<false, false, true>(args, km, s); break;
    case 2: e = launch<false, true, false>(args, km, s); break;
    case 3: e = launch<false, true, true>(args, km, s); break;
    case 4: e = launch<true, false, false>(args, km, s); break;
    case 5: e = launch<true, false, true>(args, km, s); break;
    case 6: e = launch<true, true, false>(args, km, s); break;
    default: e = launch<true, true, true>(args, km, s); break;
  }
  return static_cast<int>(e);
}
