// K1's float32 body on the tensor cores (wgmma), at three precisions. The
// design, shared by all three, is described in complex_matmul.cu; each
// precision's library instantiates it (complex_matmul.cu: "highest",
// complex_matmul_bf16x3.cu: "high", complex_matmul_bf16x1.cu: "default").
//
// Each f32 value a of D (the data) and V (the plan constant) is split as
// a = hi + lo, and each real product a.b is built from the parts:
//   Tf32x3 ("highest"): hi = rna_tf32(a), lo = rna_tf32(a - hi);
//     lo.hi + hi.lo + hi.hi, wgmma m64nNk8 TF32, FP32 accuracy.
//   Bf16x3 ("high"): hi = rn_bf16(a), lo = rn_bf16(a - hi);
//     the same three products, wgmma m64nNk16 BF16 (twice the TF32 rate);
//     the dropped terms are about 2^-16 of the product.
//   Bf16x1 ("default"): hi.hi alone, no lo parts made or loaded.
//   Tf32x2 ("highest" with a bfloat16 constant, SPFFT_TPU_TWIDDLE_BF16): V
//     is exact in BF16, so in TF32 too, and its lo part is zero: V's hi
//     plane alone is loaded (half Tf32x3's V bytes) and lo.hi + hi.hi
//     issued, the same sums as Tf32x3 on that V.
// a - hi is exact in FP32, and a product of two TF32 or two BF16 values is
// exact in FP32, so the only roundings are the sums. A K tile is 128 bytes
// of V's K axis: 32 tf32 or 64 bf16, four wgmma k-steps either way.
#pragma once
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {
namespace tc {

// LO: D's lo part is made and multiplied; V_LO: V has a lo plane.
struct Tf32x3 { static constexpr bool BF16 = false, LO = true, V_LO = true; };
struct Tf32x2 { static constexpr bool BF16 = false, LO = true, V_LO = false; };
struct Bf16x3 { static constexpr bool BF16 = true, LO = true, V_LO = true; };
struct Bf16x1 { static constexpr bool BF16 = true, LO = false, V_LO = false; };

// K per stage: one 128-byte row of V
template <class M> __host__ __device__ constexpr int bk() { return M::BF16 ? 64 : 32; }
template <class M, int BN> using Mma =
    typename std::conditional<M::BF16, sm90::WgmmaBf16<BN>, sm90::WgmmaTf32<BN>>::type;

constexpr int BP = 128;           // rows of D (and O) per block: two warpgroups
constexpr int THREADS = 256;
constexpr int HALF = BP / 2;      // rows of D per warpgroup
constexpr int KSTEPS = 4;         // wgmma k-steps per K tile

// V planes per part (re, im): hi, and lo unless the mode has none.
template <class M> __host__ __device__ constexpr int planes() { return M::V_LO ? 2 : 1; }
template <class M, int BN, bool V_IM>
__host__ __device__ constexpr int v_stage_bytes() {
  return (V_IM ? 2 : 1) * planes<M>() * BN * 128;
}
// floats of one D part (re or im) per stage
template <class M> __host__ __device__ constexpr int d_part() { return BP * bk<M>(); }
template <class M, int BN, bool D_IM, bool V_IM>
__host__ __device__ constexpr int stage_bytes() {
  return v_stage_bytes<M, BN, V_IM>() + (D_IM ? 2 : 1) * d_part<M>() * 4;
}
template <class M, int BN, bool D_IM, bool V_IM>
__host__ __device__ constexpr int stages() {  // as many as fit, at most 3
  return stage_bytes<M, BN, D_IM, V_IM>() * 3 <= 225 * 1024 ? 3 : 2;
}
template <class M, int BN, bool D_IM, bool V_IM>
__host__ __device__ constexpr int smem_bytes() {
  // + 1024 to align the base, + a full and an empty mbarrier per stage
  return stages<M, BN, D_IM, V_IM>() * (stage_bytes<M, BN, D_IM, V_IM>() + 16) + 1024;
}

struct Args {
  const float* dr; const float* di;
  int64_t d_sb, d_sp, d_sk;
  const unsigned char* v; int64_t v_sb;  // V's batch stride in bytes
  float* o_r; float* o_i;
  int64_t o_sb, o_sp, o_sq;
  int64_t P, Q, K;
  int d_kmajor, d_tma, d_batched, q_tiles, p_tiles;
  int64_t tiles;  // batch x p_tiles x q_tiles
};

// Where element (p, k) of a D tile lies in shared memory, in floats, in the
// layout of TMA's 128-byte swizzle (16-byte chunk c of a 128-byte row r at
// chunk c ^ (r % 8)). k-major: per 32 k, a block of rows of 32 k, one per p.
// p-major: four 32-p-wide boxes of rows of 32 p, one per k.
template <int BK>
__device__ __forceinline__ int d_at(bool kmajor, int p, int k) {
  if (kmajor) {
    const int kk = k & 31;
    return (k >> 5) * (BP * 32) + p * 32 + ((((kk >> 2) ^ p) & 7) << 2) + (kk & 3);
  }
  return (p >> 5) * (32 * BK) + k * 32 + (((((p & 31) >> 2) ^ k) & 7) << 2) + (p & 3);
}

// The hi and lo parts of this thread's A fragment of k-step s (rows prow and
// prow + 8 of the tile) from one part of D in shared memory.
template <class M>
__device__ __forceinline__ void a_fragment(const float* d, bool kmajor, int prow, int kcol, int s,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  constexpr int BK = bk<M>();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = prow + 8 * (j % 2);
    if constexpr (M::BF16) {  // a[j] = (row, 16 s + 2 kcol + 8 (j / 2) + {0, 1})
      const int k = 16 * s + 2 * kcol + 8 * (j / 2);
      const float x0 = d[d_at<BK>(kmajor, row, k)], x1 = d[d_at<BK>(kmajor, row, k + 1)];
      hi[j] = sm90::bf16x2_rn(x0, x1);
      if constexpr (M::LO) {
        lo[j] = sm90::bf16x2_rn(x0 - sm90::bf16_low(hi[j]), x1 - sm90::bf16_high(hi[j]));
      }
    } else {  // a[j] = (row, 8 s + kcol + 4 (j / 2))
      const float x = d[d_at<BK>(kmajor, row, 8 * s + kcol + 4 * (j / 2))];
      hi[j] = sm90::tf32_rna(x);
      lo[j] = sm90::tf32_rna(x - __uint_as_float(hi[j]));
    }
  }
}

// Persistent: block b takes output tiles b, b + gridDim.x, ... (Q tile
// fastest, then P tile, then batch), and streams their K tiles through one
// ring, so that the next tile's first K tiles load while this one finishes.
// Each warpgroup loads its own half of every ring slot (its 64 rows of D and
// half of V) and computes its own 64 rows; a slot's full mbarrier completes
// when both halves have landed, its empty mbarrier when both warpgroups are
// done with it. So the warpgroups run apart by up to a slot, and one
// keeps the tensor cores busy while the other adds, stores or waits.
template <class M, int BN, bool D_IM, bool V_IM, bool C_IM>
__global__ void __launch_bounds__(THREADS, 1) tc_kernel(
    const __grid_constant__ Args args, const __grid_constant__ CUtensorMap map_r,
    const __grid_constant__ CUtensorMap map_i) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int BK = bk<M>();
  constexpr int D_PART = d_part<M>();
  constexpr int STAGE = stage_bytes<M, BN, D_IM, V_IM>();
  constexpr int STAGES = stages<M, BN, D_IM, V_IM>();
  constexpr int VBYTES = v_stage_bytes<M, BN, V_IM>();
  constexpr int ACC = BN / 2;
  using MMA = Mma<M, BN>;

  const uint32_t raw = sm90::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = sm90::smem_addr(smem);
  const uint32_t bars = sbase + STAGES * STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128, wtid = tid % 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full(s), args.d_tma ? 2 : THREADS);
      sm90::mbar_init(empty(s), THREADS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int KT = static_cast<int>((args.K + BK - 1) / BK);
  const int64_t my_tiles =
      blockIdx.x < args.tiles ? (args.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  struct Tile { int64_t batch, p0, q0; int qt; };
  auto tile = [&](int64_t j) {
    const int64_t t = blockIdx.x + j * gridDim.x;
    const int64_t pq = static_cast<int64_t>(args.p_tiles) * args.q_tiles;
    const int qt = static_cast<int>(t % args.q_tiles);
    return Tile{t / pq, (t % pq) / args.q_tiles * BP, static_cast<int64_t>(qt) * BN, qt};
  };

  // Fills this warpgroup's half of ring slot s with K tile g % KT of this
  // block's tile g / KT: half of V in one bulk copy, and its 64 rows of D in
  // TMA boxes (d_tma), else element by element; either way with zeros past
  // P and K.
  auto load_half = [&](int s, int64_t g) {
    const Tile tl = tile(g / KT);
    const int kt = static_cast<int>(g % KT);
    const int64_t p0 = tl.p0 + wg * HALF, k0 = static_cast<int64_t>(kt) * BK;
    const uint32_t bar = full(s);
    const uint32_t vs = sbase + s * STAGE;
    const unsigned char* vsrc =
        args.v + tl.batch * args.v_sb + (static_cast<int64_t>(tl.qt) * KT + kt) * VBYTES;
    const uint32_t vdst = vs + wg * (VBYTES / 2);
    vsrc += wg * (VBYTES / 2);
    if (args.d_tma) {
      if (wtid == 0) {
        constexpr int PARTS = D_IM ? 2 : 1;
        sm90::mbar_arrive_expect_tx(bar, VBYTES / 2 + PARTS * HALF * BK * 4);
        sm90::bulk_copy(vdst, vsrc, VBYTES / 2, bar);
        const int b = args.d_batched ? static_cast<int>(tl.batch) : 0;
#pragma unroll
        for (int part = 0; part < PARTS; ++part) {
          const void* map = part ? &map_i : &map_r;
          const uint32_t ds = vs + VBYTES + part * D_PART * 4;
          if (args.d_kmajor) {  // per 32 k, one box of 32 k x 64 p
#pragma unroll
            for (int j = 0; j < BK / 32; ++j) {
              sm90::tma_load_3d(ds + (j * BP + wg * HALF) * 32 * 4, map,
                                static_cast<int>(k0 + 32 * j), static_cast<int>(p0), b, bar);
            }
          } else {  // two boxes of 32 p x BK k
            const uint32_t dw = ds + wg * HALF * BK * 4;
            sm90::tma_load_3d(dw, map, static_cast<int>(p0), static_cast<int>(k0), b, bar);
            sm90::tma_load_3d(dw + 32 * BK * 4, map, static_cast<int>(p0 + 32),
                              static_cast<int>(k0), b, bar);
          }
        }
      }
    } else {
      if (wtid == 0) {
        sm90::mbar_expect_tx(bar, VBYTES / 2);
        sm90::bulk_copy(vdst, vsrc, VBYTES / 2, bar);
      }
#pragma unroll
      for (int part = 0; part < (D_IM ? 2 : 1); ++part) {
        const float* src = (part ? args.di : args.dr) + tl.batch * args.d_sb;
        const uint32_t ds = vs + VBYTES + part * D_PART * 4;
        for (int e = wtid; e < HALF * BK; e += 128) {
          const int p = args.d_kmajor ? e / BK : e % HALF;
          const int k = args.d_kmajor ? e % BK : e / HALF;
          const bool ok = p0 + p < args.P && k0 + k < args.K;
          const float* gp = ok ? src + (p0 + p) * args.d_sp + (k0 + k) * args.d_sk : src;
          sm90::cp_async_4(ds + 4 * d_at<BK>(args.d_kmajor, wg * HALF + p, k), gp, ok);
        }
      }
      sm90::mbar_arrive_cp_async(bar);
    }
  };

  // acc: the FP32 sums, in registers. tmp: one K tile's sum, on the tensor
  // cores. Each wgmma rounds its result toward zero; summed over a whole K
  // (up to 192 roundings) that shrinks every output by about 4e-6, and six
  // stages of a round trip by about 2e-5. So the tensor cores sum one K tile
  // at a time (at most 24 roundings) from zero, and acc adds the K tiles
  // rounding to nearest.
  float acc_r[ACC], tmp_r[ACC];
  float acc_i[C_IM ? ACC : 1], tmp_i[C_IM ? ACC : 1];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc_r[j] = tmp_r[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (C_IM ? ACC : 1); ++j) acc_i[j] = tmp_i[j] = 0.f;

  // This thread's A-fragment rows and columns, and its accumulator rows and
  // columns (see sm90.cuh).
  const int warp = wtid / 32, lane = tid % 32;
  const int prow = wg * HALF + 16 * warp + lane / 4;
  const int kcol = lane % 4;

  // Writes the finished tile j straight from the accumulators: eight
  // neighbouring lanes cover one 32-byte sector of the output's contiguous axis.
  auto store = [&](int64_t j) {
    const Tile tl = tile(j);
    float* o_r = args.o_r + tl.batch * args.o_sb;
    float* o_i = C_IM ? args.o_i + tl.batch * args.o_sb : nullptr;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int64_t p = tl.p0 + prow + 8 * ((i / 2) % 2);
      const int64_t q = tl.q0 + 8 * (i / 4) + 2 * kcol + (i % 2);
      if (p < args.P && q < args.Q) {
        const int64_t off = p * args.o_sp + q * args.o_sq;
        o_r[off] = acc_r[i];
        if constexpr (C_IM) o_i[off] = acc_i[i];
      }
      acc_r[i] = 0.f;
      if constexpr (C_IM) acc_i[i] = 0.f;
    }
  };

  if (KT == 0) {
    for (int64_t j = 0; j < my_tiles; ++j) store(j);
    return;
  }
  // V's planes in a ring slot: re hi[, re lo][, im hi[, im lo]], 128 B a row
  constexpr int IM_PLANE = planes<M>();
  const int64_t total = my_tiles * KT;
  for (int g = 0; g < STAGES - 1 && g < total; ++g) load_half(g, g);
  for (int64_t g = 0; g < total; ++g) {
    const int s = static_cast<int>(g % STAGES);
    sm90::mbar_wait(full(s), static_cast<uint32_t>((g / STAGES) & 1));

    const uint32_t vs = sbase + s * STAGE;
    const float* d_re = reinterpret_cast<const float*>(smem + s * STAGE + VBYTES);
    const float* d_im = d_re + D_PART;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t r_hi[4], r_lo[4], i_hi[4], i_lo[4];
      a_fragment<M>(d_re, args.d_kmajor, prow, kcol, ks, r_hi, r_lo);
      if constexpr (D_IM) a_fragment<M>(d_im, args.d_kmajor, prow, kcol, ks, i_hi, i_lo);
      // V planes of this k-step: 32 bytes further along each 128-byte row
      const auto plane = [&](int i) { return sm90::desc_sw128(vs + i * BN * 128 + 32 * ks); };
      const uint64_t vr_hi = plane(0), vr_lo = plane(1);
      const uint64_t vi_hi = plane(IM_PLANE), vi_lo = plane(IM_PLANE + 1);
      // scale-d: the K tile's first product into tmp overwrites it
      int zr = ks != 0, zi = ks != 0;
#pragma unroll
      for (int j = 0; j < ACC; ++j) sm90::fence_operand(tmp_r[j]);
      if constexpr (C_IM) {
#pragma unroll
        for (int j = 0; j < ACC; ++j) sm90::fence_operand(tmp_i[j]);
      }
      sm90::wgmma_fence();
      // Re = Dr Vr - Di Vi, the small products first
      if constexpr (M::LO) {
        MMA::template mma<1>(tmp_r, r_lo, vr_hi, zr);
        if constexpr (M::V_LO) MMA::template mma<1>(tmp_r, r_hi, vr_lo, 1);
        if constexpr (D_IM && V_IM) {
          MMA::template mma<-1>(tmp_r, i_lo, vi_hi, 1);
          if constexpr (M::V_LO) MMA::template mma<-1>(tmp_r, i_hi, vi_lo, 1);
        }
        zr = 1;
      }
      MMA::template mma<1>(tmp_r, r_hi, vr_hi, zr);
      if constexpr (D_IM && V_IM) MMA::template mma<-1>(tmp_r, i_hi, vi_hi, 1);
      // Im = Dr Vi + Di Vr
      if constexpr (C_IM && V_IM && M::LO) {
        MMA::template mma<1>(tmp_i, r_lo, vi_hi, zi);
        if constexpr (M::V_LO) MMA::template mma<1>(tmp_i, r_hi, vi_lo, 1);
        zi = 1;
      }
      if constexpr (C_IM && D_IM && M::LO) {
        MMA::template mma<1>(tmp_i, i_lo, vr_hi, zi);
        if constexpr (M::V_LO) MMA::template mma<1>(tmp_i, i_hi, vr_lo, 1);
        zi = 1;
      }
      if constexpr (C_IM && V_IM) {
        MMA::template mma<1>(tmp_i, r_hi, vi_hi, zi);
        zi = 1;
      }
      if constexpr (C_IM && D_IM) MMA::template mma<1>(tmp_i, i_hi, vr_hi, zi);
      sm90::wgmma_commit();
      if (ks == 0) {
        // The tensor cores are busy: refill the slot of K tile g - 1 with
        // K tile g + STAGES - 1, once both warpgroups are done with it.
        const int64_t next = g + STAGES - 1;
        if (next < total) {
          if (next >= STAGES) {
            sm90::mbar_wait(empty(static_cast<int>(next % STAGES)),
                            static_cast<uint32_t>((next / STAGES - 1) & 1));
          }
          load_half(static_cast<int>(next % STAGES), next);
        }
      }
      // the previous k-step's products are done, and with them its A registers
      if (ks < KSTEPS - 1) sm90::wgmma_wait<1>();
    }
    sm90::wgmma_wait<0>();
    sm90::mbar_arrive(empty(s));
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      sm90::fence_operand(tmp_r[j]);
      acc_r[j] += tmp_r[j];
    }
    if constexpr (C_IM && (D_IM || V_IM)) {
#pragma unroll
      for (int j = 0; j < ACC; ++j) {
        sm90::fence_operand(tmp_i[j]);
        acc_i[j] += tmp_i[j];
      }
    }
    if (g % KT == KT - 1) store(g / KT);
  }
}

template <class M, int BN, bool D_IM, bool V_IM, bool C_IM>
cudaError_t launch(const Args& args, const CUtensorMap& map_r, const CUtensorMap& map_i,
                   cudaStream_t stream) {
  auto kernel = tc_kernel<M, BN, D_IM, V_IM, C_IM>;
  constexpr int bytes = smem_bytes<M, BN, D_IM, V_IM>();
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
  kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(args, map_r, map_i);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of one part of D, with the 128-byte swizzle: k-major, boxes
// of 32 k x 64 p over dims (K, P, batch); else boxes of 32 p x BK k over
// (P, K, batch). A D shared by the batch is one matrix (batch dim 1).
inline cudaError_t d_map(CUtensorMap* map, const float* d, int bk, bool kmajor, int64_t d_sp,
                         int64_t d_sk, int64_t d_sb, bool batched, int64_t batch, int64_t P,
                         int64_t K) {
  EncodeTiled encode;
  const cudaError_t e = encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t outer = static_cast<cuuint64_t>(kmajor ? d_sp : d_sk) * 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kmajor ? K : P),
                              static_cast<cuuint64_t>(kmajor ? P : K),
                              static_cast<cuuint64_t>(batched ? batch : 1)};
  const cuuint64_t strides[2] = {outer, batched ? static_cast<cuuint64_t>(d_sb) * 4 : outer * dims[1]};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(kmajor ? HALF : bk), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(d), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class M, int BN>
cudaError_t dispatch(const Args& args, const CUtensorMap& mr, const CUtensorMap& mi, bool v_im,
                     bool c_im, cudaStream_t s) {
  const int key = (args.di != nullptr) * 4 + v_im * 2 + c_im;
  switch (key) {
    case 0: return launch<M, BN, false, false, false>(args, mr, mi, s);
    case 1: return launch<M, BN, false, false, true>(args, mr, mi, s);
    case 2: return launch<M, BN, false, true, false>(args, mr, mi, s);
    case 3: return launch<M, BN, false, true, true>(args, mr, mi, s);
    case 4: return launch<M, BN, true, false, false>(args, mr, mi, s);
    case 5: return launch<M, BN, true, false, true>(args, mr, mi, s);
    case 6: return launch<M, BN, true, true, false>(args, mr, mi, s);
    default: return launch<M, BN, true, true, true>(args, mr, mi, s);
  }
}

// The body of each precision's C entry point (see complex_matmul.cu).
template <class M>
int run(const float* dr, const float* di, int64_t d_sb, int64_t d_sp, int64_t d_sk, int d_kmajor,
        int d_tma, const void* v, int64_t v_sb, int v_im, int bn, float* o_r, float* o_i,
        int64_t o_sb, int64_t o_sp, int64_t o_sq, int64_t batch, int64_t P, int64_t Q, int64_t K,
        void* stream) {
  if (batch < 1 || P < 1 || Q < 1 || K < 0 || batch > 65535 || (bn != 64 && bn != 88)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t q_tiles = (Q + bn - 1) / bn;
  const int64_t p_tiles = (P + BP - 1) / BP;
  if (q_tiles * p_tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool tma = d_tma && K > 0;
  const bool batched = batch > 1 && d_sb != 0;
  CUtensorMap map_r{}, map_i{};
  if (tma) {
    cudaError_t e = d_map(&map_r, dr, bk<M>(), d_kmajor, d_sp, d_sk, d_sb, batched, batch, P, K);
    if (e == cudaSuccess && di != nullptr) {
      e = d_map(&map_i, di, bk<M>(), d_kmajor, d_sp, d_sk, d_sb, batched, batch, P, K);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Args args{dr, di, d_sb, d_sp, d_sk, static_cast<const unsigned char*>(v), v_sb,
                  o_r, o_i, o_sb, o_sp, o_sq, P, Q, K, d_kmajor, tma, batched,
                  static_cast<int>(q_tiles), static_cast<int>(p_tiles), batch * p_tiles * q_tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bn == 64 ? dispatch<M, 64>(args, map_r, map_i, v_im != 0, o_i != nullptr, s)
               : dispatch<M, 88>(args, map_r, map_i, v_im != 0, o_i != nullptr, s);
  return static_cast<int>(e);
}

}  // namespace tc
}  // namespace
