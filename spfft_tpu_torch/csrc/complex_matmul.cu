// K1: planar batched strided complex matrix product, C[b] = A[b] . B[b].
//
// Replaces the TPU kernel spfft_tpu/ops/pallas_fft.py:95 complex_matmul_fused
// (kernel body :37): (xr + i xi) @ (wr + i wi) -> (yr, yi) as four real dots
// with f32 accumulation. Here it carries every DFT stage of the accelerator
// engine (z, y and x, both directions) with no transpose materialised.
//
// float32: 3xTF32 on the tensor cores (wgmma), at FP32 accuracy.
//   Bound: at the 256^3 / radius 0.659 C2C headline the stages do 59 GFLOP per
//   backward. Without tensor cores the card does 67 TFLOP/s in FP32; TF32 on
//   the tensor cores does 495, and FP32 accuracy from TF32 costs three
//   products per real product, so the least time is 3 F / 495 TFLOP/s, about
//   2.5x below the FP32 bound. At every stage shape that least time is set
//   by the tensor cores, not by HBM.
//   Each f32 value a is split as a = hi + lo with hi = rna_tf32(a) and
//   lo = rna_tf32(a - hi) (a - hi is exact), and a.b = lo.hi + hi.lo + hi.hi
//   with FP32 accumulation: the small terms first. Raw f32 is never handed
//   to the tensor cores, which would read only its top 19 bits.
//   Every stage has one operand that is a plan constant shared by the batch
//   (a DFT matrix) and one that is data. The kernel computes O = D . V with
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
//   32 through a ring of cp.async stages (three where they fit, else two),
//   so that the next tiles load while the tensor cores run. The tensor
//   cores round each wgmma's sum toward zero, so they sum one K tile at a
//   time and FP32 registers add the K tiles (see the main loop); that costs a
//   second set of accumulators, and so the Q tile is 64 and not 128. One
//   block fits on an SM (shared memory and registers), so the kernel is
//   persistent: one block per SM walks over the output tiles and streams
//   their K tiles through one ring, and the next tile loads while this one
//   finishes. The output is stored straight from the accumulators, eight
//   lanes to a 32-byte sector of its contiguous axis.
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

#include "sm90.cuh"

namespace {

// ---- float32: 3xTF32 on the tensor cores ---------------------------------------

namespace tc {

constexpr int BP = 128;           // rows of D (and O) per block: two warpgroups
constexpr int BK = 32;            // K per stage: one 128-byte swizzle row of tf32
constexpr int THREADS = 256;
constexpr int HALF = BP / 2;      // rows of D per warpgroup
constexpr int D_PART = BP * BK;   // floats of one D part (re or im) in one stage

template <int BN, bool V_IM>
__host__ __device__ constexpr int v_stage_bytes() { return (V_IM ? 4 : 2) * BN * BK * 4; }
template <int BN, bool D_IM, bool V_IM>
__host__ __device__ constexpr int stage_bytes() {
  return v_stage_bytes<BN, V_IM>() + (D_IM ? 2 : 1) * D_PART * 4;
}
template <int BN, bool D_IM, bool V_IM>
__host__ __device__ constexpr int stages() {  // as many as fit, at most 3
  return stage_bytes<BN, D_IM, V_IM>() * 3 <= 225 * 1024 ? 3 : 2;
}
template <int BN, bool D_IM, bool V_IM>
__host__ __device__ constexpr int smem_bytes() {
  // + 1024 to align the base, + a full and an empty mbarrier per stage
  return stages<BN, D_IM, V_IM>() * (stage_bytes<BN, D_IM, V_IM>() + 16) + 1024;
}

struct Args {
  const float* dr; const float* di;
  int64_t d_sb, d_sp, d_sk;
  const float* v; int64_t v_sb;
  float* o_r; float* o_i;
  int64_t o_sb, o_sp, o_sq;
  int64_t P, Q, K;
  int d_kmajor, d_tma, d_batched, q_tiles, p_tiles;
  int64_t tiles;  // batch x p_tiles x q_tiles
};

// Where element (p, k) of a D tile lies in shared memory, in floats, in the
// layout of TMA's 128-byte swizzle (16-byte chunk c of a 128-byte row r at
// chunk c ^ (r % 8)). k-major: rows of 32 k, one per p. p-major: four
// 32-p-wide boxes of rows of 32 p, one per k. Fragment reads hit 32 banks.
__device__ __forceinline__ int d_at(bool kmajor, int p, int k) {
  return kmajor ? p * BK + ((((k >> 2) ^ p) & 7) << 2) + (k & 3)
                : (p >> 5) * (32 * BK) + k * 32 + (((((p & 31) >> 2) ^ k) & 7) << 2) + (p & 3);
}

// Persistent: block b takes output tiles b, b + gridDim.x, ... (Q tile
// fastest, then P tile, then batch), and streams their K tiles through one
// ring, so that the next tile's first K tiles load while this one finishes.
// Each warpgroup loads its own half of every ring slot (its 64 rows of D and
// half of V) and computes its own 64 rows; a slot's full mbarrier completes
// when both halves have landed, its empty mbarrier when both warpgroups are
// done with it. So the warpgroups run apart by up to a slot, and one
// keeps the tensor cores busy while the other adds, stores or waits.
template <int BN, bool D_IM, bool V_IM, bool C_IM>
__global__ void __launch_bounds__(THREADS, 1) tf32x3_kernel(
    const __grid_constant__ Args args, const __grid_constant__ CUtensorMap map_r,
    const __grid_constant__ CUtensorMap map_i) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGE = stage_bytes<BN, D_IM, V_IM>();
  constexpr int STAGES = stages<BN, D_IM, V_IM>();
  constexpr int VBYTES = v_stage_bytes<BN, V_IM>();
  constexpr int ACC = BN / 2;
  using Mma = sm90::WgmmaTf32<BN>;

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
    const char* vsrc = reinterpret_cast<const char*>(
        args.v + tl.batch * args.v_sb + (static_cast<int64_t>(tl.qt) * KT + kt) * (VBYTES / 4));
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
          const uint32_t ds = vs + VBYTES + part * D_PART * 4 + wg * HALF * BK * 4;
          if (args.d_kmajor) {  // one box of 32 k x 64 p
            sm90::tma_load_3d(ds, map, static_cast<int>(k0), static_cast<int>(p0), b, bar);
          } else {  // two boxes of 32 p x 32 k
            sm90::tma_load_3d(ds, map, static_cast<int>(p0), static_cast<int>(k0), b, bar);
            sm90::tma_load_3d(ds + 32 * BK * 4, map, static_cast<int>(p0 + 32),
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
          sm90::cp_async_4(ds + 4 * d_at(args.d_kmajor, wg * HALF + p, k), gp, ok);
        }
      }
      sm90::mbar_arrive_cp_async(bar);
    }
  };

  // acc: the FP32 sums, in registers. tmp: one K tile's sum, on the tensor
  // cores. Each wgmma rounds its result toward zero; summed over a whole K
  // (up to 192 roundings) that shrinks every output by about 4e-6, and six
  // stages of a round trip by about 2e-5. So the tensor cores sum one K tile
  // at a time (24 roundings) from zero, and acc adds the K tiles rounding to
  // nearest.
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
  const int64_t total = my_tiles * KT;
  for (int g = 0; g < STAGES - 1 && g < total; ++g) load_half(g, g);
  for (int64_t g = 0; g < total; ++g) {
    const int s = static_cast<int>(g % STAGES);
    sm90::mbar_wait(full(s), static_cast<uint32_t>((g / STAGES) & 1));

    const uint32_t vs = sbase + s * STAGE;
    const float* d_re = reinterpret_cast<const float*>(smem + s * STAGE + VBYTES);
    const float* d_im = d_re + D_PART;
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8) {
      uint32_t r_hi[4], r_lo[4], i_hi[4], i_lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // a[j] = (prow + 8 (j % 2), 8 k8 + kcol + 4 (j / 2))
        const int at = d_at(args.d_kmajor, prow + 8 * (j % 2), 8 * k8 + kcol + 4 * (j / 2));
        const float x = d_re[at];
        r_hi[j] = sm90::tf32_rna(x);
        r_lo[j] = sm90::tf32_rna(x - __uint_as_float(r_hi[j]));
        if constexpr (D_IM) {
          const float y = d_im[at];
          i_hi[j] = sm90::tf32_rna(y);
          i_lo[j] = sm90::tf32_rna(y - __uint_as_float(i_hi[j]));
        }
      }
      // V planes of this k8 slice: 32 bytes further along each 128-byte row
      const uint64_t vr_hi = sm90::desc_sw128(vs + 32 * k8);
      const uint64_t vr_lo = sm90::desc_sw128(vs + BN * 128 + 32 * k8);
      const uint64_t vi_hi = sm90::desc_sw128(vs + 2 * BN * 128 + 32 * k8);
      const uint64_t vi_lo = sm90::desc_sw128(vs + 3 * BN * 128 + 32 * k8);
      const int fresh = k8 == 0;  // the first product of the K tile overwrites tmp
#pragma unroll
      for (int j = 0; j < ACC; ++j) sm90::fence_operand(tmp_r[j]);
      if constexpr (C_IM) {
#pragma unroll
        for (int j = 0; j < ACC; ++j) sm90::fence_operand(tmp_i[j]);
      }
      sm90::wgmma_fence();
      // Re = Dr Vr - Di Vi, the small products first
      Mma::template mma<1>(tmp_r, r_lo, vr_hi, !fresh);
      Mma::template mma<1>(tmp_r, r_hi, vr_lo, 1);
      if constexpr (D_IM && V_IM) {
        Mma::template mma<-1>(tmp_r, i_lo, vi_hi, 1);
        Mma::template mma<-1>(tmp_r, i_hi, vi_lo, 1);
      }
      Mma::template mma<1>(tmp_r, r_hi, vr_hi, 1);
      if constexpr (D_IM && V_IM) Mma::template mma<-1>(tmp_r, i_hi, vi_hi, 1);
      // Im = Dr Vi + Di Vr
      if constexpr (C_IM && V_IM) {
        Mma::template mma<1>(tmp_i, r_lo, vi_hi, !fresh);
        Mma::template mma<1>(tmp_i, r_hi, vi_lo, 1);
      }
      if constexpr (C_IM && D_IM) {
        Mma::template mma<1>(tmp_i, i_lo, vr_hi, V_IM || !fresh);
        Mma::template mma<1>(tmp_i, i_hi, vr_lo, 1);
      }
      if constexpr (C_IM && V_IM) Mma::template mma<1>(tmp_i, r_hi, vi_hi, 1);
      if constexpr (C_IM && D_IM) Mma::template mma<1>(tmp_i, i_hi, vr_hi, 1);
      sm90::wgmma_commit();
      if (k8 == 0) {
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
      // the previous k8's products are done, and with them its A registers
      if (k8 < BK / 8 - 1) sm90::wgmma_wait<1>();
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

template <int BN, bool D_IM, bool V_IM, bool C_IM>
cudaError_t launch(const Args& args, const CUtensorMap& map_r, const CUtensorMap& map_i,
                   cudaStream_t stream) {
  auto kernel = tf32x3_kernel<BN, D_IM, V_IM, C_IM>;
  constexpr int bytes = smem_bytes<BN, D_IM, V_IM>();
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

cudaError_t encoder(EncodeTiled* fn) {
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
// of 32 k x 64 p over dims (K, P, batch); else boxes of 32 p x 32 k over
// (P, K, batch). A D shared by the batch is one matrix (batch dim 1).
cudaError_t d_map(CUtensorMap* map, const float* d, bool kmajor, int64_t d_sp, int64_t d_sk,
                  int64_t d_sb, bool batched, int64_t batch, int64_t P, int64_t K) {
  EncodeTiled encode;
  const cudaError_t e = encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t outer = static_cast<cuuint64_t>(kmajor ? d_sp : d_sk) * 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kmajor ? K : P),
                              static_cast<cuuint64_t>(kmajor ? P : K),
                              static_cast<cuuint64_t>(batched ? batch : 1)};
  const cuuint64_t strides[2] = {outer, batched ? static_cast<cuuint64_t>(d_sb) * 4 : outer * dims[1]};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(kmajor ? HALF : 32), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(d), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
cudaError_t dispatch(const Args& args, const CUtensorMap& mr, const CUtensorMap& mi, bool v_im,
                     bool c_im, cudaStream_t s) {
  const int key = (args.di != nullptr) * 4 + v_im * 2 + c_im;
  switch (key) {
    case 0: return launch<BN, false, false, false>(args, mr, mi, s);
    case 1: return launch<BN, false, false, true>(args, mr, mi, s);
    case 2: return launch<BN, false, true, false>(args, mr, mi, s);
    case 3: return launch<BN, false, true, true>(args, mr, mi, s);
    case 4: return launch<BN, true, false, false>(args, mr, mi, s);
    case 5: return launch<BN, true, false, true>(args, mr, mi, s);
    case 6: return launch<BN, true, true, false>(args, mr, mi, s);
    default: return launch<BN, true, true, true>(args, mr, mi, s);
  }
}

}  // namespace tc

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
// in floats (0 when shared). O (P x Q) gets element (b, p, q) at
// o + b o_sb + p o_sp + q o_sq (o_i null keeps the real part only). Strides
// are in elements. Returns the cudaError_t of the launch (0 on success).
extern "C" int spfft_complex_matmul_tf32x3(
    const float* dr, const float* di, int64_t d_sb, int64_t d_sp, int64_t d_sk,
    int d_kmajor, int d_tma,
    const float* v, int64_t v_sb, int v_im, int bn,
    float* o_r, float* o_i, int64_t o_sb, int64_t o_sp, int64_t o_sq,
    int64_t batch, int64_t P, int64_t Q, int64_t K, void* stream) {
  if (batch < 1 || P < 1 || Q < 1 || K < 0 || batch > 65535 || (bn != 64 && bn != 88)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t q_tiles = (Q + bn - 1) / bn;
  const int64_t p_tiles = (P + tc::BP - 1) / tc::BP;
  if (q_tiles * p_tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool tma = d_tma && K > 0;
  const bool batched = batch > 1 && d_sb != 0;
  CUtensorMap map_r{}, map_i{};
  if (tma) {
    cudaError_t e = tc::d_map(&map_r, dr, d_kmajor, d_sp, d_sk, d_sb, batched, batch, P, K);
    if (e == cudaSuccess && di != nullptr) {
      e = tc::d_map(&map_i, di, d_kmajor, d_sp, d_sk, d_sb, batched, batch, P, K);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const tc::Args args{dr, di, d_sb, d_sp, d_sk, v, v_sb, o_r, o_i, o_sb, o_sp, o_sq,
                      P, Q, K, d_kmajor, tma, batched, static_cast<int>(q_tiles),
                      static_cast<int>(p_tiles), batch * p_tiles * q_tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bn == 64 ? tc::dispatch<64>(args, map_r, map_i, v_im != 0, o_i != nullptr, s)
               : tc::dispatch<88>(args, map_r, map_i, v_im != 0, o_i != nullptr, s);
  return static_cast<int>(e);
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
