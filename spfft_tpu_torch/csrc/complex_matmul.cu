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
// float64: its own library, complex_matmul_f64.cu, on the FP64 tensor cores.
//
// A null imaginary pointer means that part is absent: a real operand (the
// R2C forward x stage), or only the real part of the product kept (the R2C
// backward x stage, Re = Ar Br - Ai Bi).
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "k1_tc.cuh"

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
