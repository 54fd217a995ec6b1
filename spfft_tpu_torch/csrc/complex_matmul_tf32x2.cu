// K1 at precision "highest" with a bfloat16 plan constant
// (SPFFT_TPU_TWIDDLE_BF16): the float32 tensor-core body of k1_tc.cuh with
// the data split hi/lo in TF32 and the constant, exact in BF16 and so in
// TF32, one plane a part: lo.hi + hi.hi on wgmma m64nNk8 TF32, half the
// constant's bytes and two products for 3xTF32's three, the same sums.
// The arguments are those of spfft_complex_matmul_tf32x3 (complex_matmul.cu),
// with V prepared by tile_constant(..., "highest-bf16").
#include <cstdint>

#include "k1_tc.cuh"

extern "C" int spfft_complex_matmul_tf32x2(
    const float* dr, const float* di, int64_t d_sb, int64_t d_sp, int64_t d_sk,
    int d_kmajor, int d_tma,
    const void* v, int64_t v_sb, int v_im, int bn,
    float* o_r, float* o_i, int64_t o_sb, int64_t o_sp, int64_t o_sq,
    int64_t batch, int64_t P, int64_t Q, int64_t K, void* stream) {
  return tc::run<tc::Tf32x2>(dr, di, d_sb, d_sp, d_sk, d_kmajor, d_tma, v, v_sb, v_im, bn,
                             o_r, o_i, o_sb, o_sp, o_sq, batch, P, Q, K, stream);
}
