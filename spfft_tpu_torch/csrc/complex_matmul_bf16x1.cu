// K1 at precision "default": the float32 tensor-core body of k1_tc.cuh with
// one BF16 product (hi.hi) on wgmma m64nNk16 BF16.
// The arguments are those of spfft_complex_matmul_tf32x3 (complex_matmul.cu),
// with V prepared by tile_constant(..., "default").
#include <cstdint>

#include "k1_tc.cuh"

extern "C" int spfft_complex_matmul_bf16x1(
    const float* dr, const float* di, int64_t d_sb, int64_t d_sp, int64_t d_sk,
    int d_kmajor, int d_tma,
    const void* v, int64_t v_sb, int v_im, int bn,
    float* o_r, float* o_i, int64_t o_sb, int64_t o_sp, int64_t o_sq,
    int64_t batch, int64_t P, int64_t Q, int64_t K, void* stream) {
  return tc::run<tc::Bf16x1>(dr, di, d_sb, d_sp, d_sk, d_kmajor, d_tma, v, v_sb, v_im, bn,
                             o_r, o_i, o_sb, o_sp, o_sq, batch, P, Q, K, stream);
}
