/*
 * spfft_tpu native API — single-precision C++ Transform
 * (reference: include/spfft/transform_float.hpp).
 *
 * spfft::TransformFloat is declared alongside spfft::Transform in
 * transform.hpp; this header exists so callers that include
 * <spfft/transform_float.hpp> directly compile unchanged.
 */
#ifndef SPFFT_TPU_TRANSFORM_FLOAT_HPP
#define SPFFT_TPU_TRANSFORM_FLOAT_HPP

#include <spfft/transform.hpp>

#endif /* SPFFT_TPU_TRANSFORM_FLOAT_HPP */
