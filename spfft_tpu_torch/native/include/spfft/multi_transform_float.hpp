/*
 * spfft_tpu native API — single-precision C++ multi-transform
 * (reference: include/spfft/multi_transform_float.hpp).
 *
 * The TransformFloat overloads are declared alongside the double tier in
 * multi_transform.hpp; this header exists so callers that include
 * <spfft/multi_transform_float.hpp> directly compile unchanged.
 */
#ifndef SPFFT_TPU_MULTI_TRANSFORM_FLOAT_HPP
#define SPFFT_TPU_MULTI_TRANSFORM_FLOAT_HPP

#include <spfft/multi_transform.hpp>

#endif /* SPFFT_TPU_MULTI_TRANSFORM_FLOAT_HPP */
