/*
 * spfft_tpu native API — single-precision C Transform interface
 * (reference: include/spfft/transform_float.h).
 *
 * The spfft_float_transform_* surface is declared alongside the double tier
 * in transform.h; this header exists so callers that include
 * <spfft/transform_float.h> directly compile unchanged.
 */
#ifndef SPFFT_TPU_TRANSFORM_FLOAT_H
#define SPFFT_TPU_TRANSFORM_FLOAT_H

#include <spfft/transform.h>

#endif /* SPFFT_TPU_TRANSFORM_FLOAT_H */
