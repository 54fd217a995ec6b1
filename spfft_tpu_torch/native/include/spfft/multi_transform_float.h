/*
 * spfft_tpu native API — single-precision C multi-transform interface
 * (reference: include/spfft/multi_transform_float.h).
 *
 * The spfft_float_multi_transform_* surface is declared alongside the double
 * tier in multi_transform.h; this header exists so callers that include
 * <spfft/multi_transform_float.h> directly compile unchanged.
 */
#ifndef SPFFT_TPU_MULTI_TRANSFORM_FLOAT_H
#define SPFFT_TPU_MULTI_TRANSFORM_FLOAT_H

#include <spfft/multi_transform.h>

#endif /* SPFFT_TPU_MULTI_TRANSFORM_FLOAT_H */
