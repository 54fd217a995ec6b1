/*
 * spfft_tpu native API — single-precision C Grid interface
 * (reference: include/spfft/grid_float.h).
 *
 * GridFloat is the same capacity object as Grid in this build (precision
 * lives on the Transform), so the spfft_float_grid_* surface is declared
 * alongside the double tier in grid.h; this header exists so callers that
 * include <spfft/grid_float.h> directly compile unchanged.
 */
#ifndef SPFFT_TPU_GRID_FLOAT_H
#define SPFFT_TPU_GRID_FLOAT_H

#include <spfft/grid.h>

#endif /* SPFFT_TPU_GRID_FLOAT_H */
