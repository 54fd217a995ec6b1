/*
 * spfft_tpu native API — single-precision C++ Grid
 * (reference: include/spfft/grid_float.hpp).
 *
 * spfft::GridFloat is a typedef of spfft::Grid in this build (grid.hpp); this
 * header exists so callers that include <spfft/grid_float.hpp> directly
 * compile unchanged.
 */
#ifndef SPFFT_TPU_GRID_FLOAT_HPP
#define SPFFT_TPU_GRID_FLOAT_HPP

#include <spfft/grid.hpp>

#endif /* SPFFT_TPU_GRID_FLOAT_HPP */
