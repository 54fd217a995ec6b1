/* spfft_tpu native API — umbrella C++ header (reference: include/spfft/spfft.hpp). */
#ifndef SPFFT_TPU_SPFFT_HPP
#define SPFFT_TPU_SPFFT_HPP

#include <spfft/config.h>
#include <spfft/exceptions.hpp>
#include <spfft/grid.hpp>
#include <spfft/grid_float.hpp>
#include <spfft/multi_transform.hpp>
#include <spfft/multi_transform_float.hpp>
#include <spfft/transform.hpp>
#include <spfft/transform_float.hpp>
#include <spfft/types.h>

#endif /* SPFFT_TPU_SPFFT_HPP */
