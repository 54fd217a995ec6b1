/*
 * spfft_tpu native API — batched multi-transform execution (C++).
 *
 * Executes N independent transforms with pipelined dispatch: all device
 * programs are enqueued before any result is awaited, so the device overlaps the
 * transforms (reference: include/spfft/multi_transform.hpp:48-95, whose
 * pipelining interleaves CPU and GPU stages the same way).
 */
#ifndef SPFFT_TPU_MULTI_TRANSFORM_HPP
#define SPFFT_TPU_MULTI_TRANSFORM_HPP

#include <spfft/transform.hpp>
#include <spfft/types.h>

namespace spfft {

/* Freq -> space for each transform i; results land in each transform's
 * space_domain_data(). */
void multi_transform_backward(int num_transforms, Transform* transforms,
                              const double* const* input,
                              const SpfftProcessingUnitType* output_locations);

/* Space -> freq, reading each transform's space_domain_data(). */
void multi_transform_forward(int num_transforms, Transform* transforms,
                             const SpfftProcessingUnitType* input_locations,
                             double* const* output, const SpfftScalingType* scaling_types);

void multi_transform_backward(int num_transforms, TransformFloat* transforms,
                              const float* const* input,
                              const SpfftProcessingUnitType* output_locations);

void multi_transform_forward(int num_transforms, TransformFloat* transforms,
                             const SpfftProcessingUnitType* input_locations,
                             float* const* output, const SpfftScalingType* scaling_types);

/* Pointer-based overloads (reference: include/spfft/multi_transform.hpp:64-95):
 * the space-domain side reads from / writes to caller pointers instead of each
 * transform's internal space buffer. */
void multi_transform_backward(int num_transforms, Transform* transforms,
                              const double* const* input, double* const* space_output);

void multi_transform_forward(int num_transforms, Transform* transforms,
                             const double* const* space_input, double* const* output,
                             const SpfftScalingType* scaling_types);

void multi_transform_backward(int num_transforms, TransformFloat* transforms,
                              const float* const* input, float* const* space_output);

void multi_transform_forward(int num_transforms, TransformFloat* transforms,
                             const float* const* space_input, float* const* output,
                             const SpfftScalingType* scaling_types);

} // namespace spfft

#endif // SPFFT_TPU_MULTI_TRANSFORM_HPP
