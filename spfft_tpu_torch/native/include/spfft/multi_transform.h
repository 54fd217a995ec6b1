/*
 * spfft_tpu native API — C multi-transform interface.
 *
 * Batched execution of independent transforms with pipelined dispatch
 * (reference: include/spfft/multi_transform.h).
 */
#ifndef SPFFT_TPU_MULTI_TRANSFORM_H
#define SPFFT_TPU_MULTI_TRANSFORM_H

#include <spfft/errors.h>
#include <spfft/transform.h>
#include <spfft/types.h>

#ifdef __cplusplus
extern "C" {
#endif

SpfftError spfft_multi_transform_backward(int numTransforms, SpfftTransform* transforms,
                                          const double* const* input,
                                          const SpfftProcessingUnitType* outputLocations);

SpfftError spfft_multi_transform_forward(int numTransforms, SpfftTransform* transforms,
                                         const SpfftProcessingUnitType* inputLocations,
                                         double* const* output,
                                         const SpfftScalingType* scalingTypes);

SpfftError spfft_float_multi_transform_backward(
    int numTransforms, SpfftFloatTransform* transforms, const float* const* input,
    const SpfftProcessingUnitType* outputLocations);

SpfftError spfft_float_multi_transform_forward(
    int numTransforms, SpfftFloatTransform* transforms,
    const SpfftProcessingUnitType* inputLocations, float* const* output,
    const SpfftScalingType* scalingTypes);

/* Pointer-based batch overloads (reference: include/spfft/multi_transform.h:60-95):
 * the space-domain side is a caller-provided pointer per transform instead of
 * each transform's internal space_domain_data() buffer. */

SpfftError spfft_multi_transform_forward_ptr(int numTransforms,
                                             SpfftTransform* transforms,
                                             const double* const* inputPointers,
                                             double* const* outputPointers,
                                             const SpfftScalingType* scalingTypes);

SpfftError spfft_multi_transform_backward_ptr(int numTransforms,
                                              SpfftTransform* transforms,
                                              const double* const* inputPointers,
                                              double* const* outputPointers);

SpfftError spfft_float_multi_transform_forward_ptr(int numTransforms,
                                                   SpfftFloatTransform* transforms,
                                                   const float* const* inputPointers,
                                                   float* const* outputPointers,
                                                   const SpfftScalingType* scalingTypes);

SpfftError spfft_float_multi_transform_backward_ptr(int numTransforms,
                                                    SpfftFloatTransform* transforms,
                                                    const float* const* inputPointers,
                                                    float* const* outputPointers);

#ifdef __cplusplus
}
#endif

#endif /* SPFFT_TPU_MULTI_TRANSFORM_H */
