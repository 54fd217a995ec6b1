/*
 * spfft_tpu version macros — the compile-time version surface consumers can
 * feature-test against (the reference exposes its version through CMake's
 * PROJECT_VERSION in SpFFT.pc / SpFFTConfigVersion.cmake; these macros make
 * it available to the preprocessor as well). Keep in sync with the VERSION in
 * spfft_tpu_torch/native/CMakeLists.txt.
 */
#ifndef SPFFT_TPU_VERSION_H
#define SPFFT_TPU_VERSION_H

#define SPFFT_TPU_VERSION_MAJOR 0
#define SPFFT_TPU_VERSION_MINOR 3
#define SPFFT_TPU_VERSION_PATCH 0
#define SPFFT_TPU_VERSION_STRING "0.3.0"

#endif
