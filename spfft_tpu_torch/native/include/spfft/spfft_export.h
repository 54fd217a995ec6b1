/*
 * spfft_tpu native API — export macros (reference: CMake GenerateExportHeader
 * output installed as spfft/spfft_export.h). All symbols have default
 * visibility here, so every macro expands to nothing — the definitions exist
 * so reference-style prototypes and callers compile unchanged.
 */
#ifndef SPFFT_EXPORT_H
#define SPFFT_EXPORT_H

#define SPFFT_EXPORT
#define SPFFT_NO_EXPORT
#define SPFFT_DEPRECATED
#define SPFFT_DEPRECATED_EXPORT
#define SPFFT_DEPRECATED_NO_EXPORT

#endif
