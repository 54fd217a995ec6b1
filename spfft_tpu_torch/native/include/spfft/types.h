/*
 * spfft_tpu native API — public enum surface.
 *
 * ABI-compatible with the reference SpFFT C enums (reference:
 * include/spfft/types.h:33-117) so existing callers recompile unchanged.
 * Semantics on this build:
 *  - BUFFERED moves padded equal-split blocks; COMPACT_BUFFERED/UNBUFFERED
 *    move exact per-shard-pair blocks (Alltoallv/Alltoallw semantics): a
 *    gather on the device for stacked shards, one all_to_all_single over a
 *    process group.
 *  - SPFFT_PU_GPU selects the accelerator (CUDA) backend.
 */
#ifndef SPFFT_TPU_TYPES_H
#define SPFFT_TPU_TYPES_H

/* Communicator type for the MPI-surface parity stubs (reference:
 * include/spfft/grid.h:35-37 includes <mpi.h> under SPFFT_MPI and uses
 * MPI_Comm directly). When the caller builds with MPI this IS MPI_Comm, so
 * reference call sites compile unchanged; otherwise it is an opaque
 * placeholder — the stubs return SPFFT_MPI_SUPPORT_ERROR without reading it
 * (no MPI exists in this runtime; the device mesh replaces the communicator).
 *
 * ABI note: the library TU compiles without <mpi.h>, so a caller built with
 * an int-typed MPI_Comm (MPICH) passes a different by-value parameter type
 * than the TU declares (void*). The stubs never read the argument, and every
 * supported ABI (x86-64 SysV/Win64, AArch64 AAPCS) passes both int and
 * pointer scalars in the same argument register, so the call is benign —
 * but it relies on register passing of scalar arguments; an ABI that
 * class-splits them differently would need the library rebuilt with MPI
 * headers present (which makes the types identical). */
#if defined(SPFFT_MPI) || defined(MPI_VERSION)
#ifndef MPI_VERSION
#include <mpi.h>
#endif
typedef MPI_Comm SpfftMpiComm;
#else
typedef void* SpfftMpiComm;
#endif

enum SpfftExchangeType {
  /* DIVERGENCE from the reference: there DEFAULT == COMPACT_BUFFERED; here it
   * is a measured auto-policy — the runtime picks the discipline per plan
   * from its exact wire volumes, round counts, and backend collective
   * support (spfft_tpu/parallel/policy.py). Pass COMPACT_BUFFERED explicitly
   * for the reference's exact-counts wire behavior. */
  SPFFT_EXCH_DEFAULT = 0,
  /* Equal-sized message blocks; the native ICI all-to-all discipline. */
  SPFFT_EXCH_BUFFERED = 1,
  /* Same, single-precision wire payload (half the ICI bytes). */
  SPFFT_EXCH_BUFFERED_FLOAT = 2,
  /* Exact per-rank-pair block sizes (Alltoallv semantics), via a P-1-round
   * permute chain. */
  SPFFT_EXCH_COMPACT_BUFFERED = 3,
  SPFFT_EXCH_COMPACT_BUFFERED_FLOAT = 4,
  /* Zero-copy datatype exchange in the reference; maps to the same exact-counts
   * chain here. */
  SPFFT_EXCH_UNBUFFERED = 5,
  /* Extensions (beyond the reference enum): explicit bfloat16 wire payload
   * — halves the wire bytes vs an f32 wire (quarters vs f64). Accuracy ~1e-2
   * relative, NOT held to the 1e-6 parity bar; opt-in only. */
  SPFFT_EXCH_BUFFERED_BF16 = 6,
  SPFFT_EXCH_COMPACT_BUFFERED_BF16 = 7
};

/* Bitmask: a Grid may hold capacity for both units at once. */
enum SpfftProcessingUnitType {
  SPFFT_PU_HOST = 1,
  SPFFT_PU_GPU = 2 /* the CUDA device in this build */
};

enum SpfftIndexFormatType { SPFFT_INDEX_TRIPLETS = 0 };

enum SpfftTransformType { SPFFT_TRANS_C2C = 0, SPFFT_TRANS_R2C = 1 };

enum SpfftScalingType { SPFFT_NO_SCALING = 0, SPFFT_FULL_SCALING = 1 };

enum SpfftExecType { SPFFT_EXEC_SYNCHRONOUS = 0, SPFFT_EXEC_ASYNCHRONOUS = 1 };

#ifndef __cplusplus
typedef enum SpfftExchangeType SpfftExchangeType;
typedef enum SpfftProcessingUnitType SpfftProcessingUnitType;
typedef enum SpfftIndexFormatType SpfftIndexFormatType;
typedef enum SpfftTransformType SpfftTransformType;
typedef enum SpfftScalingType SpfftScalingType;
typedef enum SpfftExecType SpfftExecType;
#endif

#endif /* SPFFT_TPU_TYPES_H */
