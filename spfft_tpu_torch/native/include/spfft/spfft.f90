!> spfft_tpu native API — Fortran 2003 ISO-C interface module.
!>
!> bind(C) declarations for the C API in spfft/*.h, so Fortran plane-wave DFT
!> codes call this build the way they call the reference library
!> (reference: include/spfft/spfft.f90 plays the same role for the C API).
!> Handles are type(c_ptr); every function returns an SpfftError integer.
!>
!> Build note: compile this file into the application (the reference ships it
!> the same way); link against libspfft_tpu.

module spfft
  use iso_c_binding
  implicit none

  ! --- SpfftError (spfft/errors.h) ---
  integer(c_int), parameter :: SPFFT_SUCCESS = 0
  integer(c_int), parameter :: SPFFT_UNKNOWN_ERROR = 1
  integer(c_int), parameter :: SPFFT_INVALID_HANDLE_ERROR = 2
  integer(c_int), parameter :: SPFFT_OVERFLOW_ERROR = 3
  integer(c_int), parameter :: SPFFT_ALLOCATION_ERROR = 4
  integer(c_int), parameter :: SPFFT_INVALID_PARAMETER_ERROR = 5
  integer(c_int), parameter :: SPFFT_DUPLICATE_INDICES_ERROR = 6
  integer(c_int), parameter :: SPFFT_INVALID_INDICES_ERROR = 7
  integer(c_int), parameter :: SPFFT_MPI_SUPPORT_ERROR = 8
  integer(c_int), parameter :: SPFFT_MPI_ERROR = 9
  integer(c_int), parameter :: SPFFT_MPI_PARAMETER_MISMATCH_ERROR = 10
  integer(c_int), parameter :: SPFFT_HOST_EXECUTION_ERROR = 11
  integer(c_int), parameter :: SPFFT_FFTW_ERROR = 12
  integer(c_int), parameter :: SPFFT_GPU_ERROR = 13
  integer(c_int), parameter :: SPFFT_GPU_PRECEDING_ERROR = 14
  integer(c_int), parameter :: SPFFT_GPU_SUPPORT_ERROR = 15
  integer(c_int), parameter :: SPFFT_GPU_ALLOCATION_ERROR = 16
  integer(c_int), parameter :: SPFFT_GPU_LAUNCH_ERROR = 17
  integer(c_int), parameter :: SPFFT_GPU_NO_DEVICE_ERROR = 18
  integer(c_int), parameter :: SPFFT_GPU_INVALID_VALUE_ERROR = 19
  integer(c_int), parameter :: SPFFT_GPU_INVALID_DEVICE_PTR_ERROR = 20
  integer(c_int), parameter :: SPFFT_GPU_COPY_ERROR = 21
  integer(c_int), parameter :: SPFFT_GPU_FFT_ERROR = 22
  ! Extension: self-verification (ABFT) failed, recovery exhausted
  integer(c_int), parameter :: SPFFT_VERIFICATION_ERROR = 23
  ! Serving-layer extensions (the serving layer): admission refused under
  ! overload, and a request deadline expired at admission or pre-dispatch
  integer(c_int), parameter :: SPFFT_SERVICE_OVERLOAD_ERROR = 24
  integer(c_int), parameter :: SPFFT_DEADLINE_EXCEEDED_ERROR = 25
  ! Multi-host extension: a worker host died or became unreachable with
  ! work in flight (missed heartbeats / dead RPC transport)
  integer(c_int), parameter :: SPFFT_HOST_LOST_ERROR = 26

  ! --- SpfftExchangeType (spfft/types.h) ---
  integer(c_int), parameter :: SPFFT_EXCH_DEFAULT = 0
  integer(c_int), parameter :: SPFFT_EXCH_BUFFERED = 1
  integer(c_int), parameter :: SPFFT_EXCH_BUFFERED_FLOAT = 2
  integer(c_int), parameter :: SPFFT_EXCH_COMPACT_BUFFERED = 3
  integer(c_int), parameter :: SPFFT_EXCH_COMPACT_BUFFERED_FLOAT = 4
  integer(c_int), parameter :: SPFFT_EXCH_UNBUFFERED = 5
  ! Extensions: explicit bfloat16 wire (accuracy ~1e-2, opt-in only)
  integer(c_int), parameter :: SPFFT_EXCH_BUFFERED_BF16 = 6
  integer(c_int), parameter :: SPFFT_EXCH_COMPACT_BUFFERED_BF16 = 7

  ! --- SpfftProcessingUnitType ---
  integer(c_int), parameter :: SPFFT_PU_HOST = 1
  integer(c_int), parameter :: SPFFT_PU_GPU = 2

  ! --- SpfftIndexFormatType ---
  integer(c_int), parameter :: SPFFT_INDEX_TRIPLETS = 0

  ! --- SpfftTransformType ---
  integer(c_int), parameter :: SPFFT_TRANS_C2C = 0
  integer(c_int), parameter :: SPFFT_TRANS_R2C = 1

  ! --- SpfftScalingType ---
  integer(c_int), parameter :: SPFFT_NO_SCALING = 0
  integer(c_int), parameter :: SPFFT_FULL_SCALING = 1

  ! --- SpfftExecType ---
  integer(c_int), parameter :: SPFFT_EXEC_SYNCHRONOUS = 0
  integer(c_int), parameter :: SPFFT_EXEC_ASYNCHRONOUS = 1

  interface

    ! ---- grid --------------------------------------------------------------

    integer(c_int) function spfft_grid_create(grid, maxDimX, maxDimY, maxDimZ, &
        maxNumLocalZColumns, processingUnit, maxNumThreads) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: grid
      integer(c_int), value :: maxDimX, maxDimY, maxDimZ
      integer(c_int), value :: maxNumLocalZColumns, processingUnit, maxNumThreads
    end function

    integer(c_int) function spfft_grid_destroy(grid) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
    end function

    integer(c_int) function spfft_grid_max_dim_x(grid, dimX) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: dimX
    end function

    integer(c_int) function spfft_grid_max_dim_y(grid, dimY) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: dimY
    end function

    integer(c_int) function spfft_grid_max_dim_z(grid, dimZ) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: dimZ
    end function

    integer(c_int) function spfft_grid_max_num_local_z_columns(grid, numCols) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: numCols
    end function

    integer(c_int) function spfft_grid_processing_unit(grid, processingUnit) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: processingUnit
    end function

    integer(c_int) function spfft_grid_max_local_z_length(grid, maxLocalZLength) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: maxLocalZLength
    end function

    integer(c_int) function spfft_grid_device_id(grid, deviceId) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: deviceId
    end function

    integer(c_int) function spfft_grid_num_threads(grid, numThreads) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: numThreads
    end function

    ! ---- distributed grid (single-controller mesh) --------------------------

    integer(c_int) function spfft_grid_create_distributed(grid, maxDimX, maxDimY, &
        maxDimZ, maxNumLocalZColumns, maxLocalZLength, numShards, exchangeType, &
        processingUnit, maxNumThreads) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: grid
      integer(c_int), value :: maxDimX, maxDimY, maxDimZ
      integer(c_int), value :: maxNumLocalZColumns, maxLocalZLength, numShards
      integer(c_int), value :: exchangeType, processingUnit, maxNumThreads
    end function

    integer(c_int) function spfft_grid_num_shards(grid, numShards) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: numShards
    end function

    integer(c_int) function spfft_grid_create_distributed2(grid, maxDimX, maxDimY, &
        maxDimZ, maxNumLocalZColumns, maxLocalZLength, p1, p2, exchangeType, &
        processingUnit, maxNumThreads) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: grid
      integer(c_int), value :: maxDimX, maxDimY, maxDimZ
      integer(c_int), value :: maxNumLocalZColumns, maxLocalZLength, p1, p2
      integer(c_int), value :: exchangeType, processingUnit, maxNumThreads
    end function

    ! ---- transform (double) -------------------------------------------------

    integer(c_int) function spfft_transform_create_independent(transform, &
        maxNumThreads, processingUnit, transformType, dimX, dimY, dimZ, &
        numLocalElements, indexFormat, indices) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: transform
      integer(c_int), value :: maxNumThreads, processingUnit, transformType
      integer(c_int), value :: dimX, dimY, dimZ, numLocalElements, indexFormat
      integer(c_int), dimension(*), intent(in) :: indices
    end function

    integer(c_int) function spfft_transform_create(transform, grid, processingUnit, &
        transformType, dimX, dimY, dimZ, localZLength, numLocalElements, &
        indexFormat, indices) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: transform
      type(c_ptr), value :: grid
      integer(c_int), value :: processingUnit, transformType
      integer(c_int), value :: dimX, dimY, dimZ, localZLength
      integer(c_int), value :: numLocalElements, indexFormat
      integer(c_int), dimension(*), intent(in) :: indices
    end function

    integer(c_int) function spfft_transform_destroy(transform) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
    end function

    integer(c_int) function spfft_transform_clone(transform, newTransform) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      type(c_ptr), intent(out) :: newTransform
    end function

    integer(c_int) function spfft_transform_backward(transform, input, &
        outputLocation) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      real(c_double), dimension(*), intent(in) :: input
      integer(c_int), value :: outputLocation
    end function

    integer(c_int) function spfft_transform_forward(transform, inputLocation, &
        output, scaling) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: inputLocation
      real(c_double), dimension(*), intent(out) :: output
      integer(c_int), value :: scaling
    end function

    integer(c_int) function spfft_transform_get_space_domain(transform, &
        dataLocation, dataPtr) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: dataLocation
      type(c_ptr), intent(out) :: dataPtr
    end function

    integer(c_int) function spfft_transform_dim_x(transform, dimX) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: dimX
    end function

    integer(c_int) function spfft_transform_dim_y(transform, dimY) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: dimY
    end function

    integer(c_int) function spfft_transform_dim_z(transform, dimZ) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: dimZ
    end function

    integer(c_int) function spfft_transform_local_z_length(transform, len) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: len
    end function

    integer(c_int) function spfft_transform_local_z_offset(transform, off) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: off
    end function

    integer(c_int) function spfft_transform_num_local_elements(transform, n) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: n
    end function

    integer(c_int) function spfft_transform_num_global_elements(transform, n) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_long_long), intent(out) :: n
    end function

    integer(c_int) function spfft_transform_global_size(transform, n) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_long_long), intent(out) :: n
    end function

    integer(c_int) function spfft_transform_set_execution_mode(transform, mode) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: mode
    end function

    integer(c_int) function spfft_transform_execution_mode(transform, mode) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: mode
    end function

    integer(c_int) function spfft_transform_type(transform, transformType) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: transformType
    end function

    integer(c_int) function spfft_transform_processing_unit(transform, &
        processingUnit) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: processingUnit
    end function

    integer(c_int) function spfft_transform_local_slice_size(transform, size) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: size
    end function

    integer(c_int) function spfft_transform_device_id(transform, deviceId) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: deviceId
    end function

    integer(c_int) function spfft_transform_num_threads(transform, numThreads) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: numThreads
    end function

    ! ---- transform (float) --------------------------------------------------

    integer(c_int) function spfft_float_transform_create_independent(transform, &
        maxNumThreads, processingUnit, transformType, dimX, dimY, dimZ, &
        numLocalElements, indexFormat, indices) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: transform
      integer(c_int), value :: maxNumThreads, processingUnit, transformType
      integer(c_int), value :: dimX, dimY, dimZ, numLocalElements, indexFormat
      integer(c_int), dimension(*), intent(in) :: indices
    end function

    integer(c_int) function spfft_float_transform_destroy(transform) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
    end function

    integer(c_int) function spfft_float_transform_backward(transform, input, &
        outputLocation) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      real(c_float), dimension(*), intent(in) :: input
      integer(c_int), value :: outputLocation
    end function

    integer(c_int) function spfft_float_transform_forward(transform, &
        inputLocation, output, scaling) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: inputLocation
      real(c_float), dimension(*), intent(out) :: output
      integer(c_int), value :: scaling
    end function

    integer(c_int) function spfft_float_transform_get_space_domain(transform, &
        dataLocation, dataPtr) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: dataLocation
      type(c_ptr), intent(out) :: dataPtr
    end function

    integer(c_int) function spfft_float_grid_create(grid, maxDimX, maxDimY, &
        maxDimZ, maxNumLocalZColumns, processingUnit, maxNumThreads) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: grid
      integer(c_int), value :: maxDimX, maxDimY, maxDimZ
      integer(c_int), value :: maxNumLocalZColumns, processingUnit, maxNumThreads
    end function

    integer(c_int) function spfft_float_transform_create(transform, grid, &
        processingUnit, transformType, dimX, dimY, dimZ, localZLength, &
        numLocalElements, indexFormat, indices) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: transform
      type(c_ptr), value :: grid
      integer(c_int), value :: processingUnit, transformType
      integer(c_int), value :: dimX, dimY, dimZ, localZLength
      integer(c_int), value :: numLocalElements, indexFormat
      integer(c_int), dimension(*), intent(in) :: indices
    end function

    integer(c_int) function spfft_float_transform_clone(transform, newTransform) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      type(c_ptr), intent(out) :: newTransform
    end function

    integer(c_int) function spfft_float_transform_type(transform, transformType) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: transformType
    end function

    integer(c_int) function spfft_float_transform_dim_x(transform, dimX) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: dimX
    end function

    integer(c_int) function spfft_float_transform_dim_y(transform, dimY) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: dimY
    end function

    integer(c_int) function spfft_float_transform_dim_z(transform, dimZ) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: dimZ
    end function

    integer(c_int) function spfft_float_transform_local_z_length(transform, len) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: len
    end function

    integer(c_int) function spfft_float_transform_local_z_offset(transform, off) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: off
    end function

    integer(c_int) function spfft_float_transform_num_local_elements(transform, &
        n) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: n
    end function

    integer(c_int) function spfft_float_transform_processing_unit(transform, &
        processingUnit) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: processingUnit
    end function

    integer(c_int) function spfft_float_transform_execution_mode(transform, &
        mode) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: mode
    end function

    integer(c_int) function spfft_float_transform_set_execution_mode(transform, &
        mode) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: mode
    end function

    integer(c_int) function spfft_float_transform_local_slice_size(transform, &
        size) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: size
    end function

    integer(c_int) function spfft_float_transform_num_global_elements(transform, &
        n) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_long_long), intent(out) :: n
    end function

    integer(c_int) function spfft_float_transform_global_size(transform, n) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_long_long), intent(out) :: n
    end function

    integer(c_int) function spfft_float_transform_device_id(transform, &
        deviceId) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: deviceId
    end function

    integer(c_int) function spfft_float_transform_num_threads(transform, &
        numThreads) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: numThreads
    end function

    ! ---- grid (float tier) --------------------------------------------------
    ! Same capacity object as the double grid (precision lives on the
    ! Transform); full reference surface (reference: grid_float.h:30-190).

    integer(c_int) function spfft_float_grid_create_distributed(grid, maxDimX, &
        maxDimY, maxDimZ, maxNumLocalZColumns, maxLocalZLength, numShards, &
        exchangeType, processingUnit, maxNumThreads) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: grid
      integer(c_int), value :: maxDimX, maxDimY, maxDimZ
      integer(c_int), value :: maxNumLocalZColumns, maxLocalZLength, numShards
      integer(c_int), value :: exchangeType, processingUnit, maxNumThreads
    end function

    integer(c_int) function spfft_float_grid_destroy(grid) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
    end function

    integer(c_int) function spfft_float_grid_max_dim_x(grid, dimX) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: dimX
    end function

    integer(c_int) function spfft_float_grid_max_dim_y(grid, dimY) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: dimY
    end function

    integer(c_int) function spfft_float_grid_max_dim_z(grid, dimZ) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: dimZ
    end function

    integer(c_int) function spfft_float_grid_max_num_local_z_columns(grid, &
        maxNumLocalZColumns) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: maxNumLocalZColumns
    end function

    integer(c_int) function spfft_float_grid_max_local_z_length(grid, &
        maxLocalZLength) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: maxLocalZLength
    end function

    integer(c_int) function spfft_float_grid_processing_unit(grid, &
        processingUnit) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: processingUnit
    end function

    integer(c_int) function spfft_float_grid_device_id(grid, deviceId) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: deviceId
    end function

    integer(c_int) function spfft_float_grid_num_threads(grid, numThreads) bind(C)
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: numThreads
    end function

    ! ---- MPI-surface parity stubs -------------------------------------------
    ! No MPI exists in this runtime (the device mesh replaces the
    ! communicator); these link and return SPFFT_MPI_SUPPORT_ERROR. The bind
    ! targets are the *_fortran entry points taking an MPI_Fint-style integer,
    ! exactly like the reference module (reference: spfft.f90:165-169,310-316).

    integer(c_int) function spfft_grid_communicator(grid, comm) &
        bind(C, name="spfft_grid_communicator_fortran")
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: comm
    end function

    integer(c_int) function spfft_float_grid_communicator(grid, comm) &
        bind(C, name="spfft_float_grid_communicator_fortran")
      use iso_c_binding
      type(c_ptr), value :: grid
      integer(c_int), intent(out) :: comm
    end function

    integer(c_int) function spfft_transform_communicator(transform, comm) &
        bind(C, name="spfft_transform_communicator_fortran")
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: comm
    end function

    integer(c_int) function spfft_float_transform_communicator(transform, comm) &
        bind(C, name="spfft_float_transform_communicator_fortran")
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: comm
    end function

    integer(c_int) function spfft_transform_create_independent_distributed( &
        transform, maxNumThreads, comm, exchangeType, processingUnit, &
        transformType, dimX, dimY, dimZ, localZLength, numLocalElements, &
        indexFormat, indices) &
        bind(C, name="spfft_transform_create_independent_distributed_fortran")
      use iso_c_binding
      type(c_ptr), intent(out) :: transform
      integer(c_int), value :: maxNumThreads, comm, exchangeType
      integer(c_int), value :: processingUnit, transformType
      integer(c_int), value :: dimX, dimY, dimZ, localZLength
      integer(c_int), value :: numLocalElements, indexFormat
      integer(c_int), dimension(*), intent(in) :: indices
    end function

    integer(c_int) function spfft_float_transform_create_independent_distributed( &
        transform, maxNumThreads, comm, exchangeType, processingUnit, &
        transformType, dimX, dimY, dimZ, localZLength, numLocalElements, &
        indexFormat, indices) &
        bind(C, name="spfft_float_transform_create_independent_distributed_fortran")
      use iso_c_binding
      type(c_ptr), intent(out) :: transform
      integer(c_int), value :: maxNumThreads, comm, exchangeType
      integer(c_int), value :: processingUnit, transformType
      integer(c_int), value :: dimX, dimY, dimZ, localZLength
      integer(c_int), value :: numLocalElements, indexFormat
      integer(c_int), dimension(*), intent(in) :: indices
    end function

    ! ---- multi-transform ----------------------------------------------------

    integer(c_int) function spfft_multi_transform_backward(numTransforms, &
        transforms, input, outputLocations) bind(C)
      use iso_c_binding
      integer(c_int), value :: numTransforms
      type(c_ptr), dimension(*), intent(in) :: transforms
      type(c_ptr), dimension(*), intent(in) :: input
      integer(c_int), dimension(*), intent(in) :: outputLocations
    end function

    integer(c_int) function spfft_multi_transform_forward(numTransforms, &
        transforms, inputLocations, output, scalingTypes) bind(C)
      use iso_c_binding
      integer(c_int), value :: numTransforms
      type(c_ptr), dimension(*), intent(in) :: transforms
      integer(c_int), dimension(*), intent(in) :: inputLocations
      type(c_ptr), dimension(*), intent(in) :: output
      integer(c_int), dimension(*), intent(in) :: scalingTypes
    end function

    integer(c_int) function spfft_float_multi_transform_backward(numTransforms, &
        transforms, input, outputLocations) bind(C)
      use iso_c_binding
      integer(c_int), value :: numTransforms
      type(c_ptr), dimension(*), intent(in) :: transforms
      type(c_ptr), dimension(*), intent(in) :: input
      integer(c_int), dimension(*), intent(in) :: outputLocations
    end function

    integer(c_int) function spfft_float_multi_transform_forward(numTransforms, &
        transforms, inputLocations, output, scalingTypes) bind(C)
      use iso_c_binding
      integer(c_int), value :: numTransforms
      type(c_ptr), dimension(*), intent(in) :: transforms
      integer(c_int), dimension(*), intent(in) :: inputLocations
      type(c_ptr), dimension(*), intent(in) :: output
      integer(c_int), dimension(*), intent(in) :: scalingTypes
    end function

    ! ---- distributed transform (single-controller mesh) ---------------------

    integer(c_int) function spfft_dist_transform_create(transform, grid, &
        processingUnit, transformType, dimX, dimY, dimZ, numShards, &
        shardNumElements, indexFormat, indices, doublePrecision) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: transform
      type(c_ptr), value :: grid
      integer(c_int), value :: processingUnit, transformType
      integer(c_int), value :: dimX, dimY, dimZ, numShards
      integer(c_int), dimension(*), intent(in) :: shardNumElements
      integer(c_int), value :: indexFormat
      integer(c_int), dimension(*), intent(in) :: indices
      integer(c_int), value :: doublePrecision
    end function

    integer(c_int) function spfft_dist_transform_create_independent(transform, &
        maxNumThreads, numShards, exchangeType, processingUnit, transformType, &
        dimX, dimY, dimZ, shardNumElements, indexFormat, indices, &
        doublePrecision) bind(C)
      use iso_c_binding
      type(c_ptr), intent(out) :: transform
      integer(c_int), value :: maxNumThreads, numShards, exchangeType
      integer(c_int), value :: processingUnit, transformType
      integer(c_int), value :: dimX, dimY, dimZ
      integer(c_int), dimension(*), intent(in) :: shardNumElements
      integer(c_int), value :: indexFormat
      integer(c_int), dimension(*), intent(in) :: indices
      integer(c_int), value :: doublePrecision
    end function

    integer(c_int) function spfft_dist_transform_destroy(transform) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
    end function

    integer(c_int) function spfft_dist_transform_backward(transform, values, &
        space) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      real(c_double), dimension(*), intent(in) :: values
      real(c_double), dimension(*), intent(out) :: space
    end function

    integer(c_int) function spfft_float_dist_transform_backward(transform, values, &
        space) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      real(c_float), dimension(*), intent(in) :: values
      real(c_float), dimension(*), intent(out) :: space
    end function

    integer(c_int) function spfft_dist_transform_forward(transform, space, values, &
        scaling) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      real(c_double), dimension(*), intent(in) :: space
      real(c_double), dimension(*), intent(out) :: values
      integer(c_int), value :: scaling
    end function

    integer(c_int) function spfft_float_dist_transform_forward(transform, space, &
        values, scaling) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      real(c_float), dimension(*), intent(in) :: space
      real(c_float), dimension(*), intent(out) :: values
      integer(c_int), value :: scaling
    end function

    integer(c_int) function spfft_dist_transform_type(transform, transformType) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: transformType
    end function

    integer(c_int) function spfft_dist_transform_dim_x(transform, dimX) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: dimX
    end function

    integer(c_int) function spfft_dist_transform_dim_y(transform, dimY) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: dimY
    end function

    integer(c_int) function spfft_dist_transform_dim_z(transform, dimZ) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: dimZ
    end function

    integer(c_int) function spfft_dist_transform_num_shards(transform, &
        numShards) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: numShards
    end function

    integer(c_int) function spfft_dist_transform_num_global_elements(transform, &
        numGlobalElements) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_long_long), intent(out) :: numGlobalElements
    end function

    integer(c_int) function spfft_dist_transform_global_size(transform, &
        globalSize) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_long_long), intent(out) :: globalSize
    end function

    integer(c_int) function spfft_dist_transform_exchange_type(transform, &
        exchangeType) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: exchangeType
    end function

    integer(c_int) function spfft_dist_transform_exchange_wire_bytes(transform, &
        wireBytes) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_long_long), intent(out) :: wireBytes
    end function

    integer(c_int) function spfft_dist_transform_exchange_rounds(transform, &
        rounds) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), intent(out) :: rounds
    end function

    integer(c_int) function spfft_dist_transform_local_z_length(transform, shard, &
        localZLength) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: shard
      integer(c_int), intent(out) :: localZLength
    end function

    integer(c_int) function spfft_dist_transform_local_z_offset(transform, shard, &
        offset) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: shard
      integer(c_int), intent(out) :: offset
    end function

    integer(c_int) function spfft_dist_transform_local_y_length(transform, shard, &
        localYLength) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: shard
      integer(c_int), intent(out) :: localYLength
    end function

    integer(c_int) function spfft_dist_transform_local_y_offset(transform, shard, &
        offset) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: shard
      integer(c_int), intent(out) :: offset
    end function

    integer(c_int) function spfft_dist_transform_num_local_elements(transform, &
        shard, numLocalElements) bind(C)
      use iso_c_binding
      type(c_ptr), value :: transform
      integer(c_int), value :: shard
      integer(c_int), intent(out) :: numLocalElements
    end function

  end interface
end module spfft
