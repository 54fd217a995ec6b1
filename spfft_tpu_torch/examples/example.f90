!> Minimal spfft-tpu Fortran example — the reference example flow
!> (reference: examples/example.f90 behavior): triplets -> grid -> transform ->
!> backward -> space pointer -> forward with scaling.
!>
!> Build: python -m spfft_tpu_torch.native builds it where gfortran exists
!> (as example_f90 beside libspfft_tpu_torch.so). By hand:
!>   gfortran spfft_tpu_torch/native/include/spfft/spfft.f90 \
!>     spfft_tpu_torch/examples/example.f90 -L<dir> -lspfft_tpu_torch -o example_f90
!>   LD_LIBRARY_PATH=<dir> PYTHONPATH=<checkout>:<site-packages> ./example_f90

program example
  use iso_c_binding
  use spfft
  implicit none

  integer, parameter :: dim = 4
  integer, parameter :: n = dim * dim * dim
  integer(c_int) :: indices(3 * n)
  real(c_double) :: freq(2 * n)
  real(c_double), pointer :: space(:)
  type(c_ptr) :: grid = c_null_ptr
  type(c_ptr) :: transform = c_null_ptr
  type(c_ptr) :: space_ptr = c_null_ptr
  integer :: x, y, z, i, k, st

  k = 1
  do x = 0, dim - 1
    do y = 0, dim - 1
      do z = 0, dim - 1
        indices(k) = x
        indices(k + 1) = y
        indices(k + 2) = z
        k = k + 3
      end do
    end do
  end do

  do i = 1, n
    freq(2 * i - 1) = real(i, c_double) / n
    freq(2 * i) = -real(i, c_double) / n
  end do

  st = spfft_grid_create(grid, dim, dim, dim, dim * dim, SPFFT_PU_HOST, 1)
  if (st /= SPFFT_SUCCESS) error stop "grid_create"

  st = spfft_transform_create(transform, grid, SPFFT_PU_HOST, SPFFT_TRANS_C2C, &
                              dim, dim, dim, dim, n, SPFFT_INDEX_TRIPLETS, indices)
  if (st /= SPFFT_SUCCESS) error stop "transform_create"

  ! the transform keeps the shared resources alive (reference semantics)
  st = spfft_grid_destroy(grid)

  st = spfft_transform_backward(transform, freq, SPFFT_PU_HOST)
  if (st /= SPFFT_SUCCESS) error stop "backward"

  st = spfft_transform_get_space_domain(transform, SPFFT_PU_HOST, space_ptr)
  if (st /= SPFFT_SUCCESS) error stop "get_space_domain"
  call c_f_pointer(space_ptr, space, [2 * n])
  print *, "space domain, first element:", space(1), space(2)

  st = spfft_transform_forward(transform, SPFFT_PU_HOST, freq, SPFFT_FULL_SCALING)
  if (st /= SPFFT_SUCCESS) error stop "forward"
  print *, "roundtrip, first element:", freq(1), freq(2), &
           " (expected", 1.0_c_double / n, -1.0_c_double / n, ")"

  st = spfft_transform_destroy(transform)
end program example
