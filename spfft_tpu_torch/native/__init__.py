"""The port's C/C++/Fortran API: the sources of ``libspfft_tpu_torch.so``.

``include/spfft/`` holds the C, C++ and Fortran surface (the reference's
``spfft/*.h``, ``spfft.f90``), ``src/`` the library: the C++ classes and
extern-C handle functions over an embedded CPython interpreter that runs
:mod:`spfft_tpu_torch.capi` (``src/bridge.cpp``). ``tests/`` and
``programs/`` hold the C and C++ API tests and the benchmark program.
``python -m spfft_tpu_torch.native`` builds them
(:func:`spfft_tpu_torch._build.build_native`) and prints where.
"""
