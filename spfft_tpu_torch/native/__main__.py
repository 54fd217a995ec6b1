"""Build the native API and print its directory and the programs' PYTHONPATH.

    python -m spfft_tpu_torch.native
    # then, e.g.:  PYTHONPATH=<printed> <printed dir>/run_native_tests
"""
from .._build import build_native, native_env

if __name__ == "__main__":
    print(build_native())
    print(native_env()["PYTHONPATH"])
