/* Minimal consumer: includes the installed headers, checks the version
 * macros, and links a C API symbol. Runtime transform coverage lives in the
 * C and C++ API tests; this binary exists to prove the installed package
 * config, headers and library resolve for a downstream build. */
#include <stdio.h>

#include <spfft/spfft.h>
#include <spfft/version.h>

#if SPFFT_TPU_VERSION_MAJOR < 0
#error "version macros missing"
#endif

int main(void) {
  /* destroying a null handle must fail cleanly, exercising a real symbol */
  SpfftError err = spfft_grid_destroy(NULL);
  printf("spfft_tpu_torch %s consumer link OK (err=%d)\n", SPFFT_TPU_VERSION_STRING,
         (int)err);
  return err == SPFFT_SUCCESS ? 1 : 0;
}
