/*
 * Native benchmark CLI — the C-linkage rebuild of the reference's benchmark
 * program (reference: tests/programs/benchmark.cpp), driving the installed
 * library surface exactly like a SIRIUS-style consumer would.
 *
 * Same flag surface as the reference and as the port's Python benchmark
 * (python -m spfft_tpu_torch.programs.benchmark):
 *   -d X Y Z       grid dimensions (required)
 *   -r repeats     timed backward+forward repeats (required)
 *   -o out.json    JSON report path (optional; report always prints to stdout)
 *   -s sparsity    x-slab sparsity in [0, 1] (default 1.0)
 *   -t c2c|r2c     transform type (default c2c)
 *   -e buffered|bufferedFloat|compact|compactFloat|unbuffered
 *                  exchange discipline for --shards > 1 (default compact)
 *   -p cpu|gpu|gpu-gpu  processing unit (default cpu; gpu-gpu = gpu)
 *   -m N           independent transforms run batched per repeat (default 1)
 *   --shards N     distributed mesh size (default 1 = local transform)
 *
 * Stick-generation model (reference: benchmark.cpp:177-205): all (x, y) with
 * x < ceil(dimXFreq * sparsity); for R2C the x == 0 sticks cover only the
 * hermitian non-redundant y half; contiguous even stick split over shards.
 *
 * Timing: wall-clock (CLOCK_MONOTONIC) around the timed loop, after one
 * untimed warm-up pair per transform (compile + constant upload, reference:
 * benchmark.cpp:63-70). With FULL scaling every backward+forward pair is an
 * identity, so each repeat feeds the previous repeat's output back in — the
 * chain is dependent and cannot be elided. Each C call is one host-facing
 * call: the values and the whole space grid cross the host boundary each
 * way, which is what the reference's benchmark also measures. With -p gpu
 * the plans run on the current CUDA device (a distributed grid stacks its
 * shards there); with -p cpu on the CPU.
 */
#define _POSIX_C_SOURCE 200112L /* clock_gettime, CLOCK_MONOTONIC */

#include <limits.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <spfft/spfft.h>

#define MAX_TRANSFORMS 16

#define CHECK(expr)                                                                  \
  do {                                                                               \
    SpfftError e_ = (expr);                                                          \
    if (e_ != SPFFT_SUCCESS) {                                                       \
      fprintf(stderr, "benchmark: %s:%d: %s -> error %d\n", __FILE__, __LINE__,      \
              #expr, (int)e_);                                                       \
      return 1;                                                                      \
    }                                                                                \
  } while (0)

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

static unsigned int rng_state = 42u;
static double rng_uniform(void) {
  rng_state = rng_state * 1664525u + 1013904223u;
  return (double)(rng_state >> 8) / (double)(1u << 24) - 0.5;
}

typedef struct {
  int dims[3];
  int repeats;
  const char* out_path;
  double sparsity;
  int r2c;
  const char* exchange;
  const char* pu;
  int num_transforms;
  int shards;
} Options;

static int exchange_enum(const char* name, SpfftExchangeType* out) {
  if (strcmp(name, "buffered") == 0) *out = SPFFT_EXCH_BUFFERED;
  else if (strcmp(name, "bufferedFloat") == 0) *out = SPFFT_EXCH_BUFFERED_FLOAT;
  else if (strcmp(name, "compact") == 0) *out = SPFFT_EXCH_COMPACT_BUFFERED;
  else if (strcmp(name, "compactFloat") == 0) *out = SPFFT_EXCH_COMPACT_BUFFERED_FLOAT;
  else if (strcmp(name, "unbuffered") == 0) *out = SPFFT_EXCH_UNBUFFERED;
  else return 0;
  return 1;
}

static int parse_args(int argc, char** argv, Options* o) {
  int i;
  o->repeats = 0;
  o->dims[0] = 0;
  o->out_path = NULL;
  o->sparsity = 1.0;
  o->r2c = 0;
  o->exchange = "compact";
  o->pu = "cpu";
  o->num_transforms = 1;
  o->shards = 1;
  for (i = 1; i < argc; ++i) {
    if (strcmp(argv[i], "-d") == 0 && i + 3 < argc) {
      o->dims[0] = atoi(argv[++i]);
      o->dims[1] = atoi(argv[++i]);
      o->dims[2] = atoi(argv[++i]);
    } else if (strcmp(argv[i], "-r") == 0 && i + 1 < argc) {
      o->repeats = atoi(argv[++i]);
    } else if (strcmp(argv[i], "-o") == 0 && i + 1 < argc) {
      o->out_path = argv[++i];
    } else if (strcmp(argv[i], "-s") == 0 && i + 1 < argc) {
      o->sparsity = atof(argv[++i]);
    } else if (strcmp(argv[i], "-t") == 0 && i + 1 < argc) {
      /* a misspelled value must fail fast, not silently benchmark C2C */
      ++i;
      if (strcmp(argv[i], "r2c") != 0 && strcmp(argv[i], "c2c") != 0) {
        fprintf(stderr, "benchmark: -t must be c2c or r2c (got '%s')\n", argv[i]);
        return 0;
      }
      o->r2c = strcmp(argv[i], "r2c") == 0;
    } else if (strcmp(argv[i], "-e") == 0 && i + 1 < argc) {
      SpfftExchangeType dummy;
      o->exchange = argv[++i];
      if (!exchange_enum(o->exchange, &dummy)) {
        fprintf(stderr, "benchmark: unknown exchange '%s'\n", o->exchange);
        return 0;
      }
    } else if (strcmp(argv[i], "-p") == 0 && i + 1 < argc) {
      ++i;
      /* "gpu-gpu" (reference spelling for device-resident I/O) maps to the
       * accelerator unit — array residency is runtime-managed here */
      if (strcmp(argv[i], "cpu") != 0 && strcmp(argv[i], "gpu") != 0 &&
          strcmp(argv[i], "gpu-gpu") != 0) {
        fprintf(stderr, "benchmark: -p must be cpu, gpu or gpu-gpu (got '%s')\n",
                argv[i]);
        return 0;
      }
      o->pu = argv[i];
    } else if (strcmp(argv[i], "-m") == 0 && i + 1 < argc) {
      o->num_transforms = atoi(argv[++i]);
    } else if (strcmp(argv[i], "--shards") == 0 && i + 1 < argc) {
      o->shards = atoi(argv[++i]);
    } else {
      fprintf(stderr, "benchmark: unknown/incomplete argument '%s'\n", argv[i]);
      return 0;
    }
  }
  if (o->dims[0] <= 0 || o->repeats <= 0) {
    fprintf(stderr,
            "usage: benchmark -d X Y Z -r repeats [-o out.json] [-s sparsity]\n"
            "                 [-t c2c|r2c] [-e exchange] [-p cpu|gpu|gpu-gpu] [-m N]\n"
            "                 [--shards N]\n");
    return 0;
  }
  if (o->num_transforms < 1 || o->num_transforms > MAX_TRANSFORMS) {
    fprintf(stderr, "benchmark: -m must be in [1, %d]\n", MAX_TRANSFORMS);
    return 0;
  }
  if (o->shards > 1 && o->num_transforms != 1) {
    fprintf(stderr, "benchmark: --shards and -m are mutually exclusive\n");
    return 0;
  }
  if (o->shards < 1 || o->shards > 1024) {
    fprintf(stderr, "benchmark: --shards must be in [1, 1024]\n");
    return 0;
  }
  return 1;
}

/* Reference stick model: returns malloc'd triplets + stick count.
 * Counting is done in 64 bits (1024^3-class dense plans exceed INT_MAX/3
 * elements, so int products overflow before any cast); the C API itself
 * takes int value counts, so the caller guards num_values <= INT_MAX. */
static int* make_triplets(const Options* o, int* num_sticks, long long* num_values) {
  const int dim_x_freq = o->r2c ? o->dims[0] / 2 + 1 : o->dims[0];
  const int dim_y_freq = o->r2c ? o->dims[1] / 2 + 1 : o->dims[1];
  int num_x = (int)ceil(dim_x_freq * o->sparsity);
  int x, y, z, sticks = 0;
  size_t k = 0;
  int* trips;
  if (num_x < 1) num_x = 1;
  for (x = 0; x < num_x; ++x) sticks += (o->r2c && x == 0) ? dim_y_freq : o->dims[1];
  trips = (int*)malloc((size_t)3 * (size_t)sticks * (size_t)o->dims[2] * sizeof(int));
  if (!trips) return NULL;
  for (x = 0; x < num_x; ++x) {
    const int ny = (o->r2c && x == 0) ? dim_y_freq : o->dims[1];
    for (y = 0; y < ny; ++y)
      for (z = 0; z < o->dims[2]; ++z) {
        trips[k++] = x;
        trips[k++] = y;
        trips[k++] = z;
      }
  }
  *num_sticks = sticks;
  *num_values = (long long)sticks * o->dims[2];
  return trips;
}

int main(int argc, char** argv) {
  Options o;
  int num_sticks = 0, m, rep;
  long long n = 0, i;
  int* trips;
  SpfftProcessingUnitType pu;
  double* freq[MAX_TRANSFORMS];
  double t_backward = 0.0, t_forward = 0.0, t0, t_total;
  double pair_ms, gflops, flops;
  FILE* out;

  if (!parse_args(argc, argv, &o)) return 2;
  pu = strncmp(o.pu, "gpu", 3) == 0 ? SPFFT_PU_GPU : SPFFT_PU_HOST;
  trips = make_triplets(&o, &num_sticks, &n);
  if (!trips) return 1;
  if (n > INT_MAX) {
    fprintf(stderr, "benchmark: %lld values exceed the int-based C API limit\n", n);
    return 1;
  }

  for (m = 0; m < o.num_transforms; ++m) {
    freq[m] = (double*)malloc((size_t)2 * (size_t)n * sizeof(double));
    if (!freq[m]) {
      fprintf(stderr, "benchmark: out of memory (%lld values)\n", n);
      return 1;
    }
    for (i = 0; i < 2 * n; ++i) freq[m][i] = rng_uniform();
  }

  if (o.shards > 1) {
    /* Distributed path: contiguous even stick split (reference:
     * benchmark.cpp:190-205); shard-major triplets are already contiguous. */
    SpfftGrid grid = NULL;
    SpfftDistTransform t = NULL;
    int counts[1024];
    /* the space domain is the FULL dense grid, not the sparse value count */
    const size_t nspace = (size_t)2 * o.dims[0] * o.dims[1] * o.dims[2];
    double* space = (double*)malloc(nspace * sizeof(double));
    long long wire = 0;
    int rounds = 0, r;
    if (!space) {
      fprintf(stderr, "benchmark: out of memory (%zu space doubles)\n", nspace);
      return 1;
    }
    for (r = 0; r < o.shards; ++r) {
      int s = num_sticks / o.shards + (r < num_sticks % o.shards ? 1 : 0);
      counts[r] = s * o.dims[2];
    }
    SpfftExchangeType exch = SPFFT_EXCH_DEFAULT;
    exchange_enum(o.exchange, &exch); /* validated at parse time */
    CHECK(spfft_grid_create_distributed(&grid, o.dims[0], o.dims[1], o.dims[2],
                                        num_sticks, o.dims[2], o.shards, exch, pu,
                                        1));
    CHECK(spfft_dist_transform_create(&t, grid, pu,
                                      o.r2c ? SPFFT_TRANS_R2C : SPFFT_TRANS_C2C,
                                      o.dims[0], o.dims[1], o.dims[2], o.shards,
                                      counts, SPFFT_INDEX_TRIPLETS, trips, 1));
    CHECK(spfft_dist_transform_exchange_wire_bytes(t, &wire));
    CHECK(spfft_dist_transform_exchange_rounds(t, &rounds));

    /* warm-up (compile); the identity chain lets freq double as the output */
    CHECK(spfft_dist_transform_backward(t, freq[0], space));
    CHECK(spfft_dist_transform_forward(t, space, freq[0], SPFFT_FULL_SCALING));

    t0 = now_s();
    for (rep = 0; rep < o.repeats; ++rep) {
      double t1 = now_s();
      CHECK(spfft_dist_transform_backward(t, freq[0], space));
      t_backward += now_s() - t1;
      t1 = now_s();
      CHECK(spfft_dist_transform_forward(t, space, freq[0], SPFFT_FULL_SCALING));
      t_forward += now_s() - t1;
    }
    t_total = now_s() - t0;
    CHECK(spfft_dist_transform_destroy(t));
    CHECK(spfft_grid_destroy(grid));
    free(space);
    printf("exchange %s: wire_bytes=%lld rounds=%d\n", o.exchange, wire, rounds);
  } else {
    SpfftTransform ts[MAX_TRANSFORMS];
    const double* inputs[MAX_TRANSFORMS];
    double* outputs[MAX_TRANSFORMS];
    SpfftProcessingUnitType locs[MAX_TRANSFORMS];
    SpfftScalingType scals[MAX_TRANSFORMS];
    for (m = 0; m < o.num_transforms; ++m) {
      ts[m] = NULL;
      CHECK(spfft_transform_create_independent(
          &ts[m], 1, pu, o.r2c ? SPFFT_TRANS_R2C : SPFFT_TRANS_C2C, o.dims[0],
          o.dims[1], o.dims[2], (int)n, SPFFT_INDEX_TRIPLETS, trips));
      inputs[m] = freq[m];
      outputs[m] = freq[m]; /* identity chain: forward writes next input */
      locs[m] = pu;
      scals[m] = SPFFT_FULL_SCALING;
    }

    /* warm-up (compile) */
    CHECK(spfft_multi_transform_backward(o.num_transforms, ts, inputs, locs));
    CHECK(spfft_multi_transform_forward(o.num_transforms, ts, locs, outputs, scals));

    t0 = now_s();
    for (rep = 0; rep < o.repeats; ++rep) {
      double t1 = now_s();
      CHECK(spfft_multi_transform_backward(o.num_transforms, ts, inputs, locs));
      t_backward += now_s() - t1;
      t1 = now_s();
      CHECK(spfft_multi_transform_forward(o.num_transforms, ts, locs, outputs, scals));
      t_forward += now_s() - t1;
    }
    t_total = now_s() - t0;
    for (m = 0; m < o.num_transforms; ++m) CHECK(spfft_transform_destroy(ts[m]));
  }

  /* identity-chain sanity: repeated FULL-scaled pairs must stay bounded */
  {
    double max_abs = 0.0;
    for (i = 0; i < 2 * n && i < 4096; ++i) {
      double a = fabs(freq[0][i]);
      if (a > max_abs) max_abs = a;
    }
    if (!(max_abs < 10.0)) {
      fprintf(stderr, "benchmark: identity chain diverged (max %g)\n", max_abs);
      return 1;
    }
  }

  pair_ms = 1e3 * t_total / (o.repeats * o.num_transforms);
  flops = 2.0 * 5.0 * (double)o.dims[0] * o.dims[1] * o.dims[2] *
          log2((double)o.dims[0] * o.dims[1] * o.dims[2]);
  gflops = flops / (1e6 * pair_ms);

  out = o.out_path ? fopen(o.out_path, "w") : NULL;
  {
    char buf[1024];
    snprintf(buf, sizeof(buf),
             "{\n"
             "  \"parameters\": {\"dims\": [%d, %d, %d], \"sparsity\": %g,"
             " \"type\": \"%s\", \"processing_unit\": \"%s\","
             " \"num_transforms\": %d, \"shards\": %d, \"exchange\": \"%s\","
             " \"num_sticks\": %d, \"num_values\": %lld, \"repeats\": %d},\n"
             "  \"results\": {\"ms_per_pair\": %.3f, \"gflops\": %.1f,"
             " \"backward_ms\": %.3f, \"forward_ms\": %.3f},\n"
             "  \"harness\": \"native-c\"\n"
             "}\n",
             o.dims[0], o.dims[1], o.dims[2], o.sparsity, o.r2c ? "r2c" : "c2c",
             o.pu, o.num_transforms, o.shards, o.shards > 1 ? o.exchange : "none",
             num_sticks, n, o.repeats, pair_ms, gflops,
             1e3 * t_backward / (o.repeats * o.num_transforms),
             1e3 * t_forward / (o.repeats * o.num_transforms));
    fputs(buf, stdout);
    if (out) {
      fputs(buf, out);
      fclose(out);
    }
  }

  for (m = 0; m < o.num_transforms; ++m) free(freq[m]);
  free(trips);
  return 0;
}
