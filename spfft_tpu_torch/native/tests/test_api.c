/*
 * C-linkage end-to-end test of the spfft_tpu native API.
 *
 * Exercises the same flow as the reference example (reference:
 * examples/example.c): build index triplets, create grid + transform,
 * backward into the space domain, read space_domain_data, forward back with
 * scaling, verify the round trip. Also checks the float API, clone,
 * multi-transform and error-code behavior.
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <spfft/spfft.h>

#define CHECK(expr)                                                                      \
  do {                                                                                   \
    SpfftError e_ = (expr);                                                              \
    if (e_ != SPFFT_SUCCESS) {                                                           \
      fprintf(stderr, "FAIL %s:%d: %s -> %d\n", __FILE__, __LINE__, #expr, (int)e_);     \
      return 1;                                                                          \
    }                                                                                    \
  } while (0)

#define REQUIRE(cond)                                                                    \
  do {                                                                                   \
    if (!(cond)) {                                                                       \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);                    \
      return 1;                                                                          \
    }                                                                                    \
  } while (0)

static unsigned int rng_state = 42u;
static double rng_uniform(void) {
  rng_state = rng_state * 1664525u + 1013904223u;
  return (double)(rng_state >> 8) / (double)(1u << 24) - 0.5;
}

int main(void) {
  const int dim = 8;
  const int n = dim * dim * dim;
  int* indices = (int*)malloc((size_t)(3 * n) * sizeof(int));
  int x, y, z, i, k = 0;
  for (x = 0; x < dim; ++x)
    for (y = 0; y < dim; ++y)
      for (z = 0; z < dim; ++z) {
        indices[k++] = x;
        indices[k++] = y;
        indices[k++] = z;
      }

  /* ---- double precision, grid-based -------------------------------------- */
  SpfftGrid grid = NULL;
  CHECK(spfft_grid_create(&grid, dim, dim, dim, dim * dim, SPFFT_PU_HOST, 1));

  int got = 0;
  CHECK(spfft_grid_max_dim_x(grid, &got));
  REQUIRE(got == dim);

  SpfftTransform t = NULL;
  CHECK(spfft_transform_create(&t, grid, SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim, dim, dim,
                               dim, n, SPFFT_INDEX_TRIPLETS, indices));

  CHECK(spfft_transform_dim_x(t, &got));
  REQUIRE(got == dim);
  CHECK(spfft_transform_num_local_elements(t, &got));
  REQUIRE(got == n);
  long long gs = 0;
  CHECK(spfft_transform_global_size(t, &gs));
  REQUIRE(gs == (long long)n);

  double* freq = (double*)malloc((size_t)(2 * n) * sizeof(double));
  for (i = 0; i < 2 * n; ++i) freq[i] = rng_uniform();

  CHECK(spfft_transform_backward(t, freq, SPFFT_PU_HOST));

  double* space = NULL;
  CHECK(spfft_transform_get_space_domain(t, SPFFT_PU_HOST, &space));
  REQUIRE(space != NULL);

  /* Round trip with full scaling must reproduce the input. */
  double* back = (double*)malloc((size_t)(2 * n) * sizeof(double));
  CHECK(spfft_transform_forward(t, SPFFT_PU_HOST, back, SPFFT_FULL_SCALING));
  {
    double max_err = 0.0;
    for (i = 0; i < 2 * n; ++i) {
      double d = fabs(back[i] - freq[i]);
      if (d > max_err) max_err = d;
    }
    printf("double roundtrip max err: %g\n", max_err);
    REQUIRE(max_err < 1e-6);
  }

  /* backward_ptr writes the same slab to a caller buffer. */
  {
    double* slab = (double*)malloc((size_t)(2 * n) * sizeof(double));
    CHECK(spfft_transform_backward_ptr(t, freq, slab));
    {
      double max_err = 0.0;
      for (i = 0; i < 2 * n; ++i) {
        double d = fabs(slab[i] - space[i]);
        if (d > max_err) max_err = d;
      }
      REQUIRE(max_err == 0.0); /* identical bytes: same backward, same slab */
    }
    free(slab);
  }

  /* Write-then-forward through the space-domain pointer: scale by 2. */
  for (i = 0; i < 2 * n; ++i) space[i] *= 2.0;
  CHECK(spfft_transform_forward(t, SPFFT_PU_HOST, back, SPFFT_FULL_SCALING));
  {
    double max_err = 0.0;
    for (i = 0; i < 2 * n; ++i) {
      double d = fabs(back[i] - 2.0 * freq[i]);
      if (d > max_err) max_err = d;
    }
    REQUIRE(max_err < 1e-6);
  }

  /* Clone is independent but same layout. */
  SpfftTransform tc = NULL;
  CHECK(spfft_transform_clone(t, &tc));
  CHECK(spfft_transform_dim_x(tc, &got));
  REQUIRE(got == dim);

  /* Multi-transform: run both plans batched. */
  {
    SpfftTransform pair[2];
    const double* inputs[2];
    double* outputs[2];
    SpfftProcessingUnitType locs[2] = {SPFFT_PU_HOST, SPFFT_PU_HOST};
    SpfftScalingType scals[2] = {SPFFT_FULL_SCALING, SPFFT_FULL_SCALING};
    double* back2 = (double*)malloc((size_t)(2 * n) * sizeof(double));
    pair[0] = t;
    pair[1] = tc;
    inputs[0] = freq;
    inputs[1] = freq;
    outputs[0] = back;
    outputs[1] = back2;
    CHECK(spfft_multi_transform_backward(2, pair, inputs, locs));
    CHECK(spfft_multi_transform_forward(2, pair, locs, outputs, scals));
    {
      double max_err = 0.0;
      for (i = 0; i < 2 * n; ++i) {
        double d = fabs(back2[i] - freq[i]);
        if (d > max_err) max_err = d;
      }
      REQUIRE(max_err < 1e-6);
    }
    free(back2);
  }

  /* ---- single precision, grid-less ---------------------------------------- */
  {
    SpfftFloatTransform ft = NULL;
    float* ffreq = (float*)malloc((size_t)(2 * n) * sizeof(float));
    float* fback = (float*)malloc((size_t)(2 * n) * sizeof(float));
    for (i = 0; i < 2 * n; ++i) ffreq[i] = (float)rng_uniform();
    CHECK(spfft_float_transform_create_independent(&ft, 1, SPFFT_PU_HOST,
                                                   SPFFT_TRANS_C2C, dim, dim, dim, n,
                                                   SPFFT_INDEX_TRIPLETS, indices));
    float* fslab = (float*)malloc((size_t)(2 * n) * sizeof(float));
    float* fspace = NULL;
    CHECK(spfft_float_transform_backward(ft, ffreq, SPFFT_PU_HOST));
    CHECK(spfft_float_transform_backward_ptr(ft, ffreq, fslab));
    CHECK(spfft_float_transform_get_space_domain(ft, SPFFT_PU_HOST, &fspace));
    for (i = 0; i < 2 * n; ++i) REQUIRE(fslab[i] == fspace[i]);
    free(fslab);
    CHECK(spfft_float_transform_forward(ft, SPFFT_PU_HOST, fback, SPFFT_FULL_SCALING));
    {
      double max_err = 0.0;
      for (i = 0; i < 2 * n; ++i) {
        double d = fabs((double)fback[i] - (double)ffreq[i]);
        if (d > max_err) max_err = d;
      }
      printf("float roundtrip max err: %g\n", max_err);
      REQUIRE(max_err < 1e-4);
    }
    CHECK(spfft_float_transform_destroy(ft));
    free(ffreq);
    free(fback);
  }

  /* ---- single precision, grid-based (reference: grid_float.h surface) ----- */
  {
    SpfftFloatGrid fgrid = NULL;
    SpfftFloatTransform ft = NULL;
    SpfftProcessingUnitType fpu;
    float* ffreq = (float*)malloc((size_t)(2 * n) * sizeof(float));
    float* fback = (float*)malloc((size_t)(2 * n) * sizeof(float));
    int fgot = 0;
    for (i = 0; i < 2 * n; ++i) ffreq[i] = (float)rng_uniform();
    CHECK(spfft_float_grid_create(&fgrid, dim, dim, dim, dim * dim, SPFFT_PU_HOST, 1));
    CHECK(spfft_float_grid_max_dim_x(fgrid, &fgot));
    REQUIRE(fgot == dim);
    CHECK(spfft_float_grid_max_dim_y(fgrid, &fgot));
    REQUIRE(fgot == dim);
    CHECK(spfft_float_grid_max_dim_z(fgrid, &fgot));
    REQUIRE(fgot == dim);
    CHECK(spfft_float_grid_max_num_local_z_columns(fgrid, &fgot));
    REQUIRE(fgot == dim * dim);
    CHECK(spfft_float_grid_processing_unit(fgrid, &fpu));
    REQUIRE(fpu == SPFFT_PU_HOST);
    CHECK(spfft_float_grid_num_threads(fgrid, &fgot));
    REQUIRE(fgot >= 1);
    CHECK(spfft_float_grid_device_id(fgrid, &fgot));
    CHECK(spfft_float_transform_create(&ft, fgrid, SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim,
                                       dim, dim, dim, n, SPFFT_INDEX_TRIPLETS, indices));
    /* Grid may be destroyed once the transform holds its capacity. */
    CHECK(spfft_float_grid_destroy(fgrid));
    {
      long long fgs = 0;
      CHECK(spfft_float_transform_local_slice_size(ft, &fgot));
      REQUIRE(fgot == n);
      CHECK(spfft_float_transform_num_global_elements(ft, &fgs));
      REQUIRE(fgs == (long long)n);
      CHECK(spfft_float_transform_global_size(ft, &fgs));
      REQUIRE(fgs == (long long)n);
      CHECK(spfft_float_transform_num_threads(ft, &fgot));
      REQUIRE(fgot >= 1);
      CHECK(spfft_float_transform_device_id(ft, &fgot));
    }
    CHECK(spfft_float_transform_backward(ft, ffreq, SPFFT_PU_HOST));
    CHECK(spfft_float_transform_forward(ft, SPFFT_PU_HOST, fback, SPFFT_FULL_SCALING));
    {
      double max_err = 0.0;
      for (i = 0; i < 2 * n; ++i) {
        double d = fabs((double)fback[i] - (double)ffreq[i]);
        if (d > max_err) max_err = d;
      }
      printf("float-grid roundtrip max err: %g\n", max_err);
      REQUIRE(max_err < 1e-4);
    }
    /* Float pointer-based batch (reference: multi_transform_float.h:60-95). */
    {
      SpfftFloatTransform one[1];
      const float* fins[1];
      float* fspaces[1];
      float* fouts[1];
      SpfftScalingType fscals[1] = {SPFFT_FULL_SCALING};
      float* fslab = (float*)malloc((size_t)(2 * n) * sizeof(float));
      float* fout = (float*)malloc((size_t)(2 * n) * sizeof(float));
      one[0] = ft;
      fins[0] = ffreq;
      fspaces[0] = fslab;
      fouts[0] = fout;
      CHECK(spfft_float_multi_transform_backward_ptr(1, one, fins, fspaces));
      CHECK(spfft_float_multi_transform_forward_ptr(1, one, (const float* const*)fspaces,
                                                    fouts, fscals));
      {
        double max_err = 0.0;
        for (i = 0; i < 2 * n; ++i) {
          double d = fabs((double)fout[i] - (double)ffreq[i]);
          if (d > max_err) max_err = d;
        }
        REQUIRE(max_err < 1e-4);
      }
      free(fslab);
      free(fout);
    }
    CHECK(spfft_float_transform_destroy(ft));
    free(ffreq);
    free(fback);
  }

  /* ---- pointer-based double batch (reference: multi_transform.h:60-95) ---- */
  {
    SpfftTransform one[1];
    const double* ins[1];
    double* spaces[1];
    double* outs[1];
    SpfftScalingType scals1[1] = {SPFFT_FULL_SCALING};
    double* slab = (double*)malloc((size_t)(2 * n) * sizeof(double));
    double* out = (double*)malloc((size_t)(2 * n) * sizeof(double));
    one[0] = t;
    ins[0] = freq;
    spaces[0] = slab;
    outs[0] = out;
    CHECK(spfft_multi_transform_backward_ptr(1, one, ins, spaces));
    CHECK(spfft_multi_transform_forward_ptr(1, one, (const double* const*)spaces, outs,
                                            scals1));
    {
      double max_err = 0.0;
      for (i = 0; i < 2 * n; ++i) {
        double d = fabs(out[i] - freq[i]);
        if (d > max_err) max_err = d;
      }
      REQUIRE(max_err < 1e-6);
    }
    free(slab);
    free(out);
  }

  /* ---- MPI-surface parity stubs link and fail cleanly --------------------- */
  {
    void* comm = NULL;
    SpfftTransform dt = NULL;
    REQUIRE(spfft_grid_communicator(grid, &comm) == SPFFT_MPI_SUPPORT_ERROR);
    REQUIRE(spfft_transform_communicator(t, &comm) == SPFFT_MPI_SUPPORT_ERROR);
    REQUIRE(spfft_float_grid_communicator(grid, &comm) == SPFFT_MPI_SUPPORT_ERROR);
    REQUIRE(spfft_transform_create_independent_distributed(
                &dt, 1, NULL, SPFFT_EXCH_DEFAULT, SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim,
                dim, dim, dim, n, SPFFT_INDEX_TRIPLETS, indices) ==
            SPFFT_MPI_SUPPORT_ERROR);
  }

  /* ---- error behavior ----------------------------------------------------- */
  REQUIRE(spfft_transform_backward(NULL, freq, SPFFT_PU_HOST) ==
          SPFFT_INVALID_HANDLE_ERROR);
  {
    /* Out-of-bounds index triplet must be rejected with an indices error. */
    SpfftTransform bad = NULL;
    int bad_idx[3] = {dim + 5, 0, 0};
    SpfftError e = spfft_transform_create_independent(
        &bad, 1, SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim, dim, dim, 1,
        SPFFT_INDEX_TRIPLETS, bad_idx);
    REQUIRE(e == SPFFT_INVALID_INDICES_ERROR || e == SPFFT_INVALID_PARAMETER_ERROR);
    /* Duplicate triplets must be rejected. */
    int dup_idx[6] = {1, 1, 1, 1, 1, 1};
    e = spfft_transform_create_independent(&bad, 1, SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim,
                                           dim, dim, 2, SPFFT_INDEX_TRIPLETS, dup_idx);
    REQUIRE(e == SPFFT_DUPLICATE_INDICES_ERROR);
  }

  /* ---- distributed (single-controller 4-shard mesh) ----------------------- */
  {
    const int shards = 4;
    int counts[4];
    int* didx = (int*)malloc((size_t)(3 * n) * sizeof(int));
    double* dfreq = (double*)malloc((size_t)(2 * n) * sizeof(double));
    double* dback = (double*)malloc((size_t)(2 * n) * sizeof(double));
    double* dspace = (double*)malloc((size_t)(2 * n) * sizeof(double));
    int r, got2 = 0;
    long long ll = 0;
    k = 0;
    /* shard r owns sticks x in {2r, 2r+1}: shard-major concatenated triplets */
    for (r = 0; r < shards; ++r) {
      counts[r] = 2 * dim * dim;
      for (x = 2 * r; x < 2 * r + 2; ++x)
        for (y = 0; y < dim; ++y)
          for (z = 0; z < dim; ++z) {
            didx[k++] = x;
            didx[k++] = y;
            didx[k++] = z;
          }
    }
    for (i = 0; i < 2 * n; ++i) dfreq[i] = rng_uniform();

    SpfftGrid dgrid = NULL;
    CHECK(spfft_grid_create_distributed(&dgrid, dim, dim, dim, dim * dim, dim, shards,
                                        SPFFT_EXCH_COMPACT_BUFFERED, SPFFT_PU_HOST, 1));
    CHECK(spfft_grid_num_shards(dgrid, &got2));
    REQUIRE(got2 == shards);

    SpfftDistTransform dt = NULL;
    CHECK(spfft_dist_transform_create(&dt, dgrid, SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim,
                                      dim, dim, shards, counts, SPFFT_INDEX_TRIPLETS,
                                      didx, 1));
    CHECK(spfft_dist_transform_num_shards(dt, &got2));
    REQUIRE(got2 == shards);
    CHECK(spfft_dist_transform_num_global_elements(dt, &ll));
    REQUIRE(ll == (long long)n);
    CHECK(spfft_dist_transform_local_z_length(dt, 0, &got2));
    REQUIRE(got2 == dim / shards);
    CHECK(spfft_dist_transform_num_local_elements(dt, 1, &got2));
    REQUIRE(got2 == counts[1]);
    CHECK(spfft_dist_transform_exchange_wire_bytes(dt, &ll));
    REQUIRE(ll > 0);
    {
      /* Every discipline is one exchange round here: the exact-count
       * blocks move in one gather (one all_to_all_single over a process
       * group, which takes uneven split sizes). */
      int rounds = 0;
      CHECK(spfft_dist_transform_exchange_rounds(dt, &rounds));
      REQUIRE(rounds == 1);
    }

    CHECK(spfft_dist_transform_backward(dt, dfreq, dspace));
    /* explicit-space forward */
    CHECK(spfft_dist_transform_forward(dt, dspace, dback, SPFFT_FULL_SCALING));
    {
      double max_err = 0.0;
      for (i = 0; i < 2 * n; ++i) {
        double d = fabs(dback[i] - dfreq[i]);
        if (d > max_err) max_err = d;
      }
      printf("distributed roundtrip max err: %g\n", max_err);
      REQUIRE(max_err < 1e-6);
    }
    /* retained-space forward (NULL space pointer) */
    memset(dback, 0, (size_t)(2 * n) * sizeof(double));
    CHECK(spfft_dist_transform_forward(dt, NULL, dback, SPFFT_FULL_SCALING));
    {
      double max_err = 0.0;
      for (i = 0; i < 2 * n; ++i) {
        double d = fabs(dback[i] - dfreq[i]);
        if (d > max_err) max_err = d;
      }
      REQUIRE(max_err < 1e-6);
    }
    /* precision mismatch must be rejected, not misread */
    REQUIRE(spfft_float_dist_transform_backward(dt, (const float*)dfreq,
                                                (float*)dspace) ==
            SPFFT_INVALID_PARAMETER_ERROR);
    /* out-of-range shard index */
    REQUIRE(spfft_dist_transform_local_z_length(dt, shards, &got2) ==
            SPFFT_INVALID_PARAMETER_ERROR);

    /* 2-D pencil mesh grid (2x2) over the same 4 devices: same dist API */
    {
      SpfftGrid pgrid = NULL;
      SpfftDistTransform pt = NULL;
      CHECK(spfft_grid_create_distributed2(&pgrid, dim, dim, dim, dim * dim, dim, 2,
                                           2, SPFFT_EXCH_DEFAULT, SPFFT_PU_HOST, 1));
      CHECK(spfft_dist_transform_create(&pt, pgrid, SPFFT_PU_HOST, SPFFT_TRANS_C2C,
                                        dim, dim, dim, shards, counts,
                                        SPFFT_INDEX_TRIPLETS, didx, 1));
      CHECK(spfft_dist_transform_local_y_length(pt, 0, &got2));
      REQUIRE(got2 == dim / 2); /* y split over the first mesh axis */
      CHECK(spfft_dist_transform_local_z_length(pt, 0, &got2));
      REQUIRE(got2 == dim / 2);
      CHECK(spfft_dist_transform_backward(pt, dfreq, dspace));
      CHECK(spfft_dist_transform_forward(pt, dspace, dback, SPFFT_FULL_SCALING));
      {
        double max_err = 0.0;
        for (i = 0; i < 2 * n; ++i) {
          double d = fabs(dback[i] - dfreq[i]);
          if (d > max_err) max_err = d;
        }
        printf("pencil2 roundtrip max err: %g\n", max_err);
        REQUIRE(max_err < 1e-6);
      }
      CHECK(spfft_dist_transform_destroy(pt));
      CHECK(spfft_grid_destroy(pgrid));
    }

    /* grid-less distributed ctor (single-controller form of the reference's
     * spfft_transform_create_independent_distributed) */
    {
      SpfftDistTransform it = NULL;
      CHECK(spfft_dist_transform_create_independent(
          &it, 1, shards, SPFFT_EXCH_DEFAULT, SPFFT_PU_HOST, SPFFT_TRANS_C2C, dim,
          dim, dim, counts, SPFFT_INDEX_TRIPLETS, didx, 1));
      CHECK(spfft_dist_transform_backward(it, dfreq, dspace));
      CHECK(spfft_dist_transform_forward(it, dspace, dback, SPFFT_FULL_SCALING));
      {
        double max_err = 0.0;
        for (i = 0; i < 2 * n; ++i) {
          double d = fabs(dback[i] - dfreq[i]);
          if (d > max_err) max_err = d;
        }
        REQUIRE(max_err < 1e-6);
      }
      CHECK(spfft_dist_transform_destroy(it));
    }

    CHECK(spfft_dist_transform_destroy(dt));
    CHECK(spfft_grid_destroy(dgrid));
    free(didx);
    free(dfreq);
    free(dback);
    free(dspace);
  }

  CHECK(spfft_transform_destroy(tc));
  CHECK(spfft_transform_destroy(t));
  CHECK(spfft_grid_destroy(grid));
  free(freq);
  free(back);
  free(indices);
  printf("ALL NATIVE TESTS PASSED\n");
  return 0;
}
