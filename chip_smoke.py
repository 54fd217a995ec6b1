#!/usr/bin/env python3
"""Drives spfft_tpu_torch on one CUDA card and holds every kernel to its plain version.

Run from the root of a checkout, on a machine with an H100 and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each:

1. the card (``nvidia-smi`` name and power limit), the kernel build (K1 at
   its three float32 precisions, in its bfloat16-constant form
   ``complex_matmul_tf32x2`` and in float64, K2 and the line FFT, one
   ``nvcc`` each, in parallel), and what ptxas reports for each kernel (registers, spills) and
   how many tensor-core instructions (``HGMMA``, ``HMMA``, the float64
   library's ``DMMA``) ``cuobjdump -sass`` finds;
2. the plans, all at 256^3 (``PLANS``): in float32, C2C and R2C at the
   spherical cutoff 0.659 with the dense y stage (``SPFFT_TPU_SPARSE_Y_BLOCKS=0``)
   and with the JAX package's choice (blocked sparse-y) at ``precision``
   "highest", "high" and "default", and C2C at 0.5 (per-slot sparse-y, and
   dense beside it); in float64, C2C and R2C at 0.659, blocked; each plan's
   y variant, bucket shapes and Sy are asserted (``EXPECT``);
3. each kernel (K1 ``complex_matmul``, K2 ``row_gather``) at the shapes the
   main path gives it, against its plain PyTorch version on the same inputs
   (K1 "highest": the exact float32 products; "high"/"default": the bf16x3 /
   bf16x1 arithmetic), with its device time (``ms``: one call captured in a
   CUDA graph, replayed ``REPLAYS`` times between two events), the plain
   version's and one PyTorch library call's device time (K1: cuBLAS
   complex64 in FP32; for the bf16 rows also with TF32 allowed), for K1
   "highest"/"high" how far the other precision's arithmetic lies from the
   plain version (it must fail the bar that the kernel passes), the
   single-call time with the host's share in it (``call_ms``), and the least
   time the card could take (``bound_ms``: K1's on the TF32 tensor cores, or
   the BF16 ones for "high"/"default", or the FP64 ones for float64, where
   the full complex forms take Gauss's three products; ``fp32_bound_ms``
   without tensor cores, four products), and for K2 the vector width it
   took. Every row's ``ms``, ``plain_ms`` and ``library_ms`` are on
   ``graph_ms``'s clock (20 calls in one graph over copies of the data
   operands and outputs that together hold twice the L2 cache: no host
   replay in the time, the operands read from device memory; K1's plan
   constant is shared), ``replay_ms`` on the older clock (one call in a
   graph, replayed by the host: ``device_ms``); K1 at
   odd shapes and strides at each float32 precision, and once more in
   float64 (there also K = 0 and a real constant); K2 at odd shapes
   (``run_k2_odd``: widths 1 to 512, float32 and float64, misaligned and
   packed planes, sentinel indices and past them, one row and more vectors
   than the card's resident threads), bitwise, and its first call inside a
   CUDA-graph capture in a fresh process; the line FFT (``line_fft_phase``)
   at every form of the float32 "highest" plans (z rows both ways, the x
   stage to and from the space, C2R and R2C), bitwise against its plain
   version, with ``k1_ms`` (K1 at the same form, with the constant the
   engine would make for it), ``library_ms`` (``torch.fft``, cuFFT, at the
   stage's dense shape) and ``bound_ms`` (the form's bytes, read once and
   written once, over the HBM rate), and at the forms of ``LINE_FFT_PLANS``
   (the benchmark's 512^3 R2C plan, and 128^3 and 64^3, where it meets K1);
4. the main path at full width: ``Transform(ProcessingUnit.GPU, ...)`` for
   every plan, backward then forward(FULL), against a complex128 dense oracle
   on the host (one per transform and radius), at the bar of the plan's
   precision (float64: 1e-12). Each plan runs fused (its
   default: one CUDA graph per direction, captured at the first call) and
   has a ``fuse=False`` twin that runs node by node. The kernels' launch
   counts come from the twin's pair, where each launch counts once; the
   fused plan's first pair (warm-up and capture) must count exactly twice
   as many, its second pair (replays) none, and both must be bitwise equal
   to the twin's results. Two more plans, ``c2c-xla`` and ``r2c-xla``, run
   the ``torch.fft`` engine (cuFFT; no K1 or K2 launch);
5. a result handed out stays put across a later call (fused C2C and R2C);
   ``backward_batch``/``forward_batch`` with B = 4 against the per-request
   calls (one batched dispatch per direction, ms per transform against the
   loop); ``multi_transform_backward``/``_forward`` of the C2C and R2C
   headline plans against their single calls;
6. the distributed phase (``DIST_PLANS``): ``DistributedTransform`` over
   ``make_fft_mesh(4)``, four shards stacked on the card, at 256^3: C2C and
   R2C with ``engine="auto"`` (which must be ``mxu``) and the DEFAULT
   exchange, a skewed C2C plan (weights 2:1:1:1, z-slabs 70/62/62/62,
   UNBUFFERED), C2C in float64 over a float32 wire (BUFFERED_FLOAT), C2C on
   the ``torch.fft`` engine, and C2C over a one-rank NCCL process group (the
   collective route, fused: NCCL's kernels captured in each direction's
   graph). Each is held against the dense oracle, the local blocked plan of
   the same triplets, its round trip, its staged twin (bitwise; the fused
   first pair launches twice the twin's kernels, the replayed pair none,
   one dispatch a direction, bitwise the first), and the NCCL plan against
   the one without a group (bitwise), with one batched B = 4 program over
   the group bitwise four looped pairs (``dist_batch``); its K1 and K2 forms
   against their plain versions, as in phase 3;
6b. the pencil phase (``PENCIL_PLANS``): ``DistributedTransform`` over
   ``make_fft_mesh2(2, 2)``, four shards stacked on the card, at 256^3 and
   radius 0.659, the triplets split column by column: C2C and R2C with
   ``engine="auto"`` (which must be ``pencil2-mxu``) and DEFAULT,
   UNBUFFERED, C2C in float64 over a float32 wire (BUFFERED_FLOAT), the
   ``torch.fft`` engine, and C2C over the one-rank NCCL group (fused).
   Each is held against the dense oracle, its round trip, its staged twin
   (bitwise), its slab plan of phase 6 and the local blocked plan (1e-5),
   the NCCL plan against the plan without a group (bitwise); its K1 forms
   (z, the dense y over the stacked y-pencil grid, the x stage over the
   slot columns) and the K2 gathers of exchanges A and B against their
   plain versions, as in phase 3;
6c. the OVERLAPPED exchange (``overlap_phase``, ``OVERLAP_PLANS``): four
   shards stacked on the card at 256^3, radius 0.659: slab C2C ``mxu``
   BUFFERED at overlap 4, R2C at 2, C2C on the ``torch.fft`` engine at 4,
   the 2 x 2 pencil C2C in float64 over a float32 wire at 4, all fused, and
   slab C2C at 4 over the one-rank NCCL group (fused: each chunk's
   asynchronous collective captured on the side stream). Each is held
   against its ``overlap=1`` twin
   built beside it (bitwise expected on the ``mxu`` engines, else the
   dtype's bar), the dense oracle and its round trip, its staged twin
   (bitwise), the NCCL plan bitwise against the stacked one; no rung; its
   new K1 forms (the batched z windows, the pencil's windowed y and x) and
   K2 gathers (each chunk's, the one unpack) against their plain versions;
   under torch.profiler the streams its K1 and exchange kernels ran on (the
   staged twin's: the exchange off K1's stream) and the device ms during
   which an exchange kernel and a K1 kernel ran at once; pair and busy ms
   against the twin and the staged twin, the three taking turns (the NCCL
   plan's fused pair must show ``ncclDevKernel``);
7. one pair of every plan and twin under ``torch.profiler``: the device's
   busy share and the kernels that take its time; then the pair times, all
   plans taking turns, for comparisons within the run; each pencil plan's
   staged twin under the ``obs.STAGES`` ranges, exchange A's and B's device
   ms apart (``compare_pencil``);
8. the ``obs`` phase: the cost of the timing tree, the metrics registry and
   the flight recorder, each alone, all on and all off, on the fused
   ``c2c-blocked`` pair and its staged twin in turns; the one-line figure
   (``spfft_tpu_torch.programs.bench``, the plan of ``c2c-blocked``); the
   benchmark program
   (``spfft_tpu_torch.programs.benchmark``) through its ``main()`` with
   ``-p gpu`` at ``BASELINE.json``'s five configurations (``BENCH_CONFIGS``;
   the 512^3 one in single and double precision), the shards stacked on the
   card, each with the launch counts set to 0 just before it; each report
   held to the port's validators (plan card, timing-tree labels, perf
   report) and its round-trip residual to the dtype's bar; the 512^3 ones
   also as a 4 x 4 pencil mesh (``--mesh2 4 4``); per configuration
   ms per pair, GFLOP/s, residual, the busy ms of one profiled pair and the
   peak memory; each configuration's K1 and K2 forms against their plain
   versions, as in phase 3; the per-stage device times of each mesh
   configuration's staged twin under the ``obs.STAGES`` names (the
   exchange's measured share among them; the profiler's first step is an
   untraced warm-up; where three profiles in the process lack a stage
   range, the twin is profiled again in a fresh process,
   ``--stage-profile``); the perf model's balance fitted to those per-stage
   device ms at ``FIT_CONFIGS`` (``balance_fit``: the fit, and each mesh
   configuration's exchange share measured beside the model's at the JAX
   default, at the fit and at ``obs.perf.CUDA_FLOP_PER_BYTE``); the 512^3
   host staging rates; and a fence with a tiny ``SPFFT_TPU_FENCE_BUDGET_S``
   that must raise ``FenceTimeout`` on a long launch;
9. faults and verify (``faults_phase``): on ``c2c-blocked``, ``r2c-blocked``,
   ``dist4-c2c``, ``pencil2x2-c2c`` and the plan of
   ``bench-512-r2c-16-single``, each with guard and verify off, guard on,
   verify on and both: the results of both bitwise those of off, the staged
   twins' K1/K2 launch counts equal, every verdict (printed with ``rel``) a
   pass, no rung taken; the pair ms of the four taking turns (the least and
   the median), the device busy ms of a pair off and on, and the checks' and
   guard's scans' own device ms with the checks' kernels under the profiler.
   Then each armed fault in its own scope: ``engine.execute=corrupt`` under
   verify recovers through the ``torch.fft`` reference (cuFFT kernels in its
   profile) within the oracle's bar, ``engine.execute=nan`` under guard and
   ``sync.fence=raise`` raise ``GPUFFTError``, strict raises
   ``VerificationError``, the breaker at K = 2 opens, ``engine.compile=raise``
   falls back to ``torch.fft``, ``ir.compile=raise`` and a real CUDA-graph
   capture failure at the first dispatch run the staged path bitwise the
   fused plan's with K1 and K2 launched, ``exchange.build=raise`` on
   ``dist4-c2c`` raises ``MPIError``. The main path, the mesh phases and the
   obs phase must each have taken no rung (``no_rungs``: empty
   ``degradations``, the rung counters 0);
10. tuning and scheduling (``tuning_phase``): with a fresh
   ``SPFFT_TPU_WISDOM`` file, ``c2c-blocked`` and ``r2c-blocked`` (256^3,
   "highest") with ``policy="tuned"``: each trial table (the ``mxu``,
   ``mxu/dense-y``, ``mxu/staged``, ``mxu/bf16-twiddle`` (K1's
   "highest-bf16" form: bfloat16 DFT matrices, half the constant's bytes),
   ``xla`` and ``xla/staged`` candidates, each built and timed on the card),
   the chosen plan against the dense oracle (a bfloat16-matrix plan at the
   "default" bar), and a second construction a wisdom hit with no trial; the same
   for the exchange of ``dist4-c2c`` and ``pencil2x2-c2c`` at ``overlap=1``
   (BUFFERED, COMPACT_BUFFERED and UNBUFFERED timed in one call) and of
   ``dist4-c2c-ovtuned`` with no ``overlap`` (those and the tuner's
   ``BUFFERED/ov2`` and ``BUFFERED/ov4``: the row names the winner); the gbench graph
   (``spfft_tpu_torch.programs.gbench``, ``GBENCH_ARGS``: two geometries,
   independent backwards and backward -> forward chains) run serially and
   scheduled, each task's result bitwise its solo plan's, both rates
   printed; an empty plan on cuFFT (the zero grid and no values); and
   ``ir.lower=raise`` on the plans of ``dist4-c2c`` and ``pencil2x2-c2c``:
   the legacy path, ``ir_lower_failed`` on the card, K1 and K2 launched,
   within 1e-6 of (in fact bitwise) the staged twin. Each plan's K1 and K2
   forms get kernel rows, their launches counted from 0 before its tuning
   (the trials included) and read after its pair; no tuned plan takes a rung;
11. the C ABI (``capi_phase``): ``libspfft_tpu_torch.so`` built from the
   checkout with ``g++`` and loaded into this process with ctypes; through
   the C functions with ``SPFFT_PU_GPU``, ``c2c-blocked`` in float and
   double and ``r2c-blocked`` in float (256^3, ``CAPI_PLANS``) and
   BASELINE.json's 512^3 R2C float32 plan over 16 shards
   (``spfft_grid_create_distributed``, ``spfft_dist_transform_*``), each
   backward and forward bitwise the Python plan's with the same arguments,
   K1 and K2 launched behind the C calls, the ms per pair of the C ABI and
   of the Python pair taking turns, and the rates of the host copies the C
   layer makes; then the twin C and C++ API tests, the C, C++ and
   distributed examples (the Fortran one where ``gfortran`` exists) and the
   benchmark program with ``-p gpu`` at 256^3 and ``--shards 4``, each a
   process that must exit 0; and ``dist4-c2c-nccl1`` with ``verify=True``:
   the verdict rows of ``dist4-c2c`` with ``verify=True``, one NCCL
   all-reduce in the profile of each verified call;
12. serving on the card (``serving_phase``), at 128^3 C2C, radius 0.659,
   float32, "highest", ``engine="auto"`` (which must be ``mxu``), 3 tenants:
   the capacity C of one warm batch-fused backward of 8 requests (host
   staging included), the ms per transform of the batched program at B = 1,
   2, 4, 8 against single calls, what admission costs a request, and the
   RPC wire's cost per result (the pageable copy to the host, the frame's
   JSON + base64 encode and decode for 1 and 8 results); in a process of its
   own (``--serve-profile``), one B = 8 batched backward under the profiler
   must run 8 times the staged twin's K1 and K2 kernels, and a steady 1 C
   step of a service gives the card's busy share. Then the cells, through ``spfft_tpu_torch.programs.loadgen``'s
   ``main()`` with the launch counts set to 0 before the first:
   ``serve-128-c2c`` open-loop at 0.5, 1 and 2 C, 1.5 s a step, batch-fused
   (each step: the accounting identity, the queue within its cap, 8 sampled
   results bitwise a single call of a separately built plan, one within
   1e-5 of the complex128 dense oracle, no rung; in the 1 C step a geometry
   the cache has not seen arrives while two threads read results to the
   host, the capture hazard of the fused plans), the 1 C step again with
   batch fusion off, ``serve-mixed-sched`` (128^3 and 192^3 at 0.5
   interleaved, scheduler off and on); ``serve.dispatch=raise`` at a fraction, at 2 C,
   every ticket resolving typed; ``fleet-2w-kill``: two ``serve_worker``
   processes on the card behind a ``ClusterFront``, worker 1 SIGKILLed in
   the first step (``hosts_lost_total`` 1, completions after the kill, one
   run's spans from the front and a worker in the front's trace, the fleet
   document valid, ``fleetstat`` of the survivor and its ``--prom`` text);
   and the serving plan's backward K1 and K2 forms against their plain
   versions, as in phase 3, with their launches under serving;
13. the programs (``programs_phase``), every one through its ``main`` on
   the card at 256^3, radius 0.659, float32 "highest", ``engine="mxu"``,
   each with the launch counts set to 0 just before it (a run that
   launches neither K1 nor K2 fails): ``report``, ``trace`` and ``verify``,
   local and over 4 shards (the documents valid, no rung; ``verify`` exits
   0, then 3 under ``--mode strict --inject engine.execute=nan`` and 0,
   recovered, under ``engine.execute=corrupt:1.0``); ``fbench`` (fused and
   staged rows, their ratio, B = 1 and 4) and ``perf_gate`` over its rows
   (against themselves 0, against a doubled copy 3); ``dbench`` strong
   scaling at 256^3 in the 15 % sphere, slab over 1, 2, 4, 16 shards and
   pencil 2 x 2 and 4 x 4, each mesh row's ``exchange_fraction`` beside the
   measured exchange share of its staged twin (profiled in the fresh process
   below); ``discipline_compare`` at 4
   and 16 shards with and without ``--imbalance 0.5``, its wire bytes
   against the plan cards' and one round each; the examples ``example``,
   ``example_distributed`` and ``poisson`` with ``ProcessingUnit.GPU``;
   ``profile`` in a fresh process (``--programs-profile``), blocked and
   dense y, K1 under the z, y and x ranges and K2 under the blocked y range
   or under ``expand`` and ``pack``; the programs' plan's K1 and K2 forms
   against their plain versions, with their launches under the programs;
   the phase within ``PROGRAMS_BUDGET_S``;
14. the static-analysis gate and runtime lockdep (``lockdep_phase``): the
   port's gate (``python spfft_tpu_torch/programs/analyze.py --json -``) on
   this checkout, which must exit 0 with 19 checkers, no new finding and no
   stale baseline entry (its wall time printed); four fresh processes in
   turns, lockdep-armed (``SPFFT_TPU_LOCKDEP=1`` and a report path) and not,
   each serving phase 12's ``serve-128-c2c`` geometry in process through a
   ``TransformService``, plain and with ``sched=True``: K1 and K2 launched
   in every mode, the results of 16 fixed payloads bitwise equal across all
   four processes, each armed report's locks, edges and blocking waits
   printed and ``--lockdep-check`` exiting 0 on it, and the transforms a
   second of a 2 s closed loop per mode, armed against unarmed; then two
   ``serve_worker`` hosts spawned with ``spawn_workers(lockdep_dir=)``
   behind a ``ClusterFront``, whose per-host reports, written at their clean
   shutdown, cross-check alone and merged;
15. compiled-program statistics and the installed C library
   (``compiled_phase``, between the compare lines and the obs phase, and
   ``packaging_phase``, after phase 14): ``report(include_compiled=True)``
   on ``COMPILED_PLANS`` (local blocked C2C and R2C, the stacked slab and
   pencil plans, the plan over the one-rank NCCL group), each card valid,
   its ``hlo_op_classes`` K1/K2 counts and its CUDA graph's K1/K2 kernel
   nodes both equal to the K1/K2 launches of the staged twin's backward
   call, as element-granular ops only decompress's ``index_copy_`` into the
   flat stick table (one a plane; ``ops/compression.py``), whose device ms,
   with compress's, is printed beside its bytes bound and the fused pair's
   ms, NCCL's kernel nodes in the group plan's graph, ``compile_seconds``
   and ``memory_analysis`` printed, the card
   under ``hlo.stats=raise`` without the section and with the
   ``hlo_stats_unavailable`` degradation, and the plan's pair bitwise the
   same after the reports as before; then, where ``cmake`` exists, the
   port's CMake tree installed into a scratch prefix, the consumer project
   built against it and run, the benchmark program built against the
   installed ``spfft_tpu_torch.pc`` and run at 256^3 dense C2C in turns with
   phase 11's in-checkout build (phase 11's run, installed, in-checkout:
   results bitwise by the benchmark's checksum, each ``ms_per_pair`` and
   the installed one over the in-checkout mean printed); a line says so
   where ``cmake`` is missing;
16. the ``kernels`` line; last, the ``{"ok": true, "device": ...}`` line.

Exits non-zero, with no result line, when there is no CUDA device or any
check fails.

``python3 chip_smoke.py --against DIR [DIR ...]`` compares trees instead:
the host-facing pair times of four 256^3 local plans and two 4-shard plans,
each fused and staged, in one worker process per tree and turn (DIR...,
this tree twice, ...DIR, and that sequence again), e.g. against the parent commit unpacked into an
ignored directory with ``git archive``. It checks no kernel.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

DIMS = (256, 256, 256)
SEED = 1234
# kernel vs its plain version, max abs diff over max |plain|, float32: below
# the gap between the "highest" and "high" arithmetics (2.2e-6 to 4.7e-6 at
# the main path's forms on an H100), so that a body of the wrong precision
# fails it; the kernels' own differences reach about 1e-6
K1_RTOL = 1.5e-6
K1_F64_RTOL = 1e-12
# backward against the dense oracle, and the round trip, per precision
ORACLE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 2e-2}
# the same in float64: a sound float64 plan reads about 1e-13 at 256^3 on an
# H100, the float64 mesh plan over a float32 wire 2.6e-8, so any float32
# step fails it
ORACLE_F64_RTOL = 1e-12
REPLAYS = 20
GRAPH_CALLS = 20  # calls captured in one graph by graph_ms
# H100 SXM published peaks (NVIDIA data sheet, 700 W): FP32 and FP64 outside
# the tensor cores, dense TF32, BF16 and FP64 on them, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_F64_TC = 67e12  # FP64 on the tensor cores (the data sheet's FP64 Tensor Core rate)
# TF32, BF16, BF16, and TF32 for "highest" with a bfloat16 constant (SPFFT_TPU_TWIDDLE_BF16)
PEAK_TC = {"highest": 495e12, "high": 989e12, "default": 989e12, "highest-bf16": 495e12}
# tensor-core products per real product
TC_PASSES = {"highest": 3, "high": 3, "default": 1, "highest-bf16": 2}
OTHER = {"highest": "high", "high": "highest"}  # the precision a K1 row must not pass as
PEAK_BYTES = 3.35e12
LIBRARIES = ["complex_matmul", "complex_matmul_bf16x3", "complex_matmul_bf16x1",
             "complex_matmul_f64", "row_gather", "complex_matmul_tf32x2", "line_fft"]
BLOCKS_OFF = {"SPFFT_TPU_SPARSE_Y_BLOCKS": "0"}
F32, F64 = np.float32, np.float64
# (name, transform, radius, precision, knobs while the plan is made, y plan, dtype)
PLANS = [
    ("c2c", "c2c", 0.659, "highest", BLOCKS_OFF, "dense", F32),
    ("r2c", "r2c", 0.659, "highest", BLOCKS_OFF, "dense", F32),
    ("c2c-blocked", "c2c", 0.659, "highest", {}, "blocked", F32),
    ("r2c-blocked", "r2c", 0.659, "highest", {}, "blocked", F32),
    ("c2c-r0.5", "c2c", 0.5, "highest", {}, "per-slot", F32),
    ("c2c-r0.5-dense", "c2c", 0.5, "highest", {"SPFFT_TPU_SPARSE_Y": "0", **BLOCKS_OFF}, "dense",
     F32),
    ("c2c-blocked-high", "c2c", 0.659, "high", {}, "blocked", F32),
    ("r2c-blocked-high", "r2c", 0.659, "high", {}, "blocked", F32),
    ("c2c-blocked-default", "c2c", 0.659, "default", {}, "blocked", F32),
    ("r2c-blocked-default", "r2c", 0.659, "default", {}, "blocked", F32),
    ("c2c-blocked-f64", "c2c", 0.659, "highest", {}, "blocked", F64),
    ("r2c-blocked-f64", "r2c", 0.659, "highest", {}, "blocked", F64),
]
# The torch.fft engine's plans: (name, transform, radius)
XLA_PLANS = [("c2c-xla", "c2c", 0.659), ("r2c-xla", "r2c", 0.659)]
STAGED = "~staged"  # the name suffix of a plan's fuse=False twin
BATCH = 4
# What the JAX package's planner chooses at 256^3 (its buckets (Ag, Syg), or Sy)
EXPECT = {
    ("c2c", 0.659): [(42, 176), (42, 168), (42, 152), (43, 120)],
    ("r2c", 0.659): [(21, 176), (21, 168), (21, 152), (21, 112), (1, 256)],
    ("c2c", 0.5): 136,
}
SLOTS_OUT, SLOTS_IN = "ajz,ajk->kaz", "yaz,ajy->ajz"
# The distributed phase, 4 shards, radius 0.659: (name, transform, engine,
# exchange, dtype, shard weights, local_z_lengths, over a process group, the
# local plan it is held against)
DIST_PLANS = [
    ("dist4-c2c", "c2c", "auto", "DEFAULT", np.float32, None, None, False, "c2c-blocked"),
    ("dist4-r2c", "r2c", "auto", "DEFAULT", np.float32, None, None, False, "r2c-blocked"),
    ("dist4-c2c-skewed", "c2c", "mxu", "UNBUFFERED", np.float32, (2, 1, 1, 1),
     (70, 62, 62, 62), False, "c2c-blocked"),
    ("dist4-c2c-f64-float", "c2c", "mxu", "BUFFERED_FLOAT", np.float64, None, None, False,
     "c2c-blocked"),
    ("dist4-c2c-xla", "c2c", "xla", "DEFAULT", np.float32, None, None, False, "c2c-blocked"),
    ("dist4-c2c-nccl1", "c2c", "auto", "DEFAULT", np.float32, None, None, True, "c2c-blocked"),
]
# The pencil phase, a 2 x 2 mesh (make_fft_mesh2) stacked on the card, radius
# 0.659: (name, transform, engine, exchange, dtype, over a process group, the
# slab plan and the local plan it is held against)
PENCIL_PLANS = [
    ("pencil2x2-c2c", "c2c", "auto", "DEFAULT", np.float32, False, "dist4-c2c", "c2c-blocked"),
    ("pencil2x2-r2c", "r2c", "auto", "DEFAULT", np.float32, False, "dist4-r2c", "r2c-blocked"),
    ("pencil2x2-c2c-unbuffered", "c2c", "mxu", "UNBUFFERED", np.float32, False, "dist4-c2c",
     "c2c-blocked"),
    ("pencil2x2-c2c-f64-float", "c2c", "mxu", "BUFFERED_FLOAT", np.float64, False,
     "dist4-c2c-f64-float", "c2c-blocked"),
    ("pencil2x2-c2c-xla", "c2c", "xla", "DEFAULT", np.float32, False, "dist4-c2c-xla",
     "c2c-blocked"),
    ("pencil2x2-c2c-nccl1", "c2c", "auto", "DEFAULT", np.float32, True, "dist4-c2c",
     "c2c-blocked"),
]
# The obs phase: the benchmark program at BASELINE.json's configurations, the
# shards stacked on the card: (name, arguments besides -p gpu -o). Depth
# (-r, the timed dependent pairs) is cut to stay inside the time limit.
BENCH_CONFIGS = [
    ("bench-32-c2c-dense", ["-d", "32", "32", "32", "-r", "16", "-t", "c2c", "-s", "1.0"]),
    ("bench-128-c2c-sphere", ["-d", "128", "128", "128", "-r", "16", "-t", "c2c",
                              "--model", "spherical", "-s", "0.15"]),
    ("bench-128-r2c-sphere", ["-d", "128", "128", "128", "-r", "16", "-t", "r2c",
                              "--model", "spherical", "-s", "0.15"]),
    ("bench-256-c2c-4", ["-d", "256", "256", "256", "-r", "8", "-t", "c2c", "--shards", "4"]),
    ("bench-512-r2c-16-single", ["-d", "512", "512", "512", "-r", "4", "-t", "r2c",
                                 "--model", "spherical", "-s", "0.15", "--shards", "16",
                                 "--precision", "single"]),
    ("bench-512-r2c-16-double", ["-d", "512", "512", "512", "-r", "4", "-t", "r2c",
                                 "--model", "spherical", "-s", "0.15", "--shards", "16",
                                 "--precision", "double"]),
    # the same 16 shards as a 4 x 4 pencil mesh
    ("bench-512-r2c-mesh2-4x4-single", ["-d", "512", "512", "512", "-r", "4", "-t", "r2c",
                                        "--model", "spherical", "-s", "0.15", "--mesh2", "4",
                                        "4", "--precision", "single"]),
    ("bench-512-r2c-mesh2-4x4-double", ["-d", "512", "512", "512", "-r", "4", "-t", "r2c",
                                        "--model", "spherical", "-s", "0.15", "--mesh2", "4",
                                        "4", "--precision", "double"]),
]
# the benchmark's round-trip residual (one backward + forward(FULL) of the
# inputs against them, not the timed chain's last values, which carry every
# pair's rounding): the main path's float32 bar at "highest", and the float64 bar
BENCH_RTOL = {"single": 1e-5, "double": 1e-12}
# where the benchmark program writes each configuration's report (ignored by git)
REPORTS = os.path.join("build", "smoke")
# the timing tree's labels in every report (local plans add "Execution init")
BENCH_LABELS = {"Grid + Transform init", "warmup", "multi backward", "multi forward",
                "dispatch all", "finalize all", "input staging", "dispatch", "warmup chain",
                "benchmark loop"}
# float64 over a float32 wire, the oracle and the round trip: between what a
# sound plan reads (about 3e-8) and what the same plan computed in float32
# would (about 1.2e-6, the float32 distributed plans' reading), with room both ways
DIST_F64_RTOL = 2e-7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def call_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings after ``warmup`` calls:
    the card's time plus whatever the host keeps it waiting."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def no_collection():
    """Python's garbage collector held off for a capture (a dropped plan's
    graph, destroyed by a collection mid-capture, invalidates the capture):
    the port's own guard, ``spfft_tpu_torch.ir.compile.no_collection``."""
    from spfft_tpu_torch.ir.compile import no_collection as held_off

    return held_off()


def device_ms(fn, replays: int = REPLAYS) -> float:
    """Device time of one call: warmed up (build, argtypes, allocator), then
    captured in a CUDA graph and replayed ``replays`` times between two events."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / replays


def l2_copies(footprint: int) -> int:
    """How many copies of operands of ``footprint`` bytes hold twice the
    card's L2 cache together: at least 1, at most ``GRAPH_CALLS``."""
    import torch

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(1, min(GRAPH_CALLS, -(-2 * l2 // footprint)))


def graph_ms(fns) -> float:
    """Device time of one call, with no host replay in it: ``GRAPH_CALLS``
    calls, call i of ``fns[i % len(fns)]`` (one function per copy of the
    operands, so that a small form is read from device memory and not from
    L2), captured in one CUDA graph, the graph replayed three times between
    two events. Warmed up as :func:`device_ms`."""
    import torch

    for fn in fns:
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
        for i in range(GRAPH_CALLS):
            fns[i % len(fns)]()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * GRAPH_CALLS)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


@contextlib.contextmanager
def knobs(env):
    """The process environment with ``env`` set, restored afterwards."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def build_report(names) -> dict:
    """ptxas's registers and spills per kernel, from the build logs, and the
    tensor-core instructions in each library's SASS."""
    from spfft_tpu_torch import _build

    demangle = shutil.which("c++filt")
    report = {}
    for name in names:
        log = _build.build_log(name)
        kernels = []
        for entry, body in re.findall(
            r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)", log, re.S
        ):
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            kernels.append({"kernel": entry, "registers": int(regs.group(1)) if regs else None,
                            "spill_store_bytes": int(spill.group(1)) if spill else None})
        if demangle and kernels:
            out = subprocess.run([demangle], input="\n".join(k["kernel"] for k in kernels),
                                 capture_output=True, text=True).stdout.splitlines()
            for k, d in zip(kernels, out):
                k["kernel"] = d
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([cuobjdump, "-sass", str(_build._target(name))],
                              capture_output=True, text=True).stdout
        report[name] = {
            "kernels": kernels,
            "warnings": [ln.strip() for ln in log.splitlines()
                         if "warning" in ln.lower() or "Performance Loss" in ln],
            "sass_hgmma": len(re.findall(r"\bHGMMA\b", sass)),
            "sass_hgmma_bf16": len(re.findall(r"\bHGMMA\.\S*BF16", sass)),
            "sass_hgmma_first": next((ln.strip() for ln in sass.splitlines() if "HGMMA" in ln), None),
            "sass_hmma": len(re.findall(r"\bHMMA\b", sass)),
            "sass_dmma": len(re.findall(r"\bDMMA\b", sass)),
            "sass_dmma_first": next((ln.strip() for ln in sass.splitlines() if "DMMA" in ln), None),
        }
    return report


def k1_forms(name, t):
    """Every K1 form plan ``name`` launches that gets a row: (row name, spec,
    data pair, constant, want_imag, out pair or None). Dense plans: all four
    of their forms; the blocked and per-slot plans at float32 "highest": their
    y forms; at "high"/"default", in the bfloat16-constant form and in
    float64: all (the non-y three and the y forms)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ex, p = t._exec, t.params
    S, A, Y, X, Z = p.num_sticks, ex.num_x_active, p.dim_y, p.dim_x, p.dim_z
    f64 = ex.torch_dtype == torch.float64
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=ex.torch_dtype)
    pair = lambda *shape: (rnd(*shape), rnd(*shape))
    r2c = ex.is_r2c
    forms = []
    if ex.y_plan == "dense" or ex.k1_precision != "highest" or f64:
        if ex._z_lines is None:  # else the line FFT runs the z stage
            forms.append((f"{name}/z", "sz,zk->sk", pair(S, Z), ex._wz_b, True, None))
        if ex.y_plan == "dense":
            forms.append((f"{name}/y", "yxz,yk->kxz", pair(Y, A, Z), ex._wy_b, True, None))
        if ex._x_lines is None and r2c:  # else the line FFT runs the x stage
            forms.append((f"{name}/x_backward_real_out", "kxz,xl->klz", pair(Y, A, Z), ex._wx_b,
                          False, None))
            forms.append((f"{name}/x_forward_real_in", "yxz,xk->ykz", (rnd(Y, X, Z), None),
                          ex._wx_f, True, None))
        elif ex._x_lines is None:
            forms.append((f"{name}/x_backward", "kxz,xl->klz", pair(Y, A, Z), ex._wx_b, True, None))
            forms.append((f"{name}/x_forward", "yxz,xk->ykz", pair(Y, X, Z), ex._wx_f, True, None))
    if ex.y_plan == "per-slot":
        forms.append((f"{name}/slot_backward", SLOTS_OUT, pair(A, ex.sy, Z), ex._wy_b, True, None))
        forms.append((f"{name}/slot_forward", SLOTS_IN, pair(Y, A, Z), ex._wy_f, True, None))
    elif ex.y_plan == "blocked":
        grid, col = pair(Y, A, Z), 0
        for b, (ag, syg, wb, wf) in enumerate(ex.buckets):
            cols = tuple(g[:, col:col + ag] for g in grid)  # the grid columns it writes or reads
            forms.append((f"{name}/bucket{b}_backward", SLOTS_OUT, pair(ag, syg, Z), wb, True, cols))
            forms.append((f"{name}/bucket{b}_forward", SLOTS_IN, cols, wf, True, None))
            col += ag
    return forms


def k1_operands(spec, x, w):
    """K1's operands of stage ``spec`` on data ``x`` with plan constant ``w``."""
    from spfft_tpu_torch.ops import fft as offt

    return offt.operands(spec, x[0], x[1], *offt.constant_operands(spec, w))[0]


def k1_key(ops, want_imag, precision):
    ar, ai, br, bi = ops
    return (ar.shape[0], ar.shape[1], ar.shape[2], br.shape[2], ai is not None,
            bi is not None, want_imag, precision)


def k1_bounds_ms(ops, want_imag, precision, w) -> tuple[float, str, float]:
    """(tensor-core bound, what bounds it, FP32 or FP64 bound without tensor
    cores): max(operations over the peak, bytes over the memory rate); the
    operations are the precision's tensor-core products per real product on
    the TF32 ("highest", "highest-bf16") or BF16 peak, the real products the float64 kernel
    issues on the FP64 tensor-core peak (three per complex product where all
    four parts exist: Gauss's form), or the four-product form's on the FP32
    or FP64 peak. The bytes count the data and the result in their dtype and
    the plan constant ``w`` as the precision needs it: one bf16 plane per
    part at "default" and "highest-bf16" (its tiles are made once per plan),
    the dtype's size else."""
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1

    ar, ai, br, bi = ops
    batch, m, k = ar.shape
    n = br.shape[2]
    full = ai is not None and bi is not None and want_imag
    products = 4 if full else 2
    flops = 2 * products * batch * m * n * k
    item = ar.element_size()
    v_item = 2 if precision in ("default", "highest-bf16") else item
    a_item, b_item = (item, v_item) if k1._views(br, w.re) else (v_item, item)
    a_mats = batch if ar.stride(0) else 1
    b_mats = batch if br.stride(0) else 1
    nbytes = (
        a_item * (1 + (ai is not None)) * a_mats * m * k
        + b_item * (1 + (bi is not None)) * b_mats * k * n
        + item * (1 + want_imag) * batch * m * n
    )
    t_bytes = nbytes / PEAK_BYTES
    t_fp32 = flops / PEAK_FLOPS[str(ar.dtype).split(".")[1]]
    # float64: the card's FP64 peak on its tensor cores, where K1's float64
    # body runs, at the products it issues
    t_tc = ((3 if full else products) * flops / products / PEAK_F64_TC
            if ar.dtype == torch.float64 else TC_PASSES[precision] * flops / PEAK_TC[precision])
    bound_by = "operations" if t_tc >= t_bytes else "bytes"
    return 1e3 * max(t_tc, t_bytes), bound_by, 1e3 * max(t_fp32, t_bytes)


def k1_plain(precision):
    """K1's plain version at ``precision``: the exact float32 products for
    "highest" and "highest-bf16" (FP32 accuracy is their contract; the
    latter's constant holds bfloat16 values), the bf16 arithmetic else."""
    from spfft_tpu_torch.ops import complex_matmul as k1

    return (k1.complex_matmul_plain if precision in ("highest", k1.BF16_CONSTANT)
            else k1.ARITHMETIC[precision])


def k1_err(ops, want_imag, constant=None, precision="highest", out=None):
    """K1 against its plain version: (max abs diff, max |plain|), each per
    part of the result (real, then imaginary when it is kept)."""
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1

    got = k1.complex_matmul(*ops, want_imag, constant=constant, precision=precision, out=out)
    want = k1_plain(precision)(*ops, want_imag)
    torch.cuda.synchronize()
    parts = [(g, w) for g, w in zip(got, want) if w is not None]
    return ([(g - w).abs().max().item() for g, w in parts],
            [w.abs().max().item() for _, w in parts])


def k1_feed_bytes(ops, w) -> int:
    """Bytes the tensor-core kernel copies into shared memory for this call:
    per output tile (128 rows of D by a Q tile of V) and K tile, the D tile's
    float32 parts and the V tile's planes (csrc/k1_tc.cuh)."""
    from spfft_tpu_torch.ops import complex_matmul as k1

    ar, ai, br, bi = ops
    batch, m, k = ar.shape
    n = br.shape[2]
    transposed = not k1._views(br, w.re)
    p, q = (n, m) if transposed else (m, n)
    d_parts = 1 + ((bi if transposed else ai) is not None)
    tk = w.tiles.shape[-1]
    v_row = tk * w.tiles.element_size()  # bytes of one V tile row: 128
    v_rows = w.tiles.shape[3]  # planes
    bn, ceil = k1.tile_q(q), lambda a, b: -(-a // b)
    tiles = batch * ceil(p, 128) * ceil(q, bn)
    return tiles * ceil(k, tk) * (128 * tk * 4 * d_parts + bn * v_rows * v_row)


def k1_copies(spec, x, w, want_imag, out):
    """:func:`l2_copies` sets of one K1 form's operands for :func:`graph_ms`:
    per copy, K1's operands on a copy of the data ``x`` (the plan constant
    ``w`` shared), K1's outputs (of ``out``'s strides where the form writes
    into a wider grid), and ``torch.matmul``'s complex operands and output."""
    import torch
    from spfft_tpu_torch.ops import fft as offt

    same = lambda t: None if t is None else torch.empty_strided(
        t.size(), t.stride(), dtype=t.dtype, device=t.device).copy_(t)
    ops = k1_operands(spec, x, w)
    ar, ai, br, bi = ops
    batch, m, n = ar.shape[0], ar.shape[1], br.shape[2]
    item = ar.element_size()
    # a copy's bytes: the data and K1's output, about as much again for
    # torch.matmul's complex operands and output, and the plain version's
    footprint = item * (sum(t.numel() for t in x if t is not None)
                        + (1 + want_imag) * batch * m * n) * 3
    whole = lambda t: t[:1] if t.stride(0) == 0 else t
    cplx = lambda re, im: torch.complex(re, im if im is not None else torch.zeros_like(re))
    sets = []
    for c in range(l2_copies(footprint)):
        xc = x if c == 0 else tuple(same(t) for t in x)
        o = k1_operands(spec, xc, w)
        if out is None:
            v = tuple(ar.new_empty((batch, m, n)) if keep else None
                      for keep in (True, want_imag))
        else:
            v = tuple(offt.result_view(spec, same(t)) for t in out)
        a_c, b_c = cplx(whole(o[0]), o[1] if o[1] is None else whole(o[1])), cplx(o[2], o[3])
        sets.append((o, v, (a_c, b_c, a_c.new_empty((batch, m, n)))))
    return sets


def run_k1(name, spec, x, w, want_imag, precision, out=None):
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import fft as offt

    ops = k1_operands(spec, x, w)
    outv = None if out is None else tuple(offt.result_view(spec, o) for o in out)
    errs, scales = k1_err(ops, want_imag, w, precision, outv)
    sets = k1_copies(spec, x, w, want_imag, out)
    err, scale = max(errs), max(scales)
    f64 = ops[0].dtype == torch.float64
    rtol = K1_F64_RTOL if f64 else K1_RTOL
    ar, ai, br, bi = ops
    kernel = lambda: k1.complex_matmul(*ops, want_imag, constant=w, precision=precision, out=outv)
    plain = k1_plain(precision)
    bound, bound_by, fp32_bound = k1_bounds_ms(ops, want_imag, precision, w)
    library = k1.LIBRARY_F64[0] if f64 else k1.LIBRARIES[precision][0]
    row = {
        "name": f"{library}:{name}", "route": "cuda",
        "source": f"spfft_tpu_torch/csrc/{library}.cu",
        "replaces": "spfft_tpu/ops/pallas_fft.py:95",
        "precision": "float64" if f64 else precision,
        "shape": {"batch": ar.shape[0], "M": ar.shape[1], "K": ar.shape[2], "N": br.shape[2]},
        "max_abs_err": err, "rel_err": err / scale,
        "ms": graph_ms([lambda o=o, v=v: k1.complex_matmul(*o, want_imag, constant=w,
                                                           precision=precision, out=v)
                        for o, v, _ in sets]),
        "replay_ms": device_ms(kernel),
        "plain_ms": graph_ms([lambda o=o: plain(*o, want_imag) for o, _, _ in sets]),
        "library_ms": graph_ms([lambda a=a, b=b, c=c: torch.matmul(a, b, out=c)
                                for _, _, (a, b, c) in sets]),
        "copies": len(sets),
        "library_math": "cuBLAS complex128" if f64 else "cuBLAS complex64, allow_tf32=False",
        "call_ms": call_ms(kernel),
        "bound_ms": bound, "bound_by": bound_by, "fp32_bound_ms": fp32_bound,
    }
    if precision != "highest" and not f64:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            row["library_tf32_ms"] = graph_ms([lambda a=a, b=b, c=c: torch.matmul(a, b, out=c)
                                               for _, _, (a, b, c) in sets])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    del sets
    row["bound_share"] = row["bound_ms"] / row["ms"]
    if not f64:
        # what the tiles draw from L2 into shared memory, and at what rate
        row["feed_bytes"] = k1_feed_bytes(ops, w)
        row["feed_tb_s"] = row["feed_bytes"] / row["ms"] / 1e9
    if precision in OTHER and not f64:
        # the other float32-accurate arithmetic on the same inputs: the bar
        # must tell it from this precision's
        want, alt = plain(*ops, want_imag), k1_plain(OTHER[precision])(*ops, want_imag)
        row["other_arithmetic_rel_err"] = max(
            (a - b).abs().max().item() for a, b in zip(alt, want) if b is not None) / scale
    emit({"phase": "kernel", **row})
    check(err <= rtol * scale, f"{row['name']} differs from its plain version: {err} vs {scale}")
    if precision in OTHER and not f64:
        check(row["other_arithmetic_rel_err"] > K1_RTOL,
              f"{row['name']}: the {OTHER[precision]} arithmetic passes the {precision} bar")
    return row, k1_key(ops, want_imag, precision)


def run_k1_odd(phase, dtype, rtol, precision="highest"):
    """K1 at shapes that are not multiples of its tiles, with strides and
    pointers that are not 16-byte aligned, with a constant per batch entry and
    with strided outputs, against its plain version."""
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    r = lambda *s: torch.randn(s, generator=g, device="cuda", dtype=dtype)
    w_r, w_i = r(24, 40), r(24, 40)
    shared = lambda w: w.mT.expand(3, -1, -1)
    odd = lambda *s: r(*s[:-1], s[-1] + 1)[..., 1:]  # last axis contiguous, pointer off by one
    cases = {
        "300x64@64x64": ((r(1, 300, 64), r(1, 300, 64), r(1, 64, 64), r(1, 64, 64)), True),
        "shared 40x24 @ 3x24x70": ((shared(w_r), shared(w_i), r(3, 24, 70), r(3, 24, 70)), True),
        "shared @ real": ((shared(w_r), shared(w_i), r(3, 24, 70), None), True),
        "shared, real part only": ((shared(w_r), shared(w_i), r(3, 24, 70), r(3, 24, 70)), False),
        "unaligned 301x70@70x90": ((odd(1, 301, 70), odd(1, 301, 70), r(1, 70, 90), r(1, 70, 90)),
                                   True),
        "shared @ unaligned 3x24x177": ((shared(w_r), shared(w_i), odd(3, 24, 177), odd(3, 24, 177)),
                                        True),
        "batched 3x30x9 @ 3x9x50": ((r(3, 30, 9), r(3, 30, 9), r(3, 9, 50), r(3, 9, 50)), True),
        "real @ transposed": ((r(2, 33, 45), None, r(2, 120, 45).mT, r(2, 120, 45).mT), True),
        "per-batch 5x(130,70)^T @ 5x130x90": ((r(5, 130, 70).mT, r(5, 130, 70).mT, r(5, 130, 90),
                                              r(5, 130, 90)), True),
    }
    if dtype == torch.float64:
        cases.update({
            "K = 0, 3x30x0 @ 3x0x50": ((r(3, 30, 0), r(3, 30, 0), r(3, 0, 50), r(3, 0, 50)), True),
            "real shared constant @ 3x24x70": ((shared(w_r), None, r(3, 24, 70), r(3, 24, 70)),
                                               True),
        })
    errs = {}
    for name, (ops, want) in cases.items():
        err, scale = k1_err(ops, want, precision=precision)
        # relative to the largest output, absolute where every output is 0 (K = 0)
        errs[name] = max(e / s if s else e for e, s in zip(err, scale))
    # a strided output: columns of a wider grid, as the sparse-y stages write
    ops = (r(4, 60, 36).mT, r(4, 60, 36).mT, r(4, 60, 50), r(4, 60, 50))
    grid = [r(36, 7, 50) for _ in range(2)]
    before = [gr.clone() for gr in grid]
    out = tuple(gr[:, 2:6].permute(1, 0, 2) for gr in grid)
    err, scale = k1_err(ops, True, precision=precision, out=out)
    errs["strided out 4x36x50 in a 36x7x50 grid"] = max(e / s for e, s in zip(err, scale))
    untouched = all(torch.equal(gr[:, c], b[:, c]) for gr, b in zip(grid, before) for c in (0, 1, 6))
    worst = max(errs.values())
    emit({"phase": phase, "name": "complex_matmul", "precision": precision, "rel_err": errs,
          "strided_out_left_other_columns": untouched})
    check(worst <= rtol, f"complex_matmul {dtype} {precision} at odd shapes: rel err {worst}")
    check(untouched, f"complex_matmul {dtype} {precision} wrote outside its strided output")


def k2_vector_bytes(src, out) -> int:
    """The vector width (16, 8 or 4 bytes) that K2 takes to gather the planes
    ``src`` into ``out``, by the rule of ``vector_bytes()`` in
    ``csrc/row_gather.cu``: the widest that divides the row's bytes, both row
    strides (where there is more than one row) and every plane pointer."""
    item, width = src[0].element_size(), src[0].shape[1]
    bits = width * item
    for ts in (src, out):
        bits |= item * ts[0].stride(0) if ts[0].shape[0] > 1 else 0
        for t in ts:
            bits |= t.data_ptr()
    return next(v for v in (16, 8, 4) if bits % v == 0)


def run_k2(name, src, idx, packed=False, out_ld=None):
    """K2 at one form against its plain version. ``packed``: the planes'
    rows go side by side into one ``(rows, planes * W)`` buffer, as the
    exchange's pack writes them (its unpack reads such a buffer's column
    blocks, which ``src`` then is); ``out_ld``: each plane's rows go into
    the first ``W`` columns of an ``out_ld``-wide buffer (a window of the
    OVERLAPPED exchange). ``ms``, ``plain_ms`` and ``library_ms``
    on :func:`graph_ms`'s clock, over :func:`l2_copies` copies of the
    operands, the kernel's and ``index_select``'s outputs among them (the
    plain version allocates its own); ``replay_ms`` on :func:`device_ms`'s,
    as the K1 rows, each call into new outputs."""
    import torch
    from spfft_tpu_torch.ops import row_gather as k2

    src = [t for t in src if t is not None]
    n_src, width = src[0].shape
    n_rows, item = idx.numel(), src[0].element_size()

    def outputs():
        if out_ld is not None:
            return [src[0].new_empty((n_rows, out_ld))[:, :width] for _ in src]
        if not packed:
            return [src[0].new_empty((n_rows, width)) for _ in src]
        buf = src[0].new_empty((n_rows, len(src) * width))
        return [buf[:, q * width:(q + 1) * width] for q in range(len(src))]

    def kernel(src, idx, out=None):
        out = outputs() if out is None else out
        two = len(src) > 1
        return k2.row_gather(src[0], src[1] if two else None, idx,
                             out=(out[0], out[1] if two else None))

    def library(src, idx):
        """index_select's operands and output: the planes stacked, each
        padded with a zero row, which every out-of-range index is sent to."""
        il = idx.long()
        il = torch.where((il >= 0) & (il < n_src), il, torch.full_like(il, n_src))
        both = torch.stack([torch.cat([s, s.new_zeros((1, width))]) for s in src])
        return both, il, both.new_empty((len(src), n_rows, width))

    copies = l2_copies(len(src) * item * width * (n_src + n_rows))
    same_layout = lambda t: torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                                                device=t.device).copy_(t)
    sets = [(src, idx, outputs())] + [([same_layout(t) for t in src], idx.clone(), outputs())
                                      for _ in range(copies - 1)]
    got = [o for o in kernel(*sets[0]) if o is not None]
    want = [k2.row_gather_plain(t, idx) for t in src]
    torch.cuda.synchronize()
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    il = idx.long()
    valid = (il >= 0) & (il < n_src)
    rows_read = torch.unique(il[valid]).numel()
    nbytes = len(src) * item * width * (rows_read + n_rows) + idx.element_size() * n_rows
    libs = [library(s, i) for s, i, _ in sets]
    row = {
        "name": f"row_gather:{name}", "route": "cuda",
        "source": "spfft_tpu_torch/csrc/row_gather.cu",
        "replaces": "programs/microbench_pallas_dma.py:140",
        "shape": {"rows": n_rows, "n_src": n_src, "width": width, "planes": len(src),
                  "dtype": str(src[0].dtype).split(".")[1], "ld_src": src[0].stride(0),
                  "packed_out": packed, "ld_out": got[0].stride(0)},
        "vector_bytes": k2_vector_bytes(src, got),
        "max_abs_err": err, "bitwise_equal": exact,
        "ms": graph_ms([lambda st=st: kernel(*st) for st in sets]),
        "plain_ms": graph_ms([lambda s=s, i=i: [k2.row_gather_plain(t, i) for t in s]
                              for s, i, _ in sets]),
        "library_ms": graph_ms([lambda b=b, li=li, o=o: torch.index_select(b, 1, li, out=o)
                                for b, li, o in libs]),
        "replay_ms": device_ms(lambda: kernel(src, idx)),
        "call_ms": call_ms(lambda: kernel(src, idx)),
        "copies": copies,
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit({"phase": "kernel", **row})
    check(exact, f"{row['name']} is not bitwise equal to its plain version")
    del sets, libs
    return row, (n_rows, n_src, width, len(src))


# K2's odd shapes: widths of every vector the rule can take (1, 3, 33, 70) and
# the main path's (32, 64, 256, 512)
K2_ODD_WIDTHS = (1, 3, 33, 70, 32, 64, 256, 512)


def k2_odd_operands(dtype, width, planes, layout, idx, n_src, gen):
    """The source planes of one odd K2 case, its ``out=`` planes (None for
    new tensors), the buffer they lie in and the parts of it that the gather
    must leave as they were. ``offset``: planes and outputs one column into
    wider buffers; ``packed``: plane q into column block q + 1 of planes + 1."""
    import torch

    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    n_rows = idx.numel()
    if layout == "contiguous":
        return [rnd(n_src, width) for _ in range(planes)], None, None, []
    if layout == "offset":
        buf = rnd(planes, n_rows, width + 2)
        return ([rnd(n_src, width + 1)[:, 1:] for _ in range(planes)],
                [buf[q, :, 1:width + 1] for q in range(planes)], buf,
                [(..., slice(0, 1)), (..., slice(width + 1, width + 2))])
    buf = rnd(n_rows, (planes + 1) * width)
    return ([rnd(n_src, width) for _ in range(planes)],
            [buf[:, (q + 1) * width:(q + 2) * width] for q in range(planes)], buf,
            [(..., slice(0, width))])


def run_k2_odd() -> None:
    """K2 at odd shapes against its plain version, bitwise: every width of
    ``K2_ODD_WIDTHS`` in float32 and float64, one plane and two; planes
    contiguous, at a one-element column offset in wider buffers (misaligned
    pointers and strides), and packed into column blocks of a wider ``out=``
    whose other columns must stay as they were; one row, and more vectors
    (one a thread) than the card holds threads at once; indices with the
    sentinels -1 and n_src and past them (-3, n_src + 3), which the contract
    also sends to a zero row. A row per case with the vector width the
    kernel's rule takes for its operands (:func:`k2_vector_bytes`). Then a
    first gather inside a CUDA-graph capture, in a fresh process."""
    import itertools

    import torch
    from spfft_tpu_torch.ops import row_gather as k2

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    props = torch.cuda.get_device_properties(0)
    # threads resident at once, at most: one wave of blocks
    wave = props.multi_processor_count * props.max_threads_per_multi_processor
    n_src = 513
    cases = list(itertools.product((torch.float32, torch.float64), K2_ODD_WIDTHS, (1, 2),
                                   ("contiguous", "offset", "packed"), (False, True)))
    for case, (dtype, width, planes, layout, many) in enumerate(cases):
        item = dtype.itemsize
        if many:  # more vectors than one wave takes, even at the widest vector
            n_rows = wave * 16 // (width * item) + 7
            idx = torch.randint(-3, n_src + 4, (n_rows,), generator=g, device="cuda",
                                dtype=torch.int32)
        else:
            n_rows = 1
            idx = torch.tensor([(-1, n_src, n_src // 2, -3, n_src + 3)[case % 5]],
                               dtype=torch.int32, device="cuda")
        src, out, buf, keep = k2_odd_operands(dtype, width, planes, layout, idx, n_src, g)
        before = None if buf is None else buf.clone()
        two = lambda ts: ts[1] if planes == 2 else None
        got = k2.row_gather(src[0], two(src), idx, out=None if out is None else (out[0], two(out)))
        got = [o for o in got if o is not None]
        want = [k2.row_gather_plain(t, idx) for t in src]
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        untouched = all(torch.equal(buf[k], before[k]) for k in keep)
        vb = k2_vector_bytes(src, got)
        emit({"phase": "kernel_k2_odd", "dtype": str(dtype).split(".")[1], "width": width,
              "planes": planes, "layout": layout, "rows": n_rows, "vector_bytes": vb,
              "bitwise_equal": exact, "other_columns_untouched": untouched})
        what = f"row_gather {dtype} width {width} x{planes} {layout} {n_rows} rows"
        check(exact, f"{what} is not bitwise equal to its plain version")
        check(untouched, f"{what} wrote outside its columns")
        del src, out, buf, before, got, want, idx
    run = subprocess.run([sys.executable, "-c", K2_FIRST_CALL_IN_CAPTURE],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(run.returncode == 0, f"row_gather's first call under capture: {run.stderr[-3000:]}")
    emit({"phase": "kernel_k2_odd_done", "cases": len(cases),
          "seconds": time.perf_counter() - t0,
          "first_call_in_capture": json.loads(run.stdout.strip().splitlines()[-1])})


# A fresh process whose first gather is captured in a CUDA graph: the
# kernel's first launch happens under the capture.
K2_FIRST_CALL_IN_CAPTURE = """
import json, torch
from spfft_tpu_torch.ops import row_gather as k2
g = torch.Generator(device="cuda").manual_seed(7)
src = [torch.randn((300, 64), generator=g, device="cuda") for _ in range(2)]
idx = torch.randint(-1, 301, (1000,), generator=g, device="cuda", dtype=torch.int32)
k2._library()  # built and loaded before: the capture holds the first launch
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph):
    out = k2.row_gather(src[0], src[1], idx)
graph.replay()
torch.cuda.synchronize()
ok = all(torch.equal(o, k2.row_gather_plain(s, idx)) for o, s in zip(out, src))
print(json.dumps({"captured": True, "bitwise_equal": ok}))
raise SystemExit(0 if ok else 1)
"""


def k2_forms(name, t, gen):
    """Every K2 form plan ``name`` launches: (row name, source pair, index)."""
    import torch

    ex, p = t._exec, t.params
    S, A, Y, Z = p.num_sticks, ex.num_x_active, p.dim_y, p.dim_z
    rnd = lambda rows: [torch.randn((rows, Z), generator=gen, device="cuda") for _ in range(2)]
    if ex.y_plan == "dense":
        return [(f"{name}/expand", rnd(S), ex._yx_map), (f"{name}/pack", rnd(Y * A), ex._stick_keys)]
    if ex.y_plan == "blocked":
        rows = ex._bucket_rows.numel()
        return [(f"{name}/bucket_gather", rnd(S), ex._bucket_rows),
                (f"{name}/regather", rnd(rows), ex._row_of_stick)]
    return []


# The line FFT's forms beyond the main path's plans (float32 "highest", radius
# 0.659, a 15 % sphere): the 512^3 R2C plan of the benchmark's
# r2c-512-s15 cell, and 128^3 and 64^3, where it meets K1 (ops/line_fft.MIN_N)
LINE_FFT_PLANS = [("r2c-512", "r2c", 512), ("c2c-128", "c2c", 128), ("c2c-64", "c2c", 64)]


def line_fft_stages(ex) -> int:
    """How many of the z and x stages of engine ``ex`` run on the line FFT."""
    return ((getattr(ex, "_z_lines", None) is not None)
            + (getattr(ex, "_x_lines", None) is not None))


def line_fft_forms(name, t):
    """Every line FFT form plan ``name`` launches: (row name, kernel call,
    plain call, the K1 product it replaces, ``torch.fft`` at the stage's
    dense shape, operand sets, bytes). Each call takes one operand set
    ``(re, im, library input)``; there are :func:`l2_copies` sets. K1 runs
    with the plan constant the engine makes where the rule leaves a stage on
    K1. The bytes are the planes read once and written once: z every row in
    and out; the x backward the grid's live slots in (it never reads a
    padding slot) and the space out; the x forward the space in and every
    slot of the grid out (a padding slot is written zero)."""
    import torch
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import fft as offt
    from spfft_tpu_torch.ops import line_fft as lf
    from spfft_tpu_torch.types import ScalingType

    ex, p = t._exec, t.params
    R, Y, X, Z, A = ex._table_rows, p.dim_y, p.dim_x, p.dim_z, ex.num_x_active
    r2c = ex.is_r2c
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    const = lambda w: k1.Constant(*(torch.from_numpy(np.ascontiguousarray(q)).cuda() for q in w),
                                  "highest")
    sets = lambda nbytes, make: [make() for _ in range(l2_copies(nbytes))]
    forms = []
    if ex._z_lines is not None:
        zl, scale = ex._z_lines, 1.0 / p.total_size
        wz_b, _, _, wz_f = offt.zy_stage_matrices(Z, Y, p.total_size, np.float32)
        wb, wf = const(wz_b), const(wz_f[ScalingType.FULL])
        nbytes = 2 * 8 * R * Z

        def z_set():
            re, im = rnd(R, Z), rnd(R, Z)
            return re, im, torch.complex(re, im)

        ops = sets(nbytes, z_set)
        forms.append((f"{name}/z_backward", lambda x: lf.rows(x[0], x[1], zl, +1),
                      lambda x: lf.rows_plain(x[0], x[1], zl, +1),
                      lambda x: offt.complex_matmul(x[0], x[1], *wb.pair, "sz,zk->sk", constant=wb),
                      lambda x: torch.fft.ifft(x[2], dim=1, norm="forward"), ops, nbytes))
        forms.append((f"{name}/z_forward", lambda x: lf.rows(x[0], x[1], zl, -1, scale),
                      lambda x: lf.rows_plain(x[0], x[1], zl, -1, scale),
                      lambda x: offt.complex_matmul(x[0], x[1], *wf.pair, "sz,zk->sk", constant=wf),
                      lambda x: torch.fft.fft(x[2], dim=1), ops, nbytes))
    if ex._x_lines is not None:
        xl = ex._x_lines
        live = int((xl.ux >= 0).sum().item())
        wx_b, wx_f = (const(w) for w in offt.x_stage_matrices(X, ex._slot_x, A, r2c, np.float32))
        space_bytes = (4 if r2c else 8) * Y * X * Z
        back_bytes, fwd_bytes = 8 * Y * live * Z + space_bytes, space_bytes + 8 * Y * A * Z
        xf = X // 2 + 1 if r2c else X

        def grid_set():
            return rnd(Y, A, Z), rnd(Y, A, Z), torch.complex(rnd(Y, xf, Z), rnd(Y, xf, Z))

        def space_set():
            re, im = rnd(Y, X, Z), None if r2c else rnd(Y, X, Z)
            return re, im, re if r2c else torch.complex(re, im)

        gsets, ssets = sets(back_bytes, grid_set), sets(fwd_bytes, space_set)
        if r2c:
            k1_b = lambda x: offt.real_out_matmul(x[0], x[1], *wx_b.pair, "kxz,xl->klz",
                                                  constant=wx_b, precision="highest")
            k1_f = lambda x: offt.real_in_matmul(x[0], *wx_f.pair, "yxz,xk->ykz", constant=wx_f,
                                                 precision="highest")
            lib_b = lambda x: torch.fft.irfft(x[2], n=X, dim=1, norm="forward")
            lib_f = lambda x: torch.fft.rfft(x[2], dim=1)
        else:
            k1_b = lambda x: offt.complex_matmul(x[0], x[1], *wx_b.pair, "kxz,xl->klz",
                                                 constant=wx_b)
            k1_f = lambda x: offt.complex_matmul(x[0], x[1], *wx_f.pair, "yxz,xk->ykz",
                                                 constant=wx_f)
            lib_b = lambda x: torch.fft.ifft(x[2], dim=1, norm="forward")
            lib_f = lambda x: torch.fft.fft(x[2], dim=1)
        forms.append((f"{name}/x_backward{'_real_out' if r2c else ''}",
                      lambda x: lf.to_space(x[0], x[1], xl, real_out=r2c),
                      lambda x: lf.to_space_plain(x[0], x[1], xl, real_out=r2c), k1_b, lib_b,
                      gsets, back_bytes))
        forms.append((f"{name}/x_forward{'_real_in' if r2c else ''}",
                      lambda x: lf.from_space(x[0], x[1], xl),
                      lambda x: lf.from_space_plain(x[0], x[1], xl), k1_f, lib_f, ssets,
                      fwd_bytes))
    return forms


def run_line_fft(name, kernel, plain, k1_call, library, ops, nbytes, seen=()):
    """The line FFT at one form against its plain version, bitwise, and the
    K1 product it replaces and ``torch.fft`` beside it: ``ms``, ``k1_ms``
    and ``library_ms`` on :func:`graph_ms`'s clock over the operand sets,
    ``plain_ms`` on :func:`device_ms`'s (one call, replayed three times: its
    temporaries are large), ``bound_ms`` the form's bytes over the HBM rate.
    Returns the row and the form's launch-count key, or None where that key
    is in ``seen``."""
    import torch
    from spfft_tpu_torch.ops import line_fft as lf

    as_tuple = lambda r: r if isinstance(r, tuple) else (r,)
    lf.launches.clear()
    got = as_tuple(kernel(ops[0]))
    keys = list(lf.launches)
    check(len(keys) == 1, f"line_fft:{name}: one call counted {keys}")
    if keys[0] in seen:
        return None
    want = as_tuple(plain(ops[0]))
    torch.cuda.synchronize()
    parts = [(g, w) for g, w in zip(got, want) if w is not None]
    exact = len(got) == len(want) and all(torch.equal(g, w) for g, w in parts)
    err = max((g - w).abs().max().item() for g, w in parts)
    mode, n, lines, sign, real = keys[0]
    row = {
        "name": f"line_fft:{name}", "route": "cuda", "source": "spfft_tpu_torch/csrc/line_fft.cu",
        "replaces": "no TPU kernel: K1's z and x stages (spfft_tpu/ops/pallas_fft.py:95)",
        "precision": "float32",
        "shape": {"mode": mode, "n": n, "lines": lines, "sign": sign, "real": real},
        "max_abs_err": err, "bitwise_equal": exact,
        "ms": graph_ms([lambda x=x: kernel(x) for x in ops]),
        "k1_ms": graph_ms([lambda x=x: k1_call(x) for x in ops]),
        "plain_ms": device_ms(lambda: plain(ops[0]), replays=3),
        "library_ms": graph_ms([lambda x=x: library(x) for x in ops]),
        "library_math": "cuFFT complex64 (torch.fft)",
        "replay_ms": device_ms(lambda: kernel(ops[0])),
        "call_ms": call_ms(lambda: kernel(ops[0])),
        "copies": len(ops), "bytes": nbytes,
        "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes",
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    torch.cuda.empty_cache()
    emit({"phase": "kernel", **row})
    check(exact, f"{row['name']} is not bitwise equal to its plain version: {err}")
    return row, keys[0]


def line_fft_phase(sp, plans) -> list:
    """The line FFT at every form of the main path's plans (each launch-count
    key once), then at the forms of ``LINE_FFT_PLANS``; returns (row, plan,
    kernel, key) of the main path's forms."""
    import torch

    out, seen = [], set()
    for name, (t, _, _) in plans.items():
        if t.engine != "mxu":
            continue
        for form in line_fft_forms(name, t):
            done = run_line_fft(*form, seen=seen)
            if done is not None:
                row, key = done
                seen.add(key)
                out.append((row, name, "line_fft", key))
    for name, kind, n in LINE_FFT_PLANS:
        trip = sp.create_spherical_cutoff_triplets(n, n, n, 0.659,
                                                   hermitian_symmetry=kind == "r2c")
        t = sp.Transform(sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()), n, n, n,
                         indices=trip, dtype=F32, engine="mxu")
        check(line_fft_stages(t._exec) == 2, f"{name}: {t.describe()}")
        for form in line_fft_forms(name, t):
            run_line_fft(*form)
        del t, form
        torch.cuda.empty_cache()
    return out


def storage(idx, dim):
    return np.where(idx < 0, idx + dim, idx)


def oracle(kind, radius):
    """Triplets, values and the complex128 dense oracle of the backward
    transform of one (transform, radius)."""
    import spfft_tpu_torch as sp

    Z, Y, X = DIMS[2], DIMS[1], DIMS[0]
    N = X * Y * Z
    rng = np.random.default_rng(SEED)
    triplets = sp.create_spherical_cutoff_triplets(*DIMS, radius, hermitian_symmetry=kind == "r2c")
    if kind == "c2c":
        values = rng.standard_normal(len(triplets)) + 1j * rng.standard_normal(len(triplets))
        dense = np.zeros((Z, Y, X), np.complex128)
        t3 = np.asarray(triplets)
        dense[storage(t3[:, 2], Z), storage(t3[:, 1], Y), storage(t3[:, 0], X)] = values
        want = np.fft.ifftn(dense) * N
    else:
        # hermitian-consistent values: the spectrum of a real field, cut to the
        # sphere (symmetric under k -> -k, no Nyquist plane at this radius)
        spectrum = np.fft.fftn(rng.standard_normal((Z, Y, X)))
        tf = np.asarray(sp.create_spherical_cutoff_triplets(*DIMS, radius))
        zf, yf, xf = storage(tf[:, 2], Z), storage(tf[:, 1], Y), storage(tf[:, 0], X)
        dense = np.zeros((Z, Y, X), np.complex128)
        dense[zf, yf, xf] = spectrum[zf, yf, xf]
        want = (np.fft.ifftn(dense) * N).real
        th = np.asarray(triplets)
        values = spectrum[storage(th[:, 2], Z), storage(th[:, 1], Y), th[:, 0]]
        del spectrum
    del dense
    return triplets, values, want


def expected_launches(ex) -> tuple[int, int, int]:
    """(K1, K2, line FFT) launches of one backward+forward pair of the
    engine's y plan: a z or x stage on the line FFT (a local float32
    "highest" plan) launches it once a direction in place of K1."""
    fft = 2 * line_fft_stages(ex)
    if ex.y_plan == "dense":
        return 6 - fft, 2, fft
    if ex.y_plan == "per-slot":
        return 6 - fft, 0, fft
    return 2 * len(ex.buckets) + 4 - fft, 2, fft


def launch_counts():
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import line_fft as lf
    from spfft_tpu_torch.ops import row_gather as k2

    return {"complex_matmul": dict(k1.launches), "row_gather": dict(k2.launches),
            "line_fft": dict(lf.launches)}


def clear_counts() -> None:
    from spfft_tpu_torch import ir
    from spfft_tpu_torch.ops import complex_matmul as k1
    from spfft_tpu_torch.ops import line_fft as lf
    from spfft_tpu_torch.ops import row_gather as k2

    k1.launches.clear()
    k2.launches.clear()
    lf.launches.clear()
    ir.dispatches.clear()


def run_pair(sp, t, values_dev) -> dict:
    """One backward + forward(FULL) through the entry points, counted from 0;
    the launch and dispatch counts of that pair, its results, and the most
    memory it held above what was allocated before it."""
    import torch
    from spfft_tpu_torch import ir

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    clear_counts()
    space = t.backward(values_dev)
    back = t.forward(scaling=sp.ScalingType.FULL)
    torch.cuda.synchronize()
    return {"counts": launch_counts(), "dispatches": {f"{m}:{d}": n for (m, d), n in
                                                      ir.dispatches.items()},
            "space": space, "back": back,
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - before}


def total(counts) -> int:
    return sum(sum(c.values()) for c in counts.values())


def equal(a, b) -> tuple[bool, float]:
    """(bitwise equal, max abs diff) of two tensors on the card."""
    import torch

    return torch.equal(a, b), float((a - b).abs().max().item())


def copy_out_ms(t) -> dict:
    """Device time of the copies a fused call hands out: the static outputs
    of the backward and forward(FULL) graphs, cloned."""
    import spfft_tpu_torch as sp

    programs = t._exec._ir._programs
    out = {}
    for key, label in ((("backward", None, None), "backward"),
                       (("forward", sp.ScalingType.FULL, None), "forward")):
        static = programs[key]._captured[2]
        static = static if isinstance(static, tuple) else (static,)
        out[label] = device_ms(lambda: [o.clone() for o in static])
        out[label + "_bytes"] = sum(2 * o.numel() * o.element_size() for o in static)
    return out


def main_path(sp, name, t, twin, precision, values, want):
    """The main path of one plan: its staged twin's pair (each launch counts
    once: the launch counts of the kernels line), then the fused plan's first
    pair (warm-up and capture: exactly twice the twin's launches) and second
    pair (replays: no launch on the host), each against the dense oracle and
    bitwise against the twin. Returns the twin's launch counts and the
    device values."""
    import torch

    f64 = t.dtype == np.float64
    values_dev = torch.as_tensor(values.astype(np.complex128 if f64 else np.complex64),
                                 device="cuda")
    staged = run_pair(sp, twin, values_dev)
    first = run_pair(sp, t, values_dev)
    second = run_pair(sp, t, values_dev)

    Z, Y, X = DIMS[2], DIMS[1], DIMS[0]
    space_h = first["space"].cpu().numpy()
    check(space_h.shape == (Z, Y, X) and np.isfinite(space_h).all(), f"{name} space shape/finite")
    back_h = first["back"].cpu().numpy()
    check(back_h.shape == (len(values),) and np.isfinite(back_h).all(), f"{name} values shape/finite")
    oracle_err = float(np.abs(space_h - want).max() / np.abs(want).max())
    rt_err = float(np.abs(back_h - values).max() / np.abs(values).max())
    counts = staged["counts"]
    n_k1, n_k2 = sum(counts["complex_matmul"].values()), sum(counts["row_gather"].values())
    n_fft = sum(counts["line_fft"].values())
    precisions = sorted({key[-1] for key in counts["complex_matmul"]})
    ex = t._exec
    twice = {k: {key: 2 * n for key, n in c.items()} for k, c in counts.items()}
    vs_staged = {part: equal(first[part], staged[part]) for part in ("space", "back")}
    replay_same = all(equal(second[part], first[part])[0] for part in ("space", "back"))
    row = {
        "phase": "main_path", "plan": name, "engine": t.engine,
        "transform": t.transform_type.name.lower(), "dims": list(DIMS), "dtype": str(t.dtype),
        "precision": precision, "y_plan": getattr(ex, "y_plan", None), "describe": t.describe(),
        "num_values": len(values), "num_sticks": t.params.num_sticks,
        "num_x_active": t.num_x_active, "oracle_rel_err": oracle_err, "roundtrip_rel_err": rt_err,
        "bar": ORACLE_F64_RTOL if f64 else ORACLE_RTOL[precision],
        "launches": {"complex_matmul": n_k1, "row_gather": n_k2, "line_fft": n_fft,
                     "from": "the staged twin's pair"},
        "launches_first_fused_pair": total(first["counts"]),
        "launches_second_fused_pair": total(second["counts"]),
        "dispatches": {"staged": staged["dispatches"], "fused_first": first["dispatches"],
                       "fused_second": second["dispatches"]},
        "fused_vs_staged": {p: {"bitwise": b, "max_abs_diff": d} for p, (b, d) in vs_staged.items()},
        "k1_precisions": precisions,
        "peak_extra_bytes": {"staged_pair": staged["peak_extra_bytes"],
                             "fused_first_pair": first["peak_extra_bytes"],
                             "fused_pair": second["peak_extra_bytes"]},
        "copy_out_ms": copy_out_ms(t),
    }
    emit(row)
    bar = row["bar"]
    check(t.fused and not twin.fused, f"{name}: the plan is not fused or its twin not staged")
    check(oracle_err <= bar, f"{name} backward vs dense oracle: {oracle_err} (bar {bar})")
    check(rt_err <= bar, f"{name} round trip: {rt_err} (bar {bar})")
    check(all(b for b, _ in vs_staged.values()),
          f"{name}: fused and staged results differ: {vs_staged}")
    check(replay_same, f"{name}: the replayed pair differs from the captured one")
    check(second["dispatches"] == {"fused:backward": 1, "fused:forward": 1},
          f"{name}: fused dispatches {second['dispatches']}")
    check(total(second["counts"]) == 0, f"{name}: a replayed pair launched on the host")
    if t.engine == "xla":
        check(total(counts) == 0 and total(first["counts"]) == 0, f"{name} launched K1 or K2")
        return counts, values_dev
    check(first["counts"] == twice,
          f"{name}: first fused pair launched {first['counts']}, not twice the twin's {counts}")
    want_k1, want_k2, want_fft = expected_launches(ex)
    check(n_k1 == want_k1 and n_k2 == want_k2 and n_fft == want_fft,
          f"{name} launches: {n_k1} K1, {n_k2} K2, {n_fft} line FFT (expected {want_k1}, "
          f"{want_k2} and {want_fft})")
    check(precisions == [precision], f"{name} ran K1 at {precisions}, not {precision}")
    return counts, values_dev


def results_stay_put(sp, name, t, values_dev) -> None:
    """Two backwards on different values: the first one's results, native
    (``backward_pair``) and public, are unchanged after the second."""
    import torch

    other = values_dev.roll(1) * (0.5 - 0.25j)
    native = t.backward_pair(values_dev.real, values_dev.imag)
    native = native if isinstance(native, tuple) else (native,)
    kept_native = [x.clone() for x in native]
    public = t.backward(values_dev)
    kept_public = public.clone()
    later = t.backward_pair(other.real, other.imag)
    later = later if isinstance(later, tuple) else (later,)
    t.backward(other)
    torch.cuda.synchronize()
    stayed = all(torch.equal(a, b) for a, b in zip(native, kept_native)) and torch.equal(
        public, kept_public)
    differ = not torch.equal(later[0], native[0])
    emit({"phase": "results_stay_put", "plan": name, "stayed": stayed,
          "second_result_differs": differ})
    check(stayed and differ, f"{name}: a result changed after a later call")


def batch_phase(sp, name, t, values_dev, rounds: int = 6) -> dict:
    """``backward_batch``/``forward_batch(FULL)`` of ``BATCH`` requests
    against the per-request calls: bitwise equal, one batched dispatch per
    direction; then ms per transform, batch against a loop of single pairs,
    the two taking turns."""
    import torch
    from spfft_tpu_torch import ir

    full = sp.ScalingType.FULL
    vals = [values_dev.roll(b) for b in range(BATCH)]
    singles = [t.backward(v).clone() for v in vals]
    fsingles = [t.forward(s, full) for s in singles]
    torch.cuda.synchronize()
    ir.dispatches.clear()
    spaces = t.backward_batch(vals)
    freqs = t.forward_batch(spaces, full)
    torch.cuda.synchronize()
    dispatches = {f"{m}:{d}": n for (m, d), n in ir.dispatches.items()}
    same = [equal(a, b) for a, b in zip(spaces + freqs, singles + fsingles)]

    def batch():
        t.forward_batch(t.backward_batch(vals), full)

    def loop():
        for v in vals:
            t.forward(t.backward(v), full)

    times = {"batch": [], "loop": []}
    for r in range(rounds):
        for label, fn in (("batch", batch), ("loop", loop))[::1 if r % 2 == 0 else -1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[label].append(1e3 * (time.perf_counter() - t0) / BATCH)
    row = {"phase": "batch", "plan": name, "batch": BATCH, "dispatches": dispatches,
           "bitwise_equal_to_single_calls": all(b for b, _ in same),
           "max_abs_diff": max(d for _, d in same),
           "ms_per_transform_pair": {k: statistics.median(v) for k, v in times.items()},
           "timing": f"host clock, median of {rounds} turns; both forwards read the "
                     "(Z, Y, X) spaces their backwards returned"}
    emit(row)
    check(dispatches == {"batched:backward": 1, "batched:forward": 1},
          f"{name}: batch dispatches {dispatches}")
    check(row["bitwise_equal_to_single_calls"], f"{name}: batch differs from single calls")
    return row


def multi_transform_phase(sp, names, plans, values) -> None:
    """The headline C2C and R2C plans in one multi-transform batch, against
    their single calls."""
    import torch

    ts = [plans[n][0] for n in names]
    vals = [values[n] for n in names]
    singles = [t.backward(v).clone() for t, v in zip(ts, vals)]
    fsingles = [t.forward(scaling=sp.ScalingType.FULL) for t in ts]
    spaces = sp.multi_transform_backward(ts, vals)
    freqs = sp.multi_transform_forward(ts, None, sp.ScalingType.FULL)
    torch.cuda.synchronize()
    same = [equal(a, b) for a, b in zip(spaces + freqs, singles + fsingles)]
    emit({"phase": "multi_transform", "plans": list(names),
          "bitwise_equal_to_single_calls": all(b for b, _ in same),
          "max_abs_diff": max(d for _, d in same)})
    check(all(b for b, _ in same), "multi-transform results differ from the single calls")


def interleaved_pair_ms(sp, plans, values, rounds: int = 6, pairs: int = 4, raw=None) -> dict:
    """Median ms per backward+forward(FULL) pair of every plan (``plans``:
    name -> Transform), host clock, the plans taking turns (forward order,
    then reversed, ``rounds`` times, ``pairs`` timed pairs after one untimed
    pair at each turn), so that the host's drift falls on all of them alike.
    ``raw``, a dict, receives every plan's timed pairs."""
    import torch

    times = {name: [] for name in plans}
    for r in range(rounds):
        for name in (list(plans) if r % 2 == 0 else list(reversed(plans))):
            t = plans[name]
            for i in range(pairs + 1):
                t0 = time.perf_counter()
                t.backward(values[name])
                t.forward(scaling=sp.ScalingType.FULL)
                torch.cuda.synchronize()
                if i:
                    times[name].append(1e3 * (time.perf_counter() - t0))
    if raw is not None:
        raw.update(times)
    return {name: statistics.median(v) for name, v in times.items()}


def device_kernels(prof) -> list:
    """The profiler's device events but for the ranges drawn on the device
    timeline (the staged path's ``trace_annotation`` stage ranges and the
    ``timing.scoped`` ``spfft:<label>`` ranges): the kernels and copies."""
    from torch.autograd import DeviceType

    from spfft_tpu_torch import timing
    from spfft_tpu_torch.obs import STAGES

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in STAGES and not e.name.startswith(timing.RANGE_PREFIX)]


def union_us(spans) -> float:
    """Length of the union of sorted ``(start, end)`` intervals."""
    busy_us, reach = 0.0, None
    for start, end in spans:
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    return busy_us


def traced_pair(sp, t, values_dev, attempts: int = 3) -> tuple:
    """The device events (kernels, copies, memsets: dicts with ``name``,
    ``ts``, ``dur`` in µs and ``args.stream``) of one backward+forward(FULL)
    pair of ``t`` under torch.profiler, read from its Chrome trace, the ms
    the pair took on the host's clock, and the attempts taken. As in
    :func:`stage_profile`, one pair runs first as the schedule's untraced
    warm-up step (late in a long process the profiler loses the events at
    the start of a window; the trace holds the last cycle alone), and a
    trace with no device event is taken again, up to ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(REPORTS, exist_ok=True)
    path = os.path.join(REPORTS, f"trace-{os.getpid()}.json")
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for step in range(2):
                t0 = time.perf_counter()
                t.backward(values_dev)
                t.forward(scaling=sp.ScalingType.FULL)
                torch.cuda.synchronize()
                window_ms = 1e3 * (time.perf_counter() - t0)
                if step == 0:
                    prof.step()
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        os.remove(path)
        events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if events:
            break
    return events, window_ms, attempt


def profile_pair(sp, name, t, values_dev) -> dict:
    """One backward+forward(FULL) pair under torch.profiler
    (:func:`traced_pair`): the share of the window the device is busy, and
    the kernels by device time."""
    kernels, window_ms, attempt = traced_pair(sp, t, values_dev)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy_us = union_us(spans)
    by_name = {}
    for e in kernels:
        short = e["name"] if len(e["name"]) <= 90 else e["name"][:87] + "..."
        ms, n = by_name.get(short, (0.0, 0))
        by_name[short] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    of = lambda *keys: sum(e["dur"] / 1e3 for e in kernels if any(k in e["name"] for k in keys))
    row = {
        "phase": "profile", "plan": name, "window_ms": window_ms, "attempts": attempt,
        "device_busy_ms": busy_us / 1e3 if spans else None,
        "device_busy_share": busy_us / 1e3 / window_ms if spans else None,
        "k1_ms": of("tc_kernel", "dmma_kernel"), "k2_ms": of("row_gather_kernel"),
        "nccl_ms": of("ncclDevKernel"), "kernels": len(kernels),
        "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top],
    }
    emit(row)
    return row


# ---- the distributed phase -------------------------------------------------------


def dist_k1_forms(name, t, every=False):
    """The K1 forms of distributed plan ``name`` that get a row: its z stages,
    stacked over the four shards with the z-slab split in their matrices
    (``(P_local * S_max, Z) @ (Z, P * L_max)`` and back); for a plan whose
    slab side differs from the local plan's (ragged slabs: z extent
    P_local * L_max = 280; float64), or with ``every``, also its x and y
    forms."""
    import torch
    from spfft_tpu_torch import ScalingType

    FULL = ScalingType.FULL
    ex, p = t._exec, t.params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    dt = ex.torch_dtype
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=dt)
    pair = lambda *shape: (rnd(*shape), rnd(*shape))
    rows, PL = ex.num_local * ex._S, p.num_shards * ex._L
    if PL == p.dim_z:  # both directions at one shape: one launch key, so one row
        forms = [(f"{name}/z_backward+forward", "sz,zk->sk", pair(rows, p.dim_z), ex._wz_b,
                  True, None)]
    else:
        forms = [(f"{name}/z_backward", "sz,zk->sk", pair(rows, p.dim_z), ex._wz_b, True, None),
                 (f"{name}/z_forward", "sz,zk->sk", pair(rows, PL), ex._wz_f[FULL], True, None)]
    if ex._zs == p.dim_z and dt == torch.float32 and not every:
        return forms
    Y, A, X, Zs = p.dim_y, ex.num_x_active, p.dim_x, ex._zs
    if ex.is_r2c:
        forms += [(f"{name}/x_backward_real_out", "kxz,xl->klz", pair(Y, A, Zs), ex._wx_b, False,
                   None),
                  (f"{name}/x_forward_real_in", "yxz,xk->ykz", (rnd(Y, X, Zs), None), ex._wx_f,
                   True, None)]
    else:
        forms += [(f"{name}/x_backward", "kxz,xl->klz", pair(Y, A, Zs), ex._wx_b, True, None),
                  (f"{name}/x_forward", "yxz,xk->ykz", pair(Y, X, Zs), ex._wx_f, True, None)]
    if ex.y_plan == "dense":
        forms.append((f"{name}/y", "yxz,yk->kxz", pair(Y, A, Zs), ex._wy_b, True, None))
    elif ex.y_plan == "per-slot":
        forms += [(f"{name}/slot_backward", SLOTS_OUT, pair(A, ex.sy, Zs), ex._wy_b, True, None),
                  (f"{name}/slot_forward", SLOTS_IN, pair(Y, A, Zs), ex._wy_f, True, None)]
    else:
        grid, col = pair(Y, A, Zs), 0
        for b, (ag, syg, wb, wf) in enumerate(ex.buckets):
            cols = tuple(g[:, col:col + ag] for g in grid)
            forms.append((f"{name}/bucket{b}_backward", SLOTS_OUT, pair(ag, syg, Zs), wb, True,
                          cols))
            forms.append((f"{name}/bucket{b}_forward", SLOTS_IN, cols, wf, True, None))
            col += ag
    return forms


def route_k2_forms(form, bx, planes, width, dtype, gen):
    """The K2 gathers of one exchange direction ``bx`` (a BlockExchange):
    (row name, source planes, index, packed). Without a group one gather;
    over the process group a pack into the send buffer's column blocks and
    an unpack out of the received one's."""
    import torch

    rnd = lambda rows: [torch.randn((rows, width), generator=gen, device="cuda", dtype=dtype)
                        for _ in range(planes)]
    if not bx.collective:
        return [(form, rnd(bx.n_src), bx._index, False)]
    buf = torch.randn((sum(bx._got), planes * width), generator=gen, device="cuda", dtype=dtype)
    return [(form + "_pack", rnd(bx.n_src), bx._pack, True),
            (form + "_unpack", [buf[:, q * width:(q + 1) * width] for q in range(planes)],
             bx._unpack, False)]


def dist_k2_forms(name, t, gen):
    """The exchange's K2 gathers of distributed plan ``name``, each way."""
    ex = t._exec
    xc = ex._exchange
    planes = 1 if t.engine == "xla" else 2
    width = xc.L * (2 if planes == 1 else 1)
    return [f for direction in ("backward", "forward")
            for f in route_k2_forms(f"{name}/exchange_{direction}", getattr(xc, direction),
                                    planes, width, ex.torch_dtype, gen)]


def shard_index(triplets, per):
    """Per shard, the positions of its triplets in the global array."""
    key = lambda t: ((t[:, 0] + 1024) * 2048 + t[:, 1] + 1024) * 2048 + t[:, 2] + 1024
    keys = key(np.asarray(triplets, np.int64))
    order = np.argsort(keys)
    return [order[np.searchsorted(keys[order], key(np.asarray(t, np.int64)))] for t in per]


def expected_dist_launches(t) -> tuple[int, int]:
    """(K1, K2) launches of one distributed pair: the local engine's K1
    stages; K2 one exchange gather per direction, or a pack and an unpack
    per direction over a process group. A pencil pair: 6 K1 (z, y, x each
    way) and two exchanges a direction, 4 K2 or 8 over a group."""
    if t.engine.startswith("pencil2"):
        return (6 if t.engine == "pencil2-mxu" else 0, 8 if t._exec.collective else 4)
    k2 = 4 if t._exec._exchange.collective else 2
    return (0, k2) if t.engine == "xla" else (expected_launches(t._exec)[0], k2)


def dist_main_path(sp, name, t, twin, values, want, local_space, local_back, bar, ref=None,
                   slab=None):
    """The main path of one distributed plan: the staged twin's pair (the
    launch counts), the fused plan's first pair (twice the twin's launches:
    the eager run and the capture, over a process group too) and second
    (none, one dispatch a direction, bitwise the first), against the dense
    oracle, the local plan's backward, the input values (round trip) and
    bitwise against the twin; a plan over the process group also bitwise
    against ``ref``, the staged pair of the same plan without a group.
    Returns the launch counts, the twin's pair and the row. ``slab``: a
    pencil plan's slab plan's space and values (this plan's shards), held to
    1e-5 as the local plan's."""
    import torch

    staged = run_pair(sp, twin, values)
    first = run_pair(sp, t, values)
    second = run_pair(sp, t, values)
    space_h = first["space"].cpu().numpy()
    check(space_h.shape == want.shape and np.isfinite(space_h).all(), f"{name} space shape/finite")
    back = first["back"]
    check(len(back) == 4 and all(bool(torch.isfinite(b).all()) for b in back),
          f"{name} values finite")
    oracle_err = float(np.abs(space_h - want).max() / np.abs(want).max())
    local_err = float(np.abs(space_h - local_space).max() / np.abs(local_space).max())
    scale = max(float(v.abs().max()) for v in values)
    rt_err = max(float((b - v).abs().max()) for b, v in zip(back, values)) / scale
    local_back_err = max(float((b.to(lb.dtype) - lb).abs().max())
                         for b, lb in zip(back, local_back)) / scale
    counts = staged["counts"]
    n_k1, n_k2 = (sum(counts[k].values()) for k in ("complex_matmul", "row_gather"))
    twice = {k: {key: 2 * n for key, n in c.items()} for k, c in counts.items()}
    same = lambda a, b: torch.equal(a["space"], b["space"]) and all(
        torch.equal(x, y) for x, y in zip(a["back"], b["back"]))
    ex = t._exec
    row = {
        "phase": "dist_main_path", "plan": name, "engine": t.engine, "dims": list(DIMS),
        "transform": t.transform_type.name.lower(), "dtype": str(np.dtype(t.dtype)),
        "exchange": t.exchange_type.name,
        "exchange_requested": t.describe()["exchange"]["requested"],
        "exchange_wire_bytes": t.exchange_wire_bytes(), "exchange_rounds": t.exchange_rounds(),
        "transport": ex.exchange_transport(), "fused": t.fused,
        "staged_because": t.describe()["ir"].get("staged_because"),
        "y_plan": getattr(ex, "y_plan", None), "describe": t.describe(),
        "num_sticks_per_shard": [int(n) for n in t.params.num_sticks_per_shard],
        "local_z_lengths": [int(n) for n in t.params.local_z_lengths],
        "oracle_rel_err": oracle_err, "local_plan_rel_err": local_err,
        "local_plan_values_rel_err": local_back_err, "roundtrip_rel_err": rt_err, "bar": bar,
        "launches": {"complex_matmul": n_k1, "row_gather": n_k2, "from": "the staged twin's pair"},
        "launches_first_fused_pair": total(first["counts"]),
        "launches_second_fused_pair": total(second["counts"]),
        "dispatches": {"staged": staged["dispatches"], "fused_second": second["dispatches"]},
        "fused_equals_staged": same(first, staged), "replay_equals_first": same(second, first),
        "peak_extra_bytes": {"staged_pair": staged["peak_extra_bytes"],
                             "fused_pair": second["peak_extra_bytes"]},
    }
    if ref is not None:
        row["bitwise_equal_to_the_plan_without_a_group"] = same(first, ref)
    if slab is not None:
        row["slab_plan_rel_err"] = float(np.abs(space_h - slab[0]).max() / np.abs(slab[0]).max())
        row["slab_plan_values_rel_err"] = max(float((b.to(sb.dtype) - sb).abs().max())
                                              for b, sb in zip(back, slab[1])) / scale
    emit(row)
    check(oracle_err <= bar, f"{name} backward vs dense oracle: {oracle_err} (bar {bar})")
    check(rt_err <= bar, f"{name} round trip: {rt_err} (bar {bar})")
    check(local_err <= ORACLE_RTOL["highest"], f"{name} vs the local plan: {local_err}")
    check(local_back_err <= ORACLE_RTOL["highest"],
          f"{name} values vs the local plan: {local_back_err}")
    if slab is not None:
        check(max(row["slab_plan_rel_err"], row["slab_plan_values_rel_err"])
              <= ORACLE_RTOL["highest"], f"{name} vs its slab plan: {row['slab_plan_rel_err']}, "
              f"{row['slab_plan_values_rel_err']}")
    want_k1, want_k2 = expected_dist_launches(t)
    check(n_k1 == want_k1 and n_k2 == want_k2,
          f"{name} launches: {n_k1} K1, {n_k2} K2 (expected {want_k1} and {want_k2})")
    if ref is not None:
        check(row["bitwise_equal_to_the_plan_without_a_group"],
              f"{name}: not bitwise equal to the plan without a group")
    check(t.fused and not twin.fused and row["staged_because"] is None,
          f"{name}: the plan is not fused ({row['staged_because']}) or its twin not staged")
    check(row["fused_equals_staged"], f"{name}: fused and staged results differ")
    check(row["replay_equals_first"], f"{name}: the replayed pair differs from the first")
    check(first["counts"] == twice, f"{name}: first fused pair launched {first['counts']}, "
          f"not twice the twin's {counts}")
    check(total(second["counts"]) == 0, f"{name}: a replayed pair launched on the host")
    check(second["dispatches"] == {"fused:backward": 1, "fused:forward": 1},
          f"{name}: fused dispatches {second['dispatches']}")
    return counts, staged, row


def group_batch(sp, name, t, values) -> dict:
    """``backward_batch``/``forward_batch(FULL)`` of ``BATCH`` requests over
    the process group, twice (the first batch runs eagerly and captures the
    graph of B bodies, each with its collectives; the second replays it),
    against ``BATCH`` looped pairs: bitwise, one batched dispatch a
    direction, no host launch in the replayed batch."""
    import torch
    from spfft_tpu_torch import ir

    full = sp.ScalingType.FULL
    batch = [[v.roll(b) for v in values] for b in range(BATCH)]
    loop = []
    for v in batch:
        space = t.backward(v)
        loop.append((space, t.forward(space, full)))
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        clear_counts()
        spaces = t.backward_batch(batch)
        backs = t.forward_batch(spaces, full)
        torch.cuda.synchronize()
        runs.append({"dispatches": {f"{m}:{d}": n for (m, d), n in ir.dispatches.items()},
                     "launches": total(launch_counts()),
                     "bitwise": all(torch.equal(s, ls) and all(torch.equal(x, y) for x, y in
                                                                zip(b, lb))
                                    for s, b, (ls, lb) in zip(spaces, backs, loop))})
    row = {"phase": "dist_batch", "plan": name, "batch": BATCH, "runs": runs,
           "card": t.report()["batch"]}
    emit(row)
    check(all(r["bitwise"] for r in runs), f"{name}: a batch over the group differs from the loop")
    check(all(r["dispatches"] == {"batched:backward": 1, "batched:forward": 1} for r in runs),
          f"{name}: batch dispatches {[r['dispatches'] for r in runs]}")
    check(runs[1]["launches"] == 0, f"{name}: the replayed batch launched on the host")
    return row


def local_results_of(sp, plans, values, names) -> dict:
    """The local plans' backward (host) and forward(FULL) of their values."""
    out = {}
    for local in names:
        lt = plans[local][0]
        out[local] = (lt.backward(values[local]).cpu().numpy(),
                      lt.forward(scaling=sp.ScalingType.FULL))
    return out


def dist_phase(sp, data, plans, values, group):
    """Builds and drives every plan of ``DIST_PLANS`` (see the module
    docstring), each against its oracle and local plan; ``group`` the
    one-rank NCCL group. Returns the plans {name: (plan, staged twin)},
    their launch counts, their kernel rows, their per-shard values and
    their results {name: (space on the host, values in the global order)}."""
    import torch

    local_results = local_results_of(sp, plans, values, {d[-1] for d in DIST_PLANS})
    out, counts, rows, dvalues, mains, results = {}, {}, [], {}, {}, {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for name, kind, engine, exchange, dtype, weights, lz, over_group, local in DIST_PLANS:
        triplets, vals_global, want = data[kind, 0.659]
        per = sp.distribute_triplets(triplets, 4, DIMS[1], weights=weights)
        where = shard_index(triplets, per)
        cdt = np.complex64 if dtype == np.float32 else np.complex128
        vals = [torch.as_tensor(vals_global[i].astype(cdt), device="cuda") for i in where]
        mesh = sp.make_fft_mesh(4, group=group if over_group else None)
        make = lambda **kw: sp.DistributedTransform(
            sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()), *DIMS, per,
            mesh=mesh, engine=engine, exchange_type=getattr(sp.ExchangeType, exchange),
            dtype=dtype, local_z_lengths=lz, **kw)
        t = make()
        twin = make(fuse=False)
        emit({"phase": "dist_plan", "plan": name, "engine": t.engine, "fused": t.fused,
              "exchange": t.exchange_type.name, "describe": t.describe()})
        if engine == "auto":
            check(t.engine == "mxu", f"{name}: auto resolved to {t.engine} on the card")
        if t.engine == "mxu":
            got = [(ag, syg) for ag, syg, _, _ in t._exec.buckets] if t._exec.buckets else None
            check(t._exec.y_plan == "blocked" and got == EXPECT[kind, 0.659],
                  f"{name}: y plan {t._exec.y_plan} {got}, not the blocked {EXPECT[kind, 0.659]}")
        # the kernels at this plan's forms, against their plain versions
        if t.engine == "mxu" and not over_group:
            for form, spec, x, w, want_imag, o in dist_k1_forms(name, t):
                row, key = run_k1(form, spec, x, w, want_imag, t.precision, o)
                rows.append((row, name, "complex_matmul", key))
        for form, src, idx, packed in dist_k2_forms(name, t, gen):
            row, key = run_k2(form, src, idx, packed)
            rows.append((row, name, "row_gather", key))
        bar = DIST_F64_RTOL if dtype == np.float64 else ORACLE_RTOL["highest"]
        local_space, local_back = local_results[local]
        local_back = [local_back[torch.as_tensor(i, device="cuda")] for i in where]
        ref = mains["dist4-c2c"] if over_group else None
        counts[name], mains[name], _ = dist_main_path(
            sp, name, t, twin, vals, want, local_space, local_back, bar, ref)
        if over_group:
            group_batch(sp, name, t, vals)
        out[name], dvalues[name] = (t, twin), vals
        back = mains[name]["back"]
        flat = back[0].new_empty(sum(int(b.numel()) for b in back))
        for i, b in zip(where, back):
            flat[torch.as_tensor(i, device="cuda")] = b
        results[name] = (mains[name]["space"].cpu().numpy(), flat)
    return out, counts, rows, dvalues, results


# ---- the pencil phase ------------------------------------------------------------


def pencil_k1_forms(name, t):
    """The K1 forms of pencil plan ``name``, each one launch over every
    stacked shard: z, ``(P_local * S_max, Z) @ (Z, P2 * Lz)`` and back (one
    shape where ``P2 * Lz = Z``); y, ``(Y, Y)^T @ (Y, P_local * Ax * Lz)``
    both ways; x, ``P_local * Ly`` times ``(P1 * Ax, X)^T @ (P1 * Ax, Lz)``
    backward and ``(X, P1 * Ax)^T @ (X, Lz)`` forward (real out and real
    in for R2C)."""
    import torch
    from spfft_tpu_torch import ScalingType

    ex, p = t._exec, t.params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=ex.torch_dtype)
    pair = lambda *shape: (rnd(*shape), rnd(*shape))
    rows, zcols = ex.num_local * ex._S, ex.P2 * ex._Lz
    Y, X, Lz, Ly, Ax, C = p.dim_y, p.dim_x, ex._Lz, ex._Ly, ex._Ax, ex._C
    if zcols == p.dim_z:
        forms = [(f"{name}/z_backward+forward", "sz,zk->sk", pair(rows, p.dim_z), ex._wz_b,
                  True, None)]
    else:
        forms = [(f"{name}/z_backward", "sz,zk->sk", pair(rows, p.dim_z), ex._wz_b, True, None),
                 (f"{name}/z_forward", "sz,zk->sk", pair(rows, zcols),
                  ex._wz_f[ScalingType.FULL], True, None)]
    forms.append((f"{name}/y_backward+forward", "yxz,yk->kxz", pair(Y, ex.num_local * Ax, Lz),
                  ex._wy_b, True, None))
    slab = ex.num_local * Ly
    if ex.is_r2c:
        forms += [(f"{name}/x_backward_real_out", "kxz,xl->klz", pair(slab, C, Lz), ex._wx_b,
                   False, None),
                  (f"{name}/x_forward_real_in", "yxz,xk->ykz", (rnd(slab, X, Lz), None),
                   ex._wx_f, True, None)]
    else:
        forms += [(f"{name}/x_backward", "kxz,xl->klz", pair(slab, C, Lz), ex._wx_b, True, None),
                  (f"{name}/x_forward", "yxz,xk->ykz", pair(slab, X, Lz), ex._wx_f, True, None)]
    return forms


def pencil_k2_forms(name, t, gen):
    """The K2 gathers of pencil plan ``name``: exchanges A and B, each way."""
    ex = t._exec
    planes = 1 if t.engine == "pencil2" else 2
    width = ex._Lz * (2 if planes == 1 else 1)
    return [f for tag, direction in (("A", "backward"), ("B", "backward"), ("B", "forward"),
                                     ("A", "forward"))
            for f in route_k2_forms(f"{name}/exchange_{tag}_{direction}",
                                    ex._exchanges[tag, direction], planes, width,
                                    ex.torch_dtype, gen)]


def pencil_phase(sp, data, plans, values, group, slab_results):
    """Builds and drives every plan of ``PENCIL_PLANS`` on a 2 x 2 pencil
    mesh, each against the dense oracle, its round trip, its staged twin
    (bitwise), its slab plan and the local plan of the same triplets (1e-5),
    and the NCCL plan against the plan without a group (bitwise); its K1 and
    K2 forms against their plain versions. Returns the plans, their launch
    counts, their kernel rows and their per-shard values."""
    import torch

    X, Y = DIMS[0], DIMS[1]
    local_results = local_results_of(sp, plans, values, {d[-1] for d in PENCIL_PLANS})
    out, counts, rows, pvalues, mains = {}, {}, [], {}, {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for name, kind, engine, exchange, dtype, over_group, slab, local in PENCIL_PLANS:
        triplets, vals_global, want = data[kind, 0.659]
        per = sp.distribute_triplets(triplets, 4, Y, layout=(2, 2), dim_x=X)
        where = shard_index(triplets, per)
        cdt = np.complex64 if dtype == np.float32 else np.complex128
        vals = [torch.as_tensor(vals_global[i].astype(cdt), device="cuda") for i in where]
        mesh = sp.make_fft_mesh2(2, 2, group=group if over_group else None)
        make = lambda **kw: sp.DistributedTransform(
            sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()), *DIMS, per,
            mesh=mesh, engine=engine, exchange_type=getattr(sp.ExchangeType, exchange),
            dtype=dtype, **kw)
        t = make()
        twin = make(fuse=False)
        emit({"phase": "pencil_plan", "plan": name, "engine": t.engine, "fused": t.fused,
              "exchange": t.exchange_type.name, "describe": t.describe(),
              "plan_card_exchange_policy": t.report().get("exchange_policy")})
        if engine == "auto":
            check(t.engine == "pencil2-mxu", f"{name}: auto resolved to {t.engine} on the card")
        if t.engine == "pencil2-mxu" and not over_group:
            for form, spec, x, w, want_imag, o in pencil_k1_forms(name, t):
                row, key = run_k1(form, spec, x, w, want_imag, t.precision, o)
                rows.append((row, name, "complex_matmul", key))
        for form, src, idx, packed in pencil_k2_forms(name, t, gen):
            row, key = run_k2(form, src, idx, packed)
            rows.append((row, name, "row_gather", key))
        bar = DIST_F64_RTOL if dtype == np.float64 else ORACLE_RTOL["highest"]
        local_space, local_back = local_results[local]
        local_back = [local_back[torch.as_tensor(i, device="cuda")] for i in where]
        slab_space, slab_flat = slab_results[slab]
        slab_back = [slab_flat[torch.as_tensor(i, device="cuda")] for i in where]
        ref = mains["pencil2x2-c2c"] if over_group else None
        counts[name], mains[name], _ = dist_main_path(
            sp, name, t, twin, vals, want, local_space, local_back, bar, ref,
            slab=(slab_space, slab_back))
        out[name], pvalues[name] = (t, twin), vals
    return out, counts, rows, pvalues

# ---- phase 6c: the OVERLAPPED exchange ----------------------------------------------

# (name, transform, mesh, engine, exchange, dtype, overlap, over the process
# group); four shards stacked on the card at 256^3, radius 0.659, each held
# against its overlap=1 twin built here, and a stacked plan against its
# staged twin, whose trace shows the streams as issued
OVERLAP_PLANS = [
    ("dist4-c2c-buffered-ov4", "c2c", "slab", "mxu", "BUFFERED", F32, 4, False),
    ("dist4-r2c-buffered-ov2", "r2c", "slab", "mxu", "BUFFERED", F32, 2, False),
    ("dist4-c2c-xla-buffered-ov4", "c2c", "slab", "xla", "BUFFERED", F32, 4, False),
    ("pencil2x2-c2c-f64-float-ov4", "c2c", "pencil", "mxu", "BUFFERED_FLOAT", F64, 4, False),
    ("dist4-c2c-nccl1-ov4", "c2c", "slab", "mxu", "BUFFERED", F32, 4, True),
]
# the plan the one-rank NCCL plan is held bitwise against
OVERLAP_STACKED = {"dist4-c2c-nccl1-ov4": "dist4-c2c-buffered-ov4"}
# the dtype's bar where a form is not bitwise its overlap=1 twin's
OVERLAP_TWIN_RTOL = {"float32": 1e-5, "float64": 1e-12}
# the kernel names of the profile
K1_KERNELS, EXCHANGE_KERNELS = ("tc_kernel", "dmma_kernel"), ("row_gather_kernel",
                                                              "ncclDevKernel")


def widths(chunks) -> dict:
    """One chunk ``(c0, c1)`` per distinct chunk width."""
    return {c1 - c0: (c0, c1) for c0, c1 in chunks}


def overlap_k1_forms(name, t):
    """The K1 forms that an OVERLAPPED plan adds: on a slab mesh the z stage
    over the stick rows [c0, c1) of the four stacked shards, a batch of four
    strided windows (backward reads them, forward writes them), one row per
    chunk width; on a pencil mesh the y stage of a z window and the x stage
    reading (forward) or writing (backward) its window of the native space."""
    import torch
    from spfft_tpu_torch import ScalingType

    ex, p = t._exec, t.params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    dt = ex.torch_dtype
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=dt)
    pair = lambda *shape: (rnd(*shape), rnd(*shape))
    Pl, forms = ex.num_local, []
    if not t.engine.startswith("pencil2"):
        S, PL, Z = ex._S, p.num_shards * ex._L, p.dim_z
        for W, (c0, c1) in widths(ex._chunks).items():
            win = lambda parts: tuple(q.view(Pl, S, -1)[:, c0:c1] for q in parts)
            if PL == Z:  # both directions at one shape: one launch key, one row
                forms.append((f"{name}/z_window{W}_backward+forward", "bsz,zk->bsk",
                              win(pair(Pl * S, Z)), ex._wz_b, True, None))
            else:
                forms += [(f"{name}/z_window{W}_backward", "bsz,zk->bsk", win(pair(Pl * S, Z)),
                           ex._wz_b, True, None),
                          (f"{name}/z_window{W}_forward", "bsz,zk->bsk", pair(Pl, W, PL),
                           ex._wz_f[ScalingType.FULL], True, win(pair(Pl * S, Z)))]
        return forms
    Y, X, Lz, Ly, Ax, C = p.dim_y, p.dim_x, ex._Lz, ex._Ly, ex._Ax, ex._C
    slab = Pl * Ly
    for W, (c0, c1) in widths(ex._chunks).items():
        space = lambda: tuple(q.view(slab, X, Lz)[:, :, c0:c1] for q in pair(slab, X, Lz))
        forms += [(f"{name}/y_window{W}_backward+forward", "yxz,yk->kxz", pair(Y, Pl * Ax, W),
                   ex._wy_b, True, None),
                  (f"{name}/x_window{W}_backward", "kxz,xl->klz", pair(slab, C, W), ex._wx_b,
                   True, space()),
                  (f"{name}/x_window{W}_forward", "yxz,xk->ykz", space(), ex._wx_f, True, None)]
    return forms


def overlap_k2_forms(name, t, gen):
    """The K2 gathers of an OVERLAPPED plan, one row per chunk width: on a
    slab mesh each backward chunk's gather into its rows of the receive
    buffer (over a group: its pack), the one unpack, and each forward chunk's
    gather (its pack and unpack); on a pencil mesh exchange A backward
    reading the window's columns of the z stage's rows, exchange B both ways
    and exchange A forward writing the window's columns of the stick rows."""
    import torch

    ex = t._exec
    planes = 1 if t.engine in ("xla", "pencil2") else 2
    dt = ex.torch_dtype
    rnd = lambda rows, cols: [torch.randn((rows, cols), generator=gen, device="cuda", dtype=dt)
                              for _ in range(planes)]
    forms = []
    if not t.engine.startswith("pencil2"):
        xc = ex._exchange
        width = xc.L * (2 if planes == 1 else 1)
        bc = xc.backward_chunks
        for W, (c0, c1) in widths(xc.chunks).items():
            k = xc.chunks.index((c0, c1))
            pack = bc._chunks[k][0]
            forms.append((f"{name}/exchange_backward_chunk{W}" + ("_pack" if bc.collective
                                                                   else ""),
                          rnd(ex.num_local * W * ex.params.num_shards, width), pack, True))
            forms += route_k2_forms(f"{name}/exchange_forward_chunk{W}", xc.forward_chunks[k],
                                    planes, width, dt, gen)
        buf = torch.randn((bc.total, planes * width), generator=gen, device="cuda", dtype=dt)
        forms.append((f"{name}/exchange_backward_unpack",
                      [buf[:, q * width:(q + 1) * width] for q in range(planes)], bc._unpack,
                      False))
        return forms
    u, Lz = ex._zunit, ex._Lz
    for W, (c0, c1) in widths(ex._chunks).items():
        for tag, direction in (("A", "backward"), ("B", "backward"), ("B", "forward"),
                               ("A", "forward")):
            bx = ex._exchanges[tag, direction]
            src = rnd(bx.n_src, u * (Lz if (tag, direction) == ("A", "backward") else W))
            if (tag, direction) == ("A", "backward"):
                src = [s[:, c0 * u:c1 * u] for s in src]
            out_ld = u * Lz if (tag, direction) == ("A", "forward") else None
            forms.append((f"{name}/exchange_{tag}_{direction}_window{W}", src, bx._index, False,
                          out_ld))
    return forms


def stream_profile(sp, t, values_dev) -> dict:
    """One pair of ``t`` under torch.profiler (:func:`traced_pair`): the
    streams its K1 and exchange kernels (K2, NCCL) ran on, and the device ms
    during which an exchange kernel and a K1 kernel ran at once (the
    overlap won)."""
    events, _, attempt = traced_pair(sp, t, values_dev)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    of = lambda keys: [e for e in kernels if any(k in e["name"] for k in keys)]
    k1, xk = of(K1_KERNELS), of(EXCHANGE_KERNELS)
    rest = [e for e in kernels if e not in xk]  # K1, cuFFT and the plain tensor code
    k1_streams = sorted({e["args"].get("stream") for e in k1})
    side = [e for e in xk if e["args"].get("stream") not in k1_streams]
    spans = lambda es: sorted((e["ts"], e["ts"] + e["dur"]) for e in es)
    # the device time during which kernels of both sets ran: |A| + |B| - |A u B|
    both = lambda a, b: (union_us(spans(a)) + union_us(spans(b))
                         - union_us(sorted(spans(a) + spans(b)))) / 1e3
    return {"attempts": attempt, "k1_streams": k1_streams,
            "exchange_streams": sorted({e["args"].get("stream") for e in xk}),
            "k1_kernels": len(k1), "exchange_kernels": len(xk),
            "exchange_kernels_off_k1_streams": len(side),
            "nccl_kernels": len(of(("ncclDevKernel",))),
            "exchange_ms": union_us(spans(xk)) / 1e3, "k1_ms": union_us(spans(k1)) / 1e3,
            # an exchange kernel (K2, NCCL) and a K1 kernel at once, on any
            # streams: the overlap won (a replayed CUDA graph's kernels are
            # reported on its own streams)
            "overlapped_ms": both(xk, k1),
            # the same against any other kernel (the torch.fft engine has no K1)
            "overlapped_any_ms": both(xk, rest),
            # kernels, copies and memsets, as profile_pair counts busy time
            "device_busy_ms": union_us(spans(events)) / 1e3}


def overlap_phase(sp, data, group) -> tuple:
    """Phase 6c (module docstring): each plan of ``OVERLAP_PLANS`` and its
    overlap=1 twin, against each other (bitwise on the matrix-product
    engines), the dense oracle and the round trip; the NCCL plan bitwise
    against the stacked one; no rung; the new K1 and K2 forms against their
    plain versions; the streams and the overlap won under torch.profiler;
    pair and busy ms against the twin, the two taking turns. Returns the
    kernel rows and the launch counts of each plan's first pair."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows, counts, results, built = [], {}, {}, {}
    X, Y = DIMS[0], DIMS[1]
    for name, kind, layout, engine, exchange, dtype, ov, over_group in OVERLAP_PLANS:
        t1 = time.perf_counter()
        triplets, vals_global, want = data[kind, 0.659]
        if layout == "pencil":
            per = sp.distribute_triplets(triplets, 4, Y, layout=(2, 2), dim_x=X)
            mesh = sp.make_fft_mesh2(2, 2, group=group if over_group else None)
        else:
            per = sp.distribute_triplets(triplets, 4, Y)
            mesh = sp.make_fft_mesh(4, group=group if over_group else None)
        cdt = np.complex64 if dtype == F32 else np.complex128
        vals = [torch.as_tensor(vals_global[i].astype(cdt), device="cuda")
                for i in shard_index(triplets, per)]
        make = lambda overlap, **kw: sp.DistributedTransform(
            sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()), *DIMS, per,
            mesh=mesh, engine=engine, exchange_type=getattr(sp.ExchangeType, exchange),
            dtype=dtype, overlap=overlap, **kw)
        t, twin = make(ov), make(1)
        # a replayed CUDA graph's kernels are reported on the graph's own streams
        st = make(ov, fuse=False)
        check(t.overlap_chunks == ov and t.exchange_rounds() == ov * (
            2 if layout == "pencil" else 1), f"{name}: {t.overlap_chunks} chunks, "
              f"{t.exchange_rounds()} rounds")
        check(t.fused and t.describe()["ir"].get("staged_because") is None and not st.fused,
              f"{name}: fused {t.fused}, its twin {st.fused}")
        # the kernels at the forms this plan adds, against their plain versions
        if engine == "mxu" and not over_group:
            for form, spec, x, w, want_imag, o in overlap_k1_forms(name, t):
                row, key = run_k1(form, spec, x, w, want_imag, t._exec.k1_precision, o)
                rows.append((row, name, "complex_matmul", key))
        for form, src, idx, packed, out_ld in (
                (*f, None)[:5] for f in overlap_k2_forms(name, t, gen)):
            row, key = run_k2(form, src, idx, packed, out_ld=out_ld)
            rows.append((row, name, "row_gather", key))
        # the main path: the overlapped plan's pair counted from 0, its twin's
        first = run_pair(sp, t, vals)
        second = run_pair(sp, t, vals)
        ref = run_pair(sp, twin, vals)
        ref_peak = run_pair(sp, twin, vals)["peak_extra_bytes"]  # a replayed pair's
        counts[name] = first["counts"]
        same = lambda a, b: torch.equal(a["space"], b["space"]) and all(
            torch.equal(x, y) for x, y in zip(a["back"], b["back"]))
        rel = lambda a, b: max(
            float((a["space"] - b["space"]).abs().max() / b["space"].abs().max()),
            max(float((x - y).abs().max()) for x, y in zip(a["back"], b["back"]))
            / max(float(y.abs().max()) for y in b["back"]))
        space_h = first["space"].cpu().numpy()
        oracle_err = float(np.abs(space_h - want).max() / np.abs(want).max())
        scale = max(float(v.abs().max()) for v in vals)
        rt_err = max(float((b - v).abs().max()) for b, v in zip(first["back"], vals)) / scale
        bar = DIST_F64_RTOL if dtype == F64 else ORACLE_RTOL["highest"]
        twin_bar = OVERLAP_TWIN_RTOL[np.dtype(dtype).name]
        row = {"phase": "overlap_plan", "plan": name, "engine": t.engine, "dims": list(DIMS),
               "transform": kind, "dtype": np.dtype(dtype).name, "exchange": exchange,
               "overlap_requested": ov, "overlap_chunks": t.overlap_chunks,
               "chunks": [list(c) for c in t._exec._chunks],
               "exchange_rounds": t.exchange_rounds(),
               "transport": t._exec.exchange_transport(), "fused": t.fused,
               "stages_backward": t.describe()["ir"]["stages"]["backward"],
               "bitwise_equal_to_overlap1_twin": same(first, ref),
               "overlap1_twin_rel_err": rel(first, ref), "twin_bar": twin_bar,
               "oracle_rel_err": oracle_err, "roundtrip_rel_err": rt_err, "bar": bar,
               "launches_first_pair": {k: sum(c.values()) for k, c in first["counts"].items()},
               "launches_second_pair": total(second["counts"]),
               "dispatches_second_pair": second["dispatches"],
               "peak_extra_bytes": {"overlapped": second["peak_extra_bytes"],
                                    "overlap1_twin": ref_peak}}
        staged_pair = run_pair(sp, st, vals)
        row["fused_equals_staged"] = same(first, staged_pair)
        row["replay_equals_first"] = same(second, first)
        check(row["fused_equals_staged"], f"{name}: fused and staged results differ")
        check(row["replay_equals_first"], f"{name}: the replayed pair differs from the first")
        if name in OVERLAP_STACKED:
            row["bitwise_equal_to_" + OVERLAP_STACKED[name]] = same(
                first, results[OVERLAP_STACKED[name]])
            check(row["bitwise_equal_to_" + OVERLAP_STACKED[name]],
                  f"{name}: not bitwise the stacked {OVERLAP_STACKED[name]}")
        prof = stream_profile(sp, t, vals)
        row["profile"] = prof
        streams = stream_profile(sp, st, vals)
        row["profile_staged"] = streams
        turns = interleaved_pair_ms(sp, {name: t, "ov1": twin, "staged": st},
                                    {name: vals, "ov1": vals, "staged": vals}, rounds=4, pairs=3)
        busy = profile_pair(sp, "ov1:" + name, twin, vals)
        row.update({"pair_ms_in_turns": turns[name], "overlap1_pair_ms_in_turns": turns["ov1"],
                    "staged_pair_ms_in_turns": turns["staged"],
                    "device_busy_ms": prof["device_busy_ms"],
                    "overlap1_device_busy_ms": busy["device_busy_ms"],
                    "staged_device_busy_ms": streams["device_busy_ms"],
                    "pair_vs_overlap1": turns[name] / turns["ov1"],
                    "pair_vs_staged": turns[name] / turns["staged"],
                    "seconds": time.perf_counter() - t1})
        emit(row)
        check(oracle_err <= bar and rt_err <= bar, f"{name}: oracle {oracle_err}, round trip "
              f"{rt_err} (bar {bar})")
        check(row["overlap1_twin_rel_err"] <= twin_bar,
              f"{name}: {row['overlap1_twin_rel_err']} from its overlap=1 twin")
        check(streams["exchange_kernels_off_k1_streams"] > 0,
              f"{name}: no exchange kernel ran off K1's streams {streams}")
        check(total(second["counts"]) == 0, f"{name}: a replayed pair launched on the host")
        check(second["dispatches"] == {"fused:backward": 1, "fused:forward": 1},
              f"{name}: fused dispatches {second['dispatches']}")
        if over_group:
            check(prof["nccl_kernels"] > 0, f"{name}: no ncclDevKernel in the fused pair's "
                  "profile")
        results[name] = first
        built[name], built[name + "~ov1"], built[name + STAGED] = t, twin, st
        del first, second, ref
    no_rungs("overlap phase", built)
    emit({"phase": "overlap", "seconds": time.perf_counter() - t0})
    return rows, counts


# ---- the obs phase ---------------------------------------------------------------


# the obs phase's overhead modes: which of timing, metrics, tracing are on
OBS_MODES = {"off": (), "timing": ("timing",), "metrics": ("metrics",), "trace": ("trace",),
             "all": ("timing", "metrics", "trace")}


def set_obs(layers) -> None:
    """Exactly ``layers`` of timing, metrics and tracing on."""
    from spfft_tpu_torch import obs, timing

    for layer, module in (("timing", timing), ("metrics", obs), ("trace", obs.trace)):
        (module.enable if layer in layers else module.disable)()


def overhead_phase(sp, plans, values, rounds: int = 6, pairs: int = 10) -> dict:
    """ms per host-facing pair of each plan of ``plans`` (name -> plan: the
    fused plan and its staged twin, whose hooks run once per node) in each
    of ``OBS_MODES`` (all off, each layer alone, all on), taking turns (the
    modes' order reversed every other round), ``pairs`` timed pairs after
    one untimed pair at each turn; medians and quartiles per plan."""
    import torch

    from spfft_tpu_torch import obs

    times = {(n, m): [] for n in plans for m in OBS_MODES}
    for r in range(rounds):
        for mode in (list(OBS_MODES) if r % 2 == 0 else list(reversed(OBS_MODES))):
            set_obs(OBS_MODES[mode])
            for name, t in plans.items():
                for i in range(pairs + 1):
                    t0 = time.perf_counter()
                    t.backward(values)
                    t.forward(scaling=sp.ScalingType.FULL)
                    torch.cuda.synchronize()
                    if i:
                        times[name, mode].append(1e3 * (time.perf_counter() - t0))
            obs.trace.clear()
    set_obs(("metrics",))  # the defaults: metrics on, timing and tracing off
    rows = {}
    for name in plans:
        med = {m: statistics.median(times[name, m]) for m in OBS_MODES}
        rows[name] = {"ms_per_pair": med,
                      "minus_off_ms": {m: v - med["off"] for m, v in med.items()},
                      "min_ms": {m: min(times[name, m]) for m in OBS_MODES},
                      "quartiles_ms": {m: statistics.quantiles(times[name, m], n=4)
                                       for m in OBS_MODES}}
    row = {"phase": "obs_overhead", "pairs_each": rounds * pairs, "plans": rows}
    emit(row)
    return row


def random_pair(t, seed):
    """Random values of plan ``t``'s exact shape on the card, in the layout
    of its device-side entry points."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda n: torch.randn(n, generator=gen, device="cuda", dtype=torch.float64)
    if hasattr(t, "mesh"):
        vals = [torch.complex(rnd(t.num_local_elements(r)), rnd(t.num_local_elements(r)))
                for r in range(t.num_shards)]
        return t._exec.pad_values(vals)
    return t._exec.values_pair(torch.complex(rnd(t.num_local_elements),
                                             rnd(t.num_local_elements)))


def busy_pair_ms(sp, t, pair, attempts: int = 3) -> tuple:
    """Device busy ms (the union of the kernels' intervals) of one
    device-side backward + forward(FULL) pair under torch.profiler, and the
    profiles it took: a profile that records no device kernel at all (seen
    once, on a fused mesh plan's replay) is taken again, up to
    ``attempts`` times; None if none recorded any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t.backward_pair(*pair)
            t.forward_pair(sp.ScalingType.FULL)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in device_kernels(prof))
        if spans:
            return union_us(spans) / 1e3, attempt
    return None, attempts


def stage_profile(sp, name, t) -> dict:
    """One pair of plan ``t``'s staged twin under torch.profiler: each stage
    node runs under ``timing.trace_annotation(<its STAGES label>)``, which
    the profiler also draws as a range on the device's timeline; per stage
    label, the busy time of the kernels inside those ranges. (The CPU
    range's own ``device_time_total`` misses the kernels that the ctypes
    wrappers launch, so the device-side range is what is read.) Where three
    profiles in this process lack stage ranges, the twin is profiled in a
    fresh process (:func:`stage_profile_fresh`): late in the full script the
    profiler lost whole stage ranges on every attempt, as it lost K1/K2
    records in phases 12 and 13."""
    twin = sp.DistributedTransform.from_parameters(
        t.processing_unit, t.params, mesh=t.mesh, exchange_type=t.exchange_type,
        dtype=t.dtype, engine=t.engine, precision=t.precision, fuse=False)
    row = profile_stages(sp, name, twin)
    del twin
    if not row["complete"]:
        lost = row["ranges"]
        row = stage_profile_fresh(name, t)
        row["in_process_ranges"] = lost
    emit(row)
    check(row["complete"], f"{name}: stage ranges {row['ranges']}, want {row['runs']}")
    check(0.5 < row["stages_cover"] <= 1.0 + 1e-9,
          f"{name}: the stage ranges hold {row['stages_cover']} of the busy time")
    return row


def profile_stages(sp, name, twin) -> dict:
    """:func:`stage_profile`'s reading of the staged plan ``twin`` in this
    process: its row, with ``complete`` false where the profile kept lacks
    a stage range or holds one too few or too many times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from spfft_tpu_torch.obs import STAGES

    pair = random_pair(twin, SEED + 7)
    twin.backward_pair(*pair)
    twin.forward_pair(sp.ScalingType.FULL)
    torch.cuda.synchronize()
    stages = twin._exec._ir.describe()["stages"]
    want = set(stages["backward"]) | set(stages["forward"])
    runs = {s: stages["backward"].count(s) + stages["forward"].count(s) for s in want}
    if twin._exec.collective:
        # NCCL's kernels run on its own stream, outside the range the
        # collective's node draws on the compute stream: that range holds
        # no device work, and the collective's time is nccl_ms
        want = {s for s in want if not s.startswith("exchange")}
    # the profiler loses device events at the start of a window (the first
    # stage ranges of the backward missing, or late in a long process whole
    # stages): one pair runs as the schedule's warm-up step, untraced, and the
    # pair after it is the one read; a profile that still lacks a stage range
    # is taken again, up to three times; the check holds the one kept
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for step in range(2):
                twin.backward_pair(*pair)
                twin.forward_pair(sp.ScalingType.FULL)
                torch.cuda.synchronize()
                if step == 0:
                    prof.step()
        kernels = sorted((e.time_range.start, e.time_range.end) for e in device_kernels(prof))
        stage_ms, ranges = {}, {}
        for e in prof.events():
            if e.name in STAGES and e.device_type == DeviceType.CUDA:
                lo, hi = e.time_range.start, e.time_range.end
                inside = [(max(a, lo), min(b, hi)) for a, b in kernels if b > lo and a < hi]
                stage_ms[e.name] = stage_ms.get(e.name, 0.0) + union_us(sorted(inside)) / 1e3
                ranges[e.name] = ranges.get(e.name, 0) + 1
        complete = want <= set(ranges) and all(ranges[s] == runs[s] for s in want)
        if complete:
            break
    busy = union_us(kernels) / 1e3
    return {"phase": "obs_stage_profile", "plan": name + STAGED, "busy_ms": busy,
            "attempts": attempt, "process": os.getpid(), "complete": complete,
            "nccl_ms": sum((e.time_range.end - e.time_range.start) / 1e3
                           for e in device_kernels(prof) if "ncclDevKernel" in e.name),
            "ranges": ranges, "runs": runs, "device_ms_by_stage": stage_ms,
            "stages_cover": sum(stage_ms.values()) / busy if busy else 0.0,
            "stages": sorted(want),
            "exchange_share": sum(v for k, v in stage_ms.items() if k.startswith("exchange"))
            / busy if busy else None}


def stage_profile_fresh(name, t) -> dict:
    """:func:`profile_stages` of ``t``'s staged twin in a fresh process
    (``--stage-profile``): the plan's parameters and options go over in a
    pickle under ``REPORTS``; a plan over a process group gets a one-rank
    NCCL group of its own there."""
    mesh = t.mesh
    spec = {"name": name, "params": t.params, "exchange_type": t.exchange_type,
            "dtype": t.dtype, "engine": t.engine, "precision": t.precision,
            "shape": mesh.shape, "num_shards": mesh.num_shards,
            "group": mesh.group is not None}
    check(mesh.world == 1, f"{name}: a fresh process cannot join a group of {mesh.world}")
    os.makedirs(REPORTS, exist_ok=True)
    path = os.path.join(REPORTS, f"stage-profile-{os.getpid()}.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--stage-profile", path],
                          capture_output=True, text=True, timeout=300)
    os.remove(path)
    check(proc.returncode == 0, f"{name}: the stage-profile process failed: "
          f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def stage_profile_worker(path: str) -> int:
    """``--stage-profile <pickle>``: :func:`stage_profile_fresh`'s process.
    Rebuilds the plan's staged twin on the card from the pickled spec and
    prints :func:`profile_stages`'s row as its last line."""
    import torch

    import spfft_tpu_torch as sp

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(path, "rb") as f:
        spec = pickle.load(f)
    group = None
    if spec["group"]:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        group = sp.init_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    mesh = (sp.make_fft_mesh2(*spec["shape"], group=group) if spec["shape"]
            else sp.make_fft_mesh(spec["num_shards"], group=group))
    twin = sp.DistributedTransform.from_parameters(
        sp.ProcessingUnit.GPU, spec["params"], mesh=mesh, exchange_type=spec["exchange_type"],
        dtype=spec["dtype"], engine=spec["engine"], precision=spec["precision"], fuse=False)
    row = profile_stages(sp, spec["name"], twin)
    del twin
    sp.shutdown_distributed()
    print(json.dumps(row), flush=True)
    return 0


def staging_phase(sp, name, t) -> dict:
    """Host staging at 512^3: a backward whose result goes to the host
    (``space_domain_data()``) against one that stays on the card, and a
    forward from a host array against one from a device tensor; medians of
    three, and the bytes over the difference."""
    import torch

    space_dev = t.backward(t.forward(torch.randn((t.dim_z, t.dim_y, t.dim_x), device="cuda",
                                                 dtype=torch.float32 if t.dtype == np.float32
                                                 else torch.float64), sp.ScalingType.NONE))
    values = t.forward(space_dev, sp.ScalingType.NONE)
    host = t.space_domain_data()
    nbytes = host.nbytes

    def med(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    bwd_dev = med(lambda: t.backward(values))
    bwd_host = med(lambda: (t.backward(values), t.space_domain_data()))
    fwd_dev = med(lambda: t.forward(space_dev, sp.ScalingType.NONE))
    fwd_host = med(lambda: t.forward(host, sp.ScalingType.NONE))
    # the copies alone, one contiguous grid: into fresh pageable memory (as
    # space_domain_data does), into pageable memory touched before, the same
    # in 8 pieces (the JAX package's chunked staging), and pinned memory
    dense = space_dev.contiguous()
    warm = torch.empty(dense.shape, dtype=dense.dtype)
    warm.fill_(0)
    pinned = torch.empty(dense.shape, dtype=dense.dtype, pin_memory=True)
    pieces = [(i, i + -(-dense.shape[0] // 8)) for i in range(0, dense.shape[0],
                                                               -(-dense.shape[0] // 8))]
    raw = {
        "d2h_fresh_pageable": med(lambda: dense.cpu()),
        "d2h_warm_pageable": med(lambda: warm.copy_(dense)),
        "d2h_warm_pageable_8_pieces": med(lambda: [warm[a:b].copy_(dense[a:b])
                                                   for a, b in pieces]),
        "d2h_pinned": med(lambda: pinned.copy_(dense)),
        "h2d_pageable": med(lambda: dense.copy_(warm)),
        "h2d_pinned": med(lambda: dense.copy_(pinned)),
    }
    row = {"phase": "obs_staging", "plan": name, "bytes": nbytes,
           "backward_ms": 1e3 * bwd_dev, "backward_to_host_ms": 1e3 * bwd_host,
           "forward_ms": 1e3 * fwd_dev, "forward_from_host_ms": 1e3 * fwd_host,
           "device_to_host_gb_s": nbytes / max(bwd_host - bwd_dev, 1e-9) / 1e9,
           "host_to_device_gb_s": nbytes / max(fwd_host - fwd_dev, 1e-9) / 1e9,
           "copy_gb_s": {k: dense.numel() * dense.element_size() / v / 1e9
                         for k, v in raw.items()}}
    emit(row)
    return row


def fence_timeout_phase() -> dict:
    """A fence with a 5 ms budget on about a second of queued matrix
    products must raise FenceTimeout; without a budget the same fence
    returns once the work is done."""
    import torch

    from spfft_tpu_torch.sync import FenceTimeout, fence

    a = torch.randn((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    raised, t0 = False, time.perf_counter()
    with knobs({"SPFFT_TPU_FENCE_BUDGET_S": "0.005"}):
        for _ in range(48):
            a = torch.tanh(a @ a)
        try:
            fence(a)
        except FenceTimeout:
            raised = True
    raised_after_ms = 1e3 * (time.perf_counter() - t0)
    fence(a)
    done = torch.cuda.Event()
    done.record()
    row = {"phase": "obs_fence", "raised_fence_timeout": raised,
           "raised_after_ms": raised_after_ms, "unbudgeted_fence_complete": done.query()}
    emit(row)
    check(raised, "a fence with a 5 ms budget did not raise FenceTimeout on a long launch")
    torch.cuda.synchronize()
    return row


def bench_phase(sp) -> tuple:
    """The benchmark program at every configuration of ``BENCH_CONFIGS``
    (module docstring, phase 8). Returns the launch counts, the kernel rows
    and one summary row per configuration."""
    import torch

    from spfft_tpu_torch import obs
    from spfft_tpu_torch.programs import benchmark

    from spfft_tpu_torch.programs import bench

    counts, rows, summary, fit_cases = {}, [], {}, {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    os.makedirs(REPORTS, exist_ok=True)
    # the one-line figure: 256^3 C2C in the 0.659 sphere, float32, the plan
    # of c2c-blocked, timed by obs.perf.measure_pair_seconds
    clear_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        line = bench.main([])
    counts["bench-line"] = launch_counts()
    emit({"phase": "obs_bench_line", "value": line["value"], "unit": line["unit"],
          "vs_baseline": line["vs_baseline"], "platform": line["platform"],
          "seconds_per_pair": line["perf"]["seconds_per_pair"],
          "y_plan": line["plan"]["execution"]["sparse_y"], "launches": {
              k: sum(v.values()) for k, v in counts["bench-line"].items()}})
    check(line["platform"] == "gpu" and obs.perf.validate_perf_report(line["perf"]) == [],
          "bench: not a device line, or its perf report is malformed")
    check(all(sum(v.values()) > 0 for v in counts["bench-line"].values()),
          f"bench: a kernel was not launched: {counts['bench-line']}")
    for name, argv in BENCH_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        clear_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            report, transforms = benchmark.main(
                [*argv, "-p", "gpu", "-o", os.path.join(REPORTS, name + ".json")])
        counts[name] = launch_counts()
        peak = torch.cuda.max_memory_allocated() - before
        seconds = time.perf_counter() - t0
        t = transforms[0]
        res, par = report["results"], report["parameters"]
        card = res["plan"]
        labels, stack = set(), [report["timings"]]
        while stack:
            node = stack.pop()
            labels.add(node["label"])
            stack.extend(node["sub"])
        want = BENCH_LABELS | ({"Execution init"} if card["kind"] == "local" else set())
        perf = obs.perf.perf_report(t, res["wall_s_per_transform_pair"], repeats=par["repeats"])
        bar = BENCH_RTOL[par["precision"]]
        launched = {k: sum(v.values()) for k, v in counts[name].items()}
        pair = random_pair(t, SEED + 9)
        busy, profiles = busy_pair_ms(sp, t, pair)
        row = {"phase": "obs_bench", "config": name, "argv": argv, "seconds": seconds,
               "decomposition": card.get("decomposition"),
               "ms_per_pair": 1e3 * res["wall_s_per_transform_pair"],
               "gflops": res["gflops_per_pair"], "roundtrip_residual": res["roundtrip_residual"],
               "residual_bar": bar, "busy_ms_one_pair": busy, "busy_profiles": profiles,
               "busy_share": (None if busy is None
                              else busy / (1e3 * res["wall_s_per_transform_pair"])),
               "peak_mib": peak / 2**20,
               "engine": card["engine"], "y_plan": card["execution"].get("sparse_y"),
               "num_sticks": card["num_sticks"], "num_elements": card["num_elements"],
               "launches": launched, "perf_exchange_fraction": perf["exchange_fraction"],
               "exchange": card.get("exchange")}
        emit(row)
        summary[name] = row
        check(obs.validate_plan_card(card) == [],
              f"{name}: plan card {obs.validate_plan_card(card)}")
        check(card["degradations"] == [], f"{name}: the plan took a rung: {card['degradations']}")
        pencil = card.get("decomposition") == "pencil2"
        check(card["platform"] == "gpu" and card["engine"] == ("pencil2-mxu" if pencil else "mxu"),
              f"{name}: platform {card['platform']}, engine {card['engine']}")
        check(want <= labels, f"{name}: timing tree lacks {sorted(want - labels)}")
        check(obs.perf.validate_perf_report(perf) == [],
              f"{name}: perf report {obs.perf.validate_perf_report(perf)}")
        check(res["roundtrip_residual"] <= bar,
              f"{name}: round-trip residual {res['roundtrip_residual']} above {bar}")
        # K1 and K2 in every plan, the line FFT where it runs a stage
        fft = line_fft_stages(t._exec) > 0
        check(launched["complex_matmul"] > 0 and launched["row_gather"] > 0
              and (launched["line_fft"] > 0) == fft,
              f"{name}: launches {launched}, line FFT stages {line_fft_stages(t._exec)}")
        # the kernels at this configuration's forms, against their plain versions
        forms = (pencil_k1_forms(name, t) if pencil
                 else dist_k1_forms(name, t, every=True) if card["kind"] == "distributed"
                 else k1_forms(name, t))
        for form, spec, x, w, want_imag, o in forms:
            krow, key = run_k1(form, spec, x, w, want_imag, t.precision, o)
            rows.append((krow, name, "complex_matmul", key))
        k2 = (pencil_k2_forms(name, t, gen) if pencil
              else dist_k2_forms(name, t, gen) if card["kind"] == "distributed"
              else [(f, src, idx, False) for f, src, idx in k2_forms(name, t, gen)])
        for form, src, idx, packed in k2:
            krow, key = run_k2(form, src, idx, packed)
            rows.append((krow, name, "row_gather", key))
        if card["kind"] == "distributed":
            staged = stage_profile(sp, name, t)
            fit_cases[name] = (obs.perf.stage_model(t), staged["device_ms_by_stage"],
                               staged["exchange_share"])
        if name == "bench-512-r2c-16-single":
            staging_phase(sp, name, t)
        del transforms, t, pair, forms, k2
    balance_fit(obs.perf, fit_cases)
    return counts, rows, summary


# the staged twins whose per-stage device ms fit the perf model's balance on the card
FIT_CONFIGS = ("bench-256-c2c-4", "bench-512-r2c-16-single", "bench-512-r2c-16-double")
# the model's exchange share should read within this factor of the measured one
EXCHANGE_BAND = 1.5


def exchange_share(perf, rows, balance) -> float:
    """The model's ``exchange_fraction`` of ``rows`` at ``balance``."""
    return sum(v for k, v in perf.stage_shares(rows, balance).items()
               if k in perf.EXCHANGE_STAGES)


def exchange_band(perf, rows, measured) -> tuple:
    """The balances at which the model's exchange share lies within
    ``EXCHANGE_BAND`` of ``measured`` (the share grows with the balance:
    bisection on its logarithm)."""
    def balance_at(target):
        lo, hi = math.log(1e-3), math.log(1e4)
        for _ in range(100):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if exchange_share(perf, rows, math.exp(mid)) < target else (lo, mid)
        return math.exp((lo + hi) / 2)

    return balance_at(measured / EXCHANGE_BAND), balance_at(measured * EXCHANGE_BAND)


def balance_fit(perf, cases) -> dict:
    """The perf model's balance on the card. ``fit``: the one flop/byte
    balance that best matches the staged twins' per-stage device ms at
    ``FIT_CONFIGS`` (``perf.fit_flop_per_byte``); ``band``: the balances at
    which the model's exchange share reads within ``EXCHANGE_BAND`` of the
    measured one on every configuration of ``FIT_CONFIGS``; ``chosen``: the
    fit, or where it lies outside the band the band's nearest end (the
    per-stage error grows away from the fit: the best fit inside the band),
    the value for ``perf.CUDA_FLOP_PER_BYTE``. Per mesh configuration the
    measured exchange share (the exchange ranges' device ms over the busy
    ms) beside the model's ``exchange_fraction`` (as ``perf_report`` and
    dbench give it) at the JAX default, the fit, the chosen value and
    ``perf.CUDA_FLOP_PER_BYTE``."""
    fitted = [n for n in FIT_CONFIGS if n in cases]
    fit = perf.fit_flop_per_byte([cases[n][:2] for n in fitted])
    bands = [exchange_band(perf, cases[n][0], cases[n][2]) for n in fitted]
    lo, hi = max(b[0] for b in bands), min(b[1] for b in bands)
    chosen = min(max(fit["flop_per_byte"], lo), hi) if lo <= hi else fit["flop_per_byte"]
    balances = {"jax_default": perf.DEFAULT_FLOP_PER_BYTE, "fit": fit["flop_per_byte"],
                "chosen": chosen, "constant": perf.CUDA_FLOP_PER_BYTE}

    row = {"phase": "balance_fit", "fit_configs": fitted, **fit, "band": [lo, hi],
           "band_exists": lo <= hi, "chosen": chosen,
           "chosen_residual": perf.share_error([cases[n][:2] for n in fitted], chosen),
           **{f"{k}_flop_per_byte": v for k, v in balances.items()}, "configs": {}}
    for name, (rows, ms, measured) in cases.items():
        model = {k: exchange_share(perf, rows, b) for k, b in balances.items()}
        row["configs"][name] = {
            "measured_exchange_share": measured, "exchange_fraction": model,
            "over_measured": {k: v / measured for k, v in model.items()},
            "model_rows": rows, "device_ms_by_stage": ms}
    emit(row)
    return row



# ---- the faults and verify phase -------------------------------------------------

# the rung counters that an unarmed run must leave at 0
RUNG_COUNTERS = ("engine_fallbacks_total", "degradations_total", "execution_failures_total")
# the plan variants whose pair times the phase compares, taking turns
VARIANTS = {"off": {}, "guard": {"guard": True}, "verify": {"verify": "on"},
            "both": {"guard": True, "verify": "on"}}
# the phase's 256^3 plans: (name, transform); the local ones as PLANS makes
# them (fused, "highest", blocked), the mesh ones as DIST_PLANS and PENCIL_PLANS
FAULT_PLANS = [("c2c-blocked", "c2c"), ("r2c-blocked", "r2c"), ("dist4-c2c", "c2c"),
               ("pencil2x2-c2c", "c2c")]
FAULT_BENCH = "bench-512-r2c-16-single"


def rung_counters() -> dict:
    from spfft_tpu_torch import obs

    return {k: v for k, v in obs.snapshot()["counters"].items() if k.startswith(RUNG_COUNTERS)}


def no_rungs(where, plans, before=None) -> None:
    """Fails if a plan of an unarmed phase took a rung of the degradation
    ladder: its card's ``degradations`` must be empty and the rung counters
    of the metrics registry 0 (or, given ``before``, unchanged since)."""
    took = {name: rungs for name, rungs in ((n, t.report()["degradations"])
                                            for n, t in plans.items()) if rungs}
    before = before or {}
    counters = {k: v - before.get(k, 0) for k, v in rung_counters().items()
                if v != before.get(k, 0)}
    emit({"phase": "no_rungs", "where": where, "plans": len(plans), "degradations": took,
          "rung_counters": counters})
    check(not took and not counters, f"{where}: a plan took a rung: {took} {counters}")


def as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def same(a, b) -> bool:
    """Bitwise equal results (a tensor, or a per-shard list of them)."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(as_list(a), as_list(b)))


def busy_ms(fn) -> tuple:
    """Device busy ms (the union of the kernels' intervals) of ``fn()``
    under torch.profiler, and its kernels by device ms, the most first
    (``[name, ms, count]``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name[:90], (0.0, 0))
        by_name[e.name[:90]] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    return (union_us(sorted((e.time_range.start, e.time_range.end) for e in kernels)) / 1e3,
            [[k, ms, n] for k, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])])


def fault_maker(sp, name, kind, triplets, vals):
    """A maker of the phase's plan ``name`` (keyword arguments: guard=,
    verify=, fuse=, ...) and its values on the card."""
    import torch

    ttype = getattr(sp.TransformType, kind.upper())
    if name.startswith(("dist4", "pencil")):
        pencil = name.startswith("pencil")
        per = (sp.distribute_triplets(triplets, 4, DIMS[1], layout=(2, 2), dim_x=DIMS[0])
               if pencil else sp.distribute_triplets(triplets, 4, DIMS[1]))
        values = [torch.as_tensor(vals[i].astype(np.complex64), device="cuda")
                  for i in shard_index(triplets, per)]

        def make(**kw):
            mesh = sp.make_fft_mesh2(2, 2) if pencil else sp.make_fft_mesh(4)
            return sp.DistributedTransform(sp.ProcessingUnit.GPU, ttype, *DIMS, per, mesh=mesh,
                                           dtype=F32, **kw)
        return make, values, per
    values = torch.as_tensor(vals.astype(np.complex64), device="cuda")

    def make(**kw):
        return sp.Transform(sp.ProcessingUnit.GPU, ttype, *DIMS, indices=triplets, dtype=F32,
                            precision="highest", **kw)
    return make, values, None


def verify_rows(sp, t, values):
    """One verified pair with the flight recorder on: its results and the
    ``verify`` events (the verdict rows, with ``rel``)."""
    import torch
    from spfft_tpu_torch import obs

    obs.trace.enable()
    obs.trace.clear()
    space = t.backward(values)
    back = t.forward(scaling=sp.ScalingType.FULL)
    torch.cuda.synchronize()
    rows = [{k: e["args"].get(k) for k in ("direction", "check", "verdict", "rel")}
            for e in obs.trace.snapshot()["events"] if e["name"] == "verify"]
    obs.trace.disable()
    return space, back, rows


def event_ms(fn, runs: int = 3) -> float:
    """The least of ``runs`` CUDA-event timings of ``fn()`` (the device's
    clock from the first launch to the end of the last)."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def checks_alone_ms(sp, t, values, space):
    """The verify checks of one pair alone (on the pair's results, the
    plan's geometry) and guard's scans of its output: ms on CUDA events,
    and the checks' busy ms and kernels under the profiler."""
    from spfft_tpu_torch import faults, verify
    from spfft_tpu_torch.verify.supervisor import flat_values

    v = t._verifier
    flat = flat_values(values)
    back = t.forward(scaling=sp.ScalingType.FULL)
    fwd_space = t._device_space(None)
    kw = dict(triplets=v.geometry(), transform_type=t.transform_type, rtol=v.rtol)

    def run():
        verify.run_checks(direction="backward", freq=flat, space=space, **kw)
        verify.run_checks(direction="forward", freq=flat_values(back), space=fwd_space,
                          scale=1.0 / t.global_size, **kw)

    scans = lambda: (faults.check_array(space, check="x", platform="gpu"),
                     faults.check_array(back, check="x", platform="gpu"))
    busy, top = busy_ms(run)
    # and CUDA events around the calls (the least of three: the device's clock,
    # host gaps included), as the profiler's device events can miss kernels
    return event_ms(run), busy, top[:10], event_ms(scans)


def costs(sp, name, variants, values, rounds, pairs) -> dict:
    """The variants' pair ms taking turns (the least and the median of the
    timed pairs), their device busy ms of one pair, and the checks' and
    guard's own device ms."""
    raw = {}
    interleaved_pair_ms(sp, {f"{name}/{v}": t for v, t in variants.items()},
                        {f"{name}/{v}": values for v in variants}, rounds=rounds, pairs=pairs,
                        raw=raw)
    profiled = {v: busy_ms(lambda t=variants[v]: (
        t.backward(values), t.forward(scaling=sp.ScalingType.FULL))) for v in ("off", "both")}
    busy = {v: ms for v, (ms, _) in profiled.items()}
    # what the verified pair ran beyond the plain one, kernel by kernel
    off_ms = {k: ms for k, ms, _ in profiled["off"][1]}
    extra = sorted(([k, ms - off_ms.get(k, 0.0), n] for k, ms, n in profiled["both"][1]),
                   key=lambda row: -row[1])[:12]
    both = variants["both"]
    space = both.backward(values)
    checks_ms, checks_busy, top, guard_ms = checks_alone_ms(sp, both, values, space)
    least = {v: min(raw[f"{name}/{v}"]) for v in variants}
    return {"pair_ms_min": least,
            "pair_ms_median": {v: statistics.median(raw[f"{name}/{v}"]) for v in variants},
            "over_off_ms_min": {v: least[v] - least["off"] for v in variants},
            "pairs_each": rounds * pairs, "device_busy_ms": busy,
            "both_over_off_kernels": extra,
            "checks_event_ms": checks_ms, "checks_busy_ms": checks_busy, "checks_kernels": top,
            "guard_scans_event_ms": guard_ms}


def clean_config(sp, name, make, values):
    """One configuration unarmed: the four variants (and the off and both
    staged twins), bitwise equal results, equal K1/K2 launch counts of the
    twins, every verdict a pass, no rung taken. Returns the variants, the
    off plan's results and the row."""
    variants = {v: make(**kw) for v, kw in VARIANTS.items()}
    twins = {v: make(fuse=False, **VARIANTS[v]) for v in ("off", "both")}
    off = variants["off"]
    space_off = off.backward(values)
    back_off = off.forward(scaling=sp.ScalingType.FULL)
    space_on, back_on, rows = verify_rows(sp, variants["both"], values)
    launches = {}
    for v, tw in twins.items():
        clear_counts()
        tw.backward(values)
        tw.forward(scaling=sp.ScalingType.FULL)
        launches[v] = launch_counts()
    k1, k2 = (sum(launches["off"][k].values()) for k in ("complex_matmul", "row_gather"))
    row = {"phase": "faults_clean", "plan": name, "engine": off.engine,
           "bitwise_equal": same(space_on, space_off) and same(back_on, back_off),
           "verdicts": rows, "twin_launches": {"complex_matmul": k1, "row_gather": k2},
           "twin_launches_equal": launches["off"] == launches["both"],
           "verification": variants["both"].report()["verification"]}
    emit(row)
    check(row["bitwise_equal"], f"{name}: guard and verify changed the results")
    check(row["twin_launches_equal"] and k1 > 0 and k2 > 0,
          f"{name}: the staged twins' launches differ or miss a kernel: {launches}")
    check(rows and all(r["verdict"] == "pass" for r in rows), f"{name}: verdicts {rows}")
    no_rungs(f"faults_clean {name}", {**variants, **{f"{v}{STAGED}": t for v, t in twins.items()}})
    return variants, (space_off, back_off), row


def armed(sp, fn):
    """Run ``fn`` in its own scope; returns (the typed error's class name or
    None, ``fn``'s result), the breaker reset after."""
    from spfft_tpu_torch import verify

    try:
        return None, fn()
    except sp.GenericError as e:
        return type(e).__name__, None
    finally:
        verify.breaker.reset()


def armed_faults(sp, make, variants, values, want, results, dist_make):
    """Each armed fault in its own scope, on ``c2c-blocked`` (its variants
    of the unarmed runs, and plans made here; ``exchange.build`` on
    ``dist4-c2c``): each must give the JAX package's outcome (module
    docstring, phase 9)."""
    import torch
    from spfft_tpu_torch import faults, obs
    from spfft_tpu_torch.execution import LocalExecution
    from spfft_tpu_torch.execution_mxu import MxuLocalExecution

    bar = ORACLE_RTOL["highest"]
    vals_h = values.cpu().numpy()
    err_of = lambda space, back: (
        float(np.abs(space.cpu().numpy() - want).max() / np.abs(want).max()),
        float(np.abs(back.cpu().numpy() - vals_h).max() / np.abs(vals_h).max()))
    out = {}

    # engine.execute=corrupt under verify: the reference rung (cuFFT) recovers
    t = variants["verify"]
    with faults.inject("engine.execute=corrupt"):
        holder = {}
        ms, kernels = busy_ms(lambda: holder.update(
            space=t.backward(values), back=t.forward(scaling=sp.ScalingType.FULL)))
    errs = err_of(holder["space"], holder["back"])
    fft_kernels = sum(n for k, _, n in kernels if "fft" in k.lower())
    ref = t._reference_exec
    out["corrupt_verify"] = {"oracle_rel_err": errs[0], "roundtrip_rel_err": errs[1],
                             "degradations": [d["event"] for d in t.report()["degradations"]],
                             "reference": type(ref).__name__,
                             "reference_device": str(ref.device),
                             "reference_programs_run": len(ref._ir._compiled),
                             "cufft_kernels": fft_kernels, "busy_ms": ms}
    # the reference's own programs ran on the card (its engine is torch.fft,
    # i.e. cuFFT there); the profile's cuFFT kernels are reported beside
    check(max(errs) <= bar and out["corrupt_verify"]["degradations"] == ["verify_demoted"] * 2
          and isinstance(ref, LocalExecution) and ref.device.type == "cuda"
          and len(ref._ir._compiled) == 2,
          f"engine.execute=corrupt under verify: {out['corrupt_verify']}")

    # engine.execute=nan under guard: a typed error
    g = variants["guard"]
    with faults.inject("engine.execute=nan"):
        out["nan_guard"], _ = armed(sp, lambda: g.backward(values))
    check(out["nan_guard"] == "GPUFFTError", f"engine.execute=nan under guard: {out['nan_guard']}")

    # strict: VerificationError at the first failed check
    strict = make(verify="strict")
    with faults.inject("engine.execute=corrupt"):
        out["strict"], _ = armed(sp, lambda: strict.backward(values))
    check(out["strict"] == "VerificationError", f"strict: {out['strict']}")

    # the breaker at K = 2: the third call finds it open and skips the engine
    def breaker_calls():
        states = []
        for _ in range(3):
            t.backward(values)
            states.append(t.report()["verification"]["breaker"]["state"])
        return states

    with knobs({"SPFFT_TPU_VERIFY_BREAKER_K": "2"}), faults.inject("engine.execute=corrupt"):
        _, states = armed(sp, breaker_calls)
    events = [d["event"] for d in t.report()["degradations"]]
    out["breaker"] = {"states": states, "breaker_open": events.count("verify_breaker_open")}
    check(states == ["closed", "open", "open"] and "verify_breaker_open" in events,
          f"breaker: {out['breaker']}")

    # engine.compile=raise: the torch.fft engine, recorded
    with faults.inject("engine.compile=raise"):
        fb = make()
    space, back = fb.backward(values), fb.forward(scaling=sp.ScalingType.FULL)
    out["engine_compile"] = {"engine": fb.engine, "degradations": fb.report()["degradations"],
                             "oracle_rel_err": err_of(space, back)[0]}
    check(fb.engine == "xla" and [d["event"] for d in fb.report()["degradations"]] == [
        "engine_fallback"] and max(err_of(space, back)) <= bar,
          f"engine.compile=raise: {out['engine_compile']}")

    # ir.compile=raise: the staged path, bitwise the fused plan's, K1 and K2 launched
    with faults.inject("ir.compile=raise"):
        st = make()
    clear_counts()
    space, back = st.backward(values), st.forward(scaling=sp.ScalingType.FULL)
    counts = launch_counts()
    out["ir_compile"] = {"path": st.describe()["ir"]["path"],
                         "bitwise_fused": same(space, results[0]) and same(back, results[1]),
                         "launches": {k: sum(v.values()) for k, v in counts.items()}}
    check(out["ir_compile"]["path"] == "staged" and out["ir_compile"]["bitwise_fused"]
          and all(n > 0 for n in out["ir_compile"]["launches"].values()),
          f"ir.compile=raise: {out['ir_compile']}")

    # sync.fence=raise: a typed error
    with faults.inject("sync.fence=raise"):
        out["sync_fence"], _ = armed(sp, lambda: st.backward(values))
    check(out["sync_fence"] == "GPUFFTError", f"sync.fence=raise: {out['sync_fence']}")

    # exchange.build=raise on dist4-c2c: the mxu engine falls back, the
    # torch.fft engine fails too, MPIError (the JAX package's outcome)
    before = obs.snapshot()["counters"].get('engine_fallbacks_total{from="mxu",to="xla"}', 0)
    with faults.inject("exchange.build=raise"):
        out["exchange_build"], _ = armed(sp, dist_make)
    fell = obs.snapshot()["counters"].get('engine_fallbacks_total{from="mxu",to="xla"}', 0)
    check(out["exchange_build"] == "MPIError" and fell == before + 1,
          f"exchange.build=raise: {out['exchange_build']}, fallbacks {fell - before}")

    # a real capture failure at the first dispatch: a stage that waits for the
    # device while the stream is captured; the plan takes fuse_compile_failed
    # and runs staged, bitwise the fused plan's results
    real = MxuLocalExecution._st_z_backward

    def refuses_capture(self, *args):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()  # not permitted while capturing
        return real(self, *args)

    MxuLocalExecution._st_z_backward = refuses_capture
    try:
        cf = make()
    finally:
        MxuLocalExecution._st_z_backward = real
    clear_counts()
    space, back = cf.backward(values), cf.forward(scaling=sp.ScalingType.FULL)
    counts = launch_counts()
    entries = cf.report()["degradations"]
    out["capture_failure"] = {"path": cf.describe()["ir"]["path"],
                              "degradations": entries,
                              "bitwise_fused": same(space, results[0]) and same(back, results[1]),
                              "launches": {k: sum(v.values()) for k, v in counts.items()}}
    check(out["capture_failure"]["path"] == "staged"
          and [d["event"] for d in entries] == ["fuse_compile_failed"]
          and out["capture_failure"]["bitwise_fused"]
          and all(n > 0 for n in out["capture_failure"]["launches"].values()),
          f"a real capture failure: {out['capture_failure']}")
    return out


def faults_phase(sp, data) -> None:
    """Phase 9 (module docstring): guard and verify on the main path's plans
    and the 512^3 benchmark plan, unarmed (bitwise, launches, verdicts, no
    rung, costs), then each armed fault in its own scope."""
    import torch
    from spfft_tpu_torch import faults, verify
    from spfft_tpu_torch.programs import benchmark

    t0 = time.perf_counter()
    kept = {}
    for name, kind in FAULT_PLANS:
        t1 = time.perf_counter()
        triplets, vals, _ = data[kind, 0.659]
        make, values, _ = fault_maker(sp, name, kind, triplets, vals)
        variants, results, row = clean_config(sp, name, make, values)
        row = {"phase": "faults_costs", "plan": name,
               **costs(sp, name, variants, values, rounds=4, pairs=4),
               "seconds": time.perf_counter() - t1}
        emit(row)
        kept[name] = (make, variants if name == "c2c-blocked" else None, values, results)
        del variants
    make, variants, values, results = kept["c2c-blocked"]
    t1 = time.perf_counter()
    out = armed_faults(sp, make, variants, values, data["c2c", 0.659][2], results,
                       kept["dist4-c2c"][0])
    out["seconds"] = time.perf_counter() - t1
    faults.disarm()
    verify.breaker.reset()
    emit({"phase": "faults_armed", **out})
    del kept, make, variants, values, results
    gc.collect()
    torch.cuda.empty_cache()

    # the 512^3 R2C benchmark configuration, its plan as the benchmark program makes it
    t1 = time.perf_counter()
    before = rung_counters()
    argv = dict(BENCH_CONFIGS)[FAULT_BENCH]
    args = benchmark.parse_args([*argv, "-p", "gpu", "-o", os.devnull])
    triplets = sp.create_spherical_cutoff_triplets(
        *args.d, sp.spherical_radius_for_fraction(args.s), hermitian_symmetry=True)
    per = [np.asarray(t) for t in sp.distribute_triplets(triplets, args.shards, args.d[1])]
    exchange = sp.ExchangeType[benchmark.EXCHANGE_NAMES[args.e]]
    make = lambda **kw: sp.DistributedTransform(
        sp.ProcessingUnit.GPU, sp.TransformType.R2C, *args.d, per,
        mesh=sp.make_fft_mesh(args.shards), exchange_type=exchange, dtype=F32, **kw)
    variants = {v: make(**kw) for v, kw in VARIANTS.items()}
    field = torch.randn(args.d[::-1], generator=torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")
    values = variants["off"].forward(field)  # hermitian-consistent values
    space_off = variants["off"].backward(values)
    back_off = variants["off"].forward(scaling=sp.ScalingType.FULL)
    space_on, back_on, rows = verify_rows(sp, variants["both"], values)
    row = {"phase": "faults_clean", "plan": FAULT_BENCH, "engine": variants["off"].engine,
           "bitwise_equal": same(space_on, space_off) and same(back_on, back_off),
           "verdicts": rows}
    emit(row)
    check(row["bitwise_equal"], f"{FAULT_BENCH}: guard and verify changed the results")
    check(rows and all(r["verdict"] == "pass" for r in rows), f"{FAULT_BENCH}: verdicts {rows}")
    no_rungs(f"faults_clean {FAULT_BENCH}", variants, before)
    emit({"phase": "faults_costs", "plan": FAULT_BENCH,
          **costs(sp, FAULT_BENCH, variants, values, rounds=2, pairs=3),
          "seconds": time.perf_counter() - t1})
    del variants, values, field, space_off, back_off, space_on, back_on
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "faults", "seconds": time.perf_counter() - t0})


# ---- the tuning and scheduling phase ---------------------------------------------

# the tuned local plans: (name, transform); the tuned and legacy mesh plans:
# (name, mesh shape); the gbench workload (mixed geometries on the card)
TUNE_PLANS = [("c2c-blocked", "c2c"), ("r2c-blocked", "r2c")]
# (name, mesh shape, overlap: the count pinned, or None for the tuner's)
TUNE_MESHES = [("dist4-c2c", (4,), 1), ("pencil2x2-c2c", (2, 2), 1),
               ("dist4-c2c-ovtuned", (4,), None)]
GBENCH_ARGS = ["--dims", "128", "192", "--sparsity", "0.659", "0.5", "--tasks", "6",
               "--chain", "1", "--repeats", "3", "--dtype", "float32"]
# a legacy plan against its staged twin: the same kernels in the same order,
# so the difference is zero or rounding
LEGACY_RTOL = 1e-6
# the candidates of a local tuned plan that run K1, and the knobs they set
MXU_CANDIDATES = {"mxu": {}, "mxu/dense-y": {"SPFFT_TPU_SPARSE_Y": "0",
                                              "SPFFT_TPU_SPARSE_Y_BLOCKS": "0"},
                  "mxu/bf16-twiddle": {"SPFFT_TPU_TWIDDLE_BF16": "1"}}


def trials_run(sp) -> int:
    return sum(v for k, v in sp.obs.snapshot()["counters"].items()
               if k.startswith("tuning_trials_total"))


def add_counts(a, b) -> dict:
    return {k: {key: a[k].get(key, 0) + b[k].get(key, 0) for key in {*a[k], *b[k]}}
            for k in a}


def trial_table(rec) -> list:
    return [{k: row[k] for k in ("label", "ms", "error", "model_cost_bytes") if k in row}
            for row in rec["trials"]]


def local_form_rows(sp, name, t, gen) -> list:
    """(row, kernel, key) of every K1 and K2 form ``t`` launches."""
    out = []
    for form, spec, x, w, want_imag, o in k1_forms(name, t):
        row, key = run_k1(form, spec, x, w, want_imag, t._exec.k1_precision, o)
        out.append((row, "complex_matmul", key))
    for form, src, idx in k2_forms(name, t, gen):
        row, key = run_k2(form, src, idx)
        out.append((row, "row_gather", key))
    return out


def mesh_form_rows(name, t, gen) -> list:
    pencil = t.engine.startswith("pencil2")
    out = []
    if t.engine in ("mxu", "pencil2-mxu"):
        for form, spec, x, w, want_imag, o in (pencil_k1_forms if pencil else dist_k1_forms)(
                name, t):
            row, key = run_k1(form, spec, x, w, want_imag, t._exec.k1_precision, o)
            out.append((row, "complex_matmul", key))
    for form, src, idx, packed in (pencil_k2_forms if pencil else dist_k2_forms)(name, t, gen):
        row, key = run_k2(form, src, idx, packed)
        out.append((row, "row_gather", key))
    return out


def mesh_maker(sp, name, shape, triplets, vals_global):
    """The make function of a 4-shard C2C mesh plan (slab or 2 x 2 pencil) and
    its per-shard values on the card."""
    import torch

    X, Y = DIMS[0], DIMS[1]
    if len(shape) == 1:
        per, mesh = sp.distribute_triplets(triplets, 4, Y), sp.make_fft_mesh(4)
    else:
        per = sp.distribute_triplets(triplets, 4, Y, layout=shape, dim_x=X)
        mesh = sp.make_fft_mesh2(*shape)
    vals = [torch.as_tensor(vals_global[i].astype(np.complex64), device="cuda")
            for i in shard_index(triplets, per)]
    make = lambda **kw: sp.DistributedTransform(sp.ProcessingUnit.GPU, sp.TransformType.C2C,
                                                *DIMS, per, mesh=mesh, dtype=F32, **kw)
    return make, vals


def oracle_errs(space, back, values, want) -> tuple:
    """(backward against the dense oracle, round trip), relative."""
    import torch

    space_h = space.cpu().numpy()
    check(space_h.shape == want.shape and np.isfinite(space_h).all(), "space shape/finite")
    oracle_err = float(np.abs(space_h - want).max() / np.abs(want).max())
    pairs = list(zip(back, values)) if isinstance(back, list) else [(back, values)]
    check(all(bool(torch.isfinite(b).all()) for b, _ in pairs), "values finite")
    scale = max(float(v.abs().max()) for _, v in pairs)
    return oracle_err, max(float((b - v).abs().max()) for b, v in pairs) / scale


def tuning_phase(sp, data) -> tuple:
    """Phase 10 (module docstring): the tuned policy on the main path's local
    and mesh plans with a fresh wisdom file (each trial table; the chosen
    plan against the oracle; a second construction a wisdom hit with no
    trial), the scheduler's gbench graph, the empty plan on cuFFT and the
    mesh plans' legacy path. Returns its kernel rows (row, plan, kernel,
    key) and the launch counts of each plan's run, counted from 0 before
    its tuning (trials included) and read after its pair."""
    import torch
    from spfft_tpu_torch import faults
    from spfft_tpu_torch.programs import gbench

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows, counts = [], {}
    os.makedirs(REPORTS, exist_ok=True)
    wisdom = os.path.abspath(os.path.join(REPORTS, f"wisdom-{os.getpid()}.json"))
    if os.path.exists(wisdom):
        os.remove(wisdom)
    bar = ORACLE_RTOL["highest"]
    before = rung_counters()
    tuned = {}
    with knobs({"SPFFT_TPU_WISDOM": wisdom}):
        # local plans: the engine axis
        for name, kind in TUNE_PLANS:
            t1 = time.perf_counter()
            triplets, vals, want = data[kind, 0.659]
            make = lambda: sp.Transform(sp.ProcessingUnit.GPU, getattr(sp.TransformType,
                                                                       kind.upper()),
                                        *DIMS, indices=triplets, dtype=F32, policy="tuned")
            values_dev = torch.as_tensor(vals.astype(np.complex64), device="cuda")
            clear_counts()
            t = make()
            tuned_counts = launch_counts()
            pair = run_pair(sp, t, values_dev)
            label = f"tuned:{name}"
            counts[label] = add_counts(tuned_counts, pair["counts"])
            oracle_err, rt_err = oracle_errs(pair["space"], pair["back"], values_dev, want)
            ran = trials_run(sp)
            again = make()
            rec = t.report()["tuning"]
            # a plan with bfloat16 DFT matrices (its record and card name the
            # K1 form) is held to the one-bf16-pass bar, and says so in its row
            k1_form = t.report()["execution"].get("k1_form")
            check(rec.get("k1_form") == k1_form, f"{label}: record {rec.get('k1_form')} "
                  f"against card {k1_form}")
            bar = ORACLE_RTOL["default" if k1_form == "highest-bf16" else "highest"]
            row = {"phase": "tune", "plan": name, "engine": t.engine, "fused": t.fused,
                   "choice": rec["choice"], "k1_form": k1_form,
                   "provenance": rec["provenance"], "hit": rec["hit"],
                   "trials": trial_table(rec), "oracle_rel_err": oracle_err,
                   "roundtrip_rel_err": rt_err, "bar": bar,
                   "second": {"hit": again._tuning["hit"], "engine": again.engine,
                              "trials_run": trials_run(sp) - ran},
                   "seconds": time.perf_counter() - t1}
            emit(row)
            check(rec["provenance"] == "wisdom" and not rec["hit"]
                  and all("ms" in r for r in rec["trials"]), f"{label}: trials {rec}")
            check(oracle_err <= bar and rt_err <= bar, f"{label}: {oracle_err}, {rt_err}")
            check(row["second"] == {"hit": True, "engine": t.engine, "trials_run": 0},
                  f"{label}: second construction {row['second']}")
            # the forms the mxu candidates ran in their trials
            for cand, env in MXU_CANDIDATES.items():
                with knobs(env):
                    ref = sp.Transform(sp.ProcessingUnit.GPU, getattr(sp.TransformType,
                                                                      kind.upper()),
                                       *DIMS, indices=triplets, dtype=F32, engine="mxu")
                rows += [(r, label, k, key) for r, k, key in
                         local_form_rows(sp, f"{label}/{cand}", ref, gen)]
            tuned[label], tuned[label + "/again"] = t, again
            del pair, ref
        # mesh plans: the exchange discipline
        bar = ORACLE_RTOL["highest"]
        triplets, vals_global, want = data["c2c", 0.659]
        for name, shape, overlap in TUNE_MESHES:
            t1 = time.perf_counter()
            make, vals = mesh_maker(sp, name, shape, triplets, vals_global)
            clear_counts()
            t = make(policy="tuned", overlap=overlap)
            tuned_counts = launch_counts()
            pair = run_pair(sp, t, vals)
            label = f"tuned:{name}"
            counts[label] = add_counts(tuned_counts, pair["counts"])
            oracle_err, rt_err = oracle_errs(pair["space"], pair["back"], vals, want)
            ran = trials_run(sp)
            again = make(policy="tuned", overlap=overlap)
            rec = t.report()["tuning"]
            row = {"phase": "tune", "plan": name, "engine": t.engine,
                   "exchange": t.exchange_type.name, "overlap_pinned": overlap,
                   "overlap_chunks": t.overlap_chunks, "choice": rec["choice"],
                   "provenance": rec["provenance"], "hit": rec["hit"],
                   "trials": trial_table(rec), "oracle_rel_err": oracle_err,
                   "roundtrip_rel_err": rt_err, "bar": bar,
                   "second": {"hit": again._tuning["hit"],
                              "exchange": again.exchange_type.name,
                              "trials_run": trials_run(sp) - ran},
                   "seconds": time.perf_counter() - t1}
            if overlap is None:
                # the tuner owns the chunk count: which BUFFERED variant won
                ms = {r["label"]: r.get("ms") for r in rec["trials"]}
                row["overlap_trials_ms"] = {k: v for k, v in ms.items() if k.startswith("BUFFERED")}
                row["won"] = rec["trials"][0]["label"]
                row["overlap_won"] = min((k for k in ms if "/ov" in k and ms[k] is not None),
                                         key=lambda k: ms[k], default=None)
            emit(row)
            want_labels = {"BUFFERED", "COMPACT_BUFFERED", "UNBUFFERED"} | (
                {"BUFFERED/ov2", "BUFFERED/ov4"} if overlap is None else set())
            check(rec["provenance"] == "wisdom"
                  and {r["label"] for r in rec["trials"]} == want_labels
                  and all("ms" in r for r in rec["trials"]), f"{label}: trials {rec}")
            check(t.overlap_chunks == int(rec["choice"]["overlap"]),
                  f"{label}: {t.overlap_chunks} chunks, chose {rec['choice']}")
            check(oracle_err <= bar and rt_err <= bar, f"{label}: {oracle_err}, {rt_err}")
            check(row["second"] == {"hit": True, "exchange": t.exchange_type.name,
                                    "trials_run": 0}, f"{label}: second {row['second']}")
            rows += [(r, label, k, key) for r, k, key in mesh_form_rows(label, t, gen)]
            tuned[label], tuned[label + "/again"] = t, again
            del pair
        no_rungs("tuned plans", tuned, before)
        del tuned
    os.remove(wisdom)

    # the scheduler: the gbench graph, each task bitwise its solo plan's
    t1 = time.perf_counter()
    clear_counts()
    doc, serial_results, graph = gbench.main(GBENCH_ARGS)
    gcounts = launch_counts()
    equal_tasks = {tid: same(graph.task(tid).result, res) for tid, res in serial_results.items()}
    serial_row, sched_row = doc["rows"]
    emit({"phase": "gbench", "args": GBENCH_ARGS, "rows": doc["rows"],
          "placement": doc["placement"], "metrics": doc["metrics"],
          "tasks_bitwise_solo": sum(equal_tasks.values()), "tasks": len(equal_tasks),
          "serial_transforms_per_sec": serial_row["transforms_per_sec"],
          "sched_transforms_per_sec": sched_row["transforms_per_sec"],
          "sched_vs_serial": sched_row["overlap_vs_serial"],
          "seconds": time.perf_counter() - t1})
    check(all(equal_tasks.values()), f"gbench: tasks differ from their solo plans: "
          f"{[k for k, v in equal_tasks.items() if not v]}")
    seen = set()
    for task in graph:
        if id(task.plan) in seen:
            continue
        seen.add(id(task.plan))
        label = f"gbench:{task.plan.dim_x}"
        counts[label] = gcounts
        rows += [(r, label, k, key) for r, k, key in local_form_rows(sp, label, task.plan, gen)]
    del graph, serial_results

    # the empty plan on the torch.fft engine (cuFFT): JAX's zero grid and (0,) values
    for kind in ("c2c", "r2c"):
        e = sp.Transform(sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()),
                         64, 64, 64, num_local_elements=0, indices=np.zeros((0, 3), np.int32),
                         engine="xla", dtype=F32)
        space = e.backward(np.zeros(0, np.complex64))
        back = e.forward(space, sp.ScalingType.FULL)
        again = e.backward(np.zeros(0, np.complex64))  # the fused plan's replay
        ok = (tuple(space.shape) == (64, 64, 64) and not bool(space.abs().any())
              and tuple(back.shape) == (0,) and torch.equal(again, space))
        emit({"phase": "empty_plan", "transform": kind, "engine": e.engine, "fused": e.fused,
              "space_shape": list(space.shape), "space_dtype": str(space.dtype),
              "values_shape": list(back.shape), "ok": ok})
        check(ok, f"the empty {kind} plan on cuFFT")

    # the mesh plans' legacy path (ir_lower_failed), against the staged twin
    for name, shape, overlap in TUNE_MESHES:
        if overlap is None:  # the legacy path of dist4-c2c's geometry is held once
            continue
        make, vals = mesh_maker(sp, name, shape, triplets, vals_global)
        with faults.inject("ir.lower=raise"):
            leg = make()
        twin = make(fuse=False)
        staged = run_pair(sp, twin, vals)
        got = run_pair(sp, leg, vals)
        scale = float(staged["space"].abs().max())
        err = max(float((got["space"] - staged["space"]).abs().max()) / scale,
                  max(float((a - b).abs().max()) for a, b in zip(got["back"], staged["back"]))
                  / max(float(v.abs().max()) for v in vals))
        card = leg.report()
        n_k1, n_k2 = (sum(got["counts"][k].values()) for k in ("complex_matmul", "row_gather"))
        label = f"legacy:{name}"
        counts[label] = got["counts"]
        row = {"phase": "legacy", "plan": name, "engine": leg.engine,
               "exchange": leg.exchange_type.name, "path": card["ir"]["path"],
               "degradations": [d["event"] for d in card["degradations"]],
               "rel_err_vs_staged_twin": err, "bitwise": same(got["space"], staged["space"])
               and same(got["back"], staged["back"]),
               "launches": {"complex_matmul": n_k1, "row_gather": n_k2},
               "twin_launches": {k: sum(v.values()) for k, v in staged["counts"].items()},
               "dispatches": got["dispatches"]}
        emit(row)
        check(row["path"] == "legacy" and row["degradations"] == ["ir_lower_failed"],
              f"{label}: {row['path']}, {row['degradations']}")
        check(n_k1 > 0 and n_k2 > 0, f"{label}: K1 {n_k1}, K2 {n_k2} launches")
        check(err <= LEGACY_RTOL, f"{label}: {err} against its staged twin")
        rows += [(r, label, k, key) for r, k, key in mesh_form_rows(label, leg, gen)]
        del leg, twin, staged, got
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "tuning", "seconds": time.perf_counter() - t0})
    return rows, counts


# ---- pair times against other trees (--against) ----------------------------------

# the 256^3 plans that --against times, fused and staged: local names of
# PLANS, and the mesh plans of DIST_PLANS without a process group
TURN_PLANS = ("c2c-blocked", "c2c-blocked-high", "r2c-blocked", "r2c-blocked-high")
TURN_DIST = ("dist4-c2c", "dist4-r2c")


# ---- phase 11: the C ABI on the card ------------------------------------------------

# The local plans through the C functions with SPFFT_PU_GPU: (name, transform,
# radius, dtype)
CAPI_PLANS = [("capi-c2c-blocked", "c2c", 0.659, F32), ("capi-c2c-blocked-f64", "c2c", 0.659, F64),
              ("capi-r2c-blocked", "r2c", 0.659, F32)]
# BASELINE.json's 512^3 R2C float32 plan over 16 shards, through
# spfft_grid_create_distributed and spfft_dist_transform_*
CAPI_DIST = ("capi-512-r2c-16-single", 512, 0.15, 16)
CAPI_TURNS = 3  # rounds of the C pairs and the Python pairs taking turns
CAPI_PAIRS = 3  # timed pairs per turn
SPFFT_PU_GPU = 2
# the programs on the library, run as processes: (name, arguments, what stdout must hold)
CAPI_PROGRAMS = [
    ("run_native_tests", [], "ALL NATIVE TESTS PASSED"),
    ("run_native_tests_cpp", [], "ALL NATIVE C++ TESTS PASSED"),
    ("example", [], "roundtrip, first element"),
    ("example_cpp", [], "roundtrip, first element"),
    ("example_distributed", [], "distributed roundtrip max error"),
    ("example_f90", [], None),  # where gfortran built it
]
CAPI_BENCH = [("capi-bench-256", ["-d", "256", "256", "256", "-r", "4", "-p", "gpu"]),
              ("capi-bench-256-shards4", ["-d", "256", "256", "256", "-r", "4", "-p", "gpu",
                                          "--shards", "4"])]


def k_launches(counts) -> tuple[int, int]:
    """(K1, K2) host launches in a launch count."""
    return sum(counts["complex_matmul"].values()), sum(counts["row_gather"].values())


def host_copy_gbps(nbytes: int, reps: int = 3) -> dict:
    """GB/s of one copy of ``nbytes`` between the card and pageable host
    memory each way (a numpy buffer, as a C caller's), and of a host
    memcpy, the best of ``reps``."""
    import torch

    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = np.ones(nbytes, dtype=np.uint8)
    other = np.ones(nbytes, dtype=np.uint8)
    pageable = torch.from_numpy(host)
    out = {}
    for way, fn in (("device_to_host", lambda: pageable.copy_(dev)),
                    ("host_to_device", lambda: dev.copy_(pageable)),
                    ("host_memcpy", lambda: np.copyto(other, host))):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        out[way] = nbytes / best / 1e9
    return out


def capi_compare(name, pairs, c_pair, py_pair, copies, launches) -> dict:
    """The C pair against the Python pair, taking turns (host clock, ms):
    their least and median; the rates of the host copies the C pair makes
    (``copies``: (what, bytes, way)) at their sizes, and the share of the C
    pair they take at those rates."""
    times = {"c_abi": [], "python": []}
    for _ in range(CAPI_TURNS):
        for label, fn in (("c_abi", c_pair), ("python", py_pair)):
            for _ in range(pairs):
                t0 = time.perf_counter()
                fn()
                times[label].append((time.perf_counter() - t0) * 1e3)
    rates = {n: host_copy_gbps(n) for n in sorted({n for _, n, _ in copies})}
    copy_ms = {what: n / (rates[n][way] * 1e9) * 1e3 for what, n, way in copies}
    c_ms = statistics.median(times["c_abi"])
    return {"phase": "capi_pair", "plan": name, "pairs_each": len(times["c_abi"]),
            "c_abi_pair_ms_min": min(times["c_abi"]), "c_abi_pair_ms_median": c_ms,
            "python_pair_ms_min": min(times["python"]),
            "python_pair_ms_median": statistics.median(times["python"]),
            "c_over_python": c_ms / statistics.median(times["python"]),
            "host_copies": [{"what": what, "bytes": n, "way": way, "gbps": rates[n][way],
                             "ms": copy_ms[what]} for what, n, way in copies],
            "host_copy_ms_at_those_rates": sum(copy_ms.values()),
            "host_copy_share_of_c_pair": sum(copy_ms.values()) / c_ms,
            "k1_launches": launches[0], "k2_launches": launches[1]}


def capi_bitwise(name, what, got: np.ndarray, want: np.ndarray) -> None:
    """The C ABI's buffer ``got`` bitwise the Python plan's ``want``;
    else the difference and the reason are printed, and the run fails."""
    same_bits = got.shape == want.shape and np.array_equal(got.view(np.uint8),
                                                           want.view(np.uint8))
    if not same_bits:
        diff = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()) \
            if got.shape == want.shape else None
        emit({"phase": "capi_mismatch", "plan": name, "what": what, "max_abs_diff": diff,
              "reason": "the C ABI runs the same plan object as the Python call; a "
                        "difference means a copy or a dtype differs on the way"})
    check(same_bits, f"{name}: the C ABI's {what} is not the Python plan's, bitwise")


def capi_local(sp, api, name, kind, dtype, triplets, vals) -> dict:
    """One local plan through the C functions and through the Python API
    with the same arguments: bitwise results, K1/K2 launches behind the C
    calls, the pair times in turns and the host copies."""
    import torch

    r2c = kind == "r2c"
    cdt = np.complex64 if dtype == F32 else np.complex128
    values = np.ascontiguousarray(vals.astype(cdt))
    vin = values.view(dtype)
    X, Y, Z = DIMS
    space = np.zeros(X * Y * Z * (1 if r2c else 2), dtype=dtype)
    back = np.zeros(2 * len(values), dtype=dtype)
    ttype = getattr(sp.TransformType, kind.upper())
    py = sp.Transform(sp.ProcessingUnit.GPU, ttype, *DIMS, len(triplets), triplets, dtype=dtype)
    torch.cuda.synchronize()
    clear_counts()
    plan = api.transform(SPFFT_PU_GPU, int(ttype), DIMS, triplets, dtype == F64)
    plan.backward(vin, space)
    plan.forward(space, back, int(sp.ScalingType.FULL))
    torch.cuda.synchronize()
    launches = k_launches(launch_counts())
    check(launches[0] > 0 and launches[1] > 0,
          f"{name}: K1/K2 launches behind the C ABI {launches}")
    py_space = py.backward(values).cpu().numpy()
    py_back = py.forward(py_space, sp.ScalingType.FULL).cpu().numpy()
    capi_bitwise(name, "backward", space, py_space.reshape(-1).view(dtype))
    capi_bitwise(name, "forward", back, py_back.view(dtype))

    def c_pair():
        plan.backward(vin, space)
        plan.forward(space, back, int(sp.ScalingType.FULL))

    def py_pair():
        s = py.backward(values).cpu().numpy()
        py.forward(s, sp.ScalingType.FULL).cpu().numpy()

    # backward_ptr lands the space in the plan's host buffer, then copies it
    # to the caller's (the reference's space_domain_data semantics)
    copies = [("values_in", vin.nbytes, "host_to_device"),
              ("space_out", space.nbytes, "device_to_host"),
              ("space_to_caller", space.nbytes, "host_memcpy"),
              ("space_in", space.nbytes, "host_to_device"),
              ("values_out", back.nbytes, "device_to_host")]
    row = capi_compare(name, CAPI_PAIRS, c_pair, py_pair, copies, launches)
    plan.close()
    return row | {"dtype": np.dtype(dtype).name, "transform": kind, "bitwise": True}


def capi_dist(sp, api) -> dict:
    """BASELINE.json's 512^3 R2C float32 plan over 16 shards through
    spfft_grid_create_distributed / spfft_dist_transform_* and through a
    Python Grid with the same arguments: bitwise, launches, times."""
    import torch

    name, dim, fraction, shards = CAPI_DIST
    dims = (dim,) * 3
    radius = sp.spherical_radius_for_fraction(fraction)
    triplets = np.asarray(sp.create_spherical_cutoff_triplets(*dims, radius,
                                                              hermitian_symmetry=True))
    per = [np.asarray(t, dtype=np.int32) for t in sp.distribute_triplets(triplets, shards, dim)]
    rng = np.random.default_rng(SEED + 11)
    n = sum(len(t) for t in per)
    values = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    vin = values.view(F32)
    space = np.zeros(dim ** 3, dtype=F32)
    back = np.zeros(2 * n, dtype=F32)
    t0 = time.perf_counter()
    grid = sp.Grid(*dims, dim * dim, sp.ProcessingUnit.GPU, 1, max_local_z_length=dim,
                   mesh=sp.make_fft_mesh(shards), exchange_type=sp.ExchangeType.DEFAULT)
    py = grid.create_transform(sp.ProcessingUnit.GPU, sp.TransformType.R2C, *dims,
                               indices=per, dtype=F32)
    split = np.cumsum([len(t) for t in per])[:-1]
    py_values = np.split(values, split)
    torch.cuda.synchronize()
    clear_counts()
    plan = api.dist_transform(SPFFT_PU_GPU, int(sp.TransformType.R2C), dims, per, False)
    plan.backward(vin, space)
    plan.forward(space, back, int(sp.ScalingType.FULL))
    torch.cuda.synchronize()
    launches = k_launches(launch_counts())
    setup_s = time.perf_counter() - t0
    check(launches[0] > 0 and launches[1] > 0,
          f"{name}: K1/K2 launches behind the C ABI {launches}")
    py_space = py.backward(py_values).cpu().numpy()
    py_back = torch.cat([v.reshape(-1) for v in py.forward(py_space, sp.ScalingType.FULL)])
    capi_bitwise(name, "backward", space, py_space.reshape(-1))
    capi_bitwise(name, "forward", back, py_back.cpu().numpy().view(F32))
    del py_space, py_back

    def c_pair():
        plan.backward(vin, space)
        plan.forward(space, back, int(sp.ScalingType.FULL))

    def py_pair():
        s = py.backward(py_values).cpu().numpy()
        torch.cat([v.reshape(-1) for v in py.forward(s, sp.ScalingType.FULL)]).cpu().numpy()

    copies = [("values_in", vin.nbytes, "host_to_device"),
              ("space_out", space.nbytes, "device_to_host"),
              ("space_in", space.nbytes, "host_to_device"),
              ("values_out", back.nbytes, "device_to_host")]
    row = capi_compare(name, 1, c_pair, py_pair, copies, launches)
    plan.close()
    del py, grid
    return row | {"dtype": "float32", "transform": "r2c", "shards": shards,
                  "exchange": "DEFAULT", "setup_s": setup_s, "bitwise": True}


def capi_programs(built) -> dict:
    """The C and C++ API tests and the examples (all at once, on the host's
    CPU, SPFFT_PU_HOST), then the benchmark with ``-p gpu``, one at a time:
    each must exit 0; the benchmark's ``ms_per_pair`` from its JSON."""
    from spfft_tpu_torch import _build

    env = _build.native_env()
    started = {}
    for name, args, _ in CAPI_PROGRAMS:
        if (built / name).exists():
            started[name] = subprocess.Popen([str(built / name), *args], env=env, cwd=built,
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True)
    out = {"fortran_example_ran": _build.FORTRAN_EXAMPLE in started,
           "gfortran": shutil.which("gfortran")}
    for name, args, marker in CAPI_PROGRAMS:
        if name not in started:
            continue
        try:
            stdout, stderr = started[name].communicate(timeout=300)
        except subprocess.TimeoutExpired:
            started[name].kill()
            stdout, stderr = started[name].communicate()
        rc = started[name].returncode
        out[name] = {"rc": rc, "tail": stdout[-200:]}
        check(rc == 0 and (marker is None or marker in stdout),
              f"{name} exited {rc}: {stdout[-1000:]} {stderr[-2000:]}")
    for name, args in CAPI_BENCH:
        t0 = time.perf_counter()
        result = subprocess.run([str(built / "benchmark"), *args], env=env, cwd=built,
                                capture_output=True, text=True, timeout=300)
        check(result.returncode == 0,
              f"{name} exited {result.returncode}: {result.stdout[-1000:]} {result.stderr[-2000:]}")
        report = json.loads(result.stdout[result.stdout.index("{"):])
        out[name] = {"args": args, "seconds": time.perf_counter() - t0,
                     "ms_per_pair": report["results"]["ms_per_pair"],
                     "results": report["results"], "parameters": report["parameters"]}
        print(f"{name}: ms_per_pair {report['results']['ms_per_pair']}", flush=True)
    return out


def allreduces(prof) -> int:
    """The all-reduces in a profile: the NCCL process group's
    ``nccl:all_reduce`` records, or where it draws none, the dispatcher's
    ``c10d::allreduce_``."""
    names = [e.name for e in prof.events()]
    nccl = sum(1 for n in names if n == "nccl:all_reduce")
    return nccl if nccl else sum(1 for n in names if n == "c10d::allreduce_")


def capi_verify_group(sp, data, group, before) -> dict:
    """``dist4-c2c-nccl1`` with ``verify=True`` against ``dist4-c2c`` with
    ``verify=True``: the same verdict rows (all passes), the same results,
    one all-reduce in the profile of each verified call, and no rung taken
    (the rung counters as in ``before``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    triplets, vals, _ = data["c2c", 0.659]
    per = sp.distribute_triplets(triplets, 4, DIMS[1])
    values = [torch.as_tensor(vals[i].astype(np.complex64), device="cuda")
              for i in shard_index(triplets, per)]
    make = lambda mesh: sp.DistributedTransform(sp.ProcessingUnit.GPU, sp.TransformType.C2C,
                                                *DIMS, per, mesh=mesh, dtype=F32, verify=True)
    stacked, grouped = make(sp.make_fft_mesh(4)), make(sp.make_fft_mesh(4, group=group))
    s_space, s_back, s_rows = verify_rows(sp, stacked, values)
    g_space, g_back, g_rows = verify_rows(sp, grouped, values)
    key = lambda rows: [(r["direction"], r["check"], r["verdict"]) for r in rows
                        if r["check"] is not None]
    check(key(g_rows) == key(s_rows) and key(g_rows)
          and all(v == "pass" for *_, v in key(g_rows)),
          f"dist4-c2c-nccl1 verdicts {key(g_rows)} against dist4-c2c's {key(s_rows)}")
    check(same(g_space, s_space) and same(g_back, s_back),
          "dist4-c2c-nccl1 verified results differ from dist4-c2c's")
    calls = {}
    for direction, call in (("backward", lambda: grouped.backward(values)),
                            ("forward", lambda: grouped.forward(scaling=sp.ScalingType.FULL))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        calls[direction] = allreduces(prof)
    check(all(n == 1 for n in calls.values()),
          f"dist4-c2c-nccl1: all-reduces per verified call {calls}, not 1")
    no_rungs("capi verify", {"dist4-c2c-nccl1": grouped, "dist4-c2c": stacked}, before)
    return {"phase": "capi_verify_group", "rows": g_rows, "stacked_rows": s_rows,
            "allreduces_per_call": calls}


def capi_phase(sp, data, group) -> dict:
    """Phase 11 (module docstring): the C library built from the checkout
    and loaded into this process, the local and the 512^3 distributed plans
    through the C ABI against the Python API, the programs on the library,
    and verification over the one-rank NCCL group. Returns the in-checkout
    benchmark's 256^3 report and the directory of its build (phase 15 holds
    the installed one to it, in turns with it)."""
    from spfft_tpu_torch import _build
    from spfft_tpu_torch.native import abi

    started = time.perf_counter()
    before = rung_counters()
    built = _build.build_native()
    emit({"phase": "capi_build", "seconds": time.perf_counter() - started, "dir": str(built),
          "programs": sorted(p.name for p in built.iterdir() if os.access(p, os.X_OK)
                             and p.is_file()),
          "libpython_shared": bool(__import__("sysconfig").get_config_var("Py_ENABLE_SHARED"))})
    api = abi.Api()
    for name, kind, radius, dtype in CAPI_PLANS:
        triplets, vals, _ = data[kind, radius]
        emit(capi_local(sp, api, name, kind, dtype, triplets, vals))
    emit(capi_dist(sp, api))
    no_rungs("capi phase", {}, before)
    programs = capi_programs(built)
    emit({"phase": "capi_programs", **programs})
    emit(capi_verify_group(sp, data, group, before))
    emit({"phase": "capi", "seconds": time.perf_counter() - started})
    return {**programs["capi-bench-256"], "dir": built}


# ---- phase 15: compiled-program statistics, and the installed C library ---------------

COMPILED_PLANS = ("c2c-blocked", "r2c-blocked", "dist4-c2c", "pencil2x2-c2c", "dist4-c2c-nccl1")
PACKAGE_DIR = os.path.join("build", "smoke", "package")
# phase 11's capi-bench-256: 256^3 dense C2C; a run takes ~17 s (mostly the
# embedded interpreter's start and the dense plan's construction), so the
# turns are phase 11's run, then one run of each build here
PACKAGE_BENCH = CAPI_BENCH[0][1]


def staged_backward_launches(twin, values_dev) -> tuple[int, int, int]:
    """(K1, K2, line FFT) launches of one backward call of a staged twin."""
    import torch

    torch.cuda.synchronize()
    clear_counts()
    twin.backward(values_dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    return (*k_launches(counts), sum(counts["line_fft"].values()))


def compiled_phase(sp, plans) -> None:
    """Phase 15, its first part (module docstring): the compiled cards of
    ``COMPILED_PLANS``; ``plans`` {name: (plan, staged twin, values on the
    card)}."""
    from spfft_tpu_torch import faults
    from spfft_tpu_torch.obs import hlo

    started = time.perf_counter()
    rows = {}
    for name in COMPILED_PLANS:
        t, twin, vals = plans[name]
        before = run_pair(sp, t, vals)
        k1, k2, fft = staged_backward_launches(twin, vals)
        t0 = time.perf_counter()
        card = t.report(include_compiled=True)
        report_s = time.perf_counter() - t0
        check(sp.obs.validate_plan_card(card) == [],
              f"{name}: invalid compiled card {sp.obs.validate_plan_card(card)}")
        compiled = card.get("compiled")
        check(compiled is not None, f"{name}: no compiled section: {card['degradations']}")
        classes, nodes = compiled["hlo_op_classes"], compiled["graph_nodes"]
        kernels = nodes["kernels"]
        check(classes.get("k1", 0) == k1 and kernels["k1"] == k1,
              f"{name}: K1 {classes.get('k1', 0)} classes, {kernels['k1']} graph nodes, "
              f"{k1} staged launches")
        check(classes.get("k2", 0) == k2 and kernels["k2"] == k2,
              f"{name}: K2 {classes.get('k2', 0)} classes, {kernels['k2']} graph nodes, "
              f"{k2} staged launches")
        check(classes.get("fft", 0) == fft and kernels["fft"] == fft,
              f"{name}: line FFT {classes.get('fft', 0)} classes, {kernels['fft']} graph nodes, "
              f"{fft} staged launches")
        grains = hlo.element_granular_ops(hlo.record_program(t)[0])
        check(compiled["element_granular_ops"] == len(grains) and all(
            op == "index_copy_" and operand.count("x") == 1 for op, operand, _ in grains),
            f"{name}: {compiled['element_granular_ops']} element-granular ops {grains}, "
            "not decompress's alone")
        if getattr(t._exec, "collective", False):
            check(kernels["nccl"] > 0, f"{name}: no NCCL kernel node in its graph: {nodes}")
        # the armed report's rung is this check's, not a rung of the plan: the
        # metrics registry is off for it, so the later phases' rung counters
        # read 0 as before
        sp.obs.disable()
        try:
            with faults.inject("hlo.stats=raise"):
                faulted = t.report(include_compiled=True)
        finally:
            sp.obs.enable()
        check("compiled" not in faulted and any(
            d["event"] == "hlo_stats_unavailable" for d in faulted["degradations"]),
            f"{name}: hlo.stats=raise gave {sorted(faulted)} {faulted['degradations']}")
        after = run_pair(sp, t, vals)
        check(same(before["space"], after["space"]) and same(before["back"], after["back"]),
              f"{name}: the plan's results changed after its compiled report")
        rows[name] = {"report_s": report_s, "compile_seconds": compiled["compile_seconds"],
                      "memory_analysis": compiled["memory_analysis"], "graph_nodes": nodes,
                      "staged_backward_k1": k1, "staged_backward_k2": k2,
                      "staged_backward_line_fft": fft,
                      "hlo_op_classes": classes, "element_granular": grains}
        print(f"{name}: compile_seconds {compiled['compile_seconds']:.4f} memory_analysis "
              f"{compiled['memory_analysis']} graph nodes {nodes['total']} {kernels}", flush=True)
    no_rungs("compiled phase", {name: plans[name][0] for name in COMPILED_PLANS})
    emit({"phase": "compiled", "seconds": time.perf_counter() - started, "rows": rows})
    emit(compression_ms(sp, *plans["c2c-blocked"][::2]))


def compression_ms(sp, t, vals) -> dict:
    """Device ms of the element ops the compiled cards flag, at ``t``'s
    shapes: decompress (``index_copy_`` into the zeroed stick table) and
    compress (``index_select`` out of it), each on the two float32 planes
    as the ``mxu`` engine runs them; their bytes bounds (values, indices
    and table each once); and the fused pair's ms beside them."""
    import torch
    from spfft_tpu_torch.ops import compression

    ex = t._exec
    vi, rows, z = ex._vi, ex._table_rows, ex.params.dim_z
    n, size = vi.numel(), ex._table_rows * ex.params.dim_z
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    planes = [torch.randn(n, device="cuda", generator=gen) for _ in range(2)]
    tables = [torch.randn(rows, z, device="cuda", generator=gen) for _ in range(2)]
    decompress = lambda: [compression.decompress(v, vi, rows, z) for v in planes]
    compress = lambda: [compression.compress(tab, vi) for tab in tables]
    for got, want in zip(decompress(), planes):  # the scatter is the gather's inverse
        check(torch.equal(compression.compress(got, vi), want), "decompress/compress disagree")
    bound = lambda nbytes: nbytes / PEAK_BYTES * 1e3
    row = {"phase": "compression_ops", "plan": "c2c-blocked", "values": n, "table": size,
           "decompress_ms": device_ms(decompress), "compress_ms": device_ms(compress),
           "decompress_bound_ms": bound(2 * (4 * n + 8 * n + 4 * size)),
           "compress_bound_ms": bound(2 * (4 * n + 8 * n + 4 * n)),
           "pair_ms": call_ms(lambda: (t.backward(vals), t.forward(scaling=sp.ScalingType.FULL)))}
    print(f"compression ops (c2c-blocked): decompress {row['decompress_ms']:.4f} ms (bound "
          f"{row['decompress_bound_ms']:.4f}), compress {row['compress_ms']:.4f} ms (bound "
          f"{row['compress_bound_ms']:.4f}), the fused pair {row['pair_ms']:.4f} ms", flush=True)
    return row


def packaging_phase(checkout) -> None:
    """Phase 15, its second part (module docstring): the port's CMake tree
    installed and consumed, and the benchmark built against the installed
    ``.pc``, run at the arguments of ``checkout``, phase 11's report of the
    in-checkout build, and held bitwise to it."""
    from spfft_tpu_torch import _build

    started = time.perf_counter()
    cmake = shutil.which("cmake")
    if cmake is None:
        print("packaging: cmake is missing on this machine; the installed tree is not built",
              flush=True)
        emit({"phase": "packaging", "cmake": None})
        return
    root = os.path.abspath(PACKAGE_DIR)
    shutil.rmtree(root, ignore_errors=True)
    build, prefix = os.path.join(root, "build"), os.path.join(root, "prefix")
    source = os.path.join("spfft_tpu_torch", "native")
    run = lambda cmd, **kw: subprocess.run(cmd, check=True, capture_output=True, text=True,
                                           timeout=300, **kw)
    run([cmake, "-S", source, "-B", build, "-DCMAKE_BUILD_TYPE=Release",
         "-DSPFFT_TPU_TORCH_BUILD_TESTS=OFF", f"-DPython3_EXECUTABLE={sys.executable}",
         f"-DCMAKE_INSTALL_PREFIX={prefix}"])
    run([cmake, "--build", build, "--parallel", "8"])
    run([cmake, "--install", build])
    libdir = next(os.path.join(prefix, d) for d in ("lib", "lib64")
                  if os.path.exists(os.path.join(prefix, d, "pkgconfig", "spfft_tpu_torch.pc")))
    installed_s = time.perf_counter() - started
    consumer = os.path.join(root, "consumer")
    run([cmake, "-S", os.path.join(source, "tests", "consumer"), "-B", consumer,
         f"-DCMAKE_PREFIX_PATH={prefix}"])
    run([cmake, "--build", consumer])
    env = _build.native_env()
    env["LD_LIBRARY_PATH"] = os.pathsep.join(p for p in (libdir, env.get("LD_LIBRARY_PATH"))
                                             if p)
    out = run([os.path.join(consumer, "consumer")], env=env).stdout
    check("consumer link OK" in out, f"the consumer printed {out!r}")
    pc_env = {**os.environ, "PKG_CONFIG_PATH": os.path.join(libdir, "pkgconfig")}
    flags = run(["pkg-config", "--cflags", "--libs", "spfft_tpu_torch"], env=pc_env).stdout.split()
    bench = os.path.join(root, "benchmark_installed")
    run([_build._c_compiler()[0], "-O2", "-o", bench,
         os.path.join(source, "programs", "benchmark.c"), *flags, f"-Wl,-rpath,{libdir}", "-lm"])
    check(checkout["args"] == PACKAGE_BENCH, f"phase 11 ran {checkout['args']}")

    def bench_run(binary, cwd) -> dict:
        result = subprocess.run([binary, *PACKAGE_BENCH], env=_build.native_env(), cwd=cwd,
                                capture_output=True, text=True, timeout=300)
        check(result.returncode == 0, f"{binary} exited {result.returncode}: "
              f"{result.stdout[-1000:]} {result.stderr[-2000:]}")
        return json.loads(result.stdout[result.stdout.index("{"):])["results"]

    installed = bench_run(bench, root)
    again = bench_run(str(checkout["dir"] / "benchmark"), checkout["dir"])
    checkout_ms = [checkout["ms_per_pair"], again["ms_per_pair"]]
    ratio = installed["ms_per_pair"] / statistics.mean(checkout_ms)
    print(f"packaging: ms_per_pair in turns: in-checkout (phase 11) {checkout_ms[0]}, installed "
          f"{installed['ms_per_pair']}, in-checkout {checkout_ms[1]}; installed over the "
          f"in-checkout mean {ratio:.4f}", flush=True)
    for got in (installed, again):
        check(got["values_fnv1a"] == checkout["results"]["values_fnv1a"],
              f"the installed and in-checkout benchmarks differ: {got} {checkout['results']}")
    emit({"phase": "packaging", "cmake": cmake, "installed_s": installed_s,
          "consumer": out.strip(), "pkg_config": flags, "args": PACKAGE_BENCH,
          "installed": installed, "checkout": checkout["results"], "checkout_again": again,
          "checkout_ms_per_pair": checkout_ms, "installed_over_checkout": ratio,
          "seconds": time.perf_counter() - started})


# ---- phase 12: serving on the card --------------------------------------------------

SERVE_NAME = "serve-128-c2c"
SERVE_DIMS = (128, 128, 128)  # gbench's first geometry: a SIRIUS-style caller's band FFTs
SERVE_RADIUS = 0.659
SERVE_MIX = (192, 192, 192, 0.5)  # gbench's second geometry, for the mixed cell
SERVE_LATE_RADIUS = 0.5  # the 128^3 geometry that arrives in the middle of the 1·C step
SERVE_TENANTS = 3
SERVE_STEP_S = 1.5
SERVE_SUBMITTERS = 4  # loadgen's submitting threads
SERVE_SAMPLE = 8  # results per step held bitwise to a separately built plan's single call
SERVE_RTOL = 1e-5  # one sample per step against the complex128 dense oracle ("highest")
SERVE_BATCHES = (1, 2, 4, 8)
SERVE_ARMED = "serve.dispatch=raise:0.5"
FLEET_QUEUE_CAP = 64


def serve_problem(sp, dims, radius, seed):
    """Triplets and complex values of one serving geometry (caller order)."""
    rng = np.random.default_rng(seed)
    trip = np.asarray(sp.create_spherical_cutoff_triplets(*dims, radius))
    return trip, rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))


def serve_oracle_err(trip, payload, dims, result) -> float:
    """Max abs error of a backward result over max |oracle|: the complex128
    dense inverse transform of ``payload`` placed at ``trip``."""
    X, Y, Z = dims
    dense = np.zeros((Z, Y, X), np.complex128)
    dense[storage(trip[:, 2], Z), storage(trip[:, 1], Y), storage(trip[:, 0], X)] = payload
    want = np.fft.ifftn(dense) * (X * Y * Z)
    return float(np.abs(result.cpu().numpy() - want).max() / np.abs(want).max())


def serve_plan(sp, trip, dims, **kw):
    """A plan exactly as the service builds its cache entry (the canonical
    triplets) and the map that stages a caller-order payload for it."""
    from spfft_tpu_torch.parallel.ragged import value_order_map

    canonical = sp.serve.canonical_triplets(trip, dims)
    t = sp.Transform(sp.ProcessingUnit.GPU, sp.TransformType.C2C, *dims, indices=canonical,
                     dtype=F32, **kw)
    src = value_order_map(t._verify_triplets(), sp.serve.wrap_triplets(trip, dims))
    return t, src


def wall_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median host-clock ms of ``fn()`` through the card's completion."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def kernel_counts(fn, attempts: int = 3) -> tuple:
    """(K1, K2) kernels on the device timeline of ``fn()`` under
    torch.profiler: the replays of a CUDA graph count there, where host
    launch counters count none. A profile that records no device event at
    all (seen in the full script's run, as ``busy_pair_ms`` has seen) is
    taken again, up to ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in device_kernels(prof)]
        if names:
            break
    return (sum("tc_kernel" in n or "dmma_kernel" in n for n in names),
            sum("row_gather_kernel" in n for n in names))


def serve_capacity(sp, plan, src, trip, payloads) -> dict:
    """Capacity C: one warm batch-fused backward of ``batch_max`` = 8 requests
    with their host staging, C = 8 / its seconds; the ms per transform of the
    batched program at B = 1, 2, 4, 8 against single calls (B4 under
    serving); and what admission costs a request (``TransformService.submit``
    of one payload: canonical triplets, the plan key, the value-order map,
    the gather into plan order)."""
    staged = [p[src] for p in payloads]
    per_b = {b: wall_ms(lambda b=b: plan.backward_batch(staged[:b]), reps=10, warmup=3) / b
             for b in SERVE_BATCHES}
    single = wall_ms(lambda: plan.backward(staged[0]), reps=10, warmup=3)
    seconds8 = per_b[8] * 8 / 1e3
    svc = sp.serve.TransformService(sp.ProcessingUnit.GPU, dtype=F32, start=False,
                                    queue_capacity=64)
    svc.submit(sp.TransformType.C2C, SERVE_DIMS, trip, payloads[0])  # the plan build
    t0 = time.perf_counter()
    for p in payloads[1:8]:
        svc.submit(sp.TransformType.C2C, SERVE_DIMS, trip, p)
    admit_ms = 1e3 * (time.perf_counter() - t0) / 7
    svc.close(drain=False)
    row = {"phase": "serve_capacity", "batch8_seconds": seconds8, "capacity_per_s": 8 / seconds8,
           "ms_per_transform_batched": {str(b): ms for b, ms in per_b.items()},
           "ms_per_transform_single": single,
           "batched_over_single": {str(b): ms / single for b, ms in per_b.items()},
           "admission_ms_per_request": admit_ms,
           "admission_limit_per_s": 1e3 / admit_ms}
    emit(row)
    return row


def serve_wire(sp, plan, src, payload) -> dict:
    """What the RPC path pays per result at 128^3 complex64: the pageable
    device-to-host copy of ``.cpu().numpy()`` and the frame's JSON + base64
    encode and decode, for a reply of 1 and of 8 results."""
    import json as _json

    from spfft_tpu_torch.serve import rpc

    res = plan.backward(payload[src])
    nbytes = res.numel() * res.element_size()
    d2h = wall_ms(lambda: rpc.host_array(res), reps=7)
    host = rpc.host_array(res)
    row = {"phase": "serve_wire", "result_bytes": nbytes, "d2h_ms": d2h,
           "d2h_gb_s": nbytes / d2h / 1e6}
    for n in (1, 8):
        reply = {"results": [{"result": host} for _ in range(n)]}
        enc = lambda: _json.dumps(rpc.encode_value(reply)).encode("utf-8")  # noqa: E731
        body = enc()
        row[f"frame{n}_bytes"] = len(body)
        row[f"frame{n}_encode_ms"] = wall_ms(enc, reps=3, warmup=0)
        row[f"frame{n}_decode_ms"] = wall_ms(
            lambda: rpc.decode_value(_json.loads(body.decode("utf-8"))), reps=3, warmup=0)
        del body
    row["wire_ms_per_result"] = d2h + (row["frame8_encode_ms"] + row["frame8_decode_ms"]) / 8
    check(row["frame8_bytes"] < rpc.MAX_FRAME_BYTES, "an 8-result reply exceeds the frame cap")
    emit(row)
    return row


def serve_row(cell, row, extra=None) -> dict:
    keys = ("key", "target_rate", "offered", "unoffered", "offered_rate", "accepted",
            "completed", "rejected", "shed", "deadline_miss", "failed", "unresolved",
            "transforms_per_sec", "p50_ms", "p99_ms", "mean_batch_occupancy", "phases",
            "completed_after_kill")
    out = {"phase": "serve_step", "cell": cell, **{k: row[k] for k in keys if k in row},
           **(extra or {})}
    emit(out)
    check(row["offered"] == row["completed"] + row["rejected"] + row["shed"]
          + row["deadline_miss"] + row["failed"], f"{cell} {row['key']}: accounting broke")
    check(row["unresolved"] == 0, f"{cell} {row['key']}: tickets left unresolved")
    return out


def plan_entries(service) -> list:
    with service.plans._lock:
        return list(service.plans._entries.values())


def serve_loadgen(argv, hooks=None) -> dict:
    """One loadgen run through its main(), its report read back."""
    from spfft_tpu_torch.programs import loadgen

    out = os.path.join(REPORTS, f"loadgen-{len(os.listdir(REPORTS))}.json")
    with knobs({"SPFFT_TPU_BATCH_FUSE": os.environ.get("SPFFT_TPU_BATCH_FUSE", "1")}):
        check(loadgen.main([*argv, "-o", out], hooks=hooks) == 0, f"loadgen {argv} failed")
    with open(out) as f:
        return json.load(f)


def serving_phase(sp) -> tuple:
    """Phase 12 (module docstring): serving on the card through K1 and K2.
    Returns the kernel rows of the serving plan's forms and their launches
    under serving."""
    import queue as _queue
    import threading

    import torch
    from spfft_tpu_torch import obs
    from spfft_tpu_torch.obs import fleet
    from spfft_tpu_torch.programs import fleetstat, loadgen

    started = time.perf_counter()
    os.makedirs(REPORTS, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = rung_counters()
    dims = SERVE_DIMS
    trip, values = serve_problem(sp, dims, SERVE_RADIUS, SEED + 12)
    rng = np.random.default_rng(SEED + 13)
    payloads = [values * (1 + 0.01 * rng.standard_normal()) for _ in range(8)]

    # ---- the reference plan, the capacity, the wire ----
    ref, src = serve_plan(sp, trip, dims)
    check(ref.engine == "mxu", f"{SERVE_NAME}: auto resolved to {ref.engine} on the card")
    cap = serve_capacity(sp, ref, src, trip, payloads)
    C = cap["capacity_per_s"]
    wire = serve_wire(sp, ref, src, payloads[0])
    # the profiled checks in a process of their own: in the full script, after
    # phases 1–11, the profiler lost K1/K2 records (0 of a staged backward's 7
    # kernels, 45 of 48 K1 in a batched one) that a fresh process records
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-profile", str(C)],
                         capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"the serving profile process failed: {run.stderr[-3000:]}")
    prof = json.loads(run.stdout.strip().splitlines()[-1])
    emit(prof)
    k_single, k_batch = tuple(prof["staged_backward"]), tuple(prof["batched_backward_b8"])
    check(k_single[0] > 0 and k_single[1] > 0, "the staged backward ran no K1 or K2")
    check(k_batch == (8 * k_single[0], 8 * k_single[1]),
          f"B = 8 batched backward ran {k_batch} K1/K2 kernels, not 8 x {k_single}")
    base = ["--device", "gpu", "--dtype", "float32", "-d", *map(str, dims),
            "-s", str(SERVE_RADIUS), "--tenants", str(SERVE_TENANTS),
            "--duration", str(SERVE_STEP_S), "--submitters", str(SERVE_SUBMITTERS),
            "--settle-s", "60"]

    # ---- cell serve-128-c2c: 0.5·C, 1·C, 2·C batch-fused; the capture hazard mid-step ----
    clear_counts()
    reads = {"n": 0}
    inbox = _queue.Queue(maxsize=8)
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                r = inbox.get(timeout=0.05)
            except _queue.Empty:
                continue
            r.cpu()  # a submitter reading its result while the dispatcher captures
            reads["n"] += 1

    def consume(result):
        try:
            inbox.put_nowait(result)
        except _queue.Full:
            pass

    late_trip, late_values = serve_problem(sp, dims, SERVE_LATE_RADIUS, SEED + 14)
    late = {}

    def late_geometry(service):
        try:
            tk = service.submit(sp.TransformType.C2C, dims, late_trip, late_values,
                                tenant="late")
            res = tk.result(timeout=120)
            late["err"] = serve_oracle_err(late_trip, late_values, dims, res)
        except Exception as e:  # reported below, where the check fails the run
            late["error"] = repr(e)

    late_thread = []

    def during(service, step):
        if step == 1:  # the 1·C step: a geometry the cache has not seen arrives
            th = threading.Thread(target=late_geometry, args=(service,), daemon=True)
            th.start()
            late_thread.append(th)

    steps = []

    def step(service, row, samples):
        i = len(steps)
        stats = service.stats()
        bitwise = []
        oracle_err = None
        for g, payload, result in samples:
            got = ref.backward(payload[src])
            bitwise.append(torch.equal(result, got))
            if oracle_err is None:
                oracle_err = serve_oracle_err(trip, payload, dims, result)
        entries = plan_entries(service)
        rungs = {e.plan._run_id: e.plan.report()["degradations"] for e in entries
                 if e.plan.report()["degradations"]}
        steps.append(serve_row(SERVE_NAME, row, {
            "samples": len(samples), "samples_bitwise": sum(bitwise),
            "oracle_rel_err": oracle_err, "queue_high_water": stats["queue_high_water"],
            "queue_capacity": stats["queue_capacity"],
            "engines": sorted({e.plan.engine for e in entries}), "degradations": rungs}))
        check(len(samples) == SERVE_SAMPLE and all(bitwise),
              f"{SERVE_NAME} {row['key']}: {len(samples)} samples, "
              f"{sum(bitwise)} bitwise a single call's")
        check(oracle_err is not None and oracle_err <= SERVE_RTOL,
              f"{SERVE_NAME} {row['key']}: {oracle_err} from the dense oracle")
        check(stats["queue_high_water"] <= stats["queue_capacity"], "the queue overran its cap")
        check(i > 0 or row["failed"] == 0, f"{SERVE_NAME}: failures at 0.5·C: {row}")
        check(not rungs, f"{SERVE_NAME} {row['key']}: a plan took a rung: {rungs}")
        check(all(e.plan.engine == "mxu" for e in entries),
              f"{SERVE_NAME}: a cached plan does not run mxu")

    readers = [threading.Thread(target=reader, daemon=True) for _ in range(2)]
    for th in readers:
        th.start()
    try:
        doc = serve_loadgen([*base, "--rate", str(C), "--ramp", "0.5", "1", "2",
                             "--batch-fuse", "1", "--sample", str(SERVE_SAMPLE),
                             "--kill-at", "0.25"],
                            hooks={"consume": consume, "during": during, "step": step})
    finally:
        stop.set()
        for th in readers:
            th.join(10)
    for th in late_thread:
        th.join(120)
    emit({"phase": "serve_capture_hazard", "reads_on_host": reads["n"], **late,
          "plan_cache": [{k: r[k] for k in ("engine", "batch_cap")} | {"run_id": r["run_id"]}
                         for r in doc["service"]["plan_cache"]]})
    check(reads["n"] > 0, "no submitter read a result while the service ran")
    check(late.get("err") is not None and late["err"] <= SERVE_RTOL,
          f"the geometry that arrived mid-step: {late}")
    check(len(doc["service"]["plan_cache"]) == 2, "the late geometry has no cache entry")

    # ---- the same at 1·C with batch fusion off (the split-phase loop) ----
    doc0 = serve_loadgen([*base, "--rate", str(C), "--ramp", "1", "--batch-fuse", "0"])
    unfused = serve_row(SERVE_NAME + "-unfused", doc0["rows"][0])

    # ---- cell serve-mixed-sched: 128^3 and 192^3 interleaved, scheduler off and on ----
    mixed = {}
    for sched in (0, 1):
        d = serve_loadgen([*base, "--rate", str(C), "--ramp", "1", "--sched", str(sched),
                           "--mix", *map(str, SERVE_MIX)])
        mixed[sched] = serve_row("serve-mixed-sched", d["rows"][0], {"sched": sched})
        check(all(r["engine"] == "mxu" for r in d["service"]["plan_cache"]),
              "serve-mixed-sched: a cached plan does not run mxu")
    counts = launch_counts()
    no_rungs("serving cells", {}, before)

    # ---- one armed case: serve.dispatch raising at a fraction, at 2·C ----
    svc = sp.serve.TransformService(sp.ProcessingUnit.GPU, dtype=F32)
    try:
        step_kw = dict(tenants=SERVE_TENANTS, trip=trip, values=values, dims=dims,
                       transform_type=sp.TransformType.C2C, timeout_s=0.0,
                       flops_per_transform=0.0, settle_s=60.0, rng=rng,
                       submitters=SERVE_SUBMITTERS)
        loadgen.run_step(svc, key="warm", rate=C, duration=1.0, **step_kw)
        f0 = obs.snapshot()["counters"]
        with sp.faults.inject(SERVE_ARMED):
            armed = loadgen.run_step(svc, key="armed", rate=2 * C, duration=1.0, **step_kw)
        injected = (sum(v for k, v in obs.snapshot()["counters"].items()
                        if k.startswith("faults_injected_total"))
                    - sum(v for k, v in f0.items() if k.startswith("faults_injected_total")))
        serve_row("serve-armed", armed, {"spec": SERVE_ARMED, "injected": injected})
        check(injected > 0 and armed["failed"] > 0, f"{SERVE_ARMED} never fired")
    finally:
        svc.close()
        sp.faults.disarm()
        sp.verify.breaker.reset()

    # ---- cell fleet-2w-kill: two workers on the card, one SIGKILLed ----
    rate = min(C, 1e3 / wire["wire_ms_per_result"])  # one result on the wire at a time
    scraped = {}

    def fleet_step(front, row, samples):
        if "json" in scraped or front.hosts[0].lost:
            return
        addr = f"host0={front.hosts[0].address}"
        path = os.path.join(REPORTS, "fleetstat.json")
        prom = os.path.join(REPORTS, "fleetstat.prom")
        scraped["json"] = fleetstat.main(["--host", addr, "-o", path])
        scraped["prom"] = fleetstat.main(["--host", addr, "--prom", "-o", prom])
        with open(path) as f:
            scraped["doc"] = json.load(f)
        with open(prom) as f:
            scraped["prom_text"] = f.read()

    obs.trace.enable(capacity=1 << 16)
    try:
        with knobs({"SPFFT_TPU_TRACE": "1"}):
            fdoc = serve_loadgen([*base, "--rate", str(rate), "--ramp", "1", "1",
                                  "--hosts", "2", "--kill-host", "1", "--kill-at", "0.4",
                                  "--queue-cap", str(FLEET_QUEUE_CAP)],
                                 hooks={"step": fleet_step})
        events = obs.trace.snapshot()["events"]
    finally:
        obs.trace.disable()
        obs.trace.clear()
    by_run = {}
    for e in events:
        if e["run"] is not None:
            sides = by_run.setdefault(e["run"], set())
            sides.add(e["args"].get("host", "front"))
    joined = [run for run, sides in by_run.items() if "front" in sides and len(sides) > 1]
    lost = fdoc["metrics"]["counters"].get('hosts_lost_total{host="host1"}', 0)
    findings = fleet.validate_fleet(fdoc["service"]["fleet"])
    # the surviving worker's own rung counters, from its scraped snapshot
    worker_rungs = {k: v for k, v in fdoc["service"]["fleet"]["counters"].items()
                    if k.startswith(RUNG_COUNTERS) and v}
    kill_row = fdoc["rows"][0]
    for r in fdoc["rows"]:
        serve_row("fleet-2w-kill", r, {"rate_basis": "the wire's results/s, one at a time"})
    prom_lines = scraped.get("prom_text", "").splitlines()
    emit({"phase": "serve_fleet", "rate": rate, "hosts_lost_host1": lost,
          "completed_after_kill": kill_row.get("completed_after_kill"),
          "runs_joined_front_and_worker": len(joined),
          "fleet_findings": findings, "worker_rung_counters": worker_rungs,
          "fleet_hosts": fdoc["service"]["fleet"]["hosts"],
          "fleetstat_exit": [scraped.get("json"), scraped.get("prom")],
          "fleetstat_hosts": scraped.get("doc", {}).get("hosts"),
          "fleetstat_counters": len(scraped.get("doc", {}).get("counters", {})),
          "prom_lines": len(prom_lines),
          "prom_head": [ln for ln in prom_lines if ln.startswith("spfft_tpu_serve_requests")][:4]})
    check(lost == 1, f"fleet-2w-kill: hosts_lost_total{{host=host1}} is {lost}")
    check((kill_row.get("completed_after_kill") or 0) > 0, "fleet-2w-kill: nothing after the kill")
    check(joined, "fleet-2w-kill: no run shows both the front's and a worker's spans")
    check(findings == [], f"fleet-2w-kill: the fleet document has findings {findings}")
    check(not worker_rungs, f"fleet-2w-kill: the surviving worker took a rung: {worker_rungs}")
    check(scraped.get("json") == 0 and scraped.get("prom") == 0 and prom_lines,
          f"fleetstat of the surviving worker: {scraped.get('json')}, {scraped.get('prom')}")

    # ---- the serving plan's kernels against their plain versions ----
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    rows = []
    for form, spec, x, w, want_imag, out in k1_forms(SERVE_NAME, ref):
        if form.endswith(("/z", "/y")) or "backward" in form:  # the traffic is backward
            row, key = run_k1(form, spec, x, w, want_imag, "highest", out)
            rows.append((row, SERVE_NAME, "complex_matmul", key))
    for form, s_, idx in k2_forms(SERVE_NAME, ref, gen):
        if form.endswith(("/expand", "/bucket_gather")):  # the backward's gathers
            row, key = run_k2(form, s_, idx)
            rows.append((row, SERVE_NAME, "row_gather", key))
    emit({"phase": "serving", "seconds": time.perf_counter() - started,
          "capacity_per_s": C, "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
          "peak_mib_note": "this process only: the fleet cell's workers hold their own",
          "transforms_per_s": {"0.5C": steps[0]["transforms_per_sec"],
                               "1C": steps[1]["transforms_per_sec"],
                               "2C": steps[2]["transforms_per_sec"],
                               "1C_unfused": unfused["transforms_per_sec"],
                               "mixed_sched0": mixed[0]["transforms_per_sec"],
                               "mixed_sched1": mixed[1]["transforms_per_sec"]},
          "device_busy_share_1C": prof["device_busy_share"]})
    return rows, {SERVE_NAME: counts}

def serve_profile_worker(rate: float) -> int:
    """``--serve-profile C``: phase 12's profiled checks in a fresh process.
    One B = 8 batch-fused backward and one staged backward of the serving
    geometry, their K1/K2 kernels on the device timeline; then a steady
    step of a service at ``rate`` requests a second under the profiler: the
    card's busy share of the window. Prints one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import spfft_tpu_torch as sp
    from spfft_tpu_torch.programs import loadgen

    torch.backends.cuda.matmul.allow_tf32 = False
    dims = SERVE_DIMS
    trip, values = serve_problem(sp, dims, SERVE_RADIUS, SEED + 12)
    rng = np.random.default_rng(SEED + 13)
    ref, src = serve_plan(sp, trip, dims)
    twin, _ = serve_plan(sp, trip, dims, fuse=False)
    batch = [(values * (1 + 0.01 * rng.standard_normal()))[src] for _ in range(8)]
    ref.backward_batch(batch)  # the B = 8 program captured before its profile
    twin.backward(batch[0])
    k_single = kernel_counts(lambda: twin.backward(batch[0]))
    k_batch = kernel_counts(lambda: ref.backward_batch(batch))
    svc = sp.serve.TransformService(sp.ProcessingUnit.GPU, dtype=F32)
    try:
        step_kw = dict(tenants=SERVE_TENANTS, trip=trip, values=values, dims=dims,
                       transform_type=sp.TransformType.C2C, timeout_s=0.0,
                       flops_per_transform=0.0, settle_s=60.0, rng=rng,
                       submitters=SERVE_SUBMITTERS)
        loadgen.run_step(svc, key="warm", rate=rate, duration=1.0, **step_kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            row = loadgen.run_step(svc, key="profiled", rate=rate, duration=SERVE_STEP_S,
                                   **step_kw)
            torch.cuda.synchronize()
            window_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        svc.close()
    kernels = device_kernels(prof)
    busy = union_us(sorted((e.time_range.start, e.time_range.end) for e in kernels)) / 1e3
    print(json.dumps({
        "phase": "serve_profile", "staged_backward": k_single, "batched_backward_b8": k_batch,
        "window_ms": window_ms, "device_busy_ms": busy, "device_busy_share": busy / window_ms,
        "host_share": 1 - busy / window_ms, "completed": row["completed"],
        "offered_rate": row["offered_rate"],
        "k1_kernels": sum("tc_kernel" in e.name for e in kernels),
        "k2_kernels": sum("row_gather_kernel" in e.name for e in kernels)}), flush=True)
    return 0

# ---- phase 13: the programs ------------------------------------------------------------

PROGRAMS_NAME = "programs-256-c2c"
PROGRAMS_RADIUS = 0.659  # c2c-blocked's geometry
PROGRAMS_GRID = ["-d", *map(str, DIMS), "--radius", str(PROGRAMS_RADIUS), "--dtype", "float32"]
# dbench: strong scaling at 256^3 in the 15 % sphere, slab over 1, 2, 4, 16
# shards and pencil 2 x 2 and 4 x 4, stacked on the card
DBENCH_ARGS = ["--devices", "1", "2", "4", "16", "--dim", "256", "--sparsity", "0.15",
               "--mesh", "slab", "pencil", "--scaling", "strong", "--engine", "mxu",
               "--repeats", "3", "--chain", "4"]
# discipline_compare: its --sparsity is the cutoff radius, as in the JAX program
DISC_ARGS = ["--shards", "4", "16", "--dim", "256", "--sparsity", "0.15", "--repeats", "4"]
DISC_NAMES = {"BUFFERED": "BUFFERED", "COMPACT": "COMPACT_BUFFERED", "UNBUFFERED": "UNBUFFERED"}
PROGRAMS_BUDGET_S = 150.0
EXAMPLE_RTOL = 1e-5  # the float32 bar of the main path at "highest"


def program_run(runs, total, name, fn):
    """``fn()`` (one program through its ``main``, its output kept aside)
    with the launch counts set to 0 just before it: its result, and in
    ``runs`` its seconds and K1/K2 launches, added into ``total``. Fails if
    it launched neither kernel."""
    import torch

    gc.collect()
    clear_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    for kernel, by_key in counts.items():
        for key, n in by_key.items():
            total[kernel][key] = total[kernel].get(key, 0) + n
    k1, k2 = k_launches(counts)
    runs[name] = {"seconds": seconds, "k1_launches": k1, "k2_launches": k2,
                  "line_fft_launches": sum(counts["line_fft"].values())}
    check(k1 + k2 > 0, f"{name}: ran on the card and launched neither K1 nor K2")
    return result, out.getvalue()


def read_json(path):
    with open(path) as f:
        return json.load(f)


def programs_profile_worker() -> int:
    """``--programs-profile``: phase 13's profiles in a fresh process (late
    in the full script the profiler lost K1/K2 records, PERF.md §7). The
    profile program at 256^3 and radius 0.659, float32 "highest": the JAX
    choice (blocked sparse-y) and the dense y stage; per stage range the
    device ms a pair and the K1/K2 kernels inside it, the model's attributed
    seconds, the launch counts. Then each mesh row of the document that
    phase 13's dbench run wrote beside its staged twin's measured exchange
    share (:func:`dbench_shares`). One JSON line."""
    import torch

    import spfft_tpu_torch as sp
    from spfft_tpu_torch.obs import perf
    from spfft_tpu_torch.programs import profile

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for label, env in (("blocked", {}), ("dense", BLOCKS_OFF)):
        clear_counts()
        t0 = time.perf_counter()
        with knobs(env), contextlib.redirect_stdout(io.StringIO()):
            out = profile.main([*PROGRAMS_GRID[:6], "--engine", "mxu", "-r", "3",
                                "--repeats", "3", "--chain", "2",
                                "-o", os.path.join(REPORTS, f"profile-{label}")])
        seconds = time.perf_counter() - t0
        report, prof = out["report"], out["profile"]
        kernels = lambda rng, what: sum(n for k, n in rng["kernels"].items()  # noqa: E731
                                        if any(w in k for w in what))
        stages = out["transform"].describe()
        rows[label] = {
            "seconds": seconds, "y_plan": out["transform"]._exec.y_plan,
            "z_stage": stages["z_stage"], "x_stage": stages["x_stage"],
            "launches": list(k_launches(launch_counts())),
            "line_fft_launches": sum(launch_counts()["line_fft"].values()),
            "seconds_per_pair": report["seconds_per_pair"],
            "stages_sum_s": sum(r["seconds"] for r in report["stages"]),
            "flop_per_byte": report["attribution"]["flop_per_byte"],
            "perf_report_missing": perf.validate_perf_report(report),
            "trace_bytes": os.path.getsize(prof["trace"]),
            "ranges": {s: {"device_ms": v["device_ms"],
                           "k1_kernels": kernels(v, ("tc_kernel", "dmma_kernel")),
                           "k2_kernels": kernels(v, ("row_gather_kernel",)),
                           "fft_kernels": kernels(v, ("line_fft_kernel",))}
                       for s, v in prof["stages"].items()},
            "model_s": {r["stage"]: r["seconds"] for r in report["stages"]},
        }
    # dbench's mesh rows beside their staged twins' measured exchange shares
    # (the document the parent's dbench run wrote)
    shares = dbench_shares(sp, read_json(os.path.join(REPORTS, "dbench.json")))
    print(json.dumps({"phase": "programs_profile", "rows": rows, "dbench_shares": shares}),
          flush=True)
    return 0


def dbench_shares(sp, doc) -> list:
    """Each mesh row of a dbench document beside the measured exchange share
    of the same plan's staged twin (``stage_profile``)."""
    import argparse

    from spfft_tpu_torch.programs import dbench

    args = argparse.Namespace(sparsity=0.15, r2c=False, dtype="f32", force_mesh=False,
                              device="gpu", engine="mxu", exchange="DEFAULT")
    out = []
    for row in doc["rows"]:
        if row["kind"] != "distributed":
            continue
        kind = "pencil" if row["decomposition"] == "pencil2" else "slab"
        P = row["device_count"]
        t = dbench.build_transform(args, sp.ProcessingUnit.GPU, kind, P, tuple(row["dims"]))
        check(t.exchange_type.name == row["exchange_discipline"],
              f"dbench {row['key']}: rebuilt as {t.exchange_type.name}")
        measured = stage_profile(sp, f"dbench-{kind}-P{P}", t)["exchange_share"]
        out.append({"key": row["key"], "mesh": row["mesh"],
                    "exchange_fraction": row["exchange_fraction"],
                    "measured_exchange_share": measured,
                    "model_over_measured": row["exchange_fraction"] / measured,
                    "ms_per_pair": 1e3 * row["seconds_per_pair"], "gflops": row["gflops"],
                    "flop_per_byte": row["attribution"]["flop_per_byte"]})
        del t
    return out


def disc_cards(sp, imbalance) -> dict:
    """The plan cards' wire bytes of discipline_compare's plans, built here
    from the same split: ``{(P, name): bytes}``."""
    dim = int(DISC_ARGS[DISC_ARGS.index("--dim") + 1])
    radius = float(DISC_ARGS[DISC_ARGS.index("--sparsity") + 1])
    triplets = sp.create_spherical_cutoff_triplets(dim, dim, dim, radius)
    out = {}
    for P in (4, 16):
        weights = 1.0 + imbalance * np.arange(P) / max(1, P - 1)
        per = sp.distribute_triplets(triplets, P, dim, weights=weights)
        for name, disc in DISC_NAMES.items():
            t = sp.DistributedTransform(sp.ProcessingUnit.GPU, sp.TransformType.C2C, dim, dim,
                                        dim, [p.copy() for p in per], mesh=sp.make_fft_mesh(P),
                                        dtype=F32, exchange_type=sp.ExchangeType[disc])
            out[P, name] = t.report()["exchange"]["wire_bytes"]
            del t
    return out


def programs_phase(sp) -> tuple:
    """Phase 13 (module docstring): every ported program and example on the
    card, through K1 and K2. Returns the kernel rows of the programs' local
    plan's forms and their launches under the programs."""
    import torch

    from spfft_tpu_torch import obs
    from spfft_tpu_torch.examples import example, example_distributed, poisson
    from spfft_tpu_torch.programs import (dbench, discipline_compare, fbench, perf_gate, report,
                                          trace, verify)

    started = time.perf_counter()
    os.makedirs(REPORTS, exist_ok=True)
    runs, total = {}, {"complex_matmul": {}, "row_gather": {}, "line_fft": {}}
    run = lambda name, fn: program_run(runs, total, name, fn)  # noqa: E731
    path = lambda name: os.path.join(REPORTS, name)  # noqa: E731
    before = rung_counters()

    # ---- report, trace, verify: local and over 4 shards, clean ----
    for label, extra in (("", []), ("-shards4", ["--shards", "4"])):
        rc, _ = run(f"report{label}", lambda: report.main(
            [*PROGRAMS_GRID, *extra, "--no-compiled", "-o", path(f"report{label}.json")]))
        doc = read_json(path(f"report{label}.json"))
        card = doc["plan"]
        emit({"phase": "programs_report", "run": f"report{label}", "rc": rc,
              "missing": obs.validate_report(doc), "engine": card["engine"],
              "platform": card["platform"], "kind": card["kind"],
              "y_plan": card["execution"].get("sparse_y"), "exchange": card.get("exchange"),
              "degradations": card["degradations"], **runs[f"report{label}"]})
        check(rc == 0 and obs.validate_report(doc) == [], f"report{label}: {rc}")
        check(card["platform"] == "gpu" and card["engine"] == "mxu" and not card["degradations"],
              f"report{label}: {card['platform']} {card['engine']} {card['degradations']}")
        obs.trace.disable()  # the program arms a fresh recorder
        rc, printed = run(f"trace{label}", lambda: trace.main(
            [*PROGRAMS_GRID, *extra, "--last", "5", "-o", path(f"trace{label}.json"),
             "--chrome", path(f"trace{label}-chrome.json")]))
        snap = read_json(path(f"trace{label}.json"))
        names = sorted({e["name"] for e in snap["events"]})
        emit({"phase": "programs_trace", "run": f"trace{label}", "rc": rc,
              "missing": obs.trace.validate_trace(snap), "events": len(snap["events"]),
              "names": names, "dropped": snap["dropped"], **runs[f"trace{label}"]})
        check(rc == 0 and obs.trace.validate_trace(snap) == [] and "execute" in names,
              f"trace{label}: rc {rc}, names {names}")
        obs.trace.disable()
        sp.verify.breaker.reset()
        rc, _ = run(f"verify{label}", lambda: verify.main(
            [*PROGRAMS_GRID, *extra, "-o", path(f"verify{label}.json")]))
        doc = read_json(path(f"verify{label}.json"))
        emit({"phase": "programs_verify", "run": f"verify{label}", "rc": rc,
              "outcome": doc["outcome"], "residual": doc.get("roundtrip_residual"),
              "checks": doc["verification"].get("checks"),
              "degradations": doc["degradations"], **runs[f"verify{label}"]})
        check(rc == 0 and doc["outcome"] == "verified" and not doc["degradations"]
              and doc["roundtrip_residual"] <= ORACLE_RTOL["highest"],
              f"verify{label}: rc {rc}, {doc['outcome']}, {doc['degradations']}")
    no_rungs("programs (clean runs)", {}, before)

    # ---- verify armed: recovered under corrupt (exit 0), typed under strict nan (exit 3) ----
    for label, argv, want in (("verify-corrupt", ["--inject", "engine.execute=corrupt:1.0"], 0),
                              ("verify-strict-nan", ["--mode", "strict", "--inject",
                                                     "engine.execute=nan"], 3)):
        sp.verify.breaker.reset()
        rc, _ = run(label, lambda: verify.main([*PROGRAMS_GRID, *argv,
                                                 "-o", path(f"{label}.json")]))
        doc = read_json(path(f"{label}.json"))
        emit({"phase": "programs_verify", "run": label, "rc": rc, "outcome": doc["outcome"],
              "residual": doc.get("roundtrip_residual"),
              "degradations": [d["event"] for d in doc["degradations"]],
              "metrics": doc["metrics"], **runs[label]})
        check(rc == want, f"{label}: exit {rc}, want {want}")
        check(sp.faults.armed() == {}, f"{label}: faults left armed")
        if want == 0:
            check(doc["outcome"] == "verified"
                  and doc["roundtrip_residual"] <= ORACLE_RTOL["highest"]
                  and doc["degradations"], f"{label}: {doc['outcome']} {doc['degradations']}")
    sp.verify.breaker.reset()
    before = rung_counters()

    # ---- fbench, and its rows through perf_gate ----
    rc, _ = run("fbench", lambda: fbench.main(
        ["--dim", "256", "--radius", str(PROGRAMS_RADIUS), "--engine", "mxu", "--pairs", "8",
         "--repeats", "3", "--batches", "1", "4", "-o", path("fbench.json")]))
    doc = read_json(path("fbench.json"))
    rows = {r["key"].rsplit(":", 1)[1]: r for r in doc["rows"]}
    doubled = dict(doc, rows=[dict(r, gflops=2 * r["gflops"]) for r in doc["rows"]])
    with open(path("fbench-doubled.json"), "w") as f:
        json.dump(doubled, f)
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        gate_self = perf_gate.main([path("fbench.json"), path("fbench.json")])
        gate_doubled = perf_gate.main([path("fbench.json"), path("fbench-doubled.json")])
    emit({"phase": "programs_fbench", "rc": rc,
          "fused_ms": 1e3 * rows["fused"]["seconds_per_pair"],
          "staged_ms": 1e3 * rows["staged"]["seconds_per_pair"],
          "fused_over_staged": doc["fused_over_staged"],
          "batch_ms_per_transform": {k: 1e3 * r["seconds_per_transform"]
                                     for k, r in rows.items() if k.startswith("b")},
          "batch_over_single": doc.get("batch_over_single"),
          "noise": {k: r["seconds_noise"] for k, r in rows.items()},
          "perf_gate_self": gate_self, "perf_gate_doubled": gate_doubled, **runs["fbench"]})
    check(rc == 0 and rows["fused"]["fused"] and not rows["staged"]["fused"],
          f"fbench: rc {rc}")
    check(gate_self == 0 and gate_doubled == 3,
          f"perf_gate on fbench's rows: {gate_self} (self), {gate_doubled} (doubled)")

    # ---- dbench: strong scaling, slab and pencil, with the card's balance ----
    rc, _ = run("dbench", lambda: dbench.main([*DBENCH_ARGS, "-o", path("dbench.json")]))
    dbench_doc = read_json(path("dbench.json"))
    check(rc == 0 and obs.perf.validate_scaling_doc(dbench_doc) == [], f"dbench: rc {rc}")
    check(all(r["attribution"]["flop_per_byte"] == obs.perf.CUDA_FLOP_PER_BYTE
              for r in dbench_doc["rows"]), "dbench: a row without the card's balance")
    emit({"phase": "programs_dbench", "rc": rc, "device": dbench_doc["device"], "rows": [
        {"key": r["key"], "mesh": r["mesh"], "ms_per_pair": 1e3 * r["seconds_per_pair"],
         "gflops": r["gflops"], "noise": r["seconds_noise"],
         "exchange_fraction": r["exchange_fraction"], "residual": r["roundtrip_residual"]}
        for r in dbench_doc["rows"]], **runs["dbench"]})

    # ---- discipline_compare: wire bytes equal the plan cards', one round each ----
    for imbalance in (0.0, 0.5):
        label = f"discipline_compare-imb{imbalance}"
        rows, _ = run(label, lambda: discipline_compare.main(
            [*DISC_ARGS, "--imbalance", str(imbalance)]))
        cards = disc_cards(sp, imbalance)
        emit({"phase": "programs_discipline_compare", "imbalance": imbalance, "rows": rows,
              "card_wire_bytes": {f"{P}:{n}": b for (P, n), b in cards.items()}, **runs[label]})
        for r in rows:
            check(r["rounds"] == 1, f"{label}: {r}")
            if r["discipline"] in DISC_NAMES:
                check(r["wire_bytes"] == cards[r["P"], r["discipline"]],
                      f"{label}: {r} against the card's {cards[r['P'], r['discipline']]}")

    # ---- the examples, ProcessingUnit.GPU ----
    out, printed = run("example", lambda: example.main([]))
    emit({"phase": "programs_example", "run": "example", "roundtrip_error": out["roundtrip_error"],
          "last_line": printed.strip().splitlines()[-1], **runs["example"]})
    check(out["roundtrip_error"] <= EXAMPLE_RTOL, f"example: {out['roundtrip_error']}")
    out, printed = run("example_distributed", lambda: example_distributed.main([]))
    emit({"phase": "programs_example", "run": "example_distributed", **out,
          "lines": printed.strip().splitlines(), **runs["example_distributed"]})
    check(max(out["roundtrip_errors"].values()) <= EXAMPLE_RTOL,
          f"example_distributed: {out['roundtrip_errors']}")
    out, printed = run("poisson", lambda: poisson.main([]))
    emit({"phase": "programs_example", "run": "poisson", "residual": out["residual"],
          "lines": printed.strip().splitlines(), **runs["poisson"]})
    check(printed.strip().splitlines()[-1] == "OK", "poisson did not print OK")
    no_rungs("programs (fbench, dbench, discipline_compare, examples)", {}, before)

    # ---- profile and dbench's exchange shares, in a fresh process ----
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--programs-profile"],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the profile process failed: {proc.stderr[-3000:]}")
    *staged, last = proc.stdout.strip().splitlines()
    print("\n".join(staged), flush=True)  # its obs_stage_profile lines
    prof = json.loads(last)
    runs["profile"] = {"seconds": time.perf_counter() - t0, "k1_launches": sum(
        r["launches"][0] for r in prof["rows"].values()), "k2_launches": sum(
        r["launches"][1] for r in prof["rows"].values())}
    shares = prof.pop("dbench_shares")
    emit({**prof, **runs["profile"]})
    emit({"phase": "programs_dbench_exchange", "what": "each mesh row's model exchange_fraction "
          "(obs.perf.CUDA_FLOP_PER_BYTE) beside the exchange range's share of the same plan's "
          "staged twin's busy time", "rows": shares})
    check(len(shares) == sum(r["kind"] == "distributed" for r in dbench_doc["rows"]),
          f"dbench: {len(shares)} mesh rows profiled")
    for label, row in prof["rows"].items():
        ranges = row["ranges"]
        y = "y transform" if row["y_plan"] == "dense" else "y transform " + row["y_plan"]
        check(not row["perf_report_missing"]
              and abs(row["stages_sum_s"] - row["seconds_per_pair"])
              <= 1e-9 * row["seconds_per_pair"], f"profile {label}: the perf report")
        check(row["flop_per_byte"] == obs.perf.CUDA_FLOP_PER_BYTE, f"profile {label}: balance")
        # each DFT stage's kernel: K1, or the line FFT where it runs z or x
        dft = {"z transform": row["z_stage"], y: "k1", "x transform": row["x_stage"]}
        for stage, kernel in dft.items():
            check(ranges.get(stage, {}).get(f"{kernel}_kernels", 0) > 0,
                  f"profile {label}: no {kernel} kernel under {stage!r}: {ranges}")
        k2_ranges = ("expand", "pack") if row["y_plan"] == "dense" else (y,)
        for stage in k2_ranges:
            check(ranges.get(stage, {}).get("k2_kernels", 0) > 0,
                  f"profile {label}: no K2 kernel under {stage!r}: {ranges}")
        check(row["launches"][0] > 0 and row["launches"][1] > 0,
              f"profile {label}: launches {row['launches']}")

    # ---- the programs' local plan's kernel forms, their launches under the programs ----
    t = sp.Transform(sp.ProcessingUnit.GPU, sp.TransformType.C2C, *DIMS,
                     indices=sp.create_spherical_cutoff_triplets(*DIMS, PROGRAMS_RADIUS),
                     dtype=F32)
    check(t._exec.y_plan == "blocked", f"{PROGRAMS_NAME}: {t._exec.y_plan}")
    krows = []
    for form, spec, x, w, want_imag, o in k1_forms(PROGRAMS_NAME, t)[:2]:
        krow, key = run_k1(form, spec, x, w, want_imag, t.precision, o)
        krows.append((krow, PROGRAMS_NAME, "complex_matmul", key))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for form, src, idx in k2_forms(PROGRAMS_NAME, t, gen):
        krow, key = run_k2(form, src, idx)
        krows.append((krow, PROGRAMS_NAME, "row_gather", key))
    del t
    seconds = time.perf_counter() - started
    emit({"phase": "programs", "seconds": seconds, "budget_s": PROGRAMS_BUDGET_S, "runs": runs,
          "k1_launches": sum(total["complex_matmul"].values()),
          "k2_launches": sum(total["row_gather"].values())})
    check(seconds <= PROGRAMS_BUDGET_S, f"phase 13 took {seconds:.1f} s, over its budget")
    return krows, {PROGRAMS_NAME: total}


# ---- phase 14: the static-analysis gate and runtime lockdep ------------------------------

LOCKDEP_SERVE_S = 2.0  # closed-loop seconds per mode in each serving process
LOCKDEP_WINDOW = 16  # requests in flight in the closed loop (and the fixed payloads hashed)
LOCKDEP_TURNS = ("armed", "unarmed", "armed", "unarmed")  # serving processes, in this order
LOCKDEP_FLEET = 4  # requests through the two lockdep-armed serve_worker hosts


def lockdep_serve_worker(out_path: str) -> int:
    """``--lockdep-serve OUT``: phase 14's serving run in a fresh process,
    armed or not by the ``SPFFT_TPU_LOCKDEP`` it was started with: phase
    12's ``serve-128-c2c`` geometry served in process by a
    ``TransformService`` on the card, plain and with ``sched=True``. Per
    mode: the SHA-256 of the results of ``LOCKDEP_WINDOW`` fixed payloads,
    the K1/K2 host launches (the counts set to 0 just before the mode) and
    the transforms a second of a closed loop of ``LOCKDEP_SERVE_S`` seconds
    through the card's completion. Writes one JSON document to ``OUT``."""
    import hashlib

    import torch

    import spfft_tpu_torch as sp
    from spfft_tpu_torch.analysis import lockdep

    torch.backends.cuda.matmul.allow_tf32 = False
    dims = SERVE_DIMS
    trip, values = serve_problem(sp, dims, SERVE_RADIUS, SEED + 12)
    payloads = [values * (1.0 + 0.125 * k) for k in range(LOCKDEP_WINDOW)]
    c2c = sp.TransformType.C2C
    doc = {"armed": lockdep.installed(), "modes": {}}
    for mode, sched in (("plain", False), ("sched", True)):
        svc = sp.serve.TransformService(sp.ProcessingUnit.GPU, dtype=F32, sched=sched,
                                        queue_capacity=FLEET_QUEUE_CAP)
        try:
            clear_counts()
            submit = lambda: [svc.submit(c2c, dims, trip, p, tenant=f"t{k % SERVE_TENANTS}")
                              for k, p in enumerate(payloads)]
            digest = hashlib.sha256()
            for tk in submit():
                digest.update(tk.result(timeout=300).cpu().numpy().tobytes())
            served = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < LOCKDEP_SERVE_S:
                for tk in submit():
                    tk.result(timeout=300)
                served += len(payloads)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1, k2 = k_launches(launch_counts())
        finally:
            svc.close()
        doc["modes"][mode] = {"digest": digest.hexdigest(), "served": served, "wall_s": wall,
                              "transforms_per_s": served / wall, "k1_launches": k1,
                              "k2_launches": k2}
    with open(out_path, "w") as fh:
        json.dump(doc, fh)
    return 0


def lockdep_check(analyze, reports) -> str:
    """Cross-check lockdep report(s) with the gate's ``--lockdep-check``;
    fails the run unless it exits 0. Returns its summary line."""
    run = subprocess.run([sys.executable, analyze, "--lockdep-check", *reports],
                         capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, f"--lockdep-check {reports} exited {run.returncode}: "
          f"{run.stdout[-3000:]}{run.stderr[-2000:]}")
    return run.stdout.strip().splitlines()[-1]


def lockdep_rows(path) -> dict:
    """The locks, edges and blocking waits of one lockdep report."""
    doc = read_json(path)
    return {"counts": doc["counts"], "cycles": doc["cycles"],
            "locks": [f"{r['id']} ({r['kind']}, created {r['created']})" for r in doc["locks"]],
            "edges": [f"{e['from']} -> {e['to']} x{e['count']}" for e in doc["edges"]],
            "blocking": doc["blocking"]}


def lockdep_phase(sp, card) -> None:
    """Phase 14 (module docstring): the port's static-analysis gate on this
    checkout, lockdep-armed serving on the card in fresh processes against
    unarmed ones (bitwise, and transforms a second in turns), and two
    lockdep-armed ``serve_worker`` hosts; every report must cross-check."""
    import torch

    from spfft_tpu_torch import hostmesh
    from spfft_tpu_torch.serve.cluster import ClusterFront

    started = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    analyze = os.path.join(root, "spfft_tpu_torch", "programs", "analyze.py")

    # ---- (a) the gate ----
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, analyze, "--json", "-"], capture_output=True,
                         text=True, timeout=600, cwd=root)
    gate_s = time.perf_counter() - t0
    check(run.returncode == 0, f"the static-analysis gate exited {run.returncode}: "
          f"{run.stdout[-3000:]}{run.stderr[-2000:]}")
    doc = json.loads(run.stdout)
    check(doc.get("schema") == "spfft_tpu_torch.analysis/1" and len(doc["checkers"]) == 19,
          f"the gate's report is not the port's: {doc.get('schema')}, {len(doc['checkers'])}")
    check(doc["counts"]["new"] == 0 and doc["counts"]["stale_baseline"] == 0,
          f"the gate found {doc['counts']}")
    emit({"phase": "analysis_gate", "nvidia_smi": card, "wall_s": gate_s,
          "checkers": len(doc["checkers"]), "counts": doc["counts"]})

    # ---- (b) and (d): armed and unarmed serving processes, in turns ----
    out_dir = os.path.abspath(os.path.join(REPORTS, "lockdep"))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    turns = []
    for i, turn in enumerate(LOCKDEP_TURNS):
        env = dict(os.environ, SPFFT_TPU_LOCKDEP="1" if turn == "armed" else "0")
        env.pop("SPFFT_TPU_LOCKDEP_REPORT", None)
        report = os.path.join(out_dir, f"serve{i}.json")
        if turn == "armed":
            env["SPFFT_TPU_LOCKDEP_REPORT"] = report
        out = os.path.join(out_dir, f"turn{i}.json")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--lockdep-serve", out],
                             capture_output=True, text=True, timeout=600, env=env, cwd=root)
        check(run.returncode == 0, f"lockdep serving process {i} ({turn}) failed: "
              f"{run.stdout[-2000:]}{run.stderr[-3000:]}")
        res = read_json(out)
        res.update(turn=turn, process_s=time.perf_counter() - t0)
        check(res["armed"] == (turn == "armed"), f"process {i}: lockdep armed {res['armed']}")
        for mode, row in res["modes"].items():
            check(row["k1_launches"] > 0 and row["k2_launches"] > 0,
                  f"process {i} ({turn}, {mode}) launched K1 {row['k1_launches']} and "
                  f"K2 {row['k2_launches']} times")
        line = {"phase": "lockdep_serve", "nvidia_smi": card, "process": i, **res}
        if turn == "armed":
            line["lockdep_check"] = lockdep_check(analyze, [report])
            line["report"] = lockdep_rows(report)
            check(line["report"]["locks"], f"process {i}: the armed report records no lock")
        emit(line)
        turns.append(res)
    for mode in ("plain", "sched"):
        digests = {t["modes"][mode]["digest"] for t in turns}
        check(len(digests) == 1, f"lockdep {mode}: armed and unarmed results differ ({digests})")
    rates = {mode: {turn: [t["modes"][mode]["transforms_per_s"] for t in turns
                           if t["turn"] == turn] for turn in ("armed", "unarmed")}
             for mode in ("plain", "sched")}
    emit({"phase": "lockdep_rate", "nvidia_smi": card,
          "what": "transforms a second served in process (128^3 C2C float32, closed loop of "
          f"{LOCKDEP_WINDOW}, {LOCKDEP_SERVE_S} s a mode), lockdep-armed and unarmed processes "
          "in turns; results bitwise equal across all of them",
          **{mode: {**r, "armed_over_unarmed": statistics.median(r["armed"])
                    / statistics.median(r["unarmed"])} for mode, r in rates.items()}})

    # ---- (c) two lockdep-armed serve_worker hosts, one report each ----
    t0 = time.perf_counter()
    dims = SERVE_DIMS
    trip, values = serve_problem(sp, dims, SERVE_RADIUS, SEED + 12)
    host_dir = os.path.join(out_dir, "hosts")
    workers = hostmesh.spawn_workers(2, dtype="float32", lockdep_dir=host_dir,
                                     workdir=os.path.join(out_dir, "work"))
    try:
        front = ClusterFront([w.address for w in workers], queue_capacity=FLEET_QUEUE_CAP,
                             platform="gpu")
        try:
            payloads = [values * (1.0 + 0.5 * k) for k in range(LOCKDEP_FLEET)]
            tickets = [front.submit(sp.TransformType.C2C, dims, trip, p) for p in payloads]
            # the front resolves a ticket to the worker's result on the host
            errs = [serve_oracle_err(trip, p, dims, torch.as_tensor(tk.result(timeout=300)))
                    for p, tk in zip(payloads, tickets)]
        finally:
            front.close()
    finally:
        hostmesh.stop_workers(workers, timeout_s=60.0)
    check(max(errs) < SERVE_RTOL, f"lockdep fleet: results {errs} from the oracle")
    reports = [os.path.join(host_dir, f"host{i}.json") for i in range(2)]
    hosts = {}
    for i, path in enumerate(reports):
        check(os.path.exists(path), f"worker host {i} wrote no lockdep report")
        hosts[f"host{i}"] = {"lockdep_check": lockdep_check(analyze, [path]),
                             "report": lockdep_rows(path)}
    emit({"phase": "lockdep_fleet", "nvidia_smi": card, "oracle_err": errs,
          "requests": LOCKDEP_FLEET,
          "seconds": time.perf_counter() - t0, "merged_check": lockdep_check(analyze, reports),
          **hosts})
    emit({"phase": "lockdep", "nvidia_smi": card, "seconds": time.perf_counter() - started})


def turns_worker(root) -> int:
    """One tree's pair times (``--turns-worker ROOT``): ``spfft_tpu_torch``
    imported from ``ROOT``, every plan of ``TURN_PLANS`` and ``TURN_DIST``
    fused and staged, all taking turns (:func:`interleaved_pair_ms`); one
    JSON line. Uses only what the port's public API has had since the
    distributed slice, so that an older tree runs it too."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import _build

    check(sp.__file__.startswith(os.path.join(root, "")), f"imported {sp.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(LIBRARIES)
    data, plans, values = {}, {}, {}
    local = {p[0]: p for p in PLANS}
    dist = {p[0]: p for p in DIST_PLANS}
    for name in TURN_PLANS + TURN_DIST:
        kind, radius = (local[name][1], local[name][2]) if name in local else (dist[name][1], 0.659)
        if (kind, radius) not in data:
            data[kind, radius] = oracle(kind, radius)[:2]
        triplets, vals = data[kind, radius]
        ttype = getattr(sp.TransformType, kind.upper())
        for suffix, fuse in (("", True), (STAGED, False)):
            if name in local:
                _, _, _, precision, env, _, dtype = local[name]
                with knobs(env):
                    plans[name + suffix] = sp.Transform(
                        sp.ProcessingUnit.GPU, ttype, *DIMS, indices=triplets, dtype=dtype,
                        precision=precision, fuse=fuse)
                values[name + suffix] = torch.as_tensor(vals.astype(np.complex64), device="cuda")
            else:
                _, _, engine, exchange, dtype, *_ = dist[name]
                per = sp.distribute_triplets(triplets, 4, DIMS[1])
                plans[name + suffix] = sp.DistributedTransform(
                    sp.ProcessingUnit.GPU, ttype, *DIMS, per, mesh=sp.make_fft_mesh(4),
                    engine=engine, exchange_type=getattr(sp.ExchangeType, exchange),
                    dtype=dtype, fuse=fuse)
                values[name + suffix] = [torch.as_tensor(vals[i].astype(np.complex64),
                                                         device="cuda")
                                         for i in shard_index(triplets, per)]
    raw = {}
    interleaved_pair_ms(sp, plans, values, raw=raw)
    emit({"phase": "turns", "root": root, "pair_ms": raw})
    return 0


def against(others) -> int:
    """``--against DIR [DIR ...]``: this tree's pair times against each
    other tree's (a checkout of the same port, e.g. the parent commit
    unpacked with ``git archive``), one :func:`turns_worker` process per
    turn, in the order DIR..., this tree, this tree, ...DIR, twice, so that
    drift over the run falls on every tree alike; per plan the median and
    the least of the pairs of all of a tree's turns. The kernels are built once here and their libraries
    copied to the other trees, which load those whose sources hash the same
    and build the rest."""
    import torch

    check(bool(others), "--against needs at least one tree")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from spfft_tpu_torch import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build_all(LIBRARIES)
    here = os.path.dirname(os.path.abspath(__file__))
    others = [os.path.abspath(o) for o in others]
    for root in others:
        target = os.path.join(root, "build", "spfft_tpu_torch")
        os.makedirs(target, exist_ok=True)
        for f in os.listdir(_build.BUILD_DIR):
            src = os.path.join(_build.BUILD_DIR, f)
            # the kernels' libraries and logs; not the C library's build tree
            if os.path.isfile(src) and not os.path.exists(os.path.join(target, f)):
                shutil.copy2(src, target)
    order = [*others, here, here, *reversed(others)] * 2
    runs = {}
    for root in order:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--turns-worker", root],
                             capture_output=True, text=True, timeout=900)
        check(run.returncode == 0, f"worker on {root}: {run.stderr[-3000:]}")
        row = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        runs.setdefault(root, []).append(row["pair_ms"])
    pooled = {root: {plan: [x for r in rs for x in r[plan]] for plan in rs[0]}
              for root, rs in runs.items()}
    stats = {"median": statistics.median, "min": min}
    got = {s: {root: {plan: f(v) for plan, v in by.items()} for root, by in pooled.items()}
           for s, f in stats.items()}
    emit({"phase": "against", "card": card, "order": order,
          "what": "ms per host-facing pair, each plan and its staged twin taking turns "
                  "in each worker (6 rounds of 4 timed pairs); median and min over the "
                  "pairs of all of a tree's workers", "pair_ms": got,
          "over_this_tree": {s: {root: {p: got[s][root][p] / got[s][here][p]
                                        for p in got[s][here]} for root in others}
                             for s in stats}})
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    _build.build_all(LIBRARIES)
    report = build_report(LIBRARIES)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, **report})
    for name in LIBRARIES[:3]:
        check(report[name]["sass_hgmma"] > 0, f"{name} has no HGMMA instruction")
    # the float64 body runs on the FP64 tensor cores
    check(report["complex_matmul_f64"]["sass_dmma"] > 0, "complex_matmul_f64 has no DMMA instruction")
    # each library runs its precision's arithmetic: TF32 for "highest" (and its
    # bfloat16-constant form), BF16 below
    for name in ("complex_matmul", "complex_matmul_tf32x2"):
        check(report[name]["sass_hgmma"] > 0, f"{name} has no HGMMA instruction")
        check(report[name]["sass_hgmma_bf16"] == 0, f"{name} has BF16 HGMMA")
    for name in LIBRARIES[1:3]:
        check(report[name]["sass_hgmma_bf16"] > 0, f"{name} has no BF16 HGMMA instruction")

    # ---- the plans: each y variant as the JAX package's planner makes it ----
    # every plan fused (the default) with a fuse=False twin under name + STAGED
    t0 = time.perf_counter()
    data, plans, twins = {}, {}, {}
    make = lambda kind, radius, dtype=F32, **kw: sp.Transform(
        sp.ProcessingUnit.GPU, getattr(sp.TransformType, kind.upper()), *DIMS,
        indices=data[kind, radius][0], dtype=dtype, **kw)
    for name, kind, radius, precision, env, y_plan, dtype in PLANS:
        if (kind, radius) not in data:
            data[kind, radius] = oracle(kind, radius)
        with knobs(env):
            t = make(kind, radius, dtype, precision=precision)
            twins[name] = make(kind, radius, dtype, precision=precision, fuse=False)
        ex = t._exec
        got = ex.sy if ex.y_plan == "per-slot" else (
            [(ag, syg) for ag, syg, _, _ in ex.buckets] if ex.y_plan == "blocked" else None)
        emit({"phase": "plan", "plan": name, "precision": precision, "dtype": str(t.dtype),
              "y_plan": ex.y_plan,
              "num_sticks": t.params.num_sticks, "num_x_active": t.num_x_active,
              "buckets_or_sy": got, "describe": t.describe()})
        check(t.engine == "mxu", f"{name}: auto resolved to {t.engine} on the card")
        check(ex.y_plan == y_plan and twins[name]._exec.y_plan == y_plan,
              f"{name} engaged {ex.y_plan}, not {y_plan}")
        if y_plan != "dense":
            check(got == EXPECT[kind, radius], f"{name}: {got}, not {EXPECT[kind, radius]}")
        plans[name] = (t, precision, (kind, radius))
    for name, kind, radius in XLA_PLANS:
        t = make(kind, radius, engine="xla")
        twins[name] = make(kind, radius, engine="xla", fuse=False)
        emit({"phase": "plan", "plan": name, "engine": "xla", "describe": t.describe()})
        plans[name] = (t, "highest", (kind, radius))
    emit({"phase": "plans", "seconds": time.perf_counter() - t0})

    # ---- kernels against their plain versions, at the main path's shapes ----
    rows = []  # (row, plan, kernel, launch-count key)
    for name, (t, precision, _) in plans.items():
        if t.engine != "mxu":
            continue
        for form, spec, x, w, want_imag, out in k1_forms(name, t):
            row, key = run_k1(form, spec, x, w, want_imag, precision, out)
            rows.append((row, name, "complex_matmul", key))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for name in ("c2c", "r2c", "c2c-blocked", "r2c-blocked", "c2c-r0.5-dense"):
        for form, src, idx in k2_forms(name, plans[name][0], gen):
            row, key = run_k2(form, src, idx)
            rows.append((row, name, "row_gather", key))
    for precision in ("highest", "high", "default"):
        run_k1_odd(f"kernel_f32_odd_{precision}", torch.float32, K1_RTOL, precision)
    run_k1_odd("kernel_f64", torch.float64, K1_F64_RTOL)
    run_k2_odd()
    rows += line_fft_phase(sp, plans)

    # ---- the main path, every plan and its twin with the counts set to 0 just before ----
    counts, values = {}, {}
    for name, (t, precision, key) in plans.items():
        _, vals, want = data[key]
        counts[name], values[name] = main_path(sp, name, t, twins[name], precision, vals, want)
    no_rungs("main path", {**{n: v[0] for n, v in plans.items()},
                           **{n + STAGED: t for n, t in twins.items()}})
    for name in ("c2c-blocked", "r2c-blocked"):
        results_stay_put(sp, name, plans[name][0], values[name])
    batches = {name: batch_phase(sp, name, plans[name][0], values[name])
               for name in ("c2c-blocked", "r2c-blocked")}
    multi_transform_phase(sp, ("c2c-blocked", "r2c-blocked"), plans, values)

    # ---- the distributed phase: four shards on the card, and over a process group ----
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    with socket.socket() as sock:  # a free port for the group's rendezvous
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    group = sp.init_distributed(f"localhost:{port}", 1, 0, backend="nccl")
    dplans, dcounts, drows, dvalues, slab_results = dist_phase(sp, data, plans, values, group)
    rows += drows
    counts.update(dcounts)
    emit({"phase": "dist", "seconds": time.perf_counter() - t0})

    # ---- the pencil phase: a 2 x 2 pencil mesh on the card, and over the process group ----
    t0 = time.perf_counter()
    pplans, pcounts, prows, pvalues = pencil_phase(sp, data, plans, values, group, slab_results)
    emit({"phase": "pencil", "seconds": time.perf_counter() - t0})
    # ---- phase 6c: the OVERLAPPED exchange, stacked and over the process group ----
    orows, ocounts = overlap_phase(sp, data, group)
    rows += orows
    counts.update(ocounts)
    t0 = time.perf_counter()
    fdata = {key: data[key] for key in (("c2c", 0.659), ("r2c", 0.659))}  # for phase 9
    del data, slab_results
    rows += prows
    counts.update(pcounts)
    values.update(dvalues)
    values.update(pvalues)
    dplans.update(pplans)
    dvalues.update(pvalues)
    no_rungs("mesh phases", {**{n: t for n, (t, _) in dplans.items()},
                             **{n + STAGED: tw for n, (_, tw) in dplans.items() if tw is not None}})

    # ---- the profile, and the pair times with every plan and twin taking turns ----
    every = {**{n: v[0] for n, v in plans.items()}, **{n + STAGED: t for n, t in twins.items()},
             **{n: t for n, (t, _) in dplans.items()},
             **{n + STAGED: tw for n, (_, tw) in dplans.items() if tw is not None}}
    values.update({n + STAGED: values[n] for n in twins})
    values.update({n + STAGED: dvalues[n] for n, (_, tw) in dplans.items() if tw is not None})
    busy = {name: profile_pair(sp, name, t, values[name]) for name, t in every.items()}
    turns = interleaved_pair_ms(sp, every, values)
    emit({"phase": "compare", "what": "median ms per pair (host clock), all plans and their "
          "staged twins taking turns (6 rounds, 4 timed pairs per turn); device busy ms and "
          "K1/K2 ms of one profiled pair; same run", **{
              name: {"pair_ms_in_turns": turns[name], "device_busy_ms": busy[name]["device_busy_ms"],
                     "staged_pair_ms_in_turns": turns[name + STAGED],
                     "staged_device_busy_ms": busy[name + STAGED]["device_busy_ms"],
                     "k1_ms": busy[name]["k1_ms"], "k2_ms": busy[name]["k2_ms"],
                     "kernels": busy[name]["kernels"],
                     "staged_kernels": busy[name + STAGED]["kernels"]}
              for name in plans},
          "batch_ms_per_transform_pair": {n: b["ms_per_transform_pair"] for n, b in batches.items()}})
    dist_rows = {}
    for name, *_, local in DIST_PLANS:
        tw = name + STAGED if name + STAGED in turns else None
        dist_rows[name] = {
            "pair_ms_in_turns": turns[name], "device_busy_ms": busy[name]["device_busy_ms"],
            "staged_pair_ms_in_turns": turns[tw] if tw else None,
            "staged_device_busy_ms": busy[tw]["device_busy_ms"] if tw else None,
            "k1_ms": busy[name]["k1_ms"], "exchange_k2_ms": busy[name]["k2_ms"],
            "nccl_ms": busy[name]["nccl_ms"], "kernels": busy[name]["kernels"],
            "local_plan": local, "local_pair_ms_in_turns": turns[local],
            "local_device_busy_ms": busy[local]["device_busy_ms"],
            "pair_vs_local": turns[name] / turns[local],
            "busy_vs_local": busy[name]["device_busy_ms"] / busy[local]["device_busy_ms"],
        }
    emit({"phase": "compare_dist", "what": "the distributed plans against the local blocked "
          "plan of the same triplets: median ms per pair (host clock, in the same turns as "
          "the compare line), device busy ms of one profiled pair; exchange_k2_ms is the "
          "exchange's K2 gathers, nccl_ms its collective kernels", **dist_rows})
    pencil_rows = {}
    for name, *_, slab, local in PENCIL_PLANS:
        t, tw = dplans[name]
        by_stage = stage_profile(sp, name, t)["device_ms_by_stage"]
        staged = name + STAGED if tw is not None else name
        pencil_rows[name] = {
            "pair_ms_in_turns": turns[name] if tw is not None else None,
            "staged_pair_ms_in_turns": turns[staged],
            "device_busy_ms": busy[name]["device_busy_ms"] if tw is not None else None,
            "staged_device_busy_ms": busy[staged]["device_busy_ms"],
            "k1_ms": busy[name]["k1_ms"], "k2_ms": busy[name]["k2_ms"],
            "nccl_ms": busy[name]["nccl_ms"], "kernels": busy[name]["kernels"],
            "exchange_A_ms": sum(v for k, v in by_stage.items() if k.endswith(" A")),
            "exchange_B_ms": sum(v for k, v in by_stage.items() if k.endswith(" B")),
            "slab_plan": slab, "slab_pair_ms_in_turns": turns[slab],
            "slab_device_busy_ms": busy[slab]["device_busy_ms"],
            "local_plan": local, "local_pair_ms_in_turns": turns[local],
            "local_device_busy_ms": busy[local]["device_busy_ms"],
            "busy_vs_slab": busy[name]["device_busy_ms"] / busy[slab]["device_busy_ms"],
        }
    for name, (t, _) in dplans.items():
        if t._exec.collective:
            check(busy[name]["nccl_ms"] > 0,
                  f"{name}: no ncclDevKernel in the fused pair's profile: {busy[name]['top']}")
    emit({"phase": "compare_pencil", "what": "the pencil plans against their slab plan and the "
          "local blocked plan of the same triplets: median ms per pair (host clock, in the same "
          "turns as the compare line), device busy ms of one profiled pair; exchange_A_ms and "
          "exchange_B_ms the device ms of the staged twin's pack, exchange and unpack ranges "
          "of each exchange (obs_stage_profile)", **pencil_rows})

    # ---- phase 15, its first part: the compiled cards on the card ----
    compiled_phase(sp, {n: ((plans[n][0], twins[n]) if n in plans else dplans[n]) + (values[n],)
                        for n in COMPILED_PLANS})

    # ---- the obs phase: the cost of observability, then the benchmark program ----
    t0 = time.perf_counter()
    overhead_phase(sp, {"c2c-blocked": plans["c2c-blocked"][0],
                        "c2c-blocked" + STAGED: twins["c2c-blocked"]}, values["c2c-blocked"])
    del every, plans, twins, dplans, values, dvalues, busy
    bcounts, brows, _ = bench_phase(sp)
    counts.update(bcounts)
    rows += brows
    fence_timeout_phase()
    no_rungs("obs phase", {})  # its plans' cards are checked in bench_phase
    emit({"phase": "obs", "seconds": time.perf_counter() - t0})

    # ---- faults and verify: guard, verify and the ladder on the main path ----
    faults_phase(sp, fdata)

    # ---- tuning and scheduling: the tuned policy, wisdom, gbench, the legacy path ----
    trows, tcounts = tuning_phase(sp, fdata)
    rows += trows
    counts.update(tcounts)

    # ---- the C ABI on the card, and verification over the process group ----
    capi_bench = capi_phase(sp, fdata, group)
    del fdata

    # ---- serving on the card: the service, the cluster front, the fleet ----
    srows, scounts = serving_phase(sp)
    rows += srows
    counts.update(scounts)

    # ---- the programs and the examples on the card ----
    prows, pcounts = programs_phase(sp)
    rows += prows
    counts.update(pcounts)

    # ---- the static-analysis gate, and lockdep-armed serving on the card ----
    lockdep_phase(sp, card)

    # ---- phase 15, its second part: the installed C library ----
    packaging_phase(capi_bench)

    kernels = []
    for row, name, kernel, key in rows:
        launches = counts[name][kernel].get(key, 0)
        check(launches > 0, f"{row['name']} was not launched by the main path of {name}")
        kernels.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "call_ms", "bound_share")}
            | {"launches": launches}
            | {k: row[k] for k in ("precision", "fp32_bound_ms", "library_math", "library_tf32_ms",
                                   "k1_ms") if k in row})
    # the fused plans over the group hold NCCL's kernels in their graphs:
    # shutdown_distributed drops them before it destroys the group
    sp.shutdown_distributed()
    emit({"phase": "done", "seconds": time.perf_counter() - started})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turns-worker"]:
        sys.exit(turns_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--against"]:
        sys.exit(against(sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-profile"]:
        sys.exit(serve_profile_worker(float(sys.argv[2])))
    if sys.argv[1:2] == ["--programs-profile"]:
        sys.exit(programs_profile_worker())
    if sys.argv[1:2] == ["--stage-profile"]:
        sys.exit(stage_profile_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--lockdep-serve"]:
        sys.exit(lockdep_serve_worker(sys.argv[2]))
    sys.exit(main())
