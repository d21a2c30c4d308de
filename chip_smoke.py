#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (smpltpu_torch) once on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the port's kernels from ``smpltpu_torch/csrc`` and runs, in order:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 must be off.
2. build: nvcc time and the compiler's register/spill report.
3. K1 (arrowhead PCG) against its plain PyTorch version in float32 on
   random SPD arrowhead systems, 40 CG steps: a sweep over window counts
   W in {1, 3, 67}, frames per window F in {1, 7, 20, 33, 100, 150, 160,
   400}, nS in {7, 10, 16} and P in {76, 31} (the fit's 76, and the small
   model's 31, which is not a multiple of 4), with the tolerance exit and
   a forced one-CTA plan whose vectors live in global scratch; each case
   printed with its launch plan (cluster size, resident frames, shared
   bytes), run twice and required bitwise identical. Then the stage-2
   (67 x 20) and stage-1 (1 x 100) shapes timed under the plan's cluster
   size and one alternative (the layouts). ``3 k1_long``: the same at the
   long-video shapes, 64 CG steps: (1, 1000), (1, 10 000) (the vectors in
   global scratch) and (667, 20), each with its plan and scratch bytes.
4. K2 (blendshapes + skinning) against its plain version: 100 frames of
   the full-width model (timed), 1 and 37 frames (a ragged frame tile),
   the 300-vertex model, and a 7-shape model through the kernel's
   run-time-width instantiation.
5. the main path: the 1000-frame synthetic workload of bench.py through
   the fused two-stage fit with ``linear="pcg_kernel"`` (one warm-up run,
   whose first LM iteration's K1 systems, one per stage, are also checked
   against the plain version: see ``k1_compare`` for the tolerance on
   these ill-conditioned systems; then a timed run), write-back, skinning
   of all frames through K2, two frames rendered with the host painter;
   then the same fit with the plain PCG, which must land within 0.1 px;
   then once more with the exact solve (``linear="tridiag"``, the
   library's and the CLI's default): residual under 2.0 px, no K1 launch
   (phase ``5 main_path_tridiag``); then with the other exact solve,
   cyclic reduction (``5 main_path_cr``), within CR_TRIDIAG_GAP_MAX_PX of
   tridiag's residual; then ``5 jvp_assembly``: the warm-up's first
   stage-2 normal-equation pieces by ``jacobian="jvp"`` against the
   analytic ones, float32 and float64. Before the timed fit, phase 7
   takes the same first LM iteration's systems through both exact solves
   (``7 tridiag_*``, ``7 cr_*``) in float32 under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), held to
   float64 and to a dense float64 solve (and cr's float64 to tridiag's),
   with K1's 40-step answer's distance from it (PCG's truncation), the ms
   per solve and the device launches per solve; ``7 exact_long`` times
   both on one random window of 1000 and of 4000 frames.
6. the render stage: K3 (the z-buffer rasterizer) through both entry
   points, ``rasterize`` from a face setup and ``rasterize_verts`` from the
   vertices, each pixel-exact against the plain version, and the setup
   kernel's key, coefficients and boxes bit for bit against the plain
   setup, on one triangle, an occluding pair, culled faces, a mesh partly
   off screen, a near face over most of the frame, 8 fitted frames, a
   batch with an empty frame in it, a batch of one (all at 1280 x 720), a
   250 x 130 frame that no tile divides and one frame at 270 x 480 (the
   CLI's video1 frames); 100 fitted frames, run twice
   (identical) and timed through both entry points beside the eager
   setup; then all 1000 fitted frames rendered through K2 -> K3 on the
   device (``render_frames``), with the launch counts and peak memory of
   that run, every frame's coverage, and two frames held against the host
   painter's coverage; then one more pass under the profiler.
7. the single-frame path, phases ``9 single_*`` (``single_phases``):
   bench.py's BENCH_SINGLE workload, the first 128 frames of the same
   video, one LM problem a frame in one batch: timed after a one-trip
   warm-up, its trips, device launches and host syncs a trip, one trip
   under ``torch.cuda.set_sync_debug_mode("error")``, held to the port's
   own float64 fit; the float64 fit with ``tr_solver="eigh"`` against
   chol's; the GMM prior with a start per component; all 1000 frames in
   chunks of 128 against one batch.
8. the streaming path, phases ``10 stream_*`` (``stream_phases``):
   bench.py's BENCH_STREAM, BENCH_STREAM_SCAN and BENCH_STREAM_PUMP
   workload, the first STREAM_FRAMES frames with the shape of the timed
   fit's stage 1: the online trip's factorizations and solves captured
   into CUDA graphs at batch 1 under sync-debug "error"; the eager step
   loop (latency, LM trips, device launches and host syncs a trip); the
   causal replay on the CUDA graph of one LM trip and the request pump,
   each held to the step loop within STREAM_AGREE_MAX of scale; held
   frames bit-equal to the frame before in all three paths; the step loop
   in float64, its mean px against float32's.
9. the port's CLIs through ``main(argv)`` on the card, each run in a
   directory under ``build/chip_smoke_cli`` (removed afterwards), phases
   ``8 cli_*``: ``cli_default`` (the full-width synthetic model on
   data/keypoints/video1 and its 480 x 270 frames, the default argv:
   sequential windows, the exact solve, the host painter), ``cli_golden``
   (the model of tests/test_fullres_golden.py on blank 1280 x 720 frames,
   its argv with 400 stage-2 iterations, plus --jax-render; log.csv held
   row by row to tests/data/fullres_golden_video1_mesh1.npz),
   ``cli_cr`` (cli_golden's argv with --linear cr: its mean held to the
   CPU run's, its rows to cli_golden's within the golden's bound),
   ``cli_kernels`` (the golden's argv at full width with --fused-stages
   --linear pcg_kernel --jax-render beside --linear pcg on the sequential
   stages) and ``cli_single`` (the single CLI, the full-width model on
   video1 with ``CLI_SINGLE_ARGV``, its mean held to the CPU run's), then
   the stream CLI four ways (``cli_stream*``: ``--jax-render``, ``--scan
   --warm-timing``, ``--pump`` and ``--use-gmm`` with the prior of
   data/avatar-model, the full-width model on video1; each mean held to
   the CPU run's, the three stream paths' rows to each other). Every K3
   launch of the runs with K3 is held pixel-exact against
   ``rasterize_torch``; each line carries the run's wall s, stage ms (the
   stream CLI's latency line) and kernel launches. ``8 api_fit_video``:
   the library's ``fit_video(mode="stream", want_verts=True)`` on phase
   10's frames (K2 in its evaluation).
10. the multi-device path (``smpltpu_torch/parallel``), phases ``11 *``
   (``mesh_phases``), one rank over NCCL on the one card (the JAX CLI's
   ``--mesh 2`` on a one-device host): ``mesh_window`` (window DP of phase
   5's 67 windows with K1, bitwise equal to the unsharded batched fit),
   ``mesh_lm`` (the frame-sharded LM as stage 1 on the 100 anchors,
   MESH_LM_TRIPS trips: wall time, device launches, host syncs and NCCL
   calls a trip, two trips under sync-debug "error", its anchors' px and
   cost against phase 5's exact stage 1 (``linear="tridiag"``), and at
   MESH_F64_DEPTH trips float32 against float64), ``mesh_frame``
   (frame DP of phase 9's 128 frames, bitwise equal to phase 9's fit),
   ``graft_entry``
   (``smpltpu_torch/graft_entry.py::entry()`` with K1 and K2, the host's
   launch floor against ``utils/roofline.py::DISPATCH_FLOOR_S``), and
   ``cli_mesh*`` (the multi and single CLIs with ``--mesh 2``,
   ``CLI_MESH_RUNS``: each mean held to the CPU run's, every K3 launch
   pixel-exact).
11. the host runtime, phase ``12 host_native``: video1 and 1000 synthetic
   keypoint files parsed by the C++ parser (``smpltpu_torch/native``,
   built with g++ at first use) and by the Python one, bit-equal; one
   fitted frame at 1280 x 720 filled by the C++ fill and the numpy fill,
   bit-equal; each timed.
12. the long-video configuration of bench.py (BENCH_FRAMES 10 000 and
   100 000, BENCH_CHUNK=67, BENCH_CG_ITERS=64; ``long_phases``), each run
   from zeroed launch counts: ``5 long_10k_chunked`` (the multi CLI's
   sequential route for long videos, ``--batched-windows
   --init-from-anchors --window-chunk 67``: stage 1 on the 1000 anchors as
   one window, the anchors to the host, the CLI's interpolation loop and
   window packing, stage 2 through ``build_chunked_window_fit``; each
   part timed; K1's launches by shape against the trips; the full-batch
   residual; the first K1 system of each shape against the plain
   version), ``5 long_10k_batch`` (the same video through the fused
   two-stage fit, stage 2 as one batch of 667 windows, within
   LONG_GAP_MAX_PX of the chunked residual; ``chunk_gap``: where the two
   differ per window, in cost and in the keypoints, and the worst
   window's chunk against one batch in float64 on the same inputs, the
   CG held to the port's PCG tolerance and the exact solve to 1e-8),
   ``6 render_10k`` (``render_frames`` over the 10 000 fitted frames at
   1280 x 720: 100 K2 and 100 K3 launches, every frame covered, three
   frames against the host painter, the memory beside the output; the
   last 100-frame chunk again on its own inputs, K2 against plain ``lbs``
   and K3 and the render's frames pixel-exact against the plain
   rasterizer, each timed), ``5 long_100k_stage1`` (the 100 000-frame
   video's stage 1 alone: 10 000 anchors in one window, K1 at 1 x 10 000,
   75 of bench.py's 150 trips; the anchors' residual, peak memory, its
   first K1 system against plain, three trips under the profiler).
13. bench.py's twin as a user runs it, phase ``13 bench``
   (``bench_phase``): ``python -m smpltpu_torch.bench`` in a process of its
   own, twice (``BENCH_RUNS``): (a) ``BENCH_LINEAR=pcg_kernel
   BENCH_RENDER=1`` at 1000 frames (K1, K2, K3); (b) 100 frames with the
   stream modes (10 frames) and BENCH_SINGLE with the GMM quality gate,
   and no fused fit (BENCH_FUSE_STAGES=0: (a) holds it). Each: exit code
   0, one stdout line with bench.py's four keys, the stderr records its
   modes print with bench.py's keys, both residuals under 2.0 px, K1's
   launches equal to the LM trips the run printed (by system shape, its
   untimed first runs included), K2 and K3 once per 100-frame chunk of the
   render and its first chunk.
14. one more fit under torch.profiler, at a fifth of the depth (30 + 12
   LM iterations: the profiler takes half a minute to digest a full
   fit's records), phase ``5 fit_profile``: device busy ms, K1's ms and
   launches, the idle share; last, so that the profiler's cost touches
   none of the timings above.

    python3 chip_smoke.py --k1-layouts

times K1 instead under every cluster size at the stage shapes and a few
others (phases 1-3, no main path and no result line): the measurement
behind ``ops/cg.py::k1_plan``'s rule.

    python3 chip_smoke.py --long

runs phases 1-3 (limits), then bench.py's whole 100 000-frame video
(``5 long_100k``: the CLI's sequential route, stage 1 on 10 000 anchors,
the host interpolation of 100 000 frames, 6667 windows in chunks of 67;
``5 long_100k_batch``: the fused fit, the 6667 windows as one batch), its
render at
bench.py's default 270 x 480 (``6 render_100k``) and the
10 000-frame chunked fit with ``linear="pcg_block"`` beside
``pcg_kernel`` (``5 long_10k_pcg_block``), and ends with the result line
(no kernels' line); a few minutes, too slow for the default run.

    python3 chip_smoke.py --bench-default

runs phases 1 and 2, then bench.py's twin once with no BENCH_* variable
set (bench.py's defaults: the plain PCG loop, no K1), checked as phase 13
checks its runs, and ends with the result line.

    python3 chip_smoke.py --k2

runs phases 1, 2 and the 100-frame case of phase 4 only: K2's time by
both measures below. A copy of this script in another checkout of the
port times that checkout's K2 the same way.

Every kernel's line carries its bound: the larger of its bytes (inputs
read once, outputs written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, the H100 SXM's published peaks. K2's and K3's
``ms`` is taken with the calls captured into a CUDA graph, so that a
kernel shorter than the host's time to enqueue it is timed on the device;
``event_ms`` beside it is the time between CUDA events around eager calls
of the wrapper, the host's enqueueing included.

Each phase prints one line. The line before the last is the kernels' JSON
summary, the last line ``{"ok": true, "device": {...}}``. A failed check
ends the run with exit code 1 and no result line; so does a machine with
no CUDA device, or a directory without the port.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

N_FRAMES, WSIZE, OVERLAP, SKIP = 1000, 20, 5, 10
S1_ITERS, S2_ITERS, CG_ITERS = 150, 60, 40
K1_TOL = 2e-4        # relative to the solution's scale (tests/test_cg_kernel.py)
K2_ATOL = 1e-5       # metre-scale vertices, float32
RENDER_PEAK_MAX_GIB = 2.19   # 0.3 below the render with a z-buffer in device memory
RESIDUAL_MAX_PX = 2.0
PLAIN_GAP_MAX_PX = 0.1
PROFILE_DEPTH = 5             # the profiled fit runs 1/5 of the LM iterations
TRIDIAG_F32_MAX = 1e-3        # exact solve, f32 vs f64, relative to scale
TRIDIAG_DENSE_MAX = 1e-8      # exact solve in f64 vs a dense f64 solve
# 5 main_path_cr: the cr fit's full-batch residual against tridiag's (both
# exact solves of the same steps; only f32 rounding parts them)
CR_TRIDIAG_GAP_MAX_PX = 0.01
# 5 jvp_assembly: the forward-mode pieces against the analytic ones, each
# relative to the piece's scale: float64 to rounding; float32 jvp within
# twice the float32 analytic pieces' distance from float64, plus this
JVP_F64_MAX, JVP_F32_SLACK = 1e-10, 1e-5
# 12 host_native: the synthetic keypoint directory's size
NATIVE_FILES = 1000
# 7 exact_long: the exact solves on one random window of these many frames
# (d is 92 MB in f32 at 4000); tridiag's launches counted at two sizes
EXACT_LONG_F, EXACT_LONG_PROFILE_F = (1000, 4000), (100, 200)
CLI_DEFAULT_MEAN_MAX_PX = 4.0  # cli_default's mean log.csv error (CPU: 2.39)
CLI_FUSED_GAP_MAX_PX = 0.5     # tests/test_fused_cli.py:57
# cli_cr: the golden's argv with --linear cr; the port's CPU run's log.csv
# mean (tests/test_torch_cli.py::test_cli_fullres_golden_cr's run, measured
# once with torch 2.13 on the CPU) and the gap allowed on the card
CLI_CR_CPU_MEAN_PX, CLI_CR_GAP_MAX_PX = 6.719750422697801, 0.05
# cli_golden, as tests/test_torch_cli.py holds the port to the pin the JAX
# CLI recorded with --mesh 1 (tests/data/fullres_golden_video1_mesh1.npz):
# per row the reference's own spread there, then 1 % + 0.02 px; the mean
# under 7.5 px
GOLDEN_RTOL, GOLDEN_ATOL, GOLDEN_MEAN_MAX = 0.01, 0.02, 7.5
# the golden's argv (tests/test_fullres_golden.py:35-37), which
# cli_kernels runs, and cli_golden's: the same with every window converged
# (tests/test_torch_cli.py::GOLDEN_MESH1_ARGV)
GOLDEN_ARGV = ["150", "60", "10", "20", "5", "5.0", "25.0", "3.0",
               "--s2-iters", "60", "--batched-windows", "--data-init",
               "--init-from-anchors"]
GOLDEN_MESH1_ARGV = GOLDEN_ARGV[:9] + ["400"] + GOLDEN_ARGV[10:]
# phase 9, bench.py's BENCH_SINGLE workload (bench.py:649-850): the first
# 128 frames, the single CLI's defaults max_iters=100, beta_pose=20,
# beta_shape=30; the GMM run at beta_pose=5 with a start per component
SINGLE_FRAMES, SINGLE_ITERS, SINGLE_CHUNK = 128, 100, 128
SINGLE_BETA_POSE, SINGLE_GMM_BETA = 20.0, 5.0
SINGLE_F64_GAP_MAX_PX = 0.1    # the f32 fit's mean px against f64's
SINGLE_FLIP_PX = 0.5           # a frame further apart is printed as a flip
CHOL_EIGH_RTOL = 1e-4          # tests/test_single_frame_solver.py:202
SINGLE_PROFILE_TRIPS = 10      # the profiled and sync-counted run
# cli_single: the port's single CLI on video1 with the full-width model;
# its log.csv mean on the CPU (tests/test_torch_single_cli.py) and the gap
# allowed on the card
CLI_SINGLE_ARGV = ["--multi-start", "--jax-render", "--freeze-scale"]
CLI_SINGLE_CPU_MEAN_PX, CLI_SINGLE_GAP_MAX_PX = 8.839078050671201, 0.05
# phase 10, bench.py's BENCH_STREAM, BENCH_STREAM_SCAN and BENCH_STREAM_PUMP
# rows (bench.py:513-630): from the init pose with no previous frame, the
# shape of phase 5's stage 1, f32; the first 100 frames where bench.py
# streams 200 (the eager loop takes ~0.2 s a frame on the card, and the
# smoke would pass ~220 s at 200: PERF.md section 4)
STREAM_FRAMES, STREAM_HOLD_FRAMES = 100, 30
STREAM_CFG = dict(beta_pose=5.0, lambda_temporal=3.0, max_iters=20)
STREAM_AGREE_MAX = 1e-4        # scan and pump against the step loop, of scale
STREAM_F64_GAP_MAX_PX = 0.1    # the f32 loop's mean px against f64's
STREAM_PROFILE_TRIPS = 10      # the profiled one-frame step
STREAM_PROFILE_FRAMES = 5      # the profiled scan (the profiler digests
                               # ~900 records a trip slowly)
# cli_stream: the port's stream CLI on video1 with the full-width model,
# four argvs; each log.csv mean held to the port's CPU run of the same argv
# (smpltpu_torch.pipeline.stream.main(argv, device="cpu"), measured once
# with torch 2.13 on the CPU), the three stream paths' rows to each other
CLI_STREAM_RUNS = (
    ("cli_stream", ["--jax-render"], 2.7063452438874678),
    ("cli_stream_scan", ["--scan", "--warm-timing"], 2.7063452438874678),
    ("cli_stream_pump", ["--pump"], 2.7063452438874678),
    ("cli_stream_gmm", ["--use-gmm", "--pose-prior",
                        "data/avatar-model/pose_prior.txt"], 8.501055887251189),
)
CLI_STREAM_GAP_MAX_PX, CLI_STREAM_ROWS_AGREE_PX = 0.05, 1e-4
H_R, W_R = 1280, 720          # render size: the bench camera at full size
# the render's device memory beside its output (gray and covered, 2 bytes
# a pixel): phase 6's bound less its 1000 frames' output
RENDER_WORK_MAX_GIB = RENDER_PEAK_MAX_GIB - 1000 * H_R * W_R * 2 / 2 ** 30
DEV_IN_HOST_MIN, HOST_IN_DEV_MIN = 0.95, 0.80   # tests/test_jax_raster.py
# phase 11: the multi-device path on one rank; cli_mesh's argvs with the
# port's CPU run's log.csv mean (smpltpu_torch.pipeline.multi / single
# .main(argv, device="cpu"), two gloo ranks, the full-width model on video1)
MESH_PROFILE_TRIPS = 3         # the profiled and sync-counted LM runs
# phase 11's cuts of depth (PERF.md section 4): the sharded LM runs 110 of
# stage 1's 150 trips (it converges at trip 101 on this workload, and a
# converged state is frozen), its float64 twin 20 beside float32's 20
MESH_LM_TRIPS, MESH_F64_DEPTH = 110, 20
# mesh_lm against phase 5's exact stage 1 (its anchors' full-batch px and
# relative cost; read 8.6e-5 px and 2.0e-5) and float32 against float64 at
# MESH_F64_DEPTH trips (read 1.76e-5 px, twice); PERF.md section 6
MESH_EXACT_GAP_MAX_PX, MESH_EXACT_COST_RTOL = 3e-4, 1e-4
MESH_F64_GAP_MAX_PX = 1e-4
LAUNCH_FLOOR_BAND = 1.5        # graft_entry: the launch floor's reading
                               # within this factor of DISPATCH_FLOOR_S
CLI_MESH_RUNS = (
    ("cli_mesh", "multi", ["20", "60", "10", "20", "5", "5.0", "25.0", "3.0",
                           "--s2-iters", "60", "--batched-windows",
                           "--data-init", "--init-from-anchors", "--linear",
                           "pcg_kernel", "--jax-render", "--mesh", "2"],
     2.327094779564784),
    ("cli_mesh_single", "single", CLI_SINGLE_ARGV + ["--mesh", "2"],
     8.840150977625992),
)
CLI_MESH_GAP_MAX_PX = 0.05
# phase 3's K1 cases: (label, windows W, frames F, row block P, shapes nS,
# rtol, forced cluster size or None for the plan's own choice)
K1_SWEEP = (
    ("stage2", 67, 20, 76, 10, 0.0, None),
    ("stage1", 1, 100, 76, 10, 0.0, None),
    ("stage2_rtol", 67, 20, 76, 10, 0.05, None),
    ("f1", 1, 1, 76, 10, 0.0, None),
    ("f7_ns16", 3, 7, 76, 16, 0.0, None),
    ("f20_w1_ns16", 1, 20, 76, 16, 0.0, None),
    ("f33", 3, 33, 76, 10, 0.0, None),
    ("stage1_ns16", 1, 100, 76, 16, 0.0, None),
    ("f150", 1, 150, 76, 10, 0.0, None),
    ("f160_ns16", 3, 160, 76, 16, 0.0, None),
    ("f400", 1, 400, 76, 10, 0.0, None),
    ("f400_rtol", 1, 400, 76, 16, 0.05, None),
    ("f160_one_cta_scratch", 2, 160, 76, 10, 0.0, 1),
    ("p31_f100", 1, 100, 31, 10, 0.0, None),
    ("p31_f33_ns7", 3, 33, 31, 7, 0.0, None),
)
# phase 3 layouts: at each stage shape, the plan's cluster size and this
# alternative (one CTA per window in one wave; the largest cluster)
K1_ALTERNATIVE = {(67, 20): 1, (1, 100): 16}
# phase 4's K2 cases: (label, options of the synthetic model, frames)
K2_CASES = (("b100", {}, 100), ("b1", {}, 1), ("b37", {}, 37),
            ("b37_nv300", {"n_verts": 300}, 37),
            ("b37_ns7", {"n_shapes": 7}, 37))
# --k1-layouts: every cluster size at these (W, F, P) shapes
K1_LAYOUT_SHAPES = ((67, 20, 76), (1, 100, 76), (3, 33, 76), (1, 150, 76),
                    (1, 400, 76), (1, 100, 31))
# the long-video configuration of bench.py (BENCH_FRAMES=10000 and
# 100000, BENCH_CHUNK=67, BENCH_CG_ITERS=64; bench.py:96-103, :148-160,
# :236-241): stage 1 on every 10th frame as one window, stage 2 in chunks
# of 67 windows, 64 CG steps
LONG_FRAMES, LONG_FRAMES_XL = 10_000, 100_000
LONG_CHUNK, LONG_CG_ITERS = 67, 64
LONG_GAP_MAX_PX = 0.01         # the 10k video chunked against one batch
# the 10k stage 2 in chunks against one batch. float64 on the same
# inputs: the exact solve over all trips to tests/test_torch_tridiag.py's
# 1e-9 in cost and 1e-8 in params; in the CG's first trip, the systems a
# chunk and the batch hand the CG within SYSTEM_GAP of their scale, and
# the CG on one system, in the batch and alone, within SYSTEM_GAP through
# CG_SHALLOW_STEPS steps (a window's CG reads its own window only; the
# batch width moves the summation order, ~1e-16). The CG's gap after
# PCG_GAP_TRIPS trips and CG_GAP_STEPS steps is reported. float32, the two
# runs: the final cost of every window that converged in both within the
# size a wrong term moves it by (1e-3, tests/test_torch_fit.py), the
# median window within the port's PCG cost tolerance (2e-5)
EXACT_GAP_COST, EXACT_GAP_PARAM = 1e-9, 1e-8
SYSTEM_GAP, CG_SHALLOW_STEPS = 1e-12, 16
PCG_GAP_TRIPS = (1, 5, 20, S2_ITERS)
CG_GAP_STEPS = (1, 2, 4, 8, 16, 32, 64)
CONVERGED_COST_GAP, MEDIAN_COST_GAP = 1e-3, 2e-5
LONG_PROFILE_TRIPS = 3         # the profiled window of the 100k stage 1
# the 100k stage 1 alone runs half of bench.py's 150 trips: at ~98 ms a
# trip, device bound, the whole of it added 15 s to the smoke (--long runs
# all 150 as part of the whole video)
LONG_XL_S1_ITERS = 75
# phase 3's long K1 cases (label, W, F): the 10k and 100k videos' stage 1
# and the 10k video's stage 2 as one batch
K1_LONG = (("1x1000", 1, 1000), ("1x10000", 1, 10000), ("667x20", 667, 20))
# --long's render: bench.py's default scale, 0.375 of the 720 x 1280
# camera (bench.py:378-380), H x W
H_LONG, W_LONG = 480, 270


# phase 13: bench.py's twin, ``python -m smpltpu_torch.bench``, run as a
# user runs it, in a process of its own: (a) K1, the render (K2, K3) at
# 1000 frames; (b) the stream and single-frame modes with the GMM gate,
# without the fused fit that (a) already holds (BENCH_FUSE_STAGES=0).
# Cuts of (b), in the order the phase's 60 s asked for them: its stream
# from 50 frames to 10 (the eager per-frame step takes ~0.23 s a frame;
# the phase took 85 s with 50), then its video from 200 frames to 100
# (the phase took 78 s at 200 without the fused fit)
BENCH_RUNS = (
    ("bench_render", {"BENCH_LINEAR": "pcg_kernel", "BENCH_RENDER": "1"}),
    ("bench_modes", {"BENCH_FRAMES": "100", "BENCH_LINEAR": "pcg_kernel",
                     "BENCH_FUSE_STAGES": "0", "BENCH_STREAM": "1",
                     "BENCH_STREAM_SCAN": "1", "BENCH_STREAM_PUMP": "1",
                     "BENCH_STREAM_FRAMES": "10", "BENCH_SINGLE": "1",
                     "BENCH_SINGLE_GMM": "1"}),
)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
# each stderr record bench.py prints in these modes, with its keys
BENCH_RECORDS = {
    "fused_two_stage_frames_per_sec": {"metric", "value", "unit",
                                       "sequential_fps"},
    "stream_pump_latency_ms": {"metric", "value", "unit", "p95_ms",
                               "mean_ms"},
    "single_frame_throughput_frames_per_sec": {
        "metric", "value", "unit", "residual_px", "starts", "gmm", "tr"},
}
BENCH_TIMEOUT_S = 600
# bytecode of every module that the run and the processes it starts import,
# kept in the checkout: where the interpreter cannot write beside a
# package's sources, each new process compiled torch from source again
# (~1400 modules, ~5 s of phase 13's two processes each)
PYCACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "pycache")


def bound(n_bytes, n_flops):
    """(bound_ms, bound_by): the least time for the bytes and the float32
    operations at the card's peaks (``smpltpu_torch/utils/roofline.py``)."""
    from smpltpu_torch.utils.roofline import PEAK_F32_FLOPS, PEAK_HBM_BPS
    t_b, t_o = n_bytes / PEAK_HBM_BPS, n_flops / PEAK_F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


T_START = time.perf_counter()


def _plain(value):
    """numpy scalars as Python numbers in the phase lines."""
    return value.item() if hasattr(value, "item") else str(value)


def phase(label, /, **fields):
    """One phase's line; ``at_s`` is the script's wall time when it ends."""
    fields["at_s"] = time.perf_counter() - T_START
    print(f"phase {label}: {json.dumps(fields, default=_plain)}", flush=True)


class Checks:
    """Collects failed checks so that one run reports all of them."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        if not ok:
            self.failed.append(what)
            print(f"CHECK FAILED: {what}", flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Device milliseconds per call of fn(): reps calls captured into one
    CUDA graph and replayed between two events, so the kernels run back to
    back and the host's time to enqueue them (more than a short kernel
    takes) is not in it."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_arrow_system(rng, w, f, device, scale=1.0, p=76, n_s=10):
    """Random SPD arrowhead systems in the solver's layout, float32 on the
    device: the construction of tests/test_cg_kernel.py, batched, with B
    scaled by sqrt(6/F) so the shape Schur complement C - Bt T^-1 B stays
    as far from singular as at its F = 6 (unscaled, B's columns grow with
    sqrt(F) and the system is indefinite past F ~ 12)."""
    import torch

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    a = t(rng.normal(size=(w, f, p, p)) * 0.1)
    d = a @ a.transpose(-1, -2) + 2.0 * torch.eye(p, device=device)
    off = t(-np.abs(rng.normal(size=(w, f - 1))) * 0.05 * scale)
    tm = torch.ones(p, device=device)
    tm[0] = 0.0
    b = t(rng.normal(size=(w, f, p, n_s)) * 0.05 * np.sqrt(6.0 / f))
    cw = t(rng.normal(size=(w, n_s, n_s)) * 0.1)
    c = cw @ cw.transpose(-1, -2) + 1.5 * torch.eye(n_s, device=device)
    return (d.contiguous(), off, tm, b, c.contiguous(),
            t(rng.normal(size=(w, f, p))), t(rng.normal(size=(w, n_s))))


def k1_compare(label, args, iters, rtol, checks, reps=(20, 3),
               real_system=False, phase_no=3, cluster=None):
    """K1 against the plain version on the same f32 inputs, and both
    against a float64 run of the plain version; then both timed. The
    kernel runs twice and the two outputs must be bitwise identical (the
    cluster reductions sum in a fixed order). ``cluster`` forces the
    plan's cluster size.

    Random systems (well conditioned): the kernel must agree with the f32
    plain version within K1_TOL of the solution's scale, as numpy's
    allclose (the tolerance of tests/test_cg_kernel.py).

    The solver's own systems (``real_system``): here 40 truncated CG steps
    in f32 land 0.5-4 % of the scale away from the f64 run for EITHER f32
    implementation (measured on the H100: plain 0.028 and 0.103 of the
    stage-1 and stage-2 first-iteration systems' max-norm deviation), so
    two f32 reduction orders cannot agree to K1_TOL. The check there is
    that the kernel is no further from the f64 solution than twice the
    plain f32 version's own distance, plus K1_TOL of scale; a wrong kernel
    lands O(scale) away."""
    import torch
    from smpltpu_torch.ops import cg

    n_w, f, p = args[5].shape
    n_s = args[6].shape[-1]
    plan = cg.k1_plan(n_w, f, p, n_s, **cg.device_limits(args[5].device),
                      cluster=cluster)

    def kernel():
        return cg.arrow_pcg_planned(plan, *args, iters=iters, rtol=rtol)
    got = kernel()
    again = kernel()
    want = cg.arrow_pcg_torch(*args, iters=iters, rtol=rtol)
    ref = cg.arrow_pcg_torch(*(a.double() for a in args), iters=iters, rtol=rtol)
    torch.cuda.synchronize()
    repeat_ok = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    checks(repeat_ok, f"K1 {label}: two launches differ")
    out = {"shape": list(args[5].shape), "n_s": n_s, "iters": iters,
           "rtol": rtol, "plan": plan._asdict(), "bitwise_repeat": repeat_ok}
    ok = repeat_ok
    for part, g, w, r in zip(("p", "w"), got, want, ref):
        scale = float(w.abs().max())
        if part == "w":
            scale = max(scale, 1.0)
        err = (g - w).abs()
        k_dev = float((g.double() - r).abs().max())
        p_dev = float((w.double() - r).abs().max())
        if real_system:
            ok &= k_dev <= 2.0 * p_dev + K1_TOL * scale
        else:
            ok &= bool(torch.all(err <= K1_TOL * scale + K1_TOL * w.abs()))
        ok &= bool(torch.all(torch.isfinite(g)))
        out[f"max_abs_err_{part}"] = float(err.max())
        out[f"scale_{part}"] = scale
        out[f"kernel_vs_f64_{part}"] = k_dev
        out[f"plain_vs_f64_{part}"] = p_dev
    # per CG step and window: the D matvec 2FP^2, the shape border
    # 4FPnS, the tridiagonal couplings 4FP, C 2nS^2, and 11 (FP + nS) for
    # the preconditioner, two dots and three updates (rtol 0 on the main
    # path: every step runs)
    flops = iters * n_w * (2 * f * p * p + 4 * f * p * n_s + 4 * f * p
                           + 2 * n_s * n_s + 11 * (f * p + n_s))
    out["bound_ms"], out["bound_by"] = bound(nbytes(*args, *got), flops)
    out["ms"] = cuda_ms(kernel, reps[0])
    out["plain_ms"] = cuda_ms(
        lambda: cg.arrow_pcg_torch(*args, iters=iters, rtol=rtol), reps[1])
    rule = ("within 2x the plain f32 distance from f64" if real_system
            else f"within {K1_TOL} of scale of the plain version")
    checks(ok, f"K1 {label}: kernel not {rule}")
    out["ok"] = ok
    phase(f"{phase_no} k1_{label}", **out)
    return out


def k1_layouts(rng, dev, checks, every=False):
    """K1's time under the plan's cluster size and K1_ALTERNATIVE's at the
    two stage shapes or, ``every``, under every cluster size at
    K1_LAYOUT_SHAPES; on one random system per shape, in turns (sizes in
    order, then in reverse), each held to K1_TOL against the plain
    version."""
    import torch
    from smpltpu_torch.ops import cg
    limits = cg.device_limits(dev)
    shapes = (K1_LAYOUT_SHAPES if every
              else [(n_w, f, 76) for n_w, f in K1_ALTERNATIVE])
    for n_w, f, p in shapes:
        args = random_arrow_system(rng, n_w, f, dev, p=p)
        want = cg.arrow_pcg_torch(*args, iters=CG_ITERS)
        chosen = cg.k1_plan(n_w, f, p, 10, **limits).cluster
        top = min(limits["max_cluster"], f)
        sizes = (range(1, top + 1) if every
                 else sorted({chosen, min(K1_ALTERNATIVE[n_w, f], top)}))
        plans = {c: cg.k1_plan(n_w, f, p, 10, **limits, cluster=c)
                 for c in sizes}
        ms = {c: [] for c in plans}
        for c in list(plans) + list(plans)[::-1]:
            ms[c].append(cuda_ms(lambda: cg.arrow_pcg_planned(
                plans[c], *args, iters=CG_ITERS), 10))
        errs = {}
        for c, plan in plans.items():
            got = cg.arrow_pcg_planned(plan, *args, iters=CG_ITERS)
            ok = all(bool(torch.all((g - w).abs() <= K1_TOL * max(
                float(w.abs().max()), 1.0) + K1_TOL * w.abs()))
                for g, w in zip(got, want))
            checks(ok, f"K1 layout {n_w}x{f} cluster {c}: not within K1_TOL")
            errs[c] = max(float((g - w).abs().max()) for g, w in zip(got, want))
        phase(f"3 k1_layouts_{n_w}x{f}_p{p}", plan_cluster=chosen,
              ms={str(c): v for c, v in ms.items()},
              max_abs_err={str(c): v for c, v in errs.items()},
              plans={str(c): p._asdict() for c, p in plans.items()})
        del args, want


# bench.py's recipe lives in the port's twin of bench.py
# (``smpltpu_torch/bench.py``); the phases call its functions
def fit_configs(linear, depth=1, cg_iters=CG_ITERS):
    """bench.py's two stage configs (``smpltpu_torch/bench.py::
    stage_configs``), fused cost, ``cg_iters`` CG steps; both stages' LM
    iterations divided by ``depth``."""
    from smpltpu_torch.bench import stage_configs
    return stage_configs(linear, cg_iters, fused=True,
                         s1_iters=S1_ITERS // depth,
                         s2_iters=S2_ITERS // depth)


def build_fit(w, linear, device, depth=1, cg_iters=CG_ITERS):
    """The port's fused two-stage fit with ``fit_configs``: stage 2 as
    one batch of all windows."""
    import torch
    from smpltpu_torch.solve import build_fused_two_stage

    return build_fused_two_stage(w["spec"], w["cam"],
                                 *fit_configs(linear, depth, cg_iters), 10,
                                 w["anchor_idx"], w["starts"], WSIZE,
                                 w["n_frames"], device=device,
                                 dtype=torch.float32)


def cli_windows(w, st1, dtype=None):
    """The multi CLI's stage-2 inputs from a stage-1 result
    (pipeline/multi.py, ``--batched-windows --init-from-anchors``): the
    anchors to the host, its interpolation loop over every frame, its
    window packing, the upload. -> ((params, shape, keypoints, R0,
    frame_valid) of all windows on st1's device, interpolation s, packing
    s)."""
    import torch
    from smpltpu_torch.energy.params import init_frame_params
    from smpltpu_torch.pipeline.multi import (
        interpolate_from_anchors,
        window_inputs,
    )
    dev, dtype = st1.params.device, dtype or st1.params.dtype
    n = w["n_frames"]
    t0 = time.perf_counter()
    anchor_params = st1.params.cpu().numpy()
    shape_w = st1.shape.cpu().numpy()
    default_pose = init_frame_params(device="cpu",
                                     dtype=torch.float32).numpy()
    poses = np.tile(default_pose, (n, 1))
    interpolate_from_anchors(poses, w["anchor_idx"], anchor_params)
    t1 = time.perf_counter()
    r0 = np.tile(w["r0c"], (n, 1, 1))
    packs = [window_inputs(s, WSIZE, poses, r0, w["kp"], default_pose)
             for s in w["starts"]]
    args = [torch.as_tensor(np.stack([p[j] for p in packs]), dtype=dtype,
                            device=dev) for j in (1, 2, 3, 4)]
    args.insert(1, torch.as_tensor(np.tile(shape_w, (len(packs), 1)),
                                   dtype=dtype, device=dev))
    torch.cuda.synchronize()
    return tuple(args), t1 - t0, time.perf_counter() - t1


def build_cli_sequential(w, linear, device, chunk, cg_iters=CG_ITERS):
    """The multi CLI's sequential route for long videos
    (``--batched-windows --init-from-anchors --window-chunk chunk``;
    bench.py's BENCH_CHUNK recipe, bench.py:148-160): stage 1 by
    ``build_multi_fitter`` on the anchors, ``cli_windows``, then stage 2
    through ``build_chunked_window_fit``. run(p0a, shape0, kpa, r0a) ->
    (stage-1 result, stage-2 result); ``run.timings``: the wall seconds of
    stage 1, the host interpolation, the packing and stage 2."""
    import torch
    from smpltpu_torch.solve import build_chunked_window_fit, build_multi_fitter

    cfg1, cfg2 = fit_configs(linear, cg_iters=cg_iters)
    fit1 = build_multi_fitter(w["spec"], w["cam"], cfg1, 10, device=device,
                              dtype=torch.float32)
    fit2 = build_chunked_window_fit(
        build_multi_fitter(w["spec"], w["cam"], cfg2, 10, device=device,
                           dtype=torch.float32), chunk)

    def run(p0a, shape0, kpa, r0a):
        t0 = time.perf_counter()
        st1 = fit1(p0a, shape0, kpa, r0a)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        args2, interp_s, pack_s = cli_windows(w, st1)
        t2 = time.perf_counter()
        st2 = fit2(*args2)
        torch.cuda.synchronize()
        run.timings = {"stage1_s": t1 - t0, "interp_s": interp_s,
                       "pack_s": pack_s,
                       "stage2_s": time.perf_counter() - t2}
        return st1, st2

    run.timings = {}
    return run


def k3_bounds(setup, verts, faces, height, width):
    """K3's two bounds on these inputs. ``rasterize``: the FaceSetup read
    once, gray and covered written once. ``rasterize_verts``: the vertices
    and faces read once, the same two outputs. Both: 12 float32 operations
    (3 edges, 2 products and 2 sums each) for every pixel of every kept
    face's clipped bounding box; the setup's ~150 a face on top for
    ``rasterize_verts``. -> ((ms, by), (ms, by), box pixels)."""
    from smpltpu_torch.render.zbuffer import face_bbox
    bb = face_bbox(setup, height, width).long()
    n_px = int((bb[..., 2] * bb[..., 3]).sum())
    b = setup.key.shape[0]
    out = 2 * b * height * width
    return (bound(nbytes(*setup) + out, 12 * n_px),
            bound(nbytes(verts) + 4 * faces.numel() + out,
                  12 * n_px + 150 * setup.key.numel()), n_px)


def k3_setup_diff(verts, faces, intr, height, width):
    """``rasterize_verts`` on the card, its images and what its setup
    stage left: (gray, covered, differing key words, differing box words,
    differing coefficient words) against ``face_setup`` and ``face_bbox``,
    compared as bits. The boxes are compared on every face (which faces
    have a record, kept and on screen, with them); keys and coefficients
    on the faces that have one: nothing is kept, or read, of the others."""
    import torch
    from smpltpu_torch.render import zbuffer
    st = zbuffer.face_setup(verts, faces, *intr)
    bb = zbuffer.face_bbox(st, height, width)
    gray, covered, scratch = zbuffer._rasterize_verts_cuda(
        verts, faces, *intr, height, width, None)
    got = zbuffer.kernel_setup(scratch)
    on = bb[..., 2] > 0
    as_bits = torch.int32
    return (gray, covered, int((got["key"] != st.key)[on].sum()),
            int((got["bbox"] != bb).sum()) + int((got["has_box"] != on).sum()),
            int((got["coef"].view(as_bits) != st.coef.view(as_bits))[on].sum()))


def k3_case(label, verts, faces, intr, checks, expect, height=H_R,
            width=W_R):
    """K3 through both entry points against its plain version on the same
    face setup, pixel-exact (``rasterize``, ``rasterize_verts``, and the
    launch whose scratch is read), and its setup stage against the plain
    setup, bit for bit; ``expect(covered_px, setup, gray)`` checks the
    scene's own content."""
    import torch
    from smpltpu_torch.render.zbuffer import (
        face_setup,
        rasterize,
        rasterize_torch,
        rasterize_verts,
    )
    st = face_setup(verts, faces, *intr)
    g1, c1 = rasterize(st, height, width)
    g2, c2 = rasterize_torch(st, height, width)
    g3, c3 = rasterize_verts(verts, faces, *intr, height, width)
    g4, c4, d_key, d_box, d_coef = k3_setup_diff(verts, faces, intr, height,
                                                 width)
    torch.cuda.synchronize()
    d_gray = [int((g != g2).sum()) for g in (g1, g3, g4)]
    d_cov = [int((c != c2).sum()) for c in (c1, c3, c4)]
    n_cov = int(c1.sum())
    scene_ok = bool(expect(n_cov, st, g1))
    ok = (not any(d_gray + d_cov + [d_key, d_box, d_coef])) and scene_ok
    checks(ok, f"K3 {label}: gray {d_gray} and covered {d_cov} pixels differ "
               f"from the plain version (rasterize, rasterize_verts, the "
               f"launch read for its setup); setup "
               f"words differing: key {d_key}, box {d_box}, coef {d_coef}; "
               f"scene check {scene_ok}")
    phase(f"6 k3_{label}", ok=ok, frames=int(verts.shape[0]), height=height,
          width=width, kept_faces=int(st.keep.sum()), covered_px=n_cov,
          differing_gray_px=d_gray, differing_covered_px=d_cov,
          differing_setup_words={"key": d_key, "box": d_box, "coef": d_coef})
    return st


def coverage_agreement(cov_dev, cov_host):
    """(dev_in_host, host_in_dev): the share of each mask within a 1-px
    dilation of the other (tests/test_jax_raster.py:94-104)."""
    def dil(m):
        out = m.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                out |= np.roll(np.roll(m, dy, 0), dx, 1)
        return out
    return ((cov_dev & dil(cov_host)).sum() / max(cov_dev.sum(), 1),
            (cov_host & dil(cov_dev)).sum() / max(cov_host.sum(), 1))


def fit_profile(w, dev, checks):
    """Phase 5 fit_profile, run after phase 6: a fit of 1/PROFILE_DEPTH of
    the LM iterations under torch.profiler, device activity only (the
    host's operators are not recorded, which keeps the profiler's cost out
    of the wall time); the device's busy time (the sum of its kernels'
    self time), K1's share and the idle share of the profiled wall time.
    The run's K1 launches, by the wrapper's own count, must be its loop
    trips, and the profiler's records of K1 as many. The profiler loses a
    buffer of records now and then (1 % of a full fit's ~143 000, in one
    run of five on an H100): a run that lost some is made once more, and
    if that one falls short too, ``records_complete`` is false, its busy
    and K1 times are lower bounds, and its count is held to nine tenths of
    the wrapper's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from smpltpu_torch.ops import LAUNCHES
    run = build_fit(w, "pcg_kernel", dev, depth=PROFILE_DEPTH)
    run(*w["args"])
    for attempt in (1, 2):
        before = LAUNCHES["arrow_pcg"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st1, st2 = run(*w["args"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        k1 = [e for e in dev_ev if "arrow_pcg_kernel" in e.key]
        k1_seen = sum(e.count for e in k1)
        k1_run = LAUNCHES["arrow_pcg"] - before
        if k1_seen == k1_run:
            break
    busy_ms = sum(e.self_device_time_total for e in dev_ev) / 1e3
    trips = int(st1.iters_run) + int(st2.iters_run.max())
    checks(k1_run == trips and trips > 0,
           f"profiled fit: {k1_run} K1 launches, {trips} loop trips")
    checks(busy_ms > 0 and 0.9 * k1_run <= k1_seen <= k1_run,
           f"profiled fit: {busy_ms} ms busy, {k1_seen} K1 launches in the "
           f"profiler's records, {k1_run} launched")
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:8]
    phase("5 fit_profile", depth=f"1/{PROFILE_DEPTH}", attempts=attempt,
          records_complete=k1_seen == k1_run, wall_ms=wall_ms,
          device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
          k1_ms=sum(e.self_device_time_total for e in k1) / 1e3,
          k1_launches=k1_run, k1_launches_recorded=k1_seen,
          device_launches=sum(e.count for e in dev_ev),
          device_busy_ms_per_trip=busy_ms / max(trips, 1),
          top_kernels_ms=[[e.key[:90], e.self_device_time_total / 1e3,
                           e.count] for e in top])


def render_phase(w, frame_params, shp, verts, fit_s, checks):
    """Phase 6 on the fitted frames (``verts``: their skinned vertices from
    phase 5, numpy): the K3 cases, K3's time per 100-frame launch, and the
    counted render of every frame. Returns (the K3 numbers by entry point,
    K3's launches in the render, those of them with the setup stage)."""
    import torch
    from smpltpu_torch.ops import LAUNCHES
    from smpltpu_torch.pipeline.common import overlay_image, render_frames
    from smpltpu_torch.render.zbuffer import (
        face_bbox,
        face_setup,
        rasterize,
        rasterize_torch,
        rasterize_verts,
    )
    dev = frame_params.device
    n = w["n_frames"]
    intr = tuple(float(c) for c in (w["cam"].fx, w["cam"].fy, w["cam"].cx,
                                    w["cam"].cy))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def faces_of(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)
    tri = t([[-0.2, -0.2, 2.0], [0.2, -0.2, 2.0], [0.0, 0.3, 2.0]])[None]
    # K3 against its plain version, pixel-exact, scene by scene
    k3_case("triangle", tri, faces_of([[0, 2, 1]]), intr, checks,
            lambda cov, st, g: cov > 1000)
    pair = t([[-0.31, -0.29, 2.0], [0.33, -0.27, 2.05], [0.02, 0.41, 1.95],
              [-0.21, -0.19, 1.5], [0.23, -0.22, 1.52],
              [-0.01, 0.26, 1.49]])[None]

    def near_wins(cov, st, g):
        # the near face's own gray at its centroid's pixel
        x = int(st.u[0, 1].mean())
        y = int(st.v[0, 1].mean())
        return cov > 1000 and int(g[0, y, x]) == int(st.key[0, 1]) & 0xFF
    k3_case("occlusion", pair, faces_of([[0, 2, 1], [3, 5, 4]]), intr, checks,
            near_wins)
    culled = t([[-0.2, -0.2, 2.0], [0.2, -0.2, 2.0], [0.0, 0.3, 2.0],
                [-0.2, -0.2, -1.0], [0.2, -0.2, -1.0], [0.0, 0.3, -1.0]])[None]
    k3_case("culled", culled, faces_of([[0, 1, 2], [3, 5, 4]]), intr, checks,
            lambda cov, st, g: cov == 0 and not bool(st.keep.any()))
    faces = faces_of(w["model"].faces)
    body = t(verts[:1] + np.array([1.0, 1.3, 0.0]))  # shifted right and down
    k3_case("off_screen", body, faces, intr, checks,
            lambda cov, st, g: cov > 1000 and float(st.u[st.keep].max()) > W_R
            and float(st.v[st.keep].max()) > H_R)
    near = t([[-1.0, -0.8, 0.5], [1.0, -0.8, 0.5], [0.0, 1.2, 0.5]])[None]
    k3_case("near_face", near, faces_of([[0, 2, 1]]), intr, checks,
            lambda cov, st, g: cov >= H_R * W_R // 2)
    k3_case("fitted_8_frames", t(verts[::n // 8]), faces, intr, checks,
            lambda cov, st, g: bool((g.flatten(1) > 0).sum(1).min() > 0))
    # a frame with no kept face (the body behind the camera) between two
    # that have some
    mixed = t(verts[[0, 1, 2]])
    mixed[1, :, 2] = -mixed[1, :, 2]
    k3_case("empty_frame_in_batch", mixed, faces, intr, checks,
            lambda cov, st, g: not bool(st.keep[1].any())
            and int((g[1] > 0).sum()) == 0 and int((g[0] > 0).sum()) > 1000
            and int((g[2] > 0).sum()) > 1000)
    k3_case("batch_of_one", t(verts[n // 2:n // 2 + 1]), faces, intr, checks,
            lambda cov, st, g: cov > 1000)
    # a frame that no tile divides: the camera scaled to 250 x 130
    small = tuple(c * 130.0 / W_R for c in intr)
    k3_case("ragged_250x130", t(verts[::n // 4]), faces, small, checks,
            lambda cov, st, g: cov > 100, height=250, width=130)
    # one frame per launch at the size of the CLI's video1 frames
    # (270 x 480, H x W; its camera: f = 0.9 * 480, the centre)
    k3_case("one_frame_270x480", t(verts[n // 3:n // 3 + 1]), faces,
            (432.0, 432.0, 240.0, 135.0), checks,
            lambda cov, st, g: cov > 1000, height=270, width=480)

    # 100 fitted frames: both entry points against the plain version, twice
    # (a z-buffer minimum does not depend on the order of the tiles' lists),
    # then timed beside the eager setup and the plain rasterizer
    v100 = t(verts[:100])
    st100 = face_setup(v100, faces, *intr)
    g2, c2 = rasterize_torch(st100, H_R, W_R)
    g1, c1 = rasterize(st100, H_R, W_R)
    g3, c3, d_key, d_box, d_coef = k3_setup_diff(v100, faces, intr, H_R, W_R)
    g4, c4 = rasterize_verts(v100, faces, *intr, H_R, W_R)
    torch.cuda.synchronize()
    k3_diff = [int((g != g2).sum()) + int((c != c2).sum())
               for g, c in ((g1, c1), (g3, c3))]
    repeat_ok = bool(torch.equal(g3, g4)) and bool(torch.equal(c3, c4))
    k3_ok = not any(k3_diff + [d_key, d_box, d_coef]) and repeat_ok
    checks(k3_ok, f"K3, 100 frames: {k3_diff} pixels differ (rasterize, "
                  f"rasterize_verts); setup words differing: key {d_key}, box "
                  f"{d_box}, coef {d_coef}; two runs identical: {repeat_ok}")
    out = (g4, c4)
    del g1, c1, g2, c2, g3, c3
    bound_setup, bound_verts, k3_px = k3_bounds(st100, v100, faces, H_R, W_R)
    ms_setup = graph_ms(lambda: rasterize(st100, H_R, W_R, out=out), 10)
    ms_verts = graph_ms(
        lambda: rasterize_verts(v100, faces, *intr, H_R, W_R, out=out), 10)
    plain_ms = cuda_ms(lambda: rasterize_torch(st100, H_R, W_R), 2)
    plain_setup_ms = cuda_ms(
        lambda: face_bbox(face_setup(v100, faces, *intr), H_R, W_R), 5)
    k3 = {"raster": {
              "ms": ms_setup, "plain_ms": plain_ms,
              "bound_ms": bound_setup[0], "bound_by": bound_setup[1],
              "event_ms": cuda_ms(
                  lambda: rasterize(st100, H_R, W_R, out=out), 20)},
          "raster_verts": {
              "ms": ms_verts, "plain_ms": plain_setup_ms + plain_ms,
              "bound_ms": bound_verts[0], "bound_by": bound_verts[1],
              "event_ms": cuda_ms(lambda: rasterize_verts(
                  v100, faces, *intr, H_R, W_R, out=out), 20)}}
    phase("6 k3_b100", ok=k3_ok, frames=100, differing_px=k3_diff,
          differing_setup_words={"key": d_key, "box": d_box, "coef": d_coef},
          two_runs_identical=repeat_ok, bbox_px=k3_px,
          kept_faces=int(st100.keep.sum()), plain_setup_ms=plain_setup_ms,
          plain_ms_per_frame=plain_ms / 100, **k3)
    del st100, v100, out, g4, c4

    # the render of every fitted frame through K2 -> K3, counted
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gray, covered = render_frames(w["model"], frame_params, shp, w["r0c"],
                                  w["cam"], H_R, W_R)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    k2_render, k3_launches = LAUNCHES["lbs"], LAUNCHES["raster"]
    k3_setup_launches = LAUNCHES["raster_setup"]
    render_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_chunks = -(-n // 100)
    checks(k3_launches == n_chunks and k3_setup_launches == n_chunks,
           f"K3 launches {k3_launches}, with the setup stage "
           f"{k3_setup_launches} != {n_chunks} chunks")
    # no (B, H, W) int32 z-buffer, no eager setup intermediates
    checks(render_peak_gib < RENDER_PEAK_MAX_GIB,
           f"render peak {render_peak_gib} GiB >= {RENDER_PEAK_MAX_GIB}")
    checks(k2_render == n_chunks,
           f"K2 launches in the render {k2_render} != {n_chunks} chunks")
    checks(tuple(gray.shape) == (n, H_R, W_R) and gray.dtype == torch.uint8
           and tuple(covered.shape) == (n, H_R, W_R), "render output shape")
    per_frame = covered.flatten(1).sum(1)
    checks(bool((per_frame > 0).all()),
           f"{int((per_frame == 0).sum())} rendered frames are empty")
    agree = {}
    for k in (0, n // 2):
        img = np.zeros((H_R, W_R, 3), np.uint8)
        overlay_image(w["model"], verts[k], img, w["cam"])
        d_in_h, h_in_d = coverage_agreement(gray[k].cpu().numpy() > 0,
                                            img[..., 0] > 0)
        agree[k] = [float(d_in_h), float(h_in_d)]
        checks(d_in_h >= DEV_IN_HOST_MIN and h_in_d >= HOST_IN_DEV_MIN,
               f"frame {k}: device vs host painter coverage {d_in_h}, {h_in_d}")
    phase("6 render", frames=n, height=H_R, width=W_R, render_s=render_s,
          render_frames_per_s=n / render_s,
          solve_render_frames_per_s=n / (fit_s + render_s),
          k2_launches=k2_render, k3_launches=k3_launches,
          k3_setup_launches=k3_setup_launches,
          covered_px={str(k): int(per_frame[k]) for k in (0, n // 2, n - 1)},
          min_covered_px=int(per_frame.min()),
          dev_in_host_host_in_dev=agree, peak_gib=render_peak_gib)
    del gray, covered

    # where the render's device time goes: one more pass, profiled
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_frames(w["model"], frame_params, shp, w["r0c"], w["cam"],
                      H_R, W_R)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in dev_ev}
    k3_ms = {name: sum(v for k, v in dev_us.items() if name in k) / 1e3
             for name in ("setup_kernel", "scan_kernel", "fill_kernel",
                          "tile_kernel")}
    k2_ms = sum(v for k, v in dev_us.items() if "lbs_kernel" in k) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    phase("6 render_profile", wall_ms=prof_ms,
          device_busy_ms=sum(dev_us.values()) / 1e3,
          k3_kernels_ms=sum(k3_ms.values()), k3_by_kernel_ms=k3_ms,
          k2_kernel_ms=k2_ms, device_kernels=len(dev_us),
          device_launches=sum(e.count for e in dev_ev),
          top_kernels_ms=[[k[:90], v / 1e3] for k, v in top])

    return k3, k3_launches, k3_setup_launches


def k2_phase(rng, dev, checks, cases):
    """Phase 4: K2 against its plain version within K2_ATOL on each of
    ``cases`` (label, model options, frames); the 100-frame case timed.
    Returns that case's numbers."""
    import torch
    from smpltpu_torch.models import SMPLModel, make_synthetic_model
    from smpltpu_torch.models.smpl import rodrigues
    from smpltpu_torch.ops import lbs
    k2, models = None, {}
    for label, kw, b in cases:
        key = tuple(sorted(kw.items()))
        if key not in models:
            models[key] = SMPLModel.from_dict(
                make_synthetic_model(**kw), device=dev, dtype=torch.float32)
        model = models[key]
        ops = lbs.prepare_lbs_operands(model)
        n_s = model.shapedirs.shape[-1]
        shapes = torch.as_tensor(0.5 * rng.normal(size=(b, n_s)),
                                 dtype=torch.float32, device=dev)
        rots = rodrigues(torch.as_tensor(
            0.3 * rng.normal(size=(b, model.num_joints, 3)),
            dtype=torch.float32, device=dev))
        pos = torch.as_tensor(rng.normal(size=(b, 3)) * 0.2 + [0.0, 0.0, 3.0],
                              dtype=torch.float32, device=dev)
        g_aff, _ = lbs.joint_affines(model, shapes, rots, pos)
        g_aff = g_aff.contiguous()
        got = lbs.lbs(shapes, g_aff, ops)
        want = lbs.lbs_torch(shapes, g_aff, ops)
        torch.cuda.synchronize()
        k2_err = float((got - want).abs().max())
        k2_ok = k2_err <= K2_ATOL and bool(torch.all(torch.isfinite(got)))
        checks(k2_ok, f"K2 {label}: kernel vs plain {k2_err} > {K2_ATOL}")
        out = {"shape": list(got.shape), "n_joints": model.num_joints,
               "n_shapes": n_s, "max_abs_err": k2_err}
        if label == "b100":
            # per (frame, vertex): blend 6nS + 3, transforms 24nJ, apply 18
            k2_bound = bound(
                nbytes(shapes, g_aff, got, ops["v_template_t"],
                       ops["shapedirs_t"], ops["weights_t"]),
                b * model.num_verts * (6 * n_s + 3 + 24 * model.num_joints
                                       + 18))
            out.update(
                ms=graph_ms(lambda: lbs.lbs(shapes, g_aff, ops), 50),
                event_ms=cuda_ms(lambda: lbs.lbs(shapes, g_aff, ops), 50),
                plain_ms=cuda_ms(lambda: lbs.lbs_torch(shapes, g_aff, ops),
                                 10),
                bound_ms=k2_bound[0], bound_by=k2_bound[1])
            k2 = out
        phase(f"4 k2_{label}", ok=k2_ok, **out)
    return k2


def assemble_arrow(d, off, tm, b, c):
    """The dense (F P + nS) x (F P + nS) matrix of each window's arrowhead
    system [T B; B^T C], float64: T's diagonal blocks d (W, F, P, P) and
    off-diagonal blocks off[:, f] * diag(tm), the border b (W, F, P, nS),
    the corner c (W, nS, nS)."""
    import torch
    n_w, f, p, _ = d.shape
    n_s = c.shape[-1]
    n = f * p + n_s
    a = torch.zeros((n_w, n, n), dtype=torch.float64, device=d.device)
    for i in range(f):
        r = slice(i * p, (i + 1) * p)
        a[:, r, r] = d[:, i]
        a[:, r, f * p:] = b[:, i]
        a[:, f * p:, r] = b[:, i].transpose(-1, -2)
    for i in range(f - 1):
        e = torch.diag_embed(off[:, i, None] * tm)
        a[:, i * p:(i + 1) * p, (i + 1) * p:(i + 2) * p] = e
        a[:, (i + 1) * p:(i + 2) * p, i * p:(i + 1) * p] = e
    a[:, f * p:, f * p:] = c
    return a


def device_profile(fn):
    """(device launches, device ms, the top five kernels [name, ms, count])
    of one call of fn() under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in dev_ev),
            sum(e.self_device_time_total for e in dev_ev) / 1e3,
            [[e.key[:70], e.self_device_time_total / 1e3, e.count]
             for e in sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:5]])


def no_sync(fn):
    """fn() under ``torch.cuda.set_sync_debug_mode("error")``: (its result,
    None) or (None, the start of the error a host sync raised)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(), None
    except RuntimeError as e:
        return None, str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)


def tridiag_phase(first, k1_main, checks):
    """Phase 7: the exact arrowhead solves (``linear="tridiag"``:
    block-tridiagonal elimination, and ``linear="cr"``: block cyclic
    reduction; each followed by the shape Schur complement,
    ``solve/multi_frame.py::arrow_tridiag``) on the first LM iteration's
    real systems of both stages, in float32 on the card under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises); held
    to the same solve in float64 (TRIDIAG_F32_MAX of scale) and that to a
    dense float64 solve of the assembled system (TRIDIAG_DENSE_MAX); cr's
    float64 solve beside tridiag's. K1's 40 steps beside them: PCG's
    truncation, its distance from the exact float64 solution. Times by CUDA
    events around eager calls (each solve is a chain of small launches;
    the host's enqueueing is in it); device time and launches per solve
    from the profiler."""
    import torch
    from smpltpu_torch.ops import cg
    from smpltpu_torch.solve.multi_frame import arrow_tridiag

    def rel(x, ref):
        return float((x.double() - ref).abs().max() / ref.abs().max())
    out = {}
    for shape, (a, k) in sorted(first.items()):
        stage = "stage1" if shape[0] == 1 else "stage2"
        a64 = [t.double() for t in a]
        n_w, f, p = a[5].shape
        x = torch.linalg.solve(assemble_arrow(*a64[:5]),
                               -torch.cat([a64[5].flatten(1), a64[6]], 1))
        dp_d, dw_d = x[:, :f * p].reshape(n_w, f, p), x[:, f * p:]
        del x
        f64 = {}
        for linear in ("tridiag", "cr"):
            label = f"{linear}_{stage}"

            def solve(args=a, linear=linear):
                return arrow_tridiag(*args, linear=linear)
            got, synced = no_sync(solve)
            checks(synced is None,
                   f"{label}: the solve synchronized: {synced}")
            if synced is not None:
                continue
            dp, dw = got
            dp64, dw64 = f64[linear] = solve(a64)
            res = {"shape": list(a[0].shape), "n_s": int(a[6].shape[-1]),
                   "f32_vs_f64": [rel(dp, dp64), rel(dw, dw64)],
                   "f64_vs_dense": [rel(dp64, dp_d), rel(dw64, dw_d)],
                   "finite": bool(torch.isfinite(dp).all()
                                  and torch.isfinite(dw).all())}
            ok = (res["finite"] and max(res["f32_vs_f64"]) <= TRIDIAG_F32_MAX
                  and max(res["f64_vs_dense"]) <= TRIDIAG_DENSE_MAX)
            if linear == "tridiag":
                k1_p, k1_w = cg.arrow_pcg(*a, iters=k["iters"], rtol=k["rtol"])
                pl_p, pl_w = cg.arrow_pcg_torch(*a64, iters=k["iters"],
                                                rtol=k["rtol"])
                res["k1_f32_vs_exact"] = [rel(k1_p, dp_d), rel(k1_w, dw_d)]
                res["plain_pcg_f64_vs_exact"] = [rel(pl_p, dp_d),
                                                 rel(pl_w, dw_d)]
                res["k1_ms"] = k1_main[f"{stage}_first_lm_iter"]["ms"]
            else:
                t64 = f64["tridiag"]
                res["f64_vs_tridiag_f64"] = [rel(dp64, t64[0]),
                                             rel(dw64, t64[1])]
                ok = ok and max(res["f64_vs_tridiag_f64"]) <= TRIDIAG_DENSE_MAX
            checks(ok, f"{label}: {res} (f32 max {TRIDIAG_F32_MAX}, f64 "
                       f"max {TRIDIAG_DENSE_MAX})")
            res["ms"] = cuda_ms(solve, 5)
            res["f64_ms"] = cuda_ms(lambda: solve(a64), 2)
            (res["device_launches_per_solve"], res["device_ms_per_solve"],
             res["top_kernels_ms"]) = device_profile(solve)
            phase(f"7 {label}", ok=ok, **res)
            out[label] = res
        del a64, f64, dp_d, dw_d
    return out


def exact_long_phase(dev, checks):
    """``7 exact_long``: both exact arrowhead solves on one random SPD
    system (``random_arrow_system``, one window) at each of EXACT_LONG_F
    frames, float32: ms per solve, launches per solve, cr under sync-debug
    "error", cr's float32 against its float64 and against tridiag's
    float32. tridiag's launches grow by a fixed count a frame: they are
    counted by the profiler at EXACT_LONG_PROFILE_F frames and extended
    linearly (its profile at 4000 frames would hold ~200 000 records, which
    the profiler takes minutes to digest); cr's are counted at each size."""
    import torch
    from smpltpu_torch.solve.multi_frame import arrow_tridiag

    rng = np.random.default_rng(7)

    def rel(x, ref):
        return float((x.double() - ref.double()).abs().max()
                     / ref.double().abs().max())
    counted = {}
    for f in EXACT_LONG_PROFILE_F:
        a = random_arrow_system(rng, 1, f, dev)
        counted[f] = device_profile(lambda: arrow_tridiag(*a))[0]
        del a
    (f0, n0), (f1, n1) = sorted(counted.items())
    per_frame = (n1 - n0) / (f1 - f0)
    res = {"tridiag_launches_counted": {str(f): n for f, n in counted.items()},
           "tridiag_launches_per_frame": per_frame}
    ok = True
    for f in EXACT_LONG_F:
        a = random_arrow_system(rng, 1, f, dev)
        row = {"d_mb": nbytes(a[0]) / 1e6}
        got, synced = no_sync(lambda: arrow_tridiag(*a, linear="cr"))
        ok &= synced is None
        dp, dw = got if got is not None else arrow_tridiag(*a, linear="cr")
        dp64, dw64 = arrow_tridiag(*(t.double() for t in a), linear="cr")
        tp, tw = arrow_tridiag(*a)
        row["cr_f32_vs_f64"] = [rel(dp, dp64), rel(dw, dw64)]
        row["cr_vs_tridiag_f32"] = [rel(dp, tp), rel(dw, tw)]
        row["tridiag_f32_vs_cr_f64"] = [rel(tp, dp64), rel(tw, dw64)]
        finite = bool(torch.isfinite(dp).all() and torch.isfinite(dw).all())
        ok &= finite and max(row["cr_f32_vs_f64"]) <= TRIDIAG_F32_MAX
        row["cr_ms"] = cuda_ms(lambda: arrow_tridiag(*a, linear="cr"), 3)
        row["tridiag_ms"] = cuda_ms(lambda: arrow_tridiag(*a), 1)
        row["cr_launches"], row["cr_device_ms"], _ = device_profile(
            lambda: arrow_tridiag(*a, linear="cr"))
        row["tridiag_launches"] = int(round(n1 + per_frame * (f - f1)))
        row["cr_synced"] = synced
        res[str(f)] = row
        del a, dp64, dw64, tp, tw
    checks(ok, f"exact_long: {res}")
    phase("7 exact_long", ok=ok, **res)
    return res


def jvp_phase(w, captured, dev, checks):
    """``5 jvp_assembly``: the first LM iteration's normal-equation pieces
    at the stage-2 shape (the warm-up's first ``corrected_frame_assembly``
    call of the 67 x 20 windows, padded frames included) by
    ``jacobian="jvp"`` (forward mode, ``torch.func``) and by the analytic
    Jacobian, in float32 and float64 on the card: jvp against analytic in
    float64 within JVP_F64_MAX of each piece's scale; float32 jvp finite
    and no further from float64 than twice float32 analytic's distance
    plus JVP_F32_SLACK; ms and device launches of each."""
    import torch
    from smpltpu_torch.constants import init_root_rotation
    from smpltpu_torch.energy import make_skeleton_spec
    from smpltpu_torch.models import SMPLModel
    from smpltpu_torch.solve.multi_frame import corrected_frame_assembly
    from smpltpu_torch.utils import default_intrinsics

    checks(captured is not None, "jvp_assembly: no stage-2 assembly captured")
    if captured is None:
        return
    p, wv, kp, r0, cam, spec, delta = captured[:7]
    f64 = torch.float64
    spec64 = make_skeleton_spec(SMPLModel.from_dict(
        w["model_dict"], device=dev, dtype=f64), init_root_rotation(),
        with_shape=True)
    inputs = {"f32": (p, wv, kp, r0, cam, spec),
              "f64": (p.double(), wv.double(), kp.double(), r0.double(),
                      default_intrinsics(720, 1280, device=dev, dtype=f64),
                      spec64)}
    res = {"shape": list(p.shape), "huber_delta": delta,
           "masked_slots": int((kp[..., 3] == 0).sum()),
           "padded_frames": int((kp[..., 3] == 0).all(-1).sum())}
    pieces = {}
    for tag, args in inputs.items():
        for jac in ("analytic", "jvp"):
            def fn(args=args, jac=jac):
                return corrected_frame_assembly(*args, delta, jac,
                                                with_cost=True)
            pieces[tag, jac] = fn()
            res[f"{jac}_{tag}_ms"] = cuda_ms(fn, 3)
            res[f"{jac}_{tag}_launches"], res[f"{jac}_{tag}_device_ms"], _ = \
                device_profile(fn)

    def rel(got, want):
        return [float((g.double() - r).abs().max()
                      / r.abs().max().clamp_min(1e-30))
                for g, r in zip(got, want)]
    ref = pieces["f64", "analytic"]
    res["jvp_f64_vs_analytic_f64"] = rel(pieces["f64", "jvp"], ref)
    res["jvp_f32_vs_analytic_f64"] = rel(pieces["f32", "jvp"], ref)
    res["analytic_f32_vs_analytic_f64"] = rel(pieces["f32", "analytic"], ref)
    res["jvp_f32_finite"] = all(bool(torch.isfinite(t).all())
                                for t in pieces["f32", "jvp"])
    ok = (res["jvp_f32_finite"]
          and max(res["jvp_f64_vs_analytic_f64"]) <= JVP_F64_MAX
          and all(j <= 2.0 * a + JVP_F32_SLACK for j, a in zip(
              res["jvp_f32_vs_analytic_f64"],
              res["analytic_f32_vs_analytic_f64"])))
    checks(ok, f"jvp_assembly: {res}")
    phase("5 jvp_assembly", ok=ok, **res)


def host_native_phase(w, verts, checks):
    """``12 host_native``: the host runtime (``smpltpu_torch.native``, built
    with g++ from ``smpltpu_torch/csrc/host``): video1's keypoints and a
    directory of NATIVE_FILES synthetic keypoint files (under
    ``build/chip_smoke_native``, removed after) parsed by the native and
    the Python parser, bit-equal, each timed; one frame of phase 5's fitted
    meshes at 1280 x 720 filled by the C++ fill and by the numpy fill,
    bit-equal, each timed."""
    import shutil
    from smpltpu_torch import native
    from smpltpu_torch.io import load_keypoint_dir
    from smpltpu_torch.render import raster as painter

    here = os.path.dirname(os.path.abspath(__file__))
    native.ensure_built()
    # the build ran at the library's first use in this process (phase 5's
    # overlay, through the host painter, where cv2 is absent)
    res = {"build": dict(native.build_info)}
    root = os.path.join(here, "build", "chip_smoke_native")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(12)
    for i in range(NATIVE_FILES):
        lms = [{"x": float(x), "y": float(y), "z": 0.0, "visibility": float(v)}
               for x, y, v in rng.random((33, 3))]
        with open(os.path.join(root, f"frame_{i:05d}.json"), "w") as f:
            json.dump(lms, f)
    ok = True
    for label, d in (("video1", os.path.join(here, "data", "keypoints",
                                             "video1")),
                     (f"synthetic{NATIVE_FILES}", root)):
        row = {}
        for backend in ("native", "python"):
            t0 = time.perf_counter()
            row[backend], _ = load_keypoint_dir(d, 720, 1280, backend=backend)
            row[f"{backend}_ms"] = (time.perf_counter() - t0) * 1e3
        same = bool(np.array_equal(row.pop("native"), row.pop("python")))
        ok &= same
        res[label] = dict(row, bit_equal=same)
    shutil.rmtree(root, ignore_errors=True)
    cam = w["cam"]
    tris, shade = painter.build_drawlist(
        np.asarray(verts[0], np.float64), np.asarray(w["model"].faces),
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    gray = np.round(220.0 * shade).astype(np.int32)
    imgs = {}
    for fill in ("native", "numpy"):
        img = np.zeros((H_R, W_R, 3), np.uint8)
        t0 = time.perf_counter()
        if fill == "native":
            native.fill_triangles(img, tris, gray)
        else:
            painter._fill_triangles_numpy(
                img, tris, np.stack([gray] * 3, axis=-1).astype(np.uint8))
        res[f"fill_{fill}_ms"] = (time.perf_counter() - t0) * 1e3
        imgs[fill] = img
    same = bool(np.array_equal(imgs["native"], imgs["numpy"]))
    res.update(fill_bit_equal=same, fill_triangles=len(gray),
               fill_covered_px=int(imgs["native"].any(-1).sum()))
    ok &= same and res["fill_covered_px"] > 0
    checks(ok, f"host_native: {res}")
    phase("12 host_native", ok=ok, **res)


def cli_run(label, argv, root, checks, k3_check=False, cli="multi"):
    """The port's multi (or ``cli="single"``, ``"stream"``) CLI,
    ``main(argv)`` on the card, into a directory of its own under ``root``;
    the launch counts set to 0 just before and read just after. The stream
    CLI's line carries its latency line and calibration ms in place of the
    metrics events the other two write. ``k3_check`` holds every K3
    launch of the run (its ``rasterize_verts`` calls from the overlay)
    against ``rasterize_torch`` on the same face setup, pixel for pixel;
    those plain calls launch no kernel. -> the run's numbers, its log.csv
    frames and errors."""
    import contextlib
    import io
    import torch
    import smpltpu_torch.pipeline.common as common
    from smpltpu_torch.ops import LAUNCHES
    from smpltpu_torch.pipeline import multi, single, stream
    from smpltpu_torch.render.zbuffer import face_setup, rasterize_torch

    out = os.path.join(root, label)
    full = argv[:3] + [out] + argv[3:] + (
        [] if cli == "stream" else ["--metrics-jsonl", out + ".jsonl"])
    k3 = {"launches_checked": 0, "differing_px": 0, "sizes": set()}
    real = common.rasterize_verts

    def checked(verts, faces, fx, fy, cx, cy, height, width, out=None):
        got = real(verts, faces, fx, fy, cx, cy, height, width, out=out)
        want = rasterize_torch(face_setup(verts, faces, fx, fy, cx, cy),
                               height, width)
        k3["differing_px"] += sum(int((g != w).sum()) for g, w in zip(got, want))
        k3["launches_checked"] += 1
        k3["sizes"].add((int(verts.shape[0]), height, width))
        return got
    if k3_check:
        common.rasterize_verts = checked
    said = io.StringIO()
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(said), contextlib.redirect_stderr(said):
            rc = {"multi": multi, "single": single,
                  "stream": stream}[cli].main(full)
        torch.cuda.synchronize()
    finally:
        common.rasterize_verts = real
    wall_s = time.perf_counter() - t0
    launches = {k: v for k, v in LAUNCHES.items() if "@" not in k}
    checks(rc == 0, f"cli {label}: rc {rc}; output ends {said.getvalue()[-600:]!r}")
    res = {"rc": rc, "wall_s": wall_s, "launches": launches,
           "argv": argv[3:]}
    frames, errs = np.zeros(0, int), np.zeros(0)
    if rc == 0:
        rows = open(os.path.join(out, "log.csv")).read().splitlines()
        checks(rows[0] == "frame,mean_pixel_error_px,time_ms",
               f"cli {label}: log.csv header {rows[0]!r}")
        frames = np.array([int(r.split(",")[0]) for r in rows[1:]])
        errs = np.array([float(r.split(",")[1]) for r in rows[1:]])
        if cli == "stream":
            text = said.getvalue()
            lat = re.search(r"latency mean ([\d.]+) ms, p50 ([\d.]+) ms, "
                            r"p95 ([\d.]+) ms", text)
            calib = re.search(r"calibrated shape on \d+ frames: solve "
                              r"([\d.]+) ms", text)
            res["latency_ms"] = (dict(zip(("mean", "p50", "p95"), map(
                float, lat.groups()))) if lat else None)
            res["stage_ms"] = {"calibrate": float(calib.group(1))
                               if calib else None}
        else:
            events = [json.loads(line) for line in open(out + ".jsonl")]
            # the fused path's window events carry shares of its one time
            fused = [e["ms"] for e in events
                     if e["event"] == "fused_two_stage"]
            res["stage_ms"] = (
                {"solve": sum(e["ms"] for e in events
                              if e["event"] == "single_solve")}
                if cli == "single" else {"fused": fused[0]} if fused else {
                    "stage1": sum(e["ms"] for e in events
                                  if e["event"] == "stage1"),
                    "windows": sum(e["ms"] for e in events
                                   if e["event"] == "window")})
        res.update(rows=len(frames), mean_px=float(errs.mean()),
                   max_px=float(errs.max()), finite=bool(np.isfinite(errs).all()))
        checks(res["finite"], f"cli {label}: non-finite errors in log.csv")
        pz = np.load(os.path.join(out, f"params_{cli}.npz"))
        res["params_shape"] = [list(pz["params"].shape), list(pz["shape"].shape)]
        png = {"single": "_render.png", "multi": "_multi.png",
               "stream": "_stream.png"}[cli]
        res["pngs"] = len([n for n in os.listdir(out) if n.endswith(png)])
        if cli != "stream":
            res["loss_curve_rows"] = len(open(os.path.join(
                out, "loss_curve.txt")).read().splitlines()) - 1
    if k3_check:
        res["k3_check"] = dict(k3, sizes=sorted(k3["sizes"]))
        checks(k3["launches_checked"] > 0 and k3["differing_px"] == 0
               and k3["launches_checked"] == launches.get("raster", 0),
               f"cli {label}: K3 against its plain version: {res['k3_check']}, "
               f"K3 launches {launches.get('raster', 0)}")
    return res, frames, errs


def cli_phases(checks):
    """Phase 8: the port's CLI on the card, three runs of ``main``:
    ``cli_default`` (the full-width synthetic model, video1's keypoints and
    its 480 x 270 frames, the default argv: sequential windows, the exact
    solve, the host painter), ``cli_golden`` (the golden's model, argv and
    blank 1280 x 720 (H x W) frames, plus --jax-render: K3 per frame; its
    log.csv held to tests/data/fullres_golden_video1.npz) and
    ``cli_kernels`` (the golden's argv at full width, --fused-stages
    --linear pcg_kernel --jax-render: K1, K2 and K3, beside the same argv
    with --linear pcg and the sequential stages); then ``cli_single``, the
    single CLI (the full-width model, video1's keypoints and frames,
    ``CLI_SINGLE_ARGV``: K2 in the evaluation, K3 per frame)."""
    import shutil
    from smpltpu_torch.io import save_smpl_npz
    from smpltpu_torch.models.synthetic import make_synthetic_model
    from smpltpu_torch.utils.image import imwrite

    here = os.path.dirname(os.path.abspath(__file__))
    kps = os.path.join(here, "data", "keypoints", "video1")
    frames_dir = os.path.join(here, "data", "frames_annotated", "video1")
    root = os.path.join(here, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "blank"))
    n_kp = len([n for n in os.listdir(kps) if n.endswith(".json")])
    for i in range(n_kp):   # frame names sort as the JSONs do
        imwrite(os.path.join(root, "blank", f"frame_{10 * i:04d}.png"),
                np.zeros((H_R, W_R, 3), np.uint8))
    small = os.path.join(root, "model300.npz")
    save_smpl_npz(small, make_synthetic_model(n_verts=300, seed=0))

    # cli_default: anchors 0, 10, 20, 30, then windows at 0, 15, 30
    res, frames, errs = cli_run(
        "cli_default", ["synthetic", kps, frames_dir], root, checks)
    if res["rc"] == 0:
        ok = bool(list(frames[:4]) == [0, 10, 20, 30]
              and set(frames[4:]) == set(range(n_kp))
              and res["pngs"] == n_kp
              and res["params_shape"] == [[n_kp, 76], [10]]
              and res["loss_curve_rows"] == 1000
              and res["mean_px"] < CLI_DEFAULT_MEAN_MAX_PX
              and res["launches"].get("lbs", 0) > 0)
        checks(ok, f"cli_default: {res}")
        res["ok"] = ok
    phase("8 cli_default", **res)

    # cli_golden: row by row against the pin, within the reference's own
    # spread on each row (recorded with the pin) and 1 % + 0.02 px
    res, frames, errs = cli_run(
        "cli_golden", [small, kps, os.path.join(root, "blank")]
        + GOLDEN_MESH1_ARGV + ["--jax-render"], root, checks, k3_check=True)
    if res["rc"] == 0:
        g = np.load(os.path.join(here, "tests", "data",
                                 "fullres_golden_video1_mesh1.npz"))
        same_rows = np.array_equal(frames, g["frames"])
        drift = np.abs(errs - g["errs"]) if same_rows else np.array([np.inf])
        spread = np.abs(g["errs_perturbed"] - g["errs"]).max(axis=0)
        limit = spread + GOLDEN_ATOL + GOLDEN_RTOL * np.abs(g["errs"])
        ok = bool(same_rows and (drift <= limit).all()
                  and errs.mean() < GOLDEN_MEAN_MAX
                  and res["launches"].get("raster", 0) == n_kp)
        checks(ok, f"cli_golden: drift {drift.max()} px, mean {errs.mean()} "
                   f"against {g['errs'].mean()}, {res}")
        off = drift > 0.02 + 0.02 * np.abs(g["errs"])   # the JAX test's gate
        res.update(ok=ok, golden_mean_px=float(g["errs"].mean()),
                   reference_spread_max_px=float(spread.max()),
                   mean_drift_rel=float(abs(errs.mean() - g["errs"].mean())
                                        / g["errs"].mean()),
                   max_drift_px=float(drift.max()),
                   max_drift_rel=float((drift / np.maximum(
                       np.abs(g["errs"]), 1e-9)).max()),
                   max_drift_of_limit=float((drift / limit).max()),
                   rows_within_2pct=int((~off).sum()),
                   rows_past_2pct=[[int(f), float(e), float(w)] for f, e, w
                                   in zip(frames[off], errs[off],
                                          g["errs"][off])])
    phase("8 cli_golden", **res)

    # cli_cr: the golden's argv with the other exact solve, cyclic
    # reduction, K3 per frame; its mean against the CPU run's, its rows
    # against cli_golden's (tridiag on the card) within the golden's bound
    golden_rows = (frames, errs) if res["rc"] == 0 else None
    res, frames, errs = cli_run(
        "cli_cr", [small, kps, os.path.join(root, "blank")]
        + GOLDEN_MESH1_ARGV + ["--linear", "cr", "--jax-render"], root,
        checks, k3_check=True)
    if res["rc"] == 0 and golden_rows is not None:
        g = np.load(os.path.join(here, "tests", "data",
                                 "fullres_golden_video1_mesh1.npz"))
        spread = np.abs(g["errs_perturbed"] - g["errs"]).max(axis=0)
        same_rows = np.array_equal(frames, golden_rows[0])
        apart = (np.abs(errs - golden_rows[1]) if same_rows
                 else np.array([np.inf]))
        limit = spread + GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden_rows[1])
        gap = abs(res["mean_px"] - CLI_CR_CPU_MEAN_PX)
        ok = bool(same_rows and (apart <= limit).all()
                  and gap <= CLI_CR_GAP_MAX_PX
                  and res["launches"].get("arrow_pcg", 0) == 0
                  and res["launches"].get("lbs", 0) > 0
                  and res["launches"].get("raster", 0) == n_kp)
        checks(ok, f"cli_cr: mean {res['mean_px']} px against the CPU's "
                   f"{CLI_CR_CPU_MEAN_PX}; rows {apart.max()} px from "
                   f"cli_golden's, {(apart / limit).max()} of the bound; {res}")
        res.update(ok=ok, cpu_mean_px=CLI_CR_CPU_MEAN_PX, gap_px=gap,
                   tridiag_mean_px=float(golden_rows[1].mean()),
                   max_apart_from_tridiag_px=float(apart.max()),
                   max_apart_of_bound=float((apart / limit).max()))
    phase("8 cli_cr", **res)

    # cli_kernels: K1 + K2 + K3 through the fused path, beside plain PCG
    runs = {}
    for label, extra in (("cli_kernels", ["--fused-stages", "--linear",
                                          "pcg_kernel", "--jax-render"]),
                         ("cli_kernels_plain_pcg", ["--linear", "pcg",
                                                    "--jax-render"])):
        runs[label] = cli_run(
            label, ["synthetic", kps, os.path.join(root, "blank")]
            + GOLDEN_ARGV + extra, root, checks, k3_check=True)[0]
    res, plain = runs["cli_kernels"], runs["cli_kernels_plain_pcg"]
    if res["rc"] == 0 and plain["rc"] == 0:
        gap = abs(res["mean_px"] - plain["mean_px"])
        ok = bool(gap < CLI_FUSED_GAP_MAX_PX
              and all(res["launches"].get(k, 0) > 0
                      for k in ("arrow_pcg", "lbs", "raster"))
              and plain["launches"].get("arrow_pcg", 0) == 0)
        checks(ok, f"cli_kernels: mean gap {gap} px, launches "
                   f"{res['launches']}, plain PCG's {plain['launches']}")
        res.update(ok=ok, plain_pcg=plain, mean_gap_px=gap)
    phase("8 cli_kernels", **res)

    # cli_single: the single CLI with a start set per frame, K2 in its
    # evaluation and K3 per frame, against the CPU run's mean
    res, frames, errs = cli_run(
        "cli_single", ["synthetic", kps, frames_dir] + CLI_SINGLE_ARGV, root,
        checks, k3_check=True, cli="single")
    if res["rc"] == 0:
        gap = abs(res["mean_px"] - CLI_SINGLE_CPU_MEAN_PX)
        n_rows = len(frames)
        ok = bool(gap <= CLI_SINGLE_GAP_MAX_PX and n_rows > 0
                  and res["pngs"] == n_rows
                  and res["launches"].get("lbs", 0) > 0
                  and res["launches"].get("raster", 0) == n_rows
                  and res["params_shape"] == [[n_kp, 76], [n_kp, 10]])
        checks(ok, f"cli_single: mean {res['mean_px']} px against the CPU's "
                   f"{CLI_SINGLE_CPU_MEAN_PX}, {res}")
        res.update(ok=ok, cpu_mean_px=CLI_SINGLE_CPU_MEAN_PX, gap_px=gap)
    phase("8 cli_single", **res)

    # cli_stream: the stream CLI four ways, each mean against the CPU run's;
    # the three stream paths' rows against each other
    rows = {}
    for label, extra, cpu_mean in CLI_STREAM_RUNS:
        extra = [os.path.join(here, a) if a.startswith("data/") else a
                 for a in extra]
        res, frames, errs = cli_run(
            label, ["synthetic", kps, frames_dir] + extra, root, checks,
            k3_check="--jax-render" in extra, cli="stream")
        if res["rc"] == 0:
            rows[label] = (frames, errs)
            gap = abs(res["mean_px"] - cpu_mean)
            n_rows = len(frames)
            render = "--jax-render" in extra
            ok = bool(gap <= CLI_STREAM_GAP_MAX_PX and n_rows > 0
                      and res["latency_ms"] is not None
                      and res["params_shape"] == [[n_kp, 76], [n_kp, 10]]
                      and res["pngs"] == (n_rows if render else 0)
                      and (not render
                           or (res["launches"].get("lbs", 0) > 0
                               and res["launches"].get("raster", 0)
                               == n_rows)))
            checks(ok, f"{label}: mean {res['mean_px']} px against the "
                       f"CPU's {cpu_mean}, {res}")
            res.update(ok=ok, cpu_mean_px=cpu_mean, gap_px=gap)
        phase(f"8 {label}", **res)
    paths = [rows.get(k) for k in ("cli_stream", "cli_stream_scan",
                                   "cli_stream_pump")]
    if all(r is not None for r in paths):
        same_frames = all(np.array_equal(paths[0][0], r[0]) for r in paths)
        apart = max(float(np.abs(paths[0][1] - r[1]).max())
                    for r in paths) if same_frames else float("inf")
        ok = bool(same_frames and apart <= CLI_STREAM_ROWS_AGREE_PX)
        checks(ok, f"cli_stream: the three paths' rows {apart} px apart")
        phase("8 cli_stream_paths", ok=ok, rows_apart_px=apart,
              bitwise=bool(apart == 0.0))
    shutil.rmtree(root, ignore_errors=True)


def api_phase(w, dev, checks):
    """``8 api_fit_video``: ``fit_video(mode="stream", want_verts=True)``, the
    library entry point, on phase 10's frames of the bench workload and the
    full-width model (calibration on the first 10 frames, the causal
    replay over the rest, K2 in the evaluation); the launch counts set to 0
    just before and read just after."""
    import torch
    from smpltpu_torch.ops import LAUNCHES
    from smpltpu_torch.pipeline.api import fit_video

    kp = w["kp"][:STREAM_FRAMES]
    LAUNCHES.clear()
    res, wall_s = timed(lambda: fit_video(
        w["model_dict"], kp, 720, 1280, mode="stream", want_verts=True,
        device=dev))
    launches = {k: v for k, v in LAUNCHES.items() if "@" not in k}
    ok = bool(res.params.shape == (len(kp), 76)
              and np.isfinite(res.errors_px).all()
              and res.verts.shape == (len(kp), w["model"].num_verts, 3)
              and np.isfinite(res.verts).all()
              and launches.get("lbs", 0) > 0
              and launches.get("arrow_pcg", 0) == 0)
    checks(ok, f"api_fit_video: launches {launches}, px finite "
               f"{np.isfinite(res.errors_px).all()}")
    phase("8 api_fit_video", ok=ok, frames=len(kp), wall_s=wall_s,
          launches=launches, mean_px=float(res.errors_px.mean()),
          converged=int(res.converged.sum()),
          verts_shape=list(res.verts.shape))


def frame_px(prob, x, kp):
    """Each frame's mean keypoint error (px) under the solver's model, the
    fitted scale included: bench.py's residual (:801-806) by frame."""
    import torch
    from smpltpu_torch.energy import project, skeleton_joints_cam
    x = torch.as_tensor(x, device=prob.spec.r0.device).to(prob.spec.r0.dtype)
    uv = project(skeleton_joints_cam(x[:, :76], x.new_zeros(prob.n_shapes),
                                     prob.spec), prob.cam)
    kp_t = torch.as_tensor(kp, device=uv.device).to(uv.dtype)
    return torch.linalg.norm(uv[:, kp[0, :, 0].astype(int)] - kp_t[:, :, 1:3],
                             dim=-1).mean(-1).cpu().numpy()


def timed(fn):
    """(fn(), wall seconds), the device synchronized on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def launches_and_syncs(fn):
    """(fn(), device kernel launches in it (profiler), host syncs in it
    (sync-debug "warn", one warning each))."""
    import warnings
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    n_sync = sum("synchroniz" in str(c.message) for c in caught)
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return out, launches, n_sync


def single_phases(w, dev, checks):
    """Phase 9, the single-frame path on bench.py's BENCH_SINGLE workload:
    the first SINGLE_FRAMES frames, every frame one LM problem from the
    reference init, solved as one batch in float32.

    ``single_fit``: timed after a one-trip warm-up; its LM trips, device
    launches and host syncs per trip (from a 1-trip and a
    SINGLE_PROFILE_TRIPS-trip run under the profiler and sync-debug
    "warn"), one trip under sync-debug "error" (no host read inside a
    trip), mean px and peak memory; held to the port's own float64 fit of
    the same frames (mean px within SINGLE_F64_GAP_MAX_PX; frames further
    apart than SINGLE_FLIP_PX are printed as basin flips).
    ``single_chol_eigh``: the float64 fit again with tr_solver="eigh",
    costs against chol's at CHOL_EIGH_RTOL. ``single_gmm``: the GMM prior
    of data/avatar-model/pose_prior.txt at beta_pose=SINGLE_GMM_BETA, a
    start per component added to the start set, best of starts.
    ``single_chunked``: all frames unchunked and in chunks of
    SINGLE_CHUNK, the largest per-frame difference relative to scale and
    both wall times."""
    import torch
    from smpltpu_torch.energy.params import init_frame_params
    from smpltpu_torch.io import load_pose_prior_txt
    from smpltpu_torch.solve.init import best_of_starts, make_start_set
    from smpltpu_torch.bench import single_problem
    from smpltpu_torch.solve.lm import LMConfig, lm_program
    from smpltpu_torch.solve.single_frame import (
        _bounds_and_frozen,
        _residual_fn,
        build_fitter,
    )
    f32, f64 = torch.float32, torch.float64
    n = SINGLE_FRAMES
    kp = w["kp"][:n]
    kp_t = torch.as_tensor(kp, device=dev)
    x0 = init_frame_params(device=dev, dtype=f32).repeat(n, 1)
    prob = single_problem(w, f32, beta_pose=SINGLE_BETA_POSE)

    def fitter(p, dtype, iters=SINGLE_ITERS, **kw):
        return build_fitter(p, iters, device=dev, dtype=dtype, **kw)

    # single_fit
    fitter(prob, f32, iters=1)(x0, kp_t)
    torch.cuda.reset_peak_memory_stats()
    st, fit_s = timed(lambda: fitter(prob, f32)(x0, kp_t))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    trips = int(st.iters_run.max())
    px32 = frame_px(prob, st.x, kp)
    counts = {}
    for k in (1, SINGLE_PROFILE_TRIPS):
        short = fitter(prob, f32, iters=k)
        st_k, launches, syncs = launches_and_syncs(lambda: short(x0, kp_t))
        counts[k] = (int(st_k.iters_run.max()), launches, syncs)
    (t1, l1, s1), (tk, lk, sk) = counts[1], counts[SINGLE_PROFILE_TRIPS]
    per_trip = (lk - l1) / max(tk - t1, 1)
    syncs_per_trip = (sk - s1) / max(tk - t1, 1)
    lower, upper, frozen = _bounds_and_frozen(prob, device=dev, dtype=f32)
    init, step = lm_program(lambda x, jac: _residual_fn(prob, kp_t, x, jac),
                            LMConfig(max_iters=SINGLE_ITERS), lower, upper,
                            frozen)
    state = step(init(x0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state)
        trip_error = None
    except RuntimeError as e:
        trip_error = str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    prob64 = single_problem(w, f64, beta_pose=SINGLE_BETA_POSE)
    st64, fit64_s = timed(lambda: fitter(prob64, f64)(x0.double(),
                                                      kp_t.double()))
    px64 = frame_px(prob64, st64.x, kp)
    gap = abs(float(px32.mean()) - float(px64.mean()))
    flips = [[int(i), float(px32[i]), float(px64[i])]
             for i in np.nonzero(np.abs(px32 - px64) > SINGLE_FLIP_PX)[0]]
    ok = bool(np.isfinite(px32).all() and gap <= SINGLE_F64_GAP_MAX_PX
              and trip_error is None and syncs_per_trip <= 1.0 and trips > 0)
    checks(ok, f"single_fit: f32 {px32.mean()} px against f64 "
               f"{px64.mean()} px, sync in a trip: {trip_error}, "
               f"{syncs_per_trip} syncs a trip")
    phase("9 single_fit", ok=ok, frames=n, max_iters=SINGLE_ITERS,
          beta_pose=SINGLE_BETA_POSE, fit_s=fit_s, frames_per_s=n / fit_s,
          lm_trips=trips, converged=int(st.converged.sum()),
          device_launches_per_trip=per_trip,
          host_syncs_per_trip=syncs_per_trip,
          profiled_runs={str(k): list(v) for k, v in counts.items()},
          trip_under_sync_error=trip_error or "clean",
          mean_px=float(px32.mean()), f64_mean_px=float(px64.mean()),
          f64_gap_px=gap, f64_fit_s=fit64_s,
          f64_lm_trips=int(st64.iters_run.max()), basin_flips=flips,
          peak_gib=peak_gib)
    single_ref = (prob, x0, kp_t, st)

    # single_chol_eigh, float64
    ste, eigh_s = timed(lambda: fitter(
        prob64, f64, lm_cfg=LMConfig(max_iters=SINGLE_ITERS,
                                     tr_solver="eigh"))(x0.double(),
                                                        kp_t.double()))
    cc, ce = st64.cost.cpu().numpy(), ste.cost.cpu().numpy()
    rel = np.abs(cc - ce) / np.maximum(np.abs(ce), 1e-30)
    apart = np.nonzero(rel > CHOL_EIGH_RTOL)[0]
    px_e = frame_px(prob64, ste.x, kp)
    ok = bool(np.isfinite(ce).all() and len(apart) <= n // 10)
    checks(ok, f"single_chol_eigh: {len(apart)} of {n} frames apart")
    phase("9 single_chol_eigh", ok=ok, frames=n, rtol=CHOL_EIGH_RTOL,
          frames_within=int(n - len(apart)), max_rel_within=float(
              np.delete(rel, apart).max()) if len(apart) < n else None,
          apart=[[int(i), float(cc[i]), float(ce[i]), float(px64[i]),
                  float(px_e[i])] for i in apart],
          chol_fit_s=fit64_s, eigh_fit_s=eigh_s,
          eigh_lm_trips=int(ste.iters_run.max()),
          eigh_mean_px=float(px_e.mean()))

    # single_gmm
    here = os.path.dirname(os.path.abspath(__file__))
    gmm = load_pose_prior_txt(os.path.join(here, "data", "avatar-model",
                                           "pose_prior.txt"))
    prob_g = single_problem(w, f32, gmm=gmm, beta_pose=SINGLE_GMM_BETA)
    starts = make_start_set(kp, prob_g.spec, w["cam"], pose_seeds=gmm["means"])
    s_dim = starts.shape[1]
    xg = torch.as_tensor(starts.reshape(n * s_dim, -1), device=dev).to(f32)
    kg = torch.as_tensor(np.repeat(kp, s_dim, axis=0), device=dev)
    fitter(prob_g, f32, iters=1)(xg, kg)
    torch.cuda.reset_peak_memory_stats()
    stg, gmm_s = timed(lambda: fitter(prob_g, f32)(xg, kg))
    xb, _, best = best_of_starts(stg, n, s_dim)
    pxg = frame_px(prob_g, xb, kp)
    ok = bool(s_dim == 13 and np.isfinite(pxg).all())
    checks(ok, f"single_gmm: {s_dim} starts, px finite {np.isfinite(pxg).all()}")
    phase("9 single_gmm", ok=ok, frames=n, starts=s_dim, problems=n * s_dim,
          beta_pose=SINGLE_GMM_BETA, fit_s=gmm_s,
          lm_trips=int(stg.iters_run.max()),
          converged=int(stg.converged.sum()), mean_px=float(pxg.mean()),
          best_start_counts=np.bincount(best, minlength=s_dim).tolist(),
          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    # single_chunked, every frame of the workload
    kp_all = torch.as_tensor(w["kp"], device=dev)
    x0a = init_frame_params(device=dev, dtype=f32).repeat(w["n_frames"], 1)
    stu, unch_s = timed(lambda: fitter(prob, f32)(x0a, kp_all))
    stc, ch_s = timed(lambda: fitter(prob, f32, chunk=SINGLE_CHUNK)(
        x0a, kp_all))
    rel = ((stc.x - stu.x).abs().amax(-1)
           / stu.x.abs().amax(-1)).cpu().numpy()
    ok = bool(np.isfinite(rel).all())
    checks(ok, "single_chunked: non-finite parameters")
    phase("9 single_chunked", ok=ok, frames=w["n_frames"], chunk=SINGLE_CHUNK,
          unchunked_s=unch_s, chunked_s=ch_s,
          max_rel_diff=float(rel.max()),
          frames_apart_1e3=int((rel > 1e-3).sum()),
          unchunked_lm_trips=int(stu.iters_run.max()),
          unchunked_mean_px=float(frame_px(prob, stu.x, w["kp"]).mean()),
          chunked_mean_px=float(frame_px(prob, stc.x, w["kp"]).mean()))
    return single_ref


def stream_px(w, xs, shp, kp):
    """Each frame's mean keypoint error (px) under the solver's model with
    the locked shape ``shp``: xs (F, P) -> (F,) numpy."""
    import torch
    from smpltpu_torch.energy import project, skeleton_joints_cam
    dev = w["spec"].r0.device
    x = torch.as_tensor(np.asarray(xs), device=dev).to(torch.float32)
    uv = project(skeleton_joints_cam(x, shp.to(dev, torch.float32),
                                     w["spec"]), w["cam"])
    kp_t = torch.as_tensor(kp, device=dev)
    return torch.linalg.norm(uv[:, w["use_smpl"]] - kp_t[:, :, 1:3],
                             dim=-1).mean(-1).cpu().numpy()


def rel_apart(a, b):
    """The largest difference of two (F, P) parameter sets, each frame's
    relative to that frame's scale (its largest |entry| in ``b``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b).max(-1)
                  / np.maximum(np.abs(b).max(-1), 1e-30)).max())


def capture_checks(dev):
    """Each factorization and solve the online trip runs (and ``solve_ex``
    of the damped mode), at batch 1 and P = 76, captured into a CUDA graph
    under sync-debug "error" and replayed: {name: error or "clean", and the
    largest difference from the eager call}."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(0)
    a0 = torch.randn(1, 76, 76, generator=g, dtype=torch.float64)
    a = (a0 @ a0.transpose(1, 2) + 76 * torch.eye(76, dtype=torch.float64)
         ).to(device=dev, dtype=torch.float32)
    b = torch.randn(1, 76, 1, generator=g).to(dev)
    ell = torch.linalg.cholesky(a)
    ops = {
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(
            a, check_errors=False)[0],
        "cholesky_solve": lambda: torch.cholesky_solve(b, ell),
        "solve_triangular": lambda: torch.linalg.solve_triangular(
            ell, b, upper=False),
        "solve_ex": lambda: torch.linalg.solve_ex(a, b[..., 0],
                                                  check_errors=False)[0],
    }
    out = {}
    for name, fn in ops.items():
        want = fn()
        torch.cuda.synchronize()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got = fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            graph.replay()
            err = "clean"
        except RuntimeError as e:
            err, got = str(e)[:300], None
        torch.cuda.synchronize()
        out[name] = {"capture": err, "max_abs_diff": (
            None if got is None else float((got - want).abs().max()))}
    return out


def stream_phases(w, shp, dev, checks):
    """Phase 10, the streaming path on bench.py's BENCH_STREAM* workload:
    the first STREAM_FRAMES frames from the init pose, the shape ``shp``
    of phase 5's stage 1, OnlineConfig(**STREAM_CFG), f32.

    ``stream_capture``: each solver call of the online trip (and the
    damped mode's ``solve_ex``) captured at batch 1 under sync-debug
    "error". ``stream_step``: ``OnlineFitter.step`` frame by frame (the
    eager LM loop) after a one-trip warm-up: latency, LM trips a frame,
    device launches and host syncs a trip (profiler and sync-debug "warn"
    over a 1-trip and a STREAM_PROFILE_TRIPS-trip step), peak GiB, mean px.
    ``stream_scan``: ``OnlineFitter.replay`` over the same frames on the
    trip graph, timed after a first run (the capture): graph replays a
    frame, launches and syncs a frame, its distance from the step loop
    relative to scale. ``stream_pump``: the frames submitted one at a time
    after a sacrificial frame: latency, distance from the step loop.
    ``stream_hold``: every 10th of the first STREAM_HOLD_FRAMES frames
    emptied; in all three paths a held frame equals the frame before, bit
    for bit, unsolved. ``stream_f64``: the step loop in float64, mean px
    against the float32 loop's."""
    import torch
    from smpltpu_torch.energy.params import init_frame_params
    from smpltpu_torch.solve.online import (
        OnlineConfig,
        OnlineFitter,
        build_online_step,
    )
    f32, f64 = torch.float32, torch.float64
    n = STREAM_FRAMES
    kp = w["kp"][:n]
    cfg = OnlineConfig(**STREAM_CFG)
    x_init = init_frame_params(device=dev, dtype=f32)

    def fitter(dtype=f32, config=cfg):
        return OnlineFitter(w["model"], w["cam"], config, shape=shp,
                            device=dev, dtype=dtype)

    def step_loop(fit, frames):
        lat, xs, trips, solved = [], [], [], []
        for k in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, res = fit.step(k)
            lat.append((time.perf_counter() - t0) * 1e3)
            xs.append(x)
            trips.append(0 if res is None else int(res.iters_run[0]))
            solved.append(res is not None)
        return (np.asarray(lat), np.stack(xs), np.asarray(trips),
                np.asarray(solved))

    def pct(lat):
        return {"mean": float(lat.mean()), "p50": float(np.percentile(lat, 50)),
                "p95": float(np.percentile(lat, 95))}

    # stream_capture
    cap = capture_checks(dev)
    ok = all(v["capture"] == "clean" and v["max_abs_diff"] <= 1e-4
             for v in cap.values())
    checks(ok, f"stream_capture: {cap}")
    phase("10 stream_capture", ok=ok, **cap)

    # stream_step
    fit = fitter()
    prev = fit.prev[None]
    one = build_online_step(fit.spec, fit.cam, cfg._replace(max_iters=1),
                            w["model"].num_joints, device=dev, dtype=f32)
    one(prev, fit.shape, kp[:1], prev, torch.zeros(1, device=dev))
    torch.cuda.reset_peak_memory_stats()
    lat, xs_step, trips, _ = step_loop(fit, kp)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    px32 = stream_px(w, xs_step, fit.shape, kp)
    counts = {}
    x1 = torch.as_tensor(xs_step[:1], device=dev)
    for k in (1, STREAM_PROFILE_TRIPS):
        short = build_online_step(fit.spec, fit.cam,
                                  cfg._replace(max_iters=k),
                                  w["model"].num_joints, device=dev,
                                  dtype=f32)
        r, launches, syncs = launches_and_syncs(lambda: short(
            x1, fit.shape, kp[1:2], x1, torch.ones(1, device=dev)))
        counts[k] = (int(r.iters_run[0]), launches, syncs)
    (t1, l1, s1), (tk, lk, sk) = counts[1], counts[STREAM_PROFILE_TRIPS]
    per_trip = (lk - l1) / max(tk - t1, 1)
    syncs_per_trip = (sk - s1) / max(tk - t1, 1)
    ok = bool(np.isfinite(px32).all() and syncs_per_trip <= 1.0
              and tk > t1)
    checks(ok, f"stream_step: px finite {np.isfinite(px32).all()}, "
               f"{syncs_per_trip} syncs a trip, profiled trips {t1}, {tk}")
    phase("10 stream_step", ok=ok, frames=n, **STREAM_CFG,
          latency_ms=pct(lat), frames_per_s=1e3 / lat.mean(),
          lm_trips_per_frame=float(trips.mean()),
          lm_trips_max=int(trips.max()), lm_trips_first=int(trips[0]),
          device_launches_per_trip=per_trip,
          host_syncs_per_trip=syncs_per_trip,
          profiled_runs={str(k): list(v) for k, v in counts.items()},
          peak_gib=peak_gib, mean_px=float(px32.mean()))

    # stream_scan: the first run captures the trip graph; the second is
    # timed; both from the init pose with no previous frame
    fit_s = fitter()
    _, first_s = timed(lambda: fit_s.replay(kp))
    scan = fit_s._scan
    graph = scan.__self__
    trips0 = graph.trips
    out, scan_s = timed(lambda: scan(x_init, fit_s.shape, kp, 0.0))
    replays = graph.trips - trips0
    xs_scan = out[0].cpu().numpy()
    apart = rel_apart(xs_scan, xs_step)
    _, s_launches, s_syncs = launches_and_syncs(
        lambda: scan(x_init, fit_s.shape, kp[:STREAM_PROFILE_FRAMES], 0.0))
    s_trips = graph.trips - trips0 - replays
    ok = bool(apart <= STREAM_AGREE_MAX and np.isfinite(xs_scan).all()
              and out[3].all())
    checks(ok, f"stream_scan: {apart} of scale from the step loop")
    phase("10 stream_scan", ok=ok, frames=n, first_run_s=first_s,
          wall_ms=scan_s * 1e3, ms_per_frame=scan_s * 1e3 / n,
          frames_per_s=n / scan_s,
          trip_replays_per_frame=replays / n, init_replays_per_frame=1.0,
          lm_trips_equal_step=bool(np.array_equal(
              out[2].cpu().numpy(), trips)),
          profiled_frames={"frames": STREAM_PROFILE_FRAMES, "trips": s_trips,
                           "device_launches": s_launches,
                           "host_syncs": s_syncs},
          max_rel_apart_from_step=apart,
          bitwise_equal_step=bool(np.array_equal(xs_scan, xs_step)),
          mean_px=float(stream_px(w, xs_scan, fit_s.shape, kp).mean()))

    # stream_pump: a sacrificial frame (the capture), stop, restart
    fit_p = fitter()
    pump = fit_p.make_pump()
    t0 = time.perf_counter()
    pump.start(x_init, fit_p.shape, 0.0)
    pump.submit(kp[0])
    pump.stop()
    first_ms = (time.perf_counter() - t0) * 1e3
    pump.start(x_init, fit_p.shape, 0.0)
    lat_p, xs_pump = [], []
    for k in kp:
        t0 = time.perf_counter()
        xs_pump.append(pump.submit(k)[0])
        lat_p.append((time.perf_counter() - t0) * 1e3)
    pump.stop()
    lat_p = np.asarray(lat_p)
    xs_pump = np.stack(xs_pump)
    apart_p = rel_apart(xs_pump, xs_step)
    ok = bool(apart_p <= STREAM_AGREE_MAX and np.isfinite(xs_pump).all())
    checks(ok, f"stream_pump: {apart_p} of scale from the step loop")
    phase("10 stream_pump", ok=ok, frames=n, first_round_trip_ms=first_ms,
          latency_ms=pct(lat_p), frames_per_s=1e3 / lat_p.mean(),
          max_rel_apart_from_step=apart_p,
          bitwise_equal_step=bool(np.array_equal(xs_pump, xs_step)))

    # stream_hold
    kp_h = kp[:STREAM_HOLD_FRAMES].copy()
    held = np.arange(9, STREAM_HOLD_FRAMES, 10)
    kp_h[held, :, 3] = 0.0
    _, xs_h, _, solved_h = step_loop(fitter(), kp_h)
    xs_hs, solved_hs, _, _, _ = fitter().replay(kp_h)
    pump = fitter().make_pump()
    pump.start(x_init, fit_p.shape, 0.0)
    outs = [pump.submit(k) for k in kp_h]
    pump.stop()
    xs_hp = np.stack([o[0] for o in outs])
    solved_hp = np.array([o[3] for o in outs])
    res = {}
    for name, xs_, sol in (("step", xs_h, solved_h), ("scan", xs_hs, solved_hs),
                           ("pump", xs_hp, solved_hp)):
        res[name] = bool(np.array_equal(np.flatnonzero(~sol), held)
                         and all(np.array_equal(xs_[i], xs_[i - 1])
                                 for i in held))
    ok = all(res.values())
    checks(ok, f"stream_hold: held frames {held.tolist()}: {res}")
    phase("10 stream_hold", ok=ok, frames=STREAM_HOLD_FRAMES,
          held=held.tolist(), held_equal_previous=res,
          scan_rel_apart_from_step=rel_apart(xs_hs, xs_h),
          pump_rel_apart_from_step=rel_apart(xs_hp, xs_h))

    # stream_f64
    fit64 = fitter(f64)
    lat64, xs64, trips64, _ = step_loop(fit64, kp)
    px64 = stream_px(w, xs64, fit64.shape, kp)
    gap = abs(float(px32.mean()) - float(px64.mean()))
    flips = [[int(i), float(px32[i]), float(px64[i])]
             for i in np.nonzero(np.abs(px32 - px64) > SINGLE_FLIP_PX)[0]]
    ok = bool(np.isfinite(px64).all() and gap <= STREAM_F64_GAP_MAX_PX)
    checks(ok, f"stream_f64: f32 {px32.mean()} px against f64 {px64.mean()}")
    phase("10 stream_f64", ok=ok, frames=n, mean_px=float(px32.mean()),
          f64_mean_px=float(px64.mean()), gap_px=gap, basin_flips=flips,
          f64_latency_ms=pct(lat64),
          f64_lm_trips_per_frame=float(trips64.mean()),
          max_rel_apart=rel_apart(xs_step, xs64))

def mesh_phases(w, st1, st1_exact, st2, single_ref, dev, checks):
    """Phase 11, the multi-device path (``smpltpu_torch/parallel``) on one
    rank over NCCL (``frames_mesh(2, "cuda")`` on one card: the JAX CLI's
    one-device mesh), full width, bench.py's workload.

    ``mesh_window``: window DP of phase 5's 67 windows (their starts
    interpolated from its stage-1 anchors, its stage-1 shape, K1), bitwise
    equal to the unsharded batched fit of the same windows. ``mesh_lm``:
    the sharded LM as stage 1 on the 100 anchors in float32 for
    MESH_LM_TRIPS trips, timed; its device launches, host syncs and NCCL
    calls a trip (1- and MESH_PROFILE_TRIPS-trip runs under the profiler
    and sync-debug "warn"), a two-trip fit under sync-debug "error"; its
    anchors' full-batch px and its cost against the exact one-device stage
    1 of phase 5 (``st1_exact``: ``linear="tridiag"`` on the same anchors
    and config), which the converged block-Jacobi PCG should reach; its
    cost no higher than phase 5's stage 1 with K1 (``st1``, 40 Jacobi-PCG
    steps a trip, short of convergence); and at MESH_F64_DEPTH trips its
    px against its own float64 run's. ``mesh_frame``:
    frame DP of phase 9's 128 frames, bitwise equal to phase 9's fit. ``graft_entry``: ``graft_entry.entry()`` on the card
    (K1, K2) and the host's launch floor against
    ``utils/roofline.py::DISPATCH_FLOOR_S``. The launch counts are set to
    0 before each run and read after it."""
    import copy
    import torch
    from smpltpu_torch.constants import init_root_rotation
    from smpltpu_torch.bench import full_batch_residual
    from smpltpu_torch.energy import make_skeleton_spec
    from smpltpu_torch.energy.params import init_frame_params
    from smpltpu_torch.ops import LAUNCHES
    from smpltpu_torch.parallel import (
        build_sharded_lm_fitter,
        frames_mesh,
        sharded_frame_fit,
        sharded_window_fit,
    )
    from smpltpu_torch.solve import MultiFrameConfig, build_multi_fitter
    from smpltpu_torch.solve.single_frame import build_fitter
    from smpltpu_torch.solve.two_stage import interp_tables
    from smpltpu_torch.utils import roofline

    f32, f64 = torch.float32, torch.float64
    mesh = frames_mesh(2, dev)
    checks(mesh.size == 1 and mesh.device == dev,
           f"one card: a mesh of {mesh.size} ranks on {mesh.device}")
    common = dict(beta_pose=5.0, lambda_temporal=3.0, linear="pcg_kernel",
                  cg_iters=CG_ITERS, fused_cost=True)
    cfg1 = MultiFrameConfig(beta_shape=25.0, max_iters=S1_ITERS, **common)
    cfg2 = MultiFrameConfig(beta_shape=1e5, max_iters=S2_ITERS, **common)

    # mesh_window: stage 2's windows from phase 5's anchors, as
    # solve/two_stage.py builds them
    n, anchor_idx = w["n_frames"], w["anchor_idx"]
    seg, hi, tt = interp_tables(anchor_idx, n)
    tt = torch.as_tensor(tt, dtype=f32, device=dev)[:, None]
    ap = st1.params
    poses = (1.0 - tt) * ap[torch.as_tensor(seg, device=dev)] + tt * ap[
        torch.as_tensor(hi, device=dev)]
    win_f = np.asarray(w["starts"])[:, None] + np.arange(WSIZE)[None]
    valid = torch.as_tensor(win_f < n, device=dev)[..., None]
    p0w = torch.where(valid, poses[torch.as_tensor(np.clip(win_f, 0, n - 1),
                                                   device=dev)],
                      init_frame_params(device=dev, dtype=f32))
    kpw, r0w, vw = w["args"][4:]
    n_win = len(w["starts"])
    fit2 = build_multi_fitter(w["spec"], w["cam"], cfg2, 10, device=dev,
                              dtype=f32)
    ref, ref_s = timed(lambda: fit2(p0w, st1.shape, kpw, r0w, vw))
    LAUNCHES.clear()
    calls0 = dict(mesh.calls)
    got, dp_s = timed(lambda: sharded_window_fit(
        mesh, fit2, p0w, st1.shape.expand(n_win, -1), kpw, r0w, vw))
    k1_window = LAUNCHES["arrow_pcg"]
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, ref))
    same_as_phase5 = all(bool(torch.equal(a, b)) for a, b in zip(got, st2))
    trips2 = int(got.iters_run.max())
    ok = bool(bitwise and k1_window == trips2 and trips2 > 0)
    checks(ok, f"mesh_window: bitwise {bitwise}, K1 {k1_window} launches, "
               f"{trips2} trips")
    phase("11 mesh_window", ok=ok, ranks=mesh.size, windows=n_win,
          bitwise_vs_unsharded=bitwise, bitwise_vs_phase5_stage2=same_as_phase5,
          k1_launches=k1_window, lm_trips=trips2, dp_s=dp_s,
          unsharded_s=ref_s, nccl_calls={k: v - calls0.get(k, 0)
                                         for k, v in mesh.calls.items()})
    del ref, got

    # mesh_lm: the sharded LM on the 100 anchors
    a_args = w["args"][:4]

    def lm(k):
        return build_sharded_lm_fitter(mesh, w["spec"], w["cam"],
                                       cfg1._replace(max_iters=k), 10)
    lm(1)(*a_args)
    counts = {}
    for k in (1, MESH_PROFILE_TRIPS):
        c0 = mesh.calls["all_reduce"] + mesh.calls["all_gather"]
        fit_k = lm(k)
        _, launches, syncs = launches_and_syncs(lambda: fit_k(*a_args))
        counts[k] = (launches, syncs,
                     mesh.calls["all_reduce"] + mesh.calls["all_gather"] - c0)
    (l1, s1, n1), (lk, sk, nk) = counts[1], counts[MESH_PROFILE_TRIPS]
    per = MESH_PROFILE_TRIPS - 1
    two = lm(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        two(*a_args)
        sync_error = None
    except RuntimeError as e:
        sync_error = str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fit_full = lm(MESH_LM_TRIPS)
    c0 = mesh.calls["all_reduce"]
    res, lm_s = timed(lambda: fit_full(*a_args))
    nccl_full = mesh.calls["all_reduce"] - c0
    kp_a = w["kp"][anchor_idx]
    anchors = {**w, "kp": kp_a}
    px = full_batch_residual(anchors, res.params, res.shape)
    px5 = full_batch_residual(anchors, st1.params, st1.shape)
    px_exact = full_batch_residual(anchors, st1_exact.params, st1_exact.shape)
    cost, cost_exact = float(res.cost), float(st1_exact.cost)
    cost_gap = abs(cost - cost_exact) / cost_exact
    # the float64 twin at MESH_F64_DEPTH trips, beside float32's at as many
    model64 = copy.deepcopy(w["model"]).to(f64)
    cam64 = type(w["cam"])(*(c.to(f64) for c in w["cam"]))
    spec64 = make_skeleton_spec(model64, init_root_rotation(), with_shape=True)
    res64, lm64_s = timed(lambda: build_sharded_lm_fitter(
        mesh, spec64, cam64, cfg1._replace(max_iters=MESH_F64_DEPTH), 10,
        dtype=f64)(*(a.double() for a in a_args)))
    res32 = lm(MESH_F64_DEPTH)(*a_args)
    anchors64 = {**anchors, "spec": spec64, "cam": cam64}
    px64 = full_batch_residual(anchors64, res64.params, res64.shape)
    px32 = full_batch_residual(anchors, res32.params, res32.shape)
    gap5, gap_exact, gap64 = abs(px - px5), abs(px - px_exact), abs(px32 - px64)
    ok = bool(np.isfinite(px) and sync_error is None and sk == s1
              and gap_exact <= MESH_EXACT_GAP_MAX_PX
              and cost_gap <= MESH_EXACT_COST_RTOL
              and cost <= float(st1.cost) and gap64 <= MESH_F64_GAP_MAX_PX)
    checks(ok, f"mesh_lm: {px} px, cost {cost} against the exact stage 1's "
               f"{px_exact} px, cost {cost_exact}; phase 5's cost "
               f"{float(st1.cost)}; f64's {px64} px against f32's {px32}; "
               f"sync under 'error': {sync_error}, syncs {counts}")
    phase("11 mesh_lm", ok=ok, ranks=mesh.size, anchors=len(anchor_idx),
          lm_trips=MESH_LM_TRIPS, cg_iters=CG_ITERS, fit_s=lm_s,
          ms_per_trip=lm_s / MESH_LM_TRIPS * 1e3,
          device_launches_per_trip=(lk - l1) / per,
          host_syncs_per_trip=(sk - s1) / per,
          nccl_calls_per_trip=(nk - n1) / per,
          nccl_all_reduces_per_fit=nccl_full,
          profiled_runs={str(k): list(v) for k, v in counts.items()},
          two_trips_under_sync_error=sync_error or "clean",
          converged=bool(res.converged), lm_trips_unconverged=int(
              res.iters_run), accepted=int(res.n_accepted),
          anchor_px=px, exact_stage1_px=px_exact, gap_to_exact_px=gap_exact,
          cost=cost, exact_stage1_cost=cost_exact,
          cost_gap_to_exact_rel=cost_gap,
          exact_stage1_trips=int(st1_exact.iters_run),
          phase5_stage1_px=px5, gap_to_phase5_px=gap5,
          phase5_stage1_cost=float(st1.cost),
          f64_lm_trips=MESH_F64_DEPTH, f32_anchor_px_there=px32,
          f64_anchor_px=px64, f64_gap_px=gap64, f64_fit_s=lm64_s)
    del res64, res32, model64

    # mesh_frame: phase 9's frames over the mesh
    prob, x0, kp_t, st9 = single_ref
    fitter = build_fitter(prob, SINGLE_ITERS, device=dev, dtype=f32)
    LAUNCHES.clear()
    got, frame_s = timed(lambda: sharded_frame_fit(mesh, fitter, x0, kp_t))
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, st9))
    checks(bitwise, "mesh_frame: not bitwise equal to phase 9's fit")
    phase("11 mesh_frame", ok=bitwise, ranks=mesh.size, frames=len(x0),
          bitwise_vs_phase9=bitwise, fit_s=frame_s,
          launches={k: v for k, v in LAUNCHES.items() if "@" not in k})

    # graft_entry, and the host's launch floor
    from smpltpu_torch import graft_entry
    fn, args = graft_entry.entry()
    LAUNCHES.clear()
    out, entry_s = timed(lambda: fn(*args))
    entry_launches = {k: v for k, v in LAUNCHES.items() if "@" not in k}
    x = torch.zeros(1, device=dev)
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10000):
        x.add_(1.0)
    floor_s = (time.perf_counter() - t0) / 1e4
    torch.cuda.synchronize()
    ok = bool([tuple(o.shape) for o in out] == [(4, 6, 76), (4,), (4, 10),
                                                 (4, 1024, 3)]
              and all(bool(torch.isfinite(o).all()) for o in out)
              and entry_launches.get("arrow_pcg", 0) > 0
              and entry_launches.get("lbs", 0) == 1
              and roofline.DISPATCH_FLOOR_S / LAUNCH_FLOOR_BAND <= floor_s
              <= LAUNCH_FLOOR_BAND * roofline.DISPATCH_FLOOR_S)
    checks(ok, f"graft_entry: launches {entry_launches}, launch floor "
               f"{floor_s} s against {roofline.DISPATCH_FLOOR_S}")
    phase("11 graft_entry", ok=ok, wall_s=entry_s, launches=entry_launches,
          launch_floor_us=floor_s * 1e6,
          dispatch_floor_us=roofline.DISPATCH_FLOOR_S * 1e6)
    mesh.close()
    cli_mesh_phases(checks)


def cli_mesh_phases(checks):
    """``11 cli_mesh*``: the multi and single CLIs with ``--mesh 2`` on one
    card (``CLI_MESH_RUNS``: one rank over NCCL; the sharded stage 1 and
    window DP with K1, frame DP), the full-width model on video1, each
    log.csv mean held to the port's CPU run of the same argv, every K3
    launch pixel-exact against ``rasterize_torch``."""
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    kps = os.path.join(here, "data", "keypoints", "video1")
    frames_dir = os.path.join(here, "data", "frames_annotated", "video1")
    root = os.path.join(here, "build", "chip_smoke_cli_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    for label, cli, argv, cpu_mean in CLI_MESH_RUNS:
        res, frames, errs = cli_run(label, ["synthetic", kps, frames_dir]
                                    + argv, root, checks, k3_check=True,
                                    cli=cli)
        if res["rc"] == 0:
            gap = abs(res["mean_px"] - cpu_mean)
            need = ("arrow_pcg", "lbs", "raster") if cli == "multi" else (
                "lbs", "raster")
            ok = bool(gap <= CLI_MESH_GAP_MAX_PX and len(frames) > 0
                      and all(res["launches"].get(k, 0) > 0 for k in need))
            checks(ok, f"{label}: mean {res['mean_px']} px against the "
                       f"CPU's {cpu_mean}, {res}")
            res.update(ok=ok, cpu_mean_px=cpu_mean, gap_px=gap)
        phase(f"11 {label}", **res)
    shutil.rmtree(root, ignore_errors=True)


def k1_long_phase(rng, dev, checks):
    """``3 k1_long``: K1 at the long video's shapes (K1_LONG), 64 steps, on
    random SPD systems through ``k1_compare`` (held to K1_TOL of the plain
    version, run twice and bitwise identical, timed beside the bound); one
    line with every case's plan, scratch bytes and times."""
    cases, ok = {}, True
    for label, n_w, f in K1_LONG:
        a = random_arrow_system(rng, n_w, f, dev)
        c = k1_compare(f"long_{label}", a, LONG_CG_ITERS, 0.0, checks,
                       reps=(3, 1))
        del a
        ok &= c["ok"]
        cases[label] = {
            "plan": c["plan"], "scratch_bytes": 4 * c["plan"]["scratch_floats"],
            "bitwise_repeat": c["bitwise_repeat"],
            "max_abs_err": max(c["max_abs_err_p"], c["max_abs_err_w"]),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "ms_over_bound": c["ms"] / c["bound_ms"]}
    phase("3 k1_long", ok=ok, iters=LONG_CG_ITERS, cases=cases)
    return cases


@contextlib.contextmanager
def first_k1_systems(store):
    """Within the block, K1's entry keeps a copy of the first system of
    each (W, F) it is called with in ``store`` ({(W, F): (args, kwargs)}),
    then launches as always; the fitter looks the entry up on each call."""
    from smpltpu_torch.ops import cg
    real = cg.arrow_pcg

    def capture(*a, **k):
        key = tuple(a[5].shape[:2])
        if key not in store:
            store[key] = ([t.clone() for t in a], k)
        return real(*a, **k)
    cg.arrow_pcg = capture
    try:
        yield store
    finally:
        cg.arrow_pcg = real


def counted_run(fn):
    """fn() from zeroed launch counts and peak memory, ended by a device
    synchronize: (its result, wall s, the launch counts, peak GiB)."""
    import torch
    from smpltpu_torch.ops import LAUNCHES
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    return (out, wall_s, dict(LAUNCHES),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def stage2_k1_launches(st2, n_win, chunk):
    """The K1 launches a stage 2 of ``n_win`` windows in chunks of
    ``chunk`` (0: one batch) must make, by shape: each chunk's slowest
    window's trips at (that chunk's windows, WSIZE)."""
    want = {}
    step = chunk if chunk > 0 else n_win
    for s in range(0, n_win, step):
        key = f"arrow_pcg@{min(step, n_win - s)}x{WSIZE}"
        want[key] = want.get(key, 0) + int(st2.iters_run[s:s + step].max())
    return want


def long_fit(w, linear, dev, chunk, checks, label, first=None):
    """bench.py's long recipe on the workload ``w`` with 64 CG steps, run
    once from zeroed counts: ``chunk`` > 0, the multi CLI's sequential
    route with stage 2 in chunks of ``chunk`` windows
    (``build_cli_sequential``); 0, the fused two-stage fit with stage 2 as
    one batch. K1's launches by shape held to the loop trips, the
    full-batch residual to RESIDUAL_MAX_PX. ``first`` collects each K1
    shape's first system. Returns (the phase's numbers, stage-1 result,
    stage-2 result)."""
    from smpltpu_torch.bench import full_batch_residual, write_back
    if chunk:
        run = build_cli_sequential(w, linear, dev, chunk,
                                   cg_iters=LONG_CG_ITERS)
        args = w["args"][:4]
    else:
        run = build_fit(w, linear, dev, cg_iters=LONG_CG_ITERS)
        args = w["args"]
    n_win = len(w["starts"])
    with (first_k1_systems(first) if first is not None
          else contextlib.nullcontext()):
        (st1, st2), wall_s, launches, peak = counted_run(lambda: run(*args))
    trips1 = int(st1.iters_run)
    want = stage2_k1_launches(st2, n_win, chunk)
    k1 = {k: v for k, v in launches.items() if k.startswith("arrow_pcg@")}
    if linear == "pcg_kernel":
        want[f"arrow_pcg@1x{len(w['anchor_idx'])}"] = trips1
        checks(k1 == want and launches["arrow_pcg"] == sum(want.values()),
               f"{label}: K1 launches {k1} != loop trips {want}")
    else:
        checks(not k1, f"{label}: {linear} launched K1: {k1}")
    residual = full_batch_residual(w, *write_back(w, st2))
    checks(np.isfinite(residual) and residual <= RESIDUAL_MAX_PX,
           f"{label}: full-batch residual {residual} px")
    res = {"linear": linear, "frames": w["n_frames"], "windows": n_win,
           "anchors": len(w["anchor_idx"]),
           "route": "cli_sequential" if chunk else "fused_two_stage",
           "chunk": chunk, "chunks": -(-n_win // chunk) if chunk else 1,
           "cg_iters": LONG_CG_ITERS, "fit_s": wall_s,
           **{k[:-2] + "_ms": v * 1e3
              for k, v in run.timings.items()},
           "frames_per_s": w["n_frames"] / wall_s,
           "stage1_trips": trips1,
           "stage2_trips": sum(v for k, v in want.items()
                               if k.endswith(f"x{WSIZE}")),
           "stage2_trips_max": int(st2.iters_run.max()),
           "stage2_converged": int(st2.converged.sum()),
           "k1_launches": launches.get("arrow_pcg", 0),
           "k1_launches_by_shape": k1,
           "full_batch_residual_px": residual, "peak_gib": peak}
    return res, st1, st2


def render_chunk_check(model, params, shp, r0, cam, height, width, gray,
                       covered, checks, label):
    """One chunk of ``render_frames`` again, on its own inputs: its
    vertices as the render makes them (FK, then K2), K2 held to
    ``lbs_torch`` within K2_ATOL; K3 from those vertices
    (``rasterize_verts``) and the plain rasterizer on their face setup,
    and the render's own output for the chunk (``gray``, ``covered``),
    both pixel-exact against the plain version. Each kernel timed on these
    inputs beside its plain version and its bound. -> (K2's numbers, K3's
    numbers), as the result line's rows take them."""
    import torch
    from smpltpu_torch.ops import lbs as k2
    from smpltpu_torch.render.zbuffer import (
        face_bbox,
        face_setup,
        rasterize_torch,
        rasterize_verts,
    )
    from smpltpu_torch.utils.writeback import params_to_pose
    dev = params.device
    b = params.shape[0]
    shapes = shp.expand(b, -1).contiguous()
    r0 = torch.as_tensor(r0, dtype=torch.float32, device=dev).expand(b, 3, 3)
    pose = params_to_pose(params, r0, model.num_joints)
    g_aff, _ = k2.joint_affines(model, shapes, pose.rotations, pose.root_pos)
    g_aff = g_aff.contiguous()
    ops = k2.prepare_lbs_operands(model)
    got = k2.lbs(shapes, g_aff, ops)
    k2_err = float((got - k2.lbs_torch(shapes, g_aff, ops)).abs().max())
    checks(k2_err <= K2_ATOL, f"{label}: K2 on the last chunk vs plain "
                              f"{k2_err} > {K2_ATOL}")
    n_s = shapes.shape[-1]
    k2_bound = bound(nbytes(shapes, g_aff, got, ops["v_template_t"],
                            ops["shapedirs_t"], ops["weights_t"]),
                     b * model.num_verts * (6 * n_s + 3
                                            + 24 * model.num_joints + 18))
    k2_row = {"frames": b, "max_abs_err": k2_err,
              "ms": graph_ms(lambda: k2.lbs(shapes, g_aff, ops), 50),
              "plain_ms": cuda_ms(lambda: k2.lbs_torch(shapes, g_aff, ops),
                                  10),
              "bound_ms": k2_bound[0], "bound_by": k2_bound[1]}

    verts = got.transpose(1, 2)
    faces = torch.as_tensor(model.faces, device=dev)
    intr = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    st = face_setup(verts, faces, *intr)
    g_p, c_p = rasterize_torch(st, height, width)
    g_k, c_k = rasterize_verts(verts, faces, *intr, height, width)
    k3_err = max(int((g_k.int() - g_p.int()).abs().max()),
                 int((c_k != c_p).sum()))
    d_render = int((gray != g_p).sum()) + int((covered != c_p).sum())
    checks(k3_err == 0 and d_render == 0,
           f"{label}: K3 on the last chunk differs from the plain version "
           f"(largest difference {k3_err}); the render's own frames of it "
           f"differ in {d_render} pixels")
    k3_bound = k3_bounds(st, verts, faces, height, width)[1]
    out = (g_k, c_k)
    k3_row = {"frames": b, "max_abs_err": k3_err,
              "render_differing_px": d_render,
              "ms": graph_ms(lambda: rasterize_verts(
                  verts, faces, *intr, height, width, out=out), 10),
              "plain_ms": cuda_ms(lambda: face_bbox(
                  face_setup(verts, faces, *intr), height, width), 5)
              + cuda_ms(lambda: rasterize_torch(st, height, width), 2),
              "bound_ms": k3_bound[0], "bound_by": k3_bound[1]}
    return k2_row, k3_row


def render_long(w, frame_params, shp, cam, height, width, checks, label):
    """``render_frames`` over every fitted frame of ``w`` at height x width
    from zeroed counts: K2 and K3 (with its setup stage) once per
    100-frame chunk, every frame covered, the render's memory beside its
    output under RENDER_WORK_MAX_GIB, and three frames' coverage against
    the host painter's as in phase 6. Returns the phase's numbers."""
    import torch
    from smpltpu_torch.ops import LAUNCHES
    from smpltpu_torch.pipeline.common import (
        batched_frame_eval,
        overlay_image,
        render_frames,
    )
    n = w["n_frames"]
    base = torch.cuda.memory_allocated()
    (gray, covered), render_s, launches, peak = counted_run(
        lambda: render_frames(w["model"], frame_params, shp, w["r0c"], cam,
                              height, width))
    n_chunks = -(-n // 100)
    counts = [launches.get(k, 0) for k in ("lbs", "raster", "raster_setup")]
    checks(counts == [n_chunks] * 3,
           f"{label}: K2, K3, K3 setup launches {counts} != {n_chunks} chunks")
    out_gib = nbytes(gray, covered) / 2 ** 30
    work_gib = peak - base / 2 ** 30 - out_gib
    checks(work_gib < RENDER_WORK_MAX_GIB,
           f"{label}: {work_gib} GiB beside the output >= "
           f"{RENDER_WORK_MAX_GIB}")
    checks(tuple(gray.shape) == (n, height, width) and gray.dtype == torch.uint8
           and tuple(covered.shape) == (n, height, width),
           f"{label}: render output shape")
    # by chunk: a sum over all frames at once would widen every pixel to
    # int64 first (68.7 GiB at 10 000 frames of 1280 x 720)
    per_frame = torch.cat([covered[s:s + 100].flatten(1).sum(1)
                           for s in range(0, n, 100)])
    checks(bool((per_frame > 0).all()),
           f"{label}: {int((per_frame == 0).sum())} rendered frames are empty")
    # the last 100-frame chunk, the farthest into the output, on its own
    s0 = (n - 1) // 100 * 100
    k2_row, k3_row = render_chunk_check(
        w["model"], frame_params[s0:], shp, w["r0c"], cam, height, width,
        gray[s0:], covered[s0:], checks, label)
    picks = [0, n // 2, n - 1]
    LAUNCHES.clear()
    _, verts = batched_frame_eval(
        w["model"], frame_params[picks], shp.expand(len(picks), -1),
        np.tile(w["r0c"], (len(picks), 1, 1)), w["kp"][picks], w["cam"])
    agree = {}
    for j, k in enumerate(picks):
        img = np.zeros((height, width, 3), np.uint8)
        overlay_image(w["model"], verts[j], img, cam)
        d_in_h, h_in_d = coverage_agreement(gray[k].cpu().numpy() > 0,
                                            img[..., 0] > 0)
        agree[k] = [float(d_in_h), float(h_in_d)]
        checks(d_in_h >= DEV_IN_HOST_MIN and h_in_d >= HOST_IN_DEV_MIN,
               f"{label}: frame {k}: device vs host painter coverage "
               f"{d_in_h}, {h_in_d}")
    res = {"frames": n, "height": height, "width": width,
           "render_s": render_s, "render_frames_per_s": n / render_s,
           "k2_launches": counts[0], "k3_launches": counts[1],
           "k3_setup_launches": counts[2], "output_gib": out_gib,
           "peak_gib": peak, "work_gib": work_gib,
           "min_covered_px": int(per_frame.min()),
           "mean_covered_px": float(per_frame.float().mean()),
           "dev_in_host_host_in_dev": agree,
           "last_chunk_from_frame": s0, "k2_last_chunk": k2_row,
           "k3_last_chunk": k3_row}
    del gray, covered, per_frame
    torch.cuda.empty_cache()
    return res


def chunk_gap(w, st1, st2c, st2b, dev, checks):
    """Where the 10k video's chunked stage 2 (``st2c``, the CLI's route)
    and its one batch (``st2b``, the fused fit) differ, and why.

    f32, the two runs: the per-window largest parameter difference, the
    window, frame and parameter (joint, axis) where it is largest, the
    per-window relative gap of the final costs (over the windows that
    converged in both, and the rest, which stopped at the trip cap), and
    how far the two solutions put the keypoints apart (projected joints,
    px). The CLI's host interpolation against the fused run's on the same
    anchors. f64, from the CLI's stage-2 inputs: the worst window's chunk
    of LONG_CHUNK windows against the same windows of one batch of all,
    the exact solve over all trips and the CG after PCG_GAP_TRIPS trips;
    in the CG's first trip, the systems the chunk and the batch hand it,
    and the CG on one system in the batch and alone after CG_GAP_STEPS
    steps, beside that system's exact solution. -> the numbers."""
    import copy

    import torch
    from smpltpu_torch.constants import init_root_rotation
    from smpltpu_torch.energy import (
        make_skeleton_spec,
        project,
        skeleton_joints_cam,
    )
    from smpltpu_torch.ops import cg as cg_ops
    from smpltpu_torch.solve import build_multi_fitter
    from smpltpu_torch.solve.multi_frame import arrow_tridiag
    from smpltpu_torch.solve.two_stage import (
        interp_tables,
        interpolate_anchors,
    )

    valid = w["args"][6] > 0                                  # (W, WSIZE)
    diff = (st2b.params - st2c.params).abs() * valid[..., None]
    per_window = diff.amax(dim=(1, 2))
    wi, fi, pi = (int(i) for i in np.unravel_index(int(diff.argmax()),
                                                   tuple(diff.shape)))
    cost_gap = (st2b.cost - st2c.cost).abs() / st2c.cost
    both = st2c.converged & st2b.converged

    def keypoints(st):
        uv = project(skeleton_joints_cam(st.params, st.shape[:, None],
                                         w["spec"]), w["cam"])
        return uv[:, :, w["use_smpl"]]                       # (W, F, K, 2)
    motion = ((keypoints(st2c) - keypoints(st2b)).norm(dim=-1)
              * valid[..., None]).amax(dim=(1, 2))          # (W,) px
    # the two routes' stage-2 initial poses
    seg, hi, t = interp_tables(w["anchor_idx"], w["n_frames"])
    fused = interpolate_anchors(
        st1.params, torch.as_tensor(seg, device=dev),
        torch.as_tensor(hi, device=dev),
        torch.as_tensor(t, dtype=st1.params.dtype, device=dev)[:, None])
    (bp, *_), _, _ = cli_windows(w, st1)
    starts = np.asarray(w["starts"])
    frames = torch.as_tensor(np.minimum(starts[:, None] + np.arange(WSIZE),
                                        w["n_frames"] - 1), device=dev)
    init_gap = float(((bp - fused[frames]).abs() * valid[..., None]).max())
    converged_gap = float(cost_gap[both].max()) if bool(both.any()) else 0.0
    res = {"worst_window": wi, "worst_frame": fi, "worst_param": pi,
           "worst_joint_axis": [1 + (pi - 7) // 3, (pi - 7) % 3]
           if pi >= 7 else None,
           "max_param_diff": float(diff.max()),
           "median_window_max_param_diff": float(per_window.median()),
           "windows_differing": int((per_window > 0).sum()),
           "windows_over_1e_3": int((per_window > 1e-3).sum()),
           "params_bitwise_equal": bool(float(diff.max()) == 0.0),
           "converged_in_both": int(both.sum()),
           "max_cost_gap_rel_converged": converged_gap,
           "max_cost_gap_rel_capped": float(cost_gap[~both].max())
           if bool((~both).any()) else 0.0,
           "median_cost_gap_rel": float(cost_gap.median()),
           "windows_cost_gap_over_1e_3": int((cost_gap > 1e-3).sum()),
           "worst_window_cost_gap_rel": float(cost_gap[wi]),
           "worst_window_converged": [bool(st2c.converged[wi]),
                                      bool(st2b.converged[wi])],
           "max_keypoint_motion_px": float(motion.max()),
           "median_keypoint_motion_px": float(motion.median()),
           "worst_window_keypoint_motion_px": float(motion[wi]),
           "stage2_init_max_diff": init_gap}
    checks(converged_gap <= CONVERGED_COST_GAP
           and res["median_cost_gap_rel"] <= MEDIAN_COST_GAP,
           f"long_10k_batch: per-window cost gap, chunked against one "
           f"batch: {converged_gap} over the windows converged in both "
           f"(> {CONVERGED_COST_GAP}?), median {res['median_cost_gap_rel']} "
           f"(> {MEDIAN_COST_GAP}?)")

    # float64 on the card, chunk against one batch on the same inputs
    f64 = torch.float64
    spec64 = make_skeleton_spec(copy.deepcopy(w["model"]).to(f64),
                                init_root_rotation(), with_shape=True)
    cam64 = type(w["cam"])(*(c.to(f64) for c in w["cam"]))
    args64, _, _ = cli_windows(w, st1, dtype=f64)
    c0 = wi // LONG_CHUNK * LONG_CHUNK
    part = slice(c0, min(c0 + LONG_CHUNK, len(starts)))
    m = valid[part]
    plain_cg = cg_ops.arrow_pcg_torch
    systems = []

    def capture(*a, **k):
        systems.append(a)
        return plain_cg(*a, **k)
    for linear, trips in (("tridiag", (S2_ITERS,)), ("pcg", PCG_GAP_TRIPS)):
        for k in trips:
            cfg2 = fit_configs(linear, cg_iters=LONG_CG_ITERS)[1]
            fit2 = build_multi_fitter(spec64, cam64,
                                      cfg2._replace(max_iters=k), 10,
                                      device=dev, dtype=f64)
            first_trip = linear == "pcg" and k == 1
            if first_trip:
                cg_ops.arrow_pcg_torch = capture
            try:
                t0 = time.perf_counter()
                whole = fit2(*args64)
                torch.cuda.synchronize()
                batch_s = time.perf_counter() - t0
                chunk = fit2(*(a[part] for a in args64))
            finally:
                cg_ops.arrow_pcg_torch = plain_cg
            d_param = float(((chunk.params - whole.params[part]).abs()
                             * m[..., None]).max())
            d_cost = float(((chunk.cost - whole.cost[part]).abs()
                            / whole.cost[part]).max())
            res[f"f64_{linear}_{k}_trips"] = {
                "windows": [part.start, part.stop],
                "chunk_vs_batch_param": d_param,
                "chunk_vs_batch_cost_rel": d_cost, "batch_s": batch_s,
                "worst_window_f32_chunked_vs_f64": float(
                    (st2c.params[wi] - chunk.params[wi - c0].float())
                    .abs().mul(valid[wi, :, None]).max())}
            if linear == "tridiag":
                checks(d_param <= EXACT_GAP_PARAM and d_cost <= EXACT_GAP_COST,
                       f"long_10k_batch: f64 tridiag, {k} trips, chunk vs "
                       f"one batch: params {d_param} > {EXACT_GAP_PARAM} or "
                       f"cost {d_cost} > {EXACT_GAP_COST}")
            del whole, chunk

    # the first trip's CG: the batch's and the chunk's systems, then the
    # CG on the chunk's windows of the batch's system, in the batch and
    # alone, by steps; the exact solution of that system beside it
    sys_b, sys_c = systems[0], systems[1]
    alone = [x if x.dim() == 1 else x[part] for x in sys_b]      # tmask: 1-D
    system_gap = max(float((x - y).abs().max() / x.abs().max())
                     for x, y in zip(alone, sys_c))
    exact = arrow_tridiag(*alone, linear="tridiag")[0]
    by_steps = {}
    for n in CG_GAP_STEPS:
        x_alone = plain_cg(*alone, iters=n)[0]
        scale = float(x_alone.abs().max())
        by_steps[n] = {
            "alone_vs_in_batch": float(
                (plain_cg(*sys_b, iters=n)[0][part] - x_alone).abs().max())
            / scale,
            "vs_exact": float((x_alone - exact).abs().max()) / scale}
    shallow = max(v["alone_vs_in_batch"] for n, v in by_steps.items()
                  if n <= CG_SHALLOW_STEPS)
    res["f64_pcg_first_trip_cg"] = {"system_gap_rel": system_gap,
                                    "by_steps_rel": by_steps}
    checks(system_gap <= SYSTEM_GAP and shallow <= SYSTEM_GAP,
           f"long_10k_batch: f64, the first trip's CG: the chunk's and the "
           f"batch's systems {system_gap} apart, the CG on one system in "
           f"the batch and alone {shallow} apart through "
           f"{CG_SHALLOW_STEPS} steps (> {SYSTEM_GAP}?)")
    return res


def long_phases(dev, checks):
    """The long-video configuration (bench.py's BENCH_FRAMES 10 000 and
    100 000, BENCH_CHUNK=67, 64 CG steps):

    ``5 long_10k_chunked``: the multi CLI's sequential route
    (``build_cli_sequential``): stage 1 on the 1000 anchors (K1 at 1 x
    1000), the host interpolation, stage 2 in chunks of 67 windows (K1 at
    67 x 20 and the ragged last chunk); the first stage-1 and stage-2 K1
    systems held against the plain version. ``5 long_10k_batch``: the same
    video through the fused fit, stage 2 as one batch of 667 windows (K1
    at 667 x 20), held within LONG_GAP_MAX_PX of the chunked residual, and
    ``chunk_gap``'s account of where the two differ. ``5 long_100k_stage1``: the
    100 000-frame video's stage 1 alone (10 000 anchors in one window, K1
    at 1 x 10 000), LONG_XL_S1_ITERS trips: the anchors' residual, peak
    memory, its first K1 system against plain, and LONG_PROFILE_TRIPS
    trips under the profiler.
    ``6 render_10k``: ``render_frames`` over the 10 000 chunked-fit frames
    at 1280 x 720, its last chunk checked again by ``render_chunk_check``.
    Returns the result line's rows for these runs: K1's as (name,
    launches, ``k1_compare``'s numbers), and the render's K2 and K3
    launches."""
    import torch
    from smpltpu_torch.solve import MultiFrameConfig, build_multi_fitter
    from torch.autograd import DeviceType
    from smpltpu_torch.bench import full_batch_residual, workload, write_back
    from torch.profiler import ProfilerActivity, profile

    k1_rows = []
    t0 = time.perf_counter()
    w = workload(dev, LONG_FRAMES)
    setup_s = time.perf_counter() - t0
    first = {}
    res, st1c, st2c = long_fit(w, "pcg_kernel", dev, LONG_CHUNK, checks,
                               "long_10k_chunked", first)
    res["setup_s"] = setup_s
    n_a = len(w["anchor_idx"])
    by_shape = {}
    for (n_w, f), (a, k) in sorted(first.items()):
        by_shape[n_w, f] = k1_compare(
            f"long_10k_{n_w}x{f}_first_lm_iter", a, k["iters"], k["rtol"],
            checks, reps=(5, 1), real_system=True, phase_no=5)
    del first
    s1 = by_shape[1, n_a]
    for (n_w, f), c in sorted(by_shape.items()):
        k1_rows.append((f"arrow_pcg_long_10k_chunked_{n_w}x{f}",
                        res["k1_launches_by_shape"][f"arrow_pcg@{n_w}x{f}"], c))
    res["k1_stage1_vs_plain"] = {
        key: s1[key] for key in ("ok", "ms", "plain_ms", "bound_ms",
                                 "kernel_vs_f64_p", "plain_vs_f64_p")}
    phase("5 long_10k_chunked", ok=not any("long_10k_chunked" in f
                                           for f in checks.failed)
          and all(c["ok"] for c in by_shape.values()), **res)
    chunked = res

    first = {}
    res, st1b, st2b = long_fit(w, "pcg_kernel", dev, 0, checks,
                               "long_10k_batch", first)
    n_win = len(w["starts"])
    a, k = first[n_win, WSIZE]
    c = k1_compare(f"long_10k_{n_win}x{WSIZE}_first_lm_iter", a, k["iters"],
                   k["rtol"], checks, reps=(5, 1), real_system=True,
                   phase_no=5)
    k1_rows.append((f"arrow_pcg_long_10k_batch_{n_win}x{WSIZE}",
                    res["k1_launches_by_shape"][f"arrow_pcg@{n_win}x{WSIZE}"],
                    c))
    del first, a
    gap = abs(res["full_batch_residual_px"] - chunked["full_batch_residual_px"])
    checks(gap <= LONG_GAP_MAX_PX,
           f"long_10k_batch: residual {gap} px from the chunked fit's")
    t0 = time.perf_counter()
    diag = chunk_gap(w, st1c, st2c, st2b, dev, checks)
    diag["seconds"] = time.perf_counter() - t0
    ok = not any("long_10k_batch" in f for f in checks.failed) and c["ok"]
    phase("5 long_10k_batch", ok=ok, **res,
          chunked_fit_s=chunked["fit_s"],
          chunked_over_batch=chunked["fit_s"] / res["fit_s"],
          residual_gap_px=gap,
          stage1_bitwise_equal=bool(torch.equal(st1b.params, st1c.params)),
          chunk_gap=diag)
    del st1b, st2b

    # the render of every frame of the chunked fit
    frame_params, shp = write_back(w, st2c)
    del st1c, st2c
    res = render_long(w, frame_params, shp, w["cam"], H_R, W_R, checks,
                      "render_10k")
    render_rows = (("lbs", "lbs_render_10k", res["k2_launches"],
                    res["k2_last_chunk"]),
                   ("raster", "raster_verts_render_10k",
                    res["k3_setup_launches"], res["k3_last_chunk"]))
    phase("6 render_10k", ok=not any("render_10k" in f for f in checks.failed),
          **res)
    del w, frame_params

    # the 100 000-frame video's stage 1 alone
    t0 = time.perf_counter()
    w = workload(dev, LONG_FRAMES_XL)
    setup_s = time.perf_counter() - t0
    args1 = w["args"][:4]
    cfg1 = MultiFrameConfig(beta_pose=5.0, beta_shape=25.0,
                            lambda_temporal=3.0, max_iters=LONG_XL_S1_ITERS,
                            linear="pcg_kernel", cg_iters=LONG_CG_ITERS,
                            fused_cost=True)
    fit1 = build_multi_fitter(w["spec"], w["cam"], cfg1, 10, device=dev,
                              dtype=torch.float32)
    first = {}
    with first_k1_systems(first):
        st1, wall_s, launches, peak = counted_run(lambda: fit1(*args1))
    trips = int(st1.iters_run)
    n_a = len(w["anchor_idx"])
    k1 = {k: v for k, v in launches.items() if k.startswith("arrow_pcg@")}
    checks(k1 == {f"arrow_pcg@1x{n_a}": trips},
           f"long_100k_stage1: K1 launches {k1} != {trips} trips")
    residual = full_batch_residual(w, st1.params, st1.shape,
                                   frames=w["anchor_idx"])
    checks(np.isfinite(residual) and residual <= RESIDUAL_MAX_PX,
           f"long_100k_stage1: anchors' residual {residual} px")
    (a, k), = first.values()
    c = k1_compare(f"long_100k_1x{n_a}_first_lm_iter", a, k["iters"],
                   k["rtol"], checks, reps=(3, 1), real_system=True,
                   phase_no=5)
    k1_rows.append((f"arrow_pcg_long_100k_stage1_1x{n_a}", trips, c))
    del first, a
    # a short window of the same solve under the profiler
    fit_short = build_multi_fitter(
        w["spec"], w["cam"], cfg1._replace(max_iters=LONG_PROFILE_TRIPS), 10,
        device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        short = fit_short(*args1)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    dev_ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_ev) / 1e3
    k1_ms = sum(e.self_device_time_total for e in dev_ev
                if "arrow_pcg_kernel" in e.key) / 1e3
    short_trips = int(short.iters_run)
    host_mb = sum(v.nbytes for v in w.values() if isinstance(v, np.ndarray))
    ok = bool(np.isfinite(residual) and residual <= RESIDUAL_MAX_PX
              and c["ok"])
    phase("5 long_100k_stage1", ok=ok, frames=w["n_frames"], anchors=n_a,
          setup_s=setup_s, workload_host_mb=host_mb / 1e6,
          workload_device_mb=nbytes(*w["args"]) / 1e6,
          fit_s=wall_s, trips=trips, converged=bool(st1.converged),
          cost_at_trip={str(k): float(st1.cost_history[k - 1])
                        for k in (1, 10, 25, 50, 75, 100, 150)
                        if k <= cfg1.max_iters},
          ms_per_trip=wall_s * 1e3 / max(trips, 1),
          k1_launches=launches.get("arrow_pcg", 0),
          anchors_residual_px=residual, peak_gib=peak,
          k1_first_lm_iter={key: c[key] for key in (
              "ok", "plan", "ms", "plain_ms", "bound_ms",
              "kernel_vs_f64_p", "plain_vs_f64_p")},
          profiled_trips=short_trips, profiled_wall_ms=prof_ms,
          device_busy_ms=busy_ms, k1_device_ms=k1_ms,
          k1_share_of_busy=k1_ms / max(busy_ms, 1e-9),
          idle_share=1.0 - busy_ms / prof_ms,
          device_launches=sum(e.count for e in dev_ev),
          device_busy_ms_per_trip=busy_ms / max(short_trips, 1))
    del w, st1, short, fit1, fit_short
    torch.cuda.empty_cache()
    return k1_rows, render_rows


def long_run(dev, checks):
    """``python3 chip_smoke.py --long``: the whole 100 000-frame video
    (``5 long_100k``: the CLI's sequential route, stage 1 on 10 000
    anchors, the host interpolation, 6667 windows in chunks of 67;
    ``5 long_100k_batch``: the fused fit with the 6667 windows as one
    batch, within LONG_GAP_MAX_PX of the chunked residual), its render at
    bench.py's default 270 x 480 (``6 render_100k``),
    and the 10 000-frame chunked fit with ``linear="pcg_block"`` beside
    ``pcg_kernel`` (``5 long_10k_pcg_block``: the pcg_block half of
    ROADMAP's M13 row)."""
    import torch
    from smpltpu_torch.bench import workload, write_back
    from smpltpu_torch.utils import default_intrinsics

    t0 = time.perf_counter()
    w = workload(dev, LONG_FRAMES_XL)
    setup_s = time.perf_counter() - t0
    res, _, st2 = long_fit(w, "pcg_kernel", dev, LONG_CHUNK, checks,
                           "long_100k")
    phase("5 long_100k", ok=not any("long_100k" in f for f in checks.failed),
          setup_s=setup_s, **res)
    chunked = res
    frame_params, shp = write_back(w, st2)
    del st2
    # the same video with stage 2 as one batch of 6667 windows
    res, _, _ = long_fit(w, "pcg_kernel", dev, 0, checks, "long_100k_batch")
    gap = abs(res["full_batch_residual_px"]
              - chunked["full_batch_residual_px"])
    checks(gap <= LONG_GAP_MAX_PX,
           f"long_100k_batch: residual {gap} px from the chunked fit's")
    phase("5 long_100k_batch", ok=not any("long_100k_batch" in f
                                          for f in checks.failed),
          **res, chunked_fit_s=chunked["fit_s"],
          chunked_over_batch=chunked["fit_s"] / res["fit_s"],
          residual_gap_px=gap)
    torch.cuda.empty_cache()
    cam = default_intrinsics(W_LONG, H_LONG, device=dev, dtype=torch.float32)
    res = render_long(w, frame_params, shp, cam, H_LONG, W_LONG, checks,
                      "render_100k")
    phase("6 render_100k", ok=not any("render_100k" in f
                                      for f in checks.failed), **res)
    del w, frame_params
    torch.cuda.empty_cache()

    w = workload(dev, LONG_FRAMES)
    rows = {}
    for linear in ("pcg_block", "pcg_kernel"):
        rows[linear], _, _ = long_fit(w, linear, dev, LONG_CHUNK, checks,
                                      f"long_10k_{linear}")
    gap = (rows["pcg_block"]["full_batch_residual_px"]
           - rows["pcg_kernel"]["full_batch_residual_px"])
    phase("5 long_10k_pcg_block", ok=not any("long_10k_pcg" in f
                                             for f in checks.failed),
          **rows["pcg_block"], pcg_kernel=rows["pcg_kernel"],
          residual_minus_pcg_kernel_px=gap)


def bench_env(extra):
    """This process's environment without bench.py's variables, plus
    ``extra``; the checkout on the path."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(extra)
    return env, here


def bench_run(label, extra, checks):
    """``python -m smpltpu_torch.bench`` with ``extra`` set, in a process of
    its own. Checks: exit code 0; one stdout line with bench.py's four keys
    and a value above 0; each stderr record its modes print, with bench.py's
    keys; the sampled and the full-batch residual <= RESIDUAL_MAX_PX; under
    ``pcg_kernel`` K1's launches equal to the LM trips it printed, by
    system shape (every run, the untimed first ones included); K2 and K3
    once per 100-frame chunk of the render and its first chunk. Returns
    the phase's numbers."""
    env, here = bench_env(extra)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", "smpltpu_torch.bench"],
                              cwd=here, env=env, capture_output=True,
                              text=True, timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        checks(False, f"{label}: no end within {BENCH_TIMEOUT_S} s")
        return {"wall_s": time.perf_counter() - t0}
    res = {"env": extra, "wall_s": time.perf_counter() - t0,
           "rc": proc.returncode}
    err = proc.stderr
    checks(proc.returncode == 0,
           f"{label}: exit code {proc.returncode}: {err[-2000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    ok_line = len(lines) == 1
    if ok_line:
        try:
            rec = json.loads(lines[0])
            ok_line = (set(rec) == BENCH_KEYS and rec["value"] > 0
                       and rec["metric"] == "solver_throughput_frames_per_sec"
                       "_1000frame_video")
            res["stdout"] = rec
        except ValueError:
            ok_line = False
    checks(ok_line, f"{label}: stdout {proc.stdout[-500:]!r}")

    def grab(pattern, cast=float):
        m = re.search(pattern, err, re.M)
        return None if m is None else [cast(g) for g in m.groups()]
    records = {}
    for ln in err.splitlines():
        if ln.startswith('{"metric"'):
            rec = json.loads(ln)
            records[rec["metric"]] = rec
    want = []
    if extra.get("BENCH_FUSE_STAGES", "1") == "1":
        want.append("fused_two_stage_frames_per_sec")
    if extra.get("BENCH_STREAM_PUMP") == "1":
        want.append("stream_pump_latency_ms")
    if extra.get("BENCH_SINGLE") == "1":
        want.append("single_frame_throughput_frames_per_sec")
    for name in want:
        checks(name in records and set(records[name]) == BENCH_RECORDS[name],
               f"{label}: stderr record {name}: {records.get(name)}")
    res["records"] = records
    sampled = grab(r"^bench: residual pixel error ([\d.]+)px")
    full = grab(r"^bench: full-batch residual pixel error ([\d.]+)px")
    for name, px in (("sampled", sampled), ("full-batch", full)):
        checks(px is not None and px[0] <= RESIDUAL_MAX_PX,
               f"{label}: {name} residual {px} px")
    res["residual_px"], res["full_batch_residual_px"] = (
        sampled and sampled[0], full and full[0])
    launches = grab(r"^bench: kernel launches (\{.*\})$", json.loads)
    trips = grab(r"^bench: LM trips by system shape (\{.*\})$", json.loads)
    launches, trips = (launches or [{}])[0], (trips or [{}])[0]
    res["launches"], res["lm_trips"] = launches, trips
    if extra.get("BENCH_LINEAR") == "pcg_kernel":
        by_shape = {k[len("arrow_pcg@"):]: v for k, v in launches.items()
                    if k.startswith("arrow_pcg@")}
        checks(launches.get("arrow_pcg", 0) > 0
               and launches.get("arrow_pcg") == sum(trips.values())
               and by_shape == trips,
               f"{label}: K1 launches {launches} against the LM trips {trips}")
    if extra.get("BENCH_RENDER") == "1":
        n_frames = int(extra.get("BENCH_FRAMES", "1000"))
        chunks = 1 + -(-n_frames // 100)
        got = [launches.get(k, 0) for k in ("lbs", "raster", "raster_setup")]
        checks(got == [chunks] * 3,
               f"{label}: K2, K3, K3 setup launches {got} != {chunks}")
        res["render"] = grab(r"^bench: render (\d+) frames at (\d+)x(\d+) in "
                             r"(\d+) ms")
    res["roofline"] = re.findall(r"^bench: (roofline\[.*)$", err, re.M)
    res["stage_ms"] = grab(r"^bench: stage-1 (\d+) ms \+ stage-2 (\d+) ms")
    res["fused_ms"] = grab(r"^bench: fused two-stage pipeline (\d+) ms")
    res["peak_gib"] = grab(r"^bench: device memory peak ([\d.]+) GiB")
    for mode in ("stream", "stream-pump"):
        res[mode] = grab(rf"^bench: {mode} (\d+) frames: latency mean "
                         r"([\d.]+) ms, p50 ([\d.]+) ms, p95 ([\d.]+) ms")
    res["stream_scan"] = grab(r"^bench: stream-scan (\d+) frames in (\d+) ms")
    res["single"] = grab(r"^bench: single-frame (\d+) frames in (\d+) ms")
    if extra.get("BENCH_SINGLE_GMM") == "1":
        gate = grab(r"^bench: GMM quality gate: gmm ([\d.]+)px vs no-gmm "
                    r"([\d.]+)px .*\(gap ([+-][\d.]+)px")
        checks(gate is not None, f"{label}: no GMM quality-gate line")
        res["gmm_gate_px"] = gate
    return res


def bench_phase(checks):
    """Phase 13: bench.py's twin run as ``BENCH_RUNS`` set it, each in a
    process of its own (``bench_run``)."""
    t0 = time.perf_counter()
    for label, extra in BENCH_RUNS:
        res = bench_run(label, extra, checks)
        phase(f"13 {label}", ok=not any(f.startswith(label)
                                        for f in checks.failed), **res)
    phase("13 bench", phase_s=time.perf_counter() - t0)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import smpltpu_torch
    from smpltpu_torch import _build
    from smpltpu_torch.ops import LAUNCHES, cg
    from smpltpu_torch.bench import full_batch_residual, workload, write_back
    from smpltpu_torch.solve import multi_frame
    from smpltpu_torch.pipeline.common import (
        batched_frame_eval,
        overlay_image,
    )

    checks = Checks()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    tf32_off = (not torch.backends.cuda.matmul.allow_tf32
                and not torch.backends.cudnn.allow_tf32)
    checks(tf32_off, "TF32 is on")
    phase("1 device", name=kind, count=torch.cuda.device_count(),
          nvidia_smi=smi_line, torch=torch.__version__,
          cuda=torch.version.cuda, port=smpltpu_torch.__version__,
          tf32_off=tf32_off)

    # 2. build
    _build.load()
    info = _build.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    phase("2 build", built=info["built"], seconds=info["seconds"],
          ptxas=ptxas)

    rng = np.random.default_rng(1)
    if argv == ["--k2"]:
        k2_phase(rng, dev, checks, K2_CASES[:1])
        return 1 if checks.failed else 0

    if argv == ["--bench-default"]:
        res = bench_run("bench_default", {}, checks)
        phase("13 bench_default", ok=not checks.failed, **res)
        return finish(checks, kind)
    # 3. K1 vs plain on random systems, then the layouts
    phase("3 k1_limits", **cg.device_limits(dev))
    if argv == ["--k1-layouts"]:
        k1_layouts(rng, dev, checks, every=True)
        return 1 if checks.failed else 0
    if argv == ["--long"]:
        long_run(dev, checks)
        return finish(checks, kind)
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}")
    for label, n_w, f, p, n_s, rtol, cluster in K1_SWEEP:
        sys_args = random_arrow_system(rng, n_w, f, dev, p=p, n_s=n_s,
                                       scale=3.0 if rtol else 1.0)
        k1_compare(label, sys_args, CG_ITERS, rtol, checks, reps=(5, 1),
                   cluster=cluster)
        del sys_args
    k1_layouts(rng, dev, checks)
    k1_long_phase(rng, dev, checks)

    # 4. K2 vs plain: the full-width model at 100 (timed), 1 and 37 frames,
    # the 300-vertex model, and 7 shapes (the run-time-width instantiation)
    k2 = k2_phase(rng, dev, checks, K2_CASES)

    # 5. main path
    t0 = time.perf_counter()
    w = workload(dev, N_FRAMES)
    phase("5 workload", frames=N_FRAMES, windows=len(w["starts"]),
          anchors=len(w["anchor_idx"]), verts=w["model"].num_verts,
          faces=w["model"].num_faces, setup_s=time.perf_counter() - t0)
    run = build_fit(w, "pcg_kernel", dev)

    # warm-up run; it also captures each stage's first K1 system
    first = {}
    real_asm = multi_frame.corrected_frame_assembly
    first_asm = {}

    def capture_asm(*a, **k):
        first_asm.setdefault(tuple(a[0].shape[:2]),
                             [t.clone() if torch.is_tensor(t) else t for t in a])
        return real_asm(*a, **k)
    multi_frame.corrected_frame_assembly = capture_asm
    try:
        with first_k1_systems(first):
            run(*w["args"])
    finally:
        multi_frame.corrected_frame_assembly = real_asm
    torch.cuda.synchronize()
    phase("5 warmup", seconds=run.timings)
    k1_main = {}
    for shape, (a, k) in sorted(first.items()):
        label = "stage1_first_lm_iter" if shape[0] == 1 else "stage2_first_lm_iter"
        k1_main[label] = k1_compare(label, a, k["iters"], k["rtol"], checks,
                                    real_system=True, phase_no=5)
    checks(len(k1_main) == 2, f"captured K1 systems of {sorted(first)}")
    # 7. the exact solve on the same systems
    exact = tridiag_phase(first, k1_main, checks)
    del first
    exact_long_phase(dev, checks)

    # the timed run, with the launch counts of the main path
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st1, st2 = run(*w["args"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    frame_params, shp = write_back(w, st2)
    n = w["n_frames"]
    t0 = time.perf_counter()
    err, verts = batched_frame_eval(
        w["model"], frame_params, shp.expand(n, -1),
        torch.as_tensor(np.tile(w["r0c"], (n, 1, 1)), device=dev), w["kp"],
        w["cam"])
    eval_s = time.perf_counter() - t0
    k1_launches, k2_launches = LAUNCHES["arrow_pcg"], LAUNCHES["lbs"]
    k1_stage = {"stage1": LAUNCHES[f"arrow_pcg@1x{len(w['anchor_idx'])}"],
                "stage2": LAUNCHES[f"arrow_pcg@{len(w['starts'])}x{WSIZE}"]}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    trips1, trips2 = int(st1.iters_run), int(st2.iters_run.max())
    checks(k1_launches == trips1 + trips2,
           f"K1 launches {k1_launches} != loop trips {trips1} + {trips2}")
    checks(k1_stage["stage1"] == trips1 and k1_stage["stage2"] == trips2,
           f"K1 launches by stage {k1_stage} != trips {trips1}, {trips2}")
    s1_plan = k1_main["stage1_first_lm_iter"]["plan"]
    checks(s1_plan["cluster"] > 1,
           f"stage 1's K1 plan runs on one SM: {s1_plan}")
    checks(k2_launches > 0, "K2 was not launched on the main path")
    residual = full_batch_residual(w, frame_params, shp)
    checks(np.isfinite(residual) and residual <= RESIDUAL_MAX_PX,
           f"full-batch residual {residual} px")
    checks(verts.shape == (n, w["model"].num_verts, 3)
           and bool(np.all(np.isfinite(verts))), "skinned vertices")
    checks(bool(np.all(np.isfinite(err))), "frame evaluation errors")
    phase("5 main_path", linear="pcg_kernel", fit_s=fit_s,
          stage1_ms=run.timings["stage1_s"] * 1e3,
          stage2_ms=run.timings["stage2_s"] * 1e3,
          frames_per_s=n / fit_s, stage1_iters_run=trips1,
          stage2_iters_run_max=trips2,
          stage2_iters_run_mean=float(st2.iters_run.float().mean()),
          stage2_converged=int(st2.converged.sum()),
          k1_launches=k1_launches, k1_launches_by_stage=k1_stage,
          k2_launches=k2_launches, full_batch_residual_px=residual,
          eval_mean_px=float(np.mean(err)), eval_s=eval_s,
          peak_gib=peak_gib)

    covered = []
    for k in (0, n // 2):
        img = np.zeros((1280, 720, 3), np.uint8)
        overlay_image(w["model"], verts[k], img, w["cam"])
        covered.append(int(np.count_nonzero(img.any(axis=-1))))
    checks(all(c > 0 for c in covered), f"rendered coverage {covered}")
    phase("5 render", frames=[0, n // 2], covered_px=covered)

    # the same fit with the plain PCG loop
    run_plain = build_fit(w, "pcg", dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st2p = run_plain(*w["args"])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    residual_plain = full_batch_residual(w, *write_back(w, st2p))
    gap = abs(residual - residual_plain)
    checks(gap <= PLAIN_GAP_MAX_PX,
           f"kernel vs plain-PCG residual gap {gap} px")
    phase("5 plain_pcg_fit", fit_s=plain_s,
          stage1_ms=run_plain.timings["stage1_s"] * 1e3,
          stage2_ms=run_plain.timings["stage2_s"] * 1e3,
          frames_per_s=n / plain_s, full_batch_residual_px=residual_plain,
          gap_px=gap)
    del run_plain, st2p

    # the same fit with the exact solve (linear="tridiag", the library's
    # and the CLI's default), once
    run_tri = build_fit(w, "tridiag", dev)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st1t, st2t = run_tri(*w["args"])
    torch.cuda.synchronize()
    tri_s = time.perf_counter() - t0
    residual_tri = full_batch_residual(w, *write_back(w, st2t))
    tri_trips = int(st1t.iters_run) + int(st2t.iters_run.max())
    checks(np.isfinite(residual_tri) and residual_tri < RESIDUAL_MAX_PX,
           f"tridiag fit: full-batch residual {residual_tri} px")
    checks(LAUNCHES["arrow_pcg"] == 0, "the tridiag fit launched K1")
    phase("5 main_path_tridiag", linear="tridiag", fit_s=tri_s,
          stage1_ms=run_tri.timings["stage1_s"] * 1e3,
          stage2_ms=run_tri.timings["stage2_s"] * 1e3,
          frames_per_s=n / tri_s, stage1_iters_run=int(st1t.iters_run),
          stage2_iters_run_max=int(st2t.iters_run.max()),
          stage2_converged=int(st2t.converged.sum()),
          full_batch_residual_px=residual_tri,
          pcg_kernel_fit_s=fit_s, pcg_kernel_residual_px=residual,
          slower_than_pcg_kernel=tri_s / fit_s,
          solve_device_launches_per_lm_trip={
              k[len("tridiag_"):]: v["device_launches_per_solve"]
              for k, v in exact.items() if k.startswith("tridiag_")},
          lm_trips=tri_trips)
    del run_tri, st2t

    # the same fit with the other exact solve, cyclic reduction, once
    run_cr = build_fit(w, "cr", dev)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st1c, st2c = run_cr(*w["args"])
    torch.cuda.synchronize()
    cr_s = time.perf_counter() - t0
    residual_cr = full_batch_residual(w, *write_back(w, st2c))
    cr_gap = abs(residual_cr - residual_tri)
    ok = bool(np.isfinite(residual_cr) and residual_cr < RESIDUAL_MAX_PX
              and cr_gap <= CR_TRIDIAG_GAP_MAX_PX
              and LAUNCHES["arrow_pcg"] == 0)
    checks(ok, f"cr fit: full-batch residual {residual_cr} px, "
               f"{cr_gap} px from tridiag's (max {CR_TRIDIAG_GAP_MAX_PX}), "
               f"K1 launches {LAUNCHES['arrow_pcg']}")
    phase("5 main_path_cr", ok=ok, linear="cr", fit_s=cr_s,
          stage1_ms=run_cr.timings["stage1_s"] * 1e3,
          stage2_ms=run_cr.timings["stage2_s"] * 1e3,
          frames_per_s=n / cr_s, stage1_iters_run=int(st1c.iters_run),
          stage2_iters_run_max=int(st2c.iters_run.max()),
          stage2_converged=int(st2c.converged.sum()),
          full_batch_residual_px=residual_cr, tridiag_residual_px=residual_tri,
          gap_to_tridiag_px=cr_gap, tridiag_fit_s=tri_s,
          faster_than_tridiag=tri_s / cr_s, pcg_kernel_fit_s=fit_s,
          stage1_cost=float(st1c.cost), tridiag_stage1_cost=float(st1t.cost),
          solve_device_launches_per_lm_trip={
              k[len("cr_"):]: v["device_launches_per_solve"]
              for k, v in exact.items() if k.startswith("cr_")},
          lm_trips=int(st1c.iters_run) + int(st2c.iters_run.max()))
    del run_cr, st1c, st2c
    jvp_phase(w, first_asm.get((len(w["starts"]), WSIZE)), dev, checks)
    del first_asm

    k3, k3_launches, k3_setup_launches = render_phase(
        w, frame_params, shp, verts, fit_s, checks)
    # 9. the single-frame path
    single_ref = single_phases(w, dev, checks)
    # 10. the streaming path, from stage 1's shape
    stream_phases(w, st1.shape, dev, checks)
    # 8. the port's CLIs, K1, K2 and K3 through their product entry points;
    # the library's fit_video
    cli_phases(checks)
    api_phase(w, dev, checks)
    # 11. the multi-device path on one rank over NCCL
    mesh_phases(w, st1, st1t, st2, single_ref, dev, checks)
    # 12. the host runtime: the native parser and fill
    host_native_phase(w, verts, checks)
    # the long-video configuration: 10 000 and 100 000 frames
    long_k1, long_render = long_phases(dev, checks)
    # 13. bench.py's twin, as a user runs it
    torch.cuda.empty_cache()
    bench_phase(checks)
    fit_profile(w, dev, checks)

    if not_ok(checks):
        return 1
    # K1 at each stage's shape, on that stage's first real system; its
    # launches are the main path's count at that shape
    k1_lines = [
        {"name": f"arrow_pcg_{stage}", "route": "cuda",
         "source": "smpltpu_torch/csrc/arrow_pcg.cu",
         "replaces": "smpltpu/ops/cg.py:146", "launches": k1_stage[stage],
         "max_abs_err": max(c["max_abs_err_p"], c["max_abs_err_w"]),
         "ms": c["ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
         "library_ms": None}
        for stage, c in (("stage1", k1_main["stage1_first_lm_iter"]),
                         ("stage2", k1_main["stage2_first_lm_iter"]))] + [
        # the long-video runs: K1 at their shapes, on each shape's first
        # real system; their launches are that run's count at the shape
        {"name": name, "route": "cuda",
         "source": "smpltpu_torch/csrc/arrow_pcg.cu",
         "replaces": "smpltpu/ops/cg.py:146", "launches": launches,
         "max_abs_err": max(c["max_abs_err_p"], c["max_abs_err_w"]),
         "ms": c["ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
         "library_ms": None}
        for name, launches, c in long_k1]
    print(json.dumps({"kernels": k1_lines + [
        {"name": "lbs", "route": "cuda", "source": "smpltpu_torch/csrc/lbs.cu",
         "replaces": "smpltpu/ops/lbs.py:88", "launches": k2_launches,
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
    ] + [
        # K3 by entry point: binning and tiles from a face setup, and the
        # same behind the setup stage, from the vertices
        {"name": name, "route": "cuda",
         "source": "smpltpu_torch/csrc/raster.cu",
         "replaces": "smpltpu/render/pallas_raster.py:425",
         "launches": launches, "max_abs_err": 0, "ms": k3[name]["ms"],
         "plain_ms": k3[name]["plain_ms"], "bound_ms": k3[name]["bound_ms"],
         "bound_by": k3[name]["bound_by"], "library_ms": None}
        for name, launches in (("raster", k3_launches),
                               ("raster_verts", k3_setup_launches))
    ] + [
        # render_10k: K2 and K3 on the render's last 100-frame chunk, their
        # launches the render's
        {"name": name, "route": "cuda",
         "source": f"smpltpu_torch/csrc/{src}.cu",
         "replaces": {"lbs": "smpltpu/ops/lbs.py:88",
                      "raster": "smpltpu/render/pallas_raster.py:425"}[src],
         "launches": launches, "max_abs_err": row["max_abs_err"],
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": None}
        for src, name, launches, row in long_render
    ]}), flush=True)
    return finish(checks, kind)


def not_ok(checks):
    """True, after saying so, if a check failed or JAX or the JAX package
    was imported."""
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "smpltpu"))
    checks(not foreign, f"JAX or the JAX package was imported: {foreign}")
    if checks.failed:
        print(f"chip_smoke: {len(checks.failed)} check(s) failed: "
              f"{checks.failed}", flush=True)
    return bool(checks.failed)


def finish(checks, kind):
    """The result line, and exit code 0, if every check passed; else 1."""
    import torch
    if not_ok(checks):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    sys.exit(main(sys.argv[1:]))
