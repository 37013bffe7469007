#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (scythe_tpu_torch) on one NVIDIA
Hopper GPU.

    python3 chip_smoke.py [--only GROUPS]   # from the root of a checkout; one card

Phases, each printing PASS, its wall time and its numbers on a line:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the TF32 switches (both off, float32 matmul precision
   "highest");
2. build: the CUDA kernels from scythe_tpu_torch/ops/csrc with nvcc (one
   nvcc a source, all started together), with ptxas' registers, shared
   memory and spills for each kernel;
3. column solve against its plain PyTorch version on the card: nz in
   {13, 24, 40, 48, 100, 128} x ncols in {37, 1200, 9216} x both stages,
   then the variable-coefficient operator (the moist3d sounding's Pxi_prof)
   at 9216 x 48, the shower's scalar and profile operators at 2304 x 32 and
   a moist3d shard's 2304 x 48 (phase 31),
   the stage's operator applied as the main path applies it
   (apply_column_operator) and the TPU function's counterpart
   (fused_column_solve, composed per call, mode="plain"): f64 kernel vs f64
   plain chain
   (1e-12 of max|ref|), f32 kernel vs f64 plain (1e-5, and at most 4x the
   f32 plain chain's own error), two calls bitwise equal in each dtype, the
   library call's error printed beside the kernel's, the plan printed per
   shape; then timed at 9216 x 48 and 1200 x 24 f32 and 9216 x 48 f64 in
   turns (plain, kernel, kernel, plain, library), each as device time and
   back to back, beside its bound and each one's error, and the profile
   operator, both shower operators, JW06's (13,824 x 24) and the shard's
   (2304 x 48) the same way;
   the library call is one
   torch.matmul of [x* | w*] by M^T, which the port never calls;
4. RLZ analysis against its plain version on the card: moist3d
   [9, 144, 64, 48], the TC grid [9, 300, 4, 24], the RLZ transform bench
   [8, 192, 128, 60], the two shapes of tests/test_pallas_transforms.py, one
   large-nl shape [2, 24, 1024, 16] (l streamed through shared memory) and a
   ragged one [3, 21, 12, 13] (nz 13: x copied element by element), and on
   their own geometries the XYZ shower [9, 144, 16, 32], the SLZ test grid
   [9, 36, 32, 24] and the JW06 grids [9, 72, 96, 24] and, at the production
   recipe, [9, 144, 96, 24] (both timed too); f64
   kernel vs f64 plain (1e-12 of max|ref|), f32 kernel vs f64 plain (1e-5,
   and at most 4x the f32 plain chain's own error), two calls bitwise equal
   in each dtype, the plan and its block count printed; then the f32 kernel
   and plain chain timed at the moist3d, transform and TC shapes, and f64 at
   moist3d, in turns, each as device time (the calls queued behind a sleep
   kernel, so host time between launches does not count) and back to back,
   beside the library call (one torch.einsum over the whole chain, TF32 off;
   the port never calls it);
5. tendency-stage probe (Triton) against its plain version at
   [9, 144, 3072] f32 (rel err 1e-5 of max|ref|), timed in turns, then its
   entry point (python -m scythe_tpu_torch.ops.elementwise_probe) run once;
6. moist3d main path at full width: integrate_model (MoistEulerRLZ,
   semi-implicit, 48 cells x 64 azimuths x 48 levels, 9 vars, ts 0.15 s) on
   "cuda" in f32, 120 steps with output every 60; the column solve ran once
   a step and the analysis once a step plus the initial analysis, the
   condensation kernel once a step and its plain chain never, fields
   finite, the bubble rises (w.max() > 0.01), three CSV outputs; steps/s on
   the card after a warm-up and a torch.profiler pass (table in
   chiprun_out/moist3d_profile.txt);
7. the mature-TC path at full width: integrate_model on tc_mature_model
   (models/tc_mature_rlz.py: 100 cells x 4 azimuths x 24 levels, 9 vars, ts
   2 s, Smagorinsky + implicit vertical diffusion, surface fluxes, sponge)
   in f32 on "cuda", 900 steps (30 simulated minutes) with output every 450;
   the column solve ran once a step, the analysis once a step plus once,
   the condensation kernel once a step and its plain chain never,
   fields finite, condensation fired (q_c max > 1e-6: PERF.md sets this band
   from a CPU f64 run of the same 900 steps), the vortex intact
   (12 < v.max() < 20 m/s), three CSV outputs; steps/s after a warm-up and a
   profiler pass (chiprun_out/tc_mature_profile.txt);
8. port parity on the card: the small moist configuration 20 steps and the
   TC bundle at 16 cells 50 steps, CUDA f64 (kernels) against CPU f64
   (plain), 1e-9 of each field's max|ref|; moist3d and the full-width TC 20
   steps CUDA f32 against CUDA f64, 1e-4 of each field's max|f64| (the TC's
   u, which starts at zero, has the bound PERF.md derives from the same
   comparison on the CPU).

9. the flagship path at full width: the Cha & Bell two-layer workflow of
   scythe_tpu_torch/examples/cha_bell_initialization.py (RL grid, 100 cells x
   256 azimuths, rDim 300, b_rDim 103, 6 vars, ts 3 s) in f32 on "cuda"
   through integrate_model and the IC files: write_rankine_ics, the one-way
   spinup for 10 simulated minutes (200 steps), add_wave2 on its last output,
   then Twoway_ShallowWater_Slab for 20 simulated minutes (400 steps), three
   CSV outputs; all fields finite, vg.max and the wavenumber-2 amplitude of
   vg at r = 50 km inside bands PERF.md sets from a CPU f64 run of the same
   600 steps (tools/torch_flagship_reference.py), no odd wavenumber there,
   wavenumber 2 the largest at r = 45 km, wb not identically zero (the
   override reached the output); no hand-written kernel lies on this path,
   and the counts say so;
10. flagship steps/s: 200 two-way steps after 10 warm-up, by CUDA events and
   by the host clock; torch.profiler over 10 steps: device busy and launches
   a step and the share of device time in the einsum GEMMs against the
   elementwise kernels (table in chiprun_out/flagship_profile.txt);
11. the golden trajectory on the card: flagship_model(32, 32), 50 f64 steps
   from vortex_state on "cuda" against
   tests/golden/twoway_slab_50steps_f64.npz and against the same run on the
   CPU, 1e-9 of each field's max;
12. flagship f32 against f64 on the card at full width, 50 steps from the
   wave-2 ICs, per field (bounds in FLAGSHIP_F32_BOUND, from PERF.md);
13. the height-resolved boundary layer (Oneway_ShallowWater_HeightResolvedBL,
   an RLZ set: 16 cells x 16 azimuths x 12 levels, ts 0.2 s, the
   configuration of tests/test_rlz_tcbl.py), 100 f64 steps on "cuda" against
   the CPU at 1e-9, its closing analysis the CUDA kernel (101 launches) and
   no column solve;
14-15. the convective shower at full width (scythe_tpu_torch/examples/
   convective_shower_xyz.py: MoistEulerXYZ, 48 cells x 16 x 32, 9 vars, ts
   0.25 s) in f32 on "cuda" through integrate_model, 240 steps (60 s), once
   with the example's options and once under profile='moist_production':
   240 column-solve and 241 analysis launches each, fields finite, w.max and
   q_c max inside bands PERF.md sets from a CPU f64 run of the same steps
   (tools/torch_shower_reference.py), seven outputs; steps/s by CUDA events,
   device busy and launches a step from torch.profiler
   (chiprun_out/shower{,_production}_profile.txt);
16. parity of the new geometries: XYZ at tests/test_xyz.py's size and SLZ
   at tests/test_slz.py's, 20 f64 steps on "cuda" against the CPU at 1e-9;
   the shower 20 steps f32 against f64 on the card at 1e-4 of each field;
17. the SLZ rest state (tests/test_slz.py's grid), 200 f64 steps on "cuda":
   w and u below 1e-10, 200 column-solve and 201 analysis launches;
18. Williamson case 2 on the SL sphere (models/williamson2_sphere.py's
   configuration: 32 cells x 96, ts 300 s) for a day in f64 on "cuda": l2(h)
   against the analytic state below 5e-4; no hand-written kernel lies on
   this RL-structured path, and the counts say 0.

19-21. JW06 at its production recipe (scythe_tpu_torch/examples/
   jw06_baroclinic_slz.py production_model: MoistEulerSLZ, 48 cells x 96 x
   24, ts 7.5 s, l_q 0, a 12 km top sponge, del^4, horizontal Smagorinsky,
   incremental analysis): balance_zonal_state on the card in f64 against
   the CPU's at 12 cells x 20 levels (1e-9; the CPU's from the child process
   below), then at full width on the card (timed, with phase 33's two CLI
   processes beside it when both groups run; the residual falls below 0.02
   of its first value), 480 f32 steps
   from the balanced state with the wind bump: the column solve once a step
   at 13,824 x 24, the analysis twice (the del^4 refit and the closing
   analysis) at [9, 144, 96, 24], steps/s, launches a step, the example's
   diagnostics inside bands around a CPU f64 run of the same steps
   (tools/torch_jw06_reference.py); f32 against f64 on the card after 20
   steps;
22-23. ensembles through torch.func.vmap: the flagship at full width, 16
   members scaled 1 + i/100 (bench.py's ensemble_bench), member-steps/s
   beside one member's steps/s by the slope of 20 and 120 steps, kernel
   launches a step of each, f64 members against their single runs (1e-12);
   the convective shower, 4 members through integrate_ensemble, 20 steps:
   one column-solve launch a step at 9,216 x 32, one analysis at
   [36, 144, 16, 32] and one condensation kernel (its vmap rule; its plain
   chain never), members against their single runs (f64 1e-12, f32
   SHOWER_MEMBER_F32_BOUND);
24. each kernel's backward and jvp at 9216 x 48 and 13,824 x 24 (column
   solve) and [9, 144, 64, 48] and [9, 144, 96, 24] (analysis) against
   torch.autograd and torch.func.jvp of its plain version (f64 1e-12, f32
   1e-5 and <= 4x the plain f32's error), timed in turns beside the plain
   version, the library call (the column solve's backward: one matmul by M;
   its jvp: one matmul of the stacked primal and tangent by M^T; the
   analysis backward: one torch.einsum over the transposed chain; its jvp:
   one torch.einsum with primal and tangent stacked on the variable axis)
   and the bound;
25-26. make_simulator on the SLZ test grid, 20 semi-implicit f64 steps with
   rain seeded everywhere: the gradient of a weighted sum of the final
   fields with respect to phys0 and K on the card against the CPU (1e-9) and
   K's against a central difference, with the launches of the forward, the
   backward (M^T) and the analysis counted, and the condensation kernel's
   (where the column solve's forward runs) and its plain chain's (once a
   step, in the backward); fit_parameters on
   calibrate_drag's case for 3 Adam iterations on the card against the CPU
   (1e-9), the loss falling.
27. the compensated (bf16x3) kernels, the TPU kernels' own arithmetic: the
   column solve in mode="comp" (the bf16 split of the composed M and of the
   activations; a body of its own on the bf16 tensor cores, its plan and
   ptxas' registers and spills printed) at nz {13, 24, 48, 128} x ncols
   {37, 9216} and at 9216 x 48,
   1200 x 24, 2304 x 32 and 13,824 x 24, both stages, against its plain
   version (the torch bf16x3 map) on the same inputs (4e-6 of max) and the
   f64 chain (0.75x to 4x the plain version's error, and 1e-4; bitwise
   repeatable), with the counterpart
   fused_column_solve at its default mode; timed at the four shapes beside
   its plain version and torch.matmul in true f32 (no single PyTorch call
   computes bf16x3 with an f32 output); the analysis in mode="comp" on
   compensated grids at the moist3d, TC, transform, shower, SLZ test and
   JW06 production shapes, the same checks (1e-5 of max against its plain
   version) and timing, beside the library call (one torch.einsum over the
   chain on the unsplit operators O_hi + O_lo in true f32);
28. moist3d at full width on compensated grids (create_grid's
   matmul="compensated" under integrate_model, deriv_single auto: on, the
   JAX package's TPU production numerics), 120 steps: 121 comp analysis launches, none of the plain
   mode, 120 column solves; steps/s, device busy and launches a step in turns
   with the plain f32 run (chiprun_out/moist3d_{comp,plain}_profile.txt);
   20 steps compensated f32 against plain f64 (bounds in COMP_M3D_BOUND,
   from the CPU); then fused_column_solve at its default (comp) on the run's
   final xi and w columns, both stages: 2 comp launches, against its plain
   version on the same composed M (4e-6) and the plain-mode kernel (1e-4);
   and semiimplicit_adjustment on build_semiimplicit_ops(..., use_pallas=True)
   (the JAX option's counterpart) on the same columns at t = 1 and 3: 2 comp
   launches, against the same corrector on the CPU (its plain version, 4e-6);
29. the flagship workflow at full width on compensated grids with the fast
   derivative slots (tools/validate_fastderiv.py's configuration): inside
   phase 9's bands, no kernel launched;
30. the factored DFT: tools/profile_factored.py's RL grid (64 cells, 6
   vars) at nl 4096 (auto: factored) round trip f64 on the card against the
   CPU (1e-12), nl 2048 l_factored=True against dense (1e-12), dense against
   factored device time at nl 1024, 2048 and 4096; MoistEulerXYZ on the XYZ
   box at lDim 4096 (factored) 10 f64 steps with 0 analysis launches (the
   factored grid takes the einsum chain by design) against the CPU (1e-9).

31. radial domain decomposition (scythe_tpu_torch.parallel) on the one
   card: moist3d at full width on 4 thread-shards of 12 cells (a ThreadMesh
   on cuda:0), 20 f64 steps by psum, halo (gather) and halo-pcr against
   one device (1e-12 of each field's max), 20 f32 steps by psum against
   one device in f32 (SHARDED_F32_BOUND, from the CPU), each with 4 x 20
   column-solve launches (2,304 x 48 columns a shard), one analysis-kernel
   launch (set-up) and no call of a kernel's plain version; the flagship
   on 4 psum shards of 25 cells, 50 f64 steps (1e-12, wb
   SHARDED_FLAGSHIP_BOUND); integrate_sharded on
   4 halo shards, 10 steps with a checkpoint, resumed for 10 more, against
   20 continuous steps on one device (1e-13); a DistMesh over a world of
   one NCCL rank (FileStore), 10 psum steps (1e-12); the flagship's 16
   members over an ensemble mesh of 4 against the unsharded ensemble
   (1e-13); steps/s and launches a step of one device and of 4 psum and 4
   halo shards, in turns (the cost of 4 shards on one card, not scaling);
   sharded-grad: the gradient of 0.5 ||spec||^2 after 10 moist3d f64 steps
   at full width, each under torch.utils.checkpoint, with respect to the
   initial spectral state (cloud and rain seeded), on one device, on 4
   thread-shards by psum and by halo, and on a DistMesh over a world of one
   NCCL rank (all_reduce, reduce_scatter in the backward): the sharded
   gradients equal one device's at 1e-12 of its max, the column solve
   launches 30 times (10 forward, 10 in the recompute, 10 on M^T) on one
   device and on the NCCL rank and 4 x 30 on the thread-shards, the
   condensation kernel where the column solve's forward runs and its plain
   chain once a step in the backward, no plain version is called, and the gradient's and the forward's seconds a step;
   then the flagship's 4D-Var gradient (graft_entry.fourdvar_cost, two
   steps at 100 cells x 256) on the NCCL rank against one device (1e-12).

32. the published benchmarks of scythe_tpu_torch/examples at their
   published sizes, in f32 on the card through the examples' functions:
   the column solve at their shapes (75 x 40, 192 x 64, 384 x 48, 450 x 24
   and the BF02 gate's 96 x 40; both stages against the f64 chain; timed at
   the four and at 192 x 64 in f64 beside its plain version and the library
   call); the warm bubble (3,000 steps; its centroid band), Straka (128 x
   48, 7,200 steps; tests/test_straka.py's bands), the SK94 wave (150 x 24,
   4,000 steps; tests/test_inertia_gravity_wave.py's), BF02 at the JAX
   test's 32 x 40 (4,000 steps; tests/test_bf02_published.py's) and at the
   published 64 x 64 (10,000 steps; printed beside the published 14.3
   m/s, held to BF02_PUBLISHED_W_BAND), each with exactly one column-solve
   launch a step, no call of a kernel's plain version and its steps/s (the
   SK94 gate in f64: PUBLISHED_F64);
33. the CLI and the harness entry: python -m scythe_tpu_torch on
   scythe_tpu_torch/models/linear_advection_1d.py in f64 as two
   subprocesses at -d 1 and -d 4 (agree at 1e-12; started before phase 19
   when the jw06 group runs too, so they run beside its balances); the
   moist RLZ demo config
   (models/moist_euler_rlz_demo.py, 16 cells x 32 x 40, 2,400 steps) in f32
   through cli.main with 2,400 column-solve and 2,401 analysis launches
   and no plain-version call; graft_entry.entry() one step and
   graft_entry.dryrun_multichip(4) on the card (36 column-solve and 9
   analysis launches), then both kernels at every shape that run gave
   them, on its own models (graft_entry.dryrun_models): the column solve at
   a shard's 48 x 12 (RLZ), 96 x 8 (SLZ) and 48 x 10 (XYZ), both stages, f64
   and f32, as phase 3, and the analysis of each whole grid, as phase 4;
34. the last phase, of the examples group: Galewsky in f64 at 128 x 512
   for whole days, at least one and each further day that ends before
   GALEWSKY_DEADLINE_S seconds of the script, each day's zonal-deviation
   energy and u_max against the same run on the CPU (GALEWSKY_RTOL) and
   beside the JAX example's table.

35. make_scan's captured steady step (the graphs group, run after the
   kernels): for the flagship, moist3d in f32 and f64, the mature TC, the
   shower with both option sets, JW06 production (unbalanced), compensated
   moist3d and the flagship's 16 members (model.batched_step), at full
   width: two start-up steps, then GRAPH_STEPS steps from that state by the
   eager loop (disable_graphs) and by the graph, twice (the interval that
   captures, its warm-up the first steady step, and one of replays only):
   each state slot equal (f64 within 1e-13 of its max, f32 within
   GRAPH_F32_BOUND; bitwise printed), the kernels' counted launches equal on
   both paths and one a step (JW06's analysis two), no plain-version call,
   one capture, the replays counted, a state kept from the first interval
   unchanged by the next; the graph's nodes (cuGraphGetNodes), launches,
   device busy and idle share a step of both paths (torch.profiler, the idle
   share against the unprofiled runs' wall time), steps/s of both in turns,
   and the memory after the capture (moist3d, JW06, the ensemble); the
   vertical diffusion's batched LU captured alone; the capture sweep: every
   one of the 21 equation sets' steady step, with every build_step option
   among them and a compensated and a factored grid, SWEEP_STEPS steps
   graph against eager; a step that reads a value on the host raises
   GraphCaptureError naming its line, and the card goes on.

36. the condensation adjustment's kernel (the condensation group): at the
   mature TC's shape [9, 300, 4, 24] and JW06's [9, 144, 96, 24] (laid out
   as the step's state), in f32 and f64, each in the TC's diagnostic mode
   and the default mode, the
   kernel through ``condensation_adjustment`` (in place, one launch, no
   plain call) against the plain chain in the same type (per output row,
   COND_F64_REL of its max in f64, COND_F32_ULPS of its max in f32), then
   in the TC's mode timed in turns (plain, kernel, kernel, plain), as
   device time (queued) and as replays of a CUDA graph of each (each kernel
   call from a copy of the input, the copy's own time taken off), beside its
   bytes bound (6 rows read, 3 written, the reference columns) and ptxas'
   registers.

Two CPU references need no card: the JW06 balance at 12 x 20 (phase 19)
and fit_parameters' run (phase 26).  One child process of this script
(``--cpu-reference``, CpuReferences) computes them in f64 on 4 threads from
the start, beside the card's phases, and those phases wait for it.

``--only`` runs some phase groups alone (kernels: 3-5; graphs: 35; paths: 6-18; jw06:
19-21; ensembles: 22-23; gradients: 24-26; comp_kernels: 27; comp_moist3d:
28; comp_flagship: 29; factored: 30; sharded: 31; examples: 32 and 34; cli:
33; condensation: 36);
only a run of all prints the kernels line and the closing line.  No phase catches its own failure: any
failed check raises and the script exits non-zero.  Without a CUDA device
it exits 2 and prints no result.
The last lines of standard output are the card's name and power limit, a
JSON object describing the kernels (each with its bound: the larger of its
bytes over 3.35 TB/s and its operations over the H100 SXM's peak for them:
products of f32 matrices at the tensor cores' f32-accurate rate, 3xTF32, a
third of 495 TFLOP/s; the comp kernels' bf16x3 products at a third of 989
TFLOP/s; of f64 matrices at 67 TFLOP/s; f32 elementwise work at 67
TFLOP/s), then {"ok": true, "device": {...}}.  It imports nothing of jax.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MOIST3D_VARS = ("s", "xi", "mu", "u", "v", "w", "mu_c", "mu_r", "qss")
FLAGSHIP_VARS = ("h", "u", "v", "ub", "vb", "wb")  # u, v: the free layer's ug, vg
# f32 against f64 after 20 full-width TC steps: 1e-4 of each field's max,
# except u: it starts at zero, and its 20-step max (0.14 m/s) sits under the
# round-off of the 15 m/s gradient-wind balance; the same comparison on the
# CPU measured 1.03e-4 (PERF.md), so its bound is 3e-4
TC_F32_BOUND = {"u": 3e-4}
TC_QC_MIN = 1e-6  # q_c max after 30 min: 6.09e-6 in the CPU f64 run (PERF.md)
# the flagship workflow after 200 spinup + 400 two-way steps; the bands sit
# around the readings of the CPU f64 run of the same 600 steps
# (tools/torch_flagship_reference.py; PERF.md)
FLAGSHIP_VG_BAND = (49.5, 50.3)  # m/s; 49.887 in the CPU f64 run
# m/s, wavenumber-2 amplitude of vg at r = 50 km; 0.6785 in the CPU f64 run
FLAGSHIP_WAVE2_BAND = (0.5, 0.9)
# f32 against f64 after 50 full-width two-way steps: 1e-4 of each field's
# max, except wb: it is diagnosed each step from derivatives of ub and vb, so
# their round-off shows in it undamped; the same comparison on the CPU
# measured 6.6e-4 from f32-made ICs (PERF.md), so its bound is 2e-3
FLAGSHIP_F32_BOUND = {"wb": 2e-3}
# the convective shower after 240 steps (60 s): (w.max band m/s, q_c max band
# kg/kg) of each run, around the readings of the CPU f64 run of the same 240
# steps (tools/torch_shower_reference.py; PERF.md): w.max 1.12497 and
# 1.96606 m/s, q_c max 2.98594e-3 and 2.30000e-3.  f32 against f64 after 20
# steps: every field within 1e-4 there (the largest, v, 5.6e-5), so 1e-4
SHOWER_BANDS = {"shower": ((1.0, 1.25), (2.5e-3, 3.5e-3)),
                "shower_production": ((1.75, 2.2), (2.0e-3, 2.6e-3))}
# the H100 SXM's published dense peaks (NVIDIA's data sheet): HBM; products
# of f32 matrices to f32 accuracy on the tensor cores (3xTF32: three TF32
# products, so a third of 495 TFLOP/s); products of f64 matrices on them;
# f32 elementwise work outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"f32 products": 495e12 / 3, "f64 products": 67e12,
                   "f32 elementwise": 67e12,
                   # the comp kernels' products: three bf16 tensor-core passes
                   # of each, so a third of 989 TFLOP/s dense bf16
                   "bf16x3 products": 989e12 / 3}
# what the library's matrix-product kernels (behind torch.einsum) are named
GEMM_KERNEL_WORDS = ("gemm", "gemv", "cutlass", "xmma", "splitk")
# JW06 at its production recipe (scythe_tpu_torch/examples/
# jw06_baroclinic_slz.py production_model): steps of 7.5 s run in f32 from the
# state balanced on the card, and the bands its readings sit in, around the
# readings of a CPU f64 run of the same steps (tools/torch_jw06_reference.py;
# PERF.md)
JW06_STEPS = 480
# (CPU f64: u_max 35.23684, |v| max 0.30388, ps 956.78128 to 1009.82857 hPa,
# eddy ps min -0.74220 hPa, |w| max 0.0070140 m/s)
JW06_BANDS = {"u_max": (35.20, 35.27), "v_absmax": (0.300, 0.308),
              "ps_min": (956.75, 956.81), "ps_max": (1009.80, 1009.86),
              "ps_eddy_min": (-0.750, -0.735), "w_absmax": (0.0068, 0.0072)}
# f32 against f64 after 20 JW06 steps: 1e-4 of each field's max unless named;
# the named fields start at (or near) zero, so f32's round-off of the base
# state is most of their 20-step max; their bounds are about 3x the same
# comparison on the CPU (tools/torch_jw06_reference.py; PERF.md)
# (CPU: mu 6.2e-3, v 1.5e-3, w 3.4e-2, mu_c 9.5e-3, qss 1.3e-2)
JW06_F32_BOUND = {"mu": 0.02, "v": 5e-3, "w": 0.1, "mu_c": 0.03, "qss": 0.04}
# the ensembles: the flagship at full width (bench.py's ensemble_bench: 16
# members scaled 1 + i/100) and the convective shower, 4 members
FLAGSHIP_MEMBERS = 16
SHOWER_MEMBERS = 4
# f32 members against their own f32 single runs after 20 shower steps: the
# batched products sum in another order, and the convection grows the
# difference; measured 1.26e-3 of a field's max on one H100, so 5e-3
SHOWER_MEMBER_F32_BOUND = 5e-3
CS_NZ = (13, 24, 40, 48, 100, 128)
CS_NCOLS = (37, 1200, 9216)
# (label, ncols, nz, reference state, per-level Pxi): the variable-coefficient
# operator at the moist3d shape, both of the shower's (48 x 16 columns x 32)
CS_MORE = (("9216x48 profile", 9216, 48, "moist3d", True),
           ("2304x32", 2304, 32, "shower", False),
           ("2304x32 profile", 2304, 32, "shower", True),
           ("2304x48", 2304, 48, "moist3d", False))  # a moist3d shard of 12 cells
# (label, ncols, nz, reference state, per-level Pxi, dtype) of the timed calls
CS_TIMED = (("9216x48 f32", 9216, 48, "moist3d", False, "float32"),
            ("1200x24 f32", 1200, 24, "moist3d", False, "float32"),
            ("9216x48 f64", 9216, 48, "moist3d", False, "float64"),
            ("9216x48 f32 profile", 9216, 48, "moist3d", True, "float32"),
            ("2304x32 f32", 2304, 32, "shower", False, "float32"),
            ("2304x32 f32 profile", 2304, 32, "shower", True, "float32"),
            ("13824x24 f32", 13824, 24, "jw06", False, "float32"),
            ("2304x48 f32", 2304, 48, "moist3d", False, "float32"))


# the CPU references that need no card, by the phase group that reads them:
# one child process of this script computes them (--cpu-reference) while the
# card runs the phases before those groups
CPU_REFERENCES = {"jw06": "jw06_small", "gradients": "fit"}
CPU_REFERENCE_THREADS = 4


class CpuReferences:
    """The CPU references ``names`` (of CPU_REFERENCES), computed by one child
    process started here, beside the card's phases; ``get(name)`` waits for
    the child and loads one; ``close()`` stops the child if it still runs."""

    def __init__(self, names, tmp):
        self.dir, self.names = tmp, list(names)
        self.log = os.path.join(tmp, "cpu_references.log")
        self.proc = None
        if self.names:
            with open(self.log, "w") as log:
                self.proc = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--cpu-reference-dir", tmp,
                     "--cpu-reference", *self.names],
                    stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)

    def get(self, name):
        assert name in self.names, (name, self.names)
        rc = self.proc.wait(timeout=900)
        with open(self.log) as log:
            assert rc == 0, (rc, log.read()[-3000:])
        return np.load(os.path.join(self.dir, f"cpu_reference_{name}.npz"))

    def close(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def cpu_references(names, out_dir):
    """The child of CpuReferences: each reference of ``names`` on the CPU in
    f64, saved to ``out_dir``/cpu_reference_<name>.npz."""
    import torch

    torch.set_num_threads(CPU_REFERENCE_THREADS)
    sys.path.insert(0, ROOT)
    import scythe_tpu_torch as tx
    from scythe_tpu_torch import adjoint
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch.examples import calibrate_drag as cd
    from scythe_tpu_torch.examples import jw06_baroclinic_slz as jwx

    for name in names:
        path = os.path.join(out_dir, f"cpu_reference_{name}.npz")
        if name == "jw06_small":
            _, _, _, phys, history, _ = jw06_small(tx, tmodel, jwx, torch, out_dir, "cpu")
            np.savez(path, phys=phys, history=np.asarray(history))
        else:
            fit, history = fit_case(tx, torch, cd, adjoint, out_dir, "cpu")
            np.savez(path, Cd=fit["Cd"], history=np.asarray(history))
    return 0


# the kernels' launch counters (``trace``) that zero_counts and launched read
CS, CS_BACK, CS_COMP = ("column_solve.launches", "column_solve.backward_launches",
                        "column_solve.comp_launches")
RA, RA_COMP = "rlz_analysis.launches", "rlz_analysis.comp_launches"
CN, CN_PLAIN = "condensation.launches", "condensation.plain_launches"
EP = "elementwise_probe.launches"
_COUNT_BASE = {}  # {counter: its process total at its module's last zero_counts}


def zero_counts(*mods):
    """Count the launches of the kernels' modules (their ``trace`` counters
    ``<module>.<counter>``: plain and comp, forward and backward) from 0,
    just before a path is driven; ``launched`` reads them."""
    from scythe_tpu_torch import trace

    names = {mod.__name__.rsplit(".", 1)[1] for mod in mods}
    for name, stat in trace.process().counters.items():
        if name.split(".")[0] in names:
            _COUNT_BASE[name] = stat.total


def launched(*names):
    """The ``trace`` counters ``names`` (``column_solve.launches``, ...)
    since their modules' last ``zero_counts``: an int for one name, a tuple
    for several."""
    from scythe_tpu_torch import trace

    rec = trace.process()
    got = tuple(int((rec.total(k) or 0) - _COUNT_BASE.get(k, 0)) for k in names)
    return got[0] if len(got) == 1 else got


def say(phase, t0, msg):
    print(f"PASS {phase} ({time.perf_counter() - t0:.2f} s): {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def write_sounding(path):
    zs = np.linspace(0.0, 12000.0, 40)
    theta = 300.0 + 0.004 * zs
    qv = 14.0 * np.exp(-zs / 2500.0)
    with open(path, "w") as f:
        f.write(f"1015.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")


def moist_model(tx, tmp, name, *, cells, ldim, xmax, zdim, ts, n_steps, out_every,
                bubble):
    """A MoistEulerRLZ configuration with its sounding and bubble IC CSV
    written under ``tmp``.  ``bubble`` = (x0, z0, radius, amplitude) of the
    cos^2 entropy bubble at azimuth 0."""
    import torch
    from scythe_tpu_torch import io as sio

    gp = tx.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=xmax, num_cells=cells, lDim=ldim,
        zmin=0.0, zmax=10000.0, zDim=zdim,
        BCL={"u": tx.BC.R1T0, "v": tx.BC.R1T0, "w": tx.BC.R1T1},
        BCR={"u": tx.BC.R1T0, "v": tx.BC.R0},
        vars={v: i + 1 for i, v in enumerate(MOIST3D_VARS)},
    )
    snd = os.path.join(tmp, f"{name}_sounding.txt")
    ics = os.path.join(tmp, f"{name}_ics.csv")
    write_sounding(snd)
    pts = tx.create_grid(gp, torch.float64, device="cpu").gridpoints()
    r, lam, z = pts[:, 0], pts[:, 1], pts[:, 2]
    x0, z0, rad0, amp = bubble
    rad = np.sqrt(((r * np.cos(lam) - x0) / rad0) ** 2
                  + (r * np.sin(lam) / rad0) ** 2 + ((z - z0) / rad0) ** 2)
    cols = np.zeros((len(r), 3 + len(MOIST3D_VARS)))
    cols[:, :3] = pts
    cols[:, 3] = amp * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
    sio._write_csv(ics, ["r", "l", "z", *MOIST3D_VARS], cols)
    return tx.ModelParameters(
        ts=ts, integration_time=n_steps * ts, output_interval=out_every * ts,
        equation_set="MoistEulerRLZ", initial_conditions=ics,
        output_dir=os.path.join(tmp, f"{name}_out"), ref_state_file=snd,
        grid_params=gp, physical_params={"K": 10.0, "f": 5.0e-5},
        options={"semiimplicit": True},
    )


def moist3d(tx, tmp, n_steps, out_every, name="moist3d"):
    """The JAX package's moist3d benchmark configuration (bench.py
    moist3d_model, its bubble from moist3d_bench)."""
    return moist_model(tx, tmp, name, cells=48, ldim=64, xmax=20000.0, zdim=48,
                       ts=0.15, n_steps=n_steps, out_every=out_every,
                       bubble=(6000.0, 2500.0, 2000.0, 2.0))


def small(tx, tmp, n_steps):
    """tests/test_rlz_tcbl.py's bubble on the small port-test grid."""
    return moist_model(tx, tmp, "small", cells=8, ldim=16, xmax=10000.0, zdim=16,
                       ts=0.25, n_steps=n_steps, out_every=n_steps,
                       bubble=(4000.0, 2000.0, 1500.0, 3.0))


def write_ics(sio, path, coord_names, pts, cols):
    """An IC CSV: the grid points, then a column per variable (zero where
    ``cols`` has none)."""
    data = np.zeros((len(pts), len(pts[0]) + len(MOIST3D_VARS)))
    data[:, :pts.shape[1]] = pts
    for j, n in enumerate(MOIST3D_VARS):
        if n in cols:
            data[:, pts.shape[1] + j] = cols[n]
    sio._write_csv(path, [*coord_names, *MOIST3D_VARS], data)


def xyz_test_model(tx, tmp, n_steps, cells=12, ldim=16, zdim=16, ts=0.2, name="xyz"):
    """MoistEulerXYZ at tests/test_xyz.py's size (12 cells x 16 x 16, a
    12 x 8 x 10 km box, ts 0.2 s, K 20, semi-implicit) with its sounding and
    its warm bubble, modulated in y, written under ``tmp``; other sizes and
    steps of the same box by keyword (the factored DFT's: lDim 4096)."""
    import torch
    from scythe_tpu_torch import io as sio

    lx, ly, lz = 12000.0, 8000.0, 10000.0
    gp = tx.GridParameters(
        geometry="XYZ", xmin=0.0, xmax=lx, num_cells=cells, lDim=ldim, ymin=0.0, ymax=ly,
        zmin=0.0, zmax=lz, zDim=zdim, BCL={"u": tx.BC.R1T0, "w": tx.BC.R1T1},
        BCR={"u": tx.BC.R1T0}, vars=MOIST3D_VARS,
    )
    zs = np.linspace(0.0, 1.2 * lz, 40)
    snd = os.path.join(tmp, f"{name}_sounding.txt")
    with open(snd, "w") as f:
        f.write("1015.0 300.0 12.0\n")
        for z in zs[1:]:
            f.write(f"{z} {300.0 + 0.004 * z} {12.0 * np.exp(-z / 2500.0)}\n")
    pts = tx.create_grid(gp, torch.float64, device="cpu").gridpoints()
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rad = np.sqrt(((x - 0.4 * lx) / 2500.0) ** 2 + ((z - 2500.0) / 2000.0) ** 2)
    s_pert = (2.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
              * (1.0 + 0.3 * np.sin(2.0 * np.pi * y / ly)))
    ics = os.path.join(tmp, f"{name}_ics.csv")
    write_ics(sio, ics, ("x", "y", "z"), pts, {"s": s_pert})
    return tx.ModelParameters(
        ts=ts, integration_time=n_steps * ts, output_interval=n_steps * ts,
        equation_set="MoistEulerXYZ", initial_conditions=ics,
        output_dir=os.path.join(tmp, f"{name}_out"), ref_state_file=snd, grid_params=gp,
        physical_params={"K": 20.0}, options={"semiimplicit": True},
    )


def slz_test_model(tx, tmp, n_steps, thermal):
    """MoistEulerSLZ at tests/test_slz.py's size (12 cells x 32 x 24, a
    15 km lid, ts 0.25 s, K 100, semi-implicit, active sedimentation) with
    its sounding, from zero perturbation or (``thermal``) a warm thermal at
    30N, written under ``tmp``."""
    import torch
    from scythe_tpu_torch import io as sio

    ZBC = tx.ZBC
    gp = tx.GridParameters(
        geometry="SLZ", xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=12, lDim=32,
        sphere_radius=6.37122e6, zmin=0.0, zmax=15000.0, zDim=24,
        BCB={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "w": ZBC.R1T0},
        BCT={"s": ZBC.R1T1, "u": ZBC.R1T1, "v": ZBC.R1T1, "mu": ZBC.R1T1,
             "mu_c": ZBC.R1T1, "mu_r": ZBC.R1T1, "w": ZBC.R1T0},
        vars=MOIST3D_VARS,
    )
    zs = np.linspace(0.0, 24000.0, 80)
    theta = np.where(zs <= 12000.0, 300.0 + 43.0 * (zs / 12000.0) ** 1.25,
                     343.0 * np.exp(9.81 / (1004.0 * 213.0) * (zs - 12000.0)))
    qv = np.where(zs <= 1200.0, 13.0, 13.0 * np.exp(-(zs - 1200.0) / 2200.0))
    qv = np.where(zs > 9000.0, 0.02, qv)
    snd = os.path.join(tmp, "slz_sounding.txt")
    with open(snd, "w") as f:
        f.write(f"1000.0 {theta[0]} {qv[0]}\n")
        for z, th, q in zip(zs[1:], theta[1:], qv[1:]):
            f.write(f"{z} {th} {q}\n")
    pts = tx.create_grid(gp, torch.float64, device="cpu").gridpoints()
    cols = {}
    if thermal:
        phi, lam, z = pts[:, 0], pts[:, 1], pts[:, 2]
        rad = np.sqrt(((phi - np.pi / 6) / 0.5) ** 2 + ((lam - np.pi) / 0.5) ** 2
                      + ((z - 1500.0) / 1500.0) ** 2)
        cols["s"] = 10.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2
    name = f"slz_{'thermal' if thermal else 'rest'}"
    ics = os.path.join(tmp, f"{name}_ics.csv")
    write_ics(sio, ics, ("lat", "lon", "z"), pts, cols)
    return tx.ModelParameters(
        ts=0.25, integration_time=n_steps * 0.25, output_interval=n_steps * 0.25,
        equation_set="MoistEulerSLZ", initial_conditions=ics,
        output_dir=os.path.join(tmp, f"{name}_out"), ref_state_file=snd, grid_params=gp,
        physical_params={"K": 100.0},
        options={"semiimplicit": True, "sedimentation": "active"},
    )


def shower(tx, sh, base, n_steps, profile=None):
    """The convective shower of scythe_tpu_torch/examples/
    convective_shower_xyz.py at its own width (48 cells x 16 x 32, ts
    0.25 s), its sounding and ICs written under ``base``, cut to ``n_steps``
    steps (outputs every sixth of them, as the example); ``profile`` puts an
    options profile over the example's options."""
    return sh.shower_model(base, profile=profile, t_end=n_steps * 0.25)


def flagship_workflow(tx, cb, base, dtype, device, twoway_steps=400):
    """The Cha & Bell workflow as a user runs it, through the IC files and
    integrate_model: Rankine ICs, the one-way spinup for 10 simulated minutes
    (200 steps), add_wave2 on its last output, then the two-way model for
    ``twoway_steps`` with an output halfway.  Returns (two-way model, grid,
    final fields)."""
    cb.initialize_wave2(base, quick=True, dtype=dtype, device=device)
    t_end = twoway_steps * 3.0
    tw = cb.twoway_model(base).with_(integration_time=t_end, output_interval=t_end / 2)
    grid, phys = tx.integrate_model(tw, dtype=dtype, device=device)
    return tw, grid, phys


def ring_amplitudes(grid, field, radius):
    """Amplitudes by azimuthal wavenumber (0 .. nl/2) of ``field`` [rDim, nl]
    on the ring nearest ``radius``."""
    i = int(np.argmin(np.abs(grid.r_mish - radius)))
    c = np.fft.rfft(np.asarray(field[i], np.float64)) / field.shape[1]
    amp = 2.0 * np.abs(c)
    amp[0] *= 0.5
    return amp


def flagship_readings(grid, phys):
    """What phase 9 checks, from the final fields [6, rDim, nl].  At r = 50 km
    the ellipse moves the vortex's edge across the ring, so wavenumber 4
    outgrows 2 there; 5 km inside the edge wavenumber 2 is the largest."""
    at50 = ring_amplitudes(grid, phys[2], 50.0e3)
    at45 = ring_amplitudes(grid, phys[2], 45.0e3)
    return {
        "vg_max": float(phys[2].max()),
        "vg_wave2_at_50km": float(at50[2]),
        "vg_wave4_at_50km": float(at50[4]),
        "vg_odd_waves_at_50km": float(at50[1::2].max()),
        "vg_wave2_at_45km": float(at45[2]),
        "vg_largest_wave_at_45km": int(np.argmax(at45[1:]) + 1),
        "h_min": float(phys[0].min()),
        "ub_min": float(phys[3].min()),
        "wb_min": float(phys[5].min()),
        "wb_max": float(phys[5].max()),
    }


def hrbl_model(tx, tmp, n_steps):
    """Oneway_ShallowWater_HeightResolvedBL at the configuration of
    tests/test_rlz_tcbl.py::test_height_resolved_bl_smoke: a balanced
    Rankine vortex over a 16 x 16 x 12 RLZ grid, its ICs written under
    ``tmp``."""
    import torch
    from scythe_tpu_torch import io as sio

    BC = tx.BC
    gp = tx.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=2.0e5, num_cells=16, lDim=16,
        zmin=0.0, zmax=2000.0, zDim=12,
        BCL={"h": BC.R1T1, "u": BC.R1T0, "v": BC.R1T0, "ub": BC.R1T0, "vb": BC.R1T0,
             "wb": BC.R1T1},
        BCR={"h": BC.R0, "u": BC.R1T1, "v": BC.R0, "ub": BC.R1T1, "vb": BC.R0},
        vars={n: i + 1 for i, n in enumerate(FLAGSHIP_VARS)},
    )
    ics = os.path.join(tmp, "hrbl_ics.csv")
    pts = tx.create_grid(gp, torch.float64, device="cpu").gridpoints()
    r = pts[:, 0]
    rm, vm, f_cor, g = 5.0e4, 20.0, 5.0e-5, 9.81
    v = np.where(r < rm, vm * r / rm, vm * rm / r)
    r_u = np.unique(r)
    v_u = np.where(r_u < rm, vm * r_u / rm, vm * rm / r_u)
    dhdr_u = (f_cor * v_u + v_u**2 / r_u) / g
    h_u = np.concatenate([[0.0], np.cumsum(0.5 * (dhdr_u[1:] + dhdr_u[:-1]) * np.diff(r_u))])
    zero = np.zeros_like(r)
    cols = np.concatenate(
        [pts, np.stack([h_u[np.searchsorted(r_u, r)], zero, v, zero, v, zero], axis=1)], axis=1)
    sio._write_csv(ics, ["r", "l", "z", *FLAGSHIP_VARS], cols)
    return tx.ModelParameters(
        ts=0.2, integration_time=n_steps * 0.2, output_interval=n_steps * 0.2,
        equation_set="Oneway_ShallowWater_HeightResolvedBL", initial_conditions=ics,
        output_dir=os.path.join(tmp, "hrbl_out"), grid_params=gp,
        physical_params={"g": g, "Kh": 3000.0, "Cd": 2.4e-3, "Hfree": 2000.0,
                         "f": f_cor, "Um": 0.0, "Vm": 0.0},
    )


def cuda_time_ms(fn, n):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def queued_time_ms(fn, n):
    """ms a call on the device alone: the ``n`` calls are queued behind a
    sleep kernel that outlasts their enqueueing, so the device runs them
    back to back whatever the host costs a call."""
    import torch

    h0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)  # cycles: ~2x at ~2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def in_turns(plain, kernel, n, timer=cuda_time_ms, library=None):
    """(kernel ms list, plain ms list) timed plain, kernel, kernel, plain
    after a warm-up of each; with ``library``, a third list, timed last."""
    fns = (plain, kernel) + ((library,) if library else ())
    for fn in fns:
        cuda_time_ms(fn, max(2, n // 10))
    times = {fn: [] for fn in fns}
    for fn in (plain, kernel, kernel, plain) + fns[2:]:
        times[fn].append(timer(fn, n))
    return (times[kernel], times[plain]) + ((times[library],) if library else ())


def bound_ms(nbytes, flops, kind):
    """(ms, "bytes" | "operations"): the least time the card could take;
    ``kind`` is a key of PEAK_FLOP_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def column_solve_bound(ncols, nz, dtype_name):
    """x*, w* and M read once, w and xi written once; 2 ncols (2nz)^2 FLOP."""
    f32 = dtype_name == "float32"
    return bound_ms((4 * ncols * nz + 4 * nz * nz) * (4 if f32 else 8),
                    2 * ncols * (2 * nz) ** 2, "f32 products" if f32 else "f64 products")


def analysis_bound(shape, b_rdim, f64=False):
    """The RLZ analysis of x [V, R, L, Z] to [V, b_rDim, L, Z] (f32, or f64):
    x, the DFT matrix, the ring mask and both operator stacks read once, the
    coefficients written once; the lambda (the kernel's dense l x l product,
    masked after), radial and vertical products."""
    V, R, L, Z = shape
    B = b_rdim
    return bound_ms(
        (8 if f64 else 4)
        * (V * R * L * Z + L * L + R * L + V * B * R + V * Z * Z + V * B * L * Z),
        2 * V * R * L * L * Z + 2 * V * B * R * L * Z + 2 * V * B * L * Z * Z,
        "f64 products" if f64 else "f32 products")


def analysis_library(torch, x, la, mask, an, az):
    """The yardstick of both analysis rows: one torch.einsum over the whole
    chain (lambda DFT, ring mask, radial and vertical operators) in x's
    dtype, TF32 off (true f32 products); the port never calls it."""
    def library():
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.einsum("kl,vrlz,rk,vbr,vKz->vbkK", la, x, mask, an, az)
    return library


def per_field_rel(got, ref):
    """max|got - ref| / max|ref| per leading-axis field (fields whose ref is
    identically zero are compared absolutely and reported as such)."""
    out = []
    for v in range(ref.shape[0]):
        scale = np.abs(ref[v]).max()
        err = np.abs(got[v].astype(np.float64) - ref[v]).max()
        out.append(err / scale if scale > 0 else err)
    return out


def fmt_rel(rel, names=MOIST3D_VARS):
    return json.dumps(dict(zip(names, [float(f"{e:.3e}") for e in rel])))


def rel_errs(got, ref):
    """max|got - ref| / max|ref| of each output of a (w, xi) pair, and the
    largest absolute error."""
    errs = [float((g.double() - r).abs().max()) for g, r in zip(got, ref)]
    return max(e / float(r.abs().max()) for e, r in zip(errs, ref)), max(errs)


def check_stage(torch, cs, o64, o32, x, w, stage, pxi):
    """One stage of the column solve on the card against its plain chain:
    the stage's operator as the main path applies it, twice in each dtype,
    and the TPU function's counterpart composed per call; returns the
    relative errors (and the f32 kernel's and library's largest absolute
    error)."""
    ts = o64.ts
    ts_term = 0.5 * ts if stage == "t1" else 1.25 * ts
    ops64 = (o64.col_filter, o64.col_deriv,
             o64.hinv_t1 if stage == "t1" else o64.hinv, o64.synth, o64.dsynth)
    ops32 = (o32.col_filter, o32.col_deriv,
             o32.hinv_t1 if stage == "t1" else o32.hinv, o32.synth, o32.dsynth)
    s64 = o64.solve_t1 if stage == "t1" else o64.solve
    s32 = o32.solve_t1 if stage == "t1" else o32.solve
    x32, w32 = x.float(), w.float()
    ref = cs.fused_column_solve_plain(x, w, *ops64, ts_term, pxi)
    plain32 = cs.fused_column_solve_plain(x32, w32, *ops32, ts_term, pxi)
    library32 = cs.apply_column_operator_plain(x32, w32, s32.M)
    k64, k64b = (cs.apply_column_operator(x, w, s64) for _ in range(2))
    k32, k32b = (cs.apply_column_operator(x32, w32, s32) for _ in range(2))
    c64 = cs.fused_column_solve(x, w, *ops64, ts_term, pxi, mode="plain")
    c32 = cs.fused_column_solve(x32, w32, *ops32, ts_term, pxi, mode="plain")
    torch.cuda.synchronize()
    where = (tuple(x.shape), stage, "profile" if np.ndim(pxi) else "scalar Pxi")
    for a, b in zip(k64 + k32, k64b + k32b):
        assert torch.isfinite(a).all() and torch.equal(a, b), (where, "not repeatable")
    r64, _ = rel_errs(k64, ref)
    r32, e32 = rel_errs(k32, ref)
    rp, _ = rel_errs(plain32, ref)
    rl, el = rel_errs(library32, ref)
    rc64, _ = rel_errs(c64, ref)
    rc32, _ = rel_errs(c32, ref)
    assert r64 <= 1e-12 and rc64 <= 1e-12, (where, "f64", r64, rc64)
    assert r32 <= 1e-5 and r32 <= 4.0 * rp, (where, "f32", r32, "plain f32", rp)
    assert rc32 <= 1e-5 and rc32 <= 4.0 * rp, (where, "counterpart f32", rc32, rp)
    return {"f64": r64, "f32": r32, "f32 / plain f32": r32 / rp,
            "library f32 / plain f32": rl / rp, "f32 / library f32": r32 / rl,
            "counterpart f64": rc64, "counterpart f32": rc32}, e32, el


def time_column_solve(torch, tti, cs, rng, label, ncols, nz, column, profile, dname):
    """The column solve at ``ncols`` x ``nz`` in ``dname`` on the stage
    operator of ``column`` = (zmax, ts, Pxi_bar, Pxi_prof) (the profile
    where ``profile``): kernel, plain chain and library call (one
    torch.matmul of [x* | w*] by M^T) timed in turns as device time (200
    calls queued behind a sleep kernel) and back to back, each one's error
    against the f64 chain printed; returns (kernel ms, plain ms, library ms,
    bound ms, bound_by), the least of each."""
    dtype = getattr(torch, dname)
    zmax_, ts_, bar, prof = column
    p = prof if profile else bar
    o = tti.build_semiimplicit_ops(nz, 0.0, zmax_, None, p, ts_, dtype, "cuda")
    o64 = tti.build_semiimplicit_ops(nz, 0.0, zmax_, None, p, ts_, torch.float64, "cuda")
    ops = (o.col_filter, o.col_deriv, o.hinv, o.synth, o.dsynth)
    x64 = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
    w64 = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
    x, w = x64.to(dtype), w64.to(dtype)
    xw = torch.cat([x, w], dim=1).contiguous()
    m_t = o.solve.M.T
    p_dev = torch.as_tensor(p, dtype=dtype, device="cuda") if profile else p
    plain = lambda: cs.fused_column_solve_plain(x, w, *ops, 1.25 * ts_, p_dev)  # noqa: E731
    kernel = lambda: cs.apply_column_operator(x, w, o.solve)  # noqa: E731
    library = lambda: torch.matmul(xw, m_t)  # noqa: E731
    ref = cs.fused_column_solve_plain(x64, w64, o64.col_filter, o64.col_deriv, o64.hinv,
                                      o64.synth, o64.dsynth, 1.25 * ts_, p)
    lib_out = library()
    err = {"kernel": rel_errs(kernel(), ref)[0], "plain": rel_errs(plain(), ref)[0],
           "library": rel_errs((lib_out[:, :nz], lib_out[:, nz:]), ref)[0]}
    kt, pt, lt = in_turns(plain, kernel, 200, timer=queued_time_ms, library=library)
    kb, pb, lb = in_turns(plain, kernel, 200, library=library)
    bound, by = column_solve_bound(ncols, nz, dname)
    print(f"  column solve {label}: device time kernel {kt} ms, plain {pt} ms, library "
          f"{lt} ms; back to back kernel {kb} ms, plain {pb} ms, library {lb} ms; bound "
          f"{bound:.5f} ms ({by}), kernel at {100.0 * bound / min(kt):.1f}% of it; rel err "
          f"against the f64 chain: kernel {err['kernel']:.3e}, plain {err['plain']:.3e}, "
          f"library {err['library']:.3e}", flush=True)
    return (min(kt), min(pt), min(lt), bound, by)


def phase_column_solve(torch, tti, cs, columns):
    """Phase 3; ``columns`` maps "moist3d", "shower" and "jw06" to (zmax, ts,
    Pxi_bar, Pxi_prof) of their reference states.  Returns ({"kernel" | "library":
    max_abs_err at 9216 x 48 f32, AB3 stage}, {label: (ms, plain_ms,
    library_ms, bound_ms, bound_by)}) with device times."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    zmax, ts, pxi, _ = columns["moist3d"]
    worst = {}
    main_err, plans = None, []
    for nz in CS_NZ:
        o64 = tti.build_semiimplicit_ops(nz, 0.0, zmax, None, pxi, ts, torch.float64, "cuda")
        o32 = tti.build_semiimplicit_ops(nz, 0.0, zmax, None, pxi, ts, torch.float32, "cuda")
        for ncols in CS_NCOLS:
            x = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
            w = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
            for stage in ("t1", "ab"):
                errs, e32, el = check_stage(torch, cs, o64, o32, x, w, stage, pxi)
                for key, v in errs.items():
                    worst[key] = max(worst.get(key, 0.0), v)
                if (ncols, nz, stage) == (9216, 48, "ab"):
                    main_err = {"kernel": e32, "library": el}
            q32, q64 = cs.plan(ncols, nz, torch.float32), cs.plan(ncols, nz, torch.float64)
            plans.append(f"{ncols}x{nz}: f32 {q32} resident {q32.resident(nz)}; "
                         f"f64 {q64} resident {q64.resident(nz)}")
    print("  column-solve plans: " + " | ".join(plans), flush=True)
    say("column-solve-vs-plain", t0,
        f"nz {list(CS_NZ)} x ncols {list(CS_NCOLS)} x 2 stages, the stage's operator as the "
        f"main path applies it: max rel err f64 {worst['f64']:.3e} (tol 1e-12), f32 vs f64 "
        f"{worst['f32']:.3e} (tol 1e-5), largest ratio to the plain f32 chain's error "
        f"{worst['f32 / plain f32']:.3f} (tol 4; not checked: the library call's largest "
        f"ratio {worst['library f32 / plain f32']:.3f}, the kernel's largest ratio to the "
        f"library's error {worst['f32 / library f32']:.3f}); two calls bitwise equal in "
        f"each dtype; the counterpart fused_column_solve (composed per call) f64 "
        f"{worst['counterpart f64']:.3e}, f32 {worst['counterpart f32']:.3e} (same tolerances)")

    # the variable-coefficient operator (a per-level Pxi) and the shower's shape
    t0 = time.perf_counter()
    worst, lines = {}, []
    for label, ncols, nz, src, profile in CS_MORE:
        zmax_, ts_, bar, prof = columns[src]
        p = prof if profile else bar
        o64 = tti.build_semiimplicit_ops(nz, 0.0, zmax_, None, p, ts_, torch.float64, "cuda")
        o32 = tti.build_semiimplicit_ops(nz, 0.0, zmax_, None, p, ts_, torch.float32, "cuda")
        x = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        w = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        for stage in ("t1", "ab"):
            errs, _, _ = check_stage(torch, cs, o64, o32, x, w, stage, p)
            for key, v in errs.items():
                worst[key] = max(worst.get(key, 0.0), v)
            lines.append(f"{label} {stage}: f64 {errs['f64']:.2e}, f32 {errs['f32']:.2e} "
                         f"({errs['f32 / plain f32']:.2f}x the plain f32 chain's)")
    say("column-solve-profile-and-shower-vs-plain", t0,
        "the Pxi_prof operator of the moist3d sounding at 9216 x 48 and the shower's "
        "scalar and profile operators at 2304 x 32, both stages, the same tolerances: "
        + "; ".join(lines))

    t0 = time.perf_counter()
    times = {}
    for label, ncols, nz, src, profile, dname in CS_TIMED:
        times[label] = time_column_solve(torch, tti, cs, rng, label, ncols, nz, columns[src],
                                         profile, dname)
    say("column-solve-timing", t0,
        "200 calls a run, min device ms kernel vs plain vs library (bound, share): "
        + ", ".join(f"{k} {a:.5f} vs {b:.5f} vs {c:.5f} ({d:.5f} {e}, "
                    f"{100.0 * d / a:.1f}%)" for k, (a, b, c, d, e) in times.items()))
    return main_err, times


def analysis_params(tx, name):
    """The grid of an analysis shape: RLZ, or for the XYZ shower and the SLZ
    shapes their own geometry (the shower's periodic box, the SLZ test's and
    JW06's shells), so the kernel runs on their own masks and operators."""
    nv, cells, ldim, nz = ANALYSIS_SHAPES[name]
    names = {n: i + 1 for i, n in enumerate("abcdefghi"[:nv])}
    geometry = ANALYSIS_GEOMETRY.get(name, "RLZ")
    if geometry == "XYZ":
        return tx.GridParameters(
            geometry="XYZ", xmin=-3.0e4, xmax=3.0e4, num_cells=cells, lDim=ldim, ymin=0.0,
            ymax=2.0e4, zmin=0.0, zmax=1.5e4, zDim=nz, BCL=tx.BC.PERIODIC,
            BCR=tx.BC.PERIODIC, BCB=tx.ZBC.R1T1, BCT=tx.ZBC.R1T1, vars=names)
    if geometry == "SLZ":
        return tx.GridParameters(
            geometry="SLZ", xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=cells, lDim=ldim,
            sphere_radius=6.37122e6,
            zmin=0.0, zmax=3.0e4 if name.startswith("jw06") else 1.5e4,
            zDim=nz, BCB=tx.ZBC.R1T0, BCT=tx.ZBC.R1T0, vars=names)
    return tx.GridParameters(
        geometry="RLZ", xmin=0.0, xmax=3.0e5, num_cells=cells, lDim=ldim,
        zmin=0.0, zmax=1.0e4, zDim=nz, vars=names)


def analysis_grid(tx, torch, name, dtype):
    g = tx.create_grid(analysis_params(tx, name), dtype, device="cuda")
    return g, (g.l_analysis, g.ring_mask, g.analysis_r, g.analysis_z)


# (nvars, cells, lDim, nz): moist3d, the TC grid, the RLZ transform bench,
# tests/test_pallas_transforms.py's two, a large nl (l streamed) and a
# ragged one (every tile ragged; nz 13 rows are not 16-byte units); the XYZ
# shower, the SLZ test grid and the JW06 grid, each on its own geometry
ANALYSIS_SHAPES = {
    "moist3d": (9, 48, 64, 48),
    "tc": (9, 100, 4, 24),
    "transform": (8, 64, 128, 60),
    "pallas_test_a": (4, 16, 64, 20),
    "pallas_test_b": (2, 12, 32, 16),
    "large_nl": (2, 8, 1024, 16),
    "ragged": (3, 7, 12, 13),
    "shower": (9, 48, 16, 32),
    "slz_test": (9, 12, 32, 24),
    "jw06": (9, 24, 96, 24),
    "jw06_production": (9, 48, 96, 24),
    "moist_demo": (9, 16, 32, 40),  # the CLI's models/moist_euler_rlz_demo.py
}
ANALYSIS_GEOMETRY = {"shower": "XYZ", "slz_test": "SLZ", "jw06": "SLZ",
                     "jw06_production": "SLZ"}


ANALYSIS_TOL = ("tol f64 1e-12, f32 vs f64 1e-5 of max|ref| and <= 4x the plain f32 "
                "chain's error, two calls bitwise equal in each dtype")


def check_analysis(torch, ra, name, g64, x, ops64, ops32):
    """The analysis kernel on f64 ``x`` on the card against its plain chain,
    in f64 (``ops64``) and f32 (``ops32``), to ANALYSIS_TOL; returns (the
    f32 kernel's largest absolute error, a line with the errors and plans)."""
    ref = ra.rlz_analysis_plain(x, *ops64)
    plain32 = ra.rlz_analysis_plain(x.float(), *ops32)
    k64, k64b = ra.rlz_analysis(x, *ops64), ra.rlz_analysis(x, *ops64)
    k32, k32b = ra.rlz_analysis(x.float(), *ops32), ra.rlz_analysis(x.float(), *ops32)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    e64 = float((k64 - ref).abs().max())
    e32 = float((k32.double() - ref).abs().max())
    ep = float((plain32.double() - ref).abs().max())
    assert torch.isfinite(k64).all() and torch.isfinite(k32).all()
    assert e64 <= 1e-12 * scale, (name, "f64", e64, scale)
    assert e32 <= 1e-5 * scale, (name, "f32", e32, scale)
    assert e32 <= 4.0 * ep, (name, "f32 vs the plain f32 chain", e32, ep)
    assert torch.equal(k64, k64b) and torch.equal(k32, k32b), (name, "not repeatable")
    p64 = ra.plan(x.shape, g64.params.b_rDim, torch.float64)
    p32 = ra.plan(x.shape, g64.params.b_rDim, torch.float32)
    return e32, (f"{name} {g64.geometry} {list(x.shape)}->b_rDim {g64.params.b_rDim}: "
                 f"rel err f64 {e64 / scale:.2e}, f32 {e32 / scale:.2e} (plain f32 "
                 f"{ep / scale:.2e}); f32 {p32} {p32.ctas} blocks; f64 {p64} {p64.ctas} blocks")


def phase_analysis(tx, torch, ra):
    """Phase 4; returns (max_abs_err at the TC shape f32, {"moist3d" |
    "transform" | "tc" | "moist3d_f64" | ...: (ms, plain_ms, library_ms,
    bound_ms, bound_by)}), device times and each shape's bound."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    lines, tc_err = [], None
    for name, (nv, cells, ldim, nz) in ANALYSIS_SHAPES.items():
        g64, ops64 = analysis_grid(tx, torch, name, torch.float64)
        _, ops32 = analysis_grid(tx, torch, name, torch.float32)
        x = torch.from_numpy(rng.normal(size=(nv,) + g64.spatial_shape)).cuda()
        e32, line = check_analysis(torch, ra, name, g64, x, ops64, ops32)
        if name == "tc":
            tc_err = e32
        lines.append(line)
    say("analysis-vs-plain", t0, ANALYSIS_TOL + "; " + " | ".join(lines))

    t0 = time.perf_counter()
    times = {}
    for name, dtype in (("moist3d", torch.float32), ("transform", torch.float32),
                        ("tc", torch.float32), ("moist3d_f64", torch.float64),
                        ("shower", torch.float32), ("slz_test", torch.float32),
                        ("jw06", torch.float32), ("jw06_production", torch.float32),
                        ("moist_demo", torch.float32)):
        g, ops = analysis_grid(tx, torch, name.removesuffix("_f64"), dtype)
        nv = ANALYSIS_SHAPES[name.removesuffix("_f64")][0]
        x = torch.from_numpy(rng.normal(size=(nv,) + g.spatial_shape)).to("cuda", dtype)
        plain = lambda: ra.rlz_analysis_plain(x, *ops)  # noqa: E731
        kernel = lambda: ra.rlz_analysis(x, *ops)  # noqa: E731
        library = analysis_library(torch, x, *ops)
        kt, pt, lt = in_turns(plain, kernel, 100, timer=queued_time_ms, library=library)
        kb, pb, lb = in_turns(plain, kernel, 100, library=library)
        times[name] = (min(kt), min(pt), min(lt))
        bound, by = analysis_bound(tuple(x.shape), g.params.b_rDim, dtype == torch.float64)
        times[name] += (bound, by)
        note = f"; bound {bound:.5f} ms ({by}), kernel at {100.0 * bound / min(kt):.1f}% of it"
        print(f"  analysis {name} {list(x.shape)}: device time kernel {kt} ms, plain {pt} ms, "
              f"library {lt} ms; back to back kernel {kb} ms, plain {pb} ms, library {lb} "
              f"ms{note}", flush=True)
    say("analysis-timing", t0,
        "100 calls a run, min device ms kernel vs plain vs library (one torch.einsum over "
        "the chain, TF32 off; f32 unless named; then the bound): "
        + ", ".join(f"{k} {t[0]:.5f} vs {t[1]:.5f} vs {t[2]:.5f}"
                    + f" ({t[3]:.5f} {t[4]})"
                    for k, t in times.items()))
    return tc_err, times


def phase_probe(torch, ep):
    """Phase 5; returns (max_abs_err, ms, plain_ms, entry-point launches)."""
    t0 = time.perf_counter()
    args = ep.probe_inputs("cuda")
    ref = ep.probe_expr_plain(*args)
    got = ep.probe_expr(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    assert torch.isfinite(got).all() and rel <= 1e-5, rel
    kt, pt = in_turns(lambda: ep.probe_expr_plain(*args), lambda: ep.probe_expr(*args), 100)
    say("probe-vs-plain", t0,
        f"{list(ep.SHAPE)} f32: rel err {rel:.3e} (tol 1e-5), abs {err:.3e}; kernel "
        f"{kt} ms, plain {pt} ms a call (min {min(kt):.5f} vs {min(pt):.5f})")
    t0 = time.perf_counter()
    zero_counts(ep)
    assert ep.main() == 0
    launches = launched(EP)
    assert launches > 0
    say("probe-entry-point", t0, f"python -m scythe_tpu_torch.ops.elementwise_probe "
        f"in process: Triton kernel launches {launches}")
    return err, min(kt), min(pt), launches


def compensated_grids():
    """For the duration, the model module builds every grid compensated
    (matmul="compensated", deriv_single auto: on), as the JAX package's auto
    does on a TPU; initialize and integrate_model keep the JAX signature,
    so the TPU's production numerics are asked for here."""
    import functools
    from unittest import mock

    from scythe_tpu_torch import model as tmodel

    return mock.patch.object(tmodel, "create_grid",
                             functools.partial(tmodel.create_grid, matmul="compensated"))


def time_steps(torch, tmodel, model, n, comp=False):
    """(ms/step by CUDA events, steps/s by host clock, state) over ``n``
    steps after 10 warm-up steps; ``comp`` on compensated grids."""
    with compensated_grids() if comp else contextlib.nullcontext():
        grid, ctx, state = tmodel.initialize(model, torch.float32, "cuda")
    step = tmodel.build_step(model, grid, ctx, torch.float32)
    for _ in range(10):  # warm-up (and the Euler/AB2 ramp)
        state = step(state)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    for _ in range(n):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - h0
    assert torch.isfinite(state.spec).all()
    return start.elapsed_time(end) / n, n / host_s, state, step


def profile_steps(torch, state, step, card, label, path, n=10):
    """torch.profiler over ``n`` steps; returns (busy us/step, wall us/step,
    kernel launches/step, column-solve us/step, matrix-product us/step: the
    library's GEMM kernels behind torch.einsum, by name) and writes the kernel
    table to ``path``."""
    from torch.profiler import ProfilerActivity, profile as tprof

    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - h0) * 1e6
    avg = prof.key_averages()
    # device rows only: an aten op's row repeats its kernels' time
    kernels = [e for e in avg
               if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    solve = [e for e in kernels if "column_solve_kernel" in e.key]
    solve_us = sum(e.self_device_time_total for e in solve)
    gemm = [e for e in kernels if any(w in e.key.lower() for w in GEMM_KERNEL_WORDS)]
    gemm_us = sum(e.self_device_time_total for e in gemm)
    table = avg.table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{card}\n{n} steps of {label} f32, host wall {wall_us:.1f} us "
                f"(profiled), device busy {busy_us:.1f} us, column solve {solve_us:.1f} us "
                f"in {sum(e.count for e in solve)} launches, matrix products {gemm_us:.1f} us "
                f"in {sum(e.count for e in gemm)} launches ({sorted(e.key for e in gemm)})\n"
                f"{table}\n")
    return (busy_us / n, wall_us / n, sum(e.count for e in kernels) / n, solve_us / n,
            gemm_us / n)


def grad_keys(times, label, prefix):
    """The kernels line's keys of a backward and jvp timing of phase 24."""
    return {f"{prefix}{rule}_{k}": times[label][rule][i]
            for rule in ("backward", "jvp")
            for i, k in enumerate(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"))}


def jw06_case(tx, tmodel, tw, torch, base, n_steps, balance_device, cells=48, zdim=24):
    """JW06 at its production recipe cut to ``n_steps``: (model, float64 CPU
    grid and context, balanced initial fields [9, *spatial] float64, the
    balance history, seconds of the balance solve on ``balance_device``)."""
    model = tw.production_model(base, t_end=n_steps * 7.5, num_cells=cells, zdim=zdim)
    g64 = tx.create_grid(model.grid_params, torch.float64, device="cpu")
    c64 = tmodel.build_context(model, g64, torch.float64)
    t0 = time.perf_counter()
    delta, history = tw.balanced_delta(model, g64, c64, device=balance_device)
    if balance_device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    phys0 = tw.initial_fields(g64, c64.ref_state, perturb=True) + delta
    return model, g64, c64, phys0, history, seconds


def jw06_readings(tw, g64, c64, phys):
    """The JW06 example's diagnostics of final fields [9, *spatial] (u max,
    |v| max, storm-track ps min and max, eddy ps min, in m/s and hPa), and
    |w| max."""
    keys = ("u_max", "v_absmax", "ps_min", "ps_max", "ps_eddy_min")
    out = dict(zip(keys, tw.diagnostics(g64, c64.ref_state, np.asarray(phys, np.float64))))
    out["w_absmax"] = float(np.abs(phys[5]).max())
    return out


def run_steps(torch, tmodel, step, state, n):
    """(state after ``n`` steps, ms a step by CUDA events)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state = tmodel.make_scan(step, n)(state)
    end.record()
    torch.cuda.synchronize()
    return state, start.elapsed_time(end) / n


def launches_by_kernel(torch, fn):
    """({kernel name: launches}, device busy us) of one call of ``fn`` under
    torch.profiler (device rows only)."""
    from torch.profiler import ProfilerActivity, profile as tprof

    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    return ({e.key: e.count for e in kernels},
            sum(e.self_device_time_total for e in kernels))


def count_launches(torch, fn):
    """(kernel launches, device busy us) of one call of ``fn``."""
    by_name, busy = launches_by_kernel(torch, fn)
    return sum(by_name.values()), busy


def launches_per_step(torch, run, n_short, n_long, tries=3):
    """{kernel name: launches a step} of ``run(n)`` from the difference of the
    two lengths, which cancels a run's set-up; per name the least of
    ``tries`` readings, since the profiler's count of a name varies by a few
    between like runs and a launch is never missing from a run that made it."""
    best = {}
    for _ in range(tries):
        short, _ = launches_by_kernel(torch, lambda: run(n_short))
        long_, _ = launches_by_kernel(torch, lambda: run(n_long))
        for k in set(short) | set(long_):
            d = (long_.get(k, 0) - short.get(k, 0)) / (n_long - n_short)
            best[k] = min(best.get(k, d), d)
    return best


def jw06_small(tx, tmodel, tw, torch, tmp, device):
    """jw06_case at the balance check's reduced size (12 cells x 20 levels)
    on ``device``."""
    return jw06_case(tx, tmodel, tw, torch, os.path.join(tmp, f"jw06_small_{device}"), 20,
                     device, cells=12, zdim=20)


def phase_jw06(tx, tmodel, tw, torch, cs, ra, tmp, card, out_dir, refs):
    """Phases 19-21: JW06 at its production recipe on the card; the CPU's
    balance from ``refs`` (CpuReferences)."""
    # ---- 19: the balance on the card against the CPU's, at a reduced size
    t0 = time.perf_counter()
    _, _, _, p_gpu, h_gpu, s_gpu = jw06_small(tx, tmodel, tw, torch, tmp, "cuda")
    ref = refs.get("jw06_small")
    p_cpu, h_cpu = ref["phys"], list(ref["history"])
    rel_bal = float(np.abs(p_gpu - p_cpu).max() / np.abs(p_cpu).max())
    assert len(h_gpu) == len(h_cpu), (h_gpu, h_cpu)
    rel_hist = max(abs(a - b) for a, b in zip(h_gpu, h_cpu)) / h_cpu[0]
    assert rel_bal <= 1e-9 and rel_hist <= 1e-9, (
        rel_bal, h_gpu, h_cpu)
    say("jw06-balance-vs-cpu", t0,
        f"balance_zonal_state of the JW06 production options at 12 cells x 20 levels "
        f"(nl_solve 4) in f64: on cuda {s_gpu:.2f} s, history {h_gpu}; the balanced state "
        f"against the cpu's rel err {rel_bal:.3e}, history {rel_hist:.3e} (tol 1e-9)")

    # ---- 20: the production grid, balanced on the card, JW06_STEPS f32 steps
    t0 = time.perf_counter()
    model, g64, c64, phys0, history, bal_s = jw06_case(
        tx, tmodel, tw, torch, os.path.join(tmp, "jw06"), JW06_STEPS, "cuda")
    assert history[-1] < 0.02 * history[0], history
    print(f"  JW06 balance on cuda f64 at 48 cells x 24 levels: {bal_s:.2f} s, "
          f"max|residual| {' -> '.join(f'{h:.3e}' for h in history)}", flush=True)
    grid, ctx, state, step = tw.prepare_run(model, phys0, torch.float32, "cuda")
    assert (grid.params.rDim, grid.nl, grid.params.zDim) == (144, 96, 24)
    from scythe_tpu_torch.ops import condensation as cn

    zero_counts(cs, ra, cn)
    state, ms_step = run_steps(torch, tmodel, step, state, JW06_STEPS)
    launches = launched(CS, RA)
    # the analysis twice a step: the del^4 term refits its first Laplacian
    # through the analysis (equations/sphere.py), then the closing analysis
    assert launches == (JW06_STEPS, 2 * JW06_STEPS), launches
    cond_launches = launched(CN, CN_PLAIN)
    assert cond_launches == (JW06_STEPS, 0), cond_launches
    phys = grid.synthesis(state.spec)["val"].cpu().numpy()
    assert phys.shape == (9, 144, 96, 24) and np.isfinite(phys).all()
    r = jw06_readings(tw, g64, c64, phys)
    for k, (lo, hi) in JW06_BANDS.items():
        assert lo < r[k] < hi, (k, r, JW06_BANDS)
    n_k, busy = count_launches(torch, lambda: tmodel.make_scan(step, 10)(state))
    say("jw06-production-path", t0,
        f"MoistEulerSLZ {list(phys.shape)} f32 on cuda from the state balanced on the card, "
        f"{JW06_STEPS} steps of 7.5 s: {1000.0 / ms_step:.2f} steps/s ({ms_step:.4f} ms/step "
        f"by CUDA events) on {card}; column-solve launches {launches[0]} at "
        f"{144 * 96} x 24 (one a step), analysis launches {launches[1]} at [9, 144, 96, 24] "
        f"(two a step: the del^4 refit and the closing analysis), condensation launches "
        f"{cond_launches[0]} (plain chain {cond_launches[1]}); {n_k / 10:.0f} kernel "
        f"launches/step, device busy {busy / 10:.1f} us/step "
        f"(torch.profiler, 10 steps); readings {json.dumps(r)} (bands {JW06_BANDS}); "
        f"balance {bal_s:.2f} s")
    jw = {"steps_per_s": 1000.0 / ms_step, "launches": launches, "balance_s": bal_s,
          "condensation_launches": cond_launches[0],
          "launches_per_step": n_k / 10, "busy_us": busy / 10, "history": history}
    del state, step

    # ---- 21: f32 against f64 on the card after 20 steps
    t0 = time.perf_counter()
    runs = {}
    for dtype in (torch.float32, torch.float64):
        g, _, st, sp = tw.prepare_run(model, phys0, dtype, "cuda")
        runs[dtype] = g.synthesis(tmodel.make_scan(sp, 20)(st).spec)["val"].cpu().numpy()
    rel = per_field_rel(runs[torch.float32], runs[torch.float64])
    checked = [v for v in range(9) if np.abs(runs[torch.float64][v]).max() > 0.0]
    bounds = [JW06_F32_BOUND.get(MOIST3D_VARS[v], 1e-4) for v in range(9)]
    print(f"  JW06 20 steps cuda f32 vs f64 rel err {fmt_rel(rel)}", flush=True)
    assert all(rel[v] <= bounds[v] for v in checked), (rel, bounds)
    say("jw06-parity-f32", t0,
        f"cuda f32 vs cuda f64, 20 steps from the balanced state, rel err per field "
        f"{fmt_rel(rel)} (tol {JW06_F32_BOUND} else 1e-4, on "
        f"{[MOIST3D_VARS[v] for v in checked]})")
    return jw


def member_runner(tx, torch, tmodel, tti, model, dtype, device, n_members):
    """run(ics, n) -> final spectral states: ``n`` steps of every member, one
    batched run under torch.func.vmap (or a plain run for one member), on a
    step built once; also returns the grid."""
    grid = tx.create_grid(model.grid_params, dtype, device=device)
    ctx = tmodel.build_context(model, grid, dtype)
    step = tmodel.build_step(model, grid, ctx, dtype)
    imp_rows = tmodel.imp_history_rows(model)

    def member(n):
        def fn(phys0):
            state = tti.initial_state(grid.analysis(phys0), phys0.shape, dtype,
                                      imp_rows=imp_rows)
            return tmodel.make_scan(step, n)(state).spec
        return fn

    def run(ics, n):
        with torch.no_grad():
            if n_members == 1:
                return member(n)(ics[0])[None]
            return torch.func.vmap(member(n))(ics)

    return grid, run


def slope_rate(torch, run, ics, n_short, n_long):
    """ms a step of ``run`` from the two lengths (host clock after a
    synchronize, best of two), which cancels the set-up of a run."""
    best = {}
    for n in (n_short, n_long, n_short, n_long):
        t0 = time.perf_counter()
        run(ics, n)
        torch.cuda.synchronize()
        best[n] = min(best.get(n, np.inf), time.perf_counter() - t0)
    return 1000.0 * (best[n_long] - best[n_short]) / (n_long - n_short)


def phase_ensembles(tx, tmodel, tti, torch, cs, ra, cb, sh, sio, tmp, card):
    """Phases 22-23: the flagship and the shower as ensembles on the card."""
    # ---- 22: the flagship at full width, 16 members
    t0 = time.perf_counter()
    fm = cb.flagship_model(100, 256)
    g = tx.create_grid(fm.grid_params, torch.float32, device="cuda")
    base = cb.vortex_phys(g)
    ics64 = np.stack([base * (1.0 + i / 100.0) for i in range(FLAGSHIP_MEMBERS)])
    rates, by_name = {}, {}
    for label, n_m in (("ensemble", FLAGSHIP_MEMBERS), ("single", 1)):
        grid, run = member_runner(tx, torch, tmodel, tti, fm, torch.float32, "cuda", n_m)
        ics = torch.as_tensor(ics64[:n_m], dtype=torch.float32, device="cuda")
        run(ics, 2)  # warm-up
        ms = slope_rate(torch, run, ics, 20, 120)
        by_name[label] = launches_per_step(torch, lambda n: run(ics, n), 5, 25)
        out = run(ics, 20)
        assert torch.isfinite(out).all()
        rates[label] = {"ms_step": ms, "member_steps_per_s": n_m * 1000.0 / ms,
                        "launches_per_step": sum(by_name[label].values())}
    ens, one = rates["ensemble"], rates["single"]
    # a step of the batch takes the single step's launches, not one more for
    # each added member: an op that vmap ran member by member would add at
    # least FLAGSHIP_MEMBERS - 1 a step, a loop over members 15x the lot
    diff = {}  # batched minus alone, by kernel name cut to 60 characters
    for k in set(by_name["ensemble"]) | set(by_name["single"]):
        d = by_name["ensemble"].get(k, 0.0) - by_name["single"].get(k, 0.0)
        if d:
            diff[k[:60]] = round(diff.get(k[:60], 0.0) + d, 2)
    rates["launch_diff_by_kernel"] = diff
    assert ens["launches_per_step"] < one["launches_per_step"] + FLAGSHIP_MEMBERS - 1, rates
    # f64: each member against its own single run, 20 steps
    f20 = fm.with_(integration_time=60.0, output_interval=60.0)
    zero_counts(cs, ra)
    _, out64 = tmodel.integrate_ensemble(f20, ics64, dtype=torch.float64, device="cuda")
    fl_launches = launched(CS, RA)
    assert fl_launches == (0, 0), fl_launches
    grid64, run1 = member_runner(tx, torch, tmodel, tti, f20, torch.float64, "cuda", 1)
    rel = 0.0
    for i in range(FLAGSHIP_MEMBERS):
        one_i = grid64.synthesis(run1(torch.as_tensor(ics64[i:i + 1], device="cuda"), 20)[0])
        ref = one_i["val"].cpu().numpy()
        rel = max(rel, float(np.abs(out64[i] - ref).max() / np.abs(ref).max()))
    assert rel <= 1e-12, rel
    say("flagship-ensemble", t0,
        f"{FLAGSHIP_MEMBERS} members of the flagship [6, 300, 256] (scaled 1 + i/100) f32 on "
        f"cuda under torch.func.vmap, by the slope of 20 and 120 steps: "
        f"{ens['member_steps_per_s']:.2f} member-steps/s ({ens['ms_step']:.4f} ms a batched "
        f"step), one member alone {one['member_steps_per_s']:.2f} steps/s "
        f"({one['ms_step']:.4f} ms); kernel launches a step {ens['launches_per_step']:.1f} "
        f"batched vs {one['launches_per_step']:.1f} alone (torch.profiler, 25 - 5 steps, "
        f"per kernel the least of 3; batched minus alone a step by kernel "
        f"{json.dumps(diff, sort_keys=True)}); "
        f"hand-written kernel launches {fl_launches} (none lies on this path); f64 members "
        f"vs their single runs after 20 steps max rel err {rel:.3e} (tol 1e-12) on {card}")

    # ---- 23: the convective shower, 4 members: both kernels once a step
    t0 = time.perf_counter()
    sm = sh.shower_model(os.path.join(tmp, "shower_ensemble"), t_end=20 * 0.25)
    gcpu = tx.create_grid(sm.grid_params, torch.float64, device="cpu")
    phys0 = sio.read_physical_grid(sm.initial_conditions, gcpu)
    ics64 = np.stack([phys0 * (1.0 + i / 100.0) for i in range(SHOWER_MEMBERS)])
    from scythe_tpu_torch.ops import condensation as cn

    outs, launches = {}, {}
    for dtype in (torch.float32, torch.float64):
        zero_counts(cs, ra, cn)
        _, outs[dtype] = tmodel.integrate_ensemble(sm, ics64, dtype=dtype, device="cuda")
        launches[dtype] = launched(CS, RA, CN, CN_PLAIN)
        # the condensation kernel once a step for all members (its vmap
        # rule), the plain chain never
        assert launches[dtype] == (20, 21, 20, 0), launches
    rel = {}
    for dtype in (torch.float32, torch.float64):
        grid1, run1 = member_runner(tx, torch, tmodel, tti, sm, dtype, "cuda", 1)
        worst = np.zeros(9)
        for i in range(SHOWER_MEMBERS):
            spec = run1(torch.as_tensor(ics64[i:i + 1], dtype=dtype, device="cuda"), 20)[0]
            ref = grid1.synthesis(spec)["val"].cpu().numpy()
            worst = np.maximum(worst, per_field_rel(outs[dtype][i], ref.astype(np.float64)))
        rel[dtype] = worst
        print(f"  shower members vs single runs {dtype}: {fmt_rel(worst)}", flush=True)
    assert np.isfinite(outs[torch.float32]).all()
    assert rel[torch.float64].max() <= 1e-12, rel
    assert rel[torch.float32].max() <= SHOWER_MEMBER_F32_BOUND, rel
    say("shower-ensemble", t0,
        f"{SHOWER_MEMBERS} members of the convective shower [9, 144, 16, 32] on cuda through "
        f"integrate_ensemble, 20 steps: column-solve launches {launches[torch.float32][0]} "
        f"at {SHOWER_MEMBERS * 2304} x 32, analysis launches {launches[torch.float32][1]} at "
        f"[{SHOWER_MEMBERS * 9}, 144, 16, 32] (one a step for all members, and the initial "
        f"analysis), condensation launches {launches[torch.float32][2]} (plain chain "
        f"{launches[torch.float32][3]}); members vs their single runs, max rel err per field: f64 "
        f"{rel[torch.float64].max():.3e} (tol 1e-12), f32 {fmt_rel(rel[torch.float32])} "
        f"(tol {SHOWER_MEMBER_F32_BOUND})")
    return {"flagship": rates, "flagship_launches": fl_launches,
            "shower_launches": launches[torch.float32]}


def phase_kernel_gradients(tx, tti, torch, cs, ra, columns):
    """Phase 24: each kernel's backward and jvp on the card against autograd
    and torch.func.jvp of its plain version, and timed in turns."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    lines, times = [], {}
    jvp = torch.func.jvp
    for label, ncols, nz, src in (("9216x48", 9216, 48, "moist3d"),
                                  ("13824x24", 13824, 24, "jw06")):
        zmax, ts, bar, _ = columns[src]
        ops = {dt: tti.build_semiimplicit_ops(nz, 0.0, zmax, None, bar, ts, dt, "cuda").solve
               for dt in (torch.float32, torch.float64)}
        x, w, gw, gx, xt, wt = (torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
                                for _ in range(6))
        m64 = ops[torch.float64].M
        gcat = torch.cat([gw, gx], dim=1)
        ref_grad = gcat @ m64  # [x* | w*] cotangents of the f64 plain map
        ref_jvp = torch.cat([xt, wt], dim=1) @ m64.T
        errs = {}
        for dt, op in ops.items():
            xs, ws = (t.to(dt).requires_grad_(True) for t in (x, w))
            cot = tuple(t.to(dt) for t in (gw, gx))
            out = cs.apply_column_operator(xs, ws, op)
            assert type(out[0].grad_fn).__name__ == "ColumnSolveFnBackward"
            got = torch.cat(torch.autograd.grad(out, (xs, ws), cot), dim=1)
            plain = torch.cat(torch.autograd.grad(
                cs.apply_column_operator_plain(xs, ws, op.M), (xs, ws), cot), dim=1)
            _, tang = jvp(lambda a, b: cs.apply_column_operator(a, b, op),
                          (x.to(dt), w.to(dt)), (xt.to(dt), wt.to(dt)))
            _, tang_p = jvp(lambda a, b: cs.apply_column_operator_plain(a, b, op.M),
                            (x.to(dt), w.to(dt)), (xt.to(dt), wt.to(dt)))
            scale_b, scale_j = float(ref_grad.abs().max()), float(ref_jvp.abs().max())
            errs[dt] = {
                "backward": float((got.double() - ref_grad).abs().max()) / scale_b,
                "backward_plain": float((plain.double() - ref_grad).abs().max()) / scale_b,
                "jvp": float((torch.cat(tang, 1).double() - ref_jvp).abs().max()) / scale_j,
                "jvp_plain": float((torch.cat(tang_p, 1).double() - ref_jvp).abs().max())
                / scale_j,
            }
        e64, e32 = errs[torch.float64], errs[torch.float32]
        assert e64["backward"] <= 1e-12 and e64["jvp"] <= 1e-12, (label, e64)
        for k in ("backward", "jvp"):
            assert e32[k] <= 1e-5 and e32[k] <= 4.0 * e32[k + "_plain"], (label, k, e32)
        # timed in turns, f32: the backward launch (M^T) against autograd of the
        # plain map and the library call g [M]; the jvp (primal and tangent)
        op = ops[torch.float32]
        x32, w32, gw32, gx32, xt32, wt32 = (t.float() for t in (x, w, gw, gx, xt, wt))
        xs = x32.clone().requires_grad_(True)
        ws = w32.clone().requires_grad_(True)
        plain_out = cs.apply_column_operator_plain(xs, ws, op.M)
        g32 = gcat.float()
        k_b = lambda: cs.ColumnSolveFn.apply(gw32, gx32, op.M.T, op.packed_T, op.M,  # noqa: E731
                                             op.packed, True, False)
        p_b = lambda: torch.autograd.grad(plain_out, (xs, ws), (gw32, gx32),  # noqa: E731
                                          retain_graph=True)
        l_b = lambda: torch.matmul(g32, op.M)  # noqa: E731
        k_j = lambda: jvp(lambda a, b: cs.apply_column_operator(a, b, op),  # noqa: E731
                          (x32, w32), (xt32, wt32))
        p_j = lambda: jvp(lambda a, b: cs.apply_column_operator_plain(a, b, op.M),  # noqa: E731
                          (x32, w32), (xt32, wt32))
        # the jvp's library call: one matmul of the stacked primal and tangent
        stacked = torch.cat([torch.cat([x32, w32], 1), torch.cat([xt32, wt32], 1)], 0)
        m_t = op.M.T
        l_j = lambda: torch.matmul(stacked, m_t)  # noqa: E731
        kb, pb, lb = in_turns(p_b, k_b, 100, timer=queued_time_ms, library=l_b)
        kj, pj, lj = in_turns(p_j, k_j, 100, timer=queued_time_ms, library=l_j)
        bound_b = column_solve_bound(ncols, nz, "float32")
        bound_j = column_solve_bound(2 * ncols, nz, "float32")
        times[f"column_solve {label}"] = {
            "backward": (min(kb), min(pb), min(lb)) + bound_b,
            "jvp": (min(kj), min(pj), min(lj)) + bound_j}
        lines.append(
            f"column solve {label}: backward rel err f64 {e64['backward']:.2e}, f32 "
            f"{e32['backward']:.2e} (plain f32 {e32['backward_plain']:.2e}); jvp f64 "
            f"{e64['jvp']:.2e}, f32 {e32['jvp']:.2e} (plain f32 {e32['jvp_plain']:.2e}); "
            f"device ms backward kernel {min(kb):.5f} vs autograd of the plain map "
            f"{min(pb):.5f} vs library {min(lb):.5f} (bound {bound_b[0]:.5f} {bound_b[1]}); "
            f"jvp kernel {min(kj):.5f} vs plain {min(pj):.5f} vs library (one matmul of the "
            f"stacked primal and tangent) {min(lj):.5f} (bound {bound_j[0]:.5f})")

    for name in ("moist3d", "jw06_production"):
        nv = ANALYSIS_SHAPES[name][0]
        g64, ops64 = analysis_grid(tx, torch, name, torch.float64)
        _, ops32 = analysis_grid(tx, torch, name, torch.float32)
        B = g64.params.b_rDim
        x = torch.from_numpy(rng.normal(size=(nv,) + g64.spatial_shape)).cuda()
        xt = torch.from_numpy(rng.normal(size=tuple(x.shape))).cuda()
        gs = torch.from_numpy(rng.normal(size=(nv, B) + g64.spatial_shape[1:])).cuda()
        xr = x.clone().requires_grad_(True)
        ref_grad = torch.autograd.grad(ra.rlz_analysis_plain(xr, *ops64), xr, gs)[0]
        ref_jvp = ra.rlz_analysis_plain(xt, *ops64)
        errs = {}
        for dt, ops in ((torch.float64, ops64), (torch.float32, ops32)):
            xs = x.to(dt).requires_grad_(True)
            out = ra.rlz_analysis(xs, *ops)
            assert type(out.grad_fn).__name__ == "RLZAnalysisFnBackward"
            got = torch.autograd.grad(out, xs, gs.to(dt))[0]
            plain = torch.autograd.grad(ra.rlz_analysis_plain(xs, *ops), xs, gs.to(dt))[0]
            _, tang = jvp(lambda p: ra.rlz_analysis(p, *ops), (x.to(dt),), (xt.to(dt),))
            _, tang_p = jvp(lambda p: ra.rlz_analysis_plain(p, *ops), (x.to(dt),),
                            (xt.to(dt),))
            sb, sj = float(ref_grad.abs().max()), float(ref_jvp.abs().max())
            errs[dt] = {"backward": float((got.double() - ref_grad).abs().max()) / sb,
                        "backward_plain": float((plain.double() - ref_grad).abs().max()) / sb,
                        "jvp": float((tang.double() - ref_jvp).abs().max()) / sj,
                        "jvp_plain": float((tang_p.double() - ref_jvp).abs().max()) / sj}
        e64, e32 = errs[torch.float64], errs[torch.float32]
        assert e64["backward"] <= 1e-12 and e64["jvp"] <= 1e-12, (name, e64)
        for k in ("backward", "jvp"):
            assert e32[k] <= 1e-5 and e32[k] <= 4.0 * e32[k + "_plain"], (name, k, e32)
        x32, xt32, g32 = x.float(), xt.float(), gs.float()
        xs = x32.clone().requires_grad_(True)
        plain_out = ra.rlz_analysis_plain(xs, *ops32)
        k_b = lambda: ra.rlz_analysis_transposed(g32, *ops32)  # noqa: E731
        p_b = lambda: torch.autograd.grad(plain_out, xs, g32, retain_graph=True)  # noqa: E731
        k_j = lambda: jvp(lambda p: ra.rlz_analysis(p, *ops32), (x32,), (xt32,))  # noqa: E731
        p_j = lambda: jvp(lambda p: ra.rlz_analysis_plain(p, *ops32), (x32,),  # noqa: E731
                          (xt32,))
        # the library calls: one torch.einsum over the transposed chain (the
        # backward), one over the chain with primal and tangent stacked on the
        # variable axis (the jvp), TF32 off
        la, mask, an, az = ops32
        stack = lambda o: torch.cat([o, o], 0) if o.shape[0] > 1 else o  # noqa: E731
        x2, an2, az2 = torch.cat([x32, xt32], 0), stack(an), stack(az)
        l_b = lambda: torch.einsum("vbkK,kl,rk,vbr,vKz->vrlz", g32, la, mask, an, az)  # noqa: E731
        l_j = analysis_library(torch, x2, la, mask, an2, az2)
        lib_b = l_b()
        assert float((lib_b.double() - ref_grad).abs().max()) <= 1e-4 * float(
            ref_grad.abs().max()), (name, "the backward's library call")
        kb, pb, lb = in_turns(p_b, k_b, 100, timer=queued_time_ms, library=l_b)
        kj, pj, lj = in_turns(p_j, k_j, 100, timer=queued_time_ms, library=l_j)
        shape = tuple(x.shape)
        bound_b = analysis_bound(shape, B)
        bound_j = analysis_bound((2 * shape[0],) + shape[1:], B)
        times[f"rlz_analysis {name}"] = {"backward": (min(kb), min(pb), min(lb)) + bound_b,
                                         "jvp": (min(kj), min(pj), min(lj)) + bound_j}
        lines.append(
            f"analysis {name} {list(shape)}: backward (the transposed einsum chain) rel err "
            f"f64 {e64['backward']:.2e}, f32 {e32['backward']:.2e} (plain f32 "
            f"{e32['backward_plain']:.2e}); jvp f64 {e64['jvp']:.2e}, f32 {e32['jvp']:.2e} "
            f"(plain f32 {e32['jvp_plain']:.2e}); device ms backward {min(kb):.5f} vs "
            f"autograd of the plain chain {min(pb):.5f} vs library (one einsum over the "
            f"transposed chain) {min(lb):.5f} (bound {bound_b[0]:.5f} {bound_b[1]}); jvp "
            f"kernel {min(kj):.5f} vs plain {min(pj):.5f} vs library (one einsum, primal and "
            f"tangent stacked) {min(lj):.5f} (bound {bound_j[0]:.5f})")
    for ln in lines:
        print("  " + ln, flush=True)
    say("kernel-backward-and-jvp", t0,
        "against torch.autograd and torch.func.jvp of the plain versions (f64 1e-12, f32 "
        "1e-5 and <= 4x the plain f32's error); 100 calls a run, min device ms: "
        + "; ".join(f"{k} backward {v['backward'][0]:.5f}, jvp {v['jvp'][0]:.5f}"
                    for k, v in times.items()))
    return times


def fit_case(tx, torch, cd, adjoint, tmp, device):
    """(fitted parameters, loss history) of fit_parameters on
    calibrate_drag's case in f64 on ``device``, 3 Adam iterations."""
    sim, grid, _ = tx.make_simulator(cd.drag_model(out_dir=os.path.join(tmp, f"drag_{device}")),
                                     torch.float64, device=device)
    p0 = cd.rankine_phys(grid)
    with torch.no_grad():
        obs = sim({"Cd": cd.CD_TRUE}, p0)[1:3]
    return adjoint.fit_parameters(sim, {"Cd": cd.CD_INIT}, p0, obs, steps=3,
                                  learning_rate=0.08, obs_slice=np.s_[1:3])


def phase_gradients(tx, torch, cs, ra, sio, tmp, cd, adjoint, refs):
    """Phases 25-26: a whole gradient through both kernels on the card, and
    fit_parameters on the card, each against the CPU (fit_parameters' from
    ``refs``, CpuReferences)."""
    # ---- 25: make_simulator on the SLZ test grid, 20 semi-implicit steps
    t0 = time.perf_counter()
    zm = slz_test_model(tx, tmp, 20, thermal=True)
    gcpu = tx.create_grid(zm.grid_params, torch.float64, device="cpu")
    phys0 = sio.read_physical_grid(zm.initial_conditions, gcpu)
    # rain everywhere: at exactly zero rain the warm-rain terms (q_r**0.875,
    # rho_r**0.1364) have no derivative, in both packages alike
    phys0[7] = 1.0e-5
    wts = np.random.default_rng(9).normal(size=phys0.shape)
    from scythe_tpu_torch.ops import condensation as cn

    grads, launches, cond = {}, None, None
    for dev in ("cuda", "cpu"):
        sim, _, _ = tx.make_simulator(zm, torch.float64, device=dev)
        w_t = torch.as_tensor(wts, device=dev)
        p0 = torch.as_tensor(phys0, device=dev).requires_grad_(True)
        K = torch.tensor(100.0, dtype=torch.float64, device=dev, requires_grad=True)
        zero_counts(cs, ra, cn)
        loss = torch.sum(w_t * sim({"K": K}, p0))
        gp0, gK = torch.autograd.grad(loss, (p0, K))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = launched(CS, CS_BACK, RA)
            cond = launched(CN, CN_PLAIN)
            with torch.no_grad():
                lo, hi = (float(torch.sum(w_t * sim({"K": 100.0 + e}, p0)))
                          for e in (-1e-2, 1e-2))
            fd = (hi - lo) / 2e-2
        grads[dev] = (gp0.cpu().numpy(), float(gK))
    (gp_g, gK_g), (gp_c, gK_c) = grads["cuda"], grads["cpu"]
    rel_p = float(np.abs(gp_g - gp_c).max() / np.abs(gp_c).max())
    rel_K = abs(gK_g - gK_c) / abs(gK_c)
    rel_fd = abs(gK_g - fd) / abs(fd)
    assert np.isfinite(gp_g).all() and rel_p <= 1e-9 and rel_K <= 1e-9, (rel_p, rel_K)
    assert rel_fd <= 1e-6, (gK_g, fd)
    # forward 20 + the remat's 20 again; 20 backward launches (M^T); the
    # analysis once more for phys0; its backward is the einsum chain
    assert launches == (40, 20, 41), launches
    # the condensation kernel in every forward and remat step, as the column
    # solve; its backward the plain chain's vjp, once a step
    assert cond == (40, 20), cond
    say("slz-gradient", t0,
        f"make_simulator on the SLZ test grid (MoistEulerSLZ [9, 36, 32, 24], semi-implicit), "
        f"20 f64 steps, d(sum w * phys_20)/d(phys0, K) on cuda against the cpu: rel err "
        f"phys0 {rel_p:.3e}, K {rel_K:.3e} (tol 1e-9); K against a central difference "
        f"(+-0.01) {rel_fd:.3e} (tol 1e-6); launches (column solve forward, backward, analysis) "
        f"{launches}, condensation kernel {cond[0]} and its plain chain in the backward "
        f"{cond[1]}")

    # ---- 26: fit_parameters on the card, calibrate_drag's case
    t0 = time.perf_counter()
    f_g, h_g = fit_case(tx, torch, cd, adjoint, tmp, "cuda")
    ref = refs.get("fit")
    f_c, h_c = {"Cd": float(ref["Cd"])}, list(ref["history"])
    rel_h = max(abs(a - b) / abs(b) for a, b in zip(h_g, h_c))
    rel_cd = abs(f_g["Cd"] - f_c["Cd"]) / f_c["Cd"]
    assert h_g[-1] < h_g[0] and rel_h <= 1e-9 and rel_cd <= 1e-9, (h_g, h_c, f_g, f_c)
    say("fit-parameters", t0,
        f"fit_parameters on calibrate_drag's case (Williams2013_slabTCBL, 100 cells, 720 "
        f"steps) f64, 3 Adam iterations on cuda: losses {h_g}, Cd {f_g['Cd']:.6e}; against "
        f"the cpu rel err losses {rel_h:.3e}, Cd {rel_cd:.3e} (tol 1e-9)")
    return {"launches": launches}


# ---- the compensated (bf16x3) numerics: the JAX package's TPU production
# mode.  (label, ncols, nz, reference state) of the comp column solve's
# timed calls: moist3d's, the TC's, the shower's and JW06's shapes
CS_COMP_TIMED = (("9216x48", 9216, 48, "moist3d"), ("1200x24", 1200, 24, "moist3d"),
                 ("2304x32", 2304, 32, "shower"), ("13824x24", 13824, 24, "jw06"))
CS_COMP_NZ = (13, 24, 48, 128)
CS_COMP_NCOLS = (37, 9216)
# each comp kernel against its plain version on the same inputs, per output
# of its max: the same bf16 products summed in another order (the CPU
# emulations of the kernels' decompositions, tests/test_torch_column_solve.py
# and tests/test_torch_rlz_analysis.py, measure up to 1e-6 and 3.4e-6; the
# card up to 1.68e-6 and 3.27e-6, and the analysis' tensor-core body up to
# 3.9e-6, an H100 80GB HBM3 at 700 W); and
# its error against f64 within COMP_ERR_RATIO of its plain version's, from
# below too, so that a body on any other arithmetic than bf16x3 fails: plain
# f32 is ~1e-5 of max from bf16x3 and ~100x nearer f64, f32 products by
# O_hi + O_lo (the activations left unsplit) 0.5x its error on the CPU; the
# kernels measured 0.96x to 1.07x on an H100 80GB HBM3 at 700 W (the
# analysis' tensor-core body 0.90x to 1.19x)
COMP_DIRECT = {"column_solve": 4e-6, "rlz_analysis": 1e-5}
COMP_ERR_RATIO = (0.75, 4.0)
# the comp analysis at phase 4's timed shapes
ANALYSIS_COMP_SHAPES = ("moist3d", "tc", "transform", "shower", "slz_test",
                        "jw06_production")
# compensated f32 (deriv_single on) against plain f64 after 20 full-width
# moist3d steps on the card, per field: about 3x the same comparison on the
# CPU, where the derivative slots' single bf16 pass leaves 1.0e-3 to 4.1e-3
# of a field's max (plain f32: 1.7e-6 to 1.2e-5; s 7.0e-5, xi 1.06e-3, mu
# 1.03e-3, u 4.14e-3, v 2.40e-3, w 2.00e-3, mu_c 1.26e-3, qss 1.17e-3;
# tools/torch_comp_reference.py on the card machine's CPU; PERF.md)
COMP_M3D_BOUND = {"s": 2e-4, "u": 1.25e-2, "v": 7.5e-3, "w": 6e-3, "mu_c": 4e-3}
COMP_M3D_DEFAULT_BOUND = 3.5e-3
# the factored DFT: tools/profile_factored.py's RL grid (64 cells, 6 vars)
FACTORED_CELLS = 64
FACTORED_TIMED_NL = (1024, 2048, 4096)


def column_solve_comp_bound(ncols, nz):
    """The comp column solve: x*, w* read, w, xi written, M's bf16 hi and lo
    read once (the size of one f32 M); 2 ncols (2nz)^2 FLOP of products, each
    three bf16 passes."""
    return bound_ms((4 * ncols * nz + 4 * nz * nz) * 4,
                    2 * ncols * (2 * nz) ** 2, "bf16x3 products")


def analysis_comp_bound(shape, b_rdim):
    """The comp RLZ analysis: as analysis_bound, each operator's bf16 hi and
    lo read once (an f32 operator's bytes), each product three bf16
    passes."""
    V, R, L, Z = shape
    B = b_rdim
    return bound_ms(
        4 * (V * R * L * Z + L * L + R * L + V * B * R + V * Z * Z + V * B * L * Z),
        2 * V * R * L * L * Z + 2 * V * B * R * L * Z + 2 * V * B * L * Z * Z,
        "bf16x3 products")


def comp_stage(torch, cs, o64, x, w, stage):
    """The comp operator of a stage (the f64 M of o64 split), the f64 chain's
    (w, xi) and the five f32 operators with the stage's ts'."""
    ts_term = 0.5 * o64.ts if stage == "t1" else 1.25 * o64.ts
    s64 = o64.solve_t1 if stage == "t1" else o64.solve
    ops64 = (o64.col_filter, o64.col_deriv,
             o64.hinv_t1 if stage == "t1" else o64.hinv, o64.synth, o64.dsynth)
    op = cs.column_operator(s64.M, torch.float32, "cuda", "comp")
    ref = cs.fused_column_solve_plain(x, w, *ops64, ts_term, o64.pxi_bar)
    return op, ref, tuple(o.float() for o in ops64), ts_term


def ptxas_of(log, word):
    """ptxas' registers, spills and shared memory of the kernels whose
    mangled names hold ``word``, from the build's log."""
    lines, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            on = word in ln
            if on and "Compiling entry function" in ln:
                lines.append(ln.split("'")[1] if "'" in ln else ln.strip())
        elif on and ("registers" in ln or "spill" in ln):
            lines.append(ln.split(":", 1)[-1].strip())
    return lines


def phase_comp_kernels(tx, tti, torch, cs, ra, columns):
    """The comp (bf16x3) kernels against their plain versions and f64, then
    timed; returns ({"column_solve" | "rlz_analysis": max_abs_err against the
    plain version at moist3d, and "..._vs_f64" against f64}, {label: (ms, plain_ms, library_ms, bound_ms, bound_by)} of the
    column solve, {name: (ms, plain_ms, bound_ms, bound_by, library_ms)} of
    the analysis), device times."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    zmax, ts, pxi, _ = columns["moist3d"]
    shapes = [(ncols, nz, "moist3d") for nz in CS_COMP_NZ for ncols in CS_COMP_NCOLS]
    shapes += [(ncols, nz, src) for _, ncols, nz, src in CS_COMP_TIMED]
    worst, lines, errs = {}, [], {}
    for ncols, nz, src in shapes:
        zmax_, ts_, bar, _ = columns[src]
        o64 = tti.build_semiimplicit_ops(nz, 0.0, zmax_, None, bar, ts_, torch.float64, "cuda")
        x = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        w = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        x32, w32 = x.float(), w.float()
        for stage in ("t1", "ab"):
            op, ref, ops32, ts_term = comp_stage(torch, cs, o64, x, w, stage)
            k, kb = (cs.apply_column_operator(x32, w32, op) for _ in range(2))
            plain = cs.apply_column_operator_comp_plain(x32, w32, op.M)
            counterpart = cs.fused_column_solve(x32, w32, *ops32, ts_term, bar)
            torch.cuda.synchronize()
            where = (ncols, nz, src, stage)
            for a, b in zip(k, kb):
                assert torch.isfinite(a).all() and torch.equal(a, b), (where, "not repeatable")
            rk, ek = rel_errs(k, ref)
            rp, _ = rel_errs(plain, ref)
            rc, _ = rel_errs(counterpart, ref)
            rd, ed = rel_errs(k, tuple(p.double() for p in plain))
            lo, hi = COMP_ERR_RATIO
            assert rd <= COMP_DIRECT["column_solve"], (where, "kernel vs its plain version", rd)
            assert lo * rp <= rk <= hi * rp and rk <= 1e-4, (where, "comp kernel", rk,
                                                              "plain comp", rp)
            assert lo * rp <= rc <= hi * rp and rc <= 1e-4, (where, "counterpart", rc, rp)
            for key, v in (("kernel", rk), ("plain", rp), ("ratio", rk / rp),
                           ("counterpart", rc), ("direct", rd)):
                worst[key] = max(worst.get(key, 0.0), v)
            worst["least_ratio"] = min(worst.get("least_ratio", hi), rk / rp)
            if (ncols, nz, stage) == (9216, 48, "ab"):
                errs["column_solve"], errs["column_solve_vs_f64"] = ed, ek
        lines.append(f"{ncols}x{nz}")
    say("comp-column-solve-vs-plain", t0,
        f"mode='comp' (bf16 split of the composed M and of [x* | w*]), {lines} x 2 stages: "
        f"kernel against its plain version (the torch bf16x3 map) on the same inputs, max "
        f"rel err {worst['direct']:.3e} (tol {COMP_DIRECT['column_solve']}); max rel err "
        f"against the f64 chain: kernel {worst['kernel']:.3e}, plain version "
        f"{worst['plain']:.3e}, ratio kernel / plain {worst['least_ratio']:.3f} to "
        f"{worst['ratio']:.3f} (tol {COMP_ERR_RATIO}, and 1e-4); the counterpart "
        f"fused_column_solve at its default mode {worst['counterpart']:.3e}; two calls "
        f"bitwise equal")

    from scythe_tpu_torch.ops import _build

    log = _build.load().log
    ptx = ptxas_of(log, "column_solve_comp_kernel") if log else ["library reused, not built"]
    print("  comp column-solve body (ptxas): " + " | ".join(ptx), flush=True)
    t0 = time.perf_counter()
    cs_times = {}
    for label, ncols, nz, src in CS_COMP_TIMED:
        zmax_, ts_, bar, _ = columns[src]
        o64 = tti.build_semiimplicit_ops(nz, 0.0, zmax_, None, bar, ts_, torch.float64, "cuda")
        x64 = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        w64 = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        op, ref, _, _ = comp_stage(torch, cs, o64, x64, w64, "ab")
        x, w = x64.float(), w64.float()
        xw = torch.cat([x, w], dim=1).contiguous()
        m_t = op.M.T
        plain = lambda: cs.apply_column_operator_comp_plain(x, w, op.M)  # noqa: E731
        kernel = lambda: cs.apply_column_operator(x, w, op)  # noqa: E731
        library = lambda: torch.matmul(xw, m_t)  # noqa: E731
        lib_out = library()
        err = {"kernel": rel_errs(kernel(), ref)[0], "plain": rel_errs(plain(), ref)[0],
               "library": rel_errs((lib_out[:, :nz], lib_out[:, nz:]), ref)[0]}
        kt, pt, lt = in_turns(plain, kernel, 200, timer=queued_time_ms, library=library)
        kb, pb, lb = in_turns(plain, kernel, 200, library=library)
        bound, by = column_solve_comp_bound(ncols, nz)
        cs_times[label] = (min(kt), min(pt), min(lt), bound, by)
        pc = cs.plan_comp(ncols, nz)
        print(f"  comp column solve {label}: {pc}, modelled {cs.comp_cost_us(ncols, nz, pc):.3f} "
              f"us; device time kernel {kt} ms, plain {pt} ms, "
              f"library (torch.matmul in true f32) {lt} ms; back to back kernel {kb} ms, plain "
              f"{pb} ms, library {lb} ms; bound {bound:.5f} ms ({by}), kernel at "
              f"{100.0 * bound / min(kt):.1f}% of it; rel err against the f64 chain: kernel "
              f"{err['kernel']:.3e}, plain {err['plain']:.3e}, library {err['library']:.3e}",
              flush=True)
    say("comp-column-solve-timing", t0,
        "200 calls a run, min device ms kernel vs plain (torch bf16x3) vs library "
        "(torch.matmul in true f32: no single PyTorch call computes bf16x3 with an f32 "
        "output) (bound, share): "
        + ", ".join(f"{k} {a:.5f} vs {b:.5f} vs {c:.5f} ({d:.5f} {e}, {100.0 * d / a:.1f}%)"
                    for k, (a, b, c, d, e) in cs_times.items()))

    t0 = time.perf_counter()
    lines = []
    ra_times = {}
    for name in ANALYSIS_COMP_SHAPES:
        nv = ANALYSIS_SHAPES[name][0]
        params = analysis_params(tx, name)
        g64 = tx.create_grid(params, torch.float64, device="cuda")
        gc = tx.create_grid(params, torch.float32, matmul="compensated", device="cuda")
        assert gc.comp and gc.l_fact is None
        ops64 = (g64.l_analysis, g64.ring_mask, g64.analysis_r, g64.analysis_z)
        opsc = (gc.l_analysis, gc.ring_mask, gc.analysis_r, gc.analysis_z)
        x = torch.from_numpy(rng.normal(size=(nv,) + g64.spatial_shape)).cuda()
        x32 = x.float()
        ref = ra.rlz_analysis_plain(x, *ops64)
        plain = ra.rlz_analysis_comp_plain(x32, *opsc)
        k, kb = (ra.rlz_analysis(x32, *opsc, mode="comp") for _ in range(2))
        via_grid = gc.analysis(x32)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        ek = float((k.double() - ref).abs().max())
        ep = float((plain.double() - ref).abs().max())
        ed = float((k.double() - plain.double()).abs().max())
        lo, hi = COMP_ERR_RATIO
        assert torch.isfinite(k).all() and torch.equal(k, kb), (name, "not repeatable")
        assert torch.equal(via_grid, k), (name, "Grid.analysis is not the comp kernel")
        assert ed <= COMP_DIRECT["rlz_analysis"] * scale, (name, "vs plain", ed / scale)
        assert lo * ep <= ek <= hi * ep and ek <= 1e-4 * scale, (name, ek / scale, ep / scale)
        if name == "moist3d":
            errs["rlz_analysis"], errs["rlz_analysis_vs_f64"] = ed, ek
        pc = ra.plan(x.shape, g64.params.b_rDim, torch.float32, "comp")
        lines.append(f"{name} {g64.geometry} {list(x.shape)}: rel err against its plain "
                     f"version {ed / scale:.2e}; against f64 kernel {ek / scale:.2e}, plain comp "
                     f"{ep / scale:.2e} ({ek / ep:.2f}x); {pc} {pc.ctas} blocks")
        plain_fn = lambda: ra.rlz_analysis_comp_plain(x32, *opsc)  # noqa: E731
        kernel_fn = lambda: ra.rlz_analysis(x32, *opsc, mode="comp")  # noqa: E731
        # the library call on the unsplit operators O_hi + O_lo, in true f32
        library = analysis_library(torch, x32, ra._unsplit(gc.l_analysis), gc.ring_mask,
                                   ra._unsplit(gc.analysis_r), ra._unsplit(gc.analysis_z))
        el = float((library().double() - ref).abs().max())
        kt, pt, lt = in_turns(plain_fn, kernel_fn, 100, timer=queued_time_ms, library=library)
        bound, by = analysis_comp_bound(tuple(x.shape), g64.params.b_rDim)
        ra_times[name] = (min(kt), min(pt), bound, by, min(lt))
        print(f"  comp analysis {name} {list(x.shape)}: device time kernel {kt} ms, plain "
              f"{pt} ms, library (one torch.einsum on O_hi + O_lo in true f32) {lt} ms; "
              f"bound {bound:.5f} ms ({by}), kernel at {100.0 * bound / min(kt):.1f}% of it; "
              f"library rel err against f64 {el / scale:.2e}", flush=True)
    say("comp-analysis-vs-plain-and-timing", t0,
        f"mode='comp' on compensated grids: the kernel within "
        f"{COMP_DIRECT['rlz_analysis']} of max|ref| of its plain comp chain on the same "
        f"inputs; against the f64 plain chain its error {COMP_ERR_RATIO}x the plain comp "
        f"chain's and <= 1e-4 of max|ref|; two calls bitwise equal, Grid.analysis equal to "
        f"it; 100 calls a run, min device ms kernel vs plain vs library (bound): "
        + ", ".join(f"{k} {t[0]:.5f} vs {t[1]:.5f} vs {t[4]:.5f} ({t[2]:.5f} {t[3]})"
                    for k, t in ra_times.items()) + " | " + " | ".join(lines))
    return errs, cs_times, ra_times


def phase_comp_moist3d(tx, tmodel, tti, torch, cs, ra, tmp, card, out_dir):
    """The slice's path: moist3d at full width on a compensated grid
    (deriv_single auto: on), 120 steps through integrate_model (initialize,
    build_context, build_step, run_loop) with its launches counted; steps/s,
    launches and device busy a step beside the plain f32 run; comp f32 against
    plain f64 after 20 steps; then fused_column_solve at its default (comp) on
    the final xi and w columns of the 120-step run, its launches counted.
    Returns a dict for the closing line and the kernels line."""
    t0 = time.perf_counter()
    model = moist3d(tx, tmp, n_steps=120, out_every=60, name="moist3d_comp")
    zero_counts(cs, ra)
    with compensated_grids():
        grid, phys = tx.integrate_model(model, dtype=torch.float32, device="cuda")
    launches = {"column_solve": launched(CS), "column_solve_comp": launched(CS_COMP),
                "rlz_analysis": launched(RA), "rlz_analysis_comp": launched(RA_COMP)}
    assert grid.comp and grid.fast and grid.l_fact is None
    assert launches == {"column_solve": 120, "column_solve_comp": 0, "rlz_analysis": 0,
                        "rlz_analysis_comp": 121}, launches
    assert phys.shape == (9, 144, 64, 48) and np.isfinite(phys).all()
    wmax = float(phys[MOIST3D_VARS.index("w")].max())
    assert wmax > 0.01, wmax
    outs = sorted(f for f in os.listdir(model.output_dir) if f.startswith("physical_out_"))
    assert len(outs) == 3, outs
    say("comp-moist3d-path", t0,
        f"integrate_model moist3d f32 on cuda, compensated grids (deriv_single auto: "
        f"fast {grid.fast}), 120 steps: launches {json.dumps(launches)}, all fields finite, "
        f"w.max {wmax:.4f} m/s, outputs {outs}")

    t0 = time.perf_counter()
    runs = {}
    for mode in ("plain", "comp", "comp", "plain"):
        ms_step, host_sps, state, step = time_steps(torch, tmodel, model, 100, mode == "comp")
        runs.setdefault(mode, []).append(1000.0 / ms_step)
        if len(runs[mode]) == 2:
            label = f"moist3d_{mode}"
            busy, wall, nk, solve, gemm = profile_steps(
                torch, state, step, card, label, os.path.join(out_dir, f"{label}_profile.txt"))
            runs[mode + "_profile"] = {"busy_us": busy, "wall_us": wall,
                                       "launches_per_step": nk, "gemm_us": gemm}
        del state, step
    res = {"launches": launches, "steps_per_s": runs["comp"],
           "plain_steps_per_s": runs["plain"], "profile": runs["comp_profile"],
           "plain_profile": runs["plain_profile"]}
    say("comp-moist3d-steps-per-second", t0,
        f"100 steps after 10 warm-up each, in turns plain, comp, comp, plain: steps/s comp "
        f"{runs['comp']}, plain f32 {runs['plain']} on {card}; profile of 10 steps "
        f"(device busy us/step, launches/step, matrix products us/step): comp "
        f"{json.dumps(runs['comp_profile'])}, plain {json.dumps(runs['plain_profile'])}; "
        f"tables in chiprun_out/moist3d_{{comp,plain}}_profile.txt")

    t0 = time.perf_counter()
    m20 = moist3d(tx, tmp, n_steps=20, out_every=20, name="moist3d_comp_20")
    with compensated_grids():
        _, pc = tx.integrate_model(m20, dtype=torch.float32, device="cuda",
                                   write_outputs=False)
    _, p64 = tx.integrate_model(m20, dtype=torch.float64, device="cuda", write_outputs=False)
    rel = per_field_rel(pc, p64)
    checked = [v for v in range(9) if np.abs(p64[v]).max() > 0.0]
    bounds = [COMP_M3D_BOUND.get(n, COMP_M3D_DEFAULT_BOUND) for n in MOIST3D_VARS]
    assert all(rel[v] <= bounds[v] for v in checked), (rel, bounds)
    res["comp_vs_f64_20_steps"] = dict(zip(MOIST3D_VARS, rel))
    say("comp-moist3d-vs-f64", t0,
        f"20 full-width steps, cuda compensated f32 vs cuda plain f64, rel err per field "
        f"{fmt_rel(rel)} (tol {COMP_M3D_BOUND} else {COMP_M3D_DEFAULT_BOUND}, on "
        f"{[MOIST3D_VARS[v] for v in checked]})")

    # fused_column_solve at its default mode (comp) on the run's own columns:
    # the comp column solve's path; the counts reset just before it
    t0 = time.perf_counter()
    xi, w = (torch.from_numpy(np.ascontiguousarray(phys[MOIST3D_VARS.index(n)]))
             .to("cuda").reshape(-1, 48) for n in ("xi", "w"))
    zmax = model.grid_params.zmax
    ctx = tmodel.build_context(model, grid, torch.float32)
    pxi = float(ctx.ref_state.Pxi_bar)
    o32 = tti.build_semiimplicit_ops(48, 0.0, zmax, None, pxi, model.ts, torch.float32, "cuda")
    stages = (("t1", 0.5 * model.ts, o32.hinv_t1, o32.solve_t1),
              ("ab", 1.25 * model.ts, o32.hinv, o32.solve))
    zero_counts(cs, ra)
    outs = [cs.fused_column_solve(xi, w, o32.col_filter, o32.col_deriv, hinv, o32.synth,
                                  o32.dsynth, ts_term, pxi)
            for _, ts_term, hinv, _ in stages]
    torch.cuda.synchronize()
    path_launches = launched(CS_COMP)
    assert (path_launches, launched(CS)) == (2, 0), (path_launches, launched(CS))
    errs, direct = [], []
    for out, (_, ts_term, hinv, op) in zip(outs, stages):
        ref = cs.apply_column_operator(xi, w, op)  # the plain (3xTF32) kernel
        errs.append(rel_errs(out, tuple(r.double() for r in ref))[0])
        m = cs.compose_column_operator(*(o.double() for o in (
            o32.col_filter, o32.col_deriv, hinv, o32.synth, o32.dsynth)), ts_term, pxi)
        plain = cs.apply_column_operator_comp_plain(
            xi, w, cs.column_operator(m, torch.float32, "cuda", "comp").M)
        direct.append(rel_errs(out, tuple(p.double() for p in plain))[0])
    assert max(direct) <= COMP_DIRECT["column_solve"], direct
    assert max(errs) <= 1e-4, errs
    res["column_solve_comp_launches"] = path_launches

    # semiimplicit_adjustment on use_pallas=True operators (the JAX option's
    # counterpart: each stage a comp operator) on the same columns, as the
    # step's corrector, the startup stage (t = 1) and AB3 (t = 3), with the
    # run's xi, w as xi^{n+1}, w^{n+1} and tendencies from a seed; the
    # counts reset just before it
    op_p = tti.build_semiimplicit_ops(48, 0.0, zmax, None, pxi, model.ts, torch.float32,
                                      "cuda", use_pallas=True)
    assert op_p.solve.comp and op_p.solve_t1.comp
    rng = np.random.default_rng(11)
    tend = [torch.from_numpy(rng.normal(size=tuple(xi.shape)) * 1e-3).float().cuda()
            for _ in range(6)]
    zero_counts(cs, ra)
    adj = [tti.semiimplicit_adjustment(op_p, w, xi, *tend, t) for t in (1, 3)]
    torch.cuda.synchronize()
    adj_launches = launched(CS_COMP)
    assert (adj_launches, launched(CS)) == (2, 0), (adj_launches, launched(CS))
    # its plain version: the same corrector on the CPU, which takes the comp
    # map's plain version (apply_column_operator_comp_plain) on the same inputs
    op_cpu = tti.build_semiimplicit_ops(48, 0.0, zmax, None, pxi, model.ts, torch.float32,
                                        "cpu", use_pallas=True)
    adj_direct = []
    for out, t in zip(adj, (1, 3)):
        ref = tti.semiimplicit_adjustment(op_cpu, w.cpu(), xi.cpu(), *(q.cpu() for q in tend),
                                          t)
        assert all(torch.isfinite(o).all() for o in out)
        adj_direct.append(rel_errs(tuple(o.cpu() for o in out),
                                   tuple(r.double() for r in ref))[0])
    assert max(adj_direct) <= COMP_DIRECT["column_solve"], adj_direct
    res["use_pallas_adjustment_launches"] = adj_launches
    say("comp-column-solve-path", t0,
        f"fused_column_solve(..., mode='comp' by default) on the compensated moist3d's "
        f"[9216, 48] columns, both stages: comp kernel launches {path_launches}; against "
        f"its plain version (the same composed M, torch bf16x3) rel err "
        f"{[f'{e:.2e}' for e in direct]} (tol {COMP_DIRECT['column_solve']}); against the "
        f"plain-mode kernel {[f'{e:.2e}' for e in errs]} (tol 1e-4); "
        f"semiimplicit_adjustment on build_semiimplicit_ops(..., use_pallas=True) at t = 1 "
        f"and 3 on the same columns: comp kernel launches {adj_launches}, against its plain "
        f"version rel err {[f'{e:.2e}' for e in adj_direct]} (tol "
        f"{COMP_DIRECT['column_solve']})")
    return res


def comp_flagship_workflow(tx, torch, cb, base, dtype, device, twoway_steps=400):
    """flagship_workflow on compensated grids (deriv_single auto: on), as the
    JAX package runs it on a TPU: Rankine ICs, the one-way spinup for 200
    steps, add_wave2 on its last output, ``twoway_steps`` two-way steps with
    an output halfway."""
    spin = cb.spinup_model(base).with_(integration_time=600.0, output_interval=600.0)
    pts_grid = tx.create_grid(spin.grid_params, torch.float64, device="cpu")  # points only
    cb.write_rankine_ics(pts_grid, spin.initial_conditions)
    with compensated_grids():
        tx.integrate_model(spin, dtype=dtype, device=device)
    balanced = os.path.join(spin.output_dir, "physical_out_600.0.csv")
    t_end = twoway_steps * 3.0
    tw = cb.twoway_model(base).with_(integration_time=t_end, output_interval=t_end / 2)
    cb.add_wave2(pts_grid, balanced, tw.initial_conditions)
    with compensated_grids():
        grid, phys = tx.integrate_model(tw, dtype=dtype, device=device)
    return tw, grid, phys


def phase_comp_flagship(tx, torch, cs, ra, cb, tmp):
    """The flagship workflow at full width on compensated grids with the fast
    derivative slots: inside phase 9's bands; no hand-written kernel lies on
    this RL path, and the counts say 0."""
    t0 = time.perf_counter()
    zero_counts(cs, ra)
    tw, grid, phys = comp_flagship_workflow(tx, torch, cb, os.path.join(tmp, "flagship_comp"),
                                            torch.float32, "cuda")
    launches = launched(CS, CS_COMP, RA, RA_COMP)
    assert launches == (0, 0, 0, 0), launches
    assert grid.comp and grid.fast
    assert phys.shape == (6, 300, 256) and np.isfinite(phys).all()
    fl = flagship_readings(grid, phys)
    assert FLAGSHIP_VG_BAND[0] < fl["vg_max"] < FLAGSHIP_VG_BAND[1], fl
    assert FLAGSHIP_WAVE2_BAND[0] < fl["vg_wave2_at_50km"] < FLAGSHIP_WAVE2_BAND[1], fl
    say("comp-flagship-path", t0,
        f"the Cha & Bell workflow f32 on cuda, compensated grids with deriv_single auto "
        f"(fast {grid.fast}): spinup 200 steps, add_wave2, two-way {tw.num_ts} steps on "
        f"{list(phys.shape)}; kernel launches {launches} (none lies on this path); "
        f"{json.dumps(fl)} (vg.max band {FLAGSHIP_VG_BAND}, wave-2 band {FLAGSHIP_WAVE2_BAND})")
    return fl


def factored_rl_params(tx, nl, factored=None):
    """tools/profile_factored.py's RL grid: 64 cells, 6 variables."""
    return tx.GridParameters(geometry="RL", xmin=0.0, xmax=3.0e5, num_cells=FACTORED_CELLS,
                             lDim=nl, l_factored=factored,
                             vars={f"v{i}": i + 1 for i in range(6)})


def round_trip(grid, spec):
    """Every slot of the synthesis, then the analysis of the value slot."""
    out = grid.synthesis(spec)
    return out, grid.analysis(out["val"])


def phase_factored(tx, tmodel, torch, cs, ra, tmp):
    """The factored DFT on the card: the auto choice at nl 4096 against the
    CPU, explicit factored against dense at 2048, dense against factored
    device time, and a factored XYZ grid stepping with no analysis launch.
    Returns {nl: (dense ms, factored ms)}."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    gp = factored_rl_params(tx, 4096)
    gc = tx.create_grid(gp, torch.float64, device="cuda")
    gcpu = tx.create_grid(gp, torch.float64, device="cpu")
    assert gc.l_fact is not None and gc.kDim == gc.l_fact.fd.K, "auto did not factor"
    spec = torch.from_numpy(rng.normal(size=gc.spectral_shape))
    a, sa = round_trip(gc, spec.cuda())
    b, sb = round_trip(gcpu, spec)
    rel4096 = max([float((a[k].cpu() - b[k]).abs().max() / b[k].abs().max()) for k in b]
                  + [float((sa.cpu() - sb).abs().max() / sb.abs().max())])
    assert rel4096 <= 1e-12, rel4096
    gd = tx.create_grid(factored_rl_params(tx, 2048, False), torch.float64, device="cuda")
    gf = tx.create_grid(factored_rl_params(tx, 2048, True), torch.float64, device="cuda")
    phys = torch.from_numpy(rng.normal(size=(6,) + gd.spatial_shape)).cuda()
    od, of = gd.synthesis(gd.analysis(phys)), gf.synthesis(gf.analysis(phys))
    rel2048 = max(float((of[k] - od[k]).abs().max() / od[k].abs().max()) for k in od)
    assert rel2048 <= 1e-12, rel2048
    say("factored-dft", t0,
        f"RL {FACTORED_CELLS} cells x 6 vars: nl 4096 (auto: factored, K {gc.kDim}) round "
        f"trip f64 cuda vs cpu rel err {rel4096:.2e} (tol 1e-12); nl 2048 l_factored=True "
        f"vs dense f64 on cuda, every slot {rel2048:.2e} (tol 1e-12)")

    t0 = time.perf_counter()
    times = {}
    for nl in FACTORED_TIMED_NL:
        row = []
        for factored in (False, True):
            g = tx.create_grid(factored_rl_params(tx, nl, factored), torch.float32,
                               device="cuda")
            s = torch.full(g.spectral_shape, 1e-3, dtype=torch.float32, device="cuda")
            row.append(lambda g=g, s=s: g.analysis(g.synthesis(s)["val"]))
        kt, pt = in_turns(row[0], row[1], 20, timer=queued_time_ms)
        times[nl] = (min(pt), min(kt))
        print(f"  factored DFT RL nl {nl} f32 round trip: device time dense {pt} ms, "
              f"factored {kt} ms", flush=True)
    say("factored-dft-timing", t0,
        "RL round trip (all synthesis slots, then the analysis of the value slot), f32, 20 "
        "calls a run, min device ms dense vs factored: "
        + ", ".join(f"nl {nl} {d:.4f} vs {f:.4f}" for nl, (d, f) in times.items()))

    t0 = time.perf_counter()
    xm = xyz_test_model(tx, tmp, 10, cells=4, ldim=4096, zdim=6, ts=0.002,
                        name="xyz_factored")
    zero_counts(cs, ra)
    g, p_gpu = tx.integrate_model(xm, dtype=torch.float64, device="cuda", write_outputs=False)
    launches = launched(CS, RA, RA_COMP)
    assert g.l_fact is not None and launches == (10, 0, 0), launches
    _, p_cpu = tx.integrate_model(xm, dtype=torch.float64, device="cpu", write_outputs=False)
    rel = per_field_rel(p_gpu, p_cpu)
    assert np.isfinite(p_gpu).all() and max(rel) <= 1e-9, rel
    say("factored-xyz-path", t0,
        f"MoistEulerXYZ on the XYZ box at lDim 4096 (factored, K {g.kDim}; "
        f"{list(p_gpu.shape)}), 10 f64 steps of 0.002 s on cuda: launches (column solve, "
        f"analysis, comp analysis) {launches}: the factored grid takes the einsum analysis by "
        f"design; vs cpu f64 rel err per field {fmt_rel(rel)} (tol 1e-9)")
    return times


SHARDS = 4  # the sharded phase's thread-shards on the one card
# float32 moist3d on 4 psum shards against one device after 20 steps: the
# shards sum the projection in another order; the same comparison on the CPU
# measured at most 4.95e-6 of a field's max (tools/torch_sharded_reference.py;
# PERF.md), so about 3x that
SHARDED_F32_BOUND = 1.5e-5
# the flagship on 4 psum shards against one device after 50 f64 steps: 1e-12
# of each field's max, except wb: it is diagnosed each step from derivatives
# of ub and vb, so their round-off shows in it undamped (as in
# FLAGSHIP_F32_BOUND); it read 1.75e-12 on the card and 2.02e-12 on the CPU
# (tools/torch_sharded_reference.py --parts flagship; PERF.md), so 1e-11,
# about 5x the larger
SHARDED_FLAGSHIP_BOUND = {"wb": 1e-11}
# the plain versions a sharded path on the card must never call
PLAIN_VERSIONS = (("column_solve", "apply_column_operator_plain"),
                  ("column_solve", "apply_column_operator_comp_plain"),
                  ("column_solve", "fused_column_solve_plain"),
                  ("rlz_analysis", "rlz_analysis_plain"),
                  ("rlz_analysis", "rlz_analysis_comp_plain"))


@contextlib.contextmanager
def plain_version_calls(cs, ra):
    """The names of the kernels' plain versions called inside the block."""
    from unittest import mock

    calls = []
    mods = {"column_solve": cs, "rlz_analysis": ra}
    with contextlib.ExitStack() as stack:
        for mod, name in PLAIN_VERSIONS:
            fn = getattr(mods[mod], name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls.append(_name)
                return _fn(*a, **k)

            stack.enter_context(mock.patch.object(mods[mod], name, counted))
        yield calls


def sharded_run(tx, torch, model, dtype, device, shard):
    """(grid, step, state) of ``model`` on one device (``shard`` None) or
    on a ThreadMesh of ``shard = (n, method, interface)`` on ``device``."""
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch.parallel import sharding as psh

    if shard is None:
        grid, ctx, state = tmodel.initialize(model, dtype, device=device)
        return grid, tmodel.build_step(model, grid, ctx, dtype), state
    n, method, interface = shard
    mesh = psh.make_mesh(n, device=device)
    grid, ctx, state = psh.initialize_sharded(model, mesh, dtype, method, device=device)
    return grid, psh.build_sharded_step(model, grid, ctx, dtype, mesh, method,
                                        interface), state


def canonical_fields(grid, spec, shard):
    """The final physical fields [nvars, *spatial] (numpy) of a run's
    spectral state, gathered and, on the halo path, made canonical."""
    from scythe_tpu_torch.parallel import sharding as psh

    spec = psh.gather_global(spec)
    if shard is not None and shard[1] == "halo":
        spec = psh.blocks_to_spec(spec, shard[0], grid.params.num_cells // shard[0])
    return grid.synthesis(spec)["val"].cpu().numpy()


def sharded_fields(tx, torch, model, dtype, device, shard):
    """The final fields of ``model.num_ts`` steps (``sharded_run``)."""
    from scythe_tpu_torch import model as tmodel

    grid, step, state = sharded_run(tx, torch, model, dtype, device, shard)
    return canonical_fields(grid, tmodel.make_scan(step, model.num_ts)(state).spec, shard)


def sharded_flagship_rel(tx, torch, device, n_steps=50, shards=SHARDS):
    """Per-field max|sharded - one device| / max|one device| of the
    flagship at full width (100 cells x 256) after ``n_steps`` f64 steps on
    one device and on ``shards`` psum thread-shards of ``device``."""
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch.examples import cha_bell_initialization as cb
    from scythe_tpu_torch.parallel import sharding as psh

    f64 = torch.float64
    fm = cb.flagship_model(100, 256).with_(integration_time=150.0, output_interval=150.0)
    g = tx.create_grid(fm.grid_params, f64, device=device)
    ctx = tmodel.build_context(fm, g, f64)
    st0 = cb.vortex_state(g, f64)
    ref = g.synthesis(tmodel.make_scan(tmodel.build_step(fm, g, ctx, f64), n_steps)(st0).spec)
    mesh = psh.make_mesh(shards, device=device)
    step = psh.build_sharded_step(fm, g, ctx, f64, mesh, "psum")
    got = tmodel.make_scan(step, n_steps)(psh.shard_state(st0, mesh, "psum"))
    return per_field_rel(canonical_fields(g, got.spec, (shards, "psum", "gather")),
                         ref["val"].cpu().numpy())


GRAD_STEPS = 10  # the sharded-grad step's checkpointed moist3d steps
GRAD_SEED = 1.0e-4  # mu_c and mu_r everywhere: at exactly zero rain the
# warm-rain terms have no derivative (a NaN gradient, in both packages)


def grad_setup(torch, tmodel, psh, model, grid, ctx, state, mesh, method):
    """(step, start, finish) of one device (``mesh`` None) or of ``mesh`` by
    ``method``: start(s) is the state to step from the canonical spectral
    state ``s`` (windowed blocks on halo, cut over the mesh's shards), and
    finish(spec) the canonical whole of a stepped spectral state."""
    f64 = torch.float64
    if mesh is None:
        step = tmodel.build_step(model, grid, ctx, f64)
        return step, lambda s: state._replace(spec=s), lambda spec: spec
    n, cl = mesh.size, grid.params.num_cells // mesh.size
    step = psh.build_sharded_step(model, grid, ctx, f64, mesh, method)

    def start(s):
        if method == "halo":
            s = psh.spec_to_blocks(s, n, cl)
        return psh.shard_state(state._replace(spec=s), mesh, method)

    def finish(spec):
        spec = psh.gather_global(spec)
        return psh.blocks_to_spec(spec, n, cl) if method == "halo" else spec

    return step, start, finish


def grad_run(torch, psh, run, spec0, mesh, n_steps):
    """(gradient, seconds a step): the whole gradient of 0.5 ||spec||^2 after
    ``n_steps`` steps of ``run`` = (step, start, finish), each under
    torch.utils.checkpoint (non-reentrant), with respect to the canonical
    spectral state ``spec0`` (``replicated_grad``: every rank's whole),
    timed from the first step to the gradient on the card."""
    from torch.utils.checkpoint import checkpoint

    step, start, finish = run
    s = spec0.detach().clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = start(s)
    for _ in range(n_steps):
        st = checkpoint(step, st, use_reentrant=False)
    spec = finish(st.spec)
    (g,) = psh.replicated_grad(0.5 * torch.sum(spec * spec), s, mesh)
    torch.cuda.synchronize()
    return g, (time.perf_counter() - t0) / n_steps


def forward_run(torch, run, spec0, n_steps):
    """Seconds a step of ``n_steps`` steps of ``run`` without a gradient."""
    step, start, _ = run
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = start(spec0)
        for _ in range(n_steps):
            st = step(st)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_steps


def phase_sharded_grad(tx, tmodel, torch, cs, ra, cb, tmp, card):
    """Phase 31's sharded-grad step: the gradient through checkpointed
    sharded semi-implicit moist3d steps on one device, 4 thread-shards and a
    world of one NCCL rank, and the flagship's 4D-Var gradient on the NCCL
    rank."""
    import torch.distributed as dist
    from scythe_tpu_torch import graft_entry as ge
    from scythe_tpu_torch.parallel import mesh as pmesh
    from scythe_tpu_torch.ops import condensation as cn
    from scythe_tpu_torch.parallel import sharding as psh

    t0 = time.perf_counter()
    f64, dev = torch.float64, "cuda:0"
    out = {"launches": {}, "condensation": {}, "rel": {}, "grad_s_step": {},
           "forward_s_step": {}}
    model = moist3d(tx, tmp, n_steps=GRAD_STEPS, out_every=GRAD_STEPS, name="grad")
    grid, ctx, state = tmodel.initialize(model, f64, device=dev)
    phys = grid.synthesis(state.spec)["val"].clone()
    phys[MOIST3D_VARS.index("mu_c")] = GRAD_SEED
    phys[MOIST3D_VARS.index("mu_r")] = GRAD_SEED
    spec0 = grid.analysis(phys)
    grads = {}

    def measure(label, mesh, method):
        run = grad_setup(torch, tmodel, psh, model, grid, ctx, state, mesh, method)
        forward_run(torch, run, spec0, 1)  # warm-up of each: the first backward and the
        grad_run(torch, psh, run, spec0, mesh, 1)  # first collective cost seconds once
        out["forward_s_step"][label] = forward_run(torch, run, spec0, GRAD_STEPS)
        zero_counts(cs, ra, cn)
        grads[label], out["grad_s_step"][label] = grad_run(torch, psh, run, spec0, mesh,
                                                           GRAD_STEPS)
        # (column solve forward and recompute, on M^T, analysis kernel)
        out["launches"][label] = launched(CS, CS_BACK, RA)
        # the condensation kernel where the column solve runs, its plain chain
        # once a step in the backward
        out["condensation"][label] = launched(CN, CN_PLAIN)

    with plain_version_calls(cs, ra) as plain:
        measure("one_device", None, None)
        for method in ("psum", "halo"):
            measure(f"thread_{method}_{SHARDS}", psh.make_mesh(SHARDS, device=dev), method)
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "grad_store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh(1, device=dev)
            assert isinstance(mesh, pmesh.DistMesh) and mesh.nccl, mesh
            measure("nccl_world_of_one", mesh, "psum")
            # the flagship's 4D-Var cost at full width, two steps
            fm = cb.flagship_model()
            fg = tx.create_grid(fm.grid_params, f64, device=dev)
            fctx = tmodel.build_context(fm, fg, f64)
            fs = cb.vortex_state(fg, f64).spec
            fgrads = []
            for m in (None, mesh):
                s = fs.detach().clone().requires_grad_(True)
                c = ge.fourdvar_cost(fm, fg, fctx, f64, m, "psum")(s)
                fgrads.append(psh.replicated_grad(c, s, m)[0])
        finally:
            dist.destroy_process_group()
        assert plain == [], sorted(set(plain))
    g1 = grads["one_device"]
    assert torch.isfinite(g1).all() and float(g1.abs().max()) > 0.0
    for label, g in grads.items():
        out["rel"][label] = float((g - g1).abs().max() / g1.abs().max())
    fl_rel = float((fgrads[1] - fgrads[0]).abs().max() / fgrads[0].abs().max())
    out["rel"]["fourdvar_flagship_nccl"] = fl_rel
    want = {"one_device": (20, 10, 20), "nccl_world_of_one": (20, 10, 0),
            **{f"thread_{m}_{SHARDS}": (SHARDS * 20, SHARDS * 10, 0) for m in ("psum", "halo")}}
    print(f"  sharded-grad launches (column solve forward + recompute, on M^T, analysis "
          f"kernel): {json.dumps(out['launches'])}; expected {json.dumps(want)}; condensation "
          f"(kernel, plain chain in the backward) {json.dumps(out['condensation'])}", flush=True)
    print(f"  sharded-grad rel err against one device (tol 1e-12): {json.dumps(out['rel'])}",
          flush=True)
    print(f"  sharded-grad seconds a step, gradient {json.dumps(out['grad_s_step'])}, forward "
          f"{json.dumps(out['forward_s_step'])} on {card}", flush=True)
    assert all(r <= 1e-12 for r in out["rel"].values()), out["rel"]
    assert out["launches"] == want, (out["launches"], want)
    assert out["condensation"] == {k: v[:2] for k, v in want.items()}, out["condensation"]
    say("sharded-grad", t0,
        f"moist3d [9, 144, 64, 48] f64, gradient of 0.5 ||spec||^2 after {GRAD_STEPS} steps, "
        f"each under checkpoint: {SHARDS} thread-shards (psum, halo) and a DistMesh over one "
        f"NCCL rank vs one device rel err {json.dumps(out['rel'])} (tol 1e-12, the flagship's "
        f"4D-Var gradient on the NCCL rank among them); column-solve launches 30 a run (4 x 30 "
        f"on the shards), plain-version calls 0; gradient s/step "
        f"{json.dumps({k: round(v, 4) for k, v in out['grad_s_step'].items()})}, forward "
        f"{json.dumps({k: round(v, 4) for k, v in out['forward_s_step'].items()})} on {card}")
    return out


def phase_sharded(tx, tmodel, torch, cs, ra, cb, tmp, card):
    """Phase 31: radial domain decomposition (scythe_tpu_torch.parallel) on
    the one card: moist3d and the flagship split into 4 thread-shards, the
    integrate_sharded with a checkpoint and its resume, a world of one NCCL
    rank, the gradient through checkpointed sharded steps on both meshes
    (``phase_sharded_grad``), the ensemble mesh, and the cost of 4 shards on
    one card."""
    import torch.distributed as dist
    from scythe_tpu_torch.parallel import mesh as pmesh
    from scythe_tpu_torch.parallel import sharding as psh

    f64, f32 = torch.float64, torch.float32
    out = {"launches": {}}
    # ---- 31a: moist3d at full width, 4 thread-shards on cuda:0, each path
    t0 = time.perf_counter()
    m20 = moist3d(tx, tmp, n_steps=20, out_every=20, name="sharded")
    zero_counts(cs, ra)
    ref64 = sharded_fields(tx, torch, m20, f64, "cuda:0", None)
    assert launched(CS, RA) == (20, 21), launched(CS, RA)
    rels = {}
    with plain_version_calls(cs, ra) as plain:
        for label, shard in (("psum", (SHARDS, "psum", "gather")),
                             ("halo", (SHARDS, "halo", "gather")),
                             ("halo_pcr", (SHARDS, "halo", "pcr"))):
            zero_counts(cs, ra)
            got = sharded_fields(tx, torch, m20, f64, "cuda:0", shard)
            counts = launched(CS, RA)
            # the column solve once a step a shard; the analysis kernel only
            # at set-up (initialize_sharded's whole-field analysis)
            assert counts == (SHARDS * 20, 1), (label, counts)
            out["launches"][f"sharded_moist3d_{label}"] = counts
            rels[label] = per_field_rel(got, ref64)
            assert max(rels[label]) <= 1e-12, (label, rels[label])
        ref32 = sharded_fields(tx, torch, m20, f32, "cuda:0", None)
        zero_counts(cs, ra)
        got32 = sharded_fields(tx, torch, m20, f32, "cuda:0", (SHARDS, "psum", "gather"))
        out["launches"]["sharded_moist3d_f32_psum"] = launched(CS, RA)
        assert out["launches"]["sharded_moist3d_f32_psum"] == (SHARDS * 20, 1)
        rel32 = per_field_rel(got32, ref32)
        print(f"  sharded moist3d f32 psum vs one device rel err {fmt_rel(rel32)}", flush=True)
        assert np.isfinite(got32).all() and max(rel32) <= SHARDED_F32_BOUND, rel32
        assert plain == [], sorted(set(plain))
    out["moist3d_rel"] = {k: max(v) for k, v in rels.items()}
    out["moist3d_f32_rel"] = max(rel32)
    say("sharded-moist3d", t0,
        f"moist3d [9, 144, 64, 48] on {SHARDS} thread-shards of 12 cells on cuda:0, 20 steps: "
        f"f64 vs one device rel err per field (tol 1e-12) "
        + "; ".join(f"{k} {fmt_rel(v)}" for k, v in rels.items())
        + f"; f32 psum vs one device f32 {fmt_rel(rel32)} (tol {SHARDED_F32_BOUND}); "
        f"(column-solve, analysis) launches {json.dumps(out['launches'])} (a solve of "
        f"2,304 x 48 columns a step a shard; the analysis kernel once, at set-up); "
        f"plain-version calls 0")

    # ---- 31b: the flagship at full width, 4 psum shards of 25 cells
    t0 = time.perf_counter()
    zero_counts(cs, ra)
    rel_fl = sharded_flagship_rel(tx, torch, "cuda:0")
    out["launches"]["sharded_flagship_psum"] = launched(CS, RA)
    assert out["launches"]["sharded_flagship_psum"] == (0, 0)
    fl_bounds = [SHARDED_FLAGSHIP_BOUND.get(n, 1e-12) for n in FLAGSHIP_VARS]
    assert all(r <= b for r, b in zip(rel_fl, fl_bounds)), (rel_fl, fl_bounds)
    say("sharded-flagship", t0,
        f"flagship [6, 300, 256] on {SHARDS} psum thread-shards of 25 cells, 50 f64 steps "
        f"vs one device rel err per field {fmt_rel(rel_fl, FLAGSHIP_VARS)} (tol "
        f"{SHARDED_FLAGSHIP_BOUND} else 1e-12); no hand-written kernel lies on this path "
        f"and the counts say 0")

    # ---- 31c: integrate_sharded (halo) through run_loop, checkpoint, resume
    t0 = time.perf_counter()
    full = moist3d(tx, tmp, n_steps=20, out_every=10, name="resume_full")
    _, p_full = tx.integrate_model(full, dtype=f64, device="cuda:0", write_outputs=False)
    first = moist3d(tx, tmp, n_steps=10, out_every=10, name="resume_first")
    first = first.with_(options={**first.opts(), "checkpoint_interval": 10 * first.ts})
    psh.integrate_sharded(first, SHARDS, f64, method="halo", device="cuda:0")
    ckpt = os.path.join(first.output_dir, "checkpoint_1.5.npz")
    outs = sorted(f for f in os.listdir(first.output_dir) if f.startswith("physical_out_"))
    assert os.path.exists(ckpt) and len(outs) == 2, os.listdir(first.output_dir)
    second = moist3d(tx, tmp, n_steps=10, out_every=10, name="resume_second")
    _, p_res = psh.integrate_sharded(second, SHARDS, f64, method="halo", resume_from=ckpt,
                                     write_outputs=False, device="cuda:0")
    rel_res = per_field_rel(p_res, p_full)
    assert max(rel_res) <= 1e-13, rel_res
    say("sharded-resume", t0,
        f"integrate_sharded moist3d on {SHARDS} halo shards, 10 f64 steps with a checkpoint "
        f"({os.path.basename(ckpt)}, outputs {outs}), then 10 more resumed from it, vs 20 "
        f"continuous steps on one device: rel err per field (tol 1e-13) {fmt_rel(rel_res)}")

    # ---- 31d: a world of one NCCL rank over a FileStore
    t0 = time.perf_counter()
    m10 = moist3d(tx, tmp, n_steps=10, out_every=10, name="nccl")
    ref10 = sharded_fields(tx, torch, m10, f64, "cuda:0", None)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "nccl_store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(1, device="cuda:0")
        assert isinstance(mesh, pmesh.DistMesh) and mesh.nccl, mesh
        zero_counts(cs, ra)
        grid, ctx, state = psh.initialize_sharded(m10, mesh, f64, "psum", device="cuda:0")
        step = psh.build_sharded_step(m10, grid, ctx, f64, mesh, "psum")
        fin = tmodel.make_scan(step, 10)(state)
        out["launches"]["sharded_nccl_world_of_one"] = launched(CS, RA)
        got = canonical_fields(grid, fin.spec, (1, "psum", "gather"))
        e1 = psh.gather_global(fin.expdot_nm1)  # all_gather_into_tensor
        assert e1.shape == (9,) + grid.spatial_shape and torch.isfinite(e1).all()
    finally:
        dist.destroy_process_group()
    assert out["launches"]["sharded_nccl_world_of_one"] == (10, 1)
    rel_nccl = per_field_rel(got, ref10)
    assert max(rel_nccl) <= 1e-12, rel_nccl
    say("sharded-nccl", t0,
        f"DistMesh over one NCCL rank (FileStore): moist3d 10 psum f64 steps (all_reduce a "
        f"step, all_gather_into_tensor for the histories) vs one device rel err per field "
        f"(tol 1e-12) {fmt_rel(rel_nccl)}; launches {out['launches']['sharded_nccl_world_of_one']}")

    # ---- the sharded-grad step: gradients through checkpointed sharded steps
    out["grad"] = phase_sharded_grad(tx, tmodel, torch, cs, ra, cb, tmp, card)
    for label, (fwd, bwd, an) in out["grad"]["launches"].items():
        out["launches"][f"sharded_grad_{label}"] = (fwd + bwd, an)

    # ---- 31e: the flagship's 16 members over an ensemble mesh of 4
    t0 = time.perf_counter()
    f20 = cb.flagship_model(100, 256).with_(integration_time=60.0, output_interval=60.0)
    base = cb.vortex_phys(tx.create_grid(f20.grid_params, f64, device="cuda:0"))
    ics = np.stack([base * (1.0 + i / 100.0) for i in range(FLAGSHIP_MEMBERS)])
    _, e_ref = tmodel.integrate_ensemble(f20, ics, dtype=f64, device="cuda:0")
    _, e_got = tmodel.integrate_ensemble(f20, ics, dtype=f64, device="cuda:0",
                                         mesh=pmesh.make_ensemble_mesh(SHARDS, device="cuda:0"))
    rel_ens = max(max(per_field_rel(e_got[i], e_ref[i])) for i in range(FLAGSHIP_MEMBERS))
    assert e_got.shape == e_ref.shape and rel_ens <= 1e-13, rel_ens
    say("sharded-ensemble", t0,
        f"integrate_ensemble of the flagship's {FLAGSHIP_MEMBERS} members on an ensemble mesh "
        f"of {SHARDS} thread-shards (4 members each), 20 f64 steps, vs the unsharded ensemble: "
        f"max rel err of a member's field {rel_ens:.3e} (tol 1e-13)")

    # ---- 31f: the cost of 4 shards on one card, in turns with one device
    t0 = time.perf_counter()
    runs = {}
    for label, shard in (("one_device", None), ("psum_4", (SHARDS, "psum", "gather")),
                         ("halo_4", (SHARDS, "halo", "gather"))):
        grid, step, state = sharded_run(tx, torch, m20, f32, "cuda:0", shard)
        state = tmodel.make_scan(step, 3)(state)  # warm-up
        runs[label] = (step, state)
    times = {k: [] for k in runs}
    for label in ("one_device", "psum_4", "halo_4", "halo_4", "psum_4", "one_device"):
        step, state = runs[label]
        _, ms = run_steps(torch, tmodel, step, state, 20)
        times[label].append(ms)
    rates = {}
    for label, (step, state) in runs.items():
        per = launches_per_step(torch, lambda n: tmodel.make_scan(step, n)(state), 3, 8,
                                tries=1)
        rates[label] = {"steps_per_s": [1000.0 / ms for ms in times[label]],
                        "ms_step": times[label],
                        "launches_per_step": sum(per.values())}
    out["times"] = rates
    say("sharded-times", t0,
        f"moist3d f32 on cuda:0, 20 steps by CUDA events, in turns: "
        + "; ".join(f"{k}: {[round(v, 2) for v in r['steps_per_s']]} steps/s, "
                    f"{r['launches_per_step']:.1f} launches a step (torch.profiler, 8 - 3 "
                    f"steps)" for k, r in rates.items())
        + f" on {card}; the cost of {SHARDS} shards on one card, not a scaling figure")
    return out


# the published runs of scythe_tpu_torch/examples at their published sizes,
# in f32 on the card, each held to its JAX test's bands (the warm bubble:
# the centroid band of the JAX example's recorded run); the CPU f64 readings
# of the same runs are in PERF.md (tools/torch_published_reference.py)
WARM_BUBBLE_CENTROID_BAND = (2050.0, 2150.0)  # m; CPU f64 2086.87
# tests/test_straka.py:62-81 (CPU f64 at 128 x 48: front 14,754.9 m,
# theta'_min -9.103 K, front speed 14.37 m/s)
STRAKA_BANDS = {"front_m": (13000.0, 17500.0), "theta_min_K": (-12.0, -5.0),
                "front_speed_m_s": (8.0, 30.0)}
STRAKA_Z_OF_MIN_MAX = 1500.0
# tests/test_inertia_gravity_wave.py:49-70 (CPU f64: corr 0.8631)
IGW_CORR_MIN = 0.84
IGW_RATIO_BAND = (0.75, 1.25)
IGW_CENTROID_TOL = 10000.0
IGW_U_MEAN_TOL, IGW_U_DEV_MAX = 0.01, 0.2
# tests/test_bf02_published.py:58-72, held on the test's own configuration
# (Delta = 208 m: 32 cells x 40 levels, ts 0.25 s, 4,000 steps); the
# published size (64 x 64, 10,000 steps) is driven too and its readings
# printed beside the published 14.3 m/s
BF02_GATE = {"num_cells": 32, "zdim": 40, "ts": 0.25, "t_end": 1000.0}
BF02_W_BAND = (9.1, 12.4)
BF02_THETA_E_DRIFT = 1.0  # K
BF02_PUBLISHED_W = 14.3  # m/s, BF02's Delta = 100 m run
# the published size's w_max after 1000 s: the JAX package and the port read
# 16.1508 m/s in f64 on the CPU (tools/torch_published_reference.py and the
# JAX example; PERF.md), the card 16.1436 in f32; the band is +-0.5 m/s
# around the f64 reading (the test's own bands belong to its Delta = 208 m
# configuration, and neither package meets them at 64 x 64 in f64)
BF02_PUBLISHED_W_BAND = (15.65, 16.65)
# Galewsky runs last: after day 1 (each day ~2,541 f64 steps at 128 x 512,
# ~4 s on one H100) a day runs only if it would end before this many seconds
# of the whole script, so a slow host cuts the roll-up and not the run
GALEWSKY_DEADLINE_S = 760.0
# Galewsky's (zonal-deviation energy m^2, u_max m/s) each day, from the same
# f64 run on the CPU (tools/torch_published_reference.py --runs galewsky
# --galewsky-days 6; PERF.md); the JAX example's own run reads day 1 alike
# (6.03, 78.2).  Its docstring's table (examples/galewsky_instability.py:
# 8-13; 78.0 m/s on day 1) is printed beside them: it does not match the
# example's code to its digits in either package
GALEWSKY_CPU_F64 = {1: (6.026674982561442, 78.19728159421253),
                    2: (7.428239149356653, 76.58449365933264),
                    3: (10.063670718218072, 75.47302613531623),
                    4: (97.10594589261028, 75.55710191202644),
                    5: (956.7427760428485, 75.06462757587238),
                    6: (4143.315488045922, 74.56439548211551)}
GALEWSKY_RTOL = 1e-6  # the card's f64 against the CPU's, each reading
# the published runs whose gate runs in f64 on the card: the SK94 wave in
# f32 reads a correlation of 0.70 and an energy centroid ~150 km from the
# analytic one, on the card and on the CPU alike (its 0.01 K anomaly is 3e-5
# of theta, a few f32 roundings; PERF.md, ROADMAP queue 3;
# tools/torch_igw_f32_check.py), and in f64 it holds the test's bands
PUBLISHED_F64 = ("igw",)
# (label, example, ncols, nz) of the column solve on the published runs
CS_PUBLISHED = (("75x40", "warm_bubble", 75, 40), ("192x64", "bf02", 192, 64),
                ("384x48", "straka", 384, 48), ("450x24", "igw", 450, 24))


def published_model(name, base):
    """The published run ``name`` (warm_bubble, straka, igw, bf02, or
    bf02_gate: the JAX test's BF02 configuration) at its size, its files
    (sounding or reference file, ICs) written under ``base``."""
    import torch
    from scythe_tpu_torch import create_grid
    from scythe_tpu_torch.examples import bf02_moist_benchmark as bf
    from scythe_tpu_torch.examples import inertia_gravity_wave as igw
    from scythe_tpu_torch.examples import straka_density_current as st
    from scythe_tpu_torch.examples import warm_bubble as wb
    from scythe_tpu_torch.model import build_context

    out = os.path.join(base, name)
    if name == "warm_bubble":
        model = wb.build_model(out)
        wb.write_ics(model)
        return model
    mod, model = {"straka": (st, lambda: st.build_model(out)),
                  "igw": (igw, lambda: igw.build_model(out)),
                  "bf02": (bf, lambda: bf.build_model(out)),
                  "bf02_gate": (bf, lambda: bf.build_model(out, **BF02_GATE))}[name]
    model = model()
    grid = create_grid(model.grid_params, torch.float64, device="cpu")  # the ICs
    mod.write_ics(model, grid, build_context(model, grid, torch.float64).ref_state)
    return model


def published_run(name, model, dtype, device):
    """The readings of one published run of ``model`` on ``device``, the
    examples' own functions (tools/torch_published_reference.py runs the
    same on any device)."""
    from scythe_tpu_torch import integrate_model
    from scythe_tpu_torch.examples import bf02_moist_benchmark as bf
    from scythe_tpu_torch.examples import inertia_gravity_wave as igw
    from scythe_tpu_torch.examples import straka_density_current as st
    from scythe_tpu_torch.examples import warm_bubble as wb

    if name == "warm_bubble":
        grid, phys = integrate_model(model, dtype=dtype, device=device)
        assert np.isfinite(phys).all()
        w_max, zc = wb.readings(grid, phys)
        return {"w_max": w_max, "centroid_z_m": zc}
    if name == "straka":
        grid, ctx, runs = st.snapshots(model, 3, dtype, device)
        return st.readings(grid, ctx.ref_state, runs)
    if name == "igw":
        grid, ctx, runs = st.snapshots(model, 1, dtype, device)
        return igw.readings(grid, ctx.ref_state, runs[-1][1], model.integration_time)
    _, _, rows = bf.simulate(model, dtype, device, report_every=model.integration_time)
    keys = ("w_max", "trho_max", "trho_min", "theta_e_min", "theta_e_max")
    return {"t0": dict(zip(keys, rows[0][1])), "t_end": dict(zip(keys, rows[-1][1]))}


def check_published(name, r):
    """The JAX test's bands of one published run's readings."""
    if name == "warm_bubble":
        lo, hi = WARM_BUBBLE_CENTROID_BAND
        assert lo < r["centroid_z_m"] < hi and r["w_max"] > 0.0, r
    elif name == "straka":
        for key, (lo, hi) in STRAKA_BANDS.items():
            val = r[key][-1] if isinstance(r[key], list) else r[key]
            assert lo < val < hi, (key, r)
        assert r["front_m"][0] < r["front_m"][1] < r["front_m"][2], r
        assert r["z_of_min_m"] < STRAKA_Z_OF_MIN_MAX, r
    elif name == "igw":
        assert r["corr"] > IGW_CORR_MIN, r
        for a, b in (("theta_max", "analytic_max"), ("theta_min", "analytic_min")):
            assert IGW_RATIO_BAND[0] < r[a] / r[b] < IGW_RATIO_BAND[1], (a, r)
        assert abs(r["centroid_m"] - r["analytic_centroid_m"]) < IGW_CENTROID_TOL, r
        assert abs(r["u_mean"] - 20.0) < IGW_U_MEAN_TOL and r["u_dev_max"] < IGW_U_DEV_MAX, r
    else:
        t0, t1 = r["t0"], r["t_end"]
        assert 1.8 < t0["trho_max"] < 2.1 and abs(t0["trho_min"]) < 0.15, r
        assert t0["w_max"] == 0.0, r
        if name == "bf02_gate":
            assert BF02_W_BAND[0] < t1["w_max"] < BF02_W_BAND[1], r
            assert t1["theta_e_min"] > t0["theta_e_min"] - BF02_THETA_E_DRIFT, r
            assert t1["theta_e_max"] < t0["theta_e_max"] + BF02_THETA_E_DRIFT, r
        else:
            assert BF02_PUBLISHED_W_BAND[0] < t1["w_max"] < BF02_PUBLISHED_W_BAND[1], r


def phase_examples(tx, tmodel, tti, torch, cs, ra, tmp, card):
    """Phase 32: the column solve at the published runs' shapes against its
    plain version and the library call; the published runs (warm bubble,
    Straka, SK94 in f64, BF02 at the JAX test's size and at the published
    one) in f32 through the examples' functions, each with its column-solve
    launches (one a step) and no call of a kernel's plain version, its
    steps/s by the host clock (set-up and snapshots included).  Galewsky is
    phase 34, the last."""
    out = {"launches": {}, "steps_per_s": {}, "readings": {}}
    base = os.path.join(tmp, "published")
    models = {}
    # ---- 32a: the column solve at the published runs' shapes
    t0 = time.perf_counter()
    rng = np.random.default_rng(32)
    columns, lines, worst = {}, [], {}
    for label, name, ncols, nz in CS_PUBLISHED + (("96x40", "bf02_gate", 96, 40),):
        m = models[name] = published_model(name, base)
        rs = tmodel.build_context(
            m, tx.create_grid(m.grid_params, torch.float64, device="cpu"),
            torch.float64).ref_state
        assert (m.grid_params.rDim, m.grid_params.zDim) == (ncols, nz), (name, ncols, nz)
        columns[name] = (m.grid_params.zmax, m.ts, float(rs.Pxi_bar),
                         rs.Pxi_prof.numpy().astype(np.float64))
        o64 = tti.build_semiimplicit_ops(nz, 0.0, m.grid_params.zmax, None, float(rs.Pxi_bar),
                                         m.ts, torch.float64, "cuda")
        o32 = tti.build_semiimplicit_ops(nz, 0.0, m.grid_params.zmax, None, float(rs.Pxi_bar),
                                         m.ts, torch.float32, "cuda")
        x = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        w = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        for stage in ("t1", "ab"):
            errs, _, _ = check_stage(torch, cs, o64, o32, x, w, stage, float(rs.Pxi_bar))
            for key, v in errs.items():
                worst[key] = max(worst.get(key, 0.0), v)
            lines.append(f"{label} {stage}: f64 {errs['f64']:.2e}, f32 {errs['f32']:.2e} "
                         f"({errs['f32 / plain f32']:.2f}x the plain f32 chain's)")
    print("  column-solve plans: " + " | ".join(
        f"{ncols}x{nz}: f32 {cs.plan(ncols, nz, torch.float32)}; f64 "
        f"{cs.plan(ncols, nz, torch.float64)}" for _, _, ncols, nz in CS_PUBLISHED), flush=True)
    say("column-solve-published-vs-plain", t0,
        "the published runs' operators (their soundings' Pxi_bar, ts and depth) at 75 x 40, "
        "192 x 64, 384 x 48, 450 x 24 and the BF02 gate's 96 x 40, both stages, f64 and f32 "
        "against the f64 chain (tol 1e-12; 1e-5 and 4x the plain f32 chain's error), two "
        "calls bitwise equal: " + "; ".join(lines))
    t0 = time.perf_counter()
    times = {}
    for label, name, ncols, nz in CS_PUBLISHED:
        times[label] = time_column_solve(torch, tti, cs, rng, label + " f32", ncols, nz,
                                         columns[name], False, "float32")
    times["192x64 f64"] = time_column_solve(torch, tti, cs, rng, "192x64 f64", 192, 64,
                                            columns["bf02"], False, "float64")
    out["column_solve_times"] = times
    say("column-solve-published-timing", t0,
        "200 calls a run, min device ms kernel vs plain vs library (bound, share): "
        + ", ".join(f"{k} {a:.5f} vs {b:.5f} vs {c:.5f} ({d:.5f} {e}, {100.0 * d / a:.1f}%)"
                    for k, (a, b, c, d, e) in times.items()))

    # ---- 32b: the published runs, the counts reset just before each
    published = {"warm_bubble": "column solve of 75 x 40 a step",
                 "straka": "column solve of 384 x 48 a step",
                 "igw": "column solve of 450 x 24 a step",
                 "bf02_gate": "column solve of 96 x 40 a step",
                 "bf02": "column solve of 192 x 64 a step"}
    for name, what in published.items():
        t0 = time.perf_counter()
        model = models[name]
        dtype = torch.float64 if name in PUBLISHED_F64 else torch.float32
        with plain_version_calls(cs, ra) as plain:
            zero_counts(cs, ra)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            r = published_run(name, model, dtype, "cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - h0
            launches = launched(CS, RA)
        assert launches == (model.num_ts, 0), (name, launches, model.num_ts)
        assert plain == [], (name, sorted(set(plain)))
        check_published(name, r)
        out["launches"][name] = launches
        out["steps_per_s"][name] = model.num_ts / seconds
        out["readings"][name] = r
        published_note = {
            "warm_bubble": f"centroid band {WARM_BUBBLE_CENTROID_BAND} m",
            "straka": "Straka et al. 1993 converged: front 15,537 m, theta'_min -9.77 K; "
                      f"bands {STRAKA_BANDS}, z of the minimum < {STRAKA_Z_OF_MIN_MAX} m",
            "igw": f"corr > {IGW_CORR_MIN}, extrema ratios in {IGW_RATIO_BAND}, centroid "
                   f"within {IGW_CENTROID_TOL} m, u mean within {IGW_U_MEAN_TOL} of 20 m/s",
            "bf02_gate": f"tests/test_bf02_published.py: w_max in {BF02_W_BAND} m/s, theta_e "
                         f"extrema within {BF02_THETA_E_DRIFT} K",
            "bf02": f"published (BF02 Delta = 100 m) w_max ~{BF02_PUBLISHED_W} m/s "
                    f"(reproductions 13.9-14.6); band {BF02_PUBLISHED_W_BAND} m/s around "
                    "both packages' CPU f64 reading, 16.1508"}[name]
        say(f"published-{name}", t0,
            f"{model.equation_set} {model.grid_params.num_cells} cells x "
            f"{model.grid_params.zDim} levels, ts {model.ts} s, {model.num_ts} "
            f"{str(dtype).removeprefix('torch.')} steps on cuda: {json.dumps(r)} "
            f"({published_note}); (column-solve, analysis) launches {launches} ({what}); "
            f"plain-version calls 0; {model.num_ts / seconds:.2f} steps/s by the host clock "
            f"({seconds:.2f} s, set-up included) on {card}")

    return out


def phase_galewsky(torch, cs, ra, t_main):
    """Phase 34: Galewsky in f64 at 128 x 512 for whole days, the last
    phase: at least day 1, then each day that ends before
    GALEWSKY_DEADLINE_S seconds from ``t_main``; each day's zonal-deviation
    energy and u_max against the same run on the CPU (GALEWSKY_RTOL),
    beside the JAX example's table."""
    from scythe_tpu_torch.examples import galewsky_instability as gw

    t0 = time.perf_counter()
    gm = gw.build_model(128, 6)
    zero_counts(cs, ra)
    days, t_day = {}, None
    for d, fields in gw.run_days(gm, 6, "cuda"):
        energy, u_max, finite = gw.day_readings(fields)
        e_ref, u_ref = GALEWSKY_CPU_F64[d]
        rel = max(abs(energy - e_ref) / e_ref, abs(u_max - u_ref) / u_ref)
        days[d] = {"dev_energy_m2": energy, "u_max_m_s": u_max, "rel_vs_cpu_f64": rel}
        print(f"  galewsky day {d}: {json.dumps(days[d])}; CPU f64 {GALEWSKY_CPU_F64[d]}; "
              f"the JAX example's table {gw.REFERENCE[d]}", flush=True)
        assert finite and rel <= GALEWSKY_RTOL, (d, days[d], GALEWSKY_CPU_F64[d])
        t_day = (time.perf_counter() - t0) / d
        if time.perf_counter() - t_main + t_day > GALEWSKY_DEADLINE_S:
            break
    assert launched(CS, RA) == (0, 0), launched(CS, RA)
    out = {"days": days, "seconds_a_day": t_day, "steps_a_day": int(round(86400.0 / gm.ts))}
    say("published-galewsky", t0,
        f"ShallowWaterSphere [3, 384, 512] f64 on cuda, ts {gm.ts} s, {len(days)} days of "
        f"{out['steps_a_day']} steps: {json.dumps(days)} against the same run on the CPU in "
        f"f64 (tol {GALEWSKY_RTOL}); the JAX example's table {json.dumps(gw.REFERENCE)}; "
        f"{t_day:.2f} s a day; no hand-written kernel on this path, the counts say 0")
    return out


class CliLinearAdvection:
    """Phase 33a's two processes, started here: python -m scythe_tpu_torch
    --dtype f64 -d 1 and -d 4 on the port's models/linear_advection_1d.py,
    each in a directory of its own with the IC file, side by side on the
    card; ``beside`` names what else ran meanwhile."""

    def __init__(self, tx, torch, tmp, beside=""):
        from scythe_tpu_torch import io as sio

        gp = tx.GridParameters(geometry="R", xmin=-50.0, xmax=50.0, num_cells=100,
                               BCL={"u": tx.BC.PERIODIC}, BCR={"u": tx.BC.PERIODIC},
                               vars={"u": 1})
        self.r = tx.create_grid(gp, torch.float64, device="cpu").r_mish
        self.beside = beside
        cfg = os.path.join(ROOT, "scythe_tpu_torch", "models", "linear_advection_1d.py")
        self.procs, self.dirs = {}, {}
        self.t0 = time.perf_counter()
        for d in (1, 4):
            cwd = self.dirs[d] = os.path.join(tmp, f"cli_{d}")
            os.makedirs(cwd)
            sio._write_csv(os.path.join(cwd, "1d_linear_advection_test_ics.csv"), ["r", "u"],
                           np.stack([self.r, np.exp(-(self.r / 20.0) ** 2)], 1))
            with open(os.path.join(cwd, "stdout.txt"), "w") as log:
                self.procs[d] = subprocess.Popen(
                    [sys.executable, "-m", "scythe_tpu_torch", "--dtype", "f64", "-d", str(d),
                     cfg], cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                    env={**os.environ, "PYTHONPATH": ROOT})

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_cli(tx, tmodel, tti, torch, cs, ra, tmp, cli_la):
    """Phase 33: the CLI (python -m scythe_tpu_torch) on the card: the port's
    models/linear_advection_1d.py as a subprocess at -d 1 and -d 4 in f64
    (``cli_la``, the CliLinearAdvection that started them; agree at 1e-12);
    the moist RLZ demo config in f32 through cli.main with exact launch
    counts; graft_entry.entry() one step; graft_entry.dryrun_multichip(4)."""
    from scythe_tpu_torch import cli, graft_entry

    out = {}
    models = os.path.join(ROOT, "scythe_tpu_torch", "models")
    # ---- 33a: the linear advection config at -d 1 and -d 4
    t0 = time.perf_counter()
    from scythe_tpu_torch import io as sio

    finals = {}
    for d, proc in cli_la.procs.items():
        rc = proc.wait(timeout=600)
        with open(os.path.join(cli_la.dirs[d], "stdout.txt")) as f:
            stdout = f.read()
        assert rc == 0, stdout[-3000:]
        assert "All done!" in stdout and "available device(s), using" in stdout
        _, finals[d] = sio._read_csv(os.path.join(cli_la.dirs[d], "linearAdvection1D_out",
                                                  "physical_out_100.0.csv"))
    secs = time.perf_counter() - cli_la.t0
    r = cli_la.r
    rel = float(np.abs(finals[4] - finals[1]).max() / np.abs(finals[1]).max())
    assert np.isfinite(finals[1]).all() and rel <= 1e-12, rel
    l2 = float(np.sqrt(np.sum((finals[1][:, 1] - np.exp(-(r / 20.0) ** 2)) ** 2)))
    out["linear_advection"] = {"rel_4_vs_1": rel, "l2_one_period": l2, "seconds": secs}
    say("cli-linear-advection", t0,
        f"python -m scythe_tpu_torch --dtype f64 -d 1 / -d 4 scythe_tpu_torch/models/"
        f"linear_advection_1d.py on cuda, 2,000 steps: -d 4 (4 thread-shards) vs -d 1 rel "
        f"err {rel:.3e} (tol 1e-12); L2(final - initial) after one period {l2:.3e}; both "
        f"processes side by side, {secs:.1f} s from their start to this check"
        + (f" ({cli_la.beside})" if cli_la.beside else ""))

    # ---- 33b: the moist RLZ demo config through the CLI, in this process
    t0 = time.perf_counter()
    cwd = os.path.join(tmp, "cli_moist")
    os.makedirs(os.path.join(cwd, "moist_rlz"))
    write_sounding(os.path.join(cwd, "moist_rlz", "sounding.txt"))
    demo = os.path.join(models, "moist_euler_rlz_demo.py")
    import runpy

    model = runpy.run_path(demo)["model"]
    pts = tx.create_grid(model.grid_params, torch.float64, device="cpu").gridpoints()
    rad = np.sqrt(((pts[:, 0] * np.cos(pts[:, 1]) - 8000.0) / 2000.0) ** 2
                  + (pts[:, 0] * np.sin(pts[:, 1]) / 2000.0) ** 2
                  + ((pts[:, 2] - 2000.0) / 2000.0) ** 2)
    write_ics(sio, os.path.join(cwd, "moist_rlz", "ics.csv"), ["r", "l", "z"], pts,
              {"s": 2.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2})
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with plain_version_calls(cs, ra) as plain:
            zero_counts(cs, ra)
            h0 = time.perf_counter()
            assert cli.main(["--dtype", "f32", demo]) == 0
            torch.cuda.synchronize()
            seconds = time.perf_counter() - h0
            launches = launched(CS, RA)
    finally:
        os.chdir(here)
    assert launches == (model.num_ts, model.num_ts + 1) == (2400, 2401), launches
    assert plain == [], sorted(set(plain))
    outs = sorted(f for f in os.listdir(os.path.join(cwd, "moist_rlz"))
                  if f.startswith("physical_out_"))
    assert len(outs) == 11, outs
    phys = sio.read_physical_grid(os.path.join(cwd, "moist_rlz", "physical_out_600.0.csv"),
                                  tx.create_grid(model.grid_params, torch.float64, device="cpu"))
    w_max = float(phys[MOIST3D_VARS.index("w")].max())
    assert phys.shape == (9, 48, 32, 40) and np.isfinite(phys).all() and w_max > 0.01, w_max
    out["moist_demo"] = {"launches": launches, "steps_per_s": model.num_ts / seconds,
                         "w_max": w_max}
    say("cli-moist-demo", t0,
        f"cli.main(['--dtype', 'f32', 'scythe_tpu_torch/models/moist_euler_rlz_demo.py']) "
        f"on cuda: MoistEulerRLZ [9, 48, 32, 40], {model.num_ts} steps: (column-solve, "
        f"analysis) launches {launches} (a solve of 1,536 x 40 columns a step, the analysis "
        f"kernel a step and once at set-up); plain-version calls 0; {len(outs)} outputs; "
        f"w.max {w_max:.4f} m/s; {model.num_ts / seconds:.2f} steps/s by the host clock "
        f"(outputs and set-up included)")

    # ---- 33c: the harness entry; the kernels at the dryrun's shapes
    t0 = time.perf_counter()
    fn, (state,) = graft_entry.entry(device="cuda")
    nxt = fn(state)
    assert nxt.spec.is_cuda and torch.isfinite(nxt.spec).all() and nxt.t == 2
    with kernel_shapes(torch, cs, ra) as seen:
        zero_counts(cs, ra)
        done = graft_entry.dryrun_multichip(DRYRUN_SHARDS, device="cuda")
        torch.cuda.synchronize()
        launches = launched(CS, RA)
    out["dryrun_multichip"] = {"steps": len(done), "launches": launches}
    assert len(done) == 19 and launches == DRYRUN_LAUNCHES, out["dryrun_multichip"]
    checked, lines = check_dryrun_kernels(tx, tmodel, tti, torch, cs, ra, tmp, DRYRUN_SHARDS)
    assert seen <= checked, (sorted(seen - checked), sorted(checked))
    say("graft-entry", t0,
        f"graft_entry.entry(): one flagship step [6, 35, 32] f32 on cuda, finite; "
        f"dryrun_multichip({DRYRUN_SHARDS}) on a ThreadMesh of {DRYRUN_SHARDS} on cuda: "
        f"{len(done)} groups ({done}), (column-solve, analysis) launches {launches} at "
        f"{sorted(seen)}; each of those shapes against its plain version after the run, on "
        f"the dryrun's own models (column solve as phase 3, analysis {ANALYSIS_TOL}): "
        + " | ".join(lines))
    return out


DRYRUN_SHARDS = 4
# column solves: one a shard a step of the RLZ, SLZ and XYZ groups, each on
# psum, halo and halo-pcr; analyses: one whole-grid set-up analysis a run
DRYRUN_LAUNCHES = (3 * 3 * DRYRUN_SHARDS, 3 * 3)


@contextlib.contextmanager
def kernel_shapes(torch, cs, ra):
    """The set of shapes the column-solve and analysis wrappers are called
    at inside the block: ("column_solve", [ncols, nz]) and ("rlz_analysis",
    physical shape, b_rDim), f32 plain mode only (asserted)."""
    from unittest import mock

    seen = set()
    apply, analysis = cs.apply_column_operator, ra.rlz_analysis

    def apply_seen(xstar, wstar, op):
        assert xstar.dtype == torch.float32 and not op.comp, (xstar.dtype, op.comp)
        seen.add(("column_solve", tuple(xstar.shape)))
        return apply(xstar, wstar, op)

    def analysis_seen(phys, l_analysis, ring_mask, analysis_r, analysis_z, mode="plain"):
        assert phys.dtype == torch.float32 and mode == "plain", (phys.dtype, mode)
        seen.add(("rlz_analysis", tuple(phys.shape), analysis_r.shape[-2]))
        return analysis(phys, l_analysis, ring_mask, analysis_r, analysis_z, mode)

    with mock.patch.object(cs, "apply_column_operator", apply_seen), \
            mock.patch.object(ra, "rlz_analysis", analysis_seen):
        yield seen


def check_dryrun_kernels(tx, tmodel, tti, torch, cs, ra, tmp, n):
    """Both kernels at the shapes dryrun_multichip(n) gives them, on its own
    moist models (graft_entry.dryrun_models): the column solve at a shard's
    columns (rDim / n x nl, by nz), both stages, f64 and f32, as phase 3
    (check_stage, on the model's depth, ts and Pxi_bar), and the analysis of
    the whole grid (the dryrun's set-up analysis), as phase 4
    (check_analysis); returns (the shapes checked, as kernel_shapes records
    them; a line a model)."""
    from scythe_tpu_torch import graft_entry

    rng = np.random.default_rng(33)
    checked, lines = set(), []
    for m in graft_entry.dryrun_models(os.path.join(tmp, "dryrun_check"), n):
        gp = m.grid_params
        g64 = tx.create_grid(gp, torch.float64, device="cuda")
        g32 = tx.create_grid(gp, torch.float32, device="cuda")
        pxi = float(tmodel.build_context(m, tx.create_grid(gp, torch.float64, device="cpu"),
                                         torch.float64).ref_state.Pxi_bar)
        ncols, nz = gp.rDim // n * g64.nl, gp.zDim
        o64, o32 = (tti.build_semiimplicit_ops(nz, 0.0, gp.zmax, None, pxi, m.ts, dt, "cuda")
                    for dt in (torch.float64, torch.float32))
        x = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        w = torch.from_numpy(rng.normal(size=(ncols, nz))).cuda()
        errs = [check_stage(torch, cs, o64, o32, x, w, stage, pxi)[0]
                for stage in ("t1", "ab")]
        phys = torch.from_numpy(rng.normal(size=(g64.nvars,) + g64.spatial_shape)).cuda()
        _, line = check_analysis(
            torch, ra, "dryrun", g64, phys,
            (g64.l_analysis, g64.ring_mask, g64.analysis_r, g64.analysis_z),
            (g32.l_analysis, g32.ring_mask, g32.analysis_r, g32.analysis_z))
        checked |= {("column_solve", (ncols, nz)),
                    ("rlz_analysis", tuple(phys.shape), g64.params.b_rDim)}
        lines.append(
            f"{gp.geometry} column solve {ncols} x {nz}, both stages: rel err f64 "
            f"{max(e['f64'] for e in errs):.2e}, f32 {max(e['f32'] for e in errs):.2e} "
            f"({max(e['f32 / plain f32'] for e in errs):.2f}x the plain f32 chain's); "
            f"analysis {line}")
    return checked, lines


# ---------------------------------------------------------------- graphs
# The graphs group (phase 35, run after the kernels group and before the
# paths): make_scan's captured steady step against its eager loop.
GRAPH_STEPS = 30  # steps of each path compared, from the same state at t = 3
GRAPH_TIMED_STEPS = 40  # steps a timed run, four runs in turns
GRAPH_PROFILE_STEPS = (4, 14)  # the two lengths whose difference gives a step
# graph against eager from one state: f64 within 1e-13 of each slot's max
# (expected bitwise: the same kernels in the same order); f32 bitwise or
# within GRAPH_F32_BOUND of each slot's max over GRAPH_STEPS steps (cuBLAS may
# take another algorithm inside a capture, as its workspace differs)
GRAPH_F64_TOL = 1e-13
GRAPH_F32_BOUND = 1e-5
SWEEP_STEPS = 6


def slot_rel(a, b):
    """max|a - b| / max|b| of each of the five state tensors, and whether
    all five are equal bit for bit."""
    rel = []
    for x, y in zip(a[:5], b[:5]):
        scale = float(y.abs().max())
        err = float((x - y).abs().max())
        rel.append(err / scale if scale > 0.0 else err)
    return rel, all(bool((x == y).all()) for x, y in zip(a[:5], b[:5]))


def kernel_counts(cs, ra):
    return {"column_solve": launched(CS), "column_solve_comp": launched(CS_COMP),
            "rlz_analysis": launched(RA), "rlz_analysis_comp": launched(RA_COMP)}


def graph_nodes(graph):
    """{"nodes": n, "kernel_nodes": k, ...} of a captured
    torch.cuda.CUDAGraph, read by libcuda's cuGraphGetNodes; None
    where this torch cannot hand out its cudaGraph_t."""
    import ctypes

    if not hasattr(graph, "raw_cuda_graph"):
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    kinds = {}
    for node in nodes:
        t = ctypes.c_int()
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        # CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset, 3 host, 4 graph, 5 empty
        name = {0: "kernel_nodes", 1: "memcpy_nodes", 2: "memset_nodes"}.get(
            t.value, f"type{t.value}_nodes")
        kinds[name] = kinds.get(name, 0) + 1
    return {"nodes": n.value, **kinds}


def path_profile(torch, run, n_short, n_long):
    """({kernel name: launches a step}, device busy us a step) of ``run(n)``
    from the difference of two lengths under torch.profiler."""
    reads = {n: launches_by_kernel(torch, lambda: run(n)) for n in (n_short, n_long)}
    (s, bs), (l_, bl) = reads[n_short], reads[n_long]
    d = n_long - n_short
    per = {k: (l_.get(k, 0) - s.get(k, 0)) / d for k in set(s) | set(l_)}
    return {k: v for k, v in per.items() if v}, (bl - bs) / d


def graph_case_state(tx, tmodel, torch, name, tmp, sh, jwx, cb):
    """(step, state at t = 1, dtype, {kernel: launches a step}) of the graphs
    group's configuration ``name`` at full width on the card."""
    f32, f64 = torch.float32, torch.float64
    if name == "flagship":
        fm = cb.flagship_model(100, 256)
        g = tx.create_grid(fm.grid_params, f32, device="cuda")
        step = tmodel.build_step(fm, g, tmodel.build_context(fm, g, f32), f32)
        return step, cb.vortex_state(g, f32), f32, {}
    if name == "flagship_ensemble":
        fm = cb.flagship_model(100, 256)
        g = tx.create_grid(fm.grid_params, f32, device="cuda")
        step = tmodel.batched_step(
            tmodel.build_step(fm, g, tmodel.build_context(fm, g, f32), f32))
        base = cb.vortex_phys(g)
        ics = torch.as_tensor(np.stack([base * (1.0 + i / 100.0)
                                        for i in range(FLAGSHIP_MEMBERS)]),
                              dtype=f32, device="cuda")
        state = tmodel.ensemble_state(torch.func.vmap(g.analysis)(ics), ics.shape)
        return step, state, f32, {}
    if name.startswith("moist3d") or name == "comp_moist3d":
        dtype = f64 if name == "moist3d_f64" else f32
        m = moist3d(tx, tmp, n_steps=GRAPH_STEPS, out_every=GRAPH_STEPS, name=f"g_{name}")
        with compensated_grids() if name == "comp_moist3d" else contextlib.nullcontext():
            grid, ctx, state = tmodel.initialize(m, dtype, "cuda")
        per = ({"column_solve": 1, "rlz_analysis_comp": 1} if name == "comp_moist3d"
               else {"column_solve": 1, "rlz_analysis": 1})
        return tmodel.build_step(m, grid, ctx, dtype), state, dtype, per
    if name == "tc_mature":
        from scythe_tpu_torch.examples.tc_intensification_rlz import tc_mature_model

        m = tc_mature_model(os.path.join(tmp, "g_tc"), t_end=2.0 * GRAPH_STEPS,
                            output_interval=2.0 * GRAPH_STEPS)
        grid, ctx, state = tmodel.initialize(m, f32, "cuda")
        return (tmodel.build_step(m, grid, ctx, f32), state, f32,
                {"column_solve": 1, "rlz_analysis": 1})
    if name in ("shower", "shower_production"):
        m = shower(tx, sh, os.path.join(tmp, f"g_{name}"), GRAPH_STEPS,
                   "moist_production" if name == "shower_production" else None)
        grid, ctx, state = tmodel.initialize(m, f32, "cuda")
        return (tmodel.build_step(m, grid, ctx, f32), state, f32,
                {"column_solve": 1, "rlz_analysis": 1})
    if name == "jw06_production":
        m = jwx.production_model(os.path.join(tmp, "g_jw06"), t_end=7.5 * GRAPH_STEPS)
        g64 = tx.create_grid(m.grid_params, f64, device="cpu")
        c64 = tmodel.build_context(m, g64, f64)
        phys0 = jwx.initial_fields(g64, c64.ref_state, perturb=True)
        _, _, state, step = jwx.prepare_run(m, phys0, f32, "cuda")
        return step, state, f32, {"column_solve": 1, "rlz_analysis": 2}
    raise KeyError(name)


GRAPH_CASES = ("flagship", "moist3d", "moist3d_f64", "tc_mature", "shower",
               "shower_production", "jw06_production", "comp_moist3d", "flagship_ensemble")
GRAPH_MEMORY_CASES = ("moist3d", "jw06_production", "flagship_ensemble")


def graph_against_eager(torch, tmodel, graphs, cs, ra, name, step, state, dtype, per_step):
    """The graphs group's checks and readings of one configuration."""
    n = GRAPH_STEPS
    s3 = tmodel.make_scan(step, 2)(state)  # the start-up steps: eager on every path
    assert s3.t == 3 and not graphs.captured(step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_reserved()
    zero_counts(cs, ra)
    with plain_version_calls(cs, ra) as plain_first:
        g1 = tmodel.make_scan(step, n)(s3)  # captures: its warm-up is the first steady step
    torch.cuda.synchronize()
    first = kernel_counts(cs, ra)
    (runner,) = graphs.captured(step).values()
    assert runner.replays == n - 1, runner.replays
    memory = {"reserved_before_gb": mem0 / 1e9,
              "reserved_after_capture_gb": torch.cuda.memory_reserved() / 1e9,
              "allocated_gb": torch.cuda.memory_allocated() / 1e9,
              "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    nodes = graph_nodes(runner.replay.__self__)
    paths = {}
    for label in ("graph", "eager"):
        zero_counts(cs, ra)
        with (graphs.disable_graphs() if label == "eager" else contextlib.nullcontext()), \
                plain_version_calls(cs, ra) as plain:
            paths[label] = (tmodel.make_scan(step, n)(s3), kernel_counts(cs, ra), list(plain))
    assert len(graphs.captured(step)) == 1 and runner.replays == 2 * n - 1, runner.replays
    (sg, cg, pg), (se, ce, pe) = paths["graph"], paths["eager"]
    want = {k: per_step.get(k, 0) * n for k in ce}
    assert ce == cg == first == want, (ce, cg, first, want)
    assert not (pg or pe or plain_first), (pg, pe, plain_first)
    assert sg.t == se.t == g1.t == 3 + n
    rel, bitwise = slot_rel(sg, se)
    rel1, bitwise1 = slot_rel(g1, se)
    bound = GRAPH_F64_TOL if dtype == torch.float64 else GRAPH_F32_BOUND
    assert all(np.isfinite(rel)) and max(rel + rel1) <= bound, (rel, rel1, bound)
    # a kept state never changes under a later replay
    kept = g1.spec.clone()
    tmodel.make_scan(step, 3)(sg)
    assert torch.equal(kept, g1.spec)

    # launches, busy and idle a step of both paths (torch.profiler), then
    # steps/s of both, taken in turns
    prof = {}
    for label in ("eager", "graph"):
        ctx = graphs.disable_graphs() if label == "eager" else contextlib.nullcontext()
        with ctx:
            per, busy = path_profile(torch, lambda k: tmodel.make_scan(step, k)(s3),
                                     *GRAPH_PROFILE_STEPS)
        prof[label] = {"launches_per_step": sum(per.values()), "busy_us": busy,
                       "by_kernel": {k[:60]: round(v, 3) for k, v in per.items()
                                     if "column_solve" in k or "rlz_analysis" in k}}
    sps = {"eager": [], "graph": []}
    for label in ("eager", "graph", "graph", "eager"):
        ctx = graphs.disable_graphs() if label == "eager" else contextlib.nullcontext()
        with ctx:
            tmodel.make_scan(step, 3)(s3)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            tmodel.make_scan(step, GRAPH_TIMED_STEPS)(s3)
            torch.cuda.synchronize()
        sps[label].append(GRAPH_TIMED_STEPS / (time.perf_counter() - h0))
    # the device's idle share: busy a step (profiled) over the wall time a
    # step of the unprofiled timed runs, each of the two
    for label in prof:
        prof[label]["wall_us"] = [1e6 / r for r in sps[label]]
        prof[label]["idle_share"] = [max(0.0, 1.0 - prof[label]["busy_us"] * r / 1e6)
                                     for r in sps[label]]
    return {"launches": ce, "plain_version_calls": len(pg) + len(pe), "rel": rel,
            "bitwise": bitwise, "rel_with_warm_up": rel1, "bitwise_with_warm_up": bitwise1,
            "replays_first_interval": n - 1, "replays_later_interval": n,
            "memory": memory, "graph_nodes": nodes, "profile": prof, "steps_per_s": sps}


def sweep_cases(tx, tmodel, wm, jwx, tmp):
    """The capture sweep: every one of the 21 equation sets at a small size,
    with every option of build_step somewhere among them.  Each case is
    (label, model, dtype, compensated, phys0 or None); phys0 None: the
    model's IC file through initialize."""
    import torch
    from scythe_tpu_torch import io as sio

    f64, BC = torch.float64, tx.BC
    cases = []

    def add(label, eqset, gp, params, ts, ic, options=None, sounding=False,
            dtype=f64, comp=False):
        pts = tx.create_grid(gp, f64, device="cpu").gridpoints()
        cols = ic(pts)
        names = list(gp.vars)
        data = np.zeros((len(pts), pts.shape[1] + len(names)))
        data[:, :pts.shape[1]] = pts
        for j, v in enumerate(names):
            if v in cols:
                data[:, pts.shape[1] + j] = cols[v]
        ics = os.path.join(tmp, f"sweep_{label}_ics.csv")
        sio._write_csv(ics, [f"c{i}" for i in range(pts.shape[1])] + names, data)
        snd = ""
        if sounding:
            snd = os.path.join(tmp, f"sweep_{label}_sounding.txt")
            write_sounding(snd)
        model = tx.ModelParameters(
            ts=ts, integration_time=SWEEP_STEPS * ts, output_interval=SWEEP_STEPS * ts,
            equation_set=eqset, initial_conditions=ics,
            output_dir=os.path.join(tmp, f"sweep_{label}_out"), ref_state_file=snd,
            grid_params=gp, physical_params=params, options=options or {})
        cases.append((label, model, dtype, comp, None))

    def blob(pts):
        r = pts[:, 0]
        return {"u": np.exp(-(((r - 50.0) / 20.0) ** 2)),
                "h": np.exp(-(((r - 50.0) / 20.0) ** 2)), "v": 2.0 * np.pi / 100.0 * r,
                "w": 0.5 + 0.0 * r} if pts.shape[1] > 1 else {
                    "u": np.exp(-(((r - 50.0) / 20.0) ** 2))}

    def bump(pts):
        r = pts[:, 0]
        lam = pts[:, 1] if pts.shape[1] > 1 else 0.0
        return {"h": 10.0 * np.exp(-(((r - 4.0e4) / 1.5e4) ** 2)) * (1.0 + 0.3 * np.cos(lam))}

    def vortex(pts):
        r, lam = pts[:, 0], pts[:, 1]
        rm, vm = 5.0e4, 20.0
        v = np.where(r < rm, vm * r / rm, vm * rm / r) * (1.0 + 0.05 * np.cos(2 * lam))
        r_u = np.unique(r)
        v_u = np.where(r_u < rm, vm * r_u / rm, vm * rm / r_u)
        dh = (5.0e-5 * v_u + v_u**2 / r_u) / 9.81
        h_u = np.concatenate([[0.0], np.cumsum(0.5 * (dh[1:] + dh[:-1]) * np.diff(r_u))])
        return {"h": h_u[np.searchsorted(r_u, r)], "v": v, "vb": 0.8 * v}

    def bubble(pts):
        r, z = pts[:, 0], pts[:, -1]
        rad = np.sqrt((r / 2000.0) ** 2 + ((z - 2000.0) / 2000.0) ** 2)
        return {"s": 3.0 * np.maximum(0.0, np.cos(np.pi * np.minimum(rad, 1.0) / 2.0)) ** 2}

    def gradient_wind(pts):
        r = pts[:, 0]
        vgr = np.where(r < 5.0e4, 30.0 * r / 5.0e4, 30.0 * 5.0e4 / r)
        return {"vgr": vgr, "v": vgr}

    def adv(geometry, names, **kw):
        extra = ({"BCL": {"u": BC.PERIODIC}, "BCR": {"u": BC.PERIODIC}}
                 if geometry == "R" else {"BCL": {"h": BC.R1T1}})
        return tx.GridParameters(geometry=geometry, vars=names, xmin=0.0, xmax=100.0, **extra,
                                 **kw)

    def hvu(geometry, **kw):
        names = ("h", "u", "v") if geometry == "RL" else ("h", "u")
        return tx.GridParameters(
            geometry=geometry, xmin=0.0, xmax=1.0e5, num_cells=10, vars=names,
            BCL={"h": BC.R1T1, "u": BC.R1T0, "v": BC.R1T0},
            BCR={"h": BC.R0, "u": BC.R1T1, "v": BC.R0}, **kw)

    def slab(**kw):
        return tx.GridParameters(
            geometry="RL", xmin=0.0, xmax=3.0e5, num_cells=8, lDim=16,
            BCL={"h": BC.R1T1, "u": BC.R1T0, "v": BC.R1T0, "ub": BC.R1T0, "vb": BC.R1T0,
                 "wb": BC.R1T1},
            BCR={"h": BC.R0, "u": BC.R1T1, "v": BC.R0, "ub": BC.R1T1, "vb": BC.R0,
                 "wb": BC.R0},
            vars={"h": 1, "u": 2, "v": 3, "ub": 4, "vb": 5, "wb": 6}, **kw)

    def rz(names):
        return tx.GridParameters(
            geometry="RZ", xmin=0.0, xmax=10000.0, num_cells=10, zmin=0.0, zmax=10000.0,
            zDim=16, BCL={"u": BC.R1T0, "w": BC.R1T1}, BCR={"u": BC.R1T0}, vars=names)

    def tcbl(geometry, **kw):
        return tx.GridParameters(
            geometry=geometry, xmin=0.0, xmax=2.0e5, num_cells=16,
            BCL={"vgr": BC.R1T0, "u": BC.R1T0, "v": BC.R1T0, "w": BC.R1T1},
            BCR={"vgr": BC.R0, "u": BC.R1T1, "v": BC.R0, "w": BC.R0},
            vars=("vgr", "u", "v", "w"), **kw)

    euler = ("s", "xi", "mu", "u", "w")
    slab_p = {"g": 9.81, "K": 5000.0, "Cd": 2.4e-3, "Hfree": 2000.0, "Hb": 1000.0,
              "f": 5.0e-5}
    tcbl_p = {"K": 1500.0, "Cd": 2.4e-3, "h": 1000.0, "f": 5.0e-5}
    add("LinearAdvection1D", "LinearAdvection1D", adv("R", ("u",), num_cells=24),
        {"c_0": 1.0, "K": 0.5}, 0.05, blob)
    add("LinearAdvectionRZ", "LinearAdvectionRZ",
        adv("RZ", ("h", "u", "v", "w"), num_cells=10, zmin=0.0, zmax=100.0, zDim=12),
        {"K": 0.5}, 0.05, blob,
        {"modal_filter_tau": 10.0, "modal_filter_axes": "rz", "sponge_top_width": 20.0,
         "sponge_top_tau": 5.0})
    add("LinearAdvectionRL", "LinearAdvectionRL",
        adv("RL", ("h", "u", "v"), num_cells=10, lDim=16), {"K": 0.5}, 0.05, blob)
    add("LinearAdvectionRLZ", "LinearAdvectionRLZ",
        adv("RLZ", ("h", "u", "v"), num_cells=8, lDim=16, zmin=0.0, zmax=50.0, zDim=8),
        {"K": 0.5}, 0.05, blob, {"modal_filter_tau": 10.0})
    add("LinearShallowWater1D", "LinearShallowWater1D", hvu("R"),
        {"g": 9.81, "K": 100.0, "H": 100.0}, 5.0, bump,
        {"sponge_width": 2.0e4, "sponge_tau": 300.0})
    add("LinearShallowWaterRL", "LinearShallowWaterRL", hvu("RL", lDim=16),
        {"g": 9.81, "K": 100.0, "H": 100.0}, 5.0, bump, {"radiation_width": 2.0e4})
    add("ShallowWaterRL", "ShallowWaterRL", hvu("RL", lDim=16),
        {"g": 9.81, "K": 100.0, "H": 100.0, "f": 5.0e-5}, 5.0, bump,
        {"modal_filter_tau": 600.0, "incremental_analysis": True})
    add("Oneway_ShallowWater_Slab", "Oneway_ShallowWater_Slab", slab(), slab_p, 3.0, vortex)
    add("Twoway_ShallowWater_Slab", "Twoway_ShallowWater_Slab", slab(),
        {**slab_p, "S1": 1.0e-5}, 3.0, vortex,
        {"sponge_width": 5.0e4, "radiation_width": 3.0e4})
    add("Twoway_ShallowWater_Slab_factored", "Twoway_ShallowWater_Slab",
        slab(l_factored=True), {**slab_p, "S1": 1.0e-5}, 3.0, vortex)
    add("Twoway_ShallowWater_Slab_compensated", "Twoway_ShallowWater_Slab", slab(),
        {**slab_p, "S1": 1.0e-5}, 3.0, vortex, dtype=torch.float32, comp=True)
    cases.append(("Oneway_ShallowWater_HeightResolvedBL", hrbl_model(tx, tmp, SWEEP_STEPS),
                  f64, False, None))
    add("Euler_test", "Euler_test", rz(euler), {"K": 5.0}, 0.2, bubble,
        {"semiimplicit": True, "si_mode": "variable"}, sounding=True)
    add("BF02_test", "BF02_test", rz(euler + ("mu_l", "qss")), {"K": 5.0}, 0.1, bubble,
        {"semiimplicit": True, "condensation": "diagnostic", "exact_vertical_pgf": True,
         "stiff_relaxation": "exp"}, sounding=True)
    add("rainfall_test", "rainfall_test", rz(euler + ("mu_c", "mu_r", "qss")), {"K": 5.0},
        0.2, bubble,
        {"semiimplicit": True, "condensation": "diagnostic", "sedimentation": "active",
         "stiff_relaxation": "exp", "condensation_rate_cap": 1.0e-4,
         "exact_vertical_pgf": True}, sounding=True)
    add("Williams2013_slabTCBL", "Williams2013_slabTCBL", tcbl("R"), tcbl_p, 5.0,
        gradient_wind)
    add("RL_SlabTCBL", "RL_SlabTCBL", tcbl("RL", lDim=8), tcbl_p, 5.0, gradient_wind)
    add("Kepert2017_TCBL", "Kepert2017_TCBL", tcbl("RZ", zmin=0.0, zmax=2000.0, zDim=12),
        {"K": 1500.0, "Cd": 2.4e-3, "f": 5.0e-5}, 0.2, gradient_wind)
    from scythe_tpu_torch.examples.tc_intensification_rlz import tc_mature_model

    # the TC bundle: sponge, surface fluxes, Smagorinsky + implicit vertical
    # diffusion, diagnostic condensation with its cap, active sedimentation
    cases.append(("MoistEulerRLZ_tc_bundle",
                  tc_mature_model(os.path.join(tmp, "sweep_tc"), t_end=4.0 * SWEEP_STEPS,
                                  output_interval=4.0 * SWEEP_STEPS, num_cells=16, ts=4.0),
                  f64, False, None))
    cases.append(("MoistEulerRLZ_compensated", small(tx, tmp, SWEEP_STEPS), torch.float32,
                  True, None))
    xm = xyz_test_model(tx, tmp, SWEEP_STEPS, name="sweep_xyz")
    cases.append(("MoistEulerXYZ", xm.with_(options={
        **dict(xm.options), "sedimentation": "active", "smagorinsky": 0.2,
        "implicit_vdiff": True, "sponge_top_width": 3000.0}), f64, False, None))
    jm = jwx.build_model(os.path.join(tmp, "sweep_jw06"), num_cells=8, nl=16, zdim=12,
                         ts=7.5, t_end=7.5 * SWEEP_STEPS, filter_tau=3600.0, smag=0.21,
                         sponge_top=12.0e3, k4=6.0e16)
    g64 = tx.create_grid(jm.grid_params, f64, device="cpu")
    phys0 = jwx.initial_fields(g64, tmodel.build_context(jm, g64, f64).ref_state,
                               perturb=True)
    cases.append(("MoistEulerSLZ", jm, f64, False, phys0))
    add("ShallowWaterSphere", "ShallowWaterSphere",
        tx.GridParameters(geometry="SL", xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=12,
                          lDim=24, sphere_radius=wm.A_EARTH, vars=("h", "u", "v")),
        {"g": wm.G, "Omega": wm.OMEGA, "K": 1.0e5}, 300.0,
        lambda pts: dict(zip("huv", wm.w6_fields(pts[:, 0], pts[:, 1]))))
    add("AdvectionSphere", "AdvectionSphere",
        tx.GridParameters(geometry="SL", xmin=-np.pi / 2, xmax=np.pi / 2, num_cells=12,
                          lDim=24, sphere_radius=wm.A_EARTH, vars=("h",)),
        {"u0": 2 * np.pi * wm.A_EARTH / (12 * 86400.0), "alpha": np.pi / 2}, 300.0,
        lambda pts: {"h": wm.w1_bell(pts[:, 0], pts[:, 1])})
    return cases


def sweep_run(tmodel, torch, graphs, jwx, case):
    """(graph against eager rel per slot, bitwise) of one sweep case:
    SWEEP_STEPS steps of each path on the card from the state at t = 3."""
    label, model, dtype, comp, phys0 = case
    with compensated_grids() if comp else contextlib.nullcontext():
        if phys0 is None:
            grid, ctx, state = tmodel.initialize(model, dtype, "cuda")
            step = tmodel.build_step(model, grid, ctx, dtype)
        else:
            grid, ctx, state, step = jwx.prepare_run(model, phys0, dtype, "cuda")
    assert grid.comp == comp, label
    s3 = tmodel.make_scan(step, 2)(state)
    with graphs.disable_graphs():
        se = tmodel.make_scan(step, SWEEP_STEPS)(s3)
    sg = tmodel.make_scan(step, SWEEP_STEPS)(s3)
    (runner,) = graphs.captured(step).values()
    assert runner.replays == SWEEP_STEPS - 1, label
    rel, bitwise = slot_rel(sg, se)
    bound = GRAPH_F64_TOL if dtype == torch.float64 else GRAPH_F32_BOUND
    assert all(np.isfinite(rel)) and max(rel) <= bound, (label, rel, bound)
    return step, s3, rel, bitwise


def phase_graphs(tx, tmodel, torch, cs, ra, cb, sh, jwx, wm, tmp, card):
    """Phase 35: make_scan's captured steady step on the card.  Returns a
    dict for the closing line."""
    import gc

    from scythe_tpu_torch import graphs

    out = {"cases": {}}
    for name in GRAPH_CASES:
        t0 = time.perf_counter()
        step, state, dtype, per = graph_case_state(tx, tmodel, torch, name, tmp, sh, jwx, cb)
        r = graph_against_eager(torch, tmodel, graphs, cs, ra, name, step, state, dtype, per)
        out["cases"][name] = r
        p = r["profile"]
        say(f"graph-{name}", t0,
            f"{GRAPH_STEPS} steps from t = 3 in {dtype}, eager (disable_graphs) vs the "
            f"captured steady step: rel per state slot {[f'{x:.2e}' for x in r['rel']]} "
            f"(bitwise {r['bitwise']}; with the capture's warm-up step "
            f"{[f'{x:.2e}' for x in r['rel_with_warm_up']]}; tol "
            f"{GRAPH_F64_TOL if dtype == torch.float64 else GRAPH_F32_BOUND}); kernel "
            f"launches on both paths {json.dumps(r['launches'])}, plain-version calls "
            f"{r['plain_version_calls']}; replays {r['replays_first_interval']} in the "
            f"capturing interval, {r['replays_later_interval']} in the next; graph nodes "
            f"{json.dumps(r['graph_nodes'])}; torch.profiler a step (steps "
            f"{GRAPH_PROFILE_STEPS[1]} - {GRAPH_PROFILE_STEPS[0]}): eager "
            f"{p['eager']['launches_per_step']:.1f} launches, busy "
            f"{p['eager']['busy_us']:.1f} us (idle share of the timed runs "
            f"{[round(x, 4) for x in p['eager']['idle_share']]}), graph "
            f"{p['graph']['launches_per_step']:.1f} launches, busy "
            f"{p['graph']['busy_us']:.1f} us (idle "
            f"{[round(x, 4) for x in p['graph']['idle_share']]}); kernels by name eager "
            f"{json.dumps(p['eager']['by_kernel'])} graph {json.dumps(p['graph']['by_kernel'])};"
            f" steps/s ({GRAPH_TIMED_STEPS} steps, host clock, in turns eager, graph, graph, "
            f"eager) eager {r['steps_per_s']['eager']} graph {r['steps_per_s']['graph']}"
            + (f"; memory after the capture {json.dumps(r['memory'])}"
               if name in GRAPH_MEMORY_CASES else "") + f" on {card}")
        del step, state
        gc.collect()

    # the batched LU of the implicit vertical diffusion, captured alone
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lu = {}
    for dtype in (torch.float32, torch.float64):
        m = (torch.eye(24, dtype=dtype, device="cuda")
             + 0.1 * torch.randn(1200, 24, 24, dtype=dtype, device="cuda", generator=gen))
        rhs = torch.randn(1200, 24, 7, dtype=dtype, device="cuda", generator=gen)
        ref = tmodel.batched_solve(m, rhs)
        box = {}

        def solve():
            box["x"] = tmodel.batched_solve(m, rhs)

        graphs.CUDA_GRAPH.warm(solve, m.device)
        replay = graphs.CUDA_GRAPH.capture(solve, m.device, [m, rhs])
        replay()
        torch.cuda.synchronize()
        lu[str(dtype)] = bool(torch.equal(box["x"], ref))
        assert float((box["x"] - ref).abs().max()) <= (1e-12 if dtype == torch.float64
                                                        else 1e-5), dtype
    out["lu_bitwise"] = lu
    say("graph-batched-lu", t0,
        f"model.batched_solve (torch.linalg.solve_ex, cuBLAS's batched LU) on "
        f"[1200, 24, 24] x [1200, 24, 7] captured in a CUDA graph and replayed against the "
        f"eager call: bitwise {json.dumps(lu)}")

    # the capture sweep: every equation set's steady step at a small size
    t0 = time.perf_counter()
    sweep = {}
    for case in sweep_cases(tx, tmodel, wm, jwx, tmp):
        step, s3, rel, bitwise = sweep_run(tmodel, torch, graphs, jwx, case)
        sweep[case[0]] = {"max_rel": max(rel), "bitwise": bitwise}
    sets = {case.split("_compensated")[0].split("_factored")[0].split("_tc_bundle")[0]
            for case in sweep}
    assert len(sets) == 21, sorted(sets)
    out["sweep"] = sweep
    say("graph-capture-sweep", t0,
        f"the steady step of all {len(sets)} equation sets (and the compensated and "
        f"factored grids) captured at small sizes, {SWEEP_STEPS} steps graph vs eager: "
        f"{json.dumps(sweep)}")

    # a step that cannot be captured raises, naming its op; the card goes on
    t0 = time.perf_counter()

    def syncing(st):
        new = step(st)
        if float(new.spec.abs().max()) < 0.0:  # a host read: waits for the card
            raise AssertionError
        return new

    try:
        tmodel.make_scan(syncing, 4)(s3)
    except graphs.GraphCaptureError as e:
        msg = str(e)
    else:
        raise AssertionError("a step with a host read was captured")
    assert "chip_smoke.py" in msg and not graphs.captured(syncing), msg
    # the failed capture gave the stream back: this thread is on the default
    # stream again, ordered with every other thread's (ThreadMesh shards)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    again = tmodel.make_scan(step, 4)(s3)
    assert torch.isfinite(again.spec).all()
    say("graph-refuses-a-host-read", t0,
        f"a step that reads a value on the host raised GraphCaptureError: {msg[:300]!r}; "
        f"the thread is back on the default stream, and the same step without the read "
        f"then replayed")
    return out


COND_SHAPES = {"tc": (300, 4, 24), "jw06": (144, 96, 24)}
# the TC's options first: the mode every timing runs in
COND_MODES = {"diagnostic": {"condensation": "diagnostic", "condensation_rate_cap": 2.0e-4,
                             "condensation_tau": 30.0},
              "default": {}}
COND_OUT_ROWS = ("s", "mu", "mu_c")
# the kernel against the plain chain in the same type, per output row, over
# its max: tests/test_torch_condensation_cuda.py's limits
COND_F64_REL = 1e-13
COND_F32_ULPS = 16  # of the row's max, 2**-23 relative each
COND_GRAPH_CALLS = 20  # calls a graph, so a replay's launch is spread over them


def graph_of(torch, fn, calls):
    """The replay of a CUDA graph of ``calls`` calls of ``fn``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    return graph.replay


def phase_condensation(torch, tmp, built):
    """Phase 36: the condensation kernel against its plain chain, then timed;
    returns {"errors": {case: {row: rel}}, "times": {case: [...]}, "ptxas": [...]}."""
    from types import SimpleNamespace

    from scythe_tpu_torch.equations.common import EqContext
    from scythe_tpu_torch.examples.tc_intensification_rlz import ZTOP, jordan_sounding
    from scythe_tpu_torch.ops import condensation as cn
    from scythe_tpu_torch.physics import microphysics as mp
    from scythe_tpu_torch.physics import reference_state as trs

    t0 = time.perf_counter()
    snd = jordan_sounding(os.path.join(tmp, "condensation_sounding.txt"), 0.9, 20.0)
    rng = np.random.default_rng(36)
    rows = [(name, MOIST3D_VARS.index(name)) for name in COND_OUT_ROWS]
    grid = SimpleNamespace(params=SimpleNamespace(vars=MOIST3D_VARS))
    errs, times = {}, {}
    for shape_name, spatial in COND_SHAPES.items():
        x = np.zeros((9,) + spatial)
        x[0] = rng.normal(0.0, 3.0, spatial)
        x[1] = rng.normal(0.0, 0.01, spatial)
        x[2] = rng.normal(0.0, 2e-3, spatial)
        x[3:6] = rng.normal(0.0, 10.0, (3,) + spatial)
        x[6] = np.abs(rng.normal(0.0, 1e-3, spatial))
        x[7] = np.abs(rng.normal(0.0, 1e-3, spatial))
        x[8] = rng.normal(0.0, 1e-4, spatial)
        npts = int(np.prod(spatial))
        for dtype in (torch.float32, torch.float64):
            dname = "f32" if dtype == torch.float32 else "f64"
            rs = trs.interpolate_reference_file(snd, 0.0, ZTOP, 24, 16, dtype, device="cuda")
            # laid out as the step's state: [a][variable][rest] in memory
            var = torch.from_numpy(x).to(device="cuda", dtype=dtype)
            var = var.transpose(0, 1).contiguous().transpose(0, 1)
            for mode, options in COND_MODES.items():
                ctx = EqContext(grid=grid, coords={}, params={}, options=options, ts=2.0,
                                var_index=MOIST3D_VARS.index, ref_state=rs)
                prm = mp.condensation_params(ctx)
                plain = mp.condensation_adjustment_plain(var, rs.sbar, rs.xibar, rs.mubar, prm)
                work = var.clone()
                zero_counts(cn)
                out = mp.condensation_adjustment(work, None, ctx)
                torch.cuda.synchronize()
                assert out is work and launched(CN, CN_PLAIN) == (1, 0), (
                    launched(CN), launched(CN_PLAIN))
                rel = {name: float((out[v] - plain[v]).abs().max() / plain[v].abs().max())
                       for name, v in rows}
                limit = COND_F64_REL if dname == "f64" else COND_F32_ULPS * 2.0**-23
                assert max(rel.values()) <= limit, (shape_name, dname, mode, rel, limit)
                errs[f"{shape_name} {dname} {mode}"] = rel
            # timed in the TC's mode: device time queued, and in a graph.  The
            # kernel adjusts in place, and the adjustment applied over and
            # over to one state (no dynamics between) turns non-finite after
            # a few hundred calls, the plain chain's too; so each kernel call
            # starts from a copy of the input, and the copy's own time,
            # timed alone, is taken off
            ctx = EqContext(grid=grid, coords={}, params={}, options=COND_MODES["diagnostic"],
                            ts=2.0, var_index=MOIST3D_VARS.index, ref_state=rs)
            prm = mp.condensation_params(ctx)
            work = var.clone()

            def copy():
                work.copy_(var)

            def kernel():
                work.copy_(var)
                cn.condensation_adjust(work, rs.sbar, rs.xibar, rs.mubar, prm)

            def plain():
                mp.condensation_adjustment_plain(var, rs.sbar, rs.xibar, rs.mubar, prm)

            k_ms, p_ms, c_ms = in_turns(plain, kernel, 200, timer=queued_time_ms,
                                        library=copy)
            k_graph, p_graph, c_graph = (graph_of(torch, fn, COND_GRAPH_CALLS)
                                         for fn in (kernel, plain, copy))
            kg_ms, pg_ms, cg_ms = in_turns(p_graph, k_graph, 20, library=c_graph)
            es = 4 if dtype == torch.float32 else 8
            bound = bound_ms(es * (9 * npts + 3 * 24), 0, "f32 elementwise")
            times[f"{shape_name} {dname}"] = {
                "kernel_ms": min(k_ms) - min(c_ms), "plain_ms": min(p_ms),
                "kernel_graph_ms": (min(kg_ms) - min(cg_ms)) / COND_GRAPH_CALLS,
                "plain_graph_ms": min(pg_ms) / COND_GRAPH_CALLS,
                "bound_ms": bound[0], "bound_by": bound[1],
                "kernel_with_copy_ms_all": k_ms, "copy_ms_all": c_ms, "plain_ms_all": p_ms,
                "graph_ms_all": {"kernel_with_copy": kg_ms, "copy": cg_ms, "plain": pg_ms}}
            torch.cuda.synchronize()
            assert torch.isfinite(work).all()
    ptxas = ptxas_of(built.log, "condensation")
    say("condensation", t0,
        f"condensation_adjustment's kernel against its plain chain in the same type, "
        f"max|kernel - plain| / max|plain| per output row (limits f64 {COND_F64_REL}, f32 "
        f"{COND_F32_ULPS} x 2^-23): {json.dumps(errs)}; in the TC's mode, ms a call "
        f"(queued device time, min of 2 in turns; and in a CUDA graph of "
        f"{COND_GRAPH_CALLS} calls, a call; the kernel's less a copy of its input, timed "
        f"alone) beside the bytes bound: {json.dumps(times)}; "
        f"ptxas {ptxas}")
    return {"errors": errs, "times": times, "ptxas": ptxas}


GROUPS = ("kernels", "graphs", "paths", "jw06", "ensembles", "gradients", "comp_kernels",
          "comp_moist3d", "comp_flagship", "factored", "sharded", "examples", "cli",
          "condensation")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="on-card smoke test of scythe_tpu_torch")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"comma-separated phase groups to run, of {GROUPS} (all by "
                    "default; the kernels line and the closing line come only from a "
                    "run of all)")
    ap.add_argument("--cpu-reference", nargs="+", choices=sorted(CPU_REFERENCES.values()),
                    help=argparse.SUPPRESS)  # the child process of CpuReferences
    ap.add_argument("--cpu-reference-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        sys.modules["jax"] = None
        sys.modules["scythe_tpu"] = None
        return cpu_references(args.cpu_reference, args.cpu_reference_dir)
    groups = set(args.only.split(","))
    if not groups <= set(GROUPS):
        ap.error(f"--only takes {GROUPS}")
    t0 = t_main = time.perf_counter()
    # the port must need neither jax nor the JAX package: importing fails
    sys.modules["jax"] = None
    sys.modules["scythe_tpu"] = None
    import torch

    if not torch.cuda.is_available():
        print("FAIL environment: torch.cuda.is_available() is false; "
              "chip_smoke.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import scythe_tpu_torch as tx
    from scythe_tpu_torch import model as tmodel
    from scythe_tpu_torch import timeintegration as tti
    from scythe_tpu_torch import adjoint
    from scythe_tpu_torch import io as sio
    from scythe_tpu_torch.examples import calibrate_drag as cd
    from scythe_tpu_torch.examples import cha_bell_initialization as cb
    from scythe_tpu_torch.examples import convective_shower_xyz as sh
    from scythe_tpu_torch.examples import jw06_baroclinic_slz as jwx
    from scythe_tpu_torch.examples import williamson_sphere as wm
    from scythe_tpu_torch.examples.tc_intensification_rlz import tc_mature_model
    from scythe_tpu_torch.ops import _build
    from scythe_tpu_torch.ops import column_solve as cs
    from scythe_tpu_torch.ops import condensation as cn
    from scythe_tpu_torch.ops import elementwise_probe as ep
    from scythe_tpu_torch.ops import rlz_analysis as ra
    from scythe_tpu_torch.physics import thermodynamics as td

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card, flush=True)
    say("environment", t0,
        f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{count} device(s); TF32 off (matmul, cudnn), f32 matmul precision highest")

    t0 = time.perf_counter()
    built = _build.load()
    assert cs.library().scythe_column_solve_max_nz() == cs.MAX_NZ
    assert ra.library().scythe_rlz_analysis_max_nz() == ra.MAX_NZ
    assert ra.library().scythe_rlz_analysis_max_nl() == ra.MAX_NL
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if ln.startswith("==") or "registers" in ln or "spill" in ln]
    say("build", t0,
        f"{built.path.name} in {built.seconds:.2f} s (nvcc, sources in parallel); "
        + " | ".join(ptxas))

    out_dir = os.path.join(ROOT, "chiprun_out")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    refs = CpuReferences([v for k, v in CPU_REFERENCES.items() if k in groups], tmp)
    cli_la = None
    try:
        model = moist3d(tx, tmp, n_steps=120, out_every=60)
        columns = {}
        for name, m in (("moist3d", model),
                        ("shower", shower(tx, sh, os.path.join(tmp, "shower"), 240)),
                        ("jw06", jwx.production_model(os.path.join(tmp, "jw06_column"),
                                                      t_end=7.5))):
            rs = tmodel.build_context(
                m, tx.create_grid(m.grid_params, torch.float64, device="cpu"), torch.float64,
            ).ref_state
            columns[name] = (m.grid_params.zmax, m.ts, float(rs.Pxi_bar),
                             rs.Pxi_prof.numpy().astype(np.float64))
        if "kernels" in groups:
            cs_err, cs_times = phase_column_solve(torch, tti, cs, columns)
            ra_err, ra_times = phase_analysis(tx, torch, ra)
            ep_err, ep_ms, ep_plain_ms, ep_launches = phase_probe(torch, ep)
        if "condensation" in groups:
            cond = phase_condensation(torch, tmp, built)

        if "graphs" in groups:
            graph_out = phase_graphs(tx, tmodel, torch, cs, ra, cb, sh, jwx, wm, tmp, card)
        if "paths" in groups:
            # ---- phase 6: moist3d, the counts reset just before it
            t0 = time.perf_counter()
            zero_counts(cs, ra, cn)
            grid, phys = tx.integrate_model(model, dtype=torch.float32, device="cuda")
            m3d_launches = launched(CS, RA)
            assert m3d_launches == (model.num_ts, model.num_ts + 1) == (120, 121), m3d_launches
            m3d_cond = launched(CN, CN_PLAIN)
            assert m3d_cond == (model.num_ts, 0), m3d_cond
            assert phys.shape == (9, 144, 64, 48) and np.isfinite(phys).all()
            wmax = float(phys[MOIST3D_VARS.index("w")].max())
            assert wmax > 0.01, wmax
            outs = sorted(f for f in os.listdir(model.output_dir) if f.startswith("physical_out_"))
            assert len(outs) == 3, outs
            say("moist3d-path", t0,
                f"integrate_model moist3d f32 on cuda, 120 steps: column-solve launches "
                f"{m3d_launches[0]}, analysis launches {m3d_launches[1]}, condensation "
                f"launches {m3d_cond[0]} (plain chain {m3d_cond[1]}), all fields finite, "
                f"w.max {wmax:.4f} m/s, outputs {outs}")
            t0 = time.perf_counter()
            ms_step, host_sps, state, step = time_steps(torch, tmodel, model, 100)
            say("moist3d-steps-per-second", t0,
                f"100 steps after 10 warm-up: {1000.0 / ms_step:.2f} steps/s ({ms_step:.4f} "
                f"ms/step by CUDA events; {host_sps:.2f} steps/s by host clock) on {card}")
            t0 = time.perf_counter()
            busy, wall, nk, solve, _ = profile_steps(torch, state, step, card, "moist3d",
                                                     os.path.join(out_dir, "moist3d_profile.txt"))
            say("moist3d-profile", t0,
                f"10 steps: device busy {busy:.1f} us/step of {wall:.1f} us/step wall "
                f"(profiled), {nk:.0f} kernel launches/step, column solve {solve:.2f} us/step; "
                f"table in chiprun_out/moist3d_profile.txt")
            del state, step, grid

            # ---- phase 7: the mature-TC path, the counts reset just before it
            t0 = time.perf_counter()
            tc = tc_mature_model(os.path.join(tmp, "tc_mature"), t_end=1800.0,
                                 output_interval=900.0)
            zero_counts(cs, ra, cn)
            grid, phys = tx.integrate_model(tc, dtype=torch.float32, device="cuda")
            tc_launches = launched(CS, RA)
            assert tc_launches == (tc.num_ts, tc.num_ts + 1) == (900, 901), tc_launches
            tc_cond = launched(CN, CN_PLAIN)
            assert tc_cond == (tc.num_ts, 0), tc_cond
            assert phys.shape == (9, 300, 4, 24) and np.isfinite(phys).all()
            qc = float(td.ahyp(torch.from_numpy(phys[6]).double()).max())
            qr = float(td.ahyp(torch.from_numpy(phys[7]).double()).max())
            vmax = float(phys[4].max())
            assert qc > TC_QC_MIN, qc
            assert 12.0 < vmax < 20.0, vmax
            outs = sorted(f for f in os.listdir(tc.output_dir) if f.startswith("physical_out_"))
            assert len(outs) == 3, outs
            say("tc-mature-path", t0,
                f"integrate_model tc_mature_model f32 on cuda, 900 steps (30 min): "
                f"column-solve launches {tc_launches[0]}, analysis launches "
                f"{tc_launches[1]}, condensation launches {tc_cond[0]} (plain chain "
                f"{tc_cond[1]}), all fields finite, v.max {vmax:.4f} m/s, q_c max "
                f"{qc:.4e} (> {TC_QC_MIN}), q_r max {qr:.4e}, w.max "
                f"{float(phys[5].max()):.4f} m/s, outputs {outs}")
            t0 = time.perf_counter()
            ms_step, host_sps, state, step = time_steps(torch, tmodel, tc, 200)
            say("tc-steps-per-second", t0,
                f"200 steps after 10 warm-up: {1000.0 / ms_step:.2f} steps/s ({ms_step:.4f} "
                f"ms/step by CUDA events; {host_sps:.2f} steps/s by host clock) on {card}")
            tc_sps = 1000.0 / ms_step
            t0 = time.perf_counter()
            busy, wall, nk, solve, _ = profile_steps(
                torch, state, step, card, "tc_mature",
                os.path.join(out_dir, "tc_mature_profile.txt"))
            say("tc-profile", t0,
                f"10 steps: device busy {busy:.1f} us/step of {wall:.1f} us/step wall "
                f"(profiled), {nk:.0f} kernel launches/step, column solve {solve:.2f} us/step; "
                f"table in chiprun_out/tc_mature_profile.txt")
            del state, step, grid

            # ---- phase 8: parity on the card
            t0 = time.perf_counter()
            sm = small(tx, tmp, 20)
            _, p_gpu = tx.integrate_model(sm, dtype=torch.float64, device="cuda",
                                          write_outputs=False)
            _, p_cpu = tx.integrate_model(sm, dtype=torch.float64, device="cpu",
                                          write_outputs=False)
            rel_small = per_field_rel(p_gpu, p_cpu)
            assert max(rel_small) <= 1e-9, rel_small
            tc16 = tc_mature_model(os.path.join(tmp, "tc16"), t_end=200.0,
                                   output_interval=200.0, num_cells=16, ts=4.0)
            _, p_gpu = tx.integrate_model(tc16, dtype=torch.float64, device="cuda",
                                          write_outputs=False)
            _, p_cpu = tx.integrate_model(tc16, dtype=torch.float64, device="cpu",
                                          write_outputs=False)
            rel_tc16 = per_field_rel(p_gpu, p_cpu)
            assert max(rel_tc16) <= 1e-9, rel_tc16
            say("parity-f64", t0,
                f"cuda f64 (kernels) vs cpu f64 (plain), rel err per field (tol 1e-9): small "
                f"20 steps {fmt_rel(rel_small)}; TC bundle 16 cells 50 steps {fmt_rel(rel_tc16)}")

            t0 = time.perf_counter()
            m20 = moist3d(tx, tmp, n_steps=20, out_every=20, name="moist3d_20")
            _, p32 = tx.integrate_model(m20, dtype=torch.float32, device="cuda",
                                        write_outputs=False)
            _, p64 = tx.integrate_model(m20, dtype=torch.float64, device="cuda",
                                        write_outputs=False)
            rel_m3d = per_field_rel(p32, p64)
            checked = [v for v in range(9) if np.abs(p64[v]).max() > 0.0]
            assert all(rel_m3d[v] <= 1e-4 for v in checked), rel_m3d
            tc20 = tc_mature_model(os.path.join(tmp, "tc20"), t_end=40.0, output_interval=40.0)
            _, p32 = tx.integrate_model(tc20, dtype=torch.float32, device="cuda",
                                        write_outputs=False)
            _, p64 = tx.integrate_model(tc20, dtype=torch.float64, device="cuda",
                                        write_outputs=False)
            rel_tc = per_field_rel(p32, p64)
            tc_checked = [v for v in range(9) if np.abs(p64[v]).max() > 0.0]
            bounds = [TC_F32_BOUND.get(MOIST3D_VARS[v], 1e-4) for v in range(9)]
            print(f"  TC 20 steps cuda f32 vs f64 rel err {fmt_rel(rel_tc)}", flush=True)
            assert all(rel_tc[v] <= bounds[v] for v in tc_checked), rel_tc
            say("parity-f32", t0,
                f"cuda f32 vs cuda f64, 20 steps, rel err per field: moist3d {fmt_rel(rel_m3d)} "
                f"(tol 1e-4 on {[MOIST3D_VARS[v] for v in checked]}); TC full width "
                f"{fmt_rel(rel_tc)} (tol {TC_F32_BOUND} else 1e-4, on "
                f"{[MOIST3D_VARS[v] for v in tc_checked]})")

            # ---- phase 9: the flagship two-layer path; no hand-written kernel
            # lies on it, and the counts, reset just before it, say so
            t0 = time.perf_counter()
            zero_counts(cs, ra, ep)
            tw, grid, phys = flagship_workflow(tx, cb, os.path.join(tmp, "flagship"),
                                               torch.float32, "cuda")
            fl_launches = launched(CS, RA, EP)
            assert fl_launches == (0, 0, 0), fl_launches
            assert (grid.params.rDim, grid.params.b_rDim, grid.nl) == (300, 103, 256)
            assert phys.shape == (6, 300, 256) and np.isfinite(phys).all()
            fl = flagship_readings(grid, phys)
            assert FLAGSHIP_VG_BAND[0] < fl["vg_max"] < FLAGSHIP_VG_BAND[1], fl
            assert (FLAGSHIP_WAVE2_BAND[0] < fl["vg_wave2_at_50km"]
                    < FLAGSHIP_WAVE2_BAND[1]), fl
            assert fl["vg_largest_wave_at_45km"] == 2, fl
            assert fl["vg_odd_waves_at_50km"] < 1e-3 * fl["vg_wave2_at_50km"], fl
            assert fl["wb_max"] > 0.0 and fl["wb_min"] < 0.0, fl
            spin_outs, outs = (
                sorted(f for f in os.listdir(m.output_dir) if f.startswith("physical_out_"))
                for m in (cb.spinup_model(os.path.join(tmp, "flagship")), tw))
            assert spin_outs == ["physical_out_0.0.csv", "physical_out_600.0.csv"], spin_outs
            assert outs == ["physical_out_0.0.csv", "physical_out_1200.0.csv",
                            "physical_out_600.0.csv"], outs
            with open(os.path.join(tw.output_dir, outs[1])) as f:
                assert sum(1 for _ in f) == 1 + 300 * 256
            say("flagship-path", t0,
                f"cha_bell_initialization workflow f32 on cuda through integrate_model: "
                f"Rankine ICs, Oneway_ShallowWater_Slab spinup 200 steps, add_wave2, "
                f"Twoway_ShallowWater_Slab {tw.num_ts} steps on {list(phys.shape)}; hand-written "
                f"kernel launches {fl_launches} (none lies on this path); all fields finite; "
                f"{json.dumps(fl)} (vg.max band {FLAGSHIP_VG_BAND}, wave-2 band "
                f"{FLAGSHIP_WAVE2_BAND}); outputs {outs}")

            # ---- phase 10: flagship steps/s and profile
            t0 = time.perf_counter()
            ms_step, host_sps, state, step = time_steps(torch, tmodel, tw, 200)
            fl_sps = 1000.0 / ms_step
            say("flagship-steps-per-second", t0,
                f"200 two-way steps after 10 warm-up: {fl_sps:.2f} steps/s ({ms_step:.4f} "
                f"ms/step by CUDA events; {host_sps:.2f} steps/s by host clock) on {card}")
            t0 = time.perf_counter()
            busy, wall, nk, _, gemm = profile_steps(
                torch, state, step, card, "flagship two-way",
                os.path.join(out_dir, "flagship_profile.txt"))
            assert busy > 0.0 and gemm > 0.0, (busy, gemm)
            say("flagship-profile", t0,
                f"10 steps: device busy {busy:.1f} us/step of {wall:.1f} us/step wall "
                f"(profiled), {nk:.0f} kernel launches/step, matrix products (einsum) "
                f"{gemm:.1f} us/step = {100.0 * gemm / busy:.1f}% of busy, other kernels "
                f"(elementwise, copies) {busy - gemm:.1f} us/step; table in "
                f"chiprun_out/flagship_profile.txt")
            del state, step

            # ---- phase 11: the golden trajectory on the card
            t0 = time.perf_counter()
            gm = cb.flagship_model(32, 32)
            golden = np.load(os.path.join(ROOT, "tests", "golden",
                                          "twoway_slab_50steps_f64.npz"))["phys"]
            runs = {}
            for dev in ("cuda", "cpu"):
                g = tx.create_grid(gm.grid_params, torch.float64, device=dev)
                gstep = tmodel.build_step(gm, g, tmodel.build_context(gm, g, torch.float64),
                                          torch.float64)
                out = tmodel.make_scan(gstep, 50)(cb.vortex_state(g, torch.float64))
                assert out.spec.device.type == dev
                runs[dev] = g.synthesis(out.spec)["val"].cpu().numpy()
            rel_golden = per_field_rel(runs["cuda"], golden)
            rel_cpu = per_field_rel(runs["cuda"], runs["cpu"])
            assert max(rel_golden) <= 1e-9 and max(rel_cpu) <= 1e-9, (rel_golden, rel_cpu)
            say("flagship-golden", t0,
                f"flagship_model(32, 32) 50 f64 steps on cuda, rel err per field (tol 1e-9): "
                f"vs tests/golden/twoway_slab_50steps_f64.npz "
                f"{fmt_rel(rel_golden, FLAGSHIP_VARS)}; vs the same run on the cpu "
                f"{fmt_rel(rel_cpu, FLAGSHIP_VARS)}")

            # ---- phase 12: flagship f32 against f64 on the card, 50 steps
            t0 = time.perf_counter()
            tw50 = tw.with_(integration_time=150.0, output_interval=150.0)
            _, p32 = tx.integrate_model(tw50, dtype=torch.float32, device="cuda",
                                        write_outputs=False)
            _, p64 = tx.integrate_model(tw50, dtype=torch.float64, device="cuda",
                                        write_outputs=False)
            rel_fl = per_field_rel(p32, p64)
            fl_bounds = [FLAGSHIP_F32_BOUND.get(n, 1e-4) for n in FLAGSHIP_VARS]
            print(f"  flagship 50 steps cuda f32 vs f64 rel err {fmt_rel(rel_fl, FLAGSHIP_VARS)}",
                  flush=True)
            assert all(np.abs(p64[v]).max() > 0.0 for v in range(6))
            assert all(r <= b for r, b in zip(rel_fl, fl_bounds)), (rel_fl, fl_bounds)
            say("flagship-parity-f32", t0,
                f"cuda f32 vs cuda f64, 50 two-way steps from the wave-2 ICs at full width, "
                f"rel err per field {fmt_rel(rel_fl, FLAGSHIP_VARS)} (tol {FLAGSHIP_F32_BOUND} "
                f"else 1e-4)")

            # ---- phase 13: the height-resolved BL, an RLZ set: its closing
            # analysis is the CUDA kernel; the counts reset just before it
            t0 = time.perf_counter()
            hm = hrbl_model(tx, tmp, 100)
            zero_counts(cs, ra)
            _, p_gpu = tx.integrate_model(hm, dtype=torch.float64, device="cuda",
                                          write_outputs=False)
            hrbl_launches = launched(CS, RA)
            assert hrbl_launches == (0, hm.num_ts + 1) == (0, 101), hrbl_launches
            _, p_cpu = tx.integrate_model(hm, dtype=torch.float64, device="cpu",
                                          write_outputs=False)
            assert launched(RA) == 101  # the CPU run launched nothing
            rel_hrbl = per_field_rel(p_gpu, p_cpu)
            assert np.isfinite(p_gpu).all() and max(rel_hrbl) <= 1e-9, rel_hrbl
            assert p_gpu[3].min() < 0.0 and np.abs(p_gpu[5]).max() > 0.0  # inflow, wb written
            say("height-resolved-bl-path", t0,
                f"Oneway_ShallowWater_HeightResolvedBL {list(p_gpu.shape)} 100 f64 steps on "
                f"cuda: column-solve launches {hrbl_launches[0]}, analysis launches "
                f"{hrbl_launches[1]}; vs cpu f64 rel err per field (tol 1e-9) "
                f"{fmt_rel(rel_hrbl, FLAGSHIP_VARS)}; ub.min {float(p_gpu[3].min()):.4f} m/s")

            # ---- phases 14-15: the convective shower at full width, with the
            # example's options and under moist_production; the counts reset
            # just before each run
            shower_runs = {}
            for label, profile in (("shower", None), ("shower_production", "moist_production")):
                t0 = time.perf_counter()
                sm = shower(tx, sh, os.path.join(tmp, label), 240, profile)
                zero_counts(cs, ra)
                grid, phys = tx.integrate_model(sm, dtype=torch.float32, device="cuda")
                launches = launched(CS, RA)
                assert launches == (sm.num_ts, sm.num_ts + 1) == (240, 241), launches
                assert phys.shape == (9, 144, 16, 32) and np.isfinite(phys).all()
                r = sh.readings(phys)
                band_w, band_qc = SHOWER_BANDS[label]
                assert band_w[0] < r["w_max"] < band_w[1], (label, r)
                assert band_qc[0] < r["qc_max"] < band_qc[1], (label, r)
                outs = sorted(f for f in os.listdir(sm.output_dir) if f.startswith("physical_out_"))
                assert len(outs) == 7, outs
                say(f"{label}-path", t0,
                    f"integrate_model convective shower (MoistEulerXYZ, {list(phys.shape)}) f32 "
                    f"on cuda, 240 steps (60 s), options {json.dumps(sm.opts(), default=str)}: "
                    f"column-solve launches {launches[0]}, analysis launches {launches[1]}; all "
                    f"fields finite; {json.dumps(r)} (w.max band {band_w}, q_c max band "
                    f"{band_qc}); {len(outs)} outputs")
                t0 = time.perf_counter()
                ms_step, host_sps, state, step = time_steps(torch, tmodel, sm, 100)
                busy, wall, nk, solve, gemm = profile_steps(
                    torch, state, step, card, label, os.path.join(out_dir, f"{label}_profile.txt"))
                shower_runs[label] = {"launches": launches, "steps_per_s": 1000.0 / ms_step,
                                      "busy_us": busy, "launches_per_step": nk}
                say(f"{label}-steps-per-second", t0,
                    f"100 steps after 10 warm-up: {1000.0 / ms_step:.2f} steps/s ({ms_step:.4f} "
                    f"ms/step by CUDA events; {host_sps:.2f} steps/s by host clock) on {card}; "
                    f"profile of 10 steps: device busy {busy:.1f} us/step of {wall:.1f} us/step "
                    f"wall, {nk:.0f} kernel launches/step, column solve {solve:.2f} us/step, "
                    f"matrix products {gemm:.1f} us/step; table in chiprun_out/{label}_profile.txt")
                del state, step, grid

            # ---- phase 16: parity of the new geometries on the card
            t0 = time.perf_counter()
            xm = xyz_test_model(tx, tmp, 20)
            _, p_gpu = tx.integrate_model(xm, dtype=torch.float64, device="cuda",
                                          write_outputs=False)
            _, p_cpu = tx.integrate_model(xm, dtype=torch.float64, device="cpu",
                                          write_outputs=False)
            rel_xyz = per_field_rel(p_gpu, p_cpu)
            assert max(rel_xyz) <= 1e-9, rel_xyz
            s20 = shower(tx, sh, os.path.join(tmp, "shower_20"), 20)
            _, p32 = tx.integrate_model(s20, dtype=torch.float32, device="cuda",
                                        write_outputs=False)
            _, p64 = tx.integrate_model(s20, dtype=torch.float64, device="cuda",
                                        write_outputs=False)
            rel_sh = per_field_rel(p32, p64)
            sh_checked = [v for v in range(9) if np.abs(p64[v]).max() > 0.0]
            assert all(rel_sh[v] <= 1e-4 for v in sh_checked), rel_sh
            zm = slz_test_model(tx, tmp, 20, thermal=True)
            _, p_gpu = tx.integrate_model(zm, dtype=torch.float64, device="cuda",
                                          write_outputs=False)
            _, p_cpu = tx.integrate_model(zm, dtype=torch.float64, device="cpu",
                                          write_outputs=False)
            rel_slz = per_field_rel(p_gpu, p_cpu)
            assert max(rel_slz) <= 1e-9, rel_slz
            say("xyz-slz-parity", t0,
                f"rel err per field: XYZ (tests/test_xyz.py's 12-cell grid) 20 f64 steps cuda vs "
                f"cpu {fmt_rel(rel_xyz)} (tol 1e-9); the shower 20 steps cuda f32 vs f64 "
                f"{fmt_rel(rel_sh)} (tol 1e-4, on "
                f"{[MOIST3D_VARS[v] for v in sh_checked]}); SLZ (tests/test_slz.py's grid) 20 "
                f"f64 steps cuda vs cpu {fmt_rel(rel_slz)} (tol 1e-9)")

            # ---- phase 17: the SLZ global balance, the counts reset just before
            t0 = time.perf_counter()
            zb = slz_test_model(tx, tmp, 200, thermal=False)
            zero_counts(cs, ra)
            _, p_gpu = tx.integrate_model(zb, dtype=torch.float64, device="cuda",
                                          write_outputs=False)
            slz_launches = launched(CS, RA)
            assert slz_launches == (200, 201), slz_launches
            w_abs, u_abs = float(np.abs(p_gpu[5]).max()), float(np.abs(p_gpu[3]).max())
            assert np.isfinite(p_gpu).all() and w_abs < 1e-10 and u_abs < 1e-10, (w_abs, u_abs)
            say("slz-balance", t0,
                f"MoistEulerSLZ {list(p_gpu.shape)} from zero perturbation, 200 f64 steps on "
                f"cuda: column-solve launches {slz_launches[0]}, analysis launches "
                f"{slz_launches[1]}; max|w| {w_abs:.3e}, max|u| {u_abs:.3e} (tol 1e-10)")

            # ---- phase 18: Williamson case 2 on the SL sphere, one day; an RL
            # structure, so no hand-written kernel lies on it and the counts say so
            t0 = time.perf_counter()
            w2 = wm.williamson2_model(os.path.join(tmp, "williamson2"))
            zero_counts(cs, ra)
            grid, phys = tx.integrate_model(w2, dtype=torch.float64, device="cuda")
            sl_launches = launched(CS, RA)
            assert sl_launches == (0, 0), sl_launches
            h2, u2, _ = wm.w2_fields(grid.gridpoints()[:, 0].reshape(grid.spatial_shape))
            l2 = float(np.sqrt(np.mean((phys[0] - h2) ** 2)) / np.sqrt(np.mean(h2**2)))
            v_abs = float(np.abs(phys[2]).max())
            assert np.isfinite(phys).all() and l2 < 5.0e-4 and v_abs < 0.05, (l2, v_abs)
            outs = sorted(f for f in os.listdir(w2.output_dir) if f.startswith("physical_out_"))
            assert len(outs) == 3, outs
            say("williamson2-path", t0,
                f"ShallowWaterSphere {list(phys.shape)} (models/williamson2_sphere.py's "
                f"configuration) f64 on cuda, {w2.num_ts} steps (one day): hand-written kernel "
                f"launches {sl_launches} (none lies on this path); l2(h) against the analytic "
                f"state {l2:.3e} (tol 5e-4), max|v| {v_abs:.4f} m/s (tol 0.05); outputs {outs}")
        if "jw06" in groups:
            if "cli" in groups:  # beside the JW06 balances, mostly cuSOLVER's SVD
                cli_la = CliLinearAdvection(tx, torch, tmp, "started beside the JW06 balances")
            jw = phase_jw06(tx, tmodel, jwx, torch, cs, ra, tmp, card, out_dir, refs)
        if "ensembles" in groups:
            ens = phase_ensembles(tx, tmodel, tti, torch, cs, ra, cb, sh, sio, tmp, card)
        if "gradients" in groups:
            kg_times = phase_kernel_gradients(tx, tti, torch, cs, ra, columns)
            grad = phase_gradients(tx, torch, cs, ra, sio, tmp, cd, adjoint, refs)
        if "comp_kernels" in groups:
            comp_errs, cs_comp_times, ra_comp_times = phase_comp_kernels(
                tx, tti, torch, cs, ra, columns)
        if "comp_moist3d" in groups:
            cm3d = phase_comp_moist3d(tx, tmodel, tti, torch, cs, ra, tmp, card, out_dir)
        if "comp_flagship" in groups:
            cfl = phase_comp_flagship(tx, torch, cs, ra, cb, tmp)
        if "factored" in groups:
            fact_times = phase_factored(tx, tmodel, torch, cs, ra, tmp)
        if "sharded" in groups:
            shd = phase_sharded(tx, tmodel, torch, cs, ra, cb, tmp, card)
        if "examples" in groups:
            exm = phase_examples(tx, tmodel, tti, torch, cs, ra, tmp, card)
        if "cli" in groups:
            cli_la = cli_la or CliLinearAdvection(tx, torch, tmp)
            cli_out = phase_cli(tx, tmodel, tti, torch, cs, ra, tmp, cli_la)
        if "examples" in groups:
            exm["galewsky"] = phase_galewsky(torch, cs, ra, t_main)
    finally:
        refs.close()
        if cli_la is not None:
            cli_la.close()
        shutil.rmtree(tmp, ignore_errors=True)

    if groups != set(GROUPS):
        print(f"  phase groups run: {sorted(groups)}; no kernels line without all of them",
              flush=True)
        return 0
    print(f"  TC mature path: {tc_sps:.2f} steps/s; moist3d launches {m3d_launches}; "
          f"flagship two-way: {fl_sps:.2f} steps/s; shower: "
          f"{json.dumps(shower_runs)}; JW06 production: {json.dumps(jw)}; ensembles: "
          f"{json.dumps(ens)}; compensated moist3d: {json.dumps(cm3d)}; compensated "
          f"flagship: {json.dumps(cfl)}; factored DFT dense vs factored ms: "
          f"{json.dumps(fact_times)}; sharded: {json.dumps(shd)}; published runs: "
          f"{json.dumps(exm, default=str)}; cli: {json.dumps(cli_out)}; graphs (steps/s "
          f"eager, graph): "
          f"{json.dumps({k: v['steps_per_s'] for k, v in graph_out['cases'].items()})}",
          flush=True)
    cs_main = cs_times["9216x48 f32"]
    n_probe = int(np.prod(ep.SHAPE))
    # seven slot tensors and rinv read, one output written; 21 FLOP an output
    ep_bound = bound_ms(4 * (8 * n_probe + ep.SHAPE[1]), 21 * n_probe, "f32 elementwise")
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {
            "name": "fused_column_solve",
            "route": "cuda",
            "source": "scythe_tpu_torch/ops/csrc/column_solve.cu",
            "replaces": "scythe_tpu/ops/pallas_semiimplicit.py:118",
            "launches": shower_runs["shower"]["launches"][0],
            "launches_per_step": shower_runs["shower"]["launches"][0] / 240,
            "launches_by_path": {"moist3d": m3d_launches[0], "tc_mature": tc_launches[0],
                                 "flagship": fl_launches[0],
                                 "height_resolved_bl": hrbl_launches[0],
                                 **{k: v["launches"][0] for k, v in shower_runs.items()},
                                 "slz_balance": slz_launches[0],
                                 "williamson2": sl_launches[0],
                                 "jw06_production": jw["launches"][0],
                                 "flagship_ensemble": ens["flagship_launches"][0],
                                 "shower_ensemble": ens["shower_launches"][0],
                                 "slz_gradient": grad["launches"][0],
                                 **{k: v[0] for k, v in shd["launches"].items()},
                                 **{f"published_{k}": v[0] for k, v in exm["launches"].items()},
                                 "cli_moist_demo": cli_out["moist_demo"]["launches"][0],
                                 "dryrun_multichip_4": cli_out["dryrun_multichip"]["launches"][0]},
            "backward_launches": grad["launches"][1],
            **grad_keys(kg_times, "column_solve 9216x48", ""),
            **grad_keys(kg_times, "column_solve 13824x24", "jw06_"),
            "max_abs_err": cs_err["kernel"],
            "library_max_abs_err": cs_err["library"],
            "ms": cs_main[0],
            "plain_ms": cs_main[1],
            "bound_ms": cs_main[3],
            "bound_by": cs_main[4],
            "library_ms": cs_main[2],
            "tc_ms": cs_times["1200x24 f32"][0],
            "tc_plain_ms": cs_times["1200x24 f32"][1],
            "tc_library_ms": cs_times["1200x24 f32"][2],
            "tc_bound_ms": cs_times["1200x24 f32"][3],
            "f64_ms": cs_times["9216x48 f64"][0],
            "f64_plain_ms": cs_times["9216x48 f64"][1],
            "f64_library_ms": cs_times["9216x48 f64"][2],
            "f64_bound_ms": cs_times["9216x48 f64"][3],
            **{f"{key}_{k}": cs_times[label][i]
               for key, label in (("profile", "9216x48 f32 profile"),
                                  ("shower", "2304x32 f32"),
                                  ("shower_profile", "2304x32 f32 profile"),
                                  ("jw06", "13824x24 f32"),
                                  ("sharded_moist3d_shard", "2304x48 f32"))
               for i, k in enumerate(("ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by"))},
            **{f"{key}_{k}": exm["column_solve_times"][label][i]
               for key, label in [(name, label) for label, name, _, _ in CS_PUBLISHED]
               + [("bf02_f64", "192x64 f64")]
               for i, k in enumerate(("ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by"))},
        },
        {
            "name": "rlz_analysis",
            "route": "cuda",
            "source": "scythe_tpu_torch/ops/csrc/rlz_analysis.cu",
            "replaces": "scythe_tpu/ops/pallas_transforms.py:105",
            "launches": shower_runs["shower"]["launches"][1],
            "launches_per_step": (shower_runs["shower"]["launches"][1] - 1) / 240,
            "launches_by_path": {"moist3d": m3d_launches[1], "tc_mature": tc_launches[1],
                                 "flagship": fl_launches[1],
                                 "height_resolved_bl": hrbl_launches[1],
                                 **{k: v["launches"][1] for k, v in shower_runs.items()},
                                 "slz_balance": slz_launches[1],
                                 "williamson2": sl_launches[1],
                                 "jw06_production": jw["launches"][1],
                                 "flagship_ensemble": ens["flagship_launches"][1],
                                 "shower_ensemble": ens["shower_launches"][1],
                                 "slz_gradient": grad["launches"][2],
                                 **{k: v[1] for k, v in shd["launches"].items()},
                                 **{f"published_{k}": v[1] for k, v in exm["launches"].items()},
                                 "cli_moist_demo": cli_out["moist_demo"]["launches"][1],
                                 "dryrun_multichip_4": cli_out["dryrun_multichip"]["launches"][1]},
            "backward_route": "einsum (the transposed chain; no kernel)",
            **grad_keys(kg_times, "rlz_analysis moist3d", ""),
            **grad_keys(kg_times, "rlz_analysis jw06_production", "jw06_"),
            "max_abs_err": ra_err,
            "ms": ra_times["moist3d"][0],
            "plain_ms": ra_times["moist3d"][1],
            "bound_ms": ra_times["moist3d"][3],
            "bound_by": ra_times["moist3d"][4],
            "library_ms": ra_times["moist3d"][2],
            "library_call": "torch.einsum over the chain in true f32 (f64 for the f64 row)",
            "moist3d_f64_ms": ra_times["moist3d_f64"][0],
            "moist3d_f64_plain_ms": ra_times["moist3d_f64"][1],
            "moist3d_f64_library_ms": ra_times["moist3d_f64"][2],
            "moist3d_f64_bound_ms": ra_times["moist3d_f64"][3],
            "moist3d_f64_bound_by": ra_times["moist3d_f64"][4],
            **{f"{name}_{k}": ra_times[name][i]
               for name in ("tc", "transform", "shower", "slz_test", "jw06", "jw06_production",
                            "moist_demo")
               for i, k in enumerate(("ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by"))},
        },
        {
            "name": "fused_column_solve_comp",
            "route": "cuda",
            "source": "scythe_tpu_torch/ops/csrc/column_solve.cu",
            "replaces": "scythe_tpu/ops/pallas_semiimplicit.py:78",
            "launches": cm3d["column_solve_comp_launches"],
            "launches_by_path": {"fused_column_solve_default_on_comp_moist3d":
                                 cm3d["column_solve_comp_launches"],
                                 "semiimplicit_adjustment_use_pallas_on_comp_moist3d":
                                 cm3d["use_pallas_adjustment_launches"],
                                 "comp_moist3d_model": cm3d["launches"]["column_solve_comp"]},
            "max_abs_err": comp_errs["column_solve"],
            "max_abs_err_vs_f64": comp_errs["column_solve_vs_f64"],
            "ms": cs_comp_times["9216x48"][0],
            "plain_ms": cs_comp_times["9216x48"][1],
            "bound_ms": cs_comp_times["9216x48"][3],
            "bound_by": cs_comp_times["9216x48"][4],
            "library_ms": cs_comp_times["9216x48"][2],
            "library_call": "torch.matmul([x* | w*], M^T) in true f32: no single PyTorch "
                            "call computes bf16x3 with an f32 output",
            **{f"{key}_{k}": cs_comp_times[label][i]
               for key, label in (("tc", "1200x24"), ("shower", "2304x32"),
                                  ("jw06", "13824x24"))
               for i, k in enumerate(("ms", "plain_ms", "library_ms", "bound_ms",
                                      "bound_by"))},
        },
        {
            "name": "rlz_analysis_comp",
            "route": "cuda",
            "source": "scythe_tpu_torch/ops/csrc/rlz_analysis.cu",
            "replaces": "scythe_tpu/ops/pallas_transforms.py:134",
            "launches": cm3d["launches"]["rlz_analysis_comp"],
            "launches_per_step": (cm3d["launches"]["rlz_analysis_comp"] - 1) / 120,
            "max_abs_err": comp_errs["rlz_analysis"],
            "max_abs_err_vs_f64": comp_errs["rlz_analysis_vs_f64"],
            "ms": ra_comp_times["moist3d"][0],
            "plain_ms": ra_comp_times["moist3d"][1],
            "bound_ms": ra_comp_times["moist3d"][2],
            "bound_by": ra_comp_times["moist3d"][3],
            "library_ms": ra_comp_times["moist3d"][4],
            "library_call": "torch.einsum over the chain on O_hi + O_lo in true f32: no "
                            "single PyTorch call computes bf16x3 with an f32 output",
            **{f"{name}_{k}": ra_comp_times[name][i]
               for name in ANALYSIS_COMP_SHAPES if name != "moist3d"
               for i, k in enumerate(("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms"))},
        },
        {
            "name": "condensation_adjustment",
            "route": "cuda",
            "source": "scythe_tpu_torch/ops/csrc/condensation.cu",
            "replaces": None,
            "launches_by_path": {"moist3d": m3d_cond[0], "tc_mature": tc_cond[0],
                                 "jw06_production": jw["condensation_launches"]},
            "max_rel_err": cond["errors"],
            **{f"{case.replace(' ', '_')}_{k}": v for case, t in cond["times"].items()
               for k, v in t.items() if "_all" not in k},
            "library_ms": None,
        },
        {
            "name": "probe_expr",
            "route": "triton",
            "source": "scythe_tpu_torch/ops/elementwise_probe.py",
            "replaces": "tools/probe_pallas_elementwise.py:48",
            "launches": ep_launches,
            "launches_per_step": 0,
            "max_abs_err": ep_err,
            "ms": ep_ms,
            "plain_ms": ep_plain_ms,
            "bound_ms": ep_bound[0],
            "bound_by": ep_bound[1],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
