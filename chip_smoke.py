"""Smoke run of the PyTorch/CUDA port (``altro_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its findings; any failure raises (non-zero exit):

1. device: a CUDA device is required; prints its name and nvidia-smi's
   name and power limit;
2. build: compiles the kernels from ``altro_tpu_torch/csrc`` with nvcc (one
   process per source, in parallel) and prints the build time and ptxas
   resource use;
3. kernel parity, each CUDA kernel against its plain PyTorch version on the
   card, in float32 (gate: max|kernel - plain| <= 1e-3 max(1, max|plain|))
   and in float64 (gate: 1e-9 max(1, max|plain|)), with both timed and the
   kernel's bound beside them (inputs, bounds and the timing from
   ``altro_tpu_torch/bench/kernels.py``: a kernel's launches queue behind a
   sleep on the stream, so its time is the device's alone):
   a. the flagship shapes (B=1024, n=12, m=6, N=30; ladders L=3 and the
      L=1 init form, each timed): the ladder rollout and the fused
      expansion on a NONPOS block;
   b. the rocket MPC window (B=1024, n=6, m=3, N=21, three SOC blocks, all
      three cone cases and an apex lane-knot): the fused expansion's SOC
      branch, and the fused ladder + AL merit at L=6 (J gated per lane
      against max(1, |J|), and the accepted rung compared);
   c. the flat quadruped batch (B=1024, n=m=12, N=15, per-lane dynamics of
      8 contact schedules, SOC friction cones): the Riccati pass on the
      solver's own AL expansion at perturbed X, U and multipliers (its
      float32 result held to the float64 plain version on the same inputs
      within 1.5x the plain float32 pass's own distance from it, or 1e-3
      max(1, max|f64|) where larger: the quadruped's Quu is
      ill-conditioned, ``against_f64``), and the ladder rollout with
      per-lane dynamics at the solver's L=11 ladder;
   d. grasp (B=1024, n = m = 6; torque balance ZERO, max force NONPOS, two
      SOC friction cones): the fused expansion on the MPC window (N=21, 13
      rows in 4 blocks) and on the cold problem (N=61, a goal ZERO block
      in front: 19 rows in 5), and the fused ladder + merit on the window
      at L=3 (J and the accepted rung as in b);
   e. the flexsat regulator (B=1024, n=12, m=3, N=80, one NONPOS block of
      6 rows, both signs of lam + rho c on its rows): the fused expansion,
      and the fused ladder + merit at L=6 (J and the accepted rung as in
      b);
   f. the quadruped closed loop's one robot (B=1, n = m = 12, N=15, the
      MPC problem linearized about a schedule with two legs in swing), in
      both friction forms (24 NONPOS rows in 5 blocks; 4 cones of 3 rows
      and 8 NONPOS rows), both signs of lam + rho c on the NONPOS rows and
      cones inside, polar and between: the fused expansion, the fused
      ladder + merit at the solver's L=11 (J and the accepted rung as in
      b) and the ladder rollout's init form (L=1);
   g. phase 6's shapes, one lane (B=1) at the drivers' L=11 ladder, not
      timed: A (with its init form) and B on the random-linear models of
      the lockstep and the sweeps ((n, m, N) = (12, 6, 21), (12, 6, 101),
      (30, 25, 21), (25, 2, 21), (2, 2, 21)), B and C on the rocket
      window, grasp's window at N=51 and its cold form at N=251, and the
      flexsat regulator (the same gates; J per lane; the accepted rung
      equal in float64); their float32 errors count in max_abs_err;
   h. the kernels' wide bodies (n or m above 32, up to the TPU kernels'
      64): A (at L=11 and its init form), B, C (L=11) and D at
      ``bench/kernels.py: WIDE_SHAPES``, the state_dim sweep's
      (n, m) = (35, 2), (45, 2), (55, 2) and (64, 64) with 8 NONPOS rows
      and one SOC block of 4 (N=21), at B=1 and B=1024, float32 and
      float64, under 3a-3f's gates (J per lane, the accepted rung as in
      b); each kernel's ms, its plain version's, its bound and the share
      of the bound it reaches printed at both batches; the float32 errors
      count in max_abs_err;
   j. kernel D on the split route with shared dynamics (the solver's AL
      expansion, per lane, of the fused kernel's 3a, 3b and 3d window
      inputs: the flagship, the rocket window and grasp's window, B=1024),
      under 3a's gates, float32 and float64, each timed beside its plain
      version and its bound; the float32 errors count in max_abs_err;
   k. kernels D and A at the naive rocket's shapes (N=301, n=6, m=3; the
      goal ZERO block and three quadratic norm blocks), B=1024 and B=1,
      float32 and float64 (``bench/kernels.py: naive_rocket_inputs``): D
      with shared A/B on the solver's per-lane expansion of a mid-solve
      iterate (per-lane Hessians), A at the L=11 ladder, under 3a's gates;
      then each path's accepted rung (equal in float64, at most B/100 lanes
      apart in float32); each timed beside its plain version and its bound;
      the float32 errors count in max_abs_err;
   n. kernels B, C and A with a group axis at the grouped quadruped's
      shapes (``bench/kernels.py: grouped_inputs``: G = 8 contact
      schedules, n = m = 12, N=15, the friction cones), at B=1024 (128
      lanes a group) and B=24 (a ragged 3 lanes a group, fewer than a
      block's scenarios), float32 and float64, under 3a's gates (the
      plain versions run the shared plain version group by group): B, C
      at L=11 (J per lane, the accepted rung as in b), A's init form
      (L=1) and its L=11 ladder; each timed beside its plain version and
      its bound, and B and C beside their shared launch at the same B
      (group 0's stacks for every lane); the float32 errors count in
      max_abs_err;
4. main paths, each on CUDA graphs (``altro_tpu_torch/solver/graph.py``:
   every MPC step, batch solve and cold solve as start, loop and finish
   graphs, the loop replayed with one host sync per k passes), with the
   launch counters, the solver-loop pass counter (both counted per replay)
   and the counter of entries into the host-driven loop reset just before
   and read just after (gate: no entry over 4a-4e and 4g-4i):
   a. the flagship MPC benchmark (B=1024, T=20, float32): success,
      violation and counter gates;
   b. the rocket MPC benchmark in its shipped straggler-compaction schedule
      (cold N=301 solve, then B=1024, T=30, float32; cap 16, block 256, one
      level (16, 128)): success >= 0.999, violation of the succeeded
      solves <= 1e-4, kernels B and C once per counted pass, A once per
      solve, D never;
   c. the flat quadruped benchmark (B=1024, float32, both friction modes,
      QUAD_ROUNDS cold rounds after a warm-up solve): success 1.0,
      violation <= 1e-4, the Riccati kernel once and the ladder rollout once
      per counted pass (plus once per solve), kernels B and C never;
   n. the grouped quadruped (``families.quadruped_batched(grouped=True)``:
      each schedule's stacks shared by its lanes), B=1024, float32, both
      friction modes, QUAD_ROUNDS cold rounds after a warm-up solve:
      success 1.0, violation <= 1e-4, kernels B and C once per counted
      pass, A once per solve (the init rollout), D never, no entry into the
      host-driven loop; solves/s, round ms, iterations and passes printed
      beside 4c's flat row;
   o. the flat quadruped with straggler compaction (cap 4, block 128: the
      unconverged-first lanes gathered with their per-lane dynamics) from
      the same x0 as the plain flat solve, B=1024, both friction modes
      (gate: equal status and iterations on every lane; max|dU|, the
      bit-equality and the passes printed); then its row
      (``quadruped_batched(compact_cap=4)``) beside 4c's, with 4c's launch
      gates;
   d. the compacted step against the plain step on the card, rocket,
      grasp and flexsat, B=1024, 5 steps from one carry (gate: equal
      status and iterations on every lane-step; max|dU| and bit-equality
      printed);
   e. the grasp MPC benchmark in its shipped schedule (cold N=61 solve,
      then B=1024, T=15, float32; cap 8, block 256, one level (8, 128)):
      success >= 0.999, violation of the succeeded solves <= 1e-4, B and C
      once per counted pass, A once per cold solve, D never (run before d,
      which compares on its setup);
   g. the flexsat regulator MPC benchmark in its shipped schedule (one
      cold N=80 solve copied to B=1024 lanes, then T=45 regulator steps
      with re-based states, float32; cap 8, block 256, one level
      (8, 128)): success 1.0, violation <= 1e-4, B and C once per counted
      pass, A once (the cold solve's init rollout: the warm solves start
      from the re-based states), D never;
   h. the quadruped closed loop (``models/quadruped/controller.py:
      simulate_host``): a 2 s trot of one robot, 67 MPC periods of 30 ms,
      each the schedule and relinearization, the warm-started solve and 30
      ticks at 1 kHz of the swing legs and the RK4 plant, float64, nominal
      plant, both friction forms, every piece on CUDA graphs; prints the
      per-period solve, prep and tick ms (p50, p99, mean), iterations,
      passes and replays (gates, as the JAX package's closed-loop test:
      status 1 on every period, final height within 0.05 m of the stance
      height, |roll|, |pitch| < 0.2, vertical forces in [-1e-6, max + 1e-4];
      B and C once per counted pass, A once per solve, the warm-up
      period's included, D never);
   i. the closed loop against a mismatched plant (+10% mass, -10%
      inertia, a 3 mm / 1.5 mm foot-position error and a 0.1 m/s lateral
      kick at 0.9 s; 2 s, QP): status 1 on every period, final height
      within 0.07 m, |roll|, |pitch| < 0.15, final lateral velocity
      < 0.15 m/s;
   j. the flagship with per-lane window indices
      (``make_mpc_step(shared_k=False)``, the JAX package's default step;
      B=1024, LANE_T steps, float32, on graphs), lanes started at windows
      0-4: success 1.0; kernel D and kernel A once per counted pass, B and
      C never; no entry into the host-driven loop; the first AGREE_B lanes
      of every step, from the card's carry cast to float64, against the
      port's plain float64 step on the CPU (gate: equal status, max|U32 -
      U64| <= 1e-3); step ms p50 printed beside the shared-k step's;
   k. the naive rocket's one landing (``bench/conic.py:
      naive_rocket_setup``: the cold N=301 solve from the hover controls
      under the cold options, the default x0, B=1; the quadratic norm
      blocks take the split route), float32 and float64 on graphs, beside
      the conic form's cold solve in the same call (iterations, solve ms):
      status 1; kernel D once per counted pass, A once per pass and once
      more (the init rollout), B and C never; no entry into the host-driven
      loop; the float64 card solve against the port's plain float64 solve
      on the CPU (equal status and iterations, max|dU| <= 1e-6);
   l. the naive rocket's Monte-Carlo of 1024 landings (x0 = the default +
      0.5 N(0, 1) per component, numpy default_rng(0)), float32 on graphs:
      success >= 0.99, every succeeded lane's violation <= 1e-4, 4k's
      launch gates; iterations mean and lane-max, passes, solves/s and the
      solve's ms printed; then float64 on the same lanes (the same launch
      gates): success and the float32 controls' relative true-cost gap
      (mean, p99, max) printed;
   m. the nonlinear SRB trot (the flat quadruped batch on the RK4 SRB model
      itself, ``families.quadruped_setup(nonlinear=True)``: per-lane
      params, every pass relinearized per lane and knot, the ladder rolled
      out through the model), B=1024, both friction modes, float32 and
      float64, a warm-up solve and 2 cold rounds from the reference states:
      success 1.0, violation <= 1e-4, kernel D once per counted pass, A, B
      and C never; 64 lanes of the float64 card solve against the port's
      plain float64 solve on the CPU (equal status and iterations,
      max|dU| <= 1e-6);
   p. scenario sharding over ``torch.distributed`` (``altro_tpu_torch/
      parallel``) at world size 1 on NCCL, in this process: the flagship's
      ``sharded_mpc_step`` (B=1024, SHARD_T steps, float32, on graphs)
      against a fresh ``make_mpc_step(shared_k=True)`` from the same state
      (gates: equal status and iterations on every lane-step, U equal bit
      for bit, the three all-reduced metrics equal to the local sum, max
      and sum; success 1.0, violation <= 1e-4; B and A once per counted
      pass, C and D never; no entry into the host-driven loop); the group
      torn down; then ``parallel.dryrun.dryrun_multichip(1)`` (one spawned
      NCCL rank: the dry run's three programs and their checks; its
      launches count in the table) and ``bench/scaling.py: measure`` at
      1024 lanes a card and 10 steps (one spawned rank; the rows for more
      cards than the host has printed as not measured);
   r. the state_dim sweep's point n = 45 (m = 2, N = 21; seed 10, the
      sweep's options) as an MPC batch, B=1024, float32, WIDE_MPC_T warm
      steps on graphs, two ways: the split route
      (``make_mpc_step(shared_k=False)``, lanes started at windows 0-4:
      the wide bodies of D and A once per counted pass, B and C never) and
      the shared-window step with ``ls_fused="on"`` (the wide bodies of B
      and C once per counted pass, A and D never); no entry into the
      host-driven loop; success 1.0, violation <= 1e-4; success, max_viol,
      mean and lane-max iterations, step ms p50 and the profiled device ms
      per pass (by kernel) printed; then 64 lanes of the float64 step on
      the card against the port's plain float64 step on the CPU from the
      card's carry (gate: equal status and iterations, max|dU| <= 1e-6);
   q. per-lane constraint windows (``make_mpc_step(shared_k=False,
      constraints_fn=grasp_constraints)``: every lane's grasp window built
      at its own index on the device), B=1024, float32, N=21, T=LANE_GRASP_T
      steps, lanes started at windows 0-7, on graphs: success >= 0.999,
      violation of the succeeded solves <= 1e-4; kernel D and kernel A once
      per counted pass, B and C never; no entry into the host-driven loop;
      then the float64 step on the card against the port's plain float64
      step on the CPU from the card's carry, 16 lanes x 3 steps (gate:
      equal status and iterations, max|dU| <= 1e-6);
   f. graphed against eager on the card, every run from one carry: the
      flagship (B=1024, 10 steps), the rocket, grasp and flexsat in their
      shipped schedules (5 steps), the quadruped, flat and grouped (2 rounds
      in each friction mode), the closed loop (10 periods in each friction
      form), the naive rocket's one landing and the nonlinear SRB trot (one
      QP solve) (gate: equal status and iterations on every lane-step;
      max|dU| and the bit-equality of X, U and the duals printed, and per
      path the step ms p50 of both forms, passes and replays per step and
      the capture seconds);
5. agreement of the float32 kernel path on the card with the float64 plain
   path on the CPU:
   a. flagship, the same 64 lanes for 10 steps (gate: equal status,
      max|U32 - U64| <= 1e-3);
   b. rocket, 64 lanes x 5 steps, both from the card's float32 carry of
      each step with ls_fused="on", scored by the float64 true cost of
      each instance (``bench/agreement_conic.py: conic_agreement``; gates:
      at most one lane-step whose status differs, |mean gap| <= 1e-3, p99
      |gap| <= 2e-2; see its GATES);
   c. quadruped, 64 lanes (8 per schedule) of the same float64-built
      instances in both friction modes, scored by the float64 true cost of
      each lane's controls (gates: at most one lane whose status differs,
      |mean gap| <= 1e-4, p99 |gap| <= 1e-3);
   d. grasp, 64 lanes x 5 steps as in b (gates: at most one lane-step whose
      status differs, |mean gap| <= 1e-3, p99 |gap| <= 1e-2);
   e. flexsat (``altro_tpu_torch/bench/agreement_flexsat.py``): the plain
      float32 regulator step on the card, B=1024, 20 steps; 16 lanes of
      steps 5, 12 and 20 against float64 truth solves at 1e-7 on the CPU,
      every lane of those steps against a tight float64 re-solve on the
      card (gates: float32 success 1.0 and violation <= 1e-4, every truth
      solve succeeds, full-batch true-cost gap |mean| <= 1e-3 and p99
      |gap| <= 1e-2; the largest gap printed);
   g. the end-to-end gate modules: ``bench/fused_check.py`` in full
      (rocket and grasp, B=1024, T=6: kernel B's route against the split
      route, kernel D's, from the same carry at every step; gates: success
      of B's route >= the split route's, |mean gap| <= 1e-3, p99 |gap| <=
      2e-2, B's largest violation <= max(the split route's, the
      constraint tolerance), B and D each on its own route) and
      ``bench/agreement.py`` at T=3 (the ``shared_k=False`` flagship,
      B=1024, tolerances 1e-4 and 1e-6; gate: success 1.0 at both);
   h. the grouped quadruped's agreement module
      (``bench/agreement_quadruped.py``, B=512, instances at mid-phase):
      the flat and grouped float32 solves and a tight grouped float32
      re-solve on the card, 16 grouped lanes against float64 truths at
      1e-7 on the CPU, both friction modes (gates on the grouped layout:
      every truth solve succeeds, at most one lane whose status differs
      from the flat layout's, full-batch true-cost gap against the tight
      re-solve |mean| <= 1e-4 and p99 |gap| <= 1e-3);

6. baselines on the card (``altro_tpu_torch/bench/baselines.py`` and
   ``bench/drivers.py``), float64 unless the driver's dtype says otherwise;
   the kernel launches of the ALTRO side count in the kernel table:
   a. ``admm_qp``, ``admm_conic`` and ``knot_admm`` on the card against the
      port on the CPU on identical inputs: the random-linear QP (n=12, m=6,
      N=31), the rocket window's conic program, the quadruped QP and SOCP
      in knot form (gates: equal status, iterations within one CHUNK,
      max|dx| <= 10 eps_abs; graphed equal to eager in status and
      iterations); prints each solve's ms, chunks, and the chunk graph's
      device ms and launches;
   b. the lockstep on the card with ALTRO on kernels A/B/C:
      ``run_mpc_lockstep`` on the random-linear problem (N=21, T=10,
      qp_eps 1e-7; gates: every status 1, err_X, err_U < 5e-3, err_x0 <
      1e-5) and ``run_mpc_lockstep_conic`` on the rocket at tolerance 1e-6
      (T=5, conic_eps 1e-9; gates: every status 1, err_U < 1e-3);
   c. the quadruped table's four rows in both races
      (``drivers.quadruped_benchmark``: 67 periods each; the card race,
      ALTRO on the kernels against the knot ADMM on the card, and the C++
      race, the native AL-iLQR against the native knot ADMM on the host;
      gates per row: status 1 on every period, final height within 0.05 m
      of the stance height, |roll|, |pitch| < 0.2); prints ms/solve
      +- sigma, +prep, iterations and success per row;
   d. one pass of each driver at reduced T (T_DRIVER steps):
      random-linear horizon (all five N) and control_dim (float32, the
      JAX package's card dtype), rocket (the four tolerances), grasp (the
      five N) and flexsat (one trial); prints ALTRO and baseline ms/step,
      iterations, chunks and err_U per point (gates: ALTRO's success rate
      1.0 at every point of the random-linear and grasp sweeps; on the
      rocket both solvers' success rates 1.0 at every tolerance and err_U
      < 1e-3 at 1e-8; on flexsat both solvers' success rates 1.0).
   e. the four-solver studies (``drivers.rocket_multibaseline_tol`` and
      ``grasp_multibaseline_tol``: ALTRO's warm step on graphs, the dense
      conic and knot ADMM on the card, the native C++ conic solver on the
      host, each against a native truth solve at 1e-9) at T=2 and
      tolerances 1e-2 and 1e-8 (gates: every solver's success 1.0, every
      truth solve converged, ALTRO's error below 1e-3 at 1e-8);
   f. the quadruped's C++ race (``simulate_host(native=True)``) for 5
      periods in both friction modes, all four rows (gates: 5f's physical
      gates);
   g. the state_dim driver at n = 35, 45, 55 (the kernels' wide bodies),
      T_DRIVER steps (gates: success 1.0 at each point, all run).

7. the quickstart (``altro_tpu_torch/examples/quickstart.py``), all five
   sections at ``--fast`` on the card (gates: every solve succeeds, the
   closed loop's every period).

The line before the last is the kernel table as JSON (with each kernel's
bound_ms and bound_by at the shapes it was timed at, and library_ms null: no
single PyTorch call computes these knot recursions): a row per kernel with
its launches over every main path, and three rows for the nonlinear and
non-affine path, D and A at the naive rocket's N=301 (launches over 4k-4l)
and D at the nonlinear SRB's linearization (launches over 4m; float32 and
float64, the float32 result held to the float64 plain version within 4x
the plain float32 pass's own distance from it, as its Quu is
ill-conditioned), and three for the grouped quadruped, B, C (L=11) and
A's init form with a group axis (3n at B=1024, float32; launches over
4n), and four for the wide bodies at 4r's n = 45, m = 2 (3h at B=1024,
float32; launches over 4r); the launches of 4p (the sharded step and the
dry run's rank), 4q and 4r count in the four kernels' rows; the last line
is {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import time

import numpy as np
import torch

from altro_tpu_torch.bench.kernels import bound_ms, time_ms

FLAG_B, FLAG_T = 1024, 20
AGREE_B, AGREE_T = 64, 10
F32_TOL, F64_TOL, AGREE_TOL = 1e-3, 1e-9, 1e-3
ROCKET_B, ROCKET_T = 1024, 30
ROCKET_AGREE_B, ROCKET_AGREE_T = 64, 5
GRASP_B, GRASP_T = 1024, 15
GRASP_AGREE_B, GRASP_AGREE_T = 64, 5
# 4j: the shared_k=False flagship's steps and the spread of its lanes'
# start windows (0 .. LANE_SPREAD - 1)
LANE_T, LANE_SPREAD = 10, 5
# 5g: fused_check's steps, agreement's steps
FUSED_CHECK_T, AGREEMENT_T = 6, 3
# compacted-vs-plain comparison: batch and steps from one carry
COMPARE_B, COMPARE_T = 1024, 5
QUAD_B, QUAD_ROUNDS, QUAD_AGREE_B = 1024, 5, 64
# 3n: the grouped kernels' batches (G = 8 groups of 128 lanes, and the
# ragged 3 lanes); 4o: the flat quadruped's compaction (cap, block); 5h:
# the quadruped agreement module's batch (its default)
GROUPED_BATCHES = (1024, 24)
QUAD_COMPACT = (4, 128)
AQ_B = 512
QUAD_GATE_BIAS, QUAD_GATE_P99 = 1e-4, 1e-3
# graphed-against-eager comparison: flagship steps, conic and flexsat
# steps, quadruped rounds per friction mode
FORMS_FLAG_T, FORMS_CONIC_T, FORMS_QUAD_ROUNDS = 10, 5, 2
FLEX_B, FLEX_T, FLEX_AGREE_B = 1024, 45, 1024
# the quadruped closed loop: seconds of the main path, of the graphed-vs-eager
# and card-vs-CPU comparisons (10 periods), and the card-vs-CPU gates
LOOP_TF, LOOP_COMPARE_TF = 2.0, 0.3
LOOP_DX, LOOP_DFORCE = 1e-4, 1e-3
# phase 6: lockstep steps (random-linear, rocket) and the drivers' steps
LOCK_T, LOCK_ROCKET_T, T_DRIVER = 10, 5, 3
# 3g: phase 6's random-linear shapes (n, m, N) at B=1: the lockstep and
# the horizon sweep's shortest (12, 6, 21), its longest (12, 6, 101), the
# control_dim sweep's widest (30, 25, 21) and the state_dim sweep's points
# run on the card (25, 2, 21) and (2, 2, 21)
P6_LINEAR = ((12, 6, 21), (12, 6, 101), (30, 25, 21), (25, 2, 21),
             (2, 2, 21))
# 3h: the kernels' wide bodies (n or m above 32) at bench/kernels.py's
# WIDE_SHAPES (the state_dim sweep's n = 35, 45, 55 with m = 2, and
# n = m = 64 with 8 NONPOS rows and one SOC block of 4), N = 21, at one
# lane and at the batch where they are timed
WIDE_BATCHES = (1, 1024)
# phase 6: the four-solver studies' steps and tolerances, the quadruped's
# C++ race (periods of 30 ms) and the state_dim sweep's points above 32
MULTI_T, MULTI_TOLS = 2, (1e-2, 1e-8)
CPP_RACE_TF = 0.15
STATE_DIM_WIDE = (35, 45, 55)
# 3k, 4k, 4l: the naive rocket's Monte-Carlo batch (its kernels also run at
# one lane), the success gate of the batch, and the card-vs-CPU gate of the
# one landing in float64
NAIVE_B, NAIVE_SUCCESS, NAIVE_DU = 1024, 0.99, 1e-6
# 4m: the nonlinear SRB trot's batch, cold rounds per friction mode and
# dtype, and the lanes of its card-vs-CPU float64 comparison and its gate
SRB_B, SRB_ROUNDS, SRB_AGREE_B, SRB_DU = 1024, 2, 64, 1e-6
# 4p: the sharded flagship's batch and steps at world size 1; the scaling
# study's lanes per card and steps
SHARD_B, SHARD_T = 1024, 3
SCALING_B, SCALING_T = 1024, 10
# 4q: per-lane grasp windows: batch, steps, the spread of the start windows
# (0 .. LANE_GRASP_SPREAD - 1), the float64 card-vs-CPU lanes, steps and
# gate
LANE_GRASP_B, LANE_GRASP_T, LANE_GRASP_SPREAD = 1024, 15, 8
LANE_GRASP_AGREE_B, LANE_GRASP_AGREE_T, LANE_GRASP_DU = 16, 3, 1e-6
# 4r: the state_dim sweep's wide point (n, m, N) as an MPC batch, its
# batch and warm steps, and the float64 card-vs-CPU lanes and gate
WIDE_MPC, WIDE_MPC_B, WIDE_MPC_T = (45, 2, 21), 1024, 3
WIDE_MPC_AGREE_B, WIDE_MPC_DU = 64, 1e-6


def errors(got, ref, names, tol: float) -> dict:
    """{output name: max|got - ref|}; raises if any exceeds
    tol * max(1, max|ref|)."""
    errs = {}
    for name, g, r in zip(names, got, ref):
        err = float((g.double() - r.double()).abs().max())
        bound = tol * max(1.0, float(r.double().abs().max()))
        if not err <= bound:
            raise AssertionError(f"{name}: max|kernel - plain| = {err:.3e} > "
                                 f"{bound:.3e}")
        errs[name] = err
    return errs


def against_f64(label, got, ref32, ref64, names, factor: float = 4.0,
                tol: float = F32_TOL) -> dict:
    """Float32 parity where the inputs are ill-conditioned (the nonlinear
    SRB's Quu): the plain float32 pass is itself far from the answer, so
    the kernel is held to the float64 plain version on the same inputs,
    within ``factor`` times the plain float32 version's own distance from
    it, or tol max(1, max|ref64|) where that is larger. Returns {output:
    max|kernel - plain float32|} and prints both distances from float64."""
    errs = {}
    for name, g, r, t in zip(names, got, ref32, ref64):
        e_k = float((g.double() - t).abs().max())
        e_p = float((r.double() - t).abs().max())
        bound = max(factor * e_p, tol * max(1.0, float(t.abs().max())))
        print(f"{label} {name}: max|kernel - f64| {e_k:.3e}, max|plain f32 "
              f"- f64| {e_p:.3e}, gate {bound:.3e}")
        if not e_k <= bound:
            raise AssertionError(f"{label} {name}: max|kernel - f64| "
                                 f"{e_k:.3e} > {bound:.3e}")
        errs[name] = float((g.double() - r.double()).abs().max())
    return errs


def parity(dtype, tol):
    """Kernel vs plain version at the flagship shapes; returns
    {kernel: ({output: max_abs_err}, ms, plain_ms, (bytes, flops))} and the
    init form's ladder time beside it."""
    from altro_tpu_torch.bench.kernels import flagship_inputs
    from altro_tpu_torch.ops import riccati_fused, rollout

    fl = flagship_inputs(dtype, torch.device("cuda"))
    args, packed, ref = fl["fused"], fl["packed"], fl["fused_ref"]
    fb = riccati_fused.fused_expand_backward
    fb_ref = riccati_fused.fused_expand_backward_reference
    out = fb(*args, packed=packed)
    torch.cuda.synchronize()
    res = {"fused_expand_backward": (
        errors(out, ref, ("K", "d", "dV1", "dV2"), tol),
        time_ms(lambda: fb(*args, packed=packed), kernel=True),
        time_ms(lambda: fb_ref(*args)), fl["fused_work"])}

    ls = rollout.batched_ls_rollout
    ls_ref = rollout.batched_ls_rollout_reference
    largs, cargs = fl["ladder"], fl["init"]
    errs = errors(ls(*largs), ls_ref(*largs), ("Xs L=3", "Us L=3"), tol)
    # the cold-start form: L=1, alpha=1, K=d=0
    errs.update(errors(ls(*cargs), ls_ref(*cargs), ("Xs L=1", "Us L=1"), tol))
    res["batched_ls_rollout"] = (
        errs, time_ms(lambda: ls(*largs), kernel=True),
        time_ms(lambda: ls_ref(*largs)), fl["ladder_work"])
    res["batched_ls_rollout L=1"] = (
        {}, time_ms(lambda: ls(*cargs), kernel=True),
        time_ms(lambda: ls_ref(*cargs)), fl["init_work"])
    return res


def row_cases(blocks, X, U, lams, rhos):
    """Counts of the SOC blocks' masked residuals z = lam + rho c by case:
    inside, polar, boundary, and at the apex (v = 0); without an SOC block,
    of the NONPOS rows' by sign (active: z > 0)."""
    if all(c.cone.value != "soc" for c in blocks):
        counts = dict(active=0, inactive=0)
        for c, lam, rho in zip(blocks, lams, rhos):
            z = lam + rho[..., None] * c.evaluate(X, U)
            act = (c.mask > 0)[..., None]
            counts["active"] += int(((z > 0) & act).sum())
            counts["inactive"] += int(((z <= 0) & act).sum())
        return counts
    counts = dict(inside=0, polar=0, boundary=0, apex=0)
    for c, lam, rho in zip(blocks, lams, rhos):
        if c.cone.value != "soc":
            continue
        z = lam + rho[..., None] * c.evaluate(X, U)
        a = torch.linalg.vector_norm(z[..., :-1], dim=-1)
        s = z[..., -1]
        act = c.mask > 0
        inside, polar = a <= s, a <= -s
        counts["inside"] += int((inside & act).sum())
        counts["polar"] += int((polar & act).sum())
        counts["boundary"] += int((~(inside | polar) & act).sum())
        counts["apex"] += int(((a == 0) & act).sum())
    return counts


def conic_parity(family, dtype, tol, cold=False):
    """The fused expansion and the fused ladder + merit against their plain
    versions on the rocket's or grasp's MPC window (the SOC branch), on
    the flexsat regulator (one NONPOS block) or on the quadruped closed
    loop's one robot ("closed loop qp" / "closed loop socp", with the
    ladder rollout's init form too) (``cold``: the fused expansion alone,
    on grasp's cold problem); returns
    {kernel: ({output: max_abs_err}, ms, plain_ms, (bytes, flops))}."""
    from altro_tpu_torch.bench.kernels import (FLEX_LADDER, GRASP_LADDER,
                                               QUAD_LADDER, ROCKET_LADDER,
                                               flexsat_inputs, grasp_inputs,
                                               quadloop_inputs, rocket_inputs)
    from altro_tpu_torch.ops import riccati_fused, rollout, rollout_al
    from altro_tpu_torch.solver.altro import _ladder_choice

    dev = torch.device("cuda")
    loop = family.startswith("closed loop")
    if loop:
        B, ladder = 1, QUAD_LADDER
        rk = quadloop_inputs(dtype, dev, family.endswith("qp"))
    elif family == "rocket":
        B, ladder = ROCKET_B, ROCKET_LADDER
        rk = rocket_inputs(dtype, dev, B)
    elif family == "flexsat":
        B, ladder = FLEX_B, FLEX_LADDER
        rk = flexsat_inputs(dtype, dev, B)
    else:
        B, ladder = GRASP_B, GRASP_LADDER
        rk = grasp_inputs(dtype, dev, B, cold=cold)
    label = family + (" cold" if cold else "")
    pm, args, packed = rk["prob"], rk["fused"], rk["packed"]
    ref = rk["fused_ref"]
    blocks, (X, U, lams, rhos) = pm.constraints, args[4:8]
    cases = row_cases(blocks, X, U, lams, rhos)
    print(f"{label} parity inputs ({dtype}): {len(blocks)} blocks, "
          f"{packed.P} rows; row cases {cases}")
    # the closed loop's inputs hold no apex (a cone's z = 0 exactly)
    if min(v for k, v in cases.items() if not (loop and k == "apex")) == 0:
        raise AssertionError(f"{label} parity inputs miss a row case: "
                             f"{cases}")

    fb = riccati_fused.fused_expand_backward
    fb_ref = riccati_fused.fused_expand_backward_reference
    out = fb(*args, packed=packed)
    torch.cuda.synchronize()
    res = {"fused_expand_backward": (
        errors(out, ref, ("K", "d", "dV1", "dV2"), tol),
        time_ms(lambda: fb(*args, packed=packed), kernel=True),
        time_ms(lambda: fb_ref(*args)), rk["fused_work"])}
    if cold:
        return res

    _, _, dV1, dV2 = ref
    cargs = rk["ladder_al"]
    la = rollout_al.batched_ls_rollout_al
    la_ref = rollout_al.batched_ls_rollout_al_reference
    Xs, Us, J = la(*cargs, packed=packed)
    Xr, Ur, Jr = la_ref(*cargs)
    torch.cuda.synchronize()
    errs = errors((Xs, Us), (Xr, Ur), ("Xs", "Us"), tol)
    J_err = (J - Jr).abs()
    if not bool((J_err <= tol * torch.clamp(Jr.abs(), min=1.0)).all()):
        raise AssertionError(f"J: max|kernel - plain| / max(1, |J|) = "
                             f"{float((J_err / Jr.abs().clamp(min=1.0)).max()):.3e}"
                             f" > {tol:.0e}")
    errs["J"] = float(J_err.max())
    alphas = torch.tensor(ladder, dtype=dtype, device=dev)
    idx_k, acc_k, _, _ = _ladder_choice(J, alphas, dV1, dV2, 1e-4)
    idx_p, acc_p, _, _ = _ladder_choice(Jr, alphas, dV1, dV2, 1e-4)
    differ = int(((idx_k != idx_p) | (acc_k != acc_p)).sum())
    print(f"{label} parity ({dtype}): accepted rung differs on {differ} of "
          f"{B} lanes; rungs taken {torch.bincount(idx_p).tolist()}")
    if differ > (0 if dtype == torch.float64 else B // 100):
        raise AssertionError(f"accepted rung differs on {differ} lanes")
    res["batched_ls_rollout_al"] = (errs,
                                    time_ms(lambda: la(*cargs, packed=packed),
                                            kernel=True),
                                    time_ms(lambda: la_ref(*cargs)),
                                    rk["ladder_al_work"])
    if loop:
        ls = rollout.batched_ls_rollout
        ls_ref = rollout.batched_ls_rollout_reference
        iargs = rk["init"]
        res["batched_ls_rollout"] = (
            errors(ls(*iargs), ls_ref(*iargs), ("Xs L=1", "Us L=1"), tol),
            time_ms(lambda: ls(*iargs), kernel=True),
            time_ms(lambda: ls_ref(*iargs)), rk["init_work"])
    return res


def quadruped_parity(dtype, tol):
    """The Riccati kernel and the ladder rollout with per-lane dynamics
    against their plain versions on the flat quadruped batch; returns
    {kernel: ({output: max_abs_err}, ms, plain_ms, (bytes, flops))}."""
    from altro_tpu_torch.bench.kernels import quadruped_inputs
    from altro_tpu_torch.ops import riccati, rollout

    from altro_tpu_torch.convert import tree_to

    qd = quadruped_inputs(dtype, torch.device("cuda"), QUAD_B)
    args, ref = qd["riccati"], qd["riccati_ref"]
    bp, bp_ref = riccati.batched_riccati, riccati.batched_riccati_reference
    out = bp(*args)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(r).all()) for r in ref):
        raise AssertionError("quadruped parity inputs make Quu indefinite")
    names = ("K", "d", "dV1", "dV2")
    if dtype == torch.float32:
        # the plain float32 pass is itself nearly a gate's width from the
        # answer here: hold the kernel to the float64 answer instead, within
        # 1.5x the plain float32 pass's own distance e from it (or tol
        # max(1, max|f64|)), which is below what that gate let through
        # (tol max|plain f32| + e) wherever e < 2 tol max|plain f32|
        errs = against_f64("D quadruped", out, ref,
                           bp_ref(*tree_to(args, dtype=torch.float64)),
                           names, factor=1.5, tol=tol)
    else:
        errs = errors(out, ref, names, tol)
    res = {"batched_riccati": (errs,
                               time_ms(lambda: bp(*args), kernel=True),
                               time_ms(lambda: bp_ref(*args)),
                               qd["riccati_work"])}

    largs = qd["ladder"]
    ls, ls_ref = rollout.batched_ls_rollout, rollout.batched_ls_rollout_reference
    res["batched_ls_rollout"] = (
        errors(ls(*largs), ls_ref(*largs), ("Xs L=11", "Us L=11"), tol),
        time_ms(lambda: ls(*largs), kernel=True),
        time_ms(lambda: ls_ref(*largs)),
        qd["ladder_work"])
    return res


def grouped_parity(dtype, tol, B):
    """Kernels B, C and A with a group axis (the grouped quadruped: G = 8
    contact schedules of B/8 lanes, the friction cones) against their
    plain versions, which run the shared plain version group by group
    (float32 B held to the float64 plain version within 4x the plain
    float32 pass's own distance from it, ``against_f64``: the quadruped's
    Quu is ill-conditioned), and against the shared kernel launched once
    per group on its lanes (gate: bit for bit): B, C at L=11 (J per lane
    and the accepted rung as in 3b), A's init form (L=1) and its L=11
    ladder; each timed beside its bound, and B and C also launched with
    group 0's stacks shared by the whole batch (the shared launch at the
    same B). Returns {kernel: ({output: max_abs_err}, ms, plain_ms,
    (bytes, flops))}."""
    from altro_tpu_torch.bench.kernels import (QUAD_LADDER, grouped_inputs,
                                               per_group_launches)
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.ops import riccati_fused, rollout, rollout_al
    from altro_tpu_torch.solver.altro import _ladder_choice

    dev = torch.device("cuda")
    gi = grouped_inputs(dtype, dev, B)
    args, packed, ref = gi["fused"], gi["packed"], gi["fused_ref"]
    blocks, (X, U, lams, rhos) = gi["prob"].constraints, args[4:8]
    cases = row_cases(blocks, X, U, lams, rhos)
    G = gi["prob"].dynamics.groups
    reps = B // G

    def bit_equal(label, fn, gargs, got, **kw):
        exact = all(torch.equal(a, b) for a, b in zip(
            got, per_group_launches(fn, gargs, G, **kw)))
        print(f"{label} grouped B={B} ({dtype}): bit-equal to {G} shared "
              f"launches, one per group: {exact}")
        if not exact:
            raise AssertionError(f"{label}: the group-indexed launch differs"
                                 f" from the shared launches per group")
    print(f"grouped quadruped parity inputs ({dtype}, B={B}, reps={reps}): "
          f"{len(blocks)} blocks, {packed.P} rows; row cases {cases}")
    if min(v for k, v in cases.items() if k != "apex") == 0:
        raise AssertionError(f"grouped parity inputs miss a row case: "
                             f"{cases}")

    fb = riccati_fused.fused_expand_backward
    fb_ref = riccati_fused.fused_expand_backward_reference
    out = fb(*args, packed=packed, grouped=True)
    torch.cuda.synchronize()
    names = ("K", "d", "dV1", "dV2")
    if dtype == torch.float32:
        errs = against_f64(f"B grouped B={B}", out, ref,
                           fb_ref(*tree_to(args, dtype=torch.float64),
                                  grouped=True), names)
    else:
        errs = errors(out, ref, names, tol)
    bit_equal("B", fb, args, out, packed=packed)
    res = {"fused_expand_backward": (
        errs,
        time_ms(lambda: fb(*args, packed=packed, grouped=True), kernel=True),
        time_ms(lambda: fb_ref(*args, grouped=True)), gi["fused_work"])}
    sargs = gi["shared_fused"]
    res["fused_expand_backward shared"] = (
        {}, time_ms(lambda: fb(*sargs, packed=packed), kernel=True),
        time_ms(lambda: fb_ref(*sargs)), gi["shared_fused_work"])

    _, _, dV1, dV2 = ref
    cargs = gi["ladder_al"]
    la = rollout_al.batched_ls_rollout_al
    la_ref = rollout_al.batched_ls_rollout_al_reference
    Xs, Us, J = la(*cargs, packed=packed, grouped=True)
    Xr, Ur, Jr = la_ref(*cargs, grouped=True)
    torch.cuda.synchronize()
    bit_equal("C", la, cargs, (Xs, Us, J), packed=packed)
    errs = errors((Xs, Us), (Xr, Ur), ("Xs", "Us"), tol)
    J_err = (J - Jr).abs()
    if not bool((J_err <= tol * torch.clamp(Jr.abs(), min=1.0)).all()):
        raise AssertionError(f"J: max|kernel - plain| / max(1, |J|) = "
                             f"{float((J_err / Jr.abs().clamp(min=1.0)).max()):.3e}"
                             f" > {tol:.0e}")
    errs["J"] = float(J_err.max())
    alphas = torch.tensor(QUAD_LADDER, dtype=dtype, device=dev)
    idx_k, acc_k, _, _ = _ladder_choice(J, alphas, dV1, dV2, 1e-4)
    idx_p, acc_p, _, _ = _ladder_choice(Jr, alphas, dV1, dV2, 1e-4)
    differ = int(((idx_k != idx_p) | (acc_k != acc_p)).sum())
    print(f"grouped quadruped parity ({dtype}, B={B}): accepted rung differs"
          f" on {differ} of {B} lanes; rungs taken "
          f"{torch.bincount(idx_p).tolist()}")
    if differ > (0 if dtype == torch.float64 else B // 100):
        raise AssertionError(f"accepted rung differs on {differ} lanes")
    res["batched_ls_rollout_al"] = (
        errs, time_ms(lambda: la(*cargs, packed=packed, grouped=True),
                      kernel=True),
        time_ms(lambda: la_ref(*cargs, grouped=True)), gi["ladder_al_work"])
    sargs = gi["shared_ladder_al"]
    res["batched_ls_rollout_al shared"] = (
        {}, time_ms(lambda: la(*sargs, packed=packed), kernel=True),
        time_ms(lambda: la_ref(*sargs)), gi["shared_ladder_al_work"])

    ls = rollout.batched_ls_rollout
    ls_ref = rollout.batched_ls_rollout_reference
    for name, key, work in (("batched_ls_rollout", "init", "init_work"),
                            ("batched_ls_rollout L=11", "ladder",
                             "ladder_work")):
        a = gi[key]
        L = len(a[-1])
        bit_equal(f"A L={L}", ls, a, ls(*a, grouped=True))
        res[name] = (
            errors(ls(*a, grouped=True), ls_ref(*a, grouped=True),
                   (f"Xs L={L}", f"Us L={L}"), tol),
            time_ms(lambda: ls(*a, grouped=True), kernel=True),
            time_ms(lambda: ls_ref(*a, grouped=True)), gi[work])
    return res


def phase6_parity(dtype, tol):
    """Kernels A, B and C against their plain versions at the shapes phase 6
    gives them, one lane (B=1) and the ladder of the drivers' options (ten
    halvings and the alpha = 0 rung, L=11): A (that ladder and the init
    form) and B on the random-linear shapes P6_LINEAR; B and C on the rocket
    window (N=21), grasp's window at the sweep's longest N=51 and its cold
    form at N=251 (the driver's cold solve), and the flexsat regulator
    (N=80). Returns {shape: {kernel: {output: max_abs_err}}}; raises as
    :func:`errors` does, on a J gap beyond tol max(1, |J|), and in float64
    on a differing accepted rung."""
    from altro_tpu_torch.bench.kernels import (QUAD_LADDER, flagship_inputs,
                                               flexsat_inputs, grasp_inputs,
                                               rocket_inputs)
    from altro_tpu_torch.ops import riccati_fused, rollout, rollout_al
    from altro_tpu_torch.solver.altro import _ladder_choice

    dev = torch.device("cuda")
    fb = riccati_fused.fused_expand_backward
    fb_ref = riccati_fused.fused_expand_backward_reference
    ls, ls_ref = rollout.batched_ls_rollout, rollout.batched_ls_rollout_reference
    la = rollout_al.batched_ls_rollout_al
    la_ref = rollout_al.batched_ls_rollout_al_reference
    names = ("K", "d", "dV1", "dV2")
    out = {}
    for n, m, N in P6_LINEAR:
        fl = flagship_inputs(dtype, dev, B=1, widths=(n, m), N=N)
        largs, iargs = fl["ladder"][:-1] + (QUAD_LADDER,), fl["init"]
        errs = errors(ls(*largs), ls_ref(*largs), ("Xs L=11", "Us L=11"),
                      tol)
        errs.update(errors(ls(*iargs), ls_ref(*iargs), ("Xs L=1", "Us L=1"),
                           tol))
        out[f"random-linear n={n} m={m} N={N}"] = {
            "fused_expand_backward": errors(
                fb(*fl["fused"], packed=fl["packed"]), fl["fused_ref"],
                names, tol),
            "batched_ls_rollout": errs}
    alphas = torch.tensor(QUAD_LADDER, dtype=dtype, device=dev)
    for label, rk in (
            ("rocket window N=21", rocket_inputs(dtype, dev, 1)),
            ("grasp window N=51", grasp_inputs(dtype, dev, 1, N=51)),
            ("grasp cold N=251", grasp_inputs(dtype, dev, 1, cold=True,
                                              N=251)),
            ("flexsat N=80", flexsat_inputs(dtype, dev, 1))):
        packed = rk["packed"]
        res = {"fused_expand_backward": errors(
            fb(*rk["fused"], packed=packed), rk["fused_ref"], names, tol)}
        cargs = rk["ladder_al"][:-1] + (QUAD_LADDER,)
        Xs, Us, J = la(*cargs, packed=packed)
        Xr, Ur, Jr = la_ref(*cargs)
        errs = errors((Xs, Us), (Xr, Ur), ("Xs", "Us"), tol)
        gap = float(((J - Jr).abs() / Jr.abs().clamp(min=1.0)).max())
        if not gap <= tol:
            raise AssertionError(f"{label} J: max|kernel - plain| / "
                                 f"max(1, |J|) = {gap:.3e} > {tol:.0e}")
        errs["J"] = float((J - Jr).abs().max())
        _, _, dV1, dV2 = rk["fused_ref"]
        idx_k, acc_k, _, _ = _ladder_choice(J, alphas, dV1, dV2, 1e-4)
        idx_p, acc_p, _, _ = _ladder_choice(Jr, alphas, dV1, dV2, 1e-4)
        same = bool(((idx_k == idx_p) & (acc_k == acc_p)).all())
        print(f"{label} parity ({dtype}, B=1, L=11): accepted rung "
              f"{int(idx_p[0])} (plain), {'same' if same else 'differs'} "
              f"on the kernel")
        if dtype == torch.float64 and not same:
            raise AssertionError(f"{label}: accepted rung differs")
        res["batched_ls_rollout_al"] = errs
        out[label] = res
    return out


def wide_parity(dtype, tol, B):
    """Phase 3h: kernels A, B, C and D against their plain versions at the
    wide bodies' shapes (``bench/kernels.py: wide_inputs``, N=21): B, D on
    the same point (D on the solver's AL expansion of it), A at the
    drivers' L=11 ladder and its init form, C at L=11 (J per lane against
    max(1, |J|), the accepted rung equal in float64, on at most 1% of the
    lanes in float32), under 3a-3f's gates. Returns {(n, m): {kernel:
    ({output: max_abs_err}, ms, plain_ms, (bytes, flops))}}, timed at every
    batch."""
    from altro_tpu_torch.bench.kernels import (QUAD_LADDER, WIDE_SHAPES,
                                               wide_inputs)
    from altro_tpu_torch.ops import riccati, riccati_fused, rollout, rollout_al
    from altro_tpu_torch.solver.altro import _ladder_choice

    dev = torch.device("cuda")
    fb = riccati_fused.fused_expand_backward
    bp = riccati.batched_riccati
    ls = rollout.batched_ls_rollout
    la = rollout_al.batched_ls_rollout_al
    refs = {"fused_expand_backward":
            riccati_fused.fused_expand_backward_reference,
            "batched_riccati": riccati.batched_riccati_reference,
            "batched_ls_rollout": rollout.batched_ls_rollout_reference,
            "batched_ls_rollout L=1": rollout.batched_ls_rollout_reference,
            "batched_ls_rollout_al":
            rollout_al.batched_ls_rollout_al_reference}
    out = {}
    for n, m in WIDE_SHAPES:
        w = wide_inputs(dtype, dev, B, n, m)
        packed = w["packed"]
        calls = {"fused_expand_backward": (
                     lambda: fb(*w["fused"], packed=packed), w["fused"],
                     ("K", "d", "dV1", "dV2"), "fused_work"),
                 "batched_riccati": (lambda: bp(*w["riccati"]), w["riccati"],
                                     ("K", "d", "dV1", "dV2"),
                                     "riccati_work"),
                 "batched_ls_rollout": (lambda: ls(*w["ladder"]),
                                        w["ladder"], ("Xs", "Us"),
                                        "ladder_work"),
                 "batched_ls_rollout L=1": (lambda: ls(*w["init"]),
                                            w["init"], ("Xs", "Us"),
                                            "init_work")}
        res = {}
        for name, (fn, args, outs, work) in calls.items():
            got = fn()
            torch.cuda.synchronize()
            ref = refs[name](*args)
            errs = errors(got, ref, outs, tol)
            del got
            res[name] = (errs, time_ms(fn, kernel=True),
                         time_ms(lambda: refs[name](*args)), w[work])
        cargs = w["ladder_al"]
        Xs, Us, J = la(*cargs, packed=packed)
        Xr, Ur, Jr = refs["batched_ls_rollout_al"](*cargs)
        torch.cuda.synchronize()
        errs = errors((Xs, Us), (Xr, Ur), ("Xs", "Us"), tol)
        gap = float(((J - Jr).abs() / Jr.abs().clamp(min=1.0)).max())
        if not gap <= tol:
            raise AssertionError(f"n={n} m={m} B={B} J: max|kernel - plain|"
                                 f" / max(1, |J|) = {gap:.3e} > {tol:.0e}")
        errs["J"] = float((J - Jr).abs().max())
        _, _, dV1, dV2 = w["fused_ref"]
        alphas = torch.tensor(QUAD_LADDER, dtype=dtype, device=dev)
        idx_k, acc_k, _, _ = _ladder_choice(J, alphas, dV1, dV2, 1e-4)
        idx_p, acc_p, _, _ = _ladder_choice(Jr, alphas, dV1, dV2, 1e-4)
        differ = int(((idx_k != idx_p) | (acc_k != acc_p)).sum())
        if differ > (0 if dtype == torch.float64 else B // 100):
            raise AssertionError(f"n={n} m={m} B={B}: accepted rung differs "
                                 f"on {differ} lanes")
        del Xs, Us, Xr, Ur
        res["batched_ls_rollout_al"] = (
            errs, time_ms(lambda: la(*cargs, packed=packed), kernel=True),
            time_ms(lambda: refs["batched_ls_rollout_al"](*cargs)),
            w["ladder_al_work"])
        out[(n, m)] = res
        del w
        torch.cuda.empty_cache()
    return out


def quadruped_agreement():
    """Quadruped agreement: the same float64-built instances (64 lanes, both
    friction modes) solved by the float32 kernel path on the card and the
    float64 plain path on the CPU, both controls scored by the float64 true
    cost of each lane (its own dynamics, rolled out from its x0)."""
    from altro_tpu_torch.bench.families import quadruped_setup
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.solver.altro import solve

    Bn = QUAD_AGREE_B
    for lin in (True, False):
        s64 = quadruped_setup(Bn, lin, torch.float64, "cpu")
        s32 = tree_to(s64, "cuda", torch.float32)
        x0 = s64.draw_x0()
        p64 = dataclasses.replace(s64.prob, x0=x0)
        p32 = dataclasses.replace(s32.prob, x0=x0.to("cuda", torch.float32))
        o32 = solve(p32, s32.opts, U0=s32.U0)
        o64 = solve(p64, s64.opts, U0=s64.U0)
        U32 = o32.U.double().cpu()
        dyn, cost = p64.dynamics, p64.cost
        J64 = cost.total(dyn.rollout(x0, o64.U), o64.U)
        J32 = cost.total(dyn.rollout(x0, U32), U32)
        gap = (J32 - J64) / J64.abs().clamp(min=1e-12)
        status_diff = int((o32.stats.status.cpu() != o64.stats.status).sum())
        worst = int(gap.abs().argmax())
        p99 = float(torch.quantile(gap.abs(), 0.99))
        mode = "qp" if lin else "socp"
        print(f"quadruped agreement [{mode}] {Bn} lanes, f32 kernels vs f64 "
              f"plain: status differs on {status_diff} lanes (f64 success "
              f"{float(o64.stats.status.double().mean()):.4f}, f32 "
              f"{float(o32.stats.status.double().mean()):.4f}); true-cost gap"
              f" mean {float(gap.mean()):.3e}, p99 |gap| {p99:.3e}, worst "
              f"{float(gap[worst]):.3e} (lane {worst}); max|dU| "
              f"{float((U32 - o64.U).abs().max()):.3e}; iterations f32 mean "
              f"{float(o32.stats.iterations.double().mean()):.3f} max "
              f"{int(o32.stats.iterations.max())}, f64 mean "
              f"{float(o64.stats.iterations.double().mean()):.3f} max "
              f"{int(o64.stats.iterations.max())}")
        if status_diff > 1:
            raise AssertionError(f"quadruped [{mode}] status differs on "
                                 f"{status_diff} lanes")
        if not (abs(float(gap.mean())) <= QUAD_GATE_BIAS
                and p99 <= QUAD_GATE_P99):
            raise AssertionError(f"quadruped [{mode}] cost gap: mean "
                                 f"{float(gap.mean()):.3e}, p99 {p99:.3e}")


def grouped_main(card, reset_counts, read_counts, flat_rows):
    """Phase 4n: the grouped quadruped (``families.quadruped_batched(
    grouped=True)``), B=QUAD_B, both friction modes, float32 on graphs,
    beside 4c's flat rows (``flat_rows``: mode -> 4c's row); returns the
    launches. Gates: success 1.0, violation <= 1e-4, kernels B and C once
    per counted pass, A once per solve (its init rollout), D never, no
    entry into the host-driven loop."""
    from altro_tpu_torch.bench.families import quadruped_batched
    from altro_tpu_torch.solver import altro

    launches = {}
    for lin in (True, False):
        mode = "qp" if lin else "socp"
        reset_counts()
        res = quadruped_batched(B=QUAD_B, rounds=QUAD_ROUNDS,
                                linearized_friction=lin, grouped=True,
                                device="cuda")
        gl, passes = read_counts(), altro.pass_count
        eager = altro.eager_loop_count
        print(f"grouped quadruped main path [{card}]: {json.dumps(res)} "
              f"passes={passes} launches={gl}")
        rows = {"grouped": res, "flat": flat_rows[mode]}
        print(f"grouped vs flat [{mode}] B={QUAD_B} [{card}]: " + "; ".join(
            f"{k} solves/s {r['solves_per_s']:.1f}, round ms p50 "
            f"{r['round_ms_p50']:.3f} p99 {r['round_ms_p99']:.3f}, mean "
            f"iters {r['mean_iters']:.3f}, lane-max iters per solve "
            f"{r['lane_max_iters'] / r['solves']:.2f}, passes per solve "
            f"{r['loop_iterations'] / r['solves']:.2f}"
            for k, r in rows.items()))
        if not (res["success_rate"] == 1.0 and res["max_viol"] <= 1e-4):
            raise AssertionError(f"grouped quadruped quality: {res}")
        if not (passes > 0 and passes == res["loop_iterations"]
                and gl["fused_expand_backward"] == passes
                and gl["batched_ls_rollout_al"] == passes
                and gl["batched_ls_rollout"] == res["solves"]
                and gl["batched_riccati"] == 0 and eager == 0):
            raise AssertionError(f"grouped quadruped launch counts {gl} do "
                                 f"not match {passes} solver-loop passes of "
                                 f"{res['solves']} solves (host-loop "
                                 f"entries {eager})")
        for k, v in gl.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def compacted_quadruped(card, reset_counts, read_counts, flat_rows):
    """Phase 4o: the flat quadruped with straggler compaction (cap and
    block QUAD_COMPACT: every lane to the cap, the unconverged-first block
    gathered with its per-lane dynamics, resumed on a loop graph of its
    own, scattered back, a catch-all) against the plain flat solve from the
    same x0, B=QUAD_B, both friction modes, float32 on graphs (gate: equal
    status and iterations on every lane; max|dU| and bit-equality
    printed); then the compacted row (``quadruped_batched(compact_cap=)``)
    beside 4c's plain one, with 4c's launch gates. Returns the row's
    launches."""
    from altro_tpu_torch.bench.families import (quadruped_batched,
                                                quadruped_setup)
    from altro_tpu_torch.solver import altro, graph

    cap, block = QUAD_COMPACT
    launches = {}
    for lin in (True, False):
        mode = "qp" if lin else "socp"
        su = quadruped_setup(QUAD_B, lin, torch.float32, "cuda")
        x0 = su.draw_x0().to("cuda", torch.float32)
        sols, passes = {}, {}
        for form, compact in (("plain", None), ("compacted", (cap, block))):
            gs = graph.GraphedSolve(su.prob, su.opts, compact=compact)
            gs(x0, su.U0)                                  # capture, warm
            p0 = altro.pass_count
            sols[form] = gs(x0, su.U0)
            passes[form] = altro.pass_count - p0
        p, c = sols["plain"], sols["compacted"]
        differ = int(((p.stats.status != c.stats.status)
                      | (p.stats.iterations != c.stats.iterations)).sum())
        bit_equal = all(torch.equal(a, b) for a, b in
                        ((p.X, c.X), (p.U, c.U), (p.stats.viol,
                                                  c.stats.viol)))
        unconverged = int((p.stats.iterations > cap).sum())
        print(f"quadruped [{mode}] compacted (cap {cap}, block {block}) vs "
              f"plain, {QUAD_B} lanes from one x0 [{card}]: status or "
              f"iterations differ on {differ} lanes; max|dU| "
              f"{float((p.U - c.U).abs().max()):.3e}; bit-equal X, U, viol:"
              f" {bit_equal}; lanes past the cap {unconverged}; passes "
              f"plain {passes['plain']}, compacted {passes['compacted']} "
              f"(lane-max iterations {int(p.stats.iterations.max())})")
        if differ:
            raise AssertionError(f"quadruped [{mode}] compacted differs "
                                 f"from plain on {differ} lanes")
        reset_counts()
        res = quadruped_batched(B=QUAD_B, rounds=QUAD_ROUNDS,
                                linearized_friction=lin, compact_cap=cap,
                                compact_block=block, device="cuda")
        ol, opasses = read_counts(), altro.pass_count
        eager = altro.eager_loop_count
        flat = flat_rows[mode]
        print(f"compacted quadruped main path [{card}]: {json.dumps(res)} "
              f"passes={opasses} launches={ol}; plain flat: solves/s "
              f"{flat['solves_per_s']:.1f}, round ms p50 "
              f"{flat['round_ms_p50']:.3f} p99 {flat['round_ms_p99']:.3f}, "
              f"passes per solve "
              f"{flat['loop_iterations'] / flat['solves']:.2f}")
        if not (res["success_rate"] == 1.0 and res["max_viol"] <= 1e-4):
            raise AssertionError(f"compacted quadruped quality: {res}")
        if not (opasses > 0 and ol["batched_riccati"] == opasses
                and ol["batched_ls_rollout"] == opasses + res["solves"]
                and ol["fused_expand_backward"] == 0
                and ol["batched_ls_rollout_al"] == 0 and eager == 0):
            raise AssertionError(f"compacted quadruped launch counts {ol} "
                                 f"do not match {opasses} solver-loop "
                                 f"passes of {res['solves']} solves "
                                 f"(host-loop entries {eager})")
        for k, v in ol.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def grouped_agreement(card):
    """Phase 5h: ``bench/agreement_quadruped.py`` at AQ_B lanes: the flat
    and grouped float32 solves and a tight grouped float32 re-solve on the
    card, SAMPLE grouped lanes against float64 truths on the CPU; its gates
    (``agreement_quadruped.check``)."""
    from altro_tpu_torch.bench import agreement_quadruped as aq

    t0 = time.perf_counter()
    res = aq.run(AQ_B, "cuda")
    for mode, r in res["modes"].items():
        g, f = r["fullbatch_grouped"], r["fullbatch_flat"]
        print(f"quadruped agreement [{mode}] [{card}] {AQ_B} lanes at "
              f"mid-phase: success grouped {r['tpu_success_rate']:.4f}, flat"
              f" {r['flat_success_rate']:.4f}, tight "
              f"{r['tight_success_rate']:.4f}; status differs on "
              f"{r['status_differs']} lanes; max_viol "
              f"{r['tpu_max_viol']:.3e}; gap vs tight f32, grouped mean "
              f"{g['gap_mean']:.3e} p99 |gap| {g['gap_abs_p99']:.3e} max "
              f"{g['gap_max']:.3e}, flat mean {f['gap_mean']:.3e} p99 |gap| "
              f"{f['gap_abs_p99']:.3e} max {f['gap_max']:.3e}; "
              f"{res['config']['sample']} lanes against f64 truth at 1e-7 "
              f"(CPU): success {r['truth_success']}, max|dU| "
              f"{r['err_U_max']:.3e} (mean {r['err_U_mean']:.3e}), max|du0| "
              f"{r['err_u0_max']:.3e}, cost gap max "
              f"{r['cost_rel_gap_max']:.3e} mean "
              f"{r['cost_rel_gap_mean']:.3e}")
    aq.check(res)
    print(f"phase 5h: {time.perf_counter() - t0:.1f} s", flush=True)


def conic_noise(su, T):
    """A conic family's benchmark noise for T steps of COMPARE_B lanes."""
    return torch.as_tensor(np.random.default_rng(su.noise_seed)
                           .standard_normal((T, COMPARE_B, 6)),
                           dtype=torch.float32, device="cuda")


def compacted_against_plain(label, make, sched, noise):
    """A family's shipped compaction schedule ``sched`` (cap, block,
    levels) against its plain step on the card (``make(cap, block,
    levels)`` -> (step, init_carry); cap 0: the plain step): COMPARE_B
    lanes, COMPARE_T steps from one carry. Gate: equal status and equal
    iterations on every lane-step."""
    cap, block, levels = sched
    pstep, init = make(0, 256, ())
    cstep, _ = make(cap, block, levels)
    pc = cc = init(COMPARE_B)
    dU, bit_equal, differ = 0.0, True, 0
    for t in range(COMPARE_T):
        pc, po = pstep(pc, noise[t], t)
        cc, co = cstep(cc, noise[t], t)
        differ += int(((co.status != po.status) | (co.iters != po.iters))
                      .sum())
        dU = max(dU, float((co.U - po.U).abs().max()))
        bit_equal &= all(torch.equal(getattr(co, k), getattr(po, k))
                         for k in ("X", "U", "viol"))
    print(f"{label} compacted {(cap, block, levels)} vs plain, "
          f"{COMPARE_B} lanes x {COMPARE_T} steps on the card: status or "
          f"iterations differ on {differ} lane-steps; max|dU| {dU:.3e}; "
          f"bit-equal X, U, viol: {bit_equal}")
    if differ:
        raise AssertionError(f"{label} compacted step differs from the "
                             f"plain one on {differ} lane-steps")


def _timed(fn):
    """(fn(), host ms of fn up to a device synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _compare(label, g_runs, e_runs, card, stats):
    """Gate and print one path's graphed-against-eager comparison.
    ``g_runs``/``e_runs``: per lane-step group, (trees, status, iters, U)
    of the graphed and the eager form; ``stats``: per form, (step ms list,
    passes, replays, steps, capture s)."""
    differ, dU, bit_equal = 0, 0.0, True
    for (gt, gs, gi, gU), (et, es, ei, eU) in zip(g_runs, e_runs):
        differ += int(((gs != es) | (gi != ei)).sum())
        dU = max(dU, float((gU - eU).abs().max()))
        bit_equal &= all(torch.equal(a, b) for a, b in
                         zip(graph_tensors(gt), graph_tensors(et)))
    line = []
    for form, (ms, passes, replays, steps, cap_s) in stats.items():
        line.append(f"{form}: step ms p50 {float(np.median(ms)):.3f}, "
                    f"passes/step {passes / steps:.2f}, replays/step "
                    f"{replays / steps:.2f}, capture {cap_s:.3f} s")
    print(f"graphed vs eager [{label}] [{card}]: status or iterations "
          f"differ on {differ} lane-steps; max|dU| {dU:.3e}; bit-equal X, "
          f"U, duals: {bit_equal}; " + "; ".join(line))
    if differ:
        raise AssertionError(f"{label}: graphed and eager differ on "
                             f"{differ} lane-steps")


def graph_tensors(tree):
    from altro_tpu_torch.solver.graph import tensors
    return tensors(tree)


def graphed_against_eager(card, su32, gsu32, fsu):
    """Phase 4f: every path graphed and eager on the card from one carry
    (or the same initial states): equal status and iterations on every
    lane-step."""
    from altro_tpu_torch.bench.conic import SCHEDULES, make_step
    from altro_tpu_torch.bench.families import (FLEXSAT_SCHEDULE,
                                                flexsat_step,
                                                quadruped_setup)
    from altro_tpu_torch.bench.flagship import flagship_setup
    from altro_tpu_torch.mpc import make_mpc_step
    from altro_tpu_torch.solver import altro, graph

    def steps_of(step, carry, noise, T):
        runs, ms = [], []
        p0, r0 = altro.pass_count, getattr(step, "loop_replays", 0)
        for t in range(T):
            (carry, out), t_ms = _timed(lambda: step(carry, noise[t], t))
            runs.append(((carry[1], carry[2], carry[3]), out.status,
                         out.iters, out.U))
            ms.append(t_ms)
        return runs, (ms, altro.pass_count - p0,
                      getattr(step, "loop_replays", 0) - r0, T,
                      getattr(step, "capture_s", 0.0))

    def compare_steps(label, make, carry, noise, T):
        runs, stats = {}, {}
        for form in ("graphed", "eager"):
            step, _ = make(form == "graphed")
            step(carry, noise[0], 0)                       # capture, warm
            runs[form], stats[form] = steps_of(step, carry, noise, T)
        _compare(label, runs["graphed"], runs["eager"], card, stats)

    su = flagship_setup(FLAG_B, FORMS_FLAG_T, device="cuda")
    make = (lambda g: make_mpc_step(su.prob_mpc, su.opts, su.X_track,
                                    su.U_track, graphed=g))
    compare_steps("flagship", make, make(False)[1](FLAG_B), su.noise,
                  FORMS_FLAG_T)
    for csu in (su32, gsu32):
        cap, block, levels = SCHEDULES[csu.family]
        make = (lambda g, c=csu, cap=cap, block=block, levels=levels:
                make_step(c, cap, block, levels, graphed=g))
        compare_steps(f"{csu.family} compacted", make,
                      make(False)[1](COMPARE_B),
                      conic_noise(csu, FORMS_CONIC_T), FORMS_CONIC_T)
    make = (lambda g: flexsat_step(fsu, *FLEXSAT_SCHEDULE, graphed=g))
    compare_steps("flexsat compacted", make, make(False)[1](COMPARE_B),
                  fsu.noise, FORMS_CONIC_T)
    for lin, grouped in ((True, False), (False, False), (True, True),
                         (False, True)):
        qsu = quadruped_setup(QUAD_B, lin, torch.float32, "cuda",
                              grouped=grouped)
        x0s = [qsu.draw_x0().to("cuda", torch.float32)
               for _ in range(FORMS_QUAD_ROUNDS)]
        gs = graph.GraphedSolve(qsu.prob, qsu.opts)
        gs(x0s[0], qsu.U0)                                 # capture, warm
        runs, stats = {}, {}
        for form in ("graphed", "eager"):
            ms, rows = [], []
            p0, r0 = altro.pass_count, gs.replays
            for x0 in x0s:
                if form == "graphed":
                    sol, t_ms = _timed(lambda: gs(x0, qsu.U0))
                else:
                    sol, t_ms = _timed(lambda: altro.solve(
                        dataclasses.replace(qsu.prob, x0=x0), qsu.opts,
                        U0=qsu.U0))
                rows.append(((sol.X, sol.U, sol.duals), sol.stats.status,
                             sol.stats.iterations, sol.U))
                ms.append(t_ms)
            runs[form] = rows
            stats[form] = (ms, altro.pass_count - p0,
                           (gs.replays - r0) if form == "graphed" else 0,
                           len(x0s), gs.capture_s if form == "graphed"
                           else 0.0)
        _compare(f"quadruped {'grouped ' if grouped else ''}"
                 f"{'qp' if lin else 'socp'}", runs["graphed"],
                 runs["eager"], card, stats)


def _loop_setup(lin: bool = True):
    from altro_tpu_torch.bench.drivers import QUAD_OPTS
    from altro_tpu_torch.models.quadruped import config
    from altro_tpu_torch.solver.options import SolverOptions
    return (config.MPCConfig(linearized_friction=lin),
            SolverOptions(**QUAD_OPTS))


def _pct(a, q):
    return float(np.percentile(np.asarray(a), q))


def closed_loop_main(card, lin, counts):
    """Phase 4h for one friction form: the 2 s closed loop through
    ``simulate_host`` on graphs; ``counts()`` returns (launches, passes,
    eager-loop entries) since the caller's reset. Gates its quality and its
    launches; returns the launches."""
    from altro_tpu_torch.models.quadruped import controller
    cfg, opts = _loop_setup(lin)
    res = controller.simulate_host(cfg, opts, tf=LOOP_TF, device="cuda",
                                   native=False)
    launches, passes, eager = counts()
    status = res["status"].cpu()
    xs = res["x"].cpu()
    fz = res["forces"].cpu().reshape(-1, 4, 3)[:, :, 2]
    iters = res["iters"].cpu()
    periods = int(status.numel())
    solves = periods + 1                  # the warm-up period's solve
    mode = "qp" if lin else "socp"
    mpc, prep, tick = res["mpc_ms"], res["prep_ms"], res["tick_ms"]
    height = abs(float(xs[-1, 2]) - cfg.stance_height)
    att = float(xs[:, 3:5].abs().max())
    print(f"closed loop [{mode}] main path [{card}]: {periods} periods of "
          f"{cfg.update_dt * 1e3:.0f} ms, float64, graphs; solve ms p50 "
          f"{_pct(mpc, 50):.3f} p99 {_pct(mpc, 99):.3f} mean "
          f"{float(np.mean(mpc)):.3f}; prep ms p50 {_pct(prep, 50):.3f} mean "
          f"{float(np.mean(prep)):.3f}; tick ms (30 ticks) p50 "
          f"{_pct(tick, 50):.3f} mean {float(np.mean(tick)):.3f}; period ms "
          f"mean {float(np.mean(mpc) + np.mean(prep) + np.mean(tick)):.3f}; "
          f"iterations mean {float(iters.double().mean()):.3f} max "
          f"{int(iters.max())}; success {float(status.double().mean()):.4f}"
          f"; passes {passes} ({passes / solves:.3f} per solve); loop "
          f"replays {res['loop_replays']}; set-up {res['setup_s']:.3f} s, "
          f"of which capture {res['capture_s']:.3f} s; final height error "
          f"{height:.4f} m, max |roll|,|pitch| {att:.4f}, vertical forces "
          f"[{float(fz.min()):.3e}, {float(fz.max()):.3f}] N; launches "
          f"{launches}")
    if not _loop_physical(cfg, res):
        raise AssertionError(f"closed loop [{mode}] quality: status "
                             f"{status.tolist()}, height error {height}, "
                             f"attitude {att}, forces "
                             f"[{float(fz.min())}, {float(fz.max())}]")
    if not (passes > 0 and launches["fused_expand_backward"] == passes
            and launches["batched_ls_rollout_al"] == passes
            and launches["batched_ls_rollout"] == solves
            and launches["batched_riccati"] == 0 and eager == 0):
        raise AssertionError(f"closed loop [{mode}] launch counts {launches}"
                             f" do not match {passes} passes of {solves} "
                             f"solves, or the host-driven loop ran ({eager})")
    return launches


def closed_loop_mismatch(card, counts):
    """Phase 4i: the closed loop against the mismatched plant (the JAX
    package's model-mismatch test), 2 s, QP, on graphs."""
    from altro_tpu_torch.models.quadruped import controller
    cfg, opts = _loop_setup(True)
    kw = dict(dtype=torch.float64, device="cuda")
    plant = controller.PlantParams(
        mass_scale=torch.tensor(1.10, **kw),
        inertia_scale=torch.tensor(0.90, **kw),
        foot_offset=torch.tensor([0.003, 0.0015, 0.0], **kw),
        kick_impulse=torch.tensor([0.0, 0.1, 0.0], **kw),
        kick_t=torch.tensor(0.9, **kw))
    res, ms = _timed(lambda: controller.simulate(cfg, opts, tf=LOOP_TF,
                                                 plant=plant, device="cuda"))
    launches, passes, eager = counts()
    status, xs = res["status"].cpu(), res["x"].cpu()
    height = abs(float(xs[-1, 2]) - cfg.stance_height)
    att = float(xs[:, 3:5].abs().max())
    vy = abs(float(xs[-1, 7]))
    print(f"closed loop mismatch [{card}]: {status.numel()} periods in "
          f"{ms:.1f} ms (capture included); success "
          f"{float(status.double().mean()):.4f}, iterations mean "
          f"{float(res['iters'].double().mean()):.3f}; final height error "
          f"{height:.4f} m, max |roll|,|pitch| {att:.4f}, final lateral "
          f"velocity {vy:.4f} m/s; passes {passes}; launches {launches}")
    if not (int(status.min()) == 1 and height < 0.07 and att < 0.15
            and vy < 0.15):
        raise AssertionError(f"closed loop mismatch: status "
                             f"{status.tolist()}, height error {height}, "
                             f"attitude {att}, lateral velocity {vy}")
    if not (passes > 0 and launches["fused_expand_backward"] == passes
            and launches["batched_ls_rollout_al"] == passes
            and launches["batched_ls_rollout"] == status.numel()
            and launches["batched_riccati"] == 0 and eager == 0):
        raise AssertionError(f"closed loop mismatch launch counts {launches}"
                             f" do not match {passes} passes")
    return launches


def closed_loop_forms(card):
    """Phase 4f's closed loop: 10 periods graphed against eager on the card,
    each friction form (gate: equal status and iterations per period)."""
    from altro_tpu_torch.models.quadruped import controller
    for lin in (True, False):
        cfg, opts = _loop_setup(lin)
        runs, ms = {}, {}
        for form in ("graphed", "eager"):
            runs[form], ms[form] = _timed(lambda: controller.simulate(
                cfg, opts, tf=LOOP_COMPARE_TF, device="cuda",
                graphed=form == "graphed"))
        g, e = runs["graphed"], runs["eager"]
        differ = int(((g["status"] != e["status"])
                      | (g["iters"] != e["iters"])).sum())
        dx = float((g["x"] - e["x"]).abs().max())
        mode = "qp" if lin else "socp"
        print(f"graphed vs eager [closed loop {mode}] [{card}]: "
              f"{g['status'].numel()} periods, status or iterations differ "
              f"on {differ}; max|dx| {dx:.3e}; bit-equal x, forces: "
              f"{torch.equal(g['x'], e['x'])}, "
              f"{torch.equal(g['forces'], e['forces'])}; run ms graphed "
              f"{ms['graphed']:.1f} (capture included), eager "
              f"{ms['eager']:.1f}")
        if differ:
            raise AssertionError(f"closed loop {mode}: graphed and eager "
                                 f"differ on {differ} periods")


def _loop_physical(cfg, res) -> bool:
    """The JAX package's closed-loop gates on one run: status 1 on every
    period, final height within 0.05 m, |roll|, |pitch| < 0.2, vertical
    forces in [-1e-6, max + 1e-4]."""
    xs = res["x"].cpu()
    fz = res["forces"].cpu().reshape(-1, 4, 3)[:, :, 2]
    return (int(res["status"].min()) == 1
            and abs(float(xs[-1, 2]) - cfg.stance_height) < 0.05
            and float(xs[:, 3:5].abs().max()) < 0.2
            and float(fz.min()) >= -1e-6
            and float(fz.max()) <= cfg.max_vert_force + 1e-4)


def closed_loop_agreement(card):
    """Phase 5f: the closed loop on the card (float64 kernels) against the
    port's own float64 run on the CPU (plain versions), 10 periods of each
    friction form. Gates: equal status on every period; max|dx| and
    max|d forces| within LOOP_DX and LOOP_DFORCE over the periods before
    the first whose iteration count differs (a split: a decision taken at
    round-off, such as the sign of lam + rho c on a NONPOS row whose
    residual and multiplier are both ~1e-30, which sets whether the row
    carries curvature); from the split on, the JAX package's physical gates
    on both runs. The split's period and the differences over all periods
    are printed."""
    from altro_tpu_torch.models.quadruped import controller
    for lin in (True, False):
        cfg, opts = _loop_setup(lin)
        c = controller.simulate(cfg, opts, tf=LOOP_COMPARE_TF, device="cuda")
        h = controller.simulate(cfg, opts, tf=LOOP_COMPARE_TF, device="cpu")
        same = bool(torch.equal(c["status"].cpu(), h["status"]))
        it_c, it_h = c["iters"].cpu(), h["iters"]
        split = next((k for k in range(len(it_h)) if it_c[k] != it_h[k]),
                     len(it_h))
        dx_k = (c["x"].cpu() - h["x"]).abs().amax(-1)
        df_k = (c["forces"].cpu() - h["forces"]).abs().amax(-1)
        dx = float(dx_k[:split].max()) if split else 0.0
        df = float(df_k[:split].max()) if split else 0.0
        phys = _loop_physical(cfg, c) and _loop_physical(cfg, h)
        mode = "qp" if lin else "socp"
        print(f"closed loop agreement [{mode}] [{card}], {len(it_h)} "
              f"periods, card f64 kernels vs CPU f64 plain: equal status "
              f"{same}; iterations card {it_c.tolist()}, CPU "
              f"{it_h.tolist()}; first split at period "
              f"{split if split < len(it_h) else 'none'}; before it max|dx| "
              f"{dx:.3e} (gate {LOOP_DX:.0e}), max|d forces| {df:.3e} N "
              f"(gate {LOOP_DFORCE:.0e}); over all periods max|dx| "
              f"{float(dx_k.max()):.3e}, max|d forces| "
              f"{float(df_k.max()):.3e} N; physical gates on both: {phys}")
        if not (same and dx <= LOOP_DX and df <= LOOP_DFORCE and phys):
            raise AssertionError(f"closed loop [{mode}] card vs CPU: status "
                                 f"equal {same}, before the split at "
                                 f"{split}: max|dx| {dx:.3e}, max|dF| "
                                 f"{df:.3e}; physical gates {phys}")


def lockstep_on_card(card):
    """Phase 6b: the two lockstep loops on the card in float64 (ALTRO on
    kernels A/B/C, the ADMM baselines on graphs), gated as the JAX
    package's tests."""
    from altro_tpu_torch.bench.baselines import rocket_window
    from altro_tpu_torch.models import random_linear as rl
    from altro_tpu_torch.models import rocket
    from altro_tpu_torch.mpc import (run_mpc_lockstep,
                                     run_mpc_lockstep_conic)
    from altro_tpu_torch.solver.options import SolverOptions
    kw = dict(dtype=torch.float64, device="cuda")
    rng = np.random.default_rng(1)
    prob = rl.gen_random_linear(rng, 12, 6, 121, **kw)
    X, U = rl.gen_trajectory(rng, prob, 121)
    pm = rl.gen_tracking_mpc(prob, X, U, 21)
    noise = torch.tensor(np.random.default_rng(3).standard_normal(
        (LOCK_T, 12)), **kw)
    t0 = time.perf_counter()
    res = run_mpc_lockstep(pm, SolverOptions(
        cost_tolerance=1e-4, constraint_tolerance=1e-4, penalty_initial=1e3,
        penalty_scaling=100.0, reset_duals=False), X, U, noise, qp_eps=1e-7)
    secs = time.perf_counter() - t0
    print(f"lockstep random-linear [{card}] T={LOCK_T}: {secs:.2f} s; "
          f"iterations ALTRO/ADMM-QP {res.iters[:, 0].tolist()} / "
          f"{res.iters[:, 1].tolist()}; max err_X "
          f"{float(res.err_X.max()):.3e}, err_U {float(res.err_U.max()):.3e},"
          f" err_x0 {float(res.err_x0.max()):.3e}")
    if not (int(res.status.min()) == 1 and float(res.err_X.max()) < 5e-3
            and float(res.err_U.max()) < 5e-3
            and float(res.err_x0.max()) < 1e-5):
        raise AssertionError(f"random-linear lockstep: {res}")

    pw, cold_X, cold_U = rocket_window("cuda")
    noise = torch.tensor(np.random.default_rng(1).standard_normal(
        (LOCK_ROCKET_T, 6)), **kw)
    tol = 1e-6
    t0 = time.perf_counter()
    res = run_mpc_lockstep_conic(
        pw, SolverOptions(
            cost_tolerance=tol, gradient_tolerance=tol * 1e-2,
            constraint_tolerance=tol, penalty_initial=1e3,
            penalty_scaling=10.0, reset_duals=False, iterations_outer=40),
        cold_X, cold_U, noise, conic_eps=1e-9, conic_max_iter=50000,
        noise_model=rocket.rocket_noise_model())
    secs = time.perf_counter() - t0
    print(f"lockstep rocket [{card}] tol {tol:g}, T={LOCK_ROCKET_T}: "
          f"{secs:.2f} s; iterations ALTRO/ADMM-conic "
          f"{res.iters[:, 0].tolist()} / {res.iters[:, 1].tolist()}; max "
          f"err_U {float(res.err_U.max()):.3e}")
    if not (int(res.status.min()) == 1 and float(res.err_U.max()) < 1e-3):
        raise AssertionError(f"rocket lockstep: {res}")


def quadruped_table(card):
    """Phase 6c: the quadruped table's four rows in both races, each over
    the 2 s closed loop: the card race (ALTRO on the kernels against the
    knot ADMM on the card) and the C++ race (the native AL-iLQR against the
    native knot ADMM on the host, the JAX package's table)."""
    from altro_tpu_torch.bench import drivers
    from altro_tpu_torch.models.quadruped import config
    stance = config.MPCConfig().stance_height
    res = drivers.quadruped_benchmark(tf=LOOP_TF, device="cuda")
    for race, rows in (("card race", res), ("C++ race", res["cpp_race"])):
        for name, r in rows.items():
            if not (isinstance(r, dict) and "ms_per_solve" in r):
                continue
            print(f"quadruped table, {race} [{card}] {name}: "
                  f"{r['ms_per_solve']:.3f} +- {r['ms_per_solve_std']:.3f} "
                  f"ms/solve (+{r['ms_prep']:.3f} prep), "
                  f"{r['mean_iters']:.2f} iterations, success "
                  f"{r['success']:.3f} over {r['periods']} periods; ADMM "
                  f"chunks {r['admm_chunks']}, ALTRO loop replays "
                  f"{r['loop_replays']}; final height "
                  f"{r['final_height']:.4f} m, max |roll|,|pitch| "
                  f"{r['max_roll_pitch']:.4f}")
            if not (r["success"] == 1.0
                    and abs(r["final_height"] - stance) < 0.05
                    and r["max_roll_pitch"] < 0.2):
                raise AssertionError(f"quadruped table, {race}, {name}: "
                                     f"{r}")
    print(res["table_md"])
    print(res["cpp_table_md"])


def drivers_once(card):
    """Phase 6d: one pass of each driver at T_DRIVER steps."""
    from altro_tpu_torch.bench import drivers
    runs = (
        ("random_linear_horizon",
         lambda: drivers.random_linear_sweep("horizon", T=T_DRIVER)),
        ("random_linear_control_dim",
         lambda: drivers.random_linear_sweep("control_dim", T=T_DRIVER)),
        ("rocket", lambda: drivers.rocket_tol_sweep(T=T_DRIVER)),
        ("grasp", lambda: drivers.grasp_horizon_sweep(T=T_DRIVER)),
        ("flexsat", lambda: drivers.flexsat_benchmark(T=T_DRIVER,
                                                      trials=1)))
    for name, fn in runs:
        print(f"driver {name} [{card}], T={T_DRIVER}:", flush=True)
        t0 = time.perf_counter()
        res = fn()
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
        for x, e in res.get("errs", {}).items():
            if e["success"] != 1.0:
                raise AssertionError(f"driver {name} at {x}: {e}")
        for r in res.get("rows", []):
            # the rocket's tolerances: both solvers succeed on every step,
            # and at the tightest ALTRO agrees with the conic ADMM as in 6b
            if not (r["success"] == 1.0 and r["baseline_success"] == 1.0
                    and (r["tol"] > 1e-8 or r["err_U"] < 1e-3)):
                raise AssertionError(f"driver {name} at tol {r['tol']}: "
                                     f"{r}")
        if name == "flexsat" and not (res["altro_success"] == 1.0
                                      and res["qp_success"] == 1.0):
            raise AssertionError(f"driver flexsat: ALTRO success "
                                 f"{res['altro_success']}, ADMM-QP success "
                                 f"{res['qp_success']}")


def multibaseline_on_card(card):
    """Phase 6e: the four-solver studies on the card (ALTRO's warm step on
    graphs, both ADMM forms on the card, the native C++ solver on the host)
    at MULTI_T steps and MULTI_TOLS. Gates: every solver's success 1.0 at
    both tolerances, every native truth solve converged (the driver raises
    otherwise), ALTRO's error against the truth below 1e-3 at 1e-8 (the
    JAX package's CPU record, at T=10, reads 4e-5 on the rocket and ~0 on
    grasp there). The loose tolerance's errors are printed, not gated."""
    from altro_tpu_torch.bench import drivers
    for name, fn in (("rocket_multibaseline",
                      drivers.rocket_multibaseline_tol),
                     ("grasp_multibaseline",
                      drivers.grasp_multibaseline_tol)):
        print(f"driver {name} [{card}], T={MULTI_T}:", flush=True)
        t0 = time.perf_counter()
        res = fn(tols=MULTI_TOLS, T=MULTI_T)
        print(f"  ({time.perf_counter() - t0:.1f} s; cold iterations "
              f"{res['cold_iterations']})", flush=True)
        for r in res["rows"]:
            ok = all(r[f"success_{k}"] == 1.0 for k in drivers.MULTI_SOLVERS)
            if not (ok and (r["tol"] > 1e-8 or r["err_altro"] < 1e-3)):
                raise AssertionError(f"driver {name} at tol {r['tol']}: {r}")


def cpp_race_on_card(card):
    """Phase 6f: the quadruped's C++ race (``simulate_host(native=True)``:
    the native AL-iLQR and the native knot ADMM on the host, the schedule,
    relinearization and ticks on the card) for CPP_RACE_TF seconds in both
    friction modes. Gates: the physical gates of 5f (status 1 every
    period, height, attitude, vertical forces)."""
    from altro_tpu_torch.bench.drivers import QUAD_ROWS
    from altro_tpu_torch.models.quadruped import controller
    for name, lin, backend in QUAD_ROWS:
        cfg, opts = _loop_setup(lin)
        res = controller.simulate_host(cfg, opts, tf=CPP_RACE_TF,
                                       backend=backend, device="cuda",
                                       native=True)
        ok = _loop_physical(cfg, res)
        print(f"C++ race [{card}] {name}: iterations "
              f"{res['iters'].tolist()}, status {res['status'].tolist()}, "
              f"ms/solve {np.mean(res['mpc_ms']):.3f} (+"
              f"{np.mean(res['prep_ms']):.3f} prep); physical gates {ok}")
        if not ok:
            raise AssertionError(f"C++ race {name}: {res}")


def state_dim_on_card(card):
    """Phase 6g: the state_dim sweep's points above the group bodies'
    widths (n = 35, 45, 55, m = 2, N = 21: the kernels' wide bodies) at
    T_DRIVER steps. Gates: success 1.0 at each point, every point run."""
    from altro_tpu_torch.bench import drivers
    t0 = time.perf_counter()
    res = drivers.random_linear_sweep("state_dim", T=T_DRIVER,
                                      xs=list(STATE_DIM_WIDE))
    print(f"driver random_linear_state_dim [{card}], T={T_DRIVER}, n = "
          f"{STATE_DIM_WIDE}: ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if "not_run" in res or sorted(res["errs"]) != list(STATE_DIM_WIDE):
        raise AssertionError(f"state_dim: points {sorted(res['errs'])}, "
                             f"keys {sorted(res)}")
    for x, e in res["errs"].items():
        if e["success"] != 1.0:
            raise AssertionError(f"state_dim n={x}: {e}")


def shared_riccati_parity(dtype, tol):
    """Phase 3j: kernel D with shared A/B against its plain version on the
    solver's AL expansion of the fused kernel's window inputs (the
    flagship, the rocket window, grasp's window; B=1024). Returns {shape:
    ({output: max_abs_err}, ms, plain_ms, (bytes, flops))}."""
    from altro_tpu_torch.bench.kernels import (flagship_inputs, grasp_inputs,
                                               rocket_inputs)
    from altro_tpu_torch.ops import riccati

    dev = torch.device("cuda")
    bp, bp_ref = riccati.batched_riccati, riccati.batched_riccati_reference
    out = {}
    for label, fn in (("flagship", flagship_inputs),
                      ("rocket window", rocket_inputs),
                      ("grasp window", grasp_inputs)):
        inp = fn(dtype, dev)
        args = inp["riccati"]
        got = bp(*args)
        torch.cuda.synchronize()
        ref = bp_ref(*args)
        if not all(bool(torch.isfinite(r).all()) for r in ref):
            raise AssertionError(f"{label}: the split-route inputs make Quu "
                                 "indefinite")
        out[label] = (errors(got, ref, ("K", "d", "dV1", "dV2"), tol),
                      time_ms(lambda: bp(*args), kernel=True),
                      time_ms(lambda: bp_ref(*args)), inp["riccati_work"])
        del inp, args, got, ref
    return out


def lane_flagship(card, reset_counts, read_counts):
    """Phase 4j: the flagship with per-lane window indices
    (``make_mpc_step(shared_k=False)``) on graphs, built in float64 on the
    CPU and cast; the counts are reset after the capture, just before the
    LANE_T steps, and read just after them. Gates its quality, launches and
    loop form, then the first AGREE_B lanes of every step against the
    port's float64 plain step on the CPU from the same carry; returns the
    launches."""
    from altro_tpu_torch.bench.flagship import flagship_setup
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.mpc import _state_map, make_mpc_step
    from altro_tpu_torch.solver import altro

    s64 = flagship_setup(FLAG_B, LANE_T + LANE_SPREAD, dtype=torch.float64,
                         device="cpu")
    s32 = tree_to(s64, "cuda", torch.float32)
    args32 = (s32.prob_mpc, s32.opts, s32.X_track, s32.U_track)
    step, init = make_mpc_step(*args32, shared_k=False)
    carry = init(FLAG_B, torch.arange(FLAG_B, device="cuda") % LANE_SPREAD)
    step(carry, s32.noise[0])                          # capture, warm up
    reset_counts()
    carries, outs, ms = [], [], []
    for t in range(LANE_T):
        carries.append(_state_map(lambda a: a[:AGREE_B], carry))
        (carry, out), t_ms = _timed(lambda: step(carry, s32.noise[t]))
        outs.append(out)
        ms.append(t_ms)
    launches, passes = read_counts(), altro.pass_count
    eager = altro.eager_loop_count
    status = torch.stack([o.status for o in outs]).cpu()
    viol = torch.stack([o.viol for o in outs]).double().cpu()
    iters = torch.stack([o.iters for o in outs]).cpu().double()
    # the shared-k step on the same problem, timed in the same call
    sstep, sinit = make_mpc_step(*args32)
    sc = sinit(FLAG_B)
    sstep(sc, s32.noise[0], 0)                         # capture, warm up
    sms = []
    for t in range(LANE_T):
        (sc, _), t_ms = _timed(lambda: sstep(sc, s32.noise[t], t))
        sms.append(t_ms)
    print(f"lane-k flagship main path [{card}]: B={FLAG_B}, {LANE_T} steps, "
          f"start windows 0-{LANE_SPREAD - 1}, float32, graphs; step ms p50 "
          f"{float(np.median(ms)):.3f} (shared-k step p50 "
          f"{float(np.median(sms)):.3f}); success "
          f"{float(status.double().mean()):.4f} max_viol "
          f"{float(viol.max()):.3e} mean_iters {float(iters.mean()):.3f} "
          f"lane_max_iters {int(iters.max())}; passes {passes}; final "
          f"windows {sorted(set(carry[4].tolist()))}; launches {launches}")
    if not (float(status.double().mean()) == 1.0
            and float(viol.max()) <= 1e-4):
        raise AssertionError(f"lane-k flagship quality: status "
                             f"{status.double().mean()}, viol {viol.max()}")
    if not (passes > 0 and launches["batched_riccati"] == passes
            and launches["batched_ls_rollout"] == passes
            and launches["fused_expand_backward"] == 0
            and launches["batched_ls_rollout_al"] == 0 and eager == 0):
        raise AssertionError(f"lane-k flagship launch counts {launches} do "
                             f"not match {passes} passes, or the host-driven "
                             f"loop ran ({eager})")
    step64, _ = make_mpc_step(s64.prob_mpc, s64.opts, s64.X_track,
                              s64.U_track, shared_k=False)
    differ, dU = 0, 0.0
    for t, (c, o32) in enumerate(zip(carries, outs)):
        _, o64 = step64(tree_to(c, "cpu", torch.float64),
                        s64.noise[t][:AGREE_B])
        differ += int((o32.status[:AGREE_B].cpu() != o64.status).sum())
        dU = max(dU, float((o32.U[:AGREE_B].double().cpu() - o64.U)
                           .abs().max()))
    print(f"lane-k flagship agreement [{card}] {AGREE_B} lanes x {LANE_T} "
          f"steps, f32 kernels vs f64 plain from the same carry: status "
          f"differs on {differ} lane-steps; max|dU| {dU:.3e} (gate "
          f"{AGREE_TOL:.0e})")
    if differ or not dU <= AGREE_TOL:
        raise AssertionError(f"lane-k flagship f32 vs f64: status differs on "
                             f"{differ} lane-steps, max|dU| {dU:.3e}")
    return launches


def sharded_flagship(card, reset_counts, read_counts):
    """Phase 4p: the flagship's ``sharded_mpc_step`` at world size 1 on
    NCCL in this process (the group torn down after it), gated bit for bit
    against a fresh ``make_mpc_step(shared_k=True)`` from the same state;
    then ``dryrun_multichip(1)`` and the scaling study's rows, each in a
    spawned rank. Returns the launches of the sharded steps plus the dry
    run's rank."""
    from altro_tpu_torch.bench import scaling
    from altro_tpu_torch.bench.flagship import flagship_setup
    from altro_tpu_torch.mpc import make_mpc_step
    from altro_tpu_torch.parallel import process_group, sharded_mpc_step
    from altro_tpu_torch.parallel.dryrun import dryrun_multichip
    from altro_tpu_torch.solver import altro

    t0 = time.perf_counter()
    su = flagship_setup(SHARD_B, SHARD_T, device="cuda")
    x0s = su.prob_mpc.x0.expand(SHARD_B, su.prob_mpc.n)
    with process_group(0, 1, "cuda") as mesh:
        backend = torch.distributed.get_backend()
        print(f"4p: process group of {mesh.size} on {backend}, rank "
              f"{mesh.rank} on {mesh.device}", flush=True)
        step = sharded_mpc_step(su.prob_mpc, su.opts, su.X_track,
                                su.U_track, mesh)
        state0 = step.init_state(x0s)
        step(state0, su.noise[0])                      # capture, warm up
        reset_counts()
        state, outs, metrics, ms = state0, [], [], []
        for t in range(SHARD_T):
            (state, mt), t_ms = _timed(lambda: step(state, su.noise[t]))
            outs.append(step.results)
            metrics.append(tuple(v.item() for v in mt))
            ms.append(t_ms)
        launches, passes = read_counts(), altro.pass_count
        eager = altro.eager_loop_count
    ref_step, _ = make_mpc_step(su.prob_mpc, su.opts, su.X_track,
                                su.U_track, shared_k=True)
    carry, exact = state0[:4], True
    for t, (out, mt) in enumerate(zip(outs, metrics)):
        carry, ref = ref_step(carry, su.noise[t], t)
        if not (torch.equal(out.status, ref.status)
                and torch.equal(out.iters, ref.iters)):
            raise AssertionError(f"4p step {t}: the sharded step's status or "
                                 f"iterations differ from the plain step's")
        exact &= torch.equal(out.U, ref.U) and torch.equal(out.X, ref.X)
        local = (int(ref.iters.sum()), float(ref.viol.max()),
                 int(ref.status.sum()))
        if (int(mt[0]), float(mt[1]), int(mt[2])) != local:
            raise AssertionError(f"4p step {t}: all-reduced metrics {mt} "
                                 f"differ from the local ones {local}")
    status = torch.stack([o.status for o in outs]).double()
    viol = torch.stack([o.viol for o in outs]).double()
    print(f"4p sharded flagship [{card}]: world size 1 ({backend}), "
          f"B={SHARD_B}, "
          f"{SHARD_T} steps, float32, graphs; step ms p50 "
          f"{float(np.median(ms)):.3f}; success "
          f"{float(status.mean()):.4f} max_viol {float(viol.max()):.3e}; "
          f"fleet metrics per step {metrics}; bit-equal (X, U) to the plain "
          f"step: {exact}; passes {passes}; launches {launches}", flush=True)
    if not exact:
        raise AssertionError("4p: the sharded step's X or U differs from the "
                             "plain step's")
    if not (float(status.mean()) == 1.0 and float(viol.max()) <= 1e-4):
        raise AssertionError(f"4p quality: success {float(status.mean())}, "
                             f"max_viol {float(viol.max())}")
    if not (passes > 0 and launches["fused_expand_backward"] == passes
            and launches["batched_ls_rollout"] == passes
            and launches["batched_ls_rollout_al"] == 0
            and launches["batched_riccati"] == 0 and eager == 0):
        raise AssertionError(f"4p launch counts {launches} do not match "
                             f"{passes} passes, or the host-driven loop ran "
                             f"({eager})")
    t1 = time.perf_counter()
    dry = dryrun_multichip(1)[0]
    print(f"4p dryrun_multichip(1) [{card}] ({time.perf_counter() - t1:.1f} "
          f"s, one spawned rank): {dry}", flush=True)
    for k, v in dry["launches"].items():
        launches[k] += v
    t1 = time.perf_counter()
    rows = scaling.measure(batch_per_device=SCALING_B, steps=SCALING_T)
    print(f"4p scaling ({time.perf_counter() - t1:.1f} s, "
          f"{torch.cuda.device_count()} card(s)) [{card}]: "
          f"{json.dumps(rows)}", flush=True)
    if not (rows[0]["devices"] == 1
            and rows[0]["n_success"] == SCALING_B
            and all(r["solves_per_s"] == scaling.NOT_MEASURED
                    for r in rows if r["devices"]
                    > torch.cuda.device_count())):
        raise AssertionError(f"4p scaling rows: {rows}")
    print(f"phase 4p ({time.perf_counter() - t0:.1f} s) launches: "
          f"{launches}", flush=True)
    return launches


def lane_grasp(card, reset_counts, read_counts):
    """Phase 4q: per-lane constraint windows on grasp
    (``make_mpc_step(shared_k=False, constraints_fn=...)``), float32 on
    graphs with the counts reset after the capture; then the float64 step
    on the card against the port's plain float64 step on the CPU from the
    card's carry. Returns the launches."""
    from altro_tpu_torch.bench.conic import grasp_setup
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.models import grasp
    from altro_tpu_torch.mpc import make_mpc_step
    from altro_tpu_torch.solver import altro

    t0 = time.perf_counter()

    def lane_step(su, opts=None, device="cuda"):
        o = grasp.make_grasp_object(61, 6.0, dtype=su.prob_mpc.x0.dtype,
                                    device=device)
        su = tree_to(su, device)
        return make_mpc_step(
            su.prob_mpc, su.opts if opts is None else opts, su.X_track,
            su.U_track, constraints_fn=lambda k: grasp.grasp_constraints(
                o, su.prob_mpc.N, k), shared_k=False)

    s32 = grasp_setup(torch.float32, device="cuda")
    noise = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (LANE_GRASP_T, LANE_GRASP_B, 6)), dtype=torch.float32, device="cuda")
    step, init = lane_step(s32)
    starts = torch.arange(LANE_GRASP_B, device="cuda") % LANE_GRASP_SPREAD
    carry = init(LANE_GRASP_B, starts)
    step(carry, noise[0])                               # capture, warm up
    reset_counts()
    outs, ms = [], []
    for t in range(LANE_GRASP_T):
        (carry, out), t_ms = _timed(lambda: step(carry, noise[t]))
        outs.append(out)
        ms.append(t_ms)
    launches, passes = read_counts(), altro.pass_count
    eager = altro.eager_loop_count
    ok = torch.stack([o.status for o in outs]).cpu() == 1
    viol = torch.stack([o.viol for o in outs]).double().cpu()
    iters = torch.stack([o.iters for o in outs]).cpu().double()
    success = float(ok.double().mean())
    viol_ok = float(viol[ok].max()) if bool(ok.any()) else math.inf
    print(f"4q per-lane grasp windows [{card}]: B={LANE_GRASP_B}, "
          f"{LANE_GRASP_T} steps, start windows 0-{LANE_GRASP_SPREAD - 1}, "
          f"float32, graphs; step ms p50 {float(np.median(ms)):.3f}; success "
          f"{success:.5f} max_viol (succeeded) {viol_ok:.3e} mean_iters "
          f"{float(iters.mean()):.3f} lane_max_iters {int(iters.max())}; "
          f"passes {passes}; final windows "
          f"{sorted(set(carry[4].tolist()))}; launches {launches}",
          flush=True)
    if not (success >= 0.999 and viol_ok <= 1e-4):
        raise AssertionError(f"4q quality: success {success}, max_viol "
                             f"{viol_ok}")
    if not (passes > 0 and launches["batched_riccati"] == passes
            and launches["batched_ls_rollout"] == passes
            and launches["fused_expand_backward"] == 0
            and launches["batched_ls_rollout_al"] == 0 and eager == 0):
        raise AssertionError(f"4q launch counts {launches} do not match "
                             f"{passes} passes, or the host-driven loop ran "
                             f"({eager})")

    # float64: the card's kernels against the CPU's plain path, each step
    # from the card's carry (the CPU mirrors the card's ladder choice:
    # ls_fused "auto" takes the fused branch's form on a card, "on" there)
    s64 = grasp_setup(torch.float64, device="cuda")
    o64 = s64.opts
    step_c, init_c = lane_step(s64)
    step_h, _ = lane_step(s64, dataclasses.replace(o64, ls_fused="on"),
                          "cpu")
    n64 = noise[:LANE_GRASP_AGREE_T, :LANE_GRASP_AGREE_B].double()
    carry = init_c(LANE_GRASP_AGREE_B, starts[:LANE_GRASP_AGREE_B])
    differ, dU = 0, 0.0
    for t in range(LANE_GRASP_AGREE_T):
        c_h = tree_to(carry, "cpu")
        carry, oc = step_c(carry, n64[t])
        _, oh = step_h(c_h, n64[t].cpu())
        differ += int(((oc.status.cpu() != oh.status)
                       | (oc.iters.cpu() != oh.iters)).sum())
        dU = max(dU, float((oc.U.cpu() - oh.U).abs().max()))
    print(f"4q float64 [{card}]: {LANE_GRASP_AGREE_B} lanes x "
          f"{LANE_GRASP_AGREE_T} steps, card kernels vs CPU plain from the "
          f"card's carry: status or iterations differ on {differ} "
          f"lane-steps; max|dU| {dU:.3e} (gate {LANE_GRASP_DU:.0e})")
    if differ or not dU <= LANE_GRASP_DU:
        raise AssertionError(f"4q float64 card vs CPU: {differ} lane-steps "
                             f"differ, max|dU| {dU:.3e}")
    print(f"phase 4q ({time.perf_counter() - t0:.1f} s) launches: "
          f"{launches}", flush=True)
    return launches


def state_dim_wide(card, reset_counts, read_counts):
    """Phase 4r: the state_dim sweep's random-linear tracking MPC at
    (n, m, N) = WIDE_MPC (seed 10, the sweep's options), built in float64
    on the CPU and cast, B=WIDE_MPC_B in float32 on graphs, run two ways:
    the split route (``make_mpc_step(shared_k=False)``, lanes started at
    windows 0 .. LANE_SPREAD - 1: kernels D and A, wide bodies) and the
    shared-window step with ``ls_fused="on"`` (kernels B and C, wide
    bodies). Per route: a warm-up step (the capture), WIDE_MPC_T counted and
    timed steps (gates: success 1.0, violation <= 1e-4, the route's two
    kernels once per counted pass and the others never, no entry into the
    host-driven loop), then two steps under the profiler (device ms per
    pass, by kernel); then WIDE_MPC_AGREE_B lanes of the float64 step on the
    card against the port's plain float64 step on the CPU from the card's
    carry, WIDE_MPC_T steps (gate: equal status and iterations, max|dU| <=
    WIDE_MPC_DU). Returns the launches of the counted steps."""
    from altro_tpu_torch.bench.device_profile import profile
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.models import random_linear as rl
    from altro_tpu_torch.mpc import make_mpc_step
    from altro_tpu_torch.solver import altro
    from altro_tpu_torch.solver.options import SolverOptions

    n, m, N = WIDE_MPC
    B, T = WIDE_MPC_B, WIDE_MPC_T
    steps = 1 + T + 2                  # warm-up, counted, two profiled
    rng = np.random.default_rng(10)
    N_track = N + steps + LANE_SPREAD + 2
    full = rl.gen_random_linear(rng, n, m, N_track, dtype=torch.float64,
                                device="cpu")
    X_track, U_track = rl.gen_trajectory(rng, full, N_track)
    prob64 = rl.gen_tracking_mpc(full, X_track, U_track, N)
    noise64 = torch.as_tensor(rng.standard_normal((steps, B, n)))
    total = {}
    for route, shared, fused in (("split", False, "auto"),
                                 ("fused", True, "on")):
        opts = SolverOptions(cost_tolerance=1e-4, constraint_tolerance=1e-4,
                             gradient_tolerance=1e-4, penalty_initial=1e3,
                             penalty_scaling=100.0, reset_duals=False,
                             ls_fused=fused)
        args64 = (prob64, opts, X_track, U_track)
        args32 = tree_to(args64, "cuda", torch.float32)
        noise = noise64.to("cuda", torch.float32)
        step, init = make_mpc_step(*args32, shared_k=shared)
        if shared:
            carry = init(B)

            def run(c, t, step=step, noise=noise):
                return step(c, noise[t], t)
        else:
            carry = init(B, torch.arange(B, device="cuda") % LANE_SPREAD)

            def run(c, t, step=step, noise=noise):
                return step(c, noise[t])
        carry, _ = run(carry, 0)                        # capture, warm up
        reset_counts()
        outs, ms = [], []
        for t in range(1, 1 + T):
            (carry, out), t_ms = _timed(lambda: run(carry, t))
            outs.append(out)
            ms.append(t_ms)
        launches, passes = read_counts(), altro.pass_count
        eager = altro.eager_loop_count
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        state = {"carry": carry, "t": 1 + T}

        def window(state=state, run=run):
            p0 = altro.pass_count
            state["carry"], _ = run(state["carry"], state["t"])
            state["t"] += 1
            return altro.pass_count - p0
        prof = profile(window)
        per_pass = prof["per_iteration"]
        status = torch.stack([o.status for o in outs]).double().cpu()
        viol = torch.stack([o.viol for o in outs]).double().cpu()
        iters = torch.stack([o.iters for o in outs]).double().cpu()
        print(f"state_dim wide MPC [{route}] [{card}]: n={n} m={m} N={N} "
              f"B={B}, {T} warm steps, float32, graphs; success "
              f"{float(status.mean()):.4f} max_viol {float(viol.max()):.3e}"
              f" mean_iters {float(iters.mean()):.3f} lane_max_iters "
              f"{int(iters.max())}; step ms p50 {float(np.median(ms)):.3f};"
              f" passes {passes}; device ms per pass "
              f"{prof['device_ms'] / prof['loop_iterations']:.4f} ("
              + ", ".join(f"{k} {v['ms']:.4f}" for k, v in per_pass.items())
              + f"), busy {prof['busy_share']:.1%}; launches {launches}",
              flush=True)
        if not (float(status.mean()) == 1.0 and float(viol.max()) <= 1e-4):
            raise AssertionError(f"state_dim wide MPC [{route}] quality: "
                                 f"status {float(status.mean())}, viol "
                                 f"{float(viol.max())}")
        mine = (("batched_riccati", "batched_ls_rollout") if not shared
                else ("fused_expand_backward", "batched_ls_rollout_al"))
        if not (passes > 0 and eager == 0
                and all(launches[k] == (passes if k in mine else 0)
                        for k in launches)):
            raise AssertionError(f"state_dim wide MPC [{route}] launch "
                                 f"counts {launches} do not match {passes} "
                                 f"passes, or the host-driven loop ran "
                                 f"({eager})")
        # float64 on the card against the CPU, from the card's carry
        a = WIDE_MPC_AGREE_B
        step_c, init_c = make_mpc_step(*tree_to(args64, "cuda"),
                                       shared_k=shared)
        step_h, _ = make_mpc_step(*args64, shared_k=shared, graphed=False)
        carry = (init_c(a) if shared else
                 init_c(a, torch.arange(a, device="cuda") % LANE_SPREAD))
        differ, dU = 0, 0.0
        for t in range(T):
            nz = noise64[t, :a]
            c_h = tree_to(carry, "cpu")
            if shared:
                carry, o_c = step_c(carry, nz.cuda(), t)
                _, o_h = step_h(c_h, nz, t)
            else:
                carry, o_c = step_c(carry, nz.cuda())
                _, o_h = step_h(c_h, nz)
            differ += int(((o_c.status.cpu() != o_h.status)
                           | (o_c.iters.cpu() != o_h.iters)).sum())
            dU = max(dU, float((o_c.U.cpu() - o_h.U).abs().max()))
        print(f"state_dim wide MPC [{route}] f64, {a} lanes x {T} steps, card"
              f" (kernels) vs CPU (plain) from the card's carry: status or "
              f"iterations differ on {differ} lane-steps; max|dU| {dU:.3e} "
              f"(gate {WIDE_MPC_DU:.0e})", flush=True)
        if differ or not dU <= WIDE_MPC_DU:
            raise AssertionError(f"state_dim wide MPC [{route}] f64: card and "
                                 f"CPU part on {differ} lane-steps, max|dU| "
                                 f"{dU:.3e}")
    return total


def gate_modules(card, su32, gsu32):
    """Phase 5g: ``bench/fused_check.py`` in full on both families (the
    setups of 4b and 4e) and ``bench/agreement.py`` at AGREEMENT_T steps;
    their gates fail the run."""
    from altro_tpu_torch.bench import agreement, fused_check
    t0 = time.perf_counter()
    fc = fused_check.run(1024, FUSED_CHECK_T, "cuda",
                         setups={"rocket": su32, "grasp": gsu32})
    for family in fused_check.FAMILIES:
        r = fc[family]
        print(f"fused_check {family} [{card}] B={r['lanes']}, T={r['steps']}"
              f": success B route {r['success_fused']:.5f}, split route "
              f"{r['success_unfused']:.5f}; true-cost gap signed mean "
              f"{r['gap_signed_mean']:.3e}, |gap| mean "
              f"{r['gap_abs_mean']:.3e}, p99 {r['gap_abs_p99']:.3e}, max "
              f"{r['gap_abs_max']:.3e}; max_viol B route "
              f"{r['max_viol_fused']:.3e}, split route "
              f"{r['max_viol_unfused']:.3e}; step ms p50 B route "
              f"{r['step_ms_p50_fused']:.3f}, split route "
              f"{r['step_ms_p50_unfused']:.3f}; launches {r['launches']}; "
              f"gate {'PASS' if r['gate_pass'] else 'FAIL'}")
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not fc["gate_pass"]:
        raise AssertionError(f"fused_check failed: {json.dumps(fc)}")
    t0 = time.perf_counter()
    ag = agreement.run(1024, AGREEMENT_T, "cuda")
    for key, r in ag["per_tpu_tolerance"].items():
        fb = ag["fullbatch"][f"tol_{key}"]
        print(f"agreement tol={key} [{card}] B=1024, T={AGREEMENT_T}: "
              f"success {r['success_all_steps']:.4f}; {ag['config']['sample']}"
              f" lanes vs f64 truth: max|dU| "
              f"{r['max_dU_tpu_f32_vs_cpu_f64']:.3e} (mean "
              f"{r['mean_dU_tpu_f32_vs_cpu_f64']:.3e}); every lane's cost "
              f"gap max {fb['gap_max']:.3e} p99 {fb['gap_p99']:.3e} mean "
              f"{fb['gap_mean']:.3e}; step ms p50 {r['step_ms_p50']:.3f}")
    print(f"agreement f64 truth vs native C++ QP: max|dU| "
          f"{ag['max_dU_cpu_f64_vs_native_cpp']:.3e}, native status "
          f"{ag['native_success']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    agreement.check(ag)


def naive_rocket_parity(dtype, tol, B):
    """Phase 3k: kernels D and A at the naive rocket's shapes (N=301, n=6,
    m=3): D with shared A/B on the solver's per-lane expansion of a
    mid-solve iterate (per-lane Hessians of the quadratic norm blocks), A at
    the solver's L=11 ladder on the plain version's gains; each against its
    plain version (``errors``' gate) and then each path's accepted rung
    (the kernels' rungs scored by the merit, with the kernel's dV, against
    the plain versions'): equal in float64, at most B/100 lanes apart in
    float32. Returns {kernel: ({output: max_abs_err}, ms, plain_ms,
    (bytes, flops))}."""
    from altro_tpu_torch.bench.kernels import QUAD_LADDER, naive_rocket_inputs
    from altro_tpu_torch.constraints import DualState
    from altro_tpu_torch.ops import riccati, rollout
    from altro_tpu_torch.solver.altro import _ladder_choice, total_al_cost_res

    dev = torch.device("cuda")
    inp = naive_rocket_inputs(dtype, dev, B)
    args, ref = inp["riccati"], inp["riccati_ref"]
    bp, bp_ref = riccati.batched_riccati, riccati.batched_riccati_reference
    got = bp(*args)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(r).all()) for r in ref):
        raise AssertionError("naive rocket parity inputs make Quu + reg "
                             "indefinite")
    # the plain versions' 300-knot loops take 50-400 ms a call: 3 timed
    res = {"batched_riccati": (
        errors(got, ref, ("K", "d", "dV1", "dV2"), tol),
        time_ms(lambda: bp(*args), kernel=True),
        time_ms(lambda: bp_ref(*args), reps=3), inp["riccati_work"])}
    largs = inp["ladder"]
    ls, ls_ref = rollout.batched_ls_rollout, rollout.batched_ls_rollout_reference
    Xs, Us = ls(*largs)
    Xr, Ur = ls_ref(*largs)
    torch.cuda.synchronize()
    res["batched_ls_rollout"] = (
        errors((Xs, Us), (Xr, Ur), ("Xs L=11", "Us L=11"), tol),
        time_ms(lambda: ls(*largs), kernel=True),
        time_ms(lambda: ls_ref(*largs), reps=3), inp["ladder_work"])
    duals = tuple(DualState(lam=lam[:, None], rho=rho[:, None])
                  for lam, rho in zip(inp["lams"], inp["rhos"]))
    alphas = torch.tensor(QUAD_LADDER, dtype=dtype, device=dev)
    Jk = total_al_cost_res(inp["prob"], duals, Xs, Us)[0]
    Jp = total_al_cost_res(inp["prob"], duals, Xr, Ur)[0]
    idx_k, acc_k, _, _ = _ladder_choice(Jk, alphas, got[2], got[3], 1e-4)
    idx_p, acc_p, _, _ = _ladder_choice(Jp, alphas, ref[2], ref[3], 1e-4)
    differ = int(((idx_k != idx_p) | (acc_k != acc_p)).sum())
    print(f"naive rocket parity B={B} ({dtype}): accepted rung differs on "
          f"{differ} of {B} lanes; rungs taken "
          f"{torch.bincount(idx_p[acc_p], minlength=len(QUAD_LADDER)).tolist()}"
          f", none on {int((~acc_p).sum())}")
    if differ > (0 if dtype == torch.float64 else B // 100):
        raise AssertionError(f"naive rocket: accepted rung differs on "
                             f"{differ} lanes")
    return res


def _naive_gates(label, launches, passes, solves, eager):
    """The launch gates of a naive rocket run: D once per pass, A once per
    pass and once more per solve (the init rollout), B and C never, no
    entry into the host-driven loop."""
    if not (passes > 0 and launches["batched_riccati"] == passes
            and launches["batched_ls_rollout"] == passes + solves
            and launches["fused_expand_backward"] == 0
            and launches["batched_ls_rollout_al"] == 0 and eager == 0):
        raise AssertionError(f"{label} launch counts {launches} do not match"
                             f" {passes} passes of {solves} solves, or the "
                             f"host-driven loop ran ({eager})")


def naive_rocket_one(card, reset_counts, read_counts):
    """Phase 4k: the naive rocket's one landing (the default x0, B=1) on
    graphs in float32 and float64, beside the conic form's cold solve in
    the same call; each solve's graphs captured and run once, then the
    counted, timed solve. Gates the naive solves (status 1 and
    ``_naive_gates``), then the float64 card solve against the port's plain
    float64 solve on the CPU (equal status and iterations, max|dU| <=
    NAIVE_DU). Returns the naive solves' launches."""
    from altro_tpu_torch.bench.conic import naive_rocket_setup
    from altro_tpu_torch.solver import altro, graph

    total, card64 = {}, None
    for dtype in (torch.float32, torch.float64):
        row = {}
        for conic in (False, True):
            su = naive_rocket_setup(1, dtype, "cuda", conic=conic)
            gs = graph.GraphedSolve(su.prob, su.opts)
            gs(U0=su.U0)                                   # warm
            reset_counts()
            sol, ms = _timed(lambda: gs(U0=su.U0))
            launches, passes = read_counts(), altro.pass_count
            row[conic] = (sol, ms, passes, launches)
            if conic:
                continue
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            if int(sol.stats.status[0]) != 1:
                raise AssertionError(f"naive rocket ({dtype}): status "
                                     f"{int(sol.stats.status[0])}")
            _naive_gates(f"naive rocket B=1 ({dtype})", launches, passes, 1,
                         altro.eager_loop_count)
        (ns, nms, np_, nl), (cs, cms, cp, cl) = row[False], row[True]
        print(f"SOC vs naive rocket B=1 N=301 ({dtype}) [{card}]: "
              f"iterations conic {int(cs.stats.iterations[0])} naive "
              f"{int(ns.stats.iterations[0])}; status conic "
              f"{int(cs.stats.status[0])} naive {int(ns.stats.status[0])}; "
              f"solve ms conic {cms:.3f} naive {nms:.3f}; passes conic "
              f"{cp} naive {np_}; cost conic {float(cs.stats.cost[0]):.9g} "
              f"naive {float(ns.stats.cost[0]):.9g}; max_viol naive "
              f"{float(ns.stats.viol[0]):.3e}; launches conic {cl} naive "
              f"{nl}", flush=True)
        if dtype == torch.float64:
            card64 = ns
    t0 = time.perf_counter()
    su = naive_rocket_setup(1, torch.float64, "cpu")
    cpu = altro.solve(su.prob, su.opts, U0=su.U0)
    dU = float((card64.U.cpu() - cpu.U).abs().max())
    same = (int(card64.stats.status[0]) == int(cpu.stats.status[0])
            and int(card64.stats.iterations[0])
            == int(cpu.stats.iterations[0]))
    print(f"naive rocket B=1 f64, card (kernels) vs CPU (plain): status "
          f"{int(card64.stats.status[0])} / {int(cpu.stats.status[0])}, "
          f"iterations {int(card64.stats.iterations[0])} / "
          f"{int(cpu.stats.iterations[0])}; max|dU| {dU:.3e} (gate "
          f"{NAIVE_DU:.0e}; CPU solve {time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not (same and dU <= NAIVE_DU):
        raise AssertionError(f"naive rocket f64: card and CPU part (max|dU| "
                             f"{dU:.3e})")
    return total


def naive_rocket_batch(card, reset_counts, read_counts):
    """Phase 4l: the naive rocket's Monte-Carlo of NAIVE_B landings on
    graphs, float32 (gates: success >= NAIVE_SUCCESS, every succeeded
    lane's violation <= 1e-4, ``_naive_gates``), then float64 on the same
    lanes (the same launch gates; reported: success and the float32
    controls' relative true-cost gap against the float64 ones, both rolled
    out in float64). Returns the launches of both."""
    from altro_tpu_torch.bench.conic import naive_rocket_setup
    from altro_tpu_torch.solver import altro, graph

    total, sols = {}, {}
    for dtype in (torch.float32, torch.float64):
        su = naive_rocket_setup(NAIVE_B, dtype, "cuda")
        gs = graph.GraphedSolve(su.prob, su.opts)
        reset_counts()
        sol, ms = _timed(lambda: gs(U0=su.U0))
        launches, passes = read_counts(), altro.pass_count
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        st = sol.stats
        ok = st.status == 1
        it = st.iterations.double()
        viol_ok = float(st.viol[ok].double().max()) if bool(ok.any()) \
            else math.nan
        print(f"naive rocket main path B={NAIVE_B} ({dtype}) [{card}]: "
              f"success {float(ok.double().mean()):.5f}; max_viol of the "
              f"succeeded {viol_ok:.3e}; iterations mean "
              f"{float(it.mean()):.2f} lane-max {int(it.max())} p99 "
              f"{float(torch.quantile(it, 0.99)):.1f}; passes {passes}; "
              f"solve ms {ms:.1f}; solves/s {NAIVE_B / (ms / 1e3):.1f}; "
              f"launches {launches}", flush=True)
        _naive_gates(f"naive rocket B={NAIVE_B} ({dtype})", launches, passes,
                     1, altro.eager_loop_count)
        if dtype == torch.float32 and not (
                float(ok.double().mean()) >= NAIVE_SUCCESS
                and viol_ok <= 1e-4):
            raise AssertionError(f"naive rocket B={NAIVE_B} quality: success "
                                 f"{float(ok.double().mean())}, viol "
                                 f"{viol_ok}")
        sols[dtype] = (su, sol)
    (su64, s64), (_, s32) = sols[torch.float64], sols[torch.float32]
    prob = su64.prob
    dyn, cost = prob.dynamics, prob.cost
    U32 = s32.U.double()
    J32 = cost.total(dyn.rollout(prob.x0, U32), U32)
    J64 = cost.total(dyn.rollout(prob.x0, s64.U), s64.U)
    both = (s32.stats.status == 1) & (s64.stats.status == 1)
    gap = ((J32 - J64) / J64.abs().clamp(min=1e-12))[both].cpu()
    print(f"naive rocket B={NAIVE_B} f32 vs f64 on the same lanes [{card}]: "
          f"success f64 {float((s64.stats.status == 1).double().mean()):.5f}"
          f"; relative true-cost gap over the {int(both.sum())} lanes both "
          f"solved: mean {float(gap.mean()):.3e}, p99 |gap| "
          f"{float(torch.quantile(gap.abs(), 0.99)):.3e}, max |gap| "
          f"{float(gap.abs().max()):.3e}", flush=True)
    return total


def srb_nonlinear(card, reset_counts, read_counts):
    """Phase 4m: the nonlinear SRB trot (the flat quadruped batch on the RK4
    model, ``families.quadruped_batched(nonlinear=True)``), SRB_B lanes,
    both friction modes, float32 and float64, on graphs (gates: success
    1.0, violation <= 1e-4, D once per pass, A, B and C never, no entry
    into the host-driven loop); then SRB_AGREE_B lanes of the float64 card
    solve against the port's plain float64 solve on the CPU from the same
    instances (equal status and iterations, max|dU| <= SRB_DU). Returns the
    launches."""
    from altro_tpu_torch.bench.families import (quadruped_batched,
                                                quadruped_setup)
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.solver import altro, graph

    total = {}
    for lin in (True, False):
        mode = "qp" if lin else "socp"
        for dtype in (torch.float32, torch.float64):
            reset_counts()
            res = quadruped_batched(B=SRB_B, rounds=SRB_ROUNDS,
                                    linearized_friction=lin, device="cuda",
                                    nonlinear=True, dtype=dtype)
            launches, passes = read_counts(), altro.pass_count
            eager = altro.eager_loop_count
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            print(f"nonlinear SRB main path [{mode}] ({dtype}) [{card}]: "
                  f"{json.dumps(res)} passes={passes}", flush=True)
            if not (res["success_rate"] == 1.0 and res["max_viol"] <= 1e-4):
                raise AssertionError(f"nonlinear SRB [{mode}] ({dtype}) "
                                     f"quality: {res}")
            if not (passes > 0 and launches["batched_riccati"] == passes
                    and launches["batched_ls_rollout"] == 0
                    and launches["fused_expand_backward"] == 0
                    and launches["batched_ls_rollout_al"] == 0
                    and eager == 0):
                raise AssertionError(f"nonlinear SRB [{mode}] launch counts "
                                     f"{launches} do not match {passes} "
                                     f"passes, or the host-driven loop ran "
                                     f"({eager})")
        s64 = quadruped_setup(SRB_B, lin, torch.float64, "cpu",
                              nonlinear=True)
        x0 = s64.draw_x0()
        sc = tree_to(s64, "cuda")
        gs = graph.GraphedSolve(sc.prob, sc.opts, states=True)
        on_card = gs(x0.cuda(), sc.U0, sc.X0)
        n = SRB_AGREE_B
        dyn = s64.prob.dynamics
        sub = dataclasses.replace(
            s64.prob, x0=x0[:n],
            dynamics=dataclasses.replace(dyn, params=tuple(
                p[:n] for p in dyn.params)))
        t0 = time.perf_counter()
        cpu = altro.solve(sub, s64.opts, U0=s64.U0[:n], X0=s64.X0[:n])
        differ = int(((on_card.stats.status[:n].cpu() != cpu.stats.status)
                      | (on_card.stats.iterations[:n].cpu()
                         != cpu.stats.iterations)).sum())
        dU = float((on_card.U[:n].cpu() - cpu.U).abs().max())
        print(f"nonlinear SRB [{mode}] f64, {n} lanes, card (kernel D) vs "
              f"CPU (plain): status or iterations differ on {differ} lanes;"
              f" max|dU| {dU:.3e} (gate {SRB_DU:.0e}; CPU solve "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        if differ or not dU <= SRB_DU:
            raise AssertionError(f"nonlinear SRB [{mode}] f64: card and CPU "
                                 f"part on {differ} lanes, max|dU| {dU:.3e}")
    return total


def nonlinear_forms(card):
    """Phase 4f's nonlinear paths: the naive rocket's one landing (float32)
    and the nonlinear SRB trot (SRB_B lanes, QP friction, float32),
    graphed against eager on the card from the same inputs (gate: equal
    status and iterations)."""
    from altro_tpu_torch.bench.conic import naive_rocket_setup
    from altro_tpu_torch.bench.families import quadruped_setup
    from altro_tpu_torch.solver import altro, graph

    nsu = naive_rocket_setup(1, torch.float32, "cuda")
    qsu = quadruped_setup(SRB_B, True, torch.float32, "cuda", nonlinear=True)
    x0 = qsu.draw_x0().to("cuda", torch.float32)
    for label, prob, opts, U0, X0 in (
            ("naive rocket B=1", nsu.prob, nsu.opts, nsu.U0, None),
            ("nonlinear SRB qp", dataclasses.replace(qsu.prob, x0=x0),
             qsu.opts, qsu.U0, qsu.X0)):
        gs = graph.GraphedSolve(prob, opts, states=X0 is not None)
        gs(prob.x0, U0, X0)                                # warm
        runs, stats = {}, {}
        for form in ("graphed", "eager"):
            p0, r0 = altro.pass_count, gs.replays
            if form == "graphed":
                sol, ms = _timed(lambda: gs(prob.x0, U0, X0))
            else:
                sol, ms = _timed(lambda: altro.solve(prob, opts, U0=U0,
                                                     X0=X0))
            runs[form] = [((sol.X, sol.U, sol.duals), sol.stats.status,
                           sol.stats.iterations, sol.U)]
            stats[form] = ([ms], altro.pass_count - p0,
                           (gs.replays - r0) if form == "graphed" else 0, 1,
                           gs.capture_s if form == "graphed" else 0.0)
        _compare(label, runs["graphed"], runs["eager"], card, stats)


def quickstart_on_card():
    """Phase 7: the quickstart's five sections at ``--fast`` on the card."""
    from altro_tpu_torch.examples import quickstart
    res = quickstart.main(["--fast"])
    bad = {k: v for k, v in res.items()
           if v.get("status", 1) != 1 or v.get("all_ok") is False}
    if bad:
        raise AssertionError(f"quickstart: {bad}")


def main() -> None:
    # ---- 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    from altro_tpu_torch.bench.flagship import (flagship_setup, power_limit,
                                                run_flagship, run_steps)
    from altro_tpu_torch.bench.conic import (SCHEDULES, grasp_batched,
                                             grasp_setup, make_step,
                                             rocket_batched, rocket_setup)
    from altro_tpu_torch.bench import agreement_conic, agreement_flexsat
    from altro_tpu_torch.bench.families import (FLEXSAT_SCHEDULE,
                                                flexsat_batched,
                                                flexsat_setup, flexsat_step,
                                                quadruped_batched)
    from altro_tpu_torch.convert import tree_to
    from altro_tpu_torch.ops import (_build, riccati, riccati_fused, rollout,
                                     rollout_al)
    from altro_tpu_torch.solver import altro

    kind = torch.cuda.get_device_name(0)
    card = power_limit()
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    print(card)

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.build_dir()})")
    for line in _build.build_log().splitlines():
        if re.search(r"Compiling entry|Used \d+ registers|spill", line):
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # ---- 3. kernel parity: (a) flagship shapes, (b) the rocket window,
    # (c) the flat quadruped batch, (d) grasp's window and cold problem,
    # (e) the flexsat regulator, (f) the closed loop's one robot
    par = {}
    for shape, fn in (
            ("flagship", parity),
            ("rocket", lambda *a: conic_parity("rocket", *a)),
            ("quadruped", quadruped_parity),
            ("grasp", lambda *a: conic_parity("grasp", *a)),
            ("grasp cold", lambda *a: conic_parity("grasp", *a, cold=True)),
            ("flexsat", lambda *a: conic_parity("flexsat", *a)),
            ("closed loop qp",
             lambda *a: conic_parity("closed loop qp", *a)),
            ("closed loop socp",
             lambda *a: conic_parity("closed loop socp", *a))):
        par[shape] = (fn(torch.float32, F32_TOL), fn(torch.float64, F64_TOL))
        for name in par[shape][0]:
            for label, (errs, ms, plain_ms, work) in zip(
                    ("f32", "f64"), (p[name] for p in par[shape])):
                errs_s = " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                bnd, by = bound_ms(*work, 4 if label == "f32" else 8)
                print(f"parity {name} {shape} {label}: max|kernel - plain| "
                      f"{errs_s or '(above)'}; kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}: "
                      f"{work[0] / 1e6:.2f} MB, {work[1] / 1e9:.4f} GFLOP) "
                      f"[{card}]")

    # ---- 3g. phase 6's shapes, one lane (no timing)
    par6 = {}
    for label, dtype, tol in (("f32", torch.float32, F32_TOL),
                              ("f64", torch.float64, F64_TOL)):
        par6[label] = phase6_parity(dtype, tol)
        for shape, res in par6[label].items():
            for name, errs in res.items():
                errs_s = " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                print(f"parity {name} {shape} B=1 {label}: max|kernel - "
                      f"plain| {errs_s}")

    # ---- 3h. the wide bodies (n or m above 32), at B=1 and B=1024
    wide = {}
    for label, dtype, tol in (("f32", torch.float32, F32_TOL),
                              ("f64", torch.float64, F64_TOL)):
        for B in WIDE_BATCHES:
            wide[label, B] = wide_parity(dtype, tol, B)
            for (n, m), res in wide[label, B].items():
                for name, (errs, ms, plain_ms, work) in res.items():
                    errs_s = " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                    bnd, by = bound_ms(*work, 4 if label == "f32" else 8)
                    print(f"parity {name} wide n={n} m={m} B={B} {label}: "
                          f"max|kernel - plain| {errs_s}; kernel {ms:.4f} "
                          f"ms, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms "
                          f"({by}: {work[0] / 1e6:.2f} MB, "
                          f"{work[1] / 1e9:.4f} GFLOP), share "
                          f"{bnd / ms:.2%} [{card}]", flush=True)

    # ---- 3j. kernel D with shared dynamics on the split route
    par_d = {}
    for label, dtype, tol in (("f32", torch.float32, F32_TOL),
                              ("f64", torch.float64, F64_TOL)):
        par_d[label] = shared_riccati_parity(dtype, tol)
        for shape, (errs, ms, plain_ms, work) in par_d[label].items():
            errs_s = " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            bnd, by = bound_ms(*work, 4 if label == "f32" else 8)
            print(f"parity batched_riccati shared {shape} {label}: max|kernel"
                  f" - plain| {errs_s}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}: "
                  f"{work[0] / 1e6:.2f} MB, {work[1] / 1e9:.4f} GFLOP), share"
                  f" {bnd / ms:.2%} [{card}]", flush=True)

    # ---- 3k. kernels D and A at the naive rocket's N=301, B=1024 and B=1
    par_k = {}
    for label, dtype, tol in (("f32", torch.float32, F32_TOL),
                              ("f64", torch.float64, F64_TOL)):
        for B in (NAIVE_B, 1):
            par_k[label, B] = naive_rocket_parity(dtype, tol, B)
            for name, (errs, ms, plain_ms, work) in par_k[label, B].items():
                errs_s = " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                bnd, by = bound_ms(*work, 4 if label == "f32" else 8)
                print(f"parity {name} naive rocket N=301 B={B} {label}: "
                      f"max|kernel - plain| {errs_s}; kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}: "
                      f"{work[0] / 1e6:.2f} MB, {work[1] / 1e9:.4f} GFLOP), "
                      f"share {bnd / ms:.2%} [{card}]", flush=True)

    # ---- 3n. kernels B, C and A with a group axis (the grouped quadruped)
    t0 = time.perf_counter()
    par_n = {}
    for label, dtype, tol in (("f32", torch.float32, F32_TOL),
                              ("f64", torch.float64, F64_TOL)):
        for B in GROUPED_BATCHES:
            par_n[label, B] = grouped_parity(dtype, tol, B)
            for name, (errs, ms, plain_ms, work) in par_n[label, B].items():
                errs_s = " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                bnd, by = bound_ms(*work, 4 if label == "f32" else 8)
                print(f"parity {name} grouped quadruped B={B} G=8 {label}: "
                      f"max|kernel - plain| {errs_s or '(shared launch)'}; "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bnd:.4f} ms ({by}: {work[0] / 1e6:.2f} MB, "
                      f"{work[1] / 1e9:.4f} GFLOP), share {bnd / ms:.2%} "
                      f"[{card}]", flush=True)
    print(f"phase 3n: {time.perf_counter() - t0:.1f} s", flush=True)

    def reset_counts():
        rollout.launch_count = 0
        riccati_fused.launch_count = 0
        rollout_al.launch_count = 0
        riccati.launch_count = 0
        altro.pass_count = 0
        altro.eager_loop_count = 0

    def read_counts():
        return {"batched_ls_rollout": rollout.launch_count,
                "fused_expand_backward": riccati_fused.launch_count,
                "batched_ls_rollout_al": rollout_al.launch_count,
                "batched_riccati": riccati.launch_count}

    # Each main path's launches are gated against the solver-loop body
    # passes counted in the same window (solver.altro.pass_count): B and D
    # launch once per pass, A and C once per pass of the paths that take
    # them, A once more per solve that starts without states. The main
    # paths run on CUDA graphs, whose replays add to both counters, and
    # never enter the host-driven loop (solver.altro.eager_loop_count).
    eager_entries = 0

    # ---- 4a. main path: flagship
    reset_counts()
    res = run_flagship(B=FLAG_B, T=FLAG_T, device="cuda")
    launches, passes = read_counts(), altro.pass_count
    eager_entries += altro.eager_loop_count
    print(f"main path [{card}]: solves/s={res['solves_per_s']:.1f} "
          f"step_ms p50={res['step_ms_p50']:.3f} p99={res['step_ms_p99']:.3f} "
          f"mean_iters={res['mean_iters']:.3f} success_rate="
          f"{res['success_rate']:.4f} max_viol={res['max_viol']:.3e} "
          f"walls_s={['%.4f' % w for w in res['wall_s']]} "
          f"lane_max_iters={res['lane_max_iters']} passes={passes} "
          f"graph_replays={res['graph_replays']} check_every="
          f"{res['check_every']} capture_s={res['capture_s']:.3f} "
          f"launches={launches}")
    if res["success_rate"] != 1.0 or not res["max_viol"] <= 1e-4:
        raise AssertionError(f"flagship quality: {res}")
    if not (passes > 0 and launches["fused_expand_backward"] == passes
            and launches["batched_ls_rollout"] == passes + res["cold_solves"]
            and launches["batched_ls_rollout_al"] == 0
            and launches["batched_riccati"] == 0):
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{passes} solver-loop passes")

    def conic_main_path(res, launches, passes, fresh_solves):
        """Print a conic main path's result and gate its quality and its
        launches: B and C once per pass, A once per solve that starts
        without states (``fresh_solves``), D never."""
        family = res["family"]
        print(f"{family} main path [{card}]: compaction "
              f"{res['compaction']}; cold N={res['cold_N']} solve "
              f"{res['cold_s']:.3f} s status={res['cold_status']} passes="
              f"{res['cold_iters']} viol={res['cold_viol']:.3e}; batched "
              f"init {res['init_s']:.3f} s; solves/s="
              f"{res['solves_per_s']:.1f} step_ms p50={res['step_ms_p50']:.3f}"
              f" p99={res['step_ms_p99']:.3f} mean_iters="
              f"{res['mean_iters']:.3f} lane_max_iters_per_step="
              f"{res['iters_max_per_step_mean']:.3f} passes_per_step="
              f"{res['passes_per_step']:.3f} iters_p99="
              f"{res['iters_p99']:.1f} success_rate="
              f"{res['success_rate']:.5f} max_viol={res['max_viol']:.3e} "
              f"max_viol_succeeded={res['max_viol_succeeded']:.3e} wall_s="
              f"{res['wall_s']:.4f} solves={res['solves']} passes={passes} "
              f"replays_per_step={res['graph_replays_per_step']:.3f} "
              f"check_every={res['check_every']} capture_s="
              f"{res['capture_s']:.3f} launches={launches}")
        if not (res["success_rate"] >= 0.999
                and res["max_viol_succeeded"] <= 1e-4):
            raise AssertionError(f"{family} quality: {res}")
        if not (passes > 0 and passes == res["loop_iterations"]
                and launches["fused_expand_backward"] == passes
                and launches["batched_ls_rollout_al"] == passes
                and launches["batched_ls_rollout"] == fresh_solves
                and launches["batched_riccati"] == 0):
            raise AssertionError(f"{family} launch counts {launches} do not "
                                 f"match {passes} solver-loop passes and "
                                 f"{fresh_solves} solves without states")

    # ---- 4b. main path: rocket (cold N=301 solve + B=1024, T=30) in the
    # shipped compaction schedule; every warm solve is seeded from the
    # tracking window's controls without states, so A runs once per solve
    reset_counts()
    su32 = rocket_setup(torch.float32, device="cuda")
    cap, block, levels = SCHEDULES["rocket"]
    rres = rocket_batched(B=ROCKET_B, T=ROCKET_T, device="cuda", setup=su32,
                          compact_cap=cap, compact_block=block,
                          compact_levels=levels)
    rlaunches = read_counts()
    eager_entries += altro.eager_loop_count
    conic_main_path(rres, rlaunches, altro.pass_count, rres["solves"])

    # ---- 4c. main path: the flat quadruped batch, both friction modes
    qlaunches, qrows = {}, {}
    for lin in (True, False):
        reset_counts()
        qres = quadruped_batched(B=QUAD_B, rounds=QUAD_ROUNDS,
                                 linearized_friction=lin, device="cuda")
        qrows["qp" if lin else "socp"] = qres
        ql, qpasses = read_counts(), altro.pass_count
        eager_entries += altro.eager_loop_count
        print(f"quadruped main path [{card}]: {json.dumps(qres)} "
              f"passes={qpasses} launches={ql}")
        if not (qres["success_rate"] == 1.0 and qres["max_viol"] <= 1e-4):
            raise AssertionError(f"quadruped quality: {qres}")
        if not (qpasses > 0 and ql["batched_riccati"] == qpasses
                and ql["batched_ls_rollout"] == qpasses + qres["solves"]
                and ql["fused_expand_backward"] == 0
                and ql["batched_ls_rollout_al"] == 0):
            raise AssertionError(f"quadruped launch counts {ql} do not match "
                                 f"{qpasses} solver-loop passes of "
                                 f"{qres['solves']} solves")
        for k, v in ql.items():
            qlaunches[k] = qlaunches.get(k, 0) + v

    # ---- 4n. main path: the grouped quadruped (B and C once per pass, A
    # once per solve); 4o. the flat quadruped with straggler compaction
    # (gated there, host-loop entries included)
    t0 = time.perf_counter()
    nlaunches = grouped_main(card, reset_counts, read_counts, qrows)
    olaunches = compacted_quadruped(card, reset_counts, read_counts, qrows)
    print(f"phase 4n-4o ({time.perf_counter() - t0:.1f} s) launches: 4n "
          f"{nlaunches}, 4o {olaunches}", flush=True)

    # ---- 4e. main path: grasp (cold N=61 solve + B=1024, T=15) in the
    # shipped compaction schedule; the warm solves start from the
    # seam-corrected shifted states, so A runs for the two cold solves only
    # (run before 4d, which compares on its setup)
    reset_counts()
    gsu32 = grasp_setup(torch.float32, device="cuda")
    cap, block, levels = SCHEDULES["grasp"]
    gres = grasp_batched(B=GRASP_B, T=GRASP_T, device="cuda", setup=gsu32,
                         compact_cap=cap, compact_block=block,
                         compact_levels=levels)
    glaunches = read_counts()
    eager_entries += altro.eager_loop_count
    conic_main_path(gres, glaunches, altro.pass_count, gres["cold_solves"])

    # ---- 4g. main path: flexsat (one cold N=80 solve copied to B=1024
    # lanes, then T=45 regulator steps) in the shipped compaction schedule;
    # the warm solves start from the re-based states, so A runs once
    reset_counts()
    fres = flexsat_batched(B=FLEX_B, T=FLEX_T, device="cuda")
    flaunches, fpasses = read_counts(), altro.pass_count
    eager_entries += altro.eager_loop_count
    print(f"flexsat main path [{card}]: compaction {fres['compaction']}; "
          f"cold N=80 solve status={fres['cold_status']} iterations="
          f"{fres['cold_iters']} viol={fres['cold_viol']:.3e}; batched init "
          f"{fres['init_s']:.3f} s; solves/s={fres['solves_per_s']:.1f} "
          f"step_ms p50={fres['step_ms_p50']:.3f} p99="
          f"{fres['step_ms_p99']:.3f} mean_iters={fres['mean_iters']:.3f} "
          f"lane_max_iters_per_step={fres['iters_max_per_step_mean']:.3f} "
          f"passes_per_step={fres['passes_per_step']:.3f} iters_p99="
          f"{fres['iters_p99']:.1f} iters_max={fres['iters_max']} "
          f"success_rate={fres['success_rate']:.5f} max_viol="
          f"{fres['max_viol']:.3e} wall_s={fres['wall_s']:.4f} passes="
          f"{fpasses} replays_per_step={fres['graph_replays_per_step']:.3f}"
          f" check_every={fres['check_every']} capture_s="
          f"{fres['capture_s']:.3f} launches={flaunches}")
    if not (fres["success_rate"] == 1.0 and fres["max_viol"] <= 1e-4):
        raise AssertionError(f"flexsat quality: {fres}")
    if not (fpasses > 0 and fpasses == fres["loop_iterations"]
            and flaunches["fused_expand_backward"] == fpasses
            and flaunches["batched_ls_rollout_al"] == fpasses
            and flaunches["batched_ls_rollout"] == 1
            and flaunches["batched_riccati"] == 0):
        raise AssertionError(f"flexsat launch counts {flaunches} do not "
                             f"match {fpasses} solver-loop passes and one "
                             f"cold solve")

    # ---- 4j. main path: the flagship with per-lane window indices (the
    # split route: D and A once per pass)
    # (gated there: its float64 comparison on the CPU enters the host loop)
    jlaunches = lane_flagship(card, reset_counts, read_counts)

    # ---- 4r. main path: the state_dim sweep's n = 45 as an MPC batch, on
    # the split route (D and A wide) and on the fused route with the fused
    # ladder (B and C wide); gated there (its float64 comparison on the CPU
    # enters the host loop)
    t0 = time.perf_counter()
    rlaunches_wide = state_dim_wide(card, reset_counts, read_counts)
    print(f"phase 4r ({time.perf_counter() - t0:.1f} s) launches: "
          f"{rlaunches_wide}", flush=True)

    # ---- 4p. main path: scenario sharding at world size 1 on NCCL, the
    # dry run and the scaling rows (gated there)
    plaunches = sharded_flagship(card, reset_counts, read_counts)

    # ---- 4q. main path: per-lane grasp windows (the split route: D and A
    # once per pass; gated there)
    qwlaunches = lane_grasp(card, reset_counts, read_counts)

    # ---- 4k, 4l. main path: the naive rocket (the quadratic norm blocks
    # take the split route: D and A once per pass, A once more per solve);
    # 4k's one landing beside the conic form, 4l's Monte-Carlo batch
    # (gated there: 4k's float64 comparison on the CPU enters the host
    # loop)
    t0 = time.perf_counter()
    klaunches = naive_rocket_one(card, reset_counts, read_counts)
    for k, v in naive_rocket_batch(card, reset_counts, read_counts).items():
        klaunches[k] += v
    print(f"phase 4k-4l ({time.perf_counter() - t0:.1f} s) launches: "
          f"{klaunches}", flush=True)

    # ---- 4m. main path: the nonlinear SRB trot (D once per pass, no
    # other kernel)
    t0 = time.perf_counter()
    mlaunches = srb_nonlinear(card, reset_counts, read_counts)
    print(f"phase 4m ({time.perf_counter() - t0:.1f} s) launches: "
          f"{mlaunches}", flush=True)

    # ---- 4h. main path: the quadruped closed loop, both friction forms;
    # A once per solve (each starts without states), B and C once per pass
    def loop_counts():
        return read_counts(), altro.pass_count, altro.eager_loop_count

    llaunches = {}
    for lin in (True, False):
        reset_counts()
        for k, v in closed_loop_main(card, lin, loop_counts).items():
            llaunches[k] = llaunches.get(k, 0) + v
        eager_entries += altro.eager_loop_count

    # ---- 4i. main path: the closed loop against a mismatched plant
    reset_counts()
    for k, v in closed_loop_mismatch(card, loop_counts).items():
        llaunches[k] = llaunches.get(k, 0) + v
    eager_entries += altro.eager_loop_count

    # ---- 4d. compacted against plain on the card: rocket, grasp, flexsat
    reset_counts()
    for csu in (su32, gsu32):
        compacted_against_plain(
            csu.family,
            lambda cap, block, levels, c=csu: make_step(c, cap, block,
                                                        levels),
            SCHEDULES[csu.family], conic_noise(csu, COMPARE_T))
    fsu = flexsat_setup(COMPARE_B, COMPARE_T, torch.float32, "cuda")
    compacted_against_plain(
        "flexsat", lambda cap, block, levels: flexsat_step(fsu, cap, block,
                                                           levels),
        FLEXSAT_SCHEDULE, fsu.noise)
    eager_entries += altro.eager_loop_count
    print(f"entries into the host-driven loop over 4a-4e and 4g-4j: "
          f"{eager_entries}")
    if eager_entries:
        raise AssertionError(f"the main paths entered the host-driven loop "
                             f"{eager_entries} times")

    # ---- 4f. graphed against eager on the card
    graphed_against_eager(card, su32, gsu32, fsu)
    closed_loop_forms(card)
    nonlinear_forms(card)

    # ---- 5a. agreement: f32 kernel path on the card vs f64 plain on the CPU
    s64 = flagship_setup(AGREE_B, AGREE_T, dtype=torch.float64, device="cpu")
    s32 = tree_to(s64, "cuda", torch.float32)
    out32 = run_steps(s32, AGREE_B, AGREE_T)
    out64 = run_steps(s64, AGREE_B, AGREE_T)
    for t, (a, b) in enumerate(zip(out32, out64)):
        if not torch.equal(a.status.cpu(), b.status):
            raise AssertionError(f"step {t}: status differs")
    dU = torch.stack([(a.U.cpu().double() - b.U).abs() for a, b in
                      zip(out32, out64)]).flatten()
    q99 = float(torch.quantile(dU[::max(1, dU.numel() // 100000)], 0.99))
    print(f"agreement {AGREE_B} lanes x {AGREE_T} steps, f32 kernels vs f64 "
          f"plain: max|dU|={float(dU.max()):.3e} mean={float(dU.mean()):.3e} "
          f"p99={q99:.3e}")
    if not float(dU.max()) <= AGREE_TOL:
        raise AssertionError(f"f32-vs-f64 control gap {float(dU.max()):.3e}")

    # ---- 5b. rocket agreement
    agreement_conic.conic_agreement(su32, ROCKET_AGREE_B, ROCKET_AGREE_T)

    # ---- 5c. quadruped agreement
    quadruped_agreement()

    # ---- 5h. the grouped quadruped's agreement module
    reset_counts()
    grouped_agreement(card)
    hlaunches = read_counts()

    # ---- 5d. grasp agreement
    agreement_conic.conic_agreement(gsu32, GRASP_AGREE_B, GRASP_AGREE_T)

    # ---- 5e. flexsat agreement: float32 on the card against float64
    # truth solves (16 lanes per checked step, on the CPU) and tight
    # float64 re-solves of every lane (on the card)
    fag = agreement_flexsat.run(FLEX_AGREE_B, "cuda")
    fb = fag["fullbatch"]
    print(f"flexsat agreement [{card}] {FLEX_AGREE_B} lanes x "
          f"{agreement_flexsat.T_STEPS} steps, f32 kernels: success "
          f"{fag['f32_success_rate']:.5f}, max_viol "
          f"{fag['f32_max_viol']:.3e}; {agreement_flexsat.SAMPLE} lanes x "
          f"steps {fag['config']['window_ks']} against f64 truth at 1e-7 "
          f"(CPU): truth success {fag['truth_success']}, max|dU| "
          f"{fag['err_U_max']:.3e} (mean {fag['err_U_mean']:.3e}), cost gap"
          f" max {fag['cost_rel_gap_max']:.3e} mean "
          f"{fag['cost_rel_gap_mean']:.3e}; every lane against a tight f64 "
          f"re-solve (card, f64 kernels), {fb['lanes_x_windows']} "
          f"lane-steps: gap mean {fb['gap_mean']:.3e}, p99 |gap| "
          f"{fb['gap_abs_p99']:.3e}, max {fb['gap_max']:.3e}, min "
          f"{fb['gap_min']:.3e}, tight success {fb['tight_success']:.5f}, "
          f"tight vs truth max|gap| {fb['tight_vs_truth_gap_max_abs']:.3e}"
          f"; gates |mean| <= {agreement_flexsat.GATE_BIAS:.0e}, p99 <= "
          f"{agreement_flexsat.GATE_P99:.0e}")
    agreement_flexsat.check(fag)

    # ---- 5f. the closed loop, card (f64 kernels) against the CPU (plain)
    closed_loop_agreement(card)

    # ---- 5g. the gate modules: fused_check in full, agreement at T=3
    reset_counts()
    gate_modules(card, su32, gsu32)
    glaunches5 = read_counts()
    print(f"phase 5g launches: {glaunches5}")

    # ---- 6. baselines on the card; ALTRO's launches count in the table
    from altro_tpu_torch.bench import baselines
    reset_counts()
    base = baselines.run("cuda")
    baselines.check(base)
    lockstep_on_card(card)
    quadruped_table(card)
    drivers_once(card)
    c0 = read_counts()
    multibaseline_on_card(card)
    c1 = read_counts()
    cpp_race_on_card(card)
    c2 = read_counts()
    state_dim_on_card(card)
    p6launches = read_counts()
    for label, a, b in (("6e four-solver studies", c0, c1),
                        ("6f C++ race", c1, c2),
                        ("6g state_dim n = 35-55 (wide bodies)", c2,
                         p6launches)):
        print(f"phase {label} launches: "
              f"{ {k: b[k] - a[k] for k in b} }")
    print(f"phase 6 ALTRO launches: {p6launches}")

    # ---- 7. the quickstart on the card
    reset_counts()
    t0 = time.perf_counter()
    quickstart_on_card()
    qslaunches = read_counts()
    print(f"phase 7 quickstart ({time.perf_counter() - t0:.1f} s) launches: "
          f"{qslaunches}", flush=True)

    # kernel table: launches over the main paths (4h-4j, 5g and 7
    # included), the largest float32 error over every parity check (3j's
    # too), times and bounds at the shapes of the path that the kernel
    # serves per iteration (the rocket window for B and C, the quadruped
    # batch for D). No single
    # PyTorch call computes any of these knot recursions, so library_ms is
    # null.
    sources = {
        "batched_ls_rollout": ("altro_tpu_torch/csrc/ls_rollout.cu",
                               "altro_tpu/ops/rollout.py:89", "flagship"),
        "fused_expand_backward": ("altro_tpu_torch/csrc/riccati_fused.cu",
                                  "altro_tpu/ops/riccati_fused.py:301",
                                  "rocket"),
        "batched_ls_rollout_al": ("altro_tpu_torch/csrc/ls_rollout_al.cu",
                                  "altro_tpu/ops/rollout.py:285", "rocket"),
        "batched_riccati": ("altro_tpu_torch/csrc/riccati.cu",
                            "altro_tpu/ops/riccati.py:204", "quadruped"),
    }
    table = []
    for name, (src, rep, timed) in sources.items():
        _, ms, plain_ms, work = par[timed][0][name]
        bnd, by = bound_ms(*work, 4)
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": (launches[name] + rlaunches[name] + qlaunches[name]
                         + nlaunches[name] + olaunches[name]
                         + glaunches[name] + flaunches[name]
                         + jlaunches[name] + rlaunches_wide[name]
                         + plaunches[name]
                         + qwlaunches[name] + klaunches[name]
                         + mlaunches[name] + llaunches[name]
                         + hlaunches[name] + glaunches5[name]
                         + p6launches[name] + qslaunches[name]),
            "max_abs_err": max(
                [v for shape in par if name in par[shape][0]
                 for v in par[shape][0][name][0].values()]
                + [v for res in par6["f32"].values() if name in res
                   for v in res[name].values()]
                + [v for B in WIDE_BATCHES
                   for res in wide["f32", B].values()
                   for k, r in res.items() if k.split(" ")[0] == name
                   for v in r[0].values()]
                + [v for r in par_d["f32"].values()
                   if name == "batched_riccati" for v in r[0].values()]
                + [v for B in (NAIVE_B, 1)
                   for k, r in par_k["f32", B].items() if k == name
                   for v in r[0].values()]
                + [v for B in GROUPED_BATCHES
                   for k, r in par_n["f32", B].items()
                   if k.split(" ")[0] == name for v in r[0].values()]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None})
    # the nonlinear and non-affine path's rows: D and A at the naive
    # rocket's N=301 (3k at B=1024, float32; launches over 4k-4l), and D
    # at the nonlinear SRB's per-lane linearization (launches over 4m;
    # ill-conditioned Quu: gated against the float64 answer, see
    # ``against_f64``)
    from altro_tpu_torch.bench.kernels import quadruped_inputs
    srb = {}
    for label, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        sn = quadruped_inputs(dtype, torch.device("cuda"), nonlinear=True)
        sn_args = sn["riccati"]
        got = riccati.batched_riccati(*sn_args)
        if dtype == torch.float32:
            errs = against_f64("D (nonlinear SRB)", got, sn["riccati_ref"],
                               riccati.batched_riccati_reference(
                                   *(a.double() for a in sn_args)),
                               ("K", "d", "dV1", "dV2"))
        else:
            errs = errors(got, sn["riccati_ref"], ("K", "d", "dV1", "dV2"),
                          F64_TOL)
        srb[label] = (errs,
                      time_ms(lambda: riccati.batched_riccati(*sn_args),
                              kernel=True),
                      time_ms(lambda: riccati.batched_riccati_reference(
                          *sn_args)), sn["riccati_work"])
    print(f"D (nonlinear SRB) f64: max|kernel - plain| "
          + " ".join(f"{k}={v:.3e}" for k, v in srb["f64"][0].items())
          + f"; kernel {srb['f64'][1]:.4f} ms, plain {srb['f64'][2]:.4f} ms, "
          f"bound {bound_ms(*srb['f64'][3], 8)[0]:.4f} ms [{card}]")
    srb_row = srb["f32"]
    for row_name, name, (errs, ms, plain_ms, work), path in (
            ("batched_riccati (naive rocket, N=301)", "batched_riccati",
             par_k["f32", NAIVE_B]["batched_riccati"], klaunches),
            ("batched_ls_rollout (naive rocket, N=301, L=11)",
             "batched_ls_rollout",
             par_k["f32", NAIVE_B]["batched_ls_rollout"], klaunches),
            ("batched_riccati (nonlinear SRB)", "batched_riccati", srb_row,
             mlaunches),
            ("fused_expand_backward (grouped quadruped, G=8)",
             "fused_expand_backward",
             par_n["f32", QUAD_B]["fused_expand_backward"], nlaunches),
            ("batched_ls_rollout_al (grouped quadruped, G=8, L=11)",
             "batched_ls_rollout_al",
             par_n["f32", QUAD_B]["batched_ls_rollout_al"], nlaunches),
            ("batched_ls_rollout (grouped quadruped, G=8, init L=1)",
             "batched_ls_rollout",
             par_n["f32", QUAD_B]["batched_ls_rollout"], nlaunches),
            *((f"{name} (wide body, n={WIDE_MPC[0]} m={WIDE_MPC[1]})", name,
               wide["f32", WIDE_BATCHES[-1]][WIDE_MPC[:2]][name],
               rlaunches_wide)
              for name in ("batched_ls_rollout", "fused_expand_backward",
                           "batched_ls_rollout_al", "batched_riccati"))):
        src, rep_, _ = sources[name]
        bnd, by = bound_ms(*work, 4)
        print(f"{row_name}: max|kernel - plain| "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}), share {bnd / ms:.2%}; launches "
              f"{path[name]} [{card}]")
        table.append({
            "name": row_name, "route": "cuda", "source": src,
            "replaces": rep_, "launches": path[name],
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
