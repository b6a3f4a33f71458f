#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (one NVIDIA GPU).

Drives ``irbfn_tpu_torch`` through its paths: the learned Frenet
planner in closed loop, with the flagship ``frenet_wide_pr1`` WCRBF net
(R=16 regions, K=512 kernels, F=8 inputs, O=10 outputs, per-region heads;
kernel ``rbf_forward``); the goal-MPC path (kernel ``admm_solve``): the
reference goal lattice and the goal-MPC closed loop in both planner modes,
the live ADMM solve and the ``goal_mpc_pr`` net (F=5, O=2); and the
fit-and-train path, which makes a goal net from the lattice just solved
(closed-form per-region fit, checkpoint, offline eval through both kernels,
Adam fine-tune, closed loop); and the Frenet chain, which starts from no
table at all: the batched NMPC solver makes one on the card, the flagship
recipe fits it, and the fitted net, the table itself and the solver each
drive the closed loop; and the map world and the bank: the 12-arm
grip-adaptive bank (``rbf_forward`` twelve times a step), the cartesian
planner, the flagship in a rasterized map with scans and iTTC, and the
Oschersleben line through ``eval_closed_loop`` with a track bundle (both
kernels); the clothoid pipeline of the IROS-2023 paper: the whole
6,384,938-goal clothoid LUT solved on the card, ``clothoid_pr`` (R=128,
K=256, F=3, O=5; ``rbf_forward``) over it, its recipe fitted on it, and the
lattice planner; and the cartesian chain: a table made on the card, its
stragglers patched, the ``cart_c1_pr`` recipe, the fitted net in the
closed loop; and the linear-MPC family and the rest of the simulator: the
quadrotor pipeline (its net ``quadrotor_pr`` through ``rbf_forward``), the
LTV tracking MPC (``admm_solve``), lidar and multi-agent racing, the
overtake demo, PPO and the closed-loop demos; and multi-device: the
region-sharded (expert-parallel) forward through the kernel's partial
mode, the sharded lattice solves and the DP x EP dry run on NCCL; and
the last tools of the JAX package: the raceline makers, the oracle
generator, the TrajGen harness and the NMPC roofline's ceilings; and
the committed nets of the zoo, each against its JAX golden and in the
loop, the learned 3-arm bank and the NMPC profiler's trace; and JAX's
random streams, which every ``--seed`` of the port draws from. Each
phase prints one line (phase 48 one a net)
(the entry points of phases 28-39 and 43 write their own output to
``torch_runs/chip_smoke_logs/phase<n>_*.log``), and any failure exits
non-zero:

1. device: requires CUDA (never falls back to the CPU); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles both ``irbfn_tpu_torch/ops/csrc/*.cu`` into ``build/``
   with nvcc, one process each, started together;
3. RBF kernel vs its plain PyTorch version on the card: the flagship at
   B in {1, 7, 1000, 1024}, around the kernel's 32-row batch tile (31, 32,
   33) and at 4096, a shared-head net of the same width, every basis
   function at a small shape, shapes off the kernel's tiles (K = 100, O = 17,
   F = 16, R = 1 and 5), the distance-cancellation regime, and two
   forwards of one input, which must agree bit for bit;
4. against JAX: the forward and ``IRBFNFrenetPlanner.plan_batch`` against
   the goldens the JAX package wrote (``scripts/export_torch_ckpt.py``);
5. Frenet closed loop: the eval sweep's defaults, 10x10 (mu, cs) x 10
   trials = 1000 lanes x 600 control steps on the oval track, with the
   kernels' launches counted; completions and mean |ey| against the golden;
6. times: the batch-1024 flagship forward, kernel against plain version;
7. ADMM kernel vs its plain version: one-family launches at v_car in
   {-1, 4.5, 8} x G in {1, 7, 96, 4097} at 300 and 600 sweeps, two whole
   reference families (2,642,368 goals each) row by row, the planner's
   shape (1000 one-goal families), shapes on both sides of the rule that
   picks the kernel's variant, and two solves of one input, bit for bit;
8. the RBF kernel at the goal net's width against its plain version and the
   golden's f64 forward;
9. goal-MPC against JAX: 4,864 golden lattice rows through the kernel
   against JAX's f64 and f32 solves, and both planner modes' ``plan_batch``;
10. the whole reference lattice, 50,204,992 QPs at 600 sweeps, through the
    table generator's solve: QP solves/s, share converged, launches;
11. goal-MPC closed loop, solver mode (the ADMM kernel): 1000 lanes x 600
    steps in the speed action mode against the JAX golden, launches
    counted;
12. the same in net mode (the RBF kernel);
13. times with CUDA events, kernel and plain version in turns: the ADMM
    solve of one whole family (in one launch, and as the table generator's
    11 chunks of 262,144) and of 1000 one-goal families, the ``goal_mpc_pr``
    forward at B=1024, the flagship forward at B=1, and an empty launch;
14. fit on the card: phase 10's lattice as a table (50,204,992 rows resident
    on the card), ``train_goal_mpc`` at the committed ``goal_mpc_pr``
    recipe (R=16, K=512, per-region heads, inverse-quadratic basis, seed
    0); seconds of each part, rows/s, and the strided MAE beside the
    committed net's on the same rows;
15. the fitted net through the kernels: saved, reloaded, and
    ``eval_goal_mpc``: table MAE through ``rbf_forward`` and 4,096 off-grid
    rows against one ``admm_solve`` launch of 1200 sweeps; its kernel
    forward against its module-path forward;
16. fine-tune on the card: 200 Adam steps of the L1 loss at batch 8192
    through ``train_epochs`` (autograd through the module path, no kernel
    launch); ms per step and peak memory;
17. the fitted net in the net-mode goal-MPC closed loop: every lane must
    finish, with a mean |ey| within 25% of phase 12's;
18. the flagship's f32 ``frenet_fullint_loss``, gradient norms and five Adam
    steps against the JAX package's f64 fixture
    (``scripts/export_torch_ckpt.py --train_golden``);
19. the NMPC solver in f64 on the card against the JAX package's f64
    solutions of 234 seeded rows of the flagship table's ranges, against
    the stored SLSQP oracle (100 rows), and ``NMPCPlanner`` against a short
    JAX NMPC-in-the-loop run (``scripts/export_torch_ckpt.py
    --nmpc_golden``);
20. f32 against f64 on the card on a seeded sample of those ranges at the
    table generator's chunk size: share feasible in each, flags that
    differ, objective gap and control difference on rows feasible in both;
    every row the 12-iteration cheap pass certifies meets the full pass's
    tolerances; and the cheap pass in f32 on the 312 seeded rows of the
    reference-parity lattice that the JAX package certified on a CPU
    (``cheap_pass_golden.npz``; fault P4 of ROADMAP.md), its certified share
    within ``TOL_CHEAP_SHARE`` of the JAX package's;
21. the table: ``gen_nmpc_table_frenet.solve_table`` over the flagship
    table's ranges (per-axis counts cut: ``TABLE_COUNTS``), default
    budgets, tiered, the one-hot kept; solves/s of each pass and overall,
    share certified by the cheap pass, share feasible;
22. that table fitted with the flagship recipe (mirror, closed-form
    per-region fit, R=16, K=512, tube weights) and evaluated:
    ``eval_offline``'s control L1 equals the fit's own; kernel forward
    against the module path; the committed flagship's L1 on the same rows;
23. three planners over that table in closed loop on the oval: the fitted
    net (``rbf_forward``) and ``ExplicitFrenetPlanner``'s multilinear lookup
    (1000 lanes x ``N_RECORD_STEPS``) and ``NMPCPlanner`` in f32
    (39 lanes x 4 steps, from its own warm start and from the net's).

24. the 12-arm grip-adaptive bank (``bank6_pr_mu0.10`` .. ``1.20``, R=16,
    K=256, per-region heads) through ``rollout_stateful`` on phase 5's sweep
    with the raceline's speed x2.5 (at 3 m/s the grip observer's speed gate
    never opens): every arm's kernel forward against its plain version at
    the loop's batch, then 1000 lanes x 600 steps against the JAX golden
    (done, laps, mean |ey|, final grip estimate, the arm each lane drove with
    at each step), 12 forwards per control step;
25. the cartesian planner (``cart_c1_pr``, R=16, K=512, F=7, setpoint
    mode): ``plan_batch`` against the JAX f64 golden on seeded poses, its
    kernel against the plain version, then the same 1000-lane sweep against
    the JAX golden;
26. the map world: the oval rasterized into an occupancy grid on the card,
    64-beam ``trace_rays`` against the JAX goldens and timed, then the
    flagship over the 1000-lane sweep with scans, iTTC and a 0.15 m disc
    against the map (no corridor), against the JAX golden;
27. the Oschersleben line (``data/Oschersleben_raceline_feasible.csv``) in a
    map rasterized around it, written as a track bundle: the eval script's
    3 x 3 flags (27 lanes, no start noise, one attempt) through
    ``eval_closed_loop.run`` for the flagship (``rbf_forward``) and the
    goal-MPC solver (``admm_solve``), each kernel against its plain version
    at the path's shape, the loops against the JAX golden with the steps
    whose goal lookahead reads the CSV's faulty seam rows masked;

28. the clothoid LUT: the reference grid's 6,384,938 goals through
    ``gen_clothoid_lut.solve_table`` (solves/s), every entry's endpoint miss
    in f64 quadrature under the f32 bound, the card's f32 solution of the
    golden's 65,536 goals against the JAX package's f64
    (``scripts/export_torch_ckpt.py --clothoid_golden``), and the native
    oracle (built in phase 2 with g++) on 4,096 of them;
29. ``clothoid_pr`` through the kernel: against its plain version at
    B=8192, against the JAX f64 golden on the 65,536 goals,
    ``eval_lut_accuracy`` over the whole LUT in chunks of 2^18 (launches
    counted), times at B = 2^18, 8192 and 360 with their bounds;
30. the ``clothoid_pr`` recipe (``train_clothoid --num_x 8 --num_y 4
    --num_t 4 --num_k 256 --error_reweight 2``) on phase 28's LUT, its
    fine-tune CUT to ``CLOTHOID_FINETUNE_STEPS`` steps: seconds of each
    part, and the fitted net's endpoint means over the LUT beside the
    committed net's of phase 29;
31. ``LatticePlanner`` in net and oracle mode against the golden's plans,
    then ms per plan and one kernel forward per plan;
32. the cartesian chain: ``gen_nmpc_table_cartesian`` over the reference
    ranges with the counts cut (``CART_TABLE_ARGS``), made without its
    straggler pass, ``patch_table_stragglers`` on its flagged rows,
    ``train_cartesian`` with ``cart_c1_pr``'s recipe, the fitted net
    through ``eval_closed_loop --planner irbfn_cart`` on the sweep
    (``N_RECORD_STEPS``), and ``eval_nmpc_oracle`` on ``N_ORACLE_ROWS``;

33. the linear MPC: the quadrotor lattice (9^4 + 32,768 = 39,329 condensed
    QPs, n = 20, up to 1000 sweeps) against the JAX f32 golden's first
    controls and converged flags, QP solves/s; ``solve_qp_batch`` on 1,024
    seeded random QPs in f64 against the same call on the CPU;
34. the quadrotor pipeline's ``run`` at the script's defaults (seconds of
    each part, train L1, off-grid MAE, regulation of net and MPC against
    ``data/quadrotor_results.json``), and the committed ``quadrotor_pr``
    (R=16, K=256, F=4, O=2, gaussian_wide) through ``rbf_forward``
    against its plain version and the JAX goldens (forward and the 80-step
    regulation loops), launches counted;
35. the LTV tracking MPC on 1,000 seeded curving references: one
    ``admm_solve`` launch (lane variant) per solve, against the plain
    version and the JAX f64 golden; ms per solve;
36. a 1,000-pose corridor lidar scan against the JAX golden (ms, peak
    memory); agent-aware scans and both collision models on a seeded
    1,000 x 4-car batch;
37. the overtake demo at its defaults (300 steps, the 360-goal oracle
    lattice) in both modes: 30 steps against JAX's rollout, the outcome
    against JAX's run, ms per control step;
38. ``train_ppo`` at its widths for ``PPO_UPDATES`` updates (env steps/s,
    a finite history, progress rising); one update from the JAX side's
    parameters with its draws against the JAX golden; and one update from
    ``PPOTrainer(seed=0)``'s own initial weights and draws (JAX's key
    chain, no replay): the weights bit for bit the golden's ``p0``, the
    uniforms bit for bit, every permutation, every categorical action
    (a lane that differs must have a gumbel margin under 1e-5), and the
    update against the golden's ``p1``;
39. ``demo_closed_loop`` at its defaults for ``pursuit``, ``irbfn`` and
    ``goal_mpc`` (both kernels' launches counted), and the
    ``demo_traj_fan`` net fan (``clothoid_pr``) against its plain version;

40. the expert-parallel forward: ``frenet_wide_pr1`` at B = 1,024 and
    65,536 split into E in {2, 4, 8, 16} region slices, ``clothoid_pr`` at
    B = 8,192 into 2 and 8, a shared-head net into 2 to 16, each slice one
    launch of ``rbf_forward.cu``'s partial mode, the slices' sums added and
    divided as the expert all_reduce does; against the unsharded kernel and
    the plain partial mode; E launches per sharded forward; the partial
    launch timed in turns with the default mode;
41. the sharded datagen on NCCL at world 1: one 2,642,368-goal family of
    phase 10 through ``solve_goal_lattice_sharded`` (twice) and 65,536 rows
    of the reference Frenet lattice through ``solve_lattice_sharded`` at
    the dry run's NMPC budget, each bit for bit the one-device solve's;
    and the same rows solved twice in a fresh spawned process, its first
    NMPC solve and its second bit for bit the solves here (fault P5 of
    ROADMAP.md, repaired);
42. the dry run: ``graft_entry.entry()``'s forward (one launch),
    ``dryrun_multichip`` over every visible card on NCCL, the DP x EP step
    at ``frenet_wide_pr1``'s width (batch 8,192) on the world of one against
    the plain step, and, with more than one card visible, NCCL ranks on up
    to 8 of them against the one-card EP forward and goal family;

43. the raceline tools on a pinched oval bundle written in the run
    (``rasterize_track`` on ``oval_track``, ``save_map_yaml``, centerline
    and raceline CSVs): ``make_feasible_raceline`` in pure push mode and
    ``min_curv_raceline``, each on the card and with ``--device cpu``;
    every point clears the margin on the card's map, the two CSVs agree;
44. the oracle generator: the perturbation-optimality gold derived on the
    card in f64 (2 rows, 60 perturbations each, none improving) against the
    committed ``tests/oracles/nmpc_pert_gold.npz``;
45. the TrajGen frequency of the IROS-2023 paper at B = 500 and 2^14: the
    clothoid solver, solver + integration, and ``clothoid_pr`` through
    ``rbf_forward`` (held against its plain version, launches counted);
46. the card's measured f32 FMA ceiling (the probe
    ``ops/csrc/fma_ceiling.cu``, held against its plain chain; not a TPU
    kernel's counterpart) and HBM read rate, and an NMPC solve's achieved
    share of the FMA ceiling (operations tallied by ``count_ops``).

47. the committed zoo (``scripts/export_torch_ckpt.py --zoo``): the nine
    runs ``arch_wcrbf_pr``, ``arch_wcrbf_shared`` (a shared head),
    ``bank_pr_mu{0.60,0.80,1.00}``, ``frenet_wide_cc`` (K = 499),
    ``frenet_wide_cluster`` (ClusterWCRBFNet, R = 500, K = 10),
    ``wide_deeper`` and ``wide_mlp`` loaded from their assets in f32: the
    forward and ``plan_batch`` against the JAX f64 goldens, the cluster
    net's gate logits too; the six WCRBFNet runs' kernel against its plain
    version at B = 1,024, the other three through the module path, as in
    JAX; the kernel on the shared head and at K = 499 timed in turns with
    the flagship, and at K = 499 also in its partial mode and as a 2-rank
    EP forward;
48. the six single nets of the zoo in phase 5's 1000-lane sweep, CUT to
    their goldens' ``n_steps`` (200), each against its JAX golden;
49. the learned bank: ``eval_adaptive --nets`` over the three
    ``bank_pr_mu*`` arms on the bundle written back from its golden,
    against the JAX script's run: its pulls equal JAX's;
50. ``utils/profiling.py --parts nmpc --reps 4 --trace_dir``: the Chrome
    trace of an NMPC solve names the solver's CUDA kernels.

51. JAX's random streams (``utils/prng.py``) on the card against the same
    calls on the CPU, bit for bit: a chain of 64 splits and folds, 2^20
    bits and uniforms, 2^16 normals, truncated normals and gumbels, the sweep's
    (1000, 3) start noise from ``split(PRNGKey(0))[1]``, and PPO's and
    EXP3's draws; each draw timed, all of them under ``PRNG_SECONDS``.

The last two lines are a JSON object naming both kernels with their
launches, errors, times and bounds, and the line
``{"ok": true, "device": {...}}``.

Usage, from the repository root: ``python3 chip_smoke.py``
"""

import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(ROOT, "irbfn_tpu_torch", "assets")
ASSET = os.path.join(ASSETS, "frenet_wide_pr1")
GOAL_ASSET = os.path.join(ASSETS, "goal_mpc_pr")
GOAL_GOLDEN = os.path.join(ASSETS, "goal_mpc_golden.npz")
TRAIN_GOLDEN = ASSET + "_train_golden.npz"
NMPC_GOLDEN = os.path.join(ASSETS, "nmpc_golden.npz")
TUBE_NPZ = os.path.join(ROOT, "data", "spielberg_tube.npz")
BANK_GOLDEN = os.path.join(ASSETS, "bank6_golden.npz")
CART_ASSET = os.path.join(ASSETS, "cart_c1_pr")
MAP_GOLDEN = os.path.join(ASSETS, "map_golden.npz")
OSCH_CSV = os.path.join(ROOT, "data", "Oschersleben_raceline_feasible.csv")
CLOTHOID_ASSET = os.path.join(ASSETS, "clothoid_pr")
CLOTHOID_GOLDEN = os.path.join(ASSETS, "clothoid_golden.npz")
CHEAP_GOLDEN = os.path.join(ASSETS, "cheap_pass_golden.npz")
# where the long outputs of phases 28-32's entry points are written
LOG_DIR = os.path.join(ROOT, "torch_runs", "chip_smoke_logs")
# rows of that CSV whose heading is off by 2*pi/3 (ROADMAP.md, faults, R2)
OSCH_SEAM_ROWS = (0, 799)
KERNELS = {
    "rbf_forward": {"name": "rbf_forward", "route": "cuda",
                    "source": "irbfn_tpu_torch/ops/csrc/rbf_forward.cu",
                    "replaces": "irbfn_tpu/ops/pallas_rbf.py:45"},
    "admm_solve": {"name": "admm_solve", "route": "cuda",
                   "source": "irbfn_tpu_torch/ops/csrc/admm_solve.cu",
                   "replaces": "irbfn_tpu/ops/pallas_admm.py:56"},
}
# one H100 SXM's published peaks: f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
N_STEPS = 600  # control steps of every closed loop held against a golden
# control steps of the loops that are records (no golden): phase 23's net
# and table loops, phase 32's fitted net; cut from 600 to keep the script
# inside its time limit on slow hosts (an H100 80GB HBM3 machine at 700 W
# took 1,162 s for the 39 phases before the cut to 300; another H100 host
# 1,176.0 s for the 50 phases before the cut to 100)
N_RECORD_STEPS = 100
# the lattice generator's flags (its defaults: the whole reference lattice)
LATTICE_ARGS = ()
# the committed goal_mpc_pr recipe (docs/ARTIFACTS.md): 16 regions x 512
# kernels, per-region heads, inverse-quadratic basis, seed 0
FIT_ARGS = ("--num_k", "512", "--num_v_car", "2", "--num_x_goal", "2",
            "--num_t_goal", "2", "--num_v_goal", "2", "--seed", "0")
TABLE_STRIDE = 1  # rows of the lattice kept for the fit: every one
N_OFFGRID = 4096
FINETUNE_STEPS = 200
FINETUNE_BATCH = 8192

# the Frenet chain: rows per solve of the table generator, the table's
# per-axis counts (the flagship table's are 12 x 7 x 11 x 5 x 6 x 7 x 7 x 9 =
# 12.2M rows over the same ranges: counts cut, nothing else), and the
# flagship fit recipe (docs/ARTIFACTS.md)
NMPC_CHUNK = 65536
TABLE_COUNTS = dict(ey=5, delta=3, vx_car=5, vy_car=3, vx_goal=4, wz=5,
                    epsi=5, curv=5)
N_F64_SAMPLE = 8192  # rows of phase 20's sample also solved in f64
FRENET_FIT_ARGS = ("--mirror_data", "--direct_fit", "--fit_mode",
                   "per_region", "--num_k", "512", "--num_ey", "2",
                   "--num_vx_car", "2", "--num_epsi", "2", "--num_curv", "2",
                   "--tube_npz", TUBE_NPZ)

# the clothoid chain: the reference LUT (251 x 161 x 158 = 6,384,938 goals,
# the generator's defaults), eval_lut_accuracy's chunk, the clothoid_pr
# recipe of docs/ARTIFACTS.md (8 x 4 x 4 regions, 256 kernels, two IRLS
# rounds, 30 fine-tune epochs) with the fine-tune CUT to a number of steps
# (the recipe's 30 epochs are 30 x 779 steps at batch 8192), the native
# oracle's sample, and the plans timed
LUT_ARGS = ()  # the generator's flags: its defaults, the reference grid
LUT_GOALS = 251 * 161 * 158
CLOTHOID_CHUNK = 1 << 18
CLOTHOID_FIT_ARGS = ("--num_x", "8", "--num_y", "4", "--num_t", "4",
                     "--num_k", "256", "--error_reweight", "2",
                     "--finetune_epochs", "30")
CLOTHOID_FINETUNE_STEPS = 300
N_ORACLE_GOALS = 4096
N_PLANS = 100
# the cartesian chain: the reference 7-D ranges with the counts cut to
# 8 x 6 x 6 x 9 x 4 x 3 x 3 = 93,312 rows (the defaults' steps give
# 8 x 18 x 18 x 63 x 8 x 7 x 13 = 106.5M rows; cart_c1's 2,437,120), made
# without its straggler pass, which patch_table_stragglers then runs; the
# cart_c1_pr recipe (docs/ARTIFACTS.md); 4 rows for eval_nmpc_oracle (its
# default is 200; host SLSQP takes ~3 s a row: 39 rows took 77-127 s on
# the H100 machines' hosts, 8 rows 26.1 s)
CART_TABLE_ARGS = ("--d_x_goal", "0.7", "--d_y_goal", "0.7", "--d_t_goal",
                   "0.775", "--d_v_goal", str(7.0 / 3.0), "--d_beta", "0.6",
                   "--d_angv_z", "3.0")
CART_FIT_ARGS = ("--direct_fit", "--fit_mode", "per_region", "--num_k",
                 "512", "--num_t_goal", "4", "--num_v_car", "2",
                 "--num_angv_z", "2")
N_ORACLE_ROWS = 4

# Tolerances, with their reasons:
# - the flagship head is ill-conditioned (sum |w| ~ 2e5 per output): an f32
#   forward differs from f64 by up to ~4e-4 whatever the summation order, so
#   two f32 paths, or an f32 path and the f64 JAX golden, agree to ~1e-3;
TOL_FLAGSHIP = 1e-3
# - well-conditioned random nets: f32 summation-order noise, relative to
#   the output's magnitude;
TOL_RANDOM = 1e-4
# - the closed loop is held against the JAX golden lane by lane. The same
#   lanes must finish (none leaves the 2 m corridor, by a wide margin). f32
#   differences grow along 600 steps of feedback in a few lanes: the port's
#   plain version on a CPU differed from the golden by 2 um median, 1.2 mm at
#   the 99th percentile and 3.2 mm at most in per-lane mean |ey|, by 1.5 m
#   at most in final progress, and by 0.001 mm in the sweep's mean |ey|.
#   Final progress sits within 1 cm of the second lap's line in the slowest
#   lane, so a lap count may flip there.
TOL_EY_LANE_MM = 10.0  # per-lane mean |ey|
TOL_EY_SWEEP_MM = 0.1  # mean |ey| over the 1000 lanes
TOL_LAP_LANES = 10  # lanes whose lap count may differ, by one lap
# - the ADMM kernel against its plain version, and the port against JAX's
#   f32 solve: the limits of tests/test_goal_mpc.py::
#   test_pallas_admm_matches_xla_loop (steer 1e-5, r_prim 5e-5, converged
#   flags identical), except the full control plan and with it the speed.
#   Two f32 ADMM paths differ in the plan by their products' summation
#   order, grown over the sweeps, and each is up to ~2.5e-4 from the f64
#   solution: phase 9 prints JAX's own f32 loop and the kernel against
#   JAX's f64 solve on the golden's 4,864 lattice rows (on a CPU, JAX's f32
#   loop and the port's plain version were 2.4e-4 from it), phase 7 the
#   plain f32 version against f64 arithmetic on a whole family. So two f32
#   plans agree to twice that, and speeds (v_car + dt a_0) to dt times it.
TOL_CONTROLS = 5e-4
TOL_SPEED = 0.05 * TOL_CONTROLS
TOL_STEER = 1e-5
TOL_RPRIM = 5e-5
# - converged flags (both residuals under 2e-3): identical, except in rows
#   whose plain-version residual lies within TOL_RES_BAND of 2e-3, where f32
#   noise decides. The residuals of two f32 paths differed by up to 8.0e-5
#   (r_dual, kernel vs plain, 4,097 goals at v_car = 8 on an H100 80GB HBM3,
#   700 W; port vs JAX f32 on a CPU: 7.9e-5), and at 300 sweeps ~7% of the
#   v_car = 8 rows are still near the limit: one of 4,097 flipped there.
TOL_RES_BAND = 2e-4
# - the f32 solve against JAX's f64 one: tests/test_goal_mpc.py::
#   test_goal_mpc_f32_close_to_f64;
TOL_F64 = 3e-3
# - the goal net (sum |w| ~ 6.5e3 per output) and both planner modes in f32
#   against JAX's f64: the port's plain f32 versions on a CPU were 1.5e-5
#   (forward) and 1.1e-5 (plan_batch) from the f64 goldens;
TOL_GOAL_NET = 1e-4
# - the goal-MPC closed loops against their JAX goldens. The PID steers
#   bang-bang at sv_max outside a 1e-4 steer deadband, so a small difference
#   in a planned steer can flip a substep's steering rate, and lanes spread
#   far more than in the accl loop. The port's plain versions on a CPU
#   (solver mode / net mode) differed from the goldens in per-lane mean |ey|
#   by 0.006 / 0.64 mm median, 22 / 41 mm at the 99th percentile and 45 /
#   61 mm at most, in the sweep's mean |ey| by 0.11 / 0.06 mm, and in final
#   progress by 2.0 / 3.0 m at most; every lane finished as in JAX, with the
#   same laps (two), none within 1 m of a lap line.
TOL_GOAL_EY_MEDIAN_MM = 5.0  # median over lanes of the per-lane difference
TOL_GOAL_EY_LANE_MM = 150.0  # any lane
TOL_GOAL_EY_SWEEP_MM = 0.5  # mean |ey| over the 1000 lanes
TOL_GOAL_LAP_LANES = 10
# - the net fitted on the card against the committed goal_mpc_pr (the same
#   recipe on the same lattice): its strided MAE may be at most 1.25x the
#   committed net's, and its closed loop's mean |ey| within 25% of it;
TOL_FIT_MAE_RATIO = 1.25
TOL_FIT_EY_RATIO = 0.25
# - the flagship's f32 loss on the card against JAX's f64 fixture, relative
#   (the port's f32 module path on a CPU was 2e-6 from it);
TOL_TRAIN_LOSS = 1e-3
# - its gradient norms, and the losses after Adam steps. The L1 loss's
#   gradient is sign(y_pred - y) / N pushed back through the net; an f32
#   output is up to ~4e-4 off (TOL_FLAGSHIP's reason) against target noise of
#   scale 0.05, so ~0.5% of the signs flip, and a first Adam step moves every
#   weight by +-lr whatever its gradient's size. The port's f32 module path
#   on a CPU was up to 1.3e-2 from the fixture in a gradient norm (the head
#   bias: 10 sums of 1,024 signs) and 1.2e-2 in a later step's loss.
TOL_TRAIN_GRAD = 5e-2
# - the NMPC solver in f64 against the JAX package's f64 solutions. Two f64
#   implementations of one iteration differ by rounding (~1e-15 in the
#   derivatives), which 125 Newton iterations amplify on marginal rows. On
#   the golden's 234 rows the port on a CPU was 2.1e-9 (median), 1.3e-7
#   (90th percentile) from JAX in a control, over 1e-6 on 3 rows (5.3e-4 at
#   most), with every feasible flag equal; on an H100 (other sin, cos and
#   atan2 than XLA's on a CPU) 2 rows were over 1e-6 and one such row's flag
#   differed. So: the tests' 1e-6, and equal flags outside a band of +-20%
#   around kkt_tol, on all but TOL_NMPC_OFF_ROWS of the rows, and the SLSQP
#   oracle at the thresholds of tests/test_nmpc_oracle.py;
TOL_NMPC_F64 = 1e-6
TOL_NMPC_OFF_ROWS = 0.03  # share of rows that may differ more
# such a row is one the iteration has not settled: both packages stop on it
# at slightly different points of the same descent (the port on a CPU: 3
# rows, up to 2.0e-3 apart in a state, 7.6e-6 apart in relative cost)
TOL_NMPC_OFF_COST = 1e-4
KKT_BAND = 0.2
# - NMPC in the loop at the golden's 10 x 2 budget: a solve cut that short
#   is not converged, so small differences flip some lanes to another
#   branch (the port in f64 on a CPU replaying the golden's observations:
#   median action error 5e-11 to 7e-10 per step, but up to 7.9 in single
#   lanes). Held by the median over lanes feasible in both: f64 1e-6; f32
#   5e-2 (measured 2e-5 to 1.1e-2), at the loop's first step, where both
#   start from the same state;
TOL_LOOP_F64_MEDIAN = 1e-6
TOL_LOOP_F32_MEDIAN = 5e-2
# - f32 against f64 solves of the same rows (the port on a CPU, 234 rows:
#   5 of 234 flags differ; on rows feasible in both the control difference
#   was 1.0e-4 at the median and 3.1e-3 at the 90th percentile): flags may
#   differ on 5% of rows, control difference p50 2e-3 and p90 5e-2 (of a
#   9.51 m/s^2, 3.14 rad/s box), relative objective gap p50 1e-5, p90 1e-3;
#   both shares feasible within 3 points of each other;
# - the flagship recipe's own L1 is a strided probe of at most 65,536 of
#   the mirrored table's rows; eval_offline reads every row. On a table of
#   201,968 mirrored rows they were 0.5% apart (equal to the digits printed
#   where the probe is the whole table); the fitted head is as
#   ill-conditioned as the committed flagship's, so its kernel forward is
#   held to the module path at TOL_FLAGSHIP (measured 4.4e-4);
TOL_FIT_PROBE = 2e-2
# - the grip-adaptive bank against its JAX golden. The observer divides the
#   measured lateral change (a difference of two f32 states over 0.1 s) by
#   a tire prediction that may be as small as its 0.5 rad/s^2 gate, so f32
#   rounding moves a lane's g estimate, and a lane whose g lies near the
#   midpoint of two arms' mus switches arm one step earlier or later: from
#   there the lane drives another net. The port's plain version on a CPU
#   matched the golden's arm in 84.8% of the lane-steps (99% over the first
#   60 steps; 389 lanes differ somewhere, each first where its g lay within
#   0.007 (median) of a midpoint), 4 lanes' done flags and 38 lanes' laps
#   differed, per-lane mean |ey| by 0.39 mm (median) and 139 mm at most,
#   the sweep's mean |ey| by 0.11 mm, the final g by 7.7e-5 (median) and
#   0.28 (90th percentile). The JAX package against itself, its start
#   states nudged by 1e-6 (relative): 83.5% of lane-steps on the same arm,
#   402 lanes differ somewhere, 3 done flags and 43 laps, per-lane mean |ey|
#   up to 410 mm, the sweep's by 0.84 mm, final g 1.4e-4 / 0.27
#   (``scripts/export_torch_ckpt.py --bank_golden --nudge 1e-6``). In f64
#   the two packages drive the same arms (tests/test_torch_grip.py), so
#   these bound f32 noise:
TOL_BANK_ARM_SHARE = 0.75  # lane-steps whose arm matches, at least
TOL_BANK_ARM_SHARE_EARLY = 0.97  # the same over the first 60 steps
TOL_BANK_DONE_LANES = 10
TOL_BANK_LAP_LANES = 80
TOL_BANK_EY_MEDIAN_MM = 5.0
TOL_BANK_EY_SWEEP_MM = 2.0
TOL_BANK_G_MEDIAN = 1e-3  # median over lanes of the final g's difference
# - the cartesian planner's f32 plan against the JAX f64 golden (the port's
#   plain f32 version on a CPU: 7.8e-5 in a control) and its closed loop
#   against the JAX f32 golden: 311 of the 1000 lanes leave the corridor,
#   and a lane that leaves it near the end does so a step earlier or later
#   (the port's plain version on a CPU: 1 lane's done flag and no lap
#   differed; per-lane mean |ey| 0.74 um median, 14 mm at the 99th
#   percentile, 67 mm at most; the sweep's mean |ey| 0.046 mm);
TOL_CART_PLAN = 1e-3
TOL_CART_DONE_LANES = 10
TOL_CART_EY_MEDIAN_MM = 5.0
TOL_CART_EY_SWEEP_MM = 0.5
# - f32 rays against JAX's f32 rays: a ray grazing a wall has not converged
#   after 64 sphere-tracing steps, and each step's f32 rounding moves where
#   it stops (tests/test_torch_map.py: 11 of 8,192 rays over 1e-4 m, 5.1 mm
#   at most); the Frenet loop in the map world is held as phase 5's (the
#   port's plain version on a CPU: per-lane 3.2 mm at most, sweep 0.0009
#   mm, the same done flags and laps);
TOL_RAYS = 1e-4  # 99% of the rays
TOL_RAYS_ANY = 1e-2  # every ray
# - the Oschersleben loops (27 lanes) against the JAX golden, the steps
#   whose lookahead reads a seam row masked:
#   the port's plain versions on a CPU (flagship / goal-MPC solver) left
#   the same lanes done with the same laps, per-lane mean |ey| 0.025 / 0.060
#   mm (median), 2.5 / 5.7 mm at most;
# the clothoid chain:
# - the f32 G1 solve against the JAX package's f64 on the golden's 65,536
#   goals: on a CPU the port's f32 was 2.5e-7, 1.0e-7 and 7.2e-6 from it (k0,
#   dk, length; JAX's own f32 2.7e-7, 1.2e-7 and 8.4e-6);
# - the LUT entries' endpoint miss (f64 quadrature of the f32 params): the
#   JAX package's f32 entries miss by up to 1.4e-5 m and 1.6e-6 rad on the
#   golden's goals, the port's f32 LUT on a CPU by up to 1.6e-5 m and 1.9e-6
#   rad over all 6,384,938 goals: the f32 bound is 5e-5 m and 5e-6 rad (in
#   f64 every entry is under 1e-6, tests/test_solvers.py);
# - clothoid_pr's forward: the length head has sum |w| 5.0e5 per output, so
#   an f32 forward is up to ~1e-3 from f64 (measured on a CPU: 9.1e-4 on the
#   length, 1.0e-4 on k3);
# - the lattice planner in f32: the CPU test's tolerances;
# - the cheap pass's certified share against the JAX package's on the
#   312-row sample: the JAX package against itself (its iteration written
#   as a Python loop) differs on 2.9% of those rows.
TOL_CLOTHOID_SOL = {"k0": 1e-6, "dk": 5e-7, "length": 3e-5}
TOL_CLOTHOID_ORACLE = 1e-8  # rtol, f64 oracle against JAX f64
TOL_LUT_MISS_M = 5e-5
TOL_LUT_MISS_RAD = 5e-6
TOL_CLOTHOID_FORWARD = 5e-3
TOL_PLAN = dict(rtol=1e-3, atol=2e-3)
TOL_CHEAP_SHARE = 0.03
TOL_OSCH_DONE_LANES = 3
TOL_OSCH_EY_MEDIAN_MM = 5.0
TOL_OSCH_EY_LANE_MM = 50.0
TOL_F32_FLAGS = 0.05
TOL_F32_DU = (2e-3, 5e-2)
TOL_F32_GAP = (1e-5, 1e-3)
TOL_F32_FEASIBLE = 0.03


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


CARD = []  # nvidia-smi's "name, power.limit", printed again at the end


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    CARD.append(smi.stdout.strip())
    print(CARD[-1], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def ptxas_summary(log: str) -> str:
    """``ptxas -v``'s registers and spills, one entry per kernel of the
    library: ``name<template arguments>: registers, spilled bytes``."""
    out, name = [], "?"
    spill = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:  # _ZN..._GLOBAL__N__...<len>name<args>...: keep name and args
            name = m.group(1)
            k = re.search(r"\d+((?:rbf|admm)\w*?kernel\w*?)I(\w+?)EEv", name)
            name = (f"{k.group(1)}<"
                    f"{', '.join(re.findall(r'Li(\d+)E', k.group(2)))}>"
                    if k else re.sub(
                        r"^.*?\d+((?:rbf|admm|fma)_[a-z_]*kernel)E.*",
                        r"\1", name))
        elif "spill" in line:
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            spill = f"spills {s.group(1)}+{s.group(2)} B" if s else line
        elif "registers" in line:
            r = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {r.group(1) if r else '?'} registers, "
                       f"{spill}")
    return "; ".join(out)


def phase_build():
    """Both kernels' nvcc processes and the native module's g++, started
    together; registers and spills of every kernel, which must be none."""
    from irbfn_tpu_torch import native
    from irbfn_tpu_torch.ops import KERNELS as OPS, build_kernel
    from irbfn_tpu_torch.ops import fma_ceiling

    def timed_native():
        t0 = time.perf_counter()
        return native.build(), time.perf_counter() - t0

    with ThreadPoolExecutor(len(OPS) + 2) as pool:
        lib = pool.submit(timed_native)
        probe = pool.submit(fma_ceiling.build_kernel)
        results = dict(zip(OPS, pool.map(build_kernel, OPS)))
        lib_path, lib_s = lib.result()
        results["fma_ceiling"] = probe.result()
    print(f"build native module: {lib_path.name} in {lib_s:.2f} s (g++, the "
          f"port's copies of clothoid_oracle.cpp, table_io.cpp, edt.cpp)",
          flush=True)
    for name, res in results.items():
        what = (" (a measuring probe of phase 46, not a TPU kernel's "
                "counterpart)" if name == "fma_ceiling" else "")
        print(f"build {name}{what}: {res.path.name} in {res.seconds:.2f} s "
              f"nvcc{' (already built)' if res.seconds == 0.0 else ''}; "
              f"{ptxas_summary(res.log)}", flush=True)
        spilled = [int(n) for n in re.findall(r"(\d+) bytes spill", res.log)]
        check(not any(spilled), f"{name} spills registers: {res.log}")


# the port's counters when ``reset_launches`` last ran
_LAUNCHES_FROM = {}


def _launch_counts() -> dict:
    from irbfn_tpu_torch.utils import spans

    c = spans.counters()
    return {"rbf_forward": c.get("ops.rbf.forwards", 0),
            "admm_solve": c.get("ops.admm.family", 0)
            + c.get("ops.admm.lane", 0)}


def reset_launches():
    _LAUNCHES_FROM.clear()
    _LAUNCHES_FROM.update(_launch_counts())


def read_launches() -> dict:
    """The kernels' launches (the RBF kernel's forwards) since
    ``reset_launches``."""
    now = _launch_counts()
    return {k: v - _LAUNCHES_FROM.get(k, 0) for k, v in now.items()}


def newton_iterations() -> int:
    """The NMPC solver's Newton iterations on this process so far."""
    from irbfn_tpu_torch.utils import spans

    return spans.counters().get("nmpc.newton_iterations", 0)


def _flagship(device):
    import torch

    from irbfn_tpu_torch.train import load_model

    model, config = load_model(ASSET + ".json", ASSET + ".npz",
                               device=device, dtype=torch.float32)
    return model.eval(), config


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _compare(label, x, ops, tol, relative=False):
    """Kernel vs the plain version on the same card tensors; ``relative``
    divides the error by max(1, max|plain|)."""
    import torch

    from irbfn_tpu_torch.ops import rbf

    with torch.no_grad():
        ref = rbf.wcrbf_forward_reference(x, ops)
        got = rbf.wcrbf_forward(x, ops)
    torch.cuda.synchronize()
    err = _max_err(got, ref)
    if relative:
        err /= max(1.0, float(ref.abs().max()))
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"{label}: kernel vs plain {'rel ' if relative else ''}max|err| "
          f"{err:.3e} > {tol:.1e}")
    return err


def _random_net(rng, device, R, K, F, O, basis, head_mode):
    """A WCRBFNet with numpy-drawn weights and an anisotropic input scale;
    its R <= 2**n regions are the first R boxes of the first n even dims
    split at 0."""
    import torch

    from irbfn_tpu_torch.models import WCRBFNet

    n = (R - 1).bit_length()
    act = [2 * i for i in range(n)]
    ranges = [[(r >> i) & 1 for i in range(n)] for r in range(R)]
    model = WCRBFNet(F, O, K, basis, R, [[-3.0, 0.0]] * n, [[0.0, 3.0]] * n,
                     ranges, act, [10.0] * n,
                     input_scale=tuple(rng.uniform(0.5, 2.0, F)),
                     head_mode=head_mode, device=device)
    n_feat = model.head_kernel.shape[0]
    state = {"centers": rng.normal(0.0, 1.5, (R, K, F)),
             "log_sigs": rng.uniform(-0.5, 0.5, (R, K)),
             "head_kernel": rng.normal(0.0, n_feat ** -0.5, (n_feat, O)),
             "head_bias": rng.normal(0.0, 0.1, (O,))}
    model.load_state_dict({k: torch.tensor(v, dtype=torch.float32)
                           for k, v in state.items()})
    return model.eval()


def _random_x(rng, net, B, device):
    import torch

    x = torch.as_tensor(rng.normal(0.0, 1.5, (B, net.in_features)),
                        dtype=torch.float32, device=device)
    return (x * net.input_scale).contiguous()


def phase_kernel_vs_plain(device, golden):
    import torch

    from irbfn_tpu_torch.models import BASIS_FUNCTIONS
    from irbfn_tpu_torch.ops import wcrbf_forward, wcrbf_params_to_kernel

    rng = np.random.default_rng(0)
    model, config = _flagship(device)
    ops = wcrbf_params_to_kernel(model)
    x = torch.as_tensor(golden["x"], device=device) * model.input_scale
    errs = {}
    for B in (1, 7, 31, 32, 33, 1000, 1024):
        errs[B] = _compare(f"flagship B={B}", x[:B].contiguous(), ops,
                           TOL_FLAGSHIP)
    errs[4096] = _compare("flagship B=4096", x.repeat(4, 1), ops,
                          TOL_FLAGSHIP)
    with torch.no_grad():  # the same bits on every call
        twice = [wcrbf_forward(x, ops) for _ in range(2)]
    check(torch.equal(*twice), "two flagship forwards of one input differ")
    shared = _random_net(rng, device, 16, 512, 8, 10, "gaussian", "shared")
    e_shared = _compare("shared head R=16 K=512",
                        _random_x(rng, shared, 1024, device),
                        wcrbf_params_to_kernel(shared), TOL_RANDOM,
                        relative=True)
    e_basis = 0.0  # every basis, both head modes, a ragged batch of 65
    for name in BASIS_FUNCTIONS:
        for mode in ("shared", "per_region"):
            net = _random_net(rng, device, 4, 32, 8, 10, name, mode)
            e_basis = max(e_basis, _compare(
                f"basis {name} {mode}", _random_x(rng, net, 65, device),
                wcrbf_params_to_kernel(net), TOL_RANDOM, relative=True))
    # off the kernel's tiles: K no multiple of 32, O over one output chunk,
    # F over 8, one region, and a region count no group size divides
    e_shapes = {}
    for R, K, F, O, B in ((4, 100, 8, 10, 65), (4, 64, 8, 17, 65),
                          (4, 64, 16, 10, 65), (1, 128, 8, 3, 65),
                          (5, 100, 5, 17, 4096), (5, 64, 12, 2, 300)):
        for mode in ("shared", "per_region"):
            net = _random_net(rng, device, R, K, F, O, "gaussian", mode)
            e = _compare(f"R={R} K={K} F={F} O={O} B={B} {mode}",
                         _random_x(rng, net, B, device),
                         wcrbf_params_to_kernel(net), TOL_RANDOM,
                         relative=True)
            e_shapes[R, K, F, O, B] = max(e, e_shapes.get((R, K, F, O, B),
                                                          0.0))
    e_cancel = phase_cancellation(device)
    print("kernel vs plain: flagship max|err| "
          + ", ".join(f"B={b} {e:.2e}" for b, e in errs.items())
          + f" (tol {TOL_FLAGSHIP}), two forwards bitwise equal; shared head "
          f"R=16 K=512 rel {e_shared:.2e}; 15 bases x 2 heads rel "
          f"{e_basis:.2e}; (R, K, F, O, B) x 2 heads rel "
          + ", ".join(f"{k} {e:.2e}" for k, e in e_shapes.items())
          + f" (tol {TOL_RANDOM}); cancellation regime vs f64 rel "
          f"{e_cancel:.2e} (tol 2e-4)", flush=True)
    return model, config, errs[1024]


def phase_cancellation(device):
    """Distances on data with a large offset mean (||x|| >> ||x - c||), the
    regime of tests/test_pallas_rbf.py::test_distance_cancellation_regime:
    the kernel must stay within 2e-4 relative of an f64 reference."""
    import torch

    from irbfn_tpu_torch.models import WCRBFNet
    from irbfn_tpu_torch.ops import wcrbf_forward, wcrbf_params_to_kernel

    rng = np.random.default_rng(7)
    R, K, F, B = 2, 16, 8, 64
    mean = 100.0 * rng.normal(size=(F,))
    c = (mean[None, None] + 0.1 * rng.normal(size=(R, K, F))).astype(
        np.float32)
    x = (mean[None] + 0.1 * rng.normal(size=(B, F))).astype(np.float32)
    d_ref = np.sqrt(((x.astype(np.float64)[:, None, None]
                      - c.astype(np.float64)[None]) ** 2).sum(-1))
    gref = np.exp(-d_ref ** 2).sum(1)
    model = WCRBFNet(F, K, K, "gaussian", R, [[-1e30]], [[1e30]], [[0], [0]],
                     [0], [1.0], device=device)
    model.load_state_dict({
        "centers": torch.from_numpy(c), "log_sigs": torch.zeros(R, K),
        "head_kernel": torch.eye(K), "head_bias": torch.zeros(K)})
    with torch.no_grad():
        out = wcrbf_forward(torch.from_numpy(x).to(device),
                            wcrbf_params_to_kernel(model))
    torch.cuda.synchronize()
    rel = np.abs(out.cpu().numpy() - gref) / np.maximum(np.abs(gref), 5e-3)
    check(float(rel.max()) <= 2e-4,
          f"cancellation regime: rel err {rel.max():.3e} > 2e-4")
    return float(rel.max())


def phase_against_jax(device, model, config, golden):
    import torch

    from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
    from irbfn_tpu_torch.sim import oval_track
    from irbfn_tpu_torch.train import input_bounds_from_config

    x = torch.as_tensor(golden["x"], device=device)
    with torch.no_grad():
        out = model(x)
    e_fwd = _max_err(out.cpu(), torch.from_numpy(golden["forward_f64"]))
    check(e_fwd <= TOL_FLAGSHIP, f"forward vs JAX f64: {e_fwd:.3e}")
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    planner = IRBFNFrenetPlanner(model, track,
                                 input_bounds=input_bounds_from_config(config))
    res = planner.plan_batch(*torch.as_tensor(golden["plan_in"],
                                              device=device).T)
    e_plan = {k: _max_err(v.cpu(), torch.from_numpy(golden[f"plan_{k}"]))
              for k, v in res._asdict().items()}
    bad = {k: e for k, e in e_plan.items() if not e <= TOL_FLAGSHIP}
    check(not bad, f"plan_batch vs JAX f64: {bad}")
    n_m = int((golden["plan_in"][:, 1] < -0.05).sum())
    print(f"against JAX (f64 goldens, tol {TOL_FLAGSHIP}): forward max|err| "
          f"{e_fwd:.2e}; plan_batch ({n_m} of {len(golden['plan_in'])} rows "
          "mirrored) " + ", ".join(f"{k} {e:.2e}" for k, e in e_plan.items()),
          flush=True)
    return track, planner


def _drive(env, sim, policy, kernel, steps=N_STEPS, per_step=1):
    """One closed loop of ``steps`` with the launch counts set to 0 just
    before and read just after; the path's kernel must have launched
    ``per_step`` times per control step (0: a net the kernel does not
    serve). Returns (final, traj, launches, seconds)."""
    import torch

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    final, traj = env.rollout(sim, policy, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches[kernel] == per_step * steps,
          f"{kernel} launches {launches[kernel]} != {per_step} x control "
          f"steps {steps}")
    check(bool(torch.isfinite(traj.obs.ey).all()), "NaN in the closed loop")
    return final, traj, launches, wall


def phase_closed_loop(device, planner, golden):
    import torch

    from irbfn_tpu_torch.sim import deviation_metrics
    from irbfn_tpu_torch.utils.profiling import sweep_env

    env, sim = sweep_env(device, "accl", golden)
    B = sim.s.numel()

    def policy(obs):
        r = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                               obs.linear_vel_x, obs.linear_vel_y,
                               obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    final, traj, launches, wall = _drive(env, sim, policy, "rbf_forward")
    ey_mean, _ = deviation_metrics(traj)
    ey = ey_mean.cpu().numpy()
    done = final.done.cpu().numpy()
    laps = final.laps.cpu().numpy()
    done_ref = golden["loop_done"]
    d_ey_mm = 1e3 * np.abs(ey - golden["loop_ey_mean"])
    n_done_diff = int((done != done_ref).sum())
    n_lap_diff = int((laps != golden["loop_laps"]).sum())
    d_sweep_mm = 1e3 * abs(float(ey.mean())
                           - float(golden["loop_ey_mean"].mean()))
    print(f"Frenet closed loop: {int((~done).sum())}/{B} lanes completed "
          f"(JAX {int((~done_ref).sum())}), laps>=1 {int((laps >= 1).sum())}"
          f"; mean|ey| {ey.mean():.4f} m (JAX {golden['loop_ey_mean'].mean():.4f}"
          f"), sweep diff {d_sweep_mm:.4f} mm, per-lane max diff "
          f"{d_ey_mm.max():.2f} mm, {n_lap_diff} lanes' "
          f"laps differ; {N_STEPS} steps in "
          f"{wall:.2f} s = {N_STEPS / wall:.1f} control steps/s "
          f"({B * N_STEPS / wall:.0f} lane-steps/s); kernel launches "
          f"{launches}", flush=True)
    check(n_done_diff == 0, f"{n_done_diff} lanes differ from JAX in done")
    check(n_lap_diff <= TOL_LAP_LANES and int(np.abs(
        laps - golden["loop_laps"]).max()) <= 1,
        f"{n_lap_diff} lanes differ from JAX in laps")
    check(float(d_ey_mm.max()) <= TOL_EY_LANE_MM,
          f"per-lane mean|ey| differs from JAX by {d_ey_mm.max():.2f} mm")
    check(d_sweep_mm <= TOL_EY_SWEEP_MM,
          f"sweep mean|ey| differs from JAX by {d_sweep_mm:.4f} mm")
    return launches["rbf_forward"], dict(done=int((~done).sum()),
                                         ey=float(ey.mean()))


def _time_ms(fn, iters=200, warmup=20):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _in_turns(plain, kernel, iters=200, warmup=20):
    """Plain, kernel, kernel, plain; mean ms of each and the runs."""
    t = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        t[name].append(_time_ms(plain if name == "plain" else kernel,
                                iters, warmup))
    return {k: float(np.mean(v)) for k, v in t.items()}, t


def _rbf_flops(B, ops) -> float:
    """Operations of one forward: per (row, region, kernel) a difference
    and an FMA per feature, the root, the width, the basis (~3) and the
    gate weight; then per-region heads an FMA per output there, while a
    shared head sums the gated basis over the regions (an FMA) and takes
    one product per (row, kernel, output), since sum_r g_r phi_r W =
    (sum_r g_r phi_r) W; per (row, region) the gate's 8 per feature."""
    R, K, F = ops.centers.shape
    O = ops.w.shape[-1]
    gate = B * R * F * 8
    if ops.per_region:
        return float(B * R * K * (3 * F + 6 + 2 * O) + gate)
    return float(B * R * K * (3 * F + 6 + 2) + 2 * B * K * O + gate)


def _bound(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_times(device, model, golden):
    """The flagship forward at B=1024 and B=1, kernel vs plain, timed in
    turns, and what an empty launch costs (the floor under a forward, which
    is two launches)."""
    import torch

    from irbfn_tpu_torch.ops import rbf

    ops = rbf.wcrbf_params_to_kernel(model)
    x = (torch.as_tensor(golden["x"], device=device)
         * model.input_scale).contiguous()
    x1 = x[:1].contiguous()
    with torch.no_grad():
        ms, t = _in_turns(lambda: rbf.wcrbf_forward_reference(x, ops),
                          lambda: rbf.wcrbf_forward(x, ops))
        ms1, t1 = _in_turns(lambda: rbf.wcrbf_forward_reference(x1, ops),
                            lambda: rbf.wcrbf_forward(x1, ops))
    floor = [_time_ms(rbf.empty_launch, iters=1000) for _ in range(2)]
    nbytes = 4 * (sum(o.numel() for o in ops[:7]) + x.numel()
                  + x.shape[0] * ops.w.shape[-1])
    bound_ms, bound_by = _bound(_rbf_flops(x.shape[0], ops), nbytes)
    print(f"times, flagship forward (CUDA events, mean of 2 x 200 calls): "
          f"B=1024 kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms"
          f" (runs {t['kernel']} / {t['plain']}), bound {bound_ms:.4f} ms "
          f"by {bound_by}; B=1 kernel {ms1['kernel']:.4f} ms, plain "
          f"{ms1['plain']:.4f} ms (runs {t1['kernel']} / {t1['plain']}); "
          f"an empty launch {min(floor):.5f} ms (runs {floor}), a forward is "
          "two launches", flush=True)
    return dict(ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


# ------------------------------------------------------------- goal-MPC path

def _admm_operands(v_car, goals):
    """The ADMM operands of v_car (F,) and goals (F, G, 4) on their device:
    (q, A, kinv, lo, hi, rho), contiguous."""
    from irbfn_tpu_torch.solvers import goal_mpc

    fam, rho, kinv, q = goal_mpc._family_operands(
        v_car, goals, goal_mpc.GoalMPCConfig(), 1e-6)
    return tuple(t.contiguous() for t in (q, fam.A_con, kinv, fam.lo,
                                          fam.hi, rho))


def _admm_errors(ops, iters, fn_a, fn_b):
    """Run two ADMM versions on the same operands; per-quantity max |err|
    (speed = a_0 dt, steer, controls, r_prim, r_dual) and the converged
    flags that differ, with the per-row control errors."""
    import torch

    xa, pa, da = fn_a(*ops, iters=iters)
    xb, pb, db = fn_b(*ops, iters=iters)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(xa).all() & torch.isfinite(pa).all()),
          "non-finite ADMM output")
    row_err = (xa.double() - xb.double()).abs().amax(-1)  # (F, G)
    err = {"speed": 0.05 * float((xa[..., 0].double()
                                  - xb[..., 0].double()).abs().max()),
           "steer": float((xa[..., 1].double()
                           - xb[..., 1].double()).abs().max()),
           "controls": float(row_err.max()),
           "r_prim": float((pa.double() - pb.double()).abs().max()),
           "r_dual": float((da.double() - db.double()).abs().max())}
    conv_a = (pa < 2e-3) & (da < 2e-3)
    conv_b = (pb < 2e-3) & (db < 2e-3)
    return (err, _flips(conv_a, conv_b, torch.maximum(pb, db)), row_err,
            conv_a)


def _flips(conv, conv_ref, res_ref):
    """(converged flags that differ, those outside the noise band around
    the 2e-3 tolerance of the reference's residual)."""
    diff = conv != conv_ref
    near = (res_ref - 2e-3).abs() <= TOL_RES_BAND
    return int(diff.sum()), int((diff & ~near).sum())


def _plain_f64(*ops, iters):
    """The plain ADMM in f64 arithmetic, its outputs rounded to f32."""
    from irbfn_tpu_torch.ops import admm

    return tuple(t.float() for t in admm.admm_solve_reference(
        *(o.double() for o in ops), iters=iters))


def _check_admm(label, err, flips):
    check(err["speed"] <= TOL_SPEED and err["steer"] <= TOL_STEER
          and err["controls"] <= TOL_CONTROLS and err["r_prim"] <= TOL_RPRIM
          and flips[1] == 0,
          f"{label}: kernel vs plain {err}; converged flags differ in "
          f"{flips[0]} rows, {flips[1]} of them outside the noise band")


def _lattice_goals():
    """The reference lattice's goal block (G, 4), solver order (x, y, v, t),
    and its v_car values."""
    from irbfn_tpu_torch.parallel import build_lattice
    from irbfn_tpu_torch.parallel import gen_goal_mpc_table as gen

    grid = gen.grid_from_args(gen.parse_args(list(LATTICE_ARGS)))
    goals_raw = build_lattice(grid[1:])
    return goals_raw[:, [0, 1, 3, 2]].copy(), grid[0].values()


def phase_admm_vs_plain(device, lattice_goals):
    import torch

    from irbfn_tpu_torch.ops import admm

    rng = np.random.default_rng(1)
    worst, n_flips = {}, 0
    for v in (-1.0, 4.5, 8.0):  # (i) one family, ragged and tiny G
        for G in (1, 7, 96, 4097):
            goals = np.stack([rng.uniform(-1.2, 4.0, G),
                              rng.uniform(0.0, 4.0, G),
                              rng.uniform(-1.0, 8.0, G),
                              rng.uniform(-3.14, 3.14, G)], axis=1)
            ops = _admm_operands(
                torch.tensor([v], device=device),
                torch.as_tensor(goals[None], dtype=torch.float32,
                                device=device))
            for iters in (300, 600):
                err, flips, _, _ = _admm_errors(ops, iters, admm.admm_solve,
                                                admm.admm_solve_reference)
                _check_admm(f"v={v} G={G} iters={iters}", err, flips)
                worst = {k: max(e, worst.get(k, 0.0)) for k, e in err.items()}
                n_flips += flips[0]
    print("ADMM kernel vs plain, one family, v_car {-1, 4.5, 8} x G {1, 7, "
          "96, 4097} x {300, 600} sweeps: max|err| "
          + ", ".join(f"{k} {e:.2e}" for k, e in worst.items())
          + f"; {n_flips} converged flags differ, all within "
          f"{TOL_RES_BAND} of the tolerance (tol speed {TOL_SPEED}, steer "
          f"{TOL_STEER}, controls {TOL_CONTROLS}, r_prim {TOL_RPRIM})",
          flush=True)

    # (ii) two whole reference families, row by row
    g = torch.as_tensor(lattice_goals, device=device)
    fam_err = 0.0
    for v in (-1.0, 8.0):
        ops = _admm_operands(torch.tensor([v], device=device), g[None])
        err, flips, row_err, conv = _admm_errors(
            ops, 600, admm.admm_solve, admm.admm_solve_reference)
        p999 = float(torch.quantile(row_err[0, ::7].float(), 0.999))
        print(f"ADMM kernel vs plain, whole family v_car={v:+.1f} "
              f"({g.shape[0]:,} goals, 600 sweeps): max|err| "
              + ", ".join(f"{k} {e:.2e}" for k, e in err.items())
              + f"; controls p99.9 {p999:.2e} (every 7th row); {flips[0]} "
              f"converged flags differ ({flips[1]} outside the noise band);"
              f" kernel converged {float(conv.double().mean()):.6f}",
              flush=True)
        _check_admm(f"family v_car={v}", err, flips)
        fam_err = max(fam_err, err["controls"])
        if v == 8.0:  # the yardstick of TOL_CONTROLS: plain f32 vs f64
            e64, _, _, _ = _admm_errors(ops, 600, admm.admm_solve_reference,
                                        _plain_f64)
            print("  plain f32 vs plain f64 on the same operands: max|err| "
                  + ", ".join(f"{k} {e:.2e}" for k, e in e64.items()),
                  flush=True)
        del ops

    # (iii) the planner's shape, 1000 one-goal families, and shapes on both
    # sides of the variant rule: few rows, a ragged last block of the family
    # variant, several families in one family-variant launch
    per_block = admm.FAMILY_BLOCK_ROWS
    shapes = ((1000, 1), (19, 1000), (3, 33), (1, 1),
              (1, admm.FAMILY_MIN_ROWS + per_block // 2 + 23),
              (3, admm.FAMILY_MIN_ROWS // 2 + 5))
    check({admm.admm_variant(*fg) for fg in shapes} == set(admm.VARIANTS)
          and admm.admm_variant(*shapes[4]) == "family"
          and shapes[4][1] % per_block, "the shapes miss a variant")
    lines = []
    for F, G in shapes:
        goals = np.stack([rng.uniform(-1.2, 4.0, F * G),
                          rng.uniform(0.0, 4.0, F * G),
                          rng.uniform(-1.0, 8.0, F * G),
                          rng.uniform(-3.14, 3.14, F * G)], axis=1)
        ops = _admm_operands(
            torch.as_tensor(rng.uniform(-1.0, 8.0, F), dtype=torch.float32,
                            device=device),
            torch.as_tensor(goals.reshape(F, G, 4), dtype=torch.float32,
                            device=device))
        err, flips, _, _ = _admm_errors(ops, 600, admm.admm_solve,
                                        admm.admm_solve_reference)
        _check_admm(f"F={F} G={G}", err, flips)
        twice = [admm.admm_solve(*ops, iters=600) for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*twice)),
              f"two ADMM solves of one input differ at F={F} G={G}")
        lines.append(f"({F}, {G}) {admm.admm_variant(F, G)} controls "
                     f"{err['controls']:.2e} r_prim {err['r_prim']:.2e} "
                     f"r_dual {err['r_dual']:.2e}")
    print("ADMM kernel vs plain, (F, G) across the variant rule, 600 sweeps, "
          "max|err|: " + "; ".join(lines) + "; two solves of each bitwise "
          "equal", flush=True)
    return fam_err


def phase_goal_net(device, golden):
    """The RBF kernel at the goal net's width (F=5, O=2)."""
    import torch

    from irbfn_tpu_torch.ops import wcrbf_params_to_kernel
    from irbfn_tpu_torch.train import load_model

    model, config = load_model(GOAL_ASSET + ".json", GOAL_ASSET + ".npz",
                               device=device)
    model.eval()
    ops = wcrbf_params_to_kernel(model)
    x = torch.as_tensor(golden["net_x"], device=device)
    xs = (x * model.input_scale).contiguous()
    errs = {B: _compare(f"goal net B={B}", xs[:B].contiguous(), ops,
                        TOL_GOAL_NET) for B in (1, 7, 1000, 1024)}
    with torch.no_grad():
        out = model(x)
    e64 = _max_err(out.cpu(), torch.from_numpy(golden["net_forward_f64"]))
    check(e64 <= TOL_GOAL_NET, f"goal net vs JAX f64: {e64:.3e}")
    print("RBF kernel at the goal net's width (R=16, K=512, F=5, O=2): "
          "vs plain max|err| " + ", ".join(f"B={b} {e:.2e}"
                                           for b, e in errs.items())
          + f"; forward vs JAX f64 {e64:.2e} (tol {TOL_GOAL_NET})",
          flush=True)
    return model


def phase_goal_against_jax(device, golden, net):
    import torch

    from irbfn_tpu_torch.planning import GoalMPCPlanner
    from irbfn_tpu_torch.sim import oval_track
    from irbfn_tpu_torch.solvers import solve_goal_family

    sols = [solve_goal_family(float(v), torch.as_tensor(g, device=device),
                              iters=600)
            for v, g in zip(golden["lat_v"], golden["lat_goals"])]
    port = {k: torch.stack([getattr(s, k) for s in sols]).cpu().numpy()
            for k in sols[0]._fields}
    e = {(k, d): float(np.abs(port[k].astype(np.float64)
                              - golden[f"lat_{k}_{d}"]).max())
         for k in ("speed", "steer", "controls", "r_prim", "r_dual")
         for d in ("f32", "f64")}
    flips = {d: _flips(torch.from_numpy(port["converged"]),
                       torch.from_numpy(golden[f"lat_converged_{d}"]),
                       torch.from_numpy(np.maximum(golden[f"lat_r_prim_{d}"],
                                                   golden[f"lat_r_dual_{d}"])))
             for d in ("f32", "f64")}
    jax32 = float(np.abs(golden["lat_controls_f32"].astype(np.float64)
                         - golden["lat_controls_f64"]).max())
    print(f"goal-MPC vs JAX, {port['speed'].size} lattice rows x 600 sweeps "
          "through the kernel: vs f64 speed "
          f"{e['speed', 'f64']:.2e} steer {e['steer', 'f64']:.2e} (tol "
          f"{TOL_F64}) controls {e['controls', 'f64']:.2e} (JAX's own f32 "
          f"loop: {jax32:.2e}); vs f32 speed {e['speed', 'f32']:.2e} steer "
          f"{e['steer', 'f32']:.2e} controls {e['controls', 'f32']:.2e} "
          f"r_prim {e['r_prim', 'f32']:.2e} r_dual {e['r_dual', 'f32']:.2e}; "
          f"converged flags differing from JAX f32/f64 {flips['f32'][0]}/"
          f"{flips['f64'][0]} ({flips['f32'][1]}/{flips['f64'][1]} outside "
          f"the noise band); converged {port['converged'].mean():.4f}",
          flush=True)
    check(e["speed", "f64"] <= TOL_F64 and e["steer", "f64"] <= TOL_F64,
          "lattice rows vs JAX f64")
    check(e["speed", "f32"] <= TOL_SPEED and e["steer", "f32"] <= TOL_STEER
          and e["controls", "f32"] <= TOL_CONTROLS
          and e["r_prim", "f32"] <= TOL_RPRIM and flips["f32"][1] == 0,
          "lattice rows vs JAX f32")

    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    pose = torch.as_tensor(golden["plan_pose"], dtype=torch.float32,
                           device=device)
    line = []
    for mode, planner in (("solver", GoalMPCPlanner(track)),
                          ("net", GoalMPCPlanner(track, net))):
        out = planner.plan_batch(*pose.T)
        for k, v in zip(("speed", "steer"), out):
            err = _max_err(v.cpu(), torch.from_numpy(
                golden[f"plan_{mode}_{k}_f64"]))
            check(err <= TOL_GOAL_NET, f"{mode} plan_batch {k} vs JAX f64: "
                                       f"{err:.3e}")
            line.append(f"{mode} {k} {err:.2e}")
    print(f"GoalMPCPlanner.plan_batch vs JAX f64 on {pose.shape[0]} poses "
          f"(tol {TOL_GOAL_NET}): " + ", ".join(line), flush=True)


def phase_lattice(device):
    """The whole reference lattice through the table generator's solve."""
    import torch

    from irbfn_tpu_torch.parallel import gen_goal_mpc_table as gen

    args = gen.parse_args(list(LATTICE_ARGS) + ["--device", str(device)])
    torch.cuda.synchronize()
    reset_launches()
    res = gen.solve_table(args)
    launches = read_launches()
    n_fam, G = res["speed"].shape
    per_family = -(-G // args.chunk)
    check(launches["admm_solve"] == n_fam * per_family,
          f"lattice launches {launches} != {n_fam} x {per_family}")
    check(bool(np.isfinite(res["speed"]).all()
               and np.isfinite(res["steer"]).all()),
          "non-finite lattice outputs")
    n = res["speed"].size
    print(f"goal lattice: {n:,} QPs x {args.iters} sweeps in "
          f"{res['seconds']:.2f} s = {n / res['seconds']:,.0f} QP solves/s; "
          f"converged {100 * res['valid'].mean():.4f}% (the JAX package's "
          f"claim: every row), {int((~res['valid']).sum())} rows not; "
          f"kernel launches {launches}", flush=True)
    return launches["admm_solve"], n / res["seconds"], res


def phase_goal_loop(device, golden, mode, net, against=None):
    """The goal-MPC closed loop in ``mode``; held lane by lane against the
    JAX golden, or, for a net the card just made (``against``: phase 12's
    result with the committed net), by its outcome."""
    import torch

    from irbfn_tpu_torch.planning import GoalMPCPlanner
    from irbfn_tpu_torch.sim import deviation_metrics
    from irbfn_tpu_torch.utils.profiling import sweep_env

    env, sim = sweep_env(device, "speed", golden)
    planner = GoalMPCPlanner(env.track, None if mode == "solver" else net)
    B = sim.s.numel()

    def policy(obs):
        return torch.stack(planner.plan_batch(obs.pose_x, obs.pose_y,
                                              obs.pose_theta,
                                              obs.linear_vel_x), dim=-1)

    kernel = "admm_solve" if mode == "solver" else "rbf_forward"
    final, traj, launches, wall = _drive(env, sim, policy, kernel)
    ey = deviation_metrics(traj)[0].cpu().numpy()
    done = final.done.cpu().numpy()
    laps = final.laps.cpu().numpy()
    out = dict(launches=launches[kernel], rate=N_STEPS / wall,
               ey=float(ey.mean()))
    if against is not None:
        print(f"goal-MPC closed loop, net mode, the net fitted on the card: "
              f"{int((~done).sum())}/{B} lanes completed, laps>=1 "
              f"{int((laps >= 1).sum())}; mean|ey| {ey.mean():.4f} m (the "
              f"committed net in phase 12: {against['ey']:.4f} m, limit "
              f"+-{100 * TOL_FIT_EY_RATIO:.0f}%); {N_STEPS} steps in "
              f"{wall:.2f} s = {N_STEPS / wall:.1f} control steps/s; kernel "
              f"launches {launches}", flush=True)
        check(not done.any(), f"{int(done.sum())} lanes did not finish")
        check(abs(out["ey"] - against["ey"])
              <= TOL_FIT_EY_RATIO * against["ey"],
              f"mean|ey| {out['ey']:.4f} m is not within "
              f"{TOL_FIT_EY_RATIO:.0%} of {against['ey']:.4f} m")
        return out
    ref = {k: golden[f"loop_{mode}_{k}"] for k in ("done", "laps",
                                                    "ey_mean")}
    d_ey_mm = 1e3 * np.abs(ey - ref["ey_mean"])
    d_sweep_mm = 1e3 * abs(float(ey.mean()) - float(ref["ey_mean"].mean()))
    n_done_diff = int((done != ref["done"]).sum())
    n_lap_diff = int((laps != ref["laps"]).sum())
    print(f"goal-MPC closed loop, {mode} mode: {int((~done).sum())}/{B} "
          f"lanes completed (JAX {int((~ref['done']).sum())}), laps>=1 "
          f"{int((laps >= 1).sum())}; mean|ey| {ey.mean():.4f} m (JAX "
          f"{ref['ey_mean'].mean():.4f}), sweep diff {d_sweep_mm:.4f} mm, "
          f"per-lane diff median {np.median(d_ey_mm):.3f} mm, max "
          f"{d_ey_mm.max():.2f} mm, {n_lap_diff} lanes' laps differ; "
          f"{N_STEPS} steps in {wall:.2f} s = {N_STEPS / wall:.1f} control "
          f"steps/s ({B * N_STEPS / wall:.0f} lane-steps/s); kernel launches "
          f"{launches}", flush=True)
    check(n_done_diff == 0, f"{n_done_diff} lanes differ from JAX in done")
    check(n_lap_diff <= TOL_GOAL_LAP_LANES and int(np.abs(
        laps - ref["laps"]).max()) <= 1,
        f"{n_lap_diff} lanes differ from JAX in laps")
    check(float(np.median(d_ey_mm)) <= TOL_GOAL_EY_MEDIAN_MM
          and float(d_ey_mm.max()) <= TOL_GOAL_EY_LANE_MM,
          f"per-lane mean|ey| differs from JAX by {np.median(d_ey_mm):.3f} "
          f"mm median, {d_ey_mm.max():.2f} mm at most")
    check(d_sweep_mm <= TOL_GOAL_EY_SWEEP_MM,
          f"sweep mean|ey| differs from JAX by {d_sweep_mm:.4f} mm")
    return out


def _admm_flops(F, G, iters) -> float:
    """Operations of one ADMM solve at T=8 (n=16, m=31): per sweep and row
    the three products' 2 (2 m n + n n) and ~8 m elementwise, and the
    residuals' 4 m n + 6 m once."""
    n, m = 16, 31
    return float(F * G * (iters * (2 * (2 * m * n + n * n) + 8 * m)
                          + 4 * m * n + 6 * m))


def _admm_bytes(F, G) -> float:
    """q in, x and both residuals out, per row; the family operands once."""
    n, m = 16, 31
    return float(4 * (F * G * (2 * n + 2) + F * (m * n + n * n + 2 * m + 1)))


def phase_goal_times(device, lattice_goals, net, golden):
    import torch

    from irbfn_tpu_torch.ops import admm, rbf

    g = torch.as_tensor(lattice_goals, device=device)
    fam_ops = _admm_operands(torch.tensor([8.0], device=device), g[None])
    ms_fam, t_fam = _in_turns(
        lambda: admm.admm_solve_reference(*fam_ops, iters=600),
        lambda: admm.admm_solve(*fam_ops, iters=600), iters=1, warmup=1)
    # the same family as the table generator launches it: chunks of 262,144
    chunk = 262144
    parts = [(fam_ops[0][:, i:i + chunk].contiguous(),) + fam_ops[1:]
             for i in range(0, g.shape[0], chunk)]

    def chunks():
        for p in parts:
            admm.admm_solve(*p, iters=600)

    t_chunks = [_time_ms(chunks, iters=1, warmup=1) for _ in range(2)]
    del fam_ops, parts
    rng = np.random.default_rng(2)
    F = 1000
    goals = torch.as_tensor(lattice_goals[rng.choice(len(lattice_goals), F)],
                            device=device)
    row_ops = _admm_operands(
        torch.as_tensor(rng.uniform(-1.0, 8.0, F), dtype=torch.float32,
                        device=device), goals[:, None])
    ms_row, t_row = _in_turns(
        lambda: admm.admm_solve_reference(*row_ops, iters=600),
        lambda: admm.admm_solve(*row_ops, iters=600), iters=10, warmup=2)
    ops = rbf.wcrbf_params_to_kernel(net)
    x = (torch.as_tensor(golden["net_x"], device=device)
         * net.input_scale).contiguous()
    with torch.no_grad():
        ms_net, t_net = _in_turns(
            lambda: rbf.wcrbf_forward_reference(x, ops),
            lambda: rbf.wcrbf_forward(x, ops))
    G = len(lattice_goals)
    b_fam = _bound(_admm_flops(1, G, 600), _admm_bytes(1, G))
    b_row = _bound(_admm_flops(F, 1, 600), _admm_bytes(F, 1))
    b_net = _bound(_rbf_flops(x.shape[0], ops), 4 * (
        sum(o.numel() for o in ops[:7]) + x.numel() + 2 * x.shape[0]))
    print(f"times (CUDA events, in turns): ADMM whole family ({G:,} goals, "
          f"600 sweeps) kernel {ms_fam['kernel']:.3f} ms, plain "
          f"{ms_fam['plain']:.3f} ms (runs {t_fam['kernel']} / "
          f"{t_fam['plain']}), bound {b_fam[0]:.3f} ms by {b_fam[1]}; the "
          f"family as {-(-G // chunk)} launches of {chunk:,} "
          f"{min(t_chunks):.3f} ms (runs {t_chunks}); "
          f"ADMM F=1000 one-goal families kernel {ms_row['kernel']:.4f} ms, "
          f"plain {ms_row['plain']:.4f} ms (runs {t_row['kernel']} / "
          f"{t_row['plain']}), bound {b_row[0]:.5f} ms by {b_row[1]}; "
          f"goal net B=1024 forward kernel {ms_net['kernel']:.4f} ms, plain "
          f"{ms_net['plain']:.4f} ms (runs {t_net['kernel']} / "
          f"{t_net['plain']}), bound {b_net[0]:.5f} ms by {b_net[1]}",
          flush=True)
    return dict(ms=ms_fam["kernel"], plain_ms=ms_fam["plain"],
                bound_ms=b_fam[0], bound_by=b_fam[1], library_ms=None)


# ------------------------------------------------------ fit-and-train path

def phase_fit(device, lattice, out_dir):
    """Phase 14: the lattice of phase 10 as a table, fitted on the card by
    the port's ``train_goal_mpc`` at the committed recipe."""
    import torch

    from irbfn_tpu_torch.parallel import gen_goal_mpc_table as gen
    from irbfn_tpu_torch.train import load_model
    from irbfn_tpu_torch.train import train_goal_mpc as tg

    t0 = time.perf_counter()
    table = gen.table_arrays(lattice)
    keep = table["valid"]
    if TABLE_STRIDE > 1:
        keep = keep & (np.arange(keep.size) % TABLE_STRIDE == 0)
    inputs, outputs = table["inputs"], table["outputs"]
    if not keep.all():
        inputs, outputs = inputs[keep], outputs[keep]
    t_table = time.perf_counter() - t0
    args = tg.parse_args(list(FIT_ARGS) + [
        "--npz_path", "(the lattice of phase 10)", "--run_name",
        "goal_mpc_card", "--device", str(device), "--out_dir", out_dir])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = tg.train(args, inputs, outputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    sec = res["seconds"]
    n = res["n_rows"]
    asset, _ = load_model(GOAL_ASSET + ".json", GOAL_ASSET + ".npz",
                          device=device)
    asset.eval()
    mae_ref, _ = tg.strided_mae(asset, res["x_dev"], res["y_dev"], n)
    same_centers = bool(torch.equal(res["model"].centers, asset.centers))
    mae = res["mae"]
    cut = ("every row of the lattice" if TABLE_STRIDE == 1 else
           f"CUT to every {TABLE_STRIDE}th row of the lattice")
    print(f"fit on the card (R=16, K=512, per-region heads): {n:,} rows "
          f"({cut}); table arrays on the host {t_table:.2f} s, region "
          f"spec and input scale (host numpy) {sec['region_spec']:.2f} s, "
          f"upload {sec['upload']:.2f} s, choose_centers "
          f"{sec['choose_centers']:.2f} s, box tests {sec['mask']:.2f} s, "
          f"gram passes {sec['gram']:.2f} s over {sec['row_visits']:,} row "
          f"visits, solves {sec['solve']:.2f} s; the whole of "
          f"train_goal_mpc {wall:.2f} s = {n / wall:,.0f} rows/s; strided "
          f"MAE speed {mae[0]:.4f} m/s steer {mae[1]:.4f} rad on "
          f"{res['n_probe']:,} rows (the committed goal_mpc_pr on the same "
          f"rows: {mae_ref[0]:.4f}, {mae_ref[1]:.4f}; limit "
          f"{TOL_FIT_MAE_RATIO}x); centers equal the committed net's bit "
          f"for bit: {same_centers}; kernel launches {launches}", flush=True)
    state = res["model"].state_dict()
    check(all(bool(torch.isfinite(v).all()) for v in state.values()),
          "non-finite fitted weights")
    check(bool((mae <= TOL_FIT_MAE_RATIO * mae_ref).all()),
          f"fitted MAE {mae} over {TOL_FIT_MAE_RATIO}x the committed net's "
          f"{mae_ref}")
    check(launches["rbf_forward"] == -(-res["n_probe"] // tg.PROBE_CHUNK),
          f"the probe's rbf_forward launches: {launches}")
    return res, table, asset


def phase_fit_eval(device, fit, table, asset):
    """Phase 15: the fitted net saved, reloaded, and evaluated through both
    kernels; the committed net beside it."""
    import torch

    from irbfn_tpu_torch.train import eval_goal_mpc as ev
    from irbfn_tpu_torch.train import load_model

    net, _ = load_model(fit["config_path"], fit["ckpt_dir"], device=device)
    net.eval()
    for k, v in fit["model"].state_dict().items():
        check(bool(torch.equal(net.state_dict()[k], v)),
              f"{k} changed through the checkpoint")
    valid = table["valid"]
    inputs, outputs = table["inputs"], table["outputs"]
    if not valid.all():
        inputs, outputs = inputs[valid], outputs[valid]
    torch.cuda.synchronize()
    reset_launches()
    got = ev.evaluate(net, inputs, outputs, table["lows"], table["highs"],
                      N_OFFGRID, 0, device=device)
    torch.cuda.synchronize()
    launches = read_launches()
    ref = ev.evaluate(asset, inputs, outputs, table["lows"], table["highs"],
                      N_OFFGRID, 0, device=device)
    x = torch.as_tensor(got["off"], device=device)
    with torch.no_grad():
        y_kernel = net(x)
    y_module = net(x)  # autograd records: the module path
    check(y_module.requires_grad and not y_kernel.requires_grad,
          "the forward's dispatch rule")
    err = _max_err(y_kernel, y_module.detach())
    n_tab = -(-got["n_table"] // ev.PROBE_CHUNK)
    print(f"the fitted net through the kernels: table MAE speed "
          f"{got['table_mae'][0]:.4f} steer {got['table_mae'][1]:.4f} "
          f"({got['n_table']:,} rows; committed net {ref['table_mae'][0]:.4f}"
          f", {ref['table_mae'][1]:.4f}); off-grid MAE speed "
          f"{got['offgrid_mae'][0]:.4f} steer {got['offgrid_mae'][1]:.4f} on "
          f"{got['n_offgrid']:,} of {N_OFFGRID} rows whose 1200-sweep solve "
          f"converged (committed net {ref['offgrid_mae'][0]:.4f}, "
          f"{ref['offgrid_mae'][1]:.4f}); kernel forward vs module-path "
          f"forward max|err| {err:.2e} (tol {TOL_GOAL_NET}); kernel launches "
          f"{launches}", flush=True)
    check(launches["admm_solve"] == 1 and launches["rbf_forward"] == n_tab + 1,
          f"eval launches {launches}: expected 1 admm_solve and {n_tab + 1} "
          "rbf_forward")
    check(err <= TOL_GOAL_NET, f"kernel vs module path: {err:.3e}")
    check(bool(np.isfinite(got["table_mae"]).all()
               and np.isfinite(got["offgrid_mae"]).all()), "non-finite MAE")
    check(bool((got["table_mae"] <= TOL_FIT_MAE_RATIO
                * ref["table_mae"]).all()),
          f"table MAE {got['table_mae']} over {TOL_FIT_MAE_RATIO}x the "
          f"committed net's {ref['table_mae']}")
    return launches


def phase_finetune(device, fit):
    """Phase 16: Adam steps of the L1 loss from the fitted weights, through
    ``train_epochs`` on a strided view of the resident table."""
    import torch

    from irbfn_tpu_torch.train import (create_trainer, load_model,
                                       make_train_step, pred_l1_loss,
                                       train_epochs)

    net, _ = load_model(fit["config_path"], fit["ckpt_dir"], device=device)
    n = fit["n_rows"]
    rows = FINETUNE_STEPS * FINETUNE_BATCH
    stride = max(n // rows, 1)
    xs = fit["x_dev"][:n:stride][:rows]
    ys = fit["y_dev"][:n:stride][:rows]
    check(xs.shape[0] == rows, f"the table has {xs.shape[0]} of {rows} rows")
    probe = xs[:FINETUNE_BATCH].contiguous()
    with torch.no_grad():
        before = net(probe)
    trainer = create_trainer(net, lr=1e-4, decay_steps=FINETUNE_STEPS)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    train_epochs(trainer, make_train_step(pred_l1_loss, None), xs, ys,
                 batch_size=FINETUNE_BATCH, epochs=1, seed=0,
                 log_fn=lambda s, m: losses.append(m.loss), log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    with torch.no_grad():
        after = net(probe)
    e_module = _max_err(after, net.forward_module(probe).detach())
    moved = _max_err(after, before)
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print(f"fine-tune on the card: {trainer.step_count} Adam steps of the L1 "
          f"loss at batch {FINETUNE_BATCH} in {wall:.2f} s = "
          f"{1e3 * wall / trainer.step_count:.2f} ms per step, peak memory "
          f"{peak / 2**30:.2f} GiB; loss mean of the first 20 steps "
          f"{first:.5f}, of the last 20 {last:.5f} (min {losses.min():.5f}, "
          f"max {losses.max():.5f}); a no-grad forward moved by "
          f"{moved:.2e} and is {e_module:.2e} from the module path (tol "
          f"{TOL_GOAL_NET}); kernel launches during the steps {launches}",
          flush=True)
    check(trainer.step_count == FINETUNE_STEPS == len(losses),
          f"{trainer.step_count} steps, {len(losses)} losses")
    check(launches == {"rbf_forward": 0, "admm_solve": 0},
          f"a kernel was launched during the train steps: {launches}")
    check(bool(np.isfinite(losses).all()), "non-finite fine-tune loss")
    check(last <= first, f"the loss rose: {first:.5f} -> {last:.5f}")
    check(moved > 0.0 and e_module <= TOL_GOAL_NET,
          f"the forward after the steps: moved {moved:.2e}, {e_module:.2e} "
          "from the module path")


def phase_train_golden(device):
    """Phase 18: the flagship's f32 loss, gradient norms and five Adam steps
    on the card against the JAX package's f64 fixture."""
    import torch

    from irbfn_tpu_torch.train import (create_trainer, frenet_fullint_loss,
                                       load_model, make_train_step)

    with np.load(TRAIN_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    net, _ = load_model(ASSET + ".json", ASSET + ".npz", device=device)
    x = torch.as_tensor(g["x"], device=device)
    y = torch.as_tensor(g["y"], dtype=torch.float32, device=device)
    dyn = torch.as_tensor(g["dyn"], dtype=torch.float32, device=device)
    reset_launches()
    loss, (pred, inte) = frenet_fullint_loss(net, x, y, dyn)
    loss.backward()
    rel = {k: abs(float(v.detach()) - float(g[k])) / abs(float(g[k]))
           for k, v in (("loss", loss), ("pred_loss", pred),
                        ("int_loss", inte))}
    rel_grad = {}
    for name, p in net.named_parameters():
        want = float(g[f"grad_norm_{name}"])
        rel_grad[name] = abs(float(p.grad.norm()) - want) / want
    trainer = create_trainer(net, lr=float(g["lr"]),
                             max_grad_norm=float(g["max_grad_norm"]))
    step = make_train_step(frenet_fullint_loss, dyn)
    losses = np.array([float(step(trainer, x, y).loss)
                       for _ in g["step_losses"]])
    rel_steps = np.abs(losses - g["step_losses"]) / np.abs(g["step_losses"])
    launches = read_launches()
    print(f"Frenet fine-tune step vs JAX f64 ({x.shape[0]} rows, lr "
          f"{float(g['lr'])}, clip {float(g['max_grad_norm'])}; relative "
          f"errors): " + ", ".join(f"{k} {e:.2e}" for k, e in rel.items())
          + f" (tol {TOL_TRAIN_LOSS}); gradient norms "
          + ", ".join(f"{k} {e:.2e}" for k, e in rel_grad.items())
          + f" (tol {TOL_TRAIN_GRAD}); losses of 5 Adam steps "
          + ", ".join(f"{v:.5f}" for v in losses) + " (JAX "
          + ", ".join(f"{v:.5f}" for v in g["step_losses"]) + "), rel "
          + ", ".join(f"{e:.2e}" for e in rel_steps)
          + f"; kernel launches {launches}", flush=True)
    bad = {k: e for k, e in rel.items() if not e <= TOL_TRAIN_LOSS}
    bad.update({k: e for k, e in rel_grad.items()
                if not e <= TOL_TRAIN_GRAD})
    check(not bad, f"loss or gradient vs JAX f64: {bad}")
    check(rel_steps[0] <= TOL_TRAIN_LOSS
          and bool((rel_steps <= TOL_TRAIN_GRAD).all()),
          f"Adam-step losses vs JAX f64: {rel_steps}")
    check(launches == {"rbf_forward": 0, "admm_solve": 0},
          f"a kernel was launched under autograd: {launches}")


# ------------------------------------------------------- the Frenet chain

def _pct(a, qs=(50, 90)):
    return [float(np.percentile(a, q)) if a.size else float("nan")
            for q in qs]


def _row_problem(rows):
    """(x0, goal, curv) tensors of table rows [ey, delta, vx, vy, vx_goal,
    wz, epsi, curv]."""
    import torch

    zeros = torch.zeros_like(rows[:, 0])
    x0 = torch.stack([zeros, rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3],
                      rows[:, 5], rows[:, 6]], dim=-1)
    goal = torch.zeros_like(x0)
    goal[:, 3] = rows[:, 4]
    return x0, goal, rows[:, 7].contiguous()


def phase_nmpc_against_jax(device, g):
    """Phase 19: the solver in f64 on the card against JAX's f64 solutions
    and the SLSQP oracle, and NMPCPlanner against the JAX loop."""
    import torch

    from irbfn_tpu_torch.dynamics import fullscale_params
    from irbfn_tpu_torch.planning import NMPCPlanner
    from irbfn_tpu_torch.sim import oval_track
    from irbfn_tpu_torch.solvers import nmpc
    from irbfn_tpu_torch.solvers.oracle import (OracleResult,
                                                agreement_metrics)

    params = fullscale_params(dtype=torch.float64, device=device)
    cfg = nmpc.NMPCConfig()
    n = len(g["rows"])
    rows = np.concatenate([g["rows"], g["oracle_rows"]])
    iters0 = newton_iterations()
    t0 = time.perf_counter()
    sol = nmpc.solve_lattice_point(torch.as_tensor(rows, device=device),
                                   params, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = newton_iterations() - iters0
    check(all(bool(torch.isfinite(getattr(sol, k)[sol.feasible]).all())
              for k in ("accel", "steer_vel", "states")),
          "non-finite feasible NMPC solutions")
    s = {k: getattr(sol, k)[:n].cpu().numpy() for k in sol._fields}
    both = s["feasible"] & g["sol_feasible"]
    err = np.maximum.reduce([
        np.abs(s["accel"] - g["sol_accel"]).max(-1),
        np.abs(s["steer_vel"] - g["sol_steer_vel"]).max(-1),
        np.abs(s["states"] - g["sol_states"]).max((-1, -2))])
    off = both & (err > TOL_NMPC_F64)
    clear = np.abs(g["sol_kkt_residual"] / cfg.kkt_tol - 1.0) > KKT_BAND
    flags = int(((s["feasible"] != g["sol_feasible"]) & clear).sum())
    onehot = int((s["active_onehot"][both & clear & ~off]
                  != g["sol_active_onehot"][both & clear & ~off]).sum())
    # a row that took another path must have reached the same cost
    x0, goal, curv = _row_problem(torch.as_tensor(g["rows"], device=device))
    cost = [nmpc._smooth_cost(
        torch.as_tensor(np.stack([a, b], -1).reshape(n, -1), device=device),
        x0, goal, curv, params, cfg).cpu().numpy()
        for a, b in ((s["accel"], s["steer_vel"]),
                     (g["sol_accel"], g["sol_steer_vel"]))]
    gap = np.abs(cost[0] - cost[1]) / (1.0 + np.abs(cost[1]))
    p50, p90 = _pct(err[both])
    print(f"NMPC vs JAX f64 on {n} rows of the wide ranges, f64 on the "
          f"card: feasible {100 * s['feasible'].mean():.1f}% (JAX "
          f"{100 * g['sol_feasible'].mean():.1f}%), flags differing outside "
          f"+-{KKT_BAND:.0%} of kkt_tol {flags}, one-hot entries differing "
          f"{onehot}; controls and states max|err| on {int(both.sum())} "
          f"rows feasible in both p50 {p50:.2e} p90 {p90:.2e} max "
          f"{err[both].max():.2e}, {int(off.sum())} rows over "
          f"{TOL_NMPC_F64} (relative cost gap there "
          f"{gap[off].max() if off.any() else 0.0:.2e}); {len(rows)} rows, "
          f"{iters} Newton iterations in {wall:.1f} s = "
          f"{1e3 * wall / max(iters, 1):.0f} ms per iteration", flush=True)
    check(onehot == 0, f"{onehot} one-hot entries differ from JAX f64")
    check(off.sum() + flags <= TOL_NMPC_OFF_ROWS * n,
          f"{int(off.sum())} of {int(both.sum())} rows differ from JAX f64 "
          f"by more than {TOL_NMPC_F64}, and {flags} feasible flags differ")
    check(not off.any() or float(gap[off].max()) <= TOL_NMPC_OFF_COST,
          f"a row differs from JAX at another cost: {gap[off].max():.2e}")

    oracle = OracleResult(g["oracle_u"], g["oracle_objective"],
                          g["oracle_max_violation"], g["oracle_feasible"])
    m = agreement_metrics(g["oracle_rows"], nmpc.NMPCSolution(
        *[v[n:] for v in sol]), oracle, params, cfg)
    print(f"NMPC vs the stored SLSQP oracle ({m['n_rows']} rows): oracle "
          f"feasible {m['oracle_feasible']}, both {m['both_feasible']}, the "
          f"oracle rejects {m['oracle_misses_al_feasible']} rows the solver "
          f"accepts; relative objective gap p50 {m['rel_obj_gap_p50']:.2e} "
          f"p90 {m['rel_obj_gap_p90']:.2e}; control difference p50 "
          f"{m['du_max_p50']:.2e}, relative p90 {m['du_rel_p90']:.2e}",
          flush=True)
    check(m["oracle_feasible"] >= 0.9 * m["n_rows"]
          and m["both_feasible"] >= 0.9 * m["oracle_feasible"]
          and m["oracle_misses_al_feasible"] <= max(1, m["n_rows"] // 33),
          "feasible sets vs the SLSQP oracle")
    check(m["rel_obj_gap_p50"] < 1e-10 and m["rel_obj_gap_p90"] < 1e-4,
          "objective vs the SLSQP oracle")
    check(m["du_max_p50"] < 1e-4 and m["du_rel_p90"] < 5e-2,
          "controls vs the SLSQP oracle")

    # the planner replays the JAX loop's observations, its own warm start
    # carried from step to step as in JAX
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    planner = NMPCPlanner(track, params, nmpc.NMPCConfig(
        gn_iters=int(g["loop_gn_iters"]), al_outer=int(g["loop_al_outer"])))
    med, share = [], []
    for k in range(int(g["loop_steps"])):
        out = planner.plan_batch(*torch.as_tensor(g["loop_obs"][k],
                                                  device=device).T)
        act = torch.stack([out.accel[:, 0], out.steer_vel[:, 0]],
                          dim=-1).cpu().numpy()
        f = out.feasible.cpu().numpy() & g["loop_feasible"][k]
        d = np.abs(act - g["loop_action"][k]).max(-1)
        med.append(float(np.median(d[f])))
        share.append(float((d[f] <= 1e-4).mean()))
    print(f"NMPCPlanner.plan_batch vs the JAX f64 loop "
          f"({g['loop_obs'].shape[1]} lanes x {len(med)} steps at "
          f"{int(g['loop_gn_iters'])} x {int(g['loop_al_outer'])} "
          f"iterations): median action error per step "
          + ", ".join(f"{v:.2e}" for v in med) + f" (tol "
          f"{TOL_LOOP_F64_MEDIAN}), share of lanes within 1e-4 "
          + ", ".join(f"{v:.2f}" for v in share), flush=True)
    check(max(med) <= TOL_LOOP_F64_MEDIAN,
          f"NMPCPlanner vs the JAX loop: median action errors {med}")


def phase_nmpc_f32(device):
    """Phase 20: f32 against f64 on the card, and the cheap pass's
    certificate."""
    import dataclasses

    import torch

    from irbfn_tpu_torch.dynamics import fullscale_params
    from irbfn_tpu_torch.parallel.gen_nmpc_table_frenet import wide_rows
    from irbfn_tpu_torch.solvers import nmpc

    cfg = nmpc.NMPCConfig()
    rows = torch.as_tensor(wide_rows(NMPC_CHUNK, 1), device=device)
    p32 = fullscale_params(device=device)
    p64 = fullscale_params(dtype=torch.float64, device=device)
    t = {}

    def solve(name, r, p, c):
        torch.cuda.synchronize()
        iters0 = newton_iterations()
        t0 = time.perf_counter()
        sol = nmpc.solve_lattice_point(r, p, c)
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0, newton_iterations() - iters0)
        return sol

    s32 = solve("f32", rows, p32, cfg)
    s64 = solve("f64", rows[:N_F64_SAMPLE].double(), p64, cfg)
    cheap = solve("cheap", rows, p32, dataclasses.replace(cfg, gn_iters=12))
    n = N_F64_SAMPLE
    f32, f64 = s32.feasible[:n], s64.feasible
    both = (f32 & f64).cpu().numpy()
    flags = float((f32 != f64).float().mean())
    u32 = torch.stack([s32.accel[:n], s32.steer_vel[:n]], dim=-1).double()
    u64 = torch.stack([s64.accel, s64.steer_vel], dim=-1)
    du = (u32 - u64).abs().amax(dim=(-1, -2)).cpu().numpy()[both]
    x0, goal, curv = _row_problem(rows[:n].double())
    j32, j64 = (nmpc._smooth_cost(u.reshape(n, -1), x0, goal, curv, p64,
                                  cfg).cpu().numpy() for u in (u32, u64))
    gap = (np.abs(j32 - j64) / (1.0 + np.abs(j64)))[both]
    # the cheap pass's certificate, recomputed from what it returned
    cf = cheap.feasible
    xs = cheap.states[cf]
    cert_ok = bool(
        (cheap.kkt_residual[cf] < cfg.kkt_tol).all()
        & (xs[:, 1:, 2].abs() <= cfg.max_steer + 1e-3).all()
        & (xs[:, 1:, 3] <= cfg.max_speed + 1e-3).all()
        & (xs[:, 1:, 3] >= cfg.min_speed - 1e-3).all()
        & torch.isfinite(xs).all())
    # and against the full pass: a certified row is feasible there too, at
    # controls that agree as two f32 solves do
    kept = float(s32.feasible[cf].float().mean())
    duc = torch.maximum((cheap.accel - s32.accel).abs().amax(-1),
                        (cheap.steer_vel - s32.steer_vel).abs().amax(-1))[
        cf & s32.feasible].cpu().numpy()
    share = {k: float(v.feasible.float().mean())
             for k, v in (("f32", s32), ("f64", s64), ("cheap", cheap))}
    print(f"NMPC f32 vs f64 on the card, {NMPC_CHUNK:,} seeded rows of the "
          f"wide ranges ({n:,} of them also in f64): feasible f32 "
          f"{100 * share['f32']:.2f}% (those {n:,}: "
          f"{100 * float(f32.float().mean()):.2f}%), f64 "
          f"{100 * share['f64']:.2f}% (the JAX package reports ~91% on its "
          f"lattice); flags differ on {100 * flags:.2f}% of rows (tol "
          f"{TOL_F32_FLAGS:.0%}); on {int(both.sum()):,} rows feasible in "
          f"both: control difference p50 {_pct(du)[0]:.2e} p90 "
          f"{_pct(du)[1]:.2e} (tol {TOL_F32_DU}), relative objective gap "
          f"p50 {_pct(gap)[0]:.2e} p90 {_pct(gap)[1]:.2e} (tol "
          f"{TOL_F32_GAP}); the 12-iteration cheap pass certifies "
          f"{100 * share['cheap']:.2f}% (the JAX package: 88.5% on its "
          f"lattice), every certified row inside the full pass's tolerances: "
          f"{cert_ok}, {100 * kept:.2f}% of them feasible in the full pass, "
          f"control difference to it p50 {_pct(duc)[0]:.2e} p90 "
          f"{_pct(duc)[1]:.2e}; seconds (Newton iterations): "
          + ", ".join(f"{k} {v[0]:.1f} ({v[1]})" for k, v in t.items()),
          flush=True)
    check(cert_ok, "a row certified by the cheap pass violates a tolerance")
    check(flags <= TOL_F32_FLAGS, f"f32/f64 flags differ on {flags:.2%}")
    check(abs(float(f32.float().mean()) - share["f64"]) <= TOL_F32_FEASIBLE,
          f"feasible shares: f32 {float(f32.float().mean()):.4f}, f64 "
          f"{share['f64']:.4f}")
    check(_pct(du)[0] <= TOL_F32_DU[0] and _pct(du)[1] <= TOL_F32_DU[1],
          f"f32 vs f64 control difference p50/p90 {_pct(du)}")
    check(_pct(gap)[0] <= TOL_F32_GAP[0] and _pct(gap)[1] <= TOL_F32_GAP[1],
          f"f32 vs f64 objective gap p50/p90 {_pct(gap)}")
    phase_cheap_pass_p4(device)
    return share


def phase_cheap_pass_p4(device):
    """Phase 20, continued: the cheap pass in f32 on the 312 seeded rows of
    the reference-parity lattice that the JAX package certified on a CPU
    (``cheap_pass_golden.npz``), in its 39-row chunks, and on the 39-row
    test shape."""
    import dataclasses

    import torch

    from irbfn_tpu_torch.dynamics import fullscale_params
    from irbfn_tpu_torch.solvers import nmpc

    with np.load(CHEAP_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    cfg = dataclasses.replace(nmpc.NMPCConfig(), gn_iters=12)
    p32 = fullscale_params(device=device)
    rows = torch.as_tensor(g["rows"], device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flags = torch.cat([nmpc.solve_lattice_point(rows[i:i + 39], p32,
                                                cfg).feasible
                       for i in range(0, len(rows), 39)]).cpu().numpy()
    test = nmpc.solve_lattice_point(rows[torch.as_tensor(g["test_idx"],
                                                         device=device)],
                                    p32, cfg).feasible.cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want, want_test = g["flags_f32"], g["test_flags_f32"]
    diff = np.flatnonzero(flags != want)
    print(f"cheap pass in f32 on the card (P4), 312 seeded rows of the "
          f"reference-parity lattice in 39-row chunks: the port certifies "
          f"{flags.sum()} ({100 * flags.mean():.2f}%), the JAX package on a "
          f"CPU {want.sum()} ({100 * want.mean():.2f}%), flags differ on "
          f"{diff.size} rows {diff.tolist()}; the 39-row test shape: "
          f"{test.sum()} against {want_test.sum()}, {int((test != want_test).sum())} "
          f"flags differ; {wall:.1f} s", flush=True)
    check(abs(flags.mean() - want.mean()) <= TOL_CHEAP_SHARE,
          f"cheap pass certified {flags.mean():.4f} against the JAX "
          f"package's {want.mean():.4f}")


def phase_frenet_table(device, out_dir):
    """Phase 21: the tiered table over the flagship table's ranges."""
    import torch

    from irbfn_tpu_torch.parallel import frenet_table, save_table
    from irbfn_tpu_torch.parallel import gen_nmpc_table_frenet as gen

    counts = [a for d, n in TABLE_COUNTS.items()
              for a in (f"--num_{d}", str(n))]
    args = gen.parse_args(list(gen.WIDE_RANGE_ARGS) + counts + [
        "--batch_per_device", str(NMPC_CHUNK), "--run_tag", "wide_cut",
        "--save_path", out_dir, "--device", str(device)])
    full = 12 * 7 * 11 * 5 * 6 * 7 * 7 * 9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gen.solve_table(args)[0]
    wall = time.perf_counter() - t0
    sol = res["sol"]
    n = len(res["rows"])
    table = frenet_table(res["rows"], sol)
    path = gen.table_name(args, res["grid"], res["mu"])
    save_table(path, table)
    feas = sol.feasible
    check(bool(np.isfinite(sol.accel[feas]).all()
               and np.isfinite(sol.steer_vel[feas]).all()),
          "non-finite controls in feasible table rows")
    check(table["constraints"].shape == (n, 86)
          and bool((table["outputs"][~feas] == -999.0).all()),
          "the table's layout")
    check(feas.mean() >= 0.5, f"only {feas.mean():.1%} of the table feasible")
    print(f"Frenet table on the card: {n:,} rows, REDUCED (counts only) "
          f"from the flagship table's {full:,}: per-axis counts "
          f"{'x'.join(str(v) for v in TABLE_COUNTS.values())} of "
          f"12x7x11x5x6x7x7x9 over the same ranges, chunks of "
          f"{NMPC_CHUNK:,}; default budgets, tiered: cheap pass certified "
          f"{100 * res['certified_cheap']:.1f}%, after the full-budget pass "
          f"{100 * res['feasible_tiered']:.1f}% feasible, final "
          f"{100 * feas.mean():.1f}%; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in res["seconds"].items())
          + f", the whole of solve_table {wall:.1f}; solves/s "
          + ", ".join(f"{k} {v:,.0f}" for k, v in res["rates"].items()),
          flush=True)
    return path, res


def phase_frenet_fit(device, table_path, out_dir):
    """Phase 22: the flagship recipe on the card's own table."""
    import torch

    from irbfn_tpu_torch.train import eval_offline, load_model
    from irbfn_tpu_torch.train import train_frenet as tf

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fit = tf.main(list(FRENET_FIT_ARGS) + [
        "--npz_path", table_path, "--run_name", "frenet_card", "--device",
        str(device), "--out_dir", out_dir])
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    config_path = os.path.join(out_dir, "frenet_card.json")
    ev = eval_offline.main(["--config_f", config_path, "--ckpt",
                            fit["ckpt_dir"], "--npz_path", table_path,
                            "--mirror", "--device", str(device)])
    launches = read_launches()
    ref = eval_offline.main(["--config_f", ASSET + ".json", "--ckpt",
                             ASSET + ".npz", "--npz_path", table_path,
                             "--mirror", "--device", str(device)])
    net, config = load_model(config_path, fit["ckpt_dir"], device=device)
    net.eval()
    inputs, _, valid = tf.load_table(table_path)
    x = torch.as_tensor(inputs[valid][::max(int(valid.sum()) // 4096, 1)],
                        dtype=torch.float32, device=device)
    with torch.no_grad():
        y_kernel = net(x)
        y_module = net.forward_module(x)
    err = _max_err(y_kernel, y_module)
    rel = abs(ev["control_l1"] - fit["fit_l1"]) / fit["fit_l1"]
    w_sum = float(net.head_kernel.detach().abs().sum(0).max())
    print(f"flagship recipe on the card's table (mirror, per-region closed "
          f"form, R=16, K=512, tube weights): train_frenet {t_fit:.2f} s, "
          f"fit control L1 {fit['fit_l1']:.5f}; eval_offline control L1 "
          f"{ev['control_l1']:.5f} (relative difference {rel:.1e}), first "
          f"state ey/epsi/vx MAE "
          + "/".join(f"{v:.5f}" for v in ev["picks"][:3])
          + f"; the committed frenet_wide_pr1 on the same rows: control L1 "
          f"{ref['control_l1']:.5f}; kernel forward vs module path on "
          f"{x.shape[0]:,} table rows max|err| {err:.2e} (tol "
          f"{TOL_FLAGSHIP}; the head's sum |w| per output is up to "
          f"{w_sum:.1e}); kernel launches (fit and eval) {launches}",
          flush=True)
    check(bool(np.isfinite(ev["control_l1"]) and np.isfinite(ev["picks"]).all()),
          "non-finite offline eval")
    check(rel <= TOL_FIT_PROBE,
          f"eval_offline L1 {ev['control_l1']} != the fit's own "
          f"{fit['fit_l1']}")
    check(launches["rbf_forward"] >= 1, "the eval did not reach rbf_forward")
    check(err <= TOL_FLAGSHIP, f"kernel vs module path: {err:.3e}")
    return net, config, launches


def phase_frenet_loops(device, net, config, table_path, golden, g, flagship):
    """Phase 23: the fitted net, the table and the solver in closed loop."""
    import torch

    from irbfn_tpu_torch.dynamics import fullscale_params
    from irbfn_tpu_torch.planning import IRBFNFrenetPlanner, NMPCPlanner
    from irbfn_tpu_torch.planning.explicit import grid_table_from_arrays
    from irbfn_tpu_torch.sim import deviation_metrics
    from irbfn_tpu_torch.sim.eval_closed_loop import explicit_policy
    from irbfn_tpu_torch.solvers import nmpc
    from irbfn_tpu_torch.train import input_bounds_from_config
    from irbfn_tpu_torch.utils.profiling import sweep_env

    env, sim = sweep_env(device, "accl", golden)
    B = sim.s.numel()
    planner = IRBFNFrenetPlanner(
        net, env.track, input_bounds=input_bounds_from_config(config))

    def net_policy(obs):
        r = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                               obs.linear_vel_x, obs.linear_vel_y,
                               obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    final, traj, launches, wall = _drive(env, sim, net_policy, "rbf_forward",
                                         N_RECORD_STEPS)
    ey = deviation_metrics(traj)[0]
    done = final.done
    print(f"Frenet closed loop, the net fitted on the card's cut table: "
          f"{int((~done).sum())}/{B} lanes completed, mean|ey| over the "
          f"lanes that did {float(ey[~done].mean()) if (~done).any() else float('nan'):.4f} m "
          f"(the committed flagship in phase 5: {flagship['done']}/{B}, "
          f"{flagship['ey']:.4f} m over {N_STEPS} steps; no threshold: the "
          f"table is cut); {N_RECORD_STEPS} steps in {wall:.2f} s; kernel "
          f"launches {launches}",
          flush=True)
    net_launches = launches["rbf_forward"]

    d = np.load(table_path)
    table = grid_table_from_arrays(d["inputs"], d["outputs"], d["valid"],
                                   device=device)
    env, sim = sweep_env(device, "accl", golden)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, traj = env.rollout(sim, explicit_policy(table, env.track, 0.5),
                              N_RECORD_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(torch.isfinite(traj.obs.ey).all()),
          "NaN in the explicit planner's loop")
    ey = deviation_metrics(traj)[0]
    done = final.done
    print(f"Frenet closed loop, ExplicitFrenetPlanner's multilinear lookup "
          f"of the same table ({len(d['inputs']):,} rows on the card, "
          f"hard brake on an infeasible cell): {int((~done).sum())}/{B} "
          f"lanes completed, mean|ey| over the lanes that did "
          f"{float(ey[~done].mean()) if (~done).any() else float('nan'):.4f}"
          f" m; {N_RECORD_STEPS} steps in {wall:.2f} s = "
          f"{N_RECORD_STEPS / wall:.1f} control steps/s", flush=True)

    # NMPC in the loop, f32, on the golden's lanes and budget
    cfg = nmpc.NMPCConfig(gn_iters=int(g["loop_gn_iters"]),
                          al_outer=int(g["loop_al_outer"]))
    steps = int(g["loop_steps"])
    lines = []
    for label, warm in (("its own warm start", None),
                        ("the fitted net's warm start", "net")):
        env, sim = sweep_env(device, "accl", g)
        warm_planner = None
        if warm:
            warm_planner = IRBFNFrenetPlanner(
                net, env.track,
                input_bounds=input_bounds_from_config(config))
        nm = NMPCPlanner(env.track, fullscale_params(device=device), cfg,
                         warm_start_planner=warm_planner)
        acts, feas = [], []

        def policy(obs):
            sol = nm.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                                obs.linear_vel_x, obs.linear_vel_y,
                                obs.ang_vel_z)
            a = torch.stack([sol.accel[:, 0], sol.steer_vel[:, 0]], dim=-1)
            acts.append(a.cpu().numpy())
            feas.append(sol.feasible.cpu().numpy())
            return a

        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        final, traj = env.rollout(sim, policy, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(bool(torch.isfinite(traj.obs.ey).all())
              and bool(np.isfinite(np.stack(acts)).all()),
              f"NaN in the NMPC loop ({label})")
        med = []
        for k in range(steps):
            f = feas[k] & g["loop_feasible"][k]
            med.append(float(np.median(np.abs(
                acts[k] - g["loop_action"][k]).max(-1)[f])))
        lines.append(
            f"{label}: feasible per step "
            + ", ".join(f"{f.mean():.2f}" for f in feas)
            + ", median action difference to the JAX f64 loop per step "
            + ", ".join(f"{v:.2e}" for v in med)
            + f", mean|ey| {float(deviation_metrics(traj)[0].mean()):.4f} m"
            f", {wall:.1f} s, kernel launches {launches}")
        if warm is None:
            check(med[0] <= TOL_LOOP_F32_MEDIAN,
                  f"f32 NMPC loop's first actions vs the JAX f64 loop: "
                  f"median {med[0]:.3e} > {TOL_LOOP_F32_MEDIAN}")
        else:
            check(launches["rbf_forward"] == steps,
                  f"the warm start's rbf_forward launches: {launches}")
            net_launches += launches["rbf_forward"]
    print(f"Frenet closed loop, NMPCPlanner in f32 ({len(g['loop_mu'])} "
          f"lanes x {steps} steps at {cfg.gn_iters} x {cfg.al_outer} "
          f"iterations; first-step tol {TOL_LOOP_F32_MEDIAN}): "
          + "; ".join(lines), flush=True)
    return net_launches


def frenet_chain(device, golden, flagship_loop):
    """Phases 19-23: solver -> table -> fit -> eval -> closed loops.
    Returns the rbf_forward launches of the fit and eval, and of the
    loops."""
    with np.load(NMPC_GOLDEN) as z:
        nmpc_golden = {k: z[k] for k in z.files}
    phase_nmpc_against_jax(device, nmpc_golden)
    phase_nmpc_f32(device)
    with tempfile.TemporaryDirectory() as out_dir:
        table_path, _ = phase_frenet_table(device, out_dir)
        net, config, launches = phase_frenet_fit(device, table_path, out_dir)
        loop_launches = phase_frenet_loops(device, net, config, table_path,
                                           golden, nmpc_golden, flagship_loop)
    return launches["rbf_forward"], loop_launches


# ------------------------------------------ the map world and the bank

def _asset(path, device):
    """A committed asset's (model, config), f32, on ``device``."""
    import torch

    from irbfn_tpu_torch.train import load_model

    model, config = load_model(path + ".json", path + ".npz", device=device,
                               dtype=torch.float32)
    return model.eval(), config


def _kernel_vs_plain(label, model, x):
    """``model``'s kernel forward on ``x`` (its net inputs, unscaled) against
    the plain version: TOL_FLAGSHIP, for the bank's arms and cart_c1_pr are
    fits as ill-conditioned as the flagship (sum |w| 1.3e5 and 5.4e4 per
    output; their plain f32 forwards on a CPU were up to 4.3e-4 and 7.0e-5
    from f64)."""
    from irbfn_tpu_torch.ops import wcrbf_params_to_kernel

    xs = (x * model.input_scale).contiguous()
    return _compare(label, xs, wcrbf_params_to_kernel(model), TOL_FLAGSHIP)


def _against(final, traj, g):
    """A 1000-lane loop against a golden's ``loop_*``: per-lane mean |ey|
    differences (mm), lanes whose done or laps differ, the sweep's mean |ey|
    difference (mm)."""
    from irbfn_tpu_torch.sim import deviation_metrics

    ey = deviation_metrics(traj)[0].cpu().numpy()
    done = final.done.cpu().numpy()
    laps = final.laps.cpu().numpy()
    return dict(ey=ey, done=done, laps=laps,
                d_ey_mm=1e3 * np.abs(ey - g["loop_ey_mean"]),
                n_done=int((done != g["loop_done"]).sum()),
                n_laps=int((laps != g["loop_laps"]).sum()),
                d_sweep_mm=1e3 * abs(float(ey.mean())
                                     - float(g["loop_ey_mean"].mean())))


def _loop_line(name, r, g, wall, launches, n_lanes):
    return (f"{name}: {int((~r['done']).sum())}/{n_lanes} lanes completed "
            f"(JAX {int((~g['loop_done']).sum())}), mean|ey| "
            f"{r['ey'].mean():.4f} m (JAX {g['loop_ey_mean'].mean():.4f}), "
            f"sweep diff {r['d_sweep_mm']:.4f} mm, per-lane diff median "
            f"{np.median(r['d_ey_mm']):.4f} mm, max {r['d_ey_mm'].max():.2f} "
            f"mm; {r['n_done']} lanes' done and {r['n_laps']} lanes' laps "
            f"differ; {N_STEPS} steps in {wall:.2f} s = "
            f"{N_STEPS / wall:.1f} control steps/s; launches {launches}, "
            + ", ".join(f"{k} {v / N_STEPS:g} per step"
                        for k, v in launches.items()))


def phase_grip_bank(device, g):
    """Phase 24: the 12-arm grip-adaptive bank through rollout_stateful."""
    import torch

    from irbfn_tpu_torch.planning import GripAdaptiveFrenetPlanner
    from irbfn_tpu_torch.planning.grip import GripConfig
    from irbfn_tpu_torch.train import input_bounds_from_config
    from irbfn_tpu_torch.utils.profiling import sweep_env

    mus = g["arm_mus"]
    arms = [_asset(os.path.join(ASSETS, f"bank6_pr_mu{m:.2f}"), device)
            for m in mus]
    env, sim = sweep_env(device, "accl", g,
                         speed_scale=float(g["flag_speed_scale"]))
    planner = GripAdaptiveFrenetPlanner(
        arms[0][0], [a for a, _ in arms], mus, env.track,
        input_bounds=input_bounds_from_config(arms[0][1]),
        grip_cfg=GripConfig(g0=float(g["flag_g0"])),
        pace_lo=float(g["flag_pace_lo"]), pace_hi=float(g["flag_pace_hi"]),
        pace_margin=float(g["flag_pace_margin"]))
    # every arm's kernel at the loop's batch, on the first observation's
    # mirrored, clamped net inputs
    obs = env.observe(sim)
    rl = env.track.raceline
    from irbfn_tpu_torch.sim.track import horizon_goal_speed, interp_wrapped

    curv = interp_wrapped(rl.ss, rl.ks, obs.s, rl.length)
    vxg = horizon_goal_speed(rl, obs.s, obs.linear_vel_x, 0.5)
    x = torch.stack([obs.ey, obs.delta, obs.linear_vel_x, obs.linear_vel_y,
                     vxg, obs.ang_vel_z, obs.epsi, curv], dim=-1)
    x = x + torch.as_tensor(np.random.default_rng(2).normal(
        0.0, 0.3, tuple(x.shape)), dtype=x.dtype, device=device)
    e_arm = max(_kernel_vs_plain(f"bank arm {i}", arm, x)
                for i, arm in enumerate(planner.bank))
    step = planner.policy()
    g_log = []

    def policy(state, obs):
        action, state = step(state, obs)
        g_log.append(state.g)
        return action, state

    B = sim.s.numel()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    final, state, traj = env.rollout_stateful(sim, policy,
                                              planner.init_state((B,)),
                                              N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches["rbf_forward"] == len(mus) * N_STEPS,
          f"bank: rbf_forward launches {launches['rbf_forward']} != "
          f"{len(mus)} arms x {N_STEPS} steps")
    check(bool(torch.isfinite(traj.obs.ey).all()), "NaN in the bank's loop")
    r = _against(final, traj, g)
    g_all = torch.stack(g_log).cpu().numpy()
    arm = np.argmin(np.abs(mus - np.clip(g_all, mus[0], mus[-1])[..., None]),
                    axis=-1)
    same = arm == g["loop_arm"][:N_STEPS]
    lanes = np.flatnonzero(~same.all(0))
    first = (~same).argmax(0)[lanes]
    mid = (mus[1:] + mus[:-1]) / 2
    near = np.abs(g_all[first, lanes][:, None] - mid).min(-1)
    d_g = np.abs(state.g.cpu().numpy() - g["loop_g"])
    share, early = float(same.mean()), float(same[:60].mean())
    print(_loop_line("grip-adaptive bank (12 arms, rollout_stateful)", r, g,
                     wall, launches, B)
          + f" (12 forwards = 24 kernel launches per step); kernel vs plain "
          f"on every arm at B={B} max|err| {e_arm:.2e}; arm equal to "
          f"JAX's in {100 * share:.2f}% of lane-steps ({100 * early:.2f}% "
          f"over the first 60 steps); {lanes.size} lanes drive another arm "
          f"somewhere, first where their g lay within "
          f"{np.median(near) if lanes.size else 0.0:.4f} (median; 90th "
          f"percentile {np.percentile(near, 90) if lanes.size else 0.0:.4f})"
          " of a "
          f"midpoint of two arms' mus; arms used (lane-steps) "
          f"{np.bincount(arm.reshape(-1), minlength=len(mus)).tolist()}; "
          f"final g median {np.median(state.g.cpu().numpy()):.3f}, diff to "
          f"JAX median {np.median(d_g):.2e}, 90th percentile "
          f"{np.percentile(d_g, 90):.2e}", flush=True)
    check(share >= TOL_BANK_ARM_SHARE and early >= TOL_BANK_ARM_SHARE_EARLY,
          f"bank arms match JAX's in {share:.4f} of lane-steps "
          f"({early:.4f} early)")
    check(r["n_done"] <= TOL_BANK_DONE_LANES
          and r["n_laps"] <= TOL_BANK_LAP_LANES,
          f"bank: {r['n_done']} lanes' done, {r['n_laps']} lanes' laps differ")
    check(float(np.median(r["d_ey_mm"])) <= TOL_BANK_EY_MEDIAN_MM
          and r["d_sweep_mm"] <= TOL_BANK_EY_SWEEP_MM,
          f"bank mean|ey| vs JAX: median {np.median(r['d_ey_mm']):.3f} mm, "
          f"sweep {r['d_sweep_mm']:.3f} mm")
    check(float(np.median(d_g)) <= TOL_BANK_G_MEDIAN,
          f"bank final g vs JAX: median {np.median(d_g):.3e}")
    return launches["rbf_forward"], e_arm


def phase_cartesian(device, g):
    """Phase 25: IRBFNPlanner with cart_c1_pr, plan_batch then the loop."""
    import torch

    from irbfn_tpu_torch.planning import IRBFNPlanner
    from irbfn_tpu_torch.sim import oval_track
    from irbfn_tpu_torch.train import input_bounds_from_config
    from irbfn_tpu_torch.utils.profiling import sweep_env

    net, conf = _asset(CART_ASSET, device)
    kw = dict(mirror=bool(conf.get("mirror", True)),
              sv_ind=int(conf["out_features"]) // 2,
              input_bounds=input_bounds_from_config(conf))
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    planner = IRBFNPlanner(net, track, **kw)
    pose = torch.as_tensor(g["plan_pose"], dtype=torch.float32, device=device)
    res = planner.plan_batch(*pose.T)
    e_plan = {k: _max_err(v.cpu(), torch.from_numpy(g[f"plan_{k}"]))
              for k, v in res._asdict().items()}
    bad = {k: e for k, e in e_plan.items() if not e <= TOL_CART_PLAN}
    check(not bad, f"cartesian plan_batch vs JAX f64: {bad}")
    env, sim = sweep_env(device, "accl", g)
    planner = IRBFNPlanner(net, env.track, **kw)
    obs = env.observe(sim)
    x = torch.stack([obs.linear_vel_x, obs.pose_x, obs.pose_y,
                     obs.pose_theta, obs.linear_vel_x, obs.beta,
                     obs.ang_vel_z], dim=-1)
    e_kernel = _kernel_vs_plain("cart_c1_pr", net, torch.minimum(torch.maximum(
        x, planner.input_bounds[:, 0]), planner.input_bounds[:, 1]))

    def policy(obs):
        r = planner.plan_batch(obs.pose_x, obs.pose_y, obs.pose_theta,
                               obs.delta, obs.linear_vel_x, obs.beta,
                               obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    final, traj, launches, wall = _drive(env, sim, policy, "rbf_forward")
    r = _against(final, traj, g)
    print(f"cartesian planner (cart_c1_pr, setpoint mode): plan_batch vs JAX "
          f"f64 on {len(pose)} seeded poses "
          + ", ".join(f"{k} {e:.2e}" for k, e in e_plan.items())
          + f" (tol {TOL_CART_PLAN}); kernel vs plain at B={sim.s.numel()} "
          f"max|err| {e_kernel:.2e}; "
          + _loop_line("closed loop", r, g, wall, launches, sim.s.numel()),
          flush=True)
    check(r["n_done"] <= TOL_CART_DONE_LANES
          and r["n_laps"] <= TOL_CART_DONE_LANES,
          f"cartesian loop: {r['n_done']} lanes' done, {r['n_laps']} lanes' "
          "laps differ from JAX")
    check(float(np.median(r["d_ey_mm"])) <= TOL_CART_EY_MEDIAN_MM
          and r["d_sweep_mm"] <= TOL_CART_EY_SWEEP_MM,
          f"cartesian mean|ey| vs JAX: median {np.median(r['d_ey_mm']):.3f} "
          f"mm, sweep {r['d_sweep_mm']:.3f} mm")
    return launches["rbf_forward"]


def phase_map_world(device, g, model, config):
    """Phase 26: the rasterized oval, scans, iTTC, the flagship's loop."""
    import torch

    from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
    from irbfn_tpu_torch.sim import (ScanSpec, oval_track, rasterize_track,
                                     trace_rays)
    from irbfn_tpu_torch.train import input_bounds_from_config
    from irbfn_tpu_torch.utils.profiling import sweep_env

    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    t0 = time.perf_counter()
    omap = rasterize_track(track, half_width=2.0)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    pose = torch.as_tensor(g["ray_pose"], device=device)
    rays = trace_rays(omap, pose[:, 0], pose[:, 1], pose[:, 2],
                      ScanSpec()).cpu().numpy()
    errs = {k: np.abs(rays - g[f"ray_{k}"]) for k in ("f32", "f64")}
    q99 = {k: float(np.quantile(e, 0.99)) for k, e in errs.items()}
    for k, e in errs.items():
        check(q99[k] <= TOL_RAYS and float(e.max()) <= TOL_RAYS_ANY,
              f"trace_rays vs JAX {k}: 99th percentile {q99[k]:.2e}, max "
              f"{e.max():.2e}")
    env, sim = sweep_env(device, "accl", g, half_width=None, occ_map=omap,
                         car_radius=0.15, scan_spec=ScanSpec(),
                         enable_ttc=True)
    x = sim.x
    with torch.no_grad():
        ms_rays = _time_ms(lambda: trace_rays(omap, x[:, 0], x[:, 1],
                                              x[:, 4], ScanSpec()),
                           iters=20, warmup=3)
    planner = IRBFNFrenetPlanner(model, env.track,
                                 input_bounds=input_bounds_from_config(config))

    def policy(obs):
        r = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                               obs.linear_vel_x, obs.linear_vel_y,
                               obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    final, traj, launches, wall = _drive(env, sim, policy, "rbf_forward")
    r = _against(final, traj, g)
    check(traj.obs.scan is not None and tuple(traj.obs.scan.shape)
          == (N_STEPS, sim.s.numel(), ScanSpec().n_beams),
          "the map world's observations carry no scans")
    print(f"map world: the oval rasterized at half width 2.0 "
          f"({tuple(omap.dist.shape)} cells, {t_map:.2f} s on the host); "
          f"trace_rays (64 beams, 64 steps) on {len(pose)} seeded poses vs "
          f"JAX f32 / f64: 99th percentile {q99['f32']:.2e} / "
          f"{q99['f64']:.2e} m, max {errs['f32'].max():.2e} / "
          f"{errs['f64'].max():.2e} m (tol {TOL_RAYS}, {TOL_RAYS_ANY}); "
          f"one scan of the 1000 lanes {ms_rays:.3f} ms (CUDA events, 20 "
          "calls); "
          + _loop_line("the flagship with scans, iTTC and a 0.15 m disc", r,
                       g, wall, launches, sim.s.numel()), flush=True)
    check(r["n_done"] == 0, f"map world: {r['n_done']} lanes differ from "
          "JAX in done")
    check(r["n_laps"] <= TOL_LAP_LANES and float(r["d_ey_mm"].max())
          <= TOL_EY_LANE_MM and r["d_sweep_mm"] <= TOL_EY_SWEEP_MM,
          f"map world vs JAX: {r['n_laps']} lanes' laps, per-lane "
          f"{r['d_ey_mm'].max():.2f} mm, sweep {r['d_sweep_mm']:.4f} mm")
    return launches["rbf_forward"], ms_rays


def _seam_rows(points, obs):
    """Per step and lane, whether the goal lookahead reads a seam row of
    the Oschersleben CSV (planning/planner.py:_lookahead_goal's rows)."""
    x = obs.pose_x.cpu().numpy()
    y = obs.pose_y.cpu().numpy()
    v = obs.linear_vel_x.cpu().numpy()
    pts = points.cpu().numpy()
    d2 = ((np.stack([x, y], -1)[..., None, :] - pts) ** 2).sum(-1)
    near = d2.argmin(-1)
    seg = np.linalg.norm(pts[1] - pts[0])
    la = np.maximum(np.maximum(v, 0.1) * 0.5, 0.1)
    goal = (near + np.ceil(la / seg).astype(np.int64)) % len(pts)
    return np.isin(goal, OSCH_SEAM_ROWS)


def phase_oschersleben(device, g):
    """Phase 27: the flagship and the goal-MPC solver on the Oschersleben
    line, through eval_closed_loop.run with a track bundle."""
    import shutil

    import torch

    from irbfn_tpu_torch.ops import admm
    from irbfn_tpu_torch.sim import eval_closed_loop as ev
    from irbfn_tpu_torch.sim.map import (raceline_from_csv, rasterize_track,
                                         save_map_yaml)
    from irbfn_tpu_torch.sim.track import Track

    hw = float(g["osch_half_width"])
    n_steps = int(g["osch_flag_n_steps"])
    flags = ["--num_mu", "3", "--mu_min", "0.7", "--mu_max", "1.1",
             "--num_cs", "3", "--cs_min", "3", "--cs_max", "7",
             "--num_trials", "3", "--n_steps", str(n_steps),
             "--noise_scale", "0", "--max_retries", "0", "--car_radius",
             str(float(g["osch_flag_car_radius"])), "--device", str(device)]
    # the ADMM kernel at the planner's shape (27 one-goal families)
    rng = np.random.default_rng(3)
    F = len(g["osch_mu"])
    goals = np.stack([rng.uniform(0.5, 4.0, F), rng.uniform(0.0, 1.0, F),
                      rng.uniform(1.0, 8.0, F), rng.uniform(-0.5, 0.5, F)],
                     axis=1)
    ops = _admm_operands(
        torch.as_tensor(rng.uniform(1.0, 8.0, F), dtype=torch.float32,
                        device=device),
        torch.as_tensor(goals.reshape(F, 1, 4), dtype=torch.float32,
                        device=device))
    e_admm, flips, _, _ = _admm_errors(ops, 600, admm.admm_solve,
                                       admm.admm_solve_reference)
    _check_admm(f"Oschersleben shape F={F} G=1", e_admm, flips)
    out, lines = {}, []
    with tempfile.TemporaryDirectory() as d:
        bundle = os.path.join(d, "osch")
        os.makedirs(bundle)
        track = Track(raceline_from_csv(OSCH_CSV, device=device))
        t0 = time.perf_counter()
        omap = rasterize_track(track, half_width=hw)
        save_map_yaml(omap.dist.cpu().numpy() > 0, float(omap.resolution),
                      (float(omap.origin_x), float(omap.origin_y), 0.0),
                      os.path.join(bundle, "osch_map.yaml"))
        shutil.copy(OSCH_CSV, os.path.join(bundle, "osch_raceline.csv"))
        t_bundle = time.perf_counter() - t0
        for name, kernel, extra in (
                ("irbfn", "rbf_forward",
                 ["--config_f", ASSET + ".json", "--ckpt", ASSET + ".npz"]),
                ("goal_mpc", "admm_solve", [])):
            args = ev.parse_args(flags + extra + [
                "--planner", name, "--map_dir", bundle, "--line_csv",
                OSCH_CSV, "--out_name", os.path.join(d, name)])
            seen = {}
            e_kernel = None
            if name == "irbfn":
                model, _ = _asset(ASSET, device)
                x = torch.as_tensor(np.random.default_rng(4).uniform(
                    -1.0, 1.0, (F, 8)), dtype=torch.float32, device=device)
                e_kernel = _kernel_vs_plain(f"flagship B={F}", model,
                                            x * 0.5 + torch.tensor(
                                                [0, 0, 4, 0, 5, 0, 0, 0],
                                                device=device))
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            ev.run(args, on_attempt=lambda a, f, t, p: seen.update(
                final=f, traj=t))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            check(launches[kernel] == n_steps,
                  f"Oschersleben {name}: {kernel} launches "
                  f"{launches[kernel]} != {n_steps} steps")
            final, traj = seen["final"], seen["traj"]
            abs_ey = traj.obs.ey.abs().cpu().numpy()
            check(np.isfinite(abs_ey).all(), f"NaN in the {name} loop")
            ref_ey = g[f"osch_{name}_abs_ey"]
            seam = (_seam_rows(track.raceline.points, traj.obs)
                    | np.isin(g[f"osch_{name}_rows"][..., 1], OSCH_SEAM_ROWS))
            keep = ~seam
            d_ey = 1e3 * np.abs((abs_ey * keep).sum(0) / keep.sum(0)
                                - (ref_ey * keep).sum(0) / keep.sum(0))
            done = final.done.cpu().numpy()
            laps = final.laps.cpu().numpy()
            n_done = int((done != g[f"osch_{name}_done"]).sum())
            n_laps = int((laps != g[f"osch_{name}_laps"]).sum())
            out[name] = dict(d_ey=d_ey, n_done=n_done, n_laps=n_laps,
                             launches=launches[kernel])
            lines.append(
                f"{name}: {int((~done).sum())}/{F} lanes completed (JAX "
                f"{int((~g[f'osch_{name}_done']).sum())}), laps "
                f"{laps.tolist()}, mean|ey| {abs_ey.mean():.4f} m; "
                f"{int(seam.sum())} of {seam.size} lane-steps masked (the "
                f"lookahead reads a seam row); per-lane mean |ey| diff to "
                f"JAX median {np.median(d_ey):.3f} mm, max {d_ey.max():.2f} "
                f"mm; {n_done} lanes' done and {n_laps} lanes' laps differ; "
                f"{n_steps} steps in {wall:.2f} s = {n_steps / wall:.1f} "
                f"control steps/s; launches {launches} "
                f"({launches[kernel] / n_steps:g} {kernel} per step)"
                + ("" if e_kernel is None else
                   f"; kernel vs plain at B={F} max|err| {e_kernel:.2e}"))
    print(f"Oschersleben line (raceline_from_csv, {track.raceline.n_points} "
          f"rows; map rasterized at half width {hw} m, "
          f"{tuple(omap.dist.shape)} cells, bundle written in "
          f"{t_bundle:.2f} s), the eval script's 3 x 3 flags, {F} lanes, "
          f"one attempt, no start noise; ADMM kernel vs plain at F={F}, "
          f"G=1: controls {e_admm['controls']:.2e}: " + "; ".join(lines),
          flush=True)
    for name, o in out.items():
        check(o["n_done"] <= TOL_OSCH_DONE_LANES
              and o["n_laps"] <= TOL_OSCH_DONE_LANES,
              f"Oschersleben {name}: {o['n_done']} lanes' done, "
              f"{o['n_laps']} lanes' laps differ from JAX")
        check(float(np.median(o["d_ey"])) <= TOL_OSCH_EY_MEDIAN_MM
              and float(o["d_ey"].max()) <= TOL_OSCH_EY_LANE_MM,
              f"Oschersleben {name}: per-lane mean |ey| diff median "
              f"{np.median(o['d_ey']):.3f} mm, max {o['d_ey'].max():.2f} mm")
    return out["irbfn"]["launches"], out["goal_mpc"]["launches"]


def worlds(device, model, config):
    """Phases 24-27. Returns the rbf_forward launches of each path and the
    admm_solve launches of the Oschersleben goal-MPC loop."""
    with np.load(BANK_GOLDEN) as z:
        bank = {k: z[k] for k in z.files}
    with np.load(CART_ASSET + "_golden.npz") as z:
        cart = {k: z[k] for k in z.files}
    with np.load(MAP_GOLDEN) as z:
        world = {k: z[k] for k in z.files}
    rbf = {}
    rbf["grip_bank"], _ = phase_grip_bank(device, bank)
    rbf["cartesian"] = phase_cartesian(device, cart)
    rbf["map_world"], _ = phase_map_world(device, world, model, config)
    rbf["oschersleben"], admm = phase_oschersleben(device, world)
    return rbf, admm


# ------------------------------------------------------ the clothoid chain

def _quiet(log, fn, *args, **kw):
    """``fn(*args, **kw)`` with its standard output written to
    ``LOG_DIR/<log>`` instead: (result, the text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, log), "w") as f:
        f.write(buf.getvalue())
    return res, buf.getvalue()


def phase_clothoid_lut(device, g, out_dir):
    """Phase 28: the reference LUT solved on the card through the LUT
    generator's solve, its entries' endpoint misses, against the JAX
    package's f64 solutions of the golden's goals, and the native oracle."""
    import torch

    from irbfn_tpu_torch import native
    from irbfn_tpu_torch.dynamics.spiral import clothoid_to_params
    from irbfn_tpu_torch.parallel import gen_clothoid_lut as gl
    from irbfn_tpu_torch.solvers.clothoid import solve_g1_hermite
    from irbfn_tpu_torch.train import eval_lut_accuracy as el

    args = gl.parse_args(list(LUT_ARGS) + ["--device", str(device),
                                           "--save_path", out_dir])
    res, _ = _quiet("phase28_gen_clothoid_lut.log", gl.solve_table, args)
    n = len(res["goals"])
    check(n == LUT_GOALS, f"the LUT has {n:,} goals")
    path = gl.lut_path(args)
    gl.save_lut(path, res["grid"], res["params"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = el.endpoint_errors(res["goals"], res["params"], CLOTHOID_CHUNK,
                              device)
    t_end = time.perf_counter() - t0
    # the golden's goals: the same lattice rows, solved on the card
    goals = torch.as_tensor(g["goals"], device=device)
    check(bool(LUT_ARGS or np.array_equal(res["goals"][g["goal_idx"]],
                                          g["goals"])),
          "the golden's goals are not the LUT's")
    sol = solve_g1_hermite(goals[:, 0], goals[:, 1], goals[:, 2])
    e_sol = {k: float(np.abs(getattr(sol, k).double().cpu().numpy()
                             - g[f"sol_f64_{k}"]).max())
             for k in TOL_CLOTHOID_SOL}
    # the native oracle (built by phase 2 on this machine), f64
    g64 = g["goals"][:N_ORACLE_GOALS].astype(np.float64)
    t0 = time.perf_counter()
    oracle, status = native.clothoid_oracle(g64)
    t_oracle = time.perf_counter() - t0
    ok = status == 0
    ref = clothoid_to_params(*(torch.as_tensor(g[f"sol_f64_{k}"][
        :N_ORACLE_GOALS]) for k in ("k0", "dk", "length"))).numpy()
    e_oracle = float((np.abs(oracle[ok] - ref[ok])
                      / np.maximum(np.abs(ref[ok]), 1.0)).max())
    card = sol.params[:N_ORACLE_GOALS].double().cpu().numpy()
    e_card = np.abs(card - oracle)[ok].max(axis=0)
    conv = float(res["converged"].mean())
    miss, rad = float(errs["xy"].max()), float(errs["theta"].max())
    counts = "x".join(str(a.num) for a in res["grid"])
    cut = ("the reference grid, none cut" if not LUT_ARGS
           else f"CUT by {' '.join(LUT_ARGS)}")
    print(f"clothoid LUT on the card: {n:,} goals ({counts}, {cut}) in "
          f"{res['seconds']:.2f} s = "
          f"{n / res['seconds']:,.0f} solves/s (host copies included; "
          f"chunks of {args.batch_per_device:,}); |g(a)| < 1e-8 on "
          f"{100 * conv:.2f}% (an f32 residual: the JAX package's f32 "
          f"reaches it on {100 * g['sol_f32_converged'].mean():.2f}% of the "
          f"golden's goals, its f64 on "
          f"{100 * g['sol_f64_converged'].mean():.2f}%); "
          f"entries' endpoint miss (f64 quadrature, {t_end:.1f} s) max "
          f"{miss:.2e} m, p99.9 {np.percentile(errs['xy'], 99.9):.2e} m, "
          f"theta max {rad:.2e} rad (f32 bound {TOL_LUT_MISS_M:g} m, "
          f"{TOL_LUT_MISS_RAD:g} rad); the card's f32 against the JAX "
          f"package's f64 on the golden's {len(goals):,} goals: "
          + ", ".join(f"{k} {v:.2e} (tol {TOL_CLOTHOID_SOL[k]:g})"
                      for k, v in e_sol.items())
          + f"; the native oracle on {N_ORACLE_GOALS:,} of them in "
          f"{t_oracle:.2f} s: {100 * ok.mean():.2f}% solved, against JAX f64 "
          f"relative {e_oracle:.2e} (tol {TOL_CLOTHOID_ORACLE:g}), the card's "
          f"params against it max|err| "
          + "/".join(f"{v:.1e}" for v in e_card), flush=True)
    check(bool(np.isfinite(res["params"]).all()), "non-finite LUT entries")
    check(miss <= TOL_LUT_MISS_M and rad <= TOL_LUT_MISS_RAD,
          f"LUT endpoint miss {miss:.2e} m / {rad:.2e} rad")
    bad = {k: v for k, v in e_sol.items() if not v <= TOL_CLOTHOID_SOL[k]}
    check(not bad, f"f32 card solve vs JAX f64: {bad}")
    check(ok.mean() > 0.99 and e_oracle <= TOL_CLOTHOID_ORACLE,
          f"native oracle: {ok.mean():.4f} solved, {e_oracle:.2e}")
    return dict(path=path, goals=res["goals"], params=res["params"],
                seconds=res["seconds"], miss=miss)


def _clothoid_bound(B, ops):
    R, K, F = ops.centers.shape
    O = ops.w.shape[-1]
    nbytes = 4 * (sum(o.numel() for o in ops[:7]) + B * F + B * O)
    return _bound(_rbf_flops(B, ops), nbytes)


def phase_clothoid_net(device, g, lut):
    """Phase 29: clothoid_pr (R=128, K=256, F=3, O=5, per-region heads)
    through the kernel: against its plain version and the JAX golden, the
    whole LUT through eval_lut_accuracy with launches counted, and times."""
    import torch

    from irbfn_tpu_torch.ops import rbf
    from irbfn_tpu_torch.planning.lattice import sample_lookahead_grid
    from irbfn_tpu_torch.train import eval_lut_accuracy as el

    net, _ = _asset(CLOTHOID_ASSET, device)
    ops = rbf.wcrbf_params_to_kernel(net)
    goals = torch.as_tensor(g["goals"], device=device)
    x8 = (goals[:8192] * net.input_scale).contiguous()
    e_plain = _compare("clothoid_pr B=8192", x8, ops, TOL_CLOTHOID_FORWARD)
    with torch.no_grad():
        y = torch.cat([net(goals[i:i + 16384])
                       for i in range(0, len(goals), 16384)])
    e_jax = np.abs(y.double().cpu().numpy() - g["forward_f64"]).max(axis=0)
    reset_launches()
    ev, text = _quiet("phase29_eval_lut_accuracy.log", el.main, [
        "--lut_path", lut["path"], "--config_f", CLOTHOID_ASSET + ".json",
        "--ckpt", CLOTHOID_ASSET + ".npz", "--chunk", str(CLOTHOID_CHUNK),
        "--device", str(device)])
    launches = read_launches()
    n_chunks = -(-LUT_GOALS // CLOTHOID_CHUNK)
    # times: a chunk of eval_lut_accuracy, the lattice planner's batch, and
    # the plain version where it fits (B = 2^18 would be a 34 GB tensor)
    xb = torch.as_tensor(lut["goals"][:CLOTHOID_CHUNK], dtype=torch.float32,
                         device=device)
    xb = (xb * net.input_scale).contiguous()
    x360 = (sample_lookahead_grid(15.0, 6.0, 8, 9, 5, device=device)
            * net.input_scale).contiguous()
    with torch.no_grad():
        ms_big = min(_time_ms(lambda: rbf.wcrbf_forward(xb, ops), 10, 2)
                     for _ in range(2))
        ms_360, t360 = _in_turns(lambda: rbf.wcrbf_forward_reference(
            x360, ops), lambda: rbf.wcrbf_forward(x360, ops))
        ms_8k, t8k = _in_turns(lambda: rbf.wcrbf_forward_reference(x8, ops),
                               lambda: rbf.wcrbf_forward(x8, ops), 20, 2)
    bound_big, by_big = _clothoid_bound(CLOTHOID_CHUNK, ops)
    bound_8k, _ = _clothoid_bound(8192, ops)
    bound_360, _ = _clothoid_bound(360, ops)
    means = {k: ev[f"{k}_mean"] for k in ("x", "y", "theta")}
    print(f"clothoid_pr through the kernel (R=128, K=256, F=3, O=5): "
          f"against the plain version at B=8192 max|err| {e_plain:.2e} "
          f"(tol {TOL_CLOTHOID_FORWARD}), against the JAX f64 golden on "
          f"{len(goals):,} goals max|err| per output "
          + "/".join(f"{v:.1e}" for v in e_jax)
          + f"; eval_lut_accuracy over the card's {LUT_GOALS:,}-goal LUT: "
          f"endpoint means x {means['x']:.4e} y {means['y']:.4e} theta "
          f"{means['theta']:.4e} (the golden's subset in f64: "
          + "/".join(f"{v:.4e}" for v in g["end_err_f64"].mean(0))
          + f"), planar miss p99 {ev['p99']:.3f} max {ev['miss_max']:.3f} "
          f"m; launches {launches} ({n_chunks} chunks of "
          f"{CLOTHOID_CHUNK:,}); times (CUDA events): B={CLOTHOID_CHUNK:,} "
          f"kernel {ms_big:.3f} ms (bound {bound_big:.3f} ms by {by_big}, "
          f"the whole LUT {ms_big * LUT_GOALS / CLOTHOID_CHUNK:.1f} ms of "
          f"kernel against a bound of "
          f"{bound_big * LUT_GOALS / CLOTHOID_CHUNK:.1f}); B=8192 kernel "
          f"{ms_8k['kernel']:.4f} ms plain {ms_8k['plain']:.4f} ms (runs "
          f"{t8k['kernel']} / {t8k['plain']}; bound {bound_8k:.4f}); B=360 "
          f"kernel {ms_360['kernel']:.4f} ms plain {ms_360['plain']:.4f} ms "
          f"(runs {t360['kernel']} / {t360['plain']}; bound "
          f"{bound_360:.4f})", flush=True)
    check(bool(torch.isfinite(y).all())
          and float(e_jax.max()) <= TOL_CLOTHOID_FORWARD,
          f"clothoid_pr vs JAX f64: {e_jax}")
    check(launches["rbf_forward"] == n_chunks,
          f"eval_lut_accuracy's launches {launches}")
    check(all(np.isfinite(v) for v in means.values()), "non-finite means")
    return dict(means=means, launches=launches["rbf_forward"],
                max_abs_err=e_plain, ms_262144=ms_big,
                plain_ms_8192=ms_8k["plain"], ms_8192=ms_8k["kernel"],
                ms_360=ms_360["kernel"], plain_ms_360=ms_360["plain"],
                bound_ms_262144=bound_big, bound_ms_8192=bound_8k,
                bound_ms_360=bound_360, bound_by=by_big)


def phase_clothoid_fit(device, lut, committed, out_dir):
    """Phase 30: the clothoid_pr recipe on the card's LUT (the fine-tune
    cut to CLOTHOID_FINETUNE_STEPS steps), seconds of each part, and the
    fitted net's endpoint means beside the committed net's."""
    import torch

    from irbfn_tpu_torch.train import eval_lut_accuracy as el
    from irbfn_tpu_torch.train import train_clothoid as tcl

    args = tcl.parse_args(list(CLOTHOID_FIT_ARGS) + [
        "--lut_path", "(phase 28's LUT)", "--finetune_steps",
        str(CLOTHOID_FINETUNE_STEPS), "--run_name", "clothoid_card",
        "--device", str(device), "--out_dir", out_dir])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res, text = _quiet("phase30_train_clothoid.log", tcl.train, args,
                       lut["goals"].astype(np.float32),
                       lut["params"].astype(np.float32))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    net = res["model"].eval()
    t0 = time.perf_counter()
    errs = el.endpoint_errors(
        lut["goals"], el.net_params(net, lut["goals"], CLOTHOID_CHUNK),
        CLOTHOID_CHUNK, device)
    t_eval = time.perf_counter() - t0
    means = {k: float(errs[k].mean()) for k in ("x", "y", "theta")}
    ratio = {k: means[k] / committed[k] for k in means}
    sec = res["seconds"]
    steps = [ln for ln in text.splitlines() if ln.startswith("  step")]
    print(f"clothoid recipe on the card (8x4x4 regions, K=256, per-region "
          f"heads, 2 IRLS rounds; fine-tune CUT to "
          f"{CLOTHOID_FINETUNE_STEPS} steps of the recipe's 30 epochs): "
          f"train_clothoid {wall:.1f} s = "
          + ", ".join(f"{k} {v:.2f}" for k, v in sec.items())
          + f" s; IRLS endpoint |x|+|y| means "
          + "/".join(f"{v:.4f}" for v in res["irls_err_means"])
          + f"; fine-tune {steps[0].strip() if steps else ''} .. "
          f"{steps[-1].strip() if steps else ''}; probes param L1 "
          f"{res['param_l1']:.5f} endpoint xy L1 {res['endpoint_l1']:.5f}; "
          f"endpoint means over the LUT ({t_eval:.1f} s) x "
          f"{means['x']:.4e} y {means['y']:.4e} theta {means['theta']:.4e}"
          f", against the committed net's (phase 29) "
          + "/".join(f"{v:.2f}x" for v in ratio.values())
          + f"; kernel launches {launches}", flush=True)
    check(all(bool(torch.isfinite(v).all())
              for v in net.state_dict().values()), "non-finite weights")
    check(all(np.isfinite(v) for v in means.values()), "non-finite means")
    check(launches["rbf_forward"] >= 2, f"IRLS and probes: {launches}")
    return net, means, read_launches()["rbf_forward"]


def phase_lattice_planner(device, g):
    """Phase 31: LatticePlanner in net and oracle mode against the golden,
    then ms per plan and one kernel forward per plan in net mode.

    The plan's cost amplifies a spiral's error (the obstacle term's slope is
    2e3 (r - clearance) per metre), so the net mode is held in two parts:
    the planner's arithmetic on the card fed the JAX net's own f32 spirals
    (``plan_net_params``) against the JAX plans, and the kernel's spirals
    of the 360 goals against those at the forward's tolerance, with the
    same goal chosen."""
    import torch

    from irbfn_tpu_torch.planning.lattice import LatticePlanner, plan_lattice

    net, _ = _asset(CLOTHOID_ASSET, device)
    target, obstacles = g["plan_target"], g["plan_obstacles"]
    jparams = torch.as_tensor(g["plan_net_params"], device=device)
    errs, ms, launches = {}, {}, {}

    def held(label, plan, pre, keys):
        for k in keys:
            a, b = getattr(plan, k).cpu().numpy(), g[pre + k]
            errs[label + k] = float(np.abs(a - b).max())
            check(bool(np.allclose(a, b, **TOL_PLAN)),
                  f"{label}{k}: max|err| {np.abs(a - b).max():.2e}")
        check(int(plan.costs.argmin()) == int(g[pre + "costs"].argmin()),
              f"{label} argmin")

    keys = ("costs", "weights", "best_params", "argmin_params")
    for mode, model in (("net", net), ("oracle", None)):
        planner = LatticePlanner(model, device=device)
        check(bool(np.array_equal(planner.goals.cpu().numpy(),
                                  g["plan_goals"])), "the planner's goals")
        for case, obs in (("free", None), ("obs", obstacles)):
            pre = f"plan_{mode}_{case}_"
            plan = planner.plan(target, obs)
            if mode == "oracle":
                held(f"oracle_{case}_", plan, pre, keys)
                continue
            check(int(plan.costs.argmin()) == int(g[pre + "costs"].argmin()),
                  f"net {case}: another goal chosen")
            held(f"jax_spirals_{case}_", plan_lattice(
                lambda _: jparams, planner.goals, target, obstacle_xy=obs,
                temperature=planner.temperature), pre, keys)
        with torch.no_grad():
            if model is not None:
                e_fwd = _max_err(net(planner.goals), jparams)
                check(e_fwd <= TOL_CLOTHOID_FORWARD,
                      f"the kernel's spirals of the plan's goals: {e_fwd:.2e}")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(N_PLANS):
            plan = planner.plan(target, obstacles)
        torch.cuda.synchronize()
        ms[mode] = 1e3 * (time.perf_counter() - t0) / N_PLANS
        launches[mode] = read_launches()
    print(f"LatticePlanner (8x9x5 = 360 goals) against the JAX f32 golden, "
          f"with and without obstacles: oracle mode (the clothoid solver) "
          f"max|err| "
          f"{max(v for k, v in errs.items() if k.startswith('oracle')):.2e}, "
          f"the planner fed the JAX net's spirals "
          f"{max(v for k, v in errs.items() if k.startswith('jax')):.2e} (tol "
          f"rtol {TOL_PLAN['rtol']} atol {TOL_PLAN['atol']}); net mode: the "
          f"kernel's spirals of the goals against JAX's max|err| "
          f"{e_fwd:.2e} (tol {TOL_CLOTHOID_FORWARD}), the same goal chosen; "
          f"per plan (host clock, {N_PLANS} plans): net {ms['net']:.3f} ms,"
          f" oracle {ms['oracle']:.3f} ms; launches {launches}", flush=True)
    check(launches["net"]["rbf_forward"] == N_PLANS,
          f"one kernel forward per plan: {launches['net']}")
    return launches["net"]["rbf_forward"], ms


def clothoid_chain(device):
    """Phases 28-31. Returns the rbf_forward launches of each path and the
    numbers of the kernels line."""
    with np.load(CLOTHOID_GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    with tempfile.TemporaryDirectory() as out_dir:
        lut = phase_clothoid_lut(device, g, out_dir)
        net = phase_clothoid_net(device, g, lut)
        _, _, fit_launches = phase_clothoid_fit(device, lut, net["means"],
                                                out_dir)
    del lut
    plan_launches, plan_ms = phase_lattice_planner(device, g)
    return dict(eval=net["launches"], fit=fit_launches,
                planner=plan_launches), net


# ------------------------------------------------------ the cartesian chain

def phase_cartesian_chain(device):
    """Phase 32: a cut cartesian table on the card, the straggler patch,
    the cart_c1_pr recipe on it, the fitted net in the closed loop, and
    eval_nmpc_oracle on N_ORACLE_ROWS rows."""
    import torch

    from irbfn_tpu_torch.parallel import gen_nmpc_table_cartesian as gc
    from irbfn_tpu_torch.parallel import patch_table_stragglers as pt
    from irbfn_tpu_torch.parallel.datagen import save_table
    from irbfn_tpu_torch.sim import eval_closed_loop as ev
    from irbfn_tpu_torch.solvers import eval_nmpc_oracle as evo
    from irbfn_tpu_torch.train import train_cartesian as tc

    dev = str(device)
    with tempfile.TemporaryDirectory() as d:
        args = gc.parse_args(list(CART_TABLE_ARGS) + [
            "--batch_per_device", str(NMPC_CHUNK), "--resolve_factor", "0",
            "--run_tag", "_cut", "--save_path", d, "--device", dev])
        res, _ = _quiet("phase32_gen_nmpc_table_cartesian.log",
                        gc.solve_table, args)
        n = len(res["rows"])
        path = gc.table_name(args, res["grid"])
        save_table(path, gc.cartesian_table(res["rows"], res["sol"]))
        counts = "x".join(str(s.num) for s in res["grid"])
        p, _ = _quiet("phase32_patch_table_stragglers.log", pt.patch,
                      pt.parse_args(["--npz_path", path, "--batch_per_device",
                                     str(NMPC_CHUNK), "--device", dev]))
        np.savez(path, **p["data"])
        valid = p["data"]["valid"]
        fit, _ = _quiet("phase32_train_cartesian.log", tc.main,
                        list(CART_FIT_ARGS) + [
                            "--npz_path", path, "--run_name", "cart_card",
                            "--device", dev, "--out_dir", d])
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop, _ = _quiet("phase32_eval_closed_loop.log", ev.run,
                         ev.parse_args([
                             "--planner", "irbfn_cart", "--config_f",
                             fit["config_path"], "--ckpt", fit["ckpt_dir"],
                             "--n_steps", str(N_RECORD_STEPS),
                             "--max_retries",
                             "0", "--device", dev]))
        torch.cuda.synchronize()
        t_loop = time.perf_counter() - t0
        launches = read_launches()
    with np.load(CART_ASSET + "_golden.npz") as z:
        committed = int((~z["loop_done"]).sum())
    t0 = time.perf_counter()
    m, _ = _quiet("phase32_eval_nmpc_oracle.log", evo.main,
                  ["--n_rows", str(N_ORACLE_ROWS), "--device", dev])
    t_oracle = time.perf_counter() - t0
    print(f"cartesian chain on the card: table {n:,} rows, REDUCED (counts "
          f"only) to {counts} over the reference ranges, chunks of "
          f"{NMPC_CHUNK:,}, made without its straggler pass: cheap pass "
          f"certified {100 * res['certified_cheap']:.1f}%, "
          f"{100 * res['feasible_tiered']:.1f}% feasible, seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in res["seconds"].items())
          + f", solves/s {res['rates']['tiered']:,.0f}; "
          f"patch_table_stragglers (4x budget) recovered "
          f"{int(p['recovered'].sum()):,}/{p['bad'].size:,} in "
          f"{p['seconds']:.1f} s -> {100 * valid.mean():.1f}% feasible; "
          f"train_cartesian (cart_c1_pr's recipe) control L1 "
          f"{fit['fit_l1']:.4f}; the fitted net in eval_closed_loop "
          f"--planner irbfn_cart over the sweep ({N_RECORD_STEPS} steps, "
          f"{t_loop:.1f} s): completion {100 * loop['completion'].mean():.1f}%"
          f" on one attempt (the committed cart_c1_pr in the JAX golden of "
          f"phase 25: {committed}/1000 lanes), mean|ey| "
          f"{np.nanmean(loop['ey']):.4f} m; "
          f"launches {launches}; eval_nmpc_oracle on {N_ORACLE_ROWS} rows "
          f"({t_oracle:.1f} s): oracle feasible {m['oracle_feasible']}, "
          f"solver {m['al_feasible']}, both {m['both_feasible']}, relative "
          f"objective gap p50 {m['rel_obj_gap_p50']:.2e} p90 "
          f"{m['rel_obj_gap_p90']:.2e}, control difference p50 "
          f"{m['du_max_p50']:.2e}", flush=True)
    check(valid.mean() >= 0.5, f"only {valid.mean():.1%} feasible")
    check(bool(np.isfinite(fit["fit_l1"])), "non-finite fit")
    check(bool(np.isfinite(loop["ey"]).all()
               and np.isfinite(loop["completion"]).all()),
          "non-finite closed-loop results")
    check(launches["rbf_forward"] >= N_RECORD_STEPS,
          f"the loop's rbf_forward launches {launches}")
    check(m["rel_obj_gap_p50"] < 1e-6 and m["rel_obj_gap_p90"] < 1e-4,
          f"eval_nmpc_oracle: {m}")
    return launches["rbf_forward"]


# ------------------------- the linear-MPC family and the rest of the sim

QUAD_ASSET = os.path.join(ASSETS, "quadrotor_pr")
QUAD_RESULTS = os.path.join(ROOT, "data", "quadrotor_results.json")
TRACKING_GOLDEN = os.path.join(ASSETS, "tracking_golden.npz")
SIM_GOLDEN = os.path.join(ASSETS, "sim_golden.npz")
OVERTAKE_GOLDEN = os.path.join(ASSETS, "overtake_golden.npz")
PPO_GOLDEN = os.path.join(ASSETS, "ppo_golden.npz")
DEMO_GOLDEN = os.path.join(ASSETS, "demo_golden.npz")
N_QP = 1024  # random QPs of phase 33, the card's f64 against the CPU's
PPO_UPDATES = 6  # train_ppo's updates in phase 38 (its curve is 120)
DEMO_STEPS = 400  # demo_closed_loop's default

# - the linear MPC's first controls against the JAX f32 golden: both solves
#   stop at the residual tolerance 1e-4, so their controls agree to it
#   (a CPU: 2.5e-5), the converged flags exactly, sweep counts within one;
TOL_QP_CONTROLS = 1e-4
# - solve_qp_batch in f64, card against CPU: LAPACK and cuSOLVER Cholesky
#   factors differ in the last place, tests/test_torch_qp.py holds the CPU
#   against JAX at 1e-10;
TOL_QP_F64 = 1e-9
# - quadrotor_pr (sum |w| 7.1e4 and 1.5e5 per output, the flagship's
#   regime): an f32 forward is ~2.3e-3 from f64 on a CPU, so the kernel and
#   the plain version agree to the flagship's 1e-3 relative and each to f64
#   to 5e-3; its 80-step regulation loop contracts, and holds that in the
#   states; the re-solved MPC's loop converges each solve to 1e-4;
TOL_QUAD_F64 = 5e-3
TOL_QUAD_RING_NET = 5e-3
TOL_QUAD_RING_MPC = 1e-4
TOL_QUAD_RATIO = 1.25  # train L1 and off-grid MAE against the JAX script's
# - ... and against the JAX script's own run of today's code at its defaults
#   (the golden's ``script_*``; the committed results JSON is older: the
#   port's plain f32 run on a CPU was 0.2% from today's run in train L1 and
#   off-grid MAE, 3% from the JSON's): 5% relative
TOL_QUAD_SCRIPT = 0.05
# - lidar: tests/test_torch_lidar.py's f32 limits (1e-5 m, and a beam may
#   take its first outside sample one sample apart where that sample ties
#   the half width in f32: at most 0.1% of beams);
TOL_LIDAR_M = 1e-5
TOL_LIDAR_TIES = 1e-3
# - the agent-aware scans 1e-4 m, and rect flags on agents clear of a SAT
#   tie by 1e-4 (tests/test_torch_multi_agent.py);
TOL_MA_SCAN = 1e-4
TOL_SAT_TIE = 1e-4
# - the overtake demo's first 30 steps against JAX's f32 rollout (a CPU:
#   4e-6 m); on the card the clothoid solves and the cost sums run in
#   another order, before an argmin tie can branch: 1e-3 m. The outcome: the
#   overtake at the same step within 3, the same collision verdict;
TOL_OVERTAKE_M = 1e-3
TOL_OVERTAKE_STEPS = 3
# - one PPO update with JAX's draws: tests/test_torch_ppo.py's
#   TOL_UPDATE_FULL (the 64-step rollout's f32 dynamics already differ by
#   ~1.5e-4 relative in the reward), per parameter tensor, relative norm.
TOL_PPO_UPDATE = 1e-3
# - the closed-loop demos against the JAX script's printed results (0.1 m
#   and 1 mm digits): the same laps and verdict, progress within 1 m, mean
#   |ey| within 5 mm (the port's plain f32 runs on a CPU printed the same
#   digits for all three planners).
TOL_DEMO_PROGRESS_M = 1.0
TOL_DEMO_EY_M = 5e-3


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _quad_bound(B):
    """quadrotor_pr's forward (R=16, K=256, F=4, O=2): B R K (3F + 6 + 2O)
    + 8 B R F = 90,624 B operations."""
    R, K, F, O = 16, 256, 4, 2
    return _bound(float(B * R * K * (3 * F + 6 + 2 * O) + 8 * B * R * F),
                  4.0 * (B * (F + O) + R * K * (F + 1) + (R * K + R) * O))


def phase_linear_mpc(device, g):
    """Phase 33: the quadrotor lattice (9^4 + 32,768 = 39,329 condensed
    QPs, n = 20, up to 1000 sweeps) on the card against the JAX f32 golden;
    solve_qp_batch on 1,024 seeded random QPs in f64, card against CPU."""
    import torch

    from irbfn_tpu_torch._device import wait_clock
    from irbfn_tpu_torch.solvers.qp import (double_integrator_mpc,
                                            solve_linear_mpc_batch,
                                            solve_qp_batch)
    from irbfn_tpu_torch.train.quadrotor_pipeline import lattice

    _, x0 = lattice(9, 32768)
    mpc = double_integrator_mpc(device=device)
    x = torch.as_tensor(x0, device=device)
    solve_linear_mpc_batch(mpc, x[:64], torch.zeros_like(x[:64]))  # warm
    t0 = wait_clock(device)
    ctrl, sol = solve_linear_mpc_batch(mpc, x, torch.zeros_like(x))
    sec = wait_clock(device) - t0
    u0 = ctrl[:, 0].cpu().numpy()
    conv = sol.converged.cpu().numpy()
    its = sol.iterations.cpu().numpy()
    err = float(np.abs(u0 - g["lat_controls_f32"]).max())
    d_its = np.abs(its.astype(int) - g["lat_iterations_f32"])
    rng = np.random.default_rng(5)
    n, m = 8, 12
    Ms = rng.normal(size=(N_QP, n, n))
    ops = (np.einsum("bij,bkj->bik", Ms, Ms) + 0.5 * np.eye(n),
           rng.normal(size=(N_QP, n)), rng.normal(size=(N_QP, m, n)),
           -rng.uniform(0.1, 1.0, (N_QP, m)), rng.uniform(0.1, 1.0, (N_QP, m)))
    t0 = wait_clock(device)
    sc = solve_qp_batch(*(torch.as_tensor(a, device=device) for a in ops))
    sec_qp = wait_clock(device) - t0
    sh = solve_qp_batch(*(torch.as_tensor(a) for a in ops))
    e_qp = float((sc.x.cpu() - sh.x).abs().max())
    it_c, it_h = sc.iterations.cpu().numpy(), sh.iterations.numpy()
    print(f"linear MPC: the quadrotor lattice, {len(x0):,} condensed QPs "
          f"(n=20, shared P, A=I) in {sec:.3f} s = {len(x0) / sec:,.0f} QP "
          f"solves/s, {int(its.max()) + 1} sweeps, "
          f"{100 * conv.mean():.2f}% converged (JAX f32 "
          f"{100 * g['lat_converged_f32'].mean():.2f}%); first controls "
          f"against the JAX f32 golden max|err| {err:.2e} (tol "
          f"{TOL_QP_CONTROLS}), sweep counts differ in "
          f"{int((d_its > 0).sum())} rows, by at most {int(d_its.max())}; "
          f"solve_qp_batch on {N_QP} random QPs (n={n}, m={m}) in f64: card "
          f"{sec_qp:.2f} s ({int(it_c.max())} sweeps, "
          f"{100 * float(sc.converged.float().mean()):.1f}% converged) "
          f"against the CPU max|dx| {e_qp:.2e}, iterations differ in "
          f"{int((it_c != it_h).sum())} rows", flush=True)
    check(err <= TOL_QP_CONTROLS and bool(np.isfinite(u0).all()),
          f"linear MPC vs JAX f32: {err}")
    check(bool((conv == g["lat_converged_f32"]).all()) and d_its.max() <= 1,
          "linear MPC converged flags or sweep counts differ from JAX's")
    check(e_qp <= TOL_QP_F64 and bool((it_c == it_h).all())
          and bool((sc.converged.cpu() == sh.converged).all()),
          f"solve_qp_batch f64 card vs CPU: {e_qp}")


def phase_quadrotor(device, g):
    """Phase 34: the quadrotor pipeline's run at the script's defaults on
    the card (lattice, solve, fit, save, off-grid eval, both closed loops),
    and the committed quadrotor_pr through the kernel against its plain
    version and the JAX goldens. Returns the rbf_forward launches of the
    run and of the committed net's loop, and its times."""
    import torch

    from irbfn_tpu_torch.ops import rbf
    from irbfn_tpu_torch.solvers.qp import double_integrator_mpc
    from irbfn_tpu_torch.train import quadrotor_pipeline as Q

    with tempfile.TemporaryDirectory() as d:
        args = Q.parse_args(["--save_path", d, "--out_dir", d,
                             "--device", str(device)])
        reset_launches()
        t0 = time.perf_counter()
        out, _ = _quiet("phase34_quadrotor_pipeline.log", Q.run, args,
                        device)
        wall = time.perf_counter() - t0
        run_launches = read_launches()
    res = out["results"]
    with open(QUAD_RESULTS) as f:
        ref = json.load(f)
    net, _ = _asset(QUAD_ASSET, device)
    ops = rbf.wcrbf_params_to_kernel(net)
    x = torch.as_tensor(g["off_x"], device=device)
    xs = (x * net.input_scale).contiguous()
    e_plain = _compare("quadrotor_pr B=4096", xs, ops, TOL_FLAGSHIP,
                       relative=True)
    _compare("quadrotor_pr B=64", xs[:64].contiguous(), ops, TOL_FLAGSHIP,
             relative=True)
    with torch.no_grad():
        e_f64 = _max_err(net(x), torch.as_tensor(g["off_forward_f64"],
                                                 device=device))
    mpc = double_integrator_mpc(device=device)
    s = torch.as_tensor(g["ring_starts"], device=device)
    reset_launches()
    tr_net = Q.roll_net(net, mpc, s).cpu().numpy()
    loop_launches = read_launches()
    tr_mpc = Q.roll_mpc(mpc, s).cpu().numpy()
    e_ring_net = float(np.abs(tr_net - g["ring_net_f32"]).max())
    e_ring_mpc = float(np.abs(tr_mpc - g["ring_mpc_f32"]).max())
    ring = Q.regulation(tr_net, tr_mpc)
    x64 = xs[:64].contiguous()
    with torch.no_grad():
        ms_4k, t_4k = _in_turns(lambda: rbf.wcrbf_forward_reference(xs, ops),
                                lambda: rbf.wcrbf_forward(xs, ops), 50, 5)
        ms_64, t_64 = _in_turns(lambda: rbf.wcrbf_forward_reference(x64,
                                                                    ops),
                                lambda: rbf.wcrbf_forward(x64, ops))
    b_4k, b_64 = _quad_bound(4096), _quad_bound(64)
    print(f"quadrotor pipeline on the card (run at the script's defaults, "
          f"{wall:.1f} s): seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in out["seconds"].items())
          + f"; lattice {out['solve']['rate']:,.0f} QP solves/s, "
          f"{out['solve']['sweeps']} sweeps, "
          f"{100 * out['solve']['converged']:.2f}% converged; train L1 "
          f"{res['train_l1']:.4f} (the committed results "
          f"{ref['train_l1']:.4f}, the JAX script's run on a CPU "
          f"{float(g['script_train_l1']):.4f}), off-grid MAE "
          f"{res['off_grid_mae']:.4f} ({ref['off_grid_mae']:.4f}, "
          f"{float(g['script_off_grid_mae']):.4f}); final distance of the "
          f"net in the JAX script's run "
          f"{float(g['script_final_dist_net']):.4f} m; regulation from the "
          f"r=2.5 ring: "
          f"final distance net {res['final_dist_net']:.4f} m "
          f"({ref['final_dist_net']:.4f}), MPC {res['final_dist_mpc']:.2e} "
          f"m ({ref['final_dist_mpc']:.2e}), settled net "
          f"{100 * res['settle_frac_net']:.1f}% "
          f"({100 * ref['settle_frac_net']:.0f}%), MPC "
          f"{100 * res['settle_frac_mpc']:.1f}% "
          f"({100 * ref['settle_frac_mpc']:.0f}%); launches {run_launches}; "
          f"the committed quadrotor_pr: kernel vs plain rel max|err| "
          f"{e_plain:.2e} at B=4096, vs JAX f64 {e_f64:.2e} (tol "
          f"{TOL_QUAD_F64}); its 80-step loop from the 64 starts vs JAX f32 "
          f"max|dx| {e_ring_net:.2e}, the re-solved MPC's {e_ring_mpc:.2e}; "
          f"{ring}; launches in its loop {loop_launches}; times (CUDA "
          f"events, in turns): B=4096 kernel {ms_4k['kernel']:.4f} ms plain "
          f"{ms_4k['plain']:.4f} ms (runs {t_4k['kernel']} / "
          f"{t_4k['plain']}; bound {b_4k[0]:.5f} ms by {b_4k[1]}), B=64 "
          f"kernel {ms_64['kernel']:.4f} ms plain {ms_64['plain']:.4f} ms "
          f"(runs {t_64['kernel']} / {t_64['plain']}; bound "
          f"{b_64[0]:.6f} ms)", flush=True)
    check(res["train_l1"] <= TOL_QUAD_RATIO * ref["train_l1"]
          and res["off_grid_mae"] <= TOL_QUAD_RATIO * ref["off_grid_mae"],
          f"quadrotor pipeline: {res} against {ref}")
    check(all(abs(res[k] / float(g[f"script_{k}"]) - 1.0) <= TOL_QUAD_SCRIPT
              for k in ("train_l1", "off_grid_mae")),
          f"quadrotor pipeline against the JAX script's run: {res}")
    check(res["settle_frac_mpc"] == 1.0, f"the re-solved MPC: {res}")
    check(run_launches["rbf_forward"] >= 80 + 2,
          f"the run's launches {run_launches}")
    check(e_f64 <= TOL_QUAD_F64, f"quadrotor_pr vs JAX f64: {e_f64}")
    check(e_ring_net <= TOL_QUAD_RING_NET
          and e_ring_mpc <= TOL_QUAD_RING_MPC,
          f"regulation loops vs JAX: {e_ring_net}, {e_ring_mpc}")
    check(loop_launches["rbf_forward"] == 80,
          f"the committed net's loop launches {loop_launches}")
    return dict(run=run_launches["rbf_forward"],
                loop=loop_launches["rbf_forward"], max_abs_err=e_plain,
                ms_4096=ms_4k["kernel"], plain_ms_4096=ms_4k["plain"],
                bound_ms_4096=b_4k[0], ms_64=ms_64["kernel"],
                plain_ms_64=ms_64["plain"], bound_ms_64=b_64[0])


def phase_tracking(device, g):
    """Phase 35: the LTV tracking MPC on 1,000 seeded curving references:
    one admm_solve launch (lane variant) per solve, the kernel against its
    plain version on the solve's operands and against the JAX f64 golden;
    ms per solve. Returns the launches and the times."""
    import torch

    from irbfn_tpu_torch.ops import admm
    from irbfn_tpu_torch.solvers import goal_mpc as gm

    rows = [torch.as_tensor(g[k], dtype=torch.float32, device=device)
            for k in ("x0", "ref", "pp")]
    F = rows[0].shape[0]
    cfg = gm.GoalMPCConfig()
    reset_launches()
    sol = gm.solve_tracking_mpc(*rows)
    torch.cuda.synchronize()
    launches = read_launches()
    ops = gm._tracking_operands(*rows, cfg, 1e-6)
    err, flips, _, _ = _admm_errors(ops, 600, admm.admm_solve,
                                    admm.admm_solve_reference)
    e64 = {k: float(np.abs(getattr(sol, k).double().cpu().numpy()
                           - g[f"{k}_f64"]).max())
           for k in ("speed", "steer", "controls")}
    conv = sol.converged.cpu().numpy()
    res64 = np.maximum(g["r_prim_f64"], g["r_dual_f64"])
    far = np.abs(res64 - 2e-3) > TOL_RES_BAND
    n_flip = int(((conv != g["converged_f64"]) & far).sum())
    ms_solve = _time_ms(lambda: gm.solve_tracking_mpc(*rows), 20, 2)
    ms, t = _in_turns(lambda: admm.admm_solve_reference(*ops, iters=600),
                      lambda: admm.admm_solve(*ops, iters=600), 10, 2)
    b = _bound(_admm_flops(F, 1, 600), _admm_bytes(F, 1))
    print(f"tracking MPC: {F} curving references (F={F} one-row families, "
          f"variant {admm.admm_variant(F, 1)}), {100 * conv.mean():.1f}% "
          f"converged (JAX f64 {100 * g['converged_f64'].mean():.1f}%); "
          f"kernel vs plain {err}, converged flags differ in {flips[0]} "
          f"rows ({flips[1]} outside the noise band); against JAX f64 "
          f"{e64} (tol {TOL_F64}), {n_flip} flags differ outside the band; "
          f"launches {launches} for one solve; a solve {ms_solve:.3f} ms "
          f"(host and card), its ADMM kernel {ms['kernel']:.4f} ms, plain "
          f"{ms['plain']:.4f} ms (runs {t['kernel']} / {t['plain']}), bound "
          f"{b[0]:.5f} ms by {b[1]}", flush=True)
    _check_admm("tracking MPC", err, flips)
    check(max(e64.values()) <= TOL_F64 and n_flip == 0,
          f"tracking MPC vs JAX f64: {e64}, {n_flip} flags")
    check(launches["admm_solve"] == 1,
          f"one solve launched {launches} (one ADMM launch expected)")
    return dict(launches=launches["admm_solve"], max_abs_err=err["controls"],
                ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=b[0],
                ms_solve=ms_solve)


def phase_lidar_multi_agent(device, g):
    """Phase 36: a 1,000-pose corridor scan on the oval against the JAX
    golden (ms per scan, peak memory), and the agent-aware scans and both
    collision models on a seeded 1,000 x 4-car batch."""
    import torch

    from irbfn_tpu_torch.dynamics.params import f1tenth_params
    from irbfn_tpu_torch.sim import lidar, multi_agent
    from irbfn_tpu_torch.sim.map import linspace

    pts = torch.as_tensor(g["lidar_points"], device=device)
    pose = torch.as_tensor(g["lidar_pose"], device=device)
    torch.cuda.reset_peak_memory_stats(device)
    r = lidar.scan(pts, 2.0, *pose.T)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    d = np.abs(r.cpu().numpy() - g["lidar_f32"])
    spec = lidar.LidarSpec()
    ties = d > TOL_LIDAR_M
    step = spec.max_range / (spec.n_samples - 1)
    ms_scan = _time_ms(lambda: lidar.scan(pts, 2.0, *pose.T), 10, 2)
    x = torch.as_tensor(g["ma_x"], device=device)
    base = torch.full(x.shape[:2] + (64,), 30.0, device=device)
    angles = linspace(-4.7 / 2, 4.7 / 2, 64, torch.float32, device)
    e_scan = float(np.abs(multi_agent.ray_cast_footprints(
        x, base, angles).cpu().numpy() - g["ma_scan_f32"]).max())
    p = f1tenth_params(device=device)
    eye = np.eye(x.shape[1], dtype=bool)
    clear = np.all((np.abs(g["ma_margin_rect"]) >= TOL_SAT_TIE) | eye, -1)
    flags = {m: multi_agent.pairwise_collisions(
        x, p, collision_model=m).cpu().numpy() for m in ("rect", "discs")}
    bad = {"rect": int((flags["rect"] != g["ma_rect_f32"])[clear].sum()),
           "discs": int((flags["discs"] != g["ma_discs_f32"]).sum())}
    ms_ma = _time_ms(lambda: (multi_agent.ray_cast_footprints(x, base,
                                                              angles),
                              multi_agent.pairwise_collisions(x, p)), 20, 2)
    print(f"lidar and multi-agent: {len(pose)} corridor scans (64 beams x "
          f"64 samples x {len(pts)} segments) against JAX f32: "
          f"{int(ties.sum())} of {d.size:,} beams a sample apart, the rest "
          f"max|err| {d[~ties].max():.2e} m; {ms_scan:.3f} ms per "
          f"1000-pose scan, peak {peak:.2f} GiB; {len(x)} x {x.shape[1]} "
          f"cars: agent-aware scans max|err| {e_scan:.2e} m, rect flags "
          f"({100 * flags['rect'].mean():.1f}% hit) differ on {bad['rect']} "
          f"of {int(clear.sum())} agents clear of a tie "
          f"({int((~clear).sum())} near one), disc flags on {bad['discs']}; "
          f"scans and rect flags {ms_ma:.3f} ms", flush=True)
    check(ties.mean() <= TOL_LIDAR_TIES
          and bool(np.allclose(d[ties], step, rtol=1e-4))
          and float(d[~ties].max()) <= TOL_LIDAR_M,
          "lidar scans vs JAX f32")
    check(e_scan <= TOL_MA_SCAN and bad["rect"] == 0 and bad["discs"] == 0,
          f"multi-agent vs JAX f32: scans {e_scan}, flags {bad}")


def phase_overtake(device, g):
    """Phase 37: the overtake demo's run at its defaults (300 steps, the
    360-goal oracle lattice) in both modes: the first 30 steps against JAX's
    rollout, the outcome against JAX's run, ms per control step."""
    from irbfn_tpu_torch.sim import demo_overtake as dov

    lines, outs = [], {}
    for mode in ("pose", "scan"):
        flags = ["--device", str(device)] + (["--from_scan"]
                                             if mode == "scan" else [])
        out, _ = _quiet(f"phase37_demo_overtake_{mode}.log", dov.run,
                        dov.parse_args(flags))
        k = g[f"{mode}_x"].shape[0]
        e = float(np.abs(out["traj_x"][:k] - g[f"{mode}_x"]).max())
        want = dov.outcome(g[f"{mode}_all_s"], g[f"{mode}_all_hit"],
                           float(out["track"].raceline.length))
        outs[mode] = (out, want, e)
        lines.append(
            f"{mode}: first {k} steps max|dx| {e:.2e} m, overtake at step "
            f"{out['overtake_step']} (JAX {want['overtake_step']}), "
            f"collision {out['collision_step']} (JAX "
            f"{want['collision_step']}), final margin "
            f"{out['final_margin']:.2f} m (JAX {want['final_margin']:.2f}); "
            f"{out['ms_per_step']:.2f} ms per control step")
    print("overtake demo (2 cars, lattice planner in oracle mode, 360 goals, "
          "300 steps): " + "; ".join(lines), flush=True)
    for mode, (out, want, e) in outs.items():
        check(e <= TOL_OVERTAKE_M, f"overtake {mode}: first steps {e}")
        check((out["collision_step"] is None)
              == (want["collision_step"] is None),
              f"overtake {mode}: collision {out['collision_step']} vs JAX "
              f"{want['collision_step']}")
        check(out["overtake_step"] is not None
              and want["overtake_step"] is not None
              and abs(out["overtake_step"] - want["overtake_step"])
              <= TOL_OVERTAKE_STEPS,
              f"overtake {mode}: step {out['overtake_step']} vs JAX "
              f"{want['overtake_step']}")


def _ppo_replay(g, device):
    """A PPOTrainer._draw handing out the JAX side's draws in order, on
    ``device``."""
    import torch

    kinds = list(g["draw_kinds"])
    queue = [g[f"draw_{i}"] for i in range(len(kinds))]
    want = {"s0": "uniform", "action": "categorical", "perm": "permutation"}

    def draw(kind, arg):
        check(kinds.pop(0) == want[kind], f"PPO draw {kind} out of order")
        v = torch.as_tensor(queue.pop(0), device=device)
        return v.to(torch.float32 if kind == "s0" else torch.int64)

    return draw


def phase_ppo(device, g):
    """Phase 38: train_ppo at its widths (64 envs x 64 steps, 7 actions,
    hidden 64-64) for PPO_UPDATES updates, one update from the JAX side's
    parameters with its draws against the JAX golden, and one from the
    port's own (``_ppo_own_draws``)."""
    import torch

    from irbfn_tpu_torch.train import ppo, train_ppo
    from irbfn_tpu_torch.train.checkpoints import unflatten_tree

    with tempfile.TemporaryDirectory() as d:
        curve, _ = _quiet("phase38_train_ppo.log", train_ppo.main, [
            "--n_updates", str(PPO_UPDATES), "--device", str(device),
            "--out", os.path.join(d, "curve.json")])
    hist = curve["history"]
    p0, p1 = (unflatten_tree({k[3:]: v for k, v in g.items()
                              if k.startswith(f"p{i}_")}) for i in (0, 1))
    trainer = ppo.PPOTrainer(train_ppo.make_env(device), ppo.PPOConfig(),
                             n_lattice=7, seed=0)
    ppo.load_flax_params(trainer.net, p0)
    trainer._draw = _ppo_replay(g, device)
    h1 = trainer.train(n_updates=1)[0]
    errs = _ppo_update_errors(trainer, p1)
    e_metric = {k: abs(v - float(g[f"metric_{k}"])) for k, v in h1.items()}
    print(f"PPO: train_ppo {PPO_UPDATES} updates of 64 envs x 64 steps "
          f"(REDUCED: the committed curve has 120) at "
          f"{curve['env_steps_per_s']:,.0f} env steps/s; reward "
          f"{hist[0]['reward']:.4f} -> {hist[-1]['reward']:.4f}, progress "
          f"{hist[0]['mean_progress']:.1f} -> {hist[-1]['mean_progress']:.1f}"
          f" m; one update from JAX's parameters with its draws: parameter "
          f"tensors' relative error max {max(errs):.2e} (tol "
          f"{TOL_PPO_UPDATE}), metrics {h1} (JAX "
          + ", ".join(f"{k} {float(g['metric_' + k]):.6f}" for k in h1)
          + ")", flush=True)
    check(all(np.isfinite(v) for h in hist for v in h.values()),
          "non-finite PPO history")
    check(hist[-1]["mean_progress"] > hist[0]["mean_progress"],
          f"PPO progress does not rise: {hist}")
    check(max(errs) <= TOL_PPO_UPDATE
          and max(e_metric.values()) <= TOL_PPO_UPDATE * max(
              1.0, max(abs(v) for v in h1.values())),
          f"PPO update vs JAX: {errs}, {e_metric}")
    _ppo_own_draws(device, g, p0, p1)


def _ppo_update_errors(trainer, p1):
    """Each parameter tensor's relative error against the golden's p1."""
    errs = []
    for i, layer in enumerate(trainer.net.dense_layers()):
        w = p1["params"][f"Dense_{i}"]
        for got, ref in ((layer.weight.detach().T, w["kernel"]),
                         (layer.bias.detach(), w["bias"])):
            errs.append(float(np.linalg.norm(got.cpu().numpy() - ref)
                              / np.linalg.norm(ref)))
    return errs


def _ppo_own_draws(device, g, p0, p1):
    """Phase 38's run without replay: ``PPOTrainer(seed=0)`` on the card
    makes its initial weights and its 70 draws from JAX's key chain."""
    import torch

    from irbfn_tpu_torch.train import ppo, train_ppo
    from irbfn_tpu_torch.utils import prng

    trainer = ppo.PPOTrainer(train_ppo.make_env(device), ppo.PPOConfig(),
                             n_lattice=7, seed=0)
    e_p0 = max(float(np.abs(
        layer.weight.detach().T.cpu().numpy()
        - p0["params"][f"Dense_{i}"]["kernel"]).max())
        for i, layer in enumerate(trainer.net.dense_layers()))
    own, drawn = trainer._draw, []

    def recording(kind, arg):
        key = trainer.key
        v = own(kind, arg)
        margin = None
        if kind == "action":  # the gap between the best two noisy logits
            z = prng.gumbel(prng.split(key)[1], arg.shape) + arg
            top = torch.topk(z, 2, dim=-1).values
            margin = (top[:, 0] - top[:, 1]).cpu().numpy()
        drawn.append((kind, v.cpu().numpy(), margin))
        return v

    trainer._draw = recording
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h1 = trainer.train(n_updates=1)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kinds = list(g["draw_kinds"])
    want = {"s0": "uniform", "action": "categorical", "perm": "permutation"}
    check([want[k] for k, _, _ in drawn] == kinds,
          f"PPO's own draws: kinds {[k for k, _, _ in drawn]}")
    n_uniform = n_perm = n_lanes = 0
    bad_uniform = bad_perm = n_flip = n_flip_near = 0
    for i, (kind, v, margin) in enumerate(drawn):
        ref = g[f"draw_{i}"]
        if kind == "s0":
            n_uniform += 1
            bad_uniform += int(not np.array_equal(v.view(np.int32),
                                                  ref.view(np.int32)))
        elif kind == "perm":
            n_perm += 1
            bad_perm += int(not np.array_equal(v, ref))
        else:
            n_lanes += v.size
            flip = v != ref
            n_flip += int(flip.sum())
            n_flip_near += int((flip & (margin < 1e-5)).sum())
    errs = _ppo_update_errors(trainer, p1)
    e_metric = {k: abs(v - float(g[f"metric_{k}"])) for k, v in h1.items()}
    print(f"PPO, PPOTrainer(seed=0)'s own weights and draws (no replay): "
          f"initial weights max|diff| from JAX's p0 {e_p0:.1e} (tol 0); "
          f"{n_uniform - bad_uniform}/{n_uniform} uniforms and "
          f"{n_perm - bad_perm}/{n_perm} permutations bit for bit; "
          f"categorical actions differ on {n_flip}/{n_lanes} lanes "
          f"({n_flip_near} with a gumbel margin under 1e-5; predicted 0); "
          f"update's parameter tensors' relative error max {max(errs):.2e}"
          f" (tol {TOL_PPO_UPDATE}), metrics {h1}; {wall:.2f} s",
          flush=True)
    check(e_p0 == 0.0, f"PPO's own initial weights vs JAX's p0: {e_p0}")
    check(bad_uniform == 0 and bad_perm == 0,
          f"PPO's own draws: {bad_uniform} uniforms, {bad_perm} "
          "permutations differ from JAX's")
    check(n_flip == n_flip_near, f"PPO's own actions: {n_flip} lanes "
          f"differ from JAX's, {n_flip - n_flip_near} by a margin over 1e-5")
    check(max(errs) <= TOL_PPO_UPDATE
          and max(e_metric.values()) <= TOL_PPO_UPDATE * max(
              1.0, max(abs(v) for v in h1.values())),
          f"PPO's own update vs JAX: {errs}, {e_metric}")


def phase_demos(device, g):
    """Phase 39: demo_closed_loop at its defaults (400 steps) for pursuit,
    irbfn (frenet_wide_pr1) and goal_mpc against the JAX script's results,
    with both kernels' launches counted, and the demo_traj_fan net fan (450
    goals, clothoid_pr) through the kernel against its plain version."""
    import torch

    from irbfn_tpu_torch.ops import wcrbf_params_to_kernel
    from irbfn_tpu_torch.planning import demo_traj_fan as fan
    from irbfn_tpu_torch.sim import demo_closed_loop as dcl

    lines, launches = [], {}
    for planner, extra in (("pursuit", []),
                           ("irbfn", ["--config_f", ASSET + ".json",
                                      "--ckpt", ASSET + ".npz"]),
                           ("goal_mpc", [])):
        reset_launches()
        out, _ = _quiet(f"phase39_demo_closed_loop_{planner}.log", dcl.run,
                        dcl.parse_args(["--planner", planner, "--device",
                                        str(device)] + extra))
        launches[planner] = read_launches()
        lines.append(f"{planner} laps {out['laps']}, progress "
                     f"{out['progress']:.1f} m, mean|ey| {out['ey']:.4f} m, "
                     f"{'CRASHED' if out['crashed'] else 'ok'} (JAX laps "
                     f"{int(g[planner + '_laps'])}, "
                     f"{float(g[planner + '_progress']):.1f} m, "
                     f"{float(g[planner + '_ey']):.3f} m), "
                     f"{DEMO_STEPS / out['wall']:.1f} control steps/s, "
                     f"launches {launches[planner]}")
        check(np.isfinite(out["ey"])
              and out["crashed"] == bool(g[planner + "_crashed"])
              and out["laps"] == int(g[planner + "_laps"])
              and abs(out["progress"] - float(g[planner + "_progress"]))
              <= TOL_DEMO_PROGRESS_M
              and abs(out["ey"] - float(g[planner + "_ey"])) <= TOL_DEMO_EY_M,
              f"demo_closed_loop {planner}: {lines[-1]}")
    reset_launches()
    out = fan.run(fan.parse_args(["--device", str(device), "--config_f",
                                  CLOTHOID_ASSET + ".json", "--ckpt",
                                  CLOTHOID_ASSET + ".npz"]))
    launches["traj_fan"] = read_launches()
    net, _ = _asset(CLOTHOID_ASSET, device)
    e_fan = _compare("demo_traj_fan net fan", (out["goals"]
                                               * net.input_scale
                                               ).contiguous(),
                     wcrbf_params_to_kernel(net), TOL_CLOTHOID_FORWARD,
                     relative=True)
    print(f"demos: demo_closed_loop ({DEMO_STEPS} steps): "
          + "; ".join(lines) + f"; demo_traj_fan net fan (450 goals, "
          f"clothoid_pr) kernel vs plain rel max|err| {e_fan:.2e}, paths "
          f"finite {bool(torch.isfinite(out['paths']).all())}, launches "
          f"{launches['traj_fan']}", flush=True)
    check(launches["irbfn"]["rbf_forward"] == DEMO_STEPS
          and launches["goal_mpc"]["admm_solve"] == DEMO_STEPS,
          f"demo launches {launches}")
    check(launches["traj_fan"]["rbf_forward"] == 1
          and bool(torch.isfinite(out["paths"]).all()),
          f"traj fan: {launches['traj_fan']}")
    return dict(rbf=launches["irbfn"]["rbf_forward"]
                + launches["traj_fan"]["rbf_forward"],
                admm=launches["goal_mpc"]["admm_solve"])


def linear_mpc_and_sim(device):
    """Phases 33-39. Returns the launches of each path and the new paths'
    kernel numbers."""
    quad = _npz(QUAD_ASSET + "_golden.npz")
    phase_linear_mpc(device, quad)
    q = phase_quadrotor(device, quad)
    tracking = phase_tracking(device, _npz(TRACKING_GOLDEN))
    phase_lidar_multi_agent(device, _npz(SIM_GOLDEN))
    phase_overtake(device, _npz(OVERTAKE_GOLDEN))
    phase_ppo(device, _npz(PPO_GOLDEN))
    demos = phase_demos(device, _npz(DEMO_GOLDEN))
    return q, tracking, demos


# ------------------------------------------------------------ multi-device

EP_EXPERTS = (2, 4, 8, 16)  # region slices of frenet_wide_pr1 (R = 16)
EP_BATCHES = (1024, 65536)
CLOTHOID_EP = (8192, (2, 8))  # clothoid_pr (R = 128): batch, slices
GOAL_V_CAR = 4.5  # the family of phase 10's lattice that phase 41 solves
N_FRENET_SHARDED = 65536
FRENET_SHARDED_BPD = 8192  # gen_nmpc_table_frenet's default chunk
DRYRUN_NMPC = dict(gn_iters=2, al_outer=1)  # the dry run's NMPC budget
STEP_BATCH = 8192
TOL_STEP_REL = 1e-6  # the world-1 DP x EP step against the plain step


def _region_slices(model, E):
    """The kernel operands of each of E expert ranks: ``model`` as
    ``shard_params`` leaves it on rank e of an expert axis of E, without a
    process group (the ranks' partial sums are added here)."""
    import torch

    from irbfn_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS, Mesh,
                                               shard_params)

    with torch.no_grad():
        return [shard_params(model, Mesh(
            model.centers.device, {DATA_AXIS: 1, EXPERT_AXIS: E}, e)
        ).kernel_operands() for e in range(E)]


def _sharded_forward(x, slices, forward):
    """The expert ranks' partial forwards added up, as the expert group's
    all_reduce adds them, then finished (``rbf.finish_partial``)."""
    from irbfn_tpu_torch.ops import rbf

    total = forward(x, slices[0], partial=True)
    for ops in slices[1:]:
        total = total + forward(x, ops, partial=True)
    return rbf.finish_partial(total, slices[0])


def _turns(fns, iters=200, warmup=20):
    """Each of ``fns`` timed with CUDA events in turns (the order, then the
    order reversed); mean ms of each, and the runs."""
    t = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        t[k].append(_time_ms(fns[k], iters, warmup))
    return {k: float(np.mean(v)) for k, v in t.items()}, t


def phase_ep_forward(device, flagship, golden):
    """Phase 40: the expert-parallel forward through ``rbf_forward.cu``'s
    partial mode. Each net is split into E region slices, each slice is one
    partial launch on the card, and the partial sums are added and divided
    as the expert group's all_reduce and ``finish_partial`` do; held
    against the unsharded kernel and the plain partial mode."""
    import torch

    from irbfn_tpu_torch.ops import rbf

    rng = np.random.default_rng(40)
    clothoid, _ = _asset(CLOTHOID_ASSET, device)
    shared = _random_net(rng, device, 16, 512, 8, 10, "gaussian", "shared")
    x = (torch.as_tensor(golden["x"], device=device)
         * flagship.input_scale).contiguous()
    goals = torch.as_tensor(_npz(CLOTHOID_GOLDEN)["goals"][:CLOTHOID_EP[0]],
                            device=device)
    runs = [("frenet_wide_pr1", flagship, TOL_FLAGSHIP, False,
             [(x if B == len(x) else x.repeat(-(-B // len(x)), 1)[:B]
               .contiguous(), E) for B in EP_BATCHES for E in EP_EXPERTS]),
            ("clothoid_pr", clothoid, TOL_CLOTHOID_FORWARD, True,
             [((goals * clothoid.input_scale).contiguous(), E)
              for E in CLOTHOID_EP[1]]),
            ("shared head R=16 K=512", shared, TOL_RANDOM, True,
             [(_random_x(rng, shared, 1024, device), E)
              for E in EP_EXPERTS])]
    errs, n_launches = {}, 0
    for name, net, tol, relative, cases in runs:
        full_ops = rbf.wcrbf_params_to_kernel(net)
        for xs, E in cases:
            slices = _region_slices(net, E)
            with torch.no_grad():
                full = rbf.wcrbf_forward(xs, full_ops)
                torch.cuda.synchronize()
                reset_launches()
                got = _sharded_forward(xs, slices, rbf.wcrbf_forward)
                torch.cuda.synchronize()
                launches = read_launches()["rbf_forward"]
                plain = _sharded_forward(xs, slices,
                                         rbf.wcrbf_forward_reference)
            check(launches == E, f"{name} E={E}: {launches} launches, not "
                  f"one per slice")
            n_launches += launches
            scale = max(1.0, float(plain.abs().max())) if relative else 1.0
            e = (_max_err(got, full) / scale, _max_err(got, plain) / scale)
            errs[name, xs.shape[0], E] = e
            check(bool(torch.isfinite(got).all()) and max(e) <= tol,
                  f"{name} B={xs.shape[0]} E={E}: sharded vs unsharded "
                  f"kernel {e[0]:.3e}, vs plain partial {e[1]:.3e}, tol "
                  f"{tol}")
    # times at B = 1024: the default forward over the 16 regions, one
    # partial launch over a rank's 8 of them (E = 2), both ranks' launches
    # in a row with the sum and the divide, and the plain partial mode
    xb = x[:1024].contiguous()
    halves = _region_slices(flagship, 2)
    full_ops = rbf.wcrbf_params_to_kernel(flagship)
    with torch.no_grad():
        ms, t = _turns({
            "default": lambda: rbf.wcrbf_forward(xb, full_ops),
            "partial": lambda: rbf.wcrbf_forward(xb, halves[0],
                                                 partial=True),
            "sharded": lambda: _sharded_forward(xb, halves,
                                                rbf.wcrbf_forward),
            "plain": lambda: rbf.wcrbf_forward_reference(xb, halves[0],
                                                         partial=True)})
    ops = halves[0]
    nbytes = 4 * (sum(o.numel() for o in ops[:7]) + xb.numel()
                  + xb.shape[0] * (ops.w.shape[-1] + 1))
    bound_ms, bound_by = _bound(_rbf_flops(xb.shape[0], ops), nbytes)
    print("EP forward (rbf_forward partial mode, slices summed and divided "
          "as the expert all_reduce does; tol "
          f"{TOL_FLAGSHIP} abs / {TOL_CLOTHOID_FORWARD} and {TOL_RANDOM} "
          "rel): max|err| vs the unsharded kernel / vs the plain partial "
          "mode: " + ", ".join(f"{n} B={b} E={E} {a:.2e}/{p:.2e}"
                               for (n, b, E), (a, p) in errs.items())
          + f"; {n_launches} partial launches, E per sharded forward; "
          f"times at B=1024 (CUDA events, in turns): default "
          f"{ms['default']:.4f} ms, one partial launch over 8 regions "
          f"{ms['partial']:.4f} ms (bound {bound_ms:.4f} ms by {bound_by}), "
          f"2 partial launches + sum + divide {ms['sharded']:.4f} ms, plain "
          f"partial {ms['plain']:.4f} ms (runs {t})", flush=True)
    return dict(launches=n_launches,
                max_abs_err=max(a for a, _ in errs.values()),
                ms=ms["partial"], plain_ms=ms["plain"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                default_ms=ms["default"], sharded_e2_ms=ms["sharded"])


@contextlib.contextmanager
def nccl_world_of_one(device):
    """A process group of one rank on NCCL (a file store in a temporary
    directory) for phases 41-42, destroyed after them; yields its mesh."""
    import torch.distributed as dist

    from irbfn_tpu_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1, device_id=device)
        try:
            yield make_mesh(device=device)
        finally:
            dist.destroy_process_group()


def _equal_tables(label, a, b):
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    check(set(a) == set(b) and not bad, f"{label}: {bad} differ")


def _frenet_table_fn():
    """The table generator's per-chunk solve at the dry run's NMPC budget:
    rows -> the table's columns."""
    from irbfn_tpu_torch.parallel import TableSolution
    from irbfn_tpu_torch.solvers import NMPCConfig, solve_lattice_point

    cfg = NMPCConfig(**DRYRUN_NMPC)

    def fn(r, pv):
        return TableSolution.from_solution(solve_lattice_point(r, pv, cfg),
                                           include_onehot=True)._asdict()

    return fn


def fresh_process_solves(rows_path: str, out_path: str, device: str):
    """Run in a process of its own by ``_fresh_process_solves``: the rows
    of ``rows_path`` through ``solve_lattice`` as phase 41 solves them,
    twice (the process's first NMPC solve and its second), written to
    ``out_path`` with the seconds of each."""
    import torch

    from irbfn_tpu_torch._device import wait_clock
    from irbfn_tpu_torch.dynamics.params import fullscale_params
    from irbfn_tpu_torch.parallel import solve_lattice

    device = torch.device(device)
    rows = np.load(rows_path)
    params = fullscale_params(dtype=torch.float32, device=device)
    out, secs = {}, []
    for i in range(2):
        t0 = wait_clock(device)
        res = solve_lattice(_frenet_table_fn(), rows,
                            batch_per_device=FRENET_SHARDED_BPD,
                            args=(params,), device=device)
        secs.append(wait_clock(device) - t0)
        out.update({f"{i}/{k}": v for k, v in res.items()})
    np.savez(out_path, seconds=np.asarray(secs), **out)


def _fresh_process_solves(rows, device):
    """``fresh_process_solves`` in a new Python process on ``device``: its
    two solves' tables and seconds."""
    with tempfile.TemporaryDirectory() as d:
        rows_path, out_path = f"{d}/rows.npy", f"{d}/out.npz"
        np.save(rows_path, rows)
        proc = subprocess.run(
            [sys.executable, "-c", f"import sys; sys.path.insert(0, "
             f"{ROOT!r}); import chip_smoke; chip_smoke."
             f"fresh_process_solves({rows_path!r}, {out_path!r}, "
             f"{str(device)!r})"],
            capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0,
              f"the fresh process's NMPC solves failed: {proc.stderr[-3000:]}")
        with np.load(out_path) as z:
            sols = [{k.split("/", 1)[1]: z[k] for k in z.files
                     if k.startswith(f"{i}/")} for i in range(2)]
            return sols, [float(t) for t in z["seconds"]]


def phase_sharded_datagen(device, mesh, lattice_goals, phase10_family_s):
    """Phase 41: the sharded lattice solves on NCCL at world 1: one
    2,642,368-goal family of phase 10 through ``solve_goal_lattice_sharded``
    (the generator's 600 sweeps and 262,144-goal chunks) and 65,536 rows of
    the reference Frenet lattice through ``solve_lattice_sharded`` at the
    dry run's NMPC budget, each bit for bit the one-device solve's; and the
    same Frenet rows solved twice in a fresh spawned process, its first
    NMPC solve and its second bit for bit this process's (P5)."""
    import torch

    from irbfn_tpu_torch._device import wait_clock
    from irbfn_tpu_torch.dynamics.params import fullscale_params
    from irbfn_tpu_torch.parallel import (FRENET_GRID, build_lattice,
                                          solve_lattice,
                                          solve_lattice_sharded)
    from irbfn_tpu_torch.parallel import gen_goal_mpc_table as gen
    from irbfn_tpu_torch.solvers import (NMPCConfig, solve_goal_lattice,
                                         solve_goal_lattice_sharded)

    args = gen.parse_args(list(LATTICE_ARGS))
    G = len(lattice_goals)
    kw = dict(iters=args.iters, batch_per_device=min(args.chunk, G))
    t0 = wait_clock(device)
    direct = solve_goal_lattice(GOAL_V_CAR, lattice_goals, device=device,
                                **kw)
    t_direct = wait_clock(device) - t0
    reset_launches()
    t_sharded = []  # the first includes NCCL's communicator set-up
    for _ in range(2):
        t0 = wait_clock(device)
        sharded = solve_goal_lattice_sharded(GOAL_V_CAR, lattice_goals,
                                             mesh=mesh, **kw)
        t_sharded.append(wait_clock(device) - t0)
        _equal_tables("sharded goal family vs solve_goal_lattice", sharded,
                      direct)
    goal_launches = read_launches()["admm_solve"]
    check(goal_launches == 2 * -(-G // kw["batch_per_device"]),
          f"sharded family, twice: {goal_launches} admm_solve launches")

    rng = np.random.default_rng(41)
    lattice = build_lattice(FRENET_GRID)
    rows = lattice[np.sort(rng.choice(len(lattice), N_FRENET_SHARDED,
                                      replace=False))]
    del lattice
    params = fullscale_params(dtype=torch.float32, device=device)
    fn = _frenet_table_fn()
    # the same rows solved in a fresh process (its first NMPC solve and its
    # second: P5 of ROADMAP.md), then here, one device and sharded
    fresh, t_fresh = _fresh_process_solves(rows, device)
    t_nmpc, f_runs = {}, {}
    for name in ("direct", "sharded"):
        t0 = wait_clock(device)
        f_runs[name] = (
            solve_lattice_sharded(fn, rows, mesh=mesh, args=(params,),
                                  batch_per_device=FRENET_SHARDED_BPD)
            if name == "sharded" else
            solve_lattice(fn, rows, batch_per_device=FRENET_SHARDED_BPD,
                          args=(params,), device=device))
        t_nmpc[name] = wait_clock(device) - t0
    _equal_tables("sharded Frenet rows vs solve_lattice", f_runs["sharded"],
                  f_runs["direct"])
    _equal_tables("a fresh process's first NMPC solve vs its second",
                  fresh[0], fresh[1])
    _equal_tables("a fresh process's first NMPC solve vs this process's",
                  fresh[0], f_runs["direct"])
    cfg = NMPCConfig(**DRYRUN_NMPC)
    print(f"sharded datagen (NCCL, world 1, mesh {mesh.shape}): goal family "
          f"v_car={GOAL_V_CAR} ({G:,} goals, {args.iters} sweeps, chunks of "
          f"{kw['batch_per_device']:,}) sharded {t_sharded[0]:.3f} s, then "
          f"{t_sharded[1]:.3f} s, solve_goal_lattice {t_direct:.3f} s, "
          f"phase 10's mean family {phase10_family_s:.3f} s; bit for bit "
          f"equal, {goal_launches} admm_solve launches in the two, "
          f"{100 * sharded['converged'].mean():.4f}% converged; "
          f"{N_FRENET_SHARDED:,} Frenet rows at gn_iters="
          f"{cfg.gn_iters}, al_outer={cfg.al_outer} (chunks of "
          f"{FRENET_SHARDED_BPD:,}) sharded {t_nmpc['sharded']:.2f} s, "
          f"solve_lattice {t_nmpc['direct']:.2f} s, "
          f"{100 * f_runs['sharded']['feasible'].mean():.1f}% feasible; a "
          f"fresh spawned process's first and second solves of the same "
          f"rows ({t_fresh[0]:.2f} s with the process's CUDA set-up, "
          f"{t_fresh[1]:.2f} s): all four bit for bit equal (P5)",
          flush=True)
    return goal_launches


def _flagship_case(model, golden):
    """``parallel/rank_checks.py``'s case of the flagship at B = 1024."""
    from irbfn_tpu_torch.train import load_config

    return dict(config=load_config(ASSET + ".json"),
                state={k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()},
                x=np.asarray(golden["x"][:1024], np.float32), y=None,
                extra=None, dtype="float32", loss="frenet_fullint_loss")


def _step_world_one(device, mesh, golden):
    """The DP x EP step at frenet_wide_pr1's width on the NCCL world of one
    against the plain step on a second copy of the net: loss and every
    gradient after the clip. The batch is the golden's inputs, repeated
    and jittered; the targets the net's own controls, jittered."""
    import torch

    from irbfn_tpu_torch.dynamics.params import fullscale_params
    from irbfn_tpu_torch.parallel.mesh import data_sharding, shard_params
    from irbfn_tpu_torch.train import (create_trainer, frenet_fullint_loss,
                                       make_train_step)

    rng = np.random.default_rng(42)
    plain_net, _ = _flagship(device)
    x0 = np.asarray(golden["x"], np.float32)
    x0 = np.tile(x0, (-(-STEP_BATCH // len(x0)), 1))[:STEP_BATCH]
    x = torch.as_tensor(x0 * (1.0 + 0.01 * rng.normal(size=x0.shape)),
                        dtype=torch.float32, device=device)
    with torch.no_grad():
        y = plain_net(x) + 0.1 * torch.as_tensor(
            rng.normal(size=(STEP_BATCH, 10)), dtype=torch.float32,
            device=device)
    dyn = fullscale_params(dtype=torch.float32, device=device).to_vector()
    sharded_net = shard_params(plain_net, mesh)
    trainers = [create_trainer(plain_net), create_trainer(sharded_net)]
    steps = [make_train_step(frenet_fullint_loss, dyn),
             make_train_step(frenet_fullint_loss, dyn, mesh=mesh)]
    shard = data_sharding(mesh)
    reset_launches()
    m = [steps[0](trainers[0], x, y),
         steps[1](trainers[1], shard(x), shard(y))]
    launches = read_launches()
    rel = {}
    for (n, p), q in zip(plain_net.named_parameters(),
                         sharded_net.parameters()):
        rel[n] = _max_err(q.grad, p.grad) / max(float(p.grad.abs().max()),
                                                1e-30)
    rel["loss"] = abs(float(m[1].loss) - float(m[0].loss)) / abs(
        float(m[0].loss))
    same = all(torch.equal(q.grad, p.grad) for p, q in zip(
        plain_net.parameters(), sharded_net.parameters()))
    check(max(rel.values()) <= TOL_STEP_REL and launches["rbf_forward"] == 0,
          f"DP x EP step vs the plain step: {rel}, launches {launches}")
    return rel, same, float(m[0].loss)


def _multi_card(device_type, world, model, golden, lattice_goals):
    """NCCL ranks on ``world`` cards (gloo ranks on the host for
    ``device_type="cpu"``): the EP forward of the flagship for each expert
    count that divides both the world and R = 16, and a goal family cut to
    ``world`` chunks of 262,144, against the same on one device."""
    import torch

    from irbfn_tpu_torch.ops import rbf
    from irbfn_tpu_torch.parallel import launch, rank_checks
    from irbfn_tpu_torch.solvers import solve_goal_lattice

    experts = [e for e in (1, 2, 4, 8) if world % e == 0 and 16 % e == 0]
    case = _flagship_case(model, golden)
    goals = lattice_goals[:world * 262144]
    jobs = [("forward", case, e) for e in experts]
    jobs.append(("goal_lattice", GOAL_V_CAR, goals, 600, 262144))
    per_rank = launch.spawn(rank_checks.run_jobs, world, device_type, jobs)
    x = (torch.as_tensor(case["x"], device=model.centers.device)
         * model.input_scale).contiguous()
    with torch.no_grad():
        ref = rbf.wcrbf_forward(x, rbf.wcrbf_params_to_kernel(model)).cpu()
    one = solve_goal_lattice(GOAL_V_CAR, goals, iters=600,
                             batch_per_device=262144,
                             device=model.centers.device)
    err = 0.0
    for res in per_rank:
        for e, r in zip(experts, res):
            err = max(err, _max_err(torch.from_numpy(r["fused"]), ref))
        _equal_tables(f"goal family on {world} ranks", res[-1]["sharded"],
                      one)
    check(err <= TOL_FLAGSHIP, f"EP forward on {world} ranks: {err:.3e}")
    return experts, err


def phase_dryrun(device, mesh, model, golden, lattice_goals):
    """Phase 42: ``graft_entry.entry()``'s forward on the card, the
    ``dryrun_multichip`` of every visible card on NCCL, the DP x EP step at
    frenet_wide_pr1's width on the world of one against the plain step,
    and, where more than one card is visible, NCCL ranks on up to 8 of them
    against the one-card results."""
    import torch

    from irbfn_tpu_torch import graft_entry

    forward, args = graft_entry.entry()
    reset_launches()
    out = forward(*args)
    torch.cuda.synchronize()
    entry_launches = read_launches()
    check(tuple(out.shape) == (1024, 10) and bool(torch.isfinite(out).all())
          and entry_launches["rbf_forward"] == 1,
          f"entry(): {tuple(out.shape)}, launches {entry_launches}")
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(n)
    t_dry = time.perf_counter() - t0
    check(np.isfinite(dry["loss"]), f"dryrun_multichip: {dry}")
    rel, same, loss = _step_world_one(device, mesh, golden)
    if n > 1:
        world = min(n, 8)
        experts, err = _multi_card("cuda", world, model, golden,
                                   lattice_goals)
        multi = (f"{world} NCCL ranks: the EP forward at expert "
                 f"{experts} within {err:.2e} of the one-card kernel, the "
                 "goal family bit for bit the one-card solve")
    else:
        multi = ("world 1 only: one card visible, no ranks on other cards "
                 "to check")
    print(f"dry run: entry() forward (1024, 10) finite, launches "
          f"{entry_launches}; dryrun_multichip({n}) on NCCL in {t_dry:.1f} s "
          f"({dry}); DP x EP step at frenet_wide_pr1's width (batch "
          f"{STEP_BATCH}, frenet_fullint_loss, mesh {mesh.shape}) against "
          f"the plain step: loss {loss:.6f}, max rel err "
          + ", ".join(f"{k} {v:.1e}" for k, v in rel.items())
          + f" (tol {TOL_STEP_REL}), gradients bit for bit equal: {same}; "
          f"{multi}", flush=True)
    return entry_launches["rbf_forward"]


def multi_device(device, model, golden, lattice_goals, phase10_family_s):
    """Phases 40-42; the launches of each kernel and the partial mode's
    numbers."""
    partial = phase_ep_forward(device, model, golden)
    with nccl_world_of_one(device) as mesh:
        admm = phase_sharded_datagen(device, mesh, lattice_goals,
                                     phase10_family_s)
        rbf = phase_dryrun(device, mesh, model, golden, lattice_goals)
    return dict(rbf=partial["launches"] + rbf, admm=admm, partial=partial)


RACELINE_MARGIN = 0.35  # the tools' default clearance (m)
# the card against --device cpu: the same f32 distance field read on the
# card, where the bilinear read's multiply-adds may contract into FMAs that
# the CPU rounds twice (the last f32 place, as JAX's XLA against the port on
# the CPU: 1e-6 in the CSV there), carried on by the pushes; the CSV prints
# 6 decimals
TOL_RACELINE_CSV = 1e-4
RACELINE_TOOLS = {  # tool -> its flags: the push binds, the boxes tighten
    "make_feasible_raceline": ("--blend_centerline", "0"),
    "min_curv_raceline": ("--n_points", "400"),
}
PERT_GOLD = os.path.join(ROOT, "tests", "oracles", "nmpc_pert_gold.npz")
TOL_PERT_U = 1e-6  # the f64 solve against the JAX package's proven gold
TRAJGEN_BATCHES = (500, 1 << 14)  # the script's default, and 2^14
TRAJGEN_CALLS = 200
# the FMA kernel against the plain chain on the card: 64 steps of the
# plain version's two roundings against the kernel's one, relative to the
# largest value
TOL_FMA_REL = 1e-5
CEILING_NMPC_ROWS = 65536  # the NMPC solve placed against the ceilings
CEILING_NMPC = dict(gn_iters=3, al_outer=1)  # the profiler's short solve


def _pinched_oval_bundle(d, name="ovl"):
    """A reference-format track bundle in ``d/name``: the oval's corridor
    (half width 2 m) rasterized and written by ``save_map_yaml``, its
    centerline with width columns 0.25 m wider than that corridor (they
    overstate it, as a real bundle's constant widths do at corners), and a
    raceline pushed 1.8 m toward the outer wall over a bump: a pinch of
    0.26 m against the 0.35 m margin."""
    from irbfn_tpu_torch.sim import oval_track
    from irbfn_tpu_torch.sim.make_feasible_raceline import geometry
    from irbfn_tpu_torch.sim.map import rasterize_track, save_map_yaml

    path = os.path.join(d, name)
    os.makedirs(path, exist_ok=True)
    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device="cpu")
    omap = rasterize_track(track, half_width=2.0)
    save_map_yaml(omap.dist.numpy() > 0, float(omap.resolution),
                  (float(omap.origin_x), float(omap.origin_y), 0.0),
                  os.path.join(path, f"{name}_map.yaml"))
    rl = track.raceline
    c = np.stack([rl.xs.double().numpy(), rl.ys.double().numpy()], -1)
    np.savetxt(os.path.join(path, f"{name}_centerline.csv"),
               np.column_stack([c, np.full((len(c), 2), 2.25)]),
               delimiter=",", fmt="%.9g",
               header="x_m,y_m,w_tr_right_m,w_tr_left_m")
    s, yaw, _, length = geometry(c)
    nrm = np.stack([-np.sin(yaw), np.cos(yaw)], -1)
    bump = 1.8 * np.exp(-0.5 * ((s - 0.3 * length) / 6.0) ** 2)
    xy = c + bump[:, None] * nrm
    s, yaw, k, _ = geometry(xy)
    np.savetxt(os.path.join(path, f"{name}_raceline.csv"),
               np.stack([s, xy[:, 0], xy[:, 1], yaw, k,
                         np.full_like(s, 3.0)], -1),
               delimiter=";", fmt="%.9g",
               header="s_m; x_m; y_m; psi_rad; kappa_radpm; vx_mps")
    return path


def phase_raceline_tools(device):
    """Phase 43: ``make_feasible_raceline`` (pure EDT push) and
    ``min_curv_raceline`` on a pinched oval bundle, on the card and with
    ``--device cpu``: every point of each line clears the margin (less
    1e-3 m) on the card's map, and the card's CSV is the CPU's."""
    import torch

    from irbfn_tpu_torch.sim import make_feasible_raceline as mf
    from irbfn_tpu_torch.sim import min_curv_raceline as mc
    from irbfn_tpu_torch.sim.map import distance_at, load_map_yaml

    mods = {"make_feasible_raceline": mf, "min_curv_raceline": mc}
    parts = []
    with tempfile.TemporaryDirectory() as tmp:
        bundle = _pinched_oval_bundle(tmp)
        omap = load_map_yaml(os.path.join(bundle, "ovl_map.yaml"),
                             device=device)
        for name, flags in RACELINE_TOOLS.items():
            lines, secs = {}, {}
            for where in (str(device), "cpu"):
                out = os.path.join(tmp, f"{name}_{where}.csv")
                t0 = time.perf_counter()
                _quiet(f"phase43_{name}_{where.split(':')[0]}.log",
                       mods[name].main, ["--map_dir", bundle, *flags,
                                         "--out", out, "--device", where])
                secs[where] = time.perf_counter() - t0
                lines[where] = np.loadtxt(out, delimiter=";", comments="#")
            card, cpu = lines[str(device)], lines["cpu"]
            d = distance_at(omap, torch.as_tensor(card[:, 1], device=device,
                                                  dtype=torch.float32),
                            torch.as_tensor(card[:, 2], device=device,
                                            dtype=torch.float32))
            clear = float(d.min())
            err = (np.abs(card - cpu).max(0) if card.shape == cpu.shape
                   else np.full(6, np.inf))
            check(clear >= RACELINE_MARGIN - 1e-3
                  and float(err.max()) <= TOL_RACELINE_CSV,
                  f"{name}: min clearance {clear:.4f} m (margin "
                  f"{RACELINE_MARGIN}), card vs CPU per column {err}")
            parts.append(f"{name} ({' '.join(flags)}): {len(card)} points, "
                         f"{secs[str(device)]:.2f} s on the card, "
                         f"{secs['cpu']:.2f} s with --device cpu, min "
                         f"clearance {clear:.4f} m, card vs CPU max|diff| "
                         "per column (s, x, y, psi, kappa, vx) "
                         + "/".join(f"{e:.1e}" for e in err))
    print(f"raceline tools on a pinched oval (margin {RACELINE_MARGIN} m; "
          f"tol {TOL_RACELINE_CSV} card vs CPU): " + "; ".join(parts),
          flush=True)


def phase_oracle_gold(device):
    """Phase 44: ``gen_test_oracles.derive_perturbation_gold`` on the card
    in f64 (the two rows solved, 60 perturbations of each evaluated, the
    proof that none improves), against the JAX package's committed
    ``tests/oracles/nmpc_pert_gold.npz``."""
    from irbfn_tpu_torch._device import wait_clock
    from irbfn_tpu_torch.solvers.gen_test_oracles import \
        derive_perturbation_gold

    t0 = wait_clock(device)
    gold = derive_perturbation_gold(device)  # raises if any improves
    secs = wait_clock(device) - t0
    with np.load(PERT_GOLD) as ref:
        e_u = float(np.abs(gold["u_star"] - ref["u_star"]).max())
        e_f = float((np.abs(gold["f_star"] - ref["f_star"])
                     / np.abs(ref["f_star"])).max())
        same_draws = float(np.abs(gold["cands"] - ref["cands"]).max())
    check(e_u <= TOL_PERT_U, f"perturbation gold u_star {e_u:.3e} from the "
          f"committed one (tol {TOL_PERT_U})")
    print(f"oracle generator: the perturbation gold in f64 on the card in "
          f"{secs:.2f} s: u_star {e_u:.2e} from the committed "
          f"nmpc_pert_gold.npz (tol {TOL_PERT_U}), f_star rel {e_f:.1e}, "
          f"candidates {same_draws:.1e} from its draws; 0 of "
          f"{gold['cands'].shape[0]} x {gold['n_cand']} perturbations "
          "improve", flush=True)


def phase_trajgen(device):
    """Phase 45: the TrajGen frequency (``utils/profiling.py --parts
    trajgen``): the clothoid solver, solver + 9-point integration, and the
    ``clothoid_pr`` forward through ``rbf_forward.cu``, at B = 500 and
    2^14, CUDA events over ``TRAJGEN_CALLS`` calls in a row; the net path
    against its plain version at phase 29's tolerance, one launch a call.
    Returns the launches."""
    import torch

    from irbfn_tpu_torch.ops import rbf
    from irbfn_tpu_torch.utils import profiling as prof

    net, _ = _asset(CLOTHOID_ASSET, device)
    ops = rbf.wcrbf_params_to_kernel(net)
    errs = {}
    for B in TRAJGEN_BATCHES:
        g = torch.as_tensor(prof.trajgen_goals(B), device=device)
        errs[B] = _compare(f"TrajGen net B={B}",
                           (g * net.input_scale).contiguous(), ops,
                           TOL_CLOTHOID_FORWARD)
    reset_launches()
    res = prof.profile_trajgen(device, TRAJGEN_BATCHES,
                               CLOTHOID_ASSET + ".json",
                               CLOTHOID_ASSET + ".npz", TRAJGEN_CALLS)
    torch.cuda.synchronize()
    launches = read_launches()["rbf_forward"]
    # every call of the net path, the warm-up's included
    expected = len(TRAJGEN_BATCHES) * (TRAJGEN_CALLS + prof.WARMUP)
    check(launches == expected, f"TrajGen: {launches} rbf_forward "
          f"launches, not {expected}")
    check(all(np.isfinite(r) and r > 0 for _, r, _ in res.values()),
          f"TrajGen rates: {res}")
    print("TrajGen frequency (CUDA events, " + f"{TRAJGEN_CALLS} calls in a "
          "row): " + "; ".join(
              f"{name} B={B:,} {rate:,.0f} trajs/s ({us:.1f} us/batch)"
              for (name, B), (us, rate, _) in res.items())
          + f"; rbf_forward {launches} launches (one a net call); net vs "
          "plain max|err| " + ", ".join(f"B={B} {e:.1e}"
                                        for B, e in errs.items())
          + f" (tol {TOL_CLOTHOID_FORWARD})", flush=True)
    return launches


def phase_ceilings(device):
    """Phase 46: the card's measured ceilings (``measure_ceilings``): the
    f32 FMA rate of the probe ``fma_ceiling.cu`` (held against its plain
    chain first) and the HBM read rate of a ``torch.sum`` over 1 GiB; and
    where an NMPC solve sits against them: ``count_ops``' tally of one
    Newton iteration (the same on the card and on the CPU) times the
    solve's iterations, over its wall time."""
    import torch

    from irbfn_tpu_torch._device import wait_clock
    from irbfn_tpu_torch.dynamics.params import fullscale_params
    from irbfn_tpu_torch.ops.fma_ceiling import (STEPS, fma_chain,
                                                 fma_chain_reference)
    from irbfn_tpu_torch.parallel.gen_nmpc_table_frenet import wide_rows
    from irbfn_tpu_torch.solvers import NMPCConfig, solve_lattice_point
    from irbfn_tpu_torch.utils import profiling as prof
    from irbfn_tpu_torch.utils import spans

    x = torch.arange(1 << 22, dtype=torch.float32, device=device) * 1e-9
    fma_launches = spans.counters().get("ops.fma.launches", 0)
    got = fma_chain(x)
    torch.cuda.synchronize()
    check(spans.counters().get("ops.fma.launches", 0) == fma_launches + 1,
          "the FMA probe did not launch")
    ref = fma_chain_reference(x)
    e_fma = _max_err(got, ref) / float(ref.abs().max())
    check(e_fma <= TOL_FMA_REL, f"FMA probe vs its plain chain: rel "
          f"{e_fma:.2e} (tol {TOL_FMA_REL})")
    one = prof.event_ms(lambda: fma_chain(x), 20)
    plain = prof.event_ms(lambda: fma_chain_reference(x), 3)
    c = prof.measure_ceilings(device)
    rows = torch.as_tensor(wide_rows(CEILING_NMPC_ROWS, 0), device=device)
    params = fullscale_params(dtype=torch.float32, device=device)
    cfg = NMPCConfig(**CEILING_NMPC)
    iters0 = newton_iterations()
    t0 = wait_clock(device)
    solve_lattice_point(rows, params, cfg)
    wall = wait_clock(device) - t0
    iters = newton_iterations() - iters0
    ops_iter = prof.newton_iteration_ops(rows, params, cfg)
    small = rows[:256]
    n_card = prof.newton_iteration_ops(small, params, cfg)
    n_cpu = prof.newton_iteration_ops(
        small.cpu(), fullscale_params(dtype=torch.float32, device="cpu"),
        cfg)
    check(n_card == n_cpu, f"count_ops: {n_card} operations on the card, "
          f"{n_cpu} on the CPU for the same iteration")
    achieved = ops_iter * iters / wall
    share = achieved / c["fma_flops"]
    print(f"ceilings (measuring probe fma_ceiling.cu, not a TPU kernel's "
          f"counterpart; vs its plain chain rel {e_fma:.1e}, tol "
          f"{TOL_FMA_REL}): f32 FMA {c['fma_flops'] / 1e12:.2f} TFLOP/s "
          f"({c['n']:,} elements x {STEPS * c['repeats']} dependent FMAs in "
          f"one pass, {c['fma_ms']:.4f} ms); the 64-FMA chain alone "
          f"{2 * STEPS * x.numel() / one / 1e6:.0f} GFLOP/s ({one:.4f} ms: "
          f"16 FLOP a byte, under the ridge), as 128 plain launches "
          f"{2 * STEPS * x.numel() / plain / 1e6:.0f} GFLOP/s ({plain:.3f} "
          f"ms); HBM read {c['hbm_bytes_per_s'] / 1e9:.0f} GB/s (torch.sum "
          f"over {c['hbm_bytes'] / 2**30:.0f} GiB, {c['hbm_ms']:.3f} ms); "
          f"an NMPC solve of {CEILING_NMPC_ROWS:,} wide-range rows (f32, "
          f"gn_iters={cfg.gn_iters}, al_outer={cfg.al_outer}): "
          f"{iters} Newton iterations in {wall:.3f} s, "
          f"{ops_iter / 1e9:.3f} GFLOP an iteration by count_ops (matmuls "
          f"2mnk, elementwise one per output element, reductions one per "
          f"input element; {n_card:,} at 256 rows on the card and on the "
          f"CPU), {achieved / 1e9:.1f} GFLOP/s = {100 * share:.3f}% of the "
          f"measured FMA ceiling", flush=True)
    return dict(fma_flops=c["fma_flops"], hbm_bytes_per_s=c["hbm_bytes_per_s"],
                nmpc_share=share)


def port_tools(device):
    """Phases 43-46; the TrajGen phase's ``rbf_forward`` launches."""
    phase_raceline_tools(device)
    phase_oracle_gold(device)
    launches = phase_trajgen(device)
    phase_ceilings(device)
    return launches


# ------------------------------------------------------ the committed zoo

# the nine committed runs exported by scripts/export_torch_ckpt.py --zoo,
# as its zoo.json names them, each with a lean golden (256 forward and
# plan rows; for the six single nets, the sweep CUT from the eval script's
# 600 steps to the golden's n_steps for the time limit: the loop runs are
# those whose golden holds loop_done), and the learned bank's golden,
# which names its arms' runs
ZOO_MANIFEST = os.path.join(ASSETS, "zoo.json")
ZOO_TIMED = ("arch_wcrbf_shared", "frenet_wide_cc")  # beside the flagship
# the partial mode (and a 2-rank EP forward) on the padded K = 499 layout
ZOO_PARTIAL = ("frenet_wide_cc",)
TRACE_ROWS = 1000  # the NMPC solve whose profiler trace phase 50 writes
# each zoo loop's split of a step: ZOO_SPLIT steps synchronised by part
# (median), then ZOO_PROFILED under torch.profiler (its key_averages over
# ~4,600 launches a step cost seconds of host time a step)
ZOO_SPLIT = 10
ZOO_PROFILED = 3
# - each net in f32 on the card against its JAX f64 golden (forward and
#   plan_batch), and its kernel against its plain version: the f32 rounding
#   of its head grows with the head's sum of |w| per output (printed by
#   phase 47 beside the tolerance). By the rule of phases 4 and 8, each
#   tolerance is the next 1, 2 or 5 x 10^n at least twice the port's plain
#   f32 forward's distance from f64 on a CPU, and at least TOL_RANDOM:
TOL_ZOO = {
    "arch_wcrbf_pr": 5e-3,  # sum |w| 4.9e5, 2.5x the flagship's: 2.2e-3
    # shared head: sum |w| 9.8e3 over features summed over 16 unnormalised
    # gates (outputs up to 41): 9.2e-4
    "arch_wcrbf_shared": 2e-3,
    "bank_pr_mu0.60": 5e-4,  # sum |w| 1.4e5: 1.4e-4
    "bank_pr_mu0.80": 5e-4,  # 1.4e5: 1.8e-4
    "bank_pr_mu1.00": 5e-4,  # 1.3e5: 2.1e-4
    "frenet_wide_cc": 1e-3,  # 2.4e5 (K = 499): 2.7e-4
    "frenet_wide_cluster": TOL_RANDOM,  # head 64 (a Dense on 10 features):
    # 8.8e-6; its gate logits, an affine map of the input: 3.2e-6
    "wide_deeper": 2e-4,  # head 61 behind two Dense(64)+relu: 6.5e-5
    "wide_mlp": TOL_RANDOM,  # head 43: 9.3e-6
}
# - each sweep against its golden. The JAX package against itself, its
#   start states nudged at the f32 scale (scripts/export_torch_ckpt.py
#   --zoo --nudge N [--nudge_seed S]: every entry x(1 + N) for N = +-1e-7
#   and +-1e-6, and x(1 +- N) with the signs of seeds 1 and 2 at 1e-7 and
#   1e-6; the goldens' 200 steps; each nudge's readings in PERF.md section
#   6), at most: (done lanes, lap lanes, laps apart in a lane, per-lane
#   |ey| median and max mm, sweep mm) arch_wcrbf_pr (1, 0, 0, 4.94,
#   114.47, 0.808), arch_wcrbf_shared (117, 0, 0, 0.74, 546.15, 3.102),
#   frenet_wide_cc (0, 0, 0, 0.0007, 1.09, 0.0031), frenet_wide_cluster
#   (0, 0, 0, 0.0004, 23.33, 0.075), wide_deeper (1, 0, 0, 0.0016, 230.17,
#   0.203), wide_mlp (0, 0, 0, 0.0004, 14.18, 0.027). No lane finishes a
#   lap in 200 steps. Each limit is twice that spread, rounded up to two
#   significant digits, and never under phase 5's, with the per-lane |ey|
#   on its median (frenet_wide_cc: its max); frenet_wide_cc and wide_mlp
#   are held to phase 5's (done lanes, lap lanes, laps apart, per-lane |ey|
#   mm, sweep mm). scripts/zoo_loop_faults.py plants input-bound faults in
#   the planner and shows which of these limits each breaks:
TOL_ZOO_LOOP = {
    "arch_wcrbf_pr": (2, TOL_LAP_LANES, 1, TOL_EY_LANE_MM, 1.7),
    "arch_wcrbf_shared": (240, TOL_LAP_LANES, 1, TOL_EY_LANE_MM, 6.3),
    "frenet_wide_cc": (0, TOL_LAP_LANES, 1, TOL_EY_LANE_MM, TOL_EY_SWEEP_MM),
    "frenet_wide_cluster": (0, TOL_LAP_LANES, 1, TOL_EY_LANE_MM, 0.15),
    "wide_deeper": (2, TOL_LAP_LANES, 1, TOL_EY_LANE_MM, 0.41),
    "wide_mlp": (0, TOL_LAP_LANES, 1, TOL_EY_LANE_MM, TOL_EY_SWEEP_MM),
}
ZOO_LANE_MAX = ("frenet_wide_cc",)  # per-lane |ey| held at its max
# - the learned bank's fixed-arm rewards (lap progress over the golden's
#   --n_steps, 100: CUT from the script's 600 for the time limit) against
#   the JAX script's, as tests/test_torch_eval_closed_loop.py holds them
TOL_ADAPTIVE_REWARD = 1e-4


def _zoo_runs():
    """(the nine runs, the six whose golden holds a sweep, the bank's
    golden path) from the exporter's ``zoo.json``."""
    with open(ZOO_MANIFEST) as f:
        manifest = json.load(f)
    loops = []
    for run in manifest["runs"]:
        with np.load(os.path.join(ASSETS, f"{run}_golden.npz")) as z:
            if "loop_done" in z.files:
                loops.append(run)
    return (tuple(manifest["runs"]), tuple(loops),
            os.path.join(ASSETS, manifest["bank"]))


def _head_sum(model) -> float:
    """The largest sum of |w| over one output of a net's last layer."""
    sd = model.state_dict()
    w = sd["head_kernel"] if "head_kernel" in sd else sd["dense3_kernel"]
    return float(w.abs().sum(0).max())


def _zoo_inputs(rng, config, B, device):
    """B net inputs drawn inside a config's trained grid."""
    import torch

    from irbfn_tpu_torch.train import input_bounds_from_config

    b = input_bounds_from_config(config)
    return torch.as_tensor(rng.uniform(b[:, 0], b[:, 1], (B, b.shape[0])),
                           dtype=torch.float32, device=device)


def phase_zoo(device, flagship, golden):
    """Phase 47: the nine committed runs of the zoo from their assets, f32
    on the card: the forward and ``plan_batch`` against the JAX f64
    goldens (and the cluster net's gate logits); the six WCRBFNet runs'
    kernel against its plain version at B = 1,024, the others through the
    module path (no launch); the kernel on ``arch_wcrbf_shared`` (a shared
    head) and ``frenet_wide_cc`` (K = 499) timed in turns with the
    flagship; on K = 499 also the partial mode against its plain version,
    and the 2-rank EP forward (two partial launches, summed and finished)
    against the default kernel. Returns (launches, times)."""
    import torch

    from irbfn_tpu_torch.models import WCRBFNet
    from irbfn_tpu_torch.ops import rbf
    from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
    from irbfn_tpu_torch.sim import oval_track
    from irbfn_tpu_torch.train import input_bounds_from_config

    track = oval_track(30.0, 15.0, n_samples=512, speed=3.0, device=device)
    rng = np.random.default_rng(47)
    launches, lines = 0, []
    zoo, _, _ = _zoo_runs()
    timed = {"frenet_wide_pr1": (rbf.wcrbf_params_to_kernel(flagship), (
        torch.as_tensor(golden["x"], device=device)
        * flagship.input_scale).contiguous())}
    for run in zoo:
        model, config = _asset(os.path.join(ASSETS, run), device)
        g = _npz(os.path.join(ASSETS, f"{run}_golden.npz"))
        tol, kernel = TOL_ZOO[run], isinstance(model, WCRBFNet)
        torch.cuda.synchronize()
        reset_launches()
        with torch.no_grad():
            out = model(torch.as_tensor(g["x"], device=device))
        res = IRBFNFrenetPlanner(
            model, track, input_bounds=input_bounds_from_config(config)
        ).plan_batch(*torch.as_tensor(g["plan_in"], device=device).T)
        torch.cuda.synchronize()
        n = read_launches()["rbf_forward"]
        check(n == 2 * kernel, f"{run}: {n} rbf_forward launches for a "
              f"forward and a plan ({type(model).__name__})")
        launches += n
        out, logits = out if isinstance(out, tuple) else (out, None)
        e_fwd = _max_err(out.cpu(), torch.from_numpy(g["forward_f64"]))
        e_plan = max(_max_err(getattr(res, k).cpu(),
                              torch.from_numpy(g[f"plan_{k}"]))
                     for k in ("accel", "steer_vel"))
        line = (f"{run} ({type(model).__name__}, sum|w| "
                f"{_head_sum(model):.3g}, tol {tol:g}): forward {e_fwd:.2e}"
                f", plan {e_plan:.2e}")
        check(e_fwd <= tol and e_plan <= tol,
              f"{run} vs JAX f64: forward {e_fwd:.3e}, plan {e_plan:.3e} > "
              f"{tol:g}")
        if logits is not None:
            rows = g["logits_f64"].shape[0]
            e_log = _max_err(logits[:rows].cpu(),
                             torch.from_numpy(g["logits_f64"]))
            check(e_log <= TOL_RANDOM, f"{run} gate logits vs JAX f64: "
                  f"{e_log:.3e}")
            line += f", gate logits {e_log:.2e} (tol {TOL_RANDOM:g})"
        if kernel:
            x = (_zoo_inputs(rng, config, 1024, device)
                 * model.input_scale).contiguous()
            ops = rbf.wcrbf_params_to_kernel(model)
            line += (f", kernel vs plain B=1024 "
                     f"{_compare(f'{run} B=1024', x, ops, tol):.2e}")
            if run in ZOO_PARTIAL:
                n, part = _zoo_partial(run, model, x, ops, tol)
                launches += n
                line += part
            if run in ZOO_TIMED:
                timed[run] = (ops, x)
        else:
            line += ", module path"
        lines.append(line)
    # the kernel at B = 1024 in turns: the flagship, the shared head, K=499
    order = list(timed) + list(timed)[::-1]
    ms = {run: {"kernel": [], "plain": []} for run in timed}
    with torch.no_grad():
        for run in order:
            ops, x = timed[run]
            ms[run]["kernel"].append(_time_ms(
                lambda: rbf.wcrbf_forward(x, ops)))
            ms[run]["plain"].append(_time_ms(
                lambda: rbf.wcrbf_forward_reference(x, ops), iters=50,
                warmup=5))
    times = {}
    for run, t in ms.items():
        ops, x = timed[run]
        nbytes = 4 * (sum(o.numel() for o in ops[:7]) + x.numel()
                      + x.shape[0] * ops.w.shape[-1])
        bound_ms, bound_by = _bound(_rbf_flops(x.shape[0], ops), nbytes)
        times[run] = dict(ms=float(np.mean(t["kernel"])),
                          plain_ms=float(np.mean(t["plain"])),
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
    print("the committed zoo vs the JAX f64 goldens (256 rows), f32 on the "
          "card: " + "; ".join(lines) + "; the kernel at B=1024 (CUDA "
          "events, in turns with the flagship): " + "; ".join(
              f"{run} {t['ms']:.4f} ms (runs {ms[run]['kernel']}), plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']}" for run, t in times.items()), flush=True)
    return launches, times


def _zoo_partial(run, model, x, ops, tol):
    """The partial mode on the padded layout: the kernel's (B, O + 1) sums
    against the plain partial mode (relative to max(1, max|plain|), as the
    undivided sums grow with the gate sum) and finished against the plain
    default forward; then the 2-rank EP forward (``_sharded_forward``, one
    partial launch per rank, the path of phase 40) against the default
    kernel. Returns (EP launches, the line's part)."""
    import torch

    from irbfn_tpu_torch.ops import rbf

    with torch.no_grad():
        plain = rbf.wcrbf_forward_reference(x, ops, partial=True)
        got = rbf.wcrbf_forward(x, ops, partial=True)
        full = rbf.wcrbf_forward(x, ops)
        ref = rbf.wcrbf_forward_reference(x, ops)
        slices = _region_slices(model, 2)
        torch.cuda.synchronize()
        reset_launches()
        sharded = _sharded_forward(x, slices, rbf.wcrbf_forward)
        torch.cuda.synchronize()
        n = read_launches()["rbf_forward"]
    e_part = _max_err(got, plain) / max(1.0, float(plain.abs().max()))
    e_fin = _max_err(rbf.finish_partial(got, ops), ref)
    e_ep = _max_err(sharded, full)
    check(n == 2, f"{run} EP forward: {n} partial launches, not 2")
    check(bool(torch.isfinite(got).all() & torch.isfinite(sharded).all())
          and max(e_part, e_fin, e_ep) <= tol,
          f"{run} partial mode: vs plain partial rel {e_part:.3e}, finished"
          f" vs plain {e_fin:.3e}, 2-rank EP vs kernel {e_ep:.3e} > {tol:g}")
    return n, (f", partial mode vs plain rel {e_part:.2e} (gate sum up to "
               f"{float(plain[:, -1].max()):.2f}), finished {e_fin:.2e}, "
               f"2-rank EP forward vs kernel {e_ep:.2e} ({n} partial "
               "launches)")


def zoo_sweep(device, run, lanes, bounds=None):
    """One zoo net from its assets in phase 5's 1000-lane sweep for its
    golden's ``n_steps`` (``bounds``: the planner's input bounds, default
    the config's). Returns (final, traj, launches, seconds, (env, sim,
    policy), golden)."""
    import torch

    from irbfn_tpu_torch.models import WCRBFNet
    from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
    from irbfn_tpu_torch.train import input_bounds_from_config
    from irbfn_tpu_torch.utils.profiling import sweep_env

    model, config = _asset(os.path.join(ASSETS, run), device)
    g = _npz(os.path.join(ASSETS, f"{run}_golden.npz"))
    env, sim = sweep_env(device, "accl", lanes)
    planner = IRBFNFrenetPlanner(
        model, env.track, input_bounds=(input_bounds_from_config(config)
                                        if bounds is None else bounds))

    def policy(obs):
        r = planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                               obs.linear_vel_x, obs.linear_vel_y,
                               obs.ang_vel_z)
        return torch.stack([r.accel, r.steer_vel], dim=-1)

    final, traj, launches, wall = _drive(
        env, sim, policy, "rbf_forward", int(g["n_steps"]),
        int(isinstance(model, WCRBFNet)))
    return final, traj, launches, wall, (env, sim, policy), g


def zoo_loop_verdict(run, r, g):
    """A zoo sweep's readings (``_against``) against its golden by
    ``TOL_ZOO_LOOP``: (the readings with the laps apart and the per-lane
    |ey| statistic added, the line's part, the failed limits' names)."""
    done_tol, lap_tol, step_tol, ey_tol, sweep_tol = TOL_ZOO_LOOP[run]
    r["lap_step"] = int(np.abs(r["laps"] - g["loop_laps"]).max())
    r["ey_stat"] = float(r["d_ey_mm"].max() if run in ZOO_LANE_MAX
                         else np.median(r["d_ey_mm"]))
    failed = [name for name, v, tol in (
        ("done", r["n_done"], done_tol), ("laps", r["n_laps"], lap_tol),
        ("laps apart", r["lap_step"], step_tol),
        ("per-lane |ey|", r["ey_stat"], ey_tol),
        ("sweep", r["d_sweep_mm"], sweep_tol)) if not v <= tol]
    text = (f"{int((~r['done']).sum())}/{r['done'].size} lanes completed "
            f"(JAX {int((~g['loop_done']).sum())}), laps>=1 "
            f"{int((r['laps'] >= 1).sum())} (JAX "
            f"{int((g['loop_laps'] >= 1).sum())}); mean|ey| "
            f"{r['ey'].mean():.4f} m (JAX {g['loop_ey_mean'].mean():.4f}); "
            f"{r['n_done']} lanes' done (tol {done_tol}) and {r['n_laps']} "
            f"lanes' laps (tol {lap_tol}) differ, by up to {r['lap_step']} "
            f"(tol {step_tol}); per-lane diff median "
            f"{np.median(r['d_ey_mm']):.4f} mm, max {r['d_ey_mm'].max():.2f}"
            f" mm (tol {ey_tol} on the "
            f"{'max' if run in ZOO_LANE_MAX else 'median'}), sweep "
            f"{r['d_sweep_mm']:.4f} mm (tol {sweep_tol})")
    return r, text, failed


def phase_zoo_loops(device, golden):
    """Phase 48: the six single nets of the zoo (WCRBFNet per-region and
    shared heads, K = 499, the learned-gate cluster net, the deeper and MLP
    heads) in phase 5's 1000-lane sweep, CUT to their goldens' ``n_steps``,
    each against its JAX golden (``zoo_loop_verdict``). Returns the
    kernel's launches."""
    from irbfn_tpu_torch.utils.profiling import profile_loop

    lanes = {k: golden[k] for k in ("loop_mu", "loop_cs", "loop_noise")}
    total = 0
    for run in _zoo_runs()[1]:
        final, traj, launches, wall, (env, sim, policy), g = zoo_sweep(
            device, run, lanes)
        total += launches["rbf_forward"]
        steps = int(g["n_steps"])
        # where a step's time goes: ZOO_SPLIT steps after 2, synchronised
        # by part, then ZOO_PROFILED under torch.profiler
        split, step_ms, dev_ms, idle, per_step_launches = profile_loop(
            env, sim, policy, ZOO_SPLIT, 2, ZOO_PROFILED)
        r, text, failed = zoo_loop_verdict(run, _against(final, traj, g),
                                           g)
        print(f"zoo loop {run}: {text}; {steps} steps (CUT from 600) in "
              f"{wall:.2f} s = {steps / wall:.1f} control steps/s; "
              f"rbf_forward {launches['rbf_forward']} launches"
              + ("" if launches["rbf_forward"] else " (module path)")
              + f"; ms per step, median of {ZOO_SPLIT} synchronised: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; {ZOO_PROFILED} steps under the profiler {step_ms:.2f} "
              f"ms, device {dev_ms:.3f} ms, idle share {idle:.3f}, "
              f"{per_step_launches:.0f} kernel launches per step",
              flush=True)
        check(not failed, f"zoo loop {run}: {', '.join(failed)} past "
              f"TOL_ZOO_LOOP: {r['n_done']} lanes' done, {r['n_laps']} "
              f"lanes' laps (by up to {r['lap_step']}) differ, per-lane "
              f"|ey| {r['ey_stat']:.3f} mm, sweep {r['d_sweep_mm']:.4f} mm "
              "from JAX")
    return total


def phase_learned_bank(device):
    """Phase 49: ``eval_adaptive --nets`` over the three ``bank_pr_mu*``
    arms on the bundle that ``bank_pr_golden.npz`` holds (written back byte
    for byte), with the JAX run's flags, against the JAX script's JSON: the
    same pulls, since the bandits draw JAX's arms.
    Returns the kernel's launches: every arm's forward at every step of
    every round (the episodes and each arm's fixed baselines)."""
    import torch

    from irbfn_tpu_torch.sim import eval_adaptive

    g = _npz(_zoo_runs()[2])
    ref = json.loads(str(g["results_json"]))
    argv = [str(a) for a in g["argv"]]
    arms = [str(n) for n in g["nets"]]
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, "ovl")
        os.makedirs(bundle)
        for k in g:
            if k.startswith("bundle_"):
                with open(os.path.join(bundle, k[len("bundle_"):]),
                          "wb") as f:
                    f.write(g[k].tobytes())
        nets = [f"{p}.json:{p}.npz" for p in (
            os.path.join(ASSETS, n) for n in arms)]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res, _ = _quiet("phase49_eval_adaptive.log", eval_adaptive.main,
                        ["--device", "cuda", *argv, "--map_dir", bundle,
                         "--json_out", os.path.join(tmp, "adaptive.json"),
                         "--nets", *nets])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()["rbf_forward"]
    n_arms = len(arms)
    flag = dict(zip(argv, argv[1:]))
    steps = int(flag["--n_steps"])
    rounds = int(flag["--episodes"]) + n_arms * int(flag["--baseline_rounds"])
    check(launches == n_arms * steps * rounds,
          f"learned bank: {launches} rbf_forward launches, not {n_arms} arms"
          f" x {steps} steps x {rounds} rounds")
    e_fixed = _max_err(torch.as_tensor(res["fixed_rewards"]),
                       torch.as_tensor(ref["fixed_rewards"]))
    speeds = np.asarray(res["speed_scales"])
    e_speed = float(np.abs(speeds / np.asarray(ref["speed_scales"]) - 1.0)
                    .max())
    pulls, rewards = np.asarray(res["pulls"]), np.asarray(res["rewards"])
    fixed = np.asarray(res["fixed_rewards"])
    e_pulled = float(np.abs(rewards - fixed[pulls, np.arange(
        pulls.shape[1])]).max())
    print(f"learned bank (eval_adaptive --nets {' '.join(arms)}, "
          f"{' '.join(argv)}; the bundle written back from the golden): "
          f"fixed rewards {np.round(fixed, 4).tolist()} (JAX "
          f"{np.round(np.asarray(ref['fixed_rewards']), 4).tolist()}), "
          f"max|diff| {e_fixed:.2e} (tol {TOL_ADAPTIVE_REWARD:g}); speed "
          f"scales rel {e_speed:.1e} (tol 1e-12); pulled arms "
          f"{pulls.tolist()} (JAX {ref['pulls']}), each round's reward its "
          f"arm's baseline to "
          f"{e_pulled:.1e}; {launches} rbf_forward launches ({n_arms} per "
          f"step); {wall:.1f} s", flush=True)
    check(res["mode"] == ref["mode"] == "learned" and set(res) == set(ref),
          f"learned bank: result keys {sorted(res)} vs JAX {sorted(ref)}")
    check(e_fixed <= TOL_ADAPTIVE_REWARD and e_speed <= 1e-12,
          f"learned bank vs JAX: fixed rewards {e_fixed:.3e}, speed "
          f"scales {e_speed:.3e}")
    check(pulls.shape == (int(flag["--episodes"]), len(ref["combos"]))
          and ((pulls >= 0) & (pulls < n_arms)).all() and e_pulled <= 1e-6,
          f"learned bank: pulls {pulls.tolist()}, rewards {rewards.tolist()}")
    check(pulls.tolist() == ref["pulls"], f"learned bank: pulls "
          f"{pulls.tolist()}, JAX's {ref['pulls']} for the same seed")
    return launches


def phase_nmpc_trace(device):
    """Phase 50: ``python -m irbfn_tpu_torch.utils.profiling --parts nmpc
    --nmpc_batches 1000 --reps 4 --trace_dir DIR`` (``profile_nmpc.py``'s
    flags): the trace file must exist and name the solver's CUDA
    kernels."""
    from irbfn_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _quiet("phase50_profiling_nmpc.log", profiling.main,
               ["--parts", "nmpc", "--nmpc_batches", str(TRACE_ROWS),
                "--reps", "4", "--trace_dir", tmp])
        wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        check(os.path.exists(path), f"no trace at {path}")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    check(bool(kernels), "the NMPC trace names no CUDA kernel")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
    print(f"profiler trace of a {TRACE_ROWS:,}-row NMPC solve (profiling "
          f"--parts nmpc --reps 4 --trace_dir): {size / 2**20:.1f} MiB, "
          f"{len(events):,} events, {sum(kernels.values()):,} CUDA kernel "
          f"launches of {len(kernels)} kernels (most: "
          + ", ".join(f"{n[:40]} x{c}" for n, c in top)
          + f"); the tool's run {wall:.1f} s (its lines in "
          "torch_runs/chip_smoke_logs/phase50_profiling_nmpc.log)",
          flush=True)


PRNG_SECONDS = 10.0  # phase 51's budget for all of its draws on the card


def phase_prng(device):
    """Phase 51: ``utils/prng.py``'s draws on the card against the same
    calls on the CPU, bit for bit, each timed on the card. Returns the
    milliseconds by draw."""
    import torch

    from irbfn_tpu_torch.utils import prng

    n, m = 1 << 20, 1 << 16  # the CPU's side of the normal family is slow
    logits = torch.as_tensor(np.random.default_rng(0).normal(
        0, 2, (64, 7)).astype(np.float32))
    probs = torch.as_tensor(np.random.default_rng(1).dirichlet(
        np.ones(12)).astype(np.float32))

    def chain(dev):  # 64 splits, each subkey folded with its index
        k, out = prng.PRNGKey(0, device=dev), []
        for i in range(64):
            k, sub = prng.split(k)
            out.append(prng.fold_in(sub, i))
        return torch.stack(out)

    def exp3(dev):  # 64 pulls of a 12-arm bandit, JAX's choice
        k, out = prng.PRNGKey(3, device=dev), []
        for _ in range(64):
            k, sub = prng.split(k)
            out.append(prng.choice(sub, 12, probs.to(dev)))
        return torch.stack(out)

    def key(seed, dev):
        return prng.PRNGKey(seed, device=dev)

    draws = {
        "key chain (64 splits + folds)": chain,
        "bits (2^20)": lambda d: prng.bits(key(1, d), (n,)),
        "uniform (2^20, [-3, 5.5))": lambda d: prng.uniform(
            key(2, d), (n,), minval=-3.0, maxval=5.5),
        "sweep start noise (1000, 3)": lambda d: prng.normal(
            prng.split(key(0, d))[1], (1000, 3)),
        "normal (2^16)": lambda d: prng.normal(key(4, d), (m,)),
        "truncated normal (2^16)": lambda d: prng.truncated_normal(
            key(5, d), -2, 2, (m,)),
        "gumbel (2^16)": lambda d: prng.gumbel(key(6, d), (m,)),
        "PPO start uniform (64)": lambda d: prng.uniform(
            key(7, d), (64,), maxval=50.0),
        "PPO categorical (64 x 7)": lambda d: prng.categorical(
            key(8, d), logits.to(d)),
        "PPO permutation (4096)": lambda d: prng.permutation(key(9, d),
                                                             4096),
        "EXP3 choice (64 pulls, 12 arms)": exp3,
    }
    ms, differ = {}, []
    for name, fn in draws.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(device)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        got, want = got.cpu(), fn("cpu")
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            differ.append(name)
    total = sum(ms.values()) / 1e3
    print("JAX's streams on the card against the CPU, bit for bit: "
          + "; ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f"; {total:.2f} s in all (budget {PRNG_SECONDS:g} s)"
          + (f"; DIFFER: {', '.join(differ)}" if differ else ""),
          flush=True)
    check(not differ, f"prng on the card differs from the CPU: {differ}")
    check(total <= PRNG_SECONDS, f"prng draws took {total:.2f} s on the "
          f"card, over {PRNG_SECONDS:g} s")
    return ms


def committed_zoo(device, flagship, golden):
    """Phases 47-50; (the zoo's rbf_forward launches, the timed nets)."""
    t = [time.perf_counter()]
    launches, times = phase_zoo(device, flagship, golden)
    t.append(time.perf_counter())
    launches += phase_zoo_loops(device, golden)
    t.append(time.perf_counter())
    launches += phase_learned_bank(device)
    t.append(time.perf_counter())
    phase_nmpc_trace(device)
    t.append(time.perf_counter())
    print("phases 47-50 took " + ", ".join(
        f"{b - a:.1f}" for a, b in zip(t, t[1:])) + " s", flush=True)
    return launches, times


# host seconds of each phase function and phase group, summed over calls
# (a group's time holds its phases'); printed before the kernels line
SECONDS = {}


def _timed(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            SECONDS[fn.__name__] = (SECONDS.get(fn.__name__, 0.0)
                                    + time.perf_counter() - t0)
    return run


for _name in [n for n, f in globals().items() if callable(f) and (
        n.startswith("phase_") or n in (
            "frenet_chain", "worlds", "clothoid_chain", "linear_mpc_and_sim",
            "multi_device", "port_tools", "committed_zoo"))]:
    globals()[_name] = _timed(globals()[_name])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: chip_smoke.py runs on a GPU only")
    sys.path.insert(0, ROOT)
    import irbfn_tpu_torch  # noqa: F401  (the port; fails outside the repo)

    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    with np.load(ASSET + "_golden.npz") as z:
        golden = {k: z[k] for k in z.files}
    with np.load(GOAL_GOLDEN) as z:
        goal_golden = {k: z[k] for k in z.files}
    # the learned Frenet planner
    model, config, err_1024 = phase_kernel_vs_plain(device, golden)
    track, planner = phase_against_jax(device, model, config, golden)
    rbf_launches, flagship_loop = phase_closed_loop(device, planner, golden)
    rbf_times = phase_times(device, model, golden)
    # the goal-MPC path
    lattice_goals, _ = _lattice_goals()
    admm_err = phase_admm_vs_plain(device, lattice_goals)
    net = phase_goal_net(device, goal_golden)
    phase_goal_against_jax(device, goal_golden, net)
    _, _, lattice = phase_lattice(device)
    phase10_family_s = lattice["seconds"] / lattice["speed"].shape[0]
    admm_launches = phase_goal_loop(device, goal_golden, "solver",
                                    net)["launches"]
    net_loop = phase_goal_loop(device, goal_golden, "net", net)
    admm_times = phase_goal_times(device, lattice_goals, net, goal_golden)
    # the fit-and-train path
    with tempfile.TemporaryDirectory() as out_dir:
        fit, table, asset = phase_fit(device, lattice, out_dir)
        del lattice
        chain_launches = phase_fit_eval(device, fit, table, asset)
        del table
        phase_finetune(device, fit)
    phase_goal_loop(device, goal_golden, "net", fit["model"].eval(),
                    against=net_loop)
    del fit
    phase_train_golden(device)
    frenet_launches, loop_launches = frenet_chain(device, golden,
                                                  flagship_loop)
    # the map world and the bank
    world_rbf, osch_admm = worlds(device, model, config)
    # the clothoid chain and the cartesian chain
    clothoid_rbf, clothoid = clothoid_chain(device)
    cart_rbf = phase_cartesian_chain(device)
    # the linear-MPC family, the rest of the sim, PPO and the demos
    quad, tracking, demos = linear_mpc_and_sim(device)
    # multi-device: the EP forward, the sharded datagen, the dry run
    md = multi_device(device, model, golden, lattice_goals, phase10_family_s)
    # the last tools: raceline makers, oracle generator, TrajGen, ceilings
    trajgen_rbf = port_tools(device)
    # the committed zoo, its loops, the learned bank, the NMPC trace
    zoo_rbf, zoo_times = committed_zoo(device, model, golden)
    # JAX's random streams on the card
    phase_prng(device)
    print("seconds by phase function and group: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(SECONDS.items(),
                                          key=lambda kv: -kv[1])),
          flush=True)
    print(f"all 51 phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(CARD[-1], flush=True)
    print(json.dumps({"kernels": [
        dict(KERNELS["rbf_forward"],
             launches=(rbf_launches + frenet_launches + loop_launches
                       + sum(world_rbf.values())
                       + sum(clothoid_rbf.values()) + cart_rbf
                       + quad["run"] + quad["loop"] + demos["rbf"]
                       + md["rbf"] + trajgen_rbf + zoo_rbf),
             launches_frenet_loop=rbf_launches,
             launches_frenet_chain=frenet_launches + loop_launches,
             **{f"launches_{k}": v for k, v in world_rbf.items()},
             launches_fit_eval=chain_launches["rbf_forward"],
             **{f"launches_clothoid_{k}": v for k, v in clothoid_rbf.items()},
             launches_cartesian_chain=cart_rbf,
             launches_quadrotor_pipeline=quad["run"],
             launches_quadrotor_loop=quad["loop"],
             launches_demos=demos["rbf"],
             launches_multi_device=md["rbf"],
             launches_trajgen=trajgen_rbf,
             launches_zoo=zoo_rbf,
             committed_nets_b1024=zoo_times,
             partial_mode=md["partial"],
             quadrotor_pr={k: v for k, v in quad.items()
                           if k not in ("run", "loop")},
             clothoid_pr={k: v for k, v in clothoid.items()
                          if k not in ("means",)},
             max_abs_err=err_1024, **rbf_times),
        dict(KERNELS["admm_solve"],
             launches=(admm_launches + osch_admm + tracking["launches"]
                       + demos["admm"] + md["admm"]),
             launches_goal_loop=admm_launches,
             launches_oschersleben=osch_admm,
             launches_tracking=tracking["launches"],
             launches_demos=demos["admm"],
             launches_sharded_datagen=md["admm"],
             tracking={k: v for k, v in tracking.items()
                       if k != "launches"},
             launches_fit_eval=chain_launches["admm_solve"],
             max_abs_err=admm_err, **admm_times)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
