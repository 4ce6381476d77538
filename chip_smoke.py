#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

Drives the port's paths, those with a QP through the hand-written ADMM
kernels:

- the condensed double-integrator MPC fleet (K=50 horizon, n = m = 52 QP,
  B = 8192 controllers on one clock, float32, the bench.py configuration)
  through the shared-matrix kernel (csrc/admm_shared.cu);
- the README Quickstart's SE(2) vehicle fleet on per-member clocks (K=30,
  n = 163, m = 99 sparse QP, B = 1024, float32, every member transcribed and
  factorized on its own) through the per-problem kernel
  (csrc/admm_problem.cu);
- the SE(2) x R^3 vehicle MPC + ASIF fleet of benchmarks/asif_bench.py
  (B = 256), its MPC through the shared-matrix kernel, its ASIF on the lane
  backend with adaptive rho (asif_bench.py's settings) through the lane
  kernel (csrc/admm_lane.cu);
- benchmarks/ekf_bench.py's EKF fleets (SE(2) and SO(3), B = 4096, float32;
  the fleet, square-root fleet and vmap layouts; no kernel: dense batched
  algebra);
- examples/output_feedback_vehicle.py's EKF -> MPC -> ASIF loop (40 of its
  800 steps), both QPs through the per-problem kernel at B = 1;
- examples/pid_se2.py (2000 steps) and a spline round trip on SE(2), SO(3);
- benchmarks/ocp_se2.py's SE(2) OCP sweep (the JAX package's BASELINE
  config 5, on-device protocol): B = 64 flat SE(2) x R^2 collocation OCPs
  on Mesh.uniform(3, 5) (NLP n = m = 112) solved in one lockstep SQP,
  every subproblem batch (QP n = 112, m = 224) through the per-problem
  kernel, then the rescue pass for the tail;
- the same fleet with mesh refinement (the reference's
  examples/ocp_se2_nlp.cpp:47-91): solve_ocp_flat_batch from
  Mesh.uniform(3, 5), each member starting from (identity, (1, 0)), every
  pass's and every rescue's subproblems through the per-problem kernel
  (the refined passes' on its streaming route);
- examples/ocp_se2_nlp.py's OCP through solve_ocp (B = 1) and
  examples/ocp_se2_qp.py's QP through ocp_to_qp, solve_qp and
  qpsol_to_ocpsol;
- benchmarks/qp_bench.py's f32 lane column (B = 256 random QPs at n = m =
  8, 32, 96, density 0.3) and a (3, 24) family with adaptive rho and
  compensated checks through the lane kernel; n = m = 128 on the plain
  lane loop (the counted fall-through).
- examples_torch/, the port's examples: the four whose problems the
  phases above build come from those files (pid_se2, output_feedback_vehicle,
  ocp_se2_nlp, ocp_se2_qp); the other nine run in the examples phase, each
  through its kernel route: the SE(3) x R^6 hover MPC (admm_problem), the
  SE(3) x R^3 OCP fleet with mesh refinement (B = 8, admm_problem), the
  condensed double-integrator MPC at B = 1 (admm_shared), the
  double-integrator ASIF (admm_lane), the vehicle MPC + ASIF (admm_problem,
  admm_lane), the double-integrator OCP as one QP (admm_problem) and as an
  NLP with refinement (admm_problem), and the two EKF examples.

Phases:

  1. device: refuses to run without a CUDA device; prints the card's name and
     power limit;
  2. build: compiles the CUDA sources with nvcc for sm_90a, one nvcc per
     source, in parallel;
  3. each kernel against its plain PyTorch version at its path's shapes: 20
     fixed iterations (iterates and returned residuals), one cold and one
     warm-started solve, every point the kernel calls Optimal re-checked in
     float64, both times, each as the mean of back-to-back calls and as the
     median of single launches (the shared
     kernel's also at B = 1024 and, cold, with the members sorted by their
     iteration counts); the layout each launch takes at its path's shape,
     where the per-problem kernel must keep Minv and As resident in shared
     memory; the per-problem kernel also on a numpy family whose members
     fire every certificate; the lane kernel at the ASIF's (3, 53) with
     adaptive rho off (fixed iterations) and on (whole solves: statuses
     against float64, iteration and refactorization counts against the
     plain version), and on the lane phase's shapes;
  4. each path: closed-loop fleet steps with every launch count set to 0
     just before and read just after, step time, the Optimal share, and the
     first steps again on the plain path;
  5. ekf-fleet: the three layouts held against each other and against the
     CPU float64 port, rates over 100 chained steps, a step split, the
     square-root P checked PSD, the batched library calls timed against
     the lane helpers; output-feedback: the loop with the barrier on the
     true state, the estimation error, one admm_problem launch per QP, a
     step split, the first steps again on the torch loop, the kernel held
     against its plain version at the loop's two shapes; pid-spline;
     shared-route: shared factors past the shared kernel's shapes take the
     torch shared loop on the card, nothing launched; ocp-sweep: the
     Optimal share after rescue against the JAX package's on the same
     velocities, every Optimal member's KKT residual recomputed in float64,
     one admm_problem launch per lockstep iteration, sweep and rescue
     times, a synchronised split of one lockstep iteration, the kernel held
     against its plain version on the first subproblem batch, the first
     iterations again on the torch loop, and the single-problem form on
     one member; ocp-refine: per pass the mesh, Optimal shares, launches
     and stage times, each pass's error estimate against its float64
     recomputation, the Optimal share after each rescue against the JAX
     package's, the final error and float64 KKT, the kernel held against
     its plain version on the second pass's first subproblem batch;
     ocp-solve and ocp-qp: the single OCP's passes against the JAX
     package's and its start, the QP's x(t) against the torch loop's;
     examples: each of the nine at its own width, its depth cut where it
     says so, with its own assertions, its launches, its states held to a
     float64 run on the CPU, the kernels at its QPs (for the two
     refinement examples at each pass's first subproblem batch; for the
     SE(3) fleet also each pass's error estimate against its float64
     recomputation and every member's KKT residual in float64);
  6. a JSON line of the kernels (with each one's bound on this card, its
     launches on each path and the shapes it was held at), the card's name
     and power limit, then the result line.

Run from the repository root:  python3 chip_smoke.py
Any failed phase exits non-zero.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from examples_torch._common import card_qp_params
from examples_torch.mpc_asif_vehicle import asif_filter, f as vehicle_asif_f
from examples_torch.ocp_se2_nlp import ocp_example, se2_tracking
from examples_torch.ocp_se2_qp import ocp_qp_problem
from examples_torch.output_feedback_vehicle import (
    DT as OF_DT, output_feedback_path, output_feedback_start, output_feedback_step,
)
from examples_torch.pid_se2 import PID_DT, PID_STEPS
from smooth_feedback_tpu_torch.utils.flops import H100_PEAK_F32

B = 8192
K = 50
DT = 0.05
STEPS = 200
SEED = 0

# the per-member-clock SE(2) vehicle fleet
FLEET_B = 1024
FLEET_K = 30  # benchmarks/asif_bench.py:73
FLEET_STEPS = 50
FLEET_PLAIN_STEPS = 3
TWIST = (0.5, 0.0, 0.3)

# the SE(2) x R^3 vehicle MPC + ASIF fleet (benchmarks/asif_bench.py:39-123)
ASIF_B = 256  # the bench's default fleet
ASIF_MPC_K = 30
ASIF_DT = 0.025
ASIF_WARM = 20  # 40 before the EKF and output-feedback phases joined the smoke
ASIF_STEPS = 20  # 40 before the refinement phases joined the smoke
ASIF_PLAIN_STEPS = 5
ASIF_T = 2.5

# benchmarks/ekf_bench.py's fleets at its B; its 100 chained steps cut to
# 50 for the smoke's time when the examples joined it
EKF_B = 4096
EKF_STEPS = 20  # 50 until the parallel slice joined the smoke (100 in ekf_bench.py)
EKF_REPS = 2  # ekf_bench.py takes the best of 3
EKF_TAU = 0.05
EKF_CHECK_STEPS = 10
EKF_CPU_STEPS = 3

# examples/output_feedback_vehicle.py's loop, OF_STEPS of its 800 steps
OF_STEPS = 20  # 40 before the refinement phases joined the smoke
OF_PLAIN_STEPS = 5
OF_KERNEL_STEPS = 10

# benchmarks/ocp_se2.py's on-device protocol (the JAX package's BASELINE
# config 5): B = 64 flat SE(2) x R^2 OCPs on Mesh.uniform(3, 5), f32
OCP_B = 64
OCP_MESH = (3, 5)
OCP_QP_SHAPE = (112, 224)  # the SQP subproblem: n, m + n (bound rows)
OCP_SPLIT_REPS = 5
# the kernel against its plain version on the path's subproblems: a single
# iteration on the first lockstep iteration's, FIXED_ITERS and the warm
# solve on the earliest resolved of the first OCP_KERNEL_ITERS (PERF.md, section 6)
OCP_FIRST_ITERS = 1
OCP_KERNEL_ITERS = 12
OCP_MIN_STOPPED = 4
# a relative check must resolve 1 % of a member's scale
OCP_RESOLVE = 1e-2
# members the three routes solve to the end side by side
OCP_ROUTE_B = 4
# the JAX package's Optimal share on the same velocities (f32, CPU, "xla",
# the same protocol; python3 ocp_sweep_jax.py): 100 % before and after rescue
OCP_JAX_OPTIMAL = 1.0
OCP_TOL = 1e-4
# the fleet refinement (BASELINE config 5 with refinement: the reference's
# examples/ocp_se2_nlp.cpp:47-91 on the sweep's family) and the single
# SE(2) OCP: from Mesh.uniform(3, 5), at most 3 passes, tf guess 5, to a
# dynamics error of 1e-4 for the single OCP and 1e-3 for the fleet: at 1e-4
# the JAX package's own f32 fleet ends its 3 passes at 3.44e-4 (the
# fleet-max error stalls on the first interval, where the hardest members
# saturate |u| <= 1)
OCP_TARGET_ERR = 1e-4
OCP_FLEET_TARGET_ERR = 1e-3
OCP_REFINE_ITER = 3
OCP_TF_GUESS = 5.0
# the fleet starts at rest on the screw's speeds of examples/ocp_se2_nlp.py,
# (1, 0), not on its own screw: the sweep's start makes each member's
# optimum the screw itself, e(t) = t vel in the flat coordinates, which the
# start mesh already holds to rounding (the JAX package's f32 fleet ends in
# one pass, fleet-max error 3.5e-6), so nothing would refine
OCP_REFINE_START = (1.0, 0.0)
# the JAX package's readings on the same velocities, problems and protocol
# (f32, CPU, "xla"; python3 ocp_sweep_jax.py --refine): the fleet's Optimal
# share after rescue and mesh on each pass (1 of 64 rescued on pass 0), the
# per-interval fleet-max errors of each pass that refined; the single OCP's
# pass count.  The fleet-max errors follow the SQP's f32 tolerance in one
# member's converged point: on the same first pass JAX reads 3.9e-4 on the
# second interval (member 15, Optimal at KKT 7.9e-5) and the port's route
# through admm_problem's plain version 9.8e-6 (CPU), so the two refine
# other intervals and take 2 and 3 passes.  The smoke prints the passes
# beside JAX's and holds each pass's error estimate to its float64
# recomputation on the CPU instead.
OCP_JAX_REFINE_OPTIMAL = (1.0, 1.0, 1.0)
OCP_JAX_REFINE_MESHES = (((5, 0.0), (5, 1 / 3), (5, 2 / 3)), ((8, 0.0), (7, 1 / 3), (5, 2 / 3)),
                         ((10, 0.0), (7, 1 / 3), (5, 2 / 3)))
OCP_JAX_REFINE_ERRS = ((2.1074365358799696e-3, 3.939935122616589e-4, 2.8927004677825607e-5),
                       (1.1823103995993733e-3, 7.432830170728266e-5, 1.6556035916437395e-5))
# the card's f32 error estimate against the f64 one on the same
# trajectories, per interval (the CPU's f32 estimate lands within 6.9e-8)
OCP_REFINE_ERR_ATOL, OCP_REFINE_ERR_RTOL = 1e-6, 1e-3
OCP_JAX_SOLVE_PASSES = 2
# the second pass's subproblem on JAX's refined mesh (3 intervals, 20
# points): QP n = 147, m = 294, past the per-problem kernel's shared
# memory, so streamed (the card tests' shape)
OCP_REFINED_QP_SHAPE = (147, 294)
# examples/ocp_se2_qp.py's default, and its solver settings (max_iter 20000,
# polish) at eps 1e-3 in place of its 1e-6: the example runs float64, and
# on this QP float32 ADMM stalls at residuals of ~3e-4 (primal) and ~1e-3
# (dual) on both routes (the equality rows' rho of 100 scales each
# iteration's rounding into y), so at eps 1e-4 and below it ends
# MaxIterations after 20000 iterations; at 1e-3 it stops and the polish
# lands within 1.3e-7 of the float64 eps-1e-6 solution (CPU readings)
OCP_QP_IVALS = 10
OCP_QP_EPS = 1e-3
# step 0: a shared-factor batch past the shared kernel's shapes
SHARED_ROUTE_N = 160
SHARED_ROUTE_B = 4


def ocp_sweep_velocities(B_=OCP_B, seed=SEED):
    """(B, 3) tracked screw velocities, benchmarks/ocp_se2.py's
    distribution (``_random_vels``) drawn with numpy: (1 + 0.3 N, 0,
    0.5 + 0.2 N)."""
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal(B_), rng.standard_normal(B_)
    return np.stack([1.0 + 0.3 * a, np.zeros(B_), 0.5 + 0.2 * b], axis=1)


def ocp_sweep_flat(dtype=torch.float32, device="cuda", start=None):
    """benchmarks/ocp_se2.py:112-139 through the port's API: the flat OCP
    of one tracked screw velocity ``vel`` (3,), as ``make_flat(vel)`` for
    ``solve_ocp_flat_batch``.  X = SE(2) x R^2 (the speeds along the
    screw), U = R^2; cost tf + q with q the integral of |x (-) xdes|^2/2 +
    |u|^2/2, |u| <= 1, tf = 5, x0 = (identity, the screw's speeds);
    flattened about the identity and u = 0.01.  ``start`` (2,) fixes x0's
    speeds instead (the refinement fleet's start, OCP_REFINE_START)."""
    from smooth_feedback_tpu_torch.ocp import OCP, flatten_ocp

    kw = dict(dtype=dtype, device=device)
    bound_u = torch.ones(2, **kw)
    ends = torch.tensor([5.0, 0, 0, 0, 0, 0], **kw)
    u_nom = torch.full((2,), 0.01, **kw)
    fixed = None if start is None else torch.tensor(start, **kw)

    def make_flat(vel):
        X, U, f, g = se2_tracking(vel)
        x0_speeds = torch.stack([vel[0], vel[2]]) if fixed is None else fixed
        x_nom = X.identity(**kw)
        ocp = OCP(
            X=X, U=U,
            theta=lambda tf, x0, xf, q: tf + q[0],
            f=f, g=g,
            cr=lambda t, x, u: u, crl=-bound_u, cru=bound_u,
            ce=lambda tf, x0, xf, q: torch.cat(
                [tf[None], X.log(x0) - torch.cat([torch.zeros_like(vel), x0_speeds])]
            ),
            cel=ends, ceu=ends,
        )
        return flatten_ocp(ocp, lambda t: x_nom, lambda t: u_nom)

    return make_flat


def ocp_sweep_problem(mesh, dtype=torch.float32, device="cuda", start=None):
    """The flat NLP of :func:`ocp_sweep_flat`'s OCP on ``mesh``, as
    ``make(vel)`` for ``solve_nlp_sqp_batch``."""
    from smooth_feedback_tpu_torch.ocp import ocp_to_nlp

    make_flat = ocp_sweep_flat(dtype, device, start)
    return lambda vel: ocp_to_nlp(make_flat(vel), mesh)


# examples/pid_se2.py's PID_STEPS steps at PID_DT
# card f32 splines against the CPU f64 port, (g, body velocity, body
# acceleration): the phase run on a CPU in f32 lands within 2.4e-7, 1.1e-6
# and 9.0e-6 of f64; about forty times that
SPLINE_TOL = (1e-5, 5e-5, 5e-4)

KERNELS = {
    "admm_shared": ("smooth_feedback_tpu_torch/csrc/admm_shared.cu",
                    "smooth_feedback_tpu/qp/pallas_kernel.py:234"),
    "admm_problem": ("smooth_feedback_tpu_torch/csrc/admm_problem.cu",
                     "smooth_feedback_tpu/qp/pallas_kernel.py:47"),
    # no Pallas kernel: the JAX package's lane backend, one XLA while_loop
    "admm_lane": ("smooth_feedback_tpu_torch/csrc/admm_lane.cu",
                  "smooth_feedback_tpu/qp/solver.py:645"),
}
# NVIDIA H100 SXM data sheet: HBM3 rate and (utils/flops.py) the f32 rate
# outside the tensor cores (the kernels run IEEE f32 FMAs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = H100_PEAK_F32


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def require(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device (this script runs only on a GPU)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    phase("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}")
    return card


def build_phase():
    from smooth_feedback_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    phase("build", f"built and loaded in {time.perf_counter() - t0:.3f} s "
                   f"(nvcc {_build.build_seconds:.3f} s)")
    # ptxas's report, one line a kernel: its template arguments (admm_problem:
    # 32-column tiles a warp covers, 0 streams; admm_shared: entries a lane,
    # problems a warp), registers and spills
    name = "?"
    for line in _build.build_log.splitlines():
        found = re.search(r"\d(admm_[a-z]+_kernel)(?:I((?:Li\d+E)+))?", line)
        if found:
            name = found.group(1) + ("<" + ", ".join(re.findall(r"Li(\d+)E", found.group(2))) + ">"
                                     if found.group(2) else "")
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            phase("build", f"{name}: {line.split(':', 1)[1].strip()}; {spills}")


def layout_phase():
    """The layout each launch takes at its path's shape, asked of the built
    library and held against the Python mirrors; the per-problem kernel must
    run resident at (163, 99)."""
    import ctypes

    from smooth_feedback_tpu_torch import _build
    from smooth_feedback_tpu_torch.qp import cuda_kernel as ck

    lib = _build.load()
    block = qp_params("cuda").kernel_block
    for b in (B, 1024):
        out = (ctypes.c_int * 4)()
        require(lib.admm_shared_plan(b, 52, 52, block, out) == 0,
                "admm_shared_plan refused the path's shape")
        phase("layout", f"admm_shared at B={b}, n=m=52, kernel_block={block}: {out[0]} problems a "
                        f"warp, {out[1]} problems and {out[2]} warps a block, {out[3]} bytes of "
                        f"shared memory a block")
        require(tuple(out) == ck.shared_plan(b, 52, 52, block),
                "shared_plan does not mirror the library")
    smem = ctypes.c_int(0)
    resident = lib.admm_problem_route(163, 99, ck.PROBLEM_WARPS, ctypes.byref(smem))
    route = "resident" if resident else "streaming"
    phase("layout", f"admm_problem at n=163, m=99: {route} route, {ck.PROBLEM_WARPS} warps and "
                    f"{smem.value} bytes of shared memory a block")
    require((route, smem.value) == ck.problem_route(163, 99),
            "problem_route does not mirror the library")
    require(resident == 1, "the per-problem kernel does not keep Minv and As resident at (163, 99)")
    n, m = OCP_QP_SHAPE
    resident = lib.admm_problem_route(n, m, ck.PROBLEM_WARPS, ctypes.byref(smem))
    route = "resident" if resident else "streaming"
    phase("layout", f"admm_problem at the OCP sweep's n={n}, m={m}: {route} route, {smem.value} "
                    f"bytes of shared memory a block")
    require((route, smem.value) == ck.problem_route(n, m),
            "problem_route does not mirror the library")
    require(resident == 1, f"the per-problem kernel does not keep Minv and As resident at ({n}, {m})")
    streamed = lib.admm_problem_route(600, 600, ck.PROBLEM_WARPS, ctypes.byref(smem))
    require(streamed == 0 and ck.problem_route(600, 600)[0] == "streaming",
            "n = m = 600 is not streamed")
    # admm_lane at the ASIF's, the examples' and the lane phase's shapes, the
    # boundary shapes (32, 1140) and (105, 105); n = m = 128 refused
    for b, n, m in [(ASIF_B, 3, 53), (1, 2, 32), (1, 3, 53), *((LANE_B, k, k) for k in LANE_SHAPES),
                    (LANE_B, *LANE_ADAPTIVE_SHAPE), (4, 32, 1140), (4, 105, 105)]:
        out = (ctypes.c_int * 4)()
        require(lib.admm_lane_plan(b, n, m, out) == 1, f"admm_lane_plan refused ({n}, {m})")
        require(tuple(out) == ck.lane_plan(b, n, m), "lane_plan does not mirror the library")
        phase("layout", f"admm_lane at B={b}, n={n}, m={m}: {out[0]} problems (warps) and "
                        f"{out[1]} bytes of shared memory a block, P and A in "
                        f"{'shared' if out[2] else 'device'} memory, "
                        + (f"register path (n = {out[3]})" if out[3] else "a lane per output"))
    n = LANE_FALLTHROUGH_N
    require(lib.admm_lane_plan(4, n, n, out) == 0 and not ck.lane_fits(n, n),
            f"n = m = {n} fits the lane kernel")


def make_main_path(backend, dev):
    """bench.py's configuration, rewritten in torch."""
    from smooth_feedback_tpu_torch.controllers import MPCParams, MPCWeights, make_mpc_step
    from smooth_feedback_tpu_torch.groups import Rn

    dt = torch.float32
    kw = dict(dtype=dt, device=dev)
    return make_mpc_step(
        Rn(2), Rn(1),
        lambda x, u: torch.stack([x[1], u[0]]),
        lambda t: torch.stack([-0.5 * torch.sin(0.3 * t), -0.15 * torch.cos(0.3 * t)]),
        lambda t: torch.zeros(1, **kw),
        weights=MPCWeights(Q=torch.eye(2, **kw), Qtf=0.1 * torch.eye(2, **kw),
                           R=0.1 * torch.eye(1, **kw)),
        params=MPCParams(
            K=K, tf=5.0, return_trajectories=False,
            qp=qp_params(backend),
        ),
        cr=lambda x, u: u, crl=[-0.5], cru=[0.5],
        dtype=dt, device=dev, reuse_factors=True, condense=True,
    )


def qp_params(backend):
    """bench.py's solver settings (bench.py:75-93) on a port backend."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(scaling=True, polish=False, rho=2.0, rho_eq_scale=15.0,
                          max_iter=100, stop_check_iter=10, backend=backend)


def initial_states(dev):
    xs = 0.5 * np.random.default_rng(SEED).standard_normal((B, 2))
    return torch.as_tensor(xs, dtype=torch.float32, device=dev)


def time_ms(fn, reps):
    """Mean device time of one call of ``fn`` in ms: one pair of events around
    ``reps`` back-to-back calls (after a warm-up).  Every ``ms`` and
    ``plain_ms`` in the kernels line is taken this way.  Where the host
    needs longer to enqueue a call than the card to run it, this reads the
    host's pace: the kernels line's ``single_ms`` is :func:`time_single_ms`'s
    reading of the same call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_single_ms(fn, reps):
    """Median device time of one call of ``fn`` in ms.  Each of ``reps``
    calls (after a warm-up) sits between its own pair of events, behind a
    spin kernel of about half a millisecond that keeps the card busy while
    the host enqueues the call: the events then bracket the call's device
    work alone, also when that is shorter than the host's own time to
    launch it."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # cycles
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
        torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs]))


FIXED_ITERS = 20
# f32 kernel against f32 plain version, another summation order and FMA
# contraction: on a CPU the f32 plain version differs from its f64 run by
# 2e-5..7e-5 after 40 iterations of tests/test_torch_cuda.py's random 52x52
# family, and 20 iterations of the main path's better-scaled QPs stay below.
# is scaled by max(1, |v|_inf) of each vector.  On the sparse fleet path
# every row is an equality (rho = 100): each iteration adds 100 times the
# rounding of A x to y, and after 20 iterations the f32 plain version's y
# sits ~1e-3 from its f64 run (PERF.md).  So each vector may also
# differ by twice that measured floor: a kernel as close to the f64 run as
# the f32 plain version is lies within it.
ITER_TOL = 1e-4
PRIMAL_TOL = 1e-4
# The residuals a kernel returns (pres, dres of the last check) are f32
# max-norms of differences of products larger than themselves (A x - z;
# P x + q + A' y), so they carry those products' rounding: each may differ
# from the plain version's by 1e-3 + 1e-2 of its size, plus twice the f32
# plain version's own distance from its f64 run.
RES_ATOL, RES_RTOL = 1e-3, 1e-2


def f64(args):
    return tuple(a.double() if a is not None and a.dtype == torch.float32 else a for a in args)


def wrappers():
    from smooth_feedback_tpu_torch.qp import (
        admm_iterate_cuda, admm_iterate_cuda_shared, admm_solve_cuda_lane,
    )

    return {"admm_shared": admm_iterate_cuda_shared, "admm_problem": admm_iterate_cuda,
            "admm_lane": admm_solve_cuda_lane}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in wrappers().items()}


def n_checks(iters, k):
    """Stopping checks a member ran in ``iters`` iterations (it % k == 1 % k)."""
    first = 1 % k
    return torch.where(iters > first, torch.div(iters - 1 - first, k, rounding_mode="floor") + 1, 0)


def bound(args, out, prm):
    """The least time the card could take for one kernel call, in ms, and
    what sets it: every input read once and every output written once at the
    HBM rate, against the matrix-vector FMAs this call's members needed (3
    products an iteration, 6 more at each check) at the f32 rate."""
    n, m = args[1].shape[-1], args[1].shape[-2]
    moved = sum(a.numel() * a.element_size() for a in (*args, *out))
    iters = out[4].to(torch.int64)
    per_iter = 2 * (2 * m * n + n * n)
    per_check = 2 * (4 * m * n + 2 * n * n)
    flops = float((iters * per_iter + n_checks(iters, prm.stop_check_iter) * per_check).sum())
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def residual_slack(qps, args, out, prm, scalings=None):
    """Worst ratio, over the members the kernel calls Optimal, of each
    unscaled residual (re-evaluated in float64) to its stopping tolerance
    (plus 1e-4 for the kernel's own f32 evaluation).  ``qps`` holds P and A
    with a leading axis of 1 (shared) or B; ``scalings`` ``(sx, sy, c)``,
    by default where the ADMM kernels' arguments hold them."""
    d = torch.float64
    sx, sy, c = (a.to(d) for a in (scalings or args[7:10]))
    c = c.reshape(-1, 1)
    q = qps.q.to(d)

    def mv(M, v):
        M = M.to(d)
        return v @ M[0].T if M.shape[0] == 1 else torch.einsum("bij,bj->bi", M, v)

    def mtv(M, v):
        M = M.to(d)
        return v @ M[0] if M.shape[0] == 1 else torch.einsum("bij,bi->bj", M, v)

    x = out[0].to(d) * sx
    z = out[1].to(d) / sy
    y = out[2].to(d) * sy / c
    Ax, Px, Aty = mv(qps.A, x), mv(qps.P, x), mtv(qps.A, y)
    ninf = lambda v: v.abs().amax(dim=1)
    pres = ninf(Ax - z)
    dres = ninf(Px + q + Aty)
    ptol = prm.eps_abs + prm.eps_rel * torch.maximum(ninf(Ax), ninf(z)) + 1e-4
    dtol = prm.eps_abs + prm.eps_rel * torch.maximum(ninf(Px), torch.maximum(ninf(q), ninf(Aty))) + 1e-4
    opt = out[3] == 0
    ratio = torch.maximum(pres / ptol, dres / dtol)[opt]
    return float(ratio.max()) if bool(opt.any()) else 0.0


def fixed_runs(wrapper, args, qprm, iters, plain=None):
    """``iters`` iterations with every tolerance 0 through ``wrapper`` (None:
    skipped) and the plain version (``plain``, by default the ADMM kernels')
    in float32 and float64."""
    from smooth_feedback_tpu_torch.qp import admm_iterate_reference

    plain = plain or admm_iterate_reference
    prm = dataclasses.replace(qprm, eps_abs=0.0, eps_rel=0.0, eps_primal_inf=0.0,
                              eps_dual_inf=0.0, max_iter=iters)
    k = None if wrapper is None else wrapper(prm, *args)
    r = plain(prm, *args)
    d = plain(prm, *f64(args))
    torch.cuda.synchronize()
    return k, r, d


def fixed_iteration_check(wrapper, args, qprm, start="cold inputs", iters=FIXED_ITERS,
                          plain=None):
    """All tolerances 0: no member can stop, so kernel and plain version run
    exactly ``iters`` iterations and their iterates compare directly, each
    vector within ITER_TOL of its own scale plus twice the f32 plain
    version's distance from an f64 run (the rounding floor).  Returns the
    largest absolute difference."""
    from smooth_feedback_tpu_torch.qp import QPSolutionStatus

    MAX_ITER = int(QPSolutionStatus.MaxIterations)
    k, r, d = fixed_runs(wrapper, args, qprm, iters, plain)
    ran = bool((k[3] == MAX_ITER).all() and (r[3] == MAX_ITER).all()
               and (k[4] == iters).all() and (r[4] == iters).all())
    rows, worst, ok = [], 0.0, True
    for name, kt, rt, dt in zip("xzy", k[:3], r[:3], d[:3]):
        err = float((kt - rt).abs().max())
        floor = float((rt.double() - dt).abs().max())
        scale = max(1.0, float(dt.abs().max()))
        rows.append(f"{name} {err:.3e} (f32 plain - f64 {floor:.3e}, scale {scale:.3e})")
        worst = max(worst, err)
        ok = ok and err <= ITER_TOL * scale + 2 * floor
    phase("kernel", f"fixed {iters} iterations, all tolerances 0, {start}: every "
                    f"member ran them in both: {ran}; max |kernel - plain| " + ", ".join(rows)
                    + f" (bound {ITER_TOL:g} x scale + 2 x floor)")
    require(ran, "with all tolerances 0 a member stopped before max_iter")
    require(ok, "fixed-iteration iterates differ beyond the bound")
    # the last check's residuals as returned, at the member where they differ most
    rows, res_ok = [], True
    for name, kt, rt, dt in zip(("pres", "dres"), k[5:], r[5:], d[5:]):
        diff = (kt - rt).abs()
        i = int(diff.argmax())
        floor = float((rt.double() - dt).abs().max())
        rows.append(f"{name} {float(diff[i]):.3e} at member {i} (kernel {float(kt[i]):.6e}, plain "
                    f"{float(rt[i]):.6e}; f32 plain - f64 {floor:.3e})")
        res_ok = res_ok and bool((diff <= RES_ATOL + RES_RTOL * rt.abs() + 2 * floor).all())
    phase("kernel", "the residuals of the last check, max |kernel - plain|: " + ", ".join(rows)
                    + f" (bound {RES_ATOL:g} + {RES_RTOL:g} x size + 2 x floor)")
    require(res_ok, "the returned residuals differ beyond the bound")
    return worst


def compare_with_plain(name, wrapper, prm, args, qps, min_optimal=None, exact_iters=False,
                       noisy=False, k=None, r=None):
    """One solve through the kernel against the plain version in f32 and in
    f64 on the same inputs: statuses, iteration counts, the unscaled primal
    where the counts agree, and every point the kernel calls Optimal
    re-checked in f64.  Statuses must agree on 99.9 % of members.  Iteration
    counts must agree on 99.5 % of members, unless the f32 plain version
    itself splits from the f64 run more often: then the kernel must match
    the f64 run's counts at least as often as the f32 plain version does
    (within half a point).  ``noisy`` is for a small batch whose members
    converge near max_iter, where float32 rounding decides a member's
    status and count (the OCP sweep's subproblems): the kernel's statuses
    and counts must then match the f64 run's in as many members as the f32
    plain version's do, less max(1, B / 32) members.  ``min_optimal`` also
    requires that Optimal share from both versions alike; ``exact_iters``
    every count equal.  ``k`` and ``r`` are the kernel's and the f32 plain
    version's outputs where already computed.  Returns the primal error
    where counts agree and the kernel's outputs."""
    from smooth_feedback_tpu_torch.qp import admm_iterate_reference

    k = wrapper(prm, *args) if k is None else k
    r = admm_iterate_reference(prm, *args) if r is None else r
    d = admm_iterate_reference(prm, *f64(args))
    torch.cuda.synchronize()
    share = lambda mask: float(mask.float().mean())
    agree = share(k[3] == r[3])
    k_opt, r_opt, d_opt = (share(o[3] == 0) for o in (k, r, d))
    eq_it = share(k[4] == r[4])
    eq_kd, eq_rd = share(k[4] == d[4]), share(r[4] == d[4])
    same_it = (k[3] == 0) & (r[3] == 0) & (k[4] == r[4])
    both = (k[3] == 0) & (r[3] == 0)
    # unscaled primal: what the controller applies
    dx = ((k[0] - r[0]) * args[7]).abs()
    err_same = float(dx[same_it].max()) if bool(same_it.any()) else float("inf")
    err_all = float(dx[both].max()) if bool(both.any()) else float("inf")
    slack = residual_slack(qps, args, k, prm)
    not_opt = lambda o: torch.nonzero(o[3] != 0).flatten().tolist()
    phase("kernel", f"{name}: status agreement {agree * 100:.3f}%, Optimal kernel "
                    f"{k_opt * 100:.3f}% plain {r_opt * 100:.3f}% plain-f64 "
                    f"{d_opt * 100:.3f}%, equal iters kernel/plain {eq_it * 100:.3f}% "
                    f"kernel/plain-f64 {eq_kd * 100:.3f}% plain/plain-f64 "
                    f"{eq_rd * 100:.3f}%, mean iters kernel "
                    f"{float(k[4].float().mean()):.2f} plain {float(r[4].float().mean()):.2f}, "
                    f"max |dprimal| equal-iters {err_same:.3e} all {err_all:.3e}, "
                    f"kernel's Optimal points re-checked in f64: worst residual / "
                    f"tolerance {slack:.4f}")
    phase("kernel", f"{name}: members not Optimal: kernel {not_opt(k)[:20]} plain "
                    f"{not_opt(r)[:20]} plain-f64 {not_opt(d)[:20]}")
    B_ = k[3].numel()
    allow = max(1, B_ // 32)
    n_sk, n_sr = int((k[3] == d[3]).sum()), int((r[3] == d[3]).sum())
    n_kd, n_rd = int((k[4] == d[4]).sum()), int((r[4] == d[4]).sum())
    if noisy:
        phase("kernel", f"{name}: statuses equal to the f64 run's in {n_sk} members (f32 plain "
                        f"{n_sr}), counts in {n_kd} ({n_rd}); allowance {allow}")
        require(n_sk >= n_sr - allow, f"{name}: statuses match the f64 run's in {n_sk} members, "
                                      f"the f32 plain version's in {n_sr}")
    else:
        require(agree >= 0.999, f"{name}: kernel/plain status agreement {agree:.5f} < 0.999")
    if min_optimal is not None:
        require(k_opt == r_opt, f"{name}: kernel and plain Optimal shares differ")
        require(k_opt >= min_optimal, f"{name}: Optimal share {k_opt:.5f}")
    if exact_iters:
        require(eq_it == 1.0, f"{name}: equal iteration counts {eq_it:.5f}")
    elif noisy:
        require(n_kd >= n_rd - allow, f"{name}: counts match the f64 run's in {n_kd} members, "
                                      f"the f32 plain version's in {n_rd}")
    else:
        require(eq_it >= 0.995 or (eq_rd < 0.995 and eq_kd >= eq_rd - 0.005),
                f"{name}: equal iteration counts kernel/plain {eq_it:.5f}, kernel/plain-f64 "
                f"{eq_kd:.5f}, plain/plain-f64 {eq_rd:.5f}")
    # Members with equal iteration counts ran the same iterations: only f32
    # rounding in another summation order separates them.  Members that
    # stopped at different checks are compared through their residuals
    # instead: re-evaluated in f64, every point the kernel calls Optimal
    # passes the stopping test (allowing 1e-4 for the f32 evaluation inside
    # the kernel).
    require(err_same <= PRIMAL_TOL, f"{name}: primal differs by {err_same:.3e} > {PRIMAL_TOL:g}")
    require(slack <= 1.0, f"{name}: an Optimal point fails the f64 residual test")
    return err_same, k


def stored_bytes(t):
    """Bytes a tensor's distinct entries take (an axis of stride 0 counts
    once): what a kernel must read of it at least."""
    if t is None:
        return 0
    return t.element_size() * int(np.prod([s for s, st in zip(t.shape, t.stride()) if st != 0]))


def lane_bound(args, out, prm, scaled=False):
    """The least time the card could take for one admm_lane call, in ms, and
    what sets it: every input read once (an operand the batch shares, once)
    and every output the call writes once (the scaled iterates and the
    scalings only for a call with ``scaled``; ``out`` may be a solve that
    returned them) at the HBM rate, against the FLOPs this
    call's members ran at the f32 rate: the Ruiz sweeps each member ran (3
    n^2 + 2 m n products a sweep), the scaled matrices, vectors and warm
    start (4 m n + 2 n + 4 m), the factorizations (A' diag(rho) A, the
    Cholesky factor, the inverse: one a member when no factors are given,
    one per refactorization), the iterations (3 products, 2 more a KKT
    refinement sweep), the checks (6 products) and the epilogue (P x and
    the objective, 2 n^2 + 4 n + 2 m)."""
    P, q, A, l, u, xw, yw, factors = args
    m, n = A.shape[-2:]
    moved = sum(stored_bytes(t) for t in (P, q, A, l, u, xw, yw, *(factors or ())))
    written = out if scaled else out[:out._fields.index("x")]
    moved += sum(stored_bytes(t) for t in written if t is not None)
    iters, refactors = out.iters.to(torch.int64), out.refactors.to(torch.int64)
    per_sweep = 3 * n * n + 2 * m * n
    fixed = 4 * m * n + 2 * n + 4 * m + 2 * n * n + 4 * n + 2 * m
    per_iter = 2 * (2 * m * n + n * n + 2 * max(0, prm.kkt_refine_iters) * n * n)
    per_check = 2 * (4 * m * n + 2 * n * n)
    per_factor = 2 * (n * n * m + n ** 3 // 3 + n ** 3)
    factorizations = refactors + (1 if factors is None else 0)
    flops = float((out.sweeps.to(torch.int64) * per_sweep + fixed + iters * per_iter
                   + n_checks(iters, prm.stop_check_iter) * per_check
                   + factorizations * per_factor).sum())
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def lane_iterates(solve, **kw):
    """A lane whole solve as the fixed-iteration check reads a kernel's
    outputs: ``(x, z, y, status, iters, pres, dres)`` in scaled variables."""
    def run(prm, *args):
        o = solve(prm, *args, **kw)
        return o.x, o.z, o.y, o.status, o.iters, o.pres, o.dres
    return run


def lane_fixed_check(cold, prm, label):
    """admm_lane and its plain version for FIXED_ITERS iterations with every
    tolerance 0 and adaptive rho off, from a seeded random warm start (std
    0.1; a member whose input is already safe has the cold start as its
    exact solution), by fixed_iteration_check's rule.  Returns its worst
    error."""
    from smooth_feedback_tpu_torch.qp import admm_solve_cuda_lane, admm_solve_lane_reference

    rng = np.random.default_rng(SEED)
    noisy = list(cold)
    for i in (5, 6):  # the unscaled warm start's primal and dual
        shape = (cold[2].shape[0], cold[2].shape[2 if i == 5 else 1])
        noisy[i] = torch.as_tensor(0.1 * rng.standard_normal(shape), dtype=torch.float32,
                                   device=cold[2].device)
    return fixed_iteration_check(lane_iterates(admm_solve_cuda_lane, scaled=True), tuple(noisy),
                                 dataclasses.replace(prm, adaptive_rho=False),
                                 f"{label}, a seeded random warm start (std 0.1)",
                                 plain=lane_iterates(admm_solve_lane_reference))


def lane_compare(name, args, prm):
    """One whole solve through admm_lane (scaling, factorization, loop and
    unscaling in the kernel) against its plain version in f32 (refactorizing
    the adapting members alone, as the kernel does) and in f64.  Statuses
    against the f64 run: equal on as many members as the f32 plain
    version's, less max(1, B / 128).  The Ruiz sweeps each member ran, and,
    with a static rho, the iteration counts, against the f32 plain version
    (equal on 99.5 % of members or, where the f32 plain version itself
    splits from the f64 run more often, matching the f64 run at least as
    often as it does, within half a point); where the iteration counts
    agree, each member's unscaled primal within PRIMAL_TOL of its scale
    max(1, |x|) plus twice the f32 plain version's distance from the f64
    run, and the objective within PRIMAL_TOL of max(1, |objective|) plus
    twice that distance.  Adaptive rho makes discrete decisions from f32
    residuals, and two f32 runs then take other rho paths to other points
    within eps: the iteration and refactorization counts are judged as
    compare_with_plain's noisy mode judges the OCP subproblems (equal to
    the f64 run's on as many members as the f32 plain version's, less
    max(1, B / 32)), the primal not at all.  Every point the kernel calls
    Optimal passes the f64 stopping test.  Returns the largest primal
    difference where it is judged and the kernel's outputs."""
    from smooth_feedback_tpu_torch.qp import (
        QuadraticProgram, admm_solve_cuda_lane, admm_solve_lane_reference,
    )

    k = admm_solve_cuda_lane(prm, *args, scaled=True)
    r = admm_solve_lane_reference(prm, *args, member_refactor=True)
    d = admm_solve_lane_reference(prm, *f64(args), member_refactor=True)
    torch.cuda.synchronize()
    B_ = k.status.numel()
    share = lambda mask: float(mask.float().mean())
    n_kd, n_rd = int((k.status == d.status).sum()), int((r.status == d.status).sum())
    allow = max(1, B_ // 128)
    counts_ok, rows = True, []
    for label in ("iters", "refactors", "sweeps"):
        ko, ro, do = getattr(k, label), getattr(r, label), getattr(d, label)
        kr, kd, rd = share(ko == ro), share(ko == do), share(ro == do)
        rows.append(f"{label} equal kernel/plain {kr * 100:.2f}% kernel/plain-f64 {kd * 100:.2f}% "
                    f"plain/plain-f64 {rd * 100:.2f}%")
        if prm.adaptive_rho and label != "sweeps":
            counts_ok = counts_ok and int((ko == do).sum()) >= int((ro == do).sum()) - max(1, B_ // 32)
        else:
            counts_ok = counts_ok and (kr >= 0.995 or (rd < 0.995 and kd >= rd - 0.005))
    xk, xr, xd = (o.primal.double() for o in (k, r, d))
    scale = xd.abs().amax(dim=1).clamp(min=1.0)
    err = (xk - xr).abs().amax(dim=1)
    floor = (xr - xd).abs().amax(dim=1)
    ok_, or_, od = (o.objective.double() for o in (k, r, d))
    obj_err = (ok_ - or_).abs()
    obj_ok = obj_err <= PRIMAL_TOL * od.abs().clamp(min=1.0) + 2 * (or_ - od).abs()
    same = (k.iters == r.iters) & (not prm.adaptive_rho)
    primal_ok = bool((err <= PRIMAL_TOL * scale + 2 * floor)[same].all() and obj_ok[same].all())
    worst = float(err[same].max()) if bool(same.any()) else 0.0
    slack = residual_slack(QuadraticProgram(*args[:5]), args, (k.x, k.z, k.y, k.status), prm,
                           (k.sx, k.sy, k.c))
    ref = lambda o: (f"mean {float(o.refactors.float().mean()):.3f} max {int(o.refactors.max())} "
                     f"members refactorized {int((o.refactors > 0).sum())}")
    phase("kernel", f"{name}: statuses equal to the f64 run's in {n_kd} of {B_} members (f32 plain "
                    f"{n_rd}; allowance {allow}), Optimal kernel {share(k.status == 0) * 100:.2f}% "
                    f"plain-f64 {share(d.status == 0) * 100:.2f}%; " + "; ".join(rows)
                    + f"; mean iters kernel {float(k.iters.float().mean()):.2f} plain "
                    f"{float(r.iters.float().mean()):.2f}; Ruiz sweeps kernel mean "
                    f"{float(k.sweeps.float().mean()):.2f} max {int(k.sweeps.max())}; "
                    f"refactorizations per member: kernel {ref(k)}, plain {ref(r)}; max |dprimal| "
                    f"equal-iters "
                    + (f"(adaptive rho: not judged; all {float(err.max()):.3e})" if prm.adaptive_rho
                       else f"{worst:.3e}, max |dobjective| {float(obj_err[same].max()) if bool(same.any()) else 0.0:.3e} "
                            f"(bound {PRIMAL_TOL:g} x scale + 2 x floor)")
                    + f"; kernel's Optimal points re-checked in f64: worst residual / tolerance "
                    f"{slack:.4f}")
    require(n_kd >= n_rd - allow, f"{name}: statuses match the f64 run's in {n_kd} members, the "
                                  f"f32 plain version's in {n_rd}")
    require(counts_ok, f"{name}: iteration, refactorization or sweep counts differ beyond the rule")
    require(primal_ok, f"{name}: the primal or the objective differs beyond the bound")
    require(slack <= 1.0, f"{name}: an Optimal point fails the f64 residual test")
    return worst, k


def sm_clock_mhz():
    """The card's highest SM clock in MHz (nvidia-smi), which converts the
    kernel's clock64 counts to time (an upper bound on the rate: a card
    under a power cap may run slower)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(smi.stdout.split()[0]) if smi.returncode == 0 else float("nan")


def lane_clock_split(name, args, prm, k):
    """The clock64 split of one warp, the member with the most iterations
    (it sets the launch's time): prologue (scaling, rho, scaled matrices,
    warm start), factorization, iterations without and with a check,
    refactorizations, epilogue."""
    from smooth_feedback_tpu_torch.qp import admm_solve_cuda_lane

    member = int(torch.argmax(k.iters))
    clocks = torch.zeros(8, dtype=torch.int64, device=k.iters.device)
    admm_solve_cuda_lane(prm, *args, clocks=clocks, clock_member=member)
    c = clocks.tolist()
    total, mhz = sum(c[:6]), sm_clock_mhz()
    parts = ("prologue", "factorization", "iterations", "checks", "refactorizations", "epilogue")
    phase("kernel", f"{name}: clock64 split of member {member}'s warp ({int(k.iters[member])} "
                    f"iterations, {c[7]} of them with a check, {int(k.refactors[member])} "
                    f"refactorizations, {int(k.sweeps[member])} Ruiz sweeps): "
                    + ", ".join(f"{p} {v} cycles ({v / max(1, total) * 100:.1f}%)"
                                for p, v in zip(parts, c[:6]))
                    + f"; {c[2] / max(1, c[6]):.0f} cycles an iteration without a check, "
                    f"{c[3] / max(1, c[7]):.0f} with one; {total} cycles, {total / mhz:.2f} us at "
                    f"the card's highest SM clock ({mhz:.0f} MHz)")


def kernel_phase(step, dev):
    """The shared-matrix kernel against the plain version on the condensed
    path's real inputs.  Returns the worst error, the warm solve's kernel and
    plain times and its bound."""
    from smooth_feedback_tpu_torch.qp import (
        admm_iterate_cuda_shared, admm_iterate_reference, shared_kernel_args, solve_qp_batch,
    )

    f = step.factors
    n, m = f.Minv.shape[0], f.As.shape[0]
    require((n, m) == (52, 52), f"main-path QP is {n}x{m}, expected 52x52")
    qprm = qp_params("cuda")
    xs = initial_states(dev)

    qps_cold = step.condensed_qp(0.0, xs)
    cold = shared_kernel_args(qps_cold, f)
    worst = fixed_iteration_check(admm_iterate_cuda_shared, cold, qprm)
    # warm start: the cold solution, one clock step later
    qps_warm = step.condensed_qp(DT, xs)
    warm = shared_kernel_args(qps_warm, f, solve_qp_batch(qps_cold, qprm, None, f))
    rows = {}
    for name, qps, args in (("cold", qps_cold, cold), ("warm", qps_warm, warm)):
        # a warm-started solve is the main path's regime: all Optimal, every
        # member at the same check.  From the cold start at std-0.5 states a
        # few members need more than max_iter = 100 iterations in either
        # version, and a member whose residual ends within f32 rounding of a
        # check's threshold may stop one check earlier or later.
        err, k = compare_with_plain(
            f"shared {name}", admm_iterate_cuda_shared, qprm, args, qps,
            min_optimal=1.0 if name == "warm" else 0.999, exact_iters=name == "warm",
        )
        worst = max(worst, err)
        rows[name] = (
            time_ms(lambda: admm_iterate_cuda_shared(qprm, *args), 20),
            time_ms(lambda: admm_iterate_reference(qprm, *args), 5),
            *bound(args, k, qprm),
        )
        single = time_single_ms(lambda: admm_iterate_cuda_shared(qprm, *args), 20)
        rows[name] += (single,)
        phase("kernel", f"shared {name}: kernel {rows[name][0]:.4f} ms, plain "
                        f"{rows[name][1]:.4f} ms per solve at B={B}, n=m={n} (means of "
                        f"back-to-back calls; median of single kernel launches {single:.4f} "
                        f"ms); bound {rows[name][2]:.4f} ms ({rows[name][3]})")
        # a small fleet (one problem a warp), the same members
        small = tuple(a[:1024].contiguous() if a.dim() and a.shape[0] == B else a for a in args)
        ks = admm_iterate_cuda_shared(qprm, *small)
        require(all(torch.equal(a, b[:1024]) for a, b in zip(ks, k)),
                f"shared {name}: a member's result depends on the batch around it")
        ms = time_ms(lambda: admm_iterate_cuda_shared(qprm, *small), 20)
        single = time_single_ms(lambda: admm_iterate_cuda_shared(qprm, *small), 20)
        bs, by = bound(small, ks, qprm)
        phase("kernel", f"shared {name} at B=1024: kernel {ms:.4f} ms back to back (no less "
                        f"than the host takes to enqueue a call), {single:.4f} ms median of "
                        f"single launches; bound {bs:.4f} ms ({by}), results equal the B={B} "
                        f"launch's")
        if name == "cold":
            # what sorting stragglers could gain at best: the members in the
            # order of the iteration counts this very solve gives them
            perm = torch.argsort(k[4], stable=True)
            srt = tuple(a[perm].contiguous() if a.dim() and a.shape[0] == B else a for a in args)
            ks = admm_iterate_cuda_shared(qprm, *srt)
            require(all(torch.equal(a, b[perm]) for a, b in zip(ks, k)),
                    "shared cold: sorting the members changed a result")
            ms = time_ms(lambda: admm_iterate_cuda_shared(qprm, *srt), 20)
            phase("kernel", f"shared cold, members sorted by their iteration counts: kernel "
                            f"{ms:.4f} ms (unsorted {rows[name][0]:.4f} ms)")
    return worst, rows["warm"]


def vehicle(dev):
    """The README Quickstart's kinematic SE(2) vehicle tracking a screw:
    ``(f, xdes, udes)`` in float32 on ``dev``."""
    from smooth_feedback_tpu_torch.groups import SE2

    twist = torch.tensor(TWIST, dtype=torch.float32, device=dev)
    f = lambda x, u: torch.stack([u[0], torch.zeros_like(u[0]), u[1]])
    xdes = lambda t: SE2.exp(t * twist)
    udes = lambda t: torch.stack([twist[0], twist[2]])
    return f, xdes, udes


def fleet_qp_params(backend):
    """The fleet's solver settings: the defaults (rho 0.1, rho_eq_scale 1e3,
    max_iter 4000) with polish off and a check every 10 iterations."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(polish=False, stop_check_iter=10, backend=backend)


def make_fleet_path(backend, dev):
    """The Quickstart vehicle at K=30, tf=3 (n = 163, m = 99), per-member
    transcription and factorization (reuse_factors=False, condense=False)."""
    from smooth_feedback_tpu_torch.controllers import MPCParams, MPCWeights, make_mpc_step
    from smooth_feedback_tpu_torch.groups import SE2, Rn

    kw = dict(dtype=torch.float32, device=dev)
    f, xdes, udes = vehicle(dev)
    return make_mpc_step(
        SE2, Rn(2), f, xdes, udes,
        weights=MPCWeights(Q=torch.eye(3, **kw), Qtf=5 * torch.eye(3, **kw),
                           R=0.1 * torch.eye(2, **kw)),
        params=MPCParams(K=FLEET_K, tf=3.0, return_trajectories=False,
                         qp=fleet_qp_params(backend)),
        **kw,
    )


def fleet_initial(dev):
    """Clocks ~ U(0, 10) and states SE2.rplus(xdes(t), 0.3 N(0, I3)), seed 0."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.groups import SE2

    rng = np.random.default_rng(SEED)
    kw = dict(dtype=torch.float32, device=dev)
    ts = torch.as_tensor(rng.uniform(0.0, 10.0, FLEET_B), **kw)
    noise = torch.as_tensor(0.3 * rng.standard_normal((FLEET_B, 3)), **kw)
    _, xdes, _ = vehicle(dev)
    return ts, vmap(SE2.rplus)(vmap(xdes)(ts), noise)


def plant(dev, xs, u):
    """One DT of the vehicle: x <- x (+) DT f(x, u)."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.groups import SE2

    f, _, _ = vehicle(dev)
    return vmap(SE2.rplus)(xs, DT * vmap(f)(xs, u))


def problem_family(n, m, B_, seed):
    """A numpy family of QPs, each with its own P and A: member 2 has a row
    unbounded above and one unbounded below, member 3 is primal infeasible
    (x0 >= 1 and x0 <= -1), member 4 dual infeasible (P = 0, A = 0, free
    rows, q != 0)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B_, n, n)) / np.sqrt(n)
    P = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(n)
    A = rng.standard_normal((B_, m, n)) / np.sqrt(n)
    center = np.einsum("bmn,bn->bm", A, rng.standard_normal((B_, n)))
    spread = np.abs(rng.standard_normal((B_, m))) + 0.1
    l, u = center - spread, center + spread
    q = rng.standard_normal((B_, n))
    u[2, 0], l[2, 1] = np.inf, -np.inf
    A[3, :2] = 0.0
    A[3, :2, 0] = 1.0
    l[3, 0], u[3, 0] = 1.0, np.inf
    l[3, 1], u[3, 1] = -np.inf, -1.0
    P[4], A[4], l[4], u[4] = 0.0, 0.0, -np.inf, np.inf
    return P, q, A, l, u


def problem_kernel_phase(step, dev):
    """The per-problem kernel against the plain version on the fleet path's
    real inputs (cold and warm), then on a numpy family that fires every
    certificate.  Returns the worst error, the warm solve's kernel and plain
    times and its bound."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.convert import qp_from_numpy
    from smooth_feedback_tpu_torch.qp import (
        QPSolutionStatus, admm_iterate_cuda, admm_iterate_reference, per_problem_kernel_args,
        solve_qp_batch,
    )

    qprm = fleet_qp_params("cuda")
    ts, xs = fleet_initial(dev)
    qps_cold = vmap(step.transcribe)(ts, xs)
    m, n = qps_cold.A.shape[-2:]
    require((n, m) == (163, 99), f"fleet QP is n={n}, m={m}, expected n=163, m=99")
    cold = per_problem_kernel_args(qps_cold, None, None, qprm)
    worst = fixed_iteration_check(admm_iterate_cuda, cold, qprm)
    # warm start: the cold solution, one clock step later
    qps_warm = vmap(step.transcribe)(ts + DT, xs)
    warm = per_problem_kernel_args(qps_warm, None, solve_qp_batch(qps_cold, qprm), qprm)
    rows = {}
    for name, qps, args in (("cold", qps_cold, cold), ("warm", qps_warm, warm)):
        err, k = compare_with_plain(f"per-problem {name}", admm_iterate_cuda, qprm, args, qps)
        worst = max(worst, err)
        rows[name] = (
            time_ms(lambda: admm_iterate_cuda(qprm, *args), 10),
            time_ms(lambda: admm_iterate_reference(qprm, *args), 3),
            *bound(args, k, qprm),
        )
        single = time_single_ms(lambda: admm_iterate_cuda(qprm, *args), 10)
        rows[name] += (single,)
        phase("kernel", f"per-problem {name}: kernel {rows[name][0]:.4f} ms, plain "
                        f"{rows[name][1]:.4f} ms per solve at B={FLEET_B}, n={n}, m={m} (means "
                        f"of back-to-back calls; median of single kernel launches {single:.4f} "
                        f"ms); bound {rows[name][2]:.4f} ms ({rows[name][3]})")

    # every certificate branch on the card: +-inf rows, a primal- and a
    # dual-infeasible member, a member that starts PrimalInfeasible
    # dual-infeasible member (eps_abs = eps_rel = 1e-3, the defaults)
    fam = qp_from_numpy(problem_family(64, 64, 256, SEED), device=dev)
    args = per_problem_kernel_args(fam, None, None, qprm)
    args[15][1] = int(QPSolutionStatus.PrimalInfeasible)
    err, k = compare_with_plain("per-problem family", admm_iterate_cuda, qprm, args, fam)
    st, it = k[3].tolist(), k[4].tolist()
    phase("kernel", f"per-problem family: members 1-4 status {st[1:5]} iters {it[1:5]}")
    require(st[1] == QPSolutionStatus.PrimalInfeasible and it[1] == 0,
            "the member that started PrimalInfeasible was touched")
    require(st[3] == QPSolutionStatus.PrimalInfeasible, "no primal-infeasibility certificate")
    require(st[4] == QPSolutionStatus.DualInfeasible, "no dual-infeasibility certificate")
    require(st[2] == QPSolutionStatus.Optimal, "the member with +-inf rows is not Optimal")
    return max(worst, err), rows["warm"]


def fleet_phase(step, ws0, dev):
    """FLEET_STEPS closed-loop steps of the per-member-clock fleet through
    the per-problem kernel.  Returns the launch counts and, for the first
    FLEET_PLAIN_STEPS steps, each step's clocks, states, warm start and
    result."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda, per_problem_kernel_args, qp_factorize

    qprm = fleet_qp_params("cuda")
    ts, xs = fleet_initial(dev)
    ws = type(ws0)(*(a.expand((FLEET_B,) + a.shape).contiguous() for a in ws0))
    statuses, iters, us, step_s, kept = [], [], [], [], []
    reset_counts()
    for i in range(FLEET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = step.fleet(ws, ts, xs)
        if i < FLEET_PLAIN_STEPS:
            kept.append((ts, xs, ws, r))
        xs = plant(dev, xs, r.u)
        ts = ts + DT
        ws = r.warmstart
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        statuses.append(r.status)
        iters.append(ws.iters)
        us.append(r.u)
    counts = read_counts()
    st = torch.stack(statuses)
    u = torch.stack(us)
    opt = float((st == 0).float().mean())
    med = float(np.median(step_s))
    bad = torch.nonzero(st != 0).tolist()
    phase("fleet", f"{FLEET_STEPS} steps x B={FLEET_B} on per-member clocks: Optimal "
                   f"{opt * 100:.3f}%, launches {counts}, median step {med * 1e3:.3f} ms (min "
                   f"{min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}), {FLEET_B / med:.1f} "
                   f"solves/s, mean ADMM iters {float(torch.stack(iters).float().mean()):.3f}")
    phase("fleet", f"not Optimal (step, member): {bad[:50]} statuses "
                   f"{[int(st[i, j]) for i, j in bad[:50]]}")
    require(counts["admm_problem"] == FLEET_STEPS,
            f"per-problem kernel launched {counts['admm_problem']} times in {FLEET_STEPS} steps")
    require(opt >= 0.999, f"fleet Optimal {opt:.5f} < 0.999")
    require(bool(torch.isfinite(u).all()), "non-finite u")
    require(tuple(u.shape) == (FLEET_STEPS, FLEET_B, 2), f"u has shape {tuple(u.shape)}")

    # a synchronised split of the next step: its stages one after another,
    # then the whole step, five times over; medians of each
    stages = {
        "transcription": lambda _: vmap(step.transcribe)(ts, xs),
        "factorization": lambda qps: (qps, qp_factorize(qps, qprm)),
        "scaling and warm start": lambda qf: per_problem_kernel_args(*qf, ws, qprm),
        "kernel": lambda args: admm_iterate_cuda(qprm, *args),
        "whole step": lambda _: step.fleet(ws, ts, xs),
    }
    times = {name: [] for name in stages}
    for _ in range(5):
        out = None
        for name, fn in stages.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(out)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {name: float(np.median(t)) for name, t in times.items()}
    rest = med["whole step"] - sum(v for k, v in med.items() if k != "whole step")
    phase("fleet", "one step, synchronised split (medians of 5): " + ", ".join(
        f"{name} {v:.3f} ms" for name, v in med.items()
    ) + f"; whole step minus the stages (solver and MPC finalize, and host timing "
        f"noise) {rest:.3f} ms")
    return counts, kept


def fleet_plain_phase(dev, kept):
    """The first fleet steps again on the plain path, each from the kernel
    path's clocks, states and warm start for that step."""
    step_p, _ = make_fleet_path("torch", dev)
    worst, agree = 0.0, 1.0
    for ts, xs, ws, rk in kept:
        r = step_p.fleet(ws, ts, xs)
        same = (r.status == 0) & (rk.status == 0) & (r.warmstart.iters == rk.warmstart.iters)
        du = (r.u - rk.u).abs().amax(dim=1)
        worst = max(worst, float(du[same].max()) if bool(same.any()) else float("inf"))
        agree = min(agree, float((r.status == rk.status).float().mean()))
    phase("fleet-plain", f"plain path, first {len(kept)} steps on the kernel path's clocks, "
                         f"states and warm starts: status agreement >= {agree * 100:.3f}%, max "
                         f"|du| equal-iters {worst:.3e}")
    require(agree >= 0.999, "plain and kernel fleet paths disagree on statuses")
    require(worst <= PRIMAL_TOL, f"u differs from the plain fleet path by {worst:.3e}")
    return worst


def main_path_phase(step, ws0, dev, keep=5):
    """200 closed-loop fleet steps through the shared-matrix kernel.  Returns
    the launch counts and, for the first ``keep`` steps, each step's states, warm start
    and result."""
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda_shared, shared_kernel_args

    xs = initial_states(dev)
    ws = type(ws0)(*(a.expand((B,) + a.shape).contiguous() for a in ws0))
    statuses, iters, us, step_s, kept = [], [], [], [], []
    reset_counts()
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = step.fleet_shared_t(ws, DT * i, xs)
        if i < keep:
            kept.append((xs, ws, r))
        xs = xs + DT * torch.stack([xs[:, 1], r.u[:, 0]], dim=1)
        ws = r.warmstart
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        statuses.append(r.status)
        iters.append(ws.iters)
        us.append(r.u)
    counts = read_counts()
    launches = counts["admm_shared"]
    st = torch.stack(statuses)
    it = torch.stack(iters).float()
    u = torch.stack(us)
    opt = float((st == 0).float().mean())
    med = float(np.median(step_s))

    # the kernel alone on the next step's inputs, warm-started from the carry
    args = shared_kernel_args(step.condensed_qp(DT * STEPS, xs), step.factors, ws)
    kern_ms = time_ms(lambda: admm_iterate_cuda_shared(qp_params("cuda"), *args), 20)
    share = kern_ms / (med * 1e3)
    phase("main", f"{STEPS} steps x B={B}: Optimal {opt * 100:.3f}%, launches "
                  f"{counts}, median step {med * 1e3:.3f} ms (min {min(step_s) * 1e3:.3f}, "
                  f"max {max(step_s) * 1e3:.3f}), {B / med:.1f} solves/s, mean ADMM iters "
                  f"{float(it.mean()):.3f}, kernel on a step's inputs {kern_ms:.4f} ms = "
                  f"{share * 100:.2f}% of the median step")
    require(opt >= 0.999, f"main path Optimal {opt:.5f} < 0.999")
    require(launches == STEPS, f"kernel launched {launches} times in {STEPS} steps")
    require(bool(torch.isfinite(u).all()), "non-finite u")
    # u may leave [-0.5, 0.5] by the ADMM primal tolerance
    # (eps_abs + eps_rel * 0.5 = 1.5e-3); allow 2e-3
    umax = float(u.abs().max())
    require(umax <= 0.5 + 2e-3, f"|u| reached {umax:.5f}")
    require(tuple(u.shape) == (STEPS, B, 1), f"u has shape {tuple(u.shape)}")
    return counts, kept


def reference_phase(dev, kept):
    """The first steps of the main path again on the plain loop, each from
    the kernel path's states and warm start for that step, so every step
    compares the two solvers on the same inputs."""
    step_p, _ = make_main_path("torch", dev)
    worst, agree, eq_it = 0.0, 1.0, 1.0
    for i, (xs, ws, rk) in enumerate(kept):
        r = step_p.fleet_shared_t(ws, DT * i, xs)
        same = (r.status == 0) & (rk.status == 0) & (r.warmstart.iters == rk.warmstart.iters)
        du = (r.u - rk.u).abs()[:, 0]
        worst = max(worst, float(du[same].max()) if bool(same.any()) else float("inf"))
        agree = min(agree, float((r.status == rk.status).float().mean()))
        eq_it = min(eq_it, float((r.warmstart.iters == rk.warmstart.iters).float().mean()))
    phase("reference", f"plain path, first {len(kept)} steps on the kernel path's states and "
                       f"warm starts: status agreement >= {agree * 100:.3f}%, equal iters >= "
                       f"{eq_it * 100:.3f}%, max |du| equal-iters {worst:.3e}")
    require(agree >= 0.999, "plain and kernel paths disagree on statuses")
    require(eq_it >= 0.995, f"plain and kernel paths agree on iterations for {eq_it:.5f}")
    require(worst <= PRIMAL_TOL, f"u differs from the plain path by {worst:.3e}")
    return worst


def vehicle_asif_path(mpc_backend, dev, dtype=torch.float32):
    """benchmarks/asif_bench.py:39-123 in torch: the SE(2) x R^3 vehicle's
    condensed MPC on one clock and the ASIF filter, in ``dtype`` (the
    bench's float32) on ``dev``.  Returns ``(X, f, h, mpc_step, mpc_ws,
    asif_step, asif_ws)``."""
    from smooth_feedback_tpu_torch.controllers import (
        ASIFilterParams, MPCParams, MPCWeights, make_asif_step, make_mpc_step,
    )
    from smooth_feedback_tpu_torch.groups import SE2, Bundle, Rn

    kw = dict(dtype=dtype, device=dev)
    X, U = Bundle(SE2, Rn(3)), Rn(2)
    vdes = torch.tensor([1.0, 0.0, 0.4], **kw)
    base = torch.tensor([2.5, 0.0, 0.0, 1.0], **kw)
    mpc, mws = make_mpc_step(
        X, U, vehicle_asif_f, lambda t: torch.cat([SE2.rplus(base, t * vdes), vdes]),
        lambda t: torch.zeros(2, **kw), dxdes=lambda t: torch.cat([vdes, torch.zeros(3, **kw)]),
        weights=MPCWeights(Q=torch.eye(6, **kw), Qtf=0.1 * torch.eye(6, **kw), R=torch.eye(2, **kw)),
        params=MPCParams(K=ASIF_MPC_K, tf=5.0, return_trajectories=False,
                         qp=asif_mpc_params(mpc_backend)),
        cr=lambda x, u: u, crl=[-0.5, -0.5], cru=[0.5, 0.5],
        reuse_factors=True, condense=True, static_reference=True, **kw,
    )
    fl = asif_filter(dev, dtype)
    asif, aws = make_asif_step(
        X, U, vehicle_asif_f, fl["h"], fl["bu"],
        params=ASIFilterParams(T=ASIF_T, asif=asif_to_qp_params(), qp=asif_qp_params("lane", True)),
        W_u=fl["W_u"], ulim=fl["ulim"], **kw,
    )
    return X, vehicle_asif_f, fl["h"], mpc, mws, asif, aws


def asif_to_qp_params():
    """The bench's barrier rows: K = 50 constraint times over T = 2.5."""
    from smooth_feedback_tpu_torch.controllers import ASIFtoQPParams

    return ASIFtoQPParams(K=50, dt=0.05, alpha=2.0, relax_cost=1000.0)


def asif_mpc_params(backend):
    """The bench's MPC solver settings (asif_bench.py:74-77) on a port backend."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(polish=False, max_iter=200, stop_check_iter=10, backend=backend)


def asif_qp_params(backend, adaptive):
    """The bench's ASIF solver settings (asif_bench.py:112-115) on a port
    backend; the bench's own is "lane" with adaptive rho."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(polish=False, max_iter=250, stop_check_iter=10, rho=0.02,
                          adaptive_rho=adaptive, backend=backend)


def asif_initial(X, dev, dtype=torch.float32):
    """X.rplus(identity, 0.2 N(0, I6)) for ASIF_B vehicles, seed 0."""
    from torch.func import vmap

    dx = torch.as_tensor(0.2 * np.random.default_rng(SEED).standard_normal((ASIF_B, 6)),
                         dtype=dtype, device=dev)
    return vmap(lambda d: X.rplus(X.identity(dtype=dtype, device=dev), d))(dx)


def batch_ws(ws, B_):
    return type(ws)(*(a.expand((B_,) + a.shape).contiguous() for a in ws))


def vehicle_asif_phase(parts, dev):
    """ASIF_WARM + ASIF_STEPS closed-loop steps of the bench's fleet: the MPC
    through the shared-matrix kernel, the ASIF through the lane kernel with
    adaptive rho (asif_bench.py's backend="lane"), the plant.  The barrier
    must stay positive at every post-step state; each kernel must launch
    once a step.  Returns the launch counts, the first ASIF_PLAIN_STEPS
    steps' inputs and results, and the state and carries after the run."""
    from torch.func import vmap

    X, f, h, mpc, mws0, asif, aws0 = parts
    xs = asif_initial(X, dev)
    mws, aws = batch_ws(mws0, ASIF_B), batch_ws(aws0, ASIF_B)
    from smooth_feedback_tpu_torch.qp import solver as qsolver

    steps = ASIF_WARM + ASIF_STEPS
    kept, step_s, m_st, a_st, a_it, hmins = [], [], [], [], [], []
    reset_counts()
    sweeps = qsolver.lane_ruiz_sweeps
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = ASIF_DT * i
        m = mpc.fleet_shared_t(mws, t, xs)
        a = asif.fleet(aws, xs, m.u)
        if i < ASIF_PLAIN_STEPS:
            kept.append((t, xs, mws, aws, m, a))
        xs = vmap(lambda x, u: X.rplus(x, ASIF_DT * f(x, u)))(xs, a.u)
        hmin = vmap(lambda x: h(t, x)[0])(xs).min()
        mws, aws = m.warmstart, a.warmstart
        torch.cuda.synchronize()
        if i >= ASIF_WARM:
            step_s.append(time.perf_counter() - t0)
        m_st.append(m.status)
        a_st.append(a.status)
        a_it.append(a.warmstart.iters)
        hmins.append(hmin)
    counts, sweeps = read_counts(), qsolver.lane_ruiz_sweeps - sweeps
    m_opt = float((torch.stack(m_st) == 0).float().mean())
    a_opt = float((torch.stack(a_st) == 0).float().mean())
    h_min = float(torch.stack(hmins).min())
    med = float(np.median(step_s))
    phase("vehicle-asif", f"{steps} steps ({ASIF_WARM} warm-up, {ASIF_STEPS} timed) x B={ASIF_B}: "
                          f"MPC Optimal {m_opt * 100:.3f}%, ASIF Optimal {a_opt * 100:.3f}% (mean "
                          f"ASIF iters {float(torch.stack(a_it).float().mean()):.3f}), launches "
                          f"{counts}, torch Ruiz sweeps {sweeps}, min barrier {h_min:.6f}, "
                          f"median timed step {med * 1e3:.3f} ms "
                          f"(min {min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}), "
                          f"{ASIF_B / med:.1f} MPC+ASIF steps/s")
    require(h_min > 0.0, f"safety: min barrier {h_min} <= 0")
    require(counts["admm_shared"] == steps,
            f"shared kernel launched {counts['admm_shared']} times in {steps} steps")
    require(counts["admm_lane"] == steps,
            f"lane kernel launched {counts['admm_lane']} times in {steps} steps")
    require(sweeps == 0, f"{sweeps} Ruiz sweeps ran in torch on the lane route")
    require(bool(torch.isfinite(xs).all()), "non-finite vehicle state")
    return counts, kept, (ASIF_DT * steps, xs, mws, aws)


def vehicle_asif_split(parts, carry, dev):
    """A synchronised split of one step at the carried state, five times
    over: MPC, ASIF transcription, ASIF solve (the lane kernel's route), the
    same solve on the torch loop with adaptive rho (the route before the
    lane kernel, for comparison; not part of the step), plant; medians."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.controllers import asif_to_qp_fleet
    from smooth_feedback_tpu_torch.qp import solve_qp_batch

    from smooth_feedback_tpu_torch.groups import Rn

    X, f, h, mpc, _, asif, _ = parts
    t, xs, mws, aws = carry
    fl = asif_filter(dev)
    stages = {
        "MPC": lambda _: mpc.fleet_shared_t(mws, t, xs),
        "ASIF transcription": lambda m: (m, asif_to_qp_fleet(
            X, Rn(2), asif_to_qp_params(), ASIF_T, xs, m.u, fl["W_u"], fl["ulim"], f, h, fl["bu"])),
        "ASIF solve": lambda mq: (mq, solve_qp_batch(mq[1], asif_qp_params("lane", True), aws)),
        "ASIF solve on the torch loop (not in the step)": lambda ms: (
            solve_qp_batch(ms[0][1], asif_qp_params("torch", True), aws), ms[1])[1],
        "plant": lambda sol: vmap(lambda x, u: X.rplus(x, ASIF_DT * f(x, u)))(xs, sol.primal[:, :2]),
    }
    times = {name: [] for name in list(stages) + ["whole step"]}
    for _ in range(5):
        out = None
        for name, fn in stages.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(out)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = mpc.fleet_shared_t(mws, t, xs)
        a = asif.fleet(aws, xs, m.u)
        vmap(lambda x, u: X.rplus(x, ASIF_DT * f(x, u)))(xs, a.u)
        torch.cuda.synchronize()
        times["whole step"].append((time.perf_counter() - t0) * 1e3)
    med = {name: float(np.median(v)) for name, v in times.items()}
    phase("vehicle-asif", "one step, synchronised split (medians of 5): " + ", ".join(
        f"{name} {v:.3f} ms" for name, v in med.items()))
    return med


# The vehicle MPC's u against the plain path: PR 1's bound (the kernel and
# the plain loop run the same f32 iterations in another summation order).
# The filtered u: the ASIF QP of a member differs between the two runs only
# through its input u_des (the MPC u), and its solution is the W_u-weighted
# projection of u_des onto the safe inputs, so |du| <= sqrt(20 / 1) |du_des|
# between exact solutions; a solve that stops at the same check adds the
# same f32 rounding as the MPC's.  So, where the ASIF iteration counts agree:
# |du_asif| <= PRIMAL_TOL + 5 max |du_mpc|.
ASIF_U_GAIN = 5.0


def vehicle_asif_plain_phase(dev, kept):
    """The first steps again with the MPC on the plain loop, each from the
    kernel path's state and carries for that step."""
    _, _, _, mpc_p, _, asif, _ = vehicle_asif_path("torch", dev)
    worst_m, worst_a, agree_m, agree_a = 0.0, 0.0, 1.0, 1.0
    for t, xs, mws, aws, mk, ak in kept:
        mp = mpc_p.fleet_shared_t(mws, t, xs)
        ap = asif.fleet(aws, xs, mp.u)
        same_m = (mp.status == 0) & (mk.status == 0) & (mp.warmstart.iters == mk.warmstart.iters)
        du_m = (mp.u - mk.u).abs().amax(dim=1)
        dm = float(du_m[same_m].max()) if bool(same_m.any()) else float("inf")
        same_a = (ap.status == ak.status) & (ap.warmstart.iters == ak.warmstart.iters)
        da = float((ap.u - ak.u).abs().amax(dim=1)[same_a].max()) if bool(same_a.any()) else 0.0
        require(da <= PRIMAL_TOL + ASIF_U_GAIN * float(du_m.max()),
                f"filtered u differs from the plain path by {da:.3e} at t={t:.3f}")
        worst_m, worst_a = max(worst_m, dm), max(worst_a, da)
        agree_m = min(agree_m, float((mp.status == mk.status).float().mean()))
        agree_a = min(agree_a, float(same_a.float().mean()))
    phase("vehicle-asif-plain", f"MPC on the plain loop, first {len(kept)} steps on the kernel "
                                f"path's states and carries: MPC status agreement >= "
                                f"{agree_m * 100:.3f}%, max |du| equal-iters {worst_m:.3e} (bound "
                                f"{PRIMAL_TOL:g}); ASIF statuses and iteration counts equal for >= "
                                f"{agree_a * 100:.3f}%, max |du| there {worst_a:.3e} (bound "
                                f"{PRIMAL_TOL:g} + {ASIF_U_GAIN:g} x max |du_mpc| of the step)")
    require(agree_m >= 0.999, "plain and kernel vehicle MPC disagree on statuses")
    require(worst_m <= PRIMAL_TOL, f"vehicle MPC u differs from the plain path by {worst_m:.3e}")
    require(agree_a >= 0.99, f"ASIF statuses or counts agree for only {agree_a:.4f}")
    return worst_m


def vehicle_kernel_phase(parts, kept, dev):
    """The kernels at this path's shapes, against their plain versions:
    admm_shared on one step's condensed vehicle QPs (n = m = 64, B = 256),
    admm_problem on one step's ASIF QPs (n = 3, m = 53, adaptive rho off),
    and admm_lane on the same ASIF QPs (FIXED_ITERS iterations with adaptive
    rho off, then whole solves with it on), each cold and warm.  Returns
    each kernel's worst error and warm row."""
    from smooth_feedback_tpu_torch.controllers import asif_to_qp_fleet
    from smooth_feedback_tpu_torch.groups import Rn
    from smooth_feedback_tpu_torch.qp import (
        admm_iterate_cuda, admm_iterate_cuda_shared, admm_iterate_reference, admm_solve_cuda_lane,
        admm_solve_lane_reference, lane_kernel_args, per_problem_kernel_args, shared_kernel_args,
        solve_qp_batch,
    )
    from smooth_feedback_tpu_torch.qp import solver as qsolver

    X, f, h, mpc, _, asif, _ = parts
    t, xs, mws, aws, mk, ak = kept[-1]
    f_ = mpc.factors
    n, m = f_.Minv.shape[0], f_.As.shape[0]
    require((n, m) == (64, 64), f"vehicle MPC QP is {n}x{m}, expected 64x64")
    prm = asif_mpc_params("cuda")
    qps = mpc.condensed_qp(t, xs)
    cold = shared_kernel_args(qps, f_)
    worst_s = fixed_iteration_check(admm_iterate_cuda_shared, cold, prm)
    rows = {}
    for name, args in (("cold", cold), ("warm", shared_kernel_args(qps, f_, mws))):
        err, k = compare_with_plain(f"vehicle shared {name}", admm_iterate_cuda_shared, prm, args,
                                    qps)
        worst_s = max(worst_s, err)
        rows[name] = (time_ms(lambda: admm_iterate_cuda_shared(prm, *args), 20),
                      time_ms(lambda: admm_iterate_reference(prm, *args), 5), *bound(args, k, prm))
        phase("kernel", f"vehicle shared {name}: kernel {rows[name][0]:.4f} ms, plain "
                        f"{rows[name][1]:.4f} ms per solve at B={ASIF_B}, n=m={n} (means of "
                        f"back-to-back calls); bound {rows[name][2]:.4f} ms ({rows[name][3]})")
    shared_row = rows["warm"]

    fl = asif_filter(dev)
    aq = asif_to_qp_fleet(X, Rn(2), asif_to_qp_params(), ASIF_T, xs, mk.u, fl["W_u"], fl["ulim"],
                          f, h, fl["bu"])
    am, an = aq.A.shape[-2:]
    require((an, am) == (3, 53), f"ASIF QP is n={an}, m={am}, expected n=3, m=53")
    prm_k = asif_qp_params("cuda", False)
    cold = per_problem_kernel_args(aq, None, None, prm_k)
    # a member whose desired input is already safe has the cold start (0) as
    # its exact solution and stops at the first check even with every
    # tolerance 0: the fixed iterations start from a seeded random iterate
    rng = np.random.default_rng(SEED)
    noisy = list(cold)
    for i in (12, 13, 14):  # x0, z0, y0
        noisy[i] = torch.as_tensor(0.1 * rng.standard_normal(tuple(cold[i].shape)),
                                   dtype=torch.float32, device=dev)
    worst_p = fixed_iteration_check(admm_iterate_cuda, tuple(noisy), prm_k,
                                    "a seeded random start (std 0.1)")
    rows = {}
    for name, args in (("cold", cold), ("warm", per_problem_kernel_args(aq, None, aws, prm_k))):
        err, k = compare_with_plain(f"ASIF per-problem {name}", admm_iterate_cuda, prm_k, args, aq)
        worst_p = max(worst_p, err)
        rows[name] = (time_ms(lambda: admm_iterate_cuda(prm_k, *args), 20),
                      time_ms(lambda: admm_iterate_reference(prm_k, *args), 5), *bound(args, k, prm_k))
        phase("kernel", f"ASIF per-problem {name}: kernel {rows[name][0]:.4f} ms, plain "
                        f"{rows[name][1]:.4f} ms per solve at B={ASIF_B}, n={an}, m={am} (means of "
                        f"back-to-back calls); bound {rows[name][2]:.4f} ms ({rows[name][3]})")

    # admm_lane, the path's own route for the ASIF: fixed iterations from a
    # seeded random warm start with adaptive rho off, then whole solves (the
    # kernel scaling and factorizing each member) with it on
    prm_l = asif_qp_params("lane", True)
    cold = lane_kernel_args(aq)
    worst_l = lane_fixed_check(cold, prm_l, "admm_lane")
    lane_rows = {}
    for name, args in (("cold", cold), ("warm", lane_kernel_args(aq, None, aws))):
        err, k = lane_compare(f"ASIF lane {name}", args, prm_l)
        worst_l = max(worst_l, err)
        lane_rows[name] = (time_ms(lambda: admm_solve_cuda_lane(prm_l, *args), 20),
                           time_ms(lambda: admm_solve_lane_reference(prm_l, *args), 3),
                           *lane_bound(args, k, prm_l),
                           time_single_ms(lambda: admm_solve_cuda_lane(prm_l, *args), 20))
        phase("kernel", f"ASIF lane {name}: kernel {lane_rows[name][0]:.4f} ms, plain "
                        f"{lane_rows[name][1]:.4f} ms per solve at B={ASIF_B}, n={an}, m={am}, "
                        f"adaptive rho (means of back-to-back calls; median of single kernel "
                        f"launches {lane_rows[name][4]:.4f} ms); bound {lane_rows[name][2]:.6f} ms "
                        f"({lane_rows[name][3]})")
        lane_clock_split(f"ASIF lane {name}", args, prm_l, k)

    # the ASIF solve on each route, warm-started from the carry; on the lane
    # route one launch a solve and no Ruiz sweep in torch
    for route, p in (("lane kernel, adaptive rho", prm_l),
                     ("torch loop, adaptive rho", asif_qp_params("torch", True)),
                     ("kernel, static rho", prm_k)):
        ts, sol = [], None
        reset_counts()
        sweeps = qsolver.lane_ruiz_sweeps
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = solve_qp_batch(aq, p, aws)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        counts, sweeps = read_counts(), qsolver.lane_ruiz_sweeps - sweeps
        phase("kernel", f"ASIF solve ({route}): {float(np.median(ts)):.3f} ms (median of 5, "
                        f"solve_qp_batch), mean iters {float(sol.iters.float().mean()):.3f}, "
                        f"Optimal {float((sol.status == 0).float().mean()) * 100:.3f}%, launches "
                        f"{counts} in 5 solves, torch Ruiz sweeps {sweeps}")
        if p is prm_l:
            require(counts == {"admm_shared": 0, "admm_problem": 0, "admm_lane": 5} and sweeps == 0,
                    "a lane ASIF solve was not exactly one admm_lane launch with no torch sweep")
    return worst_s, shared_row, worst_p, rows["warm"], worst_l, lane_rows["warm"]


def entry_points_phase(dev):
    """The user entry points with default solver parameters (polish on): the
    MPC class on the Quickstart vehicle (float64: polish by Cholesky) and
    the ASIFilter on one vehicle of the bench's configuration (float32:
    polish by LU), five calls each."""
    from collections import Counter

    from smooth_feedback_tpu_torch.controllers import MPC, ASIFilter, ASIFilterParams, MPCParams
    from smooth_feedback_tpu_torch.groups import SE2, Bundle, Rn

    ok = {0, 4}  # Optimal, MaxIterations
    k64 = dict(dtype=torch.float64, device=dev)
    twist = torch.tensor(TWIST, **k64)
    f = lambda x, u: torch.stack([u[0], torch.zeros_like(u[0]), u[1]])
    mpc = MPC(SE2, Rn(2), f, params=MPCParams(K=8, tf=3.0), **k64)
    mpc.set_xdes(lambda t: SE2.exp(t * twist), dxdes=lambda t: twist)
    mpc.set_udes(lambda t: torch.stack([twist[0], twist[2]]))
    x = SE2.exp(torch.tensor([0.2, -0.1, 0.1], **k64))
    stats, t0 = Counter(), time.perf_counter()
    for i in range(5):
        u, st = mpc(DT * i, x)
        require(bool(torch.isfinite(u).all()) and int(st) in ok, f"MPC call {i}: {st!r}, u {u}")
        stats[st.name] += 1
        x = SE2.rplus(x, DT * f(x, u))
    phase("entry-points", f"MPC class (Quickstart SE(2) vehicle, K=8, float64, default solver "
                          f"parameters: polish on, backend torch): 5 calls in "
                          f"{time.perf_counter() - t0:.3f} s, statuses {dict(stats)}, last u "
                          f"{[round(float(v), 6) for v in u]}")

    k32 = dict(dtype=torch.float32, device=dev)
    X, fl = Bundle(SE2, Rn(3)), asif_filter(dev)
    fil = ASIFilter(X, Rn(2), vehicle_asif_f, fl["h"], fl["bu"],
                    params=ASIFilterParams(T=ASIF_T, asif=asif_to_qp_params()),
                    W_u=fl["W_u"], ulim=fl["ulim"], **k32)
    x = X.rplus(X.identity(**k32), torch.tensor([0.0, -0.3, -1.2, 0.5, 0.0, 0.0], **k32))
    stats, t0 = Counter(), time.perf_counter()
    for i in range(5):
        u, st = fil(x, torch.tensor([0.3, 0.0], **k32))
        require(bool(torch.isfinite(u).all()) and int(st) in ok, f"ASIFilter call {i}: {st!r}, u {u}")
        stats[st.name] += 1
        x = X.rplus(x, ASIF_DT * vehicle_asif_f(x, u))
    phase("entry-points", f"ASIFilter (bench vehicle, K=50, T=2.5, float32, default solver "
                          f"parameters: polish on, backend torch): 5 calls in "
                          f"{time.perf_counter() - t0:.3f} s, statuses {dict(stats)}, last u "
                          f"{[round(float(v), 6) for v in u]}")


# --------------------------------------------------- EKF fleets (ekf_bench.py)


def ekf_problem(name, dev, dtype=torch.float32):
    """benchmarks/ekf_bench.py's problem on ``name`` ("SE(2)" or "SO(3)"):
    ``(G, dyn, meas, Q, R)``, twist 0.1 (1..ndof), meas = G.log, Q = 0.01 I,
    R = 0.05 I."""
    from smooth_feedback_tpu_torch.groups import SE2, SO3

    G = {"SE(2)": SE2, "SO(3)": SO3}[name]
    kw = dict(dtype=dtype, device=dev)
    twist = 0.1 * torch.arange(1, G.ndof + 1, **kw)
    eye = torch.eye(G.ndof, **kw)
    return G, (lambda t, g: twist), G.log, 0.01 * eye, 0.05 * eye


def ekf_layouts(G, dyn, meas, Q, R):
    """``{layout: (reset, step, cov)}`` for the three layouts of
    ekf_bench.py: ``step(state, noise)`` is one Euler predict over EKF_TAU
    and one update with ``y = meas(g) + noise`` taken at the pre-step
    estimate; ``cov(state)`` is each member's P, (B, n, n)."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch import estimators as E

    def fleet_step(s, noise):
        y = vmap(meas)(s.g) + noise
        return E.ekf_fleet_update(G, meas, E.ekf_fleet_predict(G, dyn, s, Q, EKF_TAU), y, R)

    def sqrt_step(s, noise):
        y = vmap(meas)(s.g) + noise
        return E.sqrt_ekf_fleet_update(G, meas, E.sqrt_ekf_fleet_predict(G, dyn, s, Q, EKF_TAU), y, R)

    one = vmap(lambda si, yi: E.ekf_update(G, meas, E.ekf_predict(G, dyn, si, Q, EKF_TAU), yi, R))

    def sqrt_cov(s):
        S = s.St.movedim(-1, 0)
        return S @ S.mT

    return {
        "fleet": (lambda g: E.ekf_fleet_reset(G, g), fleet_step,
                  lambda s: E.ekf_fleet_states(G, s).P),
        "sqrt fleet": (lambda g: E.sqrt_ekf_fleet_reset(G, g), sqrt_step, sqrt_cov),
        "vmap": (lambda g: E.EKFState(g, torch.eye(G.ndof, dtype=g.dtype, device=g.device)
                                      .expand(g.shape[0], G.ndof, G.ndof)),
                 lambda s, noise: one(s, vmap(meas)(s.g) + noise), lambda s: s.P),
    }


# f32 against the CPU f64 port on the first EKF_CPU_STEPS steps, and the
# layouts against each other after EKF_CHECK_STEPS: this phase run on a CPU
# (the wrappers' plain versions, f32 against f64, B = 4096) lands within
# 2.6e-7 in g and 1.8e-7 in P of the f64 port over the first 3 steps, and
# its layouts within 4.8e-7 of each other after 10; the card's f32 differs
# from the CPU's in summation order and FMA contraction.  So 2e-5 (forty
# times that floor) for every comparison below.  The
# square-root form propagates P + h (A P + P A' + Q) as Phi P Phi' + h Q, so
# it differs from the other two by O(h^2) per step (~1e-3 here): it is held
# to the other layouts through that difference, which the CPU f64 run gives.
EKF_TOL = 2e-5


def ekf_diff(G, a, b, cov_a, cov_b):
    """Largest |a.g (-) b.g| and |P_a - P_b| over the fleet."""
    from torch.func import vmap

    dg = float(vmap(G.rminus)(a.g, b.g).abs().max())
    return dg, float((cov_a(a) - cov_b(b)).abs().max())


def ekf_fleet_phase(dev):
    """ekf_bench.py's fleets on the card, nothing cut: SE(2) and SO(3), B =
    4096, float32, the three layouts; held against each other and against
    the CPU f64 port; rates over EKF_STEPS chained steps (best of EKF_REPS
    after a warm-up) with fresh measurement noise a step; a synchronised
    split of one step; the square-root fleet's P checked PSD after the
    timed runs; the layout's linear algebra timed against the lane helpers
    it replaces.  Returns ``{(group, layout): (rate, ms a step)}``."""
    from torch.func import vmap

    rates = {}
    for name in ("SE(2)", "SO(3)"):
        G, dyn, meas, Q, R = ekf_problem(name, dev)
        lay = ekf_layouts(G, dyn, meas, Q, R)
        # states exp(0.2 N(0, I)), each member G.random(gen, 0.2) drawn at once
        gen = torch.Generator(device=dev).manual_seed(SEED)
        g0 = vmap(G.exp)(0.2 * torch.randn((EKF_B, G.ndof), generator=gen, device=dev))
        noise = 0.05 * torch.randn((EKF_CHECK_STEPS, EKF_B, G.ndof), generator=gen, device=dev)
        Gc, dync, measc, Qc, Rc = ekf_problem(name, "cpu", torch.float64)
        lay_c = ekf_layouts(Gc, dync, measc, Qc, Rc)
        end, end_c = {}, {}
        for lname, (reset, step, cov) in lay.items():
            reset_c, step_c, cov_c = lay_c[lname]
            s, sc, worst = reset(g0), reset_c(g0.double().cpu()), (0.0, 0.0)
            for k in range(EKF_CHECK_STEPS):
                s = step(s, noise[k])
                sc = step_c(sc, noise[k].double().cpu())
                if k < EKF_CPU_STEPS:
                    card = type(s)(*(a.double().cpu() for a in s))
                    worst = tuple(map(max, worst, ekf_diff(Gc, card, sc, cov_c, cov_c)))
            end[lname], end_c[lname] = type(s)(*(a.double().cpu() for a in s)), sc
            phase("ekf-fleet", f"{name} {lname}: card f32 against the CPU f64 port over the first "
                               f"{EKF_CPU_STEPS} steps: max |dg| {worst[0]:.3e}, max |dP| "
                               f"{worst[1]:.3e} (bound {EKF_TOL:g})")
            require(max(worst) <= EKF_TOL, f"{name} {lname} differs from the CPU f64 port")
        covs = {ln: lay_c[ln][2] for ln in lay_c}
        fv = ekf_diff(Gc, end["fleet"], end["vmap"], covs["fleet"], covs["vmap"])
        # the square-root layout through its O(h^2) difference from the fleet
        d_card = (vmap(Gc.rminus)(end["sqrt fleet"].g, end["fleet"].g),
                  covs["sqrt fleet"](end["sqrt fleet"]) - covs["fleet"](end["fleet"]))
        d_cpu = (vmap(Gc.rminus)(end_c["sqrt fleet"].g, end_c["fleet"].g),
                 covs["sqrt fleet"](end_c["sqrt fleet"]) - covs["fleet"](end_c["fleet"]))
        sq = tuple(float((a - b).abs().max()) for a, b in zip(d_card, d_cpu))
        phase("ekf-fleet", f"{name}: layouts after {EKF_CHECK_STEPS} steps from the same inputs on "
                           f"the card: fleet against vmap max |dg| {fv[0]:.3e} max |dP| {fv[1]:.3e}; "
                           f"square-root fleet against fleet, less the same difference in the CPU "
                           f"f64 run ({float(d_cpu[1].abs().max()):.3e} in P, the O(h^2) of its "
                           f"discrete propagation): |dg| {sq[0]:.3e} |dP| {sq[1]:.3e} (bound "
                           f"{EKF_TOL:g})")
        require(max(fv + sq) <= EKF_TOL, f"{name}: the layouts disagree on the card")

        # rates, as ekf_bench.py takes them
        for lname, (reset, step, cov) in lay.items():
            def run():
                s = reset(g0)
                for _ in range(EKF_STEPS):
                    s = step(s, 0.05 * torch.randn((EKF_B, G.ndof), generator=gen, device=dev))
                return s

            run()
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(EKF_REPS):
                t0 = time.perf_counter()
                s = run()
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            rates[name, lname] = (EKF_B * EKF_STEPS / best, best * 1e3 / EKF_STEPS)
            phase("ekf-fleet", f"{name} {lname}: {rates[name, lname][0]:.1f} predict+update/s "
                               f"(B={EKF_B}, {rates[name, lname][1]:.3f} ms a fleet step, best of "
                               f"{EKF_REPS} runs of {EKF_STEPS} chained steps)")
            require(all(bool(torch.isfinite(a).all()) for a in s), f"{name} {lname}: non-finite state")
            if lname == "sqrt fleet":
                P = cov(s)  # float32 on the card
                norm = torch.linalg.matrix_norm(P.double(), ord=2)
                asym = float(((P - P.mT).abs().amax(dim=(1, 2)) / norm).max())
                lam = float((torch.linalg.eigvalsh(P.double()).amin(dim=1) / norm).min())
                phase("ekf-fleet", f"{name} square-root fleet after {EKF_STEPS} steps: P = S S' "
                                   f"max |P - P'| / |P| {asym:.3e}, smallest eigenvalue / |P| "
                                   f"{lam:.3e} (bound -1e-6)")
                require(asym <= 1e-6 and lam >= -1e-6, f"{name}: square-root P not symmetric PSD")
        ekf_split(name, G, dyn, meas, Q, R, g0, noise[0])
    ekf_linalg_timing(dev)
    return rates


def ekf_split(name, G, dyn, meas, Q, R, g0, noise):
    """One fleet step of each fleet form, synchronised stage by stage
    (medians of 5): measurement Jacobians, predict, update (which takes the
    Jacobians itself)."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch import estimators as E
    from smooth_feedback_tpu_torch.estimators.ekf import _fleet_meas_lin

    z = torch.zeros(G.ndof, dtype=g0.dtype, device=g0.device)
    forms = {
        "fleet": (E.ekf_fleet_reset(G, g0), E.ekf_fleet_predict, E.ekf_fleet_update),
        "sqrt fleet": (E.sqrt_ekf_fleet_reset(G, g0), E.sqrt_ekf_fleet_predict,
                       E.sqrt_ekf_fleet_update),
    }
    for lname, (s, predict, update) in forms.items():
        y = vmap(meas)(s.g) + noise
        stages = {
            "measurement Jacobians": lambda s: (_fleet_meas_lin(G, meas, s.g, y, None, z), s)[1],
            "predict": lambda s: predict(G, dyn, s, Q, EKF_TAU),
            "update": lambda s: update(G, meas, s, y, R),
        }
        times = {k: [] for k in stages}
        for _ in range(5):
            out = s
            for k, fn in stages.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(out)
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
        phase("ekf-fleet", f"{name} {lname}, one step, synchronised split (medians of 5): " + ", ".join(
            f"{k} {float(np.median(v)):.3f} ms" for k, v in times.items()))


def ekf_linalg_timing(dev):
    """The fleet forms' batched library calls on (B, n, n) against the
    unrolled lane helpers on (n, n, B) that the JAX package's layout uses,
    at the fleets' shapes (n = m = 3, B = 4096, float32): the innovation
    Cholesky and gain solve, and the square-root forms' QR (predict (3, 6),
    update (6, 6))."""
    from smooth_feedback_tpu_torch.estimators.ekf import _chol_solve, _qr_lower
    from smooth_feedback_tpu_torch.utils import chol_lane, chol_solve_lane, qr_lower_lane

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    M = rnd(EKF_B, 3, 3)
    S = M @ M.mT + torch.eye(3, device=dev)
    rhs = rnd(EKF_B, 3, 3)
    St, rhst = S.movedim(0, -1).contiguous(), rhs.movedim(0, -1).contiguous()
    rows = {
        "Cholesky + solve": (lambda: _chol_solve(S, rhs),
                             lambda: chol_solve_lane(chol_lane(St), rhst).movedim(-1, 0)),
    }
    for r, c in ((3, 6), (6, 6)):
        A = rnd(EKF_B, r, c)
        At = A.movedim(0, -1).contiguous()
        rows[f"QR lower ({r}, {c})"] = (lambda A=A: _qr_lower(A),
                                        lambda At=At: qr_lower_lane(At).movedim(-1, 0))
    for what, (lib, lane) in rows.items():
        err = float((lib() - lane()).abs().max())
        phase("ekf-fleet", f"{what} at B={EKF_B}: batched library calls {time_ms(lib, 20):.4f} ms, "
                           f"unrolled lane helpers {time_ms(lane, 20):.4f} ms (means of back-to-back "
                           f"calls), max |difference| {err:.3e}")
        require(err <= 1e-4, f"{what}: library and lane helpers disagree")


# ------------------------------- EKF -> MPC -> ASIF (output_feedback_vehicle.py)


def output_feedback_noise(steps, kw):
    """The smoke's measurement and process noise for ``steps`` steps of the
    example's loop (0.03 N(0, I11); 0.02 N(0, I6) on the velocity states),
    numpy seed SEED."""
    rng = np.random.default_rng(SEED)
    nm = 0.03 * rng.standard_normal((steps, 11))
    nw = 0.02 * rng.standard_normal((steps, 6))
    nw[:, :3] = 0.0
    return torch.as_tensor(nm, **kw), torch.as_tensor(nw, **kw)


def output_feedback_phase(p, dev):
    """OF_STEPS steps of the example's loop with both QPs on the per-problem
    kernel: the barrier on the TRUE state stays > 0, the estimation error
    ends below its initial value, and admm_problem launches once per QP
    solve.  Returns the launch counts and each step's inputs and results."""
    from torch.func import vmap

    X, h = p["X"], p["h"]
    x, est = output_feedback_start(p)
    err0 = float(torch.linalg.vector_norm(X.rminus(est.g, x)))
    mws, aws = p["mws"], p["aws"]
    nm, nw = output_feedback_noise(OF_STEPS, p["kw"])
    kept, step_s, hs, errs, m_st, a_st = [], [], [], [], [], []
    reset_counts()
    for i in range(OF_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x1, est1, est_upd, m, a = output_feedback_step(p, i, x, est, mws, aws, nm[i], nw[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        kept.append((i, x, est, mws, aws, est_upd, m, a))
        x, est, mws, aws = x1, est1, m.warmstart, a.warmstart
        hs.append(h(torch.tensor(OF_DT * i, **p["kw"]), x)[0])
        errs.append(torch.linalg.vector_norm(X.rminus(est.g, x)))
        m_st.append(int(m.status))
        a_st.append(int(a.status))
    counts = read_counts()
    hmin, errs = float(torch.stack(hs).min()), [float(e) for e in errs]
    med = float(np.median(step_s))
    phase("output-feedback", f"{OF_STEPS} steps (the example runs 800), float32: launches {counts}, "
                             f"MPC statuses {dict((s, m_st.count(s)) for s in set(m_st))}, ASIF "
                             f"statuses {dict((s, a_st.count(s)) for s in set(a_st))}, min barrier on "
                             f"the TRUE state {hmin:+.6f}, estimation error at reset {err0:.4f}, after "
                             f"step 1 {errs[0]:.4f}, final {errs[-1]:.4f}, median step "
                             f"{med * 1e3:.3f} ms (min {min(step_s) * 1e3:.3f}, max "
                             f"{max(step_s) * 1e3:.3f}), x final "
                             f"{[round(float(v), 4) for v in x[:2]]}")
    require(counts["admm_problem"] == 2 * OF_STEPS and counts["admm_shared"] == 0,
            f"output-feedback launches {counts}, expected {2 * OF_STEPS} admm_problem (one per QP)")
    require(hmin > 0.0, f"safety violated under output feedback: min barrier {hmin}")
    require(errs[-1] < err0, f"the EKF did not reduce the estimation error ({err0} -> {errs[-1]})")
    require(all(s in (0, 4) for s in m_st + a_st), "a QP returned neither Optimal nor MaxIterations")
    require(bool(torch.isfinite(x).all()) and bool(torch.isfinite(est.P).all()), "non-finite state")
    return counts, kept


def output_feedback_split(p, kept):
    """One step at the last kept inputs, synchronised stage by stage, five
    times over: EKF (update and predict), MPC, ASIF transcription, ASIF
    solve, plant; medians."""
    from smooth_feedback_tpu_torch.controllers import asif_to_qp
    from smooth_feedback_tpu_torch.estimators import ekf_predict, ekf_update
    from smooth_feedback_tpu_torch.qp import QPSolution, QuadraticProgram, solve_qp_batch

    X, U, f, fl, aprm, kw = p["X"], p["U"], p["f"], p["fl"], p["aprm"], p["kw"]
    i, x, est, mws, aws, _, m, a = kept[-1]
    t = torch.tensor(OF_DT * i, **kw)
    y = p["meas"](x)
    stages = {
        "EKF": lambda: ekf_predict(X, lambda t_, g: f(g, a.u),
                                   ekf_update(X, p["meas"], est, y, p["R"]), p["Q"], OF_DT),
        "MPC": lambda: p["mpc"](mws, t, est.g),
        "ASIF transcription": lambda: asif_to_qp(X, U, aprm.asif, aprm.T, est.g, m.u, fl["W_u"],
                                                 fl["ulim"], f, fl["h"], fl["bu"]),
        "ASIF solve": lambda: solve_qp_batch(QuadraticProgram(*(q[None] for q in aq)), aprm.qp,
                                             QPSolution(*(w[None] for w in aws))),
        "plant": lambda: X.rplus(x, OF_DT * f(x, a.u)),
    }
    aq = stages["ASIF transcription"]()
    times = {k: [] for k in stages}
    for _ in range(5):
        for k, fn in stages.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    phase("output-feedback", "one step, synchronised split (medians of 5): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in med.items()))
    return med


def output_feedback_plain_phase(dev, kept):
    """The first OF_PLAIN_STEPS steps again with both QPs on the torch
    loop, each from the kernel run's state, estimate and warm starts: the
    vehicle-asif-plain phase's bounds on u."""
    p = output_feedback_path(dev, backend="torch")
    nm, nw = output_feedback_noise(OF_STEPS, p["kw"])
    worst_m = worst_a = 0.0
    rows = []
    for i, x, est, mws, aws, _, mk, ak in kept[:OF_PLAIN_STEPS]:
        _, _, _, mp, ap = output_feedback_step(p, i, x, est, mws, aws, nm[i], nw[i])
        require(int(mp.status) == int(mk.status) and int(ap.status) == int(ak.status),
                f"step {i}: plain statuses {int(mp.status)}, {int(ap.status)} against kernel "
                f"{int(mk.status)}, {int(ak.status)}")
        du_m = float((mp.u - mk.u).abs().max())
        du_a = float((ap.u - ak.u).abs().max())
        it = [(int(mp.warmstart.iters), int(mk.warmstart.iters)),
              (int(ap.warmstart.iters), int(ak.warmstart.iters))]
        rows.append(f"step {i} iters MPC plain/kernel {it[0]} ASIF {it[1]} |du| MPC {du_m:.3e} "
                    f"ASIF {du_a:.3e}")
        if it[0][0] == it[0][1]:
            require(du_m <= PRIMAL_TOL, f"step {i}: MPC u differs by {du_m:.3e}")
            worst_m = max(worst_m, du_m)
        if it[1][0] == it[1][1]:
            require(du_a <= PRIMAL_TOL + ASIF_U_GAIN * du_m, f"step {i}: ASIF u differs by {du_a:.3e}")
            worst_a = max(worst_a, du_a)
    phase("output-feedback-plain", f"both QPs on the torch loop, first {OF_PLAIN_STEPS} steps on the "
                                   f"kernel run's states and carries: statuses equal; " + "; ".join(rows)
                                   + f" (bounds where iteration counts agree: MPC {PRIMAL_TOL:g}, "
                                   f"ASIF {PRIMAL_TOL:g} + {ASIF_U_GAIN:g} x the step's |du_mpc|)")
    return worst_m


# The output-feedback MPC's solve never converges (4000 iterations every
# step, in the JAX package too: ROADMAP Queue 3 item 7).  After that many
# float32 iterations the kernel and the f32 plain version each lie from the
# float64 run by f32 noise that the summation order decides, so the two are
# not held to each other (a rounding change passed or failed that rule by
# chance).  Each is held to the float64 run instead: per vector (x, z, y),
# the largest distance from it over the members, relative to each member's
# scale max(1, |v|_inf); the kernel's worst over the three vectors at most
# OF_F64_FACTOR times the f32 plain version's worst plus OF_F64_FLOOR; and
# the kernel's statuses equal to the f64 run's on every member where the
# plain version's are.  The worst vector, not each one, is compared: which
# vector's noise lands nearer float64 in one run is chance (at B = 1 a
# kernel 4.8 x the plain version's in x was 0.59 x in y, its worst).  The
# floor is two float32 ulps at scale 1, below every worst reading of the
# plain version's (the output-feedback MPC's y 6.4e-5).  The factor is
# what the committed kernel needs: its worst lies 1.0-1.6 x the plain
# version's at the output-feedback MPC and the SE(3) fleet, and 2.5 x over
# the family of the double-integrator NLP's first subproblem at (19, 45);
# a build whose column products carry a 1e-5 relative bias lies 8.3 x at
# the output-feedback MPC and fails (streaming_variants.py).
OF_F64_FACTOR = 4.0
OF_F64_FLOOR = 2 * 2.0 ** -23


def f64_distances(outs, d):
    """Per vector (x, z, y): the largest distance of ``outs`` from the
    float64 run ``d`` over the members, relative to each member's scale."""
    return [float(((o.double() - dv).abs().amax(dim=1) / dv.abs().amax(dim=1).clamp(min=1.0)).max())
            for o, dv in zip(outs[:3], d[:3])]


def f64_bound(plain):
    """The float64 rule's bound on the kernel's worst distance, from the
    plain version's per-vector distances ``plain``."""
    return OF_F64_FACTOR * max(plain) + OF_F64_FLOOR


def f64_distance_check(wrapper, args, prm, label, k=None, r=None):
    """One solve through ``wrapper`` (its outputs ``k`` where given) and the
    plain version in float32 (``r``) and float64 on the same inputs, judged
    by the float64 rule above.  Returns the kernel's outputs."""
    from smooth_feedback_tpu_torch.qp import admm_iterate_reference

    k = wrapper(prm, *args) if k is None else k
    r = admm_iterate_reference(prm, *args) if r is None else r
    d = admm_iterate_reference(prm, *f64(args))
    torch.cuda.synchronize()
    statuses = bool(((k[3] == d[3]) | (r[3] != d[3])).all())
    dk, dr = f64_distances(k, d), f64_distances(r, d)
    good = statuses and max(dk) <= f64_bound(dr)
    phase("kernel", f"{label}: statuses kernel {k[3].tolist()} plain {r[3].tolist()} f64 "
                    f"{d[3].tolist()}, equal to f64's wherever the plain version's are: {statuses}; "
                    f"largest distance from the f64 run relative to each member's scale: "
                    + ", ".join(f"{v} kernel {a:.3e} plain {b:.3e}" for v, a, b in zip("xzy", dk, dr))
                    + f"; the kernel's worst {max(dk):.3e} (bound {OF_F64_FACTOR:g} x the plain "
                    f"version's worst + {OF_F64_FLOOR:.3g} = {f64_bound(dr):.3e})")
    require(good, f"{label}: the kernel lies farther from the float64 run than the rule allows")
    return k


def output_feedback_kernel_phase(p, kept, dev):
    """admm_problem at the output-feedback shapes against its plain version:
    the MPC QPs and the ASIF QPs of the first OF_KERNEL_STEPS steps, batched
    (each member its own block, so the batch changes no member's result),
    20 fixed iterations and a warm-started solve each (a solve that runs
    to max_iter in both versions held to the float64 run:
    :func:`f64_distance_check`); then each at B = 1, the path's own launch,
    timed.  Returns the worst error and the rows ``{shape: (ms, plain_ms,
    bound_ms, bound_by)}``."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.controllers import asif_to_qp
    from smooth_feedback_tpu_torch.qp import (
        QPSolution, QPSolutionStatus, QuadraticProgram, admm_iterate_cuda, admm_iterate_reference,
        per_problem_kernel_args,
    )

    X, U, f, fl, aprm, kw = p["X"], p["U"], p["f"], p["fl"], p["aprm"], p["kw"]
    MAX_ITER = int(QPSolutionStatus.MaxIterations)
    first = kept[:OF_KERNEL_STEPS]
    stack_ws = lambda wss: QPSolution(*(torch.stack(a) for a in zip(*wss)))
    ts = torch.tensor([OF_DT * k[0] for k in first], **kw)
    gs = torch.stack([k[5].g for k in first])
    mq = vmap(p["mpc"].transcribe)(ts, gs)
    aq = QuadraticProgram(*(torch.stack(a) for a in zip(*(
        asif_to_qp(X, U, aprm.asif, aprm.T, k[5].g, k[6].u, fl["W_u"], fl["ulim"], f, fl["h"],
                   fl["bu"]) for k in first))))
    prm = aprm.qp
    worst, rows = 0.0, {}
    for what, qps, ws in (("MPC", mq, stack_ws([k[3] for k in first])),
                          ("ASIF", aq, stack_ws([k[4] for k in first]))):
        m, n = qps.A.shape[-2:]
        cold = per_problem_kernel_args(qps, None, None, prm)
        if what == "ASIF":
            # an input that is already safe makes the cold start exact (it
            # stops at the first check even with every tolerance 0): start
            # the fixed iterations from a seeded random iterate
            rng = np.random.default_rng(SEED)
            cold = list(cold)
            for j in (12, 13, 14):
                cold[j] = torch.as_tensor(0.1 * rng.standard_normal(tuple(cold[j].shape)),
                                          dtype=torch.float32, device=dev)
        worst = max(worst, fixed_iteration_check(admm_iterate_cuda, tuple(cold), prm,
                                                 f"output-feedback {what} ({n}, {m})"))
        warm = per_problem_kernel_args(qps, None, ws, prm)
        label = f"output-feedback {what} ({n}, {m}) x {len(first)} steps, warm"
        k = admm_iterate_cuda(prm, *warm)
        r = admm_iterate_reference(prm, *warm)
        stuck = bool((k[3] == MAX_ITER).all() and (r[3] == MAX_ITER).all())
        if stuck:
            # every member runs to max_iter in both (the example's MPC does
            # so in the JAX package too): each is held to the float64 run
            # (not counted in the kernels line's max_abs_err: after 4000
            # float32 iterations |kernel - plain| is f32 noise)
            k = f64_distance_check(admm_iterate_cuda, warm, prm, label, k, r)
        else:
            err, k = compare_with_plain(label, admm_iterate_cuda, prm, warm, qps, k=k, r=r)
            worst = max(worst, err)
        one = tuple(a[-1:].contiguous() if a.dim() and a.shape[0] == len(first) else a for a in warm)
        k1 = admm_iterate_cuda(prm, *one)
        require(all(torch.equal(a, b[-1:]) for a, b in zip(k1, k)),
                f"output-feedback {what}: the B = 1 launch differs from the batched one")
        # the plain version's 4000 MPC iterations take seconds: one timed call
        rows[f"({n}, {m})"] = (time_ms(lambda: admm_iterate_cuda(prm, *one), 20),
                               time_ms(lambda: admm_iterate_reference(prm, *one),
                                       1 if stuck else 5),
                               *bound(one, k1, prm))
        r = rows[f"({n}, {m})"]
        phase("kernel", f"output-feedback {what} at B=1, n={n}, m={m} (one block: one SM of 132), "
                        f"warm: kernel {r[0]:.4f} ms, plain {r[1]:.4f} ms (means of back-to-back "
                        f"calls), {int(k1[4][0])} iterations; bound {r[2]:.6f} ms ({r[3]})")
    return worst, rows


# -------------------------------------------------- the SE(2) OCP sweep


def ocp_sweep_params(backend):
    """benchmarks/ocp_se2.py:166-194 at B <= 64: unchunked, no probe, no
    stall freeze; the subproblems on ``backend`` (``card_qp_params``)."""
    from smooth_feedback_tpu_torch.solvers import SQPParams

    return SQPParams(max_iter=60, tol=OCP_TOL, compensated_kkt=True, qp_budget=36000,
                     qp=card_qp_params(backend))


def ocp_sweep_path(dev, dtype=torch.float32, B_=OCP_B, mesh=OCP_MESH):
    """``(make, vels, z0)``: the sweep's NLP family on ``Mesh.uniform(*mesh)``,
    the B tracked velocities and the start (tf = 5, zero deviations)."""
    from smooth_feedback_tpu_torch.ocp.collocation import Mesh

    make = ocp_sweep_problem(Mesh.uniform(*mesh), dtype, dev)
    vels = torch.as_tensor(ocp_sweep_velocities(B_), dtype=dtype, device=dev)
    z0 = torch.zeros((B_, make(vels[0]).n), dtype=dtype, device=dev)
    z0[:, 0] = 5.0
    return make, vels, z0


def ocp_sweep_rescue(make, vels, sol, prm, z0):
    """benchmarks/ocp_se2.py:276-279: rescue_nonoptimal with budget_scale 4,
    adaptive rho and stall_scale 3, cold start z0.  Adaptive rho has no
    kernel route, so the rescue's QPs run the torch loop."""
    from smooth_feedback_tpu_torch.solvers import rescue_nonoptimal

    rprm = dataclasses.replace(prm, qp=dataclasses.replace(prm.qp, backend="torch"))
    return rescue_nonoptimal(make, vels, sol, rprm, x0_cold=z0, budget_scale=4,
                             adaptive_rho=True, stall_scale=3)


def ocp_kkt_f64(vels, sol, mesh=None, start=None):
    """Every member's KKT residual recomputed in float64 on the CPU at the
    returned point of the NLP on ``mesh`` (a ``Mesh``; the sweep's
    ``Mesh.uniform(*OCP_MESH)`` by default; ``start`` as
    :func:`ocp_sweep_flat`'s): :func:`nlp_kkt_f64`."""
    from smooth_feedback_tpu_torch.ocp.collocation import Mesh

    make = ocp_sweep_problem(Mesh.uniform(*OCP_MESH) if mesh is None else mesh, torch.float64,
                             "cpu", start)
    return nlp_kkt_f64(make, vels, sol)


def nlp_kkt_f64(make, thetas, sol):
    """Every member's KKT residual in float64 at the returned point (x,
    lam, z = zu - zl) of its NLP ``make(theta)`` (a float64 CPU NLP): max
    of |grad f + J' lam + z|_inf and the largest bound violation."""
    from torch.func import grad, jacrev, vmap

    d = lambda a: torch.as_tensor(a).detach().to("cpu", torch.float64)
    th, x, lam, z = d(thetas), d(sol.x), d(sol.lam), d(sol.zu) - d(sol.zl)
    gval = vmap(lambda t, xx: make(t).g(xx))(th, x)
    gr = vmap(lambda t, xx: grad(make(t).f)(xx))(th, x)
    J = vmap(lambda t, xx: jacrev(make(t).g)(xx))(th, x)
    xl, xu, gl, gu = vmap(lambda t: tuple(make(t)[4:8]))(th)
    stat = (gr + torch.einsum("bmn,bm->bn", J, lam) + z).abs().amax(dim=1)
    over = lambda lo, v, hi: torch.maximum(torch.clamp(lo - v, min=0.0), torch.clamp(v - hi, min=0.0))
    return torch.maximum(stat, torch.maximum(over(gl, gval, gu).amax(dim=1),
                                             over(xl, x, xu).amax(dim=1)))


def pct(a, q):
    return float(np.percentile(a.cpu().numpy(), q))


def ocp_sweep_phase(dev):
    """benchmarks/ocp_se2.py's on-device protocol at B = 64, float32: the
    lockstep SQP with every subproblem through admm_problem (one launch an
    iteration), then the rescue.  Requires an Optimal share after rescue
    at least the JAX package's on the same velocities, every Optimal
    member's float64 KKT residual <= tol, and the launches equal to the
    lockstep iterations.  Returns the sweep's launches, solution and
    seconds."""
    from smooth_feedback_tpu_torch.qp import solver as qsolver
    from smooth_feedback_tpu_torch.solvers import solve_nlp_sqp_batch

    make, vels, z0 = ocp_sweep_path(dev)
    prm = ocp_sweep_params("cuda")
    nlp0 = make(vels[0])
    require((nlp0.n, nlp0.n + nlp0.m) == OCP_QP_SHAPE, f"subproblem shape {(nlp0.n, nlp0.m)}")
    fall0 = qsolver.shared_fallthroughs
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve_nlp_sqp_batch(make, vels, z0, prm)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    counts = read_counts()
    lockstep = int(sol.iters.max())
    st0 = sol.status.clone()
    reset_counts()
    t0 = time.perf_counter()
    merged, n_resc = ocp_sweep_rescue(make, vels, sol, prm, z0)
    torch.cuda.synchronize()
    t_rescue = time.perf_counter() - t0
    rcounts = read_counts()
    opt0 = float((st0 == 0).float().mean())
    opt = float((merged.status == 0).float().mean())
    kkt64 = ocp_kkt_f64(vels, merged)
    is_opt = (merged.status == 0).cpu()
    worst64 = float(kkt64[is_opt].max()) if bool(is_opt.any()) else 0.0
    phase("ocp-sweep", f"B={OCP_B} flat SE(2) x R^2 OCPs on Mesh.uniform{OCP_MESH} (NLP n={nlp0.n}, "
                       f"m={nlp0.m}; QP n={OCP_QP_SHAPE[0]}, m={OCP_QP_SHAPE[1]}), float32: Optimal "
                       f"{opt0 * 100:.3f}% after the sweep, {opt * 100:.3f}% after rescue (JAX, f32 "
                       f"CPU, same velocities: {OCP_JAX_OPTIMAL * 100:.3f}%); {n_resc} members "
                       f"rescued; statuses {merged.status.tolist()}")
    phase("ocp-sweep", f"SQP iterations p50 {pct(sol.iters, 50):.0f} max {lockstep}, qp_iters p50 "
                       f"{pct(sol.qp_iters, 50):.0f} max {int(sol.qp_iters.max())}, KKT median "
                       f"{pct(merged.kkt_res, 50):.3e} max {float(merged.kkt_res.max()):.3e}; Optimal "
                       f"members' KKT recomputed in float64 on the CPU: max {worst64:.3e} (tol "
                       f"{OCP_TOL:g})")
    phase("ocp-sweep", f"sweep {t_sweep:.3f} s, rescue {t_rescue:.3f} s: "
                       f"{OCP_B / (t_sweep + t_rescue):.3f} OCP solves/s; launches: sweep {counts} in "
                       f"{lockstep} lockstep iterations, rescue {rcounts} (adaptive rho: torch loop); "
                       f"shared-loop fall-throughs {qsolver.shared_fallthroughs - fall0}")
    require(opt >= OCP_JAX_OPTIMAL, f"Optimal share after rescue {opt:.5f} < JAX's {OCP_JAX_OPTIMAL}")
    require(worst64 <= OCP_TOL, f"an Optimal member's float64 KKT residual is {worst64:.3e}")
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": lockstep},
            f"admm_problem launches {counts} != {lockstep} lockstep iterations")
    require(rcounts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": 0}, f"the rescue launched {rcounts}")
    return counts, sol, t_sweep


def ocp_lockstep(dev, iters, trace, backend="cuda", dtype=torch.float32):
    """The sweep's first ``iters`` lockstep SQP iterations with ``trace``
    called at each stage (the lockstep loop's own hook: the public entry
    points take none), inside the entry points' float32 matmul scope."""
    from smooth_feedback_tpu_torch._precision import ieee_f32_matmul
    from smooth_feedback_tpu_torch.solvers import sqp

    make, vels, z0 = ocp_sweep_path(dev, dtype)
    prm = dataclasses.replace(ocp_sweep_params(backend), max_iter=iters)
    with ieee_f32_matmul():
        return sqp._solve_nlp_sqp_batch_impl(make, vels, z0, prm, None, trace)


def ocp_sweep_split(dev):
    """One lockstep SQP iteration from the sweep's start, synchronised at
    each stage, medians of OCP_SPLIT_REPS (after a warm-up): derivatives
    (the Lagrangian Hessian, then f, g, gradient, Jacobian and KKT at the
    new iterate), convexification, QP, line search; and the QP itself
    split into factorization and scaling, kernel, and finalize (polish and
    the compensated check).  Returns the first iteration's subproblem and
    warm start."""
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda, per_problem_kernel_args, solve_qp_batch

    stages, captured = [], {}

    def trace(stage, info):
        torch.cuda.synchronize()
        stages[-1][stage] = time.perf_counter()
        if stage == "qp":
            captured.update(info)

    for _ in range(OCP_SPLIT_REPS + 1):
        stages.append({})
        ocp_lockstep(dev, 1, trace)
    order = ["start", "hessian", "convexify", "qp", "line_search", "derivatives"]
    ms = {b: float(np.median([1e3 * (s[b] - s[a]) for s in stages[1:]]))
          for a, b in zip(order, order[1:])}
    qp, ws, qprm = captured["qp"], captured["ws"], ocp_sweep_params("cuda").qp
    sync = torch.cuda.synchronize

    def timed(fn):
        fn()
        sync()
        out = []
        for _ in range(OCP_SPLIT_REPS):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(out))

    args = per_problem_kernel_args(qp, None, ws, qprm)
    prep = timed(lambda: per_problem_kernel_args(qp, None, ws, qprm))
    kern = timed(lambda: admm_iterate_cuda(qprm, *args))
    whole = timed(lambda: solve_qp_batch(qp, qprm, ws))
    phase("ocp-sweep", "one lockstep SQP iteration, synchronised split (medians of "
                       f"{OCP_SPLIT_REPS}): derivatives {ms['hessian'] + ms['derivatives']:.3f} ms "
                       f"(Lagrangian Hessian {ms['hessian']:.3f}, f/g/grad/J/KKT "
                       f"{ms['derivatives']:.3f}), convexification {ms['convexify']:.3f} ms, QP "
                       f"{ms['qp']:.3f} ms, line search {ms['line_search']:.3f} ms; the QP alone: "
                       f"factorization and scaling {prep:.3f} ms, kernel {kern:.3f} ms, finalize "
                       f"(polish, compensated check) {whole - prep - kern:.3f} ms, whole {whole:.3f} ms")
    return qp, ws


def relative_floor(r, d):
    """Per member and vector (x, z, y): the float32 plain version's distance
    from the float64 run relative to the member's scale max(1, |v|_inf), and
    the members all of whose values are finite in both runs."""
    fin = lambda o: torch.stack([torch.isfinite(v).all(dim=1) for v in o[:3]]).all(dim=0)
    scale = [dt.abs().amax(dim=1).clamp(min=1.0) for dt in d[:3]]
    rel = [(rt.double() - dt).abs().amax(dim=1) / sc for rt, dt, sc in zip(r[:3], d[:3], scale)]
    return rel, scale, fin(r) & fin(d)


def ocp_resolved_subproblem(caps, qprm):
    """The earliest captured subproblem batch after the first that float32
    resolves: at least OCP_MIN_STOPPED members' solves on the path stopped
    before max_iter, and over FIXED_ITERS warm iterations the float32 plain
    version's median distance from the float64 run, relative to each
    member's scale (the largest of x, z, y), is within OCP_RESOLVE / 10.
    Chosen from the plain versions alone, and as early as possible: later
    batches hold more members already at their fixed point."""
    from smooth_feedback_tpu_torch.qp import per_problem_kernel_args

    rows = []
    for it, (qp, ws, sol) in enumerate(caps[1:], start=2):
        stopped = int((sol.iters < qprm.max_iter).sum())
        if stopped < OCP_MIN_STOPPED:
            rows.append(f"{it}: {stopped} stopped")
            continue
        _, r, d = fixed_runs(None, per_problem_kernel_args(qp, None, ws, qprm), qprm, FIXED_ITERS)
        rel, _, ok = relative_floor(r, d)
        med = max(float(v[ok].median()) for v in rel)
        rows.append(f"{it}: {stopped} stopped, median relative floor {med:.3e}")
        if med <= OCP_RESOLVE / 10:
            phase("kernel", f"ocp-sweep lockstep iterations captured: {'; '.join(rows)}")
            return it, qp, ws
    phase("kernel", f"ocp-sweep lockstep iterations captured: {'; '.join(rows)}")
    require(False, f"no captured subproblem batch has {OCP_MIN_STOPPED} members that stopped "
                   f"early and a median relative floor <= {OCP_RESOLVE / 10:g}")


def relative_fixed_check(wrapper, args, qprm, iters, label):
    """Kernel and plain version with every tolerance 0 for ``iters``
    iterations, judged member by member relative to each member's own scale
    (the path's members span orders of magnitude), as distributions over
    the members: a few members are chaotic in float32 (their distance from
    the float64 run differs by factors between two float32 runs), so no
    single member decides.  Per vector, the kernel's median distance from
    the float64 run must be within ITER_TOL + twice the float32 plain
    version's median, a bound that must itself lie within OCP_RESOLVE (a
    kernel off by 1 % of the scale in half the members fails), and the
    kernel must come within OCP_RESOLVE / 10 of the float64 run in as many
    members as the plain version does, less an eighth of the fleet (a
    kernel wrong in a few members fails).  Members with non-finite values in
    the plain runs must be non-finite in the kernel's too and are left out.
    Returns the largest |kernel - plain| over the members the plain version
    resolves (within OCP_RESOLVE / 10)."""
    from smooth_feedback_tpu_torch.qp import QPSolutionStatus

    MAX_ITER = int(QPSolutionStatus.MaxIterations)
    k, r, d = fixed_runs(wrapper, args, qprm, iters)
    rel, scale, ok = relative_floor(r, d)
    fin_k = torch.stack([torch.isfinite(v).all(dim=1) for v in k[:3]]).all(dim=0)
    ran = bool(((k[3] == MAX_ITER) & (r[3] == MAX_ITER) & (k[4] == iters) & (r[4] == iters))[ok].all())
    nonfinite_same = bool((fin_k | ~ok).all() and (~fin_k | ok).all())
    tau, allow = OCP_RESOLVE / 10, ok.numel() // 8
    resolved = ok & torch.stack([fl <= tau for fl in rel]).all(dim=0)
    rows, worst, good = [], 0.0, bool(ok.any()) and nonfinite_same
    for name, kt, rt, dt, fl, sc in zip("xzy", k[:3], r[:3], d[:3], rel, scale):
        if bool(resolved.any()):
            worst = max(worst, float((kt - rt).abs().amax(dim=1)[resolved].max()))
        dist = ((kt.double() - dt).abs().amax(dim=1) / sc)[ok]
        fmed, emed = float(fl[ok].median()), float(dist.median())
        n_k, n_r = int((dist <= tau).sum()), int((fl[ok] <= tau).sum())
        bmed = ITER_TOL + 2 * fmed
        rows.append(f"{name} median {emed:.3e} (plain {fmed:.3e}), within {tau:g}: {n_k} (plain "
                    f"{n_r}), largest {float(dist.max()):.3e} (plain {float(fl[ok].max()):.3e})")
        good = good and emed <= bmed and bmed <= OCP_RESOLVE and n_k >= n_r - allow
    phase("kernel", f"{label}: fixed {iters} iterations, all tolerances 0, {int(ok.sum())} of "
                    f"{ok.numel()} members finite in the plain runs (the same members finite in "
                    f"the kernel's: {nonfinite_same}), all ran them: {ran}; distance from the f64 "
                    f"plain run relative to each member's scale, kernel (f32 plain): "
                    + ", ".join(rows) + f"; largest |kernel - plain| over the {int(resolved.sum())} "
                    f"members the plain version resolves {worst:.3e} (bounds: median {ITER_TOL:g} "
                    f"+ 2 x the plain version's and <= {OCP_RESOLVE:g}; within {tau:g} in as many "
                    f"members less {allow})")
    require(ran, "with all tolerances 0 a member stopped before max_iter")
    require(good, f"{label}: the kernel differs beyond the relative bounds")
    return worst


def ocp_sweep_kernel_phase(first, dev):
    """admm_problem against its plain version on the path's own subproblem
    batches (B = 64, n = 112, m = 224).  The first lockstep iteration's
    (lambda = 0: H = c G + 1e-6 I) is one float32 cannot follow past a
    single ADMM iteration, so it is held for one; then the earliest batch
    of the first OCP_KERNEL_ITERS iterations that float32 resolves
    (:func:`ocp_resolved_subproblem`) is held over FIXED_ITERS warm
    iterations and in the warm solve the path runs (compare_with_plain:
    statuses, iteration counts, the primal where the counts agree, the f64
    re-check of every Optimal point).  The kernels line's times are the
    first batch's whole 1200-iteration solve.  Returns the worst absolute
    error (the first batch's iteration and the warm solve's primal where
    counts agree) and the row (ms, plain_ms, bound_ms, bound_by)."""
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda, admm_iterate_reference, per_problem_kernel_args

    qprm = ocp_sweep_params("cuda").qp
    qp, ws = first
    n, m, B_ = qp.A.shape[-1], qp.A.shape[-2], qp.A.shape[0]
    warm = per_problem_kernel_args(qp, None, ws, qprm)
    worst = relative_fixed_check(admm_iterate_cuda, warm, qprm, OCP_FIRST_ITERS,
                                 f"ocp-sweep ({n}, {m}) B={B_}, lockstep iteration 1")
    caps = []
    ocp_lockstep(dev, OCP_KERNEL_ITERS,
                 lambda s, i: caps.append((i["qp"], i["ws"], i["sol"])) if s == "qp" else None)
    it, qp2, ws2 = ocp_resolved_subproblem(caps, qprm)
    label = f"ocp-sweep ({n}, {m}) B={B_}, lockstep iteration {it}"
    warm2 = per_problem_kernel_args(qp2, None, ws2, qprm)
    # not counted in the kernels line's max_abs_err: members whose iterates
    # grow to ~1e29 in every run make an absolute difference meaningless
    relative_fixed_check(admm_iterate_cuda, warm2, qprm, FIXED_ITERS, label)
    err, _ = compare_with_plain(f"{label}, warm solve", admm_iterate_cuda, qprm, warm2, qp2,
                                noisy=True)
    k = admm_iterate_cuda(qprm, *warm)
    row = (time_ms(lambda: admm_iterate_cuda(qprm, *warm), 20),
           time_ms(lambda: admm_iterate_reference(qprm, *warm), 2), *bound(warm, k, qprm))
    phase("kernel", f"ocp-sweep ({n}, {m}) B={B_}, lockstep iteration 1, warm solve: kernel "
                    f"{row[0]:.4f} ms, plain {row[1]:.4f} ms (means of back-to-back calls), mean "
                    f"{float(k[4].float().mean()):.1f} iterations; bound {row[2]:.6f} ms ({row[3]}, "
                    f"{100 * row[2] / row[0]:.2f}%)")
    return max(worst, err), row


def ocp_sweep_routes_phase(dev, sweep_sol):
    """The first OCP_ROUTE_B members the sweep called Optimal, solved again
    to the end on three routes on the card: subproblems through the kernel
    (float32), the torch loop in float32, and in float64.  Each run must
    call every member Optimal, and the kernel route's x must lie within
    1e-4 of its scale plus twice the float32 torch route's distance from
    the float64 one (the measured float32 noise), a floor that must itself
    lie within OCP_RESOLVE of the scale.  Returns the distance."""
    from smooth_feedback_tpu_torch.solvers import solve_nlp_sqp_batch

    idx = torch.nonzero(sweep_sol.status == 0).flatten()[:OCP_ROUTE_B]
    out = {}
    for name, backend, dtype in (("cuda", "cuda", torch.float32), ("torch", "torch", torch.float32),
                                 ("torch64", "torch", torch.float64)):
        make, vels, z0 = ocp_sweep_path(dev, dtype)
        out[name] = solve_nlp_sqp_batch(make, vels[idx], z0[idx], ocp_sweep_params(backend))
    kc, kt, k64 = out["cuda"], out["torch"], out["torch64"]
    optimal = all(bool((s.status == 0).all()) for s in out.values())
    dx = float((kc.x - kt.x).abs().max())
    floor = float((kt.x.double() - k64.x).abs().max())
    scale = max(1.0, float(k64.x.abs().max()))
    its = {k: v.iters.tolist() for k, v in out.items()}
    phase("ocp-sweep-routes", f"members {idx.tolist()} solved to the end on the kernel, the f32 "
                              f"torch loop and the f64 torch loop: all Optimal {optimal}; SQP "
                              f"iterations {its}; max |x_kernel - x_torch| {dx:.3e} (f32 torch - f64 "
                              f"torch {floor:.3e}, scale {scale:.3e}; bound 1e-4 x scale + 2 x floor, "
                              f"floor <= {OCP_RESOLVE:g} x scale)")
    require(optimal, "a route left a member the sweep solved not Optimal")
    require(floor <= OCP_RESOLVE * scale, "the f32 noise floor does not resolve the routes")
    require(dx <= 1e-4 * scale + 2 * floor, "the kernel route's solution differs beyond the bound")
    return dx


def ocp_single_phase(dev, sweep_sol):
    """solve_nlp_sqp on member 0 alone (a fleet of one: admm_problem at
    B = 1): its status equal to the sweep's and its float64 KKT <= tol."""
    from smooth_feedback_tpu_torch.nlp import NLPSolution
    from smooth_feedback_tpu_torch.solvers import solve_nlp_sqp

    make, vels, z0 = ocp_sweep_path(dev)
    reset_counts()
    t0 = time.perf_counter()
    s1 = solve_nlp_sqp(make(vels[0]), z0[0], ocp_sweep_params("cuda"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    kkt = float(ocp_kkt_f64(vels[:1], NLPSolution(*(a[None] for a in s1)))[0])
    phase("ocp-single", f"solve_nlp_sqp on member 0 (B = 1): status {int(s1.status)} (sweep "
                        f"{int(sweep_sol.status[0])}), {int(s1.iters)} SQP iterations (sweep "
                        f"{int(sweep_sol.iters[0])}), KKT {float(s1.kkt_res):.3e}, float64 {kkt:.3e}; "
                        f"launches {counts}; {secs:.3f} s")
    require(int(s1.status) == int(sweep_sol.status[0]), "the single form's status differs")
    require(kkt <= OCP_TOL, f"the single form's float64 KKT residual is {kkt:.3e}")
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": int(s1.iters)},
            f"single form launches {counts}")


def ocp_refine_params(backend, target_err=OCP_FLEET_TARGET_ERR):
    """The mesh-refinement protocol on the sweep's SQP (``ocp_sweep_params``):
    refine to a dynamics error of ``target_err`` (the fleet's by default)
    in at most OCP_REFINE_ITER passes, tf guess 5, the driver's rescue and
    fail_fast on."""
    from smooth_feedback_tpu_torch.ocp import SolveOCPParams

    return SolveOCPParams(target_err=target_err, max_refine_iter=OCP_REFINE_ITER,
                          tf_guess=OCP_TF_GUESS, sqp=ocp_sweep_params(backend), rescue=True,
                          fail_fast=True)


def ocp_refine_run(dev, backend="cuda", dtype=torch.float32, B_=OCP_B, sync=None, mesh=OCP_MESH):
    """solve_ocp_flat_batch on the sweep's family (``ocp_sweep_flat``, the
    sweep's B velocities, x0's speeds OCP_REFINE_START) from
    ``Mesh.uniform(*mesh)`` with
    :func:`ocp_refine_params`, through the driver's own stage hook (the
    public entry point takes none).  ``sync`` runs before each stage's
    clock is read.  Returns ``((nlpsol, mesh, info), passes, make_flat,
    vels)``; each pass's record holds its mesh, the statuses, SQP and
    inner iterations and launch counts after its solve and after its rescue
    (counts set to 0 at the pass's start and after its solve), the number
    rescued, the per-interval fleet-max errors, the transfer's warm start
    and mesh, and each stage's seconds."""
    from smooth_feedback_tpu_torch.ocp import solve as osolve
    from smooth_feedback_tpu_torch.ocp.collocation import Mesh

    sync = sync or (lambda: None)
    make_flat = ocp_sweep_flat(dtype, dev, OCP_REFINE_START)
    vels = torch.as_tensor(ocp_sweep_velocities(B_), dtype=dtype, device=dev)
    passes = []

    def trace(stage, info):
        sync()
        now = time.perf_counter()
        if stage == "start":
            passes.append({"mesh": info["mesh"], "t": now})
            reset_counts()
            return
        p = passes[-1]
        p[stage + "_s"], p["t"] = now - p["t"], now
        if stage in ("solve", "rescue"):
            sol = info["nlpsol"]
            p[stage] = dict(status=sol.status.clone(), iters=sol.iters.clone(),
                            qp_iters=sol.qp_iters.clone(), launches=read_counts())
            p["n_rescued"] = info.get("n_rescued", 0)
            p["sol"] = sol
            reset_counts()
        elif stage == "error":
            p["errs"] = info["errs"].amax(dim=0).tolist()
        else:
            p.update(mesh_new=info["mesh_new"], z=info["z"], lam=info["lam"])

    out = osolve._solve_ocp_flat_batch_impl(make_flat, vels, Mesh.uniform(*mesh),
                                            ocp_refine_params(backend), dtype, dev, trace)
    return out, passes, make_flat, vels


def ocp_refine_errors_f64(vels, sol, mesh):
    """The fleet-max per-interval dynamics errors of the members'
    solutions ``sol`` on ``mesh`` (the refinement fleet's OCPs), evaluated
    as the driver does, in float64 on the CPU."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.nlp import NLPSolution
    from smooth_feedback_tpu_torch.ocp import nlpsol_to_ocpsol
    from smooth_feedback_tpu_torch.ocp.collocation import mesh_dyn_error

    make_flat = ocp_sweep_flat(torch.float64, "cpu", OCP_REFINE_START)
    d = lambda a: a.detach().to("cpu", torch.float64 if a.is_floating_point() else a.dtype)
    hi = mesh.increase_degrees()

    def one(th, s):
        flat = make_flat(th)
        o = nlpsol_to_ocpsol(flat, mesh, s)
        return mesh_dyn_error(hi, flat.f, 0.0, o.tf, o.x, o.u)

    return vmap(one)(d(vels), NLPSolution(*(d(a) for a in sol))).amax(dim=0)


def refine_branch(e, K, target):
    """What ``Mesh.refine_errors`` does to an interval of degree K with
    error e: None (kept) or the degree it aims at."""
    import math

    return None if e <= target else K + int(round(math.log(e / target) / math.log(K) + 1))


def ocp_refine_phase(dev):
    """The fleet refinement at B = 64, float32, every SQP subproblem of
    every pass and of its rescue through admm_problem.  Requires, against
    the JAX package's run on the same velocities and protocol: each pass's
    Optimal share after rescue at least JAX's; each pass's error estimate
    within OCP_REFINE_ERR_ATOL + OCP_REFINE_ERR_RTOL of its float64
    recomputation on the CPU; at least one refinement and at most
    OCP_REFINE_ITER passes, ending at a fleet-max error <=
    OCP_FLEET_TARGET_ERR (the pass count itself follows rounding, see
    OCP_JAX_REFINE_ERRS, and is printed beside JAX's with the intervals
    that took another branch); the returned mesh the one the solution was
    solved on; every Optimal member's KKT residual, recomputed in float64
    on the final mesh, <= OCP_TOL; each pass's launches equal to its
    lockstep iterations, admm_shared never.  Returns the launches (solves,
    rescues), the passes' records and the velocities."""
    from smooth_feedback_tpu_torch.ocp import nlp_layout
    from smooth_feedback_tpu_torch.qp.cuda_kernel import problem_route

    t0 = time.perf_counter()
    (sol, mesh, info), passes, make_flat, vels = ocp_refine_run(dev, sync=torch.cuda.synchronize)
    total = time.perf_counter() - t0
    flat0 = make_flat(vels[0])
    launches = {"ocp-refine": 0, "ocp-refine rescue": 0}
    good_launches = True
    for k, p in enumerate(passes):
        lay = nlp_layout(flat0, p["mesh"])
        n, m = lay.n, lay.m + lay.n
        s0, s1 = p["solve"], p["rescue"]
        lockstep = int(s0["iters"].max())
        opt0, opt1 = (float((s["status"] == 0).float().mean()) for s in (s0, s1))
        bar = OCP_JAX_REFINE_OPTIMAL[k] if k < len(OCP_JAX_REFINE_OPTIMAL) else 1.0
        err = max(p["errs"]) if "errs" in p else float("nan")
        launches["ocp-refine"] += s0["launches"]["admm_problem"]
        launches["ocp-refine rescue"] += s1["launches"]["admm_problem"]
        good_launches = (good_launches and s0["launches"] == {"admm_shared": 0, "admm_lane": 0, "admm_problem": lockstep}
                         and s1["launches"]["admm_shared"] == 0)
        phase("ocp-refine", f"pass {k}: mesh {p['mesh'].N_ivals} intervals / {p['mesh'].N_colloc} "
                            f"points (NLP n={lay.n}, m={lay.m}; QP n={n}, m={m}, {problem_route(n, m)[0]} "
                            f"route); Optimal {opt0 * 100:.3f}% after the solve, {opt1 * 100:.3f}% after "
                            f"rescuing {p['n_rescued']} (JAX, f32 CPU: {bar * 100:.3f}%); SQP iterations "
                            f"p50 {pct(s0['iters'], 50):.0f} max {lockstep}, qp_iters p50 "
                            f"{pct(s0['qp_iters'], 50):.0f} max {int(s0['qp_iters'].max())}; fleet-max "
                            f"dynamics error {err:.3e}; launches: solve {s0['launches']} in {lockstep} "
                            f"lockstep iterations, rescue {s1['launches']}; seconds: solve "
                            f"{p['solve_s']:.3f}, rescue {p['rescue_s']:.3f}, error estimate "
                            f"{p.get('error_s', float('nan')):.3f}, transfer "
                            f"{p.get('transfer_s', float('nan')):.3f}")
        require(opt1 >= bar, f"pass {k}: Optimal share after rescue {opt1:.5f} < JAX's {bar}")
        if "errs" in p:
            e64 = ocp_refine_errors_f64(vels, p["sol"], p["mesh"])
            de = (torch.tensor(p["errs"], dtype=torch.float64) - e64).abs()
            est_ok = bool((de <= OCP_REFINE_ERR_ATOL + OCP_REFINE_ERR_RTOL * e64).all())
            phase("ocp-refine", f"pass {k}: per-interval fleet-max errors {[f'{e:.4e}' for e in p['errs']]}, "
                                f"float64 on the CPU {[f'{e:.4e}' for e in e64.tolist()]}: largest "
                                f"difference {float(de.max()):.3e} (bound {OCP_REFINE_ERR_ATOL:g} + "
                                f"{OCP_REFINE_ERR_RTOL:g} x f64)")
            require(est_ok, f"pass {k}: the error estimate differs from its float64 recomputation")
    kkt64 = ocp_kkt_f64(vels, sol, mesh, OCP_REFINE_START)
    is_opt = (sol.status == 0).cpu()
    worst64 = float(kkt64[is_opt].max()) if bool(is_opt.any()) else 0.0
    jax_final = OCP_JAX_REFINE_MESHES[-1]
    same_mesh = len(mesh.intervals) == len(jax_final) and all(
        K == Kj and abs(t - tj) <= 1e-12 for (K, t), (Kj, tj) in zip(mesh.intervals, jax_final))
    phase("ocp-refine", f"{len(passes)} passes (JAX {len(OCP_JAX_REFINE_MESHES)}), errors "
                        f"{[float(f'{e:.4g}') for e in info.errors]} (target {OCP_FLEET_TARGET_ERR:g}), "
                        f"{total:.3f} s in all: {OCP_B / total:.3f} OCP solves/s; final mesh "
                        f"{[(K, round(t, 6)) for K, t in mesh.intervals]}; JAX's "
                        f"{[(K, round(t, 6)) for K, t in jax_final]}: equal {same_mesh}; Optimal "
                        f"members' KKT recomputed in float64 on the final mesh: max {worst64:.3e} (tol "
                        f"{OCP_TOL:g}); statuses {sol.status.tolist()}")
    if not same_mesh:
        for k, p in enumerate(passes[:-1]):
            if k >= len(OCP_JAX_REFINE_ERRS):
                break
            tgt = 0.1 * OCP_FLEET_TARGET_ERR
            for i, ((K, _), e, ej) in enumerate(zip(p["mesh"].intervals, p["errs"], OCP_JAX_REFINE_ERRS[k])):
                if refine_branch(e, K, tgt) != refine_branch(ej, K, tgt):
                    phase("ocp-refine", f"pass {k}, interval {i} (degree {K}): port error {e:.6e} -> "
                                        f"{refine_branch(e, K, tgt)}, JAX {ej:.6e} -> "
                                        f"{refine_branch(ej, K, tgt)} (threshold {tgt:g})")
    require(2 <= len(passes) <= OCP_REFINE_ITER, f"{len(passes)} passes")
    require(info.errors[-1] <= OCP_FLEET_TARGET_ERR, f"final fleet-max error {info.errors[-1]:.3e}")
    require(mesh == info.meshes[-1] and nlp_layout(flat0, mesh).n == sol.x.shape[1],
            "the returned mesh is not the one the solution was solved on")
    require(worst64 <= OCP_TOL, f"an Optimal member's float64 KKT residual is {worst64:.3e}")
    require(good_launches, "a pass's launches differ from its lockstep iterations, or admm_shared ran")
    return launches, passes, vels


def ocp_refine_kernel_phase(dev, passes, vels):
    """admm_problem against its plain version on the refined pass's first
    lockstep subproblem batch (B = 64, the streaming route), rebuilt from
    the transfer's warm start: the launch layout the built library takes
    there beside problem_route's; FIXED_ITERS iterations with every
    tolerance 0 judged relative to each member's scale
    (relative_fixed_check), and the path's own solve (compare_with_plain,
    noisy: statuses and counts against an f64 run), then its time against
    the plain version's and the bound.  Returns the worst absolute error
    and the shape."""
    import ctypes

    from smooth_feedback_tpu_torch import _build
    from smooth_feedback_tpu_torch._precision import ieee_f32_matmul
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda, admm_iterate_reference, per_problem_kernel_args
    from smooth_feedback_tpu_torch.qp import cuda_kernel as ck
    from smooth_feedback_tpu_torch.solvers import sqp

    p = passes[0]
    make = ocp_sweep_problem(p["mesh_new"], torch.float32, dev, OCP_REFINE_START)
    prm = dataclasses.replace(ocp_sweep_params("cuda"), max_iter=1)
    captured = {}
    with ieee_f32_matmul():
        sqp._solve_nlp_sqp_batch_impl(make, vels, p["z"], prm, p["lam"],
                                      lambda s, i: captured.update(i) if s == "qp" else None)
    qp, ws, qprm = captured["qp"], captured["ws"], prm.qp
    n, m, B_ = qp.A.shape[-1], qp.A.shape[-2], qp.A.shape[0]
    smem = ctypes.c_int(0)
    resident = _build.load().admm_problem_route(n, m, ck.PROBLEM_WARPS, ctypes.byref(smem))
    route = "resident" if resident else "streaming"
    phase("layout", f"admm_problem at the refined pass's n={n}, m={m}: {route} route, {smem.value} "
                    f"bytes of shared memory a block (problem_route: {ck.problem_route(n, m)})")
    require((route, smem.value) == ck.problem_route(n, m), "problem_route does not mirror the library")
    label = f"ocp-refine ({n}, {m}) B={B_}, pass 1, lockstep iteration 1"
    warm = per_problem_kernel_args(qp, None, ws, qprm)
    worst = relative_fixed_check(admm_iterate_cuda, warm, qprm, FIXED_ITERS, label)
    err, k = compare_with_plain(f"{label}, warm solve", admm_iterate_cuda, qprm, warm, qp, noisy=True)
    row = (time_ms(lambda: admm_iterate_cuda(qprm, *warm), 5),
           time_ms(lambda: admm_iterate_reference(qprm, *warm), 1), *bound(warm, k, qprm))
    single = time_single_ms(lambda: admm_iterate_cuda(qprm, *warm), 5)
    phase("kernel", f"{label}, warm solve: kernel {row[0]:.4f} ms (mean of back-to-back calls) "
                    f"[{single:.4f} ms, median of single launches], plain {row[1]:.4f} ms, mean "
                    f"{float(k[4].float().mean()):.1f} iterations; bound {row[2]:.6f} ms ({row[3]}, "
                    f"{100 * row[2] / row[0]:.2f}%)")
    return max(worst, err), (n, m)


def ocp_solve_run(dev, backend="cuda", dtype=torch.float32):
    """solve_ocp (flatten, refine, unflatten) on :func:`ocp_example` with
    the refinement protocol.  Returns ``(sol, mesh, info, x(0))``."""
    from smooth_feedback_tpu_torch.ocp import solve_ocp
    from smooth_feedback_tpu_torch.ocp.collocation import Mesh

    ocp, xl, ul = ocp_example(dtype, dev)
    sol, mesh, info = solve_ocp(ocp, xl, ul, Mesh.uniform(*OCP_MESH),
                                ocp_refine_params(backend, OCP_TARGET_ERR), dtype=dtype, device=dev)
    return sol, mesh, info, sol.x(torch.zeros((), dtype=dtype, device=dev))


def ocp_solve_phase(dev):
    """The single-problem driver on examples/ocp_se2_nlp.py's OCP, f32 on
    the card: Optimal in JAX's pass count (f32, CPU, the same protocol),
    the final error <= OCP_TARGET_ERR, x(0) on the group within 1e-4 of the
    fixed initial pose and velocity, one admm_problem launch at B = 1 per
    SQP iteration.  Returns the launches and the subproblems' shapes."""
    from smooth_feedback_tpu_torch.ocp import flatten_ocp, nlp_layout

    reset_counts()
    t0 = time.perf_counter()
    sol, mesh, info, x0 = ocp_solve_run(dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    want = torch.tensor([0.0, 0.0, 1.0, 0.0, 1.0, 0.0], dtype=x0.dtype, device=x0.device)
    dx0 = float((x0 - want).abs().max())
    flat = flatten_ocp(*ocp_example(torch.float32, dev))
    shapes = [(lay.n, lay.m + lay.n) for lay in (nlp_layout(flat, q) for q in info.meshes)]
    phase("ocp-solve", f"solve_ocp on examples/ocp_se2_nlp.py's OCP, float32: status "
                       f"{info.status.name}, {len(info.meshes)} passes (JAX, f32 CPU: "
                       f"{OCP_JAX_SOLVE_PASSES}), meshes {[(q.N_ivals, q.N_colloc) for q in info.meshes]}, "
                       f"SQP iterations {info.nlp_iters}, errors "
                       f"{[float(f'{e:.4g}') for e in info.errors]}; QP shapes {shapes}; x(0) "
                       f"{x0.tolist()}, "
                       f"{dx0:.3e} from the fixed start; launches {counts}; {secs:.3f} s")
    require(info.status == 0, "solve_ocp did not end Optimal")
    require(len(info.meshes) == OCP_JAX_SOLVE_PASSES, "solve_ocp's pass count differs from JAX's")
    require(info.errors[-1] <= OCP_TARGET_ERR, f"solve_ocp's final error {info.errors[-1]:.3e}")
    require(dx0 <= 1e-4, f"x(0) lies {dx0:.3e} from the fixed initial state")
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": sum(info.nlp_iters)},
            f"solve_ocp launches {counts} != {sum(info.nlp_iters)} SQP iterations")
    return counts, shapes


def ocp_qp_params(backend, polish=True):
    """The example's QP parameters (max_iter 20000, polish) at eps OCP_QP_EPS."""
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    return QPSolverParams(eps_abs=OCP_QP_EPS, eps_rel=OCP_QP_EPS, max_iter=20000, polish=polish,
                          backend=backend)


def ocp_qp_run(dev, backend, dtype=torch.float32):
    """ocp_to_qp, solve_qp with :func:`ocp_qp_params` on ``backend``,
    qpsol_to_ocpsol, and x(t) at the example's 6 sample times.  Returns
    ``(sol, xs, qp)``."""
    from smooth_feedback_tpu_torch.ocp import ocp_to_qp, qpsol_to_ocpsol
    from smooth_feedback_tpu_torch.qp import solve_qp

    ocp, mesh, tf, xl, ul, dxl = ocp_qp_problem(dtype, dev)
    qp = ocp_to_qp(ocp, mesh, tf, xl, ul, dxl, dtype=dtype, device=dev)
    sol = solve_qp(qp, ocp_qp_params(backend))
    osol = qpsol_to_ocpsol(ocp, mesh, sol, tf, xl, ul)
    ts = torch.linspace(0.0, tf, 6, dtype=dtype, device=dev)
    return sol, torch.stack([osol.x(t) for t in ts]), qp


def ocp_qp_phase(dev):
    """examples/ocp_se2_qp.py's round trip on the card: Optimal through one
    admm_problem launch, and x(t) at the 6 sample times within 1e-4 of its
    scale plus twice the f32 torch route's distance from the f64 one (the
    measured f32 noise) of the same run on the torch loop.  Then the kernel
    against its plain version on that launch's inputs (B = 1, the streaming
    route), polish aside (the same float64 step on both routes): FIXED_ITERS
    iterations with every tolerance 0 (relative_fixed_check) and the solve
    itself (compare_with_plain: status and iteration count against the
    plain version's and the f64 run's, the Optimal point re-checked in
    f64), and the kernel's time on it beside the plain version's and the
    bound.  Returns the launches, the QP's shape and the worst error."""
    from smooth_feedback_tpu_torch.qp import (
        QuadraticProgram, admm_iterate_cuda, admm_iterate_reference, per_problem_kernel_args,
    )

    reset_counts()
    t0 = time.perf_counter()
    sol, xs, qp = ocp_qp_run(dev, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    sol_t, xs_t, _ = ocp_qp_run(dev, "torch")
    sol_d, xs_d, _ = ocp_qp_run(dev, "torch", torch.float64)
    dx = float((xs - xs_t).abs().max())
    floor = float((xs_t.double() - xs_d).abs().max())
    scale = max(1.0, float(xs_d.abs().max()))
    n, m = sol.primal.shape[0], sol.dual.shape[0]
    phase("ocp-qp", f"examples/ocp_se2_qp.py (n_ival {OCP_QP_IVALS}, QP n={n} m={m}, "
                    f"eps {OCP_QP_EPS:g}): "
                    f"status kernel {int(sol.status)}, torch {int(sol_t.status)}, f64 torch "
                    f"{int(sol_d.status)}; iterations {int(sol.iters)}, {int(sol_t.iters)}, "
                    f"{int(sol_d.iters)}; max |x_kernel(t) - x_torch(t)| at 6 times {dx:.3e} (f32 "
                    f"torch - f64 torch {floor:.3e}, scale {scale:.3e}; bound 1e-4 x scale + 2 x "
                    f"floor); launches {counts}; {secs:.3f} s")
    require(int(sol.status) == 0 and int(sol_t.status) == 0, "the QP round trip is not Optimal")
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": 1}, f"ocp-qp launches {counts}")
    require(dx <= 1e-4 * scale + 2 * floor, "the kernel route's x(t) differs beyond the bound")
    qp1 = QuadraticProgram(*(a[None] for a in qp))
    qprm = ocp_qp_params("cuda", polish=False)
    args = per_problem_kernel_args(qp1, None, None, qprm)
    label = f"ocp-qp ({n}, {m}) B=1"
    worst = relative_fixed_check(admm_iterate_cuda, args, qprm, FIXED_ITERS, label)
    err, k = compare_with_plain(f"{label}, the path's solve before polish", admm_iterate_cuda, qprm,
                                args, qp1)
    require(int(k[4][0]) == int(sol.iters), "the checked solve is not the path's launch")
    row = (time_ms(lambda: admm_iterate_cuda(qprm, *args), 20),
           time_ms(lambda: admm_iterate_reference(qprm, *args), 3), *bound(args, k, qprm))
    phase("kernel", f"{label}, the path's solve: kernel {row[0]:.4f} ms, plain {row[1]:.4f} ms "
                    f"(means of back-to-back calls), {int(k[4][0])} iterations; bound "
                    f"{row[2]:.6f} ms ({row[3]})")
    return counts, (n, m), max(worst, err)


def shared_route_problem(n=SHARED_ROUTE_N, B_=SHARED_ROUTE_B, seed=SEED):
    """numpy ``(P, q, A, l, u)`` of a shared-factor batch (P and A with a
    leading axis of 1): P = M M'/n + I, A ~ N(0, 1/n), per-member q ~ N(0, 1)
    and box bounds -l = u ~ 0.5 + U(0, 1)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    A = rng.standard_normal((n, n)) / np.sqrt(n)
    q = rng.standard_normal((B_, n))
    u = 0.5 + rng.random((B_, n))
    return P[None], q, A[None], -u, u


def shared_route_phase(dev):
    """Shared factors at n = m = 160, past the shared kernel's shapes: on
    backend "cuda" the torch shared loop runs on the card, nothing is
    launched, and statuses and iteration counts equal backend "torch"'s."""
    from smooth_feedback_tpu_torch.convert import qp_from_numpy
    from smooth_feedback_tpu_torch.qp import QPSolverParams, qp_factorize, solve_qp_batch
    from smooth_feedback_tpu_torch.qp import cuda_kernel as ck, solver as qsolver

    qp = qp_from_numpy(shared_route_problem(), dev, torch.float32)
    n = qp.P.shape[-1]
    factors = qp_factorize(qp._replace(q=qp.q[:1], l=qp.l[:1], u=qp.u[:1]))
    factors = type(factors)(*(a[0] for a in factors))
    fall0 = qsolver.shared_fallthroughs
    reset_counts()
    k = solve_qp_batch(qp, QPSolverParams(backend="cuda", polish=False), factors=factors)
    counts, falls = read_counts(), qsolver.shared_fallthroughs - fall0
    r = solve_qp_batch(qp, QPSolverParams(backend="torch", polish=False), factors=factors)
    phase("shared-route", f"shared factors at n=m={n}, B={qp.q.shape[0]} on backend cuda: "
                          f"shared_kernel_fits {ck.shared_kernel_fits(n, n, 8)}, route: torch shared "
                          f"loop on the card ({falls} fall-through, launches {counts}); statuses "
                          f"{k.status.tolist()} iters {k.iters.tolist()} (backend torch "
                          f"{r.status.tolist()} {r.iters.tolist()})")
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": 0} and falls == 1,
            "the shared route launched a kernel")
    require(torch.equal(k.status, r.status) and torch.equal(k.iters, r.iters),
            "the shared route differs from backend torch")


# ------------------------------------------- lane (benchmarks/qp_bench.py)


LANE_B = 256  # qp_bench.py's throughput sweep batch
LANE_SHAPES = (8, 32, 96)  # its lane column's n = m (density 0.3)
LANE_DENSITY = 0.3
LANE_ADAPTIVE_SHAPE = (3, 24)  # tests/test_qp.py's lane f32 and adaptive-rho shape
LANE_FALLTHROUGH_N = 128


def lane_family(n, m, B_, density, seed):
    """numpy ``(P, q, A, l, u)`` of qp_bench.py's problems (the JAX package's
    random_qp): P = M M' with M masked to ``density``, q and A ~ N(0, 1),
    bounds A x0 -+ (|N(0, 1)| + 0.1) for x0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B_, n, n)) * (rng.random((B_, n, n)) < density)
    A = rng.standard_normal((B_, m, n))
    center = np.einsum("bmn,bn->bm", A, rng.standard_normal((B_, n)))
    spread = np.abs(rng.standard_normal((B_, m))) + 0.1
    return M @ M.transpose(0, 2, 1), rng.standard_normal((B_, n)), A, center - spread, center + spread


def lane_phase(dev):
    """qp_bench.py's f32 lane column on the card: B = 256 fresh problems at
    n = m in LANE_SHAPES (density 0.3) with QPSolverParams(max_iter=4000,
    backend="lane") as qp_bench.py:85, then (3, 24) with adaptive rho and
    compensated checks.  Each: one solve_qp_batch through the route (one
    launch, statuses), the kernel against its plain version and an f64 run
    on the launch's inputs (lane_compare), times and bound.  Then n = m =
    128, which the kernel cannot hold: the plain loop on the card, one
    fall-through counted, nothing launched.  Returns the launches of the
    route's solves, the worst error and the shapes."""
    from smooth_feedback_tpu_torch.convert import qp_from_numpy
    from smooth_feedback_tpu_torch.qp import (
        QPSolverParams, admm_solve_cuda_lane, admm_solve_lane_reference, lane_kernel_args,
        solve_qp_batch,
    )
    from smooth_feedback_tpu_torch.qp import solver as qsolver

    cases = [((n, n), QPSolverParams(max_iter=4000, backend="lane")) for n in LANE_SHAPES]
    cases.append((LANE_ADAPTIVE_SHAPE, QPSolverParams(max_iter=4000, backend="lane",
                                                      adaptive_rho=True, compensated_check=True)))
    worst, shapes, launches = 0.0, [], 0
    for (n, m), prm in cases:
        qp = qp_from_numpy(lane_family(n, m, LANE_B, LANE_DENSITY, SEED + n), dev, torch.float32)
        reset_counts()
        sweeps = qsolver.lane_ruiz_sweeps
        sol = solve_qp_batch(qp, prm)
        counts, sweeps = read_counts(), qsolver.lane_ruiz_sweeps - sweeps
        launches += counts["admm_lane"]
        require(counts == {"admm_shared": 0, "admm_problem": 0, "admm_lane": 1} and sweeps == 0,
                f"lane ({n}, {m}): launches {counts}, torch Ruiz sweeps {sweeps}")
        args = lane_kernel_args(qp)
        label = f"lane ({n}, {m})" + (" adaptive, compensated" if prm.adaptive_rho else "")
        err, k = lane_compare(label, args, prm)
        worst = max(worst, err)
        ms = time_ms(lambda: admm_solve_cuda_lane(prm, *args), 10)
        single = time_single_ms(lambda: admm_solve_cuda_lane(prm, *args), 10)
        plain_ms = time_ms(lambda: admm_solve_lane_reference(prm, *args), 1)
        bound_ms, bound_by = lane_bound(args, k, prm)
        opt = float((sol.status == 0).float().mean())
        phase("lane", f"{label}, B={LANE_B}: solve_qp_batch Optimal {opt * 100:.2f}% (polished), "
                      f"launches {counts}, torch Ruiz sweeps {sweeps}; kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms (means of back-to-back calls; median of single kernel "
                      f"launches {single:.4f} ms), mean iters "
                      f"{float(k.iters.float().mean()):.2f}, max {int(k.iters.max())}, bound "
                      f"{bound_ms:.6f} ms ({bound_by})")
        if prm.adaptive_rho:
            lane_clock_split(label, args, prm, k)
        shapes.append(f"B={LANE_B} n={n} m={m}")

    n = LANE_FALLTHROUGH_N
    qp = qp_from_numpy(lane_family(n, n, 4, LANE_DENSITY, SEED + n), dev, torch.float32)
    falls = qsolver.lane_fallthroughs
    reset_counts()
    sol = solve_qp_batch(qp, QPSolverParams(max_iter=4000, backend="lane", polish=False))
    counts, falls = read_counts(), qsolver.lane_fallthroughs - falls
    phase("lane", f"n=m={n}, B=4 (the kernel cannot hold it): {falls} fall-through, launches "
                  f"{counts}, statuses {sol.status.tolist()} on the plain loop on the card")
    require(counts == {"admm_shared": 0, "admm_problem": 0, "admm_lane": 0} and falls == 1,
            "the lane fall-through launched a kernel or was not counted")
    return launches, worst, shapes


# -------------------------------------------------------- PID and splines


def pid_spline_phase(dev):
    """examples_torch/pid_se2.py on the card (float32, 2000 steps at dt =
    0.01): the final tracking error below 0.05; and fit_spline / spline_eval
    on SE(2) and SO(3) knots in float32 on the card against the CPU float64
    port."""
    from examples_torch import pid_se2
    from smooth_feedback_tpu_torch.groups import SE2, SO3
    from smooth_feedback_tpu_torch.utils import fit_spline, spline_eval

    kw = dict(dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    errs = pid_se2.run(PID_STEPS, **kw)["errs"].tolist()
    phase("pid-spline", f"PID on SE(2), {PID_STEPS} steps at dt={PID_DT}: error {errs[0]:.4f} -> "
                        f"{errs[-1]:.6f} (bound 0.05), {time.perf_counter() - t0:.3f} s")
    require(errs[-1] < 0.05, f"PID final error {errs[-1]}")

    # knots exp(0.5 N(0, I)) at uneven times; times inside, at knots, past the end
    ts = [0.0, 0.7, 1.5, 2.0, 3.1]
    times = [0.05, 0.3, 0.7, 1.2, 1.99, 2.6, 3.05, 3.5]
    rng = np.random.default_rng(SEED)
    for name, G in (("SE(2)", SE2), ("SO(3)", SO3)):
        gs = torch.func.vmap(G.exp)(torch.as_tensor(0.5 * rng.standard_normal((len(ts), G.ndof))))
        for c2 in (False, True):
            sp, sp64 = fit_spline(G, ts, gs.to(**kw), c2=c2), fit_spline(G, ts, gs, c2=c2)
            err = [0.0, 0.0, 0.0]
            for t in times:
                for j, (a, b) in enumerate(zip(spline_eval(G, sp, t), spline_eval(G, sp64, t))):
                    err[j] = max(err[j], float((a.double().cpu() - b).abs().max()))
            phase("pid-spline", f"{name} spline, c2={c2}: card f32 against the CPU f64 port at "
                                f"{len(times)} times: max |dg| {err[0]:.3e}, |dv| {err[1]:.3e}, "
                                f"|da| {err[2]:.3e} (bounds {SPLINE_TOL})")
            require(all(e <= b for e, b in zip(err, SPLINE_TOL)), f"{name} spline differs")


# ----------------------------------------------- the examples (examples_torch/)

# Examples 1-9 of examples_torch/ (those no earlier phase runs), each at its
# own width: horizon, fleet, mesh, state and input dimensions as the JAX
# example's.  A closed loop runs EX_STEPS[name][0] of its default
# EX_STEPS[name][1] steps where the default would not fit the smoke's time
# (seconds a step on the H100 at 700 W: the SE(3) MPC 0.40-0.48, the
# vehicle MPC + ASIF 1.66-1.90, the double-integrator ASIF 0.15-0.24, the
# condensed MPC 0.016-0.017, the EKF fleet 0.07-0.09; the smoke took 696 s
# on one host and 908 s on another with deeper cuts, and 870 s on the
# second with SE(3) MPC 40 and vehicle 8 steps).
EX_STEPS = {
    "mpc_se3_rigidbody": (24, 300),
    "mpc_doubleintegrator": (400, 1200),
    "asif_doubleintegrator": (40, 500),
    "mpc_asif_vehicle": (6, 800),
    "ekf_se2_localization": (200, 200),
    "ekf_fleet_se2": (100, 200),
}
# Each closed loop's first EX_CPU_STEPS steps (each OCP example whole) run
# again on the CPU in float64 (the torch loop) and in float32 (the kernel
# routes' plain versions): the card's float32 states may lie from the
# float64 run's at most EX_F32_FACTOR times as far as the CPU's float32
# states do, plus EX_X_ATOL.  The floor is the problem's own: the EKF
# examples' first update inverts H P H' + R with P = I and R = 0.001 I,
# condition ~3e4, so float32 lands ~5e-4 from float64 on any device.
EX_CPU_STEPS = 3
EX_F32_FACTOR = 10.0
EX_X_ATOL = 1e-6
# the kernels are held at the QPs of a loop's first EX_KERNEL_STEPS states,
# a single QP as a family of EX_FAMILY members (as_family)
EX_KERNEL_STEPS = 8
EX_FAMILY = 16
# the SE(3) fleet's refinement: the example's B, target and pass limit
EX_SE3_B = 8


def example_line(name, secs, steps, merit, counts):
    phase("examples", f"{name}: {secs:.3f} s, {steps}, {merit}, launches {counts}")


def held_to_f64(name, card, run_cpu):
    """The card's float32 states ``card`` against the float64 CPU run's:
    ``run_cpu(dtype)`` runs the example on the CPU and returns the same
    states; the bound is EX_F32_FACTOR x the CPU float32 run's distance
    from float64 + EX_X_ATOL."""
    ref = run_cpu(torch.float64).double()
    floor = float((run_cpu(torch.float32).double() - ref).abs().max())
    dx = float((card.double().cpu() - ref).abs().max())
    bound = EX_F32_FACTOR * floor + EX_X_ATOL
    phase("examples", f"{name}: float32 on the card against float64 on the CPU, max |dx| "
                      f"{dx:.3e} (float32 on the CPU {floor:.3e}; bound {EX_F32_FACTOR:g} x that + "
                      f"{EX_X_ATOL:g})")
    require(dx <= bound, f"{name}: the card's trajectory differs from float64's by {dx:.3e}")


def cpu_backend(dtype, route):
    """The CPU run's backend: the example's kernel ``route`` (its plain
    version on CPU tensors) in float32, the torch loop in float64."""
    return route if dtype == torch.float32 else "torch"


def first_member(args, B_):
    return tuple(a[:1].contiguous() if a is not None and a.dim() and a.shape[0] == B_ else a
                 for a in args)


def example_kernel(label, wrapper, args, qps, prm, worst, shape, family=None):
    """A kernel ``wrapper`` (admm_problem's or admm_shared's) at an
    example's QP batch against its plain version, after its fixed-iteration
    check (whose worst error is ``worst``): the solve (compare_with_plain,
    noisy: statuses and counts against the float64 run; where every member
    runs to max_iter in both versions, f64_distance_check, on ``family``'s
    arguments where a single QP was widened by :func:`as_family`), member 0
    alone equal to its batched result, and member 0's launch timed.
    Returns the worst error, the row and ``shape``."""
    from smooth_feedback_tpu_torch.qp import QPSolutionStatus, admm_iterate_reference

    k = wrapper(prm, *args)
    r = admm_iterate_reference(prm, *args)
    MAX_ITER = int(QPSolutionStatus.MaxIterations)
    stuck = bool((k[3] == MAX_ITER).all() and (r[3] == MAX_ITER).all())
    if stuck:
        # every member runs to max_iter in both (the SQP's first subproblem,
        # lambda = 0): held to the float64 run as the output-feedback MPC is
        what = f"{label}, solve (max_iter in both)"
        if family is None:
            k = f64_distance_check(wrapper, args, prm, what, k, r)
        else:
            f64_distance_check(wrapper, family, prm, f"{what}, its family")
    else:
        # converged solves: the path's own QPs (a family's near-equal
        # members stop at one check or another together, by rounding)
        err, k = compare_with_plain(f"{label}, solve", wrapper, prm, args, qps, noisy=True,
                                    k=k, r=r)
        worst = max(worst, err)
    one = first_member(args, shape[0])
    k1 = wrapper(prm, *one)
    require(all(torch.equal(a, b[:1]) for a, b in zip(k1, k)),
            f"{label}: member 0 alone differs from its batched result")
    # a plain solve to max_iter takes about a second: one timed call
    row = (time_ms(lambda: wrapper(prm, *one), 10),
           time_ms(lambda: admm_iterate_reference(prm, *one), 1 if stuck else 2),
           *bound(one, k1, prm), time_single_ms(lambda: wrapper(prm, *one), 10))
    phase("kernel", f"{label}: member 0's solve at B=1: kernel {row[0]:.4f} ms, plain {row[1]:.4f} "
                    f"ms (means of back-to-back calls; median of single kernel launches "
                    f"{row[4]:.4f} ms), {int(k1[4][0])} iterations; bound {row[2]:.6f} ms "
                    f"({row[3]})")
    return worst, row, shape


def as_family(qps, ws):
    """A single QP (batch of one) and its warm start ``ws`` as a family of
    EX_FAMILY members: itself first, then copies whose q is scaled
    elementwise by 1 + 1e-3 N(0, 1) (numpy seed SEED), each from the same
    warm start.  One member's float32 distance from float64 is a single
    draw of rounding noise (one solve at B = 1 put the kernel's at 4.8 x
    the plain version's in x and 0.59 x in y): the family gives the checks
    of iterates a distribution over members at the path's shape."""
    from smooth_feedback_tpu_torch.qp import QPSolution, QuadraticProgram

    rng = np.random.default_rng(SEED)
    rep = lambda a: a.expand(EX_FAMILY, *a.shape[1:]).contiguous()
    scale = torch.as_tensor(1.0 + 1e-3 * rng.standard_normal((EX_FAMILY - 1, qps.q.shape[-1])),
                            dtype=qps.q.dtype, device=qps.q.device)
    fam = QuadraticProgram(rep(qps.P), torch.cat([qps.q, qps.q * scale]), rep(qps.A), rep(qps.l),
                           rep(qps.u))
    return fam, None if ws is None else QPSolution(*(rep(a) for a in ws))


def example_problem_kernel(label, qps, prm, fixed=FIXED_ITERS, ws=None):
    """admm_problem at an example's QP batch (warm start ``ws``): the
    launch layout against problem_route, ``fixed`` iterations with every
    tolerance 0 judged against float64 relative to each member's scale
    (relative_fixed_check; a single QP widened by :func:`as_family`), then
    :func:`example_kernel` on the path's own QPs."""
    import ctypes

    from smooth_feedback_tpu_torch import _build
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda, per_problem_kernel_args
    from smooth_feedback_tpu_torch.qp import cuda_kernel as ck

    n, m, B_ = qps.A.shape[-1], qps.A.shape[-2], qps.A.shape[0]
    args = per_problem_kernel_args(qps, None, ws, prm)
    family = None
    if B_ == 1:
        fq, fws = as_family(qps, ws)
        family = per_problem_kernel_args(fq, None, fws, prm)
    label = f"{label} ({n}, {m}) B={B_}"
    smem = ctypes.c_int(0)
    resident = _build.load().admm_problem_route(n, m, ck.PROBLEM_WARPS, ctypes.byref(smem))
    route = ("resident" if resident else "streaming", smem.value)
    phase("layout", f"admm_problem at {label}: {route[0]} route, {route[1]} bytes of shared "
                    f"memory a block (problem_route: {ck.problem_route(n, m)})")
    require(route == ck.problem_route(n, m), "problem_route does not mirror the library")
    worst = relative_fixed_check(admm_iterate_cuda, args if family is None else family, prm, fixed,
                                 label if family is None else f"{label}, its family of {EX_FAMILY}")
    return example_kernel(label, admm_iterate_cuda, args, qps, prm, worst, (B_, n, m), family)


def example_lane_kernel(label, qps, prm, dev):
    """admm_lane at an example's ASIF QP batch against its plain version:
    FIXED_ITERS iterations from a seeded random warm start (an input
    already safe makes the cold start exact) and the cold solve
    (lane_compare), member 0's launch timed (back to back, a B = 1 launch
    runs at the host's pace; the row's last time is the median of single
    launches).  Returns the worst error, the row and the shape."""
    from smooth_feedback_tpu_torch.qp import (
        admm_solve_cuda_lane, admm_solve_lane_reference, lane_kernel_args,
    )

    n, m, B_ = qps.A.shape[-1], qps.A.shape[-2], qps.A.shape[0]
    label = f"{label} ({n}, {m}) B={B_}"
    cold = lane_kernel_args(qps)
    worst = lane_fixed_check(cold, prm, label)
    err, k = lane_compare(f"{label}, cold", cold, prm)
    one = first_member(cold, B_)
    k1 = admm_solve_cuda_lane(prm, *one)
    row = (time_ms(lambda: admm_solve_cuda_lane(prm, *one), 20),
           time_ms(lambda: admm_solve_lane_reference(prm, *one), 3), *lane_bound(one, k1, prm),
           time_single_ms(lambda: admm_solve_cuda_lane(prm, *one), 20))
    phase("kernel", f"{label}: member 0's solve at B=1: kernel {row[0]:.4f} ms, plain "
                    f"{row[1]:.4f} ms (means of back-to-back calls; median of single kernel "
                    f"launches {row[4]:.4f} ms), {int(k1.iters[0])} iterations; bound "
                    f"{row[2]:.6f} ms ({row[3]})")
    return max(worst, err), row, (B_, n, m)


def example_mpc_se3(dev):
    """examples_torch/mpc_se3_rigidbody.py: the SE(3) x R^6 hover MPC (K =
    8, QP per step through admm_problem), the first card run of MPC on
    SE(3).  The example's assertions (every QP Optimal; the hover error
    falling), its states held to float64, the kernel at the loop's QPs."""
    from torch.func import vmap
    from examples_torch import mpc_se3_rigidbody as ex
    from smooth_feedback_tpu_torch.qp import QPSolverParams

    name = "mpc_se3_rigidbody"
    steps, default = EX_STEPS[name]
    reset_counts()
    t0 = time.perf_counter()
    out = ex.run(steps, device=dev)
    torch.cuda.synchronize()
    secs, counts = time.perf_counter() - t0, read_counts()
    opt = float((out["statuses"] == 0).float().mean())
    errs = out["errs"].tolist()
    example_line(name, secs, f"{steps} of {default} steps", f"Optimal {opt * 100:.3f}%, hover error "
                 f"{errs[0]:.4f} -> {errs[-1]:.4f}", counts)
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": steps}, f"{name} launches")
    require(opt == 1.0, f"{name}: a QP was not Optimal")
    require(errs[-1] < errs[0], f"{name}: the hover error did not fall")
    held_to_f64(name, out["xs"][:EX_CPU_STEPS], lambda dt: ex.run(
        EX_CPU_STEPS, device="cpu", dtype=dt, backend=cpu_backend(dt, "cuda"))["xs"])
    step, _, _, x0 = ex.build(device=dev)
    states = torch.cat([x0[None], out["xs"][:EX_KERNEL_STEPS - 1]])
    ts = ex.DT * torch.arange(EX_KERNEL_STEPS, dtype=torch.float32, device=dev)
    qps = vmap(step.transcribe)(ts, states)
    return counts, example_problem_kernel(name, qps, QPSolverParams(polish=False, backend="cuda"))


def example_mpc_di(dev):
    """examples_torch/mpc_doubleintegrator.py: the condensed K = 20 MPC at
    B = 1 (one admm_shared launch a step): the example's assertion (> 95 %
    Optimal), its states held to float64, the kernel at the condensed QPs
    of the loop's first states."""
    from examples_torch import mpc_doubleintegrator as ex
    from smooth_feedback_tpu_torch.qp import (
        QPSolverParams, admm_iterate_cuda_shared, shared_kernel_args,
    )

    name = "mpc_doubleintegrator"
    steps, default = EX_STEPS[name]
    reset_counts()
    t0 = time.perf_counter()
    out = ex.run(steps, device=dev)
    torch.cuda.synchronize()
    secs, counts = time.perf_counter() - t0, read_counts()
    opt = float((out["statuses"] == 0).float().mean())
    ts = (np.arange(steps) + 1) * ex.DT
    err = np.abs(out["xs"][:, 0].double().cpu().numpy() + 0.5 * np.sin(0.3 * ts))
    example_line(name, secs, f"{steps} of {default} steps", f"Optimal {opt * 100:.3f}%, tracking "
                 f"error after the transient {err[min(200, steps // 2):].max():.4f}", counts)
    require(counts == {"admm_shared": steps, "admm_lane": 0, "admm_problem": 0}, f"{name} launches")
    require(opt > 0.95, f"{name}: Optimal share {opt}")
    held_to_f64(name, out["xs"][:EX_CPU_STEPS], lambda dt: ex.run(
        EX_CPU_STEPS, device="cpu", dtype=dt, backend=cpu_backend(dt, "cuda"))["xs"])
    step, _ = ex.build(device=dev)
    states = torch.cat([torch.tensor([[1.0, 0.0]], device=dev), out["xs"][:EX_KERNEL_STEPS - 1]])
    prm = QPSolverParams(polish=False, max_iter=300, backend="cuda")
    qps = step.condensed_qp(0.0, states)
    args = shared_kernel_args(qps, step.factors)
    n, m, B_ = step.factors.Minv.shape[0], step.factors.As.shape[0], len(states)
    label = f"{name} condensed ({n}, {m}) B={B_}"
    worst = fixed_iteration_check(admm_iterate_cuda_shared, args, prm, label)
    return counts, example_kernel(label, admm_iterate_cuda_shared, args, qps, prm, worst,
                                  (B_, n, m))


def example_asif_di(dev):
    """examples_torch/asif_doubleintegrator.py: the ASIF (K = 30) on the
    lane route (one admm_lane launch a step): the example's assertion
    (position >= -0.05), its states held to float64, admm_lane at the
    filter QPs of the loop's first states."""
    from examples_torch import asif_doubleintegrator as ex
    from smooth_feedback_tpu_torch.controllers import asif_to_qp
    from smooth_feedback_tpu_torch.qp import QuadraticProgram
    from smooth_feedback_tpu_torch.qp import solver as qsolver

    name = "asif_doubleintegrator"
    steps, default = EX_STEPS[name]
    reset_counts()
    sweeps = qsolver.lane_ruiz_sweeps
    t0 = time.perf_counter()
    out = ex.run(steps, device=dev)
    torch.cuda.synchronize()
    secs, counts = time.perf_counter() - t0, read_counts()
    require(qsolver.lane_ruiz_sweeps == sweeps, f"{name}: Ruiz sweeps ran in torch")
    opt = float((out["statuses"] == 0).float().mean())
    pmin = float(out["xs"][:, 0].min())
    example_line(name, secs, f"{steps} of {default} steps", f"Optimal {opt * 100:.3f}%, min "
                 f"position {pmin:+.4f}, final {out['xs'][-1].tolist()}", counts)
    require(counts == {"admm_shared": 0, "admm_lane": steps, "admm_problem": 0}, f"{name} launches")
    require(pmin > -0.05, f"{name}: min position {pmin}")
    held_to_f64(name, out["xs"][:EX_CPU_STEPS], lambda dt: ex.run(
        EX_CPU_STEPS, device="cpu", dtype=dt, backend=cpu_backend(dt, "lane"))["xs"])
    _, _, prm, pc = ex.build(device=dev)
    states = torch.cat([torch.tensor([[2.0, 0.0]], device=dev), out["xs"][:EX_KERNEL_STEPS - 1]])
    u_des = torch.tensor([-1.0], device=dev)
    qps = QuadraticProgram(*(torch.stack(a) for a in zip(*(
        asif_to_qp(ex.X, ex.U, prm.asif, prm.T, x, u_des, pc["W_u"], pc["ulim"], ex.f, pc["h"],
                   pc["bu"]) for x in states))))
    return counts, example_lane_kernel(name, qps, prm.qp, dev)


def example_vehicle(dev):
    """examples_torch/mpc_asif_vehicle.py: the sparse MPC (K = 30, one
    admm_problem launch a step, (262, 262) as the output-feedback loop's)
    and the ASIF (K = 50, alpha 1, relax_cost 100, static rho: one
    admm_lane launch a step): the barrier positive, the states held to
    float64, admm_lane at the filter QPs of the loop's first states."""
    from examples_torch import mpc_asif_vehicle as ex
    from smooth_feedback_tpu_torch.controllers import asif_to_qp
    from smooth_feedback_tpu_torch.qp import QuadraticProgram
    from smooth_feedback_tpu_torch.qp import solver as qsolver

    name = "mpc_asif_vehicle"
    steps, default = EX_STEPS[name]
    reset_counts()
    sweeps = qsolver.lane_ruiz_sweeps
    t0 = time.perf_counter()
    out = ex.run(steps, device=dev)
    torch.cuda.synchronize()
    secs, counts = time.perf_counter() - t0, read_counts()
    require(qsolver.lane_ruiz_sweeps == sweeps, f"{name}: Ruiz sweeps ran in torch")
    st = lambda k: {s: int((out[k] == s).sum()) for s in set(out[k].tolist())}
    hmin = float(out["hs"].min())
    example_line(name, secs, f"{steps} of {default} steps", f"MPC statuses {st('mpc_statuses')}, "
                 f"ASIF statuses {st('asif_statuses')}, min barrier {hmin:+.6f}", counts)
    require(counts == {"admm_shared": 0, "admm_lane": steps, "admm_problem": steps},
            f"{name} launches")
    require(hmin > 0.0, f"{name}: min barrier {hmin}")
    held_to_f64(name, out["xs"][:EX_CPU_STEPS], lambda dt: ex.run(
        EX_CPU_STEPS, device="cpu", dtype=dt, backend=cpu_backend(dt, "cuda"),
        asif_backend=cpu_backend(dt, "lane"))["xs"])
    c = ex.controllers(dict(dtype=torch.float32, device=dev), "cuda", "lane")
    x0 = ex.X.identity(dtype=torch.float32, device=dev)
    states = torch.cat([x0[None], out["xs"][:EX_KERNEL_STEPS - 1]])
    fl, aprm = c["fl"], c["aprm"]
    qps = QuadraticProgram(*(torch.stack(a) for a in zip(*(
        asif_to_qp(ex.X, ex.U, aprm.asif, aprm.T, x, u, fl["W_u"], fl["ulim"], ex.f, fl["h"],
                   fl["bu"]) for x, u in zip(states, out["u_mpc"][:EX_KERNEL_STEPS])))))
    return counts, example_lane_kernel(name, qps, aprm.qp, dev)


def example_ocp_di_qp(dev):
    """examples_torch/ocp_doubleintegrator_qp.py at its n_ival 10 (K = 40):
    one admm_problem launch, Optimal, x(t) at 11 times held to the float64
    torch route at the example's eps 1e-6, the kernel at the QP."""
    from examples_torch import ocp_doubleintegrator_qp as ex
    from smooth_feedback_tpu_torch.qp import QPSolverParams, QuadraticProgram

    name = "ocp_doubleintegrator_qp"
    reset_counts()
    t0 = time.perf_counter()
    out = ex.run(device=dev)
    torch.cuda.synchronize()
    secs, counts = time.perf_counter() - t0, read_counts()
    sol = out["sol"]
    example_line(name, secs, "n_ival 10 (the default)", f"status {int(sol.status)}, iterations "
                 f"{int(sol.iters)}, x(tf) {out['xs'][-1].tolist()}", counts)
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": 1}, f"{name} launches")
    require(int(sol.status) == 0, f"{name}: not Optimal")
    held_to_f64(name, out["xs"], lambda dt: ex.run(device="cpu", dtype=dt,
                                                   backend=cpu_backend(dt, "cuda"))["xs"])
    qp1 = QuadraticProgram(*(a[None] for a in out["qp"]))
    prm = QPSolverParams(eps_abs=1e-3, eps_rel=1e-3, max_iter=20000, polish=False, backend="cuda")
    return counts, example_problem_kernel(name, qp1, prm)


def example_ocp_di_nlp(dev):
    """examples_torch/ocp_doubleintegrator_nlp.py (its derivative self-check,
    then refinement to the float32 target from Mesh()): Optimal, the final
    error within the target, the fixed ends held, one admm_problem launch
    per SQP iteration, x(t) at 11 times held to float64 (the CPU's torch
    route to the same target); then admm_problem at each pass's first
    subproblem, taken from the run through the SQP's stage hook, for one
    iteration from the path's own start (every subproblem of this NLP runs
    the ADMM to max_iter, polish finishing it, and from the starts the
    refinement transfers 20 float32 iterations already put the kernel's
    distance from float64 at 2.0 x the plain version's in y and 0.57 x in
    x) and the whole solve by the float64 rule."""
    from examples_torch import _common, ocp_doubleintegrator_nlp as ex
    from smooth_feedback_tpu_torch.solvers import sqp

    name = "ocp_doubleintegrator_nlp"
    # each pass is one solve_nlp_sqp, which runs the lockstep loop on a
    # fleet of one: its first subproblem batch is kept as the loop hands it
    # to the QP solver (no launch added, none repeated)
    firsts, loop = [], sqp._solve_nlp_sqp_batch_impl

    def kept_first(make_nlp, thetas, x0, params, lam0, trace=None):
        seen = {}
        keep = lambda stage, info: seen.setdefault("qp", info) if stage == "qp" else None
        sol = loop(make_nlp, thetas, x0, params, lam0, keep)
        firsts.append((seen["qp"], params.qp))
        return sol

    reset_counts()
    sqp._solve_nlp_sqp_batch_impl = kept_first
    try:
        t0 = time.perf_counter()
        out = ex.run(device=dev)
        torch.cuda.synchronize()
        secs, counts = time.perf_counter() - t0, read_counts()
    finally:
        sqp._solve_nlp_sqp_batch_impl = loop
    info, mesh = out["info"], out["mesh"]
    example_line(name, secs, f"{len(info.meshes)} passes of at most 10 (float32 target "
                 f"{_common.F32_TARGET_ERR:g}, SQP tol {_common.F32_SQP_TOL:g}; the example's "
                 f"1e-6, 1e-8)", f"status {info.status.name}, meshes "
                 f"{[(q.N_ivals, q.N_colloc) for q in info.meshes]}, SQP iterations "
                 f"{info.nlp_iters}, errors {[float(f'{e:.4g}') for e in info.errors]}", counts)
    require(info.status == 0, f"{name}: not Optimal")
    require(info.errors[-1] <= _common.F32_TARGET_ERR, f"{name}: final error {info.errors[-1]}")
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": sum(info.nlp_iters)},
            f"{name} launches")
    require(len(firsts) == len(info.meshes), f"{name}: {len(firsts)} SQP solves in "
                                             f"{len(info.meshes)} passes")
    ends = torch.stack([out["xs"][0], out["xs"][-1]]).double().cpu()
    want = torch.tensor([[1.0, 1.0], [0.1, 0.0]], dtype=torch.float64)
    require(float((ends - want).abs().max()) <= 1e-4, f"{name}: the fixed ends moved: {ends}")
    held_to_f64(name, out["xs"], lambda dt: ex.run(
        _common.F32_TARGET_ERR, device="cpu", dtype=dt, backend=cpu_backend(dt, "cuda"))["xs"])
    rows, worst = [], 0.0
    for i, ((cap, qprm), q) in enumerate(zip(firsts, info.meshes)):
        err, row, shape = example_problem_kernel(
            f"{name} pass {i} mesh ({q.N_ivals}, {q.N_colloc}), SQP iteration 1", cap["qp"], qprm,
            fixed=OCP_FIRST_ITERS, ws=cap["ws"])
        worst = max(worst, err)
        rows.append((row, shape))
    return counts, (worst, rows)


def se3_kkt_f64(ex, mesh, twists, sol):
    """Every member's KKT residual recomputed in float64 on the CPU at the
    returned point of the SE(3) fleet's NLP on ``mesh``."""
    from smooth_feedback_tpu_torch.ocp import ocp_to_nlp

    make_flat = ex.flat_factory(torch.float64, "cpu")
    return nlp_kkt_f64(lambda th: ocp_to_nlp(make_flat(th), mesh, torch.float64, "cpu"), twists, sol)


def se3_errors_f64(ex, mesh, twists, sol):
    """The fleet-max per-interval dynamics errors of ``sol`` on ``mesh``,
    evaluated as the driver does, in float64 on the CPU."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch.nlp import NLPSolution
    from smooth_feedback_tpu_torch.ocp import nlpsol_to_ocpsol
    from smooth_feedback_tpu_torch.ocp.collocation import mesh_dyn_error

    make_flat = ex.flat_factory(torch.float64, "cpu")
    d = lambda a: a.detach().to("cpu", torch.float64 if a.is_floating_point() else a.dtype)
    hi = mesh.increase_degrees()

    def one(th, s):
        flat = make_flat(th)
        o = nlpsol_to_ocpsol(flat, mesh, s)
        return mesh_dyn_error(hi, flat.f, 0.0, o.tf, o.x, o.u)

    return vmap(one)(d(twists), NLPSolution(*(d(a) for a in sol))).amax(dim=0)


def example_ocp_se3(dev):
    """examples_torch/ocp_se3_nlp.py's fleet (B = 8 screws on SE(3) x R^3,
    Mesh(), at most 6 passes, its SQP with the float32 tolerance and
    target), the first card run of an NLP on SE(3), through the driver's
    stage hook: every member Optimal (the example's assertion), every
    member's KKT recomputed in float64 <= OCP_TOL, each pass's error
    estimate within 1e-6 + 1e-3 x its float64 recomputation, one
    admm_problem launch per lockstep SQP iteration; then admm_problem at
    each pass's first lockstep subproblem batch (the first pass's lambda =
    0 batch for one iteration, as the sweep's)."""
    from examples_torch import _common, ocp_se3_nlp as ex
    from smooth_feedback_tpu_torch.ocp import nlp_initial_guess, nlp_layout, ocp_to_nlp
    from smooth_feedback_tpu_torch.ocp import solve as osolve
    from smooth_feedback_tpu_torch.ocp.collocation import Mesh
    from smooth_feedback_tpu_torch.solvers import sqp

    name = "ocp_se3_nlp"
    kw = dict(dtype=torch.float32, device=dev)
    twists = ex.fleet_twists(EX_SE3_B, **kw)
    make_flat = ex.flat_factory(**kw)
    prm = ex.params(1e-4, 6, torch.float32, "cuda", verbose=False)
    passes = []

    def trace(stage, info):
        if stage == "start":
            if not passes:
                flat0 = make_flat(twists[0])
                z = nlp_initial_guess(flat0, info["mesh"], prm.tf_guess, **kw)
                start = (z.expand(EX_SE3_B, -1).clone(), torch.zeros(
                    (EX_SE3_B, nlp_layout(flat0, info["mesh"]).m), **kw))
            else:
                start = passes[-1]["next"]
            passes.append(dict(mesh=info["mesh"], start=start))
            reset_counts()
        elif stage == "solve":
            passes[-1].update(solve=info["nlpsol"], launches=read_counts())
        elif stage == "rescue":
            passes[-1].update(sol=info["nlpsol"], rescued=info["n_rescued"])
        elif stage == "error":
            passes[-1]["errs"] = info["errs"].amax(dim=0)
        elif stage == "transfer":
            passes[-1]["next"] = (info["z"], info["lam"])

    t0 = time.perf_counter()
    sol, mesh, info = osolve._solve_ocp_flat_batch_impl(make_flat, twists, Mesh(), prm,
                                                       torch.float32, dev, trace)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = info.statuses
    example_line(name, secs, f"{len(passes)} passes of at most 6 (float32 target "
                 f"{prm.target_err:g}, SQP tol {prm.sqp.tol:g}; the example's 1e-4, 1e-7)",
                 f"B={EX_SE3_B}, Optimal {int((st == 0).sum())}/{EX_SE3_B}, meshes "
                 f"{[(q.N_ivals, q.N_colloc) for q in info.meshes]}, SQP iterations per pass "
                 f"{[int(i.max()) for i in info.nlp_iters]}, rescued {info.rescued}, errors "
                 f"{[float(f'{e:.4g}') for e in info.errors]}",
                 [p["launches"] for p in passes])
    require(bool((st == 0).all()), f"{name}: non-Optimal members in the fleet")
    require(info.errors[-1] <= prm.target_err, f"{name}: final error {info.errors[-1]}")
    for i, p in enumerate(passes):
        require(p["launches"] == {"admm_shared": 0, "admm_lane": 0,
                                  "admm_problem": int(p["solve"].iters.max())},
                f"{name}: pass {i} launched {p['launches']} in {int(p['solve'].iters.max())} "
                f"lockstep iterations")
        e64 = se3_errors_f64(ex, p["mesh"], twists, p["sol"])
        de = float((p["errs"].double().cpu() - e64).abs().max())
        phase("examples", f"{name} pass {i}: mesh ({p['mesh'].N_ivals}, {p['mesh'].N_colloc}), "
                          f"fleet-max errors {[float(f'{e:.4g}') for e in p['errs'].tolist()]}, "
                          f"float64 recomputation {[float(f'{e:.4g}') for e in e64.tolist()]}, "
                          f"max |d| {de:.3e} (bound 1e-6 + 1e-3 x float64's)")
        require(bool(((p["errs"].double().cpu() - e64).abs() <= 1e-6 + 1e-3 * e64.abs()).all()),
                f"{name}: pass {i}'s error estimate differs from its float64 recomputation")
    kkt = se3_kkt_f64(ex, mesh, twists, sol)
    phase("examples", f"{name}: float64 KKT on the final mesh, worst {float(kkt.max()):.3e} "
                      f"(bound {OCP_TOL:g})")
    require(float(kkt.max()) <= OCP_TOL, f"{name}: float64 KKT {float(kkt.max())}")
    rows, worst = [], 0.0
    for i, p in enumerate(passes):
        make = lambda th, q=p["mesh"]: ocp_to_nlp(make_flat(th), q, **kw)
        captured = {}
        sqp._solve_nlp_sqp_batch_impl(make, twists, p["start"][0], dataclasses.replace(
            prm.sqp, max_iter=1), p["start"][1],
            lambda s, inf: captured.update(inf) if s == "qp" else None)
        err, row, shape = example_problem_kernel(
            f"{name} pass {i}, lockstep iteration 1", captured["qp"], prm.sqp.qp,
            fixed=OCP_FIRST_ITERS if i == 0 else FIXED_ITERS, ws=captured["ws"])
        worst = max(worst, err)
        rows.append((row, shape))
    return [p["launches"] for p in passes], (worst, rows)


def example_ekf(dev):
    """examples_torch/ekf_se2_localization.py and ekf_fleet_se2.py (B = 64,
    both filters) at their defaults: the examples' assertions, and the
    first EX_CPU_STEPS steps held to float64 on the same noise.  No
    kernel."""
    from examples_torch import ekf_fleet_se2 as fleet, ekf_se2_localization as single

    counts = {}
    for name, ex, kw in (("ekf_se2_localization", single, {}), ("ekf_fleet_se2", fleet, {"B": 64})):
        steps, default = EX_STEPS[name]
        reset_counts()
        t0 = time.perf_counter()
        out = ex.run(steps, device=dev, **kw)
        torch.cuda.synchronize()
        secs, counts[name] = time.perf_counter() - t0, read_counts()
        errs = [out[k].double().cpu() for k in ("errs", "errs_sqrt") if k in out]
        mean = lambda e: e.mean(dim=-1) if e.dim() > 1 else e
        example_line(name, secs, f"{steps} of {default} steps", "pose error " + ", ".join(
            f"{float(mean(e)[0]):.4f} -> {float(mean(e)[-1]):.5f}" for e in errs), counts[name])
        require(counts[name] == {"admm_shared": 0, "admm_lane": 0, "admm_problem": 0},
                f"{name} launched a kernel")
        # the examples' assertions: below 0.1 (0.05 for the fleet's mean) at
        # their 200 steps, below the first step's at fewer
        require(all(float(mean(e)[-1]) < ((0.1 if name == "ekf_se2_localization" else 0.05)
                                          if steps >= 200 else float(mean(e)[0])) for e in errs),
                f"{name}: final error")
        errs_of = lambda o: torch.stack([o[k] for k in o if k.startswith("errs")])
        held_to_f64(name, errs_of(ex.run(EX_CPU_STEPS, device=dev, **kw)),
                    lambda dt, ex=ex, kw=kw: errs_of(ex.run(EX_CPU_STEPS, device="cpu", dtype=dt,
                                                            **kw)))
    return counts


def examples_phase(dev):
    """Examples 1-9 of examples_torch/ on the card.  Returns the launches of
    each example's run and, per kernel, ``(example, worst error, row,
    shape)`` of each new shape it was held at."""
    launches, found = {}, {"admm_problem": [], "admm_shared": [], "admm_lane": []}
    for name, fn, kernel in (("mpc_se3_rigidbody", example_mpc_se3, "admm_problem"),
                             ("mpc_doubleintegrator", example_mpc_di, "admm_shared"),
                             ("asif_doubleintegrator", example_asif_di, "admm_lane"),
                             ("mpc_asif_vehicle", example_vehicle, "admm_lane"),
                             ("ocp_doubleintegrator_qp", example_ocp_di_qp, "admm_problem")):
        launches[name], (err, row, shape) = fn(dev)
        found[kernel].append((name, err, row, shape))
    launches["ocp_doubleintegrator_nlp"], (err, rows) = example_ocp_di_nlp(dev)
    found["admm_problem"] += [(f"ocp_doubleintegrator_nlp pass {i}", err, row, shape)
                              for i, (row, shape) in enumerate(rows)]
    per_pass, (err, rows) = example_ocp_se3(dev)
    launches["ocp_se3_nlp"] = {k: sum(c[k] for c in per_pass) for k in per_pass[0]}
    found["admm_problem"] += [(f"ocp_se3_nlp pass {i}", err, row, shape)
                              for i, (row, shape) in enumerate(rows)]
    launches.update(example_ekf(dev))
    return launches, found


PAR_STEPS = 20  # closed-loop steps of the sharded condensed fleet
PAR_ONE_CARD_SHARDS = 4  # the mesh on a one-card machine: 4 shards on cuda:0


def parallel_mesh():
    """The mesh of every visible card (one shard each) or, with one card,
    PAR_ONE_CARD_SHARDS shards on cuda:0, each on its own stream."""
    from smooth_feedback_tpu_torch.parallel import dp_mesh

    n = torch.cuda.device_count()
    if n > 1:
        mesh = dp_mesh()
        what = f"{n} cards, one shard each"
    else:
        mesh = dp_mesh([torch.device("cuda", 0)] * PAR_ONE_CARD_SHARDS)
        what = (f"one visible card: {PAR_ONE_CARD_SHARDS} shards on cuda:0, each on its own "
                f"stream; no second card was exercised")
    phase("parallel", f"mesh {[str(d) for d in mesh.devices]} ({what})")
    return mesh


def per_device(mesh, build):
    """``build(d)`` once for each distinct device of the mesh, listed shard
    by shard (a step's or an NLP's tensors live on the device it was built
    on)."""
    built = {}
    for d in mesh.devices:
        if d not in built:
            built[d] = build(d)
    return [built[d] for d in mesh.devices]


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def parallel_fleet_phase(mesh, step, kept, dev):
    """PAR_STEPS closed-loop steps of the condensed main path at B = 8192
    through make_sharded_fleet_step, the sharded warm start and states
    carried from step to step, and before it the same steps unsharded from
    the same states (the main path's last kept step: warm-started).
    Gates: every member Optimal at every step, one admm_shared launch per
    shard per step, |u - u_unsharded| <= PRIMAL_TOL; admm_shared against
    its plain version on shard 0's first launch.  Returns the sharded run's
    launches and admm_shared's error on that launch."""
    from smooth_feedback_tpu_torch.parallel import (
        make_sharded_fleet_step, shard_batch, shard_pytree,
    )
    from smooth_feedback_tpu_torch.parallel.mesh_utils import _shard_map
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda_shared, shared_kernel_args

    i0 = len(kept) - 1
    xs0, ws0, _ = kept[i0]
    fns = per_device(mesh, lambda d: step if d == dev else make_main_path("cuda", d)[0])
    sharded_step = make_sharded_fleet_step([f.fleet_shared_t for f in fns], mesh)
    plant = lambda x, u: x + DT * torch.stack([x[:, 1], u[:, 0]], dim=1)
    runs = {}
    for name in ("unsharded", "sharded"):
        if name == "unsharded":
            xs, ws, fleet, move = xs0, ws0, step.fleet_shared_t, plant
            whole = lambda a: a
        else:
            xs, ws, fleet = shard_batch(xs0, mesh), shard_pytree(ws0, mesh), sharded_step
            move = _shard_map(plant, mesh, (0, 0), 0)
            whole = lambda a: a.gather(dev)
        st, it, us, secs = [], [], [], []
        reset_counts()
        for i in range(PAR_STEPS):
            sync_all()
            t0 = time.perf_counter()
            r = fleet(ws, DT * (i0 + i), xs)
            xs, ws = move(xs, r.u), r.warmstart
            sync_all()
            secs.append(time.perf_counter() - t0)
            st.append(whole(r.status))
            it.append(whole(r.warmstart.iters))
            us.append(whole(r.u))
        runs[name] = (torch.stack(st), torch.stack(it), torch.stack(us), read_counts(), secs)
    st_u, it_u, u_u, c_u, s_u = runs["unsharded"]
    st_s, it_s, u_s, c_s, s_s = runs["sharded"]
    same = float(((st_s == st_u) & (it_s == it_u)).float().mean())
    du = float((u_s - u_u).abs().max())
    opt = [float((st_s[i] == 0).float().mean()) for i in range(PAR_STEPS)]
    phase("parallel", f"condensed fleet, {PAR_STEPS} steps x B={B} from step {i0} of the main "
                      f"path, {mesh.size} shards of {B // mesh.size}: Optimal sharded min "
                      f"{min(opt) * 100:.3f}% over the steps (unsharded "
                      f"{float((st_u == 0).float().mean()) * 100:.3f}% overall); status and "
                      f"iteration count equal to the unsharded run's in {same * 100:.3f}% of "
                      f"member-steps; max |u - u_unsharded| {du:.3e} (bound {PRIMAL_TOL:g}); "
                      f"launches sharded {c_s}, unsharded {c_u}; median step sharded "
                      f"{float(np.median(s_s)) * 1e3:.3f} ms, unsharded "
                      f"{float(np.median(s_u)) * 1e3:.3f} ms")
    require(min(opt) == 1.0, f"a sharded step left members not Optimal (min {min(opt):.5f})")
    require(c_s == {"admm_shared": mesh.size * PAR_STEPS, "admm_lane": 0, "admm_problem": 0},
            f"sharded fleet launches {c_s} != {mesh.size} x {PAR_STEPS} admm_shared")
    require(du <= PRIMAL_TOL, f"sharded u differs from unsharded by {du:.3e}")
    require(bool(torch.isfinite(u_s).all()), "non-finite sharded u")
    # shard 0's first launch, on its own inputs, against the plain version
    k = B // mesh.size
    ws_0 = type(ws0)(*(a[:k] for a in ws0))
    qps = fns[0].condensed_qp(DT * i0, xs0[:k].to(mesh.devices[0]))
    args = shared_kernel_args(qps, fns[0].factors, type(ws0)(*(a.to(mesh.devices[0]) for a in ws_0)))
    err, _ = compare_with_plain(f"parallel shard 0 of {mesh.size}, condensed B={k}",
                                admm_iterate_cuda_shared, qp_params("cuda"), args, qps)
    return c_s, err


def parallel_ekf_phase(mesh, dev):
    """The SE(2) and SO(3) EKF fleets at B = 4096, EKFFleetState and
    SqrtEKFFleetState, EKF_CHECK_STEPS chained steps on states sharded with
    shard_ekf_fleet, against the same steps unsharded at EKF_TOL; no
    kernel launches."""
    from torch.func import vmap
    from smooth_feedback_tpu_torch import estimators as E
    from smooth_feedback_tpu_torch.parallel import shard_ekf_fleet
    from smooth_feedback_tpu_torch.parallel.mesh_utils import _shard_map

    reset_counts()
    for name in ("SE(2)", "SO(3)"):
        G, dyn, meas, Q, R = ekf_problem(name, dev)
        lay = ekf_layouts(G, dyn, meas, Q, R)
        lays = per_device(mesh, lambda d: ekf_layouts(*ekf_problem(name, d)))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        g0 = vmap(G.exp)(0.2 * torch.randn((EKF_B, G.ndof), generator=gen, device=dev))
        noise = 0.05 * torch.randn((EKF_CHECK_STEPS, EKF_B, G.ndof), generator=gen, device=dev)
        for lname, state_type in (("fleet", E.EKFFleetState), ("sqrt fleet", E.SqrtEKFFleetState)):
            reset, step, cov = lay[lname]
            axes = state_type(0, -1)
            sharded_step = _shard_map([ly[lname][1] for ly in lays], mesh, (axes, 0), axes)
            s, ss = reset(g0), shard_ekf_fleet(reset(g0), mesh)
            sync_all()
            t0 = time.perf_counter()
            for k in range(EKF_CHECK_STEPS):
                s = step(s, noise[k])
            sync_all()
            t1 = time.perf_counter()
            for k in range(EKF_CHECK_STEPS):
                ss = sharded_step(ss, noise[k])
            sync_all()
            t2 = time.perf_counter()
            whole = type(s)(*(a.gather(dev) for a in ss))
            dg, dP = ekf_diff(G, whole, s, cov, cov)
            phase("parallel", f"EKF {name} {lname}, B={EKF_B} over {mesh.size} shards, "
                              f"{EKF_CHECK_STEPS} chained steps: max |dg| {dg:.3e}, max |dP| "
                              f"{dP:.3e} against unsharded (bound {EKF_TOL:g}); "
                              f"{(t1 - t0) * 1e3 / EKF_CHECK_STEPS:.3f} ms a step unsharded, "
                              f"{(t2 - t1) * 1e3 / EKF_CHECK_STEPS:.3f} ms sharded")
            require(max(dg, dP) <= EKF_TOL, f"sharded EKF {name} {lname} differs from unsharded")
    counts = read_counts()
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": 0},
            f"a sharded EKF fleet launched {counts}")


def parallel_lane_phase(mesh, vparts, vkept, dev):
    """The vehicle-asif path's ASIF QPs (n = 3, m = 53, B = ASIF_B) through
    _shard_map of solve_qp_batch(backend="lane", adaptive rho on), warm
    started from the path's carry: statuses, iteration counts and primal
    bit-equal to one unsharded launch (each admm_lane warp owns one
    problem), one launch per shard; admm_lane against its plain version on
    shard 0's launch.  Returns the sharded launches and that error."""
    from smooth_feedback_tpu_torch.controllers import asif_to_qp_fleet
    from smooth_feedback_tpu_torch.groups import Rn
    from smooth_feedback_tpu_torch.parallel.mesh_utils import _shard_map
    from smooth_feedback_tpu_torch.qp import lane_kernel_args, solve_qp_batch

    X, f, h, mpc, _, asif, _ = vparts
    t, xs, mws, aws, mk, ak = vkept[-1]
    fl = asif_filter(dev)
    aq = asif_to_qp_fleet(X, Rn(2), asif_to_qp_params(), ASIF_T, xs, mk.u, fl["W_u"], fl["ulim"],
                          f, h, fl["bu"])
    prm = asif_qp_params("lane", True)
    reset_counts()
    one = solve_qp_batch(aq, prm, aws)
    c_one = read_counts()
    solve = _shard_map(lambda qp, ws: solve_qp_batch(qp, prm, ws), mesh, (0, 0), 0)
    reset_counts()
    sh = solve(aq, aws)
    sync_all()
    counts = read_counts()
    whole = type(one)(*(a.gather(dev) for a in sh))
    equal = {k: torch.equal(getattr(whole, k), getattr(one, k))
             for k in ("status", "iters", "primal")}
    phase("parallel", f"ASIF lane QP (3, 53), B={ASIF_B} over {mesh.size} shards, adaptive rho: "
                      f"bit-equal to one unsharded launch {equal}; Optimal "
                      f"{float((whole.status == 0).float().mean()) * 100:.3f}%; launches sharded "
                      f"{counts}, unsharded {c_one}")
    require(all(equal.values()), f"sharded lane solve differs from the unsharded launch: {equal}")
    require(counts == {"admm_shared": 0, "admm_lane": mesh.size, "admm_problem": 0},
            f"sharded lane launches {counts} != {mesh.size} admm_lane")
    k = ASIF_B // mesh.size
    d0 = mesh.devices[0]
    part = lambda tree: type(tree)(*(a[:k].to(d0) for a in tree))
    err, _ = lane_compare(f"parallel shard 0 of {mesh.size}, ASIF lane B={k}",
                          lane_kernel_args(part(aq), None, part(aws)), prm)
    return counts, err


def parallel_sqp_phase(mesh, dev, sweep_sol, sweep_s):
    """make_sharded_sqp_fleet on the ocp-sweep phase's B = OCP_B velocities,
    set against that phase's unsharded sweep (no second unsharded run).
    Gates: the float64 KKT residual <= OCP_TOL for every member the sharded
    sweep calls Optimal, admm_problem launches = the sum of the shards'
    lockstep iterations, admm_shared 0; admm_problem against its plain
    version on shard 0's first lockstep batch (relative_fixed_check).
    Returns the launches and that error."""
    from smooth_feedback_tpu_torch._precision import ieee_f32_matmul
    from smooth_feedback_tpu_torch.parallel import make_sharded_sqp_fleet
    from smooth_feedback_tpu_torch.qp import admm_iterate_cuda, per_problem_kernel_args
    from smooth_feedback_tpu_torch.solvers import sqp

    prm = ocp_sweep_params("cuda")
    paths = per_device(mesh, lambda d: ocp_sweep_path(d))
    make, vels, z0 = paths[0]
    sharded = make_sharded_sqp_fleet([p[0] for p in paths], mesh, prm)
    reset_counts()
    sync_all()
    t0 = time.perf_counter()
    sol = sharded(vels, z0)
    sync_all()
    secs = time.perf_counter() - t0
    counts = read_counts()
    lockstep = [int(p.max()) for p in sol.iters.parts]
    whole = type(sweep_sol)(*(a.gather(dev) for a in sol))
    kkt64 = ocp_kkt_f64(vels, whole)
    is_opt = (whole.status == 0).cpu()
    worst64 = float(kkt64[is_opt].max()) if bool(is_opt.any()) else 0.0
    same = (whole.status == sweep_sol.status).cpu()
    phase("parallel", f"SE(2) OCP sweep, B={OCP_B} over {mesh.size} shards of "
                      f"{OCP_B // mesh.size}: Optimal {float(is_opt.float().mean()) * 100:.3f}% "
                      f"(unsharded sweep {float((sweep_sol.status == 0).float().mean()) * 100:.3f}%"
                      f"), statuses equal to the unsharded sweep's in {int(same.sum())} of {same.numel()} "
                      f"members (differ: {torch.nonzero(~same).flatten().tolist()}); lockstep "
                      f"iterations per shard {lockstep} (unsharded "
                      f"{int(sweep_sol.iters.max())}); launches {counts}; Optimal members' KKT "
                      f"recomputed in float64 on the CPU: max {worst64:.3e} (tol {OCP_TOL:g}); "
                      f"{secs:.3f} s sharded, {sweep_s:.3f} s unsharded")
    require(worst64 <= OCP_TOL, f"a sharded Optimal member's float64 KKT residual is {worst64:.3e}")
    require(counts == {"admm_shared": 0, "admm_lane": 0, "admm_problem": sum(lockstep)},
            f"sharded sweep launches {counts} != the shards' lockstep iterations {lockstep}")
    # shard 0's first lockstep batch, on its own members
    k = OCP_B // mesh.size
    caps = []
    with ieee_f32_matmul():
        sqp._solve_nlp_sqp_batch_impl(make, vels[:k], z0[:k], dataclasses.replace(prm, max_iter=1),
                                      None, lambda s, i: caps.append(i) if s == "qp" else None)
    qprm = prm.qp
    args = per_problem_kernel_args(caps[0]["qp"], None, caps[0]["ws"], qprm)
    err = relative_fixed_check(admm_iterate_cuda, args, qprm, OCP_FIRST_ITERS,
                               f"parallel shard 0 of {mesh.size}, ocp-sweep {OCP_QP_SHAPE} B={k}, "
                               f"lockstep iteration 1")
    return counts, err


def parallel_phase(step, main_kept, vparts, vkept, sweep_sol, sweep_s, dev):
    """The parallel slice: the condensed fleet, both EKF fleets, the ASIF
    lane QPs and the SE(2) OCP sweep, each sharded over the mesh.  Returns
    ``{kernel: launches}``, ``{kernel: worst error}`` on shard 0's
    launches and the mesh's size."""
    mesh = parallel_mesh()
    c_fleet, e_shared = parallel_fleet_phase(mesh, step, main_kept, dev)
    parallel_ekf_phase(mesh, dev)
    c_lane, e_lane = parallel_lane_phase(mesh, vparts, vkept, dev)
    c_sqp, e_problem = parallel_sqp_phase(mesh, dev, sweep_sol, sweep_s)
    launches = {name: c_fleet[name] + c_lane[name] + c_sqp[name] for name in c_fleet}
    errs = {"admm_shared": e_shared, "admm_lane": e_lane, "admm_problem": e_problem}
    return launches, errs, mesh.size


def main():
    t_start = time.perf_counter()
    mark = lambda what: phase("time", f"{what}: {time.perf_counter() - t_start:.1f} s since the start")
    card = device_phase()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    layout_phase()
    shared_route_phase(dev)
    t0 = time.perf_counter()
    step, ws0 = make_main_path("cuda", dev)
    fleet, fws0 = make_fleet_path("cuda", dev)
    phase("setup", f"make_mpc_step, both paths (K={K} condensed, K={FLEET_K} sparse) "
                   f"{time.perf_counter() - t0:.3f} s")
    rows = {"admm_shared": kernel_phase(step, dev), "admm_problem": problem_kernel_phase(fleet, dev)}
    counts, main_kept = main_path_phase(step, ws0, dev)
    err = reference_phase(dev, main_kept)
    rows["admm_shared"] = (max(rows["admm_shared"][0], err), rows["admm_shared"][1])
    launches = {"admm_shared": counts["admm_shared"]}
    counts, kept = fleet_phase(fleet, fws0, dev)
    err = fleet_plain_phase(dev, kept)
    rows["admm_problem"] = (max(rows["admm_problem"][0], err), rows["admm_problem"][1])
    launches["admm_problem"] = counts["admm_problem"]

    vparts = vehicle_asif_path("cuda", dev)
    vcounts, vkept, vcarry = vehicle_asif_phase(vparts, dev)
    vehicle_asif_split(vparts, vcarry, dev)
    err = vehicle_asif_plain_phase(dev, vkept)
    worst_s, _, worst_p, _, worst_l, lane_row = vehicle_kernel_phase(vparts, vkept, dev)
    rows["admm_shared"] = (max(rows["admm_shared"][0], err, worst_s), rows["admm_shared"][1])
    rows["admm_problem"] = (max(rows["admm_problem"][0], worst_p), rows["admm_problem"][1])
    launches["admm_lane"] = vcounts["admm_lane"]
    phase("launches", f"per path (counts set to 0 before each, read after): condensed "
                      f"{launches['admm_shared']} admm_shared in {STEPS} steps; per-member fleet "
                      f"{launches['admm_problem']} admm_problem in {FLEET_STEPS} steps; vehicle-asif "
                      f"{vcounts} in {ASIF_WARM + ASIF_STEPS} steps")
    lcounts, worst_q, lshapes = lane_phase(dev)
    rows["admm_lane"] = (max(worst_l, worst_q), lane_row)
    entry_points_phase(dev)
    mark("the control slices (condensed, fleet, vehicle-asif, entry points)")

    # the state-estimation slice: no kernel on the EKF fleets; the
    # output-feedback loop runs both its QPs through admm_problem
    reset_counts()
    ekf_fleet_phase(dev)
    require(read_counts() == {"admm_shared": 0, "admm_lane": 0, "admm_problem": 0},
            "an EKF fleet launched a kernel")
    ofp = output_feedback_path(dev)
    ofcounts, ofkept = output_feedback_phase(ofp, dev)
    output_feedback_split(ofp, ofkept)
    err = output_feedback_plain_phase(dev, ofkept)
    worst_o, orows = output_feedback_kernel_phase(ofp, ofkept, dev)
    rows["admm_problem"] = (max(rows["admm_problem"][0], err, worst_o), rows["admm_problem"][1])
    pid_spline_phase(dev)
    phase("launches", f"output-feedback {ofcounts} in {OF_STEPS} steps (2 QP solves a step)")
    mark("the state-estimation slice (ekf-fleet, output-feedback, pid-spline)")

    # the NLP slice: every lockstep SQP subproblem through admm_problem
    ocounts, osol, osecs = ocp_sweep_phase(dev)
    first = ocp_sweep_split(dev)
    worst_c, _ = ocp_sweep_kernel_phase(first, dev)
    # the path-level distance between routes is held to its own bound (f32
    # noise of a converged SQP), not counted as kernel error
    ocp_sweep_routes_phase(dev, osol)
    ocp_single_phase(dev, osol)
    mark("the NLP slice (ocp-sweep)")

    # the parallel slice: the condensed fleet, the EKF fleets, the ASIF lane
    # QPs and the OCP sweep sharded over the mesh, each shard on its stream
    plaunches, perrs, pn = parallel_phase(step, main_kept, vparts, vkept, osol, osecs, dev)
    for name, e in perrs.items():
        rows[name] = (max(rows[name][0], e), rows[name][1])
    phase("launches", f"parallel {plaunches}")
    mark("the parallel slice (condensed fleet, EKF fleets, lane QP, OCP sweep, sharded)")

    # the refinement slice: every pass's and every rescue's subproblems
    # through admm_problem, the second pass's on the streaming route
    rcounts, rpasses, rvels = ocp_refine_phase(dev)
    worst_r, rshape = ocp_refine_kernel_phase(dev, rpasses, rvels)
    scounts, sshapes = ocp_solve_phase(dev)
    qcounts, qshape, worst_q = ocp_qp_phase(dev)
    rows["admm_problem"] = (max(rows["admm_problem"][0], worst_c, worst_r, worst_q),
                            rows["admm_problem"][1])
    phase("launches", f"ocp-refine {rcounts}; ocp-solve {scounts}; ocp-qp {qcounts}")
    mark("the refinement slice (ocp-refine, ocp-solve, ocp-qp)")

    # the examples: examples_torch/ 1-9, each through its kernel route
    xcounts, xfound = examples_phase(dev)
    for name, found in xfound.items():
        rows[name] = (max([rows[name][0]] + [f[1] for f in found]), rows[name][1])
    phase("launches", f"examples {xcounts}")
    mark("the examples (examples_torch/ 1-9)")

    by_path = {
        "admm_shared": {"condensed": launches["admm_shared"],
                        "vehicle-asif": vcounts["admm_shared"],
                        "parallel": plaunches["admm_shared"]},
        "admm_problem": {"per-member fleet": launches["admm_problem"],
                         "output-feedback": ofcounts["admm_problem"],
                         "ocp-sweep": ocounts["admm_problem"], **rcounts,
                         "ocp-solve": scounts["admm_problem"], "ocp-qp": qcounts["admm_problem"],
                         "parallel": plaunches["admm_problem"]},
        "admm_lane": {"vehicle-asif": vcounts["admm_lane"], "lane": lcounts,
                      "parallel": plaunches["admm_lane"]},
    }
    for name in by_path:
        by_path[name].update({f"examples/{ex}": c[name] for ex, c in xcounts.items() if c[name]})
    shapes = {
        "admm_shared": [f"B={B} n=m=52", "B=1024 n=m=52", f"B={ASIF_B} n=m=64",
                        f"B={B // pn} n=m=52 (parallel, {pn} shards)"],
        "admm_problem": [f"B={FLEET_B} n=163 m=99", f"B={ASIF_B} n=3 m=53"]
                        + [f"B=1 (n, m)={k}" for k in orows]
                        + [f"B={OCP_B} n={OCP_QP_SHAPE[0]} m={OCP_QP_SHAPE[1]}",
                           f"B={OCP_B} n={rshape[0]} m={rshape[1]}"]
                        + [f"B=1 n={n} m={m}" for n, m in sshapes + [qshape]]
                        + [f"B={OCP_B // pn} n={OCP_QP_SHAPE[0]} m={OCP_QP_SHAPE[1]} (parallel, "
                           f"{pn} shards)"],
        "admm_lane": [f"B={ASIF_B} n=3 m=53"] + lshapes
                     + [f"B={ASIF_B // pn} n=3 m=53 (parallel, {pn} shards)"],
    }
    for name, found in xfound.items():
        shapes[name] += [f"B={b} n={n} m={m} (examples/{ex})" for ex, _, _, (b, n, m) in found]
    kernels = []
    for name, (max_err, (ms, plain_ms, bound_ms, bound_by, single_ms)) in rows.items():
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # ms is the mean of back-to-back calls, which reads the host's
            # pace where a launch runs faster than the host enqueues it;
            # single_ms is the median of single launches, the device's time
            "single_ms": single_ms,
            # no single PyTorch call runs a whole ADMM solve
            "library_ms": None,
            "launches_by_path": by_path[name], "shapes": shapes[name],
            # member 0's solve at B = 1 at each example's shape
            "example_rows": [{"path": f"examples/{ex}", "B": b, "n": n, "m": m, "ms": r[0],
                              "plain_ms": r[1], "bound_ms": r[2], "bound_by": r[3],
                              "single_ms": r[4],
                              "max_abs_err": e} for ex, e, r, (b, n, m) in xfound[name]],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
