"""Fused ADMM iteration: the CUDA kernels' wrappers and their plain version.

Two kernels, one per TPU kernel of ``smooth_feedback_tpu/qp/pallas_kernel.py``:

- ``csrc/admm_shared.cu``, ``csrc/admm_shared_cluster.cu`` and
  ``csrc/admm_shared_stream.cu`` replace ``_admm_kernel_shared`` (called
  through ``admm_iterate_pallas_shared``): every problem of the batch
  shares the scaled ``Minv``, ``As`` and ``Ps``; each has its own vectors
  and warm start.  Three routes, one wrapper (:func:`shared_route` decides
  by shape, over every shape the JAX package's ``shared_kernel_fits``
  admits).  The resident route (max(n, m) <= 128) is bound by the 128
  bytes a clock that an SM's shared memory delivers to the registers, not
  by HBM: the three shared matrices stay resident in shared memory for the
  whole solve and every problem's vectors stay in registers.  A warp
  advances a group of 2 problems in lockstep (the TPU kernel's GEMM form,
  with per-member freeze masks), so one matrix entry read from shared
  memory feeds a whole group's FMAs; fp32 FMAs, and an odd row stride so
  row and column reads are free of bank conflicts.  The cluster route (the
  larger shapes whose ``Minv`` and ``As`` a thread-block cluster of up to 16
  blocks holds) slices them over the blocks' shared memory once a launch:
  a cluster advances a group of 8 or 4 problems in lockstep, the blocks
  exchanging vector slices and partial sums through distributed shared
  memory, and persistent clusters take groups from a work counter; it takes
  the bands of shapes where it was the faster kernel on an H100
  (``CLUSTER_ROUTE_FROM``).  The streaming route (every other shape past the
  resident route) keeps the matrices in device memory, where the L2 holds
  them: a block advances up to 16 problems in lockstep and reads each
  matrix once an iteration for all of them, its threads owning output
  columns, the problems' inputs staged in shared memory.
  :func:`shared_plan` mirrors how a launch lays a batch out on each route.
- ``csrc/admm_problem.cu`` replaces ``_admm_kernel`` (called through
  ``admm_iterate_pallas``): every problem carries its own ``Minv``, ``As``,
  ``Ps``, ``rho``, ``sx``, ``sy`` and ``c``.  Its bound is device memory
  (each matrix read once).  One thread block per problem; where ``Minv``,
  ``As`` and the vectors fit a block's shared memory (:func:`problem_route`)
  the block copies them in once and iterates from there, at the rate shared
  memory feeds its matrix-vector products, reading ``Ps`` from device memory
  once per check; larger shapes stream the matrices on every iteration.

A third kernel has no Pallas counterpart:

- ``csrc/admm_lane.cu`` runs the JAX package's lane backend
  (``smooth_feedback_tpu/qp/solver.py::_solve_qp_batch_lane``, one compiled
  XLA program over batch-trailing stacks) as one launch: the whole solve of
  a fleet of tiny per-problem QPs, from the unscaled problem to the unscaled
  solution (Ruiz scaling, per-row rho, factorization, the loop with its
  stopping checks (plain or compensated), certificates, ``kkt_refine_iters``
  and adaptive rho refactorizing in the kernel, the objective).  One warp
  per problem, its matrices and vectors in shared memory
  (:func:`lane_plan`); up to n = 8 every lane works on every product.

:func:`admm_iterate_cuda_shared`, :func:`admm_iterate_cuda` and
:func:`admm_solve_cuda_lane` launch their kernel on CUDA tensors and run
the plain version (:func:`admm_iterate_reference`,
:func:`admm_solve_lane_reference`) on CPU tensors; nothing else chooses
the plain version.  Each has a ``launches`` attribute that counts kernel
launches (under ``qp.solver._count_lock``: shards solve in threads).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .solver import (
    _DUAL_INF, _MAX_ITER, _OPTIMAL, _PRIMAL_INF, _RUNNING, _UNKNOWN, QPFactors, _count_lock,
    _inner_contiguous, _lane_chol_inverse, _lane_loop, _lane_scaling, _mtv, _mv, _norm_inf,
    _scaled_inputs,
)
from .types import QPSolverParams

# what one block may hold on an H100 (232,448 bytes of shared memory)
SMEM_LIMIT = 232448
MAX_DIM = 128  # shared kernel, resident route: entries per lane instantiated up to 4 (K <= 4)
MAX_BLOCK = 8  # shared kernel, resident route: problems per block (a group for each warp)
MAX_WARPS = 8  # shared kernel, resident route: warps per block (__launch_bounds__(256))
STREAM_GROUPS = (16, 8, 4, 2)  # shared kernel, streaming route: problems a block, widest first
STREAM_MAX_WARPS = 16  # ... warps a block (__launch_bounds__(512))
STREAM_COLS = 2  # ... output columns a thread owns in one pass
STREAM_NQ = 16  # ... per-problem quantities a check reduces over the block
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # shared kernel, cluster route: blocks a cluster, smallest first
CLUSTER_GROUPS = (8, 4)  # ... problems a cluster advances together, widest first
CLUSTER_THREADS = 256  # ... threads a block
CLUSTER_NQ = 19  # ... per-problem quantities a check reduces over the cluster
# ... the shapes the route gives the cluster kernel, by the cluster size its
# plan takes: from max(n, m) = 200 up in clusters of 2, every shape in
# clusters of 16, no other.  Set by both kernels' times on an H100 at bench.py
# --sweep's fleets (PERF.md): the cluster kernel was faster at (200, 200), C =
# 2, and at (602, 602), C = 16, slower at (158, 158), C = 2, and at (302,
# 302), C = 8.
CLUSTER_ROUTE_FROM = {2: 200, 16: 0}
SMS = 132  # streaming multiprocessors of an H100, four warp schedulers each
PROBLEM_WARPS = 16  # per-problem kernel: warps per block, one block per problem
PROBLEM_STATIC_SMEM = 4 * 10 * 16  # its block-reduction scratch
LANE_MAX_WARPS = 8  # lane kernel: problems (warps) per block (__launch_bounds__(256))
LANE_VEC_N, LANE_VEC_M = 9, 14  # lane kernel: n- and m-vectors a problem keeps
LANE_SMALL_MAX = 8  # lane kernel: the widest n on its register path


def admm_iterate_reference(
    prm: QPSolverParams, Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0
):
    """Plain batched torch version of the fused ADMM loop (any dtype).

    The matrices are either shared by the batch (``Minv``/``Ps`` (n, n),
    ``As`` (m, n), ``rho``/``sy`` (m,), ``sx`` (n,), ``c`` 0-d: every product
    is one ``(B, k) @ (k, j)`` GEMM) or per problem (a leading batch axis on
    each: batched products).  Same updates, stopping check, certificates and
    freeze semantics as the kernels.  Returns ``(x, z, y, status, iters,
    pres, dres)`` in scaled variables."""
    B = qs.shape[0]
    dt, dev = qs.dtype, qs.device
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    alpha, sigma = prm.alpha, prm.sigma
    eps_abs, eps_rel = prm.eps_abs, prm.eps_rel
    eps_pinf, eps_dinf = prm.eps_primal_inf, prm.eps_dual_inf
    k = prm.stop_check_iter
    if c.dim() == 1:  # per problem: broadcast against (B, .) vectors
        c = c[:, None]

    mu_inf = u >= inf
    ml_inf = l <= -inf
    uv_fin = torch.where(mu_inf, 0.0, u)
    lv_fin = torch.where(ml_inf, 0.0, l)
    inv_sy = 1.0 / sy
    inv_csx = 1.0 / (c * sx)

    def check(x, z, y, x_old, y_old):
        Ax = _mv(As, x) * inv_sy
        z_us = z * inv_sy
        pres = _norm_inf(Ax - z_us)
        prim_ok = pres <= eps_abs + eps_rel * torch.maximum(_norm_inf(Ax), _norm_inf(z_us))

        Px = _mv(Ps, x) * inv_csx
        Aty = _mtv(As, y) * inv_csx
        qv = qs * inv_csx
        dres = _norm_inf(Px + qv + Aty)
        dscale = torch.maximum(_norm_inf(Px), torch.maximum(_norm_inf(qv), _norm_inf(Aty)))
        dual_ok = dres <= eps_abs + eps_rel * dscale
        optimal = prim_ok & dual_ok

        dy_us = sy * (y - y_old) / c
        E = _norm_inf(dy_us)[:, None]
        Atdy = _mtv(As, y - y_old) * inv_csx
        viol = ((mu_inf & (dy_us > eps_pinf * E)) | (ml_inf & (dy_us < -eps_pinf * E))).any(dim=1)
        sum_term = (
            uv_fin * torch.clamp(dy_us, min=0.0) + lv_fin * torch.clamp(dy_us, max=0.0)
        ).sum(dim=1)
        prim_inf = ~viol & (torch.maximum(_norm_inf(Atdy), sum_term) < eps_pinf * E[:, 0])

        dx_us = sx * (x - x_old)
        dxn = _norm_inf(dx_us)
        Pdx = _mv(Ps, x - x_old) * inv_csx
        Adx = _mv(As, x - x_old) * inv_sy
        tol = (eps_dinf * dxn)[:, None]
        row_ok = torch.where(
            mu_inf, Adx >= -tol, torch.where(ml_inf, Adx <= tol, Adx.abs() < tol)
        ).all(dim=1)
        qdx = (qs * inv_csx * dx_us).sum(dim=1)
        dual_inf = (_norm_inf(Pdx) <= tol[:, 0]) & (qdx <= tol[:, 0]) & row_ok

        finite = (x.abs() < inf).all(dim=1) & (y.abs() < inf).all(dim=1)
        st = torch.full((B,), _RUNNING, dtype=torch.int32, device=dev)
        st = torch.where(dual_inf, _DUAL_INF, st)
        st = torch.where(prim_inf, _PRIMAL_INF, st)
        st = torch.where(optimal, _OPTIMAL, st)
        st = torch.where(~finite, _UNKNOWN, st).to(torch.int32)
        return st, pres, dres

    x, z, y = x0, z0, y0
    status = status0.to(torch.int32)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    pres = torch.full((B,), float("inf"), dtype=dt, device=dev)
    dres = torch.full((B,), float("inf"), dtype=dt, device=dev)

    it = 0
    while it < prm.max_iter and bool((status == _RUNNING).any()):
        x_old, y_old = x, y
        rhs = sigma * x - qs + _mtv(As, rho * z - y)
        xt = _mtv(Minv, rhs)
        zt = _mv(As, xt)

        xn = alpha * xt + (1 - alpha) * x
        zr = alpha * zt + (1 - alpha) * z
        zn = torch.clamp(zr + y / rho, ls, us)
        yn = y + rho * (zr - zn)

        if it % k == 1 % k:
            new_status, pres_n, dres_n = check(xn, zn, yn, x_old, y_old)
        else:
            new_status = torch.full((B,), _RUNNING, dtype=torch.int32, device=dev)
            pres_n, dres_n = pres, dres

        run = status == _RUNNING
        runc = run[:, None]
        x = torch.where(runc, xn, x)
        z = torch.where(runc, zn, z)
        y = torch.where(runc, yn, y)
        status = torch.where(run, new_status, status)
        iters = torch.where(run, it + 1, iters).to(torch.int32)
        pres = torch.where(run, pres_n, pres)
        dres = torch.where(run, dres_n, dres)
        it += 1

    status = torch.where(status == _RUNNING, _MAX_ITER, status).to(torch.int32)
    return x, z, y, status, iters, pres, dres


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _block_group(block: int) -> int:
    """Widest group a warp of the shared kernel advances together in a block
    of ``block`` problems."""
    return 2 if block >= 2 else 1


def _resident_smem_bytes(n: int, m: int, block: int) -> int:
    """Dynamic shared memory one block of the resident route needs for
    blocks of ``block`` problems (mirrors ``smem_bytes`` in
    csrc/admm_shared.cu): three matrices at an odd row stride and 64 K
    floats of staging for each problem of a block (whole groups)."""
    ld = n | 1
    K = (max(n, m) + 31) // 32
    P = _block_group(block)
    slots = -(-block // P) * P
    return 4 * (_round4(ld * (2 * n + m)) + 64 * K * slots)


def _stream_smem_bytes(n: int, m: int, G: int) -> int:
    """Dynamic shared memory one block of the streaming route needs for ``G``
    problems (mirrors ``stream_smem`` in csrc/admm_shared_stream.cu): two
    staging buffers of max(n, m) rows of G floats, the check's per-warp
    partials, nine per-problem scalars."""
    return 4 * (2 * max(n, m) * G + STREAM_NQ * STREAM_MAX_WARPS * G + 9 * G)


def _stream_parts(G: int, D: int) -> int:
    """Parts a streaming block's threads form at a widest vector of ``D``
    (mirrors ``parts`` in csrc/admm_shared_stream.cu): two (each owning G /
    2 of the block's problems) where G >= 8 and a part of at most half the
    warps covers D in one pass, else one."""
    half = 32 * (STREAM_MAX_WARPS // 2)
    return 2 if G >= 8 and -(-D // STREAM_COLS) <= half else 1


def _stream_group(n: int, m: int) -> int:
    """Problems a block of the streaming route advances together: the widest
    of ``STREAM_GROUPS`` whose block fits ``SMEM_LIMIT``, 0 where none does."""
    return next((G for G in STREAM_GROUPS if _stream_smem_bytes(n, m, G) <= SMEM_LIMIT), 0)


def stream_plan(n: int, m: int):
    """The streaming route's layout at ``(n, m)`` (mirrors ``plan`` in
    csrc/admm_shared_stream.cu): ``(G, G, warps, smem)``, the widest block
    that fits, its threads in two parts of G / 2 problems (G >= 8 and
    max(n, m) <= 512) or one part, each part with enough warps for two
    columns a thread of max(n, m) in as few passes as ``STREAM_MAX_WARPS``
    allow, spread evenly over the passes."""
    G = _stream_group(n, m)
    H = _stream_parts(G, max(n, m))
    threads = -(-max(n, m) // STREAM_COLS)  # a part's, in one pass
    passes = -(-threads // (32 * (STREAM_MAX_WARPS // H)))
    return G, G, H * -(-threads // (32 * passes)), _stream_smem_bytes(n, m, G)


def _cluster_smem_bytes(n: int, m: int, C: int, G: int) -> int:
    """Dynamic shared memory one block of the cluster route needs for
    clusters of ``C`` blocks advancing ``G`` problems (mirrors
    ``make_layout`` in csrc/admm_shared_cluster.cu): the gathered input
    (max(n, m) rows of G), the product's per-segment sums, the check's
    per-warp and per-block quantities, six vectors of the block's
    ceil(n / C) columns and six of its ceil(m / C) rows, the status words,
    then the slices of ``Minv`` (n rows of ceil(n / C)) and ``As``
    (ceil(m / C) rows at the odd stride n | 1)."""
    wn, wm = -(-n // C), -(-m // C)
    floats = (_round4(max(n, m) * G) + CLUSTER_THREADS * G + CLUSTER_NQ * (CLUSTER_THREADS // 32) * G
              + 2 * _round4(CLUSTER_NQ * G) + 6 * (wn + wm) * G + _round4(7 * G + 1)
              + n * wn + wm * (n | 1))
    return 4 * floats


def _cluster_shape(n: int, m: int):
    """``(C, G)`` of the cluster route at ``(n, m)`` (mirrors ``plan`` in
    csrc/admm_shared_cluster.cu): the widest G of ``CLUSTER_GROUPS`` for
    which some cluster size holds the slices, with the smallest such size;
    None where no cluster of 16 holds them."""
    for G in CLUSTER_GROUPS:
        for C in CLUSTER_SIZES:
            if _cluster_smem_bytes(n, m, C, G) <= SMEM_LIMIT:
                return C, G
    return None


def cluster_plan(n: int, m: int):
    """How the cluster kernel lays out a problem of ``(n, m)`` (mirrors
    ``admm_shared_cluster_plan`` but for the clusters resident, which the
    device decides): ``(C, G, warps, smem)`` = blocks a cluster, problems a
    cluster advances together, warps a block, dynamic shared memory a block
    in bytes, from the shape alone, wherever some cluster holds the shape
    (the route takes it only where ``CLUSTER_ROUTE_FROM`` says).  Raises
    where no cluster holds it."""
    found = _cluster_shape(n, m)
    if found is None:
        raise ValueError(f"no cluster of the cluster route holds n={n}, m={m}")
    C, G = found
    return C, G, CLUSTER_THREADS // 32, _cluster_smem_bytes(n, m, C, G)


# The JAX package's gate for its fused shared-matrix kernel
# (smooth_feedback_tpu/qp/pallas_kernel.py: shared_kernel_fits and the
# constants and footprint estimates it reads), copied: a TPU's VMEM budget
# decides which shapes the kernel takes, and the port takes the same ones.
_VMEM_RAISED = 100 * 2**20
_FOOTPRINT_FUDGE = 2.0


def _pad128(v: int) -> int:
    return -(-max(v, 128) // 128) * 128


def _shared_static_bytes(n_pad: int, m_pad: int) -> int:
    return 4 * (2 * n_pad * n_pad + m_pad * n_pad) + (1 << 20)


def _shared_per_problem_bytes(n_pad: int, m_pad: int) -> int:
    return 18 * 4 * (n_pad + m_pad)


def _jax_shared_kernel_fits(n: int, m: int) -> bool:
    n_pad, m_pad = _pad128(n), _pad128(m)
    est = _shared_static_bytes(n_pad, m_pad) + 64 * _shared_per_problem_bytes(n_pad, m_pad)
    return est * _FOOTPRINT_FUDGE <= _VMEM_RAISED


def shared_route(n: int, m: int, block: int) -> Optional[str]:
    """The route the shared kernel takes at ``(n, m)`` in blocks of
    ``block`` problems, by shape alone: ``"resident"`` where max(n, m) <=
    ``MAX_DIM`` and the block's matrices and staging fit ``SMEM_LIMIT``
    (csrc/admm_shared.cu), else, where the JAX package's
    ``shared_kernel_fits`` admits the shape, ``"cluster"`` where
    ``CLUSTER_ROUTE_FROM`` gives the cluster kernel's plan the shape
    (csrc/admm_shared_cluster.cu; square shapes 200 to 206 and 426 to 640),
    and ``"streaming"`` elsewhere (csrc/admm_shared_stream.cu), else None.
    The bands come from the two kernels' times on the card, not from
    anything known at run time.  Raises for a ``block`` outside
    1..``MAX_BLOCK``."""
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"kernel_block must be in [1, {MAX_BLOCK}], got {block}")
    if max(n, m) <= MAX_DIM and _resident_smem_bytes(n, m, block) <= SMEM_LIMIT:
        return "resident"
    if not _jax_shared_kernel_fits(n, m):
        return None
    found = _cluster_shape(n, m)
    if found is not None and max(n, m) >= CLUSTER_ROUTE_FROM.get(found[0], math.inf):
        return "cluster"
    if _stream_group(n, m):
        return "streaming"
    return None


def shared_kernel_fits(n: int, m: int, block: int) -> bool:
    """Whether the shared kernel takes a problem of ``(n, m)`` in blocks of
    ``block`` problems on one of its routes: exactly where the JAX package's
    ``shared_kernel_fits(n, m)`` admits its fused kernel.  ``solve_qp_batch``
    routes a shared-factor batch past it to the torch shared loop, as the
    JAX package falls through to its XLA shared-GEMM path.  Raises for a
    ``block`` outside 1..``MAX_BLOCK``."""
    return shared_route(n, m, block) is not None


def shared_plan(B: int, n: int, m: int, block: int):
    """How the shared kernel lays out ``B`` problems (mirrors ``plan`` in
    csrc/admm_shared.cu, csrc/admm_shared_cluster.cu and
    csrc/admm_shared_stream.cu): ``(P, pb, warps, smem)`` = problems
    advanced together (by a warp on the resident route, by a whole cluster
    or block on the others), problems per block (per cluster on the cluster
    route), warps per block, dynamic shared memory in bytes.  Resident
    route, in blocks of at most ``block``: fleets too small to give every
    warp scheduler a warp get one problem a warp, and those too small to give
    every SM a block get smaller blocks.  Cluster route:
    :func:`cluster_plan`'s group.  Streaming route: :func:`stream_plan`.
    Raises for a shape past every route."""
    route = shared_route(n, m, block)
    if route == "resident":
        P = _block_group(block)
        if P > 1 and -(-B // P) < 4 * SMS:
            P = 1
        pb = min(block, max(P, -(-B // SMS)))
        warps = min(MAX_WARPS, -(-pb // P))
        return P, pb, warps, _resident_smem_bytes(n, m, block)
    if route == "cluster":
        _, G, warps, smem = cluster_plan(n, m)
        return G, G, warps, smem
    if route == "streaming":
        return stream_plan(n, m)
    raise ValueError(f"the shared kernel takes no route at n={n}, m={m}")


def smem_bytes(n: int, m: int, block: int) -> int:
    """Dynamic shared memory one block of the shared kernel needs at ``(n,
    m)`` in blocks of ``block`` problems, on the route :func:`shared_route`
    gives the shape (whatever B).  Raises for a shape past every route."""
    return shared_plan(1, n, m, block)[3]


def shared_stream_scratch(B: int, n: int, m: int) -> int:
    """Floats of device-memory scratch one launch of the streaming route
    needs (mirrors ``admm_shared_stream_scratch``): the transposed ``As``
    and ``Ps``, and four vectors a problem (this iteration's x, z, y and
    y As at a check)."""
    return n * m + n * n + B * (2 * n + 2 * m)


def shared_cluster_scratch(B: int, n: int, m: int) -> int:
    """Floats of device-memory scratch one launch of the cluster route needs
    (mirrors ``admm_shared_cluster_scratch``): the work counter (four
    floats' room, zeroed by the launch on its stream) and the transposed
    ``Ps``; nothing a problem."""
    return 4 + n * n


def problem_route(n: int, m: int):
    """The route the per-problem kernel takes at ``(n, m)`` and the dynamic
    shared memory one block needs (mirrors ``plan`` in
    csrc/admm_problem.cu): ``("resident", bytes)`` when ``Minv``, ``As`` and
    the vectors fit one block, else ``("streaming", bytes)`` with the vectors
    alone.  The vectors are 10 of length n and 15 of length m, on the
    resident route also one n-vector of partial sums per warp."""
    vectors = 10 * _round4(n) + 15 * _round4(m)
    partial = PROBLEM_WARPS * _round4(n)
    if 4 * (m * n + n * n + 16 + vectors + partial) + PROBLEM_STATIC_SMEM <= SMEM_LIMIT:
        return "resident", 4 * (_round4(m * n + 3) + _round4(n * n + 3) + vectors + partial)
    return "streaming", 4 * vectors


def problem_smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory one block of the per-problem kernel needs on
    the route :func:`problem_route` gives ``(n, m)``."""
    return problem_route(n, m)[1]


def lane_problem_bytes(n: int, m: int, resident: bool = False) -> int:
    """Shared memory one problem (one warp) of the lane kernel keeps
    (mirrors ``problem_floats`` in csrc/admm_lane.cu): ``As``, ``Minv``,
    ``Mred`` and two matrices of refactorization scratch at the odd row
    stride ``n | 1``, with ``resident`` also the unscaled ``P`` and ``A``
    there, and its vectors."""
    ld = n | 1
    extra = ld * (n + m) if resident else 0
    return 4 * _round4(ld * (m + 4 * n) + extra + LANE_VEC_N * n + LANE_VEC_M * m)


def lane_fits(n: int, m: int) -> bool:
    """Whether the lane kernel holds a problem of ``(n, m)``: one problem's
    matrices and vectors (without the unscaled ``P`` and ``A``, which it
    then reads from device memory) within one block's ``SMEM_LIMIT``.
    ``solve_qp_batch`` runs a lane batch that does not fit on the plain
    whole solve."""
    return n >= 1 and m >= 1 and lane_problem_bytes(n, m) <= SMEM_LIMIT


def lane_plan(B: int, n: int, m: int):
    """How the lane kernel lays out ``B`` problems (mirrors ``plan`` in
    csrc/admm_lane.cu): ``(problems a block, dynamic shared memory a block
    in bytes, resident, small)``.  A warp a problem; the unscaled ``P`` and
    ``A`` in shared memory (``resident``) wherever one problem with them
    fits a block; as many problems a block as fit, up to
    ``LANE_MAX_WARPS``, but no more than it takes to give every SM a block;
    ``small`` n where the register path (one instantiation a width, up to
    ``LANE_SMALL_MAX``) takes the problem, else 0 (a lane per output).
    Raises for a shape :func:`lane_fits` refuses."""
    if not lane_fits(n, m):
        raise ValueError(f"the lane kernel cannot hold n={n}, m={m}")
    resident = lane_problem_bytes(n, m, True) <= SMEM_LIMIT
    per = lane_problem_bytes(n, m, resident)
    ppb = min(LANE_MAX_WARPS, SMEM_LIMIT // per, max(1, -(-B // SMS)))
    return ppb, ppb * per, int(resident), n if n <= LANE_SMALL_MAX else 0


def _check_args(per_problem, prm, Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0,
                status0):
    B, n = qs.shape
    m = ls.shape[1]
    lead = (B,) if per_problem else ()
    shapes = {
        "Minv": (Minv, lead + (n, n)), "As": (As, lead + (m, n)), "Ps": (Ps, lead + (n, n)),
        "rho": (rho, lead + (m,)), "sx": (sx, lead + (n,)), "sy": (sy, lead + (m,)),
        "c": (c, lead),
        "qs": (qs, (B, n)), "ls": (ls, (B, m)), "us": (us, (B, m)),
        "l": (l, (B, m)), "u": (u, (B, m)),
        "x0": (x0, (B, n)), "z0": (z0, (B, m)), "y0": (y0, (B, m)),
    }
    dev = qs.device
    for name, (t, shape) in shapes.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(status0.shape) != (B,) or status0.dtype != torch.int32:
        raise ValueError("status0 must be int32 of shape (B,)")
    if status0.device != dev or not status0.is_contiguous():
        raise ValueError("status0 must be contiguous and on the problems' device")
    if prm.stop_check_iter < 1:
        raise ValueError("stop_check_iter must be >= 1")
    if per_problem:
        need = problem_smem_bytes(n, m) + PROBLEM_STATIC_SMEM
        if need > SMEM_LIMIT:  # the streaming route's vectors alone
            raise ValueError(
                f"the per-problem kernel cannot hold n={n}, m={m}: its vectors need "
                f"{need} <= {SMEM_LIMIT} bytes of shared memory"
            )
    elif shared_route(n, m, prm.kernel_block) is None:
        raise ValueError(
            f"the shared-matrix kernel cannot hold n={n}, m={m}: past the JAX package's "
            f"shared_kernel_fits bound, which both its routes keep"
        )
    return B, n, m


def _launch(fn_name, prm, args, B, n, m, ints=(), scratch=None):
    """Allocate the outputs and launch ``fn_name`` of the kernels' library on
    the problems' device and current stream (``scratch``, a float32 tensor,
    passed after the outputs; ``ints`` after ``B, n, m``); raise on a
    non-zero CUDA code."""
    from .. import _build

    Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0 = args
    dev = qs.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = (
        torch.empty((B, n), **f32), torch.empty((B, m), **f32), torch.empty((B, m), **f32),
        torch.empty((B,), **i32), torch.empty((B,), **i32),
        torch.empty((B,), **f32), torch.empty((B,), **f32),
    )
    fn = getattr(_build.load(), fn_name)
    extra = () if scratch is None else (scratch.data_ptr(),)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            *(t.data_ptr() for t in (Minv, As, Ps, rho, sx, sy, c, qs, ls, us, l, u, x0, z0, y0, status0)),
            *(t.data_ptr() for t in outs), *extra,
            B, n, m, *ints,
            prm.alpha, prm.sigma, prm.eps_abs, prm.eps_rel,
            prm.eps_primal_inf, prm.eps_dual_inf,
            prm.max_iter, prm.stop_check_iter, stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    return outs


def _device_type(qs):
    if qs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qs.device}")
    return qs.device.type


def admm_iterate_cuda_shared(
    prm: QPSolverParams, Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0
):
    """Shared-matrix fused ADMM on float32 tensors.

    CUDA tensors launch the route :func:`shared_route` gives the shape (or
    raise): ``csrc/admm_shared.cu`` for the resident route,
    ``csrc/admm_shared_cluster.cu`` for the cluster route and
    ``csrc/admm_shared_stream.cu`` for the streaming route (each of the last
    two with its scratch); shapes past every route raise.  CPU tensors run
    :func:`admm_iterate_reference`.  ``Minv``/``Ps`` (n, n), ``As`` (m, n),
    ``rho``/``sy`` (m,), ``sx`` (n,), ``c`` 0-d.  Returns ``(x, z, y, status,
    iters, pres, dres)`` in scaled variables.  ``launches`` counts the
    launches, ``route_launches`` them by route."""
    args = (Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0)
    B, n, m = _check_args(False, prm, *args)
    if _device_type(qs) == "cpu":
        return admm_iterate_reference(prm, *args)
    route = shared_route(n, m, prm.kernel_block)
    if route == "resident":
        outs = _launch("admm_shared_launch", prm, args, B, n, m, (prm.kernel_block,))
    elif route == "cluster":
        scratch = torch.empty(shared_cluster_scratch(B, n, m), dtype=torch.float32,
                              device=qs.device)
        outs = _launch("admm_shared_cluster_launch", prm, args, B, n, m, scratch=scratch)
    else:
        scratch = torch.empty(shared_stream_scratch(B, n, m), dtype=torch.float32,
                              device=qs.device)
        outs = _launch("admm_shared_stream_launch", prm, args, B, n, m, scratch=scratch)
    with _count_lock:
        admm_iterate_cuda_shared.launches += 1
        admm_iterate_cuda_shared.route_launches[route] += 1
    return outs


admm_iterate_cuda_shared.launches = 0
admm_iterate_cuda_shared.route_launches = {"resident": 0, "cluster": 0, "streaming": 0}


def admm_iterate_cuda(
    prm: QPSolverParams, Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0
):
    """Per-problem fused ADMM on float32 tensors.

    CUDA tensors launch ``csrc/admm_problem.cu`` (or raise); CPU tensors run
    :func:`admm_iterate_reference`.  ``Minv``/``Ps`` (B, n, n), ``As`` (B, m,
    n), ``rho``/``sy`` (B, m), ``sx`` (B, n), ``c`` (B,).  Returns ``(x, z,
    y, status, iters, pres, dres)`` in scaled variables."""
    args = (Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0)
    B, n, m = _check_args(True, prm, *args)
    if _device_type(qs) == "cpu":
        return admm_iterate_reference(prm, *args)
    outs = _launch("admm_problem_launch", prm, args, B, n, m, (PROBLEM_WARPS,))
    with _count_lock:
        admm_iterate_cuda.launches += 1
    return outs


admm_iterate_cuda.launches = 0


class LaneSolution(NamedTuple):
    """One lane solve, batch-leading: the unscaled solution (``primal``
    (B, n), ``dual`` (B, m), ``objective``), ``status``, ``iters``, the last
    check's ``pres`` and ``dres``, the refactorizations adaptive rho asked
    for and the Ruiz sweeps each member ran, then the scaled iterates ``x``,
    ``z``, ``y`` and the scalings ``c``, ``sx``, ``sy`` (None where the
    kernel was not asked for them)."""

    primal: torch.Tensor
    dual: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    objective: torch.Tensor
    pres: torch.Tensor
    dres: torch.Tensor
    refactors: torch.Tensor
    sweeps: torch.Tensor
    x: Optional[torch.Tensor]
    z: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    c: Optional[torch.Tensor]
    sx: Optional[torch.Tensor]
    sy: Optional[torch.Tensor]


class _Warm(NamedTuple):
    primal: torch.Tensor
    dual: torch.Tensor


def admm_solve_lane_reference(
    prm: QPSolverParams, P, q, A, l, u, xw=None, yw=None, factors=None, member_refactor=False,
) -> LaneSolution:
    """Plain torch version of the lane kernel (any dtype): the lane
    backend's whole solve from the batch-trailing pieces of ``qp.solver``,
    so that its float64 rounding follows the JAX package's.  ``P`` (B, n,
    n), ``q`` (B, n), ``A`` (B, m, n), ``l``/``u`` (B, m), the unscaled warm
    start ``xw`` (B, n), ``yw`` (B, m) or None, per-problem ``factors`` or
    None (then ``_lane_scaling`` and ``_lane_chol_inverse``: a member whose
    factor fails and that would run starts Unknown).  Rho adapts as in the
    JAX package (the whole fleet refactorized when a member adapts) or,
    with ``member_refactor``, as in the kernel.  Returns every field of
    :class:`LaneSolution`."""
    B, m, n = A.shape
    P, q, l, u = P.expand(B, n, n), q.expand(B, n), l.expand(B, m), u.expand(B, m)
    Pt, At = P.permute(1, 2, 0), A.permute(1, 2, 0)
    lt, ut, qt = l.T, u.T, q.T
    if factors is None:
        c, sxt, syt, rhot, Pst, Ast, sweeps = _lane_scaling(Pt, qt, At, lt, ut, prm)
        Mredt, Minvt, fail = _lane_chol_inverse(Pst, Ast, rhot, prm.sigma)
        sx, sy, fact_ok = sxt.T, syt.T, ~fail
    else:
        c, sx, sy, rho, Ps, As, Mred, Minv, fact_ok = factors
        rhot, Pst, Ast = rho.T, Ps.permute(1, 2, 0), As.permute(1, 2, 0)
        Mredt, Minvt = Mred.permute(1, 2, 0), Minv.permute(1, 2, 0)
        sweeps = torch.zeros((B,), dtype=torch.int32, device=A.device)
    warm = None if xw is None else _Warm(xw, yw)
    scal = QPFactors(c, sx, sy, None, None, None, None, None, fact_ok)
    _, _, _, qs, ls, us, x0, z0, y0, status0 = _scaled_inputs(A, q, l, u, scal, warm, False)
    x, z, y, status, iters, pres, dres, refactors = _lane_loop(
        prm, Pt, qt, At, lt, ut, c, sx.T, sy.T, rhot, Pst, Ast, Mredt, Minvt,
        qs.T, ls.T, us.T, x0.T, z0.T, y0.T, status0, member_refactor,
    )
    x, z, y = x.T, z.T, y.T
    primal = sx * x
    dual = sy * y / c[:, None]
    objective = (primal * (0.5 * _mv(P, primal) + q)).sum(dim=1)
    return LaneSolution(primal, dual, status, iters, objective, pres, dres, refactors, sweeps,
                        x, z, y, c, sx, sy)


def _lane_check_args(prm, P, q, A, l, u, xw, yw, factors):
    """Check the lane kernel's operands (see ``qp.solver._lane_args``):
    float32 on one device, batch-leading with contiguous inner axes, the
    factors contiguous; returns ``(B, n, m)``."""
    if not isinstance(A, torch.Tensor) or A.dim() != 3:
        raise ValueError("A must be a (B, m, n) tensor")
    B, m, n = A.shape
    dev = A.device
    named = {"P": (P, (n, n)), "q": (q, (n,)), "A": (A, (m, n)), "l": (l, (m,)), "u": (u, (m,))}
    if (xw is None) != (yw is None):
        raise ValueError("the warm start's primal and dual are given together or not at all")
    if xw is not None:
        named.update(xw=(xw, (n,)), yw=(yw, (m,)))
    for name, (t, inner) in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if tuple(t.shape) != (B,) + inner:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B,) + inner}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not _inner_contiguous(t) or t.stride(0) < 0:
            raise ValueError(f"{name} must have contiguous inner axes")
    if factors is not None:
        inner = ((), (n,), (m,), (m,), (n, n), (m, n), (n, n), (n, n), ())
        for name, t, shape in zip(QPFactors._fields, factors, inner):
            want = torch.bool if name == "fact_ok" else torch.float32
            if not isinstance(t, torch.Tensor) or tuple(t.shape) != (B,) + shape:
                raise ValueError(f"factors.{name} must be a tensor of shape {(B,) + shape}")
            if t.dtype != want or t.device != dev or not t.is_contiguous():
                raise ValueError(f"factors.{name} must be contiguous {want} on {dev}")
    if prm.stop_check_iter < 1:
        raise ValueError("stop_check_iter must be >= 1")
    if not lane_fits(n, m):
        raise ValueError(
            f"the lane kernel cannot hold n={n}, m={m}: one problem needs "
            f"{lane_problem_bytes(n, m)} <= {SMEM_LIMIT} bytes of shared memory"
        )
    return B, n, m


def _batch_stride(t):
    return 0 if t is None or t.shape[0] == 1 else t.stride(0)


def _lane_call(lib, prm, P, q, A, l, u, xw, yw, factors, scaled, clocks, clock_member, stream):
    """One ``admm_lane_launch`` of ``lib`` on checked operands: one output
    allocation (the fields are views of it), the launch, its CUDA code
    (raises where it is not 0)."""
    B, m, n = A.shape
    ppb = lane_plan(B, n, m)[0]
    # (shape a member, int32) of primal, dual, objective, pres, dres,
    # status, iters, refactors, sweeps, then x, z, y, c, sx, sy
    layout = [((n,), False), ((m,), False), ((), False), ((), False), ((), False),
              ((), True), ((), True), ((), True), ((), True)]
    if scaled:
        layout += [((n,), False), ((m,), False), ((m,), False), ((), False), ((n,), False),
                   ((m,), False)]
    buf = torch.empty(B * sum(math.prod(s) for s, _ in layout), dtype=torch.float32,
                      device=A.device)
    fields, off = [], 0
    for shape, is_int in layout:
        size = B * math.prod(shape)
        f = buf[off:off + size]
        fields.append((f.view(torch.int32) if is_int else f).view((B,) + shape))
        off += size
    primal, dual, objective, pres, dres, status, iters, refactors, sweeps = fields[:9]
    scaled_out = fields[9:] if scaled else [None] * 6
    ptr = lambda t: None if t is None else t.data_ptr()
    fac = [None] * 9 if factors is None else list(factors)
    err = lib.admm_lane_launch(
        *(ptr(t) for t in (P, q, A, l, u, xw, yw, *fac)),
        *(ptr(t) for t in (primal, dual, objective, pres, dres, status, iters, refactors, sweeps,
                           *scaled_out, clocks)),
        *(_batch_stride(t) for t in (P, q, A, l, u, xw, yw)),
        clock_member, B, n, m, ppb,
        prm.alpha, prm.sigma, prm.rho, prm.rho_eq_scale * prm.rho, prm.eps_abs, prm.eps_rel,
        prm.eps_primal_inf, prm.eps_dual_inf, prm.adaptive_rho_tol,
        prm.max_iter, prm.stop_check_iter, max(0, prm.kkt_refine_iters),
        int(prm.adaptive_rho), int(prm.compensated_check), int(prm.scaling), stream,
    )
    if err != 0:
        raise RuntimeError(f"admm_lane_launch failed: CUDA error {err}")
    x, z, y, c, sx, sy = scaled_out
    return LaneSolution(primal, dual, status, iters, objective, pres, dres, refactors, sweeps,
                        x, z, y, c, sx, sy)


def admm_solve_cuda_lane(
    prm: QPSolverParams, P, q, A, l, u, xw=None, yw=None, factors=None, scaled=False,
    clocks=None, clock_member=0,
) -> LaneSolution:
    """The lane backend's whole solve on float32 tensors, batch-leading (the
    operands ``qp.lane_kernel_args`` prepares).

    CUDA tensors launch ``csrc/admm_lane.cu`` once (or raise): scaling,
    per-row rho, the scaled warm start, factorization, the loop with
    adaptive rho and the unscaled solution in the kernel, the outputs views
    of one allocation; ``scaled`` also returns the scaled iterates and the
    scalings (polish needs them).  ``clocks``, an int64 CUDA tensor of 8,
    takes member ``clock_member``'s clock64 split (prologue,
    factorization, iterations without and with a check, refactorizations,
    epilogue cycles, then the two iteration counts).  CPU tensors run
    :func:`admm_solve_lane_reference` with the kernel's member
    refactorization.  Returns a :class:`LaneSolution`."""
    B, n, m = _lane_check_args(prm, P, q, A, l, u, xw, yw, factors)
    if _device_type(A) == "cpu":
        return admm_solve_lane_reference(prm, P, q, A, l, u, xw, yw, factors, member_refactor=True)
    if clocks is not None and (clocks.dtype != torch.int64 or clocks.numel() < 8
                               or clocks.device != A.device):
        raise ValueError("clocks must be an int64 tensor of 8 on the problems' device")
    from .. import _build

    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        out = _lane_call(_build.load(), prm, P, q, A, l, u, xw, yw, factors, scaled, clocks,
                         clock_member, stream)
    with _count_lock:
        admm_solve_cuda_lane.launches += 1
    return out


admm_solve_cuda_lane.launches = 0
