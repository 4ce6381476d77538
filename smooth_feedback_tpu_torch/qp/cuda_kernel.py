"""Shared-matrix fused ADMM iteration: CUDA kernel wrapper and plain version.

The kernel (``csrc/admm_shared.cu``) replaces the TPU kernel
``smooth_feedback_tpu/qp/pallas_kernel.py::_admm_kernel_shared`` (called
through ``admm_iterate_pallas_shared``).  Every problem of the batch shares the
scaled ``Minv``, ``As`` and ``Ps``; each has its own vectors and warm start.

On an H100 the kernel is bound by latency and FMA issue rate, not by HBM: the
three shared matrices stay resident in shared memory for the whole solve and
every problem's vectors stay in registers, so device memory sees one read of
the inputs and one write of the outputs.  The design answers that with one
warp per problem, each running its own loop and exiting on its own (a
member's result does not depend on the rest of its block, so this equals the
TPU kernel's block-lockstep semantics), and with many warps resident per SM
to hide the latency of the dependent product chain.  Each lane accumulates its
own outputs with fp32 FMAs; matrices are stored with an odd row stride, so
both row and column reads are free of bank conflicts.

:func:`admm_iterate_cuda_shared` launches the kernel on CUDA tensors and runs
:func:`admm_iterate_shared_reference` on CPU tensors; nothing else chooses
the plain version.  Its ``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import torch

from .solver import _DUAL_INF, _MAX_ITER, _OPTIMAL, _PRIMAL_INF, _RUNNING, _UNKNOWN, _norm_inf
from .types import QPSolverParams

# what one block may hold on an H100 (232,448 bytes of shared memory)
SMEM_LIMIT = 232448
MAX_DIM = 128  # entries per lane are instantiated up to 4 (csrc: K <= 4)
MAX_BLOCK = 8  # warps per block (csrc: __launch_bounds__(256))


def admm_iterate_shared_reference(
    prm: QPSolverParams, Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0
):
    """Plain batched torch version of the shared-matrix ADMM loop (any dtype).

    Same updates, stopping check, certificates and freeze semantics as the
    kernel; the shared matrices stay 2-D, so every product is one
    ``(B, k) @ (k, j)`` GEMM.  Returns ``(x, z, y, status, iters, pres,
    dres)`` in scaled variables."""
    B = qs.shape[0]
    dt, dev = qs.dtype, qs.device
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    alpha, sigma = prm.alpha, prm.sigma
    eps_abs, eps_rel = prm.eps_abs, prm.eps_rel
    eps_pinf, eps_dinf = prm.eps_primal_inf, prm.eps_dual_inf
    k = prm.stop_check_iter

    mu_inf = u >= inf
    ml_inf = l <= -inf
    uv_fin = torch.where(mu_inf, 0.0, u)
    lv_fin = torch.where(ml_inf, 0.0, l)
    inv_sy = 1.0 / sy
    inv_csx = 1.0 / (c * sx)
    AsT, PsT = As.T, Ps.T

    def check(x, z, y, x_old, y_old):
        Ax = (x @ AsT) * inv_sy
        z_us = z * inv_sy
        pres = _norm_inf(Ax - z_us)
        prim_ok = pres <= eps_abs + eps_rel * torch.maximum(_norm_inf(Ax), _norm_inf(z_us))

        Px = (x @ PsT) * inv_csx
        Aty = (y @ As) * inv_csx
        qv = qs * inv_csx
        dres = _norm_inf(Px + qv + Aty)
        dscale = torch.maximum(_norm_inf(Px), torch.maximum(_norm_inf(qv), _norm_inf(Aty)))
        dual_ok = dres <= eps_abs + eps_rel * dscale
        optimal = prim_ok & dual_ok

        dy_us = sy * (y - y_old) / c
        E = _norm_inf(dy_us)[:, None]
        Atdy = ((y - y_old) @ As) * inv_csx
        viol = ((mu_inf & (dy_us > eps_pinf * E)) | (ml_inf & (dy_us < -eps_pinf * E))).any(dim=1)
        sum_term = (
            uv_fin * torch.clamp(dy_us, min=0.0) + lv_fin * torch.clamp(dy_us, max=0.0)
        ).sum(dim=1)
        prim_inf = ~viol & (torch.maximum(_norm_inf(Atdy), sum_term) < eps_pinf * E[:, 0])

        dx_us = sx * (x - x_old)
        dxn = _norm_inf(dx_us)
        Pdx = ((x - x_old) @ PsT) * inv_csx
        Adx = ((x - x_old) @ AsT) * inv_sy
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
        rhs = sigma * x - qs + (rho * z - y) @ As
        xt = rhs @ Minv
        zt = xt @ AsT

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


def smem_bytes(n: int, m: int, warps: int) -> int:
    """Shared memory one block of the kernel needs (mirrors the C function)."""
    ld = n | 1
    K = (max(n, m) + 31) // 32
    return 4 * (ld * (2 * n + m) + warps * 32 * K)


def _check_args(prm, Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0):
    B, n = qs.shape
    m = ls.shape[1]
    shapes = {
        "Minv": (Minv, (n, n)), "As": (As, (m, n)), "Ps": (Ps, (n, n)),
        "rho": (rho, (m,)), "sx": (sx, (n,)), "sy": (sy, (m,)), "c": (c, ()),
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
    if not 1 <= prm.kernel_block <= MAX_BLOCK:
        raise ValueError(f"kernel_block must be in [1, {MAX_BLOCK}], got {prm.kernel_block}")
    if prm.stop_check_iter < 1:
        raise ValueError("stop_check_iter must be >= 1")
    if max(n, m) > MAX_DIM or smem_bytes(n, m, prm.kernel_block) > SMEM_LIMIT:
        raise ValueError(
            f"the shared-matrix kernel cannot hold n={n}, m={m}: it needs "
            f"max(n, m) <= {MAX_DIM} and {smem_bytes(n, m, prm.kernel_block)} "
            f"<= {SMEM_LIMIT} bytes of shared memory"
        )
    return B, n, m


def admm_iterate_cuda_shared(
    prm: QPSolverParams, Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0
):
    """Shared-matrix fused ADMM on float32 tensors.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors run
    :func:`admm_iterate_shared_reference`.  ``c`` is a 0-d tensor.  Returns
    ``(x, z, y, status, iters, pres, dres)`` in scaled variables."""
    args = (Minv, As, Ps, qs, ls, us, rho, sx, sy, c, l, u, x0, z0, y0, status0)
    B, n, m = _check_args(prm, *args)
    if qs.device.type == "cpu":
        return admm_iterate_shared_reference(prm, *args)
    if qs.device.type != "cuda":
        raise ValueError(f"unsupported device {qs.device}")

    from .. import _build

    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=qs.device)
    i32 = dict(dtype=torch.int32, device=qs.device)
    x = torch.empty((B, n), **f32)
    z = torch.empty((B, m), **f32)
    y = torch.empty((B, m), **f32)
    status = torch.empty((B,), **i32)
    iters = torch.empty((B,), **i32)
    pres = torch.empty((B,), **f32)
    dres = torch.empty((B,), **f32)
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        err = lib.admm_shared_launch(
            *(t.data_ptr() for t in (Minv, As, Ps, rho, sx, sy, c, qs, ls, us, l, u, x0, z0, y0, status0)),
            *(t.data_ptr() for t in (x, z, y, status, iters, pres, dres)),
            B, n, m, prm.kernel_block,
            prm.alpha, prm.sigma, prm.eps_abs, prm.eps_rel,
            prm.eps_primal_inf, prm.eps_dual_inf,
            prm.max_iter, prm.stop_check_iter, stream,
        )
    if err != 0:
        raise RuntimeError(f"admm_shared kernel launch failed: CUDA error {err}")
    admm_iterate_cuda_shared.launches += 1
    return x, z, y, status, iters, pres, dres


admm_iterate_cuda_shared.launches = 0
