"""Quadratic-program problem and solution types (PyTorch port).

Counterpart of ``smooth_feedback_tpu/qp/types.py``: the problem

    min_x  0.5 x' P x + q' x
    s.t.   l <= A x <= u

is a NamedTuple of dense tensors; batches of QPs are leading axes on every
field.  Status codes and solver-parameter defaults are identical to the JAX
package, so results of the two packages compare field by field.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import torch


class QuadraticProgram(NamedTuple):
    """Dense QP data."""

    P: torch.Tensor  # (n, n) cost quadratic (only symmetric part matters)
    q: torch.Tensor  # (n,)   cost linear
    A: torch.Tensor  # (m, n) constraint matrix
    l: torch.Tensor  # (m,)   lower bounds (-inf allowed)
    u: torch.Tensor  # (m,)   upper bounds (+inf allowed)


class QPSolutionStatus(enum.IntEnum):
    """Solver return codes; the same integers as the JAX package."""

    Optimal = 0
    PolishFailed = 1
    PrimalInfeasible = 2
    DualInfeasible = 3
    MaxIterations = 4
    MaxTime = 5
    Unknown = 6
    # internal sentinel: still iterating (never returned)
    Running = -1


class QPSolution(NamedTuple):
    """Solution tensors (leading batch axes where the problem has them)."""

    primal: torch.Tensor  # (n,)
    dual: torch.Tensor  # (m,)
    status: torch.Tensor  # int32, a QPSolutionStatus value
    iters: torch.Tensor  # int32
    objective: torch.Tensor
    primal_res: torch.Tensor  # inf-norm primal residual at last stopping check
    dual_res: torch.Tensor  # inf-norm dual residual at last stopping check


@dataclasses.dataclass(frozen=True)
class QPSolverParams:
    """ADMM solver options; fields and defaults match the JAX package.

    ``backend``:
      ``"torch"`` the plain batched loop (any dtype, any device);
      ``"cuda"``  the hand-written CUDA kernels (``qp/cuda_kernel.py``,
                  float32): the shared-matrix kernel against shared factors,
                  the per-problem kernel otherwise.  On CPU tensors their
                  wrappers run the kernels' plain version.
    ``kernel_block``: problems per thread block of the shared-matrix kernel,
    1 to 8 (a block's warps each advance a group of 2 of them together;
    the launch takes smaller blocks for a fleet too small to give every SM
    one); the per-problem kernel runs one problem per block.
    """

    alpha: float = 1.6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    scaling: bool = True
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    eps_primal_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    max_iter: int = 4000
    stop_check_iter: int = 25
    polish: bool = True
    polish_iter: int = 5
    delta: float = 1e-6
    kkt_refine_iters: int = 0
    backend: str = "torch"
    kernel_block: int = 8
    sort_stragglers: bool = False
    adaptive_rho: bool = False
    adaptive_rho_tol: float = 5.0
    compensated_check: bool = False
    # a host line of residual summaries at every stopping check of the torch
    # loop (the kernels print nothing)
    verbose: bool = False


def random_qp(
    n: int,
    m: int,
    density: float = 1.0,
    dtype=torch.float64,
    device=None,
    generator: torch.Generator | None = None,
) -> QuadraticProgram:
    """Random feasible QP, the JAX package's construction: P = M M' (PSD)
    with M's entries kept with probability ``density``, A ~ N(0, 1), and
    bounds straddling A x0 for a random x0 (spread |N(0, 1)| + 0.1).

    The draws come from ``generator`` (a ``torch.Generator``, by default one
    seeded with 0 on ``device``), on ``device`` (by default the generator's).
    This is not ``jax.random``'s stream: the same seed gives another problem
    than the JAX package's ``random_qp``, of the same distribution."""
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    device = generator.device if device is None else torch.device(device)
    kw = dict(dtype=dtype, device=device, generator=generator)
    M = torch.randn((n, n), **kw)
    if density < 1.0:
        keep = torch.rand((n, n), dtype=dtype, device=device, generator=generator) < density
        M = M * keep
    P = M @ M.T
    q = torch.randn((n,), **kw)
    A = torch.randn((m, n), **kw)
    x0 = torch.randn((n,), **kw)
    center = A @ x0
    spread = torch.randn((m,), **kw).abs() + 0.1
    return QuadraticProgram(P=P, q=q, A=A, l=center - spread, u=center + spread)


def warmstart_like(qp: QuadraticProgram) -> QPSolution:
    """Zero warmstart with shapes, dtype and device matching ``qp``."""
    n = qp.A.shape[-1]
    m = qp.A.shape[-2]
    batch = tuple(qp.A.shape[:-2])
    dt, dev = qp.A.dtype, qp.A.device
    return QPSolution(
        primal=torch.zeros(batch + (n,), dtype=dt, device=dev),
        dual=torch.zeros(batch + (m,), dtype=dt, device=dev),
        status=torch.full(batch, int(QPSolutionStatus.Unknown), dtype=torch.int32, device=dev),
        iters=torch.zeros(batch, dtype=torch.int32, device=dev),
        objective=torch.zeros(batch, dtype=dt, device=dev),
        primal_res=torch.zeros(batch, dtype=dt, device=dev),
        dual_res=torch.zeros(batch, dtype=dt, device=dev),
    )
