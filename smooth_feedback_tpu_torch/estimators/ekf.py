"""Extended Kalman filter on Lie groups (PyTorch port of
``smooth_feedback_tpu/estimators/ekf.py``): right-Jacobian / IEKF form.

The filter state is a plain NamedTuple ``EKFState(g, P)`` and ``predict`` /
``update`` are pure functions, so a fleet of per-member filters runs under
``torch.func.vmap``.  Covariance propagation uses the body-frame
linearization ``A = -ad(f(t, g)) + d^r f / dg``.

Besides the plain, iterated and square-root per-member forms, the module
holds the fleet forms of the JAX package.  Their public states keep the JAX
layout, the covariance (or its factor) batch-TRAILING as ``(ndof, ndof, B)``,
so states convert one to one between the packages.  That layout is a TPU
tiling device (the fleet on the 128 lanes); on a GPU the batched library
calls want the batch leading.  So each fleet function moves the stack to
``(B, ndof, ndof)`` once on entry and back on exit (``movedim``, views, no
copy) and runs its algebra as batched products, one ``cholesky_ex`` and two
triangular solves (covariance form) or one batched QR (square-root form) per
call, where the unrolled lane helpers of ``utils/linalg.py`` would launch
dozens of elementwise kernels.

Every tangent Jacobian of a user callable is cast back to the working dtype
(``_jac``): torch 2.13's forward mode gives a 0-d float32 tensor times a
Python scalar a float64 tangent (see ``controllers/asif.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from .._func import jacfwd
from .._precision import ieee_f32_matmul
from ..groups.base import LieGroup, ad_generators

_STEPPERS = ("euler", "rk4")


class EKFState(NamedTuple):
    """Filter estimate and covariance."""

    g: torch.Tensor  # (nparams,) group element
    P: torch.Tensor  # (ndof, ndof) covariance


def _jac(fn, z):
    """``jacfwd(fn)(z)`` in the dtype of ``z``."""
    return jacfwd(fn)(z).to(z.dtype)


def _sym(P):
    return 0.5 * (P + P.transpose(-1, -2))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _check_stepper(stepper):
    if stepper not in _STEPPERS:
        raise ValueError(f"unknown stepper {stepper!r}")


def _chol_solve(S, B):
    """``S^{-1} B`` for a (batch of) SPD ``S``: ``cholesky_ex`` and two
    triangular solves (batched cuBLAS on the card; ``cholesky_solve`` loops
    over the batch there unless MAGMA takes it)."""
    L = torch.linalg.cholesky_ex(S).L
    Z = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Z, upper=True)


def ekf_reset(G: LieGroup, g: torch.Tensor, P: Optional[torch.Tensor] = None) -> EKFState:
    """Create a filter state (``P`` defaults to the identity)."""
    if P is None:
        P = _eye(G.ndof, g)
    return EKFState(g=g, P=P)


def ekf_predict(
    G: LieGroup,
    f: Callable,
    state: EKFState,
    Q: torch.Tensor,
    tau,
    n_steps: int = 1,
    stepper: str = "euler",
) -> EKFState:
    """Propagate the filter through dynamics ``d^r x_t = f(t, x)`` over
    ``[0, tau]`` with process covariance ``Q``, in ``n_steps`` fixed steps.
    The covariance steps first, with the pre-step estimate."""
    _check_stepper(stepper)
    g, P = state
    tau = torch.as_tensor(tau, dtype=P.dtype, device=P.device)
    h = tau / n_steps
    z = torch.zeros((G.ndof,), dtype=P.dtype, device=P.device)

    def cov_rhs(t, g, P):
        fv = f(t, g)
        A = -G.ad(fv) + _jac(lambda w: f(t, G.rplus(g, w)), z)
        return A @ P + P @ A.T + Q

    def state_step(t, g):
        if stepper == "euler":
            return G.rplus(g, h * f(t, g))
        k1 = f(t, g)
        k2 = f(t + 0.5 * h, G.rplus(g, 0.5 * h * k1))
        k3 = f(t + 0.5 * h, G.rplus(g, 0.5 * h * k2))
        k4 = f(t + h, G.rplus(g, h * k3))
        return G.rplus(g, (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4))

    def cov_step(t, g, P):
        if stepper == "euler":
            return _sym(P + h * cov_rhs(t, g, P))
        k1 = cov_rhs(t, g, P)
        k2 = cov_rhs(t + 0.5 * h, g, P + 0.5 * h * k1)
        k3 = cov_rhs(t + 0.5 * h, g, P + 0.5 * h * k2)
        k4 = cov_rhs(t + h, g, P + h * k3)
        return _sym(P + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4))

    with ieee_f32_matmul():
        for i in range(n_steps):
            t = i * h
            P = cov_step(t, g, P)  # covariance first: uses the pre-step g
            g = state_step(t, g)
    return EKFState(g=g, P=P)


def _meas_lin(G, h, g, y, Y, z, e=None):
    """Measurement Jacobian (m, n) and innovation (m,) of one member.  With
    ``e``, ``h`` is evaluated at ``g (+) e`` and differentiated in the
    tangent space at ``g`` (the Gauss-Newton Jacobian that pairs with a
    covariance anchored at ``g``)."""
    if e is None:
        at = lambda w: G.rplus(g, w)
        hval = h(g)
    else:
        at = lambda w: G.rplus(g, e + w)
        hval = h(G.rplus(g, e))
    if Y is None:
        return _jac(lambda w: h(at(w)), z), y - hval
    return _jac(lambda w: Y.rminus(h(at(w)), hval), z), Y.rminus(y, hval)


def _joseph(P, K, H, R):
    """Joseph-form posterior ``(I - K H) P (I - K H)' + K R K'``
    (symmetrized); keeps P positive semidefinite through long f32 runs."""
    IKH = _eye(P.shape[-1], P) - K @ H
    return _sym(IKH @ P @ IKH.transpose(-1, -2) + K @ R @ K.transpose(-1, -2))


def ekf_update(
    G: LieGroup,
    h: Callable,
    state: EKFState,
    y: torch.Tensor,
    R: torch.Tensor,
    Y: Optional[LieGroup] = None,
) -> EKFState:
    """Measurement update with ``y = h(x) + w``, ``w ~ N(0, R)``.  If ``Y``
    is given, ``h`` maps into that group and the innovation is
    ``y (-) h(g)``; otherwise ``h`` returns a Euclidean vector."""
    g, P = state
    z = torch.zeros((G.ndof,), dtype=P.dtype, device=P.device)
    H, innov = _meas_lin(G, h, g, y, Y, z)
    with ieee_f32_matmul():
        HP = H @ P
        K = _chol_solve(_sym(HP @ H.T + R), HP).T
        g_new = G.rplus(g, K @ innov)
        return EKFState(g=g_new, P=_joseph(P, K, H, R))


def ekf_update_iterated(
    G: LieGroup,
    h: Callable,
    state: EKFState,
    y: torch.Tensor,
    R: torch.Tensor,
    Y: Optional[LieGroup] = None,
    iters: int = 3,
) -> EKFState:
    """Iterated measurement update (Gauss-Newton relinearization): each sweep
    relinearizes ``h`` at ``g0 (+) e_k`` and applies ``e_{k+1} = K_k (r_k +
    H_k e_k)`` in the tangent space at ``g0``.  ``iters=1`` is
    :func:`ekf_update`."""
    g0, P = state
    z = torch.zeros((G.ndof,), dtype=P.dtype, device=P.device)
    e = z
    with ieee_f32_matmul():
        for _ in range(max(1, iters)):
            H, rk = _meas_lin(G, h, g0, y, Y, z, e=e)
            HP = H @ P
            K = _chol_solve(_sym(HP @ H.T + R), HP).T
            e = K @ (rk + H @ e)
        return EKFState(g=G.rplus(g0, e), P=_joseph(P, K, H, R))


# ---------------------------------------------------------------------------
# Square-root forms
# ---------------------------------------------------------------------------


class SqrtEKFState(NamedTuple):
    """Square-root filter state: ``P = S @ S.T`` with ``S`` lower-triangular,
    which stays positive semidefinite by construction in long f32 runs."""

    g: torch.Tensor  # (nparams,)
    S: torch.Tensor  # (ndof, ndof) lower-triangular, P = S S'


def _qr_lower(M):
    """Lower-triangular T with ``T T' = M M'`` (thin QR of M'), for one
    (n, k) matrix or a batch (..., n, k), k >= n.  Sign-normalized to a
    non-negative diagonal, so the factor is unique."""
    r = torch.linalg.qr(M.transpose(-1, -2), mode="r").R
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    s = torch.sign(torch.where(d == 0, torch.ones_like(d), d))
    return (r * s[..., :, None]).transpose(-1, -2)


def _psd_sqrt_lower(M):
    """Lower-triangular T with ``T T' = M`` for a PSD, possibly singular, M
    (one matrix or a batch): an eigh-based square root with the negative
    eigenvalues clamped, then :func:`_qr_lower`.  A Cholesky factor would
    be NaN on singular noise (zero process noise on some states)."""
    w, V = torch.linalg.eigh(_sym(M))
    return _qr_lower(V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :])


def sqrt_ekf_reset(G: LieGroup, g: torch.Tensor, P: Optional[torch.Tensor] = None) -> SqrtEKFState:
    if P is None:
        P = _eye(G.ndof, g)
    return SqrtEKFState(g=g, S=_psd_sqrt_lower(torch.as_tensor(P)))


def sqrt_ekf_predict(
    G: LieGroup,
    f: Callable,
    state: SqrtEKFState,
    Q: torch.Tensor,
    tau,
    n_steps: int = 1,
) -> SqrtEKFState:
    """Square-root covariance propagation (array form): per Euler substep
    ``S <- qr-lower([Phi S, chol(h Q)])``, ``Phi = I + h A``, with the
    linearization of :func:`ekf_predict`.  This is the discrete propagation
    ``Phi P Phi' + h Q``; it differs from :func:`ekf_predict`'s
    ``P + h (A P + P A' + Q)`` at O(h^2) per substep."""
    g, S = state
    dt, dev = S.dtype, S.device
    tau = torch.as_tensor(tau, dtype=dt, device=dev)
    h = tau / n_steps
    z = torch.zeros((G.ndof,), dtype=dt, device=dev)
    eye = _eye(G.ndof, S)
    with ieee_f32_matmul():
        Qh = _psd_sqrt_lower(torch.as_tensor(Q, dtype=dt, device=dev) * h)
        for i in range(n_steps):
            t = i * h
            fv = f(t, g)
            A = -G.ad(fv) + _jac(lambda w: f(t, G.rplus(g, w)), z)
            S = _qr_lower(torch.cat([(eye + h * A) @ S, Qh], dim=1))
            g = G.rplus(g, h * fv)
    return SqrtEKFState(g=g, S=S)


def sqrt_ekf_update(
    G: LieGroup,
    h: Callable,
    state: SqrtEKFState,
    y: torch.Tensor,
    R: torch.Tensor,
    Y: Optional[LieGroup] = None,
) -> SqrtEKFState:
    """Square-root measurement update by the QR array algorithm (Kailath):

        [[Rh,  H S],        [[X,  0],
         [0,   S  ]]   ->    [Yb, Z]]   (lower-triangularization by QR)

    with ``X X' = H P H' + R``, ``K = Yb X^{-1}`` and ``Z`` the posterior
    factor; no covariance is formed."""
    g, S = state
    n = G.ndof
    z = torch.zeros((n,), dtype=S.dtype, device=S.device)
    H, innov = _meas_lin(G, h, g, y, Y, z)
    m = H.shape[0]
    with ieee_f32_matmul():
        Rh = _psd_sqrt_lower(torch.as_tensor(R, dtype=S.dtype, device=S.device))
        pre = torch.cat([
            torch.cat([Rh, H @ S], dim=1),
            torch.cat([S.new_zeros((n, m)), S], dim=1),
        ])
        T = _qr_lower(pre)
        K = torch.linalg.solve_triangular(T[:m, :m], T[m:, :m], upper=False, left=False)
        return SqrtEKFState(g=G.rplus(g, K @ innov), S=T[m:, m:])


# ---------------------------------------------------------------------------
# Fleet forms: public states batch-trailing, algebra batch-leading
# ---------------------------------------------------------------------------


class EKFFleetState(NamedTuple):
    """Fleet filter state in the JAX package's layout: ``g`` batch-leading,
    ``Pt[:, :, b]`` = member b's covariance."""

    g: torch.Tensor  # (B, nparams)
    Pt: torch.Tensor  # (ndof, ndof, B)


def ekf_fleet_reset(G: LieGroup, g: torch.Tensor, P: Optional[torch.Tensor] = None) -> EKFFleetState:
    """A fleet state from batch-leading inputs: ``P`` a shared (ndof, ndof)
    covariance (broadcast, no copy) or a per-member (B, ndof, ndof) stack."""
    B, n = g.shape[0], G.ndof
    P = _eye(n, g) if P is None else torch.as_tensor(P)
    if P.dim() == 2:
        return EKFFleetState(g=g, Pt=P[:, :, None].expand(n, n, B))
    return EKFFleetState(g=g, Pt=P.movedim(0, -1))


def ekf_fleet_states(G: LieGroup, fleet: EKFFleetState) -> EKFState:
    """The batch-leading ``EKFState`` of a fleet (for ``vmap`` of the
    per-member functions)."""
    return EKFState(g=fleet.g, P=fleet.Pt.movedim(-1, 0))


def _noise_b(M, dtype, device):
    """Shared (n, n) or per-member (B, n, n) noise as a batch-leading stack,
    (1, n, n) or (B, n, n).  A 3-D input is always batch-leading, whatever
    B and n (the JAX package's ``_noise_t`` convention)."""
    M = torch.as_tensor(M, dtype=dtype, device=device)
    return M[None] if M.dim() == 2 else M


def _fleet_A(G, f, t, g, z, adgen):
    """Velocities (B, n) and linearizations ``-ad(f) + d^r f`` (B, n, n) of a
    fleet; ``ad`` assembles from its constant generators."""
    fv = vmap(lambda gi: f(t, gi))(g)
    J = vmap(lambda gi: _jac(lambda w: f(t, G.rplus(gi, w)), z))(g)
    return fv, J - torch.einsum("kij,bk->bij", adgen, fv)


def ekf_fleet_predict(
    G: LieGroup,
    f: Callable,
    state: EKFFleetState,
    Q: torch.Tensor,
    tau,
    n_steps: int = 1,
    stepper: str = "euler",
) -> EKFFleetState:
    """Fleet :func:`ekf_predict`: the same math as ``vmap(ekf_predict)``.
    ``f`` is per-member ``f(t, g) -> (ndof,)``; ``Q`` shared (n, n) or
    per-member (B, n, n)."""
    _check_stepper(stepper)
    g, Pt = state
    dt, dev = Pt.dtype, Pt.device
    P = Pt.movedim(-1, 0)  # (B, n, n)
    tau = torch.as_tensor(tau, dtype=dt, device=dev)
    h = tau / n_steps
    z = torch.zeros((G.ndof,), dtype=dt, device=dev)
    Qb = _noise_b(Q, dt, dev)
    adgen = ad_generators(G, dtype=dt, device=dev)

    def cov_rhs(A, P):
        AP = A @ P
        return AP + AP.transpose(1, 2) + Qb

    with ieee_f32_matmul():
        for i in range(n_steps):
            t = i * h
            # covariance first: uses the pre-step estimate
            if stepper == "euler":
                fv, A = _fleet_A(G, f, t, g, z, adgen)
                P = _sym(P + h * cov_rhs(A, P))
                g = vmap(lambda gi, fi: G.rplus(gi, h * fi))(g, fv)
                continue
            # rk4: stages relinearize at the stage time, at the pre-step g
            _, A1 = _fleet_A(G, f, t, g, z, adgen)
            _, A2 = _fleet_A(G, f, t + 0.5 * h, g, z, adgen)
            _, A4 = _fleet_A(G, f, t + h, g, z, adgen)
            k1 = cov_rhs(A1, P)
            k2 = cov_rhs(A2, P + 0.5 * h * k1)
            k3 = cov_rhs(A2, P + 0.5 * h * k2)
            k4 = cov_rhs(A4, P + h * k3)
            P = _sym(P + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4))

            def rk4_state(gi):
                c1 = f(t, gi)
                c2 = f(t + 0.5 * h, G.rplus(gi, 0.5 * h * c1))
                c3 = f(t + 0.5 * h, G.rplus(gi, 0.5 * h * c2))
                c4 = f(t + h, G.rplus(gi, h * c3))
                return G.rplus(gi, (h / 6.0) * (c1 + 2 * c2 + 2 * c3 + c4))

            g = vmap(rk4_state)(g)
    return EKFFleetState(g=g, Pt=P.movedim(0, -1))


def _fleet_meas_lin(G, h, g, y, Y, z, e=None):
    """Per-member measurement Jacobians (B, m, n) and innovations (B, m) of
    a fleet (:func:`_meas_lin` under ``vmap``)."""
    if e is None:
        return vmap(lambda gi, yi: _meas_lin(G, h, gi, yi, Y, z))(g, y)
    return vmap(lambda gi, yi, ei: _meas_lin(G, h, gi, yi, Y, z, e=ei))(g, y, e)


def _fleet_gain(P, H, Rb):
    """Kalman gains (B, n, m) of a batch-leading fleet."""
    PHt = P @ H.transpose(1, 2)
    S = _sym(H @ PHt + Rb)
    return _chol_solve(S, PHt.transpose(1, 2)).transpose(1, 2)


def ekf_fleet_update(
    G: LieGroup,
    h: Callable,
    state: EKFFleetState,
    y: torch.Tensor,
    R: torch.Tensor,
    Y: Optional[LieGroup] = None,
) -> EKFFleetState:
    """Fleet :func:`ekf_update` (Joseph form): ``y`` is (B, m); ``R`` shared
    (m, m) or per-member (B, m, m)."""
    g, Pt = state
    dt, dev = Pt.dtype, Pt.device
    P = Pt.movedim(-1, 0)
    z = torch.zeros((G.ndof,), dtype=dt, device=dev)
    H, innov = _fleet_meas_lin(G, h, g, y, Y, z)
    Rb = _noise_b(R, dt, dev)
    with ieee_f32_matmul():
        K = _fleet_gain(P, H, Rb)
        g_new = vmap(G.rplus)(g, (K @ innov[:, :, None])[:, :, 0])
        P_new = _joseph(P, K, H, Rb)
    return EKFFleetState(g=g_new, Pt=P_new.movedim(0, -1))


def ekf_fleet_update_iterated(
    G: LieGroup,
    h: Callable,
    state: EKFFleetState,
    y: torch.Tensor,
    R: torch.Tensor,
    Y: Optional[LieGroup] = None,
    iters: int = 3,
) -> EKFFleetState:
    """Fleet :func:`ekf_update_iterated`; ``iters=1`` is
    :func:`ekf_fleet_update`."""
    g0, Pt = state
    dt, dev = Pt.dtype, Pt.device
    P = Pt.movedim(-1, 0)
    n, B = G.ndof, g0.shape[0]
    z = torch.zeros((n,), dtype=dt, device=dev)
    Rb = _noise_b(R, dt, dev)
    e = torch.zeros((B, n), dtype=dt, device=dev)
    with ieee_f32_matmul():
        for _ in range(max(1, iters)):
            H, rk = _fleet_meas_lin(G, h, g0, y, Y, z, e=e)
            K = _fleet_gain(P, H, Rb)
            # IEKF recursion e <- K (r + H e) in the tangent space at g0
            e = (K @ (rk + (H @ e[:, :, None])[:, :, 0])[:, :, None])[:, :, 0]
        g_new = vmap(G.rplus)(g0, e)
        P_new = _joseph(P, K, H, Rb)
    return EKFFleetState(g=g_new, Pt=P_new.movedim(0, -1))


class SqrtEKFFleetState(NamedTuple):
    """Square-root fleet state: ``g`` batch-leading, lower-triangular factors
    batch-trailing (``St[:, :, b] St[:, :, b]' = P_b``)."""

    g: torch.Tensor  # (B, nparams)
    St: torch.Tensor  # (ndof, ndof, B)


def sqrt_ekf_fleet_reset(
    G: LieGroup, g: torch.Tensor, P: Optional[torch.Tensor] = None
) -> SqrtEKFFleetState:
    B, n = g.shape[0], G.ndof
    P = _eye(n, g) if P is None else torch.as_tensor(P)
    if P.dim() == 2:
        return SqrtEKFFleetState(g=g, St=_psd_sqrt_lower(P)[:, :, None].expand(n, n, B))
    return SqrtEKFFleetState(g=g, St=_psd_sqrt_lower(P).movedim(0, -1))


def _sqrt_noise_b(M, h, dtype, device):
    """Factors of shared (n, n) / per-member (B, n, n) noise times ``h``,
    batch-leading ((1, n, n) or (B, n, n)), as :func:`_noise_b`."""
    return _psd_sqrt_lower(_noise_b(M, dtype, device) * h)


def sqrt_ekf_fleet_predict(
    G: LieGroup,
    f: Callable,
    state: SqrtEKFFleetState,
    Q: torch.Tensor,
    tau,
    n_steps: int = 1,
) -> SqrtEKFFleetState:
    """Fleet :func:`sqrt_ekf_predict`: per Euler substep
    ``S <- qr_lower([Phi S, chol(h Q)])``, one batched QR; the array form's
    conditioning is kept (no Gram matrix)."""
    g, St = state
    dt, dev = St.dtype, St.device
    S = St.movedim(-1, 0)
    B, n = g.shape[0], G.ndof
    tau = torch.as_tensor(tau, dtype=dt, device=dev)
    h = tau / n_steps
    z = torch.zeros((n,), dtype=dt, device=dev)
    eye = _eye(n, S)
    adgen = ad_generators(G, dtype=dt, device=dev)
    with ieee_f32_matmul():
        Qh = _sqrt_noise_b(Q, h, dt, dev).expand(B, n, n)
        for i in range(n_steps):
            fv, A = _fleet_A(G, f, i * h, g, z, adgen)
            S = _qr_lower(torch.cat([(eye + h * A) @ S, Qh], dim=2))
            g = vmap(lambda gi, fi: G.rplus(gi, h * fi))(g, fv)
    return SqrtEKFFleetState(g=g, St=S.movedim(0, -1))


def sqrt_ekf_fleet_update(
    G: LieGroup,
    h: Callable,
    state: SqrtEKFFleetState,
    y: torch.Tensor,
    R: torch.Tensor,
    Y: Optional[LieGroup] = None,
) -> SqrtEKFFleetState:
    """Fleet :func:`sqrt_ekf_update` (Kailath's QR array algorithm), one
    batched QR and one batched triangular solve."""
    g, St = state
    dt, dev = St.dtype, St.device
    S = St.movedim(-1, 0)
    B, n = g.shape[0], G.ndof
    z = torch.zeros((n,), dtype=dt, device=dev)
    H, innov = _fleet_meas_lin(G, h, g, y, Y, z)
    m = H.shape[1]
    with ieee_f32_matmul():
        Rh = _sqrt_noise_b(R, 1.0, dt, dev).expand(B, m, m)
        pre = torch.cat([
            torch.cat([Rh, H @ S], dim=2),
            torch.cat([S.new_zeros((B, n, m)), S], dim=2),
        ], dim=1)
        T = _qr_lower(pre)
        K = torch.linalg.solve_triangular(T[:, :m, :m], T[:, m:, :m], upper=False, left=False)
        g_new = vmap(G.rplus)(g, (K @ innov[:, :, None])[:, :, 0])
    return SqrtEKFFleetState(g=g_new, St=T[:, m:, m:].movedim(0, -1))


class EKF:
    """Stateful convenience wrapper (the reference class API); for batched
    use prefer the functional forms with an explicit state."""

    def __init__(self, G: LieGroup, g=None, P=None, dtype=torch.float64, device="cuda"):
        self.G = G
        g = G.identity(dtype=dtype, device=device) if g is None else g
        self.state = ekf_reset(G, g, P)

    def reset(self, g, P):
        self.state = EKFState(g=g, P=P)

    @property
    def estimate(self):
        return self.state.g

    @property
    def covariance(self):
        return self.state.P

    def predict(self, f, Q, tau, n_steps: int = 1, stepper: str = "euler"):
        self.state = ekf_predict(self.G, f, self.state, Q, tau, n_steps, stepper)

    def update(self, h, y, R, Y: Optional[LieGroup] = None):
        self.state = ekf_update(self.G, h, self.state, y, R, Y)
