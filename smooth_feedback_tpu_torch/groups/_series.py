"""Taylor-guarded trigonometric coefficient functions (PyTorch port of
``smooth_feedback_tpu/groups/_series.py``, the helpers SO(2), SE(2), SO(3)
and SE(3) use).

The coefficient functions in the Lie-group exp/log/Jacobian closed forms
(sin(x)/x and friends) are singular at 0 when written naively.  Each helper
is total and smooth: near zero it evaluates a truncated series, and the exact
branch is computed on a "safe" input, so forward- and reverse-mode autodiff
never see a NaN (the double-``where`` form).  A plain
``where(small, series, exact(x))`` would give NaN derivatives at 0 under
``torch.func.jacfwd``/``hessian``, which the transcription takes.

No Python branch depends on a tensor's value, so every helper runs under
``torch.func.vmap``.  Series are accurate to machine epsilon in float64 for
|x| below the cutoff.

Every helper evaluates a 0-d argument on a 1-d view (``_on_1d``): forward-mode
autodiff in torch 2.13 promotes the tangent of a 0-d float32 tensor to
float64 when a Python scalar enters the op (``jvp(lambda x: x / 6.0)``), and a
float64 tangent then meets float32 in a matrix product of the group code.  On
a 1-d view the scalar keeps the tensor's dtype.
"""

from __future__ import annotations

import functools

import torch

_CUT = 1e-2  # |x| cutoff between series and exact branch (f64)
_DCUT2 = 1e-2  # seam of the derivative helpers in f64; f32 uses 0.25


def _is_32bit(dtype) -> bool:
    return torch.finfo(dtype).bits <= 32


def _on_1d(fn):
    @functools.wraps(fn)
    def wrapped(x):
        return fn(x.reshape(-1)).reshape(x.shape)

    return wrapped


def _cut(dtype):
    """Series/exact seam, dtype-aware: the exact branches cancel like
    eps/x^2 near zero, and in f32 the series are accurate far below f32 eps
    out to x = 0.5."""
    return 0.5 if _is_32bit(dtype) else _CUT


def _guard(x):
    small = x.abs() < _cut(x.dtype)
    safe = torch.where(small, torch.ones_like(x), x)
    return small, safe


def _safe_denom(d, eps=1e-12):
    """Clamp a denominator away from zero, preserving sign (the inverse
    Jacobian coefficients have true poles at |theta| = 2 pi k)."""
    mag = torch.clamp(d.abs(), min=eps)
    sign = torch.where(d >= 0, 1.0, -1.0).to(d.dtype)
    return sign * mag


@_on_1d
def sinc(x):
    """sin(x) / x."""
    small, safe = _guard(x)
    x2 = x * x
    series = 1.0 - x2 / 6.0 * (1.0 - x2 / 20.0 * (1.0 - x2 / 42.0))
    return torch.where(small, series, torch.sin(safe) / safe)


@_on_1d
def cos1c(x):
    """(1 - cos(x)) / x**2."""
    small, safe = _guard(x)
    x2 = x * x
    series = 0.5 * (1.0 - x2 / 12.0 * (1.0 - x2 / 30.0 * (1.0 - x2 / 56.0)))
    return torch.where(small, series, (1.0 - torch.cos(safe)) / (safe * safe))


@_on_1d
def sin3c(x):
    """(x - sin(x)) / x**3."""
    small, safe = _guard(x)
    x2 = x * x
    series = (1.0 - x2 / 20.0 * (1.0 - x2 / 42.0 * (1.0 - x2 / 72.0))) / 6.0
    return torch.where(small, series, (safe - torch.sin(safe)) / (safe * safe * safe))


@_on_1d
def jlinv2c(x):
    """1/x**2 - (1 + cos(x)) / (2 x sin(x)), the quadratic coefficient of the
    inverse SO(3) Jacobian."""
    small, safe = _guard(x)
    x2 = x * x
    series = (1.0 + x2 / 60.0 * (1.0 + x2 / 42.0 * (1.0 + x2 / 40.0))) / 12.0
    exact = 1.0 / (safe * safe) - (1.0 + torch.cos(safe)) / _safe_denom(
        2.0 * safe * torch.sin(safe)
    )
    return torch.where(small, series, exact)


@_on_1d
def acos_over_sinc(x):
    """(x/2) cot(x/2) = sin(x) x / (2 (1 - cos x)), the A/(2B) of the planar
    log; series 1 - x^2/12 - ..."""
    small, safe = _guard(x)
    x2 = x * x
    series = 1.0 - x2 / 12.0 * (1.0 + x2 / 60.0 * (1.0 + x2 / 42.0))
    exact = 0.5 * safe * torch.sin(safe) / _safe_denom(1.0 - torch.cos(safe))
    return torch.where(small, series, exact)


# --- theta^2-input variants -------------------------------------------------
#
# All coefficient functions are even in theta, so these take theta^2 (smooth
# everywhere) and take the square root only of a guarded value inside the
# exact branch.


def _cut2(dtype):
    c = _cut(dtype)
    return c * c


def _guard2(x2):
    small = x2 < _cut2(x2.dtype)
    safe = torch.sqrt(torch.where(small, torch.ones_like(x2), x2))
    return small, safe


@_on_1d
def sinc2(x2):
    """sin(t)/t with t = sqrt(x2)."""
    small, t = _guard2(x2)
    series = 1.0 - x2 / 6.0 * (1.0 - x2 / 20.0 * (1.0 - x2 / 42.0))
    return torch.where(small, series, torch.sin(t) / t)


@_on_1d
def cos2(x2):
    """cos(t) with t = sqrt(x2)."""
    small, t = _guard2(x2)
    series = 1.0 - x2 / 2.0 * (1.0 - x2 / 12.0 * (1.0 - x2 / 30.0))
    return torch.where(small, series, torch.cos(t))


@_on_1d
def cos1c2(x2):
    """(1 - cos(t)) / t^2 with t = sqrt(x2)."""
    small, t = _guard2(x2)
    series = 0.5 * (1.0 - x2 / 12.0 * (1.0 - x2 / 30.0 * (1.0 - x2 / 56.0)))
    return torch.where(small, series, (1.0 - torch.cos(t)) / (t * t))


@_on_1d
def sin3c2(x2):
    """(t - sin(t)) / t^3 with t = sqrt(x2)."""
    small, t = _guard2(x2)
    series = (1.0 - x2 / 20.0 * (1.0 - x2 / 42.0 * (1.0 - x2 / 72.0))) / 6.0
    return torch.where(small, series, (t - torch.sin(t)) / (t * t * t))


@_on_1d
def jlinv2c2(x2):
    """1/t^2 - (1 + cos(t)) / (2 t sin(t)) with t = sqrt(x2)."""
    small, t = _guard2(x2)
    series = (1.0 + x2 / 60.0 * (1.0 + x2 / 42.0 * (1.0 + x2 / 40.0))) / 12.0
    exact = 1.0 / (t * t) - (1.0 + torch.cos(t)) / _safe_denom(2.0 * t * torch.sin(t))
    return torch.where(small, series, exact)


# --- derivatives w.r.t. s = t^2 of the Jacobian coefficients ----------------
#
# For the closed-form second-order derivatives: with c(s) and s = v.v,
# grad_v c = c'(s) 2 v.  The exact branches divide by the GUARDED square
# ``t*t``, never the raw ``x2``, so the unselected branch stays finite at 0.


def _dcut2(dtype):
    return 0.25 if _is_32bit(dtype) else _DCUT2


def _seam_guard(x2, cut):
    """``(small, t, t*t)``: the series mask, the guarded root and its square
    (== x2 on the exact branch, 1 on the series)."""
    small = x2 < cut
    t = torch.sqrt(torch.where(small, torch.ones_like(x2), x2))
    return small, t, t * t


def _dguard2(x2):
    return _seam_guard(x2, _dcut2(x2.dtype))


@_on_1d
def dcos1c2(x2):
    """d/ds [(1 - cos t)/t^2], s = t^2 = x2."""
    small, t, x2s = _dguard2(x2)
    series = -(1.0 - x2 / 15.0 * (1.0 - 3.0 * x2 / 112.0 * (1.0 - 2.0 * x2 / 135.0))) / 24.0
    exact = torch.sin(t) / (2.0 * t * x2s) - (1.0 - torch.cos(t)) / (x2s * x2s)
    return torch.where(small, series, exact)


@_on_1d
def dsin3c2(x2):
    """d/ds [(t - sin t)/t^3], s = t^2 = x2."""
    small, t, x2s = _dguard2(x2)
    series = -(1.0 - x2 / 21.0 * (1.0 - x2 / 48.0 * (1.0 - 2.0 * x2 / 165.0))) / 120.0
    exact = (1.0 - torch.cos(t)) / (2.0 * x2s * x2s) - 3.0 * (t - torch.sin(t)) / (
        2.0 * x2s * x2s * t
    )
    return torch.where(small, series, exact)


@_on_1d
def djlinv2c2(x2):
    """d/ds [1/t^2 - (1 + cos t)/(2 t sin t)], s = t^2 = x2."""
    small, t, x2s = _dguard2(x2)
    series = (1.0 + x2 / 21.0 * (1.0 + 3.0 * x2 / 80.0)) / 720.0
    s_, c_ = torch.sin(t), torch.cos(t)
    N = 1.0 + c_
    # d/dt [N/(2 t s)] = (-s * 2ts - N*(2s + 2tc)) / (2ts)^2
    du = (-s_ * 2.0 * t * s_ - N * (2.0 * s_ + 2.0 * t * c_)) / _safe_denom(
        4.0 * x2s * s_ * s_
    )
    dc3_dt = -2.0 / (x2s * t) - du
    return torch.where(small, series, dc3_dt / (2.0 * t))


# --- higher-order coefficients of the SE(3) Q-block -------------------------
#
# Barfoot's Q-block ("State Estimation for Robotics", eq. 7.86) uses sin3c2
# and the two functions below; their exact branches cancel badly for small t,
# so the seam sits at t = 0.5 in every dtype (five series terms hold ~1e-10
# relative there).


@_on_1d
def cos4c2(x2):
    """(1 - t^2/2 - cos(t)) / t^4 with t = sqrt(x2)  (= -1/24 + t^2/720 - ...)."""
    small, t, x2s = _seam_guard(x2, 0.25)
    series = (
        -(1.0 - x2 / 30.0 * (1.0 - x2 / 56.0 * (1.0 - x2 / 90.0 * (1.0 - x2 / 132.0))))
        / 24.0
    )
    exact = (1.0 - 0.5 * x2s - torch.cos(t)) / (x2s * x2s)
    return torch.where(small, series, exact)


@_on_1d
def sin5c2(x2):
    """(t - sin(t) - t^3/6) / t^5 with t = sqrt(x2)  (= -1/120 + t^2/5040 - ...)."""
    small, t, x2s = _seam_guard(x2, 0.25)
    series = (
        -(1.0 - x2 / 42.0 * (1.0 - x2 / 72.0 * (1.0 - x2 / 110.0 * (1.0 - x2 / 156.0))))
        / 120.0
    )
    exact = (t - torch.sin(t) - t * x2s / 6.0) / (x2s * x2s * t)
    return torch.where(small, series, exact)


@_on_1d
def dcos4c2(x2):
    """d/ds [(1 - s/2 - cos t)/s^2], s = t^2 = x2."""
    small, t, x2s = _seam_guard(x2, 0.25)
    series = (1.0 - x2 / 28.0 * (1.0 - x2 / 60.0 * (1.0 - x2 / 99.0))) / 720.0
    exact = (-0.5 + torch.sin(t) / (2.0 * t)) / (x2s * x2s) - 2.0 * (
        1.0 - 0.5 * x2s - torch.cos(t)
    ) / (x2s * x2s * x2s)
    return torch.where(small, series, exact)


@_on_1d
def dsin5c2(x2):
    """d/ds [(t - sin t - t^3/6)/(s^2 t)], s = t^2 = x2."""
    small, t, x2s = _seam_guard(x2, 0.25)
    series = (1.0 - x2 / 36.0 * (1.0 - 3.0 * x2 / 220.0 * (1.0 - x2 / 117.0))) / 5040.0
    exact = (1.0 - torch.cos(t) - 0.5 * x2s) / (2.0 * x2s * x2s * x2s) - 2.5 * (
        t - torch.sin(t) - t * x2s / 6.0
    ) / (x2s * x2s * x2s * t)
    return torch.where(small, series, exact)
