"""PID controller on Lie groups (PyTorch port of
``smooth_feedback_tpu/controllers/pid.py``).

The controller state (last time and integral error) is an explicit
NamedTuple and the step a pure function, so fleets of controllers run under
``torch.func.vmap``.  The controlled model is the Lie-group double
integrator ``d^r x_t = v, dv/dt = u``, and the law is

    u = a_des + kp . (x_des (-) x) + kd . (v_des - v) + ki . integral_err
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from ..groups.base import LieGroup


@dataclasses.dataclass(frozen=True)
class PIDParams:
    windup_limit: float = float("inf")


class PIDState(NamedTuple):
    """Integral state; ``t_last = nan`` means "no previous sample"."""

    t_last: torch.Tensor  # 0-d
    i_err: torch.Tensor  # (ndof,)


class PIDGains(NamedTuple):
    """Per-axis gains as tangent-space vectors."""

    kp: torch.Tensor  # (ndof,)
    kd: torch.Tensor  # (ndof,)
    ki: torch.Tensor  # (ndof,)


def pid_init(G: LieGroup, dtype=None, device="cuda") -> PIDState:
    kw = dict(dtype=dtype, device=device)
    return PIDState(t_last=torch.full((), float("nan"), **kw), i_err=torch.zeros((G.ndof,), **kw))


def pid_gains(G: LieGroup, kp=1.0, kd=1.0, ki=0.0, dtype=None, device="cuda") -> PIDGains:
    ones = torch.ones((G.ndof,), dtype=dtype, device=device)
    return PIDGains(kp=kp * ones, kd=kd * ones, ki=ki * ones)


def pid_step(
    G: LieGroup,
    params: PIDParams,
    gains: PIDGains,
    state: PIDState,
    t,
    x: torch.Tensor,
    v: torch.Tensor,
    x_des: torch.Tensor,
    v_des: torch.Tensor,
    a_des: torch.Tensor,
) -> Tuple[torch.Tensor, PIDState]:
    """One PID step; returns ``(u, new_state)``.  ``x_des``/``v_des``/
    ``a_des`` are the desired state, body velocity and body acceleration at
    time ``t``."""
    t = torch.as_tensor(t, dtype=state.i_err.dtype, device=state.i_err.device)
    g_err = G.rminus(x_des, x)

    # integral update with the windup clamp; skipped on the first call
    # (t_last = nan) and for non-increasing time
    do_int = ~torch.isnan(state.t_last) & (t > state.t_last)
    i_new = state.i_err + (t - torch.where(do_int, state.t_last, t)) * g_err
    i_new = torch.clamp(i_new, -params.windup_limit, params.windup_limit)
    i_err = torch.where(do_int, i_new, state.i_err)

    u = a_des + gains.kp * g_err + gains.kd * (v_des - v) + gains.ki * i_err
    return u, PIDState(t_last=t, i_err=i_err)


class PID:
    """Stateful wrapper (the reference class API); for fleets prefer
    :func:`pid_step` under ``vmap``."""

    def __init__(self, G: LieGroup, params: PIDParams = PIDParams(), dtype=None, device="cuda"):
        self.G = G
        self.params = params
        self._kw = dict(dtype=dtype, device=device)
        self.gains = pid_gains(G, **self._kw)
        self.state = pid_init(G, **self._kw)
        zeros = torch.zeros((G.ndof,), **self._kw)
        self._xdes: Callable = lambda t: (G.identity(**self._kw), zeros, zeros)

    def _axes(self, k):
        return torch.as_tensor(k, **self._kw).expand(self.G.ndof)

    def set_kp(self, kp):
        self.gains = self.gains._replace(kp=self._axes(kp))

    def set_kd(self, kd):
        self.gains = self.gains._replace(kd=self._axes(kd))

    def set_ki(self, ki):
        self.gains = self.gains._replace(ki=self._axes(ki))

    def reset_integral(self):
        self.state = self.state._replace(i_err=torch.zeros_like(self.state.i_err))

    def set_xdes(self, f: Callable):
        """``f(t) -> (x_des, v_des, a_des)``."""
        self._xdes = f

    def __call__(self, t, x, v):
        x_des, v_des, a_des = self._xdes(t)
        u, self.state = pid_step(
            self.G, self.params, self.gains, self.state, t, x, v, x_des, v_des, a_des
        )
        return u
