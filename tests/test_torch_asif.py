"""The port's ASIF safety filter against the JAX package, on the CPU:
``asif_to_qp``, ``asif_to_qp_fleet``, ``make_asif_step`` (``step`` and
``step.fleet``), ``ASIFilter``, and the bounds helpers with
``convert.bounds_from_numpy``.

States and inputs come from numpy with a seed and go to both packages; both
run float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from smooth_feedback_tpu.controllers.asif import ASIFilter as JASIFilter
from smooth_feedback_tpu.controllers.asif import ASIFilterParams as JASIFilterParams
from smooth_feedback_tpu.controllers.asif import ASIFtoQPParams as JASIFtoQPParams
from smooth_feedback_tpu.controllers.asif import asif_to_qp as j_asif_to_qp
from smooth_feedback_tpu.controllers.asif import asif_to_qp_fleet as j_asif_to_qp_fleet
from smooth_feedback_tpu.controllers.asif import make_asif_step as j_make_asif_step
from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.qp import QPSolverParams as JQPSolverParams
from smooth_feedback_tpu.utils.bounds import ManifoldBounds as JManifoldBounds
from smooth_feedback_tpu.utils.bounds import box_bounds as j_box_bounds
from smooth_feedback_tpu.utils.bounds import empty_bounds as j_empty_bounds
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.controllers import (
    ASIFilter,
    ASIFilterParams,
    ASIFtoQPParams,
    asif_to_qp,
    asif_to_qp_fleet,
    make_asif_step,
)
from smooth_feedback_tpu_torch.groups import SE2, Rn
from smooth_feedback_tpu_torch.qp import QPSolutionStatus, QPSolverParams
from smooth_feedback_tpu_torch.utils import box_bounds, empty_bounds

torch.set_num_threads(1)

bounds_from_numpy = functools.partial(convert.bounds_from_numpy, device="cpu")
ULIM = (np.eye(2), np.zeros(2), np.array([-0.3, -0.6]), np.array([0.4, 0.6]))


def test_asif_transcription_matches_jax_f64():
    """tests/test_asif.py's fleet-transcription problem (SE(2), a barrier
    that depends on t, a backup law, input bounds; K = 7 constraint times,
    2 substeps each): asif_to_qp of each member and asif_to_qp_fleet give
    JAX's P, q, A, l, u within 1e-10 (f64; the sensitivity is integrated in
    another summation order)."""
    jf = lambda x, u: jnp.stack([u[0], 0.1 * x[1], u[1]])
    jh = lambda t, x: jnp.stack([x[0] + 0.2 * t, 2.0 - x[1]])
    jbu = lambda t, x: jnp.stack([0.3 * x[1], -0.4 * jnp.ones(())])
    tf = lambda x, u: torch.stack([u[0], 0.1 * x[1], u[1]])
    th = lambda t, x: torch.stack([x[0] + 0.2 * t, 2.0 - x[1]])
    tbu = lambda t, x: torch.stack([0.3 * x[1], torch.full_like(x[1], -0.4)])
    W = np.array([2.0, 1.0])
    B = 3
    rng = np.random.default_rng(31)
    xs = np.stack([SE2.exp(torch.as_tensor(0.4 * rng.standard_normal(3))).numpy() for _ in range(B)])
    uds = 0.2 * rng.standard_normal((B, 2))
    jprm = JASIFtoQPParams(K=7, dt=0.07, alpha=1.5, relax_cost=200.0)
    tprm = ASIFtoQPParams(K=7, dt=0.07, alpha=1.5, relax_cost=200.0)
    jul = JManifoldBounds(*(jnp.asarray(a) for a in ULIM))

    @jax.jit
    def jax_qps(xs_, uds_):
        one = jax.vmap(lambda x, ud: j_asif_to_qp(JSE2, JRn(2), jprm, 1.1, x, ud, W, jul, jf, jh, jbu))
        return one(xs_, uds_), j_asif_to_qp_fleet(JSE2, JRn(2), jprm, 1.1, xs_, uds_, W, jul, jf, jh, jbu)

    jv, jfl = jax_qps(jnp.asarray(xs), jnp.asarray(uds))
    tul = bounds_from_numpy(ULIM)
    tfl = asif_to_qp_fleet(SE2, Rn(2), tprm, 1.1, torch.as_tensor(xs), torch.as_tensor(uds), W, tul,
                           tf, th, tbu)
    assert tfl.A.shape == (B, 7 * 2 + 2 + 1, 3)
    for b in range(B):
        one = asif_to_qp(SE2, Rn(2), tprm, 1.1, torch.as_tensor(xs[b]), torch.as_tensor(uds[b]), W,
                         tul, tf, th, tbu)
        for name, a, v, fl, tfa in zip("PqAlu", one, jv, jfl, tfl):
            for want in (v, fl):
                np.testing.assert_allclose(a.numpy(), np.asarray(want)[b], atol=1e-10, rtol=0,
                                           err_msg=name)
            np.testing.assert_allclose(tfa[b].numpy(), a.numpy(), atol=1e-12, rtol=0, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_di_filter(backend):
    """tests/test_asif.py's double integrator with barrier h = position and
    a backup law that brakes (K = 5, T = 1), JAX's filter on ``backend``,
    built once a backend."""
    return j_make_asif_step(
        JRn(2), JRn(1), lambda x, u: jnp.stack([x[1], u[0]]),
        lambda t, x: jnp.stack([x[0]]), lambda t, x: jnp.array([1.0]),
        params=JASIFilterParams(T=1.0, asif=JASIFtoQPParams(K=5), qp=JQPSolverParams(
            eps_abs=1e-8, eps_rel=1e-8, backend=backend, adaptive_rho=True, polish=False,
            max_iter=20000,
        )),
    )


def _port_di_filter(port_backend):
    """The same filter in the port, on ``port_backend``."""
    return make_asif_step(
        Rn(2), Rn(1), lambda x, u: torch.stack([x[1], u[0]]),
        lambda t, x: x[:1], lambda t, x: torch.ones(1, dtype=x.dtype),
        params=ASIFilterParams(T=1.0, asif=ASIFtoQPParams(K=5), qp=QPSolverParams(
            eps_abs=1e-8, eps_rel=1e-8, adaptive_rho=True, polish=False, max_iter=20000,
            backend=port_backend,
        )),
        device="cpu",
    )


def test_asif_step_and_fleet_match_jax():
    """make_asif_step at tight tolerance with adaptive rho (the mirror of
    tests/test_asif.py::test_fleet_lane_adaptive_matches_xla): the port's
    step.fleet on "torch" and on "lane" (the bench's backend) against JAX's
    on "lane" and on "xla".  Statuses equal and Optimal, iteration counts
    equal to the xla path's, filtered u within 1e-9 of both (f64; JAX's own
    lane/xla pair agrees to 1e-9 here); step is step.fleet at B = 1."""
    jl, jws0 = _jax_di_filter("lane")
    jx, _ = _jax_di_filter("xla")
    B = 8
    xs = np.stack([np.array([1.0 + 0.1 * i, -0.2]) for i in range(B)])
    xs[::2, 1] = -1.5  # half the fleet heading for the barrier
    uds = -0.5 * np.ones((B, 1))
    jw = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jws0)
    rjs = [jax.jit(jfleet)(jw, jnp.asarray(xs), jnp.asarray(uds)) for jfleet in (jl.fleet, jx.fleet)]
    for port_backend in ("torch", "lane"):
        tstep, tws0 = _port_di_filter(port_backend)
        tw = type(tws0)(*(a.expand((B,) + a.shape) for a in tws0))
        rt = tstep.fleet(tw, torch.as_tensor(xs), torch.as_tensor(uds))
        assert bool((rt.status == QPSolutionStatus.Optimal).all())
        for rj in rjs:
            np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
            np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), atol=1e-9, rtol=0)
        np.testing.assert_array_equal(rt.warmstart.iters.numpy(),
                                      np.asarray(rjs[-1].warmstart.iters))
        assert float(np.abs(rt.u.numpy() - uds).max()) > 0.1  # the filter acts on some members

        r1 = tstep(tws0, torch.as_tensor(xs[2]), torch.as_tensor(uds[2]))
        # the lane loop reduces over a trailing batch axis, whose length sets
        # torch's summation order: B = 1 lands within rounding of the fleet
        torch.testing.assert_close(r1.u, rt.u[2], rtol=0, atol=0 if port_backend == "torch" else 1e-12)
        assert int(r1.status) == int(rt.status[2])


def test_asif_filter_class_matches_jax():
    """ASIFilter with the default solver parameters (polish on), four calls
    carrying the warm start, on the double integrator pushed toward the
    barrier: statuses and u as JAX's ASIFilter (f64, u within 1e-9)."""
    jfil = JASIFilter(JRn(2), JRn(1), lambda x, u: jnp.stack([x[1], u[0]]),
                      lambda t, x: jnp.stack([x[0] + 0.5 * x[1]]), lambda t, x: jnp.array([2.0]),
                      params=JASIFilterParams(T=2.0, asif=JASIFtoQPParams(K=8, alpha=2.0, dt=0.05,
                                                                         relax_cost=1000.0)))
    tfil = ASIFilter(Rn(2), Rn(1), lambda x, u: torch.stack([x[1], u[0]]),
                     lambda t, x: x[:1] + 0.5 * x[1:],
                     lambda t, x: torch.full((1,), 2.0, dtype=x.dtype),
                     params=ASIFilterParams(T=2.0, asif=ASIFtoQPParams(K=8, alpha=2.0, dt=0.05,
                                                                      relax_cost=1000.0)),
                     device="cpu")
    x = np.array([0.3, -0.4])
    for _ in range(4):
        ju, jst = jfil(jnp.asarray(x), jnp.array([-1.0]))
        tu, tst = tfil(torch.as_tensor(x), torch.tensor([-1.0], dtype=torch.float64))
        assert tst == jst == QPSolutionStatus.Optimal
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-9, rtol=0)
        x = x + 0.05 * np.array([x[1], float(tu[0])])
    assert float(tu[0]) > -1.0  # the filter overrides the push


def test_bounds_helpers_and_bounds_from_numpy():
    """A JAX ManifoldBounds carried across with bounds_from_numpy keeps every
    field; box_bounds and empty_bounds give JAX's fields."""
    jb = JManifoldBounds(*(jnp.asarray(a) for a in ULIM))
    tb = bounds_from_numpy(jax.tree.map(np.asarray, jb))
    assert tb._fields == jb._fields
    for t, j in zip(tb, jb):
        assert t.dtype == torch.float64
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for tb, jb in (
        (box_bounds(SE2, [-1.0, -2.0, -3.0], [1.0, 2.0, 3.0], torch.float64, "cpu"),
         j_box_bounds(JSE2, [-1.0, -2.0, -3.0], [1.0, 2.0, 3.0], jnp.float64)),
        (empty_bounds(Rn(2), torch.float64, "cpu"), j_empty_bounds(JRn(2), jnp.float64)),
    ):
        for t, j in zip(tb, jb):
            assert tuple(t.shape) == j.shape
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
