"""The port's second-order group derivatives, ``d2r_fog``, the FLOP counters
and ``random_qp`` against the JAX package, on the CPU in float64.

``d2r_exp``/``d2r_expinv`` of every group type at the scales of
tests/test_groups.py (both sides of each series seam): the closed forms
within 1e-9 of the JAX package's and of the port's own ``jacfwd``
fallback; one float32 case under ``vmap`` + ``jacfwd``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from smooth_feedback_tpu import groups as jg
from smooth_feedback_tpu.utils import flops as jflops
from smooth_feedback_tpu.utils.linalg import d2r_fog as j_d2r_fog
from smooth_feedback_tpu_torch import groups as tg
from smooth_feedback_tpu_torch.groups import LieGroup
from smooth_feedback_tpu_torch.qp import random_qp
from smooth_feedback_tpu_torch.utils import d2r_fog, flops

torch.set_num_threads(1)

GROUPS = {
    "Rn3": (jg.Rn(3), tg.Rn(3)),
    "SO2": (jg.SO2, tg.SO2),
    "SE2": (jg.SE2, tg.SE2),
    "SO3": (jg.SO3, tg.SO3),
    "SE3": (jg.SE3, tg.SE3),
    "Bundle(SE3,Rn6)": (jg.Bundle(jg.SE3, jg.Rn(6)), tg.Bundle(tg.SE3, tg.Rn(6))),
}
SCALES = (1e-6, 0.009, 0.4, 0.9)
TOL = 1e-9


def _tangents(G, seed):
    rng = np.random.default_rng(seed)
    return [s * rng.standard_normal(G.ndof) for s in SCALES]


@pytest.mark.parametrize("name", GROUPS)
def test_second_order_matches_jax(name):
    """Each closed form within 1e-9 of the JAX package's closed form."""
    J, T = GROUPS[name]
    for v in _tangents(T, len(name)):
        for fn in ("d2r_exp", "d2r_expinv"):
            want = np.asarray(getattr(J, fn)(jnp.asarray(v)))
            got = getattr(T, fn)(torch.tensor(v)).numpy()
            assert got.shape == (T.ndof,) * 3
            np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=f"{name} {fn} |v| {v}")


@pytest.mark.parametrize("name", GROUPS)
def test_second_order_matches_jacfwd_fallback(name):
    """Each closed form within 1e-9 of the base class's ``jacfwd`` of the
    first-order closed form (the fallback a group without one takes)."""
    _, T = GROUPS[name]
    for v in _tangents(T, 7 + len(name)):
        v = torch.tensor(v)
        np.testing.assert_allclose(T.d2r_exp(v), LieGroup.d2r_exp(T, v), atol=TOL, rtol=0)
        np.testing.assert_allclose(T.d2r_expinv(v), LieGroup.d2r_expinv(T, v), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["SE2", "SO3", "Bundle(SE3,Rn6)"])
def test_second_order_float32_under_vmap_and_jacfwd(name):
    """float32 under ``vmap`` of ``jacfwd`` (the shape the port's float32
    paths take): forward mode through each closed form, float32 results
    within 1e-5 of float64's."""
    _, T = GROUPS[name]
    v = torch.tensor(0.4 * np.random.default_rng(3).standard_normal((5, T.ndof)))
    for fn in ("d2r_exp", "d2r_expinv"):
        f = lambda w: getattr(T, fn)(w) * w.sum()
        got = vmap(jacfwd(f))(v.float())
        assert got.dtype == torch.float32 and got.shape == (5,) + (T.ndof,) * 4
        want = vmap(jacfwd(f))(v)
        np.testing.assert_allclose(got.double(), want, atol=1e-5, rtol=1e-5)


def test_d2r_fog_matches_jax():
    rng = np.random.default_rng(0)
    Jf, Hf = rng.standard_normal((2, 3)), rng.standard_normal((2, 3, 3))
    Jg, Hg = rng.standard_normal((3, 4)), rng.standard_normal((3, 4, 4))
    want = np.asarray(j_d2r_fog(*(jnp.asarray(a) for a in (Jf, Hf, Jg, Hg))))
    got = d2r_fog(*(torch.tensor(a) for a in (Jf, Hf, Jg, Hg))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_d2r_fog_is_the_hessian_of_the_composition():
    """d2r_fog of f o g with g on SO(3)'s exp chart: the Hessian torch.func
    takes of the composition directly."""
    A = torch.tensor(np.random.default_rng(1).standard_normal((2, 4)))
    fn = lambda y: torch.stack([(A[0] * torch.sin(y)).sum(), (A[1] * y * y).sum()])
    gn = tg.SO3.exp
    x = torch.tensor([0.3, -0.2, 0.5], dtype=torch.float64)
    Jf, Hf = jacfwd(fn)(gn(x)), jacfwd(jacfwd(fn))(gn(x))
    Jg, Hg = jacfwd(gn)(x), jacfwd(jacfwd(gn))(x)
    want = jacfwd(jacfwd(lambda z: fn(gn(z))))(x)
    np.testing.assert_allclose(d2r_fog(Jf, Hf, Jg, Hg), want, atol=1e-12)


@pytest.mark.parametrize("n,m,iters,checks,fact,refine", [
    (52, 52, 100, 10, 1, 0), (3, 53, 4.4, 1, 2, 2), (163, 99, 1200.5, 48, 0, 1)])
def test_flop_counters_equal_jax(n, m, iters, checks, fact, refine):
    assert flops.admm_iter_flops(n, m, refine) == jflops.admm_iter_flops(n, m, refine)
    assert flops.admm_factor_flops(n, m) == jflops.admm_factor_flops(n, m)
    assert flops.admm_check_flops(n, m) == jflops.admm_check_flops(n, m)
    kw = dict(checks=checks, factorizations=fact, refine_iters=refine)
    assert flops.qp_solve_flops(n, m, iters, **kw) == jflops.qp_solve_flops(n, m, iters, **kw)
    assert (flops.condensed_mpc_transcribe_flops(n, m, 102, 2)
            == jflops.condensed_mpc_transcribe_flops(n, m, 102, 2))


def test_peak_is_the_h100_f32_rate():
    """The peak is the H100's float32 rate outside the tensor cores; no
    peak for a CPU, none for a TPU."""
    assert flops.device_peak_flops("gpu") == 67e12
    assert flops.device_peak_flops("cpu") is None and flops.device_peak_flops("tpu") is None
    assert flops.mfu_pct(67e9, 1e-3) == pytest.approx(100.0)
    assert flops.mfu_pct(1.0, 1.0, "cpu") is None and flops.mfu_pct(1.0, 0.0) is None


@pytest.mark.parametrize("n,m,density", [(8, 5, 1.0), (32, 40, 0.3)])
def test_random_qp_structure(n, m, density):
    """P symmetric PSD, l <= A x0 <= u for the hidden x0 (the bounds
    straddle A x0 by |N| + 0.1), M's density near ``density``, the draws
    following the generator."""
    gen = lambda: torch.Generator().manual_seed(5)
    qp = random_qp(n, m, density, generator=gen())
    assert qp.P.shape == (n, n) and qp.A.shape == (m, n) and qp.q.shape == (n,)
    assert qp.P.dtype == torch.float64
    np.testing.assert_allclose(qp.P, qp.P.T, atol=1e-12)
    assert float(torch.linalg.eigvalsh(qp.P).min()) > -1e-9
    width = qp.u - qp.l
    assert bool((width >= 0.2 - 1e-12).all())
    # regenerate the draws: x0 is the fourth draw after M's (and the mask's)
    g = gen()
    M = torch.randn((n, n), generator=g, dtype=torch.float64)
    if density < 1.0:
        keep = torch.rand((n, n), generator=g, dtype=torch.float64) < density
        assert abs(float(keep.double().mean()) - density) < 0.1
        M = M * keep
    np.testing.assert_allclose(qp.P, M @ M.T, atol=1e-12)
    torch.randn((n,), generator=g, dtype=torch.float64)
    torch.randn((m, n), generator=g, dtype=torch.float64)
    x0 = torch.randn((n,), generator=g, dtype=torch.float64)
    ax = qp.A @ x0
    assert bool(((qp.l <= ax) & (ax <= qp.u)).all())
    again = random_qp(n, m, density, generator=gen())
    assert all(torch.equal(a, b) for a, b in zip(qp, again))
