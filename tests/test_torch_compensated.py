"""The port's compensated (two-float) accumulation against a float64
re-evaluation and against the JAX package, on the CPU.

Inputs are float32 from numpy with a seed.  Each compensated result must sit
~eps^2-close to the float64 value (where the plain float32 computation does
not), and agree with the JAX package's compensated result.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu.utils import compensated as jc
from smooth_feedback_tpu_torch.utils import compensated as tc

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_two_sum_and_two_prod_exact():
    """a + b = s + e and a * b = p + e exactly (float32 inputs, checked in
    float64, where both sides are exact); the float64 constant of the split
    keeps two_prod exact in float64 too."""
    rng = np.random.default_rng(0)
    a = 1e4 * rng.standard_normal(1000)
    b = 1e-4 * rng.standard_normal(1000)
    s, e = tc.two_sum(_t(a), _t(b))
    exact = np.float32(a).astype(np.float64) + np.float32(b).astype(np.float64)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(), exact)
    a, b = rng.standard_normal(1000), 37.3 * rng.standard_normal(1000)
    p, e = tc.two_prod(_t(a), _t(b))
    exact = np.float32(a).astype(np.float64) * np.float32(b).astype(np.float64)
    np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(), exact)
    # float64: the product error of two 53-bit numbers, exact to the last bit
    a64 = torch.tensor([1.0 + 2.0**-30], dtype=torch.float64)
    b64 = torch.tensor([1.0 - 2.0**-29], dtype=torch.float64)
    p, e = tc.two_prod(a64, b64)
    assert float(p) == 1.0 - 2.0**-30 and float(e) == -(2.0**-59)


@pytest.mark.parametrize("n", [3, 100])
def test_csum_and_cdot_vs_f64(n):
    """csum and cdot of float32 vectors land within ~eps^2 of the float64
    value on cancelling inputs, where a plain float32 sum misses it."""
    rng = np.random.default_rng(n)
    x = np.float32(rng.standard_normal((n, 4)) * 10.0 ** rng.integers(-3, 4, (n, 4)))
    x[-1] = -x[:-1].astype(np.float64).sum(0)  # heavy cancellation
    y = np.float32(rng.standard_normal((n, 4)))
    for name, args, exact in (
        ("csum", (x,), x.astype(np.float64).sum(0)),
        ("cdot", (x, y), (x.astype(np.float64) * y).sum(0)),
    ):
        hi, lo = getattr(tc, name)(*(_t(a) for a in args), dim=0)
        got = hi.double().numpy() + lo.double().numpy()
        scale = np.abs(x).sum(0)
        assert np.all(np.abs(got - exact) <= 1e-12 * scale), name
    plain = _t(x).sum(0).double().numpy()
    assert np.abs(plain - x.astype(np.float64).sum(0)).max() > 1e3 * np.abs(got - exact).max()


@pytest.mark.parametrize("batched", [False, True])
def test_stationarity_and_matvecs_vs_f64(batched):
    """stationarity_compensated, cmatvec and cmatvec_t (float32) within
    ~eps^2 of the float64 value; the batched cmatvec_t equals the loop over
    members."""
    rng = np.random.default_rng(7)
    B, m, n = 3, 40, 6
    J = np.float32(rng.standard_normal((B, m, n)))
    lam = np.float32(10.0 * rng.standard_normal((B, m)))
    grad = -np.einsum("bmn,bm->bn", J.astype(np.float64), lam).astype(np.float32)
    z = np.float32(1e-3 * rng.standard_normal((B, n)))
    if not batched:
        J, lam, grad, z = J[0], lam[0], grad[0], z[0]
    args = (grad, J, lam, z)
    got = tc.stationarity_compensated(*(_t(a) for a in args)).double().numpy()
    f64 = lambda a: np.asarray(a, np.float64)
    exact = np.abs(f64(grad) + np.einsum("...mn,...m->...n", f64(J), f64(lam)) + f64(z)).max(-1)
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-10)

    hi, lo = tc.cmatvec_t(_t(J), _t(lam))
    if batched:
        for b in range(B):
            hb, lb = tc.cmatvec_t(_t(J[b]), _t(lam[b]))
            torch.testing.assert_close(hi[b] + lo[b], hb + lb, rtol=0, atol=1e-6)
    v = np.float32(rng.standard_normal(J.shape[:-2] + (n,)))
    hi, lo = tc.cmatvec(_t(J), _t(v))
    exact = np.einsum("...mn,...n->...m", f64(J), f64(v))
    np.testing.assert_allclose(hi.double().numpy() + lo.double().numpy(), exact, atol=1e-11, rtol=0)


def test_matches_jax():
    """Every helper gives the JAX package's (hi + lo) on the same small
    float32 inputs (JAX under jax.jit), within 1e-12 of the operands' scale.
    Small, because at larger sizes jax.jit on the CPU does not keep the JAX
    functions error-free: the jitted stationarity of a (3, 40, 6) stack lands
    3e-6 from the float64 value where the eager JAX call and the port land on
    it (XLA's CPU compiler rewrites the error-free sums)."""
    rng = np.random.default_rng(5)
    B, m, n = 2, 6, 3
    J = np.float32(rng.standard_normal((B, m, n)) * 10.0 ** rng.integers(-2, 3, (B, m, n)))
    lam = np.float32(rng.standard_normal((B, m)))
    v = np.float32(rng.standard_normal((B, n)))
    grad = -np.einsum("bmn,bm->bn", J.astype(np.float64), lam).astype(np.float32)
    z = np.float32(1e-3 * rng.standard_normal((B, n)))
    pair = lambda r: np.asarray(r[0], np.float64) + np.asarray(r[1], np.float64)
    cases = (
        ("csum", (J[0],), dict(axis=0), dict(dim=0)),
        ("cdot", (J[0], J[1]), dict(axis=1), dict(dim=1)),
        ("cmatvec", (J, v), {}, {}),
        ("cmatvec_t", (J, lam), {}, {}),
        ("cmatvec_t", (J[0], lam[0]), {}, {}),
    )
    scale = np.abs(J).max() * m
    for name, args, jkw, tkw in cases:
        fn = jax.jit(functools.partial(getattr(jc, name), **jkw))
        want = pair(fn(*(jnp.asarray(a) for a in args)))
        got = pair(getattr(tc, name)(*(_t(a) for a in args), **tkw))
        np.testing.assert_allclose(got, want, atol=1e-12 * scale, rtol=0, err_msg=name)
    want = np.asarray(jax.jit(jc.stationarity_compensated)(*(jnp.asarray(a) for a in (grad, J, lam, z))))
    got = tc.stationarity_compensated(*(_t(a) for a in (grad, J, lam, z))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12 * scale, rtol=0)
