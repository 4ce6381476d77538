"""The port's ``Bundle`` (the SE(2) x R^3 vehicle state of
benchmarks/asif_bench.py), ``ad_generators`` and ``jacobian_wrt_group``
against the JAX package, on the CPU, in float64.

Group elements and tangents come from numpy with a seed and go to both
packages; every result agrees within 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import Bundle as JBundle
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.groups.base import ad_generators as j_ad_generators
from smooth_feedback_tpu.groups.base import jacobian_wrt_group as j_jacobian_wrt_group
from smooth_feedback_tpu_torch.groups import SE2, Bundle, LieGroup, Rn, ad_generators, jacobian_wrt_group

torch.set_num_threads(1)

JX, TX = JBundle(JSE2, JRn(3)), Bundle(SE2, Rn(3))


@functools.lru_cache(maxsize=None)
def _elements(seed):
    """Two group elements (one far from the identity) and two tangents."""
    rng = np.random.default_rng(seed)
    v1, v2 = 0.7 * rng.standard_normal(6), rng.standard_normal(6)
    v2[2] = 2.5  # a large rotation
    g1, g2 = (TX.exp(torch.as_tensor(v)).numpy() for v in (v1, v2))
    return g1, g2, v1, v2


OPS = {
    "exp": "v", "log": "g", "inverse": "g", "compose": "gg", "rplus": "gv", "rminus": "gg",
    "Ad": "g", "ad": "v", "dr_exp": "v", "dr_expinv": "v", "normalize": "g",
}


def _arguments(op, k):
    """The numpy arguments of ``op`` at point k (0 or 1)."""
    g1, g2, v1, v2 = _elements(0)
    pick = {"g": (g1, g2), "v": (v1, v2)}
    vals = [pick[a][(k + i) % 2] for i, a in enumerate(OPS[op])]
    return [1.01 * vals[0]] if op == "normalize" else vals


@functools.lru_cache(maxsize=None)
def _jax_results():
    """Every operation at both points, from one jitted JAX program."""
    fn = jax.jit(lambda args: {op: [getattr(JX, op)(*a) for a in args[op]] for op in OPS})
    return fn({op: [[jnp.asarray(v) for v in _arguments(op, k)] for k in range(2)] for op in OPS})


@pytest.mark.parametrize("op", list(OPS))
def test_bundle_matches_jax(op):
    """Each operation of Bundle(SE2, Rn(3)) at two points within 1e-12 of
    JAX (f64)."""
    for k in range(2):
        got = getattr(TX, op)(*(torch.as_tensor(a) for a in _arguments(op, k)))
        want = _jax_results()[op][k]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0, err_msg=op)


def test_bundle_structure_and_generators():
    """Sizes, identity, commutativity and the block-diagonal adjoints as
    JAX's; ad_generators of the bundle and of SE2 within 1e-12 of JAX's;
    ad(v) = sum_k v_k adgen[k]; the closed-form dr_exp and dr_expinv equal
    the jacfwd fallbacks of the base class under vmap (so the block
    assembly runs under torch.func)."""
    assert (TX.nparams, TX.ndof) == (JX.nparams, JX.ndof) == (7, 6)
    assert not TX.is_commutative() and Bundle(Rn(2), Rn(1)).is_commutative()
    assert TX == Bundle(SE2, Rn(3)) and hash(TX) == hash(Bundle(SE2, Rn(3)))
    np.testing.assert_array_equal(TX.identity(dtype=torch.float64).numpy(), np.asarray(JX.identity()))
    want = jax.jit(lambda: [j_ad_generators(JX, jnp.float64), j_ad_generators(JSE2, jnp.float64)])()
    for w, tg in zip(want, (TX, SE2)):
        np.testing.assert_allclose(ad_generators(tg, dtype=torch.float64).numpy(), np.asarray(w),
                                   atol=1e-12, rtol=0)
    _, _, v1, v2 = _elements(1)
    gen = ad_generators(TX, dtype=torch.float64)
    vs = torch.as_tensor(np.stack([v1, v2]))
    torch.testing.assert_close(torch.einsum("kij,bk->bij", gen, vs), vmap(TX.ad)(vs), rtol=0, atol=1e-14)
    for name in ("dr_exp", "dr_expinv"):
        closed = vmap(getattr(TX, name))(vs)
        fallback = vmap(lambda v: getattr(LieGroup, name)(TX, v))(vs)
        torch.testing.assert_close(closed, fallback, rtol=0, atol=1e-12)


def test_jacobian_wrt_group_matches_jax():
    """jacobian_wrt_group of a vector function of the bundle state: value and
    body-frame Jacobian within 1e-12 of JAX's, and equal to jacfwd of
    f(g o exp(w)) at w = 0."""
    g1, _, _, _ = _elements(2)
    jf = lambda g, a: jnp.stack([jnp.sum(g[:2] ** 2), a * g[4] * g[2], jnp.sin(g[6])])
    tf = lambda g, a: torch.stack([(g[:2] ** 2).sum(), a * g[4] * g[2], torch.sin(g[6])])
    jv, jJ = jax.jit(lambda g: j_jacobian_wrt_group(JX, jf, g, 0.5))(jnp.asarray(g1))
    tv, tJ = jacobian_wrt_group(TX, tf, torch.as_tensor(g1), 0.5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=1e-12, rtol=0)
    g = torch.as_tensor(g1)
    direct = jacfwd(lambda w: tf(TX.rplus(g, w), 0.5))(torch.zeros(6, dtype=torch.float64))
    torch.testing.assert_close(tJ, direct, rtol=0, atol=0)
