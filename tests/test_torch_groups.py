"""The PyTorch port's Lie-group core against the JAX package, on the CPU.

The port holds ``Rn`` only, so its ``torch.func.jacfwd`` fallbacks for the
adjoints and right Jacobians are checked on a test-local SE(2) that defines
only exp/log/compose/inverse, against the JAX package's closed forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu_torch.groups import LieGroup, Rn

torch.set_num_threads(1)


class _SE2(LieGroup):
    """Storage ``[tx, ty, re, im]``, tangent ``[vx, vy, w]``."""

    nparams = 4
    ndof = 3

    @staticmethod
    def _V(w):
        # sin(w)/w and (1 - cos w)/w, with their series where w is near 0
        small = w.abs() < 1e-4
        ws = torch.where(small, torch.ones_like(w), w)
        a = torch.where(small, 1 - w * w / 6, torch.sin(ws) / ws)
        b = torch.where(small, w / 2, (1 - torch.cos(ws)) / ws)
        return torch.stack([torch.stack([a, -b]), torch.stack([b, a])])

    def exp(self, v):
        t = self._V(v[2]) @ v[:2]
        return torch.cat([t, torch.stack([torch.cos(v[2]), torch.sin(v[2])])])

    def log(self, g):
        w = torch.atan2(g[3], g[2])
        return torch.cat([torch.linalg.solve(self._V(w), g[:2]), w[None]])

    def compose(self, a, b):
        R = torch.stack([torch.stack([a[2], -a[3]]), torch.stack([a[3], a[2]])])
        re = a[2] * b[2] - a[3] * b[3]
        im = a[2] * b[3] + a[3] * b[2]
        return torch.cat([a[:2] + R @ b[:2], torch.stack([re, im])])

    def inverse(self, g):
        c, s = g[2], g[3]
        t = torch.stack([-(c * g[0] + s * g[1]), s * g[0] - c * g[1]])
        return torch.cat([t, torch.stack([c, -s])])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jacfwd_fallbacks_match_closed_forms(seed):
    """Ad, ad, dr_exp and dr_expinv from the port's jacfwd fallbacks, and the
    derived rplus/rminus/lplus/lminus, equal the JAX package's SE(2) closed
    forms within 1e-10 (f64; autodiff of exp/log against formulas)."""
    rng = np.random.default_rng(seed)
    v, w = 0.8 * rng.standard_normal(3), 0.8 * rng.standard_normal(3)
    G = _SE2()
    g, h = G.exp(torch.as_tensor(v)), G.exp(torch.as_tensor(w))
    jg, jh = JSE2.exp(jnp.asarray(v)), JSE2.exp(jnp.asarray(w))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-12, rtol=0)
    pairs = [
        (G.Ad(g), JSE2.Ad(jg)),
        (G.ad(torch.as_tensor(v)), JSE2.ad(jnp.asarray(v))),
        (G.dr_exp(torch.as_tensor(v)), JSE2.dr_exp(jnp.asarray(v))),
        (G.dr_expinv(torch.as_tensor(v)), JSE2.dr_expinv(jnp.asarray(v))),
        (G.rplus(g, torch.as_tensor(w)), JSE2.rplus(jg, jnp.asarray(w))),
        (G.rminus(g, h), JSE2.rminus(jg, jh)),
        (G.lplus(g, torch.as_tensor(w)), JSE2.lplus(jg, jnp.asarray(w))),
        (G.lminus(g, h), JSE2.lminus(jg, jh)),
    ]
    for i, (got, ref) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-10, rtol=0,
                                   err_msg=str(i))


def test_rn_closed_forms_match_fallbacks():
    """Rn's closed forms equal the generic fallbacks and the JAX package's Rn."""
    G, J = Rn(3), JRn(3)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(3))
    for name in ("Ad", "ad", "dr_exp", "dr_expinv"):
        closed = getattr(G, name)(x)
        torch.testing.assert_close(closed, getattr(LieGroup, name)(G, x), rtol=0, atol=0)
        ref = getattr(J, name)(jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(closed.numpy(), np.asarray(ref))
    assert G == Rn(3) and G != Rn(2) and hash(G) == hash(Rn(3))
    assert G.is_commutative() and not _SE2().is_commutative()
    torch.testing.assert_close(G.rminus(G.rplus(x, x), x), x)
