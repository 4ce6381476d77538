"""The PyTorch port's Lie-group core against the JAX package, on the CPU.

The ``torch.func.jacfwd`` fallbacks for the adjoints and right Jacobians
are checked on a test-local SE(2) that defines only exp/log/compose/inverse,
against the JAX package's closed forms; then every concrete group's closed
forms against the JAX package's.
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


# ------------------------------------------------- SO(2), SE(2) closed forms

from smooth_feedback_tpu.groups import SO2 as JSO2  # noqa: E402
from smooth_feedback_tpu.groups import _series as jse  # noqa: E402
from smooth_feedback_tpu_torch.groups import SE2, SO2  # noqa: E402
from smooth_feedback_tpu_torch.groups import _series as tse  # noqa: E402

# angles across both sides of every series seam (f64: 1e-2), 0 and near 2 pi
ANGLES = [0.0, 1e-9, -3e-3, 9e-3, 0.011, -0.4, 1.3, 3.0, -6.0]


def _close(got, ref, tol=1e-12, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("name", ["sinc", "cos1c", "acos_over_sinc", "cos1c2", "sin3c2",
                                  "jlinv2c2", "dcos1c2", "dsin3c2", "djlinv2c2", "sin3c",
                                  "jlinv2c", "sinc2", "cos2", "cos4c2", "sin5c2", "dcos4c2",
                                  "dsin5c2"])
def test_series_helpers_match_jax(name):
    """Each series helper equals the JAX package's within 1e-12 (f64) at
    angles on both sides of the seams, and its derivative by forward-mode
    autodiff is finite at 0 (the guarded double-where form) and equals
    JAX's within 1e-9 plus the exact branch's cancellation, ~eps / x^2
    (1.5e-8 measured for d jlinv2c2 just above its seam, in both packages'
    arithmetic alike)."""
    import jax

    tf_, jf = getattr(tse, name), getattr(jse, name)
    squared = name.endswith("2")
    for a in ANGLES + ([0.45, 0.55] if squared else []):  # the t = 0.5 seam of the SE(3) helpers
        x = a * a if squared else a
        tx = torch.tensor(x, dtype=torch.float64)
        _close(tf_(tx), jf(jnp.asarray(x)), msg=f"{name}({x})")
        d = torch.func.jacfwd(tf_)(tx)
        assert torch.isfinite(d)
        tol = 1e-9 + (1e-15 / x**2 if abs(x) >= 1e-4 else 0.0)
        _close(d, jax.jacfwd(jf)(jnp.asarray(x)), tol=tol, msg=f"d {name}({x})")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_so2_se2_match_jax(seed):
    """SO2 and SE2 exp, log, compose, inverse, rplus/rminus, Ad, ad, dr_exp,
    dr_expinv, normalize and matrix equal the JAX package's within 1e-12
    (f64), at random elements and at small and zero angles; jacfwd of
    rminus (what the transcription takes) equals JAX's too."""
    import jax

    rng = np.random.default_rng(seed)
    for G, J in ((SE2, JSE2), (SO2, JSO2)):
        vs = [rng.standard_normal(G.ndof) for _ in range(2)]
        small = rng.standard_normal(G.ndof)
        small[-1] = 1e-9 * (seed - 1)  # angle 0 and +-1e-9
        for v, w in ((vs[0], vs[1]), (small, vs[0])):
            tv, tw = torch.as_tensor(v), torch.as_tensor(w)
            jv, jw = jnp.asarray(v), jnp.asarray(w)
            g, h = G.exp(tv), G.exp(tw)
            jg, jh = J.exp(jv), J.exp(jw)
            pairs = [
                ("exp", g, jg), ("log", G.log(g), J.log(jg)),
                ("compose", G.compose(g, h), J.compose(jg, jh)),
                ("inverse", G.inverse(g), J.inverse(jg)),
                ("rplus", G.rplus(g, tw), J.rplus(jg, jw)),
                ("rminus", G.rminus(g, h), J.rminus(jg, jh)),
                ("Ad", G.Ad(g), J.Ad(jg)), ("ad", G.ad(tv), J.ad(jv)),
                ("dr_exp", G.dr_exp(tv), J.dr_exp(jv)),
                ("dr_expinv", G.dr_expinv(tv), J.dr_expinv(jv)),
                ("normalize", G.normalize(1.01 * g), J.normalize(1.01 * jg)),
                ("matrix", G.matrix(g), J.matrix(jg)),
                ("d rminus", torch.func.jacfwd(lambda a: G.rminus(G.rplus(g, a), h))(tv * 0),
                 jax.jacfwd(lambda a: J.rminus(J.rplus(jg, a), jh))(jv * 0)),
            ]
            for name, got, ref in pairs:
                _close(got, ref, msg=f"{G} {name}")
        assert G.is_commutative() == J.is_commutative()
    x = SE2.identity(dtype=torch.float64)
    torch.testing.assert_close(x, torch.tensor(np.asarray(JSE2.identity(jnp.float64))))
    # the closed forms agree with the LieGroup jacfwd fallbacks
    v = torch.as_tensor(rng.standard_normal(3))
    for name in ("Ad", "ad", "dr_exp", "dr_expinv"):
        arg = SE2.exp(v) if name == "Ad" else v
        _close(getattr(SE2, name)(arg), getattr(LieGroup, name)(SE2, arg).numpy(), tol=1e-10,
               msg=name)


def test_se2_runs_under_vmap_and_jacfwd_in_f32():
    """SE2 under vmap of jacfwd in float32 keeps float32 throughout, as the
    f32 transcription needs."""
    ts = torch.linspace(0.0, 3.0, 5)
    twist = torch.tensor([0.5, 0.0, 0.3])
    J = torch.func.vmap(torch.func.jacfwd(
        lambda t: SE2.rminus(SE2.exp((t + 0.1) * twist), SE2.exp(t * twist))
    ))(ts)
    assert J.dtype == torch.float32 and J.shape == (5, 3)
    torch.testing.assert_close(J, torch.zeros_like(J))


# ---------------------------------------------------------- SO(3), SE(3)

from smooth_feedback_tpu.groups import SE3 as JSE3  # noqa: E402
from smooth_feedback_tpu.groups import SO3 as JSO3  # noqa: E402
from smooth_feedback_tpu_torch.groups import SE3, SO3  # noqa: E402


def _rotation_cases(rng, G):
    """Tangents (v, w) whose rotation part is random, zero, 1e-9, near the
    f64 series seam (1e-2), of angle near pi, and of angle past pi (the log
    must return the principal branch)."""
    def with_angle(theta):
        v = rng.standard_normal(G.ndof)
        r = rng.standard_normal(3)
        v[-3:] = theta * r / np.linalg.norm(r)
        return v

    return [(with_angle(th), rng.standard_normal(G.ndof))
            for th in (1.1, 0.0, 1e-9, 9e-3, 0.011, np.pi - 1e-6, np.pi + 0.3)]


@pytest.mark.parametrize("name", ["SO3", "SE3"])
def test_so3_se3_match_jax(name):
    """SO3 and SE3 exp, log, compose, inverse, rplus, rminus, lplus, lminus,
    Ad, ad, dr_exp, dr_expinv, dl_exp, dl_expinv, normalize, matrix, hat
    and the so(3) generators (SO3) and jacfwd of rminus equal the JAX
    package's within 1e-12 (f64)
    at random, zero, tiny and near-pi angles and past pi; the closed forms
    equal the LieGroup jacfwd fallbacks within 1e-9 at a random tangent;
    identity and random() give elements of the group."""
    import jax

    G, J = (SO3, JSO3) if name == "SO3" else (SE3, JSE3)
    rng = np.random.default_rng(7)
    for k, (v, w) in enumerate(_rotation_cases(rng, G)):
        tv, tw = torch.as_tensor(v), torch.as_tensor(w)
        jv, jw = jnp.asarray(v), jnp.asarray(w)
        g, h = G.exp(tv), G.exp(tw)
        jg, jh = J.exp(jv), J.exp(jw)
        pairs = [
            ("exp", g, jg), ("log", G.log(g), J.log(jg)),
            ("compose", G.compose(g, h), J.compose(jg, jh)),
            ("inverse", G.inverse(g), J.inverse(jg)),
            ("rplus", G.rplus(g, tw), J.rplus(jg, jw)),
            ("rminus", G.rminus(g, h), J.rminus(jg, jh)),
            ("lplus", G.lplus(g, tw), J.lplus(jg, jw)),
            ("lminus", G.lminus(g, h), J.lminus(jg, jh)),
            ("Ad", G.Ad(g), J.Ad(jg)), ("ad", G.ad(tv), J.ad(jv)),
            ("dr_exp", G.dr_exp(tv), J.dr_exp(jv)),
            ("dr_expinv", G.dr_expinv(tv), J.dr_expinv(jv)),
            ("dl_exp", G.dl_exp(tv), J.dl_exp(jv)),
            ("dl_expinv", G.dl_expinv(tv), J.dl_expinv(jv)),
            ("normalize", G.normalize(1.01 * g), J.normalize(1.01 * jg)),
            ("matrix", G.matrix(g), J.matrix(jg)),
            ("d rminus", torch.func.jacfwd(lambda a: G.rminus(G.rplus(g, a), h))(tv * 0),
             jax.jacfwd(lambda a: J.rminus(J.rplus(jg, a), jh))(jv * 0)),
        ]
        if name == "SO3":
            pairs.append(("hat", G.hat(tv), J.hat(jv)))
        # the log of a rotation past pi is the principal one
        pairs.append(("log o exp", G.log(G.exp(tv)), J.log(J.exp(jv))))
        for what, got, ref in pairs:
            _close(got, ref, msg=f"{name} case {k} {what}")
    v = torch.as_tensor(rng.standard_normal(G.ndof))
    for what in ("Ad", "ad", "dr_exp", "dr_expinv"):
        arg = G.exp(v) if what == "Ad" else v
        _close(getattr(G, what)(arg), getattr(LieGroup, what)(G, arg).numpy(), tol=1e-9, msg=what)
    _close(G.identity(dtype=torch.float64), J.identity(jnp.float64), tol=0)
    if name == "SO3":
        from smooth_feedback_tpu.groups.groups import _so3_generators as jgen
        from smooth_feedback_tpu_torch.groups.groups import _so3_generators as tgen

        _close(tgen(torch.float64), jgen(jnp.float64), tol=0)
    gen = torch.Generator().manual_seed(0)
    r = G.random(gen, 0.2, dtype=torch.float64)
    assert r.shape == (G.nparams,) and abs(float(torch.linalg.vector_norm(r[-4:])) - 1) < 1e-12
    assert not G.is_commutative()


def test_so3_se3_run_under_vmap_and_jacfwd_in_f32():
    """SO3 and SE3 under vmap of jacfwd in float32 keep float32 throughout
    (1-d slices where a Python scalar enters, as _series explains)."""
    ts = torch.linspace(0.0, 3.0, 5)
    for G in (SO3, SE3):
        twist = 0.1 * torch.arange(1.0, G.ndof + 1)
        J = torch.func.vmap(torch.func.jacfwd(
            lambda t: G.rminus(G.exp((t + 0.1) * twist), G.exp(t * twist))
        ))(ts)
        assert J.dtype == torch.float32 and J.shape == (5, G.ndof)
        torch.testing.assert_close(J, torch.zeros_like(J), rtol=0, atol=1e-6)
        Jw = torch.func.vmap(torch.func.jacfwd(lambda w: G.log(G.rplus(G.exp(twist), w))))(
            torch.zeros(5, G.ndof))
        assert Jw.dtype == torch.float32
