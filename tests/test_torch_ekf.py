"""The PyTorch port's EKF (plain, iterated, square-root and fleet forms) and
the batch-trailing lane helpers against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; fleet
states cross between them one to one (the covariance stack batch-trailing,
``(ndof, ndof, B)``, in both).  Each JAX function is jitted once with its
group and callables static.  Float64 bars: the lane helpers within 1e-12,
the filters' ``g`` and ``P`` (or ``S``) within 1e-10 (the same algebra in
another order of operations and another Cholesky / QR implementation; the
measured differences are ~1e-15).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import smooth_feedback_tpu.estimators as je
import smooth_feedback_tpu_torch.estimators as te
from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import SO3 as JSO3
from smooth_feedback_tpu.utils import linalg as jla
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.groups import SE2, SO3
from smooth_feedback_tpu_torch.utils import linalg as tla

torch.set_num_threads(1)

GROUPS = {"SE2": (SE2, JSE2), "SO3": (SO3, JSO3)}
TOL = 1e-10


def _close(got, ref, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol, rtol=0, err_msg=msg)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------ lane helpers


def test_lane_helpers_match_jax():
    """mm_lane, mv_lane, sym_lane, chol_lane, chol_solve_lane and
    qr_lower_lane on (n, n, B) stacks (n = 3 and 6, B = 5) equal the JAX
    package's within 1e-12 (f64); qr_lower_lane's factor reproduces M M'
    with a non-negative diagonal, also for a rank-deficient stack."""
    rng = np.random.default_rng(0)
    for n in (3, 6):
        A, Bm = rng.standard_normal((n, n, 5)), rng.standard_normal((n, 2 * n, 5))
        x = rng.standard_normal((n, 5))
        S = np.einsum("ijb,kjb->ikb", A, A) + np.eye(n)[:, :, None]

        def helpers(la, A, Bm, x, S):
            return (la.mm_lane(A, Bm), la.mv_lane(A, x), la.sym_lane(A), la.chol_lane(S),
                    la.chol_solve_lane(la.chol_lane(S), Bm), la.qr_lower_lane(Bm))

        refs = jax.jit(functools.partial(helpers, jla))(*(jnp.asarray(a) for a in (A, Bm, x, S)))
        gots = helpers(tla, *(_t(a) for a in (A, Bm, x, S)))
        for i, (got, ref) in enumerate(zip(gots, refs)):
            _close(got.numpy(), ref, tol=1e-12, msg=f"n={n} case {i}")
        T = tla.qr_lower_lane(_t(Bm)).numpy()
        _close(np.einsum("ijb,kjb->ikb", T, T), np.einsum("ijb,kjb->ikb", Bm, Bm), tol=1e-12)
        assert (np.einsum("iib->ib", T) >= 0).all()
    low = rng.standard_normal((3, 1, 4)) * np.ones((1, 4, 1))  # rank 1 rows
    got = tla.qr_lower_lane(_t(low)).numpy()
    _close(got, jax.jit(jla.qr_lower_lane)(jnp.asarray(low)), tol=1e-12)
    assert np.isfinite(got).all()


# ------------------------------------------------------- per-member filters


def _twist(G, xp, dtype=None):
    """ekf_bench.py's twist 0.1 (1..ndof) in array module ``xp``."""
    if xp is torch:
        return 0.1 * torch.arange(1, G.ndof + 1, dtype=dtype or torch.float64)
    return 0.1 * jnp.arange(1, G.ndof + 1, dtype=dtype or jnp.float64)


def _callables(G, xp, c):
    """Dynamics that depend on the state and time, a Euclidean measurement
    and a manifold one (into G itself), in array module ``xp``."""
    tw = _twist(G, xp)
    f = lambda t, g: tw * (1.0 + 0.5 * xp.sin(t)) + 0.1 * G.log(g)
    h_euc = lambda g: G.log(G.compose(c, g))[:2] + 0.1 * G.log(g)[1:3] ** 2
    h_man = lambda g: G.compose(c, g)
    return f, h_euc, h_man


def _both(name, seed):
    """Per-member inputs in both packages: group, callables, g, P, Q, R, and
    the measurements."""
    G, J = GROUPS[name]
    rng = np.random.default_rng(seed)
    n = G.ndof
    v, c = 0.4 * rng.standard_normal(n), 0.5 * rng.standard_normal(n)
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + 0.2 * np.eye(n)
    Q = 0.01 * np.eye(n) + 0.002 * np.ones((n, n))
    jg, jc = J.exp(jnp.asarray(v)), J.exp(jnp.asarray(c))
    tg, tc = G.exp(_t(v)), G.exp(_t(c))
    jf, jh, jhm = _callables(J, jnp, jc)
    tf, th, thm = _callables(G, torch, tc)
    y = np.asarray(jh(jg)) + 0.2 * rng.standard_normal(2)
    ym = np.asarray(J.rplus(jhm(jg), jnp.asarray(0.3 * rng.standard_normal(n))))
    R = np.diag(0.05 + 0.1 * rng.random(2))
    Rm = 0.05 * np.eye(n) + 0.01 * np.ones((n, n))
    jax_side = (J, jf, jh, jhm, je.EKFState(jg, jnp.asarray(P)))
    torch_side = (G, tf, th, thm, te.EKFState(tg, _t(P)))
    return jax_side, torch_side, Q, (y, R), (ym, Rm)


@functools.lru_cache(maxsize=None)
def _jax_predicts(name):
    """The JAX package's ekf_predict with both steppers, one program."""
    (J, jf, *_, js), _, Q, _, _ = _both(name, 1)
    run = lambda s: {st: je.ekf_predict(J, jf, s, jnp.asarray(Q), 0.3, 3, st)
                     for st in ("euler", "rk4")}
    return jax.jit(run)(js)


@pytest.mark.parametrize("stepper", ["euler", "rk4"])
@pytest.mark.parametrize("name", ["SE2", "SO3"])
def test_ekf_predict_matches_jax(name, stepper):
    """ekf_predict (3 steps over tau = 0.3, dynamics depending on g and t)
    equals the JAX package's: g and P within 1e-10 (f64)."""
    _, (G, tf, *_, ts), Q, _, _ = _both(name, 1)
    ref = _jax_predicts(name)[stepper]
    got = te.ekf_predict(G, tf, ts, _t(Q), 0.3, 3, stepper)
    _close(got.g, ref.g)
    _close(got.P, ref.P)
    with pytest.raises(ValueError, match="stepper"):
        te.ekf_predict(G, tf, ts, _t(Q), 0.3, 1, "midpoint")


@functools.lru_cache(maxsize=None)
def _jax_updates():
    """The JAX package's updates of test_ekf_updates_match_jax, one program:
    {(kind, iters): state}, iters 0 meaning ekf_update."""
    (J, _, jh, jhm, js), _, _, euc, man = _both("SE2", 2)

    def run(s):
        out = {}
        for kind, h, (y, R), Y in (("euclidean", jh, euc, None), ("manifold", jhm, man, J)):
            y, R = jnp.asarray(y), jnp.asarray(R)
            out[kind, 0] = je.ekf_update(J, h, s, y, R, Y)
            for iters in (1, 3):
                out[kind, iters] = je.ekf_update_iterated(J, h, s, y, R, Y, iters)
        return out

    return jax.jit(run)(js)


@pytest.mark.parametrize("kind", ["euclidean", "manifold"])
@pytest.mark.parametrize("iters", [0, 1, 3], ids=["plain", "iter1", "iter3"])
def test_ekf_updates_match_jax(kind, iters):
    """ekf_update and ekf_update_iterated (1 and 3 sweeps), with a Euclidean
    measurement (m = 2) and a manifold one (Y = SE(2) itself, innovation
    y (-) h(g)), equal the JAX package's: g and P within 1e-10 (f64); one
    sweep equals the plain update."""
    _, (G, _, th, thm, ts), _, euc, man = _both("SE2", 2)
    h_t, (y, R), Y_t = (th, euc, None) if kind == "euclidean" else (thm, man, G)
    if iters == 0:
        got = te.ekf_update(G, h_t, ts, _t(y), _t(R), Y_t)
    else:
        got = te.ekf_update_iterated(G, h_t, ts, _t(y), _t(R), Y_t, iters)
        if iters == 1:
            plain = te.ekf_update(G, h_t, ts, _t(y), _t(R), Y_t)
            _close(got.g, plain.g, tol=1e-14)
            _close(got.P, plain.P, tol=1e-14)
    ref = _jax_updates()[kind, iters]
    _close(got.g, ref.g)
    _close(got.P, ref.P)


def test_sqrt_forms_match_jax_with_singular_noise():
    """The square-root forms against the JAX package's, on
    tests/test_ekf.py's singular case (heading known exactly, no process
    noise on two states, an exact measurement channel): sqrt_ekf_reset,
    10 predict substeps and an update, g and S within 1e-10 (f64), every
    factor finite and lower triangular with a non-negative diagonal; and a
    regular case (the SO(3) inputs above, manifold measurement)."""
    Q, R, P0 = np.diag([0.05, 0.0, 0.0]), np.diag([0.04, 0.0]), np.diag([1.0, 1.0, 0.0])
    y = np.array([0.3, -0.1])
    fj, ft = lambda t, g: jnp.array([1.0, 0.0, 0.4]), lambda t, g: _t([1.0, 0.0, 0.4])

    def run_j(g0):
        s = je.sqrt_ekf_reset(JSE2, g0, jnp.asarray(P0))
        s1 = je.sqrt_ekf_predict(JSE2, fj, s, jnp.asarray(Q), 0.5, n_steps=10)
        return s, s1, je.sqrt_ekf_update(JSE2, lambda g: g[:2], s1, jnp.asarray(y), jnp.asarray(R))

    s = te.sqrt_ekf_reset(SE2, SE2.identity(dtype=torch.float64), _t(P0))
    s1 = te.sqrt_ekf_predict(SE2, ft, s, _t(Q), 0.5, n_steps=10)
    s2 = te.sqrt_ekf_update(SE2, lambda g: g[:2], s1, _t(y), _t(R))
    for got, ref in zip((s, s1, s2), jax.jit(run_j)(JSE2.identity(jnp.float64))):
        _close(got.g, ref.g)
        _close(got.S, ref.S)
        S = got.S.numpy()
        assert np.isfinite(S).all() and (np.diag(S) >= 0).all() and not np.triu(S, 1).any()
    _close((s.S @ s.S.T).numpy(), P0, tol=1e-12)

    (J, jf, _, jhm, js), (G, tf, _, thm, ts), Q, _, (ym, Rm) = _both("SO3", 3)
    args = (jnp.asarray(Q), jnp.asarray(ym), jnp.asarray(Rm))

    def cycle_j(g, P, Q_, y_, R_):
        s = je.sqrt_ekf_predict(J, jf, je.sqrt_ekf_reset(J, g, P), Q_, 0.2, n_steps=2)
        return je.sqrt_ekf_update(J, jhm, s, y_, R_, Y=J)

    ref = jax.jit(cycle_j)(js.g, js.P, *args)
    got = te.sqrt_ekf_update(
        G, thm, te.sqrt_ekf_predict(G, tf, te.sqrt_ekf_reset(G, ts.g, ts.P), _t(Q), 0.2, 2),
        _t(ym), _t(Rm), Y=G,
    )
    _close(got.g, ref.g)
    _close(got.S, ref.S)


# ---------------------------------------------------------------- fleets


def _fleet_inputs(name, B, seed):
    """Fleet inputs in numpy: elements exp(0.3 N(0, I)), per-member
    covariances, shared and per-member (B, n, n) noise, measurements."""
    G, J = GROUPS[name]
    rng = np.random.default_rng(seed)
    n = G.ndof
    g0 = np.asarray(jax.vmap(J.exp)(jnp.asarray(0.3 * rng.standard_normal((B, n)))))
    P0 = np.stack([np.eye(n) * (1.0 + 0.1 * i) + 0.05 * np.ones((n, n)) for i in range(B)])
    Qs = np.stack([(0.01 + 0.05 * i) * np.eye(n) for i in range(B)])
    Rs = np.stack([(0.05 + 0.02 * i) * np.eye(n) for i in range(B)])
    y = np.asarray(jax.vmap(J.log)(jnp.asarray(g0))) + 0.05 * rng.standard_normal((B, n))
    return g0, P0, Qs, Rs, y


def _fleet_fns(J, G, xp):
    tw = _twist(G, xp)
    f = lambda t, g: tw * (1.0 + 0.5 * xp.sin(t)) + 0.1 * G.log(g)
    return f, G.log


@functools.lru_cache(maxsize=None)
def _jax_fleet_programs(name, per_member):
    """The JAX fleet forms of one test, jitted once: predict (euler, rk4),
    update, iterated update (3 sweeps), sqrt predict and update."""
    J = GROUPS[name][1]
    f, meas = _fleet_fns(None, J, jnp)

    def run(g0, P0, Qs, Rs, y):
        Q = Qs if per_member else Qs[0]
        R = Rs if per_member else Rs[0]
        fl = je.ekf_fleet_reset(J, g0, P0)
        out = {"euler": je.ekf_fleet_predict(J, f, fl, Q, 0.2, n_steps=2),
               "rk4": je.ekf_fleet_predict(J, f, fl, Q, 0.2, n_steps=2, stepper="rk4")}
        out["update"] = je.ekf_fleet_update(J, meas, out["euler"], y, R)
        out["manifold"] = je.ekf_fleet_update(J, lambda g: g, fl, jax.vmap(J.exp)(y), R, Y=J)
        out["iterated"] = je.ekf_fleet_update_iterated(J, meas, out["euler"], y, R, iters=3)
        sq = je.sqrt_ekf_fleet_reset(J, g0, P0)
        out["sqrt_reset"] = sq
        out["sqrt_predict"] = je.sqrt_ekf_fleet_predict(J, f, sq, Q, 0.2, n_steps=2)
        out["sqrt_update"] = je.sqrt_ekf_fleet_update(J, meas, out["sqrt_predict"], y, R)
        return out

    return jax.jit(run)


@pytest.mark.parametrize(
    "name,B,per_member",
    [("SE2", 8, False), ("SO3", 3, True)],
    ids=["SE2-B8-shared", "SO3-B3-per-member"],
)
def test_fleet_forms_match_jax(name, B, per_member):
    """Every fleet form against the JAX package's fleet form on the same
    states (g, and the (ndof, ndof, B) stacks, compared as they are): euler
    and rk4 predicts (2 substeps), the update, a manifold-measurement
    update, the iterated update (3 sweeps), and the square-root reset,
    predict and update; shared noise at B = 8, per-member (B, n, n) noise at
    B = 3 == ndof, where a 3-D noise stack must be read batch-leading.
    f64 within 1e-10.  The vmap of the per-member port functions gives the
    port's fleet result too."""
    G, J = GROUPS[name]
    g0, P0, Qs, Rs, y = _fleet_inputs(name, B, seed=B)
    ref = _jax_fleet_programs(name, per_member)(*(jnp.asarray(a) for a in (g0, P0, Qs, Rs, y)))
    f, meas = _fleet_fns(None, G, torch)
    Q, R = (_t(Qs), _t(Rs)) if per_member else (_t(Qs[0]), _t(Rs[0]))
    fl = te.ekf_fleet_reset(G, _t(g0), _t(P0))
    got = {"euler": te.ekf_fleet_predict(G, f, fl, Q, 0.2, n_steps=2),
           "rk4": te.ekf_fleet_predict(G, f, fl, Q, 0.2, n_steps=2, stepper="rk4")}
    got["update"] = te.ekf_fleet_update(G, meas, got["euler"], _t(y), R)
    got["manifold"] = te.ekf_fleet_update(G, lambda g: g, fl, vmap(G.exp)(_t(y)), R, Y=G)
    got["iterated"] = te.ekf_fleet_update_iterated(G, meas, got["euler"], _t(y), R, iters=3)
    sq = te.sqrt_ekf_fleet_reset(G, _t(g0), _t(P0))
    got["sqrt_reset"] = sq
    got["sqrt_predict"] = te.sqrt_ekf_fleet_predict(G, f, sq, Q, 0.2, n_steps=2)
    got["sqrt_update"] = te.sqrt_ekf_fleet_update(G, meas, got["sqrt_predict"], _t(y), R)
    for key, state in got.items():
        assert state[1].shape == (G.ndof, G.ndof, B), key
        for a, b in zip(state, ref[key]):
            _close(a, b, msg=key)

    # the per-member functions under vmap agree with the fleet forms
    per = te.ekf_fleet_states(G, fl)
    Qv = Q if per_member else Q.expand(B, -1, -1)
    Rv = R if per_member else R.expand(B, -1, -1)
    one = lambda s, Qi, Ri, yi: te.ekf_update(
        G, meas, te.ekf_predict(G, f, s, Qi, 0.2, n_steps=2), yi, Ri)
    v = vmap(one)(per, Qv, Rv, _t(y))
    fs = te.ekf_fleet_states(G, got["update"])
    _close(v.g, fs.g, tol=1e-12)
    _close(v.P, fs.P, tol=1e-12)


def _bench_problem(name, B, dtype, xp):
    """ekf_bench.py's problem: twist 0.1 (1..ndof), meas = G.log, Q = 0.01 I,
    R = 0.05 I."""
    G = GROUPS[name][0 if xp is torch else 1]
    tw = _twist(G, xp, dtype)
    eye = xp.eye(G.ndof, dtype=dtype)
    return G, (lambda t, g: tw), G.log, 0.01 * eye, 0.05 * eye


@pytest.mark.parametrize("name", ["SE2", "SO3"])
def test_slice_bench_chain_matches_jax(name):
    """The slice as a whole: 3 chained fleet predict + update steps of
    benchmarks/ekf_bench.py's problem (one Euler step of tau = 0.05, fresh
    measurement noise 0.05 N(0, I) a step, numpy from a seed) at B = 8, in
    the covariance fleet and the square-root fleet.  f64 within 1e-10; f32
    port against f32 JAX within 1e-5 (3 steps of f32 algebra on O(1)
    values: ~10 roundings of 6e-8 each per entry, with margin)."""
    B, steps = 8, 3
    rng = np.random.default_rng(5)
    n = GROUPS[name][0].ndof
    v0 = 0.2 * rng.standard_normal((B, n))
    noise = 0.05 * rng.standard_normal((steps, B, n))
    for jdt, tdt, tol in ((jnp.float64, torch.float64, TOL), (jnp.float32, torch.float32, 1e-5)):
        J, jf, jm, jQ, jR = _bench_problem(name, B, jdt, jnp)
        G, tf, tm, tQ, tR = _bench_problem(name, B, tdt, torch)

        @jax.jit
        def chain_j(g0, noise):
            def body(sq, nk):
                s, q = sq
                s = je.ekf_fleet_predict(J, jf, s, jQ, 0.05)
                s = je.ekf_fleet_update(J, jm, s, jax.vmap(jm)(s.g) + nk, jR)
                q = je.sqrt_ekf_fleet_predict(J, jf, q, jQ, 0.05)
                q = je.sqrt_ekf_fleet_update(J, jm, q, jax.vmap(jm)(q.g) + nk, jR)
                return (s, q), None

            # the reset states' stacks are broadcasts: materialize for the carry
            s0 = je.ekf_fleet_reset(J, g0)
            q0 = je.sqrt_ekf_fleet_reset(J, g0)
            carry = jax.tree.map(lambda a: a + jnp.zeros_like(a), (s0, q0))
            return jax.lax.scan(body, carry, noise)[0]

        g0 = jax.vmap(J.exp)(jnp.asarray(v0, jdt))
        rs, rq = chain_j(g0, jnp.asarray(noise, jdt))
        s = te.ekf_fleet_reset(G, _t(g0, tdt))
        q = te.sqrt_ekf_fleet_reset(G, _t(g0, tdt))
        for k in range(steps):
            nk = _t(noise[k], tdt)
            s = te.ekf_fleet_predict(G, tf, s, tQ, 0.05)
            s = te.ekf_fleet_update(G, tm, s, vmap(tm)(s.g) + nk, tR)
            q = te.sqrt_ekf_fleet_predict(G, tf, q, tQ, 0.05)
            q = te.sqrt_ekf_fleet_update(G, tm, q, vmap(tm)(q.g) + nk, tR)
        for got, ref in ((s, rs), (q, rq)):
            assert got.g.dtype == tdt and got[1].dtype == tdt
            for a, b in zip(got, ref):
                _close(a, b, tol=tol, msg=str(tdt))


def test_state_converters_and_ekf_class():
    """convert's EKF state converters carry JAX states across as they are
    (g, and the batch-trailing stacks); the EKF class runs predict and
    update like the functions."""
    g0, P0, *_ = _fleet_inputs("SO3", 4, seed=9)
    jf = je.ekf_fleet_reset(JSO3, jnp.asarray(g0), jnp.asarray(P0))
    jq = je.sqrt_ekf_fleet_reset(JSO3, jnp.asarray(g0), jnp.asarray(P0))
    tf = convert.ekf_fleet_state_from_numpy(tuple(np.asarray(a) for a in jf), device="cpu")
    tq = convert.sqrt_ekf_fleet_state_from_numpy(tuple(np.asarray(a) for a in jq), device="cpu")
    one = convert.ekf_state_from_numpy((g0[0], P0[0]), device="cpu")
    sq = convert.sqrt_ekf_state_from_numpy((g0[0], np.linalg.cholesky(P0[0])), device="cpu")
    assert isinstance(tf, te.EKFFleetState) and tf.Pt.shape == (3, 3, 4)
    assert isinstance(tq, te.SqrtEKFFleetState) and isinstance(sq, te.SqrtEKFState)
    _close(tf.Pt, jf.Pt, tol=0)
    _close(te.ekf_fleet_states(SO3, tf).P, P0, tol=0)
    St = tq.St.movedim(-1, 0)
    _close(St @ St.mT, P0, tol=1e-12)

    f = lambda t, g: 0.1 * SO3.log(g)
    ekf = te.EKF(SO3, one.g, one.P, device="cpu")
    ekf.predict(f, 0.01 * torch.eye(3, dtype=torch.float64), 0.1)
    ekf.update(SO3.log, torch.zeros(3, dtype=torch.float64), 0.05 * torch.eye(3, dtype=torch.float64))
    s = te.ekf_predict(SO3, f, one, 0.01 * torch.eye(3, dtype=torch.float64), 0.1)
    s = te.ekf_update(SO3, SO3.log, s, torch.zeros(3, dtype=torch.float64),
                      0.05 * torch.eye(3, dtype=torch.float64))
    torch.testing.assert_close(ekf.estimate, s.g, rtol=0, atol=0)
    torch.testing.assert_close(ekf.covariance, s.P, rtol=0, atol=0)
    assert te.EKF(SO3, device="cpu").estimate.tolist() == [0.0, 0.0, 0.0, 1.0]
