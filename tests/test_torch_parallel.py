"""The port's data parallelism (``smooth_feedback_tpu_torch.parallel``) on the
CPU, on tests/test_parallel.py's six mesh workloads and inputs (converted
with numpy), in float64.

The port runs sharded on a mesh of eight ``"cpu"`` entries (eight threads,
one shard each) and is held to the port unsharded: statuses and iteration
counts equal, floats within 1e-12 of the result's scale.  The port unsharded is held to the JAX
package unsharded, each JAX program built once: statuses and iteration
counts equal, primal within 1e-9 (JAX's sharded results equal its
unsharded ones: tests/test_parallel.py).  Then the module's contracts: an
uneven batch raises, the axis of each shard, one callable or one per
device, a failing shard reaches the caller; and the two thread-safety
repairs the shards need (the TF32 scope and the counters).
"""

import contextlib
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu import estimators as JE
from smooth_feedback_tpu.controllers import MPCParams as JMPCParams
from smooth_feedback_tpu.controllers import MPCWeights as JMPCWeights
from smooth_feedback_tpu.controllers import make_mpc_step as j_make_mpc_step
from smooth_feedback_tpu.groups import SE2 as JSE2
from smooth_feedback_tpu.groups import SO3 as JSO3
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.nlp import NLP as JNLP
from smooth_feedback_tpu.qp import QPSolverParams as JQPSolverParams
from smooth_feedback_tpu.qp import random_qp as j_random_qp
from smooth_feedback_tpu.qp import solve_qp_batch as j_solve_qp_batch
from smooth_feedback_tpu.solvers import SQPParams as JSQPParams
from smooth_feedback_tpu.solvers import solve_nlp_sqp_batch as j_sqp_batch
from smooth_feedback_tpu_torch import _precision, convert
from smooth_feedback_tpu_torch import estimators as E
from smooth_feedback_tpu_torch.controllers import MPCParams, make_mpc_step
from smooth_feedback_tpu_torch.groups import SE2, SO3, Rn
from smooth_feedback_tpu_torch.nlp import NLP, NLPSolutionStatus
from smooth_feedback_tpu_torch.parallel import (
    dp_mesh, make_sharded_fleet_step, make_sharded_sqp_fleet, replicate, shard_batch,
    shard_ekf_fleet, shard_pytree, shard_trailing,
)
from smooth_feedback_tpu_torch.parallel.mesh_utils import Replicated, Sharded, _shard_map, gather
from smooth_feedback_tpu_torch.qp import QPSolverParams, solve_qp_batch
from smooth_feedback_tpu_torch.qp import cuda_kernel
from smooth_feedback_tpu_torch.qp import solver as qsolver
from smooth_feedback_tpu_torch.solvers import SQPParams, solve_nlp_sqp_batch

torch.set_num_threads(1)

N_SHARDS = 8
B = 2 * N_SHARDS
FLOAT_TOL = 1e-12  # sharded against unsharded, relative to the result's scale
JAX_TOL = 1e-9  # the port against JAX: float64, another summation order


@pytest.fixture
def mesh():
    return dp_mesh(["cpu"] * N_SHARDS)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_sharded(tree, mesh):
    for leaf in jax.tree.leaves(tree, is_leaf=lambda a: isinstance(a, (Sharded, Replicated))):
        if isinstance(leaf, torch.Tensor):
            raise AssertionError("an output leaf came back whole")
        if isinstance(leaf, Sharded):
            assert len(leaf.parts) == mesh.size


def _same(sharded, local, ints=("status", "iters"), scale=None):
    """The gathered sharded result against the unsharded one: the integer
    fields equal, every float within FLOAT_TOL of the result's scale
    (max(1, its largest finite |float|)): a batch of 2 and one of 16 take
    other vectorized summation orders on the CPU."""
    whole = gather(sharded)
    if scale is None:
        floats = [a[torch.isfinite(a)].abs() for a in jax.tree.leaves(local)
                  if isinstance(a, torch.Tensor) and a.is_floating_point()]
        scale = max([1.0] + [float(a.max()) for a in floats if a.numel()])
    for name in type(local)._fields:
        a, b = getattr(whole, name), getattr(local, name)
        if isinstance(b, tuple):
            _same(a, b, ints, scale)
        elif isinstance(b, torch.Tensor):
            assert a.shape == b.shape, name
            if name in ints or not b.is_floating_point():
                assert torch.equal(a, b), name
            else:
                torch.testing.assert_close(a, b, atol=FLOAT_TOL * scale, rtol=0, msg=name)


def _jax_qps(seed, n, m):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.vmap(lambda k: j_random_qp(k, n=n, m=m))(keys)


def _check_qp(mesh, jqps, jprm, tprm):
    tqps = convert.qp_from_numpy(_np(jqps), device="cpu")
    local = solve_qp_batch(tqps, tprm)
    solve = _shard_map(lambda qp: solve_qp_batch(qp, tprm), mesh, (0,), 0)
    sharded = solve(shard_pytree(tqps, mesh))
    _assert_sharded(sharded, mesh)
    _same(sharded, local)
    jsol = j_solve_qp_batch(jqps, jprm)
    np.testing.assert_array_equal(local.status.numpy(), np.asarray(jsol.status))
    np.testing.assert_array_equal(local.iters.numpy(), np.asarray(jsol.iters))
    np.testing.assert_allclose(local.primal.numpy(), np.asarray(jsol.primal), atol=JAX_TOL, rtol=0)


def test_sharded_qp_batch(mesh):
    """tests/test_parallel.py's QP batch (random_qp, n = 6, m = 8, B = 16,
    default parameters) through solve_qp_batch on each shard."""
    _check_qp(mesh, _jax_qps(3, 6, 8), JQPSolverParams(), QPSolverParams())


def test_sharded_lane_qp_adaptive_rho(mesh):
    """The lane backend with adaptive rho (n = 4, m = 10, polish off): a
    member's solve does not depend on the batch around it."""
    jprm = dataclasses.replace(JQPSolverParams(polish=False), backend="lane", adaptive_rho=True)
    tprm = dataclasses.replace(QPSolverParams(polish=False), backend="lane", adaptive_rho=True)
    _check_qp(mesh, _jax_qps(21, 4, 10), jprm, tprm)


# __graft_entry__._build_fleet(B=16, K=8, bench_config=True): bench.py's
# solver settings at a K below 50 (max_iter 400), condensed, shared factors
BENCH_QP = dict(scaling=True, polish=False, rho=2.0, rho_eq_scale=15.0, max_iter=400,
                stop_check_iter=10)
WEIGHTS = (np.eye(2), 0.1 * np.eye(2), 0.1 * np.eye(1))


def test_sharded_condensed_fleet_step(mesh):
    """The bench configuration's condensed fleet step (K = 8, B = 16,
    float64; the port's "torch" loop, JAX's "xla") through
    make_sharded_fleet_step, then a second step from the sharded warm
    start; JAX's _build_fleet states.  Statuses are compared, not required
    Optimal: at t = 0.3 one member reaches max_iter in float64 in both
    packages (tests/test_parallel.py's float32 Pallas run has none)."""
    j_step, jws0 = j_make_mpc_step(
        JRn(2), JRn(1), lambda x, u: jnp.stack([x[1], u[0]]),
        lambda t: jnp.stack([-0.5 * jnp.sin(0.3 * t), -0.15 * jnp.cos(0.3 * t)]),
        lambda t: jnp.zeros(1), weights=JMPCWeights(*(jnp.asarray(w) for w in WEIGHTS)),
        params=JMPCParams(K=8, tf=5.0, qp=JQPSolverParams(**BENCH_QP), return_trajectories=False),
        cr=lambda x, u: u, crl=jnp.array([-0.5]), cru=jnp.array([0.5]),
        reuse_factors=True, condense=True,
    )
    t_step, tws0 = make_mpc_step(
        Rn(2), Rn(1), lambda x, u: torch.stack([x[1], u[0]]),
        lambda t: torch.stack([-0.5 * torch.sin(0.3 * t), -0.15 * torch.cos(0.3 * t)]),
        lambda t: torch.zeros(1, dtype=torch.float64),
        weights=convert.weights_from_numpy(WEIGHTS, device="cpu"),
        params=MPCParams(K=8, tf=5.0, qp=QPSolverParams(**BENCH_QP), return_trajectories=False),
        cr=lambda x, u: u, crl=[-0.5], cru=[0.5], device="cpu", reuse_factors=True, condense=True,
    )
    xs = np.array(0.5 * jax.random.normal(jax.random.PRNGKey(0), (B, 2)))
    jws = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jws0)
    tws = type(tws0)(*(a.expand((B,) + a.shape) for a in tws0))
    j_fleet = jax.jit(j_step.fleet_shared_t)
    sharded_step = make_sharded_fleet_step(t_step.fleet_shared_t, mesh)
    tx = torch.as_tensor(xs)
    xs_s, ws_s = shard_batch(tx, mesh), shard_pytree(tws, mesh)
    for t in (0.3, 0.35):
        local = t_step.fleet_shared_t(tws, t, tx)
        sharded = sharded_step(ws_s, t, xs_s)
        _assert_sharded(sharded, mesh)
        _same(sharded, local)
        jr = j_fleet(jws, t, jnp.asarray(xs))
        np.testing.assert_array_equal(local.status.numpy(), np.asarray(jr.status))
        np.testing.assert_array_equal(local.warmstart.iters.numpy(),
                                      np.asarray(jr.warmstart.iters))
        np.testing.assert_allclose(local.u.numpy(), np.asarray(jr.u), atol=JAX_TOL, rtol=0)
        # the closed-loop carry: the next step starts from each run's own
        tws, jws, ws_s = local.warmstart, jr.warmstart, sharded.warmstart
    # per-member clocks shard like the states
    ts = torch.linspace(0.0, 1.0, B, dtype=torch.float64)
    one, ows0 = make_mpc_step(
        Rn(2), Rn(1), lambda x, u: torch.stack([x[1], u[0]]),
        lambda t: torch.stack([0.1 * t, 0.1 + 0.0 * t]), lambda t: torch.zeros(1, dtype=t.dtype),
        weights=convert.weights_from_numpy(WEIGHTS, device="cpu"),
        params=MPCParams(K=4, tf=5.0, qp=QPSolverParams(**BENCH_QP), return_trajectories=False),
        device="cpu",
    )
    ows = type(ows0)(*(a.expand((B,) + a.shape) for a in ows0))
    _same(make_sharded_fleet_step(one.fleet, mesh)(ows, ts, tx), one.fleet(ows, ts, tx))


def _jax_group_states(G, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.vmap(lambda k: G.random(k, 0.3))(keys)


def test_sharded_ekf_fleet(mesh):
    """The SE(2) EKF fleet (predict over 3 Euler steps, then update) on a
    state sharded with shard_ekf_fleet: g on its leading axis, Pt on its
    trailing one."""
    g0 = _jax_group_states(JSE2, 9)
    twist = np.array([0.4, 0.0, 0.2])
    Q, R = 0.01 * np.eye(3), 0.05 * np.eye(3)

    def j_step(s, y):
        s = JE.ekf_fleet_predict(JSE2, lambda t, g: jnp.asarray(twist) + 0.1 * JSE2.log(g), s,
                                 jnp.asarray(Q), 0.1, n_steps=3)
        return JE.ekf_fleet_update(JSE2, JSE2.log, s, y, jnp.asarray(R))

    def t_step(s, y):
        tw = torch.as_tensor(twist)
        s = E.ekf_fleet_predict(SE2, lambda t, g: tw + 0.1 * SE2.log(g), s, torch.as_tensor(Q),
                                0.1, n_steps=3)
        return E.ekf_fleet_update(SE2, SE2.log, s, y, torch.as_tensor(R))

    y = jax.vmap(JSE2.log)(g0) + 0.05
    jr = jax.jit(j_step)(JE.ekf_fleet_reset(JSE2, g0), y)
    s0 = E.ekf_fleet_reset(SE2, torch.as_tensor(np.asarray(g0)))
    ty = torch.as_tensor(np.asarray(y))
    local = t_step(s0, ty)
    axes = (E.EKFFleetState(0, -1), 0)
    sharded = _shard_map(t_step, mesh, axes, axes[0])(shard_ekf_fleet(s0, mesh), ty)
    assert sharded.Pt.axis == 2 and sharded.Pt.parts[0].shape == (3, 3, B // N_SHARDS)
    _same(sharded, local)
    np.testing.assert_allclose(local.g.numpy(), np.asarray(jr.g), atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(local.Pt.numpy(), np.asarray(jr.Pt), atol=JAX_TOL, rtol=0)


def test_sharded_sqrt_ekf_fleet(mesh):
    """The SO(3) square-root fleet update: shard_ekf_fleet takes the field
    St as it takes Pt."""
    g0 = _jax_group_states(JSO3, 41)
    R = 0.05 * np.eye(3)
    y = jax.vmap(JSO3.log)(g0) + 0.05
    jr = jax.jit(lambda s, y: JE.sqrt_ekf_fleet_update(JSO3, JSO3.log, s, y, jnp.asarray(R)))(
        JE.sqrt_ekf_fleet_reset(JSO3, g0), y)
    t_step = lambda s, y: E.sqrt_ekf_fleet_update(SO3, SO3.log, s, y, torch.as_tensor(R))
    s0 = E.sqrt_ekf_fleet_reset(SO3, torch.as_tensor(np.asarray(g0)))
    ty = torch.as_tensor(np.asarray(y))
    local = t_step(s0, ty)
    axes = (E.SqrtEKFFleetState(0, -1), 0)
    sharded = _shard_map(t_step, mesh, axes, axes[0])(shard_ekf_fleet(s0, mesh), ty)
    assert isinstance(sharded.St, Sharded) and sharded.St.axis == 2
    _same(sharded, local)
    np.testing.assert_allclose(local.g.numpy(), np.asarray(jr.g), atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(local.St.numpy(), np.asarray(jr.St), atol=JAX_TOL, rtol=0)


def _nlp_family(xp, NLPType):
    stack = jnp.stack if xp is jnp else torch.stack
    full = (lambda v, n: jnp.full(n, v)) if xp is jnp else (
        lambda v, n: torch.full((n,), v, dtype=torch.float64))

    def make(b):
        return NLPType(
            n=2, m=1,
            f=lambda x: (x[0] - b) ** 2 + 0.5 * (x[1] + b) ** 2 + 0.1 * x[0] * x[1],
            g=lambda x: stack([x[0] + x[1]]),
            xl=full(-5.0, 2), xu=full(5.0, 2), gl=full(-1.0, 1), gu=full(1.0, 1),
        )

    return make


@functools.lru_cache(maxsize=None)
def _jax_sqp():
    prm = JSQPParams(max_iter=40, tol=1e-10)
    bs = jnp.linspace(-2.0, 2.0, B)
    return _np(j_sqp_batch(_nlp_family(jnp, JNLP), bs, jnp.zeros((B, 2)), prm))


@pytest.mark.parametrize("chunk_size", [None, 1])
def test_sharded_sqp_fleet(mesh, chunk_size):
    """tests/test_parallel.py's SQP fleet (B = 16 two-variable NLPs) through
    make_sharded_sqp_fleet, each shard's lockstep loop its own; with
    chunk_size=1 each shard chunks its own part.  Both against JAX's
    unchunked fleet (one JAX program): without a probe, chunking leaves
    each member's lockstep path as it is."""
    prm = SQPParams(max_iter=40, tol=1e-10, chunk_size=chunk_size)
    make = _nlp_family(torch, NLP)
    bs = torch.linspace(-2.0, 2.0, B, dtype=torch.float64)
    x0 = torch.zeros((B, 2), dtype=torch.float64)
    local = solve_nlp_sqp_batch(make, bs, x0, prm)
    sharded = make_sharded_sqp_fleet(make, mesh, prm)(shard_batch(bs, mesh), x0)
    _assert_sharded(sharded, mesh)
    _same(sharded, local, ints=("status", "iters", "qp_iters"))
    assert bool((local.status == int(NLPSolutionStatus.Optimal)).all())
    js = _jax_sqp()
    for name in ("status", "iters", "qp_iters"):
        np.testing.assert_array_equal(getattr(local, name).numpy(), getattr(js, name), name)
    np.testing.assert_allclose(local.x.numpy(), js.x, atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(local.objective.numpy(), js.objective, atol=JAX_TOL, rtol=0)


def test_uneven_batch_raises(mesh):
    """A batch that does not divide evenly over the mesh raises, as
    shard_map does; so does a 0-d tensor."""
    with pytest.raises(ValueError, match="divide evenly"):
        shard_batch(torch.zeros(B + 1, 3), mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        shard_trailing(torch.zeros(3, B - 1), mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        _shard_map(lambda x: x, mesh, (0,), 0)(torch.zeros(N_SHARDS + 2))
    with pytest.raises(ValueError, match="0-d"):
        shard_batch(torch.tensor(1.0), mesh)


def test_shard_axes_and_gather(mesh):
    """Each shard holds its contiguous part on its axis: shard_batch the
    leading one, shard_trailing and shard_ekf_fleet's stack the trailing
    one; gather restores the tensor; replicate copies it to every shard;
    dp_mesh() without a card raises."""
    a = torch.arange(B * 6, dtype=torch.float64).reshape(B, 2, 3)
    s = shard_batch(a, mesh)
    assert s.axis == 0 and s.shape == (B, 2, 3) and len(s.parts) == N_SHARDS
    assert all(torch.equal(p, a[2 * i:2 * i + 2]) for i, p in enumerate(s.parts))
    t = shard_trailing(a.movedim(0, -1), mesh)
    assert t.axis == 2 and all(p.shape == (2, 3, 2) for p in t.parts)
    assert torch.equal(t.gather(), a.movedim(0, -1)) and torch.equal(gather(s), a)
    assert shard_batch(s, mesh) is s
    fleet = E.ekf_fleet_reset(SE2, SE2.identity(dtype=torch.float64, device="cpu").expand(B, 4))
    sf = shard_ekf_fleet(fleet, mesh)
    assert (sf.g.axis, sf.Pt.axis) == (0, 2)
    assert sf.g.parts[1].shape == (2, 4) and sf.Pt.parts[1].shape == (3, 3, 2)
    assert torch.equal(sf.Pt.gather(), fleet.Pt)
    r = replicate({"P": torch.eye(3)}, mesh)["P"]
    assert isinstance(r, Replicated) and len(r.parts) == N_SHARDS
    out = _shard_map(lambda x, P: x.sum() * P, mesh, (0, None), None)(a, r)
    assert isinstance(out, Replicated)
    assert [float(p[0, 0]) for p in out.parts] == [float(a[2 * i:2 * i + 2].sum())
                                                  for i in range(N_SHARDS)]
    with pytest.raises(ValueError, match="axis"):
        _shard_map(lambda x: x, mesh, (-1,), 0)(s)
    with pytest.raises(ValueError, match="axis"):
        shard_batch(a, mesh, axis_name="model")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dp_mesh()


def test_one_callable_or_one_per_device():
    """A step closes over tensors on the device it was built on: one
    callable serves a mesh only where every mesh device is its device, else
    it takes one callable for each mesh device; nothing is copied."""
    step, _ = make_mpc_step(
        Rn(2), Rn(1), lambda x, u: torch.stack([x[1], u[0]]),
        lambda t: torch.stack([0.1 * t, 0.1 + 0.0 * t]), lambda t: torch.zeros(1, dtype=t.dtype),
        weights=convert.weights_from_numpy(WEIGHTS, device="cpu"),
        params=MPCParams(K=4, tf=1.0), device="cpu",
    )
    assert step.fleet.device == torch.device("cpu")
    cpu4 = dp_mesh(["cpu"] * 4)
    make_sharded_fleet_step(step.fleet_shared_t, cpu4)
    make_sharded_fleet_step([step.fleet_shared_t] * 4, cpu4)
    with pytest.raises(ValueError, match="3 callables for a mesh of 4"):
        make_sharded_fleet_step([step.fleet_shared_t] * 3, cpu4)
    # a mesh that spans two devices needs a callable for each; a callable
    # that lives on another device than its mesh entry is refused.  The
    # devices are checked before anything touches them, so "meta" stands in
    # for a second device here.
    two = dp_mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="one callable for each mesh device"):
        make_sharded_fleet_step(step.fleet_shared_t, two)
    with pytest.raises(ValueError, match="on cpu for mesh device meta"):
        make_sharded_fleet_step([step.fleet_shared_t] * 2, two)
    with pytest.raises(ValueError, match=r"one callable \(on cpu\)"):
        make_sharded_sqp_fleet(step.fleet_shared_t, dp_mesh(["meta"] * 2), SQPParams())
    make_sharded_sqp_fleet(lambda th: None, dp_mesh(["meta"] * 2), SQPParams())
    with pytest.raises(ValueError, match="one callable for each mesh device"):
        make_sharded_sqp_fleet(lambda th: None, two, SQPParams())
    # _shard_map, like jax.shard_map, runs one function on every shard of
    # any mesh, unless it carries another device
    _shard_map(lambda x: x, two, (0,), 0)
    with pytest.raises(ValueError, match=r"one callable \(on cpu\)"):
        _shard_map(step.fleet_shared_t, two, (0, None, 0), 0)


def test_failing_shard_reaches_the_caller(mesh):
    """An exception in one shard is raised in the caller once every thread
    has ended; no shard is retried or skipped."""
    calls = []

    def fn(x):
        calls.append(threading.current_thread().name)
        if float(x[0]) == 4.0:
            raise FloatingPointError("shard 2 failed")
        return x

    with pytest.raises(FloatingPointError, match="shard 2 failed") as info:
        _shard_map(fn, mesh, (0,), 0)(torch.arange(B, dtype=torch.float64))
    assert "in shard 2 of 8" in "".join(getattr(info.value, "__notes__", []))
    assert sorted(calls) == sorted(f"shard-{i}" for i in range(N_SHARDS))


def test_ieee_f32_matmul_across_threads():
    """Two threads inside ieee_f32_matmul at once, TF32 on outside: the
    flags stay off while either is inside, also after the first leaves,
    and come back on when the last leaves."""
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    saved = flags()
    first_in, first_out, seen = threading.Event(), threading.Event(), []

    def first():
        with _precision.ieee_f32_matmul():
            first_in.set()
            second_in.wait()
        first_out.set()

    def second():
        first_in.wait()
        with _precision.ieee_f32_matmul():
            second_in.set()
            first_out.wait()
            seen.append(flags())

    second_in = threading.Event()
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        threads = [threading.Thread(target=first), threading.Thread(target=second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert seen == [(False, False)]
        assert flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _SlowCount(int):
    """A count whose addition yields the thread between reading the count
    and storing the sum: an unguarded ``+= 1`` from several threads then
    loses increments."""

    def __add__(self, other):
        threading.Event().wait(1e-3)
        return _SlowCount(int(self) + other)


def test_counters_lose_no_increment(monkeypatch):
    """The kernels' launch counters and the solver's counters, bumped from 8
    threads at once, count every increment.  The launch paths run with the
    launch itself stubbed (there is no card here); the Ruiz sweeps run the
    plain lane solve, the shared fall-through the torch shared loop on a
    shape the shared kernel cannot hold; lane_fallthroughs, which only a CUDA tensor
    reaches, takes the solver's counting helper directly."""
    from smooth_feedback_tpu_torch import _build
    from smooth_feedback_tpu_torch.qp import QPFactors, QuadraticProgram, qp_factorize

    n_threads, reps = 8, 2
    monkeypatch.setattr(cuda_kernel, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(cuda_kernel, "_launch", lambda *a: None)
    monkeypatch.setattr(cuda_kernel, "_lane_call", lambda *a: None)
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("Stream", (), {"cuda_stream": 0})())
    prm = QPSolverParams(backend="cuda")
    n, m, b = 3, 4, 2
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    status = torch.zeros(b, dtype=torch.int32)
    per = (z(b, n, n), z(b, m, n), z(b, n, n), z(b, n), z(b, m), z(b, m), z(b, m), z(b, n),
           z(b, m), z(b), z(b, m), z(b, m), z(b, n), z(b, m), z(b, m), status)
    shared = (z(n, n), z(m, n), z(n, n), z(b, n), z(b, m), z(b, m), z(m), z(n), z(m), z(),
              z(b, m), z(b, m), z(b, n), z(b, m), z(b, m), status)
    lane = (z(b, n, n), z(b, n), z(b, m, n), z(b, m), z(b, m))
    rng = np.random.default_rng(0)
    P, A = np.eye(n), rng.standard_normal((m, n))
    q, l, u = rng.standard_normal((b, n)), -np.ones((b, m)), np.ones((b, m))
    qp = convert.qp_from_numpy((np.tile(P, (b, 1, 1)), q, np.tile(A, (b, 1, 1)), l, u), "cpu")
    # shared factors with more rows than the shared kernel holds (m > 128):
    # backend="cuda" takes the torch shared loop and counts a fall-through
    mw = cuda_kernel.MAX_DIM + 2
    Aw = rng.standard_normal((mw, n))
    wide = convert.qp_from_numpy((P[None], q, Aw[None], -np.ones((b, mw)), np.ones((b, mw))),
                                 "cpu")
    f1 = QPFactors(*(a[0] for a in qp_factorize(QuadraticProgram(
        wide.P, wide.q[:1], wide.A, wide.l[:1], wide.u[:1]), prm)))
    lane_prm = QPSolverParams(backend="lane", polish=False, max_iter=20)
    jobs = {
        (cuda_kernel.admm_iterate_cuda, "launches"): lambda: cuda_kernel.admm_iterate_cuda(prm, *per),
        (cuda_kernel.admm_iterate_cuda_shared, "launches"):
            lambda: cuda_kernel.admm_iterate_cuda_shared(prm, *shared),
        (cuda_kernel.admm_solve_cuda_lane, "launches"):
            lambda: cuda_kernel.admm_solve_cuda_lane(prm, *lane),
        (qsolver, "lane_ruiz_sweeps"): lambda: solve_qp_batch(qp, lane_prm),
        (qsolver, "shared_fallthroughs"): lambda: solve_qp_batch(
            wide, dataclasses.replace(prm, max_iter=20), None, f1),
        (qsolver, "lane_fallthroughs"): lambda: qsolver._bump("lane_fallthroughs"),
    }
    for (owner, name), job in jobs.items():
        monkeypatch.setattr(owner, name, _SlowCount(0))
        job()
        once = int(getattr(owner, name))
        assert once >= 1, name
        monkeypatch.setattr(owner, name, _SlowCount(0))
        threads = [threading.Thread(target=lambda: [job() for _ in range(reps)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert int(getattr(owner, name)) == once * n_threads * reps, name
