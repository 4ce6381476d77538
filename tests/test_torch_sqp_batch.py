"""The lockstep fleet SQP (solve_nlp_sqp_batch) and rescue_nonoptimal,
port against the JAX package, float64 on the CPU (port "torch", JAX
"xla"), on tests/test_sqp.py's families: the same statuses and SQP
iteration counts per member, x within 1e-7, Optimal members' KKT <= tol;
per-member bounds, chunks, the difficulty probe, qp_budget, the stall
freeze, adaptive-rho inner QPs and BFGS, and both rescue stages from the
JAX package's own fleet solution (handed over through
convert.nlp_solution_from_numpy).  Two deliberate divergences from the
JAX package are marked where they are tested."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu.nlp import NLP as JNLP
from smooth_feedback_tpu.qp import QPSolverParams as JQ
from smooth_feedback_tpu.solvers import SQPParams as JP
from smooth_feedback_tpu.solvers import rescue_nonoptimal as j_rescue
from smooth_feedback_tpu.solvers import solve_nlp_sqp_batch as j_batch
from smooth_feedback_tpu_torch.convert import nlp_solution_from_numpy
from smooth_feedback_tpu_torch.nlp import NLP as TNLP
from smooth_feedback_tpu_torch.nlp import NLPSolutionStatus
from smooth_feedback_tpu_torch.qp import QPSolverParams as TQ
from smooth_feedback_tpu_torch.solvers import SQPParams as TP
from smooth_feedback_tpu_torch.solvers import rescue_nonoptimal as t_rescue
from smooth_feedback_tpu_torch.solvers import solve_nlp_sqp_batch as t_batch

torch.set_num_threads(1)

inf = float("inf")
OPTIMAL = int(NLPSolutionStatus.Optimal)
LIMIT = int(NLPSolutionStatus.IterationLimit)


def _family(name, lib):
    """``make(b) -> NLP`` of tests/test_sqp.py's families, in ``lib``."""
    a = (lambda v: jnp.asarray(v, jnp.float64)) if lib is jnp else (
        lambda v: torch.tensor(np.asarray(v, dtype=np.float64)))
    NLP = JNLP if lib is jnp else TNLP
    st = lib.stack
    if name == "shifted":  # (x0 - b)^2 + x1^2 + 0.1 sin x1, x0 + x1 <= 1
        return lambda b: NLP(2, 1, lambda x: (x[0] - b) ** 2 + x[1] ** 2 + 0.1 * lib.sin(x[1]),
                             lambda x: st([x[0] + x[1]]), a([-inf] * 2), a([inf] * 2),
                             a([-inf]), a([1.0]))
    if name == "valley":  # a Rosenbrock valley whose stiffness grows with b
        return lambda b: NLP(2, 1, lambda x: (1.0 - x[0]) ** 2 + 10.0 * (x[1] - x[0] ** 2) ** 2 * b,
                             lambda x: st([x[0] + x[1]]), a([-5.0] * 2), a([5.0] * 2), a([-4.0]),
                             a([4.0]))
    if name == "probe":  # tests/test_sqp.py's probe family
        return lambda b: NLP(2, 1,
                             lambda x: (1.0 - x[0]) ** 2 + (1.0 + 5.0 * b) * (x[1] - x[0] ** 2) ** 2,
                             lambda x: st([x[0] + x[1]]), a([-5.0] * 2), a([5.0] * 2), a([-4.0]),
                             a([4.0]))
    if name == "bounds":  # x0 >= b per member
        def make(b):
            lo = jnp.stack([b, -jnp.inf * jnp.ones(())]) if lib is jnp else torch.stack(
                [b, torch.tensor(-inf, dtype=torch.float64)])
            return NLP(2, 1, lambda x: (x[0] - 1.0) ** 2 + x[1] ** 2, lambda x: st([x[0] + x[1]]),
                       lo, a([inf] * 2), a([-inf]), a([10.0]))
        return make
    raise KeyError(name)


CASES = {
    "shifted": ([0.0, 1.0, 3.0, -2.0], [0.0, 0.0]),
    "valley": ([0.0, 1.0, 5.0, 10.0], [-1.2, 1.0]),
    "probe": (list(np.linspace(0.0, 2.0, 6)), [-1.2, 1.0]),
    "bounds": ([0.0, 2.0, 3.0], [4.0, 4.0]),
}


def _inputs(name):
    bs, x0 = CASES[name]
    return np.asarray(bs, dtype=np.float64), np.tile(np.asarray(x0, dtype=np.float64), (len(bs), 1))


@functools.lru_cache(maxsize=None)
def _jax_fleet(name, prm):
    """The JAX package's fleet solve of family ``name`` under ``prm``,
    jitted once per (family, parameters)."""
    bs, x0 = _inputs(name)
    make = _family(name, jnp)
    return jax.jit(lambda th, x: j_batch(make, th, x, prm))(jnp.asarray(bs), jnp.asarray(x0))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _agree(sj, st, tol=None, x_tol=1e-7):
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(sj.status))
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(sj.iters))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), atol=x_tol, rtol=0)
    if tol is not None:
        opt = st.status.numpy() == OPTIMAL
        assert np.all(st.kkt_res.numpy()[opt] <= tol)
        assert np.all(np.asarray(sj.kkt_res)[opt] <= tol)


def _fleet(name, kw, qp=None):
    """The same fleet through both packages under the same parameters."""
    jprm = JP(**kw) if qp is None else JP(qp=JQ(**qp), **kw)
    tprm = TP(**kw) if qp is None else TP(qp=TQ(**qp), **kw)
    bs, x0 = _inputs(name)
    sj = _jax_fleet(name, jprm)
    st = t_batch(_family(name, torch), _t(bs), _t(x0), tprm)
    _agree(sj, st, tprm.tol)
    return sj, st, jprm, tprm


@pytest.mark.parametrize("name", ["shifted", "bounds"])
def test_fleet_matches_jax(name):
    """Per-member problem data, bounds included (x0 >= b activates on some
    members only); every member Optimal at its hand-checked optimum."""
    _, st, _, _ = _fleet(name, dict(max_iter=40))
    assert bool((st.status == OPTIMAL).all())
    if name == "bounds":
        torch.testing.assert_close(st.x, _t([[1.0, 0.0], [2.0, 0.0], [3.0, 0.0]]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [dict(chunk_size=4), dict(chunk_size=2, probe_iters=2,
                                                          probe_qp_cap=100)],
                         ids=["chunks", "chunks+probe"])
def test_chunks_and_probe_match_jax(kw):
    """Sequential chunks (the last one padded) and the difficulty probe's
    sort: the JAX package's results, member by member, probe work counted."""
    _, st, _, _ = _fleet("probe", dict(max_iter=60, tol=1e-9, **kw))
    assert bool((st.status == OPTIMAL).all()) and bool((st.qp_iters > 0).all())


def test_qp_budget_freeze_matches_jax():
    """A budget that binds freezes the stiff member as IterationLimit at
    the same iteration in both packages; the easy member is Optimal."""
    _, st, _, _ = _fleet("valley", dict(max_iter=60, tol=1e-10, qp_budget=500), dict(max_iter=400))
    assert int(st.status[0]) == OPTIMAL and LIMIT in st.status.tolist()


def test_stall_freeze_matches_jax():
    """stall_iters with an impossible ratio freezes the stiff members after
    ~stall_iters iterations, as in the JAX package."""
    _, st, _, _ = _fleet("valley", dict(max_iter=60, tol=1e-10, stall_iters=3, stall_ratio=1e-12))
    assert int(st.status[0]) == OPTIMAL and bool((st.iters[1:] <= 6).all())


def test_stall_ratio_zero_deliberate_divergence():
    """DELIBERATE DIVERGENCE from the JAX package (sqp.py:1109): at
    stall_ratio = 0 its first comparison is kkt < inf * 0 = NaN, so the
    first iteration counts as no progress and a stalling member freezes
    after stall_iters iterations; for every ratio > 0 the first iteration
    sets the mark.  The port sets the mark at the first iteration for every
    ratio, so the member freezes one iteration later.  Everything else is
    equal."""
    kw = dict(max_iter=60, tol=1e-10, stall_iters=3, stall_ratio=0.0)
    bs, x0 = _inputs("valley")
    sj = _jax_fleet("valley", JP(**kw))
    st = t_batch(_family("valley", torch), _t(bs), _t(x0), TP(**kw))
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(sj.status))
    frozen = np.asarray(sj.status) == LIMIT
    assert frozen.any()
    np.testing.assert_array_equal(np.asarray(sj.iters)[frozen], 3)
    np.testing.assert_array_equal(st.iters.numpy()[frozen], 4)
    np.testing.assert_array_equal(st.iters.numpy()[~frozen], np.asarray(sj.iters)[~frozen])


def test_adaptive_rho_and_bfgs_fleets_match_jax():
    _fleet("shifted", dict(max_iter=60), dict(adaptive_rho=True, eps_abs=1e-9, eps_rel=1e-9))
    _fleet("shifted", dict(max_iter=120, hessian="bfgs"))


def _starved(max_iter):
    """A starved fleet solve of the valley family by the JAX package and
    the same solution handed to the port."""
    prm = JP(max_iter=max_iter, tol=1e-8)
    sj = _jax_fleet("valley", prm)
    st = nlp_solution_from_numpy(tuple(np.asarray(a) for a in sj), device="cpu")
    return sj, st, prm, TP(max_iter=max_iter, tol=1e-8)


def test_rescue_warm_started_stage_matches_jax():
    """Stage 1 (multistart-wide lockstep groups, warm-started at the fleet
    iterate): the members the starved fleet left behind end Optimal at the
    valley's optimum, each with the JAX package's SQP iterations; Optimal
    members keep their fields bit for bit."""
    bs, _ = _inputs("valley")
    sj, st, jprm, tprm = _starved(4)
    assert (np.asarray(sj.status) != OPTIMAL).any()
    mj, nj = j_rescue(_family("valley", jnp), jnp.asarray(bs), sj, jprm, qp_iter_scale=2,
                      iter_scale=20)
    mt, nt = t_rescue(_family("valley", torch), _t(bs), st, tprm, qp_iter_scale=2, iter_scale=20)
    assert nt == nj == int((np.asarray(sj.status) != OPTIMAL).sum())
    _agree(mj, mt, tprm.tol)
    assert bool((mt.status == OPTIMAL).all())
    kept = np.asarray(sj.status) == OPTIMAL
    np.testing.assert_array_equal(mt.x.numpy()[kept], np.asarray(sj.x)[kept])


def test_rescue_multistart_stage_matches_jax():
    """Stage 2 (the perturbed multistart, numpy-seeded candidates) after a
    stage 1 that cannot finish (iter_scale 1 at max_iter 3): the same
    winners and accumulated iterations as the JAX package."""
    bs, x0 = _inputs("valley")
    sj, st, jprm, tprm = _starved(3)
    kw = dict(iter_scale=1, x0_cold=x0, seed=3)
    mj, _ = j_rescue(_family("valley", jnp), jnp.asarray(bs), sj, jprm, **kw)
    mt, _ = t_rescue(_family("valley", torch), _t(bs), st, tprm, **kw)
    _agree(mj, mt)
    np.testing.assert_allclose(mt.kkt_res.numpy(), np.asarray(mj.kkt_res), rtol=1e-6, atol=1e-12)
    # stage 2 ran: more work than stage 1's 3 iterations on every rescued member
    bad = np.asarray(sj.status) != OPTIMAL
    assert bad.any() and np.all((mt.iters - st.iters).numpy()[bad] > 3)


def test_rescue_wide_multistart_deliberate_divergence():
    """DELIBERATE DIVERGENCE from the JAX package (sqp.py:1406-1421): its
    perturbation ladder has 6 entries and multistart > 7 indexes past them
    (IndexError).  The port repeats the ladder for wider multistarts and
    runs; at multistart <= 7 both packages build the same candidates (the
    multistart test above).  The best-so-far candidate keeps the JAX
    package's place in the ladder (the last)."""
    bs, x0 = _inputs("valley")
    sj, st, jprm, tprm = _starved(2)
    with pytest.raises(IndexError):
        j_rescue(_family("valley", jnp), jnp.asarray(bs), sj, jprm, iter_scale=1, multistart=9)
    mt, nt = t_rescue(_family("valley", torch), _t(bs), st, tprm, iter_scale=1, multistart=9,
                      x0_cold=x0)
    assert nt == int((st.status != OPTIMAL).sum()) > 0
    assert bool((mt.kkt_res <= st.kkt_res).all())
