"""The shared-matrix kernel's routes against the JAX package, on the CPU.

The port's gate (``qp.cuda_kernel.shared_kernel_fits``, ``shared_route``)
against the JAX package's ``shared_kernel_fits`` on a grid of shapes (pure
Python), the order of the three routes, the cluster and streaming routes'
launch layouts, and bench.py's K = 50 sparse double-integrator fleet (n = m
= 158, past the resident route) in closed loop: the port on backend "cuda"
with CPU tensors (the kernel's plain version, no fall-through) against
JAX's "xla" backend, both float64.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smooth_feedback_tpu.controllers import MPCParams as JMPCParams
from smooth_feedback_tpu.controllers import MPCWeights as JMPCWeights
from smooth_feedback_tpu.controllers import make_mpc_step as j_make_mpc_step
from smooth_feedback_tpu.groups import Rn as JRn
from smooth_feedback_tpu.qp import QPSolverParams as JQPSolverParams
from smooth_feedback_tpu.qp.pallas_kernel import shared_kernel_fits as j_shared_kernel_fits
from smooth_feedback_tpu_torch import convert
from smooth_feedback_tpu_torch.controllers import MPCParams, make_mpc_step
from smooth_feedback_tpu_torch.groups import Rn
from smooth_feedback_tpu_torch.qp import QPSolverParams
from smooth_feedback_tpu_torch.qp import solver as qsolver
from smooth_feedback_tpu_torch.qp.cuda_kernel import (
    CLUSTER_GROUPS, CLUSTER_ROUTE_FROM, CLUSTER_SIZES, MAX_DIM, SMEM_LIMIT, STREAM_COLS, STREAM_MAX_WARPS, cluster_plan,
    shared_cluster_scratch, shared_kernel_fits, shared_plan, shared_route, shared_stream_scratch,
    smem_bytes, stream_plan,
)
from smooth_feedback_tpu_torch.qp.cuda_kernel import _cluster_smem_bytes

torch.set_num_threads(1)

# widths on either side of the routes' and the JAX gate's edges: the
# resident route's 128, bench.py --sweep's shapes (52, 100, 158, 200, 302,
# 602), the last square shape JAX admits
# (1664) and the first it refuses (1792), and the widest m it admits at n <=
# 128 (9856)
EDGE = [1, 3, 52, 100, 127, 128, 129, 158, 200, 256, 257, 302, 602, 1024, 1536, 1664, 1665,
        1700, 1792, 2200, 4000, 9856, 9857, 9984]


@pytest.mark.parametrize("n", EDGE)
def test_gate_is_the_jax_packages(n):
    """shared_kernel_fits(n, m, block) equals the JAX package's
    shared_kernel_fits(n, m) for every m of the grid and every block; the
    route is "resident" exactly where max(n, m) <= 128, "cluster" or
    "streaming" where JAX admits the rest (the cluster route where its plan
    needs a cluster of 16 blocks), None past it."""
    for m in EDGE:
        want = bool(j_shared_kernel_fits(n, m))
        for block in (1, 8):
            assert shared_kernel_fits(n, m, block) == want, (n, m, block)
            route = shared_route(n, m, block)
            if max(n, m) <= MAX_DIM:
                assert route == "resident"
            elif want:
                assert route in ("cluster", "streaming"), (n, m, block)
            else:
                assert route is None, (n, m, block)


def test_gate_checks_the_block():
    """kernel_block outside 1..8 raises on either route."""
    for n in (52, 608):
        for block in (0, 9):
            with pytest.raises(ValueError, match="kernel_block"):
                shared_kernel_fits(n, n, block)


@pytest.mark.parametrize(
    "B,n,m,plan,route",
    [
        (8192, 158, 158, (16, 16, 6, 37184), "streaming"),  # bench.py's K = 50 sparse
        (4096, 302, 302, (16, 16, 10, 55616), "streaming"),  # K = 100 sparse
        (2048, 200, 200, (16, 16, 8, 42560), "cluster"),  # K = 200 condensed
        (2048, 602, 602, (16, 16, 10, 94016), "cluster"),  # K = 200 sparse
        (83, 300, 170, (16, 16, 10, 55360), "streaming"),  # non-square, a partly empty last block
        (8, 1664, 1664, (16, 16, 13, 229952), "streaming"),  # the widest square shape JAX admits
        (4, 128, 9856, (2, 2, 16, 159816), "streaming"),  # the widest m it admits: two a block
        (4, 3, 130, (16, 16, 6, 33600), "streaming"),
    ],
)
def test_streaming_layout(B, n, m, plan, route):
    """The streaming route's launch layout (mirror of csrc/admm_shared_stream.cu),
    which the library gives at any shape it holds, also where the shape
    takes the cluster route (``route``): the widest block of 16, 8, 4 or 2
    problems that fits one block's shared memory (two staging buffers of
    max(n, m) rows, the check's per-warp partials), its threads in two parts
    of half the problems each (one part below 8 problems or past max(n, m)
    = 512), each part's warps covering max(n, m) at two columns a thread in
    the fewest passes 16 warps allow, and its device-memory scratch."""
    assert shared_route(n, m, 8) == route
    G, pb, warps, smem = stream_plan(n, m)
    assert (G, pb, warps, smem) == plan
    assert smem <= SMEM_LIMIT
    if route == "streaming":
        assert shared_plan(B, n, m, 8) == plan and smem == smem_bytes(n, m, 8)
    H = 2 if G >= 8 and max(n, m) <= 512 else 1
    per_pass = lambda w: 32 * (w // H) * STREAM_COLS  # columns a part covers in a pass
    assert warps <= STREAM_MAX_WARPS and warps % H == 0
    assert -(-max(n, m) // per_pass(warps)) == -(-max(n, m) // per_pass(STREAM_MAX_WARPS))
    assert smem >= 4 * 2 * max(n, m) * G
    assert shared_stream_scratch(B, n, m) == n * m + n * n + B * (2 * n + 2 * m)
    # the block does not depend on B or on kernel_block
    assert stream_plan(n, m) == plan


# the cluster route's first and largest square shapes
CLUSTER_FIRST, CLUSTER_LAST = 426, 640


@pytest.mark.parametrize(
    "B,n,m,plan,route",
    [
        (8192, 158, 158, (2, 8, 8, 150076), "streaming"),  # bench.py's K = 50 sparse
        (4096, 302, 302, (8, 8, 8, 130728), "streaming"),  # K = 100 sparse
        (2048, 200, 200, (2, 8, 8, 219712), "cluster"),  # K = 200 condensed
        (2048, 602, 602, (16, 8, 8, 231528), "cluster"),  # K = 200 sparse: a cluster of 16
        (83, 300, 170, (4, 8, 8, 188540), "streaming"),  # non-square
        (1, 129, 129, (1, 8, 8, 201304), "streaming"),  # past the resident route: one block
        (8, 206, 206, (2, 8, 8, 230812), "cluster"),  # the largest shape a pair of blocks holds
        (8, 207, 207, (4, 8, 8, 127216), "streaming"),
        (8, CLUSTER_FIRST - 1, CLUSTER_FIRST - 1, (8, 8, 8, 232448), "streaming"),
        (8, CLUSTER_FIRST, CLUSTER_FIRST, (16, 8, 8, 130636), "cluster"),  # needs 16 blocks
        (2048, 500, 500, (16, 8, 8, 170928), "cluster"),
        (8, CLUSTER_LAST, CLUSTER_LAST, (16, 4, 8, 230144), "cluster"),  # the largest square
        (4, 3, 130, (1, 8, 8, 45804), "streaming"),
        (4, 128, 1000, (8, 8, 8, 146276), "streaming"),
    ],
)
def test_cluster_layout(B, n, m, plan, route):
    """The cluster kernel's launch layout (mirror of csrc/admm_shared_cluster.cu):
    the widest group of 8 or 4 problems for which some cluster of 1, 2, 4, 8
    or 16 blocks holds its slices of Minv (n rows of ceil(n / C) columns)
    and As (ceil(m / C) rows at the odd stride n | 1) beside the group's
    vectors, with the smallest such cluster; 8 warps a block; the plan
    depends on the shape alone, and the scratch is the work counter and Ps'
    (nothing a problem).  The route takes the cluster kernel where its plan
    needs a cluster of 16 blocks, or of 2 from max(n, m) = 200 up (the bands
    where it was the faster kernel on the card), the streaming kernel
    elsewhere."""
    C, G, warps, smem = cluster_plan(n, m)
    assert (C, G, warps, smem) == plan
    assert shared_route(n, m, 8) == route
    assert route == ("cluster" if max(n, m) >= CLUSTER_ROUTE_FROM.get(C, 1 << 30) else "streaming")
    if route == "cluster":
        assert shared_plan(B, n, m, 8) == (G, G, warps, smem) == shared_plan(1, n, m, 1)
        assert smem == smem_bytes(n, m, 8)
    assert smem <= SMEM_LIMIT
    wn, wm = -(-n // C), -(-m // C)
    assert smem >= 4 * (n * wn + wm * (n | 1) + max(n, m) * G)  # the slices and the input
    # no smaller cluster holds this group, and no cluster a wider one
    assert all(_cluster_smem_bytes(n, m, c, G) > SMEM_LIMIT for c in CLUSTER_SIZES if c < C)
    assert all(_cluster_smem_bytes(n, m, c, g) > SMEM_LIMIT
               for c in CLUSTER_SIZES for g in CLUSTER_GROUPS if g > G)
    assert shared_cluster_scratch(B, n, m) == 4 + n * n


@pytest.mark.parametrize("n,m", [(CLUSTER_LAST + 1, CLUSTER_LAST + 1), (900, 900),
                                 (1664, 1664), (128, 9856)])
def test_cluster_layout_past_capacity(n, m):
    """Past the cluster route's capacity (the first square shape past it,
    the card tests' past-capacity shape, the JAX gate's square and tall
    edges) the shape takes the streaming route and cluster_plan raises."""
    assert shared_route(n, m, 8) == "streaming"
    assert shared_plan(4, n, m, 8) == stream_plan(n, m)
    with pytest.raises(ValueError, match="no cluster"):
        cluster_plan(n, m)


@pytest.mark.parametrize("m", [None, 1, 130, 1000, 5000, 9856])
def test_route_order(m):
    """Along n (with m = n, or m fixed) the routes come in one order,
    resident (max(n, m) <= 128) < streaming < cluster (clusters of 2 from
    200 up) < streaming < cluster (clusters of 16) < streaming (past the
    cluster route's capacity) < None (past the JAX gate), each stretch at
    most once; the square edges sit at 128, 199, 206, 425, 640 and 1664."""
    order = ["resident", "streaming", "cluster", "streaming", "cluster", "streaming", None]
    seq = [shared_route(n, n if m is None else m, 8) for n in range(1, 1800)]
    stretches = [k for k, _ in itertools.groupby(seq)]
    at = 0
    for k in stretches:
        while at < len(order) and order[at] != k:
            at += 1
        assert at < len(order), stretches
        at += 1
    if m is None:
        assert seq[127] == "resident" and seq[128] == "streaming"
        assert seq[198] == "streaming" and seq[199] == "cluster"
        assert seq[205] == "cluster" and seq[206] == "streaming"
        assert seq[CLUSTER_FIRST - 2] == "streaming" and seq[CLUSTER_FIRST - 1] == "cluster"
        assert seq[CLUSTER_LAST - 1] == "cluster" and seq[CLUSTER_LAST] == "streaming"
        assert seq[1663] == "streaming" and seq[1664] is None


def test_layout_past_the_gate_raises():
    with pytest.raises(ValueError, match="no route"):
        shared_plan(4, 1792, 1792, 8)


# bench.py's double integrator and solver settings (bench.py:47-130)
BENCH_QP = dict(scaling=True, polish=False, rho=2.0, rho_eq_scale=15.0,
                max_iter=100, stop_check_iter=10)
WEIGHTS = (np.eye(2), 0.1 * np.eye(2), 0.1 * np.eye(1))
DT = 0.05
TOL = 1e-9  # float64 on both sides, another summation order


@functools.lru_cache(maxsize=None)
def _jax_sparse(K):
    step, ws0 = j_make_mpc_step(
        JRn(2), JRn(1), lambda x, u: jnp.stack([x[1], u[0]]),
        lambda t: jnp.stack([-0.5 * jnp.sin(0.3 * t), -0.15 * jnp.cos(0.3 * t)]),
        lambda t: jnp.zeros(1, jnp.float64),
        weights=JMPCWeights(*(jnp.asarray(w, jnp.float64) for w in WEIGHTS)),
        params=JMPCParams(K=K, tf=5.0, return_trajectories=False,
                          qp=JQPSolverParams(**BENCH_QP, backend="xla")),
        cr=lambda x, u: u, crl=jnp.array([-0.5]), cru=jnp.array([0.5]),
        dtype=jnp.float64, reuse_factors=True, condense=False,
    )
    return jax.jit(step.fleet_shared_t), ws0


def _torch_sparse(K):
    return make_mpc_step(
        Rn(2), Rn(1), lambda x, u: torch.stack([x[1], u[0]]),
        lambda t: torch.stack([-0.5 * torch.sin(0.3 * t), -0.15 * torch.cos(0.3 * t)]),
        lambda t: torch.zeros(1, dtype=torch.float64),
        weights=convert.weights_from_numpy(WEIGHTS, dtype=torch.float64, device="cpu"),
        params=MPCParams(K=K, tf=5.0, return_trajectories=False,
                         qp=QPSolverParams(**BENCH_QP, backend="cuda")),
        cr=lambda x, u: u, crl=[-0.5], cru=[0.5],
        dtype=torch.float64, device="cpu", reuse_factors=True, condense=False,
    )


def test_sparse_fleet_on_the_streaming_route_matches_jax():
    """bench.py's K = 50 sparse fleet (n = m = 158: the streaming route),
    B = 4, two closed-loop steps of fleet_shared_t, u driving the plant: the
    port on backend "cuda" with CPU tensors runs the kernel's plain version
    with no fall-through; statuses and iteration counts equal JAX's "xla"
    run's, u and the primal within 1e-9 (float64 both)."""
    K, B = 50, 4
    j_step, jws0 = _jax_sparse(K)
    t_step, tws0 = _torch_sparse(K)
    n = int(tws0.primal.shape[-1])
    m = int(tws0.dual.shape[-1])
    assert (n, m) == (158, 158) and shared_route(n, m, 8) == "streaming"
    xs = 0.5 * np.random.default_rng(0).standard_normal((B, 2))
    jws = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jws0)
    tws = type(tws0)(*(a.expand((B,) + a.shape).contiguous() for a in tws0))
    falls = qsolver.shared_fallthroughs
    for i in range(2):
        t = DT * i
        jr = j_step(jws, t, jnp.asarray(xs))
        tr = t_step.fleet_shared_t(tws, t, torch.as_tensor(xs))
        np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
        np.testing.assert_array_equal(tr.warmstart.iters.numpy(), np.asarray(jr.warmstart.iters))
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), atol=TOL, rtol=0)
        np.testing.assert_allclose(tr.warmstart.primal.numpy(), np.asarray(jr.warmstart.primal),
                                   atol=TOL, rtol=0)
        assert int((tr.status == 0).sum()) == B
        xs = xs + DT * np.stack([xs[:, 1], np.asarray(jr.u)[:, 0]], axis=1)
        jws, tws = jr.warmstart, tr.warmstart
    assert qsolver.shared_fallthroughs == falls
