"""Shared factors on either side of the shared kernel's gate:
``solve_qp_batch`` on backend "cuda" takes the kernel route wherever the
JAX package's ``shared_kernel_fits`` admits the shape (the resident route
at n = m = 100, the streaming route at 160; their plain version on CPU
tensors) and routes a batch past it (n = m = 1792) to the torch shared loop
on the problems' own device, decided before anything launches, as the JAX
package's "pallas" backend falls through to its XLA shared-GEMM path.
Against the JAX package on "pallas" (its kernel in interpret mode where it
admits the shape), f32 on the CPU, from the same factors: the same
statuses and iteration counts, primals within 1e-4 of their scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import shared_route_problem
from smooth_feedback_tpu.qp import QPSolverParams as JParams
from smooth_feedback_tpu.qp import QuadraticProgram as JQP
from smooth_feedback_tpu.qp import qp_factorize as j_factorize
from smooth_feedback_tpu.qp import solve_qp_batch as j_solve
from smooth_feedback_tpu.qp.pallas_kernel import shared_kernel_fits as j_shared_kernel_fits
from smooth_feedback_tpu_torch.convert import factors_from_numpy, qp_from_numpy
from smooth_feedback_tpu_torch.qp import QPSolverParams, solve_qp_batch
from smooth_feedback_tpu_torch.qp import solver as qsolver
from smooth_feedback_tpu_torch.qp.cuda_kernel import shared_kernel_fits

torch.set_num_threads(1)


@pytest.mark.parametrize("n,B", [(100, 4), (160, 4), (1792, 2)])
def test_shared_factors_on_cuda_backend_match_jax_pallas(n, B):
    P, q, A, l, u = (a.astype(np.float32) for a in shared_route_problem(n, B))
    jp = JParams(polish=False, backend="pallas")
    jf = jax.tree.map(lambda a: a[0], j_factorize(JQP(*(jnp.asarray(a) for a in
                                                        (P, q[:1], A, l[:1], u[:1]))), jp))
    js = j_solve(JQP(*(jnp.asarray(a) for a in (P, q, A, l, u))), jp, None, jf)
    tf = factors_from_numpy([np.asarray(a) for a in jf], device="cpu", dtype=torch.float32)
    falls = qsolver.shared_fallthroughs
    ts = solve_qp_batch(qp_from_numpy((P, q, A, l, u), "cpu", torch.float32),
                        QPSolverParams(polish=False, backend="cuda"), None, tf)
    assert shared_kernel_fits(n, n, 8) == j_shared_kernel_fits(n, n) == (n <= 1664)
    assert qsolver.shared_fallthroughs == falls + (n > 1664)
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.iters.numpy(), np.asarray(js.iters))
    assert bool((ts.status == 0).all())
    scale = max(1.0, float(np.abs(np.asarray(js.primal)).max()))
    np.testing.assert_allclose(ts.primal.numpy(), np.asarray(js.primal), atol=1e-4 * scale, rtol=0)
