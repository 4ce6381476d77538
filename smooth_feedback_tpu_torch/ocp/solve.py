"""High-level OCP solve with hp-adaptive mesh refinement (PyTorch port of
``smooth_feedback_tpu/ocp/solve.py``).

Repeatedly transcribe the flat OCP on the current mesh, solve the NLP with
the SQP, estimate per-interval dynamics errors on a degree-elevated mesh,
and refine until the target error is met.  Solutions transfer between
meshes as warm starts (primal and multipliers) through
:func:`ocpsol_to_nlpsol`.

The JAX package memoizes one compiled program per mesh signature
(``_SolveCache``, ``_BatchSolveCache``); eager torch compiles nothing, so
every pass builds its NLP afresh and no result is ever reused across calls.

The entry points run on ``device`` (the card by default) in ``dtype``:
the NLP transcription, the start and the problem data ``thetas`` are put
there, and the SQP follows them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import torch
from torch.func import vmap
from torch.utils._pytree import tree_flatten, tree_map

from ..nlp import NLPSolutionStatus
from ..solvers.sqp import SQPParams, rescue_nonoptimal, solve_nlp_sqp, solve_nlp_sqp_batch
from .collocation.functions import mesh_dyn_error
from .collocation.mesh import Mesh
from .flatten import flatten_ocp, unflatten_ocpsol
from .ocp import OCP
from .to_nlp import nlp_initial_guess, nlp_layout, nlpsol_to_ocpsol, ocp_to_nlp, ocpsol_to_nlpsol

_OPTIMAL = int(NLPSolutionStatus.Optimal)


@dataclasses.dataclass(frozen=True)
class SolveOCPParams:
    target_err: float = 1e-6  # interval dynamics-error target
    max_refine_iter: int = 10
    tf_guess: float = 1.0  # initial horizon guess
    sqp: SQPParams = dataclasses.field(default_factory=SQPParams)
    verbose: bool = False
    # stop refining when an NLP solve is non-Optimal instead of refining
    # the mesh around an unconverged solution
    fail_fast: bool = True
    # fleet driver only: before fail_fast triggers, re-solve the
    # non-Optimal members with boosted budgets (rescue_nonoptimal)
    rescue: bool = True


class SolveOCPInfo(NamedTuple):
    meshes: List[Mesh]
    nlp_iters: List[int]
    errors: List[float]
    status: NLPSolutionStatus


class SolveOCPBatchInfo(NamedTuple):
    meshes: List[Mesh]
    nlp_iters: List[torch.Tensor]  # per refinement pass: (B,) SQP iterations
    errors: List[float]  # per pass: max dynamics error across the fleet
    statuses: torch.Tensor  # (B,) final NLPSolutionStatus values
    rescued: List[int]  # per pass: members re-solved (rescue=True)


def solve_ocp_flat(
    flatocp: OCP,
    mesh: Optional[Mesh] = None,
    params: SolveOCPParams = SolveOCPParams(),
    *,
    dtype=torch.float32,
    device="cuda",
):
    """Solve a FLAT (Euclidean) OCP with mesh refinement.

    Returns ``(ocpsol, mesh, info)``; ``mesh`` is the mesh ``ocpsol`` was
    solved on.  Each pass is one :func:`solve_nlp_sqp` (on
    ``backend="cuda"`` one ``admm_problem`` launch at B = 1 per SQP
    iteration).  For Lie-group problems use :func:`solve_ocp`."""
    if mesh is None:
        mesh = Mesh()

    z = nlp_initial_guess(flatocp, mesh, params.tf_guess, dtype, device)
    lam = torch.zeros((nlp_layout(flatocp, mesh).m,), dtype=dtype, device=device)
    meshes, iters, errors = [], [], []
    status = NLPSolutionStatus.IterationLimit
    ocpsol = None

    for it in range(params.max_refine_iter):
        nlpsol = solve_nlp_sqp(ocp_to_nlp(flatocp, mesh, dtype, device), z, params.sqp, lam0=lam)
        status = NLPSolutionStatus(int(nlpsol.status))
        ocpsol = nlpsol_to_ocpsol(flatocp, mesh, nlpsol)

        if status != NLPSolutionStatus.Optimal and params.fail_fast:
            # surface the non-Optimal status instead of refining around it
            meshes.append(mesh)
            iters.append(int(nlpsol.iters))
            errors.append(float("nan"))
            if params.verbose:
                print(f"[solve_ocp] iter {it}: NLP returned {status.name}; stopping")
            break

        # error estimation on a degree-elevated mesh
        errs = mesh_dyn_error(mesh.increase_degrees(), flatocp.f, 0.0, ocpsol.tf, ocpsol.x, ocpsol.u)
        max_err = float(errs.max())

        meshes.append(mesh)
        iters.append(int(nlpsol.iters))
        errors.append(max_err)
        if params.verbose:
            print(
                f"[solve_ocp] iter {it}: mesh {mesh.N_ivals} ivals / "
                f"{mesh.N_colloc} pts, nlp iters {int(nlpsol.iters)}, "
                f"max dyn err {max_err:.2e}"
            )

        # never refine on the final pass: the returned mesh must be the one
        # the returned solution was solved on
        if max_err <= params.target_err or it == params.max_refine_iter - 1:
            break

        mesh = mesh.refine_errors(errs.tolist(), 0.1 * params.target_err)
        # full warm-start transfer: primal and constraint multipliers
        z, lam = ocpsol_to_nlpsol(flatocp, mesh, ocpsol, multipliers=True)

    return ocpsol, mesh, SolveOCPInfo(meshes, iters, errors, status)


def solve_ocp_flat_batch(
    make_flat: Callable,
    thetas,
    mesh: Optional[Mesh] = None,
    params: SolveOCPParams = SolveOCPParams(),
    *,
    dtype=torch.float32,
    device="cuda",
):
    """Solve a FLEET of flat OCPs on a SHARED hp-refined mesh.

    ``make_flat(theta) -> OCP`` must run under ``torch.func.vmap`` in
    ``theta`` (a tensor, or a tuple/list/dict of tensors, each with a
    leading batch axis B: the members' problem data); all members share
    the problem structure.  Each pass solves the fleet as one lockstep SQP
    (:func:`solve_nlp_sqp_batch`; on ``backend="cuda"`` one
    ``admm_problem`` launch per lockstep iteration), re-solves its
    non-Optimal members with :func:`rescue_nonoptimal` (``params.rescue``),
    and refines the mesh on the PER-INTERVAL MAXIMUM dynamics error across
    the fleet.  ``thetas`` go to ``device``, their floating-point tensors
    to ``dtype``.

    Returns ``(nlpsol, mesh, info)`` where ``nlpsol`` carries a leading
    batch axis and ``mesh`` is the mesh it was solved on; reconstruct
    member i's trajectories with ``nlpsol_to_ocpsol(make_flat(theta_i),
    mesh, NLPSolution(*(a[i] for a in nlpsol)))``."""
    return _solve_ocp_flat_batch_impl(make_flat, thetas, mesh, params, dtype, device)


def _solve_ocp_flat_batch_impl(make_flat, thetas, mesh, params, dtype, device, trace=None):
    """The fleet driver.  ``trace``, if given, is called as ``trace(stage,
    info)`` in every pass: at its start (``"start"``) and after its
    ``"solve"``, ``"rescue"`` (also when nothing was rescued), ``"error"``
    and ``"transfer"`` stages, with ``info`` a dict of the pass index
    ``it``, its ``mesh``, and the stage's results (``nlpsol`` after the
    solve and the rescue, ``n_rescued``, ``errs`` (B, N_ivals), ``mesh_new``
    with the warm start ``z`` and ``lam``).  It is how a profile times the
    stages; the public entry point passes none."""
    if mesh is None:
        mesh = Mesh()
    trace = trace or (lambda stage, info: None)

    def place(a):
        a = torch.as_tensor(a, device=device)
        return a.to(dtype) if a.is_floating_point() else a

    thetas = tree_map(place, thetas)
    B = tree_flatten(thetas)[0][0].shape[0]
    flat0 = make_flat(tree_map(lambda a: a[0], thetas))
    z = nlp_initial_guess(flat0, mesh, params.tf_guess, dtype, device).expand(B, -1).clone()
    lam = torch.zeros((B, nlp_layout(flat0, mesh).m), dtype=dtype, device=device)

    meshes, iters, errors, rescued = [], [], [], []
    statuses = torch.full((B,), int(NLPSolutionStatus.IterationLimit), dtype=torch.int32,
                          device=device)
    nlpsol = None
    # straggler sort key for chunked fleets (params.sqp.chunk_size): pass
    # k's per-member inner-ADMM totals order pass k+1's members (zeros on
    # pass 0: the identity order)
    sortk = torch.zeros((B,), dtype=torch.int32, device=device)

    for it in range(params.max_refine_iter):
        trace("start", dict(it=it, mesh=mesh))
        make_nlp = lambda t, mesh=mesh: ocp_to_nlp(make_flat(t), mesh, dtype, device)
        nlpsol = solve_nlp_sqp_batch(make_nlp, thetas, z, params.sqp, lam0=lam, sort_key=sortk)
        trace("solve", dict(it=it, mesh=mesh, nlpsol=nlpsol))
        statuses = nlpsol.status
        all_opt = bool((statuses == _OPTIMAL).all())
        n_rescued = 0

        if not all_opt and params.rescue:
            nlpsol, n_rescued = rescue_nonoptimal(make_nlp, thetas, nlpsol, params.sqp)
            statuses = nlpsol.status
            all_opt = bool((statuses == _OPTIMAL).all())
            if params.verbose and n_rescued:
                print(
                    f"[solve_ocp_batch] iter {it}: rescued {n_rescued} "
                    f"members ({int((statuses != 0).sum())} still bad)"
                )
        trace("rescue", dict(it=it, mesh=mesh, nlpsol=nlpsol, n_rescued=n_rescued))
        rescued.append(n_rescued)
        sortk = nlpsol.qp_iters

        if not all_opt and params.fail_fast:
            meshes.append(mesh)
            iters.append(nlpsol.iters)
            errors.append(float("nan"))
            if params.verbose:
                n_bad = int((statuses != 0).sum())
                print(f"[solve_ocp_batch] iter {it}: {n_bad}/{B} non-Optimal; stopping")
            break

        mesh_hi = mesh.increase_degrees()

        def one_err(th, s, mesh=mesh, mesh_hi=mesh_hi):
            flat = make_flat(th)
            o = nlpsol_to_ocpsol(flat, mesh, s)
            return mesh_dyn_error(mesh_hi, flat.f, 0.0, o.tf, o.x, o.u)

        errs_b = vmap(one_err)(thetas, nlpsol)  # (B, N_ivals)
        errs = errs_b.amax(dim=0)  # fleet-max per interval
        max_err = float(errs.max())
        trace("error", dict(it=it, mesh=mesh, errs=errs_b))

        meshes.append(mesh)
        iters.append(nlpsol.iters)
        errors.append(max_err)
        if params.verbose:
            print(
                f"[solve_ocp_batch] iter {it}: mesh {mesh.N_ivals} ivals / "
                f"{mesh.N_colloc} pts, max dyn err {max_err:.2e}"
            )

        # never refine on the final pass (as solve_ocp_flat): the returned
        # mesh must be the one nlpsol was solved on
        if max_err <= params.target_err or it == params.max_refine_iter - 1:
            break

        mesh_new = mesh.refine_errors(errs.tolist(), 0.1 * params.target_err)

        def one_transfer(th, s, mesh=mesh, mesh_new=mesh_new):
            flat = make_flat(th)
            # full warm-start transfer: primal and constraint multipliers
            return ocpsol_to_nlpsol(flat, mesh_new, nlpsol_to_ocpsol(flat, mesh, s),
                                    multipliers=True)

        z, lam = vmap(one_transfer)(thetas, nlpsol)
        trace("transfer", dict(it=it, mesh=mesh, mesh_new=mesh_new, z=z, lam=lam))
        mesh = mesh_new

    return nlpsol, mesh, SolveOCPBatchInfo(meshes, iters, errors, statuses, rescued)


def solve_ocp(
    ocp: OCP,
    xl_fun: Callable,
    ul_fun: Callable,
    mesh: Optional[Mesh] = None,
    params: SolveOCPParams = SolveOCPParams(),
    *,
    dtype=torch.float32,
    device="cuda",
):
    """Solve a Lie-group OCP end to end: flatten around the nominal
    trajectories, solve with mesh refinement (:func:`solve_ocp_flat`),
    unflatten the solution.  Returns ``(ocpsol, mesh, info)`` with
    ``ocpsol.x(t)``/``ocpsol.u(t)`` on the original group."""
    flat = flatten_ocp(ocp, xl_fun, ul_fun)
    flatsol, mesh, info = solve_ocp_flat(flat, mesh, params, dtype=dtype, device=device)
    return unflatten_ocpsol(flatsol, ocp, xl_fun, ul_fun), mesh, info
