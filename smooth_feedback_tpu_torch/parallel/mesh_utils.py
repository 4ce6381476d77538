"""Data-parallel sharding of problem batches over the devices of one host.

The PyTorch port of ``smooth_feedback_tpu/parallel/mesh_utils.py``: pure
data parallelism over independent problem instances (QPs, filters, MPC
steps, SQP fleets), a 1-D mesh, the batch axis split into contiguous equal
parts, no communication between problems.  As under JAX's single
controller, one process drives every device: a sharded call takes the whole
batch (or one already sharded), runs each shard's part in a thread of its
own on that shard's device and CUDA stream, joins the threads and returns
batch-sharded results.  Nothing inside needs a collective: every loop
condition (the ADMM stopping test, the lockstep SQP's) is the shard's own,
so each shard waits only for the worst member of its own part.

A mesh may list one device more than once: k shards on one card, each on
its own stream.  That is the only mesh a one-card machine can build, and a
mesh of ``"cpu"`` entries (threads on the host) runs the same code on the
CPU.  A sharded value is a :class:`Sharded` (the parts and the axis) or a
:class:`Replicated` (one copy a shard); ``gather`` puts it on one device.
An exception in any shard reaches the caller: no shard is retried, skipped
or moved to another device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


def _norm_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceMesh:
    """A 1-D mesh: ``devices`` holds one entry a shard (repeats allowed);
    each CUDA entry gets a stream of its own for its shard's work."""

    def __init__(self, devices: Sequence, axis_name: str = "dp"):
        self.devices = tuple(_norm_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name
        self.streams = tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                             for d in self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """One tensor split along ``axis`` into contiguous equal ``parts``, part
    i on mesh device i."""

    parts: tuple
    axis: int

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        s[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return tuple(s)

    @property
    def devices(self) -> tuple:
        return tuple(p.device for p in self.parts)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: part 0's)."""
        device = self.parts[0].device if device is None else device
        return torch.cat([p.to(device) for p in self.parts], dim=self.axis)


@dataclasses.dataclass(frozen=True, eq=False)
class Replicated:
    """One copy of a tensor on each mesh device."""

    parts: tuple

    @property
    def devices(self) -> tuple:
        return tuple(p.device for p in self.parts)

    def gather(self, device=None) -> torch.Tensor:
        return self.parts[0] if device is None else self.parts[0].to(device)


def gather(tree, device=None):
    """Every :class:`Sharded` or :class:`Replicated` leaf of ``tree`` as one
    tensor on ``device``."""
    return tree_map(lambda a: a.gather(device) if isinstance(a, (Sharded, Replicated)) else a,
                    tree)


def dp_mesh(devices: Optional[Sequence] = None, axis_name: str = "dp") -> DeviceMesh:
    """1-D data-parallel mesh over the given devices, by default every
    visible card.  Raises ``RuntimeError`` when no card is visible and no
    devices are given."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("dp_mesh: no CUDA device is visible; pass the devices "
                               "(e.g. ['cpu'] * 8) to build a mesh without one")
        devices = [torch.device("cuda", i) for i in range(n)]
    return DeviceMesh(devices, axis_name)


def _check_axis_name(mesh: DeviceMesh, axis_name: str):
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")


def _split(a, mesh: DeviceMesh, axis: int) -> Sharded:
    if isinstance(a, Sharded):
        if a.axis == axis % len(a.shape) and a.devices == mesh.devices:
            return a
        a = a.gather()
    a = torch.as_tensor(a)
    if a.dim() == 0:
        raise ValueError("a 0-d tensor has no batch axis to shard")
    axis %= a.dim()
    B, n = a.shape[axis], mesh.size
    if B % n:
        raise ValueError(f"the batch axis ({B} members) does not divide evenly over the "
                         f"{n} mesh devices")
    k = B // n
    return Sharded(tuple(a.narrow(axis, i * k, k).to(d) for i, d in enumerate(mesh.devices)),
                   axis)


def shard_batch(array, mesh: DeviceMesh, axis_name: str = "dp") -> Sharded:
    """Shard the leading (batch) axis of one array across the mesh."""
    _check_axis_name(mesh, axis_name)
    return _split(array, mesh, 0)


def shard_trailing(array, mesh: DeviceMesh, axis_name: str = "dp") -> Sharded:
    """Shard the TRAILING axis of one array across the mesh (the batch axis
    of lane-major fleet layouts, e.g. ``EKFFleetState.Pt``)."""
    _check_axis_name(mesh, axis_name)
    return _split(array, mesh, -1)


def shard_ekf_fleet(fleet, mesh: DeviceMesh, axis_name: str = "dp"):
    """Shard a fleet filter state across the mesh: ``g`` on its leading
    (batch) axis, the covariance/factor stack on its trailing (lane/batch)
    axis.  Works for both ``EKFFleetState`` (field ``Pt``) and
    ``SqrtEKFFleetState`` (field ``St``)."""
    g_field, stack_field = fleet._fields
    return type(fleet)(**{
        g_field: shard_batch(getattr(fleet, g_field), mesh, axis_name),
        stack_field: shard_trailing(getattr(fleet, stack_field), mesh, axis_name),
    })


def shard_pytree(tree, mesh: DeviceMesh, axis_name: str = "dp"):
    """Shard the leading axis of every leaf of a pytree (QuadraticProgram,
    QPSolution warmstarts, EKFState fleets, ...)."""
    return tree_map(lambda a: shard_batch(a, mesh, axis_name), tree)


def replicate(tree, mesh: DeviceMesh):
    """One copy of every leaf of a pytree on each mesh device (for shared
    parameters)."""
    return tree_map(lambda a: Replicated(tuple(torch.as_tensor(a).to(d) for d in mesh.devices)),
                    tree)


def _leaf_axes(spec, tree) -> list:
    """The axis (an int, or None: replicated) of every leaf of ``tree``, in
    ``tree_flatten``'s order, from ``spec``: an int or None for the whole
    tree, or a prefix of its structure (e.g. ``EKFFleetState(0, -1)``)."""
    if spec is None or isinstance(spec, int):
        return [spec] * len(tree_flatten(tree)[0])
    if isinstance(tree, dict):
        return [a for k in tree for a in _leaf_axes(spec[k], tree[k])]
    if isinstance(tree, (tuple, list)) and len(spec) == len(tree):
        return [a for s, t in zip(spec, tree) for a in _leaf_axes(s, t)]
    raise ValueError(f"the axis spec {spec!r} does not match the structure of {type(tree)}")


def _place(leaf, axis, mesh: DeviceMesh):
    """One input leaf as the mesh's parts: a Sharded or Replicated leaf as
    it is, a tensor split along ``axis`` (None: copied to every device), any
    other value the same for every shard."""
    if isinstance(leaf, Sharded):
        if axis is None or leaf.axis != axis % len(leaf.shape) or leaf.devices != mesh.devices:
            raise ValueError(f"a sharded input on axis {leaf.axis} over {leaf.devices} where "
                             f"the call expects axis {axis} over {mesh.devices}")
        return leaf.parts
    if isinstance(leaf, Replicated):
        if axis is not None or leaf.devices != mesh.devices:
            raise ValueError("a replicated input where the call expects a sharded one, or one "
                             "replicated over other devices")
        return leaf.parts
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
        if axis is None:
            return tuple(torch.as_tensor(leaf).to(d) for d in mesh.devices)
        return _split(leaf, mesh, axis).parts
    return (leaf,) * mesh.size


def _per_shard(fn, mesh: DeviceMesh, what: str, closes_over_tensors: bool = True) -> tuple:
    """One callable for each mesh device.  ``fn`` is either one callable or
    a sequence of callables, one for each mesh device.  A callable's
    tensors are never copied to another device: one that carries a
    ``device`` (make_mpc_step's functions do) serves only a mesh of that
    device alone, and, where ``closes_over_tensors``, so does one that
    carries none (a step or an NLP family built on one device)."""
    if callable(fn):
        devs = set(mesh.devices)
        own = getattr(fn, "device", None)
        if (own is not None and {_norm_device(own)} != devs) or (
                own is None and closes_over_tensors and len(devs) > 1):
            where = "" if own is None else f" (on {_norm_device(own)})"
            raise ValueError(f"{what} is one callable{where}, but the mesh runs on "
                             f"{sorted(map(str, devs))}: pass one callable for each mesh "
                             f"device, each built on its device")
        return (fn,) * mesh.size
    fns = tuple(fn)
    if len(fns) != mesh.size:
        raise ValueError(f"{what}: {len(fns)} callables for a mesh of {mesh.size} devices")
    for f, d in zip(fns, mesh.devices):
        own = getattr(f, "device", None)
        if own is not None and _norm_device(own) != d:
            raise ValueError(f"{what}: a callable on {_norm_device(own)} for mesh device {d}")
    return fns


@contextlib.contextmanager
def _on_shard(device: torch.device, stream, caller_stream):
    """Run on the shard's device and stream, after the work the caller had
    queued on that device (the shard's inputs)."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        stream.wait_stream(caller_stream)
        yield


def _shard_map(fn, mesh: DeviceMesh, in_axes, out_axes) -> Callable:
    """``jax.shard_map`` for the port: ``fn`` (one callable for every shard,
    unless it carries another ``device``, or one for each mesh device; see
    :func:`_per_shard`) runs on each shard's part of the
    positional arguments, each shard in a thread of its own on its device
    and stream.  ``in_axes`` holds one spec for each argument and
    ``out_axes`` one for the output: an axis (the batch axis of every
    leaf), None (replicated) or a prefix of the structure holding those.
    Tensor leaves are split (or copied) to the mesh; Sharded and Replicated
    leaves must already match it.  Output leaves come back as Sharded along
    their axis (Replicated for None; any non-tensor leaf as shard 0 returned
    it).  The caller's streams wait for the shards' work.  An exception in
    any shard is raised after every thread has ended."""
    fns = _per_shard(fn, mesh, "fn", closes_over_tensors=False)

    def run(*args):
        if len(args) != len(in_axes):
            raise TypeError(f"{len(args)} arguments for {len(in_axes)} in_axes")
        leaves, spec = tree_flatten(list(args))
        axes = _leaf_axes(list(in_axes), list(args))
        placed = [_place(a, ax, mesh) for a, ax in zip(leaves, axes)]
        local = [tree_unflatten([p[i] for p in placed], spec) for i in range(mesh.size)]
        callers = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                   for d in mesh.devices]
        grad = torch.is_grad_enabled()
        results, errors = [None] * mesh.size, [None] * mesh.size

        def work(i):
            try:
                with torch.set_grad_enabled(grad), \
                        _on_shard(mesh.devices[i], mesh.streams[i], callers[i]):
                    results[i] = fns[i](*local[i])
            except BaseException as e:  # re-raised in the caller's thread
                errors[i] = e

        threads = [threading.Thread(target=work, args=(i,), name=f"shard-{i}")
                   for i in range(mesh.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for caller, stream in zip(callers, mesh.streams):
            if stream is not None:
                caller.wait_stream(stream)
        for i, e in enumerate(errors):
            if e is not None:
                e.add_note(f"in shard {i} of {mesh.size}, on {mesh.devices[i]}")
                raise e
        outs = [tree_flatten(r) for r in results]
        out_spec = outs[0][1]
        if any(s != out_spec for _, s in outs):
            raise ValueError("the shards returned outputs of different structures")
        merged = []
        for j, ax in enumerate(_leaf_axes(out_axes, results[0])):
            parts = tuple(o[0][j] for o in outs)
            if not isinstance(parts[0], torch.Tensor):
                merged.append(parts[0])
            elif ax is None:
                merged.append(Replicated(parts))
            else:
                merged.append(Sharded(parts, ax % parts[0].dim()))
        return tree_unflatten(merged, out_spec)

    return run


def make_sharded_fleet_step(fleet_fn, mesh: DeviceMesh, axis_name: str = "dp"):
    """Shard a fleet MPC step over the batch axis of a device mesh.

    ``fleet_fn`` is ``step.fleet_shared_t`` (or ``step.fleet``) from
    :func:`controllers.make_mpc_step`, or a sequence of them, one for each
    mesh device (a step's tensors live on the device it was built on: one
    callable serves a mesh only when every mesh device is its device).  The
    returned function has the same ``(warmstarts, t, xs) -> MPCStepResult``
    signature: ``warmstarts``/``xs`` whole or sharded on their leading axis,
    a scalar ``t`` replicated, a per-member ``(B,)`` ``t`` sharded like
    ``xs``; every output leaf is batch-sharded, and the result's sharded
    ``warmstart`` feeds the next step.  Each shard launches its own kernel
    on its own part (pure data parallelism, no collectives)."""
    _check_axis_name(mesh, axis_name)
    fns = _per_shard(fleet_fn, mesh, "fleet_fn")

    def sharded(warmstarts, t, xs):
        # a scalar clock replicates; a per-member (B,) time vector shards
        # along the batch axis like the states
        per_member = t.dim() >= 1 if torch.is_tensor(t) else (
            isinstance(t, Sharded) or np.ndim(t) >= 1)
        t_axis = 0 if per_member else None
        if per_member and not isinstance(t, (Sharded, torch.Tensor)):
            t = torch.as_tensor(np.asarray(t))
        return _shard_map(fns, mesh, (0, t_axis, 0), 0)(warmstarts, t, xs)

    return sharded


def make_sharded_sqp_fleet(make_nlp, mesh: DeviceMesh, params, axis_name: str = "dp"):
    """Shard a batched SQP fleet (``solve_nlp_sqp_batch``) over the mesh.

    Each shard runs the complete lockstep SQP + inner-ADMM loop on its LOCAL
    sub-batch with no collectives: the loop conditions are the shard's own,
    so its early exits are decoupled from the other shards' stragglers and
    each shard pays only the worst member of B/n; ``params.chunk_size``
    applies within each shard.

    ``make_nlp(theta) -> NLP`` as in :func:`solve_nlp_sqp_batch` (one
    callable where every mesh device is the device its tensors live on,
    else one for each mesh device); the returned ``sharded(thetas, x0,
    lam0=None)`` takes batch-leading inputs, whole or sharded, and returns
    a batch-sharded ``NLPSolution``.  ``lam0=None`` starts from zero
    multipliers.  B must divide evenly by the mesh size."""
    from ..solvers.sqp import solve_nlp_sqp_batch

    _check_axis_name(mesh, axis_name)
    local = [lambda th, x0, lam0, mk=mk: solve_nlp_sqp_batch(mk, th, x0, params, lam0=lam0)
             for mk in _per_shard(make_nlp, mesh, "make_nlp")]

    def sharded(thetas, x0, lam0=None):
        return _shard_map(local, mesh, (0, 0, 0), 0)(thetas, x0, lam0)

    return sharded
