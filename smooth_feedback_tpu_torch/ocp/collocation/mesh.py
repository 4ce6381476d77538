"""Legendre-Gauss-Radau collocation mesh.

A numpy-only copy of ``smooth_feedback_tpu/ocp/collocation/mesh.py`` (the
original's package import would pull in JAX).

TPU-native re-design of the reference mesh (collocation/mesh.hpp): the mesh is
an immutable, hashable host-side object (suitable as a jit-static argument);
node/weight/differentiation tables are precomputed in numpy float64 and baked
into compiled programs as constants.  Refinement (`refine_ph`,
`refine_errors`) returns a *new* mesh — a changed mesh signature means a new
XLA compilation, which is the fixed-shape analog of the reference's
reallocation.

Conventions match the reference:

* the mesh partitions [0, 1]; each interval has K in [Kmin, Kmax+1]
  collocation points at (left) LGR nodes, plus an extra interpolation node at
  the right endpoint (mesh.hpp:35-48),
* ``interval_diffmat(i)`` returns D of shape (K+1, K) with
  ``y'(tau_j) = sum_k y(tau_k) D[k, j]`` w.r.t. the GLOBAL [0,1] timescale
  (mesh.hpp:312-344),
* ``interval_intmat(i)`` is the inverse of the square sub-block
  (mesh.hpp:387-391).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np

# ------------------------------------------------------------- static tables


@functools.lru_cache(maxsize=None)
def lgr_nodes(K: int) -> Tuple[np.ndarray, np.ndarray]:
    """K left-Radau nodes and quadrature weights on [0, 1].

    Nodes are 0 together with the roots of (P_{K-1} + P_K)/(1+x) mapped from
    [-1, 1]; exactness degree 2K-2.
    """
    if K < 1:
        raise ValueError("K must be >= 1")
    if K == 1:
        return np.array([0.0]), np.array([1.0])
    c = np.zeros(K + 1)
    c[K - 1] = 1.0
    c[K] = 1.0
    x = np.sort(np.real(np.polynomial.legendre.legroots(c)))
    x[0] = -1.0
    cm1 = np.zeros(K)
    cm1[K - 1] = 1.0
    PKm1 = np.polynomial.legendre.legval(x, cm1)
    w = (1.0 - x) / (K * K * PKm1**2)
    w[0] = 2.0 / (K * K)
    return (x + 1.0) / 2.0, w / 2.0


@functools.lru_cache(maxsize=None)
def lgr_plus_one(K: int) -> Tuple[np.ndarray, np.ndarray]:
    """LGR nodes with an extra node at 1 (weight 0); cf. mesh.hpp:35-48."""
    n, w = lgr_nodes(K)
    return np.append(n, 1.0), np.append(w, 0.0)


def _bary_weights(t: np.ndarray) -> np.ndarray:
    diff = t[:, None] - t[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


@functools.lru_cache(maxsize=None)
def diffmat_local(K: int) -> np.ndarray:
    """Local differentiation matrix D of shape (K+1, K) on [0, 1]:
    ``y'(s_i) = sum_j y(s_j) D[j, i]`` for the K LGR collocation points."""
    t, _ = lgr_plus_one(K)  # K+1 points
    w = _bary_weights(t)
    # Dfull[i, j] = l_j'(t_i)
    Dfull = np.zeros((K + 1, K + 1))
    for i in range(K + 1):
        for j in range(K + 1):
            if i != j:
                Dfull[i, j] = (w[j] / w[i]) / (t[i] - t[j])
        Dfull[i, i] = -np.sum(Dfull[i, :])
    return Dfull[:K, :].T.copy()  # (K+1, K); column i = derivative at s_i


@functools.lru_cache(maxsize=None)
def intmat_local(K: int) -> np.ndarray:
    """Local integration matrix: inverse of diffmat rows 1..K (K x K)."""
    D = diffmat_local(K)
    return np.linalg.inv(D[1:, :])


@functools.lru_cache(maxsize=None)
def bary_weights_plus_one(K: int) -> np.ndarray:
    t, _ = lgr_plus_one(K)
    return _bary_weights(t)


@functools.lru_cache(maxsize=None)
def bary_weights_colloc(K: int) -> np.ndarray:
    t, _ = lgr_nodes(K)
    return _bary_weights(t)


# --------------------------------------------------------------------- mesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Immutable collocation mesh of [0, 1]; cf. reference Mesh (mesh.hpp:60).

    ``intervals`` is a tuple of ``(K, tau0)`` pairs sorted by ``tau0``.
    """

    Kmin: int = 5
    Kmax: int = 10
    intervals: Tuple[Tuple[int, float], ...] = None  # type: ignore

    def __post_init__(self):
        if self.intervals is None:
            object.__setattr__(self, "intervals", ((self.Kmin, 0.0),))

    # -------------------------------------------------------- constructors
    @staticmethod
    def uniform(n: int, k: int = 5, Kmin: int = 5, Kmax: int = 10) -> "Mesh":
        """n equal intervals of degree k (cf. mesh.hpp:93-105)."""
        n = max(1, n)
        ivs = tuple((k, i / n) for i in range(n))
        return Mesh(Kmin=Kmin, Kmax=Kmax, intervals=ivs)

    # ------------------------------------------------------------- queries
    @property
    def N_ivals(self) -> int:
        return len(self.intervals)

    @property
    def N_colloc(self) -> int:
        return sum(K for K, _ in self.intervals)

    def N_colloc_ival(self, i: int) -> int:
        return self.intervals[i][0]

    def interval_bounds(self, i: int) -> Tuple[float, float]:
        tau0 = self.intervals[i][1]
        tauf = self.intervals[i + 1][1] if i + 1 < len(self.intervals) else 1.0
        return tau0, tauf

    def interval_nodes(self, i: int) -> np.ndarray:
        """K+1 global nodes of interval i (incl. right endpoint)."""
        K = self.intervals[i][0]
        tau0, tauf = self.interval_bounds(i)
        s, _ = lgr_plus_one(K)
        return tau0 + (tauf - tau0) * s

    def interval_weights(self, i: int) -> np.ndarray:
        K = self.intervals[i][0]
        tau0, tauf = self.interval_bounds(i)
        _, w = lgr_plus_one(K)
        return (tauf - tau0) * w

    def all_nodes(self) -> np.ndarray:
        """All N_colloc collocation nodes plus the final node at 1
        (size N_colloc + 1; cf. mesh.hpp:239-249)."""
        out = [self.interval_nodes(i)[:-1] for i in range(self.N_ivals)]
        out.append(np.array([1.0]))
        return np.concatenate(out)

    def all_weights(self) -> np.ndarray:
        """Quadrature weights matching :meth:`all_nodes` (final weight 0)."""
        out = [self.interval_weights(i)[:-1] for i in range(self.N_ivals)]
        out.append(np.array([0.0]))
        return np.concatenate(out)

    def interval_offsets(self) -> np.ndarray:
        """Start index of each interval's first collocation node."""
        return np.concatenate(
            [[0], np.cumsum([K for K, _ in self.intervals])[:-1]]
        ).astype(int)

    def interval_diffmat(self, i: int) -> np.ndarray:
        """(K+1, K) differentiation matrix w.r.t. the [0,1] timescale."""
        K = self.intervals[i][0]
        tau0, tauf = self.interval_bounds(i)
        return diffmat_local(K) / (tauf - tau0)

    def interval_diffmat_unscaled(self, i: int) -> Tuple[float, np.ndarray]:
        """(alpha, D_local) with interval_diffmat = alpha * D_local."""
        K = self.intervals[i][0]
        tau0, tauf = self.interval_bounds(i)
        return 1.0 / (tauf - tau0), diffmat_local(K)

    def interval_intmat(self, i: int) -> np.ndarray:
        K = self.intervals[i][0]
        tau0, tauf = self.interval_bounds(i)
        return (tauf - tau0) * intmat_local(K)

    def interval_find(self, t: float) -> int:
        if t <= 0:
            return 0
        if t >= 1:
            return self.N_ivals - 1
        taus = [tau0 for _, tau0 in self.intervals]
        return int(np.searchsorted(np.asarray(taus), t, side="right") - 1)

    # ---------------------------------------------------------- refinement
    def refine_ph(self, i: int, D: int) -> "Mesh":
        """ph-refinement of interval i toward D collocation points
        (cf. mesh.hpp:145-167); returns a new mesh."""
        ivs = list(self.intervals)
        K, tau0 = ivs[i]
        tauf = ivs[i + 1][1] if i + 1 < len(ivs) else 1.0
        if D > self.Kmax or K > self.Kmax:
            n = max(2, -(-D // self.Kmin))  # ceil
            taum = (tauf - tau0) / n
            new = [(self.Kmin, tau0 + j * taum) for j in range(n)]
            ivs[i : i + 1] = new
        elif D < K:
            pass
        else:
            ivs[i] = (D, tau0)
        return dataclasses.replace(self, intervals=tuple(ivs))

    def refine_errors(self, errs, target_err: float) -> "Mesh":
        """Error-driven refinement (cf. mesh.hpp:174-189); returns new mesh."""
        mesh = self
        for i in reversed(range(self.N_ivals)):
            e = float(errs[i])
            Ki = self.N_colloc_ival(i)
            if e > target_err:
                Ktarget = Ki + int(round(math.log(e / target_err) / math.log(Ki) + 1))
                mesh = mesh.refine_ph(i, Ktarget)
        return mesh

    def increase_degrees(self) -> "Mesh":
        ivs = tuple((min(K + 1, self.Kmax + 1), t) for K, t in self.intervals)
        return dataclasses.replace(self, intervals=ivs)

    def decrease_degrees(self) -> "Mesh":
        ivs = tuple((max(K - 1, self.Kmin), t) for K, t in self.intervals)
        return dataclasses.replace(self, intervals=ivs)

    def set_N_colloc_ival(self, i: int, K: int) -> "Mesh":
        ivs = list(self.intervals)
        ivs[i] = (K, ivs[i][1])
        return dataclasses.replace(self, intervals=tuple(ivs))

    # groups of intervals with equal degree (for vectorized assembly)
    def degree_groups(self):
        """Dict degree -> list of interval indices."""
        groups = {}
        for i, (K, _) in enumerate(self.intervals):
            groups.setdefault(K, []).append(i)
        return groups
