"""Host-side evaluation of an NLP's functions for the bridges: numpy in,
numpy out, each call on the NLP's own device and dtype."""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacrev

from ..nlp import NLP


def to_numpy(a) -> np.ndarray:
    """float64 numpy copy of a tensor (on any device) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


class HostNLP:
    """``f``, its gradient, ``g`` and its Jacobian of ``nlp`` as numpy
    callables (``torch.func.grad`` / ``jacrev``)."""

    def __init__(self, nlp: NLP):
        self.nlp = nlp
        self.kw = dict(dtype=nlp.xl.dtype, device=nlp.xl.device)
        self._grad = grad(nlp.f)
        self._jac = jacrev(nlp.g)

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float64), **self.kw)

    def f(self, x) -> float:
        return float(self.nlp.f(self.tensor(x)))

    def grad(self, x) -> np.ndarray:
        return to_numpy(self._grad(self.tensor(x)))

    def g(self, x) -> np.ndarray:
        return to_numpy(self.nlp.g(self.tensor(x)))

    def jac(self, x) -> np.ndarray:
        return to_numpy(self._jac(self.tensor(x)))
