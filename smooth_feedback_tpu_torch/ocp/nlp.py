"""Re-export: the NLP types live in :mod:`smooth_feedback_tpu_torch.nlp`
(top level, so solvers and ocp can both import them without a cycle)."""

from ..nlp import NLP, HessianNLP, NLPSolution, NLPSolutionStatus, with_hessians

__all__ = ["NLP", "HessianNLP", "NLPSolution", "NLPSolutionStatus", "with_hessians"]
