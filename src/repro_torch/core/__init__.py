"""Core library: the paper's performance model, algorithms, and bounds.

A numpy-only copy of ``repro.core`` with identical arithmetic, so that
the port prices and selects exactly as the reference does; only the
cache directory (``autogen.cache_dir``) is the port's own."""

from repro_torch.core.model import CostTerms, Fabric, TPU_V5E_AXIS, WSE2
from repro_torch.core import patterns, schedule
from repro_torch.core.autogen import autogen_tree, compute_tables, t_autogen
from repro_torch.core.lowerbound import compute_lb_energy, t_lower_bound
from repro_torch.core.selector import (best_allreduce, best_reduce,
                                 optimality_ratios, predict_allreduce,
                                 predict_reduce)

__all__ = [
    "CostTerms", "Fabric", "WSE2", "TPU_V5E_AXIS", "patterns", "schedule",
    "autogen_tree", "compute_tables", "t_autogen", "compute_lb_energy",
    "t_lower_bound", "best_allreduce", "best_reduce", "optimality_ratios",
    "predict_allreduce", "predict_reduce",
]
