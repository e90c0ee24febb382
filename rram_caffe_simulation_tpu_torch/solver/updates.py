"""SGD, the update rule of the slice (counterpart of the reference
package's solver/updates.py; reference sgd_solver.cpp:217-247
ComputeUpdateValue): history = local_rate * diff + momentum * history;
update = history. The solver then applies data -= update after the
RRAM strategy pass (solver.cpp:299-305). The other five rules wait for
a later slice."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class Hyper:
    """Update-rule hyperparameters from a SolverParameter, as float32
    values (the reference holds them as f32 scalars)."""

    def __init__(self, param):
        self.momentum = float(np.float32(param.momentum))


def sgd(diff, slots, local_rate: float, hp: Hyper, t):
    h = local_rate * diff + hp.momentum * slots["h"]
    return h, {"h": h}


UPDATE_RULES = {"SGD": sgd}
HISTORY_SLOTS = {"SGD": ("h",)}


def init_history(solver_type: str,
                 param_tensors: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """Zero history banks shaped like each learnable param
    (SGDSolver::PreSolve, sgd_solver.cpp:93-105)."""
    return {key: {s: torch.zeros_like(t) for s in HISTORY_SLOTS[solver_type]}
            for key, t in param_tensors.items()}
