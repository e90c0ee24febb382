"""The six SGD-family update rules (counterpart of the reference
package's solver/updates.py; reference src/caffe/solvers/*_solver.cpp
ComputeUpdateValue).

Each rule is `rule(diff, slots, local_rate, hp, t) -> (update, slots')`:
`diff` the regularized gradient, `slots` the param's history banks by
name, `local_rate` the float32 rate * lr_mult, `t` = iter + 1 (Adam's
step count). Under per-lane clocks (the self-healing sweep's virtual
time) `local_rate` is a float32 tensor of one rate a lane, shaped to
broadcast over the (C, ...) diff, and Adam's `t` the lanes' corrections
`adam_correction` as a tensor of the same shape; the rules keep their
operation order, one float32 product a lane. The solver then applies
data -= update after the RRAM strategy pass (solver.cpp:299-305).

Every rule keeps the reference's expression order, one float32
operation at a time: `local_rate * diff / (sqrt(h) + delta)` is
`(local_rate * diff) / (...)`, `(1 - r) * diff * diff` is `((1 - r) *
diff) * diff`, and the scalar factors (`1 - r`, `1 + m`, `1 - b`) are
float32 operations on the host before they meet a tensor. The square
root is the correctly rounded one on either device (`_sqrt`: torch's
CPU sqrt is not). Adam's bias correction `sqrt(1 - b2^t) / (1 - b1^t)`
is a float32 scalar of the step, computed on the host once per step
with the C library's `powf`, which is the power XLA's CPU backend
calls (`adam_correction`).

Multi-slot history serializes in the reference's .solverstate order:
every param's "h" bank, then every param's "h2" (AdaDelta and Adam).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Dict

import numpy as np
import torch

from ..core.prng import _sqrt as _sqrt_cpu

F32 = np.float32


def _f32(x) -> float:
    return float(F32(x))


class Hyper:
    """Update-rule hyperparameters from a SolverParameter, as float32
    values (the reference holds them as float32 scalars; `delta`'s
    default is float32(1e-8)), with the scalar factors the rules use."""

    def __init__(self, param):
        self.momentum = _f32(param.momentum)
        self.momentum2 = _f32(param.momentum2)      # Adam beta2
        self.delta = _f32(param.delta)
        self.rms_decay = _f32(param.rms_decay)
        one = F32(1.0)
        self.one_plus_m = _f32(one + F32(self.momentum))
        self.one_minus_m = _f32(one - F32(self.momentum))
        self.one_minus_m2 = _f32(one - F32(self.momentum2))
        self.one_minus_r = _f32(one - F32(self.rms_decay))


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 sqrt: CUDA's is; on the CPU the
    float64 one fixed up against the midpoints (core/prng.py)."""
    return torch.sqrt(t) if t.device.type != "cpu" else _sqrt_cpu(t)


@functools.lru_cache(maxsize=1)
def _powf():
    """The C library's float32 pow, loaded at first use."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float,
                                               ctypes.c_float]
    return fn


def powf(b: float, t: float) -> float:
    """b ** t in float32 as XLA's CPU backend computes it: the C
    library's powf (glibc's is within 0.82 ulp of the exact power and
    equals XLA's at every t in 1..50000 for b = 0.999; numpy's float32
    power is not it)."""
    return float(_powf()(F32(b), F32(t)))


def adam_correction(hp: Hyper, t: int) -> float:
    """sqrt(1 - b2^t) / (1 - b1^t) in float32, each operation rounded
    (adam_solver.cpp:41)."""
    tf = _f32(t)
    num = np.sqrt(F32(1.0) - F32(powf(hp.momentum2, tf)))
    return _f32(F32(num) / (F32(1.0) - F32(powf(hp.momentum, tf))))


def sgd(diff, slots, local_rate: float, hp: Hyper, t):
    """history = local_rate*diff + momentum*history; update = history
    (sgd_solver.cpp:217-247)."""
    h = local_rate * diff + hp.momentum * slots["h"]
    return h, {"h": h}


def nesterov(diff, slots, local_rate: float, hp: Hyper, t):
    """update = (1+m)*h_new - m*h_old (nesterov_solver.cpp:9-35)."""
    h_old = slots["h"]
    h = local_rate * diff + hp.momentum * h_old
    return hp.one_plus_m * h - hp.momentum * h_old, {"h": h}


def adagrad(diff, slots, local_rate: float, hp: Hyper, t):
    """h += diff^2; update = local_rate * diff / (sqrt(h) + delta)
    (adagrad_solver.cpp:9-46)."""
    h = slots["h"] + diff * diff
    return (local_rate * diff) / (_sqrt(h) + hp.delta), {"h": h}


def rmsprop(diff, slots, local_rate: float, hp: Hyper, t):
    """h = rms_decay*h + (1-rms_decay)*diff^2; update = local_rate * diff
    / (sqrt(h) + delta) (rmsprop_solver.cpp:10-46)."""
    h = hp.rms_decay * slots["h"] + (hp.one_minus_r * diff) * diff
    return (local_rate * diff) / (_sqrt(h) + hp.delta), {"h": h}


def adadelta(diff, slots, local_rate: float, hp: Hyper, t):
    """h1 tracks the gradient's RMS, h2 the update's; v = diff *
    sqrt((delta+h2)/(delta+h1)); update = local_rate * v
    (adadelta_solver.cpp:19-77; momentum is the decay)."""
    m = hp.momentum
    h1 = m * slots["h"] + (hp.one_minus_m * diff) * diff
    v = diff * _sqrt((hp.delta + slots["h2"]) / (hp.delta + h1))
    h2 = m * slots["h2"] + (hp.one_minus_m * v) * v
    return local_rate * v, {"h": h1, "h2": h2}


def adam(diff, slots, local_rate: float, hp: Hyper, t):
    """m, v moments and the sqrt(1-b2^t)/(1-b1^t) correction
    (adam_solver.cpp:19-80; momentum = beta1, momentum2 = beta2, delta =
    eps)."""
    m = hp.momentum * slots["h"] + hp.one_minus_m * diff
    v = hp.momentum2 * slots["h2"] + (hp.one_minus_m2 * diff) * diff
    if isinstance(t, torch.Tensor):     # per lane: the corrections
        scale = local_rate * t
    else:
        scale = _f32(F32(local_rate) * F32(adam_correction(hp, t)))
    return (scale * m) / (_sqrt(v) + hp.delta), {"h": m, "h2": v}


UPDATE_RULES = {
    "SGD": sgd,
    "Nesterov": nesterov,
    "AdaGrad": adagrad,
    "RMSProp": rmsprop,
    "AdaDelta": adadelta,
    "Adam": adam,
}

# slot names per solver type; "h2" is the second history bank, after
# the first in the .solverstate history list
HISTORY_SLOTS = {
    "SGD": ("h",),
    "Nesterov": ("h",),
    "AdaGrad": ("h",),
    "RMSProp": ("h",),
    "AdaDelta": ("h", "h2"),
    "Adam": ("h", "h2"),
}

# the legacy SolverParameter.solver_type enum, by number, -> type string
# (upgrade_proto.hpp:80 UpgradeSolverAsNeeded)
LEGACY_SOLVER_TYPES = ["SGD", "Nesterov", "AdaGrad", "RMSProp", "AdaDelta",
                       "Adam"]
# the enum's labels, in the same order (caffe.proto SolverType)
LEGACY_SOLVER_LABELS = ["SGD", "NESTEROV", "ADAGRAD", "RMSPROP", "ADADELTA",
                        "ADAM"]


def resolve_solver_type(param) -> str:
    """The solver's type string: the legacy `solver_type` enum where it
    is set and `type` is not (given as its number or its label), else
    `type` with a trailing "Solver" stripped (solver_factory.hpp:73)."""
    if param.HasField("solver_type") and not param.HasField("type"):
        v = param.solver_type
        if isinstance(v, str):
            if v not in LEGACY_SOLVER_LABELS:
                raise ValueError(f"unknown solver_type {v!r}")
            v = LEGACY_SOLVER_LABELS.index(v)
        if not 0 <= int(v) < len(LEGACY_SOLVER_TYPES):
            raise ValueError(f"unknown solver_type {v!r}")
        return LEGACY_SOLVER_TYPES[int(v)]
    t = param.type
    return t[:-6] if t.endswith("Solver") else t


def init_history(solver_type: str,
                 param_tensors: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """Zero history banks shaped like each learnable param
    (SGDSolver::PreSolve, sgd_solver.cpp:93-105)."""
    return {key: {s: torch.zeros_like(t) for s in HISTORY_SLOTS[solver_type]}
            for key, t in param_tensors.items()}
