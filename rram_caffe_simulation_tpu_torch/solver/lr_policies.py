"""Learning-rate schedules (counterpart of the reference package's
solver/lr_policies.py; reference SGDSolver::GetLearningRate,
sgd_solver.cpp:27-91): the seven policies as host functions of the
iteration, in the float32 arithmetic the reference uses. The port's
step runs eagerly, so the rate is a host number handed to the update."""
from __future__ import annotations

import numpy as np


def current_step_fn(param):
    """it -> current_step_, the count a snapshot's SolverState carries
    (the reference's closed form): it // stepsize under "step", the
    stepvalues reached under "multistep", else 0."""
    policy = param.lr_policy
    if policy == "step":
        stepsize = max(int(param.stepsize), 1)
        return lambda it: int(it) // stepsize
    if policy == "multistep":
        steps = [int(s) for s in param.stepvalue]
        return lambda it: sum(int(it) >= s for s in steps)
    return lambda it: 0


def learning_rate_fn(param):
    """rate(iter) -> float (a float32 value) for `param.lr_policy`."""
    policy = param.lr_policy
    base = np.float32(param.base_lr)
    gamma = np.float32(param.gamma)
    power = np.float32(param.power)
    one = np.float32(1.0)

    if policy == "fixed":
        return lambda it: float(base)
    if policy == "step":
        stepsize = max(int(param.stepsize), 1)
        return lambda it: float(
            base * gamma ** np.float32(int(it) // stepsize))
    if policy == "multistep":
        steps = sorted(int(s) for s in param.stepvalue)
        return lambda it: float(
            base * gamma ** np.float32(sum(int(it) >= s for s in steps)))
    if policy == "exp":
        return lambda it: float(base * gamma ** np.float32(it))
    if policy == "inv":
        return lambda it: float(
            base * (one + gamma * np.float32(it)) ** (-power))
    if policy == "poly":
        max_iter = np.float32(param.max_iter)
        return lambda it: float(
            base * (one - np.float32(it) / max_iter) ** power)
    if policy == "sigmoid":
        stepsize = np.float32(param.stepsize)
        return lambda it: float(
            base / (one + np.exp(-gamma * (np.float32(it) - stepsize))))
    raise ValueError(f"Unknown lr policy: {policy!r}")
