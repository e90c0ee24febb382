"""`conductance_drift`: retention loss, programmed conductances decay
toward a drift target on a log time axis, re-anchored by writes
(counterpart of the reference package's fault/processes/drift.py).

Per cell

    w(age+1) = target + (w(age) - target) * exp(-rate * dlog)
    dlog     = log1p(age+1) - log1p(age)

so after `a` unwritten steps the decay is ``(1+a)^-rate``, the power law
of PCM/RRAM drift. A write (|diff| >= 1e-20) resets the cell's age to 0
and its fresh value takes no decay that step. The rate is log-normal
around `nu`, ``rate = nu * exp(sigma * z)`` with z ~ N(0, 1) drawn once.

State groups, both f32 (they ride every generic mechanism, and pass
through the packed banks untouched): ``drift_age`` (steps since the
cell's last write) and ``drift_rate``. Parameters: ``target`` (default
0.0), ``nu`` (default 0.1), ``sigma`` (default 0.0).

The arithmetic is the reference's to the bit: `exp` and `log1p` are
XLA's CPU float32 functions (core/prng.py), and the last multiply-add
is one correctly rounded fma, as XLA contracts it in the reference's
jitted train step. The same tensor operations give the same bits on the
card.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import prng
from ...core.registry import register_fault_process
from .. import engine as fault_engine
from .. import mapping as fault_mapping
from .base import FaultProcess, float_param, lane_count


@register_fault_process("conductance_drift")
class ConductanceDrift(FaultProcess):

    phase = "decay"
    has_lifetimes = False
    supports_packed = True   # its f32 groups pass through the banks
    param_names = ("target", "nu", "sigma")

    def __init__(self, params=None):
        super().__init__(params)
        self.target = float_param(self.params, "target", 0.0)
        self.nu = float_param(self.params, "nu", 0.1)
        self.sigma = float_param(self.params, "sigma", 0.0)
        if self.nu < 0:
            raise ValueError(f"conductance_drift nu must be >= 0, got "
                             f"{self.nu!r}")

    def init_state(self, key, shapes, pattern, tiles=None, device="cpu"):
        nu, sigma = prng._f32(self.nu), prng._f32(self.sigma)

        def rate_draw(k, shape):
            return nu * prng.exp(sigma * prng.normal(k, shape, device))

        lead = tuple(np.shape(key)[:-1])
        age, rate = {}, {}
        for name in sorted(shapes):
            ks = prng.split(key)
            key, k_rate = ks[..., 0, :], ks[..., 1, :]
            shape = tuple(shapes[name])
            age[name] = torch.zeros(lead + shape, dtype=torch.float32,
                                    device=device)
            # each crossbar tile is its own die area: its rate field
            # draws under the tile-folded key
            rate[name] = fault_mapping.tiled_draw(k_rate, shape, tiles,
                                                  rate_draw)
        return {"drift_age": age, "drift_rate": rate}

    def draw_rescaled(self, key, shapes, pattern, mean, std, tiles=None,
                      device="cpu"):
        # no lifetimes: (mean, std) belong to the stack's clamp process;
        # each config draws its own rate field under its key
        return self.init_state(key, shapes, pattern, tiles=tiles,
                               device=device)

    def fail(self, fault_params, state, fault_diffs, decrement):
        target = prng._f32(self.target)
        new_params, new_age = {}, {}
        for name, w in fault_params.items():
            age = state["drift_age"][name]
            rate = state["drift_rate"][name]
            written = fault_diffs[name].abs() >= fault_engine.EPSILON32
            age1 = torch.where(written, 0.0, age + 1.0)
            # the log-time step; 0 for a re-anchored (written) cell
            dlog = torch.where(written, 0.0,
                               prng.log1p(age1) - prng.log1p(age))
            decay = prng.exp(-rate * dlog)
            new_params[name] = prng.fma(w - target, decay, target)
            new_age[name] = age1
        return new_params, {**state, "drift_age": new_age}

    def fail_packed(self, fault_params, state, fault_diffs, pack_spec):
        # its groups are f32 either way: the banks hold the clamp
        # family's lifetimes and stuck values only
        return self.fail(fault_params, state, fault_diffs,
                         pack_spec["decrement"])

    def counters(self, state, life_view, lanes=0):
        drifted = age_sum = None
        n = 0
        for v in state["drift_age"].values():
            c = lane_count(v > 0, lanes)
            flat = v.reshape(lanes, -1) if lanes else v.reshape(-1)
            # ages are whole steps: a float64 sum is exact, rounded once
            s = flat.double().sum(-1)
            drifted = c if drifted is None else drifted + c
            age_sum = s if age_sum is None else age_sum + s
            n += flat.shape[-1]
        # the reference's jitted census: a float32 sum times the float32
        # reciprocal of the cell count
        inv = float(np.float32(1.0) / np.float32(max(n, 1)))
        return {"drifted": drifted,
                "age_mean": age_sum.float() * inv}

    def health(self, state, life_view, stuck_view, tiles, edges, ndims):
        # the age distribution per (param, tile): how long each cell has
        # drifted unwritten
        return {name: fault_mapping.per_tile_ages(
                    state["drift_age"][name], tiles, edges["age"],
                    ndims[name])
                for name in sorted(state["drift_age"])}
