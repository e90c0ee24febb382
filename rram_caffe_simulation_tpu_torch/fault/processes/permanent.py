"""`permanent_fault_map`: static manufacturing-defect maps, a fixed set
of cells stuck from step 0 and nothing evolving (counterpart of the
reference package's fault/processes/permanent.py).

The state is the clamp family's lifetimes/stuck groups, so the
strategies, the census, checkpoints and the packed banks work
unchanged: lifetimes are a constant field of -1.0 (faulty: <= 0 broken,
< 0 the remapping flag) or +1.0 (healthy), never decremented (kernel
B1's mode "never").

The map comes from one of:

- ``map=PATH``: a .npz with ``<layer/slot>/broken`` (nonzero = faulty)
  and ``<layer/slot>/stuck`` ({-1, 0, +1}) per fault-target param,
  shaped as the net's (a missing key: that param is fault-free);
- ``fraction=F``: each cell faulty with probability F, stuck values
  from the pattern's failure_prob splits, each crossbar tile its own
  draw; every sweep config draws its own placement.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import prng
from ...core.registry import register_fault_process
from .. import engine as fault_engine
from .. import mapping as fault_mapping
from .. import packed as fault_packed
from .base import FaultProcess, float_param


@register_fault_process("permanent_fault_map")
class PermanentFaultMap(FaultProcess):

    phase = "clamp"
    has_lifetimes = True
    supports_packed = True
    #: kernel B1 never decrements: the counter field is static
    fused_mode = "never"
    param_names = ("map", "fraction")

    def __init__(self, params=None):
        super().__init__(params)
        self.map_path = self.params.get("map")
        self.fraction = None
        if "fraction" in self.params:
            self.fraction = float_param(self.params, "fraction", 0.0)
            if not 0.0 <= self.fraction <= 1.0:
                raise ValueError(
                    f"permanent_fault_map fraction must be in [0, 1], "
                    f"got {self.fraction!r}")
        if (self.map_path is None) == (self.fraction is None):
            raise ValueError(
                "permanent_fault_map needs exactly one of map=PATH "
                "(a .npz defect map) or fraction=F (i.i.d. synthetic "
                "yield)")
        self._loaded = None

    # --- map source ----------------------------------------------------
    def _load_map(self, shapes, lead, device):
        if self._loaded is None:
            with np.load(self.map_path) as z:
                self._loaded = {k: np.asarray(z[k]) for k in z.files}
        life, stuck = {}, {}
        for name, shape in shapes.items():
            b = self._loaded.get(f"{name}/broken")
            s = self._loaded.get(f"{name}/stuck")
            if b is None:
                b = np.zeros(shape, bool)
            if s is None:
                s = np.zeros(shape, np.float32)
            if tuple(b.shape) != tuple(shape) \
                    or tuple(s.shape) != tuple(shape):
                raise ValueError(
                    f"permanent_fault_map {self.map_path}: entry "
                    f"{name!r} has shape {tuple(np.shape(b))}/"
                    f"{tuple(np.shape(s))}, expected {tuple(shape)}")
            bad = set(np.unique(np.asarray(s, np.float32))) - {-1.0, 0.0,
                                                               1.0}
            if bad:
                raise ValueError(
                    f"permanent_fault_map {self.map_path}: {name!r} "
                    f"stuck values {sorted(bad)} outside {{-1, 0, +1}}")
            lv = np.where(np.asarray(b, bool), -1.0, 1.0).astype(np.float32)
            sv = np.asarray(s, np.float32)
            # every config of a sweep holds the same chip
            life[name] = torch.from_numpy(np.array(
                np.broadcast_to(lv, lead + lv.shape))).to(device)
            stuck[name] = torch.from_numpy(np.array(
                np.broadcast_to(sv, lead + sv.shape))).to(device)
        return {"lifetimes": life, "stuck": stuck}

    def _draw_map(self, key, shapes, pattern, tiles, device):
        split1, split2 = (float(np.float32(v))
                          for v in fault_engine.stuck_splits(pattern))
        frac = float(np.float32(self.fraction))

        def life_draw(k, shape):
            broken = prng.uniform(k, shape, device=device) < frac
            return torch.where(broken, -1.0, 1.0)

        def stuck_draw(k, shape):
            u = prng.uniform(k, shape, device=device)
            return torch.where(u < split1, -1.0,
                               torch.where(u < split2, 0.0, 1.0))

        life, stuck = {}, {}
        for name in sorted(shapes):
            ks = prng.split(key, 3)
            key, k_b, k_s = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]
            # defects are a per-die statistic: each tile rolls its own
            life[name] = fault_mapping.tiled_draw(k_b, shapes[name], tiles,
                                                  life_draw)
            stuck[name] = fault_mapping.tiled_draw(k_s, shapes[name], tiles,
                                                   stuck_draw)
        return {"lifetimes": life, "stuck": stuck}

    # --- state ---------------------------------------------------------
    def init_state(self, key, shapes, pattern, tiles=None, device="cpu"):
        if self.map_path is not None:
            # a file map is the measured chip: its tiles are in it
            lead = tuple(np.shape(key)[:-1])
            return self._load_map(shapes, lead, device)
        return self._draw_map(key, shapes, pattern, tiles, device)

    def draw_rescaled(self, key, shapes, pattern, mean, std, tiles=None,
                      device="cpu"):
        # no lifetimes to re-anchor: a file map is the same chip for every
        # config, a fraction map an independent placement under each key
        return self.init_state(key, shapes, pattern, tiles=tiles,
                               device=device)

    # --- the (static) transform ---------------------------------------
    def fail(self, fault_params, state, fault_diffs, decrement):
        new_params = {}
        for name, data in fault_params.items():
            new_params[name] = torch.where(state["lifetimes"][name] <= 0,
                                           state["stuck"][name], data)
        return new_params, state

    def fail_packed(self, fault_params, state, fault_diffs, pack_spec):
        return fault_packed.fail_packed(fault_params, state, fault_diffs,
                                        pack_spec, mode="never")
