"""`debug_info` deep tracing and numeric health sentinels (counterpart of
the reference package's observe/debug.py).

`SolverParameter.debug_info` prints, every iteration, the reference's
per-layer mean-absolute-value lines (net.cpp:618-668 ForwardDebugInfo,
BackwardDebugInfo, UpdateDebugInfo). `NetDebugSpec` enumerates the
capture points once; the step reduces exactly these entries into a few
stacked f32 vectors (one row per lane under the sweep's config axis)
that ride the step's metrics tree as device tensors, and the host
formats the lines and the `debug_trace` record from them.

On top of the same vectors:

- **sentinels**: per phase (forward, backward, update, fault clamp),
  NaN / Inf / overflow flags with the first bad entry's index
  (`sentinel_tree`). A NaN anywhere in a blob poisons its mean-abs, so
  the per-entry scalar is a sufficient detector.
- **the watchdog**: a host policy (`Solver.enable_watchdog`) that reads
  the sentinel summary every iteration and, on a trip or a non-finite
  loss, prints a diagnostic naming the phase and layer, optionally
  snapshots, and stops the run.

As in the reference: a blob read by several layers carries one summed
cotangent; under `iter_size` > 1 the forward values are the last
sub-batch's and the backward diffs the accumulated ones; a shared param
reports its owner's gradient. In-place chains (`fc1 -> ReLU -> fc1`)
trace each version apart: capture sites are (producing layer, top)
pairs, and a data top is captured when it is fed.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .schema import SCHEMA_VERSION

#: Sentinel phases, in the order their vectors stack into the tree.
PHASES = ("forward", "backward", "update", "fault")

#: A finite mean-abs above this trips the overflow sentinel.
OVERFLOW_LIMIT = 1e30


def blob_mean_abs(x: torch.Tensor, lanes: int = 0, laned: bool = False,
                  scalar: bool = False) -> torch.Tensor:
    """asum/count of a blob (Blob::asum_data()/count()), f32; under
    `lanes` one value per lane, (lanes,): a laned blob of per-config
    shape (d0, d1, ...) is held as (d0, lanes*d1, ...), a laned
    per-config scalar (`scalar`) as (lanes,), and a blob no lane
    changes (`laned` False) is the same for every lane."""
    a = x.detach().float().abs()
    if not lanes:
        return a.mean()
    if not laned:
        return a.mean().expand(lanes)
    if scalar:
        return a
    return a.reshape(a.shape[0], lanes, -1).mean((0, 2))


def param_mean_abs(x: torch.Tensor, lanes: int = 0) -> torch.Tensor:
    """asum/count of a param or a per-param tensor (a leading lane axis
    under `lanes`), f32."""
    a = x.detach().float().abs()
    return a.reshape(lanes, -1).mean(1) if lanes else a.mean()


class NetDebugSpec:
    """The capture points of a net's debug trace, built once.

    Entry forms (tuples, in emission order):

    - ``fwd``: ("top", layer, blob, site) then ("param", layer,
      display_name, slot) per layer in forward order. `site` is the
      (producing layer, top) pair a capture keys on; a fed data top
      uses ("__data__", top).
    - ``bwd``: ("bottom", layer, blob, site) then ("bparam", layer,
      slot, owner_key) per layer in reverse order. Bottoms fed by a
      data layer are skipped (bottom_need_backward == false), so are
      params with lr_mult == 0.
    - ``update``: (layer, display_name, owner_key) per owned learnable
      param, in learnable_params order.
    - ``fault``: owner_key per fault-target param (the post-clamp
      check).
    """

    def __init__(self, net, owner_refs, fault_keys):
        self.net = net
        consumed = {b for ly in net.layers for b in ly.lp.bottom}
        self.fwd: List[tuple] = []
        bwd_per_layer: List[List[tuple]] = []
        current_site: Dict[str, Optional[tuple]] = {}
        # whether a site's blob carries the lane axis (Net.apply's rule,
        # Layer.laned_tops)
        self.laned: Dict[tuple, bool] = {}
        laned_blob: Dict[str, bool] = {}
        for layer in net.layers:
            if layer.is_data_source:
                for t in layer.lp.top:
                    current_site[t] = None
                    laned_blob[t] = False
                    if t in consumed:
                        site = ("__data__", t)
                        self.laned[site] = False
                        self.fwd.append(("top", layer.name, t, site))
                continue
            specs = layer.param_specs()
            bottom_sites = [(b, current_site.get(b))
                            for b in layer.lp.bottom]
            outs = layer.laned_tops([laned_blob.get(b, False)
                                     for b in layer.lp.bottom])
            for t, out_laned in zip(layer.lp.top, outs):
                site = (layer.name, t)
                current_site[t] = site
                laned_blob[t] = out_laned
                self.laned[site] = out_laned
                self.fwd.append(("top", layer.name, t, site))
            for slot in range(layer.num_params()):
                disp = specs[slot].name or str(slot)
                self.fwd.append(("param", layer.name, disp, slot))
            entries = [("bottom", layer.name, b, site)
                       for b, site in bottom_sites if site is not None]
            for slot in range(layer.num_params()):
                if specs[slot].lr_mult == 0:
                    continue
                owner, oslot = net._layer_slots[layer.name][slot]
                entries.append(("bparam", layer.name, slot,
                                f"{owner}/{oslot}"))
            bwd_per_layer.append(entries)
        self.bwd: List[tuple] = [e for lay in reversed(bwd_per_layer)
                                 for e in lay]
        # probes only where a backward entry reads the cotangent
        self.probe_sites = sorted({e[3] for e in self.bwd
                                   if e[0] == "bottom"},
                                  key=lambda s: (s[0], s[1]))
        self.update: List[tuple] = [
            (r.layer_name, r.name or str(r.slot),
             f"{r.layer_name}/{r.slot}") for r in owner_refs]
        self.fault: List[str] = list(fault_keys)

    # ------------------------------------------------------------------
    # the step's side (device tensors)

    def check_lanes(self, lanes: int):
        """Under the sweep's config axis every probe site must carry the
        lane axis: the cotangent of a blob no lane changes (a layer
        without params over data alone) is the sum over the lanes, not
        each lane's own."""
        if not lanes:
            return
        shared = [s for s in self.probe_sites if not self.laned[s]]
        if shared:
            raise NotImplementedError(
                f"debug_info over config lanes: the backward trace of "
                f"{shared} (blobs computed from the data alone, shared "
                "by every lane) has no per-lane cotangent in the "
                "PyTorch/CUDA package; unset debug_info and the "
                "watchdog for this net's sweep")

    def _blob_shape(self, blob: str, lanes: int) -> tuple:
        shape = tuple(self.net.blob_shapes[blob])
        if not lanes:
            return shape
        if shape == ():
            return (lanes,)
        return (shape[0], lanes * shape[1]) + shape[2:]

    def make_probes(self, lanes: int = 0, device=None) -> Dict[tuple,
                                                              torch.Tensor]:
        """Zero probes, one per consumed capture site, requiring grad:
        `Net.apply` adds each to its top where it is produced, so the
        gradient with respect to a probe is the blob's cotangent
        (summed over its readers)."""
        return {site: torch.zeros(self._blob_shape(site[1], lanes),
                                  dtype=torch.float32, device=device,
                                  requires_grad=True)
                for site in self.probe_sites}

    def _stack(self, vals, lanes: int, device) -> torch.Tensor:
        if not vals:
            return torch.zeros((lanes, 0) if lanes else (0,),
                               dtype=torch.float32, device=device)
        return torch.stack(vals, dim=-1)

    def forward_values(self, params, trace_sites, lanes: int = 0,
                       device=None) -> torch.Tensor:
        """ForwardDebugInfo's reductions: the per-site captures of
        computed and fed tops, then each layer's params; (entries,), or
        (lanes, entries)."""
        net = self.net
        vals = []
        for e in self.fwd:
            if e[0] == "top":
                vals.append(trace_sites[e[3]])
            else:
                _, lname, _, slot = e
                lp = net._gather_layer_params(params,
                                              net.layer_by_name[lname])
                vals.append(param_mean_abs(lp[slot], lanes))
        return self._stack(vals, lanes, device)

    def backward_values(self, probe_grads, grad_flat, lanes: int = 0,
                        device=None) -> torch.Tensor:
        """BackwardDebugInfo's reductions: bottom diffs from the probe
        cotangents, param diffs from the raw (pre-clip) gradients."""
        vals = []
        for e in self.bwd:
            if e[0] == "bottom":
                site = e[3]
                vals.append(blob_mean_abs(
                    probe_grads[site], lanes, True,
                    tuple(self.net.blob_shapes[site[1]]) == ()))
            else:
                vals.append(param_mean_abs(grad_flat[e[3]], lanes))
        return self._stack(vals, lanes, device)

    def values_for_keys(self, flat, keys, lanes: int = 0,
                        device=None) -> torch.Tensor:
        return self._stack([param_mean_abs(flat[k], lanes) for k in keys],
                           lanes, device)

    def update_keys(self):
        return [k for _, _, k in self.update]

    def all_param_norms(self, data_flat, grad_flat,
                        lanes: int = 0) -> torch.Tensor:
        """The "[Backward] All net params" totals over the owned
        learnable params: [L1 data, L1 diff, L2 data, L2 diff] (sums, as
        net.cpp accumulates asum and sumsq); (4,), or (lanes, 4)."""
        def red(t):
            return t.reshape(lanes, -1).sum(1) if lanes else t.sum()
        l1d = l1g = sqd = sqg = None
        for _, _, k in self.update:
            d = data_flat[k].detach().float()
            g = grad_flat[k].detach().float()
            terms = (red(d.abs()), red(g.abs()), red(d * d), red(g * g))
            if l1d is None:
                l1d, l1g, sqd, sqg = terms
            else:
                l1d, l1g, sqd, sqg = (l1d + terms[0], l1g + terms[1],
                                      sqd + terms[2], sqg + terms[3])
        return torch.stack([l1d, l1g, torch.sqrt(sqd), torch.sqrt(sqg)],
                           dim=-1)

    # ------------------------------------------------------------------
    # the host's side

    def _phase_entries(self, phase: str):
        return {"forward": self.fwd, "backward": self.bwd,
                "update": self.update, "fault": self.fault}[phase]

    def entry_name(self, phase: str, idx: int) -> str:
        """Human name of sentinel entry `idx` of `phase`, for the
        watchdog's diagnostic."""
        e = self._phase_entries(phase)[idx]
        if phase == "fault":
            return f"param {e}"
        if phase == "update":
            return f"layer {e[0]}, param {e[1]}"
        kind = e[0]
        if kind in ("top", "bottom"):
            return f"layer {e[1]}, {kind} blob {e[2]}"
        name = e[2] if kind == "param" else str(e[2])
        return f"layer {e[1]}, param blob {name}"

    def sentinel_summary(self, host_debug: dict) -> dict:
        """One iteration's (one lane's) host debug tree as {tripped,
        phase, entry, flags {nan, inf, overflow}, loss}: the watchdog's
        input and the sentinel record's payload."""
        sent = host_debug["sentinel"]
        for pi, phase in enumerate(PHASES):
            first = int(np.asarray(sent["first"])[pi])
            if first >= 0:
                return {"tripped": True, "phase": phase,
                        "entry": self.entry_name(phase, first),
                        "flags": {
                            "nan": bool(np.asarray(sent["nan"])[pi]),
                            "inf": bool(np.asarray(sent["inf"])[pi]),
                            "overflow": bool(np.asarray(sent["ovf"])[pi]),
                        },
                        "loss": float(host_debug["loss"])}
        return {"tripped": False, "phase": None, "entry": None,
                "flags": {"nan": False, "inf": False, "overflow": False},
                "loss": float(host_debug["loss"])}

    def trace_record(self, iteration: int, host_debug: dict) -> dict:
        """One `debug_trace` record of an iteration; the reference's
        lines regenerate from it (sink.debug_trace_lines)."""
        fwd, bwd = host_debug["fwd"], host_debug["bwd"]
        norms = host_debug["norms"]
        forward = [{"layer": e[1],
                    "kind": "top" if e[0] == "top" else "param",
                    "blob": str(e[2]), "value": float(v)}
                   for e, v in zip(self.fwd, fwd)]
        backward = [{"layer": e[1],
                     "kind": "bottom" if e[0] == "bottom" else "param",
                     "blob": str(e[2]), "value": float(v)}
                    for e, v in zip(self.bwd, bwd)]
        update = [{"layer": ly, "param": disp, "data": float(dv),
                   "diff": float(uv)}
                  for (ly, disp, _), dv, uv in zip(
                      self.update, host_debug["upd_data"],
                      host_debug["upd_diff"])]
        return {"schema_version": SCHEMA_VERSION, "type": "debug_trace",
                "iter": int(iteration), "wall_time": time.time(),
                "forward": forward, "backward": backward,
                "update": update,
                "params_l1": [float(norms[0]), float(norms[1])],
                "params_l2": [float(norms[2]), float(norms[3])]}

    def sentinel_record(self, iteration: int, summary: dict) -> dict:
        """A `sentinel` record: on a tripped sentinel, or on a
        non-finite loss with phase "loss" and no `entry`."""
        rec = {"schema_version": SCHEMA_VERSION, "type": "sentinel",
               "iter": int(iteration), "wall_time": time.time(),
               "phase": summary["phase"] or "loss",
               "nan": summary["flags"]["nan"],
               "inf": summary["flags"]["inf"],
               "overflow": summary["flags"]["overflow"],
               "loss": summary["loss"]}
        if summary["entry"] is not None:
            rec["entry"] = summary["entry"]
        return rec


def sentinel_tree(phase_vecs: Dict[str, torch.Tensor]) -> dict:
    """Numeric-health flags from the per-phase trace vectors (entries on
    the last axis; a leading lane axis rides through): nan / inf / ovf
    any-flags (int32 0/1) and `first`, the first bad entry of each
    phase or -1, each stacked over PHASES on the last axis."""
    nan_f, inf_f, ovf_f, first_f = [], [], [], []
    for phase in PHASES:
        v = phase_vecs[phase]
        n = v.shape[-1]
        nan = torch.isnan(v)
        inf = torch.isinf(v)
        ovf = torch.isfinite(v) & (v.abs() > OVERFLOW_LIMIT)
        bad = nan | inf | ovf
        idx = torch.arange(n, device=v.device).expand(bad.shape)
        first = torch.where(bad, idx, torch.full_like(idx, n)).amin(-1) \
            if n else torch.full(v.shape[:-1], n, dtype=torch.int64,
                                 device=v.device)
        nan_f.append(nan.any(-1).int())
        inf_f.append(inf.any(-1).int())
        ovf_f.append(ovf.any(-1).int())
        first_f.append(torch.where(first == n, torch.full_like(first, -1),
                                   first).int())
    return {"nan": torch.stack(nan_f, -1), "inf": torch.stack(inf_f, -1),
            "ovf": torch.stack(ovf_f, -1),
            "first": torch.stack(first_f, -1)}
