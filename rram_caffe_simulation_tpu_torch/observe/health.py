"""Crossbar health plane: the wear census and the host-side wear ledger
(counterpart of the reference package's observe/health.py).

1. `CensusProgram`: a census of the resident fault state, f32 or packed
   (read through `fault/packed.py unpacked_view`), run on the state's
   device every `health_every` iterations, apart from the train step
   (arming it changes no result): per-(param, tile) remaining-lifetime
   histograms over fixed log-spaced bins, broken fraction, mean
   lifetime and the stuck values of the broken cells
   (`fault/mapping.py per_tile_health`), and the drift-age distribution
   (`per_tile_ages`), each process of the stack contributing its own
   (its `health` hook). Under the sweep's stacked state every stat
   carries a leading per-lane axis. Its result is the `params` payload of a `health`
   record (sink.make_health_record), fetched in one transfer.

2. `HealthLedger`: plain Python over `health` records: per-(config,
   param, tile) wear-rate trends, a write-traffic estimate and a
   remaining-useful-life forecast, iterations until a tile's broken
   fraction crosses `threshold` ("trend" from >= 2 censuses, "bin" from
   one: the nearest lifetime-histogram edge over the write quantum).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: remaining-lifetime bin edges (cell writes remaining). Bin 0 = (-inf,
#: 0] (broken), bin i = (edges[i-1], edges[i]], the last bin beyond 1e8.
LIFE_EDGES = (1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8)

#: drift-age bin edges (iterations since the last write). Bin 0 = age
#: <= 0.
AGE_EDGES = (1e1, 1e2, 1e3, 1e4, 1e5)

#: the broken fraction the RUL forecast projects to by default
RUL_THRESHOLD = 0.3

#: census samples the ledger keeps per (config, param, tile)
LEDGER_HISTORY = 64


class CensusProgram:
    """The wear census over one fault-state structure: `stack` is the
    fault-process stack (fault/processes/ ProcessStack, which carries
    the tile spec), `stacked` whether the leaves carry a leading config
    axis, `pack_spec` the packed banks' spec (None for f32). Calling it
    returns the host-side `params` payload: {param: {"grid": [gr, gc],
    "cells": [...], stat: nested lists}}."""

    def __init__(self, stack, stacked: bool = False, pack_spec=None):
        self.stack = stack
        self.stacked = bool(stacked)
        self.pack_spec = pack_spec

    def stats(self, state) -> dict:
        """{param: {stat: tensor}} on the state's device."""
        from ..fault import packed as fault_packed
        if "life_q" in state:
            state = fault_packed.unpacked_view(state, self.pack_spec)
        lead = 1 if self.stacked else 0
        ndims = {}
        for group in state.values():
            for k, v in group.items():
                ndims.setdefault(k, v.dim() - lead)
        return self.stack.health(state, state.get("lifetimes", {}),
                                 state.get("stuck", {}),
                                 {"life": LIFE_EDGES, "age": AGE_EDGES},
                                 ndims)

    def __call__(self, state) -> dict:
        from ..fault import mapping as fault_mapping
        from . import counters
        stats = counters.to_host(self.stats(state))
        lead = 1 if self.stacked else 0
        shapes = {}
        for group, leaves in state.items():
            if group == "stuck_bits":
                continue        # four cells a byte; life_q covers them
            for k, v in leaves.items():
                shapes.setdefault(k, tuple(v.shape[lead:]))
        out = {}
        for name, st in stats.items():
            grid, _, cells = fault_mapping.health_tiles(shapes[name],
                                                        self.stack.tiles)
            entry = {"grid": [int(grid[0]), int(grid[1])],
                     "cells": [int(c) for c in cells]}
            entry.update(st)
            out[name] = entry
        return out


def _slope(samples: List[Tuple[int, float]]) -> float:
    """Least-squares slope of (iter, value) samples; 0.0 when
    degenerate."""
    n = len(samples)
    if n < 2:
        return 0.0
    mx = sum(s[0] for s in samples) / n
    my = sum(s[1] for s in samples) / n
    den = sum((s[0] - mx) ** 2 for s in samples)
    if den <= 0:
        return 0.0
    return sum((s[0] - mx) * (s[1] - my) for s in samples) / den


class HealthLedger:
    """Wear ledger over a stream of `health` records, keyed (config,
    param, tile): config -1 for a single run; under a sweep `lane_map`
    names each lane's config."""

    def __init__(self, threshold: float = RUL_THRESHOLD,
                 history: int = LEDGER_HISTORY):
        self.threshold = float(threshold)
        self.history = max(int(history), 2)
        #: (config, param, tile) -> [(iter, broken_frac, life_mean)]
        self._series: Dict[tuple, list] = {}
        #: (config, param, tile) -> {"cells", "grid", "life_hist"}
        self._meta: Dict[tuple, dict] = {}
        self._decrement = 1.0
        self._life_edges: tuple = tuple(LIFE_EDGES)
        self._censuses = 0

    def update(self, rec: dict):
        """Ingest one `health` record (other records are ignored, so a
        whole metrics stream can be fed)."""
        if not isinstance(rec, dict) or rec.get("type") != "health":
            return
        it = int(rec.get("iter", 0))
        dec = rec.get("decrement")
        if isinstance(dec, (int, float)) and dec > 0:
            self._decrement = float(dec)
        edges = rec.get("life_edges")
        if isinstance(edges, list) and edges:
            self._life_edges = tuple(float(e) for e in edges)
        lane_map = rec.get("lane_map")
        self._censuses += 1
        for pname, st in (rec.get("params") or {}).items():
            if not isinstance(st, dict):
                continue
            bf, lm = st.get("broken_frac"), st.get("life_mean")
            if not isinstance(bf, list):
                continue
            hist = st.get("life_hist")
            cells = st.get("cells")
            grid = st.get("grid")
            if lane_map is None:
                self._ingest(-1, pname, it, bf, lm, hist, cells, grid)
                continue
            for lane, cfg in enumerate(lane_map):
                if cfg < 0 or lane >= len(bf):
                    continue
                self._ingest(int(cfg), pname, it, bf[lane],
                             lm[lane] if isinstance(lm, list) else None,
                             hist[lane] if isinstance(hist, list)
                             else None, cells, grid)

    def _ingest(self, cfg, pname, it, bf, lm, hist, cells, grid):
        if not isinstance(bf, list):
            return
        for t, frac in enumerate(bf):
            key = (cfg, pname, t)
            series = self._series.setdefault(key, [])
            sample = (it, float(frac),
                      float(lm[t]) if isinstance(lm, list) else None)
            # a resumed stream may repeat the census at the restore
            # iteration: one sample
            if series and series[-1][0] == it:
                series[-1] = sample
            else:
                series.append(sample)
            del series[:-self.history]
            meta = self._meta.setdefault(key, {})
            if isinstance(cells, list) and t < len(cells):
                meta["cells"] = int(cells[t])
            if isinstance(grid, list):
                meta["grid"] = list(grid)
            if isinstance(hist, list) and t < len(hist):
                meta["life_hist"] = list(hist[t])

    def forecast(self, threshold: Optional[float] = None) -> list:
        """Per-(config, param, tile) rows, worst first: broken fraction
        now, wear rate (d broken_frac / d iter), write rate (from the
        life_mean trend) and `rul_iters`, the iterations until the
        broken fraction crosses the threshold (None: no wear seen)."""
        th = self.threshold if threshold is None else float(threshold)
        rows = []
        for key in sorted(self._series):
            cfg, pname, tile = key
            series = self._series[key]
            it, bf, lm = series[-1]
            rate = _slope([(s[0], s[1]) for s in series])
            lm_rate = _slope([(s[0], s[2]) for s in series
                              if s[2] is not None])
            write_rate = (-lm_rate / self._decrement
                          if lm_rate < 0 else 0.0)
            rul = method = None
            if bf >= th:
                rul, method = 0.0, "trend"
            elif len(series) >= 2:
                if rate > 0:
                    rul, method = (th - bf) / rate, "trend"
            else:
                rul = self._bin_rul(key, th)
                if rul is not None:
                    method = "bin"
            rows.append({
                "config": cfg, "param": pname, "tile": tile,
                "iter": it, "broken_frac": bf,
                "wear_rate": rate, "write_rate": write_rate,
                "rul_iters": rul, "method": method,
            })
        rows.sort(key=lambda r: (r["rul_iters"]
                                 if r["rul_iters"] is not None
                                 else float("inf"), -r["broken_frac"]))
        return rows

    def _bin_rul(self, key, th) -> Optional[float]:
        """Single-census forecast: the smallest histogram edge below
        which more than `th` of the tile's cells sit, over the write
        quantum."""
        meta = self._meta.get(key, {})
        hist = meta.get("life_hist")
        cells = meta.get("cells")
        if not hist or not cells:
            return None
        cum = 0
        for b, count in enumerate(hist):
            cum += count
            if cum / max(cells, 1) > th:
                if b == 0:
                    return 0.0
                edge = self._life_edges[min(b - 1,
                                            len(self._life_edges) - 1)]
                return edge / self._decrement
        return None

    def summary(self) -> Optional[dict]:
        """Census count, worst broken fraction, fastest wear rate and
        the least RUL over every (config, param, tile); None before the
        first census."""
        rows = self.forecast()
        if not rows:
            return None
        ruls = [r["rul_iters"] for r in rows
                if r["rul_iters"] is not None]
        return {
            "censuses": self._censuses,
            "configs": len({r["config"] for r in rows}),
            "tiles": len(rows),
            "broken_frac_max": round(
                max(r["broken_frac"] for r in rows), 6),
            "wear_rate_max": round(
                max(r["wear_rate"] for r in rows), 10),
            "rul_iters_min": (round(min(ruls), 2) if ruls else None),
        }

    def worst_tiles(self, n: int = 8) -> list:
        """The n worst forecast rows."""
        return self.forecast()[:max(int(n), 0)]
