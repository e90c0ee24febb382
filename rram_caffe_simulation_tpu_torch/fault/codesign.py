"""Hardware co-design sweeps: joint axes over fault physics and hardware
knobs, reduced to Pareto fronts (the reference package's
fault/codesign.py, copied whole).

The sweep explores the per-config (mean, std) lifetime grid in one
runner; this module adds the axes that change the step itself (the
fault-process mix of fault/processes/, the crossbar read-noise sigma and
ADC resolution, the mitigation strategy, the tile mapping) and reduces
the per-config records to a co-design answer, the Pareto front of a
quality metric against a hardware-cost metric.

- `expand_grid(axes)`: the cartesian config grid, each entry a flat dict
  of axis values.
- `group_static(configs)`: buckets the grid by the STATIC axes
  (process, sigma, adc_bits, strategy, tiles): each bucket is one
  SweepRunner whose (mean, std) entries are its lanes.
- `pareto_front(records, metric_x, metric_y)`: the non-dominated subset
  (both metrics minimized unless `maximize_*`), over plain dicts.
- `make_report(...)`: the `pareto_report.json` payload of the
  `run_codesign.py` driver.

Plain Python and json: analysis tooling loads results without torch.
"""
from __future__ import annotations

import itertools
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: axes whose values change the step: one SweepRunner per distinct
#: combination; everything else rides the config lanes. "tiles" is the
#: crossbar-mapping axis (fault/mapping.py TileSpec): the tile grid
#: decides both the fault draw and the per-tile ADC structure of the
#: read.
STATIC_AXES = ("process", "sigma", "adc_bits", "strategy", "tiles")

#: per-lane axes (the Monte-Carlo lifetime-distribution grid)
LANE_AXES = ("mean", "std")


def _tiles_canonical(v) -> str:
    """Canonicalize a tiles axis value so equivalent spellings bucket
    together. A malformed spec raises (mapping.canonical is loud): a
    corrupted axis value must not become a plausible-looking bucket in
    the report. Imported here, so loading this module needs no torch."""
    from .mapping import canonical
    return canonical(v)


def expand_grid(axes: Dict[str, Sequence]) -> List[dict]:
    """Cartesian product of the given axes: {axis: [values]} -> one
    flat dict per combination. Unknown axis names are carried through
    verbatim (they land in the result records untouched)."""
    if not axes:
        return []
    names = sorted(axes)
    for n in names:
        vals = axes[n]
        if not isinstance(vals, (list, tuple)) or not len(vals):
            raise ValueError(f"co-design axis {n!r} needs a non-empty "
                             f"list of values, got {vals!r}")
    return [dict(zip(names, combo))
            for combo in itertools.product(*(axes[n] for n in names))]


def static_key(cfg: dict) -> Tuple:
    """The step-identity of a config: its static-axis values (absent
    axes read as their neutral defaults)."""
    return (str(cfg.get("process", "endurance_stuck_at")),
            float(cfg.get("sigma", 0.0) or 0.0),
            int(cfg.get("adc_bits", 0) or 0),
            str(cfg.get("strategy", "none") or "none"),
            _tiles_canonical(cfg.get("tiles", "1x1") or "1x1"))


def group_static(configs: Iterable[dict]) -> Dict[Tuple, List[dict]]:
    """Bucket a config grid by `static_key`: each bucket is one sweep
    whose entries differ only along the lane axes."""
    groups: Dict[Tuple, List[dict]] = {}
    for cfg in configs:
        groups.setdefault(static_key(cfg), []).append(dict(cfg))
    return groups


def _metric(rec: dict, name: str) -> Optional[float]:
    v = rec.get(name)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    v = float(v)
    if v != v:                      # NaN never dominates anything
        return None
    return v


def pareto_front(records: Sequence[dict], metric_x: str, metric_y: str,
                 maximize_x: bool = False, maximize_y: bool = False
                 ) -> Tuple[List[dict], int]:
    """The non-dominated subset of `records` under (metric_x,
    metric_y), both minimized unless `maximize_*`. Records missing
    either metric (or carrying NaN — a failed config) are excluded
    from the comparison entirely. Returns (front sorted by metric_x,
    dominated_count). Ties: a record equal on both metrics to a front
    member joins the front (it is not dominated)."""
    pts = []
    for rec in records:
        x, y = _metric(rec, metric_x), _metric(rec, metric_y)
        if x is None or y is None:
            continue
        pts.append((x if not maximize_x else -x,
                    y if not maximize_y else -y, rec))
    front = []
    dominated = 0
    for x, y, rec in pts:
        if any(ox <= x and oy <= y and (ox < x or oy < y)
               for ox, oy, _ in pts):
            dominated += 1
        else:
            front.append((x, y, rec))
    front.sort(key=lambda p: (p[0], p[1]))
    return [rec for _, _, rec in front], dominated


def load_results(path: str) -> List[dict]:
    """Per-config result records from a JSONL file (one object per
    line; blank lines skipped) — the driver's results.jsonl, or any
    sweep metrics log whose records carry the chosen metrics."""
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


def _axis_distinct(records: Sequence[dict], name: str) -> set:
    """The distinct values an axis takes across records (tiles values
    canonicalized; absent = not counted)."""
    vals = set()
    for r in records:
        if name in r:
            v = r[name]
            vals.add(_tiles_canonical(v) if name == "tiles" else
                     (str(v) if not isinstance(v, (int, float)) else v))
    return vals


def collapsed_axes(records: Sequence[dict], front: Sequence[dict],
                   axes: Optional[dict] = None) -> List[str]:
    """Which design axes COLLAPSED on the Pareto front: axes that were
    actually swept (more than one distinct value across the evaluated
    records) but whose front members all share one value — the named
    culprits behind a degenerate front ("widen THIS axis"). Considers
    the declared `axes` when given, else every known static + lane
    axis present in the records."""
    names = (sorted(axes) if axes
             else [n for n in STATIC_AXES + LANE_AXES
                   if any(n in r for r in records)])
    out = []
    for n in names:
        swept = _axis_distinct(records, n)
        on_front = _axis_distinct(front, n)
        if len(swept) > 1 and len(on_front) <= 1:
            out.append(n)
    return out


def make_report(records: Sequence[dict], metric_x: str, metric_y: str,
                maximize_x: bool = False, maximize_y: bool = False,
                axes: Optional[dict] = None) -> dict:
    """The `pareto_report.json` payload: the front (full records, best
    metric_x first), the dominated count, and a degeneracy verdict —
    `degenerate` is True when the front collapses to a single point
    (or fewer), with `collapsed_axes` NAMING the swept axes whose
    values all fell off the front (the axes to widen). Each front
    record's `tiles` value (when present) is recorded in canonical
    TileSpec form under `front_tiles` so the winning crossbar mappings
    read off the report directly."""
    front, dominated = pareto_front(records, metric_x, metric_y,
                                    maximize_x, maximize_y)
    distinct = {( _metric(r, metric_x), _metric(r, metric_y))
                for r in front}
    report = {
        "schema_version": 2,
        "metric_x": metric_x, "metric_y": metric_y,
        "maximize_x": bool(maximize_x), "maximize_y": bool(maximize_y),
        "evaluated": len(records),
        "dominated": dominated,
        "front_size": len(front),
        "degenerate": len(distinct) < 2,
        "collapsed_axes": collapsed_axes(records, front, axes),
        "front": list(front),
    }
    if any("tiles" in r for r in front):
        report["front_tiles"] = [
            _tiles_canonical(r.get("tiles", "1x1")) for r in front]
    if axes:
        report["axes"] = {k: list(v) for k, v in axes.items()}
    return report
