"""Tiled crossbar mapping (counterpart of the reference package's
fault/mapping.py): a layer's weight matrix spread over bounded physical
crossbar tiles, each with its own fault draw and its own ADC.

- `TileSpec`: "1x1" (one tile per matrix, the untiled program), "GRxGC"
  (at most GR x GC tiles per matrix) or "cells=RxC" (tiles of at most
  R x C cells). Geometry is defined over the crossbar view of a stored
  weight: the stored 2-D shape of an InnerProduct weight, the im2col
  (K, N) = (C_in*kh*kw, C_out) view of a conv kernel.
- `to_im2col` / `from_im2col`: the exact reshapes between a stored
  (..., C_out, C_in, kh, kw) kernel and its (..., K, N) view (numpy
  arrays and tensors alike; leading config axes ride through).
- `conv_geom`, `im2col_index_plan`, `pad_activation_flat`,
  `conv_patch_rows`: the conv GEMM's operand. Patch row m = (n, oh, ow),
  feature kk = c*(kh*kw) + r*kw + s (channel-major, `F.unfold`'s order),
  and element (m, kk) is `xflat[row_base[m] + col_off[kk]]` of the
  zero-padded, flattened NCHW activation.
- `tiled_draw`: one parameter's draw assembled tile by tile, tile-major,
  tile t drawn from the threefry key folded with t (as the reference).
- The per-tile census: `per_tile_counters` (the metrics record's
  `fault.per_tile`), `health_tiles`, `log_histogram`, `per_tile_health`
  and `per_tile_ages` (the `health` record's). Counts and histograms
  are integer sums (torch.bucketize over the fixed edges, then an
  integer bincount), equal to the reference's; leading config axes ride
  through, so a sweep's stacked leaves give per-lane vectors.
"""
from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng

#: hard cap on tiles per layer (the per-tile draw loops over tiles)
MAX_TILES_PER_LAYER = 4096
#: the canonical spec of every untiled program
DEFAULT_TILES = "1x1"

_GRID_RE = re.compile(r"^(\d+)x(\d+)$")
_CELLS_RE = re.compile(r"^cells=(\d+)x(\d+)$")


class TileSpec:
    """A parsed tile-mapping selection: `mode` "grid" (a, b bound the
    per-layer tile grid) or "cells" (a, b bound the cells per tile).
    Compared by `canonical()`."""

    def __init__(self, mode: str, a: int, b: int):
        if mode not in ("grid", "cells"):
            raise ValueError(f"unknown TileSpec mode {mode!r}")
        a, b = int(a), int(b)
        if a < 1 or b < 1:
            raise ValueError(f"TileSpec dims must be >= 1, got {a}x{b}")
        if mode == "grid" and a * b > MAX_TILES_PER_LAYER:
            raise ValueError(
                f"TileSpec grid {a}x{b} exceeds {MAX_TILES_PER_LAYER} "
                "tiles per layer")
        self.mode, self.a, self.b = mode, a, b

    @classmethod
    def parse(cls, text) -> "TileSpec":
        if isinstance(text, TileSpec):
            return text
        if text is None or not str(text).strip():
            text = DEFAULT_TILES
        text = str(text).strip().lower()
        m = _GRID_RE.match(text)
        if m:
            return cls("grid", int(m.group(1)), int(m.group(2)))
        m = _CELLS_RE.match(text)
        if m:
            return cls("cells", int(m.group(1)), int(m.group(2)))
        raise ValueError(
            f"bad tile spec {text!r}: expected 'GRxGC' (a per-layer "
            "tile grid, e.g. '2x4'; '1x1' = untiled) or 'cells=RxC' "
            "(cells per tile, e.g. 'cells=256x256')")

    def canonical(self) -> str:
        if self.mode == "cells":
            return f"cells={self.a}x{self.b}"
        return f"{self.a}x{self.b}"

    @property
    def is_default(self) -> bool:
        """The 1x1 grid: every layer one tile, the untiled program."""
        return self.mode == "grid" and self.a == 1 and self.b == 1

    def tile_dims(self, shape) -> Tuple[int, int]:
        """Cells per tile (tr, tc) over the crossbar view of a stored
        shape; grid form ceil-divides the dims, cells form clamps to the
        matrix."""
        shape = crossbar_view_shape(shape)
        if len(shape) != 2:
            raise ValueError(
                f"tile_dims is defined over >=2-D shapes, got {shape}")
        d0, d1 = shape
        if self.mode == "cells":
            return min(self.a, d0), min(self.b, d1)
        return -(-d0 // min(self.a, d0)), -(-d1 // min(self.b, d1))

    def grid(self, shape) -> Tuple[int, int]:
        """The effective tile grid (gr, gc) of a stored shape; 1-D
        shapes (biases) are one tile."""
        shape = crossbar_view_shape(shape)
        if len(shape) != 2:
            return (1, 1)
        tr, tc = self.tile_dims(shape)
        gr, gc = -(-shape[0] // tr), -(-shape[1] // tc)
        if gr * gc > MAX_TILES_PER_LAYER:
            raise ValueError(
                f"tile spec {self.canonical()!r} maps shape {shape} onto "
                f"{gr}x{gc} = {gr * gc} tiles, over the "
                f"{MAX_TILES_PER_LAYER}-tile per-layer cap; use bigger "
                "tiles")
        return gr, gc

    def n_tiles(self, shape) -> int:
        gr, gc = self.grid(shape)
        return gr * gc

    def bounds(self, shape):
        """([row (lo, hi)...], [col (lo, hi)...]) over the crossbar
        view."""
        shape = crossbar_view_shape(shape)
        tr, tc = self.tile_dims(shape)
        return split_bounds(shape[0], tr), split_bounds(shape[1], tc)

    def tile_slices(self, shape):
        """(tile_index, (r0, r1, c0, c1)) in tile-major order."""
        rb, cb = self.bounds(shape)
        t = 0
        for (r0, r1) in rb:
            for (c0, c1) in cb:
                yield t, (r0, r1, c0, c1)
                t += 1

    def __eq__(self, other):
        return (isinstance(other, TileSpec)
                and self.canonical() == other.canonical())

    def __hash__(self):
        return hash(self.canonical())

    def __repr__(self):
        return f"TileSpec({self.canonical()!r})"


def split_bounds(n: int, t: int) -> List[Tuple[int, int]]:
    """Ceil-split [0, n) into blocks of at most t cells."""
    return [(lo, min(n, lo + t)) for lo in range(0, n, t)]


def canonical(text) -> str:
    return TileSpec.parse(text).canonical()


# ---------------------------------------------------------------------------
# the conv im2col crossbar view

def im2col_shape(shape) -> Tuple[int, int]:
    """(K, N) view dims of a stored >2-D conv kernel shape."""
    if len(shape) <= 2:
        raise ValueError(f"im2col_shape is defined over >2-D conv kernels, "
                         f"got {tuple(shape)}")
    return int(np.prod([int(d) for d in shape[1:]])), int(shape[0])


def crossbar_view_shape(shape) -> Tuple[int, ...]:
    """The 2-D shape tile geometry is defined over."""
    if len(shape) > 2:
        return im2col_shape(shape)
    return tuple(int(d) for d in shape)


def to_im2col(arr, param_ndim=None):
    """(..., C_out, C_in, kh, kw) -> its (..., K, N) view; `param_ndim`
    is the stored rank (default all of arr's), leading axes ride
    through."""
    nd = arr.ndim if param_ndim is None else int(param_ndim)
    lead = tuple(arr.shape[:arr.ndim - nd])
    return arr.reshape(lead + (int(arr.shape[arr.ndim - nd]), -1)) \
        .swapaxes(-1, -2)


def from_im2col(view, shape):
    """Inverse of `to_im2col`: (..., K, N) back to the stored shape."""
    shape = tuple(int(d) for d in shape)
    lead = tuple(view.shape[:view.ndim - 2])
    return view.swapaxes(-1, -2).reshape(lead + shape)


# ---------------------------------------------------------------------------
# the conv GEMM's operand

def conv_geom(kernel, stride, pad, dilation) -> Tuple[int, ...]:
    """The static 2-D conv geometry (kh, kw, sh, sw, ph, pw, dh, dw)."""
    if len(kernel) != 2 or len(stride) != 2 or len(pad) != 2 \
            or len(dilation) != 2:
        raise ValueError(
            f"implicit im2col needs 2-D spatial geometry, got "
            f"kernel={tuple(kernel)} stride={tuple(stride)} "
            f"pad={tuple(pad)} dilation={tuple(dilation)}")
    return (int(kernel[0]), int(kernel[1]), int(stride[0]), int(stride[1]),
            int(pad[0]), int(pad[1]), int(dilation[0]), int(dilation[1]))


def im2col_index_plan(x_shape, geom):
    """The implicit-im2col address plan of an NCHW activation of shape
    `x_shape` under `geom`: (row_base, col_off, m, k, padded_shape),
    int32 vectors of M = N*OH*OW and K = C*kh*kw entries with
    element (m, kk) at flat offset row_base[m] + col_off[kk] of the
    activation zero-padded to padded_shape."""
    n, c, h, w = (int(d) for d in x_shape)
    kh, kw, sh, sw, ph, pw, dh, dw = geom
    hp, wp = h + 2 * ph, w + 2 * pw
    oh = (hp - (dh * (kh - 1) + 1)) // sh + 1
    ow = (wp - (dw * (kw - 1) + 1)) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"implicit im2col: empty output window for "
                         f"x={tuple(x_shape)} geom={geom}")
    base_n = np.arange(n, dtype=np.int64) * (c * hp * wp)
    base_oh = np.arange(oh, dtype=np.int64) * (sh * wp)
    base_ow = np.arange(ow, dtype=np.int64) * sw
    row_base = (base_n[:, None, None] + base_oh[None, :, None]
                + base_ow[None, None, :]).reshape(-1)
    off_c = np.arange(c, dtype=np.int64) * (hp * wp)
    off_r = np.arange(kh, dtype=np.int64) * (dh * wp)
    off_s = np.arange(kw, dtype=np.int64) * dw
    col_off = (off_c[:, None, None] + off_r[None, :, None]
               + off_s[None, None, :]).reshape(-1)
    if int(row_base[-1] + col_off[-1]) >= n * c * hp * wp:
        raise AssertionError("implicit im2col plan addresses out of range")
    if n * c * hp * wp > 2 ** 31 - 1:
        raise ValueError(f"implicit im2col: one activation of "
                         f"{n * c * hp * wp} elements overflows the int32 "
                         "plan")
    return (row_base.astype(np.int32), col_off.astype(np.int32),
            n * oh * ow, c * kh * kw, (n, c, hp, wp))


def pad_activation_flat(x: torch.Tensor, geom) -> torch.Tensor:
    """Zero-pad an NCHW activation spatially and flatten its trailing 4
    dims; a leading config axis rides through ((C, N, ch, H, W) ->
    (C, F))."""
    ph, pw = geom[4], geom[5]
    return F.pad(x, (pw, pw, ph, ph)).reshape(
        tuple(x.shape[:x.dim() - 4]) + (-1,))


def conv_patch_rows(x: torch.Tensor, geom) -> torch.Tensor:
    """The (N*OH*OW, C*kh*kw) im2col patch rows of an NCHW activation
    (an exact gather, `F.unfold`); a per-lane (C, N, ch, H, W) input
    gives (C, N*OH*OW, K)."""
    kh, kw, sh, sw, ph, pw, dh, dw = geom
    lead = tuple(x.shape[:x.dim() - 4])
    n, c, h, w = x.shape[-4:]
    cols = F.unfold(x.reshape((-1, c, h, w)), (kh, kw), dilation=(dh, dw),
                    padding=(ph, pw), stride=(sh, sw))     # (B, K, L)
    k, L = cols.shape[1], cols.shape[2]
    return cols.reshape(lead + (n, k, L)).transpose(-1, -2).reshape(
        lead + (n * L, k))


# ---------------------------------------------------------------------------
# per-(layer, tile) independent draws

def tiled_draw(key, shape, tiles, draw_fn):
    """One parameter's draw tile by tile (the reference's tiled_draw):
    tile t of the crossbar view, tile-major, is `draw_fn(fold_in(key,
    t), block_shape)`, the blocks assembled back into the stored shape
    (conv kernels in view layout, then `from_im2col`). A single tile (no
    spec, the default spec, a 1-D shape, a matrix one tile covers) is
    `draw_fn(key, shape)` with the unfolded key. `key` may be a batch of
    keys (C, 2); the draw then carries a leading C axis."""
    shape = tuple(int(d) for d in shape)
    grid = ((1, 1) if tiles is None or len(shape) < 2
            else tiles.grid(shape))
    if grid[0] * grid[1] == 1:
        return draw_fn(key, shape)
    rb, cb = tiles.bounds(shape)
    rows, t = [], 0
    for r0, r1 in rb:
        blocks = []
        for c0, c1 in cb:
            blocks.append(draw_fn(prng.fold_in(key, t), (r1 - r0, c1 - c0)))
            t += 1
        rows.append(torch.cat(blocks, dim=-1))
    out = torch.cat(rows, dim=-2)
    return from_im2col(out, shape).contiguous() if len(shape) > 2 else out


# ---------------------------------------------------------------------------
# the per-tile census (the observe `fault.per_tile` block and the
# `health` record's sensor core)

def _frac(count: torch.Tensor, cells: int) -> torch.Tensor:
    """count / cells in f32 as the reference's jitted mean computes it:
    the f32 count times the f32 reciprocal."""
    return count.float() * float(np.float32(1) / np.float32(cells))


def per_tile_counters(life: torch.Tensor, stuck: torch.Tensor,
                      tiles: TileSpec, lanes: int = 0) -> dict:
    """Per-tile census of ONE >=2-D fault leaf (a leading C axis under
    `lanes`): broken-cell fraction, minimum remaining lifetime, and how
    many broken cells read -1 / 0 / +1, per tile of the crossbar view
    (a conv kernel over its im2col (K, N) view, whose dims ride as
    "view"). Returns {"grid", "broken_frac", "life_min", "stuck_neg",
    "stuck_zero", "stuck_pos"[, "view"]}, tile-major, each with the
    lane axis first under lanes."""
    nd = life.dim() - (1 if lanes else 0)
    view = None
    if nd > 2:
        view = im2col_shape(tuple(life.shape[life.dim() - nd:]))
        life, stuck = to_im2col(life, nd), to_im2col(stuck, nd)
    shape = tuple(life.shape[-2:])
    gr, gc = tiles.grid(shape)
    cols = {k: [] for k in ("broken_frac", "life_min", "stuck_neg",
                            "stuck_zero", "stuck_pos")}
    for _, (r0, r1, c0, c1) in tiles.tile_slices(shape):
        lt = life[..., r0:r1, c0:c1]
        st = stuck[..., r0:r1, c0:c1]
        broken = lt <= 0
        cols["broken_frac"].append(
            _frac(broken.sum((-2, -1)), (r1 - r0) * (c1 - c0)))
        cols["life_min"].append(lt.amin((-2, -1)).float())
        cols["stuck_neg"].append((broken & (st == -1.0)).sum((-2, -1)))
        cols["stuck_zero"].append((broken & (st == 0.0)).sum((-2, -1)))
        cols["stuck_pos"].append((broken & (st == 1.0)).sum((-2, -1)))
    lead = tuple(life.shape[:-2])

    def const(vals):
        # host geometry: a CPU tensor, so the step copies nothing over
        return torch.tensor(vals, dtype=torch.int64).expand(
            lead + (len(vals),))
    out = {"grid": const([gr, gc])}
    out.update({k: torch.stack(v, dim=-1) for k, v in cols.items()})
    if view is not None:
        out["view"] = const(list(view))
    return out


def health_tiles(shape, tiles) -> Tuple[Tuple[int, int], list, List[int]]:
    """Tile enumeration of the wear census over one STORED param shape:
    ((gr, gc), [(r0, r1, c0, c1) or None per tile], [cells per tile]).
    >=2-D shapes follow the TileSpec grid (None or the default: one
    tile), conv kernels over their im2col view; 1-D targets (biases)
    are one tile."""
    if len(shape) >= 2 and tiles is not None and not tiles.is_default:
        grid = tiles.grid(shape)
        sls = [sl for _, sl in tiles.tile_slices(shape)]
        cells = [(r1 - r0) * (c1 - c0) for r0, r1, c0, c1 in sls]
        return grid, sls, cells
    return (1, 1), [None], [int(np.prod([int(d) for d in shape]))]


def _tile_view(arr, sl, param_ndim):
    """One tile of `arr` (leading axes ride through)."""
    if sl is None or param_ndim != 2:
        return arr
    r0, r1, c0, c1 = sl
    return arr[..., r0:r1, c0:c1]


def log_histogram(x: torch.Tensor, edges, axes) -> torch.Tensor:
    """Counts of `x` over the census's fixed bins, on a new last axis:
    bin 0 = (-inf, 0], bin i = (edges[i-1], edges[i]] with a leading
    edge of 0, the last bin beyond the top edge; len(edges) + 2 bins.
    torch.bucketize (right=False: the number of edges strictly below a
    value, the reference's sum of `x > edge`) and an integer bincount,
    int64."""
    bounds = torch.tensor([0.0] + [float(e) for e in edges],
                          dtype=x.dtype, device=x.device)
    nb = len(bounds) + 1
    nax = len(axes)
    lead = tuple(x.shape[:x.dim() - nax])
    cells = int(np.prod([int(d) for d in x.shape[x.dim() - nax:]]))
    idx = torch.bucketize(x.contiguous(), bounds, right=False)
    idx = idx.reshape(-1, cells)
    rows = idx.shape[0]
    idx = idx + torch.arange(rows, device=x.device).unsqueeze(1) * nb
    counts = torch.bincount(idx.reshape(-1), minlength=rows * nb)
    return counts.reshape(lead + (nb,))


def per_tile_health(life: torch.Tensor, stuck: torch.Tensor, tiles, edges,
                    param_ndim: int) -> dict:
    """Per-tile wear census of ONE lifetime-bearing fault leaf:
    remaining-lifetime histogram over `edges` (`log_histogram`; bin 0 =
    broken), broken fraction, mean remaining lifetime, and the stuck
    values of the broken cells. `param_ndim` is the STORED rank (2 =
    a crossbar matrix on the tile grid, > 2 = a conv kernel on the grid
    over its im2col view, 1 = one tile); leading axes ride through.
    Returns {"life_hist": [..., T, B], "broken_frac"/"life_mean": f32
    [..., T], "stuck_neg"/"stuck_zero"/"stuck_pos": [..., T]},
    tile-major; the geometry comes from `health_tiles`."""
    if param_ndim > 2:
        life = to_im2col(life, param_ndim)
        stuck = to_im2col(stuck, param_ndim)
        param_ndim = 2
    shape = tuple(life.shape[life.dim() - param_ndim:])
    _, sls, cells = health_tiles(shape, tiles if param_ndim == 2 else None)
    axes = (-2, -1) if param_ndim == 2 else (-1,)
    cols = {k: [] for k in ("life_hist", "broken_frac", "life_mean",
                            "stuck_neg", "stuck_zero", "stuck_pos")}
    for sl, n in zip(sls, cells):
        lt = _tile_view(life, sl, param_ndim)
        st = _tile_view(stuck, sl, param_ndim)
        broken = lt <= 0
        cols["life_hist"].append(log_histogram(lt, edges, axes))
        cols["broken_frac"].append(_frac(broken.sum(axes), n))
        cols["life_mean"].append(lt.float().mean(axes))
        cols["stuck_neg"].append((broken & (st == -1.0)).sum(axes))
        cols["stuck_zero"].append((broken & (st == 0.0)).sum(axes))
        cols["stuck_pos"].append((broken & (st == 1.0)).sum(axes))
    return {k: torch.stack(v, dim=-2 if k == "life_hist" else -1)
            for k, v in cols.items()}


def per_tile_ages(age: torch.Tensor, tiles, edges, param_ndim: int) -> dict:
    """Per-tile drift-age distribution of ONE age leaf (iterations since
    the last write): the age histogram over `edges` (bin 0 = age <= 0),
    mean and max age per tile; the layout of `per_tile_health`."""
    if param_ndim > 2:
        age = to_im2col(age, param_ndim)
        param_ndim = 2
    shape = tuple(age.shape[age.dim() - param_ndim:])
    _, sls, _ = health_tiles(shape, tiles if param_ndim == 2 else None)
    axes = (-2, -1) if param_ndim == 2 else (-1,)
    hist, amean, amax = [], [], []
    for sl in sls:
        at = _tile_view(age, sl, param_ndim)
        hist.append(log_histogram(at, edges, axes))
        amean.append(at.float().mean(axes))
        amax.append(at.float().amax(axes))
    return {"age_hist": torch.stack(hist, dim=-2),
            "age_mean": torch.stack(amean, dim=-1),
            "age_max": torch.stack(amax, dim=-1)}
