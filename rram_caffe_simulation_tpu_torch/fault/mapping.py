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

The census helpers of the reference (`per_tile_counters`,
`health_tiles`, `per_tile_health`, `per_tile_ages`) are not ported yet.
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
