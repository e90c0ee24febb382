"""Fused ApplyUpdate + Fail epilogue (counterpart of the reference
package's fault/fused.py): the SGD subtract and the packed fault
transition of one fault-target leaf in one pass, kernel B1
(csrc/fused_epilogue.cu).

Semantics are exactly `data - upd` followed by `packed.fail_packed`,
bit for bit; `fused_update_fail_plain` is that sequence written out,
and the card's kernel is held against it with `torch.equal`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import packed as fault_packed

FUSED_MODES = ("write", "always", "never")

_VP = ctypes.c_void_p
FUSED_LIB = kernels.CudaLibrary(
    "fused_epilogue.cu",
    {name: [_VP] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP]
     for name in ("rram_fused_update_fail_i16",
                  "rram_fused_update_fail_i32")})
_FN = {torch.int16: "rram_fused_update_fail_i16",
       torch.int32: "rram_fused_update_fail_i32"}


def fused_update_fail_plain(data, upd, life_q, stuck_bits,
                            mode: str = "write"):
    """The plain PyTorch version of kernel B1: `data - upd`, then
    `fail_packed` on the one leaf."""
    L = data.shape[-1]
    new, state = fault_packed.fail_packed(
        {"leaf": data - upd}, {"life_q": {"leaf": life_q},
                               "stuck_bits": {"leaf": stuck_bits}},
        {"leaf": upd}, {"last_dim": {"leaf": L}}, mode=mode)
    return new["leaf"], state["life_q"]["leaf"]


def _check(data, upd, life_q, stuck_bits, mode):
    if mode not in FUSED_MODES:
        raise ValueError(f"unknown fused epilogue mode {mode!r} "
                         f"(expected one of {FUSED_MODES})")
    if data.dtype != torch.float32 or upd.dtype != torch.float32:
        raise TypeError("fused_update_fail: data and upd must be float32")
    if life_q.dtype not in _FN:
        raise TypeError(f"fused_update_fail: life_q must be int16 or "
                        f"int32, got {life_q.dtype}")
    if stuck_bits.dtype != torch.uint8:
        raise TypeError("fused_update_fail: stuck_bits must be uint8")
    if upd.shape != data.shape or life_q.shape != data.shape:
        raise ValueError(f"fused_update_fail: shapes differ: data "
                         f"{tuple(data.shape)}, upd {tuple(upd.shape)}, "
                         f"life_q {tuple(life_q.shape)}")
    L = data.shape[-1]
    want = tuple(data.shape[:-1]) + (-(-L // 4),)
    if tuple(stuck_bits.shape) != want:
        raise ValueError(f"fused_update_fail: stuck_bits shape "
                         f"{tuple(stuck_bits.shape)}, expected {want}")


def fused_update_fail(data, upd, life_q, stuck_bits, mode: str = "write"):
    """(data', life_q') of one step for one fault leaf: data' =
    where(life_q' <= 0, stuck, data - upd), the counter decremented per
    `mode`. Leading axes (a config axis) fold into rows. On CUDA tensors
    this launches kernel B1; on CPU tensors it runs the plain version."""
    _check(data, upd, life_q, stuck_bits, mode)
    if not data.is_cuda:
        return fused_update_fail_plain(data, upd, life_q, stuck_bits, mode)
    tensors = (data, upd, life_q, stuck_bits)
    if any(t.device != data.device for t in tensors):
        raise ValueError("fused_update_fail: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_update_fail: operands must be contiguous")
    out_data = torch.empty_like(data)
    out_lq = torch.empty_like(life_q)
    L = data.shape[-1]
    rows = data.numel() // L if L else 0
    FUSED_LIB.call(_FN[life_q.dtype], kernels.ptr(data), kernels.ptr(upd),
                   kernels.ptr(life_q), kernels.ptr(stuck_bits),
                   kernels.ptr(out_data), kernels.ptr(out_lq), rows, L,
                   FUSED_MODES.index(mode), kernels.stream_ptr(data.device))
    return out_data, out_lq
