"""Device selection for the port's entry points.

Every entry point (Solver, Net, the kernel wrappers' callers) runs on
the card unless the caller asks for the CPU by name: with no device
given and no CUDA device present, `resolve_device` raises instead of
falling back, so a run that meant to measure the card cannot silently
measure the host.
"""
from __future__ import annotations

import torch

CUDNN_DETERMINISTIC = True


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        # cuBLAS matmuls and (by default) cuDNN convolutions would round
        # f32 operands to TF32's 10-bit mantissa; the reference computes
        # in full f32, so both stay off
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # cuDNN's convolution backward algorithms may add with atomics,
        # so two runs from one seed part in the last bits; the
        # deterministic ones make a run repeat bit for bit
        torch.backends.cudnn.deterministic = CUDNN_DETERMINISTIC
    return dev
