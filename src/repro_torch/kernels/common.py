"""Input checks shared by the kernels' wrappers."""
from __future__ import annotations

import torch

#: the dtype code each kernel's C entry takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check(name, t, dtypes, shape, device):
    """Raise ValueError unless `t` is a contiguous tensor of one of
    `dtypes` with `shape` on `device`."""
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        want = "/".join(str(d) for d in dtypes)
        raise ValueError(
            f"{name}: expected a contiguous {want} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}" + ("" if t.is_contiguous() else " (strided)"))


def on_cuda(name, t):
    """Raise unless `t` lies on a CUDA device (the CPU is handled by the
    caller, which runs the plain version)."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA tensors (or the CPU, "
                           f"through its plain version), got {t.device}")
