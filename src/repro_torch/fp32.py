"""Float32 arithmetic that gives the reference's bits on any device.

The reference runs as one XLA program on the CPU, where a multiply and
an add are fused into one FMA and Python constants are float32. These
helpers reproduce that rounding with ordinary PyTorch operations, the
same way on the CPU and on CUDA:

  f32(x)           the float32 value of a Python float, as a Python float
  fma32(a, b, c)   a * b + c rounded once
  div32(a, b)      a / b correctly rounded
  sqrt32(x)        sqrt(x) correctly rounded
  fmod32(x, y)     fmod, exact

Constants stay Python scalars: PyTorch casts a scalar to the float32
tensor's type before it computes, and a scalar costs no host-to-device
copy (a 0-d CUDA tensor built from host data would wait for the card).
The last three helpers run in float64, where rounding twice (first to
float64, then to float32) gives the correctly rounded float32 result
for a division, a square root and an exact remainder.
"""
from __future__ import annotations

import numpy as np
import torch


def f32(x: float) -> float:
    """`x` rounded to float32, as the reference's weakly typed constant
    becomes (a Python float holding that exact value)."""
    return float(np.float32(x))


def fma32(a, b, c):
    """float32 a * b + c rounded once, as a fused multiply-add.

    In float64 the product of two float32 values is exact, the sum's
    rounding error is recovered exactly (TwoSum), and an inexact sum is
    rounded to odd before the final rounding to float32 — which makes
    that double rounding correct. `b` and `c` may be float32 tensors or
    Python floats (taken as float32)."""
    a64 = a.double()
    b64 = b.double() if isinstance(b, torch.Tensor) else f32(b)
    c64 = c.double() if isinstance(c, torch.Tensor) else f32(c)
    p = a64 * b64
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def div32(a, b):
    """a / b as a correctly rounded float32 division (integer operands
    below 2**24 are taken exactly). `b` may be a Python float (taken as
    float32): PyTorch's own division by a scalar multiplies by its
    reciprocal on CUDA."""
    b64 = b.double() if isinstance(b, torch.Tensor) else f32(b)
    return (a.double() / b64).float()


def sqrt32(x):
    return torch.sqrt(x.double()).float()


def fmod32(x, y: float):
    return torch.fmod(x.double(), f32(y)).float()
