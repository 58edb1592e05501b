"""Wrappers of the hand-written chunked-WKV intra-chunk kernels: the
forward (`csrc/wkv_intra.cu`) and its backward (`csrc/wkv_intra_bwd.cu`).

`wkv_intra(r, k, l_prev, l, chunk)` returns RWKV6's intra-chunk matrix A
(B, H, S / chunk, chunk, chunk) for every chunk at once:
A[t, i] = sum_n r[t, n] k[i, n] exp(l_prev[t, n] - l[i, n]) for i < t,
0 for i >= t. It takes float32 (B, H, S, N) tensors at N in `N_VALUES`
(the smoke's 16, rwkv6-1.6b's 64) and any chunk up to `MAX_CHUNK` that
divides S; anything else raises `ValueError` naming the shape, on the
CPU as on the card.

On a CUDA tensor a wrapper checks its inputs, allocates its outputs with
`torch.empty` (the kernels write every element), launches the kernel on
the current stream and counts the launch; a launch CUDA refuses raises.
On a CPU tensor it runs the plain version (`ref.py`), and only then:
there is no fallback from the card to the plain code.

Every call goes through `WkvIntra`, a `torch.autograd.Function` that
saves its four inputs and whose backward is the backward kernel (on the
CPU: `ref.wkv_intra_bwd_plain`, the same algebra). The backward is once
differentiable.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.common import check, on_cuda
from repro_torch.kernels.wkv import ref

#: head sizes N the kernels take (the smoke config's and rwkv6-1.6b's)
N_VALUES = (16, 64)
#: the largest chunk: eight sub-chunks of 16 rows (`csrc/wkv.cuh`)
MAX_CHUNK = 128

_P = ctypes.c_void_p
_I = ctypes.c_int

kernel = build.CudaKernel("wkv_intra", "wkv_intra_launch",
                          [_P, _P, _P, _P, _I, _I, _I, _P],
                          errors="wkv_intra_error_string")
bwd_kernel = build.CudaKernel(
    "wkv_intra_bwd", "wkv_intra_bwd_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    errors="wkv_intra_bwd_error_string")
KERNELS = (kernel, bwd_kernel)


def _check(r, k, l_prev, l, chunk: int):
    """(B, H, S, N) of a call the kernels take; raises ValueError on
    anything else."""
    shape = tuple(r.shape)
    if len(shape) != 4 or shape[-1] not in N_VALUES or not (
            isinstance(chunk, int) and 1 <= chunk <= MAX_CHUNK
            and shape[2] % chunk == 0):
        raise ValueError(
            f"wkv_intra: r of shape {shape} (B, H, S, N) with chunk "
            f"{chunk}: the kernels take N in {N_VALUES} and a chunk of "
            f"1..{MAX_CHUNK} that divides S")
    for name, t in (("r", r), ("k", k), ("l_prev", l_prev), ("l", l)):
        check(name, t, (torch.float32,), shape, r.device)
    return shape


def _forward(r, k, l_prev, l, chunk: int):
    B, H, S, N = r.shape
    if r.device.type == "cpu":
        return ref.wkv_intra_plain(r, k, l_prev, l, chunk)
    on_cuda("wkv_intra", r)
    A = torch.empty((B, H, S // chunk, chunk, chunk), dtype=torch.float32,
                    device=r.device)
    kernel.launch(r.data_ptr(), k.data_ptr(), l_prev.data_ptr(),
                  l.data_ptr(), B * H * (S // chunk), chunk, N, A.data_ptr())
    return A


def wkv_intra_bwd(r, k, l_prev, l, dA, chunk: int):
    """(dr, dk, dl_prev, dl), each (B, H, S, N) float32, for the gradient
    dA (B, H, S / chunk, chunk, chunk) float32 of `wkv_intra(r, k,
    l_prev, l, chunk)`: one pass over the lower triangle's sub-blocks
    gives dr and dk, and dl_prev = r dr, dl = -k dk."""
    B, H, S, N = _check(r, k, l_prev, l, chunk)
    check("dA", dA, (torch.float32,), (B, H, S // chunk, chunk, chunk),
          r.device)
    if r.device.type == "cpu":
        return ref.wkv_intra_bwd_plain(r, k, l_prev, l, dA, chunk)
    on_cuda("wkv_intra_bwd", r)
    dr, dk, dlp, dl = (torch.empty_like(r) for _ in range(4))
    bwd_kernel.launch(r.data_ptr(), k.data_ptr(), l_prev.data_ptr(),
                      l.data_ptr(), dA.data_ptr(), B * H * (S // chunk),
                      chunk, N, dr.data_ptr(), dk.data_ptr(),
                      dlp.data_ptr(), dl.data_ptr())
    return dr, dk, dlp, dl


class WkvIntra(torch.autograd.Function):
    """The intra-chunk term as one differentiable op: its four inputs
    saved, the backward by `wkv_intra_bwd`."""

    @staticmethod
    def forward(ctx, r, k, l_prev, l, chunk):
        ctx.save_for_backward(r, k, l_prev, l)
        ctx.chunk = chunk
        return _forward(r, k, l_prev, l, chunk)

    @staticmethod
    @once_differentiable
    def backward(ctx, dA):
        r, k, l_prev, l = ctx.saved_tensors
        return (*wkv_intra_bwd(r, k, l_prev, l, dA.contiguous(), ctx.chunk),
                None)


def wkv_intra(r, k, l_prev, l, chunk: int):
    """RWKV6's intra-chunk matrix for every chunk: (B, H, S / chunk,
    chunk, chunk) float32, zero on and above the diagonal.
    Differentiable in r, k, l_prev and l when they need a gradient."""
    _check(r, k, l_prev, l, chunk)
    return WkvIntra.apply(r, k, l_prev, l, chunk)


def reset_launches() -> None:
    build.reset_launches(KERNELS)


def launches() -> dict:
    return build.launches(KERNELS)
