"""Wrappers of the hand-written flash-attention kernels: the forward
(`csrc/flash_attention.cu`) and the backward
(`csrc/flash_attention_bwd.cu`).

On a CUDA tensor a wrapper checks its inputs, allocates its outputs with
`torch.empty`, launches the kernel on the current stream and counts the
launch; a launch CUDA refuses raises. In bf16 at D 64 and 128 the
TMA tensor maps of the forward and the backward are encoded on the host
inside the launch. On a CPU tensor it runs the plain version (`ref.py`),
and only then: there is no fallback from the card to the plain code.

A call that needs a gradient (grad mode on and q, k or v requiring one)
goes through `FlashAttention`, a `torch.autograd.Function`: its forward
also writes the float32 row log-sum-exp, and its backward is the
backward kernel. The backward is once differentiable: a second-order
gradient raises.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.common import DTYPES, check, on_cuda
from repro_torch.kernels.flash_attention import ref

#: head dims the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int

kernel = build.CudaKernel(
    "flash_attention", "flash_attention_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float],
    errors="flash_attention_error_string")

bwd_kernel = build.CudaKernel(
    "flash_attention_bwd", "flash_attention_bwd_launch",
    [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int64, _P, _P, _P, _I, _I, _I,
     _I, _I, _I, _I, _I, ctypes.c_float],
    errors="flash_attention_bwd_error_string")


def _check(q, k, v):
    """(B, H, Hkv, S, Skv, D) of a call the kernels take; raises on
    anything else."""
    on_cuda("flash_attention", q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q and k/v are (B, H, S, D)")
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{Hkv} KV heads do not divide {H} query heads")
    dev = q.device
    check("q", q, DTYPES, (B, H, S, D), dev)
    check("k", k, (q.dtype,), (B, Hkv, Skv, D), dev)
    check("v", v, (q.dtype,), (B, Hkv, Skv, D), dev)
    if q.dtype == torch.bfloat16 and D >= 64 and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel loads its tiles "
                         "by TMA, which needs 16-byte aligned tensors")
    return B, H, Hkv, S, Skv, D


def _forward(q, k, v, causal: bool, with_lse: bool):
    """(out, lse or None) by one forward launch."""
    B, H, Hkv, S, Skv, D = _check(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), B, H, Hkv, S,
                  Skv, D, int(causal), DTYPES[q.dtype], D ** -0.5)
    return out, lse


def bwd_workspace(B, H, Hkv, S, Skv, D, dtype) -> int:
    """float32 elements of the backward's scratch (the C entry refuses
    less). bf16 at D 64 / 128 (the wgmma path): lse log2(e) and delta in
    rows of S rounded up to 64, and, where a KV head serves several query
    heads, every query head's float32 dk and dv partials; the other
    paths: delta."""
    if dtype == torch.bfloat16 and D >= 64:
        n = 2 * B * H * (-(-S // 64) * 64)
        return n + (2 * B * H * Skv * D if H != Hkv else 0)
    return B * H * S


def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool = True):
    """Gradients (dq, dk, dv) of `flash_attention(q, k, v, causal)` for
    the output gradient `dout`, from the forward's `out` and row
    log-sum-exp `lse` (B, H, S) float32. dk and dv are (B, Hkv, Skv, D):
    the group's query heads are summed in head order. One call is one
    launch of the C entry: in bf16 at D 64 / 128 four kernels (the row
    sums, dk/dv per query head, the group sum where Hkv < H, dq), else
    three (the row sums, dk/dv per KV head, dq); every output written
    once (no atomics: the result is the same in every run)."""
    B, H, Hkv, S, Skv, D = _check(q, k, v)
    dev = q.device
    check("out", out, (q.dtype,), (B, H, S, D), dev)
    check("dout", dout, (q.dtype,), (B, H, S, D), dev)
    check("lse", lse, (torch.float32,), (B, H, S), dev)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: the bf16 kernels load their "
                         "tiles by TMA or 16-byte loads, which need "
                         "16-byte aligned tensors")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    n_ws = bwd_workspace(B, H, Hkv, S, Skv, D, q.dtype)
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    bwd_kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      ws.data_ptr(), n_ws, dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), B, H, Hkv, S, Skv, D, int(causal),
                      DTYPES[q.dtype], D ** -0.5)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable op: forward with the row
    log-sum-exp saved, backward by `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # a view at an odd offset: realign
            dout = dout.clone()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """Softmax(q k^T D^-0.5) v per head, causal (top-left aligned) or
    not. q: (B, H, S, D); k, v: (B, Hkv, Skv, D), Hkv dividing H: query
    head h reads KV head h // (H // Hkv), so grouped K/V is passed
    unexpanded. One dtype, float32 or bfloat16. Returns (B, H, S, D),
    differentiable when the inputs need a gradient."""
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, False)[0]
