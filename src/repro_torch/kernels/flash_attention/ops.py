"""Wrappers of the hand-written flash-attention kernels: the forward
(`csrc/flash_attention.cu`) and the backward
(`csrc/flash_attention_bwd.cu`).

On a CUDA tensor a wrapper checks its inputs, allocates its outputs with
`torch.empty`, launches the kernel on the current stream and counts the
launch; a launch CUDA refuses raises. In bf16 at D 64 and 128 the
TMA tensor maps of the forward and the backward are encoded on the host
inside the launch. On a CPU tensor it runs the plain version (`ref.py`),
and only then: there is no fallback from the card to the plain code.

The head dims (Dk of q and k, Dv of v) the forward and the backward take
on the card are `PAIRS`: one head dim for all three (16, 32, 64, 128),
or MLA's (192, 128) in bfloat16. Any other pair raises `ValueError`
naming it (the smoke configs' small head dims run on the CPU only:
ROADMAP.md queue 2, item 2).

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

#: head dims the kernels are compiled for with Dk = Dv
HEAD_DIMS = (16, 32, 64, 128)
#: the kernels' (Dk, Dv) pairs: HEAD_DIMS, and MLA's in bfloat16 only
PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
BF16_ONLY = ((192, 128),)

_P = ctypes.c_void_p
_I = ctypes.c_int

kernel = build.CudaKernel(
    "flash_attention", "flash_attention_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float],
    errors="flash_attention_error_string")

bwd_kernel = build.CudaKernel(
    "flash_attention_bwd", "flash_attention_bwd_launch",
    [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int64, _P, _P, _P, _I, _I, _I,
     _I, _I, _I, _I, _I, _I, ctypes.c_float],
    errors="flash_attention_bwd_error_string")


def _check(q, k, v):
    """(B, H, Hkv, S, Skv, Dk, Dv) of a call the kernels take; raises on
    anything else."""
    on_cuda("flash_attention", q)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q and k/v are (B, H, S, D)")
    B, H, S, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (D, Dv) not in PAIRS:
        raise ValueError(f"head dims (Dk {D}, Dv {Dv}) not in the kernel's "
                         f"pairs {PAIRS}; see ROADMAP.md queue 2")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{Hkv} KV heads do not divide {H} query heads")
    dev = q.device
    check("q", q, DTYPES, (B, H, S, D), dev)
    check("k", k, (q.dtype,), (B, Hkv, Skv, D), dev)
    check("v", v, (q.dtype,), (B, Hkv, Skv, Dv), dev)
    if (D, Dv) in BF16_ONLY and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: head dims (Dk {D}, Dv {Dv}) "
                         f"are compiled for bfloat16 only, not {q.dtype}")
    if q.dtype == torch.bfloat16 and D >= 64 and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel loads its tiles "
                         "by TMA, which needs 16-byte aligned tensors")
    return B, H, Hkv, S, Skv, D, Dv


def _forward(q, k, v, causal: bool, with_lse: bool):
    """(out (B, H, S, Dv), lse or None) by one forward launch."""
    B, H, Hkv, S, Skv, D, Dv = _check(q, k, v)
    out = q.new_empty((B, H, S, Dv))
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), B, H, Hkv, S,
                  Skv, D, Dv, int(causal), DTYPES[q.dtype], D ** -0.5)
    return out, lse


def bwd_workspace(B, H, Hkv, S, Skv, D, dtype, Dv=None) -> int:
    """float32 elements of the backward's scratch (the C entry refuses
    less). bf16 at D = Dv 64 / 128 (the wgmma path): lse log2(e) and
    delta in rows of S rounded up to 64, and, where a KV head serves
    several query heads, every query head's float32 dk partials (D
    columns) and dv partials (Dv columns); the other paths, MLA's (192,
    128) among them: delta."""
    Dv = D if Dv is None else Dv
    if dtype == torch.bfloat16 and D == Dv and D >= 64:
        n = 2 * B * H * (-(-S // 64) * 64)
        return n + (B * H * Skv * (D + Dv) if H != Hkv else 0)
    return B * H * S


def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool = True):
    """Gradients (dq, dk, dv) of `flash_attention(q, k, v, causal)` for
    the output gradient `dout`, from the forward's `out` and row
    log-sum-exp `lse` (B, H, S) float32. dq is q's shape, dk k's (B,
    Hkv, Skv, Dk) and dv v's (B, Hkv, Skv, Dv): the group's query heads
    are summed in head order. One call is one launch of the C entry: in
    bf16 at D 64 / 128 four kernels (the row sums, dk/dv per query head,
    the group sum where Hkv < H, dq), else three (the row sums over Dv,
    dk/dv per KV head, dq); every output written once (no atomics: the
    result is the same in every run)."""
    B, H, Hkv, S, Skv, D, Dv = _check(q, k, v)
    dev = q.device
    check("out", out, (q.dtype,), (B, H, S, Dv), dev)
    check("dout", dout, (q.dtype,), (B, H, S, Dv), dev)
    check("lse", lse, (torch.float32,), (B, H, S), dev)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd: the bf16 kernels load their "
                         "tiles by TMA or 16-byte loads, which need "
                         "16-byte aligned tensors")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    n_ws = bwd_workspace(B, H, Hkv, S, Skv, D, q.dtype, Dv)
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    bwd_kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      ws.data_ptr(), n_ws, dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), B, H, Hkv, S, Skv, D, Dv, int(causal),
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
    """Softmax(q k^T Dk^-0.5) v per head, causal (top-left aligned) or
    not. q: (B, H, S, Dk); k: (B, Hkv, Skv, Dk); v: (B, Hkv, Skv, Dv),
    Hkv dividing H: query head h reads KV head h // (H // Hkv), so
    grouped K/V is passed unexpanded. One dtype, float32 or bfloat16.
    Returns (B, H, S, Dv), differentiable when the inputs need a
    gradient."""
    if q.device.type == "cpu":
        return ref.flash_attention_plain(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, False)[0]
