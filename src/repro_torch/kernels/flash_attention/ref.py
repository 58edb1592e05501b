"""Plain PyTorch version of the flash-attention forward.

The same function as the CUDA kernel (`csrc/flash_attention.cu`) and the
Pallas TPU kernel it replaces
(`repro.kernels.flash_attention.flash_attention`), in one block: scores
in float32 scaled by Dk^-0.5 (Dk the head dim of q and k; v may have
its own, Dv, as MLA's 192 and 128), masked to -1e30 above the causal
diagonal (top-left aligned when Skv != S), P = exp(s - rowmax) rounded
to V's type before P.V, accumulated in float32 and divided by max(l,
1e-30). In float32 it is the exact softmax; in bfloat16 it differs from
the kernel only by where P is rounded (one block here, 64-key tiles
there).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_plain(q, k, v, causal: bool = True):
    """q: (B, H, S, Dk); k: (B, Hkv, Skv, Dk); v: (B, Hkv, Skv, Dv) with
    Hkv dividing H (query head h reads KV head h // (H // Hkv)). Returns
    (B, H, S, Dv) in q's dtype."""
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kx = k.repeat_interleave(H // Hkv, dim=1).float()
    vx = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.matmul(q.float(), kx.transpose(-1, -2)) * D ** -0.5
    if causal:
        keep = torch.ones(S, Skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vx.float())
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


def flash_attention_lse_plain(q, k, causal: bool = True):
    """The float32 row log-sum-exp (B, H, S) of the scaled, masked
    scores: what the forward kernel writes for the backward."""
    H, Hkv, D = q.shape[1], k.shape[1], q.shape[-1]
    kx = k.repeat_interleave(H // Hkv, dim=1).float()
    s = torch.matmul(q.float(), kx.transpose(-1, -2)) * D ** -0.5
    if causal:
        S, Skv = q.shape[2], k.shape[2]
        keep = torch.ones(S, Skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return torch.logsumexp(s, dim=-1)


def flash_attention_grads_plain(q, k, v, dout, causal: bool = True):
    """(dq, dk, dv) by autograd through `flash_attention_plain`: the
    plain twin of the backward kernel (dk, dv at k's and v's shapes)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal)
        return torch.autograd.grad(out, leaves, dout)
