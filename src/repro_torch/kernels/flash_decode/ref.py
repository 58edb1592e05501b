"""Plain PyTorch version of the flash-decode kernel.

The same function as the CUDA kernel (`csrc/flash_decode.cu`) and the
Pallas TPU kernel it replaces (`repro.kernels.flash_decode.flash_decode`):
one query token per sequence against every cached position <= pos,
query head h reading KV head h // G, scores in float32 scaled by
D^-0.5, P = exp(s - max) rounded to V's type before P.V, accumulated in
float32 and divided by max(l, 1e-30).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_plain(q, k_cache, v_cache, pos: int):
    """q: (B, Hq, D); caches: (B, S, Hkv, D); attend to positions <= pos.
    Returns (B, Hq, D) in q's dtype."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    k = k_cache.transpose(1, 2).repeat_interleave(G, dim=1).float()
    v = v_cache.transpose(1, 2).repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k) * D ** -0.5
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid[None, None, :], s, NEG_INF)
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhk,bhkd->bhd", p.to(v_cache.dtype).float(), v)
    return (acc / l.clamp(min=1e-30)).to(q.dtype)
