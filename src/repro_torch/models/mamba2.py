"""Mamba2 SSD block [arXiv:2405.21060] — the port of
`repro.models.mamba2`: the chunked scan for prefill and training, the
exact single-step recurrence for decode.

The SSD recurrence has a scalar decay a head:

    h_t = a_t h_{t-1} + (b_t x_t^T)        h: (P, N) per head
    y_t = c_t^T h_t + D x_t

Chunked (chunk c, A = cumsum(log a)):
    intra:  Y = ((C B^T) . L) X        L[t,i] = exp(A_t - A_i), i <= t
    inter:  Y += (C . exp(A)) h_0
    state:  h_c = exp(A_c) h_0 + sum_i exp(A_c - A_i) b_i x_i^T

The chunks' intra terms, state increments and state contributions are
batched over the chunks; only the state each chunk starts from is
carried in a loop, where the reference's `lax.scan` steps whole chunks.
Rounding follows the reference: the projections and the causal conv in
COMPUTE_DT, silu and the scan in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (COMPUTE_DT, _init, chunk_starts,
                                      init_rmsnorm, rmsnorm)


def init_mamba2(gen, d: int, cfg):
    s = cfg.ssm
    di = s.expand * d
    H = di // s.head_dim
    dev = gen.device
    return {
        "ln": init_rmsnorm(d, dev),
        # fused in_proj: [z (di), x (di), B (N), C (N), dt (H)]
        "w_in": _init(gen, (d, 2 * di + 2 * s.d_state + H)),
        "conv_w": _init(gen, (s.d_conv, di + 2 * s.d_state), scale=0.5),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "ln_y": init_rmsnorm(di, dev),
        "w_out": _init(gen, (di, d)),
    }


def _ssd_chunked(xh, bh, ch, dt, A_log, h0, chunk: int):
    """xh: (B, S, H, P); bh, ch: (B, S, N); dt: (B, S, H) float32; h0:
    (B, H, P, N). S must be a multiple of the chunk or at most one chunk
    (the reference's reshape raises TypeError otherwise). Returns (y
    (B, S, H, P) float32, h (B, H, P, N) float32).

    Every chunk's intra term, state increment and state contribution is
    one batched op over the chunks; only the state each chunk starts
    from is carried in a loop (one (B, H, P, N) update a chunk), where
    the reference scans whole chunks."""
    B, S, H, P = xh.shape
    N = bh.shape[-1]
    c = min(chunk, S)
    if S % c:
        raise TypeError(f"_ssd_chunked: a sequence of {S} does not split "
                        f"into chunks of {c}")
    nc = S // c
    a = -torch.exp(A_log)[None, None, :] * dt  # log decay (B, S, H), <= 0
    xs = (xh * dt[..., None]).float().transpose(1, 2).reshape(
        B, H, nc, c, P)
    bs, cs = (t.float().reshape(B, 1, nc, c, N) for t in (bh, ch))
    Ac = torch.cumsum(a.float().transpose(1, 2).reshape(B, H, nc, c), -1)
    # intra-chunk; entries i > t have a positive exponent, which
    # overflows float32 once a chunk's decay passes ~88 (a full chunk of
    # 128 at zamba2-1.2b's width does): it is replaced by -inf before the
    # exponential, so the gradient is 0 there (the reference's where
    # after exp gives 0 x inf = NaN in its backward)
    tril = torch.ones((c, c), dtype=torch.bool, device=xh.device).tril()
    cb = torch.matmul(cs, bs.transpose(-1, -2))  # (B, 1, nc, c, c)
    L = torch.exp(torch.where(tril, Ac[..., :, None] - Ac[..., None, :],
                              -torch.inf))
    y = torch.matmul(cb * L, xs)  # (B, H, nc, c, P)
    del L
    # the state each chunk starts from
    decay_to_end = torch.exp(Ac[..., -1:] - Ac)  # (B, H, nc, c)
    inc = torch.matmul((xs * decay_to_end[..., None]).transpose(-1, -2), bs)
    decay = torch.exp(Ac[..., -1])[..., None, None]  # (B, H, nc, 1, 1)
    starts, h = chunk_starts(h0.float(), decay, inc)
    # inter-chunk (state h enters each position with decay exp(A_t))
    y = y + torch.matmul(cs, starts.transpose(-1, -2)) \
        * torch.exp(Ac)[..., None]
    return y.reshape(B, H, S, P).transpose(1, 2), h


def mamba2_fwd(p, x, carry, *, cfg, decode: bool = False):
    """x: (B, S, d). carry: dict(ssm (B, H, P, N), conv (B, d_conv - 1,
    ch)). decode=True runs the exact single-step recurrence (S must be
    1). Returns (x + the block's output, new carry)."""
    s = cfg.ssm
    B, S, D = x.shape
    di = s.expand * D
    H = di // s.head_dim
    P, N = s.head_dim, s.d_state
    xn = rmsnorm(p["ln"], x, cfg.norm_eps)
    proj = torch.matmul(xn, p["w_in"].to(COMPUTE_DT))
    z, xr, bc, dt = proj.split([di, di, 2 * N, H], -1)
    conv_in = torch.cat([xr, bc], -1)  # (B, S, di + 2N)

    # causal depthwise conv over the sequence, with the carried tail
    seq = torch.cat([carry["conv"].to(COMPUTE_DT), conv_in], 1)
    kw = p["conv_w"].to(COMPUTE_DT)  # (d_conv, ch)
    conv = seq[:, 0:S] * kw[0]
    for i in range(1, s.d_conv):
        conv = conv + seq[:, i:i + S] * kw[i]
    conv = F.silu(conv.float()).to(COMPUTE_DT)
    # a copy: a view would keep the whole (B, S + d_conv - 1, ch) alive
    new_tail = seq[:, S:S + s.d_conv - 1].contiguous()

    xr, bh, ch = conv.split([di, N, N], -1)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    xh = xr.reshape(B, S, H, P)

    if decode:
        a = torch.exp(-torch.exp(p["A_log"])[None, :] * dtv[:, 0])  # (B, H)
        h0 = carry["ssm"].float()
        kv = (xh[:, 0] * dtv[:, 0, :, None]).float()[..., None] \
            * bh[:, 0].float()[:, None, None, :]  # (B, H, P, N)
        h1 = a[..., None, None] * h0 + kv
        y = torch.matmul(h1, ch[:, 0].float()[:, None, :, None])[..., 0]
        y, hS = y[:, None], h1  # (B, 1, H, P)
    else:
        y, hS = _ssd_chunked(xh, bh, ch, dtv, p["A_log"], carry["ssm"],
                             s.chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(COMPUTE_DT)
    y = rmsnorm(p["ln_y"], y, cfg.norm_eps)
    y = y * F.silu(z.float()).to(COMPUTE_DT)
    out = torch.matmul(y, p["w_out"].to(COMPUTE_DT))
    return x + out, {"ssm": hS, "conv": new_tail}
