"""Shared building blocks: norms, MLPs, RoPE, embeddings — the port of
`repro.models.layers` for the serving path.

All modules are functional: ``init_*`` returns a param dict, ``*_fwd``
consumes it. Params are stored bf16; norms and softmax compute in
float32.

REPRO_FORCE_F32=1 switches params and compute to float32 (same shapes),
read once at import as the reference reads it. On one device every
sharding constraint of the reference is a no-op, so there is no
ParallelCtx here.
"""
from __future__ import annotations

import os

import torch

_FORCE_F32 = os.environ.get("REPRO_FORCE_F32", "0") == "1"
PARAM_DT = torch.float32 if _FORCE_F32 else torch.bfloat16
COMPUTE_DT = torch.float32 if _FORCE_F32 else torch.bfloat16


def _init(gen: torch.Generator, shape, scale=None, dtype=PARAM_DT):
    """Normal(0, 1) * scale (default fan_in ** -0.5, fan_in = shape[-2]
    or the only dim), cast to `dtype`, drawn on `gen`'s device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(dtype)  # in place: one float32 temporary


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device):
    return {"scale": torch.ones((d,), dtype=PARAM_DT, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, f: int):
    return {"w_gate": _init(gen, (d, f)), "w_up": _init(gen, (d, f)),
            "w_down": _init(gen, (f, d))}


def silu_mul(g, u):
    """silu(g) in float32, rounded to COMPUTE_DT, times u."""
    return torch.nn.functional.silu(g.float()).to(COMPUTE_DT) * u


def mlp_fwd(p, x):
    """SwiGLU over the last dim of x."""
    h = torch.matmul(x, p["w_gate"].to(COMPUTE_DT))
    u = torch.matmul(x, p["w_up"].to(COMPUTE_DT))
    return torch.matmul(silu_mul(h, u), p["w_down"].to(COMPUTE_DT))


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None):
    # theta stays a Python scalar: a 0-d CUDA tensor built from host data
    # would make PyTorch synchronise the stream, twice a layer
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def chunk_starts(h0, decay, inc):
    """The state each chunk of a chunked linear recurrence starts from,
    h_{j+1} = decay_j h_j + inc_j from h_0: (starts (B, H, n_chunks,
    ...), the state after the last chunk). decay and inc: (B, H,
    n_chunks, ...), broadcasting against h0 (B, H, ...). The only
    sequential part of rwkv6's and Mamba2's chunked scans."""
    h, starts = h0, []
    for j in range(inc.shape[2]):
        starts.append(h)
        h = decay[:, :, j] * h + inc[:, :, j]
    return torch.stack(starts, 2), h


def init_embed(gen, vocab: int, d: int, tie: bool = False):
    p = {"embedding": _init(gen, (vocab, d), scale=0.02)}
    if not tie:
        p["lm_head"] = _init(gen, (d, vocab))
    return p


def embed_fwd(p, tokens):
    return p["embedding"].to(COMPUTE_DT)[tokens.long()]


def lm_head_fwd(p, x):
    w = p.get("lm_head")
    if w is None:
        w = p["embedding"].T
    return torch.matmul(x, w.to(COMPUTE_DT))


# ---------------------------------------------------------------------------
# Cross-entropy (train)
# ---------------------------------------------------------------------------


def _nll(logits, labels):
    """Per position -log softmax(logits)[label], in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - gold


def softmax_xent(logits, labels, mask=None):
    """Mean cross-entropy in float32 over the positions where `mask` is
    set (every position when None)."""
    nll = _nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def _xent_piece(h, w, labels, mask):
    logits = torch.matmul(h, w.to(COMPUTE_DT))
    return (_nll(logits, labels) * mask).sum(), mask.sum()


def chunked_xent(h, p_embed, labels, mask, chunk: int = 1024):
    """Sequence-chunked cross-entropy: each (B, chunk, V) logit block is
    recomputed in the backward pass (`torch.utils.checkpoint`, the
    reference's `jax.checkpoint`), so the (B, S, V) float32 logits never
    exist. The sums run as the reference's scan: chunk by chunk, then
    the remainder. Returns (sum_nll, sum_mask)."""
    from torch.utils.checkpoint import checkpoint
    w = p_embed.get("lm_head")
    if w is None:
        w = p_embed["embedding"].T
    B, S, _ = h.shape
    c = min(chunk, S)
    n = S // c
    mask = mask.float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    bounds = [(i * c, (i + 1) * c) for i in range(n)]
    if S > n * c:
        bounds.append((n * c, S))
    for a, b in bounds:
        s, k = checkpoint(_xent_piece, h[:, a:b], w, labels[:, a:b],
                          mask[:, a:b], use_reentrant=False,
                          preserve_rng_state=False)
        tot, cnt = tot + s, cnt + k
    return tot, cnt
