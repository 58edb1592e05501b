"""Attention for prefill and decode — the port of
`repro.models.attention`: GQA and DeepSeek-V3's MLA.

GQA prefill calls the flash-attention kernel where the reference calls
its jnp oracle `flash_heads`; decode calls the flash-decode kernel where
the reference calls `decode_attend`. Both kernels read grouped K/V in
place, so the group-expanded K/V the reference builds is never made.

MLA prefill builds per-head q and k of head dim nope + rope (192 at
full width) and v of v_head_dim (128) from the latents, as the
reference does, and calls the same flash-attention kernel at that pair.
MLA decode absorbs `w_uk` into q and attends in the latent space over a
head-free cache of kv_lora_rank + rope values a token, in torch ops, in
the reference's order of operations.

Deliberate difference: the prefill's cache line holds the rope keys
after RoPE, as decode writes its own lines. The reference caches the
raw projection (`mla_fwd(..., return_latent=True)`), so its decode
reads the prompt's rope keys unrotated (ROADMAP.md, known red in the
reference). The sequence-sharded `flash_seq` comes with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models.layers import COMPUTE_DT, _init, apply_rope

NEG_INF = -1e30


def init_gqa(gen, d: int, n_heads: int, n_kv: int, head_dim: int,
             bias: bool):
    p = {
        "wq": _init(gen, (d, n_heads, head_dim)),
        "wk": _init(gen, (d, n_kv, head_dim)),
        "wv": _init(gen, (d, n_kv, head_dim)),
        "wo": _init(gen, (n_heads, head_dim, d)),
    }
    if bias:
        dev = gen.device
        p["bq"] = torch.zeros((n_heads, head_dim), dtype=COMPUTE_DT,
                              device=dev)
        p["bk"] = torch.zeros((n_kv, head_dim), dtype=COMPUTE_DT, device=dev)
        p["bv"] = torch.zeros((n_kv, head_dim), dtype=COMPUTE_DT, device=dev)
    return p


def init_mla(gen, d: int, n_heads: int, c):
    """c: MLAConfig."""
    qh = c.qk_nope_head_dim + c.qk_rope_head_dim
    return {
        "w_dq": _init(gen, (d, c.q_lora_rank)),
        "w_uq": _init(gen, (c.q_lora_rank, n_heads, qh)),
        "w_dkv": _init(gen, (d, c.kv_lora_rank + c.qk_rope_head_dim)),
        "w_uk": _init(gen, (c.kv_lora_rank, n_heads, c.qk_nope_head_dim)),
        "w_uv": _init(gen, (c.kv_lora_rank, n_heads, c.v_head_dim)),
        "wo": _init(gen, (n_heads, c.v_head_dim, d)),
    }


def _heads(p, x, w, b):
    """x (B, S, d) through p[w] (d, H, Dh) and the bias p[b] if the layer
    has one: (B, H, S, Dh), not yet contiguous."""
    out = torch.einsum("bsd,dhk->bhsk", x, p[w].to(COMPUTE_DT))
    if b in p:
        out = out + p[b].to(COMPUTE_DT)[None, :, None, :]
    return out


def _project_q(p, x, rope_theta, positions):
    """x: (B, S, d) -> q (B, H, S, Dh), contiguous, with RoPE at
    `positions` (B, S)."""
    q = _heads(p, x, "wq", "bq")
    if rope_theta:
        q = apply_rope(q, positions[:, None, :], rope_theta)
    return q.contiguous()


def _project_qkv(p, x, rope_theta, positions):
    """x: (B, S, d) -> q (B, H, S, Dh), k, v (B, Hkv, S, Dh), contiguous,
    with RoPE at `positions` (B, S)."""
    k, v = _heads(p, x, "wk", "bk"), _heads(p, x, "wv", "bv")
    if rope_theta:
        k = apply_rope(k, positions[:, None, :], rope_theta)
    return _project_q(p, x, rope_theta, positions), k.contiguous(), \
        v.contiguous()


def gqa_fwd(p, x, *, cfg, causal: bool = True, kv_override=None,
            return_kv: bool = False):
    """Full-sequence GQA attention (train / prefill), causal or not
    (the encoder attends both ways), q rotated at 0..S-1.

    kv_override: an encoder's (k, v), each (B, Hkv, S_src, Dh) and
    contiguous, unrotated, for cross-attention: the layer's own k and v
    projections are not computed, and S_src may differ from S.
    return_kv: also return the post-RoPE (k, v) laid out (B, S, Hkv, Dh)
    for the cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    if kv_override is not None:
        q = _project_q(p, x, cfg.rope_theta, positions)
        k, v = kv_override
    else:
        q, k, v = _project_qkv(p, x, cfg.rope_theta, positions)
    out = fa_ops.flash_attention(q, k, v, causal)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(COMPUTE_DT))
    if return_kv:
        return y, (k.transpose(1, 2), v.transpose(1, 2))
    return y


def pos_scalar(pos) -> int:
    """The decode position as a Python int (the first entry of a
    per-row array, as the reference)."""
    if torch.is_tensor(pos):
        return int(pos.reshape(-1)[0])
    return int(pos)


def gqa_decode(p, x, cache, pos, *, cfg, cross: bool = False):
    """One-token decode. x: (B, 1, d); cache: {"k", "v"} of
    (B, Smax, Hkv, Dh). Writes the new row at `pos` into the cache IN
    PLACE (the reference returns a new cache; the port saves the copy)
    and returns (y, cache). Past the cache's end the row goes to
    Smax - 1, where the reference's `dynamic_update_slice` clamps it,
    and the token attends to every cached row.

    With `cross` (an encoder-decoder's cross-attention) the cache is
    read-only: q is rotated at `pos` and attends to the rows 0..pos (the
    caller passes S_src - 1: every row), and the layer's k and v
    projections are not computed."""
    B = x.shape[0]
    pos = pos_scalar(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    if cross:
        q = _project_q(p, x, cfg.rope_theta, positions)
    else:
        q, k, v = _project_qkv(p, x, cfg.rope_theta, positions)
        row = min(pos, cache["k"].shape[1] - 1)
        cache["k"][:, row] = k[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, row] = v[:, :, 0].to(cache["v"].dtype)
    out = fd_ops.flash_decode(q[:, :, 0].contiguous(), cache["k"],
                              cache["v"], pos)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"].to(COMPUTE_DT))[:, None]
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


def _mla_q(p, x, cfg, positions):
    """(q_nope, q_rope) of x (B, S, d), each (B, H, S, .), q_rope after
    RoPE at `positions` (B, S)."""
    c = cfg.mla
    cq = torch.einsum("bsd,dr->bsr", x, p["w_dq"].to(COMPUTE_DT))
    q = torch.einsum("bsr,rhk->bhsk", cq, p["w_uq"].to(COMPUTE_DT))
    q_nope, q_rope = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)


def _mla_line(p, x, cfg, positions):
    """The cache lines of x (B, S, d): (B, S, kv_lora_rank + rope), the
    latent and then the rope key after RoPE at `positions`."""
    r = cfg.mla.kv_lora_rank
    line = torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(COMPUTE_DT))
    k_rope = apply_rope(line[:, None, :, r:], positions[:, None, :],
                        cfg.rope_theta)[:, 0]
    return torch.cat([line[..., :r], k_rope], -1)


def mla_fwd(p, x, *, cfg, return_latent: bool = False):
    """MLA prefill / training: per-head K/V materialised from the latent,
    causal attention by the flash-attention kernel at (Dk, Dv) = (nope +
    rope, v_head_dim). With `return_latent` also returns the cache lines
    (B, S, kv_lora_rank + rope), their rope keys after RoPE."""
    c = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    line = _mla_line(p, x, cfg, positions)
    ckv, k_rope = line.split([c.kv_lora_rank, c.qk_rope_head_dim], -1)
    k_nope = torch.einsum("bsr,rhk->bhsk", ckv, p["w_uk"].to(COMPUTE_DT))
    v = torch.einsum("bsr,rhk->bhsk", ckv, p["w_uv"].to(COMPUTE_DT))
    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, k_rope[:, None].expand(B, H, S, -1)], -1)
    out = fa_ops.flash_attention(qf, kf, v.contiguous(), True)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(COMPUTE_DT))
    if return_latent:
        return y, line
    return y


def mla_decode(p, x, cache, pos, *, cfg):
    """MLA decode with weight absorption: scores live in the latent
    space; cache (B, Smax, kv_lora_rank + rope), head-free. Writes the
    new line at `pos` into the cache IN PLACE (past the end at Smax - 1,
    where the reference's `dynamic_update_slice` clamps it) and returns
    (y, cache)."""
    c = cfg.mla
    r = c.kv_lora_rank
    B = x.shape[0]
    pos = pos_scalar(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = (t[:, :, 0] for t in _mla_q(p, x, cfg, positions))
    row = min(pos, cache.shape[1] - 1)
    cache[:, row] = _mla_line(p, x, cfg, positions)[:, 0].to(cache.dtype)

    lat, k_rope = cache[..., :r].to(COMPUTE_DT), cache[..., r:].to(COMPUTE_DT)
    # absorb W_uk into q: (B, H, nope) x (r, H, nope) -> (B, H, r)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope, p["w_uk"].to(COMPUTE_DT))
    scale = (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5
    s = (torch.einsum("bhr,bsr->bhs", q_lat, lat)
         + torch.einsum("bhk,bsk->bhs", q_rope, k_rope))
    s = s.float() * scale
    valid = torch.arange(cache.shape[1], device=x.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    pw = torch.softmax(s, -1).to(COMPUTE_DT)
    ctx_lat = torch.einsum("bhs,bsr->bhr", pw, lat)
    out = torch.einsum("bhr,rhk->bhk", ctx_lat, p["w_uv"].to(COMPUTE_DT))
    y = torch.einsum("bhk,hkd->bd", out, p["wo"].to(COMPUTE_DT))[:, None]
    return y, cache
