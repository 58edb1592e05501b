"""GQA attention for prefill and decode — the port of the GQA part of
`repro.models.attention`.

Prefill calls the flash-attention kernel where the reference calls its
jnp oracle `flash_heads`; decode calls the flash-decode kernel where the
reference calls `decode_attend`. Both kernels read grouped K/V in place,
so the group-expanded K/V the reference builds is never made. MLA and
the sequence-sharded `flash_seq` come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models.layers import COMPUTE_DT, _init, apply_rope


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


def _project_qkv(p, x, rope_theta, positions):
    """x: (B, S, d) -> q (B, H, S, Dh), k, v (B, Hkv, S, Dh), contiguous,
    with RoPE at `positions` (B, S)."""
    def proj(w, b):
        out = torch.einsum("bsd,dhk->bhsk", x, p[w].to(COMPUTE_DT))
        if b in p:
            out = out + p[b].to(COMPUTE_DT)[None, :, None, :]
        return out

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    if rope_theta:
        q = apply_rope(q, positions[:, None, :], rope_theta)
        k = apply_rope(k, positions[:, None, :], rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def gqa_fwd(p, x, *, cfg, return_kv: bool = False):
    """Full-sequence causal GQA attention (prefill). With `return_kv`
    also returns the post-RoPE (k, v) laid out (B, S, Hkv, Dh) for the
    cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg.rope_theta, positions)
    out = fa_ops.flash_attention(q, k, v, True)
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


def gqa_decode(p, x, cache, pos, *, cfg):
    """One-token decode. x: (B, 1, d); cache: {"k", "v"} of
    (B, Smax, Hkv, Dh). Writes the new row at `pos` into the cache IN
    PLACE (the reference returns a new cache; the port saves the copy)
    and returns (y, cache). Past the cache's end the row goes to
    Smax - 1, where the reference's `dynamic_update_slice` clamps it,
    and the token attends to every cached row."""
    B = x.shape[0]
    pos = pos_scalar(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, cfg.rope_theta, positions)
    row = min(pos, cache["k"].shape[1] - 1)
    cache["k"][:, row] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, row] = v[:, :, 0].to(cache["v"].dtype)
    out = fd_ops.flash_decode(q[:, :, 0].contiguous(), cache["k"],
                              cache["v"], pos)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"].to(COMPUTE_DT))[:, None]
    return y, cache
