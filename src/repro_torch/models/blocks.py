"""Per-layer block assembly — the port of `repro.models.blocks`: the
dense/MoE transformer block (GQA or MLA attention plus an MoE or SwiGLU
FFN) and zamba2's shared attention block, for training, prefill and
decode."""
from __future__ import annotations

import types

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (COMPUTE_DT, _init, init_mlp,
                                       init_rmsnorm, mlp_fwd, rmsnorm)


def attn_cfg_view(cfg, d_model):
    """The attention fields of `cfg` with the head dim taken from
    `d_model` (zamba2's shared block attends at 2 * d_model)."""
    return types.SimpleNamespace(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
        resolved_head_dim=d_model // cfg.n_heads)


def init_tf_block(gen, cfg, moe_layer: bool):
    d = cfg.d_model
    p = {"ln1": init_rmsnorm(d, gen.device),
         "ln2": init_rmsnorm(d, gen.device)}
    if cfg.mla is not None:
        p["attn"] = attn.init_mla(gen, d, cfg.n_heads, cfg.mla)
    else:
        p["attn"] = attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, cfg.qkv_bias)
    if moe_layer:
        p["moe"] = moe_mod.init_moe(gen, d, cfg.moe)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff)
    return p


def _ffn(p, xm, cfg, router_bias, placement, train=False):
    if "moe" in p:
        return moe_mod.moe_fwd(p["moe"], xm, m=cfg.moe,
                               router_bias=router_bias, placement=placement,
                               train=train)
    return mlp_fwd(p["mlp"], xm), {}


def tf_block_fwd(p, x, *, cfg, router_bias=None, placement=None,
                 return_kv=False, train=False):
    """Full-sequence causal block (train / prefill). Returns (x,
    kv_or_None, metrics): kv is GQA's (k, v), or MLA's latent cache
    lines. With `train` an MoE layer adds its aux loss to the metrics;
    attention is differentiable whenever its inputs need a gradient (the
    kernel wrapper's autograd function)."""
    xa = rmsnorm(p["ln1"], x, cfg.norm_eps)
    kv = None
    if cfg.mla is not None:
        out = attn.mla_fwd(p["attn"], xa, cfg=cfg, return_latent=return_kv)
    else:
        out = attn.gqa_fwd(p["attn"], xa, cfg=cfg, return_kv=return_kv)
    if return_kv:
        y, kv = out
    else:
        y = out
    x = x + y
    y2, metrics = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg,
                       router_bias, placement, train)
    return x + y2, kv, metrics


def tf_block_decode(p, x, cache, pos, *, cfg, router_bias=None,
                    placement=None):
    """Single-token block step; updates `cache` ({"k", "v"}, or MLA's
    latent array) in place. Returns (x, cache)."""
    xa = rmsnorm(p["ln1"], x, cfg.norm_eps)
    decode = attn.mla_decode if cfg.mla is not None else attn.gqa_decode
    y, cache = decode(p["attn"], xa, cache, pos, cfg=cfg)
    x = x + y
    y2, _ = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, router_bias,
                 placement)
    return x + y2, cache


# ---------------------------------------------------------------------------
# Zamba2 shared attention block (weights shared across invocations)
# ---------------------------------------------------------------------------


def init_shared_block(gen, cfg):
    d2 = 2 * cfg.d_model
    dev = gen.device
    acfg = attn_cfg_view(cfg, d2)
    return {
        "ln1": init_rmsnorm(d2, dev),
        "ln2": init_rmsnorm(d2, dev),
        "attn": attn.init_gqa(gen, d2, cfg.n_heads, cfg.n_kv_heads,
                              acfg.resolved_head_dim, False),
        "mlp": init_mlp(gen, d2, cfg.d_ff),
        "w_down": _init(gen, (d2, cfg.d_model)),
    }


def _shared_tail(p, xin, y, cfg):
    """The block after attention: residual, SwiGLU at 2 * d, and the
    down-projection back to d."""
    xin = xin + y
    xin = xin + mlp_fwd(p["mlp"], rmsnorm(p["ln2"], xin, cfg.norm_eps))
    return torch.matmul(xin, p["w_down"].to(COMPUTE_DT))


def shared_block_fwd(p, h, emb0, *, cfg, return_kv=False):
    """The shared block on concat(h, emb0) (B, S, 2 d): causal GQA
    through the attention kernel at head dim 2 d / n_heads. Returns (h +
    the block's output, the post-RoPE (k, v) (B, S, Hkv, Dh) with
    `return_kv`, else None)."""
    d2cfg = attn_cfg_view(cfg, 2 * cfg.d_model)
    xin = torch.cat([h, emb0], -1)
    xa = rmsnorm(p["ln1"], xin, cfg.norm_eps)
    out = attn.gqa_fwd(p["attn"], xa, cfg=d2cfg, return_kv=return_kv)
    y, kv = out if return_kv else (out, None)
    return h + _shared_tail(p, xin, y, cfg), kv


def shared_block_decode(p, h, emb0, cache, pos, *, cfg):
    """One token through the shared block; writes this invocation's K/V
    row at `pos` into `cache` ({"k", "v"} of (B, Smax, Hkv, Dh)) in
    place, through the flash-decode kernel. Returns (h, cache)."""
    d2cfg = attn_cfg_view(cfg, 2 * cfg.d_model)
    xin = torch.cat([h, emb0], -1)
    xa = rmsnorm(p["ln1"], xin, cfg.norm_eps)
    y, cache = attn.gqa_decode(p["attn"], xa, cache, pos, cfg=d2cfg)
    return h + _shared_tail(p, xin, y, cfg), cache
