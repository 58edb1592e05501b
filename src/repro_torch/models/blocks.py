"""Per-layer block assembly — the port of the dense/MoE transformer block
of `repro.models.blocks` (GQA attention plus an MoE or SwiGLU FFN), for
training, prefill and decode."""
from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp_fwd, rmsnorm


def init_tf_block(gen, cfg, moe_layer: bool):
    d = cfg.d_model
    p = {"ln1": init_rmsnorm(d, gen.device), "ln2": init_rmsnorm(d, gen.device),
         "attn": attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, cfg.qkv_bias)}
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
    kv_or_None, metrics). With `train` an MoE layer adds its aux loss to
    the metrics; attention is differentiable whenever its inputs need a
    gradient (the kernel wrapper's autograd function)."""
    xa = rmsnorm(p["ln1"], x, cfg.norm_eps)
    kv = None
    if return_kv:
        y, kv = attn.gqa_fwd(p["attn"], xa, cfg=cfg, return_kv=True)
    else:
        y = attn.gqa_fwd(p["attn"], xa, cfg=cfg)
    x = x + y
    y2, metrics = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg,
                       router_bias, placement, train)
    return x + y2, kv, metrics


def tf_block_decode(p, x, cache, pos, *, cfg, router_bias=None,
                    placement=None):
    """Single-token block step; updates `cache` ({"k", "v"}) in place.
    Returns (x, cache)."""
    xa = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, cache = attn.gqa_decode(p["attn"], xa, cache, pos, cfg=cfg)
    x = x + y
    y2, _ = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, router_bias,
                 placement)
    return x + y2, cache
