"""Encoder-decoder backbone (seamless-m4t-medium) — the port of
`repro.models.encdec`.

The speech/text frontend is a stub, as in the reference: the encoder
consumes precomputed frame embeddings (B, S_src, FRAME_DIM). Encoder
blocks are bidirectional self-attention + MLP (the attention kernel
with `causal=False`); decoder blocks add causal self-attention and
cross-attention over the encoder output. RoPE replaces the released
model's relative-position scheme (DESIGN.md §Adaptations): the encoder
rotates q and k at 0..S_src-1, a decoder's cross-attention rotates its q
only, and the encoder's k and v enter it unrotated.

Caches: ``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each (L, B, S,
Hkv, Dh) and contiguous. The self cache is written in place a row a
step (as `attention.gqa_decode` does); the cross cache is written once
by the prefill, and every decode step reads all its rows. As in the
reference, a decode step rotates its cross query at S_src - 1, while the
loss's cross-attention rotates it at the target positions (ROADMAP.md,
known red in the reference).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.layers import (COMPUTE_DT, _init, embed_fwd,
                                       init_embed, init_mlp, init_rmsnorm,
                                       lm_head_fwd, mlp_fwd, rmsnorm)
from repro_torch.models.lm import REMATS, _init_stack, layer, masked_xent

FRAME_DIM = 1024  # stub frontend output dim


def _init_enc_block(gen, cfg):
    d = cfg.d_model
    return {
        "ln1": init_rmsnorm(d, gen.device), "ln2": init_rmsnorm(d, gen.device),
        "attn": attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, False),
        "mlp": init_mlp(gen, d, cfg.d_ff),
    }


def _init_dec_block(gen, cfg):
    d = cfg.d_model
    return {
        "ln1": init_rmsnorm(d, gen.device), "ln2": init_rmsnorm(d, gen.device),
        "ln3": init_rmsnorm(d, gen.device),
        "self_attn": attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, False),
        "cross_attn": attn.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, False),
        "mlp": init_mlp(gen, d, cfg.d_ff),
    }


def init_encdec(gen: torch.Generator, cfg) -> Dict[str, Any]:
    """The reference's tree (`src_proj`, `embed` with an untied head,
    `enc_layers`, `dec_layers`, `enc_norm`, `final_norm`), drawn on
    `gen`'s device a layer at a time."""
    d = cfg.d_model
    return {
        "src_proj": _init(gen, (FRAME_DIM, d)),
        "embed": init_embed(gen, cfg.padded_vocab, d),
        "enc_layers": _init_stack(gen, cfg.n_layers,
                                  lambda g: _init_enc_block(g, cfg)),
        "dec_layers": _init_stack(gen, cfg.n_layers,
                                  lambda g: _init_dec_block(g, cfg)),
        "enc_norm": init_rmsnorm(d, gen.device),
        "final_norm": init_rmsnorm(d, gen.device),
    }


def _runner(train: bool, remat: str):
    """fn(*args), under `torch.utils.checkpoint` when training with a
    `remat` other than "none": as the reference's, the encoder-decoder
    checkpoints whole blocks, so "dots" behaves as "full"."""
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r} not in {REMATS}")

    def run(fn, *args):
        if train and remat != "none":
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    return run


def enc_block(p, x, cfg):
    """An encoder layer on x (B, S_src, d): non-causal self-attention,
    then the MLP."""
    xa = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_fwd(p["attn"], xa, cfg=cfg, causal=False)
    xm = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], xm)


def encode(params, frames, cfg, *, train: bool = False,
           remat: str = "full"):
    """frames (B, S_src, FRAME_DIM) -> the encoder output (B, S_src, d)
    after `enc_norm`: one non-causal attention launch a layer."""
    run = _runner(train, remat)
    x = torch.matmul(frames.to(COMPUTE_DT), params["src_proj"].to(COMPUTE_DT))
    for i in range(cfg.n_layers):
        x = run(enc_block, layer(params["enc_layers"], i), x, cfg)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_block_full(p, x, enc_kv, cfg, collect_cache: bool = False):
    """A decoder block over the whole target sequence: causal
    self-attention, cross-attention over `enc_kv` (`_enc_cross_kv`'s),
    MLP. Returns (x, the self-attention's (k, v) when `collect_cache`,
    else None)."""
    xa = rmsnorm(p["ln1"], x, cfg.norm_eps)
    kv = None
    if collect_cache:
        y, kv = attn.gqa_fwd(p["self_attn"], xa, cfg=cfg, return_kv=True)
    else:
        y = attn.gqa_fwd(p["self_attn"], xa, cfg=cfg)
    x = x + y
    xc = rmsnorm(p["ln2"], x, cfg.norm_eps)
    x = x + attn.gqa_fwd(p["cross_attn"], xc, cfg=cfg, causal=False,
                         kv_override=enc_kv)
    xm = rmsnorm(p["ln3"], x, cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], xm), kv


def _enc_cross_kv(p_layer, enc_out, cfg):
    """The encoder output projected to this decoder layer's cross K/V:
    (k, v), each (B, Hkv, S_src, Dh), contiguous, unrotated."""
    ca = p_layer["cross_attn"]
    return (attn._heads(ca, enc_out, "wk", "bk").contiguous(),
            attn._heads(ca, enc_out, "wv", "bv").contiguous())


def encdec_loss(params, batch, extras, cfg, *, loss_chunk: int = 0,
                remat: str = "full", px=None, batch_entry=None):
    """Next-token cross-entropy of the decoder over batch["tokens"] (B,
    S), given the source batch["frames"], masked by `loss_mask` when the
    batch has one. As the reference's, it builds the full (B, S, V)
    logits: `loss_chunk` is taken for the train step's interface and not
    used. On a distributed mesh (`px`) the batch is this rank's rows
    (`batch_entry`) and the loss its share (`lm.masked_xent`). Returns
    (loss, {"xent": loss})."""
    del extras, loss_chunk
    frames, tokens = batch["frames"], batch["tokens"]
    run = _runner(True, remat)
    enc_out = encode(params, frames, cfg, train=True, remat=remat)
    x = embed_fwd(params["embed"], tokens)

    def body(p_layer, xc, enc):
        kv = _enc_cross_kv(p_layer, enc, cfg)
        return _dec_block_full(p_layer, xc, kv, cfg)[0]

    for i in range(cfg.n_layers):
        x = run(body, layer(params["dec_layers"], i), x, enc_out)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    loss = masked_xent(x, params["embed"], tokens[:, 1:], mask[:, 1:], 0,
                       px, batch_entry)
    return loss, {"xent": loss}


def cross_cache(params, enc_out, cfg):
    """Every decoder layer's cross K/V of the encoder output (B, S_src,
    d): {"k", "v"}, each (L, B, S_src, Hkv, Dh), contiguous, each
    layer's rows written by one matmul into its slice."""
    B, S_src, d = enc_out.shape
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (L, B, S_src, Hkv, Dh)
    cross = {"k": enc_out.new_empty(shape), "v": enc_out.new_empty(shape)}
    for i in range(L):
        ca = layer(params["dec_layers"], i)["cross_attn"]
        for name, w in (("k", "wk"), ("v", "wv")):
            torch.matmul(enc_out, ca[w].to(COMPUTE_DT).reshape(d, Hkv * Dh),
                         out=cross[name][i].view(B, S_src, Hkv * Dh))
    return cross


def encdec_prefill(params, batch, cfg, cache_len: int):
    """Encode batch["frames"] (B, S_src, FRAME_DIM), write the cross
    caches (`cross_cache`) and allocate a zero self cache of `cache_len`
    rows. Returns (cache, the BOS logits (B, 1, V): the LM head over
    `final_norm` of the encoder's last row, as the reference)."""
    enc_out = encode(params, batch["frames"], cfg)
    cross = cross_cache(params, enc_out, cfg)
    L, B = cfg.n_layers, enc_out.shape[0]
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    self_shape = (L, B, cache_len, Hkv, Dh)
    self_cache = {
        "k": torch.zeros(self_shape, dtype=COMPUTE_DT, device=enc_out.device),
        "v": torch.zeros(self_shape, dtype=COMPUTE_DT, device=enc_out.device),
    }
    logits = lm_head_fwd(params["embed"], rmsnorm(
        params["final_norm"], enc_out[:, -1:], cfg.norm_eps))
    return {"self": self_cache, "cross": cross}, logits


def dec_block_decode(p, x, self_c, cross_c, pos, cfg):
    """One decoder layer of a decode step on x (B, 1, d): causal
    self-attention writing its row into `self_c` ({"k", "v"} of (B,
    S_self, Hkv, Dh)) in place, cross-attention over every row of the
    read-only `cross_c`, the query rotated at S_src - 1 as the
    reference's, then the MLP. Returns x."""
    xa = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, _ = attn.gqa_decode(p["self_attn"], xa, self_c, pos, cfg=cfg)
    x = x + y
    xb = rmsnorm(p["ln2"], x, cfg.norm_eps)
    y, _ = attn.gqa_decode(p["cross_attn"], xb, cross_c,
                           cross_c["k"].shape[1] - 1, cfg=cfg, cross=True)
    x = x + y
    xm = rmsnorm(p["ln3"], x, cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], xm)


def encdec_decode(params, cache, tokens, pos, extras, cfg):
    """One greedy decode step of the decoder: tokens (B,) at target
    position `pos` (0 for the token after BOS), every layer by
    `dec_block_decode` (its self row written into cache["self"] in
    place). Returns (cache, logits (B, V))."""
    del extras
    x = embed_fwd(params["embed"], tokens[:, None])
    for i in range(cfg.n_layers):
        x = dec_block_decode(layer(params["dec_layers"], i), x,
                             layer(cache["self"], i),
                             layer(cache["cross"], i), pos, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return cache, lm_head_fwd(params["embed"], x)[:, 0, :]
