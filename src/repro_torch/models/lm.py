"""Decoder-only LM assembly for transformer stacks — the port of
`repro.models.lm`'s init / loss / prefill / decode for the dense and MoE
(GQA) families.

Layers are stacked (L, ...) as in the reference and driven by a Python
loop over layers where the reference uses `lax.scan`; training with
`remat="full"` recomputes each block in the backward pass
(`torch.utils.checkpoint`, the reference's `jax.checkpoint` of the scan
body). Caches are ``{"main": {"k", "v"}}`` of shape (L, B, Smax, Hkv,
Dh). MLA, rwkv6, mamba2, encoder-decoder, vision tokens, MTP and
`first_k_dense` stacks come with later slices and raise
`NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import LATER
from repro_torch.tree import tree_map
from repro_torch.models import blocks
from repro_torch.models.layers import (chunked_xent, embed_fwd, init_embed,
                                       init_rmsnorm, lm_head_fwd, rmsnorm,
                                       softmax_xent)

MOE_AUX_WEIGHT = 1e-2
#: the reference's remat policies; "dots" (save the matmuls' outputs)
#: has no counterpart here yet
REMATS = ("none", "full")


def check_ported(cfg) -> None:
    """Raise NotImplementedError for what this slice does not run."""
    later = [name for name, on in (
        ("MLA", cfg.mla is not None), ("rwkv", cfg.rwkv is not None),
        ("ssm", cfg.ssm is not None), ("encoder-decoder", cfg.encoder_decoder),
        ("vision tokens", bool(cfg.n_vision_tokens)),
        ("MTP", bool(cfg.mtp_depth)),
        ("first_k_dense", cfg.moe is not None and cfg.moe.first_k_dense > 0),
    ) if on]
    if later:
        raise NotImplementedError(f"{cfg.name}: {', '.join(later)} not "
                                  f"ported yet; see {LATER}")


def layer(stack, i: int):
    """Layer i of a stacked (L, ...) parameter or cache tree (views)."""
    return tree_map(lambda t: t[i], stack)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_stack(gen, n: int, make):
    """Stack `n` draws of `make(gen)` into (n, ...) leaves, one layer at
    a time: at full width the weights are built on the card and never
    pass through host memory, and the only temporary is one layer."""
    first = make(gen)
    stack = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    tree_map(lambda s, t: s[0].copy_(t), stack, first)
    del first
    for i in range(1, n):
        tree_map(lambda s, t: s[i].copy_(t), stack, make(gen))
    return stack


def init_params(gen: torch.Generator, cfg) -> Dict[str, Any]:
    """Random weights drawn on `gen`'s device (its own stream: the
    reference's jax.random numbers are not reproduced; tests carry
    weights across with `models.convert`)."""
    check_ported(cfg)
    p: Dict[str, Any] = {
        "embed": init_embed(gen, cfg.padded_vocab, cfg.d_model,
                            cfg.tie_embeddings),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
    }
    moe = cfg.moe is not None
    p["layers"] = _init_stack(
        gen, cfg.n_layers, lambda g: blocks.init_tf_block(g, cfg, moe))
    return p


def init_extras(cfg, device) -> Dict[str, Any]:
    """Mutable non-gradient state: aux-free router bias + GAIA
    placement."""
    if cfg.moe is None:
        return {}
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    E = cfg.moe.num_experts
    return {
        "router_bias": torch.zeros((n_moe, E), dtype=torch.float32,
                                   device=device),
        "placement": torch.arange(E, dtype=torch.int32,
                                  device=device).repeat(n_moe, 1),
    }


# ---------------------------------------------------------------------------
# Backbone forward (prefill)
# ---------------------------------------------------------------------------


def backbone_fwd(params, x, cfg, extras, *, train: bool = False,
                 remat: str = "full", collect_cache: bool = False):
    """Returns (h, cache_or_None, metrics). With `train` each MoE layer
    reports its aux loss (their mean is `moe_aux_loss`), and under
    `remat="full"` each block runs under `torch.utils.checkpoint`: only
    its input is kept, and the backward recomputes the rest."""
    check_ported(cfg)
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r} not in {REMATS}")
    stack = params["layers"]
    moe = cfg.moe is not None
    kvs, counts, dropped, aux = [], [], [], []

    def block(i, xc):
        return blocks.tf_block_fwd(
            layer(stack, i), xc, cfg=cfg,
            router_bias=extras["router_bias"][i] if moe else None,
            placement=extras["placement"][i] if moe else None,
            return_kv=collect_cache, train=train)

    for i in range(cfg.n_layers):
        if train and remat == "full":
            x, kv, met = checkpoint(block, i, x, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            x, kv, met = block(i, x)
        if collect_cache:
            kvs.append(kv)
        if met:
            counts.append(met["expert_counts"])
            dropped.append(met["moe_dropped"])
            if train:
                aux.append(met["moe_aux_loss"])
    metrics = {}
    if counts:
        metrics["expert_counts"] = torch.stack(counts)  # (L, E)
        metrics["moe_dropped"] = torch.stack(dropped).sum()
    if aux:
        metrics["moe_aux_loss"] = torch.stack(aux).mean()
    cache = None
    if collect_cache:
        cache = {"main": (torch.stack([k for k, _ in kvs]),
                          torch.stack([v for _, v in kvs]))}
    return x, cache, metrics


# ---------------------------------------------------------------------------
# Loss (train)
# ---------------------------------------------------------------------------


def loss_fn(params, batch, extras, cfg, *, loss_chunk: int = 0,
            remat: str = "full"):
    """Next-token cross-entropy (masked by `loss_mask` when the batch has
    one), plus MOE_AUX_WEIGHT x the MoE aux loss. `loss_chunk` > 0 takes
    the sequence-chunked cross-entropy; `remat` as `backbone_fwd`.
    Returns (loss, metrics)."""
    tokens = batch["tokens"]
    x = embed_fwd(params["embed"], tokens)
    h, _, metrics = backbone_fwd(params, x, cfg, extras, train=True,
                                 remat=remat)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    if loss_chunk:
        tot, cnt = chunked_xent(h[:, :-1], params["embed"], tokens[:, 1:],
                                mask[:, 1:], loss_chunk)
        loss = tot / cnt.clamp(min=1.0)
    else:
        logits = lm_head_fwd(params["embed"], h)
        loss = softmax_xent(logits[:, :-1], tokens[:, 1:], mask[:, 1:])
    metrics["xent"] = loss
    if "moe_aux_loss" in metrics:
        loss = loss + MOE_AUX_WEIGHT * metrics["moe_aux_loss"]
    return loss, metrics


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def prefill(params, batch, cfg, cache_len: int):
    """Run the full prompt, return (cache, last_logits (B, 1, V)).

    As the reference, prefill routes with fresh extras (zero bias,
    identity placement). The caches are padded to `cache_len`."""
    tokens = batch["tokens"]
    x = embed_fwd(params["embed"], tokens)
    h, cache, _ = backbone_fwd(params, x, cfg,
                               init_extras(cfg, tokens.device),
                               collect_cache=True)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = lm_head_fwd(params["embed"], h[:, -1:, :])
    return _pad_cache_to(cache, cfg, cache_len), logits


def _pad_cache_to(cache, cfg, cache_len: int):
    """Pad the prefill caches (L, B, S, Hkv, Dh) along S to
    cache_len."""
    check_ported(cfg)

    def pad_seq(arr):
        S = arr.shape[2]
        if S >= cache_len:
            return arr
        out = arr.new_zeros((*arr.shape[:2], cache_len, *arr.shape[3:]))
        out[:, :, :S] = arr
        return out

    return {name: {"k": pad_seq(kv[0]), "v": pad_seq(kv[1])}
            for name, kv in cache.items()}


def decode_step(params, cache, tokens, pos, extras, cfg):
    """One greedy decode step. tokens: (B,) int; pos: a Python int (or a
    scalar tensor). Writes the new K/V rows into `cache` in place.

    Returns (cache, logits (B, V))."""
    check_ported(cfg)
    x = embed_fwd(params["embed"], tokens[:, None])
    stack, kv = params["layers"], cache["main"]
    moe = cfg.moe is not None
    for i in range(cfg.n_layers):
        x, _ = blocks.tf_block_decode(
            layer(stack, i), x, layer(kv, i), pos, cfg=cfg,
            router_bias=extras["router_bias"][i] if moe else None,
            placement=extras["placement"][i] if moe else None)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head_fwd(params["embed"], h)[:, 0, :]
    return cache, logits
