"""Decoder-only LM assembly for transformer stacks — the port of
`repro.models.lm`'s init / loss / prefill / decode for the dense, MoE
and MLA + MoE (DeepSeek-V3) families.

Layers are stacked (L, ...) as in the reference and driven by a Python
loop over layers where the reference uses `lax.scan`; training with
`remat="full"` recomputes each block in the backward pass
(`torch.utils.checkpoint`, the reference's `jax.checkpoint` of the scan
body). With `first_k_dense` the leading dense layers are a stack of
their own, `dense_layers`, run before the MoE stack `layers`; the
router bias and the placement index the MoE stack only. A config with
`mtp_depth` has the multi-token-prediction head `mtp`, which only the
loss runs. Caches are ``{"main": {"k", "v"}}`` of shape (L, B, Smax,
Hkv, Dh), or for MLA ``{"dense": (Ld, B, Smax, r + rope), "main": (L,
B, Smax, r + rope)}``. rwkv6, mamba2, encoder-decoder and vision tokens
come with later slices and raise `NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import LATER
from repro_torch.tree import tree_map
from repro_torch.models import blocks
from repro_torch.models.layers import (COMPUTE_DT, _init, chunked_xent,
                                       embed_fwd, init_embed, init_rmsnorm,
                                       lm_head_fwd, rmsnorm, softmax_xent)

MTP_WEIGHT = 0.3
MOE_AUX_WEIGHT = 1e-2
#: the reference's remat policies; "dots" (save the matmuls' outputs)
#: has no counterpart here yet
REMATS = ("none", "full")


def check_ported(cfg) -> None:
    """Raise NotImplementedError for what this slice does not run."""
    later = [name for name, on in (
        ("rwkv", cfg.rwkv is not None), ("ssm", cfg.ssm is not None),
        ("encoder-decoder", cfg.encoder_decoder),
        ("vision tokens", bool(cfg.n_vision_tokens)),
    ) if on]
    if later:
        raise NotImplementedError(f"{cfg.name}: {', '.join(later)} not "
                                  f"ported yet; see {LATER}")


def layer(stack, i: int):
    """Layer i of a stacked (L, ...) parameter or cache tree (views)."""
    return tree_map(lambda t: t[i], stack)


def first_k_dense(cfg) -> int:
    """The leading dense layers of an MoE config (0 without MoE)."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def stacks(cfg):
    """(name, depth, is MoE) of the layer stacks in the order they run:
    `dense_layers` (cache "dense") when the config has `first_k_dense`,
    then `layers` (cache "main")."""
    fk = first_k_dense(cfg)
    out = [("dense", fk, False)] if fk else []
    return out + [("main", cfg.n_layers - fk, cfg.moe is not None)]


#: the parameter stack behind each cache name
STACK_PARAMS = {"dense": "dense_layers", "main": "layers"}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_stack(gen, n: int, make):
    """Stack `n` draws of `make(gen)` into (n, ...) leaves, one layer at
    a time: at full width the weights are built on the card and never
    pass through host memory, and the only temporary is one layer."""
    first = make(gen)
    if n == 1:  # a view: no second copy of a layer (an MoE layer of
        # deepseek-v3-671b is 22.5 GB)
        return tree_map(lambda t: t[None], first)
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
    for name, n, moe in stacks(cfg):
        p[STACK_PARAMS[name]] = _init_stack(
            gen, n, lambda g, moe=moe: blocks.init_tf_block(g, cfg, moe))
    if cfg.mtp_depth:
        d = cfg.d_model
        p["mtp"] = {"proj": _init(gen, (2 * d, d)),
                    "block": blocks.init_tf_block(gen, cfg, False),
                    "norm": init_rmsnorm(d, gen.device)}
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
    counts, dropped, aux = [], [], []
    cache = {} if collect_cache else None

    def block(stack, moe, i, xc):
        return blocks.tf_block_fwd(
            layer(stack, i), xc, cfg=cfg,
            router_bias=extras["router_bias"][i] if moe else None,
            placement=extras["placement"][i] if moe else None,
            return_kv=collect_cache, train=train)

    for name, n, moe in stacks(cfg):
        stack, kvs = params[STACK_PARAMS[name]], []
        for i in range(n):
            if train and remat == "full":
                x, kv, met = checkpoint(block, stack, moe, i, x,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
            else:
                x, kv, met = block(stack, moe, i, x)
            if collect_cache:
                kvs.append(kv)
            if met:
                counts.append(met["expert_counts"])
                dropped.append(met["moe_dropped"])
                if train:
                    aux.append(met["moe_aux_loss"])
        if collect_cache:  # GQA's (k, v) or MLA's latent, a layer each
            cache[name] = tree_map(lambda *t: torch.stack(t), *kvs)
    metrics = {}
    if counts:
        metrics["expert_counts"] = torch.stack(counts)  # (L_moe, E)
        metrics["moe_dropped"] = torch.stack(dropped).sum()
    if aux:
        metrics["moe_aux_loss"] = torch.stack(aux).mean()
    return x, cache, metrics


# ---------------------------------------------------------------------------
# Loss (train)
# ---------------------------------------------------------------------------


def loss_fn(params, batch, extras, cfg, *, loss_chunk: int = 0,
            remat: str = "full"):
    """Next-token cross-entropy (masked by `loss_mask` when the batch has
    one), plus MTP_WEIGHT x the multi-token-prediction loss where the
    config has an MTP head, plus MOE_AUX_WEIGHT x the MoE aux loss.
    `loss_chunk` > 0 takes the sequence-chunked cross-entropy; `remat`
    as `backbone_fwd`. Returns (loss, metrics)."""
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

    if cfg.mtp_depth and "mtp" in params:
        # Multi-token prediction (DeepSeek-V3): predict t+2 from
        # concat(h_t, emb(tok_{t+1})) through one extra block
        mtp = params["mtp"]
        emb_next = embed_fwd(params["embed"], tokens[:, 1:])
        hin = torch.cat([rmsnorm(mtp["norm"], h[:, :-1], cfg.norm_eps),
                         emb_next], -1)
        hm = torch.einsum("bsd,de->bse", hin, mtp["proj"].to(COMPUTE_DT))
        hm, _, _ = blocks.tf_block_fwd(mtp["block"], hm, cfg=cfg,
                                       train=True)
        if loss_chunk:
            tot, cnt = chunked_xent(hm[:, :-1], params["embed"],
                                    tokens[:, 2:], mask[:, 2:], loss_chunk)
            mtp_loss = tot / cnt.clamp(min=1.0)
        else:
            lm2 = lm_head_fwd(params["embed"], hm)
            mtp_loss = softmax_xent(lm2[:, :-1], tokens[:, 2:], mask[:, 2:])
        metrics["mtp_loss"] = mtp_loss
        loss = loss + MTP_WEIGHT * mtp_loss

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
    """Pad the prefill caches along S to cache_len: GQA's (L, B, S, Hkv,
    Dh) pairs, or MLA's latent (L, B, S, r + rope) arrays."""
    check_ported(cfg)

    def pad_seq(arr):
        S = arr.shape[2]
        if S >= cache_len:
            return arr
        out = arr.new_zeros((*arr.shape[:2], cache_len, *arr.shape[3:]))
        out[:, :, :S] = arr
        return out

    if cfg.mla is not None:
        return {name: pad_seq(lat) for name, lat in cache.items()}
    return {name: {"k": pad_seq(kv[0]), "v": pad_seq(kv[1])}
            for name, kv in cache.items()}


def decode_step(params, cache, tokens, pos, extras, cfg):
    """One greedy decode step. tokens: (B,) int; pos: a Python int (or a
    scalar tensor). Writes the new K/V rows (MLA: latent lines) into
    `cache` in place, the dense stack's and then the MoE stack's.

    Returns (cache, logits (B, V))."""
    check_ported(cfg)
    x = embed_fwd(params["embed"], tokens[:, None])
    for name, n, moe in stacks(cfg):
        stack, kv = params[STACK_PARAMS[name]], cache[name]
        for i in range(n):
            x, _ = blocks.tf_block_decode(
                layer(stack, i), x, layer(kv, i), pos, cfg=cfg,
                router_bias=extras["router_bias"][i] if moe else None,
                placement=extras["placement"][i] if moe else None)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head_fwd(params["embed"], h)[:, 0, :]
    return cache, logits
