"""Decoder-only LM assembly — the port of `repro.models.lm`'s init /
loss / prefill / decode for the dense, MoE and MLA + MoE (DeepSeek-V3)
transformer stacks and for the recurrent families: RWKV6 and the
Mamba2 hybrid with zamba2's shared attention block.

Layers are stacked (L, ...) as in the reference and driven by a Python
loop over layers where the reference uses `lax.scan`; training with
`remat="full"` recomputes each block in the backward pass
(`torch.utils.checkpoint`, the reference's `jax.checkpoint` of the scan
body), and `remat="dots"` keeps each block's matrix products and
recomputes the rest (selective checkpointing, the reference's
`checkpoint_dots` policy). With `first_k_dense` the leading dense
layers are a stack of their own, `dense_layers`, run before the MoE
stack `layers`; the router bias and the placement index the MoE stack
only. A config with
`mtp_depth` has the multi-token-prediction head `mtp`, which only the
loss runs. Caches are ``{"main": {"k", "v"}}`` of shape (L, B, Smax,
Hkv, Dh), or for MLA ``{"dense": (Ld, B, Smax, r + rope), "main": (L,
B, Smax, r + rope)}``; RWKV6's is the stacked recurrent carry
``{"state": (L, B, H, N, N) float32, "shift_a", "shift_f": (L, B,
d)}``, zamba2's ``{"mamba": {"ssm": (L, B, H, P, N) float32, "conv":
(L, B, d_conv - 1, di + 2 N)}, "attn_k", "attn_v": (n_inv, B, Smax,
Hkv, Dh)}``, one K/V slice for each invocation of the shared block
(layers 0, shared_every, ...). A config with `n_vision_tokens`
(internvl2) has `vision_proj`: a batch's `vision_embeds` (B, n, d)
through it replace the first n token embeddings (`_embed_inputs`). The
encoder-decoder family (seamless) lives in `models/encdec.py`;
`init_params` dispatches to it, `launch.steps.model_fns` picks its
loss, prefill and decode.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.tree import tree_map
from repro_torch.models import blocks
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as r6
from repro_torch.models.layers import (COMPUTE_DT, _init, _nll,
                                       chunked_xent, embed_fwd, init_embed,
                                       init_rmsnorm, lm_head_fwd, rmsnorm)

MTP_WEIGHT = 0.3
MOE_AUX_WEIGHT = 1e-2
#: the reference's remat policies
REMATS = ("none", "full", "dots")
#: the operators whose outputs "dots" keeps: the matrix products
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
        torch.ops.aten.addmm.default, torch.ops.aten.linear.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_dots_context = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def remat_run(fn, *args, train: bool, remat: str):
    """fn(*args) as a training step runs a block under `remat`: "full"
    keeps only the inputs and recomputes the block in the backward,
    "dots" keeps the matrix products' outputs too (the kernels'
    autograd functions and everything else are recomputed, as
    `checkpoint_dots` recomputes a Pallas call), "none" keeps all."""
    if train and remat == "full":
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    if train and remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=_dots_context)
    return fn(*args)


def layer(stack, i: int):
    """Layer i of a stacked (L, ...) parameter or cache tree (views; on
    a mesh, `parallel.sharding.StackedUse` gathers the layer here)."""
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
    weights across with `models.convert`). An encoder-decoder config
    gets `encdec.init_encdec`'s tree."""
    if cfg.encoder_decoder:
        from repro_torch.models.encdec import init_encdec
        return init_encdec(gen, cfg)
    p: Dict[str, Any] = {
        "embed": init_embed(gen, cfg.padded_vocab, cfg.d_model,
                            cfg.tie_embeddings),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
    }
    d = cfg.d_model
    if cfg.rwkv is not None:
        p["layers"] = _init_stack(
            gen, cfg.n_layers, lambda g: r6.init_rwkv_block(g, d, cfg))
    elif cfg.ssm is not None:  # zamba2 hybrid
        p["layers"] = _init_stack(
            gen, cfg.n_layers, lambda g: m2.init_mamba2(g, d, cfg))
        p["shared_block"] = blocks.init_shared_block(gen, cfg)
    else:
        for name, n, moe in stacks(cfg):
            p[STACK_PARAMS[name]] = _init_stack(
                gen, n, lambda g, moe=moe: blocks.init_tf_block(g, cfg, moe))
    if cfg.n_vision_tokens:
        p["vision_proj"] = _init(gen, (d, d))
    if cfg.mtp_depth:
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


def _embed_inputs(params, batch, cfg):
    """The token embeddings of batch["tokens"] (B, S, d); with vision
    tokens and batch["vision_embeds"] (B, n, d), those through
    `vision_proj` take the first n positions."""
    x = embed_fwd(params["embed"], batch["tokens"])
    if cfg.n_vision_tokens and "vision_embeds" in batch:
        v = torch.matmul(batch["vision_embeds"].to(COMPUTE_DT),
                         params["vision_proj"].to(COMPUTE_DT))
        x = torch.cat([v, x[:, cfg.n_vision_tokens:]], 1)
    return x


def backbone_fwd(params, x, cfg, extras, *, train: bool = False,
                 remat: str = "full", collect_cache: bool = False,
                 px=None, batch_entry=None):
    """Returns (h, cache_or_None, metrics). With `train` each MoE layer
    reports its aux loss (their mean is `moe_aux_loss`), and each block
    runs under `remat_run`. `px` and `batch_entry` (the spec entry of
    the rows x holds) set the MoE dispatch groups."""
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r} not in {REMATS}")

    def run(fn, *args):
        return remat_run(fn, *args, train=train, remat=remat)

    if cfg.rwkv is not None or cfg.ssm is not None:
        recurrent = _rwkv_backbone if cfg.rwkv is not None else \
            _hybrid_backbone
        x, cache = recurrent(params, x, cfg, run, collect_cache)
        return x, cache, {}
    counts, dropped, aux = [], [], []
    cache = {} if collect_cache else None

    def block(stack, moe, i, xc):
        return blocks.tf_block_fwd(
            layer(stack, i), xc, cfg=cfg,
            router_bias=extras["router_bias"][i] if moe else None,
            placement=extras["placement"][i] if moe else None,
            return_kv=collect_cache, train=train, px=px,
            batch_entry=batch_entry)

    for name, n, moe in stacks(cfg):
        stack, kvs = params[STACK_PARAMS[name]], []
        for i in range(n):
            x, kv, met = run(block, stack, moe, i, x)
            if collect_cache:
                kvs.append(kv)
            if met:
                counts.append(met["expert_counts"])
                dropped.append(met["moe_dropped"])
                if train:
                    aux.append(met["moe_aux_loss"])
        if collect_cache:  # GQA's (k, v) or MLA's latent, a layer each
            cache[name] = _stacked(kvs)
    metrics = {}
    if counts:
        metrics["expert_counts"] = torch.stack(counts)  # (L_moe, E)
        metrics["moe_dropped"] = torch.stack(dropped).sum()
    if aux:
        metrics["moe_aux_loss"] = torch.stack(aux).mean()
    return x, cache, metrics


def _stacked(parts):
    """One (L, ...) tree of a list of per-layer trees."""
    return tree_map(lambda *t: torch.stack(t), *parts)


def zero_rwkv_carry(cfg, B: int, device):
    """An RWKV6 layer's carry before the first token: {"state": (B, H,
    N, N) float32, "shift_a", "shift_f": (B, d)} of zeros."""
    H, N, d = cfg.n_heads, cfg.rwkv.head_dim, cfg.d_model
    return {
        "state": torch.zeros((B, H, N, N), dtype=torch.float32,
                             device=device),
        "shift_a": torch.zeros((B, d), dtype=COMPUTE_DT, device=device),
        "shift_f": torch.zeros((B, d), dtype=COMPUTE_DT, device=device),
    }


def _rwkv_backbone(params, x, cfg, run, collect_cache):
    """RWKV6: every layer starts its chunked scan from a zero carry and
    leaves its final carry as the cache. Returns (h, cache or None)."""
    zero = zero_rwkv_carry(cfg, x.shape[0], x.device)
    carries = []

    def body(p_layer, xc):
        return r6.rwkv_block_fwd(p_layer, xc, zero, cfg=cfg)

    for i in range(cfg.n_layers):
        x, carry = run(body, layer(params["layers"], i), x)
        if collect_cache:  # the shifts are views of a whole (B, S, d)
            carries.append(tree_map(lambda t: t.contiguous(), carry))
    return x, (_stacked(carries) if collect_cache else None)


def shared_slot(cfg, i: int):
    """zamba2's shared block runs before Mamba2 layer `i` when `i` is a
    multiple of `shared_every`: the index of that invocation's K/V
    slice, or None."""
    return i // cfg.shared_every if i % cfg.shared_every == 0 else None


def n_shared(cfg) -> int:
    """How many times zamba2's shared block runs in one pass (0 for a
    model without one)."""
    se = cfg.shared_every
    return -(-cfg.n_layers // se) if se else 0


def zero_mamba_carry(cfg, B: int, device):
    """A Mamba2 layer's carry before the first token: {"ssm": (B, H, P,
    N) float32, "conv": (B, d_conv - 1, di + 2 N)} of zeros."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {
        "ssm": torch.zeros((B, di // s.head_dim, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((B, s.d_conv - 1, di + 2 * s.d_state),
                            dtype=COMPUTE_DT, device=device),
    }


def _hybrid_backbone(params, x, cfg, run, collect_cache):
    """zamba2: the shared block (on concat(h, emb0)) before every
    `shared_every`-th Mamba2 layer, each Mamba2 layer from a zero carry.
    Returns (h, cache or None)."""
    zero = zero_mamba_carry(cfg, x.shape[0], x.device)
    emb0 = x
    ks, vs, mstates = [], [], []

    def body(p_m, xc, e0, shared: bool):
        kv = None
        if shared:
            xc, kv = blocks.shared_block_fwd(
                params["shared_block"], xc, e0, cfg=cfg,
                return_kv=collect_cache)
        xc, mcarry = m2.mamba2_fwd(p_m, xc, zero, cfg=cfg)
        return xc, kv, mcarry

    for i in range(cfg.n_layers):
        x, kv, mcarry = run(body, layer(params["layers"], i), x, emb0,
                            shared_slot(cfg, i) is not None)
        if collect_cache:
            mstates.append(mcarry)
            if kv is not None:
                ks.append(kv[0].to(COMPUTE_DT))
                vs.append(kv[1].to(COMPUTE_DT))
    if not collect_cache:
        return x, None
    return x, {"mamba": _stacked(mstates), "attn_k": torch.stack(ks),
               "attn_v": torch.stack(vs)}


# ---------------------------------------------------------------------------
# Loss (train)
# ---------------------------------------------------------------------------


def masked_xent(h, p_embed, labels, mask, loss_chunk: int = 0, px=None,
                batch_entry=None):
    """sum(mask * nll) / max(sum(mask), 1) of the LM head on h (B, S, d)
    at positions :-1 against labels and mask (B, S - 1), over the
    microbatch's rows: on a distributed mesh h holds this rank's rows
    (`batch_entry`) and the count is summed over the rows' ranks, so the
    ranks' terms add up to the loss. `loss_chunk` > 0 takes the
    sequence-chunked cross-entropy."""
    if loss_chunk:
        tot, cnt = chunked_xent(h[:, :-1], p_embed, labels, mask,
                                loss_chunk)
    else:
        mask = mask.float()
        logits = lm_head_fwd(p_embed, h)
        tot = (_nll(logits[:, :-1], labels) * mask).sum()
        cnt = mask.sum()
    if px is not None:
        cnt = px.row_sum(cnt, batch_entry)
    return tot / cnt.clamp(min=1.0)


def loss_fn(params, batch, extras, cfg, *, loss_chunk: int = 0,
            remat: str = "full", px=None, batch_entry=None):
    """Next-token cross-entropy (masked by `loss_mask` when the batch has
    one), plus MTP_WEIGHT x the multi-token-prediction loss where the
    config has an MTP head, plus MOE_AUX_WEIGHT x the MoE aux loss.
    `loss_chunk` > 0 takes the sequence-chunked cross-entropy; `remat`
    as `backbone_fwd`. On a distributed mesh (`px`) the batch is this
    rank's rows (`batch_entry`) and the loss and metrics are its shares
    of the microbatch's (`masked_xent`). Returns (loss, metrics)."""
    tokens = batch["tokens"]
    x = _embed_inputs(params, batch, cfg)
    h, _, metrics = backbone_fwd(params, x, cfg, extras, train=True,
                                 remat=remat, px=px,
                                 batch_entry=batch_entry)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
    loss = masked_xent(h, params["embed"], tokens[:, 1:],
                       mask[:, 1:], loss_chunk, px, batch_entry)
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
        mtp_loss = masked_xent(hm, params["embed"], tokens[:, 2:],
                               mask[:, 2:], loss_chunk, px, batch_entry)
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
    identity placement). The caches are padded to `cache_len`. A batch
    may carry `vision_embeds` (`_embed_inputs`)."""
    tokens = batch["tokens"]
    x = _embed_inputs(params, batch, cfg)
    h, cache, _ = backbone_fwd(params, x, cfg,
                               init_extras(cfg, tokens.device),
                               collect_cache=True)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = lm_head_fwd(params["embed"], h[:, -1:, :])
    return _pad_cache_to(cache, cfg, cache_len), logits


def _pad_cache_to(cache, cfg, cache_len: int):
    """Pad the prefill caches along S to cache_len: GQA's (L, B, S, Hkv,
    Dh) pairs, MLA's latent (L, B, S, r + rope) arrays, or zamba2's
    (n_inv, B, S, Hkv, Dh) K/V stacks. RWKV6's carry has no S; an
    encoder-decoder's caches are allocated at their size by its
    prefill."""
    if cfg.rwkv is not None or cfg.encoder_decoder:
        return cache

    def pad_seq(arr):
        S = arr.shape[2]
        if S >= cache_len:
            return arr
        out = arr.new_zeros((*arr.shape[:2], cache_len, *arr.shape[3:]))
        out[:, :, :S] = arr
        return out

    if cfg.ssm is not None:
        return dict(cache, attn_k=pad_seq(cache["attn_k"]),
                    attn_v=pad_seq(cache["attn_v"]))
    if cfg.mla is not None:
        return {name: pad_seq(lat) for name, lat in cache.items()}
    return {name: {"k": pad_seq(kv[0]), "v": pad_seq(kv[1])}
            for name, kv in cache.items()}


def decode_step(params, cache, tokens, pos, extras, cfg):
    """One greedy decode step. tokens: (B,) int; pos: a Python int (or a
    scalar tensor). Writes the new K/V rows (MLA: latent lines) into
    `cache` in place, the dense stack's and then the MoE stack's; the
    recurrent families replace each layer's carry in place (zamba2 also
    writes each shared-block invocation's K/V row).

    Returns (cache, logits (B, V))."""
    x = embed_fwd(params["embed"], tokens[:, None])
    if cfg.rwkv is not None or cfg.ssm is not None:
        x = _recurrent_decode(params, cache, x, pos, cfg)
    else:
        x = _stacks_decode(params, cache, x, pos, extras, cfg)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head_fwd(params["embed"], h)[:, 0, :]
    return cache, logits


def _stacks_decode(params, cache, x, pos, extras, cfg):
    """The transformer stacks of one decode step on x (B, 1, d), dense
    stack first; K/V rows written into `cache` in place. Returns h."""
    for name, n, moe in stacks(cfg):
        stack, kv = params[STACK_PARAMS[name]], cache[name]
        for i in range(n):
            x, _ = blocks.tf_block_decode(
                layer(stack, i), x, layer(kv, i), pos, cfg=cfg,
                router_bias=extras["router_bias"][i] if moe else None,
                placement=extras["placement"][i] if moe else None)
    return x


def _recurrent_decode(params, cache, x, pos, cfg):
    """The layers of one decode step of RWKV6 or zamba2 on x (B, 1, d);
    every layer's carry is copied into `cache` in place. Returns h."""
    def store(dst, src):
        tree_map(lambda a, b: a.copy_(b), dst, src)

    if cfg.rwkv is not None:
        for i in range(cfg.n_layers):
            c = layer(cache, i)
            x, new = r6.rwkv_decode_step(layer(params["layers"], i), x, c,
                                         cfg=cfg)
            store(c, new)
        return x
    emb0 = x
    for i in range(cfg.n_layers):
        j = shared_slot(cfg, i)
        if j is not None:
            kv = {"k": cache["attn_k"][j], "v": cache["attn_v"][j]}
            x, _ = blocks.shared_block_decode(params["shared_block"], x,
                                              emb0, kv, pos, cfg=cfg)
        c = layer(cache["mamba"], i)
        x, new = m2.mamba2_fwd(layer(params["layers"], i), x, c, cfg=cfg,
                               decode=True)
        store(c, new)
    return x
