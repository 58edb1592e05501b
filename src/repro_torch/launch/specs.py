"""Shape stand-ins + partition specs for every model input — the port
of `repro.launch.specs`.

``input_specs(arch, shape)`` gives (stand-in tree, spec tree). Where the
reference builds `jax.ShapeDtypeStruct`s, the stand-ins here are tensors
on the `meta` device: a shape and a dtype, and no bytes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.encdec import FRAME_DIM
from repro_torch.models.layers import COMPUTE_DT
from repro_torch.parallel.ctx import P, ParallelCtx


def SDS(shape, dtype) -> torch.Tensor:
    """A stand-in of `shape` and `dtype` on the `meta` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch_P(px: ParallelCtx, b: int, *rest) -> P:
    return P(px.batch_spec(b), *rest)


# ---------------------------------------------------------------------------
# Batch inputs
# ---------------------------------------------------------------------------


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig, px: ParallelCtx
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    B, S = shape.global_batch, shape.seq_len
    sds = {"tokens": SDS((B, S), torch.int32),
           "loss_mask": SDS((B, S), torch.float32)}
    spec = {"tokens": _batch_P(px, B, None),
            "loss_mask": _batch_P(px, B, None)}
    if cfg.encoder_decoder:
        sds["frames"] = SDS((B, S, FRAME_DIM), COMPUTE_DT)
        spec["frames"] = _batch_P(px, B, None, None)
    if cfg.n_vision_tokens:
        sds["vision_embeds"] = SDS((B, cfg.n_vision_tokens, cfg.d_model),
                                   COMPUTE_DT)
        spec["vision_embeds"] = _batch_P(px, B, None, None)
    return sds, spec


def prefill_batch_specs(cfg, shape, px):
    B, S = shape.global_batch, shape.seq_len
    if cfg.encoder_decoder:
        return ({"frames": SDS((B, S, FRAME_DIM), COMPUTE_DT)},
                {"frames": _batch_P(px, B, None, None)})
    sds = {"tokens": SDS((B, S), torch.int32)}
    spec = {"tokens": _batch_P(px, B, None)}
    if cfg.n_vision_tokens:
        sds["vision_embeds"] = SDS((B, cfg.n_vision_tokens, cfg.d_model),
                                   COMPUTE_DT)
        spec["vision_embeds"] = _batch_P(px, B, None, None)
    return sds, spec


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, px: ParallelCtx):
    """(sds_tree, spec_tree) for the KV/state cache at shape.seq_len."""
    B, S = shape.global_batch, shape.seq_len
    b = px.batch_spec(B)
    seq = (px.seq_mega_spec(S) if B == 1
           else px.shard_if(S, px.model_axis))
    L, d = cfg.n_layers, cfg.d_model

    if cfg.encoder_decoder:
        Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        kv = lambda: SDS((L, B, S, Hkv, Dh), COMPUTE_DT)
        sp = P(None, b, seq, None, None)
        return ({"self": {"k": kv(), "v": kv()},
                 "cross": {"k": kv(), "v": kv()}},
                {"self": {"k": sp, "v": sp}, "cross": {"k": sp, "v": sp}})

    if cfg.rwkv is not None:
        H, N = cfg.n_heads, cfg.rwkv.head_dim
        h_entry = px.shard_if(H, px.model_axis)
        return ({"state": SDS((L, B, H, N, N), torch.float32),
                 "shift_a": SDS((L, B, d), COMPUTE_DT),
                 "shift_f": SDS((L, B, d), COMPUTE_DT)},
                {"state": P(None, b, h_entry, None, None),
                 "shift_a": P(None, b, None), "shift_f": P(None, b, None)})

    if cfg.ssm is not None:  # zamba2
        s = cfg.ssm
        di = s.expand * d
        H = di // s.head_dim
        n_inv = (L + cfg.shared_every - 1) // cfg.shared_every
        hd2 = 2 * d // cfg.n_heads
        ch = di + 2 * s.d_state
        h_entry = px.shard_if(H, px.model_axis)
        return ({"mamba": {"ssm": SDS((L, B, H, s.head_dim, s.d_state),
                                      torch.float32),
                           "conv": SDS((L, B, s.d_conv - 1, ch), COMPUTE_DT)},
                 "attn_k": SDS((n_inv, B, S, cfg.n_kv_heads, hd2), COMPUTE_DT),
                 "attn_v": SDS((n_inv, B, S, cfg.n_kv_heads, hd2), COMPUTE_DT)},
                {"mamba": {"ssm": P(None, b, h_entry, None, None),
                           "conv": P(None, b, None, None)},
                 "attn_k": P(None, b, seq, None, None),
                 "attn_v": P(None, b, seq, None, None)})

    if cfg.mla is not None:  # deepseek: latent line cache
        r = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        fk = cfg.moe.first_k_dense if cfg.moe else 0
        out_sds = {"main": SDS((L - fk, B, S, r), COMPUTE_DT)}
        out_sp = {"main": P(None, b, seq, None)}
        if fk:
            out_sds["dense"] = SDS((fk, B, S, r), COMPUTE_DT)
            out_sp["dense"] = P(None, b, seq, None)
        return out_sds, out_sp

    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    fk = cfg.moe.first_k_dense if cfg.moe else 0
    kv = lambda n: {"k": SDS((n, B, S, Hkv, Dh), COMPUTE_DT),
                    "v": SDS((n, B, S, Hkv, Dh), COMPUTE_DT)}
    sp = {"k": P(None, b, seq, None, None), "v": P(None, b, seq, None, None)}
    out_sds = {"main": kv(L - fk)}
    out_sp = {"main": sp}
    if fk:
        out_sds["dense"] = kv(fk)
        out_sp["dense"] = dict(sp)
    return out_sds, out_sp


def decode_input_specs(cfg, shape, px):
    B = shape.global_batch
    cache_sds, cache_sp = cache_specs(cfg, shape, px)
    sds = {"cache": cache_sds,
           "tokens": SDS((B,), torch.int32),
           "pos": SDS((), torch.int32)}
    spec = {"cache": cache_sp,
            "tokens": P(px.batch_spec(B)),
            "pos": P()}
    return sds, spec


def input_specs(cfg: ArchConfig, shape: ShapeConfig, px: ParallelCtx):
    """Dispatch on the shape kind. Returns (sds_tree, spec_tree)."""
    if shape.kind == "train":
        return train_batch_specs(cfg, shape, px)
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape, px)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape, px)
    raise ValueError(shape.kind)
