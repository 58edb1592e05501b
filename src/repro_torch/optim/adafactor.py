"""Adafactor [arXiv:1804.04235] with bf16 momentum and fp32 master
weights, and its lean variant (no master, no momentum, bf16 weights
updated with stochastic rounding) — the port of `repro.optim.adafactor`.

The lean variant's rounding noise is `jax.random.bits` under the key
`fold_in(fold_in(key(17), step), leaf index)`, drawn by
`repro_torch.random`, so the port rounds to the reference's bits.
"""
from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch import tree
from repro_torch.optim.adamw import AdamWConfig, clip_scale, global_norm, lr_at

_MASK = 0xFFFFFFFF


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _vrow(p):
    shape = p.shape[:-1] if _factored(p.shape) else p.shape
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def _vcol(p):
    shape = (p.shape[:-2] + p.shape[-1:]) if _factored(p.shape) else (1,)
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree.leaves(params)[0].device)


def adafactor_init(params):
    return {
        "m": tree.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.bfloat16, device=p.device), params),
        "vr": tree.tree_map(_vrow, params),
        "vc": tree.tree_map(_vcol, params),
        "master": tree.tree_map(lambda p: p.float().clone(), params),
        "step": _step0(params),
    }


def _second_moment(g, vr, vc, decay: float):
    """The factored (or, for a vector, plain) second-moment update and
    the RMS-clipped update direction u."""
    g2 = torch.square(g) + 1e-30
    if _factored(g.shape):
        vr = decay * vr + (1 - decay) * g2.mean(-1)
        vc = decay * vc + (1 - decay) * g2.mean(-2)
        denom = (vr[..., None] * vc[..., None, :]
                 / vr.mean(-1)[..., None, None].clamp(min=1e-30))
        u = g * torch.rsqrt(denom + 1e-30)
    else:
        vr = decay * vr + (1 - decay) * g2
        u = g * torch.rsqrt(vr + 1e-30)
    # update clipping (RMS <= 1) per the paper
    rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
    return vr, vc, u / rms.clamp(min=1.0)


def adafactor_apply(c: AdamWConfig, grads, state, params,
                    decay: float = 0.999, gnorm=None):
    step = state["step"] + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = clip_scale(c, gnorm)
    lr = lr_at(c, step)

    def upd(g, m, vr, vc, w):
        vr, vc, u = _second_moment(g.float() * scale, vr, vc, decay)
        m32 = c.beta1 * m.float() + (1 - c.beta1) * u
        w = w - lr * (m32 + c.weight_decay * w)
        return m32.to(torch.bfloat16), vr, vc, w

    out = tree.tree_map(upd, grads, state["m"], state["vr"], state["vc"],
                        state["master"])
    m, vr, vc, master = tree.unzip(grads, out, 4)
    new_state = {"m": m, "vr": vr, "vc": vc, "master": master, "step": step}
    new_params = tree.tree_map(lambda w, p: w.to(p.dtype), master, params)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Lean variant: no master, no momentum, stochastic-rounding bf16 updates
# ---------------------------------------------------------------------------


def _stochastic_round_bf16(key, x32):
    """Unbiased float32 -> bf16 rounding: add uniform 16-bit noise below
    the bf16 mantissa and truncate, on uint32 words held in int64."""
    bits = x32.contiguous().view(torch.int32).long() & _MASK
    noise = trandom.bits(key, x32.shape, device=x32.device) & 0xFFFF
    trunc = (bits + noise) & 0xFFFF0000
    trunc = torch.where(trunc >= 1 << 31, trunc - (1 << 32), trunc)
    return trunc.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def adafactor_lean_init(params):
    return {
        "vr": tree.tree_map(_vrow, params),
        "vc": tree.tree_map(_vcol, params),
        "step": _step0(params),
    }


def adafactor_lean_apply(c: AdamWConfig, grads, state, params,
                         decay: float = 0.999, gnorm=None):
    """The step number keys the rounding noise, so it is read on the
    host once a call."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = clip_scale(c, gnorm)
    lr = lr_at(c, step)
    base_key = trandom.fold_in(trandom.key(17), int(step))
    flat_g = tree.leaves(grads)
    index = {id(g): i for i, g in enumerate(flat_g)}

    def upd(g, vr, vc, w):
        vr, vc, u = _second_moment(g.float() * scale, vr, vc, decay)
        w32 = w.float()
        w32 = w32 - lr * (u + c.weight_decay * w32)
        if w.dtype == torch.bfloat16:
            w = _stochastic_round_bf16(
                trandom.fold_in(base_key, index[id(g)]), w32)
        else:
            w = w32.to(w.dtype)
        return vr, vc, w

    out = tree.tree_map(upd, grads, state["vr"], state["vc"], params)
    vr, vc, new_params = tree.unzip(grads, out, 3)
    new_state = {"vr": vr, "vc": vc, "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
