"""AdamW with fp32 master weights, global-norm clipping and a linear
warmup + cosine schedule — the port of `repro.optim.adamw` on one device
(no ZeRO sharding: that belongs to the LM stack's parallelism).

Trees are the port's nested dicts of tensors (`repro_torch.tree`),
walked in the reference's order. The step count is a 0-d int32 tensor and
the schedule is computed on its device, so a step never waits on the
host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def lr_at(c: AdamWConfig, step):
    """The learning rate at `step` (an int or a 0-d tensor), float32."""
    step = torch.as_tensor(step).float()
    warm = c.lr * step / max(c.warmup_steps, 1)
    t = ((step - c.warmup_steps)
         / max(c.total_steps - c.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.1 * c.lr + 0.9 * c.lr * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < c.warmup_steps, warm, cos)


def adamw_init(params):
    dev = tree.leaves(params)[0].device
    return {
        "m": tree.tree_map(tree.zeros_f32, params),
        "v": tree.tree_map(tree.zeros_f32, params),
        "master": tree.tree_map(lambda p: p.float().clone(), params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads):
    """The gradients' L2 norm, float32: each leaf's norm accumulated in
    float64, then the norm of those.

    The reference sums float32 squares, so a norm past ~1.8e19 is inf
    there and its clip then zeroes the whole step; seamless-m4t-medium's
    random-weight gradients at full width get there. Below that the two
    agree to float32 rounding (a deliberate difference, ROADMAP.md
    §3)."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float64)
             for g in tree.leaves(grads)]
    return torch.linalg.vector_norm(torch.stack(norms)).float()


def clip_scale(c: AdamWConfig, gnorm):
    return torch.clamp(c.clip_norm / gnorm.clamp(min=1e-12), max=1.0)


def adamw_apply(c: AdamWConfig, grads, state, params):
    """Returns (new_params in the params' dtypes, new_state, metrics).

    The state's m, v and master leaves are updated IN PLACE, leaf by
    leaf (the reference returns new ones): at full width a second copy
    of the optimizer state would not fit beside the first. Each
    operation rounds as the reference's `upd` does."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = clip_scale(c, gnorm)
    lr = lr_at(c, step)
    b1c = 1 - torch.pow(c.beta1, step.float())
    b2c = 1 - torch.pow(c.beta2, step.float())

    def upd(g, m, v, w, p):
        g = g.float() * scale
        m.mul_(c.beta1).add_((1 - c.beta1) * g)
        v.mul_(c.beta2).add_((1 - c.beta2) * torch.square(g))
        mh = m / b1c
        vh = v / b2c
        w.sub_(lr * (mh / (torch.sqrt(vh) + c.eps) + c.weight_decay * w))
        return w.to(p.dtype, copy=True)

    new_params = tree.tree_map(upd, grads, state["m"], state["v"],
                               state["master"], params)
    new_state = dict(state, step=step)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
