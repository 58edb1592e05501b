"""DiLoCo-style cross-pod training (arXiv:2311.08105) — the port of
`repro.optim.diloco`.

Each pod runs H local AdamW steps on its own data; every H steps the
pods exchange only the parameter *delta* and an outer Nesterov-momentum
optimizer applies the pod-averaged delta to the global weights. The
outer step composes with the q8 compressed all-reduce in
`optim/compress.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class DiLoCoConfig:
    inner_steps: int = 50  # H
    outer_lr: float = 0.7
    outer_momentum: float = 0.9  # Nesterov


def diloco_init(params):
    return {
        "global": tree.tree_map(lambda p: p.float().clone(), params),
        "velocity": tree.tree_map(tree.zeros_f32, params),
    }


def outer_step(cfg: DiLoCoConfig, state, pod_params_mean) -> Tuple[Any, Any]:
    """Apply the outer Nesterov update given the POD-AVERAGED inner
    parameters after H local steps, in float32, in the reference's
    order.

    Returns (new_state, new_start_params) — every pod restarts its inner
    loop from the updated global weights."""
    delta = tree.tree_map(lambda g, p: g - p.float(), state["global"],
                          pod_params_mean)  # outer "gradient"
    vel = tree.tree_map(lambda v, d: cfg.outer_momentum * v + d,
                        state["velocity"], delta)
    new_global = tree.tree_map(
        lambda g, v, d: g - cfg.outer_lr * (cfg.outer_momentum * v + d),
        state["global"], vel, delta)
    return {"global": new_global, "velocity": vel}, new_global
