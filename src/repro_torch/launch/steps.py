"""Step functions — the port of `repro.launch.steps` on one device:
`build_train_step` and `build_serve_step` (no shardings or jit
signatures: PyTorch runs eagerly, so `build_*` returns the step
function itself).

`build_train_step` wires together the model loss, microbatched gradient
accumulation (float32 accumulators, or bf16), the optimizer chosen by
name with fp32 master weights, and the aux-free MoE router-bias update
after each microbatch. Its knobs are `TrainCtx`'s: the names and
defaults of the reference's `ParallelCtx` fields it reads (the mesh,
sharding and ZeRO knobs belong to the LM stack's parallelism).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.models import lm as lm_mod
from repro_torch.optim.adafactor import (adafactor_apply, adafactor_init,
                                         adafactor_lean_apply,
                                         adafactor_lean_init)
from repro_torch.optim.adamw import AdamWConfig, adamw_apply, adamw_init

BIAS_LR = 1e-3  # aux-free router bias update rate (DeepSeek-V3)

#: optimizer name -> (init, apply)
OPTIMIZERS = {
    "adamw": (adamw_init, adamw_apply),
    "adafactor": (adafactor_init, adafactor_apply),
    "adafactor_lean": (adafactor_lean_init, adafactor_lean_apply),
}
GRAD_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainCtx:
    """The training knobs of the reference's `ParallelCtx`, same names
    and defaults."""
    num_microbatches: int = 1
    remat: str = "full"  # "none" | "full"
    grad_dtype: str = "f32"  # "f32" | "bf16"
    loss_chunk: int = 0  # sequence-chunked cross-entropy (0 = off)
    optimizer: str = "adamw"  # "adamw" | "adafactor" | "adafactor_lean"

    def __post_init__(self):
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer={self.optimizer!r} not in "
                             f"{sorted(OPTIMIZERS)}")
        if self.grad_dtype not in GRAD_DTYPES:
            raise ValueError(f"grad_dtype={self.grad_dtype!r} not in "
                             f"{sorted(GRAD_DTYPES)}")
        if self.remat not in lm_mod.REMATS:
            raise ValueError(f"remat={self.remat!r} not in {lm_mod.REMATS}")


def argmax_first(logits):
    """argmax over the last dim taking the FIRST maximal index, as
    jnp.argmax does: bf16 logits tie often enough for this to matter."""
    V = logits.shape[-1]
    top = logits.max(-1, keepdim=True).values
    ids = torch.arange(V, device=logits.device)
    return torch.where(logits == top, ids, V).min(-1).values.to(torch.int32)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def opt_init(px: TrainCtx):
    """The init function of `px.optimizer`'s state."""
    return OPTIMIZERS[px.optimizer][0]


def _update_router_bias(extras, metrics):
    """Aux-loss-free balancing: push the selection bias of overloaded
    experts down, underloaded up (sign update, DeepSeek-V3 §2.1.2)."""
    if "expert_counts" not in metrics or "router_bias" not in extras:
        return extras
    counts = metrics["expert_counts"].float()  # (Lmoe, E)
    mean = counts.mean(-1, keepdim=True)
    bias = extras["router_bias"] + BIAS_LR * torch.sign(mean - counts)
    return dict(extras, router_bias=bias)


def _on(batch, device):
    """A batch of numpy arrays or tensors as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def build_train_step(cfg, shape, px: Optional[TrainCtx] = None,
                     opt: Optional[AdamWConfig] = None):
    """train_step(params, opt_state, extras, batch) -> (params, opt_state,
    extras, metrics): one optimizer step over `shape.global_batch` rows
    in `px.num_microbatches` microbatches. The batch may hold numpy
    arrays (they go to the params' device). Metrics are device scalars:
    the loss and the loss function's scalar metrics averaged over the
    microbatches, then the optimizer's `grad_norm` and `lr`."""
    lm_mod.check_ported(cfg)
    px = px or TrainCtx()
    opt = opt or AdamWConfig()
    M = px.num_microbatches
    if shape.global_batch % M:
        raise ValueError(f"global batch {shape.global_batch} is not a "
                         f"multiple of {M} microbatches")
    apply = OPTIMIZERS[px.optimizer][1]
    gdt = GRAD_DTYPES[px.grad_dtype]

    def train_step(params, opt_state, extras, batch):
        dev = tree.leaves(params)[0].device
        batch = _on(batch, dev)
        rows = next(iter(batch.values())).shape[0]
        if rows % M:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{M} microbatches")
        mb = rows // M
        p_req = tree.tree_map(lambda t: t.detach().requires_grad_(), params)
        flat = tree.leaves(p_req)
        gacc = [torch.zeros(p.shape, dtype=gdt, device=dev) for p in flat]
        scalars = []
        for i in range(M):
            b = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics = lm_mod.loss_fn(p_req, b, extras, cfg,
                                           loss_chunk=px.loss_chunk,
                                           remat=px.remat)
            grads = torch.autograd.grad(loss, flat)
            extras = _update_router_bias(extras, metrics)
            for a, g in zip(gacc, grads):
                a.add_(g.to(gdt))
            del grads
            sc = {k: v.detach() for k, v in metrics.items() if v.dim() == 0}
            sc["loss"] = loss.detach()
            scalars.append(sc)
        for a in gacc:  # in place: no second copy of the accumulators
            a.div_(M)
        grads = tree.unflatten(tree.structure(params), gacc)
        del gacc, p_req, flat
        params, opt_state, om = apply(opt, grads, opt_state, params)
        metrics = {k: torch.stack([s[k] for s in scalars]).float().mean()
                   for k in scalars[0]}
        metrics.update(om)
        return params, opt_state, extras, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------


def build_serve_step(cfg):
    """serve_step(params, extras, cache, tokens, pos) -> (cache,
    next_tokens (B,) int32): one greedy decode step. The cache is
    updated in place."""
    lm_mod.check_ported(cfg)

    def serve_step(params, extras, cache, tokens, pos):
        cache, logits = lm_mod.decode_step(params, cache, tokens, pos,
                                           extras, cfg)
        return cache, argmax_first(logits)

    return serve_step
