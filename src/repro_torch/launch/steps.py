"""Step functions — the port of `repro.launch.steps`: `model_fns` (a
family's loss, prefill and decode), `build_train_step` and
`build_serve_step` (no jit signatures: PyTorch runs eagerly, so
`build_*` returns the step function itself), and `_param_sds`, the
parameter tree's shapes and dtypes on the `meta` device.

`build_train_step` wires together the model loss, microbatched gradient
accumulation (float32 accumulators, or bf16), the optimizer chosen by
name with fp32 master weights, and the aux-free MoE router-bias update
after each microbatch. Its knobs are a `ParallelCtx`'s; `TrainCtx(...)`
is the shorthand `make_ctx(None, ...)`, validated.

Under a mesh (`px.mesh`) the step takes and returns this rank's blocks
of the params under `train_specs`' param specs and of the optimizer
state under its optimizer specs (`shard_state` cuts them from whole
trees), and the whole batch, of which each microbatch's rows under
`px.batch_spec` are this rank's to compute (`parallel/sharding.py` says
what the layouts mean). The losses are shares that add up over the
rows' ranks to the reference's (`models.lm.masked_xent`); the metrics,
the expert counts that move the router bias, and the gradient are summed
over those ranks; the clipping norm is the whole gradient's
(`sharding.global_norm`). Under `zero1` the optimizer updates its
blocks and the new param blocks are gathered from them. One step body
serves with a mesh and without: there every block is the whole leaf and
every sum over ranks is the value itself.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.optim.adafactor import (adafactor_apply, adafactor_init,
                                         adafactor_lean_apply,
                                         adafactor_lean_init)
from repro_torch.optim.adamw import AdamWConfig, adamw_apply, adamw_init
from repro_torch.parallel import sharding
from repro_torch.parallel.ctx import ParallelCtx, make_ctx

BIAS_LR = 1e-3  # aux-free router bias update rate (DeepSeek-V3)

#: optimizer name -> (init, apply)
OPTIMIZERS = {
    "adamw": (adamw_init, adamw_apply),
    "adafactor": (adafactor_init, adafactor_apply),
    "adafactor_lean": (adafactor_lean_init, adafactor_lean_apply),
}
GRAD_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _validate(px: ParallelCtx) -> ParallelCtx:
    if px.optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer={px.optimizer!r} not in "
                         f"{sorted(OPTIMIZERS)}")
    if px.grad_dtype not in GRAD_DTYPES:
        raise ValueError(f"grad_dtype={px.grad_dtype!r} not in "
                         f"{sorted(GRAD_DTYPES)}")
    if px.remat not in lm_mod.REMATS:
        raise ValueError(f"remat={px.remat!r} not in {lm_mod.REMATS}")
    return px


def TrainCtx(**knobs) -> ParallelCtx:
    """`make_ctx(None, **knobs)`: the training knobs of a mesh-less
    context (num_microbatches, remat "none" | "full" | "dots",
    grad_dtype "f32" | "bf16", loss_chunk, optimizer "adamw" |
    "adafactor" | "adafactor_lean"), validated: a value the step cannot
    take raises ValueError here."""
    return _validate(make_ctx(None, **knobs))


class MetaGen:
    """A stand-in for a `torch.Generator` on the `meta` device: `init_*`
    then build leaves of the right shapes and dtypes and draw nothing."""
    device = torch.device("meta")


def _param_sds(cfg):
    """cfg's parameter tree on the `meta` device (no bytes)."""
    return lm_mod.init_params(MetaGen(), cfg)


def model_fns(cfg):
    """(loss_fn, prefill_fn, decode_fn) for this architecture family:
    `models.encdec`'s for an encoder-decoder, else `models.lm`'s."""
    if cfg.encoder_decoder:
        return (encdec_mod.encdec_loss, encdec_mod.encdec_prefill,
                encdec_mod.encdec_decode)
    return lm_mod.loss_fn, lm_mod.prefill, lm_mod.decode_step


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


def opt_init(px: ParallelCtx):
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


def train_specs(cfg, px: ParallelCtx):
    """(param specs, optimizer-state specs) of cfg's trees under px, as
    the reference's step lays them out."""
    p_sds = _param_sds(cfg)
    p_spec = sharding.param_specs(p_sds, px)
    o_spec = sharding.opt_specs(
        p_spec, p_sds, px, zero1=px.zero1,
        factored=px.optimizer.startswith("adafactor"),
        lean=px.optimizer == "adafactor_lean")
    return p_spec, o_spec


def shard_state(cfg, px: ParallelCtx, params, opt_state):
    """This rank's blocks of whole params and optimizer state."""
    p_spec, o_spec = train_specs(cfg, px)
    return (sharding.shard_tree(params, p_spec, px),
            sharding.shard_tree(opt_state, o_spec, px))


def build_train_step(cfg, shape, px: Optional[ParallelCtx] = None,
                     opt: Optional[AdamWConfig] = None):
    """train_step(params, opt_state, extras, batch) -> (params, opt_state,
    extras, metrics): one optimizer step over `shape.global_batch` rows
    in `px.num_microbatches` microbatches. The batch may hold numpy
    arrays (they go to the params' device). Metrics are device scalars:
    the loss and the loss function's scalar metrics averaged over the
    microbatches, then the optimizer's `grad_norm` and `lr`. Under a
    mesh the params and optimizer state are this rank's blocks (see the
    module docstring); without one every block is the whole leaf and
    every sum over ranks is the value itself.

    Raises ValueError for a mesh of several devices that spans no
    `torch.distributed` processes (`make_production_mesh`, a bare
    `Mesh`): its blocks would be cut and never gathered."""
    px = _validate(px or TrainCtx())
    opt = opt or AdamWConfig()
    M = px.num_microbatches
    if shape.global_batch % M:
        raise ValueError(f"global batch {shape.global_batch} is not a "
                         f"multiple of {M} microbatches")
    if px.optimizer != "adamw" and px.n_devices > 1:
        raise NotImplementedError(
            f"optimizer={px.optimizer!r} on a mesh of {px.n_devices} "
            f"devices: its factored moments reduce over dims a block "
            f"splits; adamw is the optimizer the port shards")
    if px.n_devices > 1 and not px.distributed:
        raise ValueError(
            f"a mesh of {px.n_devices} devices without a process group: "
            f"train on `make_local_mesh` inside `torch.distributed`")
    apply = OPTIMIZERS[px.optimizer][1]
    loss_fn = model_fns(cfg)[0]
    gdt = GRAD_DTYPES[px.grad_dtype]
    p_spec, o_spec = train_specs(cfg, px)
    # the optimizer's per-param-leaf spec (its moments and master; the
    # lean variant updates the params themselves)
    mv_spec = o_spec.get("master", p_spec)

    def train_step(params, opt_state, extras, batch):
        dev = tree.leaves(params)[0].device
        batch = _on(batch, dev)
        rows = next(iter(batch.values())).shape[0]
        if rows % M:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{M} microbatches")
        mb = rows // M
        entry = px.batch_spec(mb)  # the rows' spec entry
        mine = mb // px.axis_size(entry)
        lo = px.index(entry) * mine
        p_req = tree.tree_map(lambda t: t.detach().requires_grad_(), params)
        flat = tree.leaves(p_req)
        gacc = [torch.zeros(p.shape, dtype=gdt, device=dev) for p in flat]
        scalars = []
        for i in range(M):
            b = {k: v[i * mb + lo:i * mb + lo + mine]
                 for k, v in batch.items()}
            view = sharding.use_tree(p_req, p_spec, entry, px)
            loss, metrics = loss_fn(view, b, extras, cfg,
                                    loss_chunk=px.loss_chunk,
                                    remat=px.remat, px=px,
                                    batch_entry=entry)
            grads = torch.autograd.grad(loss, flat)
            del view
            metrics = {k: px.row_sum(v.detach(), entry)
                       for k, v in metrics.items()}
            extras = _update_router_bias(extras, metrics)
            for a, g in zip(gacc, grads):
                a.add_(g.to(gdt))
            del grads
            sc = {k: v for k, v in metrics.items() if v.dim() == 0}
            sc["loss"] = px.row_sum(loss.detach(), entry)
            scalars.append(sc)
        for a in gacc:  # in place: no second copy of the accumulators
            a.div_(M)
        grads = tree.unflatten(tree.structure(params), gacc)
        del gacc, p_req, flat
        # the optimizer's blocks: under zero1 a finer cut of the params'
        g_o = _map3(lambda g, ps, os: sharding.reblock(g, ps, os, px),
                    grads, p_spec, mv_spec)
        p_o = _map3(lambda p, ps, os: sharding.reblock(p, ps, os, px),
                    params, p_spec, mv_spec)
        gnorm = sharding.global_norm(g_o, mv_spec, px)
        new_o, opt_state, om = apply(opt, g_o, opt_state, p_o, gnorm=gnorm)
        del grads, g_o, p_o
        params = _map3(lambda p, ps, os: sharding.reblock(p, os, ps, px),
                       new_o, p_spec, mv_spec)
        metrics = {k: torch.stack([s[k] for s in scalars]).float().mean()
                   for k in scalars[0]}
        metrics.update(om)
        return params, opt_state, extras, metrics

    return train_step


def _map3(fn, t, s1, s2):
    """fn(leaf, spec1, spec2) over a tree and two spec trees."""
    if isinstance(t, dict):
        return {k: _map3(fn, v, s1[k], s2[k]) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_map3(fn, *xs) for xs in zip(t, s1, s2))
    if t is None:
        return None
    return fn(t, s1, s2)


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------


def build_serve_step(cfg):
    """serve_step(params, extras, cache, tokens, pos) -> (cache,
    next_tokens (B,) int32): one greedy decode step. The cache is
    updated in place."""
    decode = model_fns(cfg)[2]

    def serve_step(params, extras, cache, tokens, pos):
        cache, logits = decode(params, cache, tokens, pos, extras, cfg)
        return cache, argmax_first(logits)

    return serve_step
