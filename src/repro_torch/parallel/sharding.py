"""Name-based partition rules for parameter / optimizer / cache trees —
the port of `repro.parallel.sharding` — and what a spec means here.

Specs are derived from leaf names + shapes so one rule set covers every
architecture. Stacked layer params (leading L dim) get a None prefix
automatically. Dims that don't divide the axis size fall back to
replication (e.g. 4 KV heads on a 16-way model axis). A spec is `P`, a
tuple with one entry a dim; `P()` is `()`.

PyTorch has no partitioner, so the port spells out what a layout means
on a live mesh:

- Storage follows the specs. A rank holds, of each leaf, its block:
  dim i cut into `axis_size(spec[i])` contiguous blocks and block
  `index(spec[i])` kept, an axis tuple's first axis major, as a
  `NamedSharding` tiles (`shard_tree`; `gather_tree` inverts it). Under
  `zero1` the optimizer state and master weights are held at
  `opt_specs`' blocks; under `fsdp` the params at the data-axis block
  `zero1_spec` adds.
- Weights are gathered where they are used, one layer at a time: `Use`
  is an autograd function whose forward all-gathers a block over the
  axes its spec names and whose backward sums the gradient over the
  ranks that computed other rows and keeps this rank's block.
  `use_tree` wraps a param tree: a stacked (L, ...) leaf becomes a
  `StackedUse`, whose `[i]` gathers layer i (so `models.lm.layer` and a
  remat recompute gather again), any other leaf is gathered once.
- Compute follows the batch spec: a rank computes the rows
  `batch_spec(B)` gives its coordinates, and ranks that agree on those
  axes compute alike. The matrix products are not split over the model
  axis (tensor parallelism is a speed matter for a machine of several
  cards, ROADMAP.md).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.parallel.ctx import P, NamedSharding, ParallelCtx, axes_of

#: the top-level param keys whose leaves are (L, ...) layer stacks
STACK_KEYS = ("layers", "dense_layers", "enc_layers", "dec_layers")


def _rules(px: ParallelCtx):
    m = lambda d: px.shard_if(d, px.model_axis)

    def rule(name, shape, in_moe: bool):
        n = name
        if n in ("embedding",):  # (V, D)
            return (m(shape[-2]), None)
        if n in ("lm_head",):  # (D, V)
            return (None, m(shape[-1]))
        if n in ("wq", "wk", "wv"):  # (d, H, Dh)
            return (None, m(shape[-2]), None)
        if n in ("bq", "bk", "bv"):  # (H, Dh)
            return (m(shape[-2]), None)
        if n == "wo" and len(shape) >= 3:  # (H, Dh, d)
            return (m(shape[-3]), None, None)

        def fsdp_entry(dim):
            # fsdp: shard the expert contraction dim over the data axes
            if not px.fsdp or not px.batch_axes:
                return None
            ba = tuple(px.batch_axes) if len(px.batch_axes) > 1 \
                else px.batch_axes[0]
            return px.shard_if(dim, ba)

        def expert_entry(dim):
            # 2-D EP: experts shard over (data x model) jointly (px.ep2d)
            if px.ep2d and px.ep_axes is not None \
                    and dim % px.axis_size(px.ep_axes) == 0:
                return px.ep_axes
            return m(dim)

        # MoE expert weights are identified by their dict path ("moe"
        # key, outside the dense "shared" sub-dict), not by shape:
        # stacked dense (L, d, f) looks like per-layer experts (E, d, f)
        if n in ("w_gate", "w_up"):
            if in_moe:  # experts (E, d, f): EP over model, fsdp over d
                ee = expert_entry(shape[-3])
                fs = None if isinstance(ee, tuple) else fsdp_entry(shape[-2])
                return (ee, fs, None)
            return (None, m(shape[-1]))  # dense (d, f): column parallel
        if n == "w_down":
            if in_moe:  # experts (E, f, d)
                ee = expert_entry(shape[-3])
                fs = None if isinstance(ee, tuple) else fsdp_entry(shape[-2])
                return (ee, fs, None)
            return (m(shape[-2]), None)  # dense (f, d) / zamba (2d, d)
        if n == "router":  # (d, E)
            return (None, m(shape[-1]))
        # MLA
        if n in ("w_dq", "w_dkv"):
            return (None, None)
        if n in ("w_uq", "w_uk", "w_uv"):  # (r, H, hd)
            return (None, m(shape[-2]), None)
        # rwkv6
        if n in ("t_r", "t_k", "t_v", "t_g"):  # (d, d) -> column parallel
            return (None, m(shape[-1]))
        if n == "t_o":  # (d, d) -> row parallel
            return (m(shape[-2]), None)
        if n == "ck":  # (d, ff)
            return (None, m(shape[-1]))
        if n == "cv":  # (ff, d)
            return (m(shape[-2]), None)
        # mamba2
        if n == "w_in":  # (d, 2di+2N+H)
            return (None, m(shape[-1]))
        if n == "w_out":  # (di, d)
            return (m(shape[-2]), None)
        if n == "proj":  # mtp (2d, d)
            return (m(shape[-2]), None)
        return None  # replicate

    return rule


def _map_path(fn, tree, path=()):
    """fn(path of dict keys, leaf) over a tree of dicts / tuples / lists
    (the tree's containers kept)."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_map_path(fn, v, path) for v in tree)
    if tree is None:
        return None
    return fn(path, tree)


def param_specs(params_shape: Any, px: ParallelCtx):
    """Map a tree of tensors (on the `meta` device: only shapes are read)
    to `P` specs.

    With ``px.fsdp`` every spec is additionally extended with data-axis
    sharding on its largest free dim (ZeRO-3 / FSDP)."""
    rule = _rules(px)

    def visit(path, leaf):
        name = path[-1] if path else None
        in_moe = "moe" in path and "shared" not in path
        shape = tuple(leaf.shape)
        trailing = rule(name, shape, in_moe) if name else None
        if trailing is None:
            spec = P()
        else:
            prefix = (None,) * (len(shape) - len(trailing))
            spec = P(*(prefix + tuple(trailing)))
        if px.fsdp:
            spec = zero1_spec(spec, shape, px)
        return spec

    return _map_path(visit, params_shape)


def zero1_spec(spec: P, shape, px: ParallelCtx) -> P:
    """Extend a param spec with data-axis sharding on the largest
    unsharded, divisible dim (ZeRO-1 optimizer-state partitioning)."""
    if px.mesh is None or not px.batch_axes:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                used.add(a)
    avail = [a for a in px.batch_axes if a not in used]
    if not avail:
        return spec
    # try the whole group first, then suffixes (innermost axes first)
    for lo in range(len(avail)):
        group = tuple(avail[lo:])
        size = 1
        for a in group:
            size *= px.mesh.shape[a]
        best, best_dim = -1, -1
        for i, (e, d) in enumerate(zip(entries, shape)):
            if e is None and d % size == 0 and d > best:
                best, best_dim = d, i
        if best_dim >= 0:
            entries[best_dim] = group if len(group) > 1 else group[0]
            return P(*entries)
    return spec


def _map2(fn, specs, shapes):
    """fn(spec, leaf) over a spec tree and the tree of its leaves."""
    if isinstance(specs, dict):
        return {k: _map2(fn, specs[k], shapes[k]) for k in specs}
    if isinstance(specs, (tuple, list)) and not isinstance(specs, P):
        return type(specs)(_map2(fn, s, l) for s, l in zip(specs, shapes))
    if specs is None:
        return None
    return fn(specs, shapes)


def opt_specs(param_specs_tree, params_shape, px: ParallelCtx,
              zero1: bool = True, factored: bool = False,
              lean: bool = False):
    """Optimizer-state specs matching adamw_init / adafactor_init /
    adafactor_lean_init."""
    def one(spec, leaf):
        return zero1_spec(spec, tuple(leaf.shape), px) if zero1 else spec

    mv = _map2(one, param_specs_tree, params_shape)
    if not factored:
        return {"m": mv, "v": mv, "master": mv, "step": P()}

    def drop(spec, leaf, axis_from_end):
        # vr drops the last dim, vc the second-to-last (see adafactor_init)
        shape = tuple(leaf.shape)
        if len(shape) < 2 or shape[-1] <= 1 or shape[-2] <= 1:
            return P() if axis_from_end == 2 else spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        del entries[len(shape) - axis_from_end]
        return P(*entries)

    vr = _map2(lambda s, l: drop(one(s, l), l, 1), param_specs_tree,
               params_shape)
    vc = _map2(lambda s, l: drop(one(s, l), l, 2), param_specs_tree,
               params_shape)
    if lean:
        return {"vr": vr, "vc": vc, "step": P()}
    return {"m": mv, "vr": vr, "vc": vc, "master": mv, "step": P()}


def to_shardings(spec_tree, px: ParallelCtx):
    if px.mesh is None:
        return None
    return _map_path(lambda _, s: NamedSharding(px.mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# Blocks on a live mesh
# ---------------------------------------------------------------------------


def _entries(spec, ndim: int):
    return list(spec) + [None] * (ndim - len(spec))


def block_of(x: torch.Tensor, spec, px: ParallelCtx) -> torch.Tensor:
    """This rank's block of the whole tensor x under `spec` (a view)."""
    for dim, e in enumerate(_entries(spec, x.dim())):
        n = px.axis_size(e)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, px.index(e) * size, size)
    return x


def _gather_dim(x: torch.Tensor, dim: int, entry, px: ParallelCtx):
    """x's blocks of every rank along `entry`, concatenated on `dim`."""
    if not px.distributed:
        return x
    y = x.contiguous()
    parts = [torch.empty_like(y) for _ in range(px.axis_size(entry))]
    dist.all_gather(parts, y, group=px.mesh.group(axes_of(entry)))
    return torch.cat(parts, dim)


def gather_block(x: torch.Tensor, spec, px: ParallelCtx) -> torch.Tensor:
    """The whole tensor from this rank's block x under `spec`. Every
    rank of the mesh must call it with the same spec; without a process
    group the block is the whole tensor."""
    for dim, e in enumerate(_entries(spec, x.dim())):
        if px.axis_size(e) > 1:
            x = _gather_dim(x, dim, e, px)
    return x


def reblock(x: torch.Tensor, src, dst, px: ParallelCtx) -> torch.Tensor:
    """A block under spec `src` taken to spec `dst`, dim by dim: a dim
    that `dst` shards and `src` does not is cut, one that `src` shards
    and `dst` does not is gathered."""
    ent_s, ent_d = _entries(src, x.dim()), _entries(dst, x.dim())
    for dim, (s, d) in enumerate(zip(ent_s, ent_d)):
        if s == d:
            continue
        if s is None:
            n = px.axis_size(d)
            size = x.shape[dim] // n
            x = x.narrow(dim, px.index(d) * size, size)
        elif d is None:
            x = _gather_dim(x, dim, s, px)
        else:
            raise ValueError(f"cannot take dim {dim} from {s!r} to {d!r}")
    return x


def owns(spec, px: ParallelCtx) -> bool:
    """True on the one rank of each set of ranks holding the same block
    under `spec`: coordinate 0 on every axis the spec does not name."""
    if px.mesh is None or not px.mesh.live:
        return True
    named = {a for e in spec for a in axes_of(e)}
    return all(c == 0 for a, c in px.mesh.coords.items() if a not in named)


def shard_tree(tree, spec_tree, px: ParallelCtx):
    """This rank's blocks of a tree of whole tensors (the counterpart of
    `jax.device_put(x, NamedSharding)`); contiguous copies."""
    return _map_spec(lambda x, s: block_of(x, s, px).contiguous(), tree,
                     spec_tree)


def gather_tree(tree, spec_tree, px: ParallelCtx):
    """The whole tensors of a tree of this rank's blocks."""
    return _map_spec(lambda x, s: gather_block(x, s, px), tree, spec_tree)


def _map_spec(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_spec(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_spec(fn, v, s) for v, s in zip(tree, specs))
    if tree is None:
        return None
    return fn(tree, specs)


# ---------------------------------------------------------------------------
# Weights gathered at use
# ---------------------------------------------------------------------------


class Use(torch.autograd.Function):
    """block -> the whole tensor, gathered over the axes `spec` names.
    The backward sums the whole gradient over the ranks along `rows`
    (those that computed the other rows of the batch) and keeps this
    rank's block: each row's gradient counted once."""

    @staticmethod
    def forward(ctx, block, spec, rows, px):
        ctx.spec, ctx.rows, ctx.px = spec, rows, px
        return gather_block(block, spec, px)

    @staticmethod
    def backward(ctx, g):
        px = ctx.px
        if px.distributed and ctx.rows is not None:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=px.mesh.group(axes_of(ctx.rows)))
        return block_of(g, ctx.spec, px).contiguous(), None, None, None


class StackedUse:
    """A stacked (L, ...) block whose `[i]` is layer i gathered by `Use`
    (the layer's spec drops the L entry)."""

    def __init__(self, block, spec, rows, px):
        self.block, self.spec, self.rows, self.px = block, spec, rows, px

    def __getitem__(self, i):
        return Use.apply(self.block[i], P(*tuple(self.spec)[1:]), self.rows,
                         self.px)


def use_tree(params, specs, rows, px: ParallelCtx):
    """The param tree as the model code reads it on a live mesh: under
    `STACK_KEYS` each leaf a `StackedUse`, every other leaf gathered by
    `Use` now. `rows`: the batch spec entry of the rows this rank
    computes. Off a distributed mesh every block is the whole leaf and
    the tree is returned as it is."""
    if not px.distributed:
        return params
    out = {}
    for k, v in params.items():
        if k in STACK_KEYS:
            out[k] = _map_spec(lambda b, s: StackedUse(b, s, rows, px), v,
                               specs[k])
        else:
            out[k] = _map_spec(lambda b, s: Use.apply(b, s, rows, px), v,
                               specs[k])
    return out


def global_norm(grads, specs, px: ParallelCtx):
    """The L2 norm of a gradient held in blocks under `specs`: each
    leaf's norm accumulated in float64 on its blocks, squared, summed
    over the ranks (a block held by several ranks counted once), then
    the norm of the leaves' norms, float32 — on one rank the bits of
    `optim.adamw.global_norm`."""
    sq = []
    flat_g, flat_s = [], []
    _flatten2(grads, specs, flat_g, flat_s)
    for g, s in zip(flat_g, flat_s):
        n = torch.linalg.vector_norm(g, dtype=torch.float64)
        sq.append(n * n if owns(s, px) else torch.zeros_like(n))
    sq = torch.stack(sq)
    if px.distributed:
        dist.all_reduce(sq)
    return torch.linalg.vector_norm(torch.sqrt(sq)).float()


def _flatten2(tree, specs, out_t, out_s):
    """Leaves of `tree` and their specs, in the reference's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten2(tree[k], specs[k], out_t, out_s)
    elif isinstance(tree, (tuple, list)):
        for x, s in zip(tree, specs):
            _flatten2(x, s, out_t, out_s)
    elif tree is not None:
        out_t.append(tree)
        out_s.append(specs)
