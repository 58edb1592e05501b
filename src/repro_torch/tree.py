"""Nested containers of tensors (the port's pytrees): dicts, tuples and
lists, with leaves in the reference's order.

`jax.tree_util` flattens a dict by its sorted keys and a tuple or list
in order; the port's optimizers, gradient sums and checkpoints walk the
leaves in that same order, so a global norm adds its terms as the
reference does and a checkpoint's `leaf_i` is the reference's leaf i.
None is an empty node, as in JAX.
"""
from __future__ import annotations

import torch


def _walk(t, out: list) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _walk(t[k], out)
    elif isinstance(t, (tuple, list)):
        for x in t:
            _walk(x, out)
    elif t is not None:
        out.append(t)


def leaves(tree) -> list:
    """The leaves of `tree` in the reference's order. (A module-level
    walk: a nested function that calls itself is a reference cycle, which
    would hold the list, and so every leaf, until the garbage collector
    ran.)"""
    out = []
    _walk(tree, out)
    return out


def structure(tree):
    """A JSON-able description of `tree`'s containers, leaves as None."""
    if isinstance(tree, dict):
        return {"dict": {k: structure(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [structure(x) for x in tree]}
    return {"none": None} if tree is None else None


def _build(s, it):
    if s is None:
        return next(it)
    (kind, body), = s.items()
    if kind == "dict":
        return {k: _build(v, it) for k, v in body.items()}
    if kind == "none":
        return None
    seq = [_build(x, it) for x in body]
    return tuple(seq) if kind == "tuple" else seq


def unflatten(struct, flat) -> object:
    """The tree of `structure` with `flat`'s leaves, in order."""
    it = iter(flat)
    out = _build(struct, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn, *trees):
    """fn over the leaves of trees of one structure; the result has the
    first tree's containers (dict keys in its own order)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    if t0 is None:
        return None
    return fn(*trees)


def unzip(like, out, n: int) -> tuple:
    """n trees of `like`'s structure from `out`, a tree of `like`'s
    structure whose leaves are n-tuples."""
    return tuple(tree_map(lambda _, o: o[i], like, out) for i in range(n))


def zeros_f32(t):
    """float32 zeros of `t`'s shape on its device."""
    return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
