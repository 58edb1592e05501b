"""Load-balancing constraints on the self-clustering outcome (paper §4.4),
the port of `repro.core.balance`.

Symmetric: per-LP inbound migrations equal outbound. Flow decomposition
on the candidate matrix: pairwise swaps first, then ring rotations at
every shift, then a final swap pass on the residual; every granted unit
lies on a 2-cycle or an L-cycle, so each LP's SE count is invariant.

Asymmetric: grants additionally drain over-target LPs toward
under-target ones, so the allocation drifts to the capacity profile.

Within a granted (s, d) quota the highest-alpha SEs go first. Counts
are built with `index_add_` rather than `bincount`, which would wait for
the device to size its output.
"""
from __future__ import annotations

import torch

from repro_torch.fp32 import div32


def bincount(idx, length: int):
    """`bincount(idx, minlength=length)` as int32, without a host sync."""
    out = torch.zeros(length, dtype=torch.int32, device=idx.device)
    return out.index_add_(0, idx.long(), torch.ones_like(idx,
                                                         dtype=torch.int32))


def _off_diag(L: int, like):
    return 1 - torch.eye(L, dtype=like.dtype, device=like.device)


def candidate_matrix(candidate, lp, dest, n_lp: int):
    """cand[s, d] = number of SEs on LP s wanting to migrate to LP d."""
    pair = lp * n_lp + dest
    flat = torch.where(candidate, pair, torch.full_like(pair, n_lp * n_lp))
    return bincount(flat, n_lp * n_lp + 1)[:-1].reshape(n_lp, n_lp)


def _swap_pass(cand):
    return torch.minimum(cand, cand.T) * _off_diag(cand.shape[0], cand)


def symmetric_grants(cand):
    """Count-preserving grants <= cand: swaps + full-ring rotations."""
    L = cand.shape[0]
    cand = cand * _off_diag(L, cand)
    g = _swap_pass(cand)
    resid = cand - g
    rows = torch.arange(L, device=cand.device)
    for k in range(1, L):  # ring s -> (s+k) % L, flow = min edge
        idx = (rows + k) % L
        f = resid[rows, idx].min()
        g = g.index_put((rows, idx), f.expand(L), accumulate=True)
        resid = resid.index_put((rows, idx), -f.expand(L), accumulate=True)
    return g + _swap_pass(resid)


def asymmetric_grants(cand, current, capacity):
    """Symmetric core + extra one-way grants draining toward the target
    allocation n_se * capacity (capacity float32, sums to 1)."""
    g = symmetric_grants(cand)
    n_lp = cand.shape[0]
    total = current.sum()
    target = torch.round(capacity * total.float()).to(torch.int32)
    surplus = (current - target).clamp(min=0)
    deficit = (target - current).clamp(min=0)
    room = (cand - g).clamp(min=0)  # remaining unidirectional wishes
    # proportional fill of each destination's deficit from willing sources
    colsum = room.sum(0).clamp(min=1)
    share = room * torch.minimum(deficit, colsum)[None, :]
    extra = torch.floor(div32(share, colsum[None, :])).to(cand.dtype)
    # a source may not give away more than its surplus
    rowsum = extra.sum(1).clamp(min=1)
    scale = div32(torch.minimum(surplus, rowsum), rowsum)
    extra = torch.floor(extra.float() * scale[:, None]).to(cand.dtype)
    return g + extra * _off_diag(n_lp, cand)


def select_migrations(candidate, lp, dest, alpha, grants, n_lp: int,
                      tiebreak=None):
    """Admit the top-alpha candidates within each (src, dst) grant quota.

    The order is the reference's `lexsort((tiebreak, -alpha, pair))`
    — pair ascending, alpha descending, tiebreak ascending — built from
    three stable sorts, least significant key first. `tiebreak`
    defaults to the array index."""
    n = candidate.shape[0]
    dev = candidate.device
    pair = (lp * n_lp + dest).to(torch.int32)
    pair = torch.where(candidate, pair, torch.full_like(pair, n_lp * n_lp))
    if tiebreak is None:
        order = torch.arange(n, device=dev)
    else:
        order = torch.argsort(tiebreak, stable=True)
    order = order[torch.argsort(-alpha[order], stable=True)]
    order = order[torch.argsort(pair[order], stable=True)]
    sp = pair[order].long()
    counts = bincount(pair, n_lp * n_lp + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[sp]
    quota = grants.reshape(-1)
    admit_sorted = (sp < n_lp * n_lp) & (
        rank < quota[sp.clamp(max=n_lp * n_lp - 1)])
    admit = torch.zeros(n, dtype=torch.bool, device=dev)
    admit[order] = admit_sorted
    return admit & candidate
