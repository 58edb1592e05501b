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

Every function takes a leading replica axis too: per-SE inputs (R, N),
candidate and grant matrices (R, L, L). Replica r's result is the solo
call's on its slice: the ring's per-edge minimum is taken per replica,
and the admission order's stable sorts take the replica as their most
significant key.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.neighbors import replica_offsets
from repro_torch.fp32 import div32


def bincount(idx, length: int):
    """`bincount(idx, minlength=length)` as int32, without a host sync;
    (R, length) counts of each replica's row of an (R, N) `idx`."""
    n_rep = idx.shape[0] if idx.dim() > 1 else 1
    flat = idx.long()
    if idx.dim() > 1:
        flat = flat + replica_offsets(n_rep, length, idx.device)
    out = torch.zeros(n_rep * length, dtype=torch.int32, device=idx.device)
    out.index_add_(0, flat.reshape(-1), torch.ones(
        flat.numel(), dtype=torch.int32, device=idx.device))
    return out.view(idx.shape[:-1] + (length,))


def _off_diag(L: int, like):
    return 1 - torch.eye(L, dtype=like.dtype, device=like.device)


def candidate_matrix(candidate, lp, dest, n_lp: int):
    """cand[s, d] = number of SEs on LP s wanting to migrate to LP d."""
    pair = lp * n_lp + dest
    flat = torch.where(candidate, pair, torch.full_like(pair, n_lp * n_lp))
    return bincount(flat, n_lp * n_lp + 1)[..., :-1].reshape(
        lp.shape[:-1] + (n_lp, n_lp))


def _swap_pass(cand):
    return torch.minimum(cand, cand.transpose(-2, -1)) * \
        _off_diag(cand.shape[-1], cand)


def symmetric_grants(cand):
    """Count-preserving grants <= cand: swaps + full-ring rotations."""
    L = cand.shape[-1]
    cand = cand * _off_diag(L, cand)
    g = _swap_pass(cand)
    resid = cand - g
    rows = torch.arange(L, device=cand.device)
    for k in range(1, L):  # ring s -> (s+k) % L, flow = min edge
        idx = (rows + k) % L
        f = resid[..., rows, idx].amin(-1)[..., None, None]
        flow = f * _ring(L, k, cand.dtype, cand.device)
        g = g + flow
        resid = resid - flow
    return g + _swap_pass(resid)


@functools.lru_cache(maxsize=64)
def _ring(L: int, k: int, dtype, device):
    """(L, L) ones at (s, (s + k) % L): the ring of shift k."""
    return torch.eye(L, dtype=dtype, device=device).roll(k, dims=1)


def asymmetric_grants(cand, current, capacity):
    """Symmetric core + extra one-way grants draining toward the target
    allocation n_se * capacity (capacity float32, sums to 1)."""
    g = symmetric_grants(cand)
    n_lp = cand.shape[-1]
    total = current.sum(-1, keepdim=True)
    target = torch.round(capacity * total.float()).to(torch.int32)
    surplus = (current - target).clamp(min=0)
    deficit = (target - current).clamp(min=0)
    room = (cand - g).clamp(min=0)  # remaining unidirectional wishes
    # proportional fill of each destination's deficit from willing sources
    colsum = room.sum(-2).clamp(min=1)
    share = room * torch.minimum(deficit, colsum)[..., None, :]
    extra = torch.floor(div32(share, colsum[..., None, :])).to(cand.dtype)
    # a source may not give away more than its surplus
    rowsum = extra.sum(-1).clamp(min=1)
    scale = div32(torch.minimum(surplus, rowsum), rowsum)
    extra = torch.floor(extra.float() * scale[..., None]).to(cand.dtype)
    return g + extra * _off_diag(n_lp, cand)


def select_migrations(candidate, lp, dest, alpha, grants, n_lp: int,
                      tiebreak=None):
    """Admit the top-alpha candidates within each (src, dst) grant quota.

    The order is the reference's `lexsort((tiebreak, -alpha, pair))`
    — pair ascending, alpha descending, tiebreak ascending — built from
    three stable sorts, least significant key first; a batch sorts all
    replicas' rows at once under the key (replica, pair). `tiebreak`
    defaults to the array index."""
    lead, n = candidate.shape[:-1], candidate.shape[-1]
    n_rep = lead[0] if lead else 1
    dev = candidate.device
    LL = n_lp * n_lp
    pair = (lp * n_lp + dest).to(torch.int32)
    pair = torch.where(candidate, pair, torch.full_like(pair, LL))
    if lead:  # replica r's keys after replica r - 1's
        pair = pair + replica_offsets(n_rep, LL + 1, dev, torch.int32)
    pair, alpha = pair.reshape(-1), alpha.reshape(-1)
    if tiebreak is None:
        order = torch.arange(n_rep * n, device=dev)
    else:
        order = torch.argsort(tiebreak.reshape(-1), stable=True)
    order = order[torch.argsort(-alpha[order], stable=True)]
    order = order[torch.argsort(pair[order], stable=True)]
    sp = pair[order].long()
    counts = bincount(pair, n_rep * (LL + 1))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n_rep * n, device=dev) - starts[sp]
    quota = grants.reshape(-1)
    if lead:  # (replica, pair) -> row of the (R * L * L) quotas
        rep = sp // (LL + 1)
        sp = sp - rep * (LL + 1)
        q = quota[rep * LL + sp.clamp(max=LL - 1)]
    else:
        q = quota[sp.clamp(max=LL - 1)]
    admit_sorted = (sp < LL) & (rank < q)
    admit = torch.zeros(n_rep * n, dtype=torch.bool, device=dev)
    admit[order] = admit_sorted
    return admit.view(candidate.shape) & candidate
