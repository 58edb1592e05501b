"""Plain versions of the capacity-assignment kernel.

`capacity_assign_plain`: the costs go to the host, a stable numpy sort
orders them, and a Python loop admits (SE, LP) pairs in that order
until every SE is placed. The CPU path runs it and `chip_smoke.py`
holds the kernel to it on the card.

`capacity_assign_rounds`: the kernel's parallel rounds for weights of
exactly 0 or 1, written in plain torch (see `csrc/capacity_assign.cu`
for why they give the greedy scan's map). Only the tests call it.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x: float) -> float:
    return float(np.float32(x))


def _caps(caps):
    return np.asarray(caps.cpu() if torch.is_tensor(caps) else caps,
                      np.float32)


def capacity_assign_plain(cost, weights, caps):
    """cost (N, L) float32, weights (N,) float32, caps (L,) float32
    (numpy or tensor) -> (N,) int32 on cost's device: admit pairs in
    ascending cost (ties to the lower flat index i * L + l); an SE takes
    the first LP whose filled weight plus its own (a float32 sum) stays
    within the LP's cap; an SE no LP fits takes the LP with the most
    capacity left (the first on ties)."""
    n, L = cost.shape
    order = np.argsort(cost.reshape(-1).cpu().numpy(), kind="stable").tolist()
    w = weights.cpu().tolist()
    cap = [float(c) for c in _caps(caps)]
    fill = [0.0] * L
    assigned = [-1] * n
    left = n
    for flat in order:
        i = flat // L
        if assigned[i] >= 0:
            continue
        l = flat - i * L
        s = _f32(fill[l] + w[i])
        if s <= cap[l]:
            assigned[i], fill[l] = l, s
            left -= 1
            if not left:
                break
    if left:
        spare = np.asarray(cap, np.float32) - np.asarray(fill, np.float32)
        fallback = int(np.argmax(spare))
        assigned = [fallback if a < 0 else a for a in assigned]
    return torch.tensor(assigned, dtype=torch.int32, device=cost.device)


def _rounds_apply(weights, caps) -> bool:
    """Whether the kernel takes its rounds branch: every weight exactly
    0 or 1, every cap >= 0 and not NaN, fewer than 2^24 SEs, and the
    largest rank packed with an LP index in 31 bits."""
    w, c = weights.cpu(), _caps(caps)
    n, L = w.shape[0], c.shape[0]
    lp_bits = (L - 1).bit_length()
    return bool(((w == 0) | (w == 1)).all()) and bool((c >= 0).all()) \
        and n < 2 ** 24 and (n * L - 1) << lp_bits < 2 ** 31 - 1


def capacity_assign_rounds(cost, weights, caps):
    """The kernel's rounds on the CPU: -> ((N,) int32 map, rounds run).
    Raises ValueError where `_rounds_apply` is false.

    Each pair's rank is its place in the stable sort of the flat costs.
    A weight-0 SE takes its lowest-ranked LP. A unit SE applies to its
    lowest-ranked LP whose threshold admits its rank; an LP with more
    applicants than its quota floor(cap) lowers its threshold to the
    quota-th smallest applicant rank, and its rejected applicants apply
    again in the next round. Unit SEs no LP admits take the LP with the
    most capacity left (cap - count in float32, the first on ties)."""
    if not _rounds_apply(weights, caps):
        raise ValueError("the rounds take weights of 0 or 1, caps >= 0 "
                         "and packed ranks within 31 bits")
    n, L = cost.shape
    order = np.argsort(cost.reshape(-1).cpu().numpy(), kind="stable")
    rank = torch.empty(n * L, dtype=torch.int64)
    rank[torch.from_numpy(order)] = torch.arange(n * L)
    rank = rank.view(n, L)
    cap = torch.from_numpy(_caps(caps))
    quota = torch.where(cap >= n, torch.tensor(float(n)),
                        torch.floor(cap)).long()
    unit = weights.cpu() == 1
    thresh = torch.full((L,), n * L, dtype=torch.int64)
    lp = torch.full((n,), -1, dtype=torch.int64)
    moving = unit.clone()
    rounds = 0
    while True:
        rounds += 1
        ranked = torch.where(rank[moving] <= thresh, rank[moving], n * L)
        best, pick = ranked.min(1)
        lp[moving] = torch.where(best < n * L, pick, -1)
        app = rank.gather(1, lp.clamp(min=0)[:, None])[:, 0]
        placed = unit & (lp >= 0)
        count = torch.bincount(lp[placed], minlength=L)
        over = count > quota
        if not over.any():
            break
        for l in over.nonzero()[:, 0].tolist():
            q = int(quota[l])
            thresh[l] = -1 if q == 0 else int(
                app[placed & (lp == l)].kthvalue(q).values)
        moving = placed & (app > thresh[lp.clamp(min=0)])
    lp[~unit] = rank[~unit].argmin(1)
    fallback = int(torch.argmax(cap - count.float()))
    lp[unit & (lp < 0)] = fallback
    return lp.to(torch.int32).to(cost.device), rounds
