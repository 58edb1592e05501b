"""Plain version of the capacity-assignment kernel: the costs go to the
host, a stable numpy sort orders them, and a Python loop admits (SE,
LP) pairs in that order until every SE is placed. The CPU path runs it
and `chip_smoke.py` holds the kernel to it on the card.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x: float) -> float:
    return float(np.float32(x))


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
    cap = [float(c) for c in np.asarray(
        caps.cpu() if torch.is_tensor(caps) else caps, np.float32)]
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
