"""Initial and periodic SE -> LP partitioning, the port of
`repro.core.partition`.

    partition(key, pos, weights, cfg) -> lp   # (N,) int32

Backends, as in the reference:

  "random"        the paper's §5.1 baseline: a random permutation of the
                  round-robin assignment, bit-identical for the same key
  "stripe"        slabs along x (ties by y, then id) cut at the capacity
                  shares' cumulative-weight boundaries
  "kmeans"        balanced Lloyd iterations: toroidal-distance assignment
                  under per-LP capacity bounds, circular-mean centroids
  "bestresponse"  node-level best response over the proximity graph:
                  each round every SE's affinity to each LP is its
                  in-range neighbors there (the dense proximity kernel,
                  every SE a sender), admitted by descending affinity
                  under the capacity bounds; seeded from "stripe"
  "voronoi"       toroidal Voronoi seeds relaxed by fuzzy c-means, with
                  a membership bonus (`hysteresis`) on the previous LP
                  when `prev` is given

Parity. "random", "stripe" and "bestresponse" go through sorts, integer
counts and sums of unit weights only, so their maps equal the
reference's. "kmeans" and "voronoi" go through `sin`, `cos`, `arctan2`,
`pow` and float matmuls, whose last bits differ between XLA and PyTorch
(and between the CPU and the card); their maps agree wherever no two
costs lie within those bits of each other. The reference runs the init
eagerly except for its loops (`fori_loop`, `scan`), which XLA compiles
and fuses; `compiled=True` (the engine's periodic repartition) fuses
the distance outside the loops too.

`capacity_assign` is a sequential greedy scan over the N * L (SE, LP)
pairs in ascending cost. On the card it is a stable device sort and one
launch of a one-block kernel (`kernels/capacity_assign`); on the CPU
its plain version, a host loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.fp32 import div32, f32, fma32
from repro_torch.kernels.capacity_assign import ops as ca_ops
from repro_torch.kernels.proximity import ops as prox

PARTITION_BACKENDS = ("random", "stripe", "kmeans", "bestresponse",
                     "voronoi")

#: backends whose map depends on the previous SE -> LP assignment
_USES_PREV = frozenset({"voronoi"})


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Static parameters of one partitioning problem."""
    backend: str = "random"
    n_lp: int = 4
    area: float = 10_000.0  # toroidal square side
    interaction_range: float = 250.0  # bestresponse affinity-graph radius
    iters: int = 8  # Lloyd / best-response / fuzzy c-means rounds
    imbalance: float = 0.0  # allowed load slack over the capacity share
    shares: Optional[Tuple[float, ...]] = None  # per-LP capacity shares
    fuzzy_m: float = 2.0  # fuzzifier (> 1; -> 1 is hard Voronoi)
    hysteresis: float = 0.1  # membership bonus on the previous LP

    def __post_init__(self):
        if self.backend not in PARTITION_BACKENDS:
            raise ValueError(f"partition backend {self.backend!r} not in "
                             f"{PARTITION_BACKENDS}")
        if self.n_lp < 1:
            raise ValueError(f"n_lp={self.n_lp} must be >= 1")
        if self.area <= 0 or self.interaction_range <= 0:
            raise ValueError("area and interaction_range must be > 0")
        if self.iters < 1:
            raise ValueError(f"iters={self.iters} must be >= 1")
        if self.shares is not None and len(self.shares) != self.n_lp:
            raise ValueError(f"shares has {len(self.shares)} entries for "
                             f"n_lp={self.n_lp}")
        if self.imbalance < 0:
            raise ValueError("imbalance must be >= 0")
        if self.fuzzy_m <= 1.0:
            raise ValueError("fuzzy_m must be > 1 (the c-means fuzzifier)")
        if self.hysteresis < 0:
            raise ValueError("hysteresis must be >= 0")

    def share_array(self) -> np.ndarray:
        """The per-LP load shares, float32 (host)."""
        if self.shares is None:
            return np.full((self.n_lp,), 1.0 / self.n_lp, np.float32)
        return np.asarray(self.shares, np.float32)


def from_abm(abm, shares: Optional[Tuple[float, ...]] = None,
             iters: int = 8) -> PartitionConfig:
    """PartitionConfig for an ABMConfig-shaped object."""
    return PartitionConfig(backend=abm.partitioner, n_lp=abm.n_lp,
                           area=abm.area,
                           interaction_range=abm.interaction_range,
                           iters=iters, shares=shares)


def from_engine(cfg) -> PartitionConfig:
    """PartitionConfig for an EngineConfig (its effective capacity
    shares become the load shares)."""
    return from_abm(cfg.abm, shares=cfg.effective_capacity())


def capacity_bounds(cfg: PartitionConfig, total_weight):
    """Declared per-LP load bound: ceil(share * total * (1 + imbalance)),
    float32, on the host. `total_weight` is a float32 value."""
    w = np.float32(total_weight)
    return np.ceil(cfg.share_array() * w
                   * np.float32(1.0 + cfg.imbalance)).astype(np.float32)


def capacity_assign(cost, weights, caps):
    """Greedy capacity-constrained assignment: admit (SE, LP) pairs in
    ascending `cost` order (a stable sort, so ties go to the lower flat
    index i * L + l); an SE takes the first LP whose remaining capacity
    fits its weight (float32 sums). SEs no LP can fit fall back to the
    LP with the most remaining capacity.

    cost (N, L) float32 tensor, weights (N,) float32 tensor, caps (L,)
    float32 -> (N,) int32 on cost's device. On the card, one launch of
    the one-block kernel `kernels/capacity_assign`."""
    return ca_ops.capacity_assign(cost, weights, caps)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def _random(key, pos, weights, cfg: PartitionConfig, prev=None,
            compiled=False):
    n = pos.shape[0]
    base = (torch.arange(n, device=pos.device) % cfg.n_lp).to(torch.int32)
    return trandom.permutation(key, base)


def _stripe(key, pos, weights, cfg: PartitionConfig, prev=None,
            compiled=False):
    # rank along x, ties by y, then by id (two stable sorts), and cut
    # the ranked line at the shares' cumulative-weight boundaries
    order = torch.sort(pos[:, 1], stable=True).indices
    order = order[torch.sort(pos[order, 0], stable=True).indices]
    w_sorted = weights[order]
    start_w = torch.cumsum(w_sorted, 0) - w_sorted  # weight strictly before
    bounds = torch.from_numpy(
        np.cumsum(cfg.share_array()) * np.float32(weights.sum().item())
    ).to(pos.device)
    lp_sorted = torch.searchsorted(bounds, start_w, right=True).clamp(
        0, cfg.n_lp - 1).to(torch.int32)
    lp = torch.empty_like(lp_sorted)
    lp[order] = lp_sorted
    return lp


def _toroidal_dist2(pos, cent, area: float, compiled: bool):
    """(N, L) squared toroidal distances. Compiled, XLA's reduction of
    the squares fuses to fma(dy, dy, dx*dx); eager, each op rounds."""
    d = (pos[:, None, :] - cent[None, :, :]).abs()
    d = torch.minimum(d, f32(area) - d)
    dx, dy = d[..., 0], d[..., 1]
    return fma32(dy, dy, dx * dx) if compiled else dx * dx + dy * dy


def _circular_mean(weight_t, pos, area: float):
    """(L, 2) per-LP circular means on the torus of `pos` under the
    (N, L) weights, as positions: atan2 of the weighted sin and cos
    sums (float32 matmuls), mod 2 pi, scaled back to [0, area)."""
    two_pi = 2.0 * math.pi
    ang = pos * f32(two_pi / area)
    s = weight_t.T @ torch.sin(ang)
    c = weight_t.T @ torch.cos(ang)
    r = torch.fmod(torch.atan2(s, c), f32(two_pi))  # jnp.remainder
    r = torch.where(r < 0, r + f32(two_pi), r)
    return r * f32(area / two_pi)


def _kmeans(key, pos, weights, cfg: PartitionConfig, prev=None,
            compiled=False):
    L = cfg.n_lp
    caps = capacity_bounds(cfg, weights.sum().item())
    cent = trandom.uniform(key, (L, 2), maxval=cfg.area, device=pos.device)
    lps = torch.arange(L, device=pos.device)
    for _ in range(cfg.iters):  # the reference's compiled fori_loop
        assign = capacity_assign(_toroidal_dist2(pos, cent, cfg.area, True),
                                 weights, caps)
        onehot = (assign[:, None] == lps[None, :]) * weights[:, None]
        new = _circular_mean(onehot, pos, cfg.area)
        # an empty cluster (possible only for tiny N) keeps its centroid
        cent = torch.where(onehot.sum(0)[:, None] > 0, new, cent)
    return capacity_assign(_toroidal_dist2(pos, cent, cfg.area, compiled),
                           weights, caps)


def _bestresponse(key, pos, weights, cfg: PartitionConfig, prev=None,
                  compiled=False):
    caps = capacity_bounds(cfg, weights.sum().item())
    everyone = torch.ones((pos.shape[0],), dtype=torch.bool,
                          device=pos.device)
    lp = _stripe(key, pos, weights, cfg)
    for _ in range(cfg.iters):
        aff = prox.proximity_lp_counts(pos, lp, everyone, cfg.n_lp,
                                       cfg.area, cfg.interaction_range)
        lp = capacity_assign(-(aff.float() * weights[:, None]), weights,
                             caps)
    return lp


def _fuzzy_memberships(pos, seeds, cfg: PartitionConfig, compiled: bool):
    """(N, L) fuzzy c-means memberships u[i, l] ~ (1 / d2)^(1 / (m - 1)),
    rows normalized to sum 1 (summed in LP order)."""
    x = _toroidal_dist2(pos, seeds, cfg.area, compiled) + f32(1e-9)
    e = -1.0 / (cfg.fuzzy_m - 1.0)
    inv = div32(torch.ones_like(x), x) if e == -1.0 else torch.pow(x, e)
    total = inv[:, 0]
    for l in range(1, inv.shape[1]):
        total = total + inv[:, l]
    return div32(inv, total[:, None])


def _voronoi(key, pos, weights, cfg: PartitionConfig, prev=None,
             compiled=False):
    L = cfg.n_lp
    dev = pos.device
    caps = capacity_bounds(cfg, weights.sum().item())
    seeds = trandom.uniform(key, (L, 2), maxval=cfg.area, device=dev)
    if prev is not None:
        hold = (prev >= 0) & (prev < L)  # unassigned rows carry nothing
        onehot = torch.nn.functional.one_hot(
            prev.clamp(0, L - 1).long(), L).float() \
            * torch.where(hold, weights, 0.0)[:, None]
        warm = _circular_mean(onehot, pos, cfg.area)
        seeds = torch.where(onehot.sum(0)[:, None] > 0, warm, seeds)
    for _ in range(cfg.iters):  # the reference's compiled fori_loop
        u = _fuzzy_memberships(pos, seeds, cfg, True)
        um = (u * u if cfg.fuzzy_m == 2.0 else torch.pow(u, cfg.fuzzy_m)) \
            * weights[:, None]
        new = _circular_mean(um, pos, cfg.area)
        # a weightless seed (tiny N) stays put
        seeds = torch.where(um.sum(0)[:, None] > 1e-12, new, seeds)
    u = _fuzzy_memberships(pos, seeds, cfg, compiled)
    if prev is not None:
        hold = (prev >= 0) & (prev < L)  # unassigned rows get no bonus
        bonus = torch.nn.functional.one_hot(
            prev.clamp(0, L - 1).long(), L).float() * f32(cfg.hysteresis)
        u = u + torch.where(hold[:, None], bonus, 0.0)
    return capacity_assign(-u, weights, caps)


_REGISTRY = {
    "random": _random,
    "stripe": _stripe,
    "kmeans": _kmeans,
    "bestresponse": _bestresponse,
    "voronoi": _voronoi,
}


def uses_prev(cfg: PartitionConfig) -> bool:
    """Does this backend read the previous SE -> LP map (`prev`)?"""
    return cfg.backend in _USES_PREV


def partition(key, pos, weights, cfg: PartitionConfig, prev=None,
              compiled: bool = False):
    """Dispatch to the configured backend: (key, pos (N, 2), weights
    (N,), cfg[, prev (N,) int32]) -> lp (N,) int32 on pos's device.
    `compiled` says the reference runs this call inside its compiled
    step (the periodic repartition), not eagerly (the init)."""
    lp = _REGISTRY[cfg.backend](key, pos, weights.to(torch.float32), cfg,
                                prev=prev, compiled=compiled)
    return lp.to(torch.int32)
