"""Initial SE -> LP partitioning, the port of `repro.core.partition`.

This slice ports the paper's §5.1 baseline, the "random" backend: a
random permutation of the round-robin assignment (equal-sized LPs),
bit-identical to the reference for the same key. `PartitionConfig`
validates like the reference; the other four backends are for a later
slice and raise `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import random as trandom

PARTITION_BACKENDS = ("random", "stripe", "kmeans", "bestresponse",
                      "voronoi")

#: what the port does not run yet, and the ROADMAP.md item that brings it
LATER = "ROADMAP.md queue 1, item 6 (the remaining scenarios)"


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Static parameters of one partitioning problem."""
    backend: str = "random"
    n_lp: int = 4
    area: float = 10_000.0
    interaction_range: float = 250.0
    iters: int = 8
    imbalance: float = 0.0
    shares: Optional[Tuple[float, ...]] = None
    fuzzy_m: float = 2.0
    hysteresis: float = 0.1

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
        if self.backend != "random":
            raise NotImplementedError(
                f"partition backend {self.backend!r} is not ported yet; "
                f"see {LATER}")


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


def partition(key, pos, weights, cfg: PartitionConfig):
    """(key, pos (N, 2), weights (N,), cfg) -> lp (N,) int32. The
    "random" backend: `permutation(key, arange(n) % n_lp)`."""
    n = pos.shape[0]
    base = (torch.arange(n, device=pos.device) % cfg.n_lp).to(torch.int32)
    return trandom.permutation(key, base)
