"""The paper's evaluation model (§5.1), the port of `repro.core.abm`.

Agents move on a toroidal square by Random Waypoint and interact by
proximity: each sender's interaction reaches every agent within the
threshold range. This slice ports the rwp path; the clustered mobility
models, trace replay and the epidemic workload are for a later slice,
and `ABMConfig` raises `NotImplementedError` for them.

Arithmetic follows the reference's compiled program, through float64
where a fused or correctly rounded float32 result is needed:

  * the norm's sum of squares is `fma(dy, dy, dx*dx)` and its `sqrt` is
    correctly rounded (XLA's CPU `sqrt` is not on every CPU: on some it is
    1 ULP off on about 0.7% of inputs, so positions may drift from the
    reference by up to one ULP of `area` per step, which the tests
    allow);
  * the position update is `fma(step, speed, pos)`;
  * `%` is `jnp.remainder`: `fmod` (exact) plus a sign fix, written
    out so that its rounding is the reference's by construction.

The proximity hot spot dispatches over the four backend names. On a
CUDA tensor "grid" and "pallas_grid" launch the cell-list kernel and
"dense" and "pallas" the dense kernel (`repro_torch.kernels.proximity`);
on a CPU tensor all four run the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as trandom
from repro_torch.fp32 import div32, f32, fma32, fmod32, sqrt32
from repro_torch.core import neighbors
from repro_torch.core import partition as part
from repro_torch.kernels.proximity import ops as prox

PROXIMITY_BACKENDS = ("dense", "grid", "pallas", "pallas_grid")
MOBILITY_MODELS = ("rwp", "hotspot", "group", "flock", "trace")
WORKLOADS = ("none", "epidemic")
TRACE_POLICIES = ("loop", "hold", "exact")


@dataclasses.dataclass(frozen=True)
class ABMConfig:
    n_se: int = 10_000
    n_lp: int = 4
    area: float = 10_000.0  # toroidal square side (spaceunits)
    speed: float = 11.0  # spaceunits/timestep (min = max, Exp. 1)
    interaction_range: float = 250.0
    p_interact: float = 0.2  # pi: P(SE sends an interaction this timestep)
    proximity_backend: str = "grid"  # see PROXIMITY_BACKENDS
    grid_capacity: int = 0  # per-cell member cap; 0 = auto from density
    mem_budget_mb: int = 0  # proximity memory budget (MiB); 0 = none
    mobility: str = "rwp"  # see MOBILITY_MODELS
    n_groups: int = 8
    group_radius: float = 250.0
    trace_name: str = ""
    trace_policy: str = "loop"  # see TRACE_POLICIES
    workload: str = "none"  # see WORKLOADS
    epi_beta: float = 0.3
    epi_gamma: float = 0.0
    epi_seed_frac: float = 0.02
    epi_boost: float = 4.0
    partitioner: str = "random"  # see partition.PARTITION_BACKENDS
    use_pallas: dataclasses.InitVar[object] = None  # removed; raises

    def __post_init__(self, use_pallas=None):
        # the reference's validation, with its exception types
        if use_pallas is not None:
            raise TypeError(
                "ABMConfig.use_pallas was removed; set "
                "proximity_backend='pallas' (or 'pallas_grid') instead")
        if self.proximity_backend not in PROXIMITY_BACKENDS:
            raise ValueError(
                f"proximity_backend={self.proximity_backend!r} not in "
                f"{PROXIMITY_BACKENDS}")
        if self.partitioner not in part.PARTITION_BACKENDS:
            raise ValueError(
                f"partitioner={self.partitioner!r} not in "
                f"{part.PARTITION_BACKENDS}")
        if self.mobility not in MOBILITY_MODELS:
            raise ValueError(
                f"mobility={self.mobility!r} not in {MOBILITY_MODELS}")
        if self.mobility in ("hotspot", "group") and self.n_groups < 1:
            raise ValueError("n_groups must be >= 1 for clustered mobility")
        if self.n_se < 1 or self.n_lp < 1:
            raise ValueError(
                f"n_se={self.n_se} and n_lp={self.n_lp} must be >= 1")
        if self.area <= 0 or self.interaction_range <= 0:
            raise ValueError(
                f"area={self.area} and interaction_range="
                f"{self.interaction_range} must be > 0")
        if self.speed < 0 or self.group_radius <= 0:
            raise ValueError("speed must be >= 0 and group_radius > 0")
        if not 0.0 <= self.p_interact <= 1.0:
            raise ValueError(
                f"p_interact={self.p_interact} must be a probability")
        if self.grid_capacity < 0 or self.mem_budget_mb < 0:
            raise ValueError(
                "grid_capacity and mem_budget_mb must be >= 0 (0 = auto)")
        if self.mobility == "trace" and not self.trace_name:
            raise ValueError(
                "mobility='trace' needs trace_name — a key registered "
                "via repro.data.pipeline.register_trace")
        if self.trace_policy not in TRACE_POLICIES:
            raise ValueError(
                f"trace_policy={self.trace_policy!r} not in "
                f"{TRACE_POLICIES}")
        if self.workload not in WORKLOADS:
            raise ValueError(
                f"workload={self.workload!r} not in {WORKLOADS}")
        if self.workload == "epidemic":
            if self.proximity_backend not in ("dense", "grid"):
                raise ValueError(
                    "workload='epidemic' implements its exposure sweep "
                    "on the dense/grid proximity backends only")
            for nm, v in (("epi_beta", self.epi_beta),
                          ("epi_gamma", self.epi_gamma)):
                if not 0.0 <= v <= 1.0:
                    raise ValueError(f"{nm}={v} must be a probability")
            if not 0.0 < self.epi_seed_frac <= 1.0:
                raise ValueError(
                    f"epi_seed_frac={self.epi_seed_frac} must be in "
                    "(0, 1]")
            if self.epi_boost < 1.0:
                raise ValueError(
                    f"epi_boost={self.epi_boost} must be >= 1 (1 = no "
                    "load shift)")
        # valid, but for a later slice of the port
        for field, value, ported in (
                ("mobility", self.mobility, "rwp"),
                ("workload", self.workload, "none"),
                ("partitioner", self.partitioner, "random")):
            if value != ported:
                raise NotImplementedError(
                    f"ABMConfig.{field}={value!r} is not ported yet; see "
                    f"{part.LATER}")

    def grid_spec(self):
        """Cell-list geometry for this config, or None if the world is
        too small to tessellate. An explicit `grid_capacity` wins; the
        auto capacity is the uniform bound (rwp), clamped by a positive
        `mem_budget_mb`."""
        spec = neighbors.make_grid_spec(self.n_se, self.area,
                                        self.interaction_range,
                                        capacity=self.grid_capacity)
        if spec is None or self.grid_capacity > 0:
            return spec
        if self.mem_budget_mb > 0:
            cap = min(spec.capacity,
                      neighbors.budget_capacity(spec.ncell,
                                                self.mem_budget_mb))
            spec = dataclasses.replace(spec, capacity=cap)
        return spec


def init_abm(key, cfg: ABMConfig, device):
    """Initial model state in global-SE-id order, with the reference's
    k1/k2/k3 split order: positions, waypoints, then the partition."""
    n = cfg.n_se
    k1, k2, k3 = trandom.split(key, 3)
    pos = trandom.uniform(k1, (n, 2), maxval=cfg.area, device=device)
    wp = trandom.uniform(k2, (n, 2), maxval=cfg.area, device=device)
    lp = part.partition(k3, pos, torch.ones(n, device=device),
                        part.from_abm(cfg))
    return {"pos": pos, "waypoint": wp, "lp": lp,
            "mob": torch.zeros((n, 2), dtype=torch.float32, device=device),
            "mob_g": torch.zeros((1, 4), dtype=torch.float32,
                                 device=device),
            "epi": torch.zeros((n,), dtype=torch.int32, device=device)}


def remainder(x, y: float):
    """`jnp.remainder` for float32: fmod plus a sign fix."""
    r = fmod32(x, y)
    fix = (r != 0) & ((r < 0) != (f32(y) < 0))
    return torch.where(fix, r + f32(y), r)


def rwp_draws(key, n: int, cfg: ABMConfig, device):
    """The fresh-waypoint draw for all n SEs, indexed by SE id."""
    return trandom.uniform(key, (n, 2), maxval=cfg.area, device=device)


def rwp_apply(pos, waypoint, new_wp, cfg: ABMConfig, speed=None):
    """The deterministic half of a Random-Waypoint move: advance `speed`
    toward the waypoint (torus-aware); on arrival switch to the
    pre-drawn fresh waypoint `new_wp`."""
    speed = f32(cfg.speed if speed is None else speed)
    area, half = f32(cfg.area), f32(cfg.area / 2)
    delta = waypoint - pos
    delta = torch.where(delta > half, delta - area, delta)
    delta = torch.where(delta < -half, delta + area, delta)
    dx, dy = delta[:, 0], delta[:, 1]
    dist = sqrt32(fma32(dy, dy, dx * dx))[:, None]
    arrived = dist[:, 0] <= speed
    step = div32(delta, dist.clamp(min=f32(1e-9)))
    step = torch.where(dist > 0, step, torch.zeros_like(step))
    moved = remainder(fma32(step, speed, pos), cfg.area)
    new_pos = torch.where(arrived[:, None], waypoint, moved)
    next_wp = torch.where(arrived[:, None], new_wp, waypoint)
    return remainder(new_pos, cfg.area), next_wp


def mobility_row_draws(key, n: int, mob_g, cfg: ABMConfig, device):
    """Full-size id-order draws of the row-local models (rwp: fresh
    waypoints), plus the global rows, which rwp leaves untouched."""
    return {"wp": rwp_draws(key, n, cfg, device)}, mob_g


def mobility_row_apply(pos, waypoint, mob, draws, cfg: ABMConfig):
    """Elementwise per-row half of the row-local models."""
    return rwp_apply(pos, waypoint, draws["wp"], cfg)


def mobility_step(key, pos, waypoint, mob, mob_g, cfg: ABMConfig):
    """One mobility timestep for all N SEs, in global-SE-id order.
    Returns (pos, waypoint, mob, mob_g)."""
    draws, mob_g = mobility_row_draws(key, pos.shape[0], mob_g, cfg,
                                      pos.device)
    pos, waypoint = mobility_row_apply(pos, waypoint, mob, draws, cfg)
    return pos, waypoint, mob, mob_g


def interaction_counts_overflow(pos, lp, sender_mask, cfg: ABMConfig):
    """Per-sender histogram of recipient LPs, plus the grid's overflow
    alarm: counts (N, n_lp) int32 with counts[i, l] = number of SEs
    within `interaction_range` of sender i on LP l (self excluded,
    non-sender rows zero), and overflow () bool — True iff a grid cell
    exceeded its capacity (dense backends are always exact). Worlds with
    `area / range < 3` take the dense path on every backend."""
    backend = cfg.proximity_backend
    spec = cfg.grid_spec() if backend in ("grid", "pallas_grid") else None
    if backend in ("grid", "pallas_grid") and spec is None:
        backend = "dense"
    if backend in ("grid", "pallas_grid"):
        grid = neighbors.build_grid(pos, spec)
        counts = prox.proximity_lp_counts_grid(
            pos, lp, sender_mask, cfg.n_lp, cfg.area, cfg.interaction_range,
            spec, grid, neighbors.chunk_entries(cfg.mem_budget_mb))
        return counts, grid["overflow"]
    counts = prox.proximity_lp_counts(pos, lp, sender_mask, cfg.n_lp,
                                      cfg.area, cfg.interaction_range)
    return counts, torch.zeros((), dtype=torch.bool, device=pos.device)
