"""The paper's evaluation model (§5.1), the port of `repro.core.abm`.

Agents move on a toroidal square and interact by proximity: each
sender's interaction reaches every agent within the threshold range.
Every mobility model of the reference is here — rwp, hotspot, group,
flock and trace replay — and the epidemic workload, whose exposure
sweep runs the proximity kernels with the 0/1 infection labels as a
2-class LP map.

Arithmetic follows the reference's compiled program, through float64
where a fused or correctly rounded float32 result is needed:

  * a norm's sum of squares is `fma(dy, dy, dx*dx)` and its `sqrt` is
    correctly rounded (XLA's CPU `sqrt` is not on every CPU: on some it is
    1 ULP off on about 0.7% of inputs, so positions may drift from the
    reference by up to one ULP of `area` per step, which the tests
    allow);
  * a position update `pos + step * k (+ noise * s)` is one FMA per
    multiply-add, innermost first, as XLA contracts it;
  * a division by a constant is a multiply by its float32 reciprocal,
    a division by a tensor is correctly rounded (`div32`);
  * `%` is `jnp.remainder`: `fmod` (exact) plus a sign fix, written
    out so that its rounding is the reference's by construction.

The reference runs its init eagerly, op by op, so nothing there is
fused: the init's arithmetic is plain float32, one rounding an op.

Open worlds. The step's functions take `valid`, the live rows of an
open world's slot universe (`EngineConfig(open_world=True)`): the grid
bins dead rows out of every cell (`neighbors.build_grid(valid=)`), the
flock leaves them out of its means, and the engine holds their state.

Replicas. Every function of the step takes positions and per-SE state
with a leading replica axis, (R, N, ...), as well as without one, and
keys as an (R, 2) batch or one key (`repro_torch.random`): the per-row
arithmetic is elementwise, the draws come in (R, N, ...) from R keys,
the global rows `mob_g` are (R, G, 4), and the grid covers R worlds
(`neighbors.build_grid`). Replica r computes what a solo call on its
slice computes, bit for bit. The init stays per replica.

The proximity hot spot dispatches over the four backend names. On a
CUDA tensor "grid" and "pallas_grid" launch the cell-list kernel and
"dense" and "pallas" the dense kernel (`repro_torch.kernels.proximity`);
on a CPU tensor all four run the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.fp32 import div32, f32, fma32, fmod32, sqrt32
from repro_torch.core import neighbors
from repro_torch.core import partition as part
from repro_torch.data import pipeline as dpipe
from repro_torch.kernels.proximity import ops as prox

PROXIMITY_BACKENDS = ("dense", "grid", "pallas", "pallas_grid")
MOBILITY_MODELS = ("rwp", "hotspot", "group", "flock", "trace")
WORKLOADS = ("none", "epidemic")
TRACE_POLICIES = ("loop", "hold", "exact")

#: PRNG salts of the epidemic workload's streams (fold_in off the step
#: key; the init's origin draw off the init key)
EPI_SEED_SALT = 0x390a
EPI_INFECT_SALT = 0x3911
EPI_RECOVER_SALT = 0x3912

#: PRNG salts of the init's mobility draws (fold_in off the init key):
#: attractor / leader rows, group member offsets, flock headings
_GLOBALS_SALT, _OFFSETS_SALT, _HEADINGS_SALT = 0x6b0a, 0x6b0b, 0x6b0c

#: attractor ("hotspot") / leader ("group") speed relative to SE speed
_GLOBAL_SPEED_FACTOR = 0.5


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
    n_groups: int = 8  # K attractors ("hotspot") / groups ("group")
    group_radius: float = 250.0  # cluster spatial scale (spaceunits)
    trace_name: str = ""  # key of repro_torch.data.pipeline's registry
    trace_policy: str = "loop"  # see TRACE_POLICIES
    workload: str = "none"  # see WORKLOADS
    epi_beta: float = 0.3  # per-contact per-step infection probability
    epi_gamma: float = 0.0  # per-step recovery probability (0=SI, >0=SIS)
    epi_seed_frac: float = 0.02  # initially infectious fraction (a patch)
    epi_boost: float = 4.0  # send-probability multiplier while infectious
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
                "via repro_torch.data.pipeline.register_trace")
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

    def grid_spec(self):
        """Cell-list geometry for this config, or None if the world is
        too small to tessellate. An explicit `grid_capacity` wins;
        otherwise the auto capacity is the uniform bound for rwp, the
        exact peak cell occupancy over every frame for trace replay, and
        the clustered bound (`neighbors.clustered_capacity`) for the
        other models; a positive `mem_budget_mb` clamps it."""
        spec = neighbors.make_grid_spec(self.n_se, self.area,
                                        self.interaction_range,
                                        capacity=self.grid_capacity)
        if spec is None or self.grid_capacity > 0:
            return spec
        if self.mobility == "trace":
            cap = trace_frames(self).peak_cell_occupancy(spec.ncell)
            spec = dataclasses.replace(spec,
                                       capacity=max(spec.capacity, cap))
        elif self.mobility != "rwp":
            radius = {"hotspot": 0.5 * self.group_radius,
                      "group": self.group_radius,
                      "flock": spec.cell}[self.mobility]
            cap = neighbors.clustered_capacity(self.n_se, spec.ncell,
                                               spec.cell, self.n_groups,
                                               radius)
            spec = dataclasses.replace(spec,
                                       capacity=max(spec.capacity, cap))
        if self.mem_budget_mb > 0:
            cap = min(spec.capacity,
                      neighbors.budget_capacity(spec.ncell,
                                                self.mem_budget_mb))
            spec = dataclasses.replace(spec, capacity=cap)
        return spec


def mobility_globals(cfg: ABMConfig) -> int:
    """Rows of the global mobility state `mob_g` (attractors for
    "hotspot", leaders for "group"; 1 row otherwise — "trace" rides its
    frame counter in that row's [0, 0])."""
    return cfg.n_groups if cfg.mobility in ("hotspot", "group") else 1


def trace_frames(cfg: ABMConfig):
    """cfg.trace_name's registered Trace, validated against the config
    (a trace of the wrong shape or world size would replay garbage)."""
    tr = dpipe.get_trace(cfg.trace_name)
    if tr.n_se != cfg.n_se:
        raise ValueError(
            f"trace {cfg.trace_name!r} holds {tr.n_se} SEs but "
            f"ABMConfig.n_se={cfg.n_se}")
    if abs(tr.area - cfg.area) > 1e-6 * max(cfg.area, 1.0):
        raise ValueError(
            f"trace {cfg.trace_name!r} lives on an area={tr.area} torus "
            f"but ABMConfig.area={cfg.area}")
    return tr


#: the frames of each trace on each device: {(name, device): (Trace,
#: tensor)}, refreshed when the name is bound to another Trace
_DEVICE_FRAMES = {}


def trace_frames_on(cfg: ABMConfig, device):
    """cfg's trace frames as a (T, N, 2) float32 tensor on `device`,
    copied there once per trace."""
    tr = trace_frames(cfg)
    key = (cfg.trace_name, str(torch.device(device)))
    hit = _DEVICE_FRAMES.get(key)
    if hit is None or hit[0] is not tr:
        hit = (tr, torch.from_numpy(tr.frames).to(device))
        _DEVICE_FRAMES[key] = hit
    return hit[1]


def check_trace_horizon(cfg: ABMConfig, t0: int, n_steps: int) -> None:
    """Host-side guard for trace_policy='exact': every step of the
    window [t0, t0 + n_steps) must read a real frame (step t replays
    frame t+1). The engine runners call it before they step."""
    if n_steps <= 0 or cfg.mobility != "trace" \
            or cfg.trace_policy != "exact":
        return
    T = trace_frames(cfg).timesteps
    need = t0 + n_steps  # the last step of the window reads this frame
    if need > T - 1:
        raise ValueError(
            f"trace {cfg.trace_name!r} has {T} frames but steps "
            f"[{t0}, {t0 + n_steps}) need frame {need} under "
            "trace_policy='exact'; shorten the horizon, extend the "
            "trace, or pick trace_policy='loop'/'hold'")


def init_abm(key, cfg: ABMConfig, device):
    """Initial model state in global-SE-id order, with the reference's
    k1/k2/k3 split order: positions, waypoints, then the partition.
    The clustered models remap the k1 uniforms into blobs around their
    attractors / leaders, flock draws unit headings, and trace starts
    from frame 0. The reference computes this eagerly, so every op here
    rounds once (no FMA)."""
    n, G = cfg.n_se, mobility_globals(cfg)
    k1, k2, k3 = trandom.split(key, 3)
    pos = trandom.uniform(k1, (n, 2), maxval=cfg.area, device=device)
    wp = trandom.uniform(k2, (n, 2), maxval=cfg.area, device=device)
    mob = torch.zeros((n, 2), dtype=torch.float32, device=device)
    mob_g = torch.zeros((G, 4), dtype=torch.float32, device=device)
    if cfg.mobility in ("hotspot", "group"):
        mob_g = trandom.uniform(trandom.fold_in(key, _GLOBALS_SALT), (G, 4),
                                maxval=cfg.area, device=device)
        anchor = mob_g[torch.arange(n, device=device) % G, :2]
        width = f32(2.0 * cfg.group_radius)
        jitter = (div32(pos, cfg.area) - 0.5) * width
        if cfg.mobility == "group":
            mob = (trandom.uniform(trandom.fold_in(key, _OFFSETS_SALT),
                                   (n, 2), device=device) - 0.5) * width
            anchor = anchor + mob
            jitter = jitter * f32(0.1)  # members start tight on their slot
        pos = remainder(anchor + jitter, cfg.area)
    elif cfg.mobility == "flock":
        theta = trandom.uniform(trandom.fold_in(key, _HEADINGS_SALT), (n,),
                                maxval=2.0 * np.pi, device=device)
        # cos and sin in float64, rounded once: XLA's float32 cos / sin
        # are not correctly rounded, and the correctly rounded value
        # agrees with theirs more often than PyTorch's float32 ones do
        # (measured: 98.8% against 95.0% of headings), and it is the
        # same on the card and the CPU
        t64 = theta.double()
        mob = torch.stack([torch.cos(t64), torch.sin(t64)], dim=1).float()
    elif cfg.mobility == "trace":
        # k1/k2 are drawn (and discarded) above so the split pattern
        # stays uniform across models; frame 0 is the initial layout
        pos = trace_frames_on(cfg, device)[0].clone()
    lp = part.partition(k3, pos, torch.ones(n, device=device),
                        part.from_abm(cfg))
    epi = epidemic_init(key, pos, cfg) if cfg.workload == "epidemic" \
        else torch.zeros((n,), dtype=torch.int32, device=device)
    return {"pos": pos, "waypoint": wp, "lp": lp, "mob": mob,
            "mob_g": mob_g, "epi": epi}


def remainder(x, y: float):
    """`jnp.remainder` for float32: fmod plus a sign fix."""
    r = fmod32(x, y)
    fix = (r != 0) & ((r < 0) != (f32(y) < 0))
    return torch.where(fix, r + f32(y), r)


def toroidal_delta(a, b, area: float):
    """Shortest per-axis distance on the torus."""
    d = (a - b).abs()
    return torch.minimum(d, f32(area) - d)


def toroidal_signed_delta(frm, to, area: float):
    """Signed shortest per-axis displacement frm -> to on the torus."""
    half = f32(area / 2.0)
    return remainder(to - frm + half, area) - half


def _norm(v):
    """(..., N, 1) row norms: sqrt(fma(y, y, x*x)), as XLA fuses them."""
    return sqrt32(fma32(v[..., 1], v[..., 1], v[..., 0] * v[..., 0]))[
        ..., None]


def _unit(v, norm=None):
    """Row-wise unit vector (zero rows stay zero)."""
    norm = _norm(v) if norm is None else norm
    return div32(v, norm.clamp(min=f32(1e-9)))


def rwp_draws(key, n: int, cfg: ABMConfig, device):
    """The fresh-waypoint draw for all n SEs, indexed by SE id ((R, n,
    2) from a key batch)."""
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
    dist = _norm(delta)
    arrived = dist <= speed
    step = div32(delta, dist.clamp(min=f32(1e-9)))
    step = torch.where(dist > 0, step, torch.zeros_like(step))
    moved = remainder(fma32(step, speed, pos), cfg.area)
    new_pos = torch.where(arrived, waypoint, moved)
    next_wp = torch.where(arrived, new_wp, waypoint)
    return remainder(new_pos, cfg.area), next_wp


def _globals_step(key, mob_g, cfg: ABMConfig):
    """Advance the attractor / leader rows ((..., G, 4)) by RWP at a
    fraction of the SEs' speed."""
    draw = trandom.uniform(key, (mob_g.shape[-2], 2), maxval=cfg.area,
                           device=mob_g.device)
    gpos, gwp = rwp_apply(mob_g[..., :2], mob_g[..., 2:], draw, cfg,
                          speed=cfg.speed * _GLOBAL_SPEED_FACTOR)
    return torch.cat([gpos, gwp], dim=-1)


def _noise_scale(cfg: ABMConfig) -> float:
    """The per-axis noise amplitude of the clustered models."""
    return cfg.speed if cfg.mobility == "hotspot" else 0.5 * cfg.speed


def _hotspot_apply(pos, anchor, noise, cfg: ABMConfig):
    """Row-local half of the hotspot move: pull toward the attractor,
    saturating at `speed` beyond the dwell radius, plus noise (`noise`
    is the unscaled u - 0.5). Compiled, the pull's factor is
    min(dist * (1 / radius), 1) * speed and both additions fuse:
    fma(noise, scale, fma(unit, factor, pos))."""
    delta = toroidal_signed_delta(pos, anchor, cfg.area)
    dist = _norm(delta)
    factor = torch.clamp(dist * f32(1.0 / f32(cfg.group_radius)),
                         max=1.0) * f32(cfg.speed)
    moved = fma32(_unit(delta, dist), factor, pos)
    return remainder(fma32(noise, _noise_scale(cfg), moved), cfg.area)


def _group_apply(pos, target, noise, cfg: ABMConfig):
    """Row-local half of the RPGM-lite move: chase (leader + member
    offset) at up to `speed`, plus noise (unscaled u - 0.5), fused as
    fma(noise, scale, fma(unit, min(dist, speed), pos))."""
    delta = toroidal_signed_delta(pos, target, cfg.area)
    dist = _norm(delta)
    moved = fma32(_unit(delta, dist), dist.clamp(max=f32(cfg.speed)), pos)
    return remainder(fma32(noise, _noise_scale(cfg), moved), cfg.area)


def row_local_mobility(cfg: ABMConfig) -> bool:
    """True iff the model factors into (full-size id-order draws) x
    (elementwise per-row apply): every model but flock."""
    return cfg.mobility in ("rwp", "hotspot", "group", "trace")


def mobility_row_draws(key, n: int, mob_g, cfg: ABMConfig, device):
    """Full-size id-order draws of the row-local models, plus the
    advanced global rows: {"wp"} for rwp; {"anchor", "noise"} for
    hotspot/group (the SE's attractor / leader position and the
    unscaled noise u - 0.5); {"tp"} for trace (the next frame, indexed
    on the device by the counter in mob_g[..., 0, 0]; the frames are
    one tensor every replica reads)."""
    if cfg.mobility == "rwp":
        return {"wp": rwp_draws(key, n, cfg, device)}, mob_g
    if cfg.mobility == "trace":
        frames = trace_frames_on(cfg, device)
        T = frames.shape[0]
        nxt = mob_g[..., 0, 0].to(torch.int64) + 1
        idx = nxt % T if cfg.trace_policy == "loop" else nxt.clamp(max=T - 1)
        mob_g = mob_g.clone()
        mob_g[..., 0, 0] += 1.0
        tp = frames.index_select(0, idx.reshape(-1))
        return {"tp": tp.view(idx.shape + frames.shape[1:])}, mob_g
    mob_g = _globals_step(trandom.fold_in(key, 1), mob_g, cfg)
    anchor = mob_g[..., torch.arange(n, device=device) % mob_g.shape[-2],
                   :2]
    noise = trandom.uniform(trandom.fold_in(key, 2), (n, 2),
                            device=device) - 0.5
    return {"anchor": anchor, "noise": noise}, mob_g


def mobility_row_apply(pos, waypoint, mob, draws, cfg: ABMConfig):
    """Elementwise per-row half of the row-local models. Returns
    (pos, waypoint); `mob` is read only (the group member offset)."""
    if cfg.mobility == "rwp":
        return rwp_apply(pos, waypoint, draws["wp"], cfg)
    if cfg.mobility == "trace":
        return draws["tp"], waypoint  # replay is the whole move
    if cfg.mobility == "hotspot":
        return _hotspot_apply(pos, draws["anchor"], draws["noise"],
                              cfg), waypoint
    target = remainder(draws["anchor"] + mob, cfg.area)  # group
    return _group_apply(pos, target, draws["noise"], cfg), waypoint


def max_step_displacement(cfg: ABMConfig) -> float:
    """Upper bound on any SE's per-axis displacement in one mobility
    step, which sizes the sharded halo's dilation radius
    (`repro_torch.parallel.lp_shard`). rwp and flock move exactly
    `speed` along a unit direction; hotspot adds up to 0.5 * speed of
    per-axis noise to a speed-capped pull, group up to 0.25 * speed to
    a speed-capped chase; trace measures its frames (the `loop` policy
    also pays for the wrap-seam jump)."""
    if cfg.mobility == "trace":
        return trace_frames(cfg).max_step_displacement(
            include_seam=cfg.trace_policy == "loop")
    return {"rwp": cfg.speed, "hotspot": 1.5 * cfg.speed,
            "group": 1.25 * cfg.speed, "flock": cfg.speed}[cfg.mobility]


def _flock_step(k_noise, pos, mob, cfg: ABMConfig, valid=None):
    """Flocking-lite over the cell-list grid: steer by inertia +
    alignment with the 3x3-neighborhood mean heading + cohesion toward
    its centroid + noise; move at constant `speed` along the heading.
    Compiled, the steer is fma(noise, 0.8, fma(cohere, 0.6, fma(align,
    0.8, mob))) with the noise's 2 * 0.4 folded into 0.8. Degenerate
    worlds (no grid) flock against the global mean, whose float32 sums
    add in another order than XLA's reduction. `valid` (open world)
    keeps dead rows out of the means; their own rows are garbage the
    engine discards."""
    n = pos.shape[-2]
    spec = cfg.grid_spec()
    if spec is not None:
        cdelta, hmean = neighbors.cell_block_mean(pos, mob, spec, cfg.area,
                                                  valid=valid)
    elif valid is None:  # un-tessellatable: one global "cell" (no torus)
        inv = f32(1.0 / f32(max(n - 1, 1)))
        cdelta = (_world_sum(pos) - pos) * inv - pos
        hmean = (_world_sum(mob) - mob) * inv
    else:  # the live rows' mean, over a count the step computes
        vpos = torch.where(valid[..., None], pos, 0.0)
        vmob = torch.where(valid[..., None], mob, 0.0)
        cnt = (valid.sum(-1, dtype=torch.int32) - 1).clamp(min=1).float()
        cnt = cnt[..., None, None] if pos.dim() > 2 else cnt
        cdelta = div32(_world_sum(vpos) - vpos, cnt) - pos
        hmean = div32(_world_sum(vmob) - vmob, cnt)
    cnorm = _norm(cdelta)
    reach = torch.clamp(cnorm * f32(1.0 / f32(cfg.interaction_range)),
                        max=1.0)
    noise = trandom.uniform(k_noise, (n, 2), device=pos.device) - 0.5
    steer = fma32(_unit(hmean), f32(0.8), mob)
    steer = fma32(_unit(cdelta, cnorm) * reach, f32(0.6), steer)
    steer = fma32(noise, f32(0.8), steer)
    heading = _unit(steer)
    # a fully cancelled steer (zero vector) keeps the old heading
    heading = torch.where(_norm(heading) > 0.5, heading, mob)
    return remainder(fma32(heading, f32(cfg.speed), pos), cfg.area), heading


def _world_sum(x):
    """(..., 1, 2) sums of each world's (N, 2) rows, a world at a time:
    a replica's float32 sum adds in the order of a solo call's."""
    if x.dim() == 2:
        return x.sum(0)
    return torch.stack([w.sum(0) for w in x])[:, None, :]


def mobility_step(key, pos, waypoint, mob, mob_g, cfg: ABMConfig,
                  valid=None):
    """One mobility timestep for all N SEs, in global-SE-id order.
    Returns (pos, waypoint, mob, mob_g). `valid` (open world) keeps
    dead rows out of the flock's means; the row-local models ignore it
    (the engine discards dead rows' moves)."""
    if row_local_mobility(cfg):
        draws, mob_g = mobility_row_draws(key, pos.shape[-2], mob_g, cfg,
                                          pos.device)
        pos, waypoint = mobility_row_apply(pos, waypoint, mob, draws, cfg)
        return pos, waypoint, mob, mob_g
    pos, mob = _flock_step(trandom.fold_in(key, 2), pos, mob, cfg,
                           valid=valid)
    return pos, waypoint, mob, mob_g


def proximity_grid(pos, cfg: ABMConfig, valid=None):
    """The CSR grid the proximity phase sweeps, or None when the backend
    or the world takes the dense path. The epidemic's exposure sweep
    reuses it: same positions, same geometry. `valid` (open world) bins
    dead rows out of every cell."""
    if cfg.proximity_backend not in ("grid", "pallas_grid"):
        return None
    spec = cfg.grid_spec()
    return None if spec is None else neighbors.build_grid(pos, spec,
                                                          valid=valid)


def interaction_counts_overflow(pos, lp, sender_mask, cfg: ABMConfig,
                                grid=None, valid=None):
    """Per-sender histogram of recipient LPs, plus the grid's overflow
    alarm: counts (N, n_lp) int32 with counts[i, l] = number of SEs
    within `interaction_range` of sender i on LP l (self excluded,
    non-sender rows zero), and overflow () bool — True iff a grid cell
    exceeded its capacity (dense backends are always exact). Worlds with
    `area / range < 3` take the dense path on every backend. `grid` is
    `proximity_grid(pos, cfg, valid)` when the caller built it already.
    Open world: dead rows (`valid` False, lp -1) are no sender's
    recipient and stay out of the grid; the caller keeps them out of
    `sender_mask`."""
    if grid is None:
        grid = proximity_grid(pos, cfg, valid=valid)
    if grid is not None:
        counts = prox.proximity_lp_counts_grid(
            pos, lp, sender_mask, cfg.n_lp, cfg.area, cfg.interaction_range,
            cfg.grid_spec(), grid, neighbors.chunk_entries(cfg.mem_budget_mb))
        return counts, grid["overflow"]
    counts = prox.proximity_lp_counts(pos, lp, sender_mask, cfg.n_lp,
                                      cfg.area, cfg.interaction_range)
    return counts, torch.zeros(pos.shape[:-2], dtype=torch.bool,
                               device=pos.device)


# ---------------------------------------------------------------------------
# Epidemic workload (ABMConfig.workload == "epidemic"): one int32 flag per
# SE (`epi`: 0 susceptible, 1 infectious), SI / SIS over the proximity graph
# ---------------------------------------------------------------------------


def epidemic_init(key, pos, cfg: ABMConfig):
    """Initial infection flags: the k = max(1, round(epi_seed_frac * n))
    SEs nearest (torus metric) to one key-drawn origin start infectious.
    The reference computes it eagerly: d0*d0 + d1*d1, one rounding each
    op."""
    n = pos.shape[0]
    k = max(1, int(round(cfg.epi_seed_frac * n)))
    origin = trandom.uniform(trandom.fold_in(key, EPI_SEED_SALT), (2,),
                             maxval=cfg.area, device=pos.device)
    d = toroidal_delta(pos, origin[None, :], cfg.area)
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
    thresh = torch.sort(d2).values[k - 1]
    return (d2 <= thresh).to(torch.int32)


def epidemic_send_prob(epi, cfg: ABMConfig):
    """Per-SE interaction probability: infectious SEs send `epi_boost`x
    more often (capped at 1), in float32 as the reference."""
    p = np.float32(cfg.p_interact)
    hot = float(min(p * np.float32(cfg.epi_boost), np.float32(1.0)))
    return torch.where(epi > 0, hot, float(p))


def epidemic_draws(key, n: int, cfg: ABMConfig, device):
    """Full-size (n,) id-order uniforms for the infection (and, when
    epi_gamma > 0, recovery) trials, salted off the step key."""
    d = {"u_inf": trandom.uniform(trandom.fold_in(key, EPI_INFECT_SALT),
                                  (n,), device=device)}
    if cfg.epi_gamma > 0.0:
        d["u_rec"] = trandom.uniform(
            trandom.fold_in(key, EPI_RECOVER_SALT), (n,), device=device)
    return d


@functools.lru_cache(maxsize=16)
def _infection_table(beta: float, n: int, device: str):
    power = np.power(np.float64(np.float32(1.0 - beta)),
                     np.arange(n + 1, dtype=np.float64)).astype(np.float32)
    return torch.from_numpy(np.float32(1.0) - power).to(device)


def infection_table(cfg: ABMConfig, device):
    """p_inf[e] = 1 - (1 - beta)^e in float32 for every exposure
    e = 0..n_se, computed once on the host and kept on `device`, so the
    card and the CPU use the same table. The power is computed in
    float64 and rounded once: XLA's float32 `pow` is not correctly
    rounded, but 1 - pow as it compiles it equals this at every exposure
    0..10,000 for every beta measured (PyTorch's float32 `pow` missed
    one or three values at some betas)."""
    return _infection_table(cfg.epi_beta, cfg.n_se, str(device))


def epidemic_row_update(epi, exposure, draws, cfg: ABMConfig, table):
    """Elementwise SI/SIS transition: a susceptible row with `exposure`
    in-range infectious senders catches with p = table[exposure]
    (`infection_table`); with SIS (epi_gamma > 0) an infectious row
    recovers with gamma."""
    catch = (epi == 0) & (draws["u_inf"] < table[exposure.long()])
    out = torch.where(catch, 1, epi)
    if cfg.epi_gamma > 0.0:
        rec = (epi > 0) & (draws["u_rec"] < f32(cfg.epi_gamma))
        out = torch.where(rec, 0, out)
    return out.to(torch.int32)


def epidemic_exposure_overflow(pos, labels, query_mask, cfg: ABMConfig,
                               grid=None, valid=None):
    """exposure[i] = #{j != i in range with labels[j] == 1} for rows
    with `query_mask` (zeros elsewhere), plus the grid overflow alarm:
    the proximity kernels with the labels as a 2-class LP map. On the
    grid backend `grid` is the proximity phase's CSR grid of the same
    positions, when the caller has it. Open world: dead rows carry
    label -1 (no class) and `valid` keeps them out of the grid."""
    spec = cfg.grid_spec() if cfg.proximity_backend == "grid" else None
    if spec is not None:
        if grid is None:
            grid = neighbors.build_grid(pos, spec, valid=valid)
        counts = prox.proximity_lp_counts_grid(
            pos, labels, query_mask, 2, cfg.area, cfg.interaction_range,
            spec, grid, neighbors.chunk_entries(cfg.mem_budget_mb))
        return counts[..., 1], grid["overflow"]
    counts = prox.proximity_lp_counts(pos, labels, query_mask, 2, cfg.area,
                                      cfg.interaction_range)
    return counts[..., 1], torch.zeros(pos.shape[:-2], dtype=torch.bool,
                                       device=pos.device)
