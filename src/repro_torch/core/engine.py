"""The GAIA adaptive-partitioning engine (paper §4), the port of
`repro.core.engine` for one closed-world replica.

One step = one simulation timestep, cut into the reference's phases:

  migrate     apply migrations whose protocol delay has elapsed
  mobility    move agents (RWP) and draw this step's senders
  proximity   per-sender histogram of recipient LPs (the hot spot)
  accounting  the LP-pair flow matrix: local vs remote deliveries
  heuristic   window update, evaluation, balancing, admission (GAIA on)
  finalize    the new state and the step's metrics

The reference's compiled `lax.scan` becomes a Python loop over steps.
Every phase stays on the device: a step makes no host sync, and the
metrics are stacked once per window. The PRNG key and the step counter
live on the host (a CPU key tensor, a Python int), so key splitting
never waits for the card.

`state_from_numpy` / `state_to_numpy` carry an engine state between the
reference and the port (the key as its two uint32 words).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import balance as bal
from repro_torch.core import heuristics as heu
from repro_torch.core import partition as part
from repro_torch.core.abm import (ABMConfig, init_abm,
                                  interaction_counts_overflow,
                                  mobility_step)
from repro_torch.core.costmodel import ExecutionEnvironment
from repro_torch.core.heuristics import HeuristicConfig
from repro_torch.fp32 import div32
from repro_torch.obs.config import ObsConfig

SHARDINGS = ("none", "lp_device")

#: the ROADMAP.md items that bring what this slice does not run
LATER = {
    "scenarios": part.LATER,
    "replicas": "ROADMAP.md queue 1, item 7 (replica batching and "
                "self-tuning)",
    "service": "ROADMAP.md queue 1, item 8 (core/service.py)",
    "obs": "ROADMAP.md queue 1, item 9 (obs/)",
    "sharding": "ROADMAP.md queue 1, item 10 (parallel/lp_shard.py)",
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    abm: ABMConfig = ABMConfig()
    heuristic: HeuristicConfig = HeuristicConfig()
    gaia_on: bool = True
    balance: str = "symmetric"  # "symmetric" | "asymmetric"
    migration_delay: int = 5  # 2 (LB negotiation) + 3 (protocol, Fig. 4)
    timesteps: int = 1200
    capacity: Optional[tuple] = None  # asymmetric LP capacity shares
    env: Optional[ExecutionEnvironment] = None
    sharding: str = "none"
    n_devices: int = 0
    shard_capacity: int = 0
    mig_capacity: int = 0
    halo_capacity: int = 0
    repartition_every: int = 0
    mem_budget_mb: int = 0
    open_world: bool = False
    n_active: int = 0
    obs: ObsConfig = ObsConfig()

    def __post_init__(self):
        # the reference's validation, with its exception types
        if self.mem_budget_mb > 0 and self.abm.mem_budget_mb == 0:
            object.__setattr__(self, "abm", dataclasses.replace(
                self.abm, mem_budget_mb=self.mem_budget_mb))
        if self.sharding not in SHARDINGS:
            raise ValueError(
                f"sharding={self.sharding!r} not in {SHARDINGS}")
        if self.balance not in ("symmetric", "asymmetric"):
            raise ValueError(
                f"balance={self.balance!r} not in ('symmetric', "
                "'asymmetric')")
        if self.timesteps < 0 or self.migration_delay < 1:
            raise ValueError("timesteps must be >= 0 and migration_delay "
                             ">= 1")
        if min(self.n_devices, self.shard_capacity, self.mig_capacity,
               self.halo_capacity, self.mem_budget_mb) < 0:
            raise ValueError("n_devices and the shard/mig/halo/memory "
                             "capacities must be >= 0 (0 = auto)")
        if self.repartition_every < 0:
            raise ValueError("repartition_every must be >= 0")
        if self.halo_capacity > 0 and self.mem_budget_mb > 0 and \
                self.halo_capacity * 48 > (self.mem_budget_mb << 18):
            raise ValueError(
                f"halo_capacity={self.halo_capacity} needs more than "
                f"mem_budget_mb={self.mem_budget_mb} affords the halo "
                "buffers; raise the budget or drop one of the knobs")
        if self.env is not None and self.env.n_lp != self.abm.n_lp:
            raise ValueError(
                f"env {self.env.name!r} has {self.env.n_lp} LPs but "
                f"abm.n_lp={self.abm.n_lp}")
        if self.balance == "asymmetric" and self.effective_capacity() is None:
            raise ValueError("asymmetric balance needs `capacity` or an "
                             "`env` to derive it from")
        if not 0 <= self.n_active <= self.abm.n_se:
            raise ValueError(
                f"n_active={self.n_active} must be in [0, n_se="
                f"{self.abm.n_se}] (0 = all live)")
        if self.n_active > 0 and not self.open_world:
            raise ValueError("n_active needs open_world=True")
        if self.open_world and \
                self.abm.proximity_backend.startswith("pallas"):
            raise ValueError(
                "open_world=True needs proximity_backend 'grid' or "
                "'dense' (the Pallas kernels table every row and have "
                "no dead-slot mask)")
        # valid, but for a later slice of the port
        for bad, what, item in (
                (self.sharding == "lp_device", "sharding='lp_device'",
                 "sharding"),
                (self.repartition_every > 0, "repartition_every > 0",
                 "scenarios"),
                (self.env is not None, "an ExecutionEnvironment `env`",
                 "scenarios"),
                (self.open_world, "open_world=True", "service"),
                (self.obs.enabled, "obs.enabled=True", "obs")):
            if bad:
                raise NotImplementedError(
                    f"EngineConfig with {what} is not ported yet; see "
                    f"{LATER[item]}")

    def effective_capacity(self) -> Optional[tuple]:
        """Asymmetric capacity shares: explicit `capacity` wins, else the
        environment's relative LP speeds (normalized), else None."""
        if self.capacity is not None:
            return tuple(self.capacity)
        if self.env is not None:
            return self.env.capacity_shares()
        return None


def _init_engine(key, cfg: EngineConfig, device):
    """The engine state at t = 0 from a key (see `random.key`)."""
    k1, k2 = trandom.split(key)
    st = init_abm(k1, cfg.abm, device)
    n, L = cfg.abm.n_se, cfg.abm.n_lp
    st.update(heu.init_state(cfg.heuristic, n, L, device))
    none = torch.full((n,), -1, dtype=torch.int32, device=device)
    st.update({"key": k2, "t": 0, "pending_dst": none,
               "pending_eta": none.clone()})
    return st


def step_phases(cfg: EngineConfig):
    """Ordered (name, fn) phase decomposition of one timestep, with the
    reference's names, cut points and metric keys. Each phase maps the
    phase context dict `px` (state under "st", plus the intermediates
    earlier phases added) to a new one."""
    n, L = cfg.abm.n_se, cfg.abm.n_lp

    def i32(x, like):
        return torch.full_like(like, x)

    def ph_migrate(px):
        st = px["st"]
        t = st["t"]
        key, k_move, k_send = trandom.split(st["key"], 3)
        arrive = st["pending_eta"] == t
        minus1 = i32(-1, st["lp"])
        return dict(px, t=t, key=key, k_move=k_move, k_send=k_send,
                    lp=torch.where(arrive, st["pending_dst"], st["lp"]),
                    pending_dst=torch.where(arrive, minus1,
                                            st["pending_dst"]),
                    pending_eta=torch.where(arrive, minus1,
                                            st["pending_eta"]))

    def ph_mobility(px):
        st = px["st"]
        pos, wp, mob, mob_g = mobility_step(
            px["k_move"], st["pos"], st["waypoint"], st["mob"],
            st["mob_g"], cfg.abm)
        sender = trandom.bernoulli(px["k_send"], cfg.abm.p_interact, (n,),
                                   device=pos.device)
        return dict(px, pos=pos, wp=wp, mob=mob, mob_g=mob_g, sender=sender)

    def ph_proximity(px):
        counts, grid_ovf = interaction_counts_overflow(
            px["pos"], px["lp"], px["sender"], cfg.abm)
        return dict(px, counts=counts, grid_ovf=grid_ovf)

    def ph_account(px):
        # the per-pair flow matrix (src LP -> dst LP) is the single
        # source of truth; the scalar LCR terms are its trace and total
        lp, counts = px["lp"], px["counts"]
        flows = torch.zeros((L, L), dtype=torch.int32, device=lp.device)
        flows.index_add_(0, lp.long(), counts)
        local = flows.diagonal().sum(dtype=torch.int32)
        total = flows.sum(dtype=torch.int32)
        st = px["st"]
        zero = torch.zeros((), dtype=torch.int32, device=lp.device)
        return dict(px, flows=flows, local=local, total=total,
                    remote=total - local,
                    hstate={k: st[k] for k in ("ring", "ptr", "since_eval",
                                               "last_mig")},
                    migs=zero, n_evals=zero, reparts=zero,
                    mig_flows=torch.zeros_like(flows))

    def ph_heuristic(px):
        lp, t = px["lp"], px["t"]
        pending_dst, pending_eta = px["pending_dst"], px["pending_eta"]
        hstate = heu.update_window(cfg.heuristic, px["hstate"],
                                   px["counts"], px["sender"], t)
        cand, dest, alpha, hstate, n_evals = heu.evaluate(
            cfg.heuristic, hstate, lp, t, mf=px["mf"])
        cand = cand & (pending_dst < 0)  # not already in flight
        cmat = bal.candidate_matrix(cand, lp, dest, L)
        if cfg.balance == "asymmetric":
            cap = torch.tensor(cfg.effective_capacity(), dtype=torch.float32,
                               device=lp.device)
            current = bal.bincount(lp, L)
            grants = bal.asymmetric_grants(cmat, current, cap)
        else:
            grants = bal.symmetric_grants(cmat)
        admit = bal.select_migrations(cand, lp, dest, alpha, grants, L)
        hstate = dict(hstate, last_mig=torch.where(
            admit, i32(t, lp), hstate["last_mig"]))
        mig_flows = px["mig_flows"].index_put(
            (lp.long(), dest.long()), admit.to(torch.int32),
            accumulate=True)
        return dict(px,
                    pending_dst=torch.where(admit, dest, pending_dst),
                    pending_eta=torch.where(
                        admit, i32(t + cfg.migration_delay, lp),
                        pending_eta),
                    hstate=hstate, n_evals=n_evals,
                    migs=px["migs"] + admit.sum(dtype=torch.int32),
                    mig_flows=mig_flows)

    def ph_finalize(px):
        new_state = dict(px["st"], key=px["key"], t=px["t"] + 1,
                         pos=px["pos"], waypoint=px["wp"], lp=px["lp"],
                         mob=px["mob"], mob_g=px["mob_g"],
                         pending_dst=px["pending_dst"],
                         pending_eta=px["pending_eta"], **px["hstate"])
        local, total = px["local"].float(), px["total"].float()
        metrics = {
            "local_msgs": local,
            "remote_msgs": px["remote"].float(),
            "migrations": px["migs"].float(),
            "heu_evals": px["n_evals"].float(),
            "lcr": div32(local, torch.clamp(total, min=1.0)),
            "lp_flows": px["flows"],
            "mig_flows": px["mig_flows"],
            "repartitions": px["reparts"].float(),
            "grid_overflow": px["grid_ovf"].float(),
        }
        return dict(px, new_state=new_state, metrics=metrics)

    phases = [("migrate", ph_migrate), ("mobility", ph_mobility),
              ("proximity", ph_proximity), ("accounting", ph_account)]
    if cfg.gaia_on:
        phases.append(("heuristic", ph_heuristic))
    phases.append(("finalize", ph_finalize))
    return phases


def step(state, cfg: EngineConfig, mf=None):
    """One timestep. Returns (state, per-step metrics); `mf` overrides
    cfg.heuristic.mf."""
    px = {"st": state, "mf": mf}
    for _, fn in step_phases(cfg):
        px = fn(px)
    return px["new_state"], px["metrics"]


def series_counters(series) -> dict:
    """Aggregate a per-step metrics series into run counters (host
    floats; the flow matrices as nested int64 lists). Reads the series
    off the device once."""
    series = {k: v.cpu() for k, v in series.items()}
    counters = {k: float(series[k].sum()) for k in
                ("local_msgs", "remote_msgs", "migrations", "heu_evals")}
    counters["mean_lcr"] = float(series["lcr"].mean())
    for k in ("grid_overflow", "repartitions"):
        counters[k] = float(series[k].sum())
    for k in ("lp_flows", "mig_flows"):
        counters[k] = series[k].numpy().sum(axis=0, dtype=np.int64).tolist()
    return counters


def _run_steps(state, cfg: EngineConfig, n_steps: int, mf=None):
    """Advance n_steps; returns (state, series) with the per-step
    metrics stacked on the device."""
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    mf = cfg.heuristic.mf if mf is None else float(mf)
    per_step = []
    for _ in range(n_steps):
        state, m = step(state, cfg, mf=mf)
        per_step.append(m)
    series = {k: torch.stack([m[k] for m in per_step])
              for k in per_step[0]}
    return state, series


def _run_window(state, cfg: EngineConfig, n_steps: int, mf=None):
    """Advance an existing state by n_steps; returns (state, counters)."""
    state, series = _run_steps(state, cfg, n_steps, mf=mf)
    return state, series_counters(series)


def _migration_ratio(counters, cfg: EngineConfig) -> float:
    return counters["migrations"] / (cfg.abm.n_se *
                                     (cfg.timesteps / 1000.0))  # Eq. 8


def _run(key, cfg: EngineConfig, device):
    """Run the full simulation; returns (final_state, stacked metrics,
    aggregate counters)."""
    st = _init_engine(key, cfg, device)
    st, series = _run_steps(st, cfg, cfg.timesteps)
    counters = series_counters(series)
    counters["migration_ratio"] = _migration_ratio(counters, cfg)
    return st, series, counters


def state_from_numpy(arrays, device):
    """The port's engine state from the reference's, given as a dict of
    numpy arrays: the key as its two uint32 words (`jax.random.key_data`),
    the step counter `t` as a scalar, every other array as it is."""
    st = {}
    for k, v in arrays.items():
        if k == "key":
            st[k] = trandom.wrap_key_data(np.asarray(v))
        elif k == "t":
            st[k] = int(v)
        else:
            st[k] = torch.from_numpy(np.array(v)).to(device)
    return st


def state_to_numpy(state) -> dict:
    """Inverse of `state_from_numpy`: numpy arrays, the key as two
    uint32 words and `t` as an int32 scalar."""
    out = {}
    for k, v in state.items():
        if k == "key":
            out[k] = v.numpy().astype(np.uint32)
        elif k == "t":
            out[k] = np.int32(v)
        else:
            out[k] = v.cpu().numpy()
    return out
