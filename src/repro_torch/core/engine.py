"""The GAIA adaptive-partitioning engine (paper §4), the port of
`repro.core.engine` for one replica or a batch, closed or open world.

One step = one simulation timestep, cut into the reference's phases:

  migrate      apply migrations whose protocol delay has elapsed
  mobility     move agents and draw this step's senders
  proximity    per-sender histogram of recipient LPs (the hot spot)
  workload     the epidemic's exposure sweep and SI/SIS update (epidemic
               only; it reuses the proximity phase's grid)
  accounting   the LP-pair flow matrix: local vs remote deliveries
  repartition  every `repartition_every` steps, the partitioner's new
               map enters the migration machinery
  heuristic    window update, evaluation, balancing, admission (GAIA on)
  finalize     the new state and the step's metrics

The reference's compiled `lax.scan` becomes a Python loop over steps.
Every phase stays on the device: a step makes no host sync, and the
metrics are stacked once per window. The PRNG key and the step counter
live on the host (a CPU key tensor, a Python int), so key splitting
never waits for the card.

Replica batching (the reference's `jax.vmap` over seeds). A batch of R
replicas is the solo state with a leading replica axis on every leaf
(the key an (R, 2) tensor), and one step function serves both: every
phase reads its shapes from the state, so a solo step is the same code
on leaves without that axis. Replica r of a batch is bit for bit the
solo run of its seed; each step makes the same kernel launches for R
replicas as for one (one cell-list launch for all R worlds). The init
runs per replica, eagerly, and stacks, as the reference does on
purpose; the repartition phase calls the partitioner once per replica.
MF may be an (R,) vector.

The step counter `t`. One replica, or a batch in lockstep, holds one
Python int. A batch whose replicas are at their own steps
(`ReplicaService` refills a slot at t = 0 while the others go on) holds
a tuple of R ints: the host keeps every replica's clock, so the
repartition phase runs the partitioner only for the replicas at their
own boundary without reading the card, and the phases that compare with
the step (arrivals of in-flight migrations, the window's ring slot, the
heuristic's age test, the migration's due step) get an (R, 1) int32
tensor on the device, copied once a window without blocking.

Open world (`open_world=True`). The state is a universe of `abm.n_se`
slots, `lp >= 0` marking the live ones. Dead rows draw the same
randomness as live ones (so zero churn is bit for bit the closed-world
run), but hold their state, never send, sit in no grid cell, receive
nothing, are never evaluated and never migrate. `oracle_arrive` and
`oracle_depart` are the O(batch) scatters of the service's churn.

Telemetry (`cfg.obs.enabled`, one replica): each window carries a
fresh (drain_every, K) ledger ring on the state's device; each step
writes its row after the step (`obs.ledger.write_row`), and the ring
drains to the host by non-blocking copies (`obs.runtime`), so a step
still makes no host sync. The ring never feeds back into the step. The
batched paths run without it (`strip_obs`), as the reference's do.

`state_from_numpy` / `state_to_numpy` carry an engine state, solo or
batched, between the reference and the port (the key as its uint32
words).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import balance as bal
from repro_torch.core import heuristics as heu
from repro_torch.core import neighbors
from repro_torch.core import partition as part
from repro_torch.core.abm import (ABMConfig, check_trace_horizon,
                                  epidemic_draws,
                                  epidemic_exposure_overflow,
                                  epidemic_row_update, epidemic_send_prob,
                                  infection_table, init_abm,
                                  interaction_counts_overflow,
                                  mobility_step, proximity_grid)
from repro_torch.core.costmodel import ExecutionEnvironment
from repro_torch.core.heuristics import HeuristicConfig
from repro_torch.fp32 import div32
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import runtime as obs_runtime
from repro_torch.obs.config import ObsConfig

SHARDINGS = ("none", "lp_device")

#: PRNG salt of the periodic-repartition stream, folded into the step's
#: k_move
REPART_SALT = 0x7a47


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

    def effective_capacity(self) -> Optional[tuple]:
        """Asymmetric capacity shares: explicit `capacity` wins, else the
        environment's relative LP speeds (normalized), else None."""
        if self.capacity is not None:
            return tuple(self.capacity)
        if self.env is not None:
            return self.env.capacity_shares()
        return None

    def initial_live(self) -> int:
        """Live SEs at t = 0: `n_active` under open_world (0 = full), the
        whole population otherwise."""
        if self.open_world and self.n_active > 0:
            return self.n_active
        return self.abm.n_se


def strip_obs(cfg: EngineConfig) -> EngineConfig:
    """Drop telemetry from a config: the batched paths run without the
    ledger (it covers the single-replica resident paths), as in the
    reference."""
    if not cfg.obs.enabled:
        return cfg
    return dataclasses.replace(cfg, obs=ObsConfig())


def _init_engine(key, cfg: EngineConfig, device):
    """The engine state at t = 0 from a key (see `random.key`). An open
    world's slots [initial_live, n_se) start free (lp = -1); the draws
    are the closed world's, so the live prefix is its rows. Under
    sharding="lp_device" the state is this process's shards
    (`parallel.lp_shard.init_sharded`)."""
    if cfg.sharding == "lp_device":
        from repro_torch.parallel import lp_shard
        spec, mesh = lp_shard.layout(cfg)
        return lp_shard.init_sharded(key, cfg, spec, device, mesh)
    k1, k2 = trandom.split(key)
    st = init_abm(k1, cfg.abm, device)
    n, L = cfg.abm.n_se, cfg.abm.n_lp
    st.update(heu.init_state(cfg.heuristic, n, L, device))
    none = torch.full((n,), -1, dtype=torch.int32, device=device)
    st.update({"key": k2, "t": 0, "pending_dst": none,
               "pending_eta": none.clone()})
    live = cfg.initial_live()
    if cfg.open_world and live < n:
        st["lp"] = st["lp"].clone()
        st["lp"][live:] = -1
    return st


def clock(ts):
    """A batch's step counter from its replicas' steps: one int when
    they are in lockstep, else a tuple of them."""
    ts = tuple(int(x) for x in ts)
    return ts[0] if len(set(ts)) == 1 else ts


def latest(t) -> int:
    """The furthest step of a counter (an int, or a tuple of steps)."""
    return max(t) if isinstance(t, tuple) else t


def host_to(t, device):
    """A host tensor on `device`: on the card through a pinned buffer,
    copied without blocking the host."""
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def steps_on(t, device):
    """The step as the phases compare with it: the int itself, or for a
    tuple of per-replica steps an (R, 1) int32 tensor on `device`."""
    if not isinstance(t, tuple):
        return t
    return host_to(torch.tensor(t, dtype=torch.int32)[:, None], device)


def _replica_index(like):
    """The replica index as indices of a (..., L, L) matrix: () for a
    solo row tensor, an (R, 1) column of 0..R-1 for a batch."""
    if like.dim() == 1:
        return ()
    return (torch.arange(like.shape[0], device=like.device)[:, None],)


def _pair_add(mat, src, dst, mask):
    """mat[..., src, dst] += mask, per replica (int32 adds, exact)."""
    return mat.index_put(
        _replica_index(src) + (src.long(), dst.long()),
        mask.to(torch.int32), accumulate=True)


def lp_flows(safe_lp, counts, L: int):
    """(flows, local, total) of a step's counts: the per-pair flow
    matrix (src LP -> dst LP; (..., L, L) int32, per replica for a
    batch), its trace and its total. `safe_lp` holds every row's LP in
    [0, L) (a dead row's zero counts add nothing wherever they land)."""
    lead = safe_lp.shape[:-1]
    flows = torch.zeros(lead + (L, L), dtype=torch.int32,
                        device=safe_lp.device)
    rows = safe_lp.long()
    if lead:  # replica r's rows of the (R * L, L) flat flows
        rows = rows + neighbors.replica_offsets(lead[0], L, safe_lp.device)
    flows.view(-1, L).index_add_(0, rows.reshape(-1), counts.reshape(-1, L))
    local = flows.diagonal(dim1=-2, dim2=-1).sum(-1, dtype=torch.int32)
    total = flows.sum((-2, -1), dtype=torch.int32)
    return flows, local, total


def step_phases(cfg: EngineConfig):
    """Ordered (name, fn) phase decomposition of one timestep, with the
    reference's names, cut points and metric keys. Each phase maps the
    phase context dict `px` (state under "st", plus the intermediates
    earlier phases added) to a new one. Per-SE values are (N, ...) for
    one replica and (R, N, ...) for a batch, per-replica values () and
    (R,). The step is "t" (an int, or a tuple of per-replica steps) and
    "tv" (the int, or their (R, 1) tensor, see `steps_on`; the caller
    may put it in the first context, else the migrate phase makes it).
    A batch's context may hold "active", R host bools: the repartition
    phase skips the replicas that are not active (a service's idle
    slots, whose results are discarded)."""
    n, L = cfg.abm.n_se, cfg.abm.n_lp
    ow = cfg.open_world

    def i32(x, like):
        return torch.full_like(like, x)

    def at(x, like):
        """A step value (an int, or (R, 1) per replica) on like's rows."""
        return x.expand_as(like) if isinstance(x, torch.Tensor) \
            else i32(x, like)

    def ph_migrate(px):
        st = px["st"]
        tv = px["tv"] if "tv" in px else steps_on(st["t"], st["lp"].device)
        key, k_move, k_send = trandom.split(st["key"], 3)
        arrive = st["pending_eta"] == tv
        minus1 = i32(-1, st["lp"])
        lp = torch.where(arrive, st["pending_dst"], st["lp"])
        return dict(px, t=st["t"], tv=tv, key=key, k_move=k_move,
                    k_send=k_send, lp=lp, valid=lp >= 0 if ow else None,
                    pending_dst=torch.where(arrive, minus1,
                                            st["pending_dst"]),
                    pending_eta=torch.where(arrive, minus1,
                                            st["pending_eta"]))

    def ph_mobility(px):
        st, valid = px["st"], px["valid"]
        pos, wp, mob, mob_g = mobility_step(
            px["k_move"], st["pos"], st["waypoint"], st["mob"],
            st["mob_g"], cfg.abm, valid=valid)
        if ow:  # dead rows hold their slot state (pure selection)
            keep = valid[..., None]
            pos = torch.where(keep, pos, st["pos"])
            wp = torch.where(keep, wp, st["waypoint"])
            mob = torch.where(keep, mob, st["mob"])
        if cfg.abm.workload == "epidemic":
            # last step's infectious SEs send epi_boost x more often
            sender = trandom.uniform(px["k_send"], (n,), device=pos.device) \
                < epidemic_send_prob(st["epi"], cfg.abm)
        else:
            sender = trandom.bernoulli(px["k_send"], cfg.abm.p_interact,
                                       (n,), device=pos.device)
        if ow:
            sender = valid & sender
        return dict(px, pos=pos, wp=wp, mob=mob, mob_g=mob_g, sender=sender)

    def ph_proximity(px):
        grid = proximity_grid(px["pos"], cfg.abm, valid=px["valid"])
        counts, grid_ovf = interaction_counts_overflow(
            px["pos"], px["lp"], px["sender"], cfg.abm, grid=grid)
        return dict(px, counts=counts, grid_ovf=grid_ovf, grid=grid)

    def ph_workload(px):
        # susceptible SEs count the in-range infectious rows that sent
        # this step (the proximity kernels with 0/1 labels, over the
        # proximity phase's grid) and run the SI/SIS transition; dead
        # rows carry label -1 and are not asked
        epi, pos, valid = px["st"]["epi"], px["pos"], px["valid"]
        labels = ((epi > 0) & px["sender"]).to(torch.int32)
        qmask = epi == 0
        if ow:
            labels = torch.where(valid, labels, -1)
            qmask = qmask & valid
        exposure, ovf = epidemic_exposure_overflow(
            pos, labels, qmask, cfg.abm, grid=px["grid"], valid=valid)
        draws = epidemic_draws(px["k_move"], n, cfg.abm, pos.device)
        epi = epidemic_row_update(epi, exposure, draws, cfg.abm,
                                  infection_table(cfg.abm, pos.device))
        sick = (epi > 0) & valid if ow else epi > 0
        return dict(px, epi=epi,
                    infected=sick.sum(-1, dtype=torch.int32),
                    grid_ovf=px["grid_ovf"] | ovf)

    def ph_account(px):
        # the per-pair flow matrix (src LP -> dst LP) is the single
        # source of truth; the scalar LCR terms are its trace and total.
        # A dead row's lp -1 reads as LP 0 (`safe_lp`): its counts are
        # zeros, so it adds nothing
        lp = px["lp"]
        safe_lp = lp.clamp(0, L - 1) if ow else lp
        lead = lp.shape[:-1]
        flows, local, total = lp_flows(safe_lp, px["counts"], L)
        st = px["st"]
        zero = torch.zeros(lead, dtype=torch.int32, device=lp.device)
        return dict(px, safe_lp=safe_lp, flows=flows, local=local,
                    total=total,
                    remote=total - local,
                    hstate={k: st[k] for k in ("ring", "ptr", "since_eval",
                                               "last_mig")},
                    migs=zero, n_evals=zero, reparts=zero,
                    mig_flows=torch.zeros_like(flows))

    def ph_repartition(px):
        # every R steps the partitioner recomputes the global map from
        # the current geometry; the delta enters the in-flight migration
        # machinery (SEs already in flight are skipped). A batch at its
        # own steps runs the partitioner for the replicas at their
        # boundary only: the others keep their map.
        t, tv, every = px["t"], px["tv"], cfg.repartition_every
        lp, pos, valid = px["lp"], px["pos"], px["valid"]
        ts = t if isinstance(t, tuple) else (t,) * lp[..., 0].numel()
        active = px.get("active") or (True,) * len(ts)
        due = [r for r, tr in enumerate(ts)
               if active[r] and tr > 0 and tr % every == 0]
        if not due:
            return px
        pending_dst = px["pending_dst"]
        pcfg = part.from_engine(cfg)
        keys = trandom.fold_in(px["k_move"], REPART_SALT)
        if ow:  # dead rows: weight 0 at position 0, and they never move
            weights = valid.float()
            pos = torch.where(valid[..., None], pos, 0.0)
        else:
            weights = torch.ones((n,), dtype=torch.float32,
                                 device=pos.device).expand(lp.shape)

        def repartition(key, pos, w, lp):
            return part.partition(key, pos, w, pcfg,
                                  prev=lp if part.uses_prev(pcfg) else None,
                                  compiled=True)
        if lp.dim() == 1:
            new_lp = repartition(keys, pos, weights, lp)
        else:  # the solo partitioner, a due replica at a time
            new_lp = lp.clone()
            for r in due:
                new_lp[r] = repartition(keys[r], pos[r], weights[r], lp[r])
        move = (new_lp != lp) & (pending_dst < 0)
        if ow:
            move = move & valid
        reparts = move.sum(-1, dtype=torch.int32)
        mig_flows = _pair_add(px["mig_flows"], px["safe_lp"], new_lp, move)
        return dict(px, pending_dst=torch.where(move, new_lp, pending_dst),
                    pending_eta=torch.where(
                        move, at(tv + cfg.migration_delay, lp),
                        px["pending_eta"]),
                    hstate=dict(px["hstate"], last_mig=torch.where(
                        move, at(tv, lp), px["hstate"]["last_mig"])),
                    reparts=reparts, migs=px["migs"] + reparts,
                    mig_flows=mig_flows)

    def ph_heuristic(px):
        lp, tv, safe_lp = px["lp"], px["tv"], px["safe_lp"]
        pending_dst, pending_eta = px["pending_dst"], px["pending_eta"]
        hstate = heu.update_window(cfg.heuristic, px["hstate"],
                                   px["counts"], px["sender"], tv)
        cand, dest, alpha, hstate, n_evals = heu.evaluate(
            cfg.heuristic, hstate, lp, tv, valid=px["valid"], mf=px["mf"])
        cand = cand & (pending_dst < 0)  # not already in flight
        cmat = bal.candidate_matrix(cand, safe_lp, dest, L)
        if cfg.balance == "asymmetric":
            cap = torch.tensor(cfg.effective_capacity(), dtype=torch.float32,
                               device=lp.device)
            # an open world's dead rows count in an extra bucket, dropped
            current = bal.bincount(torch.where(lp < 0, L, lp), L + 1)[
                ..., :L] if ow else bal.bincount(lp, L)
            grants = bal.asymmetric_grants(cmat, current, cap)
        else:
            grants = bal.symmetric_grants(cmat)
        admit = bal.select_migrations(cand, safe_lp, dest, alpha, grants, L)
        hstate = dict(hstate, last_mig=torch.where(
            admit, at(tv, lp), hstate["last_mig"]))
        mig_flows = _pair_add(px["mig_flows"], safe_lp, dest, admit)
        return dict(px,
                    pending_dst=torch.where(admit, dest, pending_dst),
                    pending_eta=torch.where(
                        admit, at(tv + cfg.migration_delay, lp),
                        pending_eta),
                    hstate=hstate, n_evals=n_evals,
                    migs=px["migs"] + admit.sum(-1, dtype=torch.int32),
                    mig_flows=mig_flows)

    def ph_finalize(px):
        t = px["t"]
        t = tuple(x + 1 for x in t) if isinstance(t, tuple) else t + 1
        new_state = dict(px["st"], key=px["key"], t=t,
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
        if ow:  # the live population after this step's arrivals
            metrics["pop"] = px["valid"].sum(-1, dtype=torch.int32).float()
        if cfg.abm.workload == "epidemic":
            new_state["epi"] = px["epi"]
            metrics["infected"] = px["infected"].float()
        return dict(px, new_state=new_state, metrics=metrics)

    phases = [("migrate", ph_migrate), ("mobility", ph_mobility),
              ("proximity", ph_proximity), ("accounting", ph_account)]
    if cfg.abm.workload == "epidemic":
        phases.insert(3, ("workload", ph_workload))
    if cfg.repartition_every > 0:
        phases.append(("repartition", ph_repartition))
    if cfg.gaia_on:
        phases.append(("heuristic", ph_heuristic))
    phases.append(("finalize", ph_finalize))
    return phases


def step(state, cfg: EngineConfig, mf=None, tv=None, active=None):
    """One timestep of one replica or a batch. Returns (state, per-step
    metrics); `mf` overrides cfg.heuristic.mf (a batch: an (R,) float32
    tensor on the state's device, or one value for all). `tv` is
    `steps_on(state["t"], device)` when the caller has it; `active`
    (a batch: R host bools, None for all) names the replicas whose
    repartitions run. Under sharding="lp_device" the state is sharded
    (`parallel.lp_shard.step_sharded`)."""
    if cfg.sharding == "lp_device":
        from repro_torch.parallel import lp_shard
        return lp_shard.step_sharded(state, cfg, mf, tv, active)
    px = {"st": state, "mf": mf, "active": active}
    if tv is not None:
        px["tv"] = tv
    for _, fn in step_phases(cfg):
        px = fn(px)
    return px["new_state"], px["metrics"]


# ---------------------------------------------------------------------------
# open-world churn: O(batch) scatters into the state on its device (the
# free-slot pool and its checks live in core/service.py's Engine)
# ---------------------------------------------------------------------------


def _clear_slot_history(st, ids):
    """Reset the protocol and heuristic history of slots `ids` (an int64
    tensor on the state's device) to their init values, so a reused
    slot carries nothing of its previous occupant."""
    for k, v in (("pending_dst", -1), ("pending_eta", -1), ("ptr", 0),
                 ("since_eval", 0), ("last_mig", -10**6)):
        st[k] = st[k].index_fill(0, ids, v)
    st["ring"] = st["ring"].index_fill(1, ids, 0)
    return st


def oracle_arrive(state, ids, rows):
    """Insert a batch of SEs into the free slots `ids`. `rows` holds
    per-arrival tensors on the state's device: "pos" (B, 2) and "lp"
    (B,), optionally "waypoint" (default: the arrival position), "mob"
    (default zeros) and "epi" (default 0, susceptible)."""
    st = dict(state)
    pos = rows["pos"]
    fills = {"pos": pos, "waypoint": rows.get("waypoint", pos),
             "mob": rows.get("mob", torch.zeros_like(pos)),
             "lp": rows["lp"],
             "epi": rows.get("epi", torch.zeros_like(rows["lp"]))}
    for k, v in fills.items():
        st[k] = st[k].index_copy(0, ids, v)
    return _clear_slot_history(st, ids)


def oracle_depart(state, ids):
    """Free the slots `ids`: lp = -1 marks them dead, and their history
    resets so the next occupant starts clean."""
    st = dict(state)
    st["lp"] = st["lp"].index_fill(0, ids, -1)
    st["epi"] = st["epi"].index_fill(0, ids, 0)
    return _clear_slot_history(st, ids)


def host_series(series) -> dict:
    """A series dict on the host, copied off the device in one transfer
    (one synchronising call, however many keys): every tensor's bytes
    go into one buffer."""
    dev = next(iter(series.values())).device
    if dev.type == "cpu":
        return dict(series)
    parts, spans, at = [], [], 0
    for v in series.values():
        b = v.contiguous().view(-1).view(torch.uint8)
        pad = -b.numel() % 8  # every part starts 8-byte aligned
        parts += [b, b.new_zeros(pad)]
        spans.append((at, b.numel()))
        at += b.numel() + pad
    host = torch.cat(parts).cpu()
    return {k: host[a:a + nb].view(v.dtype).view(v.shape)
            for (k, v), (a, nb) in zip(series.items(), spans)}


def series_counters(series) -> dict:
    """Aggregate a per-step metrics series into run counters (host
    floats; the flow matrices as nested int64 lists). Reads the series
    off the device once (`host_series`). The counts are summed in
    float64: each step's float32 count is an exact integer, so the total
    is exact however a run is cut into windows (a float32 sum rounds
    once it passes 2**24, as a full-width hotspot run's messages do
    within ten steps). A sharded series (one that carries `wire_flows`)
    has no grid_overflow (its `shard_overflow` covers the views' grids)
    and adds the mean halo_frac, the steps with shard_overflow,
    bytes_on_wire and the summed wire_flows (int64)."""
    series = host_series(series)
    counters = {k: float(series[k].double().sum()) for k in
                ("local_msgs", "remote_msgs", "migrations", "heu_evals")}
    counters["mean_lcr"] = float(series["lcr"].mean())
    if "pop" in series:
        counters["mean_pop"] = float(series["pop"].mean())
    if "infected" in series:
        counters["mean_infected"] = float(series["infected"].mean())
        counters["final_infected"] = float(series["infected"][-1])
    for k in ("grid_overflow", "repartitions"):
        if k in series:
            counters[k] = float(series[k].double().sum())
    for k in ("lp_flows", "mig_flows"):
        counters[k] = series[k].numpy().sum(axis=0, dtype=np.int64).tolist()
    if "wire_flows" in series:
        counters["mean_halo_frac"] = float(series["halo_frac"].mean())
        counters["shard_overflow"] = float(
            series["shard_overflow"].double().sum())
        wf = series["wire_flows"].numpy().astype(np.int64)
        counters["bytes_on_wire"] = float(wf.sum())
        counters["wire_flows"] = wf.sum(axis=0).tolist()
    return counters


def _run_steps(state, cfg: EngineConfig, n_steps: int, mf=None,
               active=None):
    """Advance n_steps; returns (state, series) with the per-step
    metrics stacked on the device ((T, ...), or (T, R, ...) for a
    batch; `active` as `step` takes it). With cfg.obs.enabled (one
    replica), a fresh ledger ring takes each step's row, drains at its
    wraps, and its tail is flushed to the current session at the end."""
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if not isinstance(mf, torch.Tensor):
        mf = cfg.heuristic.mf if mf is None else float(mf)
    # a batch at its own steps: the steps reach the card once a window
    t0 = steps_on(state["t"], state["lp"].device)
    ring = obs_ledger.new_ring(cfg, state["lp"].device) \
        if cfg.obs.enabled else None
    t_start = state["t"]
    per_step = []
    for k in range(n_steps):
        t = state["t"]
        state, m = step(state, cfg, mf=mf, tv=t0 + k if k else t0,
                        active=active)
        if ring is not None:
            obs_ledger.write_row(ring, cfg, state, m, t)
        per_step.append(m)
    if ring is not None:
        obs_runtime.flush_tail(ring, t_start, t_start + n_steps)
    series = {k: torch.stack([m[k] for m in per_step])
              for k in per_step[0]}
    return state, series


def _run_window(state, cfg: EngineConfig, n_steps: int, mf=None):
    """Advance an existing state by n_steps; returns (state, counters).
    Under trace_policy='exact' the window's frames are checked first."""
    check_trace_horizon(cfg.abm, latest(state["t"]), n_steps)
    state, series = _run_steps(state, cfg, n_steps, mf=mf)
    return state, series_counters(series)


def _migration_ratio(counters, cfg: EngineConfig) -> float:
    return counters["migrations"] / (cfg.abm.n_se *
                                     (cfg.timesteps / 1000.0))  # Eq. 8


def _run(key, cfg: EngineConfig, device):
    """Run the full simulation; returns (final_state, stacked metrics,
    aggregate counters). Sharded, the final state is unsharded to id
    order (the oracle's layout)."""
    check_trace_horizon(cfg.abm, 0, cfg.timesteps)
    st = _init_engine(key, cfg, device)
    st, series = _run_steps(st, cfg, cfg.timesteps)
    counters = series_counters(series)
    counters["migration_ratio"] = _migration_ratio(counters, cfg)
    return _unshard(st, cfg), series, counters


def _unshard(state, cfg: EngineConfig, batch: bool = False):
    """A sharded run's final state in id order (the oracle's layout);
    any other state as it is."""
    if cfg.sharding != "lp_device":
        return state
    from repro_torch.parallel import lp_shard
    spec, mesh = lp_shard.layout(cfg)
    return (lp_shard.unshard_batch if batch else lp_shard.unshard_state)(
        state, spec, mesh)


def state_from_numpy(arrays, device):
    """The port's engine state from the reference's, given as a dict of
    numpy arrays: the key as its uint32 words (`jax.random.key_data`:
    (2,), or (R, 2) for a batch), the step counter `t` as a scalar (a
    batch's (R,) counters become one int, or a tuple when they differ;
    see `clock`), every other array as it is."""
    st = {}
    for k, v in arrays.items():
        if k == "key":
            st[k] = trandom.wrap_key_data(np.asarray(v))
        elif k == "t":
            st[k] = clock(np.asarray(v).reshape(-1).tolist())
        else:
            st[k] = torch.from_numpy(np.array(v)).to(device)
    return st


def state_to_numpy(state) -> dict:
    """Inverse of `state_from_numpy`: numpy arrays, the key as uint32
    words and `t` as an int32 scalar ((R,) for a batch, as the
    reference's stacked state holds it: each replica's own step)."""
    out = {}
    batch = state["key"].dim() == 2
    for k, v in state.items():
        if k == "key":
            out[k] = v.numpy().astype(np.uint32)
        elif k == "t":
            out[k] = np.int32(v) if not batch else np.asarray(
                v, np.int32) if isinstance(v, tuple) else np.full(
                    (state["key"].shape[0],), v, np.int32)
        else:
            out[k] = v.cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# batched multi-replica execution (the reference's vmap over seeds)
# ---------------------------------------------------------------------------


def replica_keys(seeds):
    """Seeds -> the (R, 2) key batch: row r is `random.key(seeds[r])`,
    so replica r reproduces a solo run of seeds[r] bit for bit."""
    return trandom.keys(seeds)


def stack_states(states):
    """Stack per-replica states along a new leading replica axis (keys
    included); `t` becomes one int when the replicas share their step,
    else the tuple of their steps (see `clock`)."""
    return {k: clock(s["t"] for s in states) if k == "t" else
            torch.stack([s[k] for s in states]) for k in states[0]}


def _init_batch(cfg: EngineConfig, seeds, device):
    """Stacked engine state for R replicas: each replica's init runs
    through the solo, eager init, then the states stack (as the
    reference does, so the batch's init is each seed's own)."""
    if len(seeds) < 1:
        raise ValueError("a replica batch needs at least one seed")
    return stack_states([_init_engine(k, cfg, device)
                         for k in replica_keys(seeds)])


def _mf_vector(cfg: EngineConfig, mf, n_rep: int, device):
    """Per-replica Migration Factors: None or a scalar is one value for
    every replica (a Python float, as a solo run takes it); a vector of
    R values becomes an (R,) float32 tensor on `device`, copied once a
    window from a pinned buffer without blocking the host."""
    if mf is None or np.ndim(mf) == 0:
        return cfg.heuristic.mf if mf is None else float(mf)
    if isinstance(mf, torch.Tensor):
        mf = mf.detach().cpu().numpy()
    v = np.asarray(mf, np.float32).reshape(-1)
    if v.shape != (n_rep,):
        raise ValueError(f"mf holds {v.size} values for {n_rep} replicas")
    return host_to(torch.from_numpy(v.copy()), device)


def replica_series(series, r: int):
    """Replica r of a batched (T, R, ...) series: the (T, ...) series a
    solo run would have produced (contiguous, so its float32 sums add in
    the solo order)."""
    return {k: v[:, r].contiguous() for k, v in series.items()}


def _batch_counters(series, n_rep: int):
    """One `series_counters` dict per replica, from one copy of the
    series off the device."""
    host = host_series(series)
    return [series_counters(replica_series(host, r)) for r in range(n_rep)]


def _run_window_batch(states, cfg: EngineConfig, n_steps: int, mf=None,
                      active=None):
    """Advance R stacked replica states by n_steps; `mf` a scalar (all
    replicas) or an (R,) vector; `active` R bools (None: all), the
    replicas whose repartitions run. Returns (states, [counters per
    replica])."""
    check_trace_horizon(cfg.abm, latest(states["t"]), n_steps)
    n_rep = states["key"].shape[0]
    states, series = _run_steps(
        states, strip_obs(cfg), n_steps,
        mf=_mf_vector(cfg, mf, n_rep, states["lp"].device), active=active)
    return states, _batch_counters(series, n_rep)


def _run_batch(cfg: EngineConfig, seeds, device):
    """Run R independent replicas, one per seed, in one batched pass.
    Returns (states, series, reps): the stacked final states, the (T, R,
    ...) series on the device, and one counters dict per replica (the
    solo run's schema, `migration_ratio` included)."""
    check_trace_horizon(cfg.abm, 0, cfg.timesteps)
    states = _init_batch(cfg, list(seeds), device)
    states, series = _run_steps(states, strip_obs(cfg), cfg.timesteps)
    reps = _batch_counters(series, len(seeds))
    for c in reps:
        c["migration_ratio"] = _migration_ratio(c, cfg)
    return _unshard(states, cfg, batch=True), series, reps
