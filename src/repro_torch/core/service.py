"""The resident engine facade, the port of `repro.core.service`.

    >>> eng = Engine(cfg).init(seed=0)   # state on the card
    >>> eng.step(200)                    # window counters
    >>> ids = eng.arrive({"pos": new_pos})  # open_world only
    >>> eng.query_neighbors(ids[:2])
    >>> eng.metrics()                    # accumulated run counters
    >>> Engine(cfg, device="cpu").run(seed=0)
    >>> Engine(cfg).init(seeds=[0, 1, 2]).step(100, mf=[1.2, 2.0, 4.0])
    >>> svc = ReplicaService(cfg, n_slots=4)
    >>> svc.submit(seed=0, steps=300); svc.drain()

The engine runs on the card unless the caller asks for the CPU
(`device="cpu"`); without a visible GPU, `Engine(cfg)` raises rather
than move to the CPU quietly. A batched engine (`seeds=`) returns one
counters dict per replica.

- **Open-world churn** (`EngineConfig(open_world=True)`): `arrive` and
  `depart` are O(batch) scatters into the state on its device
  (`engine.oracle_arrive` / `oracle_depart`). The free-slot pool lives
  on the host, in the reference's order, so a script of churn gets the
  reference's ids. A batch larger than the pool raises before it
  touches the state.
- **Queries** from the state on its device: `query_neighbors` (the CSR
  cell list as a read-only index, or a dense sweep in worlds too small
  to tessellate), `query_lcr` (the proximity kernel with every live SE
  a sender) and `query_region` (a wrap-aware box).
- **Sharded** (`sharding="lp_device"`): the state is slot-major, the
  churn goes through `parallel.lp_shard.arrive_sharded` /
  `depart_sharded` (an arrival whose shard has no free slot raises,
  naming shard_capacity, with the admitted rest applied), and the
  queries read the slot universe with each slot's SE id (`gid`),
  without unsharding.
- `ReplicaService`: continuous batching of requests over the replica
  axis. A finished slot is refilled at t = 0 while the others go on at
  their own steps; each request's counters are its solo run's.

Churn and queries address one resident world: a batched engine raises
on them.

Telemetry (`EngineConfig(obs=ObsConfig(enabled=True))`): the session
(`self.telemetry`) hears the ledger rows of every single-replica `run`
and `step` window (the batched paths run without it, `strip_obs`), and
churn batches as `arrive` / `depart` events stamped with the engine's
step; `ledger()`, `events(kind)` and `prometheus()` read it. The session
is made current (`repro_torch.obs.runtime`) before every `run` and
`step`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import engine as _eng
from repro_torch.core import neighbors
from repro_torch.core.abm import interaction_counts_overflow
from repro_torch.core.engine import EngineConfig
from repro_torch.core.stats import merge_counters
from repro_torch.fp32 import f32
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import runtime as obs_runtime
from repro_torch.obs.prom import prometheus_text


def resolve_device(device=None) -> torch.device:
    """`device`, or "cuda" when it is None. Raises when CUDA is asked
    for (explicitly or by default) and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the GPU unless "
            "the caller passes device=\"cpu\"")
    return dev


def _on(array, dtype, device):
    """A host array as a tensor on `device` (`engine.host_to`)."""
    return _eng.host_to(torch.from_numpy(
        np.ascontiguousarray(array, dtype=dtype)), device)


class Engine:
    """Resident facade over the GAIA engine (see module docstring)."""

    def __init__(self, cfg: EngineConfig, device=None, obs_sinks=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = None
        self._batched = False
        self._parts = []  # per-window counters (lists, batched)
        self._weights = []
        self._steps = 0
        self._live = set()
        self._free = []
        # the telemetry session (cfg.obs.enabled): ledger rows of the
        # single-replica windows, churn and tuner events
        self.telemetry = (obs_ledger.Telemetry(cfg, sinks=obs_sinks)
                          if cfg.obs.enabled else None)

    # -- lifecycle -------------------------------------------------------

    def init(self, seeds=None, *, seed: int = 0) -> "Engine":
        """Materialize resident device state: one replica from `seed`,
        or R stacked replicas from `seeds` (overrides `seed`)."""
        if seeds is not None:
            self.state = _eng._init_batch(self.cfg, list(seeds),
                                          self.device)
            self._batched = True
        else:
            self.state = _eng._init_engine(trandom.key(seed), self.cfg,
                                           self.device)
            self._batched = False
        self._parts, self._weights, self._steps = [], [], 0
        live = self.cfg.initial_live()
        self._live = set(range(live))
        self._free = list(range(self.cfg.abm.n_se - 1, live - 1, -1))
        return self

    def run(self, seeds=None, *, seed: int = 0):
        """One-shot run of cfg.timesteps steps: returns (final_state,
        per-step series, counters); with `seeds`, the stacked states,
        the (T, R, ...) series and a list of counters, one per replica.
        Does not touch the resident state."""
        if self.telemetry is not None:
            obs_runtime.set_current(self.telemetry)
        if seeds is not None:
            return _eng._run_batch(self.cfg, list(seeds), self.device)
        return _eng._run(trandom.key(seed), self.cfg, self.device)

    def _require_state(self):
        if self.state is None:
            raise RuntimeError("Engine.init() first — no resident state")

    def _single(self, what: str):
        self._require_state()
        if self._batched:
            raise RuntimeError(
                f"{what} addresses one resident world; this Engine holds "
                "a replica batch (init(seed=...) for a single one)")

    # -- stepping --------------------------------------------------------

    def step(self, n: int = 1, mf=None):
        """Advance the resident state n timesteps; returns this window's
        counters (a list of per-replica dicts when batched) and
        accumulates them into `metrics()`. `mf` overrides the Migration
        Factor for the window (a batch: one value, or one a replica)."""
        self._require_state()
        if self.telemetry is not None:
            obs_runtime.set_current(self.telemetry)
        if self._batched:
            self.state, counters = _eng._run_window_batch(
                self.state, self.cfg, n, mf=mf)
        else:
            self.state, counters = _eng._run_window(self.state, self.cfg,
                                                    n, mf=mf)
        self._parts.append(counters)
        self._weights.append(n)
        self._steps += n
        return counters

    def metrics(self) -> dict:
        """Counters accumulated over every `step` window so far, plus
        the Eq. 8 migration_ratio over the stepped span (a list of
        per-replica dicts when batched)."""
        self._require_state()
        if not self._parts:
            return [] if self._batched else {}
        per_k = self.cfg.abm.n_se * (max(self._steps, 1) / 1000.0)
        if self._batched:
            out = []
            for r in range(len(self._parts[0])):
                c = merge_counters([p[r] for p in self._parts],
                                   self._weights)
                c["migration_ratio"] = c["migrations"] / per_k
                out.append(c)
            return out
        c = merge_counters(self._parts, self._weights)
        c["migration_ratio"] = c["migrations"] / per_k
        return c

    # -- telemetry views (cfg.obs.enabled) -------------------------------

    def _require_obs(self, what: str):
        if self.telemetry is None:
            raise RuntimeError(
                f"{what} needs EngineConfig(obs=ObsConfig(enabled=True))")

    def ledger(self):
        """The per-step :class:`~repro_torch.obs.ledger.MetricsLedger`
        filled by the ring's drain (rows()/column()/summary()/latest())."""
        self._require_obs("ledger")
        return self.telemetry.ledger

    def events(self, kind=None) -> list:
        """Telemetry events recorded so far, newest last, optionally
        filtered by kind (see repro_torch.obs.events.EVENT_KINDS)."""
        self._require_obs("events")
        return self.telemetry.events.records(kind)

    def prometheus(self) -> str:
        """Prometheus text exposition of the session: latest per-step
        gauges and whole-run means from the ledger, event counts, and
        the facade's own occupancy."""
        self._require_obs("prometheus")
        extra = {"steps_total": self._steps}
        if self.cfg.open_world:
            extra["population"] = self.population()
        return prometheus_text(self.telemetry, extra=extra)

    def close(self) -> None:
        """Flush and close the telemetry sinks (file sinks in
        particular); the engine stays usable, and events stop reaching
        closed sinks."""
        if self.telemetry is not None:
            if obs_runtime.get_current() is self.telemetry:
                obs_runtime.set_current(None)
            self.telemetry.close()

    # -- open-world churn ------------------------------------------------

    def _require_open(self, what: str):
        self._single(what)
        if not self.cfg.open_world:
            raise RuntimeError(
                f"{what} needs EngineConfig(open_world=True)")

    def population(self) -> int:
        """Live SEs (the host's view of the free-slot pool)."""
        return len(self._live)

    def live_ids(self) -> list:
        """Sorted ids of the live SEs (the valid depart targets)."""
        return sorted(self._live)

    def arrive(self, rows) -> list:
        """Admit a batch of SEs. `rows["pos"]` (B, 2) is required;
        optional "lp" (default: the x-stripe LP of the position),
        "waypoint", "mob", "epi" (infection flag, default susceptible).
        Returns the B assigned SE ids. Raises RuntimeError, state
        untouched, if the universe has fewer than B free slots."""
        self._require_open("arrive")
        pos = np.asarray(rows["pos"], np.float32).reshape(-1, 2)
        b = pos.shape[0]
        if b == 0:
            return []
        if b > len(self._free):
            raise RuntimeError(
                f"arrive: batch of {b} exceeds the {len(self._free)} "
                f"free slots of the n_se={self.cfg.abm.n_se} universe; "
                "raise abm.n_se (the slot universe) or depart SEs first")
        abm = self.cfg.abm
        if "lp" in rows:
            lps = np.asarray(rows["lp"], np.int32).reshape(-1)
        else:  # the reference's float32 x-stripe
            lps = np.clip((pos[:, 0] / abm.area * abm.n_lp).astype(
                np.int32), 0, abm.n_lp - 1)
        ids = [self._free.pop() for _ in range(b)]
        dev = self.device
        trows = {"pos": _on(pos, np.float32, dev),
                 "lp": _on(lps, np.int32, dev)}
        for k in ("waypoint", "mob"):
            if k in rows:
                trows[k] = _on(np.asarray(rows[k], np.float32).reshape(
                    -1, 2), np.float32, dev)
        if "epi" in rows:
            trows["epi"] = _on(np.asarray(rows["epi"]).reshape(-1),
                               np.int32, dev)
        if self.cfg.sharding == "lp_device":
            from repro_torch.parallel import lp_shard
            self.state, adm = lp_shard.arrive_sharded(
                self.state, self.cfg, _on(ids, np.int32, dev), trows)
            adm = adm.cpu().numpy()
            if not adm.all():
                refused = [i for i, ok in zip(ids, adm) if not ok]
                self._free.extend(reversed(refused))
                admitted = [i for i, ok in zip(ids, adm) if ok]
                self._live.update(admitted)
                raise RuntimeError(
                    f"arrive: {len(refused)} of {b} arrivals refused: "
                    "their destination devices have no free slot; raise "
                    "EngineConfig.shard_capacity (admitted: "
                    f"{len(admitted)} rows, already applied)")
        else:
            self.state = _eng.oracle_arrive(self.state,
                                            _on(ids, np.int64, dev), trows)
        self._live.update(ids)
        if self.telemetry is not None:
            self.telemetry.emit("arrive", self._steps, count=b,
                                population=len(self._live))
        return ids

    def depart(self, ids) -> None:
        """Remove the SEs `ids` (an O(batch) update on the device). Their
        slots return to the free pool. Raises KeyError, state untouched,
        if any id is not live (or is given twice)."""
        self._require_open("depart")
        ids = [int(i) for i in ids]
        if not ids:
            return
        missing = [i for i in ids if i not in self._live]
        if missing or len(set(ids)) != len(ids):
            raise KeyError(
                f"depart: not live (or duplicated in batch): "
                f"{sorted(set(missing or ids))[:8]}")
        if self.cfg.sharding == "lp_device":
            from repro_torch.parallel import lp_shard
            self.state, found = lp_shard.depart_sharded(
                self.state, self.cfg, _on(ids, np.int32, self.device))
            if not bool(found.all()):
                raise RuntimeError(
                    "depart: live-set bookkeeping and device state "
                    "disagree: some ids were not found in any slot")
        else:
            self.state = _eng.oracle_depart(
                self.state, _on(ids, np.int64, self.device))
        self._live.difference_update(ids)
        self._free.extend(reversed(ids))
        if self.telemetry is not None:
            self.telemetry.emit("depart", self._steps, count=len(ids),
                                population=len(self._live))

    # -- device-state queries -------------------------------------------

    def _universe(self):
        """(pos, lp, ext, valid) of the slot universe (ext is the slot's
        SE id): id order for the oracle, slot-major for the sharded
        layer (ext = gid, every shard's slots). Queries never
        unshard."""
        st = self.state
        if self.cfg.sharding == "lp_device":
            from repro_torch.parallel import lp_shard
            pos, lp, gid = lp_shard.slot_universe(st, self.cfg)
            return pos, lp, gid.long(), gid >= 0
        n = self.cfg.abm.n_se
        ext = torch.arange(n, dtype=torch.int64, device=self.device)
        return st["pos"], st["lp"], ext, st["lp"] >= 0

    def query_neighbors(self, ids) -> dict:
        """{id: sorted list of live SE ids within interaction_range},
        from the state on its device through the CSR cell list (a dense
        sweep when the world is too small to tessellate). Raises
        KeyError for ids that are not live."""
        self._single("query_neighbors")
        ids = [int(i) for i in ids]
        missing = [i for i in ids if i not in self._live]
        if missing:
            raise KeyError(f"query_neighbors: not live: {missing[:8]}")
        if not ids:
            return {}
        abm = self.cfg.abm
        pos, lp, ext, valid = self._universe()
        q = _on(ids, np.int64, self.device)
        # each queried SE's slot (its id, for the oracle)
        rows = q if self.cfg.sharding == "none" else \
            (ext[None, :] == q[:, None]).int().argmax(1)
        qpos = pos[rows]
        spec = abm.grid_spec() if abm.proximity_backend in (
            "grid", "pallas_grid") else None
        if spec is not None:
            grid = neighbors.build_grid(pos, spec, valid=valid)
            cols = neighbors.rows_grid_neighbor_ids(
                pos, abm.area, abm.interaction_range, spec, grid, qpos,
                rows)
        else:
            d2 = neighbors.toroidal_d2(qpos[:, None, :], pos[None, :, :],
                                       abm.area, fused=False)
            rng = abm.interaction_range
            j = torch.arange(pos.shape[0], device=self.device)
            ok = valid[None, :] & (d2 <= f32(rng * rng)) \
                & (j[None, :] != rows[:, None])
            cols = torch.where(ok, j[None, :], -1)
        nbr = torch.where(cols >= 0, ext[cols.clamp(min=0)], -1)
        nbr = nbr.cpu().numpy()
        return {i: sorted(int(x) for x in row if x >= 0)
                for i, row in zip(ids, nbr)}

    def query_lcr(self) -> float:
        """Instantaneous LCR of the current placement: the fraction of
        interactions that would be LP-local if every live SE sent now
        (the proximity kernel with every live SE a sender), as a float32
        division."""
        self._single("query_lcr")
        abm = self.cfg.abm
        pos, lp, ext, valid = self._universe()
        counts, _ = interaction_counts_overflow(pos, lp, valid, abm,
                                                valid=valid)
        _, local, total = _eng.lp_flows(lp.clamp(0, abm.n_lp - 1), counts,
                                        abm.n_lp)
        local, total = torch.stack([local, total]).tolist()
        return float(np.float32(local) / np.float32(max(total, 1)))

    def query_region(self, bbox) -> list:
        """Sorted live SE ids with position inside `bbox` = (x0, y0,
        x1, y1), inclusive and wrap-aware per axis (x0 > x1 selects the
        interval wrapping through the torus seam)."""
        self._single("query_region")
        x0, y0, x1, y1 = (f32(v) for v in bbox)
        pos, lp, ext, valid = self._universe()

        def axis(v, lo, hi):
            if lo <= hi:
                return (v >= lo) & (v <= hi)
            return (v >= lo) | (v <= hi)

        hit = valid & axis(pos[:, 0], x0, x1) & axis(pos[:, 1], y0, y1)
        return sorted(ext[hit].cpu().tolist())


class ReplicaService:
    """Continuous batching of independent simulation requests over the
    replica axis.

    R resident slots share one batched step; `submit` enqueues (seed,
    steps, mf) requests and `drain` advances every slot together in
    windows sized to the nearest request boundary, refilling each
    finished slot from the queue at t = 0 while the others keep their
    state and their own step (the batch's `t` is then a tuple, see
    `engine.clock`). A request's integer counters are its solo run's:
    the batched step is bit for bit each replica's solo step, and
    window merging keeps the counter sums (`stats.merge_counters`); its
    `mean_*` values are window-weighted means of the windows' means,
    which agree with the solo run's to rounding. Idle slots (queue
    exhausted) ride along without repartitioning.
    """

    def __init__(self, cfg: EngineConfig, n_slots: int, device=None):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.cfg = cfg
        self.n_slots = n_slots
        self.device = resolve_device(device)
        self._queue = []  # pending (rid, seed, steps, mf)
        self._next_rid = 0
        self.results = {}

    def submit(self, seed: int, steps: int, mf=None) -> int:
        """Enqueue a request; returns its request id (the `results`
        key after `drain`)."""
        if steps < 1:
            raise ValueError("steps must be >= 1")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, int(seed), int(steps), mf))
        return rid

    def prometheus(self) -> str:
        """Prometheus text exposition of the service: queue depth, slot
        count, completed-request count, and the mean LCR / migrations
        over completed requests (request-level aggregates only)."""
        lines = []

        def gauge(name, value):
            name = f"gaia_service_{name}"
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {value:g}")

        gauge("slots", self.n_slots)
        gauge("queue_depth", len(self._queue))
        gauge("requests_completed", len(self.results))
        done = list(self.results.values())
        if done:
            gauge("mean_lcr", sum(c["mean_lcr"] for c in done) / len(done))
            gauge("mean_migrations",
                  sum(c["migrations"] for c in done) / len(done))
        return "\n".join(lines) + "\n"

    @staticmethod
    def _set_replica(states, r: int, sub):
        """Replica r of a stacked state overwritten by a single-replica
        state: row r of every leaf (the (R, 2) key words included), and
        replica r's step."""
        out = {}
        for k, v in states.items():
            if k == "t":
                ts = list(v) if isinstance(v, tuple) else \
                    [v] * states["key"].shape[0]
                ts[r] = sub["t"]
                out[k] = _eng.clock(ts)
            else:
                out[k] = v.clone()
                out[k][r] = sub[k]
        return out

    def drain(self) -> dict:
        """Run every queued request to completion; returns {rid:
        counters} (also kept in `self.results`). Idle slots (queue
        exhausted) ride along and are discarded."""
        if not self._queue:
            return self.results
        R = self.n_slots
        slot = [None] * R  # per-slot [rid, remaining, mf, parts, weights]
        states = None

        def refill(states, r):
            rid, seed, steps, mf = self._queue.pop(0)
            sub = _eng._init_engine(trandom.key(seed), self.cfg,
                                    self.device)
            if states is None:
                states = _eng.stack_states([sub] * R)
            else:
                states = self._set_replica(states, r, sub)
            slot[r] = [rid, steps, mf, [], []]
            return states

        for r in range(R):
            if self._queue:
                states = refill(states, r)
        while any(s is not None for s in slot):
            chunk = min(s[1] for s in slot if s is not None)
            mfs = [float(s[2] if s is not None and s[2] is not None
                         else self.cfg.heuristic.mf) for s in slot]
            states, counters = _eng._run_window_batch(
                states, self.cfg, chunk, mf=mfs,
                active=tuple(s is not None for s in slot))
            for r in range(R):
                if slot[r] is None:
                    continue
                slot[r][3].append(counters[r])
                slot[r][4].append(chunk)
                slot[r][1] -= chunk
                if slot[r][1] == 0:
                    rid, _, _, parts, weights = slot[r]
                    c = merge_counters(parts, weights)
                    c["migration_ratio"] = c["migrations"] / (
                        self.cfg.abm.n_se * (sum(weights) / 1000.0))
                    self.results[rid] = c
                    slot[r] = None
                    if self._queue:
                        states = refill(states, r)
        return self.results
