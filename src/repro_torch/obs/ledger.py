"""Per-step metrics ledger: device ring -> host accumulator (the port of
`repro.obs.ledger`).

Device side (`core.engine._run_steps`, when ``cfg.obs.enabled``): every
step writes one fixed-shape float32 row (the counters the step already
computes: LCR, messages, migrations, evaluations, repartitions, the
grid overflow, the open world's population, then the per-LP slot load)
into slot ``t % drain_every`` of a ``(drain_every, K)`` ring on the
state's device. When the ring wraps (``(t + 1) % drain_every == 0``) it
is copied to the host without blocking (`obs.runtime.drain`). Windows
whose length is not a multiple of ``drain_every`` leave a partial ring,
which the window runner flushes at its end (`obs.runtime.flush_tail`).
The step is a host loop that never waits on the card, so `t` is a host
int: the slot and the wrap test cost the device nothing, and the ring
never feeds back into the step or draws from a PRNG stream.

Host side: :class:`Telemetry` owns the :class:`MetricsLedger` (bounded
row history and O(1) streaming summaries) and the
:class:`~repro_torch.obs.events.EventLog`, and synthesizes threshold
events (migration bursts, repartitions, overflow alarms) from each
drained block, with exact step stamps, because the stamps travel in the
rows.

This module imports nothing of `repro_torch.core.engine` (the engine
imports it); it takes the engine config duck-typed.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.stats import StreamingStats
from repro_torch.obs import runtime
from repro_torch.obs.events import EventLog

#: scalar step metrics every execution layer reports, in ledger column
#: order (after the leading "step" stamp column)
_BASE_KEYS = ("lcr", "local_msgs", "remote_msgs", "migrations",
              "heu_evals", "repartitions")


def ledger_keys(cfg) -> tuple[str, ...]:
    """Ordered column names of one ledger row for this engine config.

    Layout: step stamp, the layer-shared scalar counters, the layer's
    overflow/wire extras, the open-world population, then the per-LP
    slot load (``lp_load_i``: live SEs hosted by LP i). The tuple is
    static per config, so the device row and every host consumer agree
    by construction."""
    keys = ["step", *_BASE_KEYS]
    if cfg.sharding == "lp_device":
        keys += ["halo_frac", "bytes_on_wire", "shard_overflow"]
    else:
        keys += ["grid_overflow"]
    if cfg.open_world:
        keys += ["pop"]
    keys += [f"lp_load_{i}" for i in range(cfg.abm.n_lp)]
    return tuple(keys)


def ledger_row(cfg, state, metrics, t):
    """The (K,) float32 row of step `t` (a host int) from the post-step
    state and the step's metrics, on the state's device, without a host
    sync: the stamp is filled from the scalar (no host-to-device copy),
    the counters are the step's own, and the per-LP load is a
    compare-and-sum over a fixed (slots, L) mask (a free slot, oracle
    lp < 0 or sharded gid < 0, matches no LP; `torch.bincount` on the
    card would read its input's maximum back to the host)."""
    lp = state["lp"]
    if "gid" in state:  # sharded: every local shard's slots
        lp = torch.where(state["gid"] < 0, -1, lp)
    lps = torch.arange(cfg.abm.n_lp, dtype=lp.dtype, device=lp.device)
    load = (lp.reshape(-1, 1) == lps).sum(0, dtype=torch.float32)
    cols = [torch.full((), t, dtype=torch.float32, device=lp.device)]
    for k in ledger_keys(cfg)[1:]:
        if k.startswith("lp_load_"):
            break
        cols.append(metrics[k].to(torch.float32))
    return torch.cat([torch.stack(cols), load])


def new_ring(cfg, device):
    """A window's (drain_every, K) float32 ring, every slot stamped -1:
    slots a short window never writes carry an impossible step stamp,
    which the host's stamp-match filter drops
    (`Telemetry._ingest_stamped`)."""
    return torch.full((cfg.obs.drain_every, len(ledger_keys(cfg))), -1.0,
                      dtype=torch.float32, device=device)


def write_row(ring, cfg, state, metrics, t: int) -> None:
    """Write step `t`'s row into its slot and, when the ring wraps, start
    its drain to the current session."""
    de = cfg.obs.drain_every
    ring[t % de] = ledger_row(cfg, state, metrics, t)
    if (t + 1) % de == 0:
        runtime.drain(ring, t)


class MetricsLedger:
    """Host accumulator for drained ledger rows.

    Keeps a bounded row history (the ``capacity`` newest rows: a
    resident engine can run forever) and unbounded O(1) streaming
    summaries per column (`repro_torch.core.stats.StreamingStats`), so
    `summary()` covers the whole run after old rows age out. Each row
    carries its own step stamp in column 0 (blocks file in step
    order)."""

    def __init__(self, keys: tuple[str, ...], capacity: int = 65536):
        self.keys = tuple(keys)
        self._idx = {k: i for i, k in enumerate(self.keys)}
        self._rows: deque[np.ndarray] = deque(maxlen=capacity)
        self._streams = {k: StreamingStats() for k in self.keys
                         if k != "step"}
        self.n_total = 0
        self.last_drain_s: float | None = None

    def append_block(self, block: np.ndarray) -> None:
        """Ingest a (B, K) block of rows (B >= 1)."""
        block = np.asarray(block, np.float64)
        if block.ndim != 2 or block.shape[1] != len(self.keys):
            raise ValueError(f"ledger block shape {block.shape} does not "
                             f"match {len(self.keys)} columns")
        for row in block:
            self._rows.append(row)
            for k, s in self._streams.items():
                s.add(row[self._idx[k]])
        self.n_total += len(block)
        self.last_drain_s = time.time()

    def __len__(self) -> int:
        return len(self._rows)

    def rows(self) -> np.ndarray:
        """(T, K) array of the retained row history (oldest first)."""
        if not self._rows:
            return np.zeros((0, len(self.keys)), np.float64)
        return np.stack(self._rows)

    def column(self, key: str) -> np.ndarray:
        return self.rows()[:, self._idx[key]]

    def as_dict(self) -> dict[str, np.ndarray]:
        rows = self.rows()
        return {k: rows[:, i] for i, k in enumerate(self.keys)}

    def latest(self) -> dict[str, float]:
        """The newest row as {column: value} ({} while empty)."""
        if not self._rows:
            return {}
        row = self._rows[-1]
        return {k: float(row[i]) for i, k in enumerate(self.keys)}

    def summary(self) -> dict[str, dict[str, float]]:
        """Whole-run mean/std/ci95/n per column (streaming: not limited
        to the retained history)."""
        return {k: s.as_dict() for k, s in self._streams.items()
                if s.n > 0}


class Telemetry:
    """One engine's telemetry session: ledger + event log + thresholds.

    Receives drained device blocks (`repro_torch.obs.runtime` routes the
    window runner's drains to whichever session is current, and copies
    them through the session's `drain`), files the rows, and synthesizes
    threshold events. Host-side actors (`Engine.arrive`/`depart`, the MF
    tuner) emit directly through :meth:`emit`."""

    def __init__(self, cfg, sinks=None):
        self.cfg = cfg
        self.keys = ledger_keys(cfg)
        self._idx = {k: i for i, k in enumerate(self.keys)}
        self.ledger = MetricsLedger(self.keys, capacity=cfg.obs.history)
        self.events = EventLog(sinks, capacity=cfg.obs.history)
        self.dropped_blocks = 0  # blocks that arrived with no session
        self.drain = runtime.DeviceDrain(self.on_block)  # copies in flight

    # -- device-side feeds (filed by the session's drain) ------------------
    def on_block(self, ring: np.ndarray, t_last: int) -> None:
        """A full ring flushed at step ``t_last``: slot i holds step
        ``t_last - drain_every + 1 + i`` (flushes happen exactly when
        the ring wraps, so slots are already in step order)."""
        de = self.cfg.obs.drain_every
        self._ingest_stamped(np.asarray(ring),
                             range(int(t_last) - de + 1, int(t_last) + 1))

    def on_tail(self, ring: np.ndarray, t_start: int, t_end: int) -> None:
        """Flush the partial ring a window carried out of its loop:
        steps in ``[max(t_start, t_end - t_end % drain_every), t_end)``
        never hit a wrap flush; their slots are ``t % drain_every``."""
        de = self.cfg.obs.drain_every
        lo = max(int(t_start), int(t_end) - int(t_end) % de)
        steps = range(lo, int(t_end))
        if not steps:
            return
        ring = np.asarray(ring)
        self._ingest_stamped(np.stack([ring[t % de] for t in steps]), steps)

    def _ingest_stamped(self, block: np.ndarray, steps) -> None:
        """File only the rows whose on-device step stamp (column 0)
        matches the step the slot is supposed to hold. The ring
        initializes to -1 and windows need not align to drain_every, so
        a flush can see never-written or previous-window slots — the
        stamp check drops exactly those (a window's first wrap flush
        after a short predecessor window, the tail after a wrap, etc.)
        without any cross-window bookkeeping."""
        keep = [i for i, t in enumerate(steps) if block[i, 0] == t]
        if not keep:
            return
        self._ingest(block[keep] if len(keep) != len(block) else block)

    def _ingest(self, block: np.ndarray) -> None:
        self.ledger.append_block(block)
        if self.cfg.obs.events:
            self._synthesize(block)

    # -- event synthesis ---------------------------------------------------
    def _synthesize(self, block: np.ndarray) -> None:
        ix = self._idx
        burst = self.cfg.obs.mig_burst
        for row in block:
            step = int(row[ix["step"]])
            migs = int(row[ix["migrations"]])
            reparts = int(row[ix["repartitions"]])
            if migs >= burst:
                self.emit("migration_burst", step,
                          migrations=migs, repartitions=reparts)
            if reparts > 0:
                self.emit("repartition", step, moved=reparts)
            if "grid_overflow" in ix and row[ix["grid_overflow"]] > 0:
                self.emit("grid_overflow", step)
            if "shard_overflow" in ix and row[ix["shard_overflow"]] > 0:
                self.emit("shard_overflow", step)

    def emit(self, kind: str, step: int, **data) -> None:
        self.events.emit(kind, step, **data)

    # -- host-facing views -------------------------------------------------
    def summary(self) -> dict[str, dict[str, float]]:
        return self.ledger.summary()

    def close(self) -> None:
        self.events.close()
