"""Step-phase trace timelines: Chrome-trace / Perfetto JSON export (the
port of `repro.obs.trace`).

The trace executor runs a window phase by phase: each phase of
`engine.step_phases` (or, sharded, `parallel.lp_shard.sharded_phases`)
is called in turn and timed on the host around a
`torch.cuda.synchronize()` (the device runs asynchronously; on the CPU
the phase is done when it returns). The recorder emits one complete
span ("ph": "X") per (device, phase, step) in the Chrome trace-event
format, which chrome://tracing and https://ui.perfetto.dev open.

The port's step is these very phases run in turn (`engine.step`), so a
traced run is bit for bit the untraced one; its spans include the
synchronise after each phase, which the untraced loop never makes. A
sharded run has one timeline row a shard: each span is replicated onto
every row, with the shard's own counters of that point of the step
(`n_valid`, `halo_n`) in its args.

This module imports the engine lazily (function-local): the engine
imports `repro_torch.obs` submodules.
"""
from __future__ import annotations

import json
import time
from typing import Optional

import torch


class TraceRecorder:
    """Collects Chrome trace events; one timeline row (tid) per device.

    `ts`/`dur` are microseconds relative to the recorder's creation, the
    trace-event format's native unit.
    """

    def __init__(self, n_dev: int = 1, process_name: str = "gaia-engine"):
        self.n_dev = n_dev
        self.events: list[dict] = []
        self._t0 = time.perf_counter()
        self.events.append({"ph": "M", "pid": 0, "tid": 0,
                            "name": "process_name",
                            "args": {"name": process_name}})
        for d in range(n_dev):
            self.events.append({"ph": "M", "pid": 0, "tid": d,
                                "name": "thread_name",
                                "args": {"name": f"device {d}"}})

    def add_span(self, name: str, step: int, t_start: float, t_end: float,
                 dev_args: Optional[list] = None) -> None:
        """One phase span, replicated onto every device row (per-device
        data rides in `dev_args`, one dict per device)."""
        ts = (t_start - self._t0) * 1e6
        dur = (t_end - t_start) * 1e6
        for d in range(self.n_dev):
            args = {"step": step}
            if dev_args is not None:
                args.update(dev_args[d])
            self.events.append({"ph": "X", "cat": "step", "name": name,
                                "pid": 0, "tid": d, "ts": ts, "dur": dur,
                                "args": args})

    def as_dict(self) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.as_dict(), fh)
        return path

    def phase_summary(self) -> dict:
        """Per-phase wall-time stats over the recorded steps (seconds):
        {phase: {"mean": s, "total": s, "n": spans}}, from device 0's
        row (spans are replicated across device rows)."""
        acc: dict[str, list[float]] = {}
        for ev in self.events:
            if ev.get("ph") == "X" and ev["tid"] == 0:
                acc.setdefault(ev["name"], []).append(ev["dur"] / 1e6)
        return {k: {"mean": sum(v) / len(v), "total": sum(v), "n": len(v)}
                for k, v in acc.items()}


def _dev_args(px, n_dev: int) -> list:
    """Per-shard span payload: the per-shard counters the phase context
    holds at this point of the step (read off the device)."""
    out = [dict() for _ in range(n_dev)]
    for key in ("n_valid", "halo_n"):
        if key in px:
            for d, v in enumerate(px[key].reshape(-1).tolist()):
                out[d][key] = int(v)
    return out


def trace_steps(state, cfg, n_steps: int, recorder: TraceRecorder,
                mf=None, warmup: int = 2):
    """Advance `state` by `warmup + n_steps` steps phase by phase,
    recording one span per (device, phase, step) for the last `n_steps`
    (the warm-up steps absorb first-call costs: kernel loads, allocator
    growth). Returns the advanced state, bit for bit what
    `engine._run_steps` returns. A sharded state (one replica) records
    one row a shard, with per-shard args."""
    from repro_torch.core.engine import step_phases
    sharded = cfg.sharding == "lp_device"
    if sharded:
        from repro_torch.parallel import lp_shard
        phases = lp_shard.sharded_phases(cfg)
    else:
        phases = step_phases(cfg)
    mf = cfg.heuristic.mf if mf is None else float(mf)
    dev = state["lp"].device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    sync()
    for i in range(warmup + n_steps):
        record = i >= warmup
        px = {"st": state, "mf": mf, "active": None}
        step_no = state["t"]
        for name, fn in phases:
            t0 = time.perf_counter()
            px = fn(px)
            sync()
            if record:
                recorder.add_span(name, step_no, t0, time.perf_counter(),
                                  dev_args=_dev_args(px, recorder.n_dev)
                                  if sharded else None)
        state = px["new_state"]
    return state


def trace_run(cfg, seed: int = 0, n_steps: Optional[int] = None,
              warmup: int = 2, device=None):
    """Initialize an engine state for `cfg` from `seed` on `device` (the
    card unless "cpu" is asked for), trace `n_steps` (default
    cfg.timesteps) phase by phase, and return the populated
    :class:`TraceRecorder`."""
    from repro_torch import random as trandom
    from repro_torch.core.engine import _init_engine
    from repro_torch.core.service import resolve_device

    if n_steps is None:
        n_steps = cfg.timesteps
    state = _init_engine(trandom.key(seed), cfg, resolve_device(device))
    n_dev = 1
    if cfg.sharding == "lp_device":
        from repro_torch.parallel import lp_shard
        n_dev = lp_shard.layout(cfg)[1].local
    recorder = TraceRecorder(n_dev=n_dev)
    trace_steps(state, cfg, n_steps, recorder, warmup=warmup)
    return recorder
