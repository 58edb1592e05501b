"""Self-tuning adaptive partitioning (paper §5.5), the port of
`repro.core.selftune`.

The paper leaves MF tuning to an offline sweep and sketches two
mechanisms, both built here on the cost model, on the property the
paper calls out: the gain-vs-MF curve is monotone up to a tipping point
(Figs. 8-9), so 1-D hill descent converges.

Intra-run: the run is split into windows of `window` timesteps; after
each window the controller prices the window with Eq. 5/6 (per-timestep
TEC) and moves MF multiplicatively — if the last move made the window
more expensive, it reverses direction and halves the step. MF changes
between windows only.

Inter-run: golden-section-style bracketing on full-run TEC across
replicas (different seeds), on the same monotone-then-worse structure.

Batched: `intra_run_tune_batch` runs R independent intra-run tuners in
one batched pass (`engine._run_window_batch`), each replica pricing its
own windows and moving its own MF (an (R,) vector), so replica r's
history is the solo tuner's on seeds[r], bit for bit.

The entry points run on the card unless `device="cpu"` is given. The
intra-run tuner reports each MF change as a `tuner_move` event to the
current telemetry session, if any (`repro_torch.obs.runtime`); the
batched tuner, as the reference's, reports none.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch import random as trandom
from repro_torch.core.costmodel import CostParams, SETUPS, wct, wct_env
from repro_torch.core.engine import (EngineConfig, _init_batch, _init_engine,
                                     _run_window, _run_window_batch)
from repro_torch.core.service import resolve_device
from repro_torch.obs import runtime as obs_runtime


@dataclasses.dataclass(frozen=True)
class SelfTuneConfig:
    window: int = 100  # timesteps per observation interval
    mf0: float = 4.0  # initial Migration Factor
    step0: float = 0.5  # initial multiplicative step (mf *= 1 +/- step)
    min_mf: float = 1.05
    max_mf: float = 19.0
    setup: str = "distributed"  # cost-model pricing of a window
    interaction_bytes: int = 1024
    migration_bytes: int = 32


def _price(counters, p: CostParams, cfg: EngineConfig, n_steps: int,
           tc: SelfTuneConfig) -> float:
    """Window/probe TEC on the objective the run executes on: `wct_env`
    on the per-pair flows when an ExecutionEnvironment is set, the
    homogeneous scalar model otherwise."""
    if cfg.env is not None:
        return wct_env(counters, p, cfg.env, n_steps,
                       interaction_bytes=tc.interaction_bytes,
                       migration_bytes=tc.migration_bytes)["TEC"]
    return wct(counters, p, cfg.abm.n_lp, n_steps,
               interaction_bytes=tc.interaction_bytes,
               migration_bytes=tc.migration_bytes)["TEC"]


class _Descent:
    """One tuner's hill descent on MF, window by window."""

    def __init__(self, tc: SelfTuneConfig):
        self.tc, self.mf, self.step = tc, tc.mf0, tc.step0
        self.direction = -1.0  # start by migrating more aggressively
        self.prev: Optional[float] = None
        self.history: List[Tuple[int, float, float, float]] = []

    def observe(self, w: int, counters, params, cfg: EngineConfig):
        tc = self.tc
        tec = _price(counters, params, cfg, tc.window, tc) / tc.window
        self.history.append((w, self.mf, counters["mean_lcr"], tec))
        if self.prev is not None and tec > self.prev * 1.001:
            self.direction = -self.direction  # worse: back off
            self.step = max(self.step * 0.5, 0.02)
        self.prev = tec
        self.mf = float(min(max(self.mf * (1.0 + self.direction * self.step),
                                tc.min_mf), tc.max_mf))


def intra_run_tune(key, cfg: EngineConfig, tc: SelfTuneConfig,
                   total_steps: Optional[int] = None, device=None):
    """Run `cfg` from `key` (`random.key(seed)`) with MF hill-descended
    every `window` steps. Returns (final_state, history), history rows
    (window_index, mf, window_lcr, window_tec_per_step); a sharded run's
    state is unsharded to id order, as `engine._run` returns it."""
    total = total_steps or cfg.timesteps
    params = SETUPS[tc.setup]
    state = _init_engine(key, cfg, resolve_device(device))
    tuner = _Descent(tc)
    for w in range(total // tc.window):
        state, counters = _run_window(state, cfg, tc.window, mf=tuner.mf)
        prev_mf = tuner.mf
        tuner.observe(w, counters, params, cfg)
        if tuner.mf != prev_mf:
            # the tuner's decision, stamped with the first step the new
            # MF governs
            obs_runtime.emit_event("tuner_move", (w + 1) * tc.window,
                                   mf=tuner.mf, prev_mf=prev_mf, window=w,
                                   tec_per_step=tuner.history[-1][3])
    if cfg.sharding == "lp_device":  # the oracle's id-order layout
        from repro_torch.parallel import lp_shard
        spec, mesh = lp_shard.layout(cfg)
        state = lp_shard.unshard_state(state, spec, mesh)
    return state, tuner.history


def intra_run_tune_batch(cfg: EngineConfig, tc: SelfTuneConfig, seeds,
                         total_steps: Optional[int] = None, device=None):
    """R independent intra-run tuners in one batched pass: the
    per-replica MF vector rides each window, so replica r reproduces a
    solo `intra_run_tune(random.key(seeds[r]), cfg, tc)`. Returns
    (final_states, histories), one solo-format history per replica."""
    total = total_steps or cfg.timesteps
    params = SETUPS[tc.setup]
    states = _init_batch(cfg, list(seeds), resolve_device(device))
    tuners = [_Descent(tc) for _ in seeds]
    for w in range(total // tc.window):
        states, reps = _run_window_batch(states, cfg, tc.window,
                                         mf=[t.mf for t in tuners])
        for tuner, counters in zip(tuners, reps):
            tuner.observe(w, counters, params, cfg)
    if cfg.sharding == "lp_device":
        from repro_torch.parallel import lp_shard
        spec, mesh = lp_shard.layout(cfg)
        states = lp_shard.unshard_batch(states, spec, mesh)
    return states, [t.history for t in tuners]


def inter_run_tune(key, cfg: EngineConfig, tc: SelfTuneConfig,
                   n_probes: int = 6, device=None):
    """Pick MF from full independent replicas: a golden-section bracket
    on [min_mf, max_mf] in log space, each probe one full run (from
    `fold_in(key, i)`) priced by the cost model. Returns
    (best_mf, [(mf, tec), ...])."""
    dev = resolve_device(device)
    params = SETUPS[tc.setup]
    lo, hi = math.log(tc.min_mf), math.log(tc.max_mf)
    gr = (math.sqrt(5) - 1) / 2
    trials = []

    def probe(log_mf, i):
        mf = math.exp(log_mf)
        state = _init_engine(trandom.fold_in(key, i), cfg, dev)
        _, counters = _run_window(state, cfg, cfg.timesteps, mf=mf)
        tec = _price(counters, params, cfg, cfg.timesteps, tc)
        trials.append((mf, tec))
        return tec

    a, b = lo, hi
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = probe(c, 0), probe(d, 1)
    for i in range(2, n_probes):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = probe(c, i)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = probe(d, i)
    best = min(trials, key=lambda t: t[1])
    return best[0], trials
