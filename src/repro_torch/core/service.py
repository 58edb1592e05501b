"""The resident engine facade, the port of `repro.core.service` for one
closed-world replica.

    >>> eng = Engine(cfg).init(seed=0)   # state on the card
    >>> eng.step(200)                    # window counters
    >>> eng.metrics()                    # accumulated run counters
    >>> Engine(cfg, device="cpu").run(seed=0)

The engine runs on the card unless the caller asks for the CPU
(`device="cpu"`); without a visible GPU, `Engine(cfg)` raises rather
than move to the CPU quietly. Replica batches, open-world churn, the
device-state queries, telemetry and `ReplicaService` come with later
slices and raise `NotImplementedError`, naming their ROADMAP.md item.
"""
from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch.core import engine as _eng
from repro_torch.core.engine import LATER, EngineConfig
from repro_torch.core.stats import merge_counters


def resolve_device(device=None) -> torch.device:
    """`device`, or "cuda" when it is None. Raises when CUDA is asked
    for (explicitly or by default) and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the engine runs on the GPU unless "
            "the caller passes device=\"cpu\"")
    return dev


def _later(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet; see {LATER[item]}")


class Engine:
    """Resident facade over the GAIA engine (see module docstring)."""

    def __init__(self, cfg: EngineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = None
        self._parts = []  # per-window counters
        self._weights = []
        self._steps = 0

    # -- lifecycle -------------------------------------------------------

    def init(self, seeds=None, *, seed: int = 0) -> "Engine":
        """Materialize resident device state for one replica from
        `seed`."""
        if seeds is not None:
            _later("Engine.init(seeds=...)", "replicas")
        self.state = _eng._init_engine(trandom.key(seed), self.cfg,
                                       self.device)
        self._parts, self._weights, self._steps = [], [], 0
        return self

    def run(self, seeds=None, *, seed: int = 0):
        """One-shot run of cfg.timesteps steps: returns (final_state,
        per-step series, counters). Does not touch the resident state."""
        if seeds is not None:
            _later("Engine.run(seeds=...)", "replicas")
        return _eng._run(trandom.key(seed), self.cfg, self.device)

    def _require_state(self):
        if self.state is None:
            raise RuntimeError("Engine.init() first — no resident state")

    # -- stepping --------------------------------------------------------

    def step(self, n: int = 1, mf=None):
        """Advance the resident state n timesteps; returns this window's
        counters and accumulates them into `metrics()`. `mf` overrides
        the Migration Factor for the window."""
        self._require_state()
        self.state, counters = _eng._run_window(self.state, self.cfg, n,
                                                mf=mf)
        self._parts.append(counters)
        self._weights.append(n)
        self._steps += n
        return counters

    def metrics(self) -> dict:
        """Counters accumulated over every `step` window so far, plus
        the Eq. 8 migration_ratio over the stepped span."""
        self._require_state()
        if not self._parts:
            return {}
        c = merge_counters(self._parts, self._weights)
        c["migration_ratio"] = c["migrations"] / (
            self.cfg.abm.n_se * (max(self._steps, 1) / 1000.0))
        return c

    # -- later slices ----------------------------------------------------

    def arrive(self, rows):
        _later("Engine.arrive", "service")

    def depart(self, ids):
        _later("Engine.depart", "service")

    def population(self):
        _later("Engine.population", "service")

    def live_ids(self):
        _later("Engine.live_ids", "service")

    def query_neighbors(self, ids):
        _later("Engine.query_neighbors", "service")

    def query_lcr(self):
        _later("Engine.query_lcr", "service")

    def query_region(self, bbox):
        _later("Engine.query_region", "service")

    def ledger(self):
        _later("Engine.ledger", "obs")

    def events(self, kind=None):
        _later("Engine.events", "obs")

    def prometheus(self):
        _later("Engine.prometheus", "obs")


class ReplicaService:
    """Continuous batching over the replica axis: a later slice."""

    def __init__(self, cfg: EngineConfig, n_slots: int):
        _later("ReplicaService", "service")
