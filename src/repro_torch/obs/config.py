"""Telemetry configuration.

``ObsConfig`` rides on :class:`repro.core.engine.EngineConfig` as the
``obs`` field. It must stay a frozen (hashable) dataclass: the compiled
window/scan executables are memoized on the whole ``EngineConfig``, and
an *enabled* telemetry config legitimately changes the traced program
(the ring-buffer write + drain callback are real ops), so it has to be
part of the cache key. A *disabled* config, by contrast, is normalized
to the default ``ObsConfig()`` inside ``window_key_cfg`` so every
telemetry-off variant shares one cache entry — that identity is the
"zero-op-when-off" invariant and is asserted by tests/test_obs.py.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Runtime telemetry knobs (ledger + event log + trace).

    enabled      master switch; False means the compiled step/scan is
                 bit-for-bit the untelemetered program (no extra ops)
    drain_every  ring-buffer depth in steps: the on-device ledger ring
                 holds ``drain_every`` rows and is flushed to host via
                 one async ``jax.debug.callback`` per ``drain_every``
                 steps (never per step), so the jitted scan stays whole
    events       synthesize structured events (migration_burst /
                 repartition / overflow alarms) host-side from drained
                 ledger rows; direct emissions (arrive/depart batches,
                 tuner moves) are host events and ignore this flag
    mig_burst    migrations-per-step threshold at or above which a
                 ``migration_burst`` event is emitted
    history      host-side ledger capacity in rows (oldest dropped) so
                 a resident engine's telemetry memory stays bounded
    """

    enabled: bool = False
    drain_every: int = 10
    events: bool = True
    mig_burst: int = 1
    history: int = 65536

    def __post_init__(self):
        if self.drain_every < 1:
            raise ValueError(
                f"obs.drain_every must be >= 1, got {self.drain_every}")
        if self.mig_burst < 1:
            raise ValueError(
                f"obs.mig_burst must be >= 1, got {self.mig_burst}")
        if self.history < 1:
            raise ValueError(
                f"obs.history must be >= 1, got {self.history}")
