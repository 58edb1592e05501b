"""Telemetry configuration (the port of `repro.obs.config`).

``ObsConfig`` rides on :class:`repro_torch.core.engine.EngineConfig` as
the ``obs`` field, a frozen dataclass with the reference's fields,
defaults and checks. A *disabled* config, whatever its other knobs,
leaves the window runner's ops those of the default ``ObsConfig()``
(tests/test_torch_obs.py records both op sequences); an *enabled* one
adds the ring write and its drain, and changes no result.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Runtime telemetry knobs (ledger + event log + trace).

    enabled      master switch; False means the step loop runs exactly
                 the untelemetered ops (no extra ops)
    drain_every  ring depth in steps: the on-device ledger ring holds
                 ``drain_every`` rows and is copied to the host without
                 blocking once per ``drain_every`` steps (never per
                 step)
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
