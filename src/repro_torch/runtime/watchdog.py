"""Straggler & hang detection for the training loop.

At multi-pod scale the common failure modes are (a) a host that dies
(step never completes) and (b) a straggler that silently stretches every
step. The watchdog tracks an EMA of step wall-time; a step exceeding
``hang_factor x EMA`` trips the hang callback (checkpoint-and-restart in
the trainer), and per-step times above ``straggler_factor x EMA`` are
logged/counted so the scheduler layer can evict the slow host on the
next elastic reshape. On real clusters the per-HOST timings come from
the coordinator's heartbeat service; here the same logic is driven by
the single-process step clock and unit-tested with injected delays.
A copy of the reference's `repro.runtime.watchdog`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class Watchdog:
    ema_alpha: float = 0.2
    straggler_factor: float = 2.0
    hang_factor: float = 5.0
    min_samples: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    ema: float = 0.0
    n: int = 0
    stragglers: int = 0

    def observe(self, step: int, dt: float) -> str:
        """Feed one step duration. Returns 'ok' | 'straggler' | 'hang'."""
        if self.n < self.min_samples:
            self.ema = dt if self.n == 0 else (
                self.ema_alpha * dt + (1 - self.ema_alpha) * self.ema)
            self.n += 1
            return "ok"
        verdict = "ok"
        if dt > self.hang_factor * self.ema:
            verdict = "hang"
        elif dt > self.straggler_factor * self.ema:
            verdict = "straggler"
            self.stragglers += 1
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
        # stragglers pollute the EMA less (clamped update)
        self.ema = (self.ema_alpha * min(dt, 2 * self.ema)
                    + (1 - self.ema_alpha) * self.ema)
        self.n += 1
        return verdict

    def deadline(self) -> float:
        """Suggested per-step deadline (for async collectives timeouts)."""
        return self.hang_factor * self.ema if self.n >= self.min_samples \
            else float("inf")
