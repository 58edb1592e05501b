"""Structured event log: typed, step-stamped records through pluggable
sinks (the port's copy of `repro.obs.events`).

Two sources feed it:

* **synthesized**: ``repro_torch.obs.ledger.Telemetry`` scans every
  drained ledger block on the host and emits ``migration_burst`` /
  ``repartition`` / ``grid_overflow`` / ``shard_overflow`` records
  (threshold rules in ObsConfig); they carry exact step stamps, because
  the stamps travel in the ledger rows, although the host hears from
  the device only every ``drain_every`` steps;
* **direct**: host-side actors call ``EventLog.emit`` themselves:
  ``Engine.arrive`` / ``Engine.depart`` (churn batches) and the MF
  self-tuner (``tuner_move``).

Sinks are tiny: anything with an ``emit(event)`` method works.
``MemorySink`` backs ``Engine.events()``; ``JsonlSink`` writes one JSON
object per line; ``StdoutSink`` is for interactive use.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from collections import deque
from typing import Any, IO

#: the closed vocabulary of event kinds, the reference's (tests assert
#: emitted kinds stay inside it; `shard_overflow` comes with the sharded
#: layer)
EVENT_KINDS = (
    "migration_burst",   # per-step migrations >= obs.mig_burst
    "repartition",       # a periodic global repartition moved >= 1 SE
    "grid_overflow",     # oracle proximity capacity clamp tripped
    "shard_overflow",    # sharded halo/migration capacity clamp tripped
    "arrive",            # Engine.arrive admitted a batch
    "depart",            # Engine.depart retired a batch
    "tuner_move",        # MF self-tuner accepted a new MF
)


@dataclasses.dataclass(frozen=True)
class Event:
    """One telemetry event: a kind from EVENT_KINDS, the absolute engine
    step it describes (not the step the host heard about it), and a
    flat JSON-able payload."""

    step: int
    kind: str
    data: dict[str, Any]

    def as_dict(self) -> dict[str, Any]:
        return {"step": self.step, "kind": self.kind, **self.data}


class MemorySink:
    """Bounded in-memory sink; backs ``Engine.events()``."""

    def __init__(self, capacity: int = 65536):
        self.records: deque[Event] = deque(maxlen=capacity)

    def emit(self, event: Event) -> None:
        self.records.append(event)

    def __len__(self) -> int:
        return len(self.records)


class JsonlSink:
    """Append events as JSON Lines to a path or an open file object."""

    def __init__(self, path_or_file: str | IO[str]):
        if isinstance(path_or_file, str):
            self._fh = open(path_or_file, "a", encoding="utf-8")
            self._owns = True
        else:
            self._fh = path_or_file
            self._owns = False

    def emit(self, event: Event) -> None:
        json.dump(event.as_dict(), self._fh, separators=(",", ":"))
        self._fh.write("\n")

    def close(self) -> None:
        self._fh.flush()
        if self._owns:
            self._fh.close()


class StdoutSink:
    def emit(self, event: Event) -> None:
        json.dump(event.as_dict(), sys.stdout, separators=(",", ":"))
        sys.stdout.write("\n")


class EventLog:
    """Fans events out to every attached sink.

    Always carries a MemorySink (so ``Engine.events()`` works without
    configuration); extra sinks are user-supplied. Unknown kinds raise:
    the vocabulary is closed on purpose so downstream consumers can
    switch on ``kind`` exhaustively.
    """

    def __init__(self, sinks=None, capacity: int = 65536):
        self.memory = MemorySink(capacity)
        self.sinks = [self.memory] + list(sinks or [])

    def emit(self, kind: str, step: int, **data: Any) -> Event:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r} "
                             f"(known: {EVENT_KINDS})")
        ev = Event(step=int(step), kind=kind, data=data)
        for sink in self.sinks:
            sink.emit(ev)
        return ev

    def records(self, kind: str | None = None) -> list[Event]:
        evs = list(self.memory.records)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs

    def close(self) -> None:
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()
