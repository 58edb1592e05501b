"""Runtime telemetry for the GAIA engine (the port of `repro.obs`).

Three pillars, all off by default (`ObsConfig.enabled = False`: the
window runner then dispatches exactly the ops of a config that never
heard of telemetry; on, it never perturbs a PRNG stream or a result):

* **metrics ledger** (`ledger`): a fixed-shape (drain_every, K) float32
  ring of per-step counters on the state's device, copied to pinned
  host buffers without blocking every `drain_every` steps and filed
  once each copy is done (`runtime`); the step loop never waits on it;
* **event log** (`events`): typed, step-stamped records (migration
  bursts, repartitions, overflow alarms, churn batches, tuner moves)
  through pluggable sinks (memory / JSONL / stdout);
* **trace timelines** (`trace`): Chrome-trace/Perfetto JSON spans of
  the step phases, from a phase-by-phase trace executor.

`core.service.Engine.ledger()/events()/prometheus()` is the serving
surface; `trace_run` the profiling one.
"""
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.events import (EVENT_KINDS, Event, EventLog, JsonlSink,
                                    MemorySink, StdoutSink)
from repro_torch.obs.ledger import MetricsLedger, Telemetry, ledger_keys
from repro_torch.obs.prom import prometheus_text
from repro_torch.obs import runtime
from repro_torch.obs.trace import TraceRecorder, trace_run, trace_steps

__all__ = [
    "ObsConfig", "EVENT_KINDS", "Event", "EventLog", "JsonlSink",
    "MemorySink", "StdoutSink", "MetricsLedger", "Telemetry",
    "ledger_keys", "prometheus_text", "runtime", "TraceRecorder",
    "trace_run", "trace_steps",
]
