"""Prometheus text-format rendering of a telemetry session (the port's
copy of `repro.obs.prom`).

One function, no client library: the exposition format for gauges is
plain text (`# TYPE name gauge` and `name{label="v"} value` lines).
Rendered from the ledger's latest row and streaming summaries, so it is
O(columns) whatever the run's length.
"""
from __future__ import annotations

_PREFIX = "gaia"


def _san(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def prometheus_text(tele, extra: dict | None = None) -> str:
    """Render a :class:`~repro_torch.obs.ledger.Telemetry` session as
    Prometheus text exposition. Emits, per ledger column, the latest
    per-step value (`gaia_<col>`) and the whole-run mean
    (`gaia_<col>_mean`); per-LP loads fold into one metric with an `lp`
    label. `extra` appends caller gauges (e.g. the service's replica
    count) verbatim."""
    out = []

    def gauge(name, value, labels=""):
        name = f"{_PREFIX}_{_san(name)}"
        out.append(f"# TYPE {name} gauge")
        out.append(f"{name}{labels} {value:g}")

    latest = tele.ledger.latest()
    for col, val in latest.items():
        if col.startswith("lp_load_"):
            continue
        gauge(col, val)
    loads = [(col[len("lp_load_"):], val) for col, val in latest.items()
             if col.startswith("lp_load_")]
    if loads:
        name = f"{_PREFIX}_lp_load"
        out.append(f"# TYPE {name} gauge")
        for lp, val in loads:
            out.append(f'{name}{{lp="{lp}"}} {val:g}')
    for col, st in tele.summary().items():
        if col.startswith("lp_load_"):
            continue
        gauge(f"{col}_mean", st["mean"])
    gauge("ledger_rows_total", tele.ledger.n_total)
    gauge("events_total", len(tele.events.records()))
    for kind in sorted({e.kind for e in tele.events.records()}):
        n = sum(1 for e in tele.events.records() if e.kind == kind)
        gauge("events", n, labels=f'{{kind="{kind}"}}')
    for name, value in (extra or {}).items():
        gauge(name, value)
    return "\n".join(out) + "\n"
