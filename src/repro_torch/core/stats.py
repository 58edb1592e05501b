"""Replica statistics and window merging — the port's own copy of the
part of `repro.core.stats` the engine, its replica batches, their
summaries and the telemetry ledger use. Host-only, math only.

The schema of one reported metric is {"mean", "std", "ci95", "n"}:
`std` is the sample standard deviation (ddof=1) and `ci95` the
half-width of the 95% confidence interval of the mean with the
Student-t critical value for n-1 degrees of freedom; n=1 gives a point
estimate with zero spread.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

#: two-sided 95% Student-t critical values, df = 1..30 (df > 30 ~ z)
_T95 = (12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
        2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
        2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
        2.048, 2.045, 2.042)

#: run-counter keys that merge as step-weighted means (everything else
#: numeric sums; nested lists add elementwise)
_MEAN_KEYS = ("mean_lcr", "mean_halo_frac", "mean_pop")


def t95(df: int) -> float:
    """Two-sided 95% Student-t critical value for `df` degrees of
    freedom (df > 30 falls back to the normal 1.96)."""
    if df < 1:
        raise ValueError(f"df must be >= 1, got {df}")
    return _T95[df - 1] if df <= len(_T95) else 1.96


def replica_stats(values: Sequence[float]) -> Dict[str, float]:
    """mean/std/ci95/n over independent replica measurements."""
    xs = [float(v) for v in values]
    n = len(xs)
    if n == 0:
        raise ValueError("replica_stats needs at least one value")
    mean = sum(xs) / n
    if n < 2:
        return {"mean": mean, "std": 0.0, "ci95": 0.0, "n": n}
    std = math.sqrt(sum((x - mean) ** 2 for x in xs) / (n - 1))
    return {"mean": mean, "std": std,
            "ci95": t95(n - 1) * std / math.sqrt(n), "n": n}


def is_stats(obj) -> bool:
    """Is `obj` a mean/std/ci95/n stats dict (the BENCH metric
    schema)?"""
    return isinstance(obj, dict) and {"mean", "std", "ci95", "n"} <= set(obj)


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default method), math
    only."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile needs at least one value")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    k = (len(xs) - 1) * (q / 100.0)
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


class StreamingStats:
    """Welford one-pass mean/variance accumulator in the replica schema:
    O(1) state a metric, so the telemetry ledger (`repro_torch.obs`)
    summarises a resident engine's rows without keeping them, and
    `as_dict()` gives the mean/std/ci95/n schema of `replica_stats`."""

    __slots__ = ("n", "mean", "_m2", "min", "max")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self._m2 += d * (x - self.mean)
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    @property
    def std(self) -> float:
        return math.sqrt(self._m2 / (self.n - 1)) if self.n > 1 else 0.0

    def as_dict(self) -> Dict[str, float]:
        ci = (t95(self.n - 1) * self.std / math.sqrt(self.n)
              if self.n > 1 else 0.0)
        return {"mean": self.mean, "std": self.std, "ci95": ci, "n": self.n}


def merge_counters(parts: Sequence[Dict], weights: Sequence[float]) -> Dict:
    """Merge per-window run-counter dicts into one run's counters:
    counter keys sum, `mean_*` keys combine as window-length-weighted
    means, matrix counters (nested lists) add elementwise."""
    if not parts:
        raise ValueError("merge_counters needs at least one window")
    if len(parts) != len(weights):
        raise ValueError("one weight (window length) per counters dict")
    out: Dict = {}
    total_w = float(sum(weights))
    for c, w in zip(parts, weights):
        for k, v in c.items():
            if isinstance(v, list):
                if k not in out:
                    out[k] = [row[:] for row in v]
                else:
                    out[k] = [[a + b for a, b in zip(ra, rb)]
                              for ra, rb in zip(out[k], v)]
            elif k in _MEAN_KEYS:
                out[k] = out.get(k, 0.0) + float(v) * (w / max(total_w, 1.0))
            else:
                out[k] = out.get(k, 0.0) + float(v)
    return out


def summarize(reps: List[Dict], keys: Optional[Iterable[str]] = None,
              ndigits: Optional[int] = None) -> Dict[str, Dict[str, float]]:
    """Per-metric `replica_stats` over a list of per-replica counter
    dicts (every scalar metric of the first by default; matrix counters
    skipped). Boolean counters are flags and report {"any", "count",
    "n"} instead of a statistic."""
    if not reps:
        raise ValueError("summarize needs at least one replica")
    if keys is None:
        keys = [k for k, v in reps[0].items() if isinstance(v, (int, float))]
    out = {}
    for k in keys:
        vals = [r[k] for r in reps]
        if isinstance(reps[0][k], bool):
            out[k] = {"any": any(vals),
                      "count": sum(1 for v in vals if v), "n": len(vals)}
            continue
        st = replica_stats(vals)
        if ndigits is not None:
            st = {kk: (round(v, ndigits) if kk != "n" else v)
                  for kk, v in st.items()}
        out[k] = st
    return out
