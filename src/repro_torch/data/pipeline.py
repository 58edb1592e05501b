"""The port's own copy of `repro.data.pipeline` (numpy only, so the two
packages produce the same tokens and frames from the same config):

- the LM half: `DataConfig`, `SyntheticLM` and `make_pipeline`, the
  deterministic, restart-safe token stream of the training loop;
- the trace half: position traces for the engine's `trace` mobility
  model.

Batches are a pure function of (seed, step), so a restarted trainer
replays the exact token stream without saved iterator state; a
background thread keeps `prefetch` batches ahead of the loop.

    spec = TraceSpec(n_se=10_000, area=10_000.0, timesteps=1201)
    register_trace("commute", synthetic_trace(spec))
    ABMConfig(mobility="trace", trace_name="commute")

The port keeps its own registry: a test that runs both packages
registers the same frames in each.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


# ---------------------------------------------------------------------------
# The synthetic LM stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    prefetch: int = 2
    structure: float = 0.9  # P(follow the markov rule) vs uniform noise
    order: int = 1  # 1: learnable bigram bijection; 2: modular arithmetic


class SyntheticLM:
    """Markov stream. Order 1: next = (31*a + 7) % V (a bijection when
    gcd(31, V) = 1). Order 2: next = (31*a + 17*b + 7) % V. Both with
    prob `structure`, else uniform. The generator and its draws are the
    reference's, so the tokens are bit-equal."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        toks[:, 1] = rng.integers(0, V, B)
        noise = rng.random((B, S)) >= cfg.structure
        rand = rng.integers(0, V, (B, S))
        for t in range(2, S):
            if cfg.order == 1:
                nxt = (toks[:, t - 1] * 31 + 7) % V
            else:
                nxt = (toks[:, t - 1] * 31 + toks[:, t - 2] * 17 + 7) % V
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks,
                "loss_mask": np.ones((B, S), np.float32)}


def make_pipeline(cfg: DataConfig, start_step: int = 0,
                  source: Optional[SyntheticLM] = None) -> Iterator[dict]:
    """Prefetching iterator over batches, resumable at `start_step`.
    Closing the iterator (or dropping it) stops its thread."""
    src = source or SyntheticLM(cfg)
    q: "queue.Queue" = queue.Queue(maxsize=max(cfg.prefetch, 1))
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(src.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    th = threading.Thread(target=worker, daemon=True)
    th.start()

    def gen():
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    return gen()


# ---------------------------------------------------------------------------
# Mobility traces
# ---------------------------------------------------------------------------

# A trace is a dense (T, N, 2) float32 frame stack: frame t holds the
# position of every SE at integer step t, already on the torus
# ([0, area) per axis). The engine replays frames verbatim — replay is
# bit-equal to the stack by construction, so the round-trip contract
# (generator -> writer -> loader -> replay) is byte-exact. Irregularly
# timestamped sources (GPS/taxi logs) go through `resample_trace`,
# which torus-lerps onto the integer step grid and returns the *exact*
# sample row whenever a step time coincides with a sample time.
#
# Traces are data, not config: `ABMConfig` stays hashable by referring
# to a trace via `trace_name`, a key into the process-wide registry
# below. The engine copies the frames to the device once per trace.


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Parameters of the synthetic commuter-trace generator."""
    n_se: int
    area: float
    timesteps: int          # number of frames T (steps 0..T-1)
    speed: float = 10.0     # max per-step displacement the commute obeys
    n_hubs: int = 6         # shared destinations (taxi-stand analogue)
    seed: int = 0


class Trace:
    """An in-memory position trace: ``frames`` (T, N, 2) float32 on the
    ``area`` torus. Derived quantities (per-step displacement bound,
    peak cell occupancy) are computed lazily and cached — they size the
    halo dilation radius and the proximity-grid capacity exactly."""

    def __init__(self, frames: np.ndarray, area: float):
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 3 or frames.shape[2] != 2 or frames.shape[0] < 1:
            raise ValueError(
                f"trace frames must be (T>=1, N, 2); got {frames.shape}")
        if not (np.isfinite(frames).all()
                and (frames >= 0).all() and (frames < area).all()):
            raise ValueError(
                "trace frames must be finite and inside [0, area) on "
                "both axes (fold external data onto the torus first)")
        self.frames = frames
        self.area = float(area)
        self._occ_cache: dict = {}
        self._disp_cache: dict = {}

    @property
    def timesteps(self) -> int:
        return int(self.frames.shape[0])

    @property
    def n_se(self) -> int:
        return int(self.frames.shape[1])

    def max_step_displacement(self, include_seam: bool = False) -> float:
        """Exact torus-aware max |Δpos| between consecutive frames.
        Sizes the sharded halo's dilation radius — exact-or-loud, no
        heuristic bound. ``include_seam`` adds the frames[-1] ->
        frames[0] jump, which only the `loop` replay policy ever takes
        (a commute rarely closes at the trace boundary, so the seam
        can dominate — hold/exact replays must not pay for it)."""
        key = bool(include_seam)
        if key not in self._disp_cache:
            f = self.frames.astype(np.float64)
            nxt = np.concatenate([f[1:], f[:1]], axis=0) if include_seam \
                else f[1:]
            if nxt.shape[0] == 0:
                self._disp_cache[key] = 0.0
            else:
                d = nxt - f[:nxt.shape[0]] if not include_seam else nxt - f
                half = self.area / 2.0
                d = (d + half) % self.area - half
                self._disp_cache[key] = float(np.sqrt((d * d).sum(-1)).max())
        return self._disp_cache[key]

    def peak_cell_occupancy(self, ncell: int) -> int:
        """Max SEs in any cell of an (ncell, ncell) uniform grid over
        the area, across ALL frames — the exact capacity bound for the
        proximity grid when replaying this trace."""
        key = int(ncell)
        if key not in self._occ_cache:
            cell = self.area / ncell
            ix = np.clip((self.frames[..., 0] / cell).astype(np.int64),
                         0, ncell - 1)
            iy = np.clip((self.frames[..., 1] / cell).astype(np.int64),
                         0, ncell - 1)
            flat = ix * ncell + iy  # (T, N)
            peak = 0
            for t in range(flat.shape[0]):
                peak = max(peak, int(np.bincount(
                    flat[t], minlength=ncell * ncell).max()))
            self._occ_cache[key] = peak
        return self._occ_cache[key]


def commute_frames(spec: TraceSpec) -> np.ndarray:
    """The (T, N, 2) float32 frames of `synthetic_trace`, as generated:
    a float64 position just below ``area`` can round up to ``area``
    itself in float32, which `Trace` rejects (at 10,000 SEs on an area
    of 10,000, seed 0, some frames do; the reference's generator raises
    there too). Callers that want such a spec anyway fold those values
    back below ``area``."""
    rng = np.random.default_rng(spec.seed)
    n, area, T = spec.n_se, float(spec.area), int(spec.timesteps)
    homes = rng.random((n, 2)) * area
    hubs = rng.random((max(spec.n_hubs, 1), 2)) * area
    target = hubs[rng.integers(0, len(hubs), n)]
    half = area / 2.0
    d = (target - homes + half) % area - half  # torus-shortest commute
    dist = np.sqrt((d * d).sum(-1))
    # round-trip period: out leg covers |d| in P/2 steps at <= speed
    period = np.maximum(2.0 * np.ceil(dist / max(spec.speed, 1e-9)), 2.0)
    phase = rng.integers(0, period.astype(np.int64) + 1, n)
    t = np.arange(T, dtype=np.float64)
    u = ((t[:, None] + phase[None, :]) % period[None, :]) / period[None, :]
    frac = 1.0 - np.abs(2.0 * u - 1.0)  # triangle 0 -> 1 -> 0
    frames = (homes[None] + frac[..., None] * d[None]) % area
    return frames.astype(np.float32)


def synthetic_trace(spec: TraceSpec) -> Trace:
    """Deterministic commuter trace: every SE shuttles between a home
    and one of ``n_hubs`` hubs along the torus-shortest path (a
    triangle wave with per-SE period and phase), never moving more
    than ``spec.speed`` per step. Hubs concentrate SEs — the workload
    is clustered like taxi data, not uniform — and commutes routinely
    cross the torus seam, so replay exercises wrap handling."""
    return Trace(commute_frames(spec), float(spec.area))


def save_trace(trace: Trace, path: str) -> str:
    """Write a trace as .npz (float32 frames + area). Round-trips
    bit-exactly through `load_trace`."""
    np.savez(path, frames=trace.frames,
             area=np.float32(trace.area))
    return path if path.endswith(".npz") else path + ".npz"


def load_trace(path: str) -> Trace:
    with np.load(path) as z:
        return Trace(z["frames"], float(z["area"]))


def resample_trace(times, positions, area: float, n_steps: int) -> Trace:
    """Map an irregularly timestamped position log onto the integer
    step grid 0..n_steps-1 by torus-aware linear interpolation.

    ``times`` (S,) must be strictly increasing and bracket the step
    grid (times[0] <= 0, times[-1] >= n_steps-1) — exact-or-loud, no
    silent extrapolation. When a step time coincides with a sample
    time the sample row is returned verbatim (bit-equal), so a log
    recorded *at* integer steps resamples to itself exactly."""
    times = np.asarray(times, np.float64)
    positions = np.asarray(positions, np.float32)
    if times.ndim != 1 or positions.shape[:1] != times.shape:
        raise ValueError("times (S,) must index positions (S, N, 2)")
    if not (np.diff(times) > 0).all():
        raise ValueError("trace timestamps must be strictly increasing")
    if times[0] > 0 or times[-1] < n_steps - 1:
        raise ValueError(
            f"trace samples [{times[0]}, {times[-1]}] do not cover the "
            f"step grid [0, {n_steps - 1}] — trim n_steps or extend the "
            "log (resample never extrapolates)")
    grid = np.arange(n_steps, dtype=np.float64)
    hi = np.clip(np.searchsorted(times, grid, side="left"),
                 1, len(times) - 1)
    lo = hi - 1
    exact = times[hi] == grid
    frac = ((grid - times[lo]) /
            (times[hi] - times[lo])).astype(np.float64)
    half = float(area) / 2.0
    p0 = positions[lo].astype(np.float64)
    delta = (positions[hi].astype(np.float64) - p0 + half) % area - half
    lerp = ((p0 + frac[:, None, None] * delta) % area).astype(np.float32)
    frames = np.where(exact[:, None, None], positions[hi], lerp)
    return Trace(frames, float(area))


#: process-wide trace registry; `ABMConfig.trace_name` keys into it so
#: the engine config stays hashable
_TRACES: dict[str, Trace] = {}


def register_trace(name: str, trace: Trace) -> Trace:
    """Bind ``name`` -> ``trace``. Rebinding a live name drops the
    engine's compiled-program caches: the frames are baked into traced
    programs as constants, so a stale cache would silently replay the
    old trace."""
    if not name:
        raise ValueError("trace name must be non-empty")
    _TRACES[name] = trace
    return trace


def get_trace(name: str) -> Trace:
    if name not in _TRACES:
        raise KeyError(
            f"trace {name!r} is not registered (known: "
            f"{sorted(_TRACES)}); call repro_torch.data.pipeline."
            "register_trace(name, trace) before building the engine")
    return _TRACES[name]


def trace_names() -> list:
    return sorted(_TRACES)
