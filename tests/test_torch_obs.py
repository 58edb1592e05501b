"""The port's runtime telemetry (`repro_torch.obs`) against `repro.obs`,
on the CPU, at tests/test_obs.py's size (96 SEs, 4 LPs, area 1,000,
range 80, p 0.3, MF 1.2, MT 5, 24 steps, drain_every 5).

Held exactly: the ledger's keys and rows (every column is an integer
count, or the float32 LCR of integer counts, which slice 1 holds
bit-equal), the events (kind, step, data), the Prometheus text, the
tuner's `tuner_move` events and the trace's spans per step. Within the
port: telemetry on leaves state and series bit-equal (`torch.equal`),
any `drain_every` and any cut into windows files every step once, a
traced run is bit for bit the untraced one, and with telemetry off the
window runner dispatches the very aten ops of the default config.

The reference is imported inside the `ref` fixture, so the card's tests
run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_obs.py
"""
import dataclasses
import json
import re
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro_torch.core as T  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import selftune as ttune  # noqa: E402
from repro_torch.core.stats import StreamingStats  # noqa: E402

CPU = torch.device("cpu")
# one PyTorch thread a test worker, as tests/torch_parity.py sets it
torch.set_num_threads(1)
#: tests/test_obs.py's world and heuristic
ABM = dict(n_se=96, n_lp=4, area=1000.0, speed=5.0, interaction_range=80.0,
           p_interact=0.3)
HEU = dict(mf=1.2, mt=5)
OBS = dict(enabled=True, drain_every=5)
#: config variants: engine fields, abm fields
VARIANTS = {
    "closed": ({}, {}),
    "open": ({"open_world": True, "n_active": 80}, {}),
    "epidemic": ({}, {"workload": "epidemic"}),
    "repartition": ({"repartition_every": 2}, {}),
}
#: the service's windows (misaligned with drain_every 5)
WINDOWS = (7, 3, 2, 12)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import repro.core as R
    from repro import obs as RO
    from repro.core import engine as reng
    from repro.core import selftune as rtune
    from repro.core import stats as rstats
    return types.SimpleNamespace(jax=jax, core=R, obs=RO, engine=reng,
                                 tune=rtune, stats=rstats)


def _cfg(P, O, variant="closed", obs=None, **eng):
    """Package P's config (P: repro.core or repro_torch.core, O: its obs
    package) of a variant, with ObsConfig(**obs) when given."""
    ev, av = VARIANTS[variant]
    kw = {**ev, **eng}
    if obs is not None:
        kw["obs"] = O.ObsConfig(**obs)
    kw.setdefault("timesteps", 24)
    return P.EngineConfig(abm=P.ABMConfig(**ABM, **av),
                          heuristic=P.HeuristicConfig(**HEU), gaia_on=True,
                          **kw)


def _port(variant="closed", obs=None, **eng):
    return _cfg(T, TO, variant, obs, **eng)


def _events(evs):
    return [(e.kind, e.step, e.data) for e in evs]


def _port_run(cfg, seed=7, device=CPU):
    """A one-shot run with its own session current: (state, series,
    counters), Telemetry."""
    tele = TO.Telemetry(cfg)
    with TO.runtime.use(tele):
        out = teng._run(trandom.key(seed), cfg, device)
    return out, tele


# --- the host copies --------------------------------------------------------


@pytest.mark.parametrize("variant", ["closed", "open", "epidemic",
                                     "lp_device"])
def test_ledger_keys_equal_reference(ref, variant):
    if variant == "lp_device":  # duck-typed: the reference's config
        rc = _cfg(ref.core, ref.obs, sharding="lp_device", n_devices=2)
        assert TO.ledger_keys(rc) == ref.obs.ledger_keys(rc)
        assert "shard_overflow" in TO.ledger_keys(rc)
        return
    assert TO.ledger_keys(_port(variant)) == ref.obs.ledger_keys(
        _cfg(ref.core, ref.obs, variant))


def test_package_exports_reference_names(ref):
    assert TO.__all__ == ref.obs.__all__
    assert TO.EVENT_KINDS == ref.obs.EVENT_KINDS


def test_streaming_stats_equal_reference(ref):
    xs = np.random.default_rng(0).normal(3.0, 2.0, 257)
    a, b = StreamingStats(), ref.stats.StreamingStats()
    for x in xs:
        a.add(x)
        b.add(x)
    assert a.as_dict() == b.as_dict()
    assert (a.min, a.max) == (b.min, b.max)


def test_unknown_event_kind_rejected(ref):
    for O, P in ((TO, T), (ref.obs, ref.core)):
        tele = O.Telemetry(_cfg(P, O, obs=OBS))
        with pytest.raises(ValueError):
            tele.emit("not_a_kind", 0)


# --- telemetry on is invisible to the run -----------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_obs_on_leaves_run_bit_equal(variant):
    st0, s0, c0 = teng._run(trandom.key(7), _port(variant), CPU)
    (st1, s1, c1), tele = _port_run(_port(variant, OBS))
    assert st0.keys() == st1.keys() and st0["t"] == st1["t"]
    for k in st0:
        if k != "t":
            assert torch.equal(st0[k], st1[k]), k
    assert s0.keys() == s1.keys()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert c0 == c1
    assert len(tele.ledger) == 24  # and it observed every step


class _Ops(TorchDispatchMode):
    """Records every aten op dispatched, with its tensor arguments'
    shapes and dtypes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        sig = tuple((tuple(a.shape), a.dtype) for a in args
                    if isinstance(a, torch.Tensor))
        self.ops.append((str(func), sig))
        return func(*args, **(kwargs or {}))


def _window_ops(cfg, n=7):
    state = teng._init_engine(trandom.key(3), cfg, CPU)
    with _Ops() as rec:
        teng._run_window(state, cfg, n)
    return rec.ops


def test_obs_off_dispatches_the_default_ops():
    """Telemetry off is a zero-op: a disabled ObsConfig with other knobs
    dispatches the default config's aten ops, one for one (shapes and
    dtypes included); telemetry on dispatches more (the ring)."""
    default = _window_ops(_port())
    tweaked = _window_ops(_port(obs=dict(enabled=False, drain_every=3,
                                         mig_burst=50)))
    assert tweaked == default
    with TO.runtime.use(TO.Telemetry(_port(obs=OBS))):
        on = _window_ops(_port(obs=OBS))
    assert len(on) > len(default)


# --- the ledger drain -------------------------------------------------------


def test_ledger_reproduces_series():
    cfg = _port(obs=OBS)
    (_, series, _), tele = _port_run(cfg)
    led = tele.ledger
    assert led.keys == TO.ledger_keys(cfg)
    np.testing.assert_array_equal(led.column("step"), np.arange(24.0))
    for k in ("lcr", "local_msgs", "remote_msgs", "migrations",
              "heu_evals", "repartitions", "grid_overflow"):
        np.testing.assert_array_equal(
            led.column(k), series[k].double().numpy(), err_msg=k)
    loads = np.stack([led.column(f"lp_load_{i}") for i in range(4)])
    np.testing.assert_array_equal(loads.sum(0), np.full(24, 96.0))
    st = led.summary()["lcr"]
    assert st["n"] == 24
    assert abs(st["mean"] - float(series["lcr"].double().mean())) < 1e-12


@pytest.mark.parametrize("de", [1, 24, 50])
def test_drain_every_is_only_batching(de):
    """drain_every changes when rows reach the host, never which rows:
    each depth files the rows of drain_every 5."""
    want = _port_run(_port(obs=OBS))[1].ledger.rows()
    got = _port_run(_port(obs=dict(enabled=True, drain_every=de)))[1]
    np.testing.assert_array_equal(got.ledger.rows(), want)


@pytest.mark.parametrize("windows", [(7, 7, 7), (3, 1, 9, 2, 5)],
                         ids=["7x3", "mixed"])
def test_misaligned_windows_file_each_step_once(windows):
    cfg = _port(obs=OBS, timesteps=0)
    eng = T.Engine(cfg, device=CPU).init(seed=7)
    for n in windows:
        eng.step(n)
    np.testing.assert_array_equal(eng.ledger().column("step"),
                                  np.arange(float(sum(windows))))
    assert not eng.telemetry.drain.pending
    assert eng.telemetry.drain.stalls == 0


def test_no_session_drops_blocks_without_error():
    cfg = _port(obs=OBS, timesteps=10)
    before = TO.runtime.dropped_blocks
    with TO.runtime.use(None):
        teng._run(trandom.key(3), cfg, CPU)  # two wraps
        TO.runtime.emit_event("tuner_move", 0, mf=1.0)  # ignored
        TO.runtime.on_block(np.zeros((5, 12)), 4)
    assert TO.runtime.dropped_blocks == before + 3
    tele = TO.Telemetry(cfg)
    with TO.runtime.use(tele):  # a host block files into the session
        TO.runtime.on_block(np.arange(5.0)[:, None].repeat(12, 1), 4)
    np.testing.assert_array_equal(tele.ledger.column("step"),
                                  np.arange(5.0))


def test_threshold_events_have_exact_stamps():
    cfg = _port(obs=dict(OBS, mig_burst=1), repartition_every=8)
    (_, series, _), tele = _port_run(cfg)
    migs = series["migrations"].numpy()
    assert [e.step for e in tele.events.records("migration_burst")] == \
        [t for t in range(24) if migs[t] >= 1]
    stamps = {e.step for e in tele.events.records("repartition")}
    assert stamps and all(t > 0 and t % 8 == 0 for t in stamps)


def test_jsonl_sink_round_trip(tmp_path):
    path = tmp_path / "events.jsonl"
    cfg = _port(obs=OBS, timesteps=10)
    tele = TO.Telemetry(cfg, sinks=[TO.JsonlSink(str(path))])
    with TO.runtime.use(tele):
        teng._run(trandom.key(7), cfg, CPU)
    tele.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines == [e.as_dict() for e in tele.events.records()]
    assert lines and all(ln["kind"] in TO.EVENT_KINDS and
                         isinstance(ln["step"], int) for ln in lines)


# --- the port against the reference -----------------------------------------


def _both_engines(ref, cfgs, seed=7):
    (rc, tc) = cfgs
    er = ref.core.Engine(rc, obs_sinks=[ref.obs.MemorySink()]).init(
        seed=seed)
    et = T.Engine(tc, device=CPU, obs_sinks=[TO.MemorySink()]).init(
        seed=seed)
    return er, et


def _held_equal(er, et):
    np.testing.assert_array_equal(et.ledger().rows(), er.ledger().rows())
    assert et.ledger().keys == er.ledger().keys
    assert et.ledger().summary() == er.ledger().summary()
    assert _events(et.events()) == _events(er.events())
    assert et.prometheus() == er.prometheus()


@pytest.mark.parametrize("variant", ["closed", "epidemic", "repartition"])
def test_ledger_events_prometheus_equal_reference(ref, variant):
    """Engine.step windows 7, 3, 2, 12 on both packages: the ledger rows,
    the events and the Prometheus text are the reference's exactly."""
    eng = {"repartition_every": 8} if variant == "repartition" else {}
    variant = "closed" if variant == "repartition" else variant
    er, et = _both_engines(ref, (
        _cfg(ref.core, ref.obs, variant, dict(OBS, mig_burst=3),
             timesteps=0, **eng),
        _port(variant, dict(OBS, mig_burst=3), timesteps=0, **eng)))
    for n in WINDOWS:
        er.step(n)
        et.step(n)
    assert len(et.ledger()) == sum(WINDOWS)
    _held_equal(er, et)


def test_service_telemetry_and_churn_events_equal_reference(ref):
    """tests/test_obs.py's service case on both packages: the `pop`
    column, the arrive / depart stamps, the Prometheus lines, and
    close() clearing the current session."""
    obs = dict(OBS)
    er, et = _both_engines(ref, (
        _cfg(ref.core, ref.obs, "open", obs, timesteps=0),
        _port("open", obs, timesteps=0)), seed=0)
    for e in (er, et):
        e.step(7)
        ids = e.arrive({"pos": np.full((4, 2), 100.0)})
        e.step(3)
        e.depart(ids[:2])
        e.step(2)
    _held_equal(er, et)
    pop = et.ledger().column("pop")
    assert pop[6] == 80 and pop[7] == 84 and pop[-1] == 82
    assert [(e.step, e.data["count"]) for e in et.events("arrive")] == \
        [(7, 4)]
    assert [(e.step, e.data["count"]) for e in et.events("depart")] == \
        [(10, 2)]
    text = et.prometheus()
    for line in ("# TYPE gaia_lcr gauge", 'gaia_lp_load{lp="0"}',
                 "gaia_population 82", "gaia_steps_total 12",
                 "gaia_events_total"):
        assert line in text
    et.close()
    assert TO.runtime.get_current() is not et.telemetry


@pytest.mark.parametrize("view", ["ledger", "events", "prometheus"])
def test_engine_without_obs_has_no_telemetry_surface(ref, view):
    er = ref.core.Engine(_cfg(ref.core, ref.obs, timesteps=0)).init(seed=0)
    et = T.Engine(_port(timesteps=0), device=CPU).init(seed=0)
    assert et.telemetry is None
    with pytest.raises(RuntimeError) as want:
        getattr(er, view)()
    with pytest.raises(RuntimeError, match=re.escape(str(want.value))):
        getattr(et, view)()


#: tests/test_selftune.py's tuner world
TUNE_ABM = dict(n_se=100, n_lp=4, area=1000.0, speed=4.0,
                interaction_range=90.0, p_interact=0.3)
TUNE = dict(window=30, mf0=8.0, setup="distributed")


def test_tuner_move_events_equal_reference(ref):
    """intra_run_tune with a session current: the reference's tuner_move
    events, one per MF change of its history (and, with telemetry on in
    the config, the reference's ledger rows)."""
    out = []
    for P, O, tune, key in (
            (ref.core, ref.obs, ref.tune, ref.jax.random.key(0)),
            (T, TO, ttune, trandom.key(0))):
        cfg = P.EngineConfig(abm=P.ABMConfig(**TUNE_ABM),
                             heuristic=P.HeuristicConfig(mf=4.0, mt=5),
                             timesteps=180, obs=O.ObsConfig(**OBS))
        tele = O.Telemetry(cfg)
        kw = {"device": CPU} if P is T else {}
        with O.runtime.use(tele):
            _, hist = tune.intra_run_tune(key, cfg,
                                          tune.SelfTuneConfig(**TUNE), **kw)
        out.append((tele, hist))
    (rtele, _), (ttele, hist) = out
    moves = _events(ttele.events.records("tuner_move"))
    assert moves == _events(rtele.events.records("tuner_move"))
    changed = [(w, hist[w + 1][1], hist[w][1]) for w in range(len(hist) - 1)
               if hist[w + 1][1] != hist[w][1]]
    assert [(d["window"], d["mf"], d["prev_mf"]) for _, s, d in moves
            ][:len(changed)] == changed
    assert all(s == (d["window"] + 1) * 30 for _, s, d in moves)
    np.testing.assert_array_equal(ttele.ledger.rows(), rtele.ledger.rows())
    assert len(ttele.ledger) == 180


def test_batched_paths_run_without_telemetry():
    """The batched tuner emits no tuner_move and the batched run files
    no rows, as in the reference (strip_obs)."""
    cfg = _port(obs=OBS, timesteps=60)
    tele = TO.Telemetry(cfg)
    with TO.runtime.use(tele):
        ttune.intra_run_tune_batch(cfg, ttune.SelfTuneConfig(**TUNE),
                                   [0, 1], device=CPU)
        T.Engine(cfg, device=CPU).init(seeds=[0, 1]).step(5)
    assert len(tele.ledger) == 0 and not tele.events.records()
    assert teng.strip_obs(cfg) == _port(timesteps=60)


# --- the trace --------------------------------------------------------------


def _spans(rec):
    return [(e["name"], e["args"]["step"]) for e in rec.events
            if e["ph"] == "X"]


@pytest.mark.parametrize("variant", ["closed", "epidemic", "repartition"])
def test_trace_spans_equal_reference(ref, variant):
    """The trace's spans, phase by phase and step by step, are the
    reference's trace_run's; its JSON passes the reference's structure
    checks; the traced state is bit for bit `_run_steps`'s."""
    rec = TO.trace_run(_port(variant, timesteps=3), seed=0, warmup=1,
                       device="cpu")
    want = ref.obs.trace_run(_cfg(ref.core, ref.obs, variant, timesteps=3),
                             seed=0, warmup=1)
    assert _spans(rec) == _spans(want)
    doc = json.loads(json.dumps(rec.as_dict()))
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["tid"] for e in spans} == {0}
    assert any(e["name"] == "thread_name" for e in doc["traceEvents"]
               if e["ph"] == "M")
    assert all(e["dur"] >= 0 and "step" in e["args"] for e in spans)
    summ = rec.phase_summary()
    assert summ.keys() == want.phase_summary().keys()
    assert all(v["n"] == 3 for v in summ.values())

    cfg = _port(variant)
    start = teng._init_engine(trandom.key(5), cfg, CPU)
    traced = TO.trace_steps(start, cfg, 4, TO.TraceRecorder(), warmup=2)
    fused, _ = teng._run_steps(start, cfg, 6)
    assert traced.keys() == fused.keys() and traced["t"] == fused["t"]
    for k in fused:
        if k != "t":
            assert torch.equal(traced[k], fused[k]), k


def test_sharded_trace_names_item_10(ref):
    """The sharded trace (queue 1 item 10, which this test once expected
    to raise): one row a shard, the reference's phases and per-shard
    args, and the traced state the fused run's."""
    rc = _cfg(ref.core, ref.obs, sharding="lp_device", n_devices=2)
    cfg = _port(sharding="lp_device", n_devices=2)
    want = ref.obs.trace_run(rc, seed=5, n_steps=2, warmup=1)
    rec = TO.trace_run(cfg, seed=5, n_steps=2, warmup=1, device="cpu")
    spans = [(e["name"], e["tid"], e["args"]) for e in rec.events
             if e["ph"] == "X"]
    assert spans == [(e["name"], e["tid"], e["args"])
                     for e in want.events if e["ph"] == "X"]
    assert {a["n_valid"] for _, _, a in spans} and rec.n_dev == 2
    start = teng._init_engine(trandom.key(5), cfg, CPU)
    traced = TO.trace_steps(start, cfg, 3, TO.TraceRecorder(n_dev=2),
                            warmup=1)
    fused, _ = teng._run_steps(start, cfg, 4)
    for k in fused:
        if k != "t":
            assert torch.equal(traced[k], fused[k]), k


# --- the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


def _syncs(fn):
    """The synchronising calls `fn` makes, as PyTorch's sync debug mode
    warns of them (its own warning; others are not counted)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


@pytest.mark.cuda
def test_obs_window_adds_no_sync_on_card(cuda):
    """An obs-on window makes as many synchronising calls as the obs-off
    window (the counters' read at its end), and files every step."""
    n = {}
    _syncs(lambda: torch.zeros(1, device=cuda).cpu())  # a first one
    for on in (False, True):
        cfg = _port(obs=OBS if on else None, timesteps=0)
        eng = T.Engine(cfg, device=cuda).init(seed=7)
        eng.step(3)  # warm: kernels built and loaded
        n[on] = _syncs(lambda: eng.step(23))
    assert n[True] == n[False]
    assert len(eng.ledger()) == 26 and eng.telemetry.drain.stalls == 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["closed", "open"])
def test_ledger_on_card_equals_cpu(cuda, variant):
    """The card's ledger rows and events are the CPU's."""
    cfg = _port(variant, OBS)
    (_, _, _), gpu = _port_run(cfg, device=cuda)
    (_, _, _), cpu = _port_run(cfg)
    np.testing.assert_array_equal(gpu.ledger.rows(), cpu.ledger.rows())
    assert _events(gpu.events.records()) == _events(cpu.events.records())
