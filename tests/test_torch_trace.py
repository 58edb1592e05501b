"""The port's trace replay: its own copy of the trace half of
`repro.data.pipeline` and the engine's `trace` mobility, against the
reference on the CPU.

Both packages keep their own trace registry, so every test registers
the same frames in each. The pipeline is numpy in both, so its frames,
peak occupancies and displacement bounds are compared exactly; replay
is a copy, so replayed positions are bit-equal to the frames, and every
integer series of a replayed run is exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference runs beside the port

import repro.core as R  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import abm as tabm  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

from torch_parity import (CPU, assert_integer_series_equal,  # noqa: E402
                          bits_equal, cfgs, run_both, teacher_forced)

SPEC = {"n_se": 400, "area": 1000.0, "timesteps": 41, "speed": 11.0,
        "n_hubs": 4, "seed": 3}


def _register(name, frames=None, spec=SPEC):
    """The same frames under `name` in both registries."""
    tr = rpipe.synthetic_trace(rpipe.TraceSpec(**spec)) \
        if frames is None else rpipe.Trace(frames, spec["area"])
    rpipe.register_trace(name, tr)
    tpipe.register_trace(name, tpipe.Trace(tr.frames.copy(), tr.area))
    return tr


def _abm(name, policy="exact", **kw):
    return dict(n_se=SPEC["n_se"], area=SPEC["area"], mobility="trace",
                trace_name=name, trace_policy=policy, **kw)


@pytest.mark.parametrize("spec", [SPEC, dict(SPEC, n_se=48, area=500.0,
                                             n_hubs=1, seed=11)])
def test_synthetic_trace_equal_reference(spec):
    r = rpipe.synthetic_trace(rpipe.TraceSpec(**spec))
    t = tpipe.synthetic_trace(tpipe.TraceSpec(**spec))
    bits_equal(r.frames, t.frames)
    assert (r.timesteps, r.n_se, r.area) == (t.timesteps, t.n_se, t.area)
    for seam in (False, True):
        assert r.max_step_displacement(seam) == \
            t.max_step_displacement(seam)
    for ncell in (3, 16, 40):
        assert r.peak_cell_occupancy(ncell) == t.peak_cell_occupancy(ncell)


def test_save_load_and_resample_equal_reference(tmp_path):
    tr = tpipe.synthetic_trace(tpipe.TraceSpec(**SPEC))
    back = tpipe.load_trace(tpipe.save_trace(tr, str(tmp_path / "t.npz")))
    bits_equal(back.frames, tr.frames)
    # the port's file loads in the reference and back
    rback = rpipe.load_trace(str(tmp_path / "t.npz"))
    bits_equal(rback.frames, tr.frames)
    times = np.array([-0.5, 1.0, 2.5, 4.0, 6.0])
    pos = (np.random.default_rng(0).uniform(0, 100, (5, 30, 2))
           .astype(np.float32))
    pos[2, 0] = (99.5, 0.25)  # seam crossings
    pos[3, 0] = (0.5, 99.75)
    bits_equal(rpipe.resample_trace(times, pos, 100.0, 6).frames,
               tpipe.resample_trace(times, pos, 100.0, 6).frames)


@pytest.mark.parametrize("call,match", [
    (lambda m: m.Trace(np.zeros((4, 2), np.float32), 100.0), r"T>=1"),
    (lambda m: m.Trace(np.full((2, 3, 2), 150.0, np.float32), 100.0),
     "inside"),
    (lambda m: m.resample_trace([0.0, 3.0], np.zeros((2, 1, 2)), 100.0, 6),
     "never extrapolates"),
    (lambda m: m.resample_trace([1.0, 1.0], np.zeros((2, 1, 2)), 100.0, 2),
     "strictly increasing"),
    (lambda m: m.register_trace("", None), "non-empty"),
    (lambda m: m.get_trace("no-such-trace"), "not registered"),
], ids=["shape", "off-torus", "extrapolate", "increasing", "name",
        "unknown"])
def test_validation_equal_reference(call, match):
    with pytest.raises(Exception, match=match) as ref_err:
        call(rpipe)
    with pytest.raises(type(ref_err.value), match=match):
        call(tpipe)


def test_exp6_full_spec_is_refused_by_both():
    """At exp6's full spec (10k SEs, area 10,000, 8 hubs, seed 0) a few
    float64 positions just below `area` round up to it in float32: both
    generators refuse the trace (a fault of the reference's generator,
    kept as is). `commute_frames` hands out the frames, and `Trace`
    accepts them once those values are folded below `area`."""
    spec = dict(n_se=10_000, area=10_000.0, timesteps=140, speed=11.0,
                n_hubs=8, seed=0)
    for m in (rpipe, tpipe):
        with pytest.raises(ValueError, match="inside"):
            m.synthetic_trace(m.TraceSpec(**spec))
    frames = tpipe.commute_frames(tpipe.TraceSpec(**spec))
    assert 0 < int((frames >= 10_000.0).sum()) < 10
    top = np.nextafter(np.float32(10_000.0), np.float32(0))
    tpipe.Trace(np.where(frames >= 10_000.0, top, frames), 10_000.0)


def test_trace_config_validation_equal_reference():
    _register("tt-val")
    cfg = T.ABMConfig(**_abm("tt-val"))
    with pytest.raises(ValueError, match="but ABMConfig.n_se"):
        tabm.trace_frames(dataclasses.replace(cfg, n_se=SPEC["n_se"] + 1))
    with pytest.raises(ValueError, match="torus"):
        tabm.trace_frames(dataclasses.replace(cfg, area=2 * SPEC["area"]))
    assert "tt-val" in tpipe.trace_names()
    # the grid's capacity is the trace's exact peak cell occupancy
    assert dataclasses.astuple(R.ABMConfig(**_abm("tt-val")).grid_spec()) \
        == dataclasses.astuple(cfg.grid_spec())


def test_trace_replay_exact():
    """40 steps under `exact`: positions are the frames bit for bit,
    every integer series and the final state exact, no overflow."""
    tr = _register("tt-replay")
    rc, tc = cfgs(abm=_abm("tt-replay"), timesteps=40,
                  heuristic={"mf": 1.2, "mt": 10})
    (rst, rser, rcnt), (tst, tser, tcnt) = run_both(rc, tc, seed=3)
    assert_integer_series_equal(rser, tser)
    for k in rst:
        bits_equal(rst[k], tst[k], k)
    bits_equal(tst["pos"], tr.frames[40])
    assert tcnt["grid_overflow"] == 0 and tcnt["migrations"] > 0


def test_trace_teacher_forced_bit_equal():
    _register("tt-tf")
    rc, tc = cfgs(abm=_abm("tt-tf"))
    for rst, tst, rm, tm in teacher_forced(rc, tc, seed=1, steps=10):
        for k in rst:
            bits_equal(rst[k], tst[k], k)
        for k in rm:
            bits_equal(rm[k], tm[k], k)


@pytest.mark.parametrize("policy", ["hold", "loop"])
def test_short_trace_policies_equal_reference(policy):
    """A 10-frame trace over 14 steps: `hold` stays on the last frame,
    `loop` wraps, both as the reference; the frame counter rides in
    mob_g[0, 0]."""
    full = rpipe.synthetic_trace(rpipe.TraceSpec(**SPEC))
    short = _register("tt-short", full.frames[:10])
    rc, tc = cfgs(abm=_abm("tt-short", policy), timesteps=14)
    (rst, rser, _), (tst, tser, _) = run_both(rc, tc, seed=3)
    assert_integer_series_equal(rser, tser)
    want = short.frames[-1] if policy == "hold" else short.frames[14 % 10]
    bits_equal(tst["pos"], want)
    bits_equal(rst["mob_g"], tst["mob_g"])
    assert tst["mob_g"][0, 0] == 14.0


def test_exact_policy_refuses_a_horizon_past_the_trace():
    """`exact` checks the horizon on the host before anything runs, in
    `run` and in every `step` window, as the reference's guard."""
    full = rpipe.synthetic_trace(rpipe.TraceSpec(**SPEC))
    _register("tt-exact", full.frames[:10])
    _, tc = cfgs(abm=_abm("tt-exact"), timesteps=14)
    with pytest.raises(ValueError, match="trace_policy='exact'"):
        T.Engine(tc, device=CPU).run(seed=0)
    eng = T.Engine(dataclasses.replace(tc, timesteps=9),
                   device=CPU).init(seed=0)
    eng.step(9)  # frames 1..9: the last real one
    with pytest.raises(ValueError, match="need frame 10"):
        eng.step(1)


def test_frames_follow_a_rebound_name():
    """Rebinding a name replays the new frames: the device copy is keyed
    by the Trace object."""
    full = tpipe.synthetic_trace(tpipe.TraceSpec(**SPEC))
    tpipe.register_trace("tt-rebind", full)
    cfg = T.ABMConfig(**_abm("tt-rebind", "loop"))
    a = tabm.trace_frames_on(cfg, CPU)
    flipped = tpipe.Trace(full.frames[::-1].copy(), full.area)
    tpipe.register_trace("tt-rebind", flipped)
    b = tabm.trace_frames_on(cfg, CPU)
    assert torch.equal(a, torch.from_numpy(full.frames))
    assert torch.equal(b, torch.from_numpy(flipped.frames))
