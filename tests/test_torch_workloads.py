"""The port's epidemic workload and environment pricing against the
reference, on the CPU (the card's exposure sweep:
tests/test_torch_scenario_kernels.py).

Tolerances, measured with JAX 0.9.0 and PyTorch 2.13 on the CPU:
- every integer series (counts, flows, migrations, `infected`,
  `grid_overflow`) and the final `epi` flags are exact;
- the infection probability 1 - (1 - beta)^e is a table computed once
  on the host (the power in float64, rounded once): equal to the
  jitted reference for every exposure 0..10,000 at every beta tested
  (PyTorch's float32 `pow` instead misses one value at beta 0.05 and
  three at 0.01);
- positions within `1e-5 * area` over the run, as in
  tests/test_torch_engine.py (XLA's CPU `sqrt` is not correctly rounded
  on every CPU);
- `wct_env` and the env presets are numpy in both packages: equal
  floats.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference runs beside the port

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import abm as rabm  # noqa: E402
from repro.core import costmodel as rcm  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import abm as tabm  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import neighbors as tnb  # noqa: E402
from repro_torch.fp32 import fma32  # noqa: E402

from torch_parity import (CPU, assert_integer_series_equal,  # noqa: E402
                          bits_equal, cfgs, run_both, teacher_forced)

EPI = {"workload": "epidemic"}
#: benchmarks/exp6_scenarios.py's EPI
EXP6 = {"workload": "epidemic", "epi_beta": 0.05, "epi_gamma": 0.08,
        "epi_seed_frac": 0.05, "epi_boost": 5.0}


# --- the pieces ----------------------------------------------------------


@pytest.mark.parametrize("beta", [0.3, 0.05, 0.01, 0.1, 0.9])
def test_infection_table_against_jitted_power(beta):
    """The port's table against the reference's jitted
    1 - power(1 - beta, e) for e = 0..10,000, bit for bit: the default
    0.3, exp6's 0.05 and three more."""
    e = jnp.arange(10_001, dtype=jnp.int32)
    want = np.asarray(jax.jit(lambda e: 1.0 - jnp.power(
        jnp.float32(1.0 - beta), e.astype(jnp.float32)))(e))
    got = tabm.infection_table(
        T.ABMConfig(n_se=10_000, epi_beta=beta), CPU).numpy()
    bits_equal(want, got)


def test_epidemic_init_distance_is_unfused():
    """The reference's init runs eagerly: d0**2 + d1**2 rounds each op
    (equal to the port's form on all 200,000 rows), while its jitted
    form would be fma(d0, d0, d1*d1) (33,497 rows apart)."""
    d = np.random.default_rng(0).uniform(0, 5000, (200_000, 2)).astype(
        np.float32)
    dj = jnp.asarray(d)
    eager = np.asarray(dj[:, 0] ** 2 + dj[:, 1] ** 2)
    td = torch.from_numpy(d)
    plain = (td[:, 0] * td[:, 0] + td[:, 1] * td[:, 1]).numpy()
    fused = fma32(td[:, 0], td[:, 0], td[:, 1] * td[:, 1]).numpy()
    bits_equal(eager, plain)
    assert (eager != fused).sum() > 10_000


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epidemic_init_bit_equal(seed):
    rc, tc = cfgs(abm=dict(EPI, epi_seed_frac=0.05))
    want = R.Engine(rc).init(seed=seed).state["epi"]
    got = T.Engine(tc, device=CPU).init(seed=seed).state["epi"]
    bits_equal(want, got.numpy())
    assert int(got.sum()) == round(0.05 * rc.abm.n_se)


def test_send_prob_and_row_update_equal_reference():
    cr, ct = R.ABMConfig(**EXP6), T.ABMConfig(**EXP6)
    r = np.random.default_rng(3)
    epi = (r.uniform(size=500) < 0.3).astype(np.int32)
    exposure = r.integers(0, 30, 500).astype(np.int32)
    key = jax.random.key(9)
    bits_equal(rabm.epidemic_send_prob(jnp.asarray(epi), cr),
               tabm.epidemic_send_prob(torch.from_numpy(epi), ct).numpy())
    rd = rabm.epidemic_draws(key, 500, cr)
    td = tabm.epidemic_draws(trandom.wrap_key_data(
        np.asarray(jax.random.key_data(key))), 500, ct, CPU)
    assert rd.keys() == td.keys() == {"u_inf", "u_rec"}
    for k in rd:
        bits_equal(rd[k], td[k].numpy(), k)
    want = jax.jit(lambda e, x, d: rabm.epidemic_row_update(e, x, d, cr))(
        epi, exposure, rd)
    got = tabm.epidemic_row_update(torch.from_numpy(epi),
                                   torch.from_numpy(exposure), td, ct,
                                   tabm.infection_table(ct, CPU))
    bits_equal(want, got.numpy())


# --- the slice ------------------------------------------------------------


@pytest.mark.parametrize("name,abm", [
    ("si-grid", EPI),
    ("sis-dense", dict(EPI, proximity_backend="dense", epi_gamma=0.1)),
    ("exp6", EXP6),
])
def test_epidemic_free_running_exact(name, abm):
    """40 steps with GAIA on: every integer series, `infected` and the
    final flags exact."""
    rc, tc = cfgs(abm=abm, timesteps=40)
    (rst, rser, rcnt), (tst, tser, tcnt) = run_both(rc, tc, seed=11)
    assert_integer_series_equal(rser, tser)
    for k in ("epi", "lp", "pending_dst", "ring"):
        bits_equal(rst[k], tst[k], k)
    assert np.abs(rst["pos"] - tst["pos"]).max() <= 1e-5 * rc.abm.area
    for k in ("mean_infected", "final_infected", "migrations",
              "grid_overflow"):
        assert rcnt[k] == tcnt[k], k
    assert tser["infected"][-1] > tser["infected"][0]  # the wave moved
    assert tcnt["migrations"] > 0


def test_epidemic_teacher_forced_bit_equal():
    """Each of 15 steps from the reference's state: the whole state and
    every metric bit for bit."""
    rc, tc = cfgs(abm=EXP6)
    for rst, tst, rm, tm in teacher_forced(rc, tc, seed=5, steps=15):
        for k in rst:
            bits_equal(rst[k], tst[k], k)
        for k in rm:
            bits_equal(rm[k], tm[k], k)


def test_exposure_sweep_reuses_the_proximity_grid(monkeypatch):
    """On the grid backend a step builds one CSR grid, which the
    exposure sweep shares with the proximity phase; its counts equal a
    dense sweep's."""
    _, tc = cfgs(abm=EPI, timesteps=3)
    builds = []
    real = tnb.build_grid
    monkeypatch.setattr(tnb, "build_grid",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    T.Engine(tc, device=CPU).run(seed=1)
    assert len(builds) == 3
    st = T.Engine(tc, device=CPU).init(seed=1).state
    snd = torch.rand(tc.abm.n_se,
                     generator=torch.Generator().manual_seed(0)) < 0.5
    labels = ((st["epi"] > 0) & snd).to(torch.int32)
    got, ovf = tabm.epidemic_exposure_overflow(st["pos"], labels,
                                               st["epi"] == 0, tc.abm)
    dense = dataclasses.replace(tc.abm, proximity_backend="dense")
    want, _ = tabm.epidemic_exposure_overflow(st["pos"], labels,
                                              st["epi"] == 0, dense)
    assert torch.equal(got, want) and not bool(ovf)
    assert int(got.sum()) > 0


# --- environments -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["shm", "lan", "wan2", "hetero"])
@pytest.mark.parametrize("n_lp", [1, 4, 6])
def test_env_presets_equal_reference(kind, n_lp):
    r, t = rcm.make_env(kind, n_lp), tcm.make_env(kind, n_lp)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    assert r.capacity_shares() == t.capacity_shares()


def _counters(seed, L, with_mig=True):
    r = np.random.default_rng(seed)
    c = {"lp_flows": r.integers(0, 10_000, (L, L)).tolist(),
         "local_msgs": 1.0, "remote_msgs": 2.0,
         "migrations": float(r.integers(0, 500)),
         "heu_evals": float(r.integers(0, 100_000))}
    if with_mig:
        c["mig_flows"] = r.integers(0, 50, (L, L)).tolist()
    return c


@pytest.mark.parametrize("kind", ["shm", "lan", "wan2", "hetero"])
@pytest.mark.parametrize("with_mig", [True, False])
def test_wct_env_equal_reference(kind, with_mig):
    c = _counters(len(kind), 4, with_mig)
    c["wire_flows"] = np.random.default_rng(1).integers(
        0, 1 << 20, (2, 2)).tolist()
    for setup in ("PARALLEL", "DISTRIBUTED"):
        want = rcm.wct_env(c, getattr(rcm, setup), rcm.make_env(kind, 4),
                           1200, interaction_bytes=100,
                           migration_bytes=256)
        got = tcm.wct_env(c, getattr(tcm, setup), tcm.make_env(kind, 4),
                          1200, interaction_bytes=100, migration_bytes=256)
        assert want == got


def test_env_errors_equal_reference():
    for mod in (rcm, tcm):
        with pytest.raises(ValueError, match="env kind"):
            mod.make_env("moon", 4)
        with pytest.raises(ValueError, match="lp_flows shape"):
            mod.wct_env(_counters(0, 3), mod.DISTRIBUTED,
                        mod.make_env("lan", 4), 10)
        with pytest.raises(ValueError, match="square"):
            mod.wire_cost([[1, 2]], mod.make_env("lan", 4))


def test_env_drives_asymmetric_balance_exact():
    """EngineConfig(env=hetero, balance='asymmetric'): the capacity
    profile comes from the env's speeds; 40 steps exact."""
    rc, tc = cfgs(env="hetero", balance="asymmetric", timesteps=40)
    assert tc.effective_capacity() == rc.effective_capacity() == \
        (2 / 4.5, 1 / 4.5, 1 / 4.5, 0.5 / 4.5)
    (rst, rser, rcnt), (tst, tser, tcnt) = run_both(rc, tc, seed=2)
    assert_integer_series_equal(rser, tser)
    bits_equal(rst["lp"], tst["lp"])
    assert tcnt["migrations"] > 0
    for kind in ("shm", "lan", "wan2", "hetero"):
        assert rcm.wct_env(rcnt, rcm.DISTRIBUTED, rcm.make_env(kind, 4),
                           40) == tcm.wct_env(tcnt, tcm.DISTRIBUTED,
                                              tcm.make_env(kind, 4), 40)
