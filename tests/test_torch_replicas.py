"""Replica batches: the port's `Engine.run(seeds=...)` against the
reference's `run_batch`, on the CPU, at `tests/test_replicas.py`'s
sizes (96 SEs, seeds 3, 7 and 11) and on its hotspot, epidemic and flock
variants.

Tolerances, as the solo slices hold them (`tests/test_torch_engine.py`
says why): every integer series, the final `lp`, the pending migrations
and the heuristic state exactly, and each replica's key bit for bit;
positions within `1e-5 * area` after the free-running steps (one ULP of
`area` a step on teacher-forced steps); `mean_lcr` and `mean_infected`
within their float32 summation bound. The flock is held on teacher-forced steps (its float32
headings are not XLA's): every metric and integer state exact. Replica
independence and per-replica MFs are held against the reference too;
the batch against the port's own solo runs, bit for bit, is
`tests/test_torch_replica_kernels.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference runs beside the port

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import engine as reng  # noqa: E402
from repro.core import stats as rstats  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402

from torch_parity import CPU, INT_SERIES, bits_equal, ref_numpy  # noqa: E402

SEEDS = (3, 7, 11)
#: tests/test_replicas.py's ABM and engine fields
ABM = dict(n_se=96, n_lp=4, area=1000.0, speed=5.0, interaction_range=80.0,
           p_interact=0.3)
ENG = dict(heuristic=dict(mf=1.2, mt=5), gaia_on=True, timesteps=24)
VARIANTS = {
    "rwp": ({}, {}),
    "hotspot": (dict(mobility="hotspot", n_groups=4, group_radius=120.0),
                dict(timesteps=16)),
    "epidemic": (dict(workload="epidemic", epi_gamma=0.05), {}),
}
EXACT_STATE = ("lp", "pending_dst", "pending_eta", "ring", "ptr",
               "since_eval", "last_mig", "epi")
ULP = 2.0 ** -23


def _cfgs(abm=None, **eng):
    abm = {**ABM, **(abm or {})}
    eng = {**ENG, **eng}
    heu = eng.pop("heuristic")
    return (R.EngineConfig(abm=R.ABMConfig(**abm),
                           heuristic=R.HeuristicConfig(**heu), **eng),
            T.EngineConfig(abm=T.ABMConfig(**abm),
                           heuristic=T.HeuristicConfig(**heu), **eng))


def _ref_batch(rc, seeds):
    st, ser, reps = R.Engine(rc).run(seeds=list(seeds))
    return ref_numpy(st), {k: np.asarray(v) for k, v in ser.items()}, reps


def _port_batch(tc, seeds):
    st, ser, reps = T.Engine(tc, device=CPU).run(seeds=list(seeds))
    return teng.state_to_numpy(st), {k: v.numpy() for k, v in ser.items()}, \
        reps


def _assert_counters_match(rc_reps, tc_reps, steps):
    assert len(rc_reps) == len(tc_reps)
    for want, got in zip(rc_reps, tc_reps):
        assert want.keys() == got.keys()
        for k, v in want.items():
            if k in ("mean_lcr", "mean_infected"):  # float32 means
                assert abs(v - got[k]) <= 2 * steps * 2.0 ** -24 * v
            else:
                assert v == got[k], k


@pytest.mark.parametrize("name", list(VARIANTS))
def test_run_batch_equals_reference(name):
    abm, eng = VARIANTS[name]
    rc, tc = _cfgs(abm, **eng)
    rst, rser, rreps = _ref_batch(rc, SEEDS)
    tst, tser, treps = _port_batch(tc, SEEDS)
    assert rser.keys() == tser.keys()
    for k in INT_SERIES:
        if k in rser:
            bits_equal(rser[k], tser[k], k)
    assert rst.keys() == tst.keys()
    bits_equal(rst["key"], tst["key"], "key")
    bits_equal(rst["t"], tst["t"], "t")
    for k in EXACT_STATE:
        bits_equal(rst[k], tst[k], k)
    assert np.abs(rst["pos"] - tst["pos"]).max() <= 1e-5 * rc.abm.area
    _assert_counters_match(rreps, treps, rc.timesteps)
    assert sum(c["migrations"] for c in treps) > 0


def test_flock_batch_teacher_forced_integer_outputs_exact():
    """The flock batch, each of 8 steps from the reference's batched
    state (its vmapped step, jitted): every metric exact, the integer
    state bit for bit, positions within one ULP of area."""
    rc, tc = _cfgs(dict(mobility="flock", n_groups=4, group_radius=60.0))
    mf = jnp.float32(rc.heuristic.mf)
    ref_step = jax.jit(jax.vmap(lambda st: reng.step(st, rc, mf=mf)))
    rst = R.Engine(rc).init(seeds=list(SEEDS)).state
    migrations = 0
    for _ in range(8):
        carried = teng.state_from_numpy(ref_numpy(rst), CPU)
        tst, tm = teng.step(carried, tc)
        rst, rm = ref_step(rst)
        want, got = ref_numpy(rst), teng.state_to_numpy(tst)
        for k in rm:
            bits_equal(np.asarray(rm[k]), tm[k].numpy(), k)
        for k in ("lp", "pending_dst", "pending_eta", "ring", "mob_g", "key",
                  "t"):
            bits_equal(want[k], got[k], k)
        assert np.abs(want["pos"] - got["pos"]).max() <= \
            rc.abm.area * ULP
        migrations += int(tm["migrations"].sum())
    assert migrations > 0


def test_seed_permutation_permutes_replicas():
    """Replica independence: permuting the seeds permutes every output,
    and the reference agrees."""
    rc, tc = _cfgs()
    sa, ser_a, reps_a = _port_batch(tc, (3, 7, 11))
    sb, ser_b, reps_b = _port_batch(tc, (11, 3, 7))
    perm = [1, 2, 0]  # where (3, 7, 11)'s replicas sit in batch b
    for k in ("pos", "waypoint", "lp", "ring", "key", "pending_dst"):
        bits_equal(sa[k], sb[k][perm], k)
    for k in ser_a:
        bits_equal(ser_a[k], ser_b[k][:, perm], k)
    for r, p in enumerate(perm):
        assert reps_a[r] == reps_b[p]
    assert reps_a[0] != reps_a[1]
    _, _, ref_b = _ref_batch(rc, (11, 3, 7))
    _assert_counters_match(ref_b, reps_b, rc.timesteps)


def test_per_replica_mf_vector():
    """Two replicas of one seed under MF (0.6, 8.0): each window is the
    reference's batched window and the port's solo window at that MF."""
    rc, tc = _cfgs()
    mfs = (0.6, 8.0)
    rstates = R.Engine(rc).init(seeds=[5, 5]).state
    _, rreps = reng._run_window_batch(rstates, rc, 16,
                                      mf=jnp.asarray(mfs, jnp.float32))
    eng = T.Engine(tc, device=CPU).init(seeds=[5, 5])
    treps = eng.step(16, mf=mfs)
    _assert_counters_match(rreps, treps, 16)
    for r, mf in enumerate(mfs):
        solo = T.Engine(tc, device=CPU).init(seed=5)
        assert solo.step(16, mf=mf) == treps[r]
    assert treps[0]["migrations"] > treps[1]["migrations"]


def test_batched_draws_equal_jax_vmap():
    jk = jnp.stack([jax.random.key(s) for s in SEEDS])
    tk = trandom.keys(SEEDS)
    bits_equal(np.asarray(jax.random.key_data(jk)), tk.numpy().astype(
        np.uint32), "keys")
    js = jax.vmap(lambda k: jax.random.split(k, 3))(jk)
    bits_equal(np.asarray(jax.random.key_data(js)).transpose(1, 0, 2),
               trandom.split(tk, 3).numpy().astype(np.uint32), "split")
    jf = jax.vmap(lambda k: jax.random.fold_in(k, 0x7a47))(jk)
    bits_equal(np.asarray(jax.random.key_data(jf)),
               trandom.fold_in(tk, 0x7a47).numpy().astype(np.uint32),
               "fold_in")
    ju = jax.vmap(lambda k: jax.random.uniform(k, (300, 2), maxval=1e4))(jk)
    bits_equal(np.asarray(ju), trandom.uniform(tk, (300, 2),
                                               maxval=1e4).numpy(), "uniform")
    jb = jax.vmap(lambda k: jax.random.bernoulli(k, 0.2, (777,)))(jk)
    bits_equal(np.asarray(jb), trandom.bernoulli(tk, 0.2, (777,)).numpy(),
               "bernoulli")


def test_batched_init_and_state_carry_equal_reference():
    """`init(seeds=...)` is the reference's stacked eager init, and a
    batched state crosses between the packages and back unchanged."""
    rc, tc = _cfgs(dict(mobility="hotspot", n_groups=4, group_radius=120.0))
    want = ref_numpy(R.Engine(rc).init(seeds=list(SEEDS)).state)
    got = teng.state_to_numpy(T.Engine(tc, device=CPU).init(
        seeds=list(SEEDS)).state)
    assert want.keys() == got.keys()
    for k in want:
        bits_equal(want[k], got[k], k)
    back = teng.state_to_numpy(teng.state_from_numpy(want, CPU))
    for k in want:
        bits_equal(want[k], back[k], k)


def test_stats_equal_reference():
    reps = [{"mean_lcr": 0.5, "migrations": 10.0, "grid_overflow": False,
             "lp_flows": [[1, 2]]},
            {"mean_lcr": 0.7, "migrations": 14.0, "grid_overflow": True,
             "lp_flows": [[3, 4]]},
            {"mean_lcr": 0.65, "migrations": 11.0, "grid_overflow": False,
             "lp_flows": [[3, 4]]}]
    assert tstats.summarize(reps) == rstats.summarize(reps)
    for obj in (tstats.summarize(reps)["mean_lcr"], {"mean": 1.0},
                {"any": True, "count": 1, "n": 3}):
        assert tstats.is_stats(obj) == rstats.is_stats(obj)
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6]
    for q in (0.0, 12.5, 50.0, 99.0, 100.0):
        assert tstats.percentile(xs, q) == rstats.percentile(xs, q)
    for bad in (([], 50.0), (xs, 101.0)):
        with pytest.raises(ValueError):
            rstats.percentile(*bad)
        with pytest.raises(ValueError):
            tstats.percentile(*bad)


def test_batch_window_counters_merge_as_the_run():
    """Windows of a batched engine merge into the batched run's
    counters (the reference's `metrics()` contract)."""
    _, tc = _cfgs()
    _, _, run_reps = T.Engine(tc, device=CPU).run(seeds=list(SEEDS))
    eng = T.Engine(tc, device=CPU).init(seeds=list(SEEDS))
    eng.step(10)
    eng.step(14)
    for got, want in zip(eng.metrics(), run_reps):
        for k in ("local_msgs", "remote_msgs", "migrations", "heu_evals",
                  "lp_flows", "mig_flows", "grid_overflow",
                  "migration_ratio"):
            assert got[k] == want[k], k
        assert got["mean_lcr"] == pytest.approx(want["mean_lcr"], rel=1e-6)
