"""The port's LP-per-device engine (`repro_torch.parallel.lp_shard`) on
the CPU:

- bit for bit the port's own oracle (`sharding="none"`): the unsharded
  final state and every oracle series, at D = 1, 2 and 4, on every
  scenario the reference shards (its own SYM world included), with
  `shard_overflow` 0;
- against the reference's oracle with slice 1's tolerances (integers
  exact, positions within one ULP of `area` a step). The reference's
  own sharded program is held only on teacher-forced steps of the
  models where it is green (hotspot, group): its rwp position update
  is not fused into the FMA its oracle computes (ROADMAP queue 3);
- the layout (`make_shard_spec`) and its misuse as the reference's,
  batches, the service's churn and queries, the tuner, and the sharded
  ledger against the reference's (the trace: `test_torch_obs.py`).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.obs.config import ObsConfig as RObs  # noqa: E402
from repro.obs.events import MemorySink as RSink  # noqa: E402
from repro.parallel import lp_shard as RL  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.obs.config import ObsConfig as TObs  # noqa: E402
from repro_torch.obs.events import MemorySink as TSink  # noqa: E402
from repro_torch.parallel import lp_shard as TL  # noqa: E402
from repro_torch.parallel.mesh import LPMesh  # noqa: E402

from torch_parity import (CPU, INT_SERIES, bits_equal, cfgs,  # noqa: E402
                          ref_numpy)

STATE_KEYS = ("pos", "waypoint", "mob", "mob_g", "lp", "epi", "pending_dst",
              "pending_eta", "ring", "ptr", "since_eval", "last_mig")
#: the reference's own sharding world (tests/test_sharding.py:21-24)
SYM_ABM = dict(n_se=96, n_lp=4, area=1000.0, speed=5.0,
               interaction_range=80.0, p_interact=0.3)
CLUSTER = dict(n_groups=4, group_radius=120.0)
HEU = dict(mf=1.2, mt=5)
#: a synthetic trace of the small world, registered in both packages
TRACE = "sharding-world"
_trace = rpipe.synthetic_trace(rpipe.TraceSpec(
    n_se=400, area=1000.0, timesteps=30, speed=8.0, n_hubs=4, seed=2))
rpipe.register_trace(TRACE, _trace)
tpipe.register_trace(TRACE, tpipe.Trace(_trace.frames.copy(), _trace.area))
#: the worlds the reference runs sharded, each as cfgs() fields
WORLDS = {
    "sym": dict(abm=SYM_ABM, heuristic=HEU, timesteps=24),
    "asym": dict(abm=SYM_ABM, heuristic=dict(mf=0.8, mt=2),
                 balance="asymmetric", capacity=(0.4, 0.3, 0.2, 0.1),
                 timesteps=24),
    "rwp": dict(heuristic=HEU, timesteps=16),
    "hotspot": dict(abm=dict(mobility="hotspot", **CLUSTER), heuristic=HEU,
                    timesteps=16),
    "group": dict(abm=dict(mobility="group", **CLUSTER), heuristic=HEU,
                  timesteps=16),
    "flock": dict(abm=dict(mobility="flock", **CLUSTER), heuristic=HEU,
                  timesteps=16),
    "trace": dict(abm=dict(mobility="trace", trace_name=TRACE,
                           trace_policy="loop"), heuristic=HEU,
                  timesteps=16),
    "epidemic": dict(abm=dict(workload="epidemic", epi_beta=0.3,
                              epi_gamma=0.05), heuristic=HEU, timesteps=16),
    "dense": dict(abm=dict(SYM_ABM, proximity_backend="dense"),
                  heuristic=HEU, timesteps=16),
    "heuristic2": dict(heuristic=dict(kind=2, omega=8, **HEU), timesteps=16),
    "kmeans": dict(abm=dict(partitioner="kmeans", mobility="hotspot",
                            **CLUSTER), heuristic=HEU, repartition_every=6,
                   timesteps=16),
}
SEED = 7


def _sharded(tc, D, **kw):
    return dataclasses.replace(tc, sharding="lp_device", n_devices=D, **kw)


def _numpy(run):
    st, ser, cnt = run
    return (teng.state_to_numpy(st), {k: v.numpy() for k, v in ser.items()},
            cnt)


@functools.lru_cache(maxsize=None)
def _port_oracle(world):
    _, tc = cfgs(**WORLDS[world])
    return _numpy(T.Engine(tc, device=CPU).run(seed=SEED))


@functools.lru_cache(maxsize=None)
def _port_sharded(world, D):
    _, tc = cfgs(**WORLDS[world])
    return _numpy(T.Engine(_sharded(tc, D), device=CPU).run(seed=SEED))


def _assert_equal_runs(a, b, keys=STATE_KEYS):
    (sa, sera, ca), (sb, serb, cb) = a, b
    for k in keys:
        bits_equal(sa[k], sb[k], k)
    for k in sera:
        if k in serb:
            bits_equal(sera[k], serb[k], k)
    for k in ("local_msgs", "remote_msgs", "migrations", "heu_evals",
              "repartitions", "lp_flows", "mig_flows"):
        assert ca[k] == cb[k], k


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_bit_equals_port_oracle(world, D):
    sharded = _port_sharded(world, D)
    _assert_equal_runs(_port_oracle(world), sharded)
    _, ser, cnt = sharded
    assert cnt["shard_overflow"] == 0.0
    assert cnt["migrations"] > 0
    assert (cnt["bytes_on_wire"] > 0) == (D > 1)
    assert set(ser) >= {"halo_frac", "bytes_on_wire", "wire_flows",
                        "shard_overflow"} and "grid_overflow" not in ser


@pytest.mark.parametrize("world", list(WORLDS))
def test_sharded_against_reference_oracle(world):
    rc, _ = cfgs(**WORLDS[world])
    rst, rser, rcnt = R.Engine(rc).run(seed=SEED)
    rst, rser = ref_numpy(rst), {k: np.asarray(v) for k, v in rser.items()}
    tst, tser, tcnt = _port_sharded(world, 4)
    for k in INT_SERIES + ("lcr",):
        if k in rser and k in tser:
            bits_equal(rser[k], tser[k], k)
    for k in ("lp", "pending_dst", "pending_eta", "ring", "last_mig", "epi"):
        bits_equal(rst[k], tst[k], k)
    area = rc.abm.area
    d = np.abs(rst["pos"] - tst["pos"])
    d = np.minimum(d, area - d)
    assert d.max() <= rc.timesteps * np.spacing(np.float32(area))
    assert rcnt["migrations"] == tcnt["migrations"]


def _ref_layout(rc, D):
    rc = dataclasses.replace(rc, sharding="lp_device", n_devices=D)
    spec = RL.make_shard_spec(rc)
    return rc, spec, RL.make_mesh(spec)


@pytest.mark.parametrize("mobility", ["hotspot", "group"])
def test_teacher_forced_steps_equal_reference_step_sharded(mobility):
    """D = 2: each step from the reference's sharded state, the whole
    state (halo_need and the resharded slots included) and every metric
    (wire_flows, bytes_on_wire, halo_frac, shard_overflow) bit for
    bit."""
    rc, tc = cfgs(abm=dict(n_se=200, mobility=mobility, **CLUSTER),
                  heuristic=HEU)
    rc, rspec, mesh = _ref_layout(rc, 2)
    tc = _sharded(tc, 2)
    tspec, tmesh = TL.layout(tc)
    assert tspec == dataclasses.replace(
        tspec, **{f: getattr(rspec, f) for f in
                  ("n_dev", "cap", "mig_cap", "halo_cap")})
    rst = RL.init_sharded(jax.random.key(3), rc, rspec)
    tst = TL.init_sharded(trandom.key(3), tc, tspec, CPU, tmesh)
    ref = ref_numpy(rst)
    for k, v in TL.sharded_state_to_numpy(tst, tmesh).items():
        bits_equal(ref[k], v, k)
    step = jax.jit(lambda s: RL.step_sharded(s, rc, rspec, mesh))
    moved = 0
    for _ in range(12):
        carried = TL.sharded_state_from_numpy(ref_numpy(rst), tspec, CPU)
        tnew, tm = TL.step_sharded(carried, tc)
        rst, rm = step(rst)
        for k, v in TL.sharded_state_to_numpy(tnew, tmesh).items():
            bits_equal(ref_numpy(rst)[k], v, k)
        for k, v in rm.items():
            bits_equal(np.asarray(v), tm[k].numpy(), k)
        moved += int(np.asarray(rm["migrations"]))
    assert moved > 0 and float(rm["bytes_on_wire"]) > 0


# ---------------------------------------------------------------------------
# the layout and its misuse
# ---------------------------------------------------------------------------

SPECS = [dict(n_devices=d, **kw) for d in (1, 2, 4) for kw in (
    {}, {"mem_budget_mb": 1}, {"mem_budget_mb": 64},
    {"shard_capacity": 300, "mig_capacity": 40, "halo_capacity": 50},
    {"mig_capacity": 10_000})]


@pytest.mark.parametrize("fields", SPECS,
                         ids=lambda f: "-".join(f"{k}{v}" for k, v in
                                                f.items()))
def test_shard_spec_equals_reference(fields):
    for abm in ({}, {"proximity_backend": "dense"}, {"n_lp": 3}):
        rc, tc = cfgs(abm=abm, sharding="lp_device", **fields)
        r, t = RL.make_shard_spec(rc), TL.make_shard_spec(tc)
        assert (t.n_dev, t.n_lp, t.n_se, t.cap, t.mig_cap, t.halo_cap) == \
            (r.n_dev, r.n_lp, r.n_se, r.cap, r.mig_cap, r.halo_cap)
        assert (t.grid is None) == (r.grid is None)
        if t.grid is not None:
            assert (t.grid.ncell, t.grid.capacity) == \
                (r.grid.ncell, r.grid.capacity)


def test_shard_misuse_raises_what_the_reference_raises():
    for abm, eng, call in (
            ({"proximity_backend": "pallas_grid"}, {}, "spec"),
            ({}, {"shard_capacity": 50, "n_devices": 2}, "init")):
        rc, tc = cfgs(abm=abm, sharding="lp_device", **eng)
        with pytest.raises(Exception) as rerr:
            spec = RL.make_shard_spec(rc)
            RL.init_sharded(jax.random.key(0), rc, spec)
        with pytest.raises(type(rerr.value)):
            spec = TL.make_shard_spec(tc)
            TL.init_sharded(trandom.key(0), tc, spec, CPU)


def test_shard_count_must_divide_over_the_processes():
    """The port's deliberate difference (ROADMAP queue 3): no device
    count to exceed, but D shards must split evenly over the world's
    processes; 0 is one shard a process (one without a group)."""
    with pytest.raises(ValueError, match="n_devices=3"):
        LPMesh(n_dev=3, procs=2)
    _, tc = cfgs(sharding="lp_device")
    assert TL.make_shard_spec(tc).n_dev == 1
    _, tc = cfgs(sharding="lp_device", n_devices=16)
    assert TL.make_shard_spec(tc).n_dev == 4  # never more than n_lp


def test_mesh_collectives_on_one_process():
    mesh = LPMesh(n_dev=3)
    x = torch.arange(24).view(3, 4, 2)  # (Dl, D?, ...) per shard
    assert torch.equal(mesh.psum(torch.ones(2, 3, dtype=torch.int32), 1),
                       torch.full((2,), 3, dtype=torch.int32))
    assert mesh.all_gather(x) is x
    send = torch.arange(3 * 3 * 2).view(3, 3, 2)  # [src, dst, row]
    recv = mesh.all_to_all(send)
    for s in range(3):
        for d in range(3):
            assert torch.equal(recv[d, s], send[s, d])
    assert torch.equal(mesh.axis_index(CPU), torch.arange(3,
                                                          dtype=torch.int32))


# ---------------------------------------------------------------------------
# batches, the service, the tuner
# ---------------------------------------------------------------------------


def test_batch_replicas_equal_their_solo_sharded_runs():
    _, tc = cfgs(**WORLDS["kmeans"])
    tc = _sharded(tc, 2)
    states, series, reps = T.Engine(tc, device=CPU).run(seeds=[SEED, 8])
    for r, seed in enumerate((SEED, 8)):
        st, ser, cnt = T.Engine(tc, device=CPU).run(seed=seed)
        for k in STATE_KEYS:
            bits_equal(states[k][r].numpy(), st[k].numpy(), k)
        for k in ser:
            bits_equal(series[k][:, r].contiguous().numpy(), ser[k].numpy(), k)
        assert reps[r] == cnt
    assert reps[0]["repartitions"] > 0


def test_replica_service_requests_equal_their_solo_runs():
    """Slots at their own steps (a tuple `t`), repartitions at each
    slot's own boundary."""
    _, tc = cfgs(**WORLDS["kmeans"])
    tc = _sharded(tc, 2)
    svc = T.ReplicaService(tc, n_slots=2, device=CPU)
    jobs = ((5, 12), (6, 20), (7, 9))
    for seed, steps in jobs:
        svc.submit(seed=seed, steps=steps)
    res = svc.drain()
    for rid, (seed, steps) in enumerate(jobs):
        solo = T.Engine(dataclasses.replace(tc, timesteps=steps),
                        device=CPU).run(seed=seed)[2]
        for k in ("migrations", "local_msgs", "remote_msgs",
                  "repartitions", "bytes_on_wire", "lp_flows",
                  "wire_flows"):
            assert res[rid][k] == solo[k], k


def _churn(engine, windows=4, batch=12):
    """A seeded churn script: per window, depart, arrive, two steps;
    then the three queries. Returns every observable."""
    g = np.random.default_rng(0)
    out = []
    for _ in range(windows):
        engine.depart(g.choice(engine.live_ids(), batch,
                               replace=False).tolist())
        ids = engine.arrive({"pos": g.uniform(
            0, 1000.0, (batch, 2)).astype(np.float32)})
        c = engine.step(2)
        out.append((ids, c["migrations"], c["local_msgs"], c["mean_pop"]))
    q = engine.live_ids()[:6]
    return (out, engine.query_neighbors(q), engine.query_lcr(),
            engine.query_region((100, 100, 400, 900)),
            engine.query_region((900, 0, 100, 1000)))


def test_sharded_churn_and_queries_equal_the_reference():
    rc, tc = cfgs(abm=dict(mobility="hotspot", **CLUSTER), heuristic=HEU,
                  open_world=True, n_active=380)
    rc = dataclasses.replace(rc, sharding="lp_device", n_devices=4)
    got = _churn(T.Engine(_sharded(tc, 4), device=CPU).init(seed=1))
    want = _churn(R.Engine(rc).init(seed=1))
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    # and the port's oracle (an SE's id is its slot there)
    assert _churn(T.Engine(tc, device=CPU).init(seed=1)) == got


def test_sharded_arrival_without_a_free_slot_is_loud():
    """Arrivals bound for a full shard: the admitted ones are applied,
    the rest go back to the free pool, and the call raises naming
    shard_capacity, as the reference's."""
    _, tc = cfgs(open_world=True, n_active=250, sharding="lp_device",
                 n_devices=2, shard_capacity=230)
    eng = T.Engine(tc, device=CPU).init(seed=0)
    free0 = int((eng.state["gid"][0] < 0).sum())
    with pytest.raises(RuntimeError, match="shard_capacity"):
        eng.arrive({"pos": np.full((free0 + 5, 2), 10.0, np.float32),
                    "lp": np.zeros(free0 + 5, np.int32)})
    assert eng.population() == 250 + free0
    assert int((eng.state["gid"] >= 0).sum()) == 250 + free0
    eng.step(2)  # the state stays usable


def test_sharded_tuner_equals_the_oracle_tuner():
    _, tc = cfgs(heuristic=HEU, timesteps=40)
    stc = T.SelfTuneConfig(window=10)
    s0, h0 = T.intra_run_tune(trandom.key(0), tc, stc, device=CPU)
    s1, h1 = T.intra_run_tune(trandom.key(0), _sharded(tc, 2), stc,
                              device=CPU)
    assert h0 == h1
    for k in STATE_KEYS:
        bits_equal(s0[k].numpy(), s1[k].numpy(), k)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def test_sharded_ledger_and_events_equal_the_reference():
    rc, tc = cfgs(abm=dict(mobility="hotspot", **CLUSTER), heuristic=HEU,
                  sharding="lp_device", n_devices=2)
    rc = dataclasses.replace(rc, obs=RObs(enabled=True, drain_every=4))
    tc = dataclasses.replace(tc, obs=TObs(enabled=True, drain_every=4))
    re = R.Engine(rc, obs_sinks=[RSink()]).init(seed=2)
    te = T.Engine(tc, device=CPU, obs_sinks=[TSink()]).init(seed=2)
    for n in (3, 7, 4):
        assert re.step(n)["migrations"] == te.step(n)["migrations"]
    rrows, trows = re.ledger().rows(), te.ledger().rows()
    assert te.ledger().keys == re.ledger().keys
    assert "shard_overflow" in te.ledger().keys and len(trows) == 14
    np.testing.assert_array_equal(rrows, trows)
    assert [(e.kind, e.step) for e in re.events()] == \
        [(e.kind, e.step) for e in te.events()]
