"""The port's resident service against `repro.core.service`, on the CPU:
open-world churn, the device-state queries and `ReplicaService`, at the
reference's own test sizes (160-400 SEs).

Tolerances, as the engine's slice-1 tests hold them: every integer
output exactly (the per-step series, `pop` included, `lp`, the
returned ids, the query answers, the requests' counters); positions
within one ULP of `area` a step, and within 1e-5 * area over a run of
up to 50 steps (XLA's CPU `sqrt` is not correctly rounded on every CPU;
see tests/test_torch_engine.py). The flock's floats are not bitwise
(tests/test_torch_scenarios.py), so its integers are held on
teacher-forced steps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import engine as reng  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402

from torch_parity import (CPU, INT_SERIES, bits_equal, cfgs,  # noqa: E402
                          ref_numpy)

ULP = 2.0 ** -23
#: the counters a request's solo run fixes
COUNTERS = ("migrations", "local_msgs", "remote_msgs", "heu_evals",
            "repartitions")
#: tests/test_service.py's world: 160 SEs, 4 LPs, area 3,162, range 250
SERVICE = {"n_se": 160, "area": 3162.0, "interaction_range": 250.0}
SCENARIOS = {"rwp": {}, "epidemic": {"workload": "epidemic"},
             "hotspot": {"mobility": "hotspot"}}
BALANCES = {"symmetric": {},
            "asymmetric": {"balance": "asymmetric",
                           "capacity": (0.4, 0.3, 0.2, 0.1)}}


def _ints_equal(rser, tser, what):
    """Every integer series of one window, `pop` included."""
    for k in INT_SERIES + ("pop",):
        if k in rser:
            bits_equal(np.asarray(rser[k]), tser[k].numpy(), (what, k))


def _states_close(rst, tst, area, steps, what):
    """Integer leaves exact, positions within the run's tolerance."""
    tol = min(steps * area * ULP, 1e-5 * area)
    r, t = ref_numpy(rst), teng.state_to_numpy(tst)
    assert r.keys() == t.keys()
    for k in r:
        if k in ("pos", "waypoint", "mob", "mob_g"):
            assert np.abs(r[k] - t[k]).max() <= tol, (what, k)
        else:
            bits_equal(r[k], t[k], (what, k))


def _window(re, te, rc, tc, n):
    """Step both engines' resident states n steps; (reference series,
    port series)."""
    re.state, rser = reng._compiled_window(rc, n)(
        re.state, jnp.float32(rc.heuristic.mf))
    te.state, tser = teng._run_steps(te.state, tc, n)
    return rser, tser


def _churn(re, te, rng, n_dep, n_arr, area):
    """The same departures (random live ids) and arrivals (uniform
    positions) on both engines; their returned ids must agree."""
    live = re.live_ids()
    assert live == te.live_ids()
    dep = rng.choice(live, size=n_dep, replace=False).tolist()
    re.depart(dep)
    te.depart(dep)
    pos = (rng.random((n_arr, 2)) * area).astype(np.float32)
    got = (re.arrive({"pos": pos}), te.arrive({"pos": pos}))
    assert got[0] == got[1]
    assert re.population() == te.population()


# --- zero churn ----------------------------------------------------------


@pytest.mark.parametrize("name", ["rwp", "epidemic", "dense"])
def test_zero_churn_equals_closed_world(name):
    """open_world with every slot live: bit for bit the port's closed
    world (state and series; `pop` is the one extra series), and the
    reference's open world within the slice-1 tolerances."""
    abm = {"proximity_backend": "dense"} if name == "dense" else \
        SCENARIOS[name]
    rc, tc = cfgs(abm=abm, timesteps=50, open_world=True)
    tcc = dataclasses.replace(tc, open_world=False)
    ost, oser, oc = T.Engine(tc, device=CPU).run(seed=0)
    cst, cser, _ = T.Engine(tcc, device=CPU).run(seed=0)
    assert oser.keys() - cser.keys() == {"pop"}
    for k in cser:
        bits_equal(oser[k].numpy(), cser[k].numpy(), k)
    for k in cst:
        assert ost[k] == cst[k] if k == "t" else \
            torch.equal(ost[k], cst[k]), k
    assert oc["mean_pop"] == tc.abm.n_se
    rst, rser, rcnt = R.Engine(rc).run(seed=0)
    _ints_equal(rser, oser, name)
    _states_close(rst, ost, tc.abm.area, 50, name)
    assert rcnt["mean_pop"] == oc["mean_pop"]


def test_live_prefix_matches_reference():
    """n_active < n_se: the free slots stay dead (lp -1) and the run
    equals the reference's."""
    rc, tc = cfgs(timesteps=40, open_world=True, n_active=250)
    rst, rser, _ = R.Engine(rc).run(seed=3)
    tst, tser, tcnt = T.Engine(tc, device=CPU).run(seed=3)
    _ints_equal(rser, tser, "prefix")
    _states_close(rst, tst, tc.abm.area, 40, "prefix")
    assert (tst["lp"][250:] == -1).all() and (tst["lp"][:250] >= 0).all()
    assert tcnt["mean_pop"] == 250.0


# --- churn scripts --------------------------------------------------------


@pytest.mark.parametrize("balance", list(BALANCES))
@pytest.mark.parametrize("backend", ["grid", "dense"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_churn_script_equals_reference(scenario, backend, balance):
    """Windows of steps between departures and arrivals, replayed into
    both engines: the same ids, every integer series exact (`pop`
    included), lp exact and positions within tolerance."""
    rc, tc = cfgs(abm={**SCENARIOS[scenario],
                       "proximity_backend": backend},
                  open_world=True, n_active=320, **BALANCES[balance])
    re = R.Engine(rc).init(seed=1)
    te = T.Engine(tc, device=CPU).init(seed=1)
    rng = np.random.default_rng(7)
    steps = 0
    for w, (n_dep, n_arr) in enumerate([(20, 40), (50, 10), (0, 30),
                                        (30, 0)]):
        rser, tser = _window(re, te, rc, tc, 8)
        steps += 8
        _ints_equal(rser, tser, (scenario, w))
        _churn(re, te, rng, n_dep, n_arr, tc.abm.area)
    rser, tser = _window(re, te, rc, tc, 8)
    _ints_equal(rser, tser, (scenario, "last"))
    _states_close(re.state, te.state, tc.abm.area, steps + 8, scenario)
    assert te.population() == 320 - 100 + 80


def test_flock_churn_teacher_forced_integers_exact():
    """The flock with churn: each step carries the reference's state
    (churned between steps) into the port; the step's integer outputs
    and lp are exact."""
    rc, tc = cfgs(abm={"mobility": "flock"}, open_world=True, n_active=300)
    mf = jnp.float32(rc.heuristic.mf)
    ref_step = jax.jit(lambda st: reng.step(st, rc, mf=mf))
    re = R.Engine(rc).init(seed=2)
    rng = np.random.default_rng(5)
    for i in range(12):
        if i % 4 == 3:
            live = re.live_ids()
            re.depart(rng.choice(live, size=15, replace=False).tolist())
            re.arrive({"pos": (rng.random((25, 2)) * 1000).astype(
                np.float32)})
        carried = teng.state_from_numpy(ref_numpy(re.state), CPU)
        tst, tm = teng.step(carried, tc, mf=tc.heuristic.mf)
        re.state, rm = ref_step(re.state)
        _ints_equal({k: np.asarray(v)[None] for k, v in rm.items()},
                    {k: v[None] for k, v in tm.items()}, ("flock", i))
        bits_equal(np.asarray(re.state["lp"]), tst["lp"].numpy(), i)


# --- slot lifecycle and misuse -------------------------------------------


def _service_cfgs(abm=None, **eng):
    """tests/test_service.py's `small_cfg`, in both packages."""
    return cfgs(abm={**SERVICE, **(abm or {})},
                heuristic={"mf": 1.2, "mt": 5}, timesteps=40, **eng)


def test_depart_then_arrive_reuses_clean_slot():
    rc, tc = _service_cfgs(open_world=True, n_active=160)
    te = T.Engine(tc, device=CPU).init(seed=0)
    te.step(12)  # heuristic history accumulates
    victim = 7
    te.depart([victim])
    st = te.state
    assert int(st["lp"][victim]) == -1 and int(st["epi"][victim]) == 0
    assert int(st["ring"][:, victim].sum()) == 0
    assert int(st["pending_dst"][victim]) == -1
    assert int(st["pending_eta"][victim]) == -1
    assert int(st["last_mig"][victim]) == -10**6
    [nid] = te.arrive({"pos": np.asarray([[1.0, 1.0]], np.float32)})
    assert nid == victim  # the only free slot
    st = te.state
    assert int(st["lp"][victim]) == 0  # the x-stripe LP of x = 1
    assert int(st["ring"][:, victim].sum()) == 0
    assert st["pos"][victim].tolist() == [1.0, 1.0]
    assert st["waypoint"][victim].tolist() == [1.0, 1.0]
    re = R.Engine(rc).init(seed=0)
    re.step(12)
    re.depart([victim])
    re.arrive({"pos": np.asarray([[1.0, 1.0]], np.float32)})
    for k in ("lp", "ring", "pending_dst", "last_mig", "epi"):
        bits_equal(np.asarray(re.state[k]), st[k].numpy(), k)


def test_arrive_overflow_is_loud_and_leaves_the_state():
    _, tc = _service_cfgs(open_world=True, n_active=158)
    te = T.Engine(tc, device=CPU).init(seed=0)
    before = {k: v.clone() for k, v in te.state.items() if k != "t"}
    with pytest.raises(RuntimeError, match="free slots"):
        te.arrive({"pos": np.zeros((3, 2), np.float32)})
    assert te.population() == 158
    for k, v in before.items():
        assert torch.equal(te.state[k], v), k
    assert te.arrive({"pos": np.zeros((2, 2), np.float32)}) == [158, 159]


def test_depart_unknown_or_duplicated_id_raises_key_error():
    rc, tc = _service_cfgs(open_world=True, n_active=100)
    for eng in (R.Engine(rc).init(seed=0),
                T.Engine(tc, device=CPU).init(seed=0)):
        with pytest.raises(KeyError):
            eng.depart([150])  # never admitted
        with pytest.raises(KeyError):
            eng.depart([3, 3])  # twice in one batch
        with pytest.raises(KeyError):
            eng.query_neighbors([150])
        assert eng.population() == 100
    assert T.Engine(tc, device=CPU).init(seed=0).arrive(
        {"pos": np.zeros((0, 2))}) == []


# --- queries ---------------------------------------------------------------


def _churned_pair(abm):
    """A reference engine after a churn script, and a port engine that
    holds the same state and free-slot pool."""
    rc, tc = _service_cfgs(open_world=True, n_active=140, abm=abm)
    re = R.Engine(rc).init(seed=0)
    re.step(10)
    rng = np.random.default_rng(11)
    re.depart(rng.choice(re.live_ids(), size=12, replace=False).tolist())
    re.arrive({"pos": (rng.random((6, 2)) * 3000).astype(np.float32)})
    re.step(5)
    te = T.Engine(tc, device=CPU).init(seed=0)
    te.state = teng.state_from_numpy(ref_numpy(re.state), CPU)
    te._live, te._free = set(re._live), list(re._free)
    return re, te


@pytest.mark.parametrize("backend", ["grid", "dense"])
def test_queries_equal_reference(backend):
    re, te = _churned_pair({"proximity_backend": backend})
    ids = te.live_ids()[::9]
    assert te.query_neighbors(ids) == re.query_neighbors(ids)
    assert te.query_lcr() == re.query_lcr()
    a = te.cfg.abm.area
    for box in ((0.0, 0.0, a / 2, a / 2), (a - 500.0, 0.0, 500.0, a),
                (a - 300.0, a - 300.0, 300.0, 300.0)):
        assert te.query_region(box) == re.query_region(box)


# --- ReplicaService -----------------------------------------------------


@pytest.mark.parametrize("eng", [{}, {"repartition_every": 10}],
                         ids=["plain", "repartition"])
def test_replica_service_counters_equal_solo_and_reference(eng):
    """Unequal request lengths over 2 slots (a refilled slot starts at
    t = 0 beside one at its own step): every request's integer counters
    are its solo run's and the reference service's."""
    abm = {"partitioner": "stripe"} if eng else {}
    rc, tc = _service_cfgs(abm=abm, **eng)
    jobs = [(0, 30), (1, 18), (2, 24), (3, 11)]
    rsvc, tsvc = R.ReplicaService(rc, 2), T.ReplicaService(tc, 2,
                                                           device=CPU)
    for s, n in jobs:
        assert rsvc.submit(s, n) == tsvc.submit(s, n)
    rres, tres = rsvc.drain(), tsvc.drain()
    assert rres.keys() == tres.keys() == set(range(len(jobs)))
    for rid, (s, n) in enumerate(jobs):
        _, _, solo = T.Engine(dataclasses.replace(tc, timesteps=n),
                              device=CPU).run(seed=s)
        for k in COUNTERS:
            assert tres[rid][k] == solo[k] == rres[rid][k], (rid, k)
    if eng:
        assert sum(tres[r]["repartitions"] for r in tres) > 0
    assert tsvc.prometheus().splitlines()[:6] == \
        rsvc.prometheus().splitlines()[:6]


def test_unequal_steps_round_trip_through_the_reference():
    """A batch at unequal steps (a service's state) carries to the
    reference's (R,) `t` and back, and one step from it equals the
    reference's vmapped step, replica by replica."""
    rc, tc = _service_cfgs(abm={"partitioner": "stripe"},
                           repartition_every=4)
    subs = []
    for seed, n in ((0, 4), (1, 7), (2, 0)):
        e = T.Engine(tc, device=CPU).init(seed=seed)
        if n:
            e.step(n)
        subs.append(e.state)
    st = teng.stack_states(subs)
    assert st["t"] == (4, 7, 0)
    arrays = teng.state_to_numpy(st)
    assert arrays["t"].tolist() == [4, 7, 0]
    back = teng.state_from_numpy(arrays, CPU)
    assert back["t"] == (4, 7, 0)
    rst = {k: jax.random.wrap_key_data(jnp.asarray(v)) if k == "key"
           else jnp.asarray(v) for k, v in arrays.items()}
    mfs = jnp.full((3,), rc.heuristic.mf, jnp.float32)
    rst, rm = jax.jit(jax.vmap(lambda s, m: reng.step(s, rc, mf=m)))(
        rst, mfs)
    tst, tm = teng.step(back, tc, mf=tc.heuristic.mf)
    _ints_equal({k: np.asarray(v)[None] for k, v in rm.items()},
                {k: v[None] for k, v in tm.items()}, "vmapped step")
    assert int(tm["repartitions"][0]) > 0 and int(
        tm["repartitions"][1]) == 0
    _states_close(rst, tst, tc.abm.area, 1, "vmapped step")
