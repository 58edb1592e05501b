"""The port's engine against `repro.core`, on the CPU, at small sizes.

Both packages get the same inputs: configs built from one dict of
fields, states carried across with `state_from_numpy`, seeds fixed here.

Tolerances. Every integer output is held exactly: counts, flows,
migration flows, admitted migrations, `pending_*`, `lp`, the heuristic
ring and the counters. Positions are held to one ULP of `area`
(`area * 2**-23`) per step and to `1e-5 * area` over 50 free-running
steps, not to bits: the port computes every float32 operation correctly
rounded (FMAs where XLA fuses), while XLA's CPU `sqrt` is not correctly
rounded on every CPU (on one, 1 ULP off on 1,327 of 200,000 random
inputs, measured with JAX 0.9.0), and one rwp step can then leave a
position one ULP of `area` apart; over 50 free-running steps that drift
was measured there at up to 2.9e-7 * area. `mean_lcr` is a float32 mean
whose summation order differs between XLA and PyTorch; two orders of n
terms (n - 1 additions and a division each) differ by at most
2 * n * 2**-24 of the mean, its tolerance.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import abm as rabm  # noqa: E402
from repro.core import balance as rbal  # noqa: E402
from repro.core import engine as reng  # noqa: E402
from repro.core import heuristics as rheu  # noqa: E402
from repro.core import partition as rpart  # noqa: E402
from repro.obs.config import ObsConfig as RObs  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import abm as tabm  # noqa: E402
from repro_torch.core import balance as tbal  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import heuristics as theu  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.obs.config import ObsConfig as TObs  # noqa: E402

CPU = torch.device("cpu")
ULP = 2.0 ** -23
INT_SERIES = ("local_msgs", "remote_msgs", "migrations", "heu_evals",
              "lp_flows", "mig_flows", "repartitions", "grid_overflow")


def _cfgs(abm=None, heuristic=None, **eng):
    """One dict of fields -> (reference config, port config)."""
    abm = {"n_se": 300, "area": 1000.0, "interaction_range": 60.0,
           **(abm or {})}
    heuristic = heuristic or {}
    return (R.EngineConfig(abm=R.ABMConfig(**abm),
                           heuristic=R.HeuristicConfig(**heuristic), **eng),
            T.EngineConfig(abm=T.ABMConfig(**abm),
                           heuristic=T.HeuristicConfig(**heuristic), **eng))


def _ref_numpy(st):
    return {k: np.asarray(jax.random.key_data(v)) if k == "key"
            else np.asarray(v) for k, v in st.items()}


def _bits_equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8)), what


# --- configs ---------------------------------------------------------------


@pytest.mark.parametrize("pair", [
    (R.ABMConfig, T.ABMConfig), (R.HeuristicConfig, T.HeuristicConfig),
    (rpart.PartitionConfig, tpart.PartitionConfig),
    (R.EngineConfig, T.EngineConfig), (RObs, TObs),
    (R.GridSpec, T.GridSpec)], ids=lambda p: p[0].__name__)
def test_configs_share_fields_and_defaults(pair):
    ref, port = pair
    rf = {f.name: f.default for f in dataclasses.fields(ref)}
    pf = {f.name: f.default for f in dataclasses.fields(port)}
    assert rf.keys() == pf.keys()
    for k, v in rf.items():
        w = pf[k]
        if dataclasses.is_dataclass(v):
            assert dataclasses.asdict(v) == dataclasses.asdict(w), k
        else:
            assert v == w, k


BAD = [
    ("abm", {"proximity_backend": "typo"}), ("abm", {"n_se": 0}),
    ("abm", {"area": -1.0}), ("abm", {"p_interact": 1.5}),
    ("abm", {"grid_capacity": -1}), ("abm", {"mobility": "warp"}),
    ("abm", {"mobility": "hotspot", "n_groups": 0}),
    ("abm", {"mobility": "trace"}), ("abm", {"trace_policy": "x"}),
    ("abm", {"workload": "x"}), ("abm", {"partitioner": "x"}),
    ("abm", {"workload": "epidemic", "proximity_backend": "pallas"}),
    ("abm", {"workload": "epidemic", "epi_beta": 2.0}),
    ("abm", {"speed": -1.0}), ("abm", {"use_pallas": True}),
    ("heu", {"kind": 4}), ("heu", {"mf": -1.0}), ("heu", {"mt": -1}),
    ("heu", {"kappa": 0}),
    ("eng", {"sharding": "x"}), ("eng", {"balance": "x"}),
    ("eng", {"timesteps": -1}), ("eng", {"migration_delay": 0}),
    ("eng", {"n_devices": -1}), ("eng", {"repartition_every": -1}),
    ("eng", {"balance": "asymmetric"}), ("eng", {"n_active": 5}),
    ("eng", {"halo_capacity": 1 << 20, "mem_budget_mb": 1}),
    ("obs", {"drain_every": 0}), ("obs", {"history": 0}),
    ("part", {"backend": "x"}), ("part", {"n_lp": 0}),
    ("part", {"iters": 0}), ("part", {"shares": (0.5,)}),
    ("part", {"fuzzy_m": 1.0}),
]


@pytest.mark.parametrize("which,fields", BAD,
                         ids=[f"{w}-{'-'.join(f)}" for w, f in BAD])
def test_rejects_what_the_reference_rejects(which, fields):
    ctor = {"abm": (R.ABMConfig, T.ABMConfig),
            "heu": (R.HeuristicConfig, T.HeuristicConfig),
            "eng": (R.EngineConfig, T.EngineConfig),
            "obs": (RObs, TObs),
            "part": (rpart.PartitionConfig, tpart.PartitionConfig)}[which]
    with pytest.raises(Exception) as ref_err:
        ctor[0](**fields)
    with pytest.raises(type(ref_err.value)):
        ctor[1](**fields)
    assert type(ref_err.value) is not NotImplementedError


def _sharded_batch_counters(P):
    """The integer counters of a small sharded batch run (each package
    shards as its world allows: the reference over its 4 forced
    devices, the port as one shard on one process)."""
    cfg = P.EngineConfig(abm=P.ABMConfig(n_se=64, area=1000.0,
                                         interaction_range=60.0),
                         sharding="lp_device", timesteps=4)
    eng = P.Engine(cfg, device="cpu") if P is T else P.Engine(cfg)
    return [{k: c[k] for k in ("local_msgs", "remote_msgs", "migrations",
                               "heu_evals", "lp_flows", "mig_flows",
                               "shard_overflow")}
            for c in eng.run(seeds=[0, 1])[2]]


#: the ids are the cases' places in the list before telemetry was
#: ported (its four cases, 1, 2, 5 and 6, went with it). The sharded
#: cases 0, 3 and 4 raised until the sharded layer was ported: each now
#: gives what the same call gives in the reference. "arch" is the later
#: slice still to come (queue 1 item 11): it raises naming the roadmap.
LATER = {
    0: lambda P: dataclasses.asdict(P.EngineConfig(sharding="lp_device")),
    3: _sharded_batch_counters,
    4: lambda P: dataclasses.asdict(P.EngineConfig(open_world=True,
                                                   sharding="lp_device")),
    "arch": None,
}


@pytest.mark.parametrize("case", LATER.keys(), ids=LATER.keys())
def test_later_slices_raise_naming_the_roadmap(case):
    if LATER[case] is None:
        from repro import configs as rconfigs
        from repro_torch import configs as tconfigs
        # yi-9b and the other dense families are ported since; MLA is not
        name = "deepseek-v3-671b"
        assert rconfigs.get_arch(name).name == name
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            tconfigs.get_arch(name)
        return
    assert LATER[case](T) == LATER[case](R)


def _small(P, **eng):
    return P.EngineConfig(abm=P.ABMConfig(n_se=64, area=1000.0,
                                          interaction_range=60.0), **eng)


#: the service's calls that the port ran as "later" before it had them,
#: and its misuse cases: each does what the reference does (the same
#: exception type, or the same value); P is the package, D the device
SERVICE = [
    lambda P, D: P.Engine(_small(P), **D).init(seeds=[0, 1]).depart([0]),
    lambda P, D: P.Engine(_small(P), **D).depart([0]),
    lambda P, D: P.Engine(_small(P), **D).query_neighbors([0]),
    lambda P, D: P.Engine(_small(P), **D).population(),
    lambda P, D: P.Engine(_small(P), **D).query_region(None),
    lambda P, D: P.EngineConfig(open_world=True).initial_live(),
    lambda P, D: P.Engine(_small(P), **D).arrive({}),
    lambda P, D: P.Engine(_small(P), **D).query_lcr(),
    lambda P, D: P.ReplicaService(_small(P), 2, **D).n_slots,
    lambda P, D: P.Engine(_small(P), **D).init(seed=0).depart([0]),
    lambda P, D: P.Engine(_small(P), **D).init(seed=0).arrive(
        {"pos": np.zeros((1, 2), np.float32)}),
    lambda P, D: P.Engine(_small(P), **D).init(seeds=[0, 1]).query_lcr(),
    lambda P, D: P.Engine(_small(P, open_world=True, n_active=60),
                          **D).init(seed=0).live_ids()[-3:],
    lambda P, D: P.Engine(_small(P, open_world=True, n_active=60),
                          **D).init(seed=0).depart([61]),
    lambda P, D: P.ReplicaService(_small(P), 0, **D),
    lambda P, D: P.ReplicaService(_small(P), 1, **D).submit(0, 0),
    lambda P, D: P.Engine(_small(P), **D).init(seed=0).query_neighbors([]),
]


def _outcome(fn, *args):
    try:
        return "value", fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is the outcome
        return "raises", type(e)


@pytest.mark.parametrize("make", SERVICE, ids=range(len(SERVICE)))
def test_service_calls_do_what_the_reference_does(make):
    want = _outcome(make, R, {})
    assert want[1] is not NotImplementedError
    assert _outcome(make, T, {"device": "cpu"}) == want


PORTED = [
    ("abm", {"mobility": "hotspot"}), ("abm", {"mobility": "group"}),
    ("abm", {"mobility": "flock"}),
    ("abm", {"mobility": "trace", "trace_name": "t"}),
    ("abm", {"workload": "epidemic"}),
    ("abm", {"workload": "epidemic", "proximity_backend": "dense"}),
    ("abm", {"partitioner": "stripe"}), ("abm", {"partitioner": "kmeans"}),
    ("abm", {"partitioner": "bestresponse"}),
    ("abm", {"partitioner": "voronoi"}),
    ("eng", {"repartition_every": 5}),
    ("eng", {"env": "hetero", "balance": "asymmetric"}),
    ("eng", {"env": "wan2"}),
]


@pytest.mark.parametrize("which,fields", PORTED,
                         ids=[f"{w}-{'-'.join(map(str, f.values()))}"
                              for w, f in PORTED])
def test_every_scenario_value_is_accepted(which, fields):
    """Every mobility, workload, partitioner, env and repartition_every
    the reference accepts, the port accepts (no NotImplementedError)."""
    if which == "abm":
        R.ABMConfig(**fields)
        T.ABMConfig(**fields)
        return
    env = fields.get("env")
    kw = dict(fields, env=R.make_env(env, 4) if env else None)
    R.EngineConfig(**kw)
    T.EngineConfig(**dict(fields, env=T.make_env(env, 4) if env else None))
    assert not hasattr(teng, "LATER") or "scenarios" not in teng.LATER
    assert not hasattr(tpart, "LATER")


# --- heuristics and balance, with the reference's inputs injected --------


def _heu_inputs(seed, n, L, w):
    r = np.random.default_rng(seed)
    lp = r.integers(0, L, n).astype(np.int32)
    # skewed histograms, so that plenty of SEs clear MF
    counts = r.poisson(2.0, (n, L)).astype(np.int32)
    counts[np.arange(n), r.integers(0, L, n)] += r.integers(0, 6, n)
    sender = r.uniform(size=n) < 0.5
    state = {"ring": r.poisson(1.5, (w, n, L)).astype(np.int32),
             "ptr": r.integers(0, w, n).astype(np.int32),
             "since_eval": r.integers(0, 30, n).astype(np.int32),
             "last_mig": np.where(r.uniform(size=n) < 0.3,
                                  r.integers(0, 40, n), -10**6
                                  ).astype(np.int32)}
    return lp, counts, sender, state


@pytest.mark.parametrize("kind,L", [(1, 4), (2, 4), (3, 5), (1, 7)])
def test_heuristics_and_balance_exact(kind, L):
    n, t = 400, 37
    rcfg = R.HeuristicConfig(kind=kind, zeta=6)
    tcfg = T.HeuristicConfig(kind=kind, zeta=6)
    w = rcfg.kappa if kind == 1 else rcfg.omega
    lp, counts, sender, state = _heu_inputs(kind * 10 + L, n, L, w)

    @jax.jit
    def ref(state, counts, sender, lp):
        st = rheu.update_window(rcfg, state, counts, sender, t)
        cand, dest, alpha, st, n_evals = rheu.evaluate(
            rcfg, st, lp, t, mf=jnp.float32(rcfg.mf))
        cmat = rbal.candidate_matrix(cand, lp, dest, L)
        sym = rbal.symmetric_grants(cmat)
        cap = jnp.linspace(1.0, 2.0, L, dtype=jnp.float32)
        asym = rbal.asymmetric_grants(cmat, jnp.bincount(lp, length=L),
                                      cap / cap.sum())
        admit = rbal.select_migrations(cand, lp, dest, alpha, sym, L)
        return st, cand, dest, alpha, n_evals, cmat, sym, asym, admit

    want = ref(state, counts, sender, lp)
    tst = {k: torch.from_numpy(v) for k, v in state.items()}
    tlp, tcounts, tsnd = (torch.from_numpy(a) for a in (lp, counts, sender))
    st = theu.update_window(tcfg, tst, tcounts, tsnd, t)
    cand, dest, alpha, st, n_evals = theu.evaluate(tcfg, st, tlp, t)
    cmat = tbal.candidate_matrix(cand, tlp, dest, L)
    sym = tbal.symmetric_grants(cmat)
    cap = torch.from_numpy(np.array(jnp.linspace(1.0, 2.0, L,
                                                 dtype=jnp.float32)))
    asym = tbal.asymmetric_grants(cmat, tbal.bincount(tlp, L),
                                  cap / cap.sum())
    admit = tbal.select_migrations(cand, tlp, dest, alpha, sym, L)
    got = (st, cand, dest, alpha, n_evals, cmat, sym, asym, admit)
    for k in want[0]:
        _bits_equal(want[0][k], st[k].numpy(), k)
    names = ("state", "cand", "dest", "alpha", "n_evals", "cmat", "sym",
             "asym", "admit")
    for name, a, b in list(zip(names, want, got))[1:]:
        _bits_equal(a, b.numpy(), name)
    assert int(np.asarray(want[1]).sum()) > 20  # the test has candidates
    assert int(np.asarray(want[8]).sum()) > 0  # ...and admissions
    s = sym.numpy()
    assert (s.sum(0) == s.sum(1)).all()  # per-LP in == out


# --- init and one step -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_init_bit_equal(seed):
    rc, tc = _cfgs(abm={"n_se": 257})
    ref = _ref_numpy(R.Engine(rc).init(seed=seed).state)
    got = teng.state_to_numpy(T.Engine(tc, device=CPU).init(seed=seed).state)
    assert ref.keys() == got.keys()
    for k in ref:
        _bits_equal(ref[k], got[k], k)


def test_one_rwp_step_within_one_ulp_of_area():
    """One rwp move from identical inputs. Not bitwise: XLA's CPU `sqrt`
    is not correctly rounded on every CPU (on one, 1 ULP off on 1,327 of
    200,000 inputs), so a position may land one ULP of `area` away; the
    waypoints, which only copy, stay bit-equal."""
    area = 1000.0
    r = np.random.default_rng(0)
    pos, wp, new_wp = (r.uniform(0, area, (20000, 2)).astype(np.float32)
                       for _ in range(3))
    wp[:50] = pos[:50] + 3.0  # some arrive this step
    cfg_r = R.ABMConfig(n_se=20000, area=area)
    cfg_t = T.ABMConfig(n_se=20000, area=area)
    want_pos, want_wp = jax.jit(lambda p, w, nw: rabm.rwp_apply(
        p, w, nw, cfg_r))(pos, wp, new_wp)
    got_pos, got_wp = tabm.rwp_apply(*(torch.from_numpy(a) for a in
                                       (pos, wp, new_wp)), cfg_t)
    gap = np.abs(np.asarray(want_pos) - got_pos.numpy()).max()
    assert gap <= area * ULP
    _bits_equal(want_wp, got_wp.numpy())


def test_remainder_is_jnp_remainder():
    """The `%` of the rwp move: fmod plus a sign fix, bit for bit
    `jnp.remainder`."""
    r = np.random.default_rng(1)
    x = np.concatenate([r.uniform(-2000, 3000, 50000), [0.0, -0.0, 1000.0,
                                                         -1000.0]])
    x = x.astype(np.float32)
    want = jax.jit(lambda v: v % 1000.0)(x)
    _bits_equal(want, tabm.remainder(torch.from_numpy(x), 1000.0).numpy())


# --- the slice: teacher-forced and free-running ----------------------------


def _phase_outputs(px):
    return {"counts": px["counts"], "flows": px["flows"],
            "sender": px["sender"], "grid_ovf": px["grid_ovf"]}


def test_teacher_forced_slice():
    """30 steps of a default-shaped small config (16 x 16 grid, GAIA on):
    each step, the reference state is carried into the port and both
    take one step from it. Every integer output and metric is exactly
    equal, positions are within one ULP of `area`, and waypoints and
    lcr are bit-equal."""
    rc, tc = _cfgs()
    mf = jnp.float32(rc.heuristic.mf)

    @jax.jit
    def ref_step(st):
        px = {"st": st, "mf": mf}
        for _, fn in reng.step_phases(rc):
            px = fn(px)
        return px["new_state"], px["metrics"], _phase_outputs(px)

    def port_step(st):
        px = {"st": st, "mf": tc.heuristic.mf}
        for _, fn in teng.step_phases(tc):
            px = fn(px)
        return px["new_state"], px["metrics"], _phase_outputs(px)

    rst = R.Engine(rc).init(seed=5).state
    migrations = 0
    for _ in range(30):
        carried = teng.state_from_numpy(_ref_numpy(rst), CPU)
        tst, tm, tpx = port_step(carried)
        rst, rm, rpx = ref_step(rst)
        ref_np, got_np = _ref_numpy(rst), teng.state_to_numpy(tst)
        for k in ref_np:
            if k == "pos":
                gap = np.abs(ref_np[k] - got_np[k]).max()
                assert gap <= rc.abm.area * ULP
            else:
                _bits_equal(ref_np[k], got_np[k], k)
        for k in rm:
            _bits_equal(rm[k], tm[k].numpy(), k)
        for k in rpx:
            _bits_equal(rpx[k], tpx[k].numpy(), k)
        migrations += int(tm["migrations"])
    assert migrations > 0


FREE = {
    "gaia_on": ({}, {"gaia_on": True}),
    "gaia_off": ({}, {"gaia_on": False}),
    # area / range < 3: the dense path, on the default backend
    "dense_world": ({"n_se": 200, "area": 600.0, "interaction_range": 250.0},
                    {"gaia_on": True}),
}


@pytest.mark.parametrize("name", list(FREE))
def test_free_running_slice(name):
    abm, eng = FREE[name]
    rc, tc = _cfgs(abm=abm, timesteps=50, **eng)
    rst, rser, rcnt = R.Engine(rc).run(seed=11)
    tst, tser, tcnt = T.Engine(tc, device=CPU).run(seed=11)
    for k in INT_SERIES + ("lcr",):
        _bits_equal(rser[k], tser[k].numpy(), k)
    assert np.abs(np.asarray(rst["pos"]) - tst["pos"].numpy()).max() \
        <= 1e-5 * rc.abm.area
    for k in ("lp", "pending_dst", "pending_eta", "ring", "last_mig"):
        _bits_equal(rst[k], tst[k].numpy(), k)
    assert rcnt.keys() == tcnt.keys()
    for k, v in rcnt.items():
        if k == "mean_lcr":
            assert abs(v - tcnt[k]) <= 2 * 50 * 2.0 ** -24 * v
        else:
            assert v == tcnt[k], k
    if eng["gaia_on"]:
        assert tcnt["migrations"] > 0


# --- the API -----------------------------------------------------------------


def test_init_step_metrics_equals_run():
    _, tc = _cfgs(timesteps=40)
    st, series, run_c = T.Engine(tc, device=CPU).run(seed=3)
    eng = T.Engine(tc, device=CPU).init(seed=3)
    eng.step(15)
    eng.step(25, mf=tc.heuristic.mf)
    c = eng.metrics()
    for k in ("local_msgs", "remote_msgs", "migrations", "heu_evals",
              "lp_flows", "mig_flows", "grid_overflow", "migration_ratio"):
        assert c[k] == run_c[k], k
    assert c["mean_lcr"] == pytest.approx(run_c["mean_lcr"], rel=1e-6)
    for k, v in teng.state_to_numpy(st).items():
        _bits_equal(v, teng.state_to_numpy(eng.state)[k], k)


def test_state_round_trip():
    rc, _ = _cfgs()
    x = _ref_numpy(R.Engine(rc).init(seed=2).state)
    y = teng.state_to_numpy(teng.state_from_numpy(x, CPU))
    assert x.keys() == y.keys()
    for k in x:
        _bits_equal(x[k], y[k], k)


def test_engine_defaults_to_the_card():
    _, tc = _cfgs()
    if torch.cuda.is_available():
        assert T.Engine(tc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            T.Engine(tc)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            T.Engine(tc, device="cuda")
    assert T.Engine(tc, device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
        "assert 'repro_torch.kernels.proximity.ops' in sys.modules\n"
        "assert 'repro_torch.kernels.cell_sums.ops' in sys.modules\n"
        "assert 'repro_torch.data.pipeline' in sys.modules\n"
        "assert 'repro_torch.launch.serve' in sys.modules\n"
        "assert 'repro_torch.obs.ledger' in sys.modules\n"
        "assert 'repro_torch.obs.trace' in sys.modules\n"
        "assert 'repro_torch.parallel.lp_shard' in sys.modules\n"
        "assert 'repro_torch.parallel.multihost' in sys.modules\n"
        "print(bad)\n")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.stdout.strip() == "[]"
