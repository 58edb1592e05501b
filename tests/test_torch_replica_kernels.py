"""Replica batches within the port: a batch of R replicas against R solo
calls, bit for bit, at every layer a step passes through — the draws,
the grid over R worlds, the plain proximity and cell-sum versions, the
mobility models, the heuristics and balancing, and whole runs — on the
CPU; and on the card the batched kernels (one launch for all R) against
their plain versions, and batched runs against solo runs. Imports no
JAX, so the card's tests run where it is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_replica_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import abm as tabm  # noqa: E402
from repro_torch.core import balance as tbal  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import heuristics as theu  # noqa: E402
from repro_torch.core import neighbors as tnb  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.cell_sums import ops as cs_ops  # noqa: E402
from repro_torch.kernels.cell_sums import ref as cs_ref  # noqa: E402
from repro_torch.kernels.proximity import ops as prox  # noqa: E402
from repro_torch.kernels.proximity import ref as prox_ref  # noqa: E402

CPU = torch.device("cpu")
# one PyTorch thread a test worker, as tests/torch_parity.py sets it
# (intra-op threads on top of the parallel workers oversubscribe the
# cores, and these small ops then run many times slower)
torch.set_num_threads(1)
SEEDS = (3, 7, 11)
#: a 16 x 16-cell world (the default's shape at 1/25 the SEs)
SMALL = dict(n_se=400, area=1000.0, interaction_range=60.0)


def _worlds(mobility, seeds, device, **kw):
    """(cfg, stacked init states) of one world per seed."""
    cfg = T.ABMConfig(**{**SMALL, "mobility": mobility, **kw})
    sts = [tabm.init_abm(trandom.key(s), cfg, device) for s in seeds]
    return cfg, {k: torch.stack([s[k] for s in sts]) for k in sts[0]}


def _senders(seeds, n, device, p=0.3):
    return trandom.bernoulli(trandom.keys(seeds), p, (n,), device=device)


def _same(a, b, what=""):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(a, b), what


# --- draws -------------------------------------------------------------------


def test_batched_draws_are_the_solo_draws():
    ks = trandom.keys(SEEDS)
    assert ks.shape == (3, 2)
    for r, s in enumerate(SEEDS):
        k = trandom.key(s)
        _same(ks[r], k)
        _same(trandom.split(ks, 3)[:, r], trandom.split(k, 3))
        _same(trandom.fold_in(ks, 0x3911)[r], trandom.fold_in(k, 0x3911))
        _same(trandom.uniform(ks, (50, 2), maxval=10.0)[r],
              trandom.uniform(k, (50, 2), maxval=10.0))
        _same(trandom.bernoulli(ks, 0.2, (77,))[r],
              trandom.bernoulli(k, 0.2, (77,)))
    # a batch of one takes the solo path and keeps its replica axis
    _same(trandom.uniform(ks[1:2], (5,))[0], trandom.uniform(ks[1], (5,)))
    # the key words round-trip through their uint32 form
    _same(trandom.wrap_key_data(ks.numpy().astype(np.uint32)), ks)


# --- the grid over R worlds and the plain sweeps -------------------------


@pytest.mark.parametrize("mobility,cap", [("rwp", 0), ("hotspot", 0),
                                          ("hotspot", 6)])
def test_build_grid_over_replicas(mobility, cap):
    """Replica r's segments are its solo grid's, offset by r * ncell^2
    (cells) and r * N (rows); the overflow flag is per replica."""
    cfg, st = _worlds(mobility, SEEDS, CPU, grid_capacity=cap)
    spec, n = cfg.grid_spec(), cfg.n_se
    nc2 = spec.ncell ** 2
    g = tnb.build_grid(st["pos"], spec)
    assert g["overflow"].shape == (3,)
    for r in range(3):
        s = tnb.build_grid(st["pos"][r], spec)
        _same(g["counts"][r * nc2:(r + 1) * nc2], s["counts"])
        _same(g["starts"][r * nc2:(r + 1) * nc2], s["starts"] + r * n)
        _same(g["order"][r * n:(r + 1) * n], s["order"] + r * n)
        _same(g["cell_sorted"][r * n:(r + 1) * n], s["cell_sorted"] + r * nc2)
        _same(g["overflow"][r], s["overflow"])
    if cap:  # the small capacity trips the flag somewhere
        assert bool(g["overflow"].any())


@pytest.mark.parametrize("mobility,n_lp", [("rwp", 4), ("hotspot", 4),
                                           ("rwp", 2), ("group", 7)])
def test_plain_grid_counts_over_replicas(mobility, n_lp):
    cfg, st = _worlds(mobility, SEEDS, CPU)
    spec = cfg.grid_spec()
    lp = st["lp"] % n_lp
    snd = _senders(SEEDS, cfg.n_se, CPU)
    args = (n_lp, cfg.area, cfg.interaction_range, spec)
    got = prox_ref.grid_lp_counts_plain(
        st["pos"], lp, snd, *args, tnb.build_grid(st["pos"], spec), 4096)
    for r in range(3):
        want = prox_ref.grid_lp_counts_plain(
            st["pos"][r], lp[r], snd[r], *args,
            tnb.build_grid(st["pos"][r], spec), 4096)
        _same(got[r], want, r)
    assert int(got.sum()) > 0
    # the CPU wrapper is the plain version
    _same(prox.proximity_lp_counts_grid(st["pos"], lp, snd, *args,
                                        tnb.build_grid(st["pos"], spec)), got)


def test_plain_dense_counts_over_replicas():
    cfg, st = _worlds("rwp", SEEDS, CPU, n_se=200, area=600.0,
                      interaction_range=250.0)
    snd = _senders(SEEDS, 200, CPU)
    got = prox.proximity_lp_counts(st["pos"], st["lp"], snd, 4, 600.0, 250.0)
    for r in range(3):
        _same(got[r], prox_ref.dense_lp_counts_plain(
            st["pos"][r], st["lp"][r], snd[r], 4, 600.0, 250.0))


@pytest.mark.parametrize("mobility", ["flock", "hotspot"])
def test_cell_sums_and_block_means_over_replicas(mobility):
    cfg, st = _worlds(mobility, SEEDS, CPU)
    spec = cfg.grid_spec()
    nc2 = spec.ncell ** 2
    sums = cs_ops.cell_sums(st["pos"], st["mob"],
                            tnb.build_grid(st["pos"], spec))
    assert sums.shape == (5, 3 * nc2)
    cd, vm = tnb.cell_block_mean(st["pos"], st["mob"], spec, cfg.area)
    for r in range(3):
        grid = tnb.build_grid(st["pos"][r], spec)
        _same(sums[:, r * nc2:(r + 1) * nc2],
              cs_ref.cell_sums_plain(st["pos"][r], st["mob"][r], grid))
        cdr, vmr = tnb.cell_block_mean(st["pos"][r], st["mob"][r], spec,
                                       cfg.area)
        _same(cd[r], cdr)
        _same(vm[r], vmr)


# --- mobility, heuristics and balancing ----------------------------------


def _register_trace(name="replica-kernels", n=400, area=1000.0):
    if name not in tpipe.trace_names():
        tpipe.register_trace(name, tpipe.synthetic_trace(tpipe.TraceSpec(
            n_se=n, area=area, timesteps=12, speed=11.0, n_hubs=4, seed=1)))
    return name


@pytest.mark.parametrize("mobility", ["rwp", "hotspot", "group", "flock",
                                      "trace"])
def test_mobility_step_over_replicas(mobility):
    kw = {"trace_name": _register_trace()} if mobility == "trace" else {}
    cfg, st = _worlds(mobility, SEEDS, CPU, **kw)
    keys = trandom.keys((21, 22, 23))
    st["mob_g"][1, 0, 0] += 2.0 if mobility == "trace" else 0.0
    for _ in range(3):
        args = [st[k] for k in ("pos", "waypoint", "mob", "mob_g")]
        solo = [tabm.mobility_step(keys[r], *[a[r] for a in args], cfg)
                for r in range(3)]
        got = tabm.mobility_step(keys, *args, cfg)
        for i, k in enumerate(("pos", "waypoint", "mob", "mob_g")):
            for r in range(3):
                _same(got[i][r], solo[r][i], (k, r))
            st[k] = got[i]
        keys = trandom.split(keys)[0]


def _heu_case(kind, L, n=300, w=8, r=3, seed=0):
    g = np.random.default_rng(seed)
    counts = g.poisson(2.0, (r, n, L)).astype(np.int32)
    counts[..., 0] += g.integers(0, 6, (r, n)).astype(np.int32)
    state = {"ring": g.poisson(1.5, (r, w, n, L)).astype(np.int32),
             "ptr": g.integers(0, w, (r, n)).astype(np.int32),
             "since_eval": g.integers(0, 30, (r, n)).astype(np.int32),
             "last_mig": np.where(g.uniform(size=(r, n)) < 0.3,
                                  g.integers(0, 40, (r, n)), -10**6
                                  ).astype(np.int32)}
    lp = g.integers(0, L, (r, n)).astype(np.int32)
    sender = g.uniform(size=(r, n)) < 0.5
    return ({k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(counts), torch.from_numpy(sender),
            torch.from_numpy(lp))


@pytest.mark.parametrize("kind,L", [(1, 4), (2, 4), (3, 5), (1, 7)])
def test_heuristics_and_balance_over_replicas(kind, L):
    """Per-replica MFs (0.6, 1.2, 3.0): each replica's window, evaluation,
    grants (symmetric and asymmetric) and admissions are the solo ones."""
    cfg = T.HeuristicConfig(kind=kind, zeta=6, omega=8, kappa=8)
    state, counts, sender, lp = _heu_case(kind, L, seed=kind * 10 + L)
    mfs = (0.6, 1.2, 3.0)
    cap = torch.linspace(1.0, 2.0, L)
    cap = cap / cap.sum()

    def chain(state, counts, sender, lp, mf):
        st = theu.update_window(cfg, state, counts, sender, 37)
        cand, dest, alpha, st, n_evals = theu.evaluate(cfg, st, lp, 37,
                                                       mf=mf)
        cmat = tbal.candidate_matrix(cand, lp, dest, L)
        sym = tbal.symmetric_grants(cmat)
        asym = tbal.asymmetric_grants(cmat, tbal.bincount(lp, L), cap)
        admit = tbal.select_migrations(cand, lp, dest, alpha, sym, L)
        return st, (cand, dest, alpha, n_evals, cmat, sym, asym, admit)

    bst, bout = chain(state, counts, sender, lp,
                      torch.tensor(mfs, dtype=torch.float32))
    admitted = 0
    for r, mf in enumerate(mfs):
        sst, sout = chain({k: v[r] for k, v in state.items()}, counts[r],
                          sender[r], lp[r], mf)
        for k in sst:
            _same(bst[k][r], sst[k], k)
        for i, (b, s) in enumerate(zip(bout, sout)):
            _same(b[r], s, (r, i))
        admitted += int(sout[-1].sum())
    assert admitted > 0


# --- whole runs ----------------------------------------------------------


RUNS = {
    "rwp": ({}, {}),
    "gaia_off": ({}, {"gaia_on": False}),
    "kind2": ({}, {"heuristic": T.HeuristicConfig(kind=2)}),
    "kind3_asym_env": ({}, {"heuristic": T.HeuristicConfig(kind=3, zeta=4),
                            "balance": "asymmetric",
                            "env": T.make_env("hetero", 4)}),
    "hotspot": ({"mobility": "hotspot", "n_groups": 4,
                 "group_radius": 120.0}, {}),
    "group": ({"mobility": "group"}, {}),
    "flock": ({"mobility": "flock"}, {}),
    "trace": ({"mobility": "trace", "trace_policy": "loop"}, {}),
    "epidemic": ({"workload": "epidemic", "epi_gamma": 0.1}, {}),
    "epidemic_dense": ({"workload": "epidemic",
                        "proximity_backend": "dense"}, {}),
    "dense_world": ({"n_se": 200, "area": 600.0,
                     "interaction_range": 250.0}, {}),
    "stripe_every_4": ({"partitioner": "stripe"}, {"repartition_every": 4}),
    "voronoi_every_4": ({"partitioner": "voronoi"},
                        {"repartition_every": 4}),
}


def _run_cfg(name, steps=10):
    abm, eng = RUNS[name]
    if abm.get("mobility") == "trace":
        abm = dict(abm, trace_name=_register_trace())
    return T.EngineConfig(abm=T.ABMConfig(**{**SMALL, **abm}),
                          timesteps=steps, **eng)


def _assert_batch_is_solo(cfg, device, seeds=SEEDS):
    states, series, reps = T.Engine(cfg, device=device).run(seeds=seeds)
    assert states["key"].shape == (len(seeds), 2)
    for r, seed in enumerate(seeds):
        st, ser, c = T.Engine(cfg, device=device).run(seed=seed)
        assert st.keys() == states.keys()
        for k, v in st.items():
            if k == "t":
                assert states["t"] == v
            else:
                _same(states[k][r], v, (seed, k))
        assert ser.keys() == series.keys()
        for k, v in ser.items():
            _same(series[k][:, r], v, (seed, k))
        assert reps[r] == c, seed
    return reps


@pytest.mark.parametrize("name", list(RUNS))
def test_batch_run_is_solo_runs_bitwise(name):
    reps = _assert_batch_is_solo(_run_cfg(name), CPU)
    assert reps[0] != reps[1]  # distinct seeds, distinct trajectories


def test_batched_windows_and_metrics():
    """init(seeds).step() in windows, with a per-replica MF vector in
    one of them, equals each seed's solo windows; metrics() is one dict
    a replica, equal to the solo engine's."""
    cfg = _run_cfg("rwp", steps=12)
    eng = T.Engine(cfg, device=CPU).init(seeds=SEEDS)
    w1 = eng.step(5)
    w2 = eng.step(7, mf=[0.8, 1.2, 4.0])
    assert len(w1) == len(w2) == 3
    ms = eng.metrics()
    for r, (seed, mf) in enumerate(zip(SEEDS, (0.8, 1.2, 4.0))):
        solo = T.Engine(cfg, device=CPU).init(seed=seed)
        assert solo.step(5) == w1[r]
        assert solo.step(7, mf=mf) == w2[r]
        assert solo.metrics() == ms[r]
        for k, v in solo.state.items():
            if k != "t":
                _same(eng.state[k][r], v, k)
    assert eng.state["t"] == 12
    with pytest.raises(ValueError, match="3 replicas"):
        eng.step(1, mf=[1.0, 2.0])
    assert T.Engine(cfg, device=CPU).init(seeds=[1]).metrics() == []


def test_batched_state_round_trip_and_lockstep():
    cfg = _run_cfg("hotspot")
    st = T.Engine(cfg, device=CPU).init(seeds=SEEDS).state
    arrays = teng.state_to_numpy(st)
    assert arrays["key"].shape == (3, 2) and arrays["t"].shape == (3,)
    back = teng.state_from_numpy(arrays, CPU)
    for k, v in st.items():
        assert back[k] == v if k == "t" else torch.equal(back[k], v), k
    assert back["t"] == 0  # a lockstep batch keeps one int
    # replicas at their own steps keep them, in both directions
    arrays["t"] = np.array([0, 0, 1], np.int32)
    back = teng.state_from_numpy(arrays, CPU)
    assert back["t"] == (0, 0, 1)
    _same(torch.from_numpy(teng.state_to_numpy(back)["t"]),
          torch.tensor([0, 0, 1], dtype=torch.int32))
    sub = teng._init_engine(trandom.key(0), cfg, CPU)
    assert teng.stack_states([dict(sub, t=t) for t in (0, 1)])["t"] == (0, 1)
    assert teng.stack_states([dict(sub, t=3)] * 2)["t"] == 3


# --- the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mobility,n,area,n_lp", [
    ("rwp", 2000, 4472.0, 4), ("hotspot", 2000, 4472.0, 4),
    ("rwp", 2000, 4472.0, 2), ("rwp", 10_000, 10_000.0, 4)])
def test_grid_kernel_over_replicas_on_card(cuda, mobility, n, area, n_lp):
    seeds = (1, 2, 3, 4)
    cfg, st = _worlds(mobility, seeds, cuda, n_se=n, area=area,
                      interaction_range=250.0)
    spec = cfg.grid_spec()
    lp = st["lp"] % n_lp
    snd = _senders(seeds, n, cuda)
    grid = tnb.build_grid(st["pos"], spec)
    args = (st["pos"], lp, snd, n_lp, area, 250.0, spec, grid)
    prox.reset_launches()
    got = prox.proximity_lp_counts_grid(*args)
    assert prox.launches()["proximity_grid"] == 1
    _same(got, prox_ref.grid_lp_counts_plain(*args))
    for r in range(len(seeds)):
        _same(got[r], prox.proximity_lp_counts_grid(
            st["pos"][r], lp[r], snd[r], n_lp, area, 250.0, spec,
            tnb.build_grid(st["pos"][r], spec)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_lp", [(2000, 4), (517, 9)])
def test_dense_kernel_over_replicas_on_card(cuda, n, n_lp):
    seeds = (5, 6, 7)
    cfg, st = _worlds("rwp", seeds, cuda, n_se=n, area=600.0,
                      interaction_range=250.0)
    lp = st["lp"] % n_lp
    snd = _senders(seeds, n, cuda)
    prox.reset_launches()
    got = prox.proximity_lp_counts(st["pos"], lp, snd, n_lp, 600.0, 250.0)
    assert prox.launches()["proximity_dense"] == 1
    _same(got, prox_ref.dense_lp_counts_plain(st["pos"], lp, snd, n_lp,
                                              600.0, 250.0))


@pytest.mark.cuda
@pytest.mark.parametrize("mobility", ["flock", "hotspot"])
def test_cell_sums_over_replicas_on_card(cuda, mobility):
    cfg, st = _worlds(mobility, (1, 2, 3, 4), cuda, n_se=10_000,
                      area=10_000.0, interaction_range=250.0)
    grid = tnb.build_grid(st["pos"], cfg.grid_spec())
    cs_ops.reset_launches()
    got = cs_ops.cell_sums(st["pos"], st["mob"], grid)
    assert cs_ops.launches()["cell_sums"] == 1
    want = cs_ref.cell_sums_plain(st["pos"].reshape(-1, 2),
                                  st["mob"].reshape(-1, 2), grid)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_batched_draws_on_card_equal_the_cpu(cuda):
    """Key words reach the card through fresh pinned buffers: many draws
    in a row, none of them waited for, equal the CPU's."""
    keys = trandom.keys(range(10))
    got = []
    for i in range(50):
        got.append(trandom.uniform(trandom.fold_in(keys, i), (1000,),
                                   device=cuda))
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        _same(g.cpu(), trandom.uniform(trandom.fold_in(keys, i), (1000,)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rwp", "epidemic", "flock", "hotspot",
                                  "dense_world", "kind3_asym_env"])
def test_batch_run_is_solo_runs_on_card(cuda, name):
    cfg = _run_cfg(name, steps=20)
    build.reset_launches()
    T.Engine(cfg, device=cuda).run(seeds=SEEDS)
    got = build.launches()
    grid = 0 if "dense" in name else 2 if name == "epidemic" else 1
    assert got["proximity_grid"] == grid * 20
    assert got["cell_sums"] == (20 if name == "flock" else 0)
    if name == "dense_world":
        assert got["proximity_dense"] == 20
    _assert_batch_is_solo(cfg, cuda)


def test_batch_config_errors():
    cfg = _run_cfg("rwp")
    with pytest.raises(ValueError, match="at least one seed"):
        T.Engine(cfg, device=CPU).init(seeds=[])
    eng = T.Engine(cfg, device=CPU).init(seeds=[0, 1])
    with pytest.raises(RuntimeError, match="replica batch"):
        eng.query_lcr()
