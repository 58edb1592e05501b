"""The open world and the service within the port: dead rows through the
grid, the plain sweeps and the block means; a batch whose replicas are
at their own steps against their solo runs; on the CPU, and on the card
the cell-list and dense kernels with dead rows (written into output
memory dirtied first) against their plain versions, and the open-world
engine and `ReplicaService` against the CPU and solo runs. Imports no
JAX, so the card's tests run where it is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_service_kernels.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import abm as tabm  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import neighbors as tnb  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.proximity import ops as prox  # noqa: E402
from repro_torch.kernels.proximity import ref as prox_ref  # noqa: E402

CPU = torch.device("cpu")
# one PyTorch thread a test worker, as tests/torch_parity.py sets it
torch.set_num_threads(1)
#: a 16 x 16-cell world (the default's shape at 1/25 the SEs)
SMALL = dict(n_se=400, area=1000.0, interaction_range=60.0)
#: dead-row layouts: the tail (the service's initial free slots),
#: scattered rows (after churn), every row
LAYOUTS = ("tail", "scattered", "all")


def _same(a, b, what=""):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(a, b), what


def _world(seeds, device, n_dead, layout, mobility="rwp", n_lp=4, **kw):
    """(cfg, pos, lp, senders, valid) of one world per seed (stacked when
    there are several), `n_dead` dead rows a world: lp -1, and senders
    everywhere else but on a third of the live rows. Dead rows keep
    their positions (piled into one corner for "scattered", so they
    would crowd a cell if the grid held them)."""
    cfg = T.ABMConfig(**{**SMALL, "mobility": mobility, **kw})
    n = cfg.n_se
    pos, lps, snds, valids = [], [], [], []
    for s in seeds:
        st = tabm.init_abm(trandom.key(s), cfg, device)
        g = np.random.default_rng(s)
        if layout == "tail":
            dead = np.arange(n) >= n - n_dead
        elif layout == "all":
            dead = np.ones(n, bool)
        else:
            dead = np.zeros(n, bool)
            dead[g.choice(n, n_dead, replace=False)] = True
        dead = torch.from_numpy(dead).to(device)
        p = st["pos"].clone()
        if layout == "scattered":
            p[dead] = 1.0
        pos.append(p)
        lps.append(torch.where(dead, -1, st["lp"] % n_lp))
        snds.append(torch.from_numpy(g.random(n) < 0.67).to(device))
        valids.append(~dead)
    one = len(seeds) == 1
    return (cfg,) + tuple(x[0] if one else torch.stack(x)
                          for x in (pos, lps, snds, valids))


# --- the grid and the plain sweeps ----------------------------------------


@pytest.mark.parametrize("replicas", [1, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_grid_bins_dead_rows_out(layout, replicas):
    """Dead rows sit in the virtual cell R * ncell^2, after every real
    cell; the real cells hold the live rows only, in id order, and the
    overflow flag sees the live rows only."""
    seeds = (3, 7, 11)[:replicas]
    n_dead = SMALL["n_se"] if layout == "all" else 150
    cfg, pos, _, _, valid = _world(seeds, CPU, n_dead, layout)
    spec = dataclasses.replace(cfg.grid_spec(), capacity=4)
    n, nc2 = cfg.n_se, cfg.grid_spec().ncell ** 2
    g = tnb.build_grid(pos, spec, valid=valid)
    total = replicas * nc2
    live = valid.reshape(-1)
    assert int(live.sum()) == replicas * n - (replicas * n_dead)
    assert g["starts"].shape == g["counts"].shape == (total,)
    assert int(g["counts"].sum()) == int(live.sum())
    assert (g["cell_sorted"][int(live.sum()):] == total).all()
    _same(g["order"][int(live.sum()):],
          torch.nonzero(~live)[:, 0])  # dead rows in id order
    cell = tnb.cell_ids(pos, spec).reshape(-1).long()
    if replicas > 1:
        cell = cell + (torch.arange(replicas * n) // n) * nc2
    want = torch.bincount(cell[live], minlength=total)
    _same(g["counts"], want)
    _same(g["overflow"], (want.view(pos.shape[:-2] + (nc2,)) > 4).any(-1))


@pytest.mark.parametrize("replicas", [1, 3])
@pytest.mark.parametrize("n_lp", [2, 4, 9])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_grid_counts_with_dead_rows(layout, n_lp, replicas):
    """The plain cell-list sweep over a grid with dead rows: dead rows'
    counts are zeros even where their sender flag is set, and the live
    rows count what the dense sweep over the live rows counts."""
    seeds = (3, 7, 11)[:replicas]
    n_dead = SMALL["n_se"] if layout == "all" else 150
    cfg, pos, lp, snd, valid = _world(seeds, CPU, n_dead, layout,
                                      n_lp=n_lp)
    spec = cfg.grid_spec()
    grid = tnb.build_grid(pos, spec, valid=valid)
    args = (n_lp, cfg.area, cfg.interaction_range)
    got = prox_ref.grid_lp_counts_plain(pos, lp, snd, *args, spec, grid)
    assert (got[~valid] == 0).all()
    want = prox_ref.dense_lp_counts_plain(pos, lp, snd & valid, *args)
    _same(got, want)
    if layout != "all":
        assert int(got.sum()) > 0
    _same(prox.proximity_lp_counts_grid(pos, lp, snd, *args, spec, grid),
          got)


def test_rows_grid_neighbor_ids_equals_brute_force():
    cfg, pos, _, _, valid = _world((5,), CPU, 120, "scattered")
    spec = cfg.grid_spec()
    grid = tnb.build_grid(pos, spec, valid=valid)
    q = torch.nonzero(valid)[::17, 0]
    cols = tnb.rows_grid_neighbor_ids(pos, cfg.area, cfg.interaction_range,
                                      spec, grid, pos[q], q)
    assert cols.shape == (q.shape[0], 9 * spec.capacity)
    rng2 = np.float32(cfg.interaction_range ** 2)
    p = pos.numpy()
    for i, row in zip(q.tolist(), cols.tolist()):
        d = np.abs(p - p[i])
        d = np.minimum(d, np.float32(cfg.area) - d)
        hit = valid.numpy() & (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                               <= rng2)
        hit[i] = False
        assert sorted(x for x in row if x >= 0) == \
            np.nonzero(hit)[0].tolist(), i


@pytest.mark.parametrize("replicas", [1, 3])
def test_block_means_leave_dead_rows_out(replicas):
    """The flock's block means with dead rows: each live row's output
    is, bit for bit, that of the world of the live rows alone (the
    cells add their live members in id order either way)."""
    seeds = (2, 4, 6)[:replicas]
    cfg = T.ABMConfig(**{**SMALL, "mobility": "flock"})
    sts = [tabm.init_abm(trandom.key(s), cfg, CPU) for s in seeds]
    pos = torch.stack([s["pos"] for s in sts])
    vec = torch.stack([s["mob"] for s in sts])
    valid = torch.stack([torch.from_numpy(
        np.random.default_rng(s).random(cfg.n_se) < 0.7) for s in seeds])
    spec = cfg.grid_spec()
    args = (spec, cfg.area)
    if replicas == 1:
        got = tnb.cell_block_mean(pos[0], vec[0], *args, valid=valid[0])
        got = [g[None] for g in got]
    else:
        got = tnb.cell_block_mean(pos, vec, *args, valid=valid)
    for r in range(replicas):
        v = valid[r]
        want = tnb.cell_block_mean(pos[r][v], vec[r][v], *args)
        for a, b in zip(got, want):
            _same(a[r][v], b, r)


# --- a batch at its own steps -------------------------------------------


RUNS = {
    "rwp_stripe_every_5": ({"partitioner": "stripe"},
                           {"repartition_every": 5}),
    "epidemic_open": ({"workload": "epidemic"},
                      {"open_world": True, "n_active": 300}),
    "hotspot_asym": ({"mobility": "hotspot"},
                     {"balance": "asymmetric",
                      "capacity": (0.4, 0.3, 0.2, 0.1)}),
    "kind2": ({}, {"heuristic": T.HeuristicConfig(kind=2)}),
}


def _run_cfg(name):
    abm, eng = RUNS[name]
    return T.EngineConfig(abm=T.ABMConfig(**{**SMALL, **abm}), **eng)


def _held_at_own_steps(cfg, device, starts=(0, 7, 3), steps=12):
    """Replicas brought to their own steps by solo windows, stacked and
    stepped as one batch: each equals its solo engine stepped on."""
    solos, subs = [], []
    for seed, t0 in enumerate(starts):
        e = T.Engine(cfg, device=device).init(seed=seed)
        if t0:
            e.step(t0)
        subs.append(e.state)
        solos.append(e)
    st = teng.stack_states(subs)
    assert st["t"] == tuple(starts)
    st, reps = teng._run_window_batch(st, cfg, steps)
    assert st["t"] == tuple(t + steps for t in starts)
    for r, e in enumerate(solos):
        assert e.step(steps) == reps[r], r
        for k, v in e.state.items():
            if k != "t":
                _same(st[k][r], v, (r, k))
    return reps


@pytest.mark.parametrize("name", list(RUNS))
def test_batch_at_own_steps_is_solo_runs_bitwise(name):
    reps = _held_at_own_steps(_run_cfg(name), CPU)
    if "every" in name:  # replicas reach their boundaries apart
        assert [c["repartitions"] > 0 for c in reps] == [True] * 3


def test_replica_service_requests_are_solo_runs():
    """Unequal requests over 3 slots, with an MF of their own and with
    periodic repartitions: each request's counters are its solo run's,
    MF included; the queue drains and a second drain is a no-op."""
    cfg = dataclasses.replace(_run_cfg("rwp_stripe_every_5"), timesteps=0)
    svc = T.ReplicaService(cfg, 3, device=CPU)
    jobs = [(0, 17, None), (1, 9, 2.0), (2, 23, None), (3, 6, 0.9),
            (4, 12, None)]
    rids = [svc.submit(s, n, mf) for s, n, mf in jobs]
    res = svc.drain()
    for rid, (s, n, mf) in zip(rids, jobs):
        e = T.Engine(cfg, device=CPU).init(seed=s)
        e.step(n, mf=mf)
        solo = e.metrics()
        for k in ("migrations", "local_msgs", "remote_msgs", "heu_evals",
                  "repartitions", "grid_overflow"):
            assert res[rid][k] == solo[k], (rid, k)
        assert res[rid]["migration_ratio"] == solo["migration_ratio"]
    assert svc.drain() is res
    with pytest.raises(ValueError):
        svc.submit(0, 0)
    with pytest.raises(ValueError):
        T.ReplicaService(cfg, 0, device=CPU)


def test_replica_service_idle_slots_do_not_repartition(monkeypatch):
    """Once the queue runs dry, the slots left idle ride along in the
    batch without running the partitioner: the calls are each request's
    init and its own boundaries, no more."""
    cfg = dataclasses.replace(_run_cfg("rwp_stripe_every_5"), timesteps=0)
    calls = []
    partition = teng.part.partition

    def counted(*a, **kw):
        calls.append(kw.get("compiled", False))
        return partition(*a, **kw)

    monkeypatch.setattr(teng.part, "partition", counted)
    svc = T.ReplicaService(cfg, 3, device=CPU)
    jobs = [(0, 17), (1, 9), (2, 23), (3, 6), (4, 12)]
    for s, n in jobs:
        svc.submit(s, n)
    res = svc.drain()
    every = cfg.repartition_every
    assert calls.count(False) == len(jobs)  # the inits
    assert calls.count(True) == sum((n - 1) // every for _, n in jobs)
    assert sorted(c["repartitions"] > 0 for c in res.values()) == [True] * 5


# --- the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


def _dirty(nbytes, device):
    """Fill a fresh block of `nbytes` with a nonzero pattern and free it,
    so the caching allocator hands it to the next allocation of that
    size; returns its address."""
    torch.cuda.empty_cache()
    junk = torch.full((nbytes // 4,), 0x5A5A5A5A, dtype=torch.int32,
                      device=device)
    ptr = junk.data_ptr()
    del junk
    return ptr


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [1, 4])
@pytest.mark.parametrize("n,n_dead,layout,n_lp", [
    (10_000, 2_000, "tail", 4), (10_000, 2_000, "scattered", 4),
    (2_000, 65, "tail", 2), (2_000, 2_000, "all", 4),
    (10_000, 3_000, "tail", 40)])
def test_grid_kernel_dead_rows_on_card(cuda, n, n_dead, layout, n_lp,
                                       replicas):
    """Dead tails longer than the kernel's HEAD (64), every row dead,
    batched grids with dead rows in each replica: bit for bit the plain
    version, every dead row zero in output memory dirtied first, one
    launch a call."""
    seeds = (1, 2, 3, 4)[:replicas]
    area = float(np.sqrt(n * 1e4))
    cfg, pos, lp, snd, valid = _world(seeds, cuda, n_dead, layout,
                                      n_lp=n_lp, n_se=n, area=area,
                                      interaction_range=250.0)
    spec = cfg.grid_spec()
    grid = tnb.build_grid(pos, spec, valid=valid)
    args = (pos, lp, snd, n_lp, area, 250.0, spec, grid)
    ptr = _dirty(pos.shape[:-1].numel() * n_lp * 4, cuda)
    prox.reset_launches()
    got = prox.proximity_lp_counts_grid(*args)
    assert prox.launches()["proximity_grid"] == 1
    assert got.data_ptr() == ptr  # the kernel wrote the dirtied block
    assert (got[~valid] == 0).all()
    _same(got, prox_ref.grid_lp_counts_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [1, 3])
def test_dense_kernel_dead_rows_on_card(cuda, replicas):
    seeds = (5, 6, 7)[:replicas]
    cfg, pos, lp, snd, valid = _world(seeds, cuda, 500, "scattered",
                                      n_se=2000, area=600.0,
                                      interaction_range=250.0)
    args = (pos, lp, snd & valid, 4, 600.0, 250.0)
    prox.reset_launches()
    got = prox.proximity_lp_counts(*args)
    assert prox.launches()["proximity_dense"] == 1
    assert (got[~valid] == 0).all()
    _same(got, prox_ref.dense_lp_counts_plain(*args))


def _churn_run(cfg, device, seed=0):
    """A churn script on one resident engine: per-window series on the
    host, the ids each arrival got, the final state on the host."""
    eng = T.Engine(cfg, device=device).init(seed=seed)
    g = np.random.default_rng(seed)
    series, ids = [], []
    for _ in range(6):
        eng.state, ser = teng._run_steps(eng.state, cfg, 5)
        series.append({k: v.cpu() for k, v in ser.items()})
        eng.depart(g.choice(eng.live_ids(), size=25, replace=False))
        ids.append(eng.arrive({"pos": (g.random((25, 2)) * cfg.abm.area)
                               .astype(np.float32)}))
    return series, ids, {k: v if k == "t" else v.cpu()
                         for k, v in eng.state.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("abm", [{}, {"workload": "epidemic"},
                                 {"proximity_backend": "dense",
                                  "n_se": 300, "area": 600.0,
                                  "interaction_range": 250.0}],
                         ids=["rwp", "epidemic", "dense"])
def test_open_world_churn_on_card_equals_the_cpu(cuda, abm):
    cfg = T.EngineConfig(abm=T.ABMConfig(**{**SMALL, **abm}),
                         open_world=True, n_active=280)
    build.reset_launches()
    gser, gids, gst = _churn_run(cfg, cuda)
    got = build.launches()
    dense = abm.get("proximity_backend") == "dense"
    per_step = 1 if dense else 2 if abm.get("workload") else 1
    assert got["proximity_dense" if dense else "proximity_grid"] == \
        30 * per_step
    cser, cids, cst = _churn_run(cfg, CPU)
    assert gids == cids
    for a, b in zip(gser, cser):
        for k in b:
            if k != "lcr":
                _same(a[k], b[k], k)
    area_ulp = cfg.abm.area * 2.0 ** -23
    assert float((gst["pos"] - cst["pos"]).abs().max()) <= 30 * area_ulp
    _same(gst["lp"], cst["lp"])


@pytest.mark.cuda
def test_replica_service_on_card_equals_solo_runs(cuda):
    cfg = dataclasses.replace(_run_cfg("rwp_stripe_every_5"), timesteps=0)
    svc = T.ReplicaService(cfg, 2, device=cuda)
    jobs = [(0, 14), (1, 6), (2, 11)]
    rids = [svc.submit(s, n) for s, n in jobs]
    res = svc.drain()
    for rid, (s, n) in zip(rids, jobs):
        _, _, solo = T.Engine(dataclasses.replace(cfg, timesteps=n),
                              device=cuda).run(seed=s)
        for k in ("migrations", "local_msgs", "remote_msgs", "heu_evals",
                  "repartitions"):
            assert res[rid][k] == solo[k], (rid, k)
    _held_at_own_steps(_run_cfg("epidemic_open"), cuda)
