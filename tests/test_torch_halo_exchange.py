"""The sparse halo of the port's sharded engine on the CPU: its helpers
(`halo_mask`, `dilate_mask`, `halo_need_bitmaps`, `rows_dense_counts`,
`max_step_displacement`) equal to the reference's on seeded inputs;
the need bitmaps sound (every in-range neighbour of a shard's row is in
its view after one step of worst-case motion); the wire counted by hand;
tight migration and halo buffers exact or loud; the trace replay and
the open world sharded, bit for bit the port's oracle."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import abm as rabm  # noqa: E402
from repro.core import neighbors as rnb  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.parallel import lp_shard as RL  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import abm as tabm  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import neighbors as tnb  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.parallel import lp_shard as TL  # noqa: E402

from torch_parity import CPU, bits_equal, cfgs  # noqa: E402

SYM_ABM = dict(n_se=96, n_lp=4, area=1000.0, speed=5.0,
               interaction_range=80.0, p_interact=0.3)
CLUSTER = dict(n_groups=4, group_radius=120.0)
HEU = dict(mf=1.2, mt=5)
STATE_KEYS = ("pos", "waypoint", "mob", "mob_g", "lp", "epi", "pending_dst",
              "pending_eta", "ring", "ptr", "since_eval", "last_mig")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# helpers against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ncell,r", [(7, 1), (8, 2), (5, 3), (4, 4),
                                     (16, 3)])
def test_dilate_mask_equals_reference_and_brute_force(ncell, r):
    occ = np.random.default_rng(ncell * 10 + r).random((3, ncell, ncell)) \
        < 0.15
    got = tnb.dilate_mask(_t(occ), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        rnb.dilate_mask(jnp.asarray(occ), r)))
    want = np.zeros_like(occ)
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            want |= np.roll(occ, (dx, dy), (1, 2))
    np.testing.assert_array_equal(got, want)


def test_halo_mask_equals_reference():
    _, tc = cfgs()
    spec = tc.abm.grid_spec()
    g = np.random.default_rng(4)
    ncells = spec.ncell ** 2
    for density in (0.01, 0.1, 0.5):
        cell_ref = g.integers(0, ncells, 2000).astype(np.int32)
        row_cell = g.integers(0, ncells, 300).astype(np.int32)
        row_valid = g.random(300) < density
        got = tnb.halo_mask(_t(cell_ref), _t(row_cell), _t(row_valid),
                            spec).numpy()
        want = np.asarray(rnb.halo_mask(jnp.asarray(cell_ref),
                                        jnp.asarray(row_cell),
                                        jnp.asarray(row_valid),
                                        rnb.GridSpec(**dataclasses.asdict(
                                            spec))))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_lp", [2, 4])
def test_rows_dense_counts_equals_reference(n_lp):
    g = np.random.default_rng(n_lp)
    S, area, rng = 500, 600.0, 150.0
    pos = (g.random((S, 2)) * area).astype(np.float32)
    lp = g.integers(-1, n_lp, S).astype(np.int32)  # -1: empty slots
    rows = np.sort(g.choice(S, 120, replace=False)).astype(np.int32)
    snd = g.random(120) < 0.6
    got = tnb.rows_dense_counts(_t(pos), _t(lp), n_lp, area, rng,
                                _t(pos[rows]), _t(rows), _t(snd),
                                chunk=50).numpy()
    want = np.asarray(rnb.rows_dense_counts(
        jnp.asarray(pos), jnp.asarray(lp), n_lp, area, rng,
        jnp.asarray(pos[rows]), jnp.asarray(rows), jnp.asarray(snd)))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def _register_trace(name):
    spec = dict(n_se=400, area=1000.0, timesteps=30, speed=8.0, n_hubs=4,
                seed=2)
    tr = rpipe.synthetic_trace(rpipe.TraceSpec(**spec))
    rpipe.register_trace(name, tr)
    tpipe.register_trace(name, tpipe.Trace(tr.frames.copy(), tr.area))
    return dict(n_se=400, area=1000.0, mobility="trace", trace_name=name)


def test_max_step_displacement_equals_reference():
    for abm in (dict(mobility=m, **CLUSTER) for m in
                ("rwp", "hotspot", "group", "flock")):
        rc, tc = cfgs(abm=abm)
        assert tabm.max_step_displacement(tc.abm) == \
            rabm.max_step_displacement(rc.abm)
    for policy in ("loop", "hold"):
        rc, tc = cfgs(abm=dict(_register_trace("halo-disp"),
                               trace_policy=policy))
        assert tabm.max_step_displacement(tc.abm) == \
            rabm.max_step_displacement(rc.abm)


def _layout(spec, seed, density=0.8):
    g = np.random.default_rng(seed)
    S = spec.n_slots
    valid = g.random(S) < density
    pos = (g.random((S, 2)) * 1000.0).astype(np.float32)
    pending = np.full(S, -1, np.int32)
    pend = valid & (g.random(S) < 0.25)
    pending[pend] = g.integers(0, spec.n_lp, int(pend.sum()))
    return g, pos, valid, pending


def _toroidal_d2(pos, area):
    d = np.abs(pos[:, None, :] - pos[None, :, :])
    d = np.minimum(d, area - d)
    return (d ** 2).sum(-1)


@pytest.mark.parametrize("n_devices", [2, 4])
@pytest.mark.parametrize("mobility", ["rwp", "hotspot", "group", "flock"])
def test_halo_need_bitmaps_sound_and_equal_reference(mobility, n_devices):
    """Bitmaps from a random layout equal the reference's; after every
    row moves up to the model's displacement bound (to its extreme on
    one seed), every in-range pair across two shards is covered by the
    receiver's need, whether or not a pending row has landed."""
    rc, tc = cfgs(abm=dict(SYM_ABM, mobility=mobility, **CLUSTER),
                  sharding="lp_device", n_devices=n_devices)
    spec = TL.make_shard_spec(tc)
    rspec = RL.make_shard_spec(rc)
    disp = tabm.max_step_displacement(tc.abm)
    for seed in range(4):
        g, pos, valid, pending = _layout(spec, seed)
        need = TL.halo_need_bitmaps(_t(pos), _t(valid), _t(pending), spec,
                                    tc.abm).numpy()
        np.testing.assert_array_equal(need, np.asarray(
            RL.halo_need_bitmaps(jnp.asarray(pos), jnp.asarray(valid),
                                 jnp.asarray(pending), rspec, rc.abm)))
        delta = g.uniform(-disp, disp, pos.shape) if seed else \
            (g.integers(0, 2, pos.shape) * 2 - 1) * disp
        moved = ((pos + delta) % 1000.0).astype(np.float32)
        cell = tnb.cell_ids(_t(moved), spec.grid).numpy()
        d2 = _toroidal_d2(moved.astype(np.float64), 1000.0)
        src = np.arange(spec.n_slots) // spec.cap
        dst = TL.dev_of_lp(np.maximum(pending, 0), spec)
        for owner in (src, np.where(pending >= 0, dst, src)):
            in_range = (valid[:, None] & valid[None, :]
                        & (owner[:, None] != owner[None, :])
                        & (d2 <= 80.0 ** 2))
            missing = in_range & ~need[owner][:, cell]
            assert not missing.any()


def test_halo_views_hold_every_neighbour():
    """The receiver's side, on a running engine: each shard's view
    holds every live SE within range of one of its live rows."""
    _, tc = cfgs(abm=dict(mobility="hotspot", **CLUSTER), heuristic=HEU,
                 sharding="lp_device", n_devices=4)
    spec, mesh = TL.layout(tc)
    st = teng._init_engine(trandom.key(1), tc, CPU)
    phases = TL.sharded_phases(tc)
    for _ in range(6):
        px = {"st": st, "mf": 1.2, "active": None}
        for name, fn in phases:
            px = fn(px)
            if name == "halo_exchange":
                view_pos, view_lp = px["view_pos"], px["view_lp"]
        st = px["new_state"]
        pos, lp = px["f"]["pos"], px["f"]["lp"]  # post-mobility own rows
        flat = pos.reshape(-1, 2).numpy().astype(np.float64)
        live = (lp.reshape(-1) >= 0).numpy()
        d2 = _toroidal_d2(flat, 1000.0)
        owner = np.arange(flat.shape[0]) // spec.cap
        for d in range(4):
            mine = live & (owner == d)
            want = live & (d2[mine] <= 60.0 ** 2).any(0)
            have = {tuple(p) for p, l in zip(view_pos[d].numpy(),
                                             view_lp[d].numpy()) if l >= 0}
            assert all(tuple(p) in have for p in
                       pos.reshape(-1, 2).numpy()[want])


# ---------------------------------------------------------------------------
# the wire, the buffers
# ---------------------------------------------------------------------------


def test_bytes_on_wire_matches_hand_count():
    """A frozen 2-shard world (speed 0, GAIA off): the only traffic is
    the halo, so wire_flows is the hand count of the rows each need
    bitmap asks for, 12 B a row, in both steps."""
    _, tc = cfgs(abm=dict(n_se=24, n_lp=2, area=4000.0, speed=0.0,
                          interaction_range=250.0, p_interact=1.0),
                 gaia_on=False, timesteps=2, sharding="lp_device",
                 n_devices=2)
    spec, mesh = TL.layout(tc)
    st = TL.init_sharded(trandom.key(5), tc, spec, CPU, mesh)
    need = st["halo_need"].numpy()
    valid = st["gid"].reshape(-1).numpy() >= 0
    dev = np.arange(spec.n_slots) // spec.cap
    cell = tnb.cell_ids(st["pos"].reshape(-1, 2), spec.grid).numpy()
    expected = np.zeros((2, 2), np.int64)
    for recv in range(2):
        rows = valid & (dev != recv) & need[recv][cell]
        for src in range(2):
            expected[src, recv] = ((rows & (dev == src)).sum()
                                   * TL.HALO_ROW_BYTES)
    assert expected.sum() > 0
    for _ in range(2):
        st, m = TL.step_sharded(st, tc)
        np.testing.assert_array_equal(m["wire_flows"].numpy(), expected)
        assert float(m["bytes_on_wire"]) == expected.sum()


def _oracle_and_sharded(tc, D, seed=7, **kw):
    base = T.Engine(tc, device=CPU).run(seed=seed)
    run = T.Engine(dataclasses.replace(tc, sharding="lp_device",
                                       n_devices=D, **kw),
                   device=CPU).run(seed=seed)
    return base, run


def _population_held(state, n):
    gid = state["gid"].reshape(-1).numpy()
    return sorted(gid[gid >= 0].tolist()) == list(range(n))


def test_tight_mig_capacity_is_exact_or_loud():
    """Migration buffers of 1..64 rows: every setting is bit for bit the
    oracle or raises shard_overflow, and the population is preserved
    (deferred leavers keep their slots)."""
    _, tc = cfgs(abm=SYM_ABM, heuristic=dict(mf=0.8, mt=2), timesteps=16)
    oracle = T.Engine(tc, device=CPU).run(seed=7)
    seen = set()
    for mig in (64, 4, 1):
        cfg = dataclasses.replace(tc, sharding="lp_device", n_devices=4,
                                  mig_capacity=mig)
        st = teng._init_engine(trandom.key(7), cfg, CPU)
        st, series = teng._run_steps(st, cfg, 16)
        assert _population_held(st, 96)
        loud = float(series["shard_overflow"].sum()) > 0
        seen.add(loud)
        if not loud:
            spec, mesh = TL.layout(cfg)
            un = TL.unshard_state(st, spec, mesh)
            for k in STATE_KEYS:
                bits_equal(oracle[0][k].numpy(), un[k].numpy(), k)
    assert seen == {True, False}


def test_tight_halo_capacity_is_exact_or_loud():
    _, tc = cfgs(abm=SYM_ABM, heuristic=HEU, timesteps=10)
    oracle = T.Engine(tc, device=CPU).run(seed=7)
    seen = set()
    for hc in (96, 32, 8, 2):
        st, series, cnt = T.Engine(dataclasses.replace(
            tc, sharding="lp_device", n_devices=4, halo_capacity=hc),
            device=CPU).run(seed=7)
        loud = cnt["shard_overflow"] > 0
        seen.add(loud)
        if not loud:
            for k in STATE_KEYS:
                bits_equal(oracle[0][k].numpy(), st[k].numpy(), k)
    assert seen == {True, False}


def test_zero_migration_run_moves_no_rows():
    """GAIA off and no repartition: nothing reshards, the wire is the
    halo alone, and the run is the oracle's."""
    _, tc = cfgs(abm=dict(mobility="hotspot", **CLUSTER), gaia_on=False,
                 timesteps=10)
    (o_st, _, _), (s_st, ser, cnt) = _oracle_and_sharded(tc, 4)
    assert cnt["migrations"] == 0 and cnt["shard_overflow"] == 0
    for k in STATE_KEYS:
        bits_equal(o_st[k].numpy(), s_st[k].numpy(), k)
    assert cnt["bytes_on_wire"] > 0


def test_bytes_on_wire_falls_as_gaia_clusters():
    _, tc = cfgs(abm=dict(SYM_ABM, mobility="hotspot", **CLUSTER),
                 heuristic=HEU, timesteps=48, sharding="lp_device",
                 n_devices=4)
    _, s_on, c_on = T.Engine(tc, device=CPU).run(seed=3)
    _, s_off, c_off = T.Engine(dataclasses.replace(tc, gaia_on=False),
                               device=CPU).run(seed=3)
    b_on, b_off = s_on["bytes_on_wire"].numpy(), s_off["bytes_on_wire"].numpy()
    h_on = s_on["halo_frac"].numpy()
    assert h_on[-8:].mean() < h_on[:8].mean()
    assert b_on[-8:].mean() < b_on[:8].mean()
    assert b_on[-8:].mean() < b_off[-8:].mean()


# ---------------------------------------------------------------------------
# the trace replay and the open world, sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [1, 2, 4])
def test_trace_replay_sharded_equals_oracle(D):
    _, tc = cfgs(abm=dict(_register_trace("halo-replay"),
                          trace_policy="loop"), heuristic=HEU, timesteps=20)
    (o_st, o_ser, _), (s_st, s_ser, cnt) = _oracle_and_sharded(tc, D)
    assert cnt["shard_overflow"] == 0
    for k in STATE_KEYS:
        bits_equal(o_st[k].numpy(), s_st[k].numpy(), k)
    for k in o_ser:
        if k in s_ser:
            bits_equal(o_ser[k].numpy(), s_ser[k].numpy(), k)


@pytest.mark.parametrize("mobility", ["rwp", "flock"])
def test_open_world_sharded_equals_oracle(mobility):
    """Zero churn from a partly free universe: the live rows of the
    unsharded state and every series are the oracle's."""
    _, tc = cfgs(abm=dict(mobility=mobility, **CLUSTER), heuristic=HEU,
                 open_world=True, n_active=360, timesteps=14)
    (o_st, o_ser, _), (s_st, s_ser, cnt) = _oracle_and_sharded(tc, 4)
    live = o_st["lp"].numpy() >= 0
    for k in STATE_KEYS:
        a, b = o_st[k].numpy(), s_st[k].numpy()
        if k == "ring":
            a, b = a[:, live], b[:, live]
        elif k != "mob_g":
            a, b = a[live], b[live]
        bits_equal(a, b, k)
    for k in o_ser:
        if k in s_ser:
            bits_equal(o_ser[k].numpy(), s_ser[k].numpy(), k)
    assert cnt["mean_pop"] == 360.0
