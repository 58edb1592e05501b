"""The port's clustered mobility models (hotspot, group, flock) against
the reference, on the CPU (the flock's cell-sum kernel on the card:
tests/test_torch_scenario_kernels.py).

Tolerances, measured with JAX 0.9.0 and PyTorch 2.13 on the CPU:
- hotspot and group: the whole state bit for bit on teacher-forced
  steps (the compiled moves are reproduced FMA for FMA, `fp32.fma32`),
  integer series exact free-running, positions within `1e-5 * area`
  (XLA's CPU `sqrt` is not correctly rounded on every CPU);
- flock: two float differences are known and measured. XLA's float32
  `cos`/`sin` of the initial headings are not correctly rounded: the
  port's correctly rounded ones equal them on 98.8% of 200,000 angles
  (PyTorch's float32 ones on 95.0%). And compiled, XLA folds the 3x3
  block sum into the seam fix-ups in its own order, so cells on the
  grid's edge rows and columns sum in another order (the eager
  reference, which adds in the written order, is matched bit for bit).
  So the flock's integer outputs are held exact on teacher-forced steps
  (each from the reference's state), its headings to within HEADING_TOL
  there, and a free-running run to the agreement stated in
  `test_flock_free_running_agreement`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference runs beside the port

import jax  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import neighbors as rnb  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import neighbors as tnb  # noqa: E402
from repro_torch.kernels.cell_sums import ops as cs_ops  # noqa: E402
from repro_torch.kernels.cell_sums import ref as cs_ref  # noqa: E402

from torch_parity import (CPU, assert_integer_series_equal,  # noqa: E402
                          bits_equal, cfgs, run_both, teacher_forced)

#: exp6's clustered settings at the small test world
CLUSTERED = {"n_groups": 8, "group_radius": 60.0}
#: flock headings: teacher-forced, at most this share of heading words
#: may differ from the reference's (measured: 2.4% over 40 steps of
#: 2,000 SEs); positions within one float32 ULP of area per step
HEADING_TOL = 0.05
ULP = 2.0 ** -23


@pytest.mark.parametrize("mobility", ["hotspot", "group", "flock"])
@pytest.mark.parametrize("n,area,rng", [(400, 1000.0, 60.0),
                                        (10_000, 10_000.0, 250.0),
                                        (2_000, 600.0, 250.0)])
def test_grid_spec_equal_reference(mobility, n, area, rng):
    kw = dict(n_se=n, area=area, interaction_range=rng, mobility=mobility)
    r, t = R.ABMConfig(**kw).grid_spec(), T.ABMConfig(**kw).grid_spec()
    assert (r is None) == (t is None) == (area / rng < 3)
    if r is not None:
        assert dataclasses.astuple(r) == dataclasses.astuple(t)


@pytest.mark.parametrize("args", [(10_000, 40, 250.0, 8, 125.0),
                                  (400, 16, 62.5, 1, 1.0),
                                  (50, 3, 10.0, 200, 500.0)])
def test_clustered_capacity_equal_reference(args):
    assert rnb.clustered_capacity(*args) == tnb.clustered_capacity(*args)


@pytest.mark.parametrize("mobility", ["hotspot", "group", "flock"])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_equal_reference(mobility, seed):
    """The init (eager in the reference: no FMA): positions, attractor
    rows and member offsets bit for bit; the flock's headings agree on
    at least 97% of their words (98.8% measured over 200,000 angles)."""
    rc, tc = cfgs(abm=dict(CLUSTERED, mobility=mobility))
    ref = R.Engine(rc).init(seed=seed).state
    got = T.Engine(tc, device=CPU).init(seed=seed).state
    for k in ("pos", "lp", "mob_g", "waypoint", "epi"):
        bits_equal(ref[k], got[k].numpy(), k)
    if mobility == "flock":
        same = np.asarray(ref["mob"]) == got["mob"].numpy()
        assert same.mean() >= 0.97
        assert np.abs(np.asarray(ref["mob"]) - got["mob"].numpy()).max() \
            <= 2 ** -23
    else:
        bits_equal(ref["mob"], got["mob"].numpy(), "mob")


@pytest.mark.parametrize("mobility", ["hotspot", "group"])
def test_clustered_teacher_forced_bit_equal(mobility):
    """Each of 12 steps from the reference's state: the whole state and
    every metric bit for bit, GAIA on."""
    rc, tc = cfgs(abm=dict(CLUSTERED, mobility=mobility),
                  heuristic={"mf": 1.2, "mt": 10})
    for rst, tst, rm, tm in teacher_forced(rc, tc, seed=7, steps=12):
        for k in rst:
            bits_equal(rst[k], tst[k], k)
        for k in rm:
            bits_equal(rm[k], tm[k], k)


@pytest.mark.parametrize("mobility", ["hotspot", "group"])
def test_clustered_free_running_exact(mobility):
    """40 steps: integer series and the final LP map exact, positions
    within 1e-5 * area, and the grid never overflows."""
    rc, tc = cfgs(abm=dict(CLUSTERED, mobility=mobility), timesteps=40,
                  heuristic={"mf": 1.2, "mt": 10})
    (rst, rser, rcnt), (tst, tser, tcnt) = run_both(rc, tc, seed=1)
    assert_integer_series_equal(rser, tser)
    for k in ("lp", "mob_g", "pending_dst"):
        bits_equal(rst[k], tst[k], k)
    assert np.abs(rst["pos"] - tst["pos"]).max() <= 1e-5 * rc.abm.area
    assert tcnt["grid_overflow"] == 0 and tcnt["migrations"] > 0


def test_flock_teacher_forced_integer_outputs_exact():
    """Each of 12 steps from the reference's state: every metric (counts,
    flows, migrations, overflow) exact and the integer state bit for
    bit; at most HEADING_TOL of the heading words differ and positions
    within one ULP of area."""
    rc, tc = cfgs(abm=dict(CLUSTERED, mobility="flock"))
    differ = total = 0
    for rst, tst, rm, tm in teacher_forced(rc, tc, seed=2, steps=12):
        for k in rm:
            bits_equal(rm[k], tm[k], k)
        for k in ("lp", "pending_dst", "pending_eta", "ring", "mob_g"):
            bits_equal(rst[k], tst[k], k)
        assert np.abs(rst["pos"] - tst["pos"]).max() <= \
            rc.abm.area * ULP
        differ += int((rst["mob"] != tst["mob"]).sum())
        total += rst["mob"].size
    assert differ <= HEADING_TOL * total


def test_flock_free_running_agreement():
    """40 free-running steps of 400 SEs, GAIA on, seed 11: the integer
    series are equal (measured), and positions stay within 1e-3 * area
    of the reference's (measured: 357 of 800 position words apart, by at
    most 2.3e-7 * area; 697 of 800 heading words apart)."""
    rc, tc = cfgs(abm=dict(CLUSTERED, mobility="flock"), timesteps=40)
    (rst, rser, _), (tst, tser, _) = run_both(rc, tc, seed=11)
    assert_integer_series_equal(rser, tser)
    assert np.abs(rst["pos"] - tst["pos"]).max() <= 1e-3 * rc.abm.area


@pytest.mark.parametrize("mobility", ["hotspot", "group", "flock"])
def test_transparency_gaia_does_not_change_the_model(mobility):
    """GAIA changes where events are delivered, never what happens:
    positions and headings equal with GAIA on and off."""
    _, on = cfgs(abm=dict(CLUSTERED, mobility=mobility), timesteps=20)
    off = dataclasses.replace(on, gaia_on=False)
    a = T.Engine(on, device=CPU).run(seed=4)[0]
    b = T.Engine(off, device=CPU).run(seed=4)[0]
    for k in ("pos", "mob", "mob_g"):
        assert torch.equal(a[k], b[k]), k


# --- the flock's block means ---------------------------------------------


def _flock_world(seed, n=2000, area=4472.0):
    rc, tc = cfgs(abm=dict(n_se=n, area=area, interaction_range=250.0,
                           mobility="flock"))
    st = R.Engine(rc).init(seed=seed).state
    return rc, tc, np.array(st["pos"]), np.array(st["mob"])


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_sums_equal_the_reference_scatter(seed):
    """The reference's float32 scatter-add (`bin2d`, jitted) adds each
    cell's members in id order: the plain in-order sum equals it bit
    for bit, for the count, positions and headings."""
    rc, tc, pos, mob = _flock_world(seed)
    spec = rc.abm.grid_spec()
    nc = spec.ncell

    @jax.jit
    def bins(pos, vec):
        cell = rnb.cell_ids(pos, spec)
        vals = [pos[:, 0] * 0 + 1, pos[:, 0], pos[:, 1], vec[:, 0],
                vec[:, 1]]
        return [jax.numpy.zeros((nc * nc,), jax.numpy.float32).at[cell].add(
            v, mode="drop") for v in vals]

    want = np.stack([np.asarray(b) for b in bins(pos, mob)])
    tpos, tmob = torch.tensor(pos), torch.tensor(mob)
    grid = tnb.build_grid(tpos, tc.abm.grid_spec())
    got = cs_ops.cell_sums(tpos, tmob, grid)
    bits_equal(want, got.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_block_mean_equals_eager_reference(seed):
    """The block means bit for bit against the reference run eagerly
    (its ops in the written order); against the jitted reference only
    cells on the grid's edge rows and columns may differ."""
    rc, tc, pos, mob = _flock_world(seed)
    spec = rc.abm.grid_spec()
    want = rnb.cell_block_mean(pos, mob, spec, rc.abm.area)
    got = tnb.cell_block_mean(torch.from_numpy(pos), torch.from_numpy(mob),
                              tc.abm.grid_spec(), tc.abm.area)
    for w, g in zip(want, got):
        bits_equal(w, g.numpy())
    jit = jax.jit(lambda p, m: rnb.cell_block_mean(p, m, spec,
                                                   rc.abm.area))(pos, mob)
    cell = np.asarray(rnb.cell_ids(pos, spec))
    cx, cy = cell // spec.ncell, cell % spec.ncell
    edge = (cx <= 1) | (cx >= spec.ncell - 2) | (cy <= 1) | \
        (cy >= spec.ncell - 2)
    for w, g in zip(jit, got):
        apart = (np.asarray(w) != g.numpy()).any(1)
        assert not (apart & ~edge).any()


def test_cell_sums_wrapper_runs_the_plain_version_on_the_cpu():
    _, tc, pos, mob = _flock_world(0, n=300, area=1000.0)
    tpos, tmob = torch.from_numpy(pos), torch.from_numpy(mob)
    grid = tnb.build_grid(tpos, tc.abm.grid_spec())
    cs_ops.reset_launches()
    assert torch.equal(cs_ops.cell_sums(tpos, tmob, grid),
                       cs_ref.cell_sums_plain(tpos, tmob, grid))
    assert cs_ops.launches() == {"cell_sums": 0}
    with pytest.raises(RuntimeError, match="CUDA"):
        cs_ops.cell_sums(tpos.to("meta"), tmob.to("meta"),
                         {k: v.to("meta") if torch.is_tensor(v) else v
                          for k, v in grid.items()})
