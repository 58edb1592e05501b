"""The port's cell-list search against `repro.core.neighbors`, exactly.

The reference runs under `jax.jit`, as the engine's compiled scan does:
that is where XLA fuses the range test into an FMA and turns the cell
binning's division by a constant into a multiply by its reciprocal,
which the port reproduces. Layouts: uniform, clustered, seam-straddling
bands, positions exactly on cell seams, and overflowed grids (where the
counts, not only the flag, must match: the same members are dropped).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import neighbors as rn  # noqa: E402
from repro_torch.core import neighbors as tn  # noqa: E402


def _layout(kind, seed, n, area, n_lp=4):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pos = rng.uniform(0, area, (n, 2))
    elif kind == "clustered":  # three tight blobs: overflows the auto cap
        centers = np.array([[0.1, 0.1], [0.5, 0.9], [0.9, 0.4]]) * area
        pos = (centers[np.arange(n) % 3]
               + rng.standard_normal((n, 2)) * 0.015 * area) % area
    elif kind == "seam":  # band straddling the wrap line on both axes
        pos = (rng.uniform(0, area, (n, 2)) * 0.1 - area * 0.05) % area
    pos = pos.astype(np.float32)
    lp = rng.integers(0, n_lp, n).astype(np.int32)
    sender = rng.uniform(size=n) < 0.4
    return pos, lp, sender


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _seam_positions(spec, area):
    """Every cell seam and its float32 neighbours, both axes."""
    seams = (np.arange(spec.ncell + 1) * np.float32(spec.cell))
    seams = seams.astype(np.float32)
    vals = np.concatenate([seams, np.nextafter(seams, np.float32(0)),
                           np.nextafter(seams, np.float32(area))])
    vals = vals[(vals >= 0) & (vals < area)].astype(np.float32)
    xx, yy = np.meshgrid(vals, vals[::-1])
    return np.stack([xx.ravel(), yy.ravel()], 1).astype(np.float32)


@pytest.mark.parametrize("area,rng", [(1000.0, 60.0), (10_000.0, 250.0),
                                      (777.0, 33.0), (100_000.0, 250.0)])
def test_cell_ids_exact_at_seams(area, rng):
    spec = tn.make_grid_spec(1000, area, rng)
    rspec = rn.make_grid_spec(1000, area, rng)
    assert spec.ncell == rspec.ncell and spec.capacity == rspec.capacity
    r = np.random.default_rng(0)
    pos = np.concatenate([_seam_positions(spec, area),
                          r.uniform(0, area, (20000, 2))]).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: rn.cell_ids(p, rspec))(pos))
    got = tn.cell_ids(torch.from_numpy(pos), spec).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["uniform", "clustered", "seam"])
def test_build_grid_exact(kind):
    n, area, rng = 240, 1000.0, 100.0
    pos, _, _ = _layout(kind, 5, n, area)
    spec = tn.make_grid_spec(n, area, rng)
    rspec = rn.make_grid_spec(n, area, rng)
    want = jax.jit(lambda p: rn.build_grid(p, rspec, with_table=False))(pos)
    got = tn.build_grid(torch.from_numpy(pos), spec)
    for k in ("cell", "order", "starts", "counts", "overflow"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["cell_sorted"].numpy(),
                                  np.asarray(want["cell"])[
                                      np.asarray(want["order"])])
    # the uniform auto capacity holds only for a uniform layout
    assert bool(got["overflow"]) == (kind != "uniform")


CASES = [  # kind, seed, n, n_lp, area, rng, capacity
    ("uniform", 1, 200, 4, 1000.0, 80.0, 0),
    ("uniform", 2, 500, 3, 1000.0, 60.0, 0),
    ("uniform", 3, 96, 2, 100.0, 45.0, 0),  # area / rng < 3: no grid
    ("seam", 4, 150, 4, 300.0, 40.0, 150),
    ("seam", 5, 301, 8, 1000.0, 60.0, 301),
    ("clustered", 6, 240, 4, 1000.0, 100.0, 240),
    ("clustered", 7, 240, 4, 1000.0, 100.0, 0),  # overflowed: drop set
    ("uniform", 8, 400, 5, 1000.0, 100.0, 3),  # overflowed: tight cap
]


@pytest.mark.parametrize("kind,seed,n,n_lp,area,rng,cap", CASES)
def test_counts_exact(kind, seed, n, n_lp, area, rng, cap):
    pos, lp, sender = _layout(kind, seed, n, area, n_lp)
    tp, tlp, tsnd = _t(pos, lp, sender)
    dense_ref = jax.jit(lambda p, l, s: rn.dense_lp_counts(
        p, l, s, n_lp, area, rng))(pos, lp, sender)
    dense = tn.dense_lp_counts(tp, tlp, tsnd, n_lp, area, rng, chunk=64)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(dense_ref))
    spec = tn.make_grid_spec(n, area, rng, capacity=cap)
    if spec is None:
        return
    rspec = rn.make_grid_spec(n, area, rng, capacity=cap)
    grid_ref = jax.jit(lambda p, l, s: rn.grid_lp_counts(
        p, l, s, n_lp, area, rng, rspec))(pos, lp, sender)
    for budget in (0, 37):  # one chunk, and many
        got = tn.grid_lp_counts(tp, tlp, tsnd, n_lp, area, rng, spec,
                                budget_entries=budget)
        np.testing.assert_array_equal(got.numpy(), np.asarray(grid_ref))
    overflow = bool(tn.build_grid(tp, spec)["overflow"])
    if overflow:  # the drop set matters: the counts really undercount
        assert int(got.sum()) < int(dense.sum())
    else:
        np.testing.assert_array_equal(got.numpy(), dense.numpy())


def test_toroidal_d2_is_fused():
    """The range test's distance is fma(dx, dx, dy*dy), bit for bit what
    the compiled reference computes."""
    r = np.random.default_rng(3)
    a = r.uniform(0, 1000, (20000, 2)).astype(np.float32)
    b = r.uniform(0, 1000, (20000, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y: rn.toroidal_d2(x, y, 1000.0))(a, b))
    got = tn.toroidal_d2(*_t(a, b), 1000.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_geometry_helpers_match():
    for n, area, rng, cap in ((10_000, 10_000.0, 250.0, 0),
                              (100, 100.0, 40.0, 0),
                              (1000, 1000.0, 100.0, 7),
                              (1_000_000, 100_000.0, 250.0, 0)):
        assert tn.make_grid_spec(n, area, rng, cap) == (
            None if rn.make_grid_spec(n, area, rng, cap) is None else
            tn.GridSpec(**vars(rn.make_grid_spec(n, area, rng, cap))))
    for mb in (0, 1, 64, 512):
        assert tn.chunk_entries(mb) == rn.chunk_entries(mb)
        assert tn.budget_capacity(40, max(mb, 1)) == rn.budget_capacity(
            40, max(mb, 1))
    assert tn.default_capacity(10_000, 40) == rn.default_capacity(10_000, 40)


def test_reciprocal_binning_is_not_true_division():
    """Why `cell_ids` multiplies by the reciprocal: a true division by
    the cell side disagrees with the compiled reference at some seams."""
    spec = rn.make_grid_spec(1000, 100_000.0, 250.0)
    r = np.random.default_rng(0)
    pos = r.uniform(0, 100_000.0, (200_000, 2)).astype(np.float32)
    divided = np.floor(pos / np.float32(spec.cell))
    jitted = np.asarray(jax.jit(lambda p: jnp.floor(p / spec.cell))(pos))
    assert (divided != jitted).any()
