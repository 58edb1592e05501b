"""The port's partitioners and the engine's periodic repartition against
the reference, on the CPU.

Tolerances, measured with JAX 0.9.0 and PyTorch 2.13 on the CPU:
- "random", "stripe" and "bestresponse" go through sorts, integer
  counts and sums of unit weights: their maps are exact;
- "kmeans" and "voronoi" go through `sin`, `cos`, `arctan2`, `pow` and
  float matmuls, whose last bits differ between XLA and PyTorch; a map
  can differ only where two of an SE's costs lie within those bits. On
  every layout and seed here (uniform and clustered, 2,000 SEs, three
  seeds, the init and the compiled repartition forms) the maps are
  equal, so they are held exact on these inputs; other inputs may tie;
- every integer series of a run with `repartition_every` is exact
  (oracle path: the reference's sharded repartition is red on some CPUs
  and is not the comparison).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference runs beside the port

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import partition as rpart  # noqa: E402

from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402

from torch_parity import (CPU, assert_integer_series_equal,  # noqa: E402
                          bits_equal, cfgs, run_both, teacher_forced)

N, AREA = 2000, 4472.0


def _layout(kind, seed):
    r = np.random.default_rng(seed)
    if kind == "uniform":
        pos = r.uniform(0, AREA, (N, 2))
    else:  # 8 blobs, some across the seam
        c = r.uniform(0, AREA, (8, 2))
        pos = (c[np.arange(N) % 8] + r.normal(0, 150, (N, 2))) % AREA
    return pos.astype(np.float32)


def _keys(seed):
    key = jax.random.key(seed)
    return key, trandom.wrap_key_data(np.asarray(jax.random.key_data(key)))


def _both(backend, seed, kind, compiled, prev=None, **kw):
    pos = _layout(kind, seed)
    rk, tk = _keys(seed)
    rc = rpart.PartitionConfig(backend=backend, area=AREA, **kw)
    tc = tpart.PartitionConfig(backend=backend, area=AREA, **kw)
    w = jnp.ones((N,), jnp.float32)
    rprev = None if prev is None else jnp.asarray(prev)

    def call(k, p, pv):
        return rpart.partition(k, p, w, rc, prev=pv)

    want = (jax.jit(call) if compiled else call)(rk, jnp.asarray(pos), rprev)
    got = tpart.partition(tk, torch.from_numpy(pos), torch.ones(N), tc,
                          prev=None if prev is None else
                          torch.from_numpy(prev), compiled=compiled)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("backend", ["random", "stripe", "bestresponse"])
@pytest.mark.parametrize("kind", ["uniform", "clustered"])
@pytest.mark.parametrize("seed", [0, 1])
def test_exact_backends_maps_equal(backend, kind, seed):
    want, got = _both(backend, seed, kind, compiled=False)
    bits_equal(want, got)


@pytest.mark.parametrize("backend", ["kmeans", "voronoi"])
@pytest.mark.parametrize("kind", ["uniform", "clustered"])
@pytest.mark.parametrize("compiled", [False, True],
                         ids=["init", "repartition"])
def test_float_backends_maps_equal(backend, kind, compiled):
    """Measured agreement: equal maps on these inputs, for both the
    eager init form and the compiled repartition form."""
    for seed in (0, 1, 2):
        want, got = _both(backend, seed, kind, compiled)
        bits_equal(want, got, f"seed {seed}")


@pytest.mark.parametrize("hysteresis", [0.1, 0.0])
def test_voronoi_with_prev_map_equal(hysteresis):
    """The warm start from the previous map's circular means and the
    membership bonus; an unassigned row (-1) carries nothing."""
    prev = np.random.default_rng(4).integers(-1, 4, N).astype(np.int32)
    want, got = _both("voronoi", 4, "clustered", True, prev=prev,
                      hysteresis=hysteresis)
    bits_equal(want, got)


@pytest.mark.parametrize("shares", [None, (0.4, 0.3, 0.2, 0.1),
                                    (2 / 4.5, 1 / 4.5, 1 / 4.5, 0.5 / 4.5)])
@pytest.mark.parametrize("imbalance", [0.0, 0.05])
def test_capacity_bounds_equal(shares, imbalance):
    rc = rpart.PartitionConfig(shares=shares, imbalance=imbalance)
    tc = tpart.PartitionConfig(shares=shares, imbalance=imbalance)
    for total in (2000.0, 1999.0, 7.0):
        bits_equal(rpart.capacity_bounds(rc, jnp.float32(total)),
                   tpart.capacity_bounds(tc, np.float32(total)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capacity_assign_equal(seed):
    """Ties broken by the flat index, heterogeneous weights, and caps
    tight enough that some SEs take the fallback LP."""
    r = np.random.default_rng(seed)
    n, L = 300, 4
    cost = r.integers(0, 5, (n, L)).astype(np.float32)  # many ties
    w = r.choice([0.5, 1.0, 2.0], n).astype(np.float32)
    caps = np.full((L,), w.sum() / L * (0.9 + 0.2 * seed), np.float32)
    caps = np.ceil(caps).astype(np.float32)
    want = jax.jit(rpart.capacity_assign)(cost, w, caps)
    got = tpart.capacity_assign(torch.from_numpy(cost), torch.from_numpy(w),
                                caps)
    bits_equal(want, got.numpy())


def test_uses_prev_and_validation():
    for b in tpart.PARTITION_BACKENDS:
        assert tpart.uses_prev(tpart.PartitionConfig(backend=b)) == \
            rpart.uses_prev(rpart.PartitionConfig(backend=b))
    with pytest.raises(ValueError):
        tpart.PartitionConfig(backend="metis")


# --- periodic repartition through the engine ---------------------------------


@pytest.mark.parametrize("backend,mobility", [
    ("stripe", "hotspot"), ("kmeans", "hotspot"), ("bestresponse", "group"),
    ("voronoi", "hotspot"), ("random", "rwp")])
def test_periodic_repartition_exact(backend, mobility):
    """30 steps, a repartition every 10 (and GAIA on): every integer
    series, the LP map and the in-flight state exact, and repartitions
    fired."""
    rc, tc = cfgs(abm={"partitioner": backend, "mobility": mobility,
                       "n_groups": 4, "group_radius": 120.0},
                  heuristic={"mf": 1.2, "mt": 10}, repartition_every=10,
                  timesteps=30)
    (rst, rser, rcnt), (tst, tser, tcnt) = run_both(rc, tc, seed=5)
    assert_integer_series_equal(rser, tser)
    for k in ("lp", "pending_dst", "pending_eta", "last_mig"):
        bits_equal(rst[k], tst[k], k)
    assert tcnt["repartitions"] > 0
    assert rcnt["repartitions"] == tcnt["repartitions"]


def test_repartition_teacher_forced_with_env_shares():
    """kmeans every 4 steps under the hetero env's capacity shares
    (asymmetric balance): each step from the reference's state, the
    whole state and every metric bit for bit."""
    rc, tc = cfgs(abm={"partitioner": "kmeans", "mobility": "hotspot",
                       "n_groups": 4, "group_radius": 120.0},
                  env="hetero", balance="asymmetric", repartition_every=4)
    fired = 0
    for rst, tst, rm, tm in teacher_forced(rc, tc, seed=2, steps=9):
        for k in rst:
            bits_equal(rst[k], tst[k], k)
        for k in rm:
            bits_equal(rm[k], tm[k], k)
        fired += int(tm["repartitions"])
    assert fired > 0


def test_repartition_rides_migration_machinery():
    """Deltas are in-flight migrations issued exactly at steps 6 and 12,
    counted in migrations and mig_flows (GAIA off: every migration is a
    repartition)."""
    _, tc = cfgs(abm={"partitioner": "random"}, gaia_on=False,
                 repartition_every=6, timesteps=14)
    from repro_torch.core import Engine
    _, series, _ = Engine(tc, device=CPU).run(seed=0)
    reparts = series["repartitions"].numpy()
    assert (reparts == series["migrations"].numpy()).all()
    assert np.nonzero(reparts)[0].tolist() == [6, 12]
    np.testing.assert_array_equal(
        series["mig_flows"].numpy().sum(axis=(1, 2)), reparts)


def test_repartition_phase_is_present_only_when_asked():
    from repro_torch.core import engine as teng
    _, tc = cfgs()
    assert "repartition" not in dict(teng.step_phases(tc))
    assert "repartition" in dict(teng.step_phases(
        dataclasses.replace(tc, repartition_every=3)))
