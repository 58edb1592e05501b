"""The sharded engine's kernels on the card: the cell-list kernel over
the stacked shard views (each shard's own rows against its view, halo
and padding rows written as zeros), the dense kernel with one shard's
senders over the gathered world, one cell-list launch a step whatever
the shard count, and the card's sharded run against the CPU's. Imports
no JAX, so it runs where that is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_sharding_kernels.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import neighbors as tnb  # noqa: E402
from repro_torch.kernels.proximity import ops as prox  # noqa: E402
from repro_torch.kernels.proximity import ref as prox_ref  # noqa: E402
from repro_torch.parallel import lp_shard as TL  # noqa: E402

CPU = torch.device("cpu")
torch.set_num_threads(1)
#: the default config's shape at 1/25 the SEs
SMALL = dict(n_se=400, area=1000.0, interaction_range=60.0)


def _cfg(D, n_lp=4, **abm):
    return T.EngineConfig(
        abm=T.ABMConfig(**{**SMALL, "n_lp": n_lp, **abm}),
        heuristic=T.HeuristicConfig(mf=1.2, mt=5), timesteps=12,
        sharding="lp_device", n_devices=D)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


def _context_after(cfg, phase, device, steps=3):
    """The phase context of step `steps` of a sharded run on `device`,
    just after `phase`."""
    st = teng._init_engine(trandom.key(2), cfg, device)
    st, _ = teng._run_steps(st, cfg, steps)
    px = {"st": st, "mf": cfg.heuristic.mf, "active": None}
    for name, fn in TL.sharded_phases(cfg):
        px = fn(px)
        if name == phase:
            return px


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_cell_list_over_stacked_views_equals_plain(cuda, D):
    cfg = _cfg(D, mobility="hotspot", n_groups=4, group_radius=120.0)
    spec, _ = TL.layout(cfg)
    px = _context_after(cfg, "halo_exchange", cuda)
    vp, vl = px["view_pos"], px["view_lp"]
    V = vp.shape[-2]
    snd = torch.cat([px["sender"], torch.zeros(
        (D, V - spec.cap), dtype=torch.bool, device=cuda)], -1)
    grid = tnb.build_grid(vp, spec.grid, valid=vl >= 0)
    torch.cuda.synchronize()
    got = prox.proximity_lp_counts_grid(vp, vl, snd, 4, 1000.0, 60.0,
                                        spec.grid, grid)
    want = prox_ref.grid_lp_counts_plain(vp, vl, snd, 4, 1000.0, 60.0,
                                         spec.grid, grid)
    assert torch.equal(got, want)
    # halo and padding rows are non-senders: written as zeros
    assert not got[:, spec.cap:].any()
    assert got[:, :spec.cap].sum() > 0


@pytest.mark.cuda
def test_dead_and_padded_view_rows_are_zeros(cuda):
    """Output memory filled with a nonzero pattern first: every row of
    a view that is not an asking own row comes out zero."""
    cfg = _cfg(4)
    spec, _ = TL.layout(cfg)
    px = _context_after(cfg, "halo_exchange", cuda)
    vp, vl = px["view_pos"], px["view_lp"]
    V = vp.shape[-2]
    snd = torch.cat([vl[:, :spec.cap] >= 0, torch.zeros(
        (4, V - spec.cap), dtype=torch.bool, device=cuda)], -1)
    grid = tnb.build_grid(vp, spec.grid, valid=vl >= 0)
    torch.cuda.empty_cache()
    junk = torch.full((4 * V * 4,), 7, dtype=torch.int32, device=cuda)
    ptr = junk.data_ptr()
    del junk  # the caching allocator hands the same block out again
    got = prox.proximity_lp_counts_grid(vp, vl, snd, 4, 1000.0, 60.0,
                                        spec.grid, grid)
    assert got.data_ptr() == ptr  # the output landed in the dirtied block
    assert not got[~snd].any()
    assert torch.equal(got, prox_ref.grid_lp_counts_plain(
        vp, vl, snd, 4, 1000.0, 60.0, spec.grid, grid))


@pytest.mark.cuda
def test_dense_with_one_shards_senders_equals_plain(cuda):
    cfg = _cfg(2, area=600.0, interaction_range=250.0,
               proximity_backend="dense")
    spec, _ = TL.layout(cfg)
    px = _context_after(cfg, "halo_exchange", cuda)
    pos_g, lp_g = px["pos_g"], px["lp_g"]
    for d in range(2):
        snd = torch.zeros((2, spec.cap), dtype=torch.bool, device=cuda)
        snd[d] = px["sender"][d]
        snd = snd.reshape(-1)
        got = prox.proximity_lp_counts(pos_g, lp_g, snd, 4, 600.0, 250.0)
        assert torch.equal(got, prox_ref.dense_lp_counts_plain(
            pos_g, lp_g, snd, 4, 600.0, 250.0))
        assert not got.view(2, spec.cap, 4)[1 - d].any()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_one_cell_list_launch_a_step(cuda, D):
    cfg = _cfg(D, n_lp=8)
    st = teng._init_engine(trandom.key(0), cfg, cuda)
    prox.reset_launches()
    st, series = teng._run_steps(st, cfg, 10)
    torch.cuda.synchronize()
    assert prox.launches() == {"proximity_grid": 10, "proximity_dense": 0}
    assert float(series["shard_overflow"].sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("abm", [{}, {"workload": "epidemic"},
                                 {"mobility": "flock", "n_groups": 4}])
def test_card_sharded_run_equals_cpu(cuda, abm):
    cfg = dataclasses.replace(_cfg(4, **abm), timesteps=20)
    gst, gser, gc = T.Engine(cfg, device=cuda).run(seed=1)
    cst, cser, cc = T.Engine(cfg, device=CPU).run(seed=1)
    for k in ("lp", "pending_dst", "ring", "last_mig", "epi"):
        assert torch.equal(gst[k].cpu(), cst[k]), k
    for k in ("local_msgs", "remote_msgs", "migrations", "lp_flows",
              "wire_flows", "shard_overflow"):
        assert torch.equal(gser[k].cpu(), cser[k]), k
    ulp = 1000.0 * 2.0 ** -23
    d = (gst["pos"].cpu() - cst["pos"]).abs()
    assert float(torch.minimum(d, 1000.0 - d).max()) <= 20 * ulp
