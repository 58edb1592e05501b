"""The scenario fleet's kernels on the card: the flock's cell-sum kernel,
the partitioners' capacity assignment and the epidemic's exposure sweep
(the proximity kernels at n_lp = 2), each bit for bit against its plain
version; and, on the CPU, the wrappers' plain paths. Imports no JAX, so
the card's tests run where it is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_scenario_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import abm as tabm  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import neighbors as tnb  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.capacity_assign import ops as ca_ops  # noqa: E402
from repro_torch.kernels.capacity_assign import ref as ca_ref  # noqa: E402
from repro_torch.kernels.cell_sums import ops as cs_ops  # noqa: E402
from repro_torch.kernels.cell_sums import ref as cs_ref  # noqa: E402

ULP = 2.0 ** -23


def _world(mobility, n, area, seed, device, **kw):
    cfg = T.ABMConfig(n_se=n, area=area, mobility=mobility, **kw)
    return cfg, tabm.init_abm(trandom.key(seed), cfg, device)


def _exposure_inputs(cfg, st, seed):
    hot = trandom.uniform(trandom.key(seed), (cfg.n_se,),
                          device=st["pos"].device) \
        < tabm.epidemic_send_prob(st["epi"], cfg)
    labels = ((st["epi"] > 0) & hot).to(torch.int32)
    return st["pos"], labels, st["epi"] == 0


def test_cell_sums_plain_adds_in_id_order():
    """Each cell's sum is the left-to-right float32 sum of its members
    in id order (checked against a Python loop)."""
    cfg, st = _world("flock", 300, 1000.0, 0, "cpu")
    grid = tnb.build_grid(st["pos"], cfg.grid_spec())
    got = cs_ref.cell_sums_plain(st["pos"], st["mob"], grid)
    cell = grid["cell"].tolist()
    vals = torch.stack([torch.ones(300), st["pos"][:, 0], st["pos"][:, 1],
                        st["mob"][:, 0], st["mob"][:, 1]])
    want = torch.zeros_like(got)
    for i, c in enumerate(cell):  # id order
        want[:, c] = want[:, c] + vals[:, i]
    assert torch.equal(got, want)


def test_epidemic_step_counts_two_sweeps_on_the_cpu(monkeypatch):
    """An epidemic step on the grid backend sweeps the cell list twice
    (proximity, then exposure at n_lp = 2) over one grid build."""
    cfg = T.EngineConfig(abm=T.ABMConfig(n_se=400, area=1000.0,
                                         interaction_range=60.0,
                                         workload="epidemic"))
    from repro_torch.kernels.proximity import ops
    calls = []
    real = ops.proximity_lp_counts_grid
    monkeypatch.setattr(ops, "proximity_lp_counts_grid",
                        lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    st = teng._init_engine(trandom.key(0), cfg, torch.device("cpu"))
    teng.step(st, cfg)
    assert calls == [4, 2]
    assert build.launches(cs_ops.KERNELS) == {"cell_sums": 0}


def _assign_case(kind, seed, device):
    """(cost, weights, caps) of the shapes the partitioners give the
    scan, plus tie-heavy and over-tight ones."""
    g = torch.Generator().manual_seed(seed)
    if kind in ("kmeans", "open"):  # squared distances, 10k x 4
        n, L = 10_000, 4
        cost = torch.rand((n, L), generator=g) * 5e7
    elif kind == "exp5":  # exp5's world: 50k SEs x 8 LPs
        n, L = 50_000, 8
        cost = torch.rand((n, L), generator=g) * 5e7
    elif kind == "bestresponse":  # negated integer affinities
        n, L = 10_000, 4
        cost = -torch.randint(0, 40, (n, L), generator=g).float()
    elif kind in ("ties", "ties_uneven"):
        n, L = 3_000, 7
        cost = torch.randint(0, 3, (n, L), generator=g).float()
    elif kind == "wide":
        n, L = 5_000, 64
        cost = torch.rand((n, L), generator=g)
    else:  # "tight": uneven weights, caps below the total: fallbacks
        n, L = 2_000, 4
        cost = torch.rand((n, L), generator=g)
    if kind in ("tight", "ties_uneven"):
        weights = torch.tensor([0.5, 1.0, 2.0])[
            torch.randint(0, 3, (n,), generator=g)]
    else:
        weights = torch.ones(n)
    if kind == "open":  # the engine's live mask: 9,800 of 10k slots
        weights[torch.randperm(n, generator=g)[:200]] = 0.0
    if kind == "tight":
        caps = np.full((L,), float(weights.sum()) / L * 0.9, np.float32)
    else:
        caps = tpart.capacity_bounds(tpart.PartitionConfig(n_lp=L),
                                     float(weights.sum()))
    return cost.to(device), weights.to(device), caps


#: the kinds whose weights are 0 or 1: the kernel runs its rounds
UNIT_KINDS = ("kmeans", "bestresponse", "ties", "wide", "open", "exp5")


@pytest.mark.parametrize("kind", ["kmeans", "ties", "tight"])
def test_capacity_assign_plain_fills_within_caps(kind):
    cost, w, caps = _assign_case(kind, 0, "cpu")
    build.reset_launches()
    lp = tpart.capacity_assign(cost, w, caps)
    assert build.launches(ca_ops.KERNELS) == {"capacity_assign": 0}
    assert torch.equal(lp, ca_ref.capacity_assign_plain(cost, w, caps))
    load = torch.zeros(cost.shape[1]).index_add_(0, lp.long(), w)
    if kind != "tight":
        assert (load.numpy() <= caps).all()
    else:  # some SEs fit nowhere and take the roomiest LP
        assert (load.numpy() > caps).any()


@pytest.mark.parametrize("kind", ["kmeans", "bestresponse", "ties", "open"])
def test_capacity_assign_rounds_mirror_equals_plain(kind):
    """The kernel's rounds (their plain-torch mirror) give the greedy
    scan's map on the unit-weight shapes the kernel test takes."""
    cost, w, caps = _assign_case(kind, 0, "cpu")
    got, rounds = ca_ref.capacity_assign_rounds(cost, w, caps)
    assert torch.equal(got, ca_ref.capacity_assign_plain(cost, w, caps))
    assert 1 <= rounds <= 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,area,mobility", [
    (2_000, 4472.0, "flock"), (10_000, 10_000.0, "flock"),
    (10_000, 10_000.0, "hotspot"), (100_000, 31_623.0, "rwp")])
def test_cell_sums_kernel_equals_plain_on_card(cuda, n, area, mobility):
    """The cell-sum kernel bit for bit against its plain version, on
    uniform, clustered and flocking layouts."""
    cfg, st = _world(mobility, n, area, 5, cuda)
    grid = tnb.build_grid(st["pos"], cfg.grid_spec())
    got = cs_ops.cell_sums(st["pos"], st["mob"], grid)
    want = cs_ref.cell_sums_plain(st["pos"], st["mob"], grid)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int(got[0].sum()) == n


@pytest.mark.cuda
def test_cell_sums_kernel_rejects_what_it_does_not_take(cuda):
    cfg, st = _world("flock", 500, 1000.0, 1, cuda)
    grid = tnb.build_grid(st["pos"], cfg.grid_spec())
    with pytest.raises(ValueError, match="vec"):
        cs_ops.cell_sums(st["pos"], st["mob"].double(), grid)
    with pytest.raises(ValueError, match="order"):
        cs_ops.cell_sums(st["pos"], st["mob"],
                         dict(grid, order=grid["order"].int()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["kmeans", "bestresponse", "ties", "wide",
                                  "open", "exp5", "tight", "ties_uneven"])
@pytest.mark.parametrize("seed", [0, 1])
def test_capacity_assign_kernel_equals_plain_on_card(cuda, kind, seed):
    """One launch a call, bit-equal to the plain scan; weights of 0 or 1
    take the rounds, weights of 0.5 and 2.0 the serial scan."""
    cost, w, caps = _assign_case(kind, seed, cuda)
    build.reset_launches()
    got = ca_ops.capacity_assign(cost, w, caps)
    assert build.launches(ca_ops.KERNELS) == {"capacity_assign": 1}
    rounds = int(ca_ops.last_rounds())
    want = ca_ref.capacity_assign_plain(cost.cpu(), w.cpu(), caps)
    assert torch.equal(got.cpu(), want)
    if kind in UNIT_KINDS:
        assert rounds == ca_ref.capacity_assign_rounds(
            cost.cpu(), w.cpu(), caps)[1]
    else:
        assert rounds == 0


@pytest.mark.cuda
def test_capacity_assign_kernel_calls_in_a_row(cuda):
    """Calls in a row (one stream) each start from empty fills."""
    cases = [_assign_case(k, 3, cuda) for k in ("ties", "kmeans", "ties")]
    got = [ca_ops.capacity_assign(*c) for c in cases]
    for c, g in zip(cases, got):
        want = ca_ref.capacity_assign_plain(c[0].cpu(), c[1].cpu(), c[2])
        assert torch.equal(g.cpu(), want)
    with pytest.raises(ValueError, match="LPs"):
        ca_ops.capacity_assign(torch.zeros((4, 65), device=cuda),
                               torch.ones(4, device=cuda), np.ones(65))


@pytest.mark.cuda
def test_partitioners_on_card_equal_cpu(cuda):
    """stripe and bestresponse maps on the card equal the CPU's (sorts,
    integer counts, the kernel's scan)."""
    cfg, st = _world("hotspot", 10_000, 10_000.0, 4, "cpu")
    for backend in ("stripe", "bestresponse"):
        pc = tpart.PartitionConfig(backend=backend)
        want = tpart.partition(None, st["pos"], torch.ones(10_000), pc)
        got = tpart.partition(None, st["pos"].to(cuda),
                              torch.ones(10_000, device=cuda), pc)
        assert torch.equal(got.cpu(), want), backend


@pytest.mark.cuda
def test_flock_block_means_on_card_equal_cpu(cuda):
    """The block means on the card bit for bit against the CPU (the
    kernel's in-order sums), and a flock step's positions within one
    ULP of area."""
    cfg, st = _world("flock", 2_000, 4472.0, 9, "cpu")
    spec = cfg.grid_spec()
    want = tnb.cell_block_mean(st["pos"], st["mob"], spec, cfg.area)
    got = tnb.cell_block_mean(st["pos"].to(cuda), st["mob"].to(cuda), spec,
                              cfg.area)
    for w, g in zip(want, got):
        assert torch.equal(w, g.cpu())
    key = trandom.key(2)
    cp, _ = tabm._flock_step(key, st["pos"], st["mob"], cfg)
    gp, _ = tabm._flock_step(key, st["pos"].to(cuda), st["mob"].to(cuda),
                             cfg)
    assert float((gp.cpu() - cp).abs().max()) <= cfg.area * ULP


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["grid", "dense"])
@pytest.mark.parametrize("n,area", [(2_000, 4472.0), (10_000, 10_000.0)])
def test_exposure_sweep_kernel_equals_plain_on_card(cuda, backend, n, area):
    """The exposure sweep at n_lp = 2 (cell-list or dense kernel) on an
    epidemic layout equals its plain version bit for bit."""
    cfg, st = _world("rwp", n, area, 3, cuda, workload="epidemic",
                     epi_seed_frac=0.05, proximity_backend=backend)
    args = _exposure_inputs(cfg, st, 1)
    got, _ = tabm.epidemic_exposure_overflow(*args, cfg)
    want, _ = tabm.epidemic_exposure_overflow(*(a.cpu() for a in args), cfg)
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) > 0


@pytest.mark.cuda
def test_epidemic_step_launches_the_cell_list_kernel_twice(cuda):
    cfg = T.EngineConfig(abm=T.ABMConfig(n_se=2_000, area=4472.0,
                                         workload="epidemic"))
    st = teng._init_engine(trandom.key(0), cfg, cuda)
    build.reset_launches()
    for _ in range(3):
        st, _ = teng.step(st, cfg)
    torch.cuda.synchronize()
    assert build.launches()["proximity_grid"] == 6
