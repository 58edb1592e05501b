"""The two proximity kernels: their plain versions against the Pallas
kernels, and the kernels against their plain versions on the card.

Here, without a GPU, the plain versions (`kernels/proximity/ref.py`) are
held exactly to the Pallas TPU kernels run with `interpret=True` — as
tests/test_kernels.py runs them — and to `proximity_lp_counts_ref`, on
uniform, toroidal-edge and non-sender cases. The CUDA kernels run only
on the card: those tests carry the `cuda` marker and skip here. On the
card, where JAX is not installed, run them with
`python -m pytest --noconftest -m cuda tests/test_torch_proximity.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import neighbors as tn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.proximity import ops, ref  # noqa: E402
from torch_layouts import CASES, layout  # noqa: E402


@pytest.fixture
def pallas():
    """The reference's proximity kernels (imported here, so that the
    card's tests run where JAX is not installed)."""
    pytest.importorskip("jax")
    from repro.core import neighbors
    from repro.kernels import proximity
    return neighbors, proximity


def _case(seed, n, n_lp, area, p_send=0.4):
    r = np.random.default_rng(seed)
    pos = r.uniform(0, area, (n, 2)).astype(np.float32)
    lp = r.integers(0, n_lp, n).astype(np.int32)
    sender = r.uniform(size=n) < p_send
    return pos, lp, sender


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plain_both(pos, lp, sender, n_lp, area, rng, cap=0):
    tp, tl, ts = _t(pos, lp, sender)
    dense = ref.dense_lp_counts_plain(tp, tl, ts, n_lp, area, rng).numpy()
    spec = tn.make_grid_spec(len(pos), area, rng, capacity=cap)
    grid = ref.grid_lp_counts_plain(tp, tl, ts, n_lp, area, rng, spec,
                                    tn.build_grid(tp, spec)).numpy()
    return dense, grid


@pytest.mark.parametrize("n,n_lp,area,rng", [
    (256, 4, 1000.0, 80.0), (300, 3, 1000.0, 100.0), (517, 8, 2000.0, 150.0)])
def test_plain_equals_pallas_interpret(pallas, n, n_lp, area, rng):
    rn, kern = pallas
    pos, lp, sender = _case(n, n, n_lp, area)
    dense, grid = _plain_both(pos, lp, sender, n_lp, area, rng)
    want = np.asarray(kern.proximity_lp_counts_ref(pos, lp, sender, n_lp,
                                                   area, rng))
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(grid, want)
    np.testing.assert_array_equal(dense, np.asarray(kern.proximity_lp_counts(
        pos, lp, sender, n_lp, area, rng, interpret=True)))
    spec = rn.make_grid_spec(n, area, rng)
    np.testing.assert_array_equal(grid, np.asarray(
        kern.proximity_lp_counts_grid(pos, lp, sender, n_lp, area, rng, spec,
                                      interpret=True)))


def test_plain_toroidal_edge(pallas):
    """Pairs across the wrap seam are neighbours, as in the Pallas
    kernel's own test."""
    pos = np.array([[1.0, 1.0], [999.0, 999.0], [500.0, 500.0],
                    [998.0, 2.0], [3.0, 997.0], [250.0, 999.5]], np.float32)
    lp = np.array([0, 1, 0, 1, 0, 1], np.int32)
    sender = np.ones(6, bool)
    dense, grid = _plain_both(pos, lp, sender, 2, 1000.0, 10.0)
    want = np.asarray(pallas[1].proximity_lp_counts(
        pos, lp, sender, 2, 1000.0, 10.0, interpret=True))
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(grid, want)
    assert dense[0].tolist() == [1, 2]  # (999, 999), (998, 2), (3, 997)


def test_plain_nonsenders_zero(pallas):
    pos, lp, sender = _case(7, 200, 3, 100.0, p_send=0.5)
    dense, grid = _plain_both(pos, lp, sender, 3, 100.0, 30.0)
    want = np.asarray(pallas[1].proximity_lp_counts(
        pos, lp, sender, 3, 100.0, 30.0, interpret=True))
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(grid, want)
    assert (dense[~sender] == 0).all() and dense[sender].sum() > 0


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors the wrappers return the plain versions' counts and
    launch nothing."""
    n, n_lp, area, rng = 300, 4, 1000.0, 80.0
    tp, tl, ts = _t(*_case(1, n, n_lp, area))
    spec = tn.make_grid_spec(n, area, rng)
    grid = tn.build_grid(tp, spec)
    ops.reset_launches()
    got = ops.proximity_lp_counts_grid(tp, tl, ts, n_lp, area, rng, spec,
                                       grid)
    want = ref.grid_lp_counts_plain(tp, tl, ts, n_lp, area, rng, spec, grid)
    assert torch.equal(got, want)
    assert torch.equal(ops.proximity_lp_counts(tp, tl, ts, n_lp, area, rng),
                       ref.dense_lp_counts_plain(tp, tl, ts, n_lp, area,
                                                 rng))
    assert ops.launches() == {"proximity_grid": 0, "proximity_dense": 0}


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor on another device than the CPU goes to the kernel or
    raises: the plain version is never a fallback."""
    pos = torch.empty((8, 2), dtype=torch.float32, device="meta")
    lp = torch.empty((8,), dtype=torch.int32, device="meta")
    snd = torch.empty((8,), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.proximity_lp_counts(pos, lp, snd, 4, 100.0, 10.0)


def test_build_is_keyed_by_source_and_needs_nvcc(tmp_path, monkeypatch):
    srcs = build.sources()
    assert {s.stem for s in srcs} == {
        "proximity_grid", "proximity_dense", "moe_gate", "flash_attention",
        "flash_decode", "cell_sums", "capacity_assign",
        "flash_attention_bwd", "moe_gate_bwd"}
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    paths = [build.library_path(s) for s in srcs]
    assert len(set(paths)) == 9 and all(p.parent == tmp_path for p in paths)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


#: (kind, seed, n, n_lp, area, rng, capacity, senders): the layout cases
#: of tests/test_torch_neighbors.py (overflowed and clustered grids
#: among them), then the shapes that stress the kernels' decompositions;
#: senders "draw" keeps the layout's draw, "none" / "all" override it
CARD_CASES = [(*case, "draw") for case in CASES] + [
    ("uniform", 10_000, 10_000, 4, 10_000.0, 250.0, 0, "draw"),  # engine
    ("uniform", 2000, 2000, 4, 600.0, 250.0, 0, "draw"),  # dense world
    ("uniform", 777, 777, 50, 1000.0, 90.0, 0, "draw"),
    ("uniform", 9, 900, 64, 1000.0, 100.0, 0, "draw"),  # n_lp 64
    ("uniform", 10, 600, 7, 300.0, 100.0, 0, "draw"),  # ncell == 3
    # cells of ~200 members: one sender's candidates span several chunks
    ("clustered", 11, 3000, 4, 1000.0, 100.0, 3000, "draw"),
    ("clustered", 15, 2000, 64, 1000.0, 100.0, 2000, "all"),
    # every cell ~80 members: each cell's tail beside the next one's head
    ("uniform", 16, 8000, 4, 1000.0, 100.0, 8000, "draw"),
    ("uniform", 12, 20, 3, 1000.0, 300.0, 0, "all"),  # below one tile
    ("uniform", 13, 500, 4, 1000.0, 100.0, 0, "none"),
    ("uniform", 14, 500, 9, 1000.0, 100.0, 0, "all"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,seed,n,n_lp,area,rng,cap,senders",
                         CARD_CASES)
def test_kernels_equal_plain_on_card(cuda, kind, seed, n, n_lp, area, rng,
                                     cap, senders):
    """Both kernels bit-equal to their plain versions, and two calls in a
    row bit-equal to each other (the dense kernel sums with atomics into
    an output its launch zeroes; the cell-list kernel writes every row
    of a `torch.empty` output once)."""
    pos, lp, sender = layout(kind, seed, n, area, n_lp)
    if senders != "draw":
        sender = np.full(n, senders == "all")
    tp, tl, ts = (t.to(cuda) for t in _t(pos, lp, sender))
    want = ref.dense_lp_counts_plain(tp, tl, ts, n_lp, area, rng)
    got = ops.proximity_lp_counts(tp, tl, ts, n_lp, area, rng)
    assert torch.equal(got, want)
    assert torch.equal(ops.proximity_lp_counts(tp, tl, ts, n_lp, area, rng),
                       got)
    spec = tn.make_grid_spec(n, area, rng, capacity=cap)
    if spec is not None:
        grid = tn.build_grid(tp, spec)
        got = ops.proximity_lp_counts_grid(tp, tl, ts, n_lp, area, rng,
                                           spec, grid)
        assert torch.equal(got, ref.grid_lp_counts_plain(
            tp, tl, ts, n_lp, area, rng, spec, grid))
        assert torch.equal(ops.proximity_lp_counts_grid(
            tp, tl, ts, n_lp, area, rng, spec, grid), got)
        if not bool(grid["overflow"]):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    tp, tl, ts = (t.to(cuda) for t in _t(*_case(0, 64, 4, 100.0)))
    with pytest.raises(ValueError, match="n_lp"):
        ops.proximity_lp_counts(tp, tl, ts, 65, 100.0, 10.0)
    with pytest.raises(ValueError, match="int32"):
        ops.proximity_lp_counts(tp, tl.long(), ts, 4, 100.0, 10.0)
