"""The fused MoE gate: its plain version against the Pallas kernel and
against the routing of the reference's `moe_fwd`, and the CUDA kernel
against its plain version on the card.

Tolerances: expert ids and counts exact; top_p to 1e-5 (float32
softmax: exp and the row sum round differently in XLA and PyTorch, a few
ULP of values below 1). The CUDA tests carry the `cuda` marker and skip
without a GPU; on the card, where JAX is not installed, run them with
`python -m pytest --noconftest -m cuda tests/test_torch_moe_gate.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.moe_gate import ops, ref  # noqa: E402

TOP_P_TOL = 1e-5


@pytest.fixture
def jx():
    """JAX and the reference's gate (imported here, so that the card's
    tests run where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.moe_gate.moe_gate import moe_gate
    from repro.kernels.moe_gate.ref import moe_gate_ref
    return jax, moe_gate, moe_gate_ref


def _logits(seed, t, e, scale=2.0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(t, e)) * scale).astype(np.float32)


def _bias(seed, e):
    return (np.random.default_rng(seed + 1).normal(size=e) * 0.1).astype(
        np.float32)


def _check(got, want):
    (p1, e1, c1), (p0, e0, c0) = got, want
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e0))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c0))
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0),
                               atol=TOP_P_TOL, rtol=0)


@pytest.mark.parametrize("t,e,k", [(256, 16, 2), (512, 64, 8), (128, 8, 1)])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("norm_topk", [True, False])
def test_plain_equals_pallas_sweep(jx, t, e, k, use_bias, norm_topk):
    """tests/test_kernels.py's sweep, against the Pallas kernel run in
    interpret mode."""
    _, moe_gate, _ = jx
    x = _logits(t + e + k, t, e)
    b = _bias(t, e) if use_bias else None
    want = moe_gate(x, k, bias=b, norm_topk=norm_topk, interpret=True)
    got = ref.moe_gate_plain(torch.from_numpy(x), k,
                             None if b is None else torch.from_numpy(b),
                             norm_topk)
    _check([g.numpy() for g in got], want)


@pytest.mark.parametrize("t,e,k", [(512, 128, 8), (64, 8, 2)])
def test_plain_equals_moe_fwd_routing(jx, t, e, k):
    """The jnp twin on the LM path: `moe_fwd`'s softmax -> lax.top_k ->
    take_along_axis -> renormalisation (src/repro/models/moe.py:76-84)
    and its bincount of the picks, compiled as moe_fwd is."""
    jax, _, _ = jx
    jnp = jax.numpy

    @jax.jit
    def routing(logits):
        probs = jax.nn.softmax(logits, axis=-1)
        _, top_e = jax.lax.top_k(probs, k)
        top_p = jnp.take_along_axis(probs, top_e, axis=-1)
        top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
        return top_p, top_e, jnp.bincount(top_e.reshape(-1), length=e)

    # router logits as the layer makes them: small-scale float32
    x = _logits(7, t, e, scale=0.7)
    got = ref.moe_gate_plain(torch.from_numpy(x), k, None, True)
    _check([g.numpy() for g in got], routing(x))


def test_ties_break_to_the_lower_id():
    x = torch.zeros((3, 8))
    x[1, 5] = x[1, 2] = 1.0
    top_p, top_e, counts = ref.moe_gate_plain(x, 3, None, False)
    assert top_e.tolist() == [[0, 1, 2], [2, 5, 0], [0, 1, 2]]
    assert counts.tolist() == [3, 2, 3, 0, 0, 1, 0, 0]
    assert torch.equal(top_p[0], torch.full((3,), 0.125))


def test_cpu_wrapper_runs_the_plain_version():
    x = torch.from_numpy(_logits(3, 64, 16))
    b = torch.from_numpy(_bias(3, 16))
    build.reset_launches()
    got = ops.moe_gate(x, 4, bias=b)
    want = ref.moe_gate_plain(x, 4, b, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert build.launches()["moe_gate"] == 0


def test_wrapper_never_falls_back_off_the_cpu():
    x = torch.empty((8, 16), dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.moe_gate(x, 2)


@pytest.mark.parametrize("t,sms,blocks", [
    (0, 132, 1),            # no rows: one block still writes the counts
    (1, 132, 1), (16, 132, 1),   # decode: one block, no workspace
    (17, 132, 2), (8192, 132, 264), (65536, 132, 264), (8192, 1, 2)])
def test_grid_plan(t, sms, blocks):
    """One block for each WARPS rows, at most BLOCKS_PER_SM an SM, and
    never none; the grid's warps cover every row by grid stride."""
    assert ops.grid_plan(t, sms) == blocks
    assert blocks <= max(1, sms * ops.BLOCKS_PER_SM)
    assert blocks * ops.WARPS * -(-max(t, 1) // (blocks * ops.WARPS)) >= t


def test_counts_are_handed_on_zeroed(monkeypatch):
    """A call's counts are the buffer the previous launch at the same E
    was given to zero (zeros on the first call at an E), and each call
    hands a fresh one to its launch; other expert counts keep their own."""
    monkeypatch.setattr(ops, "_ZEROED", {})
    dev = torch.device("cpu")
    first, nxt = ops._counts(dev, 128)
    assert first.dtype == torch.int32 and first.shape == (128,)
    assert not first.any() and nxt is not first
    other, other_nxt = ops._counts(dev, 500)
    assert other.shape == (500,) and not other.any()
    again, nxt2 = ops._counts(dev, 128)
    assert again is nxt and nxt2 is not nxt
    assert ops._counts(dev, 500)[0] is other_nxt


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k,dtype,use_bias", [
    (8192, 128, 8, torch.float32, False),   # prefill, the main path
    (16, 128, 8, torch.float32, False),     # decode
    (1000, 128, 8, torch.bfloat16, True),
    (333, 64, 8, torch.float32, True),
    (77, 8, 2, torch.float32, False),       # the smoke config
    (50, 500, 6, torch.float32, True),      # E not a multiple of 32
    (9, 32, 1, torch.bfloat16, False)])
@pytest.mark.parametrize("norm_topk", [True, False])
def test_kernel_equals_plain_on_card(cuda, t, e, k, dtype, use_bias,
                                     norm_topk):
    x = torch.from_numpy(_logits(t + e, t, e, 0.7)).to(cuda, dtype)
    b = torch.from_numpy(_bias(t, e)).to(cuda) if use_bias else None
    got = ops.moe_gate(x, k, bias=b, norm_topk=norm_topk)
    want = ref.moe_gate_plain(x, k, b, norm_topk)
    torch.cuda.synchronize()
    _check([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want])


def _on_card(cuda, t, e, k, seed, dtype=torch.float32, use_bias=False):
    x = torch.from_numpy(_logits(seed, t, e, 0.7)).to(cuda, dtype)
    b = torch.from_numpy(_bias(seed, e)).to(cuda) if use_bias else None
    return x, b


def _check_on_card(x, k, b=None, norm_topk=True):
    got = ops.moe_gate(x, k, bias=b, norm_topk=norm_topk)
    want = ref.moe_gate_plain(x, k, b, norm_topk)
    torch.cuda.synchronize()
    _check([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want])
    return got


@pytest.mark.cuda
def test_kernel_calls_in_a_row_find_their_counts_zeroed(cuda):
    """Three calls with the same inputs over several blocks: each adds
    into counts its previous launch zeroed, so each call's counts are
    the same, and the buffer left for the next call is zero."""
    x, b = _on_card(cuda, 8192, 128, 8, 1, use_bias=True)
    assert ops.grid_plan(8192, ops._sm_count(cuda)) > 1
    first = _check_on_card(x, 8, b)
    for _ in range(2):
        again = _check_on_card(x, 8, b)
        assert all(torch.equal(g, w) for g, w in zip(again, first))
    assert not ops._ZEROED[(x.device, 128)].any()


@pytest.mark.cuda
def test_kernel_alternating_expert_counts(cuda):
    """Calls alternating E = 128 and E = 500, each E with the counts its
    own previous launch zeroed."""
    for i in range(4):
        e, k = (128, 8) if i % 2 == 0 else (500, 6)
        x, b = _on_card(cuda, 4096 + i, e, k, 10 + i, use_bias=i > 1)
        _check_on_card(x, k, b)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0, 1])
def test_kernel_at_zero_and_one_row(cuda, t):
    """T = 0 gives zero counts; T = 1 is one warp's row."""
    x, _ = _on_card(cuda, t, 128, 8, 3)
    top_p, top_e, counts = _check_on_card(x, 8)
    assert top_p.shape == (t, 8) and top_e.shape == (t, 8)
    assert int(counts.sum()) == 8 * t


@pytest.mark.cuda
def test_kernel_more_rows_than_the_grid_holds(cuda):
    """65,536 rows: each warp of the persistent grid walks many rows."""
    x, b = _on_card(cuda, 65536, 128, 8, 4, use_bias=True)
    assert ops.grid_plan(65536, ops._sm_count(cuda)) * ops.WARPS < 65536
    _check_on_card(x, 8, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_scalar_loads(cuda, dtype):
    """E = 77 (no vector loads: the row stride is not a multiple of a
    lane's chunk), and a row view that starts off the 16-byte
    alignment."""
    x, b = _on_card(cuda, 1000, 77, 3, 5, dtype, use_bias=True)
    _check_on_card(x, 3, b)
    y, _ = _on_card(cuda, 1001, 128, 8, 6, dtype)
    _check_on_card(y[1:], 8)


@pytest.mark.cuda
@pytest.mark.parametrize("e,k", [(128, 8), (500, 6), (8, 2)])
def test_kernel_all_equal_rows_pick_the_first_ids(cuda, e, k):
    """Rows of equal logits tie everywhere: the ids are 0..k-1 in every
    row, each with probability 1/e (1/k renormalised)."""
    x = torch.full((300, e), 0.25, device=cuda)
    top_p, top_e, counts = _check_on_card(x, k)
    assert torch.equal(top_e.cpu(), torch.arange(k, dtype=torch.int32)
                       .expand(300, k))
    assert counts[:k].eq(300).all() and not counts[k:].any()


@pytest.mark.cuda
def test_kernel_ties_from_rounded_logits(cuda):
    """Logits rounded to a few levels: many probabilities tie exactly,
    with and without a bias, and the lower id must win each tie."""
    x, b = _on_card(cuda, 8192, 128, 8, 7)
    x = torch.round(x * 2) / 2
    _check_on_card(x, 8)
    _check_on_card(x, 8, b=torch.zeros(128, device=cuda).index_fill_(
        0, torch.arange(0, 128, 3, device=cuda), 0.125))


@pytest.mark.cuda
def test_kernel_on_a_side_stream(cuda):
    """A call on another stream, ordered after the current one, finds
    its counts zeroed and gives the same result."""
    x, b = _on_card(cuda, 8192, 128, 8, 8, use_bias=True)
    want = ops.moe_gate(x, 8, bias=b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = ops.moe_gate(x, 8, bias=b)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError, match="k="):
        ops.moe_gate(x, 17)
    with pytest.raises(ValueError, match="E="):
        ops.moe_gate(torch.zeros((4, 600), device=cuda), 2)
    with pytest.raises(ValueError, match="bias"):
        ops.moe_gate(x, 2, bias=torch.zeros(16, device=cuda,
                                            dtype=torch.float64))
    with pytest.raises(ValueError, match="strided"):
        ops.moe_gate(torch.zeros((16, 4), device=cuda).T, 2)
