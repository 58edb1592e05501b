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
