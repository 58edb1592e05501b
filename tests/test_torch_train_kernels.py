"""The training path's kernels: the flash-attention backward (and the
forward's row log-sum-exp), the MoE gate's backward and its
probability-mean forward.

On the CPU: the wrappers' differentiable plain paths, and the algorithm
each backward kernel runs, written out in float64 torch (the row sums
delta, P recomputed from the log-sum-exp, dS = P (dP - delta); the
gate's d probs through the renormalisation), against autograd through
the plain versions. On the card (`cuda` marker, skipped without a GPU):
each kernel against its plain twin, in every dtype and head dim the
kernels take, at GQA groups 1-8 (qwen2-7b's 7 among them), calls in a
row bit-equal, the serve path's launches unchanged, and what the
kernels do not take raising (qwen2-smoke's head dim 8 among it); the
backward's wgmma path (bf16 at D 64 and 128) at groups 1, 2, 7 and 8,
ragged and Skv != S, with the names of the kernels that ran.

Tolerances: float32 ATOL/RTOL 1e-5 of the largest |value| of the plain
result (summation order); bfloat16 2e-2 of it (the kernel rounds P and
dS to bf16 as the A operands of its products, the plain version rounds
P once over the row); the gate's d logits 1e-5 (float32 arithmetic in
another order). This file imports no JAX: on the card run
`python -m pytest --noconftest -m cuda tests/test_torch_train_kernels.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.moe_gate import ops as mg_ops  # noqa: E402
from repro_torch.kernels.moe_gate import ref as mg_ref  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GATE_TOL = 1e-5


def _rand(seed, shape, dtype=torch.float32, device="cpu", scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dtype).to(device)


def _err(got, want):
    """max |got - want| as a share of max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


# --- the algorithms, on the CPU -----------------------------------------------


def _fa2_backward(q, k, v, dout, causal):
    """The backward kernel's algorithm in float64: lse from the forward,
    delta = rowsum(dO O), P = exp(s scale - lse), dS = P (dP - delta),
    dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K; K/V gradients summed
    over each group's heads."""
    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    H, Hkv, D = q.shape[1], k.shape[1], q.shape[-1]
    G, scale = H // Hkv, D ** -0.5
    out = fa_ref.flash_attention_plain(q, k, v, causal)
    lse = fa_ref.flash_attention_lse_plain(q, k, causal).double()
    delta = (dout * out).sum(-1)
    kx, vx = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = q @ kx.transpose(-1, -2) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        S, Skv = q.shape[2], k.shape[2]
        keep = torch.ones(S, Skv, dtype=torch.bool).tril()
        p = p.masked_fill(~keep, 0.0)
    ds = p * (dout @ vx.transpose(-1, -2) - delta[..., None])
    dq = ds @ kx * scale
    dkx = ds.transpose(-1, -2) @ q * scale
    dvx = p.transpose(-1, -2) @ dout
    B, Skv = k.shape[0], k.shape[2]
    dk = dkx.reshape(B, Hkv, G, Skv, D).sum(2)
    dv = dvx.reshape(B, Hkv, G, Skv, D).sum(2)
    return dq, dk, dv


@pytest.mark.parametrize("H,Hkv,S,Skv,causal", [
    (4, 2, 37, 37, True), (7, 1, 20, 33, True), (4, 4, 24, 11, True),
    (8, 2, 19, 29, False)])
def test_attention_backward_algorithm_equals_autograd(H, Hkv, S, Skv,
                                                      causal):
    q = _rand(1, (2, H, S, 16)).double()
    k = _rand(2, (2, Hkv, Skv, 16)).double()
    v = _rand(3, (2, Hkv, Skv, 16)).double()
    do = _rand(4, (2, H, S, 16)).double()
    want = fa_ref.flash_attention_grads_plain(q, k, v, do, causal)
    got = _fa2_backward(q, k, v, do, causal)
    for g, w in zip(got, want):  # the plain version computes in float32
        assert g.shape == w.shape
        assert _err(g, w) <= 1e-5


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, 2 * 2 * 8 * 192 + 2 * 2 * 8 * 130 * 64),
    (torch.bfloat16, 128, 2 * 2 * 8 * 192 + 2 * 2 * 8 * 130 * 128),
    (torch.bfloat16, 32, 2 * 8 * 130), (torch.float32, 64, 2 * 8 * 130)])
def test_backward_workspace_size(dtype, D, want):
    """The backward's float32 scratch: the wgmma path's padded lse and
    delta rows (S 130 -> 192) and the group's partials; delta elsewhere;
    no partials when every query head has its own KV head."""
    assert fa_ops.bwd_workspace(2, 8, 2, 130, 130, D, dtype) == want
    if D >= 64 and dtype == torch.bfloat16:
        assert fa_ops.bwd_workspace(2, 8, 8, 130, 130, D, dtype) == \
            2 * 2 * 8 * 192


def test_attention_cpu_wrapper_is_differentiable():
    """On the CPU the wrapper is the plain version, so autograd runs
    through it; no kernel is launched."""
    q = _rand(1, (1, 4, 21, 16)).requires_grad_()
    k = _rand(2, (1, 2, 21, 16)).requires_grad_()
    v = _rand(3, (1, 2, 21, 16)).requires_grad_()
    build.reset_launches()
    out = fa_ops.flash_attention(q, k, v, True)
    assert out.grad_fn is not None
    do = _rand(4, out.shape)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = fa_ref.flash_attention_grads_plain(q, k, v, do, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert build.launches()["flash_attention"] == 0
    assert build.launches()["flash_attention_bwd"] == 0


def _gate_backward(logits, k, norm, g_top_p, g_pm):
    """The gate backward kernel's algorithm in float64."""
    x = logits.double()
    p = torch.softmax(x, -1)
    top_e = mg_ref.moe_gate_plain(logits, k, None, norm)[1].long()
    raw = p.gather(1, top_e)
    g = g_top_p.double()
    if norm:
        s = raw.sum(-1, keepdim=True)
        d_raw = g / s - (g * raw).sum(-1, keepdim=True) / s ** 2
    else:
        d_raw = g
    dp = torch.zeros_like(p) + g_pm.double()[None] / x.shape[0]
    dp.scatter_add_(1, top_e, d_raw)
    return p * (dp - (p * dp).sum(-1, keepdim=True))


@pytest.mark.parametrize("norm", [True, False])
def test_gate_backward_algorithm_equals_autograd(norm):
    logits = _rand(5, (64, 16), scale=1.5)
    gtp, gpm = _rand(6, (64, 4)), _rand(7, (16,))
    want = mg_ref.moe_gate_grads_plain(logits, 4, None, norm, gtp, gpm)
    got = _gate_backward(logits, 4, norm, gtp, gpm)
    assert _err(got, want) <= 1e-5


def _butterfly(x):
    """A 32-lane xor-shuffle sum over the last axis in float32, as
    `__shfl_xor_sync` at offsets 16 .. 1: every lane ends with the same
    value."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ o]
    return x


def _epl(E):
    """Experts a lane holds (csrc/gate_rows.cuh): the least of 1, 2, 4,
    8, 16 with 32 * EPL >= E."""
    return next(n for n in (1, 2, 4, 8, 16) if 32 * n >= E)


def _gate_backward_lanes(logits, k, norm, g_top_p, g_pm):
    """The backward kernel's lane layout in float32: lane l holds
    experts [l EPL, (l + 1) EPL); the softmax sums per lane in slot order
    and then by butterfly; each pick's d_raw is added by the lane that
    holds its expert; the dot is an FMA chain per lane and a butterfly."""
    from repro_torch.fp32 import fma32
    T, E = logits.shape
    epl = _epl(E)
    x = torch.full((T, 32 * epl), -torch.inf)
    x[:, :E] = logits.float()
    x = x.view(T, 32, epl)
    v = torch.exp(x - x.amax((1, 2), keepdim=True))
    s = torch.zeros(T, 32)
    for i in range(epl):
        s = s + v[..., i]
    p = v / _butterfly(s)[..., None]
    top_e = mg_ref.moe_gate_plain(logits, k, None, norm)[1].long()
    lanes = lambda a: torch.cat([a, torch.zeros(T, 32 - k)], 1)  # noqa
    raw = lanes(p.reshape(T, -1).gather(1, top_e))
    g = lanes(g_top_p.float())
    d_raw = g
    if norm:
        sm, gs = _butterfly(raw), _butterfly(g * raw)
        sc = sm.clamp(min=1e-9)
        d_raw = torch.where(sm >= 1e-9, g / sc - gs / (sc * sc), g / sc)
    inv_t = torch.tensor(1.0 / T, dtype=torch.float32)
    d = torch.zeros(T, 32 * epl)
    d[:, :E] = g_pm.float()[None] * inv_t
    rows = torch.arange(T)[:, None]
    d[rows, top_e] = d[rows, top_e] + d_raw[:, :k]  # distinct picks
    d = d.view(T, 32, epl)
    dot = torch.zeros(T, 32)
    for i in range(epl):
        dot = fma32(p[..., i], d[..., i], dot)
    out = p * (d - _butterfly(dot)[..., None])
    return out.reshape(T, -1)[:, :E]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("T,E,k", [(64, 128, 8), (50, 77, 5)])
def test_gate_backward_lane_model_equals_autograd(T, E, k, norm, ties):
    logits = _rand(12, (T, E), scale=1.5)
    if ties:
        logits = torch.round(logits * 2) / 2
    gtp, gpm = _rand(13, (T, k)), _rand(14, (E,))
    want = mg_ref.moe_gate_grads_plain(logits, k, None, norm, gtp, gpm)
    got = _gate_backward_lanes(logits, k, norm, gtp, gpm)
    assert got.dtype == torch.float32
    assert _err(got, want) <= GATE_TOL


def _fused_mean(probs, blocks):
    """The forward's probability mean in the kernel's order
    (csrc/moe_gate.cu): warp w of block b sums rows b WARPS + w + i
    blocks WARPS in row order in float32; the block adds its warps in
    warp order. A lone block divides that by T; else each block's sum t
    becomes the integer round(t 2^S), S = 62 - bits(T), the integers add
    exactly, and total / 2^S / T is taken in float64 and rounded once to
    float32. Adding +0.0 is exact, so missing rows are zeros."""
    T, E = probs.shape
    W = mg_ops.WARPS
    stride = blocks * W
    n = max(1, -(-T // stride))
    rows = torch.zeros(n * stride, E)
    rows[:T] = probs
    acc = torch.zeros(blocks, W, E)
    for i in range(n):
        acc = acc + rows[i * stride:(i + 1) * stride].view(blocks, W, E)
    part = torch.zeros(blocks, E)
    for w in range(W):
        part = part + acc[:, w]
    if blocks == 1:
        return part[0] / torch.tensor(float(T), dtype=torch.float32)
    scale = 2.0 ** (62 - T.bit_length())
    total = torch.round(part.double() * scale).long().sum(0)
    assert int(total.max()) < 2 ** 62
    return (total.double() / scale / T).float()


@pytest.mark.parametrize("sms", [1, 78, 132])
@pytest.mark.parametrize("T", [1, 333, 8192])
def test_gate_fused_mean_order(T, sms):
    """The fused mean's order on the grids the wrapper plans (one block
    at T = 1 and at sms = 1 ... 132), at two expert counts."""
    blocks = mg_ops.grid_plan(T, sms)
    for E in (128, 77):
        logits = _rand(T + E + sms, (T, E), scale=0.7)
        probs = torch.softmax(logits, -1)
        got = _fused_mean(probs, blocks)
        assert got.dtype == torch.float32
        assert float((got.double() - probs.double().mean(0)).abs().max()) \
            <= GATE_TOL
        assert torch.equal(got, _fused_mean(probs, blocks))


def test_gate_cpu_wrapper_prob_mean_and_grads():
    logits = _rand(8, (40, 8), scale=1.2).requires_grad_()
    bias = _rand(9, (8,), scale=0.1)
    top_p, top_e, counts, pm = mg_ops.moe_gate(logits, 2, bias, True,
                                               prob_mean=True)
    assert torch.allclose(pm, torch.softmax(logits, -1).mean(0))
    assert int(counts.sum()) == 40 * 2
    g = torch.autograd.grad((top_p * _rand(10, top_p.shape)).sum()
                            + (pm * _rand(11, (8,))).sum(), logits)[0]
    want = mg_ref.moe_gate_grads_plain(logits, 2, bias, True,
                                       _rand(10, top_p.shape),
                                       _rand(11, (8,)))
    assert _err(g, want) <= 1e-6
    # the three-output call is the serve path's, unchanged
    assert len(mg_ops.moe_gate(logits.detach(), 2, bias)) == 3


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


def _fa_inputs(cuda, B, H, Hkv, S, Skv, D, dtype, seed=1):
    q = _rand(seed, (B, H, S, D), dtype, cuda)
    k = _rand(seed + 1, (B, Hkv, Skv, D), dtype, cuda)
    v = _rand(seed + 2, (B, Hkv, Skv, D), dtype, cuda)
    do = _rand(seed + 3, (B, H, S, D), dtype, cuda)
    return q, k, v, do


def _fa_kernel_grads(q, k, v, do, causal):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal)
    return (out, *torch.autograd.grad(out, leaves, do))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,Skv,D,causal", [
    (2, 8, 1, 256, 256, 64, True),     # tinyllama's group of 8
    (1, 7, 1, 200, 200, 128, True),    # qwen2-7b's group of 7, D 128
    (2, 4, 2, 77, 77, 16, True),       # smoke heads, ragged
    (1, 4, 4, 130, 200, 32, True),     # causal, Skv > S
    (2, 6, 3, 96, 50, 64, True),       # causal, Skv < S
    (1, 4, 2, 77, 200, 128, False),    # cross, ragged
    (2, 2, 2, 64, 64, 16, False)])
def test_attention_backward_kernel_equals_plain(cuda, B, H, Hkv, S, Skv, D,
                                                causal, dtype):
    q, k, v, do = _fa_inputs(cuda, B, H, Hkv, S, Skv, D, dtype)
    build.reset_launches()
    out, dq, dk, dv = _fa_kernel_grads(q, k, v, do, causal)
    torch.cuda.synchronize()
    assert build.launches()["flash_attention"] == 1
    assert build.launches()["flash_attention_bwd"] == 1
    f32 = [t.float() for t in (q, k, v, do)]
    want = fa_ref.flash_attention_grads_plain(*f32, causal)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.shape == w.shape and g.dtype == dtype
        assert _err(g, w) <= TOL[dtype], (name, _err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_forward_writes_the_row_logsumexp(cuda, D, dtype):
    q, k, v, _ = _fa_inputs(cuda, 2, 8, 2, 150, 150, D, dtype)
    out, lse = fa_ops._forward(q, k, v, True, True)
    torch.cuda.synchronize()
    want = fa_ref.flash_attention_lse_plain(q, k, True)
    assert float((lse - want).abs().max()) <= 1e-3
    # the serve path's call (no lse) gives the same output
    assert torch.equal(out, fa_ops.flash_attention(q, k, v, True))


@pytest.mark.cuda
def test_attention_backward_is_deterministic(cuda):
    q, k, v, do = _fa_inputs(cuda, 2, 8, 1, 300, 300, 64, torch.bfloat16)
    a = _fa_kernel_grads(q, k, v, do, True)
    b = _fa_kernel_grads(q, k, v, do, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


#: (B, H, Hkv, S, Skv, causal) of the wgmma path's card tests: groups of
#: 1, 2, 7 (qwen2-7b) and 8 (tinyllama, qwen3-moe), ragged S, causal with
#: Skv < S and Skv > S, and one non-causal call
WGMMA_CASES = [(1, 8, 8, 200, 200, True), (2, 4, 2, 256, 256, True),
               (1, 7, 1, 333, 333, True), (2, 8, 1, 384, 384, True),
               (1, 4, 2, 300, 130, True), (1, 4, 2, 130, 300, True),
               (1, 2, 1, 5, 9, True), (1, 8, 1, 77, 200, False)]


def _fa_bwd_call(cuda, B, H, Hkv, S, Skv, D, causal, seed=1):
    """(inputs, call) of one backward launch from the forward's out and
    lse."""
    q, k, v, do = _fa_inputs(cuda, B, H, Hkv, S, Skv, D, torch.bfloat16,
                             seed)
    out, lse = fa_ops._forward(q, k, v, causal, True)
    return (q, k, v, do), lambda: fa_ops.flash_attention_bwd(
        q, k, v, out, do, lse, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("B,H,Hkv,S,Skv,causal", WGMMA_CASES)
def test_attention_backward_wgmma_equals_plain(cuda, B, H, Hkv, S, Skv, D,
                                               causal):
    (q, k, v, do), call = _fa_bwd_call(cuda, B, H, Hkv, S, Skv, D, causal)
    build.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert build.launches()["flash_attention_bwd"] == 1
    want = fa_ref.flash_attention_grads_plain(
        *(t.float() for t in (q, k, v, do)), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert torch.isfinite(g).all(), name
        assert _err(g, w) <= TOL[torch.bfloat16], (name, _err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(32, 4, 64), (28, 4, 128),
                                     (32, 4, 128)])
def test_attention_backward_calls_bit_equal(cuda, H, Hkv, D):
    """tinyllama's and qwen3-moe's group of 8 and qwen2-7b's of 7: the
    group sum runs in head order, so calls in a row give equal bits."""
    _, call = _fa_bwd_call(cuda, 1, H, Hkv, 320, 320, D, True, seed=5)
    a, b = call(), call()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,new", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 32, False), (torch.float32, 64, False)])
def test_attention_backward_kernel_names(cuda, dtype, D, new):
    """bf16 at D 64 and 128 runs the wgmma kernels and none of the
    mma.sync ones; the other dtypes and head dims keep theirs."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do = _fa_inputs(cuda, 1, 8, 2, 192, 192, D, dtype)
    out, lse = fa_ops._forward(q, k, v, True, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa_ops.flash_attention_bwd(q, k, v, out, do, lse, True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    wgmma = [n for n in names if "wgmma_kernel" in n]
    old = [n for n in names if "dkdv_mma_kernel" in n or "dq_mma_kernel" in n]
    if new:
        assert any("dkdv_wgmma_kernel" in n for n in wgmma), names
        assert any("dq_wgmma_kernel" in n for n in wgmma), names
        assert any("sum_heads_kernel" in n for n in names), names
        assert not old, names
    else:
        assert not wgmma, names
        assert bool(old) == (dtype == torch.bfloat16), names


@pytest.mark.cuda
def test_attention_grad_paths_and_refusals(cuda):
    """A differentiable call goes through the autograd function; a
    second-order gradient, or a head dim the kernels do not take (the
    qwen2 smoke's 8), raises rather than falling back."""
    q, k, v, do = _fa_inputs(cuda, 1, 4, 2, 64, 64, 32, torch.float32)
    qr = q.clone().requires_grad_()
    out = fa_ops.flash_attention(qr, k, v, True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    g, = torch.autograd.grad(out, qr, do, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), qr)
    with torch.no_grad():
        assert fa_ops.flash_attention(qr, k, v, True).grad_fn is None
    q8 = torch.zeros((1, 7, 16, 8), device=cuda, requires_grad=True)
    k8 = torch.zeros((1, 1, 16, 8), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q8, k8, k8, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,k", [(8192, 128, 8), (1000, 77, 5),
                                   (333, 500, 32), (1, 8, 2)])
def test_gate_prob_mean_and_backward_equal_plain(cuda, T, E, k, dtype):
    logits = _rand(T + E, (T, E), dtype, cuda, scale=0.7)
    bias = _rand(E, (E,), torch.float32, cuda, scale=0.05)
    gtp = _rand(1, (T, k), torch.float32, cuda)
    gpm = _rand(2, (E,), torch.float32, cuda)
    x = logits.detach().requires_grad_()
    build.reset_launches()
    top_p, top_e, counts, pm = mg_ops.moe_gate(x, k, bias, True,
                                               prob_mean=True)
    g, = torch.autograd.grad([top_p, pm], x, [gtp, gpm])
    torch.cuda.synchronize()
    assert build.launches()["moe_gate"] == 1
    assert build.launches()["moe_gate_bwd"] == 1
    want = mg_ref.moe_gate_plain(logits, k, bias, True, prob_mean=True)
    assert torch.equal(top_e, want[1]) and torch.equal(counts, want[2])
    assert float((pm - want[3]).abs().max()) <= GATE_TOL
    wg = mg_ref.moe_gate_grads_plain(logits, k, bias, True, gtp, gpm)
    assert g.dtype == dtype
    assert _err(g.float(), wg) <= (GATE_TOL if dtype == torch.float32
                                   else TOL[torch.bfloat16])
    # calls in a row are bit-equal (no float atomics)
    again = mg_ops.moe_gate(logits, k, bias, True, prob_mean=True)[3]
    assert torch.equal(again, pm)
    g2, = torch.autograd.grad(
        list(mg_ops.moe_gate(x, k, bias, True, prob_mean=True)[::3]), x,
        [gtp, gpm])
    assert torch.equal(g, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [True, False])
def test_gate_backward_on_ties_and_without_renormalisation(cuda, norm):
    logits = torch.round(_rand(3, (4096, 128), device=cuda) * 2) / 2
    gtp = _rand(4, (4096, 8), device=cuda)
    x = logits.clone().requires_grad_()
    top_p, top_e, _ = mg_ops.moe_gate(x, 8, None, norm)
    g, = torch.autograd.grad(top_p, x, gtp)
    want = mg_ref.moe_gate_plain(logits, 8, None, norm)
    assert torch.equal(top_e, want[1])
    wg = mg_ref.moe_gate_grads_plain(logits, 8, None, norm, gtp)
    assert _err(g, wg) <= GATE_TOL


@pytest.mark.cuda
def test_gate_serve_call_is_unchanged(cuda):
    """Without prob_mean and without a gradient the gate is the serve
    path's one-kernel call with three outputs."""
    logits = _rand(0, (16, 128), device=cuda)
    build.reset_launches()
    out = mg_ops.moe_gate(logits, 8, torch.zeros(128, device=cuda))
    assert len(out) == 3 and build.launches()["moe_gate"] == 1
    assert build.launches()["moe_gate_bwd"] == 0


def _cuda_kernel_names(fn, calls):
    """Names of the CUDA kernels that `calls` calls of fn() ran (traced
    again, up to three times, if the trace lost records)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) == calls:
            break
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8192, 16])
def test_gate_prob_mean_is_one_kernel(cuda, T):
    """The forward with the mean is one device kernel a call, at
    prefill's grid and at a one-block grid."""
    logits = _rand(T, (T, 128), device=cuda, scale=0.7)
    names = _cuda_kernel_names(
        lambda: mg_ops.moe_gate(logits, 8, None, True, prob_mean=True), 5)
    assert len(names) == 5, names
    assert all("moe_gate_kernel" in n for n in names), names


@pytest.mark.cuda
def test_gate_prob_mean_calls_share_the_scratch(cuda):
    """Calls at other T and E in a row share one scratch (accumulators
    and ticket), which each leaves zero; T = 0 gives the plain version's
    NaN mean, and a repeated call gives the first call's bits."""
    seen = {}
    for T, E in [(8192, 128), (1, 128), (0, 128), (8192, 128), (8192, 77),
                 (333, 77), (0, 77), (8192, 128), (1, 77)]:
        logits = _rand(T + E, (T, E), device=cuda, scale=0.7)
        top_p, top_e, counts, pm = mg_ops.moe_gate(logits, 5, None, True,
                                                   prob_mean=True)
        want = mg_ref.moe_gate_plain(logits, 5, None, True, prob_mean=True)
        torch.cuda.synchronize()
        assert not mg_ops._scratch(logits.device).any()
        assert torch.equal(top_e, want[1]) and torch.equal(counts, want[2])
        if T == 0:
            assert torch.isnan(pm).all() and torch.isnan(want[3]).all()
            continue
        assert float((pm - want[3]).abs().max()) <= GATE_TOL
        if (T, E) in seen:
            assert torch.equal(pm, seen[(T, E)])
        seen[(T, E)] = pm
