"""The two attention kernels: their plain versions against the Pallas
kernels and against their jnp twins on the LM path, and the CUDA kernels
against their plain versions on the card.

Tolerances (absolute and relative): 1e-5 in float32, where the plain
version and the references differ only in summation order and in
one-block against blockwise online softmax; 2e-2 in bfloat16, where
they also round P to bfloat16 at different points (the Pallas tests'
own 2e-2). The jnp twins round P to the reference's COMPUTE_DT
(bfloat16 unless REPRO_FORCE_F32=1), so here they are held in bfloat16;
tests/test_torch_serve.py holds them in float32 in a REPRO_FORCE_F32
subprocess. The CUDA tests carry the `cuda` marker and skip without a
GPU; on the card run them with
`python -m pytest --noconftest -m cuda tests/test_torch_attention.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as fd_ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def jx():
    """JAX and the reference's kernels and twins (imported here, so that
    the card's tests run where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro.kernels.flash_decode.flash_decode import flash_decode
    from repro.models import attention
    from repro.parallel.ctx import make_ctx
    return dict(jax=jax, jnp=jax.numpy, fa=flash_attention,
                fd=flash_decode, attn=attention, make_ctx=make_ctx)


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(jnp, a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _f32(t):
    return t.float().numpy()


# --- flash attention -----------------------------------------------------


@pytest.mark.parametrize("bh,s,d", [(2, 128, 64), (4, 256, 64), (1, 512, 128),
                                    (3, 384, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_equals_pallas(jx, bh, s, d, causal, dtype):
    """tests/test_kernels.py's sweep, K/V expanded (one KV head a query
    head), against the Pallas kernel in interpret mode."""
    q, k, v = (_rand(bh * s + d + i, (bh, s, d)) for i in range(3))
    want = jx["fa"](*(_j(jx["jnp"], a, dtype) for a in (q, k, v)),
                    causal=causal, interpret=True)
    got = fa_ref.flash_attention_plain(
        *(_t(a, dtype)[None] for a in (q, k, v)), causal)[0]
    _close(_f32(got), want, dtype)


def test_flash_attention_cross_lengths(jx):
    """Skv != S, as tests/test_kernels.py's cross-attention case."""
    q = _rand(9, (2, 128, 64))
    k, v = _rand(10, (2, 384, 64)), _rand(11, (2, 384, 64))
    want = jx["fa"](q, k, v, causal=False, interpret=True)
    got = fa_ref.flash_attention_plain(
        *(torch.from_numpy(a)[None] for a in (q, k, v)), False)[0]
    _close(got.numpy(), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gqa_unexpanded(jx, dtype):
    """Grouped K/V passed unexpanded (query head h reads KV head h // G)
    equals the Pallas kernel on the group-expanded K/V, and the plain
    version on the expanded K/V."""
    B, H, Hkv, S, D = 2, 8, 2, 128, 64
    q = _rand(1, (B, H, S, D))
    k, v = _rand(2, (B, Hkv, S, D)), _rand(3, (B, Hkv, S, D))
    jnp = jx["jnp"]
    kx, vx = (jnp.repeat(_j(jnp, a, dtype), H // Hkv, axis=1).reshape(
        B * H, S, D) for a in (k, v))
    want = jx["fa"](_j(jnp, q, dtype).reshape(B * H, S, D), kx, vx,
                    causal=True, interpret=True).reshape(B, H, S, D)
    got = fa_ref.flash_attention_plain(_t(q, dtype), _t(k, dtype),
                                       _t(v, dtype), True)
    _close(_f32(got), want, dtype)
    expanded = fa_ref.flash_attention_plain(
        _t(q, dtype), _t(k, dtype).repeat_interleave(H // Hkv, 1),
        _t(v, dtype).repeat_interleave(H // Hkv, 1), True)
    assert torch.equal(got, expanded)


def test_flash_attention_equals_flash_heads(jx):
    """The jnp twin on the LM path (attention.flash_heads, blockwise
    online softmax with the causal skip), at small blocks, in bfloat16."""
    B, H, S, D = 2, 4, 96, 16
    q, k, v = (_rand(20 + i, (B, H, S, D)) for i in range(3))
    jnp = jx["jnp"]
    px = jx["make_ctx"](None, q_block=32, kv_block=32)
    want = jx["attn"].flash_heads(
        *(_j(jnp, a, "bfloat16") for a in (q, k, v)), causal=True, px=px,
        batch_entry=None, head_entry=None)
    got = fa_ref.flash_attention_plain(
        *(_t(a, "bfloat16") for a in (q, k, v)), True)
    _close(_f32(got), want, "bfloat16")


def test_flash_attention_cpu_wrapper_and_no_fallback():
    q, k, v = (_t(_rand(i, (1, 4, 33, 16)), "float32") for i in range(3))
    build.reset_launches()
    assert torch.equal(fa_ops.flash_attention(q, k, v, True),
                       fa_ref.flash_attention_plain(q, k, v, True))
    assert build.launches()["flash_attention"] == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        fa_ops.flash_attention(*(t.to("meta") for t in (q, k, v)))


def test_flash_attention_cpu_wrapper_at_dk_ne_dv():
    """MLA's (192, 128) and the smoke's (24, 16) on the CPU: the plain
    version, (B, H, S, Dv) out, and a gradient by its autograd."""
    for dk, dv in ((192, 128), (24, 16)):
        q, k = (_t(_rand(dk + i, (1, 2, 40, dk)), "float32") for i in (0, 1))
        v = _t(_rand(dv, (1, 2, 40, dv)), "float32").requires_grad_()
        out = fa_ops.flash_attention(q, k, v, True)
        assert tuple(out.shape) == (1, 2, 40, dv)
        assert torch.equal(out.detach(),
                           fa_ref.flash_attention_plain(q, k, v.detach()))
        out.sum().backward()
        assert v.grad.shape == v.shape and v.grad.abs().sum() > 0


# --- flash decode --------------------------------------------------------


@pytest.mark.parametrize("b,h,hkv,s,d,bk", [
    (2, 8, 2, 512, 64, 512), (1, 4, 4, 1024, 64, 512),
    (3, 8, 1, 256, 128, 512),
    (2, 8, 2, 576, 64, 64),      # S not a multiple of 512
    (1, 4, 2, 100, 16, 512)])    # ragged S, the smoke config's heads
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_equals_pallas(jx, b, h, hkv, s, d, bk, dtype):
    """tests/test_kernels.py's sweep plus S that 512 does not divide,
    against the Pallas kernel in interpret mode."""
    jnp = jx["jnp"]
    q = _rand(b + h + s, (b, h, d))
    kc, vc = _rand(s + 1, (b, s, hkv, d)), _rand(s + 2, (b, s, hkv, d))
    for pos in (0, s // 3, s - 1):
        want = jx["fd"](_j(jnp, q, dtype), _j(jnp, kc, dtype),
                        _j(jnp, vc, dtype), jnp.int32(pos), bk=bk,
                        interpret=True)
        got = fd_ref.flash_decode_plain(_t(q, dtype), _t(kc, dtype),
                                        _t(vc, dtype), pos)
        _close(_f32(got), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_past_the_cache_end_equals_pallas(jx, dtype):
    """pos >= S: the reference's mask `kpos > pos` keeps all S rows, and
    so does the wrapper (on the CPU, its plain version)."""
    jnp = jx["jnp"]
    B, H, Hkv, S, D = 2, 4, 2, 96, 64
    q = _rand(40, (B, H, D))
    kc, vc = _rand(41, (B, S, Hkv, D)), _rand(42, (B, S, Hkv, D))
    for pos in (S, S + 7):
        want = jx["fd"](_j(jnp, q, dtype), _j(jnp, kc, dtype),
                        _j(jnp, vc, dtype), jnp.int32(pos), bk=32,
                        interpret=True)
        got = fd_ops.flash_decode(_t(q, dtype), _t(kc, dtype),
                                  _t(vc, dtype), pos)
        _close(_f32(got), want, dtype)


def test_flash_decode_equals_decode_attend(jx):
    """The jnp twin on the LM path (attention.decode_attend), in
    bfloat16."""
    jnp = jx["jnp"]
    B, H, Hkv, S, D = 2, 4, 2, 40, 16
    q = _rand(30, (B, H, D))
    kc, vc = _rand(31, (B, S, Hkv, D)), _rand(32, (B, S, Hkv, D))
    for pos in (0, 17, S - 1):
        want = jx["attn"].decode_attend(
            _j(jnp, q, "bfloat16"), _j(jnp, kc, "bfloat16"),
            _j(jnp, vc, "bfloat16"), jnp.int32(pos),
            px=jx["make_ctx"](None), batch_entry=None, seq_entry=None)
        got = fd_ref.flash_decode_plain(_t(q, "bfloat16"),
                                        _t(kc, "bfloat16"),
                                        _t(vc, "bfloat16"), pos)
        _close(_f32(got), want, "bfloat16")


def test_flash_decode_cpu_wrapper_and_no_fallback():
    q = _t(_rand(1, (2, 4, 16)), "float32")
    kc, vc = (_t(_rand(i, (2, 10, 2, 16)), "float32") for i in (2, 3))
    build.reset_launches()
    assert torch.equal(fd_ops.flash_decode(q, kc, vc, 6),
                       fd_ref.flash_decode_plain(q, kc, vc, 6))
    assert build.launches()["flash_decode"] == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        fd_ops.flash_decode(q.to("meta"), kc.to("meta"), vc.to("meta"), 6)


@pytest.mark.parametrize("B,Hkv,pos", [
    (16, 4, 543),        # decode, main path: 9 splits of one tile
    (1, 1, 0), (2, 2, 63), (2, 2, 64), (1, 1, 32767), (1, 4, 10000),
    (64, 8, 4095), (3, 1, 999)])
def test_flash_decode_split_plan(B, Hkv, pos):
    """Every tile 0..pos // 64 lies in exactly one split, none is empty,
    and the grid stays within SPLIT_BLOCKS blocks (one split a pair at
    the least) and MAX_SPLITS splits a pair."""
    n_split, tps = fd_ops.split_plan(B, Hkv, pos)
    n_tiles = pos // fd_ops.CHUNK + 1
    assert 1 <= n_split <= fd_ops.MAX_SPLITS and tps >= 1
    assert (n_split - 1) * tps < n_tiles <= n_split * tps
    assert B * Hkv * n_split <= max(fd_ops.SPLIT_BLOCKS, B * Hkv)
    if (B, Hkv, pos) == (16, 4, 543):
        assert (n_split, tps) == (9, 1)
    assert fd_ops.workspace_floats(B, Hkv, 64, n_split) == (
        0 if n_split == 1 else B * Hkv * n_split * fd_ops.MAX_G * 66)


def test_flash_decode_workspace_is_reused_and_grows(monkeypatch):
    """One workspace a device: reused while it is large enough, replaced
    by a larger one (tickets zeroed) when a larger shape arrives."""
    monkeypatch.setattr(fd_ops, "_WORKSPACE", {})
    dev = torch.device("cpu")
    part, tick = fd_ops.workspace(dev, 100, 8)
    assert part.dtype == torch.float32 and part.numel() == 100
    assert tick.dtype == torch.int32 and not tick.any()
    assert tick.numel() == 8
    again = fd_ops.workspace(dev, 50, 4)
    assert again[0] is part and again[1] is tick
    grown = fd_ops.workspace(dev, 200, 16)
    assert grown[0].numel() == 200 and grown[1].numel() == 16
    assert grown[0] is not part and not grown[1].any()
    assert fd_ops.workspace(dev, 0, 1)[0] is grown[0]


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,S,Skv,D,causal,dtype", [
    (16, 32, 4, 512, 512, 64, True, "bfloat16"),   # prefill, main path
    (2, 8, 2, 384, 384, 128, True, "float32"),
    (1, 4, 4, 100, 100, 16, True, "bfloat16"),     # ragged, smoke heads
    (2, 4, 2, 77, 200, 32, False, "float32"),      # cross, ragged
    (2, 4, 2, 77, 200, 32, False, "bfloat16"),
    (2, 8, 2, 200, 130, 128, True, "bfloat16"),    # causal, Skv < S
    (2, 4, 1, 130, 130, 64, True, "float32"),
    (1, 2, 2, 64, 64, 128, False, "bfloat16")])
def test_flash_attention_kernel_equals_plain_on_card(
        cuda, B, H, Hkv, S, Skv, D, causal, dtype):
    q = _t(_rand(1, (B, H, S, D)), dtype).to(cuda)
    k = _t(_rand(2, (B, Hkv, Skv, D)), dtype).to(cuda)
    v = _t(_rand(3, (B, Hkv, Skv, D)), dtype).to(cuda)
    got = fa_ops.flash_attention(q, k, v, causal)
    want = fa_ref.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    _close(_f32(got.cpu()), _f32(want.cpu()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,S,D,dtype", [
    (16, 32, 4, 576, 64, "bfloat16"),              # decode, main path
    (2, 8, 2, 512, 64, "float32"),
    (3, 8, 1, 100, 128, "float32"),
    (1, 4, 2, 77, 16, "bfloat16"),                 # smoke heads
    (2, 4, 4, 1000, 32, "float32")])
def test_flash_decode_kernel_equals_plain_on_card(cuda, B, H, Hkv, S, D,
                                                  dtype):
    q = _t(_rand(1, (B, H, D)), dtype).to(cuda)
    kc = _t(_rand(2, (B, S, Hkv, D)), dtype).to(cuda)
    vc = _t(_rand(3, (B, S, Hkv, D)), dtype).to(cuda)
    for pos in (0, 63, 64, S // 3, S - 1):
        got = fd_ops.flash_decode(q, kc, vc, pos)
        want = fd_ref.flash_decode_plain(q, kc, vc, pos)
        torch.cuda.synchronize()
        _close(_f32(got.cpu()), _f32(want.cpu()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_past_the_cache_end_on_card(cuda, dtype):
    """pos = S and S + 7 attend to all S rows, as the plain version."""
    B, H, Hkv, S, D = 16, 32, 4, 576, 64
    q = _t(_rand(4, (B, H, D)), dtype).to(cuda)
    kc = _t(_rand(5, (B, S, Hkv, D)), dtype).to(cuda)
    vc = _t(_rand(6, (B, S, Hkv, D)), dtype).to(cuda)
    for pos in (S, S + 7):
        got = fd_ops.flash_decode(q, kc, vc, pos)
        want = fd_ref.flash_decode_plain(q, kc, vc, pos)
        torch.cuda.synchronize()
        _close(_f32(got.cpu()), _f32(want.cpu()), dtype)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 4, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, q[:, :2].contiguous(), q[:, :2].contiguous())
    q = torch.zeros((1, 4, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="KV heads"):
        fa_ops.flash_attention(q, q[:, :3].contiguous(), q[:, :3].contiguous())
    with pytest.raises(ValueError, match="bfloat16"):
        fa_ops.flash_attention(q, q.bfloat16(), q.bfloat16())
    # contiguous but 2 bytes off a 16-byte boundary: TMA cannot load it
    flat = torch.zeros(4 * 8 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    qb = flat[1:].view(1, 4, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention(qb, qb[:, :2].contiguous(),
                               qb[:, :2].contiguous())
    # MLA's pair takes v at 128 only, in bfloat16 only
    q2 = torch.zeros((1, 2, 8, 192), dtype=torch.bfloat16, device=cuda)
    v2 = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match=r"head dims \(Dk 192, Dv 64\)"):
        fa_ops.flash_attention(q2, q2, v2[..., :64].contiguous())
    with pytest.raises(ValueError, match="bfloat16 only"):
        fa_ops.flash_attention(q2.float(), q2.float(), v2.float())
    with pytest.raises(ValueError, match=r"\(Dk 24, Dv 16\)"):
        fa_ops.flash_attention(q2[..., :24].contiguous(),
                               q2[..., :24].contiguous(),
                               v2[..., :16].contiguous())
    # its gradient is the backward kernel's, against autograd through
    # the plain versions (S 77: not a multiple of a tile); another Dk !=
    # Dv pair has no backward either
    qg, kg = (_t(_rand(60 + i, (1, 4, 77, 192)), "bfloat16").to(cuda)
              for i in range(2))
    vg = _t(_rand(62, (1, 4, 77, 128)), "bfloat16").to(cuda)
    dog = _t(_rand(63, (1, 4, 77, 128)), "bfloat16").to(cuda)
    leaves = [t.clone().requires_grad_() for t in (qg, kg, vg)]
    got = torch.autograd.grad(fa_ops.flash_attention(*leaves), leaves, dog)
    want = fa_ref.flash_attention_grads_plain(
        *(t.float() for t in (qg, kg, vg, dog)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float((g.float() - w).abs().max() / w.abs().max())
        assert err <= TOL["bfloat16"], err
    q3 = q2[..., :24].contiguous()
    with pytest.raises(ValueError, match=r"\(Dk 24, Dv 16\)"):
        fa_ops.flash_attention_bwd(q3, q3, v2[..., :16].contiguous(),
                                   v2[..., :16].contiguous(),
                                   v2[..., :16].contiguous(),
                                   torch.zeros((1, 2, 8), device=cuda))
    qd = torch.zeros((1, 4, 64), device=cuda)
    kc = torch.zeros((1, 10, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="pos"):
        fd_ops.flash_decode(qd, kc, kc, -1)
    with pytest.raises(ValueError, match="group"):
        fd_ops.flash_decode(torch.zeros((1, 18, 64), device=cuda),
                            torch.zeros((1, 10, 1, 64), device=cuda),
                            torch.zeros((1, 10, 1, 64), device=cuda), 3)


def _fa_case(cuda, B, H, Hkv, S, Skv, D, causal, seed=1):
    q = _t(_rand(seed, (B, H, S, D)), "bfloat16").to(cuda)
    k = _t(_rand(seed + 1, (B, Hkv, Skv, D)), "bfloat16").to(cuda)
    v = _t(_rand(seed + 2, (B, Hkv, Skv, D)), "bfloat16").to(cuda)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("S,Skv,causal", [
    (1, 1, True), (63, 63, True), (65, 65, True), (200, 200, True),
    (1, 200, False), (63, 65, False), (200, 1, False),
    (200, 63, True), (200, 65, True), (65, 1, True)])   # causal, Skv < S
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_bf16_ragged_lengths_on_card(cuda, S, Skv, causal,
                                                     D):
    """The TMA ring's zero-filled rows past S and Skv, the masked edge
    tiles and the causal bound, against the plain version."""
    q, k, v = _fa_case(cuda, 2, 8, 2, S, Skv, D, causal)
    got = fa_ops.flash_attention(q, k, v, causal)
    want = fa_ref.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    _close(_f32(got.cpu()), _f32(want.cpu()), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S", [
    (16, 128, 512),     # MLA prefill at full width (deepseek-v3-671b)
    (2, 4, 200),        # ragged: a part tile at the end
    (1, 3, 65)])
def test_flash_attention_mla_pair_on_card(cuda, B, H, S):
    """Dk 192, Dv 128, bf16, causal, K/V one head a query head (MLA's
    group of 1), against the plain version; calls in a row bit-equal."""
    r = np.random.default_rng(S)
    q = _t(r.normal(size=(B, H, S, 192)).astype(np.float32),
           "bfloat16").to(cuda)
    k = _t(r.normal(size=(B, H, S, 192)).astype(np.float32),
           "bfloat16").to(cuda)
    v = _t(r.normal(size=(B, H, S, 128)).astype(np.float32),
           "bfloat16").to(cuda)
    build.reset_launches()
    got = fa_ops.flash_attention(q, k, v, True)
    assert build.launches()["flash_attention"] == 1
    assert tuple(got.shape) == (B, H, S, 128)
    want = fa_ref.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    _close(_f32(got.cpu()), _f32(want.cpu()), "bfloat16")
    assert torch.equal(fa_ops.flash_attention(q, k, v, True), got)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_attention_bf16_groups_and_head_dims_on_card(cuda, G, D):
    """Odd and even groups (one or two query heads a block at D 64 and
    128) and every head dim (mma.sync at 16 and 32)."""
    Hkv = 2
    q, k, v = _fa_case(cuda, 2, G * Hkv, Hkv, 130, 130, D, True)
    got = fa_ops.flash_attention(q, k, v, True)
    want = fa_ref.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    _close(_f32(got.cpu()), _f32(want.cpu()), "bfloat16")


@pytest.mark.cuda
def test_flash_attention_on_a_side_stream(cuda):
    """The launch goes to the current stream: a side stream's result,
    once that stream is done, equals the default stream's."""
    q, k, v = _fa_case(cuda, 4, 16, 2, 256, 256, 64, True)
    want = fa_ops.flash_attention(q, k, v, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = fa_ops.flash_attention(q, k, v, True)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _fd_case(cuda, B, H, Hkv, S, D, dtype, seed=1):
    q = _t(_rand(seed, (B, H, D)), dtype).to(cuda)
    kc = _t(_rand(seed + 1, (B, S, Hkv, D)), dtype).to(cuda)
    vc = _t(_rand(seed + 2, (B, S, Hkv, D)), dtype).to(cuda)
    return q, kc, vc


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_groups_and_positions_on_card(cuda, G, dtype):
    """pos at the tile edges (0, 63, 64, 65) and at the cache's end, for
    every group size (heads past G padded in the tensor-core tile)."""
    S = 300
    q, kc, vc = _fd_case(cuda, 3, 2 * G, 2, S, 64, dtype)
    for pos in (0, 63, 64, 65, S - 1):
        got = fd_ops.flash_decode(q, kc, vc, pos)
        want = fd_ref.flash_decode_plain(q, kc, vc, pos)
        torch.cuda.synchronize()
        _close(_f32(got.cpu()), _f32(want.cpu()), dtype)


@pytest.mark.cuda
def test_flash_decode_calls_in_a_row_equal_fresh_calls(cuda, monkeypatch):
    """Calls at other shapes and positions in a row share the workspace
    and its tickets; each result equals the same call made first on a
    fresh workspace, bit for bit (the merge order is fixed)."""
    calls = [(_fd_case(cuda, 16, 32, 4, 576, 64, "bfloat16"), 543),
             (_fd_case(cuda, 2, 8, 2, 1000, 128, "bfloat16", 7), 999),
             (_fd_case(cuda, 1, 4, 4, 77, 16, "bfloat16", 9), 70),
             (_fd_case(cuda, 16, 32, 4, 576, 64, "bfloat16"), 100),
             (_fd_case(cuda, 2, 8, 2, 1000, 128, "float32", 11), 512)]
    in_a_row = [fd_ops.flash_decode(*args, pos) for args, pos in calls]
    torch.cuda.synchronize()
    for (args, pos), got in zip(calls, in_a_row):
        monkeypatch.setattr(fd_ops, "_WORKSPACE", {})
        fresh = fd_ops.flash_decode(*args, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, fresh)
        _close(_f32(got.cpu()),
               _f32(fd_ref.flash_decode_plain(*args, pos).cpu()),
               "float32" if got.dtype == torch.float32 else "bfloat16")


@pytest.mark.cuda
def test_flash_decode_on_a_side_stream(cuda):
    q, kc, vc = _fd_case(cuda, 16, 32, 4, 576, 64, "bfloat16")
    want = fd_ops.flash_decode(q, kc, vc, 543)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = fd_ops.flash_decode(q, kc, vc, 543)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
