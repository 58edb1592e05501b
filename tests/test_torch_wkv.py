"""The chunked-WKV intra-chunk kernels (`repro_torch.kernels.wkv`): the
term A[t, i] = sum_n r[t, n] k[i, n] exp(l_prev[t, n] - l[i, n]), i < t,
of every chunk in one launch, and its backward.

On the CPU: the plain backward (the algebra the backward kernel runs:
dr and dk from one set of masked exponentials, dl_prev = r dr,
dl = -k dk) against autograd through the plain forward in float64
(within F64_TOL of each gradient's largest |value|), at a chunk equal to
a short sequence, at N 16 and 64, and at a chunk of 64 whose log-decays
near -3 a token take l to about -190, where exp(-l) overflows float32;
a float32 model of the kernels' sub-chunk factorisation (`_factored`),
forward and gradients, against the plain versions in float64 on the same
float32 inputs (FWD_TOL, BWD_TOL), ragged chunks, a chunk below a
sub-chunk and a cliff of 0..60 a token included; the wrapper's routing,
refusals and launch counts; the time mix calling
the wrapper once a layer (forward, remat's recompute, backward); and, in
a REPRO_FORCE_F32=1 subprocess of this file, rwkv6's loss gradients
through `WkvIntra` against `jax.grad` of the reference's loss (the
tolerance of tests/test_torch_recurrent.py's
`test_loss_fn_and_grads_equal_reference_f32`).

On the card (`cuda` marker, skipped without a GPU): each kernel against
its plain version, the forward within FWD_TOL of the largest |A|, the
backward within BWD_TOL of each gradient's largest |value| (float32 in
another summation order, and the SFU's exponential), two calls bit-equal
(no atomics). This file imports JAX only in its subprocess: on the card
run `python -m pytest --noconftest -m cuda tests/test_torch_wkv.py`.
"""
import json
import os
import subprocess
import sys
from contextlib import contextmanager
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.wkv import ops, ref  # noqa: E402

torch.set_num_threads(1)

F64_TOL = 1e-10
#: tests/test_torch_recurrent.py's GRAD_TOL (rwkv6's loss gradients)
GRAD_TOL = 1e-4
FWD_TOL = 1e-5
BWD_TOL = 1e-4


def _inputs(B, H, S, N, chunk, seed=0, decay=(0.0, 1.0),
            dtype=torch.float64):
    """r, k (normal), l_prev and l from log-decays drawn uniform in
    -decay[1]..-decay[0] a token, summed inside each chunk."""
    g = np.random.default_rng(seed)
    r, k = (g.normal(size=(B, H, S, N)) for _ in range(2))
    lw = -g.uniform(*decay, size=(B, H, S // chunk, chunk, N))
    l = np.cumsum(lw, 3)
    lp = l - lw
    return [torch.from_numpy(a.reshape(B, H, S, N)).to(dtype)
            for a in (r, k, lp, l)]


@contextmanager
def _counted():
    """{"fwd", "bwd"}: the calls of the plain versions (the CPU's
    launches) while the context is open."""
    calls = {"fwd": 0, "bwd": 0}

    def count(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    with mock.patch.object(ref, "wkv_intra_plain",
                           count("fwd", ref.wkv_intra_plain)), \
            mock.patch.object(ref, "wkv_intra_bwd_plain",
                              count("bwd", ref.wkv_intra_bwd_plain)):
        yield calls


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-300))


#: (B, H, S, N, chunk, decay range a token)
CASES = {
    "chunk_is_the_sequence": (2, 3, 12, 16, 12, (0.0, 1.0)),
    "n16": (2, 2, 48, 16, 16, (0.0, 1.0)),
    "n64": (1, 2, 64, 64, 32, (0.0, 1.0)),
    "steep_decay_chunk64": (1, 2, 128, 64, 64, (2.9, 3.1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_equals_autograd_f64(case):
    B, H, S, N, c, decay = CASES[case]
    leaves = [t.requires_grad_() for t in _inputs(B, H, S, N, c, 1, decay)]
    A = ref.wkv_intra_plain(*leaves, c)
    assert A.shape == (B, H, S // c, c, c)
    assert torch.equal(A, A.tril(-1))
    dA = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(A.shape)))
    want = torch.autograd.grad(A, leaves, dA)
    got = ref.wkv_intra_bwd_plain(*(t.detach() for t in leaves), dA, c)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= F64_TOL, errs
    if case.startswith("steep"):
        l = leaves[3].detach()
        assert float(l.min()) < -180
        # a factored exponent would overflow float32 ...
        assert not torch.isfinite(torch.exp(-l.float())).all()
        # ... the plain versions stay finite there in float32
        f32 = [t.detach().float() for t in leaves]
        A32 = ref.wkv_intra_plain(*f32, c)
        g32 = ref.wkv_intra_bwd_plain(*f32, dA.float(), c)
        assert all(bool(torch.isfinite(t).all()) for t in (A32, *g32))
        assert _rel(A32, A.detach()) <= FWD_TOL


#: rows of the kernels' sub-chunks (`csrc/wkv.cuh`)
SUB = 16


def _factored(r, k, lp, l, c, dA):
    """A float32 model of the kernels' algebra: sub-chunks of SUB rows;
    for a row sub-chunk T after a column sub-chunk I the exponent split at
    L_I = l[last row of I] into exp(l_prev - L_I) (rows) and
    exp(L_I - l) (columns), each <= 0 in its exponent, and the products
    over n (forward) or over t and i (gradients) taken without an
    exponential inside; the diagonal sub-blocks direct, i < t only.
    Returns (A, dr, dk, dl_prev, dl)."""
    B, H, S, N = r.shape
    shape = (B, H, S // c, c, N)
    r, k, lp, l = (t.reshape(shape) for t in (r, k, lp, l))
    A = torch.zeros((*shape[:3], c, c), dtype=r.dtype)
    dr, dk = torch.zeros_like(r), torch.zeros_like(k)
    subs = [(s, min(s + SUB, c)) for s in range(0, c, SUB)]
    for T, (t0, t1) in enumerate(subs):
        rt, pt = r[..., t0:t1, :], lp[..., t0:t1, :]
        kt, lt = k[..., t0:t1, :], l[..., t0:t1, :]
        tri = torch.ones((t1 - t0,) * 2, dtype=torch.bool).tril(-1)
        e = torch.exp(torch.where(tri[:, :, None], pt[..., :, None, :]
                                  - lt[..., None, :, :], -torch.inf))
        A[..., t0:t1, t0:t1] = (rt[..., :, None, :] * kt[..., None, :, :]
                                * e).sum(-1)
        m = dA[..., t0:t1, t0:t1, None] * e
        dr[..., t0:t1, :] += (m * kt[..., None, :, :]).sum(-2)
        dk[..., t0:t1, :] += (m * rt[..., :, None, :]).sum(-3)
        for i0, i1 in subs[:T]:
            ref_l = l[..., i1 - 1:i1, :]
            E = torch.exp(pt - ref_l)
            f = torch.exp(ref_l - l[..., i0:i1, :])
            ki = k[..., i0:i1, :] * f
            A[..., t0:t1, i0:i1] = (rt * E) @ ki.transpose(-1, -2)
            d = dA[..., t0:t1, i0:i1]
            dr[..., t0:t1, :] += E * (d @ ki)
            dk[..., i0:i1, :] += f * (d.transpose(-1, -2) @ (rt * E))
    flat = [t.reshape(B, H, S, N) for t in (r, k, dr, dk)]
    return A, flat[2], flat[3], flat[0] * flat[2], -flat[1] * flat[3]


#: CASES, then ragged chunks, a chunk below SUB, and a cliff of 0..60 a
#: token (l to about -3,800 in a chunk of 128)
ALGEBRA_CASES = {**CASES,
                 "ragged_37": (1, 3, 74, 64, 37, (0.0, 1.0)),
                 "ragged_13_n16": (2, 2, 26, 16, 13, (0.0, 1.0)),
                 "chunk_7": (1, 2, 21, 64, 7, (0.0, 1.0)),
                 "cliff_128": (1, 2, 256, 64, 128, (0.0, 60.0))}


@pytest.mark.parametrize("case", sorted(ALGEBRA_CASES))
def test_sub_chunk_factors_equal_plain_f64(case):
    """The kernels' sub-chunk factorisation in float32 against the plain
    versions in float64: A within FWD_TOL of the largest |A|, each
    gradient within BWD_TOL of its largest |value|, everything finite."""
    B, H, S, N, c, decay = ALGEBRA_CASES[case]
    x32 = _inputs(B, H, S, N, c, 8, decay, torch.float32)
    dA = torch.from_numpy(np.random.default_rng(9).normal(
        size=(B, H, S // c, c, c))).float()
    got = _factored(*x32, c, dA)
    # the same float32 inputs, in float64 (at the cliff one rounding of l
    # to float32 moves an exponent by ~2e-4)
    x, dA = [t.double() for t in x32], dA.double()
    want = (ref.wkv_intra_plain(*x, c),
            *ref.wkv_intra_bwd_plain(*x, dA, c))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert _rel(got[0], want[0]) <= FWD_TOL
    errs = [_rel(g, w) for g, w in zip(got[1:], want[1:])]
    assert max(errs) <= BWD_TOL, errs
    if case.startswith("cliff"):
        # the factors underflow where the plain exponentials do
        assert float(x[3].min()) < -3000


def test_wrapper_runs_the_plain_versions_on_the_cpu():
    """On the CPU `wkv_intra` is the plain forward, its gradients the
    plain backward's (through `WkvIntra`), and no kernel is launched."""
    c = 16
    x = _inputs(2, 2, 48, 16, c, 3, dtype=torch.float32)
    ops.reset_launches()
    leaves = [t.clone().requires_grad_() for t in x]
    A = ops.wkv_intra(*leaves, c)
    assert A.grad_fn is not None and "WkvIntra" in type(A.grad_fn).__name__
    assert torch.equal(A.detach(), ref.wkv_intra_plain(*x, c))
    dA = torch.randn(A.shape, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad(A, leaves, dA)
    want = ref.wkv_intra_bwd_plain(*x, dA, c)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        assert ops.wkv_intra(*leaves, c).grad_fn is None
    assert ops.launches() == {"wkv_intra": 0, "wkv_intra_bwd": 0}


#: calls the kernels do not take: (what, the call's (shape, chunk, dtype))
REFUSED = {
    "head_size_32": ((1, 2, 32, 32), 16, torch.float32),
    "chunk_129": ((1, 2, 258, 64), 129, torch.float32),
    "chunk_not_dividing": ((1, 2, 48, 16), 20, torch.float32),
    "float64": ((1, 2, 32, 16), 16, torch.float64),
    "bfloat16": ((1, 2, 32, 16), 16, torch.bfloat16),
    "three_dims": ((2, 32, 16), 16, torch.float32),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_what_the_kernels_do_not_take(case):
    shape, c, dtype = REFUSED[case]
    t = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=r"wkv_intra|expected"):
        ops.wkv_intra(t, t, t, t, c)


def test_time_mix_calls_the_kernel_once_a_layer_and_pass():
    """A prefill of the smoke calls `wkv_intra` once a layer; a train
    step under remat="full" twice a layer and microbatch (the forward
    and the recompute) and its backward once: the launch counts phase
    recurrent_train holds on the card (2 x 24 x 4 and 24 x 4 a step at
    rwkv6-1.6b's depth and 4 microbatches)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import TrainCtx, build_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init
    cfg = get_smoke("rwkv6-1.6b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    with _counted() as calls:
        toks = torch.randint(0, cfg.vocab_size, (2, 32),
                             generator=torch.Generator().manual_seed(1))
        lm.prefill(params, {"tokens": toks}, cfg, 32)
        assert calls == {"fwd": cfg.n_layers, "bwd": 0}
        calls.update(fwd=0)
        mb = 2
        step = build_train_step(cfg, ShapeConfig("t", 32, 4, "train"),
                                TrainCtx(num_microbatches=mb, loss_chunk=8))
        batch = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=1)
                            ).batch_at(0)
        out = step(params, adamw_init(params), lm.init_extras(cfg, "cpu"),
                   batch)
    assert calls == {"fwd": 2 * cfg.n_layers * mb,
                     "bwd": cfg.n_layers * mb}
    assert np.isfinite(float(out[3]["loss"]))


@pytest.fixture(scope="module")
def f32():
    """rwkv6's loss gradients against the reference's in float32,
    computed once in a REPRO_FORCE_F32=1 subprocess of this file."""
    here = os.path.dirname(__file__)
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, REPRO_FORCE_F32="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, __file__], check=True,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_rwkv6_grads_through_wkv_intra_equal_reference_f32(f32):
    assert f32["param_dtype"] == "float32"
    # every layer's time mix went through WkvIntra: its forward and the
    # remat recompute, and its backward
    assert f32["calls"] == {"fwd": 2 * f32["n_layers"],
                            "bwd": f32["n_layers"]}, f32["calls"]
    assert f32["loss_rel"] <= 1e-5, f32
    assert f32["n_grads"] == f32["n_ref_grads"] > 0
    assert max(f32["grad_rel"].values()) <= GRAD_TOL, f32["grad_rel"]
    wkv = {p: e for p, e in f32["grad_rel"].items()
           if any(n in p for n in ("t_r", "t_k", "w_base", "decay_"))}
    assert len(wkv) >= 5, sorted(f32["grad_rel"])


def _f32_child():
    """Body of the float32 subprocess: rwkv6-smoke's `loss_fn` (loss
    chunk 8, remat full) and its gradients on the perturbed weights of
    tests/test_torch_recurrent.py, against `jax.grad` of the reference's.
    Prints one JSON line."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as rlm
    from repro.parallel.ctx import make_ctx
    from test_torch_recurrent import B, S, _errs, _setup

    from repro_torch import tree
    from repro_torch.models import lm as tlm
    rc, tc, rp, tp = _setup("rwkv6-1.6b")
    toks = np.random.default_rng(5).integers(0, rc.vocab_size,
                                             (B, S)).astype(np.int32)
    batch = {"tokens": toks, "loss_mask": np.ones((B, S), np.float32)}
    (rloss, _), rg = jax.value_and_grad(
        lambda p: rlm.loss_fn(p, jax.tree.map(jnp.asarray, batch), {}, rc,
                              make_ctx(None, loss_chunk=8)),
        has_aux=True)(rp)
    preq = tree.tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    with _counted() as calls:
        tloss, _ = tlm.loss_fn(preq, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, {}, tc,
                               loss_chunk=8)
        tg = torch.autograd.grad(tloss, tree.leaves(preq))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(rg)]
    rgl = jax.tree.leaves(rg)
    print(json.dumps({
        "param_dtype": str(tree.leaves(tp)[0].dtype).split(".")[-1],
        "n_layers": tc.n_layers, "calls": calls,
        "loss_rel": _errs(tloss, rloss)[0],
        "n_grads": len(tg), "n_ref_grads": len(rgl),
        "grad_rel": {p: _errs(g, w)[0] for p, g, w in zip(paths, tg, rgl)}}))


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


#: (B, H, S, N, chunk, decay): the smoke's, rwkv6-1.6b's serve and
#: train chunks, ragged chunks (c % 4 and c % 8 != 0; 100: a short last
#: sub-chunk), chunks of one and of 7 (below a sub-chunk), the steep
#: decay, the cliff of 0..60 a token
CARD_CASES = {
    "smoke": (2, 4, 64, 16, 16, (0.0, 1.0)),
    "serve_chunk": (2, 4, 512, 64, 128, (0.0, 0.2)),
    "ragged_37": (1, 3, 74, 64, 37, (0.0, 1.0)),
    "ragged_13_n16": (2, 2, 26, 16, 13, (0.0, 1.0)),
    "ragged_100": (1, 2, 200, 64, 100, (0.0, 1.0)),
    "chunk_1": (1, 2, 8, 16, 1, (0.0, 1.0)),
    "chunk_7": (1, 2, 21, 64, 7, (0.0, 1.0)),
    "steep_64": (1, 2, 128, 64, 64, (2.9, 3.1)),
    "cliff_128": (1, 2, 256, 64, 128, (0.0, 60.0)),
    "cliff_37_n16": (1, 2, 74, 16, 37, (0.0, 60.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_wkv_kernels_equal_plain_on_card(cuda, case):
    B, H, S, N, c, decay = CARD_CASES[case]
    x = [t.to(cuda) for t in _inputs(B, H, S, N, c, 5, decay,
                                      torch.float32)]
    dA = torch.randn((B, H, S // c, c, c), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(6))
    ops.reset_launches()
    A = ops.wkv_intra(*x, c)
    got = ops.wkv_intra_bwd(*x, dA, c)
    torch.cuda.synchronize()
    assert ops.launches() == {"wkv_intra": 1, "wkv_intra_bwd": 1}
    assert _rel(A, ref.wkv_intra_plain(*x, c)) <= FWD_TOL
    want = ref.wkv_intra_bwd_plain(*x, dA, c)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= BWD_TOL, errs
    assert torch.equal(A, ops.wkv_intra(*x, c))
    assert all(torch.equal(g, h) for g, h in
               zip(got, ops.wkv_intra_bwd(*x, dA, c)))


@pytest.mark.cuda
def test_wkv_autograd_on_card_equals_plain(cuda):
    """`WkvIntra` on the card: its gradients are the backward kernel's
    and match the plain backward."""
    c = 16
    x = [t.to(cuda) for t in _inputs(2, 2, 48, 16, c, 7,
                                      dtype=torch.float32)]
    leaves = [t.clone().requires_grad_() for t in x]
    A = ops.wkv_intra(*leaves, c)
    dA = torch.randn(A.shape, device=cuda)
    got = torch.autograd.grad(A, leaves, dA)
    want = ref.wkv_intra_bwd_plain(*x, dA, c)
    assert max(_rel(g, w) for g, w in zip(got, want)) <= BWD_TOL


@pytest.mark.cuda
def test_wkv_wrapper_refuses_cpu_mixed_with_card(cuda):
    t = torch.zeros((1, 2, 32, 16), device=cuda)
    with pytest.raises(ValueError, match="expected"):
        ops.wkv_intra(t, t, t.cpu(), t, 16)


if __name__ == "__main__":
    _f32_child()
