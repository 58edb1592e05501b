"""The training slice of the LM/MoE stack held against the reference on
the CPU: the cross-entropies, `lm.loss_fn` and its gradients (dense and
MoE, with the aux loss), one `build_train_step` step, the optimizers,
`random.bits` and stochastic rounding, and the synthetic token stream.

Weights cross from JAX to the port through `models.convert`; inputs
come from numpy seeds. The float32 comparisons run in one subprocess
with REPRO_FORCE_F32=1 for both packages (read at import), built once
for the file. Tolerances, with their reasons (float32 throughout; the
two frameworks sum in other orders):

- softmax_xent and chunked_xent: XENT_TOL relative;
- loss_fn: the loss within LOSS_TOL relative, each gradient leaf within
  GRAD_TOL of its largest |value|; expert counts exact;
- one train step (M = 2, AdamW): params within PARAM_TOL (absolute: at
  step 1 the warmup lr is 3e-6, and AdamW's first update is about
  lr * sign(g)), router_bias exact (a sign update from exact counts),
  the metrics within METRIC_TOL relative;
- the optimizers on the same gradients: OPT_TOL relative; the lean
  variant's bf16 weights within one bf16 ULP (its stochastic rounding is
  bit-equal on equal float32 inputs, and the float32 update may differ
  in the last bit);
- `random.bits`, `_stochastic_round_bf16` and the token stream: bit for
  bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as rpipe  # noqa: E402
from repro.optim import adafactor as raf  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402

from repro_torch import random as trandom  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.optim import adafactor as taf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

XENT_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
METRIC_TOL = 1e-5
OPT_TOL = 1e-5
#: the four smokes of loss_fn's parity, and those of the train step
LOSS_ARCHS = ("tinyllama-1.1b", "yi-6b", "qwen2-7b", "qwen3-moe-30b-a3b",
              "deepseek-v3-671b")
STEP_ARCHS = ("tinyllama-1.1b", "qwen3-moe-30b-a3b", "deepseek-v3-671b")
#: the MoE smokes, and the one with an MTP head
MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
MTP_ARCHS = ("deepseek-v3-671b",)
#: step archs with an entry in AdamW's eps regime (test_train_step_...)
ADAM_EPS_ARCHS = ("deepseek-v3-671b",)
B, S = 4, 19  # S - 1 = 18 positions: two chunks of 8 and a remainder


@pytest.fixture(scope="module")
def f32():
    """The float32 comparisons, computed once in a REPRO_FORCE_F32=1
    subprocess of this file."""
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, REPRO_FORCE_F32="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, __file__], check=True,
                         capture_output=True, text=True, env=env,
                         timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


# --- float32 parity (the subprocess's results) -----------------------------


def test_child_ran_in_float32(f32):
    assert f32["param_dtypes"] == ["float32"]


@pytest.mark.parametrize("what", ["softmax", "chunk8", "chunk4",
                                  "grad_h", "grad_w"])
def test_xent_equals_reference(f32, what):
    assert f32["xent"][what] <= XENT_TOL, f32["xent"]


@pytest.mark.parametrize("arch,chunk", [(a, 8) for a in LOSS_ARCHS]
                         + [("tinyllama-1.1b", 0)])
def test_loss_fn_and_grads_equal_reference(f32, arch, chunk):
    r = f32["loss"][f"{arch}/{chunk}"]
    assert r["loss_rel"] <= LOSS_TOL, r
    assert r["xent_rel"] <= LOSS_TOL, r
    assert r["n_grads"] == r["n_ref_grads"] > 0
    assert max(r["grad_rel"].values()) <= GRAD_TOL, r["grad_rel"]
    if arch in MOE_ARCHS:
        assert r["aux_rel"] <= LOSS_TOL, r
        assert r["counts_equal"], r
    if arch in MTP_ARCHS:
        assert r["mtp_rel"] <= LOSS_TOL, r


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_equals_reference(f32, arch):
    r = f32["step"][arch]
    assert max(r["param_err"].values()) <= PARAM_TOL, r["param_err"]
    # the comparison is not vacuous: the step moved the weights by far
    # more than the two ports differ
    if arch in ADAM_EPS_ARCHS:
        # AdamW's first update is lr g / (|g| + eps): an entry whose
        # gradient sits at eps moves by a fraction of lr set by the
        # gradient's last bits (measured: 1 of 8,192 entries of the dense
        # layer's w_gate, -0.40 against +0.09 of a typical 3.0 x 1e-6
        # move). Every other entry is held to the 10x below.
        assert r["moved"] > 5 * max(r["param_err"].values())
        assert r["far_share"] <= 1e-3, r["far_share"]
    else:
        assert r["moved"] > 10 * max(r["param_err"].values())
    for k in ("loss", "grad_norm", "lr"):
        assert r["metric_rel"][k] <= METRIC_TOL, r["metric_rel"]
    if arch in MOE_ARCHS:
        assert r["router_bias_equal"] and r["bias_moved"], r


# --- optimizers on the same gradients (in-process) --------------------------


def _grads_seq(seed, n, shapes):
    r = np.random.default_rng(seed)
    return [{k: (r.normal(size=s) * 10 ** r.uniform(-3, 1)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(n)]


SHAPES = {"w": (6, 5), "b": (5,), "stack": (2, 3, 4)}
OPTS = {"adamw": (radamw.adamw_init, radamw.adamw_apply,
                  tadamw.adamw_init, tadamw.adamw_apply),
        "adafactor": (raf.adafactor_init, raf.adafactor_apply,
                      taf.adafactor_init, taf.adafactor_apply),
        "adafactor_lean": (raf.adafactor_lean_init, raf.adafactor_lean_apply,
                           taf.adafactor_lean_init,
                           taf.adafactor_lean_apply)}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_equals_reference(name):
    rinit, rapply, tinit, tapply = OPTS[name]
    c = radamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                           clip_norm=5.0)
    r = np.random.default_rng(3)
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    lean = name == "adafactor_lean"
    rp = {k: jnp.asarray(v).astype(jnp.bfloat16 if lean else jnp.float32)
          for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if lean
                                    else torch.float32)
          for k, v in p0.items()}
    rs, ts = rinit(rp), tinit(tp)
    for g in _grads_seq(4, 6, SHAPES):
        rp, rs, rm = rapply(c, {k: jnp.asarray(v) for k, v in g.items()},
                            rs, rp)
        tp, ts, tm = tapply(c, {k: torch.from_numpy(v) for k, v in
                                g.items()}, ts, tp)
        assert _rel(tm["grad_norm"], rm["grad_norm"]) <= OPT_TOL
        assert _rel(tm["lr"], rm["lr"]) <= OPT_TOL
    for k in SHAPES:
        got = tp[k].float().numpy()
        want = np.asarray(rp[k], np.float32)
        if lean:  # within one bf16 ULP of the reference's weight
            ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
            assert np.all(np.abs(got - want) <= ulp), k
            assert np.mean(got == want) > 0.9
        else:
            assert _rel(got, want) <= OPT_TOL, k
    assert int(ts["step"]) == int(rs["step"]) == 6
    want_state = jax.tree_util.tree_leaves_with_path(rs)
    assert len(tree.leaves(ts)) == len(want_state)


def _quadratic(apply_fn, init_fn, torch_side: bool, steps=60):
    """The reference's test_optim quadratic: minimise ||w - target||^2
    from 0 with lr 0.1; the loss trajectory."""
    opt = radamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10_000,
                             weight_decay=0.0)
    target = np.array([1.0, -2.0, 3.0], np.float32)
    if torch_side:
        params, tgt = {"w": torch.zeros(3)}, torch.from_numpy(target)
    else:
        params, tgt = {"w": jnp.zeros(3, jnp.float32)}, jnp.asarray(target)
    state = init_fn(params)
    out = []
    for _ in range(steps):
        params, state, _ = apply_fn(opt, {"w": 2 * (params["w"] - tgt)},
                                    state, params)
        out.append(float(((params["w"] - tgt) ** 2).sum()))
    return np.asarray(out)


@pytest.mark.parametrize("name,factor", [("adamw", 1e-2),
                                         ("adafactor", 0.1),
                                         ("adafactor_lean", 0.1)])
def test_quadratic_convergence_equals_reference(name, factor):
    rinit, rapply, tinit, tapply = OPTS[name]
    got = _quadratic(tapply, tinit, True)
    want = _quadratic(rapply, rinit, False)
    assert got[-1] < factor * got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_adamw_grad_clip_equals_reference():
    c = radamw.AdamWConfig(lr=0.1, warmup_steps=0, clip_norm=1.0)
    huge = np.full(4, 1e9, np.float32)
    rp, _, rm = radamw.adamw_apply(c, {"w": jnp.asarray(huge)},
                                   radamw.adamw_init({"w": jnp.zeros(4)}),
                                   {"w": jnp.zeros(4)})
    tp, _, tm = tadamw.adamw_apply(c, {"w": torch.from_numpy(huge)},
                                   tadamw.adamw_init({"w": torch.zeros(4)}),
                                   {"w": torch.zeros(4)})
    assert float(tm["grad_norm"]) == pytest.approx(2e9)
    assert np.abs(tp["w"].numpy()).max() < 1.0
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(rp["w"]),
                               rtol=OPT_TOL)


@pytest.mark.parametrize("step", [0, 1, 10, 50, 100, 101, 5000, 10_000,
                                  20_000])
def test_lr_schedule_equals_reference(step):
    c = radamw.AdamWConfig(lr=1.0, warmup_steps=100, total_steps=10_000)
    want = float(radamw.lr_at(c, step))
    assert float(tadamw.lr_at(c, step)) == pytest.approx(want, rel=1e-6)
    assert float(tadamw.lr_at(c, torch.tensor(step, dtype=torch.int32))) \
        == pytest.approx(want, rel=1e-6)


def test_tree_walks_hold_no_reference_cycle():
    """`tree.leaves` and `tree.unflatten` leave nothing for the garbage
    collector: their leaves are freed as soon as the caller drops them
    (a self-calling nested walk once held 27 GB of weights on the card
    until a collection)."""
    import gc
    import weakref
    gc.disable()
    try:
        t = torch.zeros(3)
        ref = weakref.ref(t)
        flat = tree.leaves({"b": [t, None], "a": (torch.ones(1),)})
        assert flat[1] is t
        back = tree.unflatten(tree.structure({"b": [t, None],
                                              "a": (t,)}), flat)
        assert back["b"][0] is t
        del flat, back, t
        assert ref() is None
    finally:
        gc.enable()


def test_adafactor_lean_state_is_small():
    params = {"w": torch.zeros((64, 64), dtype=torch.bfloat16)}
    nbytes = lambda t: sum(x.numel() * x.element_size()  # noqa: E731
                           for x in tree.leaves(t))
    assert nbytes(taf.adafactor_lean_init(params)) < 0.05 * nbytes(
        taf.adafactor_init(params))


# --- random bits and stochastic rounding ------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (7,)), (17, (3, 5)),
                                        (123456789, (2, 3, 4))])
def test_random_bits_bit_equal(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape,
                                      jnp.uint32))
    got = trandom.bits(trandom.key(seed), shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("step,leaf", [(1, 0), (7, 3)])
def test_stochastic_round_bf16_bit_equal(step, leaf):
    """The lean optimizer's key chain, fold_in(fold_in(key(17), step),
    leaf), and the rounding of float32 values of every sign and scale."""
    r = np.random.default_rng(step)
    x = (r.normal(size=(33, 17)) * 10.0 ** r.integers(-20, 20, (33, 17))
         ).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10)]
    rk = jax.random.fold_in(jax.random.fold_in(jax.random.key(17), step),
                            leaf)
    tk = trandom.fold_in(trandom.fold_in(trandom.key(17), step), leaf)
    want = np.asarray(raf._stochastic_round_bf16(rk, jnp.asarray(x)))
    got = taf._stochastic_round_bf16(tk, torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))


def test_stochastic_rounding_unbiased():
    x = torch.full((20000,), 1.0 + 2 ** -10)  # between bf16 grid points
    r = taf._stochastic_round_bf16(trandom.key(0), x).float()
    assert len(torch.unique(r)) == 2  # the two neighbours only
    assert abs(float(r.mean()) - float(x[0])) < 2e-4


# --- the synthetic token stream ---------------------------------------------


@pytest.mark.parametrize("order", [1, 2])
def test_synthetic_lm_bit_equal(order):
    kw = dict(vocab_size=97, seq_len=33, global_batch=3, seed=5,
              order=order)
    r = rpipe.SyntheticLM(rpipe.DataConfig(**kw))
    t = tpipe.SyntheticLM(tpipe.DataConfig(**kw))
    for step in (0, 1, 12):
        want, got = r.batch_at(step), t.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("start", [0, 3])
def test_make_pipeline_resumes_bit_equal(start):
    kw = dict(vocab_size=50, seq_len=9, global_batch=2, seed=1, prefetch=3)
    rit = rpipe.make_pipeline(rpipe.DataConfig(**kw), start_step=start)
    tit = tpipe.make_pipeline(tpipe.DataConfig(**kw), start_step=start)
    for _ in range(4):
        want, got = next(rit), next(tit)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    rit.close()
    tit.close()


# --- the float32 subprocess --------------------------------------------------


def _child():
    """Body of the float32 subprocess: prints one JSON line."""
    torch.set_num_threads(1)
    from repro import configs as rcfg
    from repro.configs.base import ShapeConfig as RShape
    from repro.launch import steps as rsteps
    from repro.models import layers as rlayers
    from repro.models import lm as rlm
    from repro.parallel.ctx import make_ctx

    from repro_torch import configs as tcfg
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import convert
    from repro_torch.models import layers as tlayers
    from repro_torch.models import lm as tlm

    def npy(t):
        return jax.tree.map(np.asarray, t)

    def rel(got, want):
        return _rel(got.detach().float().numpy() if torch.is_tensor(got)
                    else got, want)

    def paths(t):
        return [jax.tree_util.keystr(p) for p, _ in
                jax.tree_util.tree_leaves_with_path(t)]

    probe = convert.params_from_numpy(npy(rlm.init_params(
        jax.random.key(0), rcfg.get_smoke("tinyllama-1.1b"))))
    res = {"param_dtypes": sorted({str(t.dtype).split(".")[-1]
                                   for t in tree.leaves(probe)})}

    # cross-entropies and their gradients
    r = np.random.default_rng(0)
    h = r.normal(size=(2, 19, 16)).astype(np.float32)
    pe = {"embedding": r.normal(size=(64, 16)).astype(np.float32),
          "lm_head": (r.normal(size=(16, 64)) * 0.3).astype(np.float32)}
    lab = r.integers(0, 64, (2, 19)).astype(np.int32)
    mask = (r.random((2, 19)) > 0.2).astype(np.float32)
    px = make_ctx(None)
    xent = {"softmax": rel(
        tlayers.softmax_xent(torch.from_numpy(h) @ torch.from_numpy(
            pe["lm_head"]), torch.from_numpy(lab), torch.from_numpy(mask)),
        rlayers.softmax_xent(jnp.asarray(h) @ jnp.asarray(pe["lm_head"]),
                             jnp.asarray(lab), jnp.asarray(mask)))}

    def rchunk(hh, ww, c):
        tot, cnt = rlayers.chunked_xent(
            hh, {"lm_head": ww}, jnp.asarray(lab), jnp.asarray(mask), px,
            None, c)
        return tot / cnt

    for c in (8, 4):
        th = torch.from_numpy(h).requires_grad_()
        tw = torch.from_numpy(pe["lm_head"]).requires_grad_()
        tot, cnt = tlayers.chunked_xent(th, {"lm_head": tw},
                                        torch.from_numpy(lab),
                                        torch.from_numpy(mask), c)
        loss = tot / cnt
        want, (gh, gw) = jax.value_and_grad(rchunk, argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(pe["lm_head"]), c)
        xent[f"chunk{c}"] = rel(loss, want)
        if c == 8:
            dh, dw = torch.autograd.grad(loss, (th, tw))
            xent["grad_h"] = rel(dh, gh)
            xent["grad_w"] = rel(dw, gw)
    res["xent"] = xent

    # loss_fn and its gradients
    res["loss"] = {}
    for arch, chunk in [(a, 8) for a in LOSS_ARCHS] + [("tinyllama-1.1b",
                                                        0)]:
        rc, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
        rp = rlm.init_params(jax.random.key(1), rc)
        tp = convert.params_from_numpy(npy(rp))
        re = rlm.init_extras(rc)
        if rc.moe is not None:  # a nonzero selection bias
            re = dict(re, router_bias=jnp.asarray(
                np.random.default_rng(2).normal(
                    size=re["router_bias"].shape).astype(np.float32) * 0.01))
        te = convert.params_from_numpy(npy(re))
        toks = np.random.default_rng(3).integers(0, rc.vocab_size,
                                                 (2, S)).astype(np.int32)
        batch = {"tokens": toks, "loss_mask": np.ones((2, S), np.float32)}
        rpx = make_ctx(None, loss_chunk=chunk)
        (rloss, rmet), rg = jax.value_and_grad(
            lambda p: rlm.loss_fn(p, jax.tree.map(jnp.asarray, batch), re,
                                  rc, rpx), has_aux=True)(rp)
        preq = tree.tree_map(lambda t: t.detach().requires_grad_(), tp)
        tloss, tmet = tlm.loss_fn(preq, {k: torch.from_numpy(v) for k, v in
                                         batch.items()}, te, tc,
                                  loss_chunk=chunk)
        tg = torch.autograd.grad(tloss, tree.leaves(preq))
        rgl = jax.tree.leaves(rg)
        out = {"loss_rel": rel(tloss, rloss),
               "xent_rel": rel(tmet["xent"], rmet["xent"]),
               "n_grads": len(tg), "n_ref_grads": len(rgl),
               "grad_rel": {p: rel(g, w) for p, g, w in
                            zip(paths(rg), tg, rgl)}}
        if "mtp_loss" in rmet:
            out["mtp_rel"] = rel(tmet["mtp_loss"], rmet["mtp_loss"])
        if rc.moe is not None:
            out["aux_rel"] = rel(tmet["moe_aux_loss"], rmet["moe_aux_loss"])
            out["counts_equal"] = bool(np.array_equal(
                tmet["expert_counts"].numpy(),
                np.asarray(rmet["expert_counts"])))
        res["loss"][f"{arch}/{chunk}"] = out

    # one train step, two microbatches, AdamW
    res["step"] = {}
    for arch in STEP_ARCHS:
        rc, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
        rp = rlm.init_params(jax.random.key(4), rc)
        tp = convert.params_from_numpy(npy(rp))
        toks = np.random.default_rng(5).integers(0, rc.vocab_size,
                                                 (B, S)).astype(np.int32)
        batch = {"tokens": toks, "loss_mask": np.ones((B, S), np.float32)}
        rpx = make_ctx(None, loss_chunk=8,
                       num_microbatches=2)
        rb = rsteps.build_train_step(rc, RShape("t", S, B, "train"), rpx)
        ropt = radamw.adamw_init(rp)
        rp2, _, re2, rm = jax.jit(rb.fn)(rp, ropt, rlm.init_extras(rc),
                                         jax.tree.map(jnp.asarray, batch))
        tfn = tsteps.build_train_step(
            tc, TShape("t", S, B, "train"),
            tsteps.TrainCtx(num_microbatches=2, loss_chunk=8))
        tp2, _, te2, tm = tfn(tp, tadamw.adamw_init(tp),
                              tlm.init_extras(tc, "cpu"), batch)
        out = {"param_err": {p: float(np.abs(g.float().numpy() - w).max())
                             for p, g, w in zip(paths(rp2),
                                                tree.leaves(tp2),
                                                jax.tree.leaves(npy(rp2)))},
               "moved": max(float(np.abs(np.asarray(a, np.float32)
                                         - np.asarray(b, np.float32)).max())
                            for a, b in zip(jax.tree.leaves(rp2),
                                            jax.tree.leaves(rp))),
               "n": sum(int(np.size(a)) for a in jax.tree.leaves(rp2)),
               "metric_rel": {k: rel(tm[k], rm[k])
                              for k in ("loss", "grad_norm", "lr")}}
        # the share of entries off by more than a tenth of the move
        out["far_share"] = sum(int((np.abs(g.float().numpy() - w) > 0.1 *
                                    out["moved"]).sum())
                               for g, w in zip(tree.leaves(tp2),
                                               jax.tree.leaves(npy(rp2)))
                               ) / out.pop("n")
        if rc.moe is not None:
            want = np.asarray(re2["router_bias"])
            out["router_bias_equal"] = bool(np.array_equal(
                te2["router_bias"].numpy(), want))
            out["bias_moved"] = bool(np.abs(want).max() > 0)
        res["step"][arch] = out
    print(json.dumps(res))


if __name__ == "__main__":
    _child()
