"""The encoder-decoder (seamless-m4t-medium: bidirectional encoder,
decoder with a read-only cross-attention cache) and vision-token
(internvl2-2b) families in the port, held against the reference on the
CPU on their smoke configs.

Weights cross from JAX through `models.convert`; inputs (frames, tokens,
vision embeddings) come from numpy seeds. Tolerances, each on a
module's or the model's output as a share of the reference's largest
|value| (every leaf of a tuple or cache on its own):

- bfloat16: a module within LOGIT_MAX (tests/test_torch_dense.py's: a
  few bf16 ULPs carried through two layers). seamless's decode steps'
  logits per row within tests/test_torch_serve.py's LOGIT_MAX
  (SERVE_LOGIT_MAX) instead. The served logits, both families: per row
  within SERVE_LOGIT_MAX (internvl2: the median row within LOGIT_TOL),
  the port's distance to the float32 model (the same bf16-valued
  weights and inputs in float32, from the subprocess) within
  TRUTH_SLACK of the reference's own, greedy picks equal where the
  reference's top-2 margin exceeds twice the row's error. seamless is
  looser because the reference rounds each raw score q.k to bfloat16
  before it scales it (`src/repro/models/attention.py:75, 227`), where
  the port's kernels and plain versions keep it in float32, and the
  smoke's scores reach ~60 (its init scales a (d, H, Dh) projection by
  H^-1/2), where one bfloat16 step of a raw score moves a probability
  by ~28%: both packages' bf16 logits are ~7% of the scale from the
  float32 model there (median row);
- float32 (REPRO_FORCE_F32=1 for both packages, in one subprocess of
  this file, on the same weights as float32 values): F32_TOL,
  summation order only, and every gradient leaf of a block within
  GRAD_TOL of its largest |value|. The smoke's peaky
  attention amplifies rounding: the reference's float32 encoder is
  F32_TOL's order from the same encoder in float64
  (`test_encoder_is_as_close_to_float64_as_the_reference`), so what runs
  through it or its cross attention (`encode`, the prefill, decode over
  the cross cache) is held within ENC_F32_TOL, and each gradient of
  `encdec_loss` within ULP_FACTOR times the move of the reference's own
  gradient leaf when its frames move by one ULP (GRAD_TOL at least).

The reference rotates a decode step's cross query at S_src - 1 and the
loss's at the target positions (ROADMAP.md, known red in the
reference): `test_decode_does_not_reproduce_the_loss_logits_*` measures
that gap in both packages.
"""
import dataclasses
import functools
import json
import os
import pickle
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rcfg  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import encdec as renc  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.parallel.ctx import make_ctx  # noqa: E402

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import encdec as tenc  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from test_torch_serve import LOGIT_MAX as SERVE_LOGIT_MAX  # noqa: E402
from test_torch_serve import LOGIT_TOL  # noqa: E402

torch.set_num_threads(1)

ENCDEC, VISION = "seamless-m4t-medium", "internvl2-2b"
ARCHS = (ENCDEC, VISION)
LOGIT_MAX = 3e-2
F32_TOL = 1e-5
GRAD_TOL = 1e-4
#: seamless's modules that run through the encoder or its peaky cross
#: attention, in float32 (the module docstring)
ENC_F32_TOL = 5e-5
ENC_MODULES = ("encode", "encdec_prefill", "encdec_decode")
#: bfloat16 serving: the port's distance to the float32 model within this
#: factor of the reference's own
TRUTH_SLACK = 1.25
#: encdec_loss's gradients: this many times the reference's own move
#: under a one-ULP change of its frames
ULP_FACTOR = 10
#: the full configs' parameters as the reference allocates them
#: (`jax.eval_shape` of `init_params`)
ALLOCATED = {ENCDEC: 978_909_184, VISION: 1_893_828_608}
PX = make_ctx(None)
#: batch, target (or prompt) length, source frames, decode steps, served
#: steps
B, S, S_SRC, STEPS, GEN = 2, 16, 24, 4, 6
#: the float32 subprocess reads the parent's weights from this file
PARAMS_ENV = "TEST_TORCH_ENCDEC_PARAMS"
MODULES = {ENCDEC: ("encode", "enc_cross_kv", "dec_block_full",
                    "encdec_prefill", "encdec_decode"),
           VISION: ("embed_inputs", "prefill", "decode_step")}
CASES = [(a, m) for a in ARCHS for m in MODULES[a]]


def _np(t):
    return jax.tree.map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's smoke weights as numpy: drawn here, or in the
    float32 subprocess the parent's, as float32 values."""
    if PARAMS_ENV in os.environ:
        with open(os.environ[PARAMS_ENV], "rb") as f:
            return pickle.load(f)[arch]
    return _np(rlm.init_params(jax.random.key(0), rcfg.get_smoke(arch)))


def _setup(arch, **fields):
    """(reference config, port config, reference params as jnp, port
    params, a fresh copy), the smoke's fields replaced by `fields` (none
    of which changes the weights)."""
    rc = dataclasses.replace(rcfg.get_smoke(arch), **fields)
    tc = dataclasses.replace(tcfg.get_smoke(arch), **fields)
    rp = _ref_params(arch)
    return rc, tc, jax.tree.map(jnp.asarray, rp), \
        convert.params_from_numpy(rp)


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a))


def _rnd(r, shape, scale=1.0):
    """A numpy draw rounded to the reference's compute dtype."""
    a = (scale * r.normal(size=shape)).astype(np.float32)
    return np.asarray(jnp.asarray(a).astype(rlayers.COMPUTE_DT))


def _bf16(a):
    """float32 numpy values rounded to bfloat16, as float32."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _flat(t):
    return [x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32) for x in tree.leaves(t)]


def _errs(got, want):
    """max |got - want| / max |want| of each leaf."""
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), (len(g), len(w))
    out = []
    for a, b in zip(g, w):
        assert a.shape == b.shape, (a.shape, b.shape)
        out.append(float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                   1e-30)))
    return out


def _rows(got, want):
    """Per (step, row) max |got - want| of a list of (B, V) logits, over
    the largest |want| of all steps."""
    g, w = _flat(got), _flat(want)
    scale = max(np.abs(x).max() for x in w)
    return np.stack([np.abs(a - b).max(-1) / scale for a, b in zip(g, w)])


def _inputs(rc, seed=100):
    """frames (B, S_SRC, FRAME_DIM), tokens (B, S), the next tokens (B,),
    vision embeddings (B, n, d) and a forced token stream (B, GEN + 1)
    from one numpy seed, the float inputs bf16-valued (the models round
    them so)."""
    r = np.random.default_rng(seed)
    return {"frames": _bf16(r.normal(size=(B, S_SRC, renc.FRAME_DIM))),
            "tokens": r.integers(0, rc.vocab_size, (B, S)).astype(np.int32),
            "next": r.integers(0, rc.vocab_size, (B,)).astype(np.int32),
            "vision_embeds": _bf16(r.normal(size=(
                B, max(rc.n_vision_tokens, 1), rc.d_model))),
            "forced": r.integers(0, rc.vocab_size, (B, GEN + 1)).astype(
                np.int32)}


def _decode_steps(decode, params, cache, tokens, start):
    """STEPS teacher-forced decode steps feeding tokens[:, i] at
    position start + i: (each step's logits, the last cache)."""
    logits = []
    for i in range(STEPS):
        cache, lg = decode(params, cache, tokens[:, i], start + i)
        logits.append(lg)
    return logits, cache


def module_case(arch, what):
    """(port result, reference result) of one module on the same weights
    and inputs (layer 0 for a block; a decode from the reference's
    prefill cache)."""
    rc, tc, rp, tp = _setup(arch)
    ins = _inputs(rc)
    r = np.random.default_rng(7)
    d = rc.d_model
    if arch == VISION:
        batch = {k: ins[k] for k in ("tokens", "vision_embeds")}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        if what == "embed_inputs":
            return (tlm._embed_inputs(tp, tb, tc),
                    rlm._embed_inputs(rp, jb, rc, PX, None))
        wc, wl = jax.jit(lambda p, b: rlm.prefill(
            p, b, rc, PX, cache_len=S + STEPS))(rp, jb)
        if what == "prefill":
            gc, gl = tlm.prefill(tp, tb, tc, S + STEPS)
            return (gl, gc), (wl, wc)
        nxt = ins["next"]
        wc2, wl2 = jax.jit(lambda p, c, t: rlm.decode_step(
            p, c, t, jnp.int32(S), {}, rc, PX))(rp, wc, jnp.asarray(nxt))
        gc2, gl2 = tlm.decode_step(tp, convert.params_from_numpy(_np(wc)),
                                   torch.from_numpy(nxt), S, {}, tc)
        return (gl2, gc2), (wl2, wc2)
    rl = jax.tree.map(lambda a: a[0], rp["dec_layers"])
    tl = tlm.layer(tp["dec_layers"], 0)
    frames = ins["frames"]
    if what == "encode":
        return (tenc.encode(tp, _t(frames), tc),
                _ref_encode(rc)(rp, jnp.asarray(frames)))
    if what == "enc_cross_kv":
        enc = _rnd(r, (B, S_SRC, d))
        return (tenc._enc_cross_kv(tl, _t(enc), tc),
                renc._enc_cross_kv(rl, jnp.asarray(enc), rc, PX, None))
    if what == "dec_block_full":
        x = _rnd(r, (B, S, d))
        H, Dh = rc.n_kv_heads, rc.resolved_head_dim
        kv = tuple(_rnd(r, (B, H, S_SRC, Dh)) for _ in range(2))
        return (tenc._dec_block_full(tl, _t(x), tuple(map(_t, kv)), tc,
                                     collect_cache=True),
                jax.jit(lambda p, xx, kv: renc._dec_block_full(
                    p, xx, kv, rc, PX, None, True))(
                        rl, jnp.asarray(x), tuple(map(jnp.asarray, kv))))
    wc, wl = jax.jit(lambda p, f: renc.encdec_prefill(
        p, {"frames": f}, rc, PX, cache_len=STEPS))(rp, jnp.asarray(frames))
    if what == "encdec_prefill":
        gc, gl = tenc.encdec_prefill(tp, {"frames": _t(frames)}, tc, STEPS)
        return (gl, gc), (wl, wc)
    toks = ins["tokens"]
    want = _decode_steps(jax.jit(lambda p, c, t, pos: renc.encdec_decode(
        p, c, t, pos, {}, rc, PX)), rp, wc, jnp.asarray(toks), 0)
    got = _decode_steps(lambda p, c, t, pos: tenc.encdec_decode(
        p, c, t, pos, {}, tc), tp, convert.params_from_numpy(_np(wc)),
        torch.from_numpy(toks), 0)
    return got, want


def _ref_encode(rc):
    return jax.jit(lambda p, f: renc.encode(p, f, rc, PX, None))


def _ref_decoder(rc):
    """The reference's decoder over a whole target, as its loss runs it:
    logits (B, T, V) of (params, frames, tokens)."""
    def full(p, frames, toks):
        enc = renc.encode(p, frames, rc, PX, None)
        x = rlayers.embed_fwd(p["embed"], toks, PX, None)
        for i in range(rc.n_layers):
            pl = jax.tree.map(lambda a: a[i], p["dec_layers"])
            kv = renc._enc_cross_kv(pl, enc, rc, PX, None)
            x, _ = renc._dec_block_full(pl, x, kv, rc, PX, None, False)
        return rlayers.lm_head_fwd(p["embed"], rlayers.rmsnorm(
            p["final_norm"], x, rc.norm_eps), PX, None)
    return jax.jit(full)


def decoder_logits(pkg, arch_fields=None):
    """(the decoder's full-sequence logits over the target, as the loss
    computes them, and STEPS teacher-forced decode steps' logits) of the
    encoder-decoder smoke in `pkg` ("reference" or "port"), each (B,
    STEPS, V), on the same weights and inputs."""
    rc, tc, rp, tp = _setup(ENCDEC, **(arch_fields or {}))
    ins = _inputs(rc)
    toks = ins["tokens"][:, :STEPS]
    if pkg == "reference":
        frames = jnp.asarray(ins["frames"])
        full = _ref_decoder(rc)(rp, frames, jnp.asarray(toks))
        cache, _ = jax.jit(lambda p, f: renc.encdec_prefill(
            p, {"frames": f}, rc, PX, STEPS))(rp, frames)
        steps, _ = _decode_steps(jax.jit(lambda p, c, t, pos: (
            renc.encdec_decode(p, c, t, pos, {}, rc, PX))), rp, cache,
            jnp.asarray(toks), 0)
        return np.asarray(full, np.float32), np.stack(
            [np.asarray(s, np.float32) for s in steps], 1)
    frames = _t(ins["frames"])
    enc = tenc.encode(tp, frames, tc)
    x = tlayers.embed_fwd(tp["embed"], torch.from_numpy(toks))
    for i in range(tc.n_layers):
        p = tlm.layer(tp["dec_layers"], i)
        x, _ = tenc._dec_block_full(p, x, tenc._enc_cross_kv(p, enc, tc), tc)
    full = tlayers.lm_head_fwd(tp["embed"], tlayers.rmsnorm(
        tp["final_norm"], x, tc.norm_eps))
    cache, _ = tenc.encdec_prefill(tp, {"frames": frames}, tc, STEPS)
    steps, _ = _decode_steps(lambda p, c, t, pos: tenc.encdec_decode(
        p, c, t, pos, {}, tc), tp, cache, torch.from_numpy(toks), 0)
    return full.float().numpy(), torch.stack(steps, 1).float().numpy()


def decode_gaps(arch_fields=None) -> dict:
    """max |decode - full| / max |full| of each package's decoder."""
    out = {}
    for pkg in ("reference", "port"):
        full, steps = decoder_logits(pkg, arch_fields)
        out[pkg] = float(np.abs(steps - full).max() / np.abs(full).max())
    return out


# --- configs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("get", ["get_arch", "get_smoke"])
def test_configs_equal_the_reference(arch, get):
    r, t = getattr(rcfg, get)(arch), getattr(tcfg, get)(arch)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    for prop in ("resolved_head_dim", "padded_vocab"):
        assert getattr(r, prop) == getattr(t, prop)
    assert r.param_count() == t.param_count()
    assert r.shapes() == t.shapes()


def _meta_count(cfg) -> int:
    """The port's full parameter tree counted without its memory: every
    draw made on the meta device."""
    def randn(shape, **kw):
        return torch.empty(shape, dtype=kw.get("dtype"), device="meta")

    with mock.patch.object(torch, "randn", randn):
        params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    return sum(t.numel() for t in tree.leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_as_the_repo_defines_them(arch):
    c = tcfg.get_arch(arch)
    if arch == ENCDEC:
        assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                c.resolved_head_dim, c.d_ff, c.vocab_size, c.padded_vocab,
                c.encoder_decoder, c.tie_embeddings) == (
                    12, 1024, 16, 16, 64, 4096, 256_206, 256_256, True,
                    False)
    else:
        assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                c.resolved_head_dim, c.d_ff, c.padded_vocab,
                c.n_vision_tokens, c.rope_theta) == (
                    24, 2048, 16, 8, 128, 8192, 92_672, 256, 1e6)
    shapes = jax.eval_shape(lambda: rlm.init_params(jax.random.key(0),
                                                    rcfg.get_arch(arch)))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == ALLOCATED[arch] == _meta_count(c)


# --- parameters --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_tree(arch):
    rc, tc, rp, tp = _setup(arch)
    ti = tlm.init_params(torch.Generator().manual_seed(0), tc)
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), _np(rp))
    assert want == tree.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), ti)
    assert want == tree.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tp)
    for a, t in zip(jax.tree.leaves(_np(rp)), tree.leaves(tp)):
        assert np.array_equal(t.float().numpy(), a.astype(np.float32))
    assert ("vision_proj" in ti) == (arch == VISION)
    assert tlm.init_extras(tc, "cpu") == {}


def test_other_families_draw_no_vision_weights():
    """The vision draw comes after every other family's layers and only
    for a config with vision tokens: the dense smoke's weights are the
    same whatever n_vision_tokens says of another config."""
    tc = tcfg.get_smoke("tinyllama-1.1b")
    a = tlm.init_params(torch.Generator().manual_seed(0), tc)
    b = tlm.init_params(torch.Generator().manual_seed(0), dataclasses.replace(
        tc, n_vision_tokens=4))
    assert "vision_proj" not in a and "vision_proj" in b
    for x, y in zip(tree.leaves(a), tree.leaves({k: v for k, v in b.items()
                                                  if k != "vision_proj"})):
        assert torch.equal(x, y)


def test_model_fns_pick_the_reference_family():
    for arch in ARCHS:
        want = rsteps.model_fns(rcfg.get_smoke(arch))
        got = tsteps.model_fns(tcfg.get_smoke(arch))
        assert [f.__name__ for f in got] == [f.__name__ for f in want]
    assert tsteps.model_fns(tcfg.get_smoke(ENCDEC))[1] is \
        tenc.encdec_prefill


# --- bfloat16 parity (in process) --------------------------------------------


@pytest.mark.parametrize("arch,what", CASES)
def test_module_equals_reference_bf16(arch, what):
    got, want = module_case(arch, what)
    if what == "encdec_decode":  # rows within serve's (module docstring)
        errs = _rows(got[0], want[0])
        assert errs.max() <= SERVE_LOGIT_MAX, errs
        got, want = got[1], want[1]  # the caches after the last step
    errs = _errs(got, want)
    assert max(errs) <= LOGIT_MAX, errs


def test_cross_cache_is_contiguous_and_read_only():
    """The prefill lays each layer's cross K/V out (L, B, S_src, Hkv, Dh)
    contiguous (flash_decode refuses a strided cache), the self cache
    (L, B, steps, Hkv, Dh) zero; a decode step writes one self row and
    leaves the cross cache as it was."""
    rc, tc, _, tp = _setup(ENCDEC)
    ins = _inputs(rc)
    cache, logits = tenc.encdec_prefill(tp, {"frames": _t(ins["frames"])},
                                        tc, STEPS)
    L, H, Dh = tc.n_layers, tc.n_kv_heads, tc.resolved_head_dim
    for part, rows in (("cross", S_SRC), ("self", STEPS)):
        for k in "kv":
            t = cache[part][k]
            assert tuple(t.shape) == (L, B, rows, H, Dh) and t.is_contiguous()
    assert not cache["self"]["k"].any() and tuple(logits.shape) == (
        B, 1, tc.padded_vocab)
    cross = tree.tree_map(torch.clone, cache["cross"])
    cache, _ = tenc.encdec_decode(tp, cache, torch.from_numpy(
        ins["next"]), 0, {}, tc)
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(cache["cross"]), tree.leaves(cross)))
    assert cache["self"]["k"][:, :, 0].any() and \
        not cache["self"]["k"][:, :, 1:].any()


def _reference_serve(rc, rp, ins):
    """The reference's serve loop teacher-forced on ins["forced"]: the
    prefill's last logits and each step's, (B, V) float32."""
    if rc.encoder_decoder:
        batch = {"frames": jnp.asarray(ins["frames"])}
        prefill, decode, start = renc.encdec_prefill, renc.encdec_decode, 0
    else:
        batch = {k: jnp.asarray(ins[k]) for k in ("tokens", "vision_embeds")}
        prefill, decode, start = rlm.prefill, rlm.decode_step, S
    cache, logits = jax.jit(lambda p, b: prefill(
        p, b, rc, PX, cache_len=start + GEN))(rp, batch)
    step = jax.jit(lambda p, c, t, pos: decode(p, c, t, pos, {}, rc, PX))
    logs = [np.asarray(logits[:, -1], np.float32)]
    for i in range(GEN):
        cache, lg = step(rp, cache, jnp.asarray(ins["forced"][:, i]),
                         jnp.int32(start + i))
        logs.append(np.asarray(lg, np.float32))
    return logs


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_equals_reference_bf16(f32, arch):
    """`launch.serve.serve` on the CPU (seamless: 24 frames; internvl2:
    16 prompt tokens, the first 8 vision tokens), 6 steps teacher-forced
    on a random stream: every row of every step's logits within
    tests/test_torch_serve.py's LOGIT_MAX of the reference's (internvl2:
    the median row within its LOGIT_TOL), the port's distance to the
    float32 model (median and largest row) within TRUTH_SLACK of the
    reference's own, and its greedy picks the reference's wherever the
    reference's top-2 margin exceeds twice the row's error."""
    rc, tc, rp, tp = _setup(arch)
    ins = _inputs(rc)
    rlogs = _reference_serve(rc, rp, ins)
    given = ({"frames": torch.from_numpy(ins["frames"])} if arch == ENCDEC
             else {"prompts": torch.from_numpy(ins["tokens"]),
                   "vision_embeds": torch.from_numpy(ins["vision_embeds"])})
    P = S_SRC if arch == ENCDEC else S
    out = tserve.serve(tc, None, B, P, GEN, 0, "cpu", params=tp,
                       forced=torch.from_numpy(ins["forced"]),
                       keep_logits=True, **given)
    errs = _rows(out["logits"], rlogs)
    assert errs.max() <= SERVE_LOGIT_MAX, errs
    if arch == VISION:
        assert np.median(errs) <= LOGIT_TOL, errs
    truth = [np.asarray(x, np.float32) for x in f32["served"][arch]]
    port, ref = _rows(out["logits"], truth), _rows(rlogs, truth)
    assert np.median(port) <= TRUTH_SLACK * np.median(ref), (port, ref)
    assert port.max() <= TRUTH_SLACK * ref.max(), (port, ref)
    w = np.stack(rlogs)
    top2 = np.sort(w, -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) / np.abs(w).max() > 2 * errs
    np.testing.assert_array_equal(out["tokens"].numpy().T[sure],
                                  np.argmax(w, -1)[sure])
    assert out["migrations"] == 0 and tuple(out["tokens"].shape) == (
        B, GEN + 1)


def test_serve_draws_the_family_inputs():
    """serve draws frames (encoder-decoder) and vision embeddings from the
    seed on the CPU, the same as given explicitly; a prompt shorter than
    the vision tokens raises."""
    for arch in ARCHS:
        tc = tcfg.get_smoke(arch)
        tp = tlm.init_params(torch.Generator().manual_seed(0), tc)
        P = 8 if arch == ENCDEC else tc.n_vision_tokens + 4
        drawn = tserve.serve(tc, None, 2, P, 3, 5, "cpu", params=tp,
                             keep_logits=True)
        if arch == ENCDEC:
            given = {"frames": torch.randn(
                (2, P, tenc.FRAME_DIM),
                generator=torch.Generator().manual_seed(6))}
        else:
            given = {"prompts": torch.randint(
                0, tc.vocab_size, (2, P),
                generator=torch.Generator().manual_seed(6)),
                "vision_embeds": torch.randn(
                (2, tc.n_vision_tokens, tc.d_model),
                generator=torch.Generator().manual_seed(7))}
        again = tserve.serve(tc, None, 2, P, 3, 5, "cpu", params=tp,
                             keep_logits=True, **given)
        assert torch.equal(drawn["tokens"], again["tokens"])
        assert all(torch.equal(a, b) for a, b in zip(drawn["logits"],
                                                     again["logits"]))
    tc = tcfg.get_smoke(VISION)
    with pytest.raises(ValueError, match="vision tokens"):
        tserve.serve(tc, None, 2, tc.n_vision_tokens - 1, 1, 0, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_needs_a_gpu_unless_asked_for_the_cpu(arch):
    tc = tcfg.get_smoke(arch)
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(tc, None, 2, 16, 2, 0)
    with pytest.raises(ValueError, match="no MoE layers"):
        tserve.serve(tc, object(), 2, 16, 2, 0, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_takes_the_family_loss(arch):
    """`build_train_step` picks the family's loss through `model_fns`:
    its loss metric over 2 microbatches is the mean of the loss function
    on each half, and the weights move."""
    rc, tc, _, tp = _setup(arch)
    ins = _inputs(rc)
    keys = ("frames", "tokens") if arch == ENCDEC else ("tokens",
                                                        "vision_embeds")
    batch = {k: torch.from_numpy(ins[k]) for k in keys}
    loss_fn = tsteps.model_fns(tc)[0]
    want = torch.stack([loss_fn(tp, {k: v[i:i + 1] for k, v in
                                     batch.items()}, {}, tc)[0]
                        for i in range(B)]).float().mean()
    step = tsteps.build_train_step(tc, ShapeConfig("t", S, B, "train"),
                                   tsteps.TrainCtx(num_microbatches=2))
    tp2, _, _, met = step(tp, adamw.adamw_init(tp), {}, batch)
    assert torch.equal(met["loss"], want) and torch.isfinite(met["loss"])
    assert any(not torch.equal(a, b) for a, b in zip(tree.leaves(tp2),
                                                     tree.leaves(tp)))


# --- float32 (the subprocess's results) --------------------------------------


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """The float32 comparisons, computed once in a REPRO_FORCE_F32=1
    subprocess of this file, on this process's weights as float32
    values."""
    path = tmp_path_factory.mktemp("encdec") / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump({a: jax.tree.map(lambda x: x.astype(np.float32),
                                     _ref_params(a)) for a in ARCHS}, f)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, REPRO_FORCE_F32="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src, os.environ.get("PYTHONPATH", "")]),
               **{PARAMS_ENV: str(path)})
    out = subprocess.run([sys.executable, __file__], check=True,
                         capture_output=True, text=True, env=env,
                         timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_child_ran_in_float32(f32):
    assert f32["param_dtypes"] == ["float32"]


@pytest.mark.parametrize("arch,what", CASES)
def test_module_equals_reference_f32(f32, arch, what):
    errs = f32["modules"][f"{arch}/{what}"]
    tol = ENC_F32_TOL if what in ENC_MODULES else F32_TOL
    assert max(errs) <= tol, errs


def test_encoder_is_as_close_to_float64_as_the_reference(f32):
    """Why the encoder's path has ENC_F32_TOL: against the same encoder
    in float64 (`_encode_f64`), the reference's float32 output is off by
    F32_TOL's order (9.4e-6 here), so two float32 encoders may differ by
    twice that; the port's is no further off than the reference's (a
    fifth more at most)."""
    e = f32["encode_vs_f64"]
    assert e["reference"] > F32_TOL / 2, e
    assert e["port"] <= 1.2 * e["reference"], e


@pytest.mark.parametrize("block", ["encoder", "decoder"])
def test_block_grads_equal_reference_f32(f32, block):
    """One block's gradients (the sum of its output times a fixed random
    tensor): the encoder block's non-causal attention; the decoder
    block's self- and cross-attention, with the gradients of the
    encoder's k and v."""
    errs = f32["block_grads"][block]
    assert len(errs) == {"encoder": 9, "decoder": 15}[block], errs
    assert max(errs) <= GRAD_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference_f32(f32, arch):
    """seamless: `encdec_loss` with a loss mask, each gradient leaf
    within ULP_FACTOR of the reference's own move under a one-ULP
    change of the frames (GRAD_TOL at least); internvl2: `loss_fn` with
    vision embeddings, every leaf within GRAD_TOL."""
    r = f32["loss"][arch]
    assert r["loss_rel"] <= F32_TOL, r
    assert r["n_grads"] == r["n_ref_grads"] > 0
    for leaf, err in r["grad_rel"].items():
        tol = GRAD_TOL
        if arch == ENCDEC:
            tol = max(tol, ULP_FACTOR * f32["ulp_move"][leaf])
        assert err <= tol, (leaf, err, tol)
    if arch == VISION:  # the vision projection is on the gradient's path
        assert r["vision_grad_max"] > 0


def test_decode_does_not_reproduce_the_loss_logits_as_in_the_reference(f32):
    """Known red in the reference: teacher-forced `encdec_decode` rotates
    the cross query at S_src - 1, the loss's decoder at the target
    positions, so decode's logits miss the loss's by a wide gap. The
    port gives the same gap; without RoPE (rope_theta 0) both packages'
    decode reproduces the loss's logits."""
    g, flat = f32["decode_gap"], f32["decode_gap_no_rope"]
    assert g["reference"] > 100 * F32_TOL, g
    # each gap is a share of the logits' scale, each side's logits within
    # ENC_F32_TOL of the other package's
    assert abs(g["port"] - g["reference"]) <= 2 * ENC_F32_TOL, g
    assert max(flat.values()) <= F32_TOL, flat


def _paths(t):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(t)]


def _loss_batch(arch, ins):
    if arch == ENCDEC:
        mask = np.ones((B, S), np.float32)
        mask[0, -5:] = 0
        return {"frames": ins["frames"], "tokens": ins["tokens"],
                "loss_mask": mask}
    return {k: ins[k] for k in ("tokens", "vision_embeds")}


def _loss_parity(arch):
    """The family's loss and its gradients against the reference's (and,
    for seamless, the reference's own gradients with the frames one ULP
    up: {leaf: move})."""
    rc, tc, rp, tp = _setup(arch)
    ins = _inputs(rc)
    batch = _loss_batch(arch, ins)
    rfn, tfn = ((renc.encdec_loss, tenc.encdec_loss) if arch == ENCDEC
                else (rlm.loss_fn, tlm.loss_fn))
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: rfn(p, b, {}, rc, PX), has_aux=True))
    (rloss, _), rg = grad(rp, jax.tree.map(jnp.asarray, batch))
    preq = tree.tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    tloss, _ = tfn(preq, {k: torch.from_numpy(v) for k, v in batch.items()},
                   {}, tc)
    tg = torch.autograd.grad(tloss, tree.leaves(preq))
    rgl = jax.tree.leaves(rg)
    out = {"loss_rel": _errs(tloss, rloss)[0], "n_grads": len(tg),
           "n_ref_grads": len(rgl),
           "grad_rel": {p: _errs(g, w)[0] for p, g, w in
                        zip(_paths(rg), tg, rgl)}}
    if arch == VISION:
        out["vision_grad_max"] = float(np.abs(np.asarray(
            rg["vision_proj"])).max())
        return out, None
    up = dict(batch, frames=np.nextafter(batch["frames"], np.float32(np.inf)))
    _, rg_up = grad(rp, jax.tree.map(jnp.asarray, up))
    return out, {p: _errs(a, b)[0] for p, a, b in zip(
        _paths(rg), jax.tree.leaves(rg_up), rgl)}


def _encode_f64(p, frames, cfg):
    """The encoder in float64 numpy, written out from the reference's
    definition: frames through `src_proj`, each layer RMSNorm,
    non-causal attention with RoPE on q and k, RMSNorm, SwiGLU, then
    `enc_norm`."""
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), p)

    def rms(scale, x):
        return x / np.sqrt((x * x).mean(-1, keepdims=True)
                           + cfg.norm_eps) * scale

    def rope(x):
        D, Sx = x.shape[-1], x.shape[-2]
        ang = np.arange(Sx)[:, None] / cfg.rope_theta ** (
            np.arange(0, D, 2) / D)
        c, s_ = np.cos(ang), np.sin(ang)
        x1, x2 = x[..., :D // 2], x[..., D // 2:]
        return np.concatenate([x1 * c - x2 * s_, x2 * c + x1 * s_], -1)

    x = frames.astype(np.float64) @ p["src_proj"]
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], p["enc_layers"])
        xa = rms(lp["ln1"]["scale"], x)
        q, k, v = (np.einsum("bsd,dhk->bhsk", xa, lp["attn"][w])
                   for w in ("wq", "wk", "wv"))
        sc = rope(q) @ rope(k).swapaxes(-1, -2) / np.sqrt(q.shape[-1])
        pr = np.exp(sc - sc.max(-1, keepdims=True))
        o = (pr / pr.sum(-1, keepdims=True)) @ v
        x = x + np.einsum("bhsk,hkd->bsd", o, lp["attn"]["wo"])
        xm = rms(lp["ln2"]["scale"], x)
        g, u = xm @ lp["mlp"]["w_gate"], xm @ lp["mlp"]["w_up"]
        x = x + (g / (1 + np.exp(-g)) * u) @ lp["mlp"]["w_down"]
    return rms(p["enc_norm"]["scale"], x)


def _encode_vs_f64():
    """{package: max |encode - float64| / max |float64|}."""
    rc, tc, rp, tp = _setup(ENCDEC)
    frames = _inputs(rc)["frames"]
    exact = _encode_f64(_ref_params(ENCDEC), frames, rc)
    got = {"reference": np.asarray(_ref_encode(rc)(rp, jnp.asarray(frames))),
           "port": tenc.encode(tp, _t(frames), tc).numpy()}
    return {k: float(np.abs(v - exact).max() / np.abs(exact).max())
            for k, v in got.items()}


def _block_grads():
    """Layer 0's encoder and decoder blocks: their parameter gradients
    (and the decoder's of its x and the encoder's k, v) against the
    reference's, as {block: [each leaf's error]}."""
    rc, tc, rp, tp = _setup(ENCDEC)
    r = np.random.default_rng(6)
    d, H, Dh = rc.d_model, rc.n_kv_heads, rc.resolved_head_dim
    x = r.normal(size=(B, S, d)).astype(np.float32)
    kv = [r.normal(size=(B, H, S_SRC, Dh)).astype(np.float32)
          for _ in range(2)]
    w = r.normal(size=(B, S, d)).astype(np.float32)
    out = {}
    for block, stack in (("encoder", "enc_layers"), ("decoder",
                                                     "dec_layers")):
        rl = jax.tree.map(lambda a: a[0], rp[stack])
        tl = tree.tree_map(lambda t: t.detach().clone().requires_grad_(),
                           tlm.layer(tp[stack], 0))
        if block == "encoder":
            def ref(p):
                xa = rlayers.rmsnorm(p["ln1"], jnp.asarray(x), rc.norm_eps)
                h = jnp.asarray(x) + rattn.gqa_fwd(
                    p["attn"], xa, cfg=rc, px=PX, causal=False,
                    batch_entry=None)
                hm = rlayers.rmsnorm(p["ln2"], h, rc.norm_eps)
                return ((h + rlayers.mlp_fwd(p["mlp"], hm, PX, None))
                        * w).sum()
            want = jax.tree.leaves(jax.jit(jax.grad(ref))(rl))
            y = tenc.enc_block(tl, torch.from_numpy(x), tc)
            ins = tree.leaves(tl)
        else:
            # the decoder block reads its cross k / v from the encoder:
            # its own cross wk / wv are not on this path
            def ref(p, xx, k, v):
                y, _ = renc._dec_block_full(p, xx, (k, v), rc, PX, None,
                                            False)
                return (y * w).sum()
            g = jax.jit(jax.grad(ref, argnums=(0, 1, 2, 3)))(
                rl, jnp.asarray(x), *map(jnp.asarray, kv))
            ca = g[0]["cross_attn"]
            g[0]["cross_attn"] = {k: v for k, v in ca.items()
                                  if k not in ("wk", "wv")}
            want = jax.tree.leaves(g[0]) + list(g[1:])
            xs = [torch.from_numpy(a).requires_grad_() for a in [x] + kv]
            y, _ = tenc._dec_block_full(tl, xs[0], tuple(xs[1:]), tc)
            tl["cross_attn"] = {k: v for k, v in tl["cross_attn"].items()
                                if k not in ("wk", "wv")}
            ins = tree.leaves(tl) + xs
        got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ins)
        out[block] = _errs(list(got), want)
    return out


def _f32_child():
    """Body of the float32 subprocess: prints one JSON line."""
    _, _, _, probe = _setup(ENCDEC)
    res = {"param_dtypes": sorted({str(t.dtype).split(".")[-1]
                                   for t in tree.leaves(probe)}),
           "modules": {}, "loss": {}, "served": {}}
    for arch, what in CASES:
        res["modules"][f"{arch}/{what}"] = _errs(*module_case(arch, what))
    for arch in ARCHS:
        res["loss"][arch], move = _loss_parity(arch)
        if move is not None:
            res["ulp_move"] = move
        rc, _, rp, _ = _setup(arch)
        res["served"][arch] = [lg.tolist() for lg in _reference_serve(
            rc, rp, _inputs(rc))]
    res["block_grads"] = _block_grads()
    res["encode_vs_f64"] = _encode_vs_f64()
    res["decode_gap"] = decode_gaps()
    res["decode_gap_no_rope"] = decode_gaps({"rope_theta": 0.0})
    print(json.dumps(res))


if __name__ == "__main__":
    _f32_child()
