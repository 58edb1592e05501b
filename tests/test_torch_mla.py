"""DeepSeek-V3 in the port, held against the reference on the CPU: its
config, the plain attention at Dk != Dv, MLA's prefill and absorbed
decode, the `first_k_dense` and MTP parameters, prefill / decode, and
the whole serve loop with GAIA on (the MoE stack only).

Weights cross from JAX through `models.convert`; inputs come from numpy
seeds; tolerances are tests/test_torch_serve.py's (BF16_TOL on a
module's output; logits per row as a share of the reference's largest
|logit|, the median row within LOGIT_TOL and every row within
LOGIT_MAX; F32_TOL in float32, in a REPRO_FORCE_F32=1 subprocess of
this file). The plain attention against `flash_heads`: 1e-5 in float32,
2e-2 in bfloat16 (tests/test_torch_attention.py's).

The reference caches the prefill's rope keys before RoPE
(`repro.models.attention.mla_fwd(..., return_latent=True)` returns the
raw projection) while its decode writes and reads them after RoPE, so
its decode after a prefill scores the prompt's keys unrotated. The port
caches them rotated. Every comparison of a decode step therefore starts
both packages from a cache whose rope columns hold rotated keys
(`_rotated`), and `test_decode_after_prefill_*` shows both sides.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rcfg  # noqa: E402
from repro.core import gaia_moe as rgm  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.parallel.ctx import make_ctx  # noqa: E402

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.core import gaia_moe as tgm  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

from test_torch_serve import (BF16_TOL, F32_TOL, LOGIT_MAX,  # noqa: E402
                              LOGIT_TOL, _check_slice, _close)

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
PX = make_ctx(None)
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: tests/test_arch_smoke.py::test_decode_matches_prefill_logits's bound
DECODE_VS_PREFILL = 3e-2
B, P, GEN = 8, 8, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16(a):
    """a in the reference's COMPUTE_DT (bfloat16; float32 under
    REPRO_FORCE_F32=1)."""
    return jnp.asarray(a).astype(rlayers.COMPUTE_DT)


def _cfgs(**moe):
    rc, tc = rcfg.get_smoke(ARCH), tcfg.get_smoke(ARCH)
    if moe:
        rc = dataclasses.replace(rc, moe=dataclasses.replace(rc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return rc, tc


@pytest.fixture(scope="module")
def smoke():
    rc, tc = _cfgs()
    rp = rlm.init_params(jax.random.key(0), rc)
    return rc, tc, rp, convert.params_from_numpy(_np(rp))


def _rotated(rc, cache, n):
    """The reference's prefill cache with the rope columns of its first
    n rows rotated at their positions, as its decode writes them."""
    r = rc.mla.kv_lora_rank
    out = {}
    for name, c in cache.items():
        pos = jnp.arange(c.shape[2])
        rot = rlayers.apply_rope(c[..., r:], pos, rc.rope_theta)
        rot = jnp.where((pos < n)[None, None, :, None], rot, c[..., r:])
        out[name] = jnp.concatenate([c[..., :r], rot], -1)
    return out


def _row_errs(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    g = np.asarray(got, np.float32).reshape(-1, want.shape[-1])
    return np.abs(g - want.reshape(g.shape)).max(-1) / np.abs(want).max()


def _logit_rule(got, want, typ=LOGIT_TOL, most=LOGIT_MAX):
    errs = _row_errs(got, want)
    assert np.median(errs) <= typ, errs
    assert errs.max() <= most, errs


# --- config ------------------------------------------------------------------


@pytest.mark.parametrize("get", ["get_arch", "get_smoke"])
def test_config_equals_the_reference(get):
    r, t = getattr(rcfg, get)(ARCH), getattr(tcfg, get)(ARCH)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    for prop in ("resolved_head_dim", "padded_vocab"):
        assert getattr(r, prop) == getattr(t, prop)
    assert r.param_count() == t.param_count()
    assert r.active_param_count() == t.active_param_count()
    assert r.shapes() == t.shapes()


def test_full_config_as_the_repo_defines_it():
    c = tcfg.get_arch(ARCH)
    m = c.mla
    assert (c.d_model, c.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim,
            m.v_head_dim, m.kv_lora_rank) == (7168, 128, 192, 128, 512)
    assert (c.moe.num_experts, c.moe.top_k, c.moe.first_k_dense,
            c.moe.num_shared_experts, c.mtp_depth) == (256, 8, 3, 1, 1)
    # the copy's approximate count: every layer counted as an MoE layer,
    # MTP left out (the allocated 4-layer cut is printed by chip_smoke.py)
    cut = dataclasses.replace(c, n_layers=4)
    want = dataclasses.replace(rcfg.get_arch(ARCH), n_layers=4)
    assert cut.param_count() == want.param_count() == 47_882_436_608


def test_get_shape_as_the_reference():
    for name in rcfg.SHAPES:
        assert dataclasses.asdict(tcfg.get_shape(name)) == \
            dataclasses.asdict(rcfg.get_shape(name))
    for cfgs in (rcfg, tcfg):
        with pytest.raises(KeyError, match="unknown shape"):
            cfgs.get_shape("no-such-shape")


# --- the plain attention at Dk != Dv -----------------------------------------


PAIRS = [(24, 16), (192, 128)]


def _attn_inputs(dk, dv):
    r = np.random.default_rng(dk)
    q, k = (r.normal(size=(1, 2, 64, dk)).astype(np.float32)
            for _ in range(2))
    return q, k, r.normal(size=(1, 2, 64, dv)).astype(np.float32)


def _plain_vs_flash_heads(dk, dv, dtype):
    """max |plain - flash_heads| at the pair, causal, B 1, H 2, S 64, and
    the plain output's shape. `flash_heads` rounds P to COMPUTE_DT, so
    float32 is compared in the REPRO_FORCE_F32 subprocess."""
    q, k, v = _attn_inputs(dk, dv)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = rattn.flash_heads(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                             causal=True, px=PX, batch_entry=None,
                             head_entry=None)
    got = fa_ref.flash_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), True)
    want = np.asarray(want, np.float32)
    over = np.abs(got.float().numpy() - want) - ATTN_TOL[dtype] * (
        1 + np.abs(want))
    return float(over.max()), list(got.shape)


@pytest.mark.parametrize("dk,dv", PAIRS)
def test_plain_attention_at_dk_ne_dv_equals_flash_heads(dk, dv):
    """The smoke's pair and the full width's in bfloat16 (scaled by
    Dk^-0.5 as `_online_block`), and the float32 row log-sum-exp."""
    over, shape = _plain_vs_flash_heads(dk, dv, "bfloat16")
    assert shape == [1, 2, 64, dv]
    assert over <= 0, over
    q, k, _ = _attn_inputs(dk, dv)
    lse = fa_ref.flash_attention_lse_plain(*(torch.from_numpy(a)
                                             for a in (q, k)), True)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * dk ** -0.5
    s = np.where(np.tril(np.ones((64, 64), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    np.testing.assert_allclose(lse.numpy(),
                               (np.log(np.exp(s - m).sum(-1)) + m[..., 0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dk,dv", PAIRS)
def test_plain_attention_at_dk_ne_dv_equals_flash_heads_f32(f32, dk, dv):
    over, shape = f32["flash_heads"][f"{dk},{dv}"]
    assert shape == [1, 2, 64, dv]
    assert over <= 0, over


# --- MLA ---------------------------------------------------------------------


def test_params_carry_across_bit_for_bit(smoke):
    rc, tc, rp, tp = smoke
    assert {"dense_layers", "layers", "mtp"} <= set(tp)
    for path, a in jax.tree_util.tree_leaves_with_path(_np(rp)):
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[a.dtype.name]
        assert np.array_equal(t.float().numpy(), a.astype(np.float32))
    ti = tlm.init_params(torch.Generator().manual_seed(0), tc)
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), _np(rp))
    assert shapes == tlm.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), ti)
    assert tlm.init_extras(tc, "cpu")["placement"].shape == (
        rc.n_layers - rc.moe.first_k_dense, rc.moe.num_experts)


def _mla_case(rc, tp, rp, stack, seed):
    rl = jax.tree.map(lambda a: a[0], rp[stack])["attn"]
    tl = tlm.layer(tp[stack], 0)["attn"]
    x = np.asarray(_bf16(np.random.default_rng(seed).normal(
        size=(2, 12, rc.d_model))))
    return rl, tl, x


@pytest.mark.parametrize("stack", ["dense_layers", "layers"])
def test_mla_fwd_equals_reference(smoke, stack):
    rc, tc, rp, tp = smoke
    rl, tl, x = _mla_case(rc, tp, rp, stack, 3)
    want, wline = rattn.mla_fwd(rl, jnp.asarray(x), cfg=rc, px=PX,
                                batch_entry=None, return_latent=True)
    got, gline = tattn.mla_fwd(tl, convert.tensor_from_numpy(x), cfg=tc,
                               return_latent=True)
    _logit_rule(got, want)
    _close(got, want, BF16_TOL, "y")
    # the cache line: latent as the reference's, rope keys the
    # reference's rotated at their positions
    r = rc.mla.kv_lora_rank
    _close(gline[..., :r], wline[..., :r], BF16_TOL, "latent")
    wrot = rlayers.apply_rope(wline[..., r:], jnp.arange(12), rc.rope_theta)
    _close(gline[..., r:], wrot, BF16_TOL, "rope")


@pytest.mark.parametrize("pos", [12, 15, 17])
def test_mla_decode_equals_reference(smoke, pos):
    """One absorbed decode step against a cache of rotated lines (pos 17
    is past its end: the line lands at Smax - 1, as the reference's
    clamped `dynamic_update_slice`)."""
    rc, tc, rp, tp = smoke
    rl, tl, x = _mla_case(rc, tp, rp, "layers", 4)
    _, wline = rattn.mla_fwd(rl, jnp.asarray(x), cfg=rc, px=PX,
                             batch_entry=None, return_latent=True)
    Smax = 16
    cache = _rotated(rc, {"c": jnp.pad(wline, ((0, 0), (0, Smax - 12),
                                                (0, 0)))[None]}, 12)["c"][0]
    xd = np.asarray(_bf16(np.random.default_rng(5).normal(
        size=(2, 1, rc.d_model))))
    want, wc = rattn.mla_decode(rl, jnp.asarray(xd), cache, jnp.int32(pos),
                                cfg=rc, px=PX, batch_entry=None,
                                seq_entry=None)
    tcache = convert.tensor_from_numpy(np.asarray(cache))
    got, gc = tattn.mla_decode(tl, convert.tensor_from_numpy(xd), tcache,
                               pos, cfg=tc)
    assert gc is tcache  # written in place
    _logit_rule(got, want)
    _close(got, want, BF16_TOL, "y")
    _close(gc, wc, BF16_TOL, "cache")
    row = min(pos, Smax - 1)
    others = [i for i in range(Smax) if i != row]
    assert np.array_equal(
        gc[:, others].view(torch.int16).numpy().view(np.uint16),
        np.asarray(wc)[:, others].view(np.uint16))


def test_prefill_and_decode_step_equal_reference(smoke):
    rc, tc, rp, tp = smoke
    Bq, S, Smax = 3, 10, 14
    tokens = np.random.default_rng(7).integers(0, 256, (Bq, S), np.int32)
    wcache, wlog = rlm.prefill(rp, {"tokens": jnp.asarray(tokens)}, rc, PX,
                               cache_len=Smax)
    gcache, glog = tlm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, tc,
                               Smax)
    # a few rows of logits: held as tests/test_torch_serve.py holds them
    _close(glog, wlog, LOGIT_MAX, "prefill logits")
    r = rc.mla.kv_lora_rank
    wrot = _rotated(rc, wcache, S)
    assert sorted(gcache) == sorted(wcache) == ["dense", "main"]
    for name in wcache:
        assert tuple(gcache[name].shape) == wcache[name].shape
        _close(gcache[name][..., :r], wcache[name][..., :r], BF16_TOL, name)
        _close(gcache[name][..., r:], wrot[name][..., r:], BF16_TOL, name)
        assert not gcache[name][:, :, S:].any()  # the padding
    # decode from the reference's rotated cache, with a migrated placement
    extras = dict(rlm.init_extras(rc), placement=jnp.tile(
        jnp.asarray([2, 3, 0, 1, 6, 7, 4, 5], jnp.int32), (2, 1)))
    nxt = np.asarray([5, 77, 200], np.int32)
    wcache2, wlog2 = rlm.decode_step(rp, wrot, jnp.asarray(nxt),
                                     jnp.int32(S), extras, rc, PX)
    tex = convert.params_from_numpy(_np(extras))
    gcache2, glog2 = tlm.decode_step(
        tp, convert.params_from_numpy(_np(wrot)), torch.from_numpy(nxt), S,
        tex, tc)
    _close(glog2, wlog2, LOGIT_MAX, "decode logits")
    for name in wcache2:
        _close(gcache2[name], wcache2[name], BF16_TOL, name)
    _, toks = tsteps.build_serve_step(tc)(
        tp, tex, convert.params_from_numpy(_np(wrot)),
        torch.from_numpy(nxt), S)
    assert torch.equal(toks, tsteps.argmax_first(glog2))


def test_decode_after_prefill_reference_fault_and_port():
    """tests/test_arch_smoke.py's decode-vs-prefill case on the deepseek
    smoke (capacity factor 100: the MoE drops no token): prefill 16
    tokens, decode token 16, against the last logits of a 17-token
    prefill. The reference reads its prompt's rope keys unrotated and
    misses by far more than the case's 3e-2; the port, whose prefill
    caches them rotated, is within it, as is the reference once its
    cache is rotated."""
    rc, tc = _cfgs(capacity_factor=100.0)
    rp = rlm.init_params(jax.random.key(0), rc)
    tp = convert.params_from_numpy(_np(rp))
    toks = np.array(jax.random.randint(jax.random.key(1), (2, 16), 0, 200),
                    np.int32)
    nxt = toks[:, -1]
    full = np.concatenate([toks, nxt[:, None]], 1)
    wcache, _ = rlm.prefill(rp, {"tokens": jnp.asarray(toks)}, rc, PX,
                            cache_len=32)
    _, wfull = rlm.prefill(rp, {"tokens": jnp.asarray(full)}, rc, PX,
                           cache_len=32)
    wfull = np.asarray(wfull[:, 0], np.float32)
    ex = rlm.init_extras(rc)
    _, wdec = rlm.decode_step(rp, wcache, jnp.asarray(nxt), jnp.int32(16),
                              ex, rc, PX)
    _, wfixed = rlm.decode_step(rp, _rotated(rc, wcache, 16),
                                jnp.asarray(nxt), jnp.int32(16), ex, rc, PX)
    ref_gap = float(np.abs(np.asarray(wdec, np.float32) - wfull).max())
    assert ref_gap > 10 * DECODE_VS_PREFILL, ref_gap
    np.testing.assert_allclose(np.asarray(wfixed, np.float32), wfull,
                               atol=DECODE_VS_PREFILL,
                               rtol=DECODE_VS_PREFILL)
    gcache, _ = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, 32)
    _, got = tlm.decode_step(tp, gcache, torch.from_numpy(nxt), 16,
                             tlm.init_extras(tc, "cpu"), tc)
    _, want = tlm.prefill(tp, {"tokens": torch.from_numpy(full)}, tc, 32)
    np.testing.assert_allclose(got.float().numpy(),
                               want[:, 0].float().numpy(),
                               atol=DECODE_VS_PREFILL,
                               rtol=DECODE_VS_PREFILL)
    _close(want[:, 0], wfull, LOGIT_MAX, "17-token prefill")


# --- the whole slice ---------------------------------------------------------


def _reference_serve(rc, rp, prompts, gcfg):
    """tests/test_torch_serve.py's reference loop for an MLA model: the
    prefill cache's rope columns rotated before the first decode step,
    and migrations over the MoE stack only (n_layers - first_k_dense)."""
    E = rc.moe.num_experts
    L = rc.n_layers - rc.moe.first_k_dense
    cache, logits = rlm.prefill(rp, {"tokens": jnp.asarray(prompts)}, rc, PX,
                                cache_len=P + GEN)
    cache = _rotated(rc, cache, P)
    decode = jax.jit(lambda p, e, c, t, pos: rlm.decode_step(
        p, c, t, pos, e, rc, PX))
    extras, params = rlm.init_extras(rc), rp
    toks = [jnp.argmax(logits[:, -1], -1).astype(jnp.int32)]
    logs = [np.asarray(logits[:, -1], np.float32)]
    st = rgm.init_state(gcfg)
    perm = jnp.arange(E, dtype=jnp.int32)
    steps = []
    for step in range(GEN):
        cache, lg = decode(params, extras, cache, toks[-1],
                           jnp.int32(P + step))
        toks.append(jnp.argmax(lg, -1).astype(jnp.int32))
        logs.append(np.asarray(lg, np.float32))
        grp = jnp.arange(B) % gcfg.num_groups
        traffic = jnp.zeros((gcfg.num_groups, E)).at[
            grp, toks[-1] % E].add(10.0)
        st, n = rgm.maybe_update(gcfg, st, traffic)
        if int(n):
            new_perm, order = rgm.placement_permutation(st["placement"], E)
            idx = jnp.tile(rgm.migration_index(perm, order), (L, 1))
            moe = dict(params["layers"]["moe"])
            for k in ("w_gate", "w_up", "w_down"):
                moe[k] = rgm.apply_migration_stacked(moe[k], idx)
            params = dict(params, layers=dict(params["layers"], moe=moe))
            extras = dict(extras, placement=jnp.tile(new_perm[None], (L, 1)))
            perm = new_perm
            steps.append(step)
    return (np.stack([np.asarray(t) for t in toks], 1), logs, steps,
            np.asarray(st["placement"]))


def _slice_errors(rc, tc, rp, seed=0):
    """Both serve loops on the same weights and prompts, the port
    teacher-forced on the reference's tokens; and the port's own run
    with GAIA on and off."""
    prompts = np.random.default_rng(seed).integers(
        0, rc.vocab_size, (B, P)).astype(np.int32)
    gkw = dict(num_experts=rc.moe.num_experts, num_groups=4, mf=1.2, mt=8,
               window=4, interval=8)
    rtoks, rlogs, rsteps, rplace = _reference_serve(
        rc, rp, prompts, rgm.GaiaMoEConfig(**gkw))
    out = tserve.serve(tc, tgm.GaiaMoEConfig(**gkw), B, P, GEN, seed, "cpu",
                       params=convert.params_from_numpy(_np(rp)),
                       prompts=torch.from_numpy(prompts),
                       forced=torch.from_numpy(rtoks), keep_logits=True)
    scale = max(float(np.abs(lg).max()) for lg in rlogs)
    errs = [np.abs(g.float().numpy() - w).max(-1) / scale
            for g, w in zip(out["logits"], rlogs)]
    margins = []
    for lg in rlogs:
        top2 = np.sort(lg, -1)[:, -2:]
        margins.append((top2[:, 1] - top2[:, 0]) / scale)
    free = {g: tserve.serve(
        tc, None if g == "off" else tgm.GaiaMoEConfig(**gkw), B, P, GEN,
        seed, "cpu", params=convert.params_from_numpy(_np(rp)),
        prompts=torch.from_numpy(prompts)) for g in ("on", "off")}
    return {
        "row_errs": np.stack(errs, 1).tolist(), "scale": scale,
        "ref_tokens": rtoks.tolist(), "tokens": out["tokens"].tolist(),
        "margins": np.stack(margins, 1).tolist(),
        "ref_steps": rsteps, "steps": out["migration_steps"],
        "ref_placement": rplace.tolist(),
        "placement": out["placement"].tolist(),
        "migrations": out["migrations"],
        "free_migrations": free["on"]["migrations"],
        "on_off_equal": bool(torch.equal(free["on"]["tokens"],
                                         free["off"]["tokens"])),
    }


def _check_mla_slice(res, typ, most):
    _check_slice(res, typ, most)
    assert res["migrations"] > 0 and res["free_migrations"] > 0
    assert res["on_off_equal"]


def test_serve_slice_equals_reference_bf16(smoke):
    rc, tc, rp, _ = smoke
    _check_mla_slice(_slice_errors(rc, tc, rp), LOGIT_TOL, LOGIT_MAX)


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
                         timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("what", ["mla_fwd", "mla_line", "mla_decode"])
def test_mla_equals_reference_f32(f32, what):
    assert f32["param_dtypes"] == ["float32"]
    assert f32[what] <= F32_TOL, f32


def test_serve_slice_equals_reference_f32(f32):
    _check_mla_slice(f32["slice"], F32_TOL, F32_TOL)


def _f32_child():
    """Body of the float32 subprocess: prints one JSON line."""
    rc, tc = _cfgs()
    rp = rlm.init_params(jax.random.key(0), rc)
    tp = convert.params_from_numpy(_np(rp))
    res = {"param_dtypes": sorted({str(t.dtype).split(".")[-1] for t in
                                   jax.tree.leaves(tp)})}

    def rel(got, want):
        want = np.asarray(want, np.float32)
        return float(np.abs(got.float().numpy() - want).max()
                     / np.abs(want).max())

    rl, tl, x = _mla_case(rc, tp, rp, "layers", 3)
    want, wline = rattn.mla_fwd(rl, jnp.asarray(x), cfg=rc, px=PX,
                                batch_entry=None, return_latent=True)
    got, gline = tattn.mla_fwd(tl, convert.tensor_from_numpy(x), cfg=tc,
                               return_latent=True)
    r = rc.mla.kv_lora_rank
    wrot = rlayers.apply_rope(wline[..., r:], jnp.arange(12), rc.rope_theta)
    res["mla_fwd"] = rel(got, want)
    res["mla_line"] = max(rel(gline[..., :r], wline[..., :r]),
                          rel(gline[..., r:], wrot))
    cache = _rotated(rc, {"c": jnp.pad(wline, ((0, 0), (0, 4),
                                                (0, 0)))[None]}, 12)["c"][0]
    xd = np.random.default_rng(5).normal(size=(2, 1, rc.d_model)).astype(
        np.float32)
    want, _ = rattn.mla_decode(rl, jnp.asarray(xd), cache, jnp.int32(12),
                               cfg=rc, px=PX, batch_entry=None,
                               seq_entry=None)
    got, _ = tattn.mla_decode(tl, torch.from_numpy(xd),
                              torch.from_numpy(np.array(cache)), 12, cfg=tc)
    res["mla_decode"] = rel(got, want)
    res["flash_heads"] = {f"{dk},{dv}": _plain_vs_flash_heads(dk, dv,
                                                              "float32")
                          for dk, dv in PAIRS}
    res["slice"] = _slice_errors(rc, tc, rp, seed=1)
    print(json.dumps(res))


if __name__ == "__main__":
    _f32_child()
