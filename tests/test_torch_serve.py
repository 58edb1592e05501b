"""The serving slice of the LM/MoE stack: configs, modules, GAIA-MoE and
the whole serve loop of the port held against the reference on the CPU.

Weights and state cross from JAX to the port through
`repro_torch.models.convert`; inputs come from numpy seeds. The
kernels' plain versions run here (CPU tensors).

Tolerances, with their reasons:
- integer outputs (expert ids and counts, drops, placements, migration
  steps, the GAIA state) are exact;
- bfloat16 activations: BF16_TOL (absolute and relative) on a module's
  output. The reference rounds each MoE contribution and each partial
  sum to bfloat16 and rounds P before P.V inside every 32-key block; the
  port sums a token's contributions in float32 and rounds once, and its
  plain attention rounds P over the whole row: a few bfloat16 ULPs;
- the whole bfloat16 slice, per (step, row) of logits, as a share of
  the reference's largest |logit|: the median row within LOGIT_TOL (the
  differences above, carried through the layers and the steps: about
  one bfloat16 ULP), every row within LOGIT_MAX. A token whose top-k
  boundary lies within that noise routes to another expert in some
  layer, which moves its logits by up to ~10% (measured: median 0.5%,
  90th percentile 1.9%, max 8.9%); float32 shows no such flip. Greedy
  tokens are equal wherever the reference's top-1 margin exceeds twice
  the row's error;
- float32 (REPRO_FORCE_F32=1 for both packages, in a subprocess):
  F32_TOL on every row, summation order only.
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
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.parallel.ctx import make_ctx  # noqa: E402

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.core import gaia_moe as tgm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

BF16_TOL = 2e-2
LOGIT_TOL = 1e-2
LOGIT_MAX = 0.15
F32_TOL = 1e-4
PX = make_ctx(None)
CPU = torch.device("cpu")
ARCH = "qwen3-moe-30b-a3b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max|want|, elementwise: bfloat16 rounds
    relative to each value, and a sum of large terms leaves small values
    with the large terms' absolute error."""
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def smoke():
    """The smoke config in both packages and the reference's weights in
    both."""
    rc, tc = rcfg.get_smoke(ARCH), tcfg.get_smoke(ARCH)
    rp = rlm.init_params(jax.random.key(0), rc)
    return rc, tc, rp, convert.params_from_numpy(_np(rp))


# --- configs ---------------------------------------------------------------


@pytest.mark.parametrize("get", ["get_arch", "get_smoke"])
def test_configs_equal_the_reference(get):
    r, t = getattr(rcfg, get)(ARCH), getattr(tcfg, get)(ARCH)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    for prop in ("resolved_head_dim", "padded_vocab"):
        assert getattr(r, prop) == getattr(t, prop)
    assert r.param_count() == t.param_count()
    assert r.active_param_count() == t.active_param_count()
    assert r.shapes() == t.shapes()
    assert {k: dataclasses.asdict(v) for k, v in rcfg.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}


def test_full_config_as_the_repo_defines_it():
    c = tcfg.get_arch(ARCH)
    assert (c.resolved_head_dim, c.padded_vocab) == (64, 152064)
    assert c.param_count() == 30_079_451_136  # 60.2 GB in bf16


def test_other_archs_raise_naming_the_roadmap():
    """Every other architecture is ported since (the encoder-decoder and
    vision families last): an unknown name raises the reference's
    KeyError, and an encoder-decoder config inits the `encdec` tree."""
    assert set(rcfg.ARCHS) <= set(tcfg.ARCHS)
    for get in (tcfg.get_arch, tcfg.get_smoke):
        with pytest.raises(KeyError):
            get("no-such-arch")
    with pytest.raises(KeyError):
        rcfg.get_arch("no-such-arch")
    encdec = dataclasses.replace(tcfg.get_smoke(ARCH), encoder_decoder=True,
                                 moe=None)
    p = tlm.init_params(torch.Generator().manual_seed(0), encdec)
    assert sorted(p) == ["dec_layers", "embed", "enc_layers", "enc_norm",
                         "final_norm", "src_proj"]
    assert p["dec_layers"]["cross_attn"]["wk"].shape[0] == encdec.n_layers


# --- modules ---------------------------------------------------------------


def test_params_carry_across_bit_for_bit(smoke):
    _, tc, rp, tp = smoke
    flat = jax.tree_util.tree_leaves_with_path(_np(rp))
    for path, a in flat:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[a.dtype.name]
        assert np.array_equal(t.float().numpy(), a.astype(np.float32))
    # the port's own init has the reference's tree, shapes and dtypes
    ti = tlm.init_params(torch.Generator().manual_seed(0), tc)
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), _np(rp))
    assert shapes == tlm.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), ti)


@pytest.mark.parametrize("capacity_factor,perm", [
    (1.25, None),                      # the config's capacity
    (0.25, None),                      # overflowing capacity: drops
    (0.5, [3, 0, 1, 2, 7, 4, 6, 5])])  # drops and a non-identity placement
def test_moe_fwd_equals_reference(smoke, capacity_factor, perm):
    rc, _, rp, tp = smoke
    m = dataclasses.replace(rc.moe, capacity_factor=capacity_factor)
    r = np.random.default_rng(5)
    x = r.normal(size=(3, 16, rc.d_model)).astype(np.float32)
    bias = (r.normal(size=8) * 0.01).astype(np.float32)
    pl = None if perm is None else np.asarray(perm, np.int32)
    rlayer = jax.tree.map(lambda a: a[0], rp["layers"]["moe"])
    want, wm = rmoe.moe_fwd(rlayer, _bf16(x), m=m, px=PX, batch_entry=None,
                            router_bias=jnp.asarray(bias),
                            placement=None if pl is None else jnp.asarray(pl))
    tlayer = tlm.layer(tp["layers"]["moe"], 0)
    got, gm = tmoe.moe_fwd(
        tlayer, convert.tensor_from_numpy(np.asarray(_bf16(x))), m=m,
        router_bias=torch.from_numpy(bias),
        placement=None if pl is None else torch.from_numpy(pl))
    _close(got, want, BF16_TOL)
    for key in ("expert_counts", "group_expert_counts", "moe_dropped"):
        np.testing.assert_array_equal(gm[key].numpy(), np.asarray(wm[key]),
                                      err_msg=key)
    if capacity_factor < 1:
        assert int(gm["moe_dropped"]) > 0


def test_moe_fwd_with_a_shared_expert_equals_reference():
    m = dataclasses.replace(rcfg.get_smoke(ARCH).moe, num_shared_experts=1,
                            d_shared=32)
    rp = rmoe.init_moe(jax.random.key(4), 64, m)
    x = np.asarray(_bf16(np.random.default_rng(9).normal(size=(2, 8, 64))))
    want, wm = rmoe.moe_fwd(rp, jnp.asarray(x), m=m, px=PX,
                            batch_entry=None)
    got, gm = tmoe.moe_fwd(convert.params_from_numpy(_np(rp)),
                           convert.tensor_from_numpy(x), m=m)
    _close(got, want, BF16_TOL)
    np.testing.assert_array_equal(gm["expert_counts"].numpy(),
                                  np.asarray(wm["expert_counts"]))


def test_tf_block_equals_reference(smoke):
    rc, tc, rp, tp = smoke
    r = np.random.default_rng(6)
    x = np.asarray(_bf16(r.normal(size=(2, 12, rc.d_model))))
    rl = jax.tree.map(lambda a: a[1], rp["layers"])
    tl = tlm.layer(tp["layers"], 1)
    pl = np.asarray([1, 0, 3, 2, 5, 4, 7, 6], np.int32)
    want, (wk, wv), wm = rblocks.tf_block_fwd(
        rl, jnp.asarray(x), cfg=rc, px=PX, batch_entry=None,
        placement=jnp.asarray(pl), return_kv=True)
    got, (gk, gv), gm = tblocks.tf_block_fwd(
        tl, convert.tensor_from_numpy(x), cfg=tc,
        placement=torch.from_numpy(pl), return_kv=True)
    _close(got, want, BF16_TOL)
    _close(gk, wk, BF16_TOL)
    _close(gv, wv, BF16_TOL)
    np.testing.assert_array_equal(gm["expert_counts"].numpy(),
                                  np.asarray(wm["expert_counts"]))
    # one decode step against a cache holding the prefill's rows
    Smax, pos = 16, 12
    pad = ((0, 0), (0, Smax - 12), (0, 0), (0, 0))
    ck, cv = (np.pad(np.asarray(a), pad) for a in (wk, wv))
    xd = np.asarray(_bf16(r.normal(size=(2, 1, rc.d_model))))
    want, wc = rblocks.tf_block_decode(
        rl, jnp.asarray(xd), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.int32(pos), cfg=rc, px=PX, batch_entry=None, seq_entry=None,
        placement=jnp.asarray(pl))
    tcache = convert.params_from_numpy({"k": ck, "v": cv})
    got, gc = tblocks.tf_block_decode(
        tl, convert.tensor_from_numpy(xd), tcache, pos, cfg=tc,
        placement=torch.from_numpy(pl))
    _close(got, want, BF16_TOL)
    _close(gc["k"], wc["k"], BF16_TOL)
    _close(gc["v"], wc["v"], BF16_TOL)


def test_prefill_and_decode_step_equal_reference(smoke):
    rc, tc, rp, tp = smoke
    B, S, Smax = 3, 10, 14
    tokens = np.random.default_rng(7).integers(0, 256, (B, S), np.int32)
    wcache, wlog = rlm.prefill(rp, {"tokens": jnp.asarray(tokens)}, rc, PX,
                               cache_len=Smax)
    gcache, glog = tlm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, tc,
                               Smax)
    _close(glog, wlog, LOGIT_MAX)
    for kv in ("k", "v"):
        assert tuple(gcache["main"][kv].shape) == wcache["main"][kv].shape
        _close(gcache["main"][kv], wcache["main"][kv], BF16_TOL, kv)
    # decode from the reference's own cache, with a migrated placement
    extras = rlm.init_extras(rc)
    pl = jnp.tile(jnp.asarray([2, 3, 0, 1, 6, 7, 4, 5], jnp.int32), (2, 1))
    extras = dict(extras, placement=pl)
    nxt = np.asarray([5, 77, 200], np.int32)
    wcache2, wlog2 = rlm.decode_step(rp, wcache, jnp.asarray(nxt),
                                     jnp.int32(S), extras, rc, PX)
    tex = convert.params_from_numpy(_np(extras))
    gcache2, glog2 = tlm.decode_step(
        tp, convert.params_from_numpy(_np(wcache)), torch.from_numpy(nxt), S,
        tex, tc)
    _close(glog2, wlog2, LOGIT_MAX)
    _close(gcache2["main"]["k"], wcache2["main"]["k"], BF16_TOL)
    serve_step = tsteps.build_serve_step(tc)
    _, toks = serve_step(tp, tex, convert.params_from_numpy(_np(wcache)),
                         torch.from_numpy(nxt), S)
    assert torch.equal(toks, tsteps.argmax_first(glog2))


@pytest.mark.parametrize("pos", [16, 23])
def test_gqa_decode_past_the_cache_end_equals_reference(smoke, pos):
    """A decode step at pos >= Smax: the reference clamps the cache row
    to Smax - 1 (`dynamic_update_slice`) and attends to all Smax rows;
    the port writes the same row and gives the same output."""
    from repro.models import attention as rattn
    from repro_torch.models import attention as tattn
    rc, tc, rp, tp = smoke
    r = np.random.default_rng(8)
    Smax, Hkv, Dh = 16, rc.n_kv_heads, rc.resolved_head_dim
    ck, cv = (np.asarray(_bf16(r.normal(size=(2, Smax, Hkv, Dh))))
              for _ in range(2))
    xd = np.asarray(_bf16(r.normal(size=(2, 1, rc.d_model))))
    rl = jax.tree.map(lambda a: a[0], rp["layers"])["attn"]
    want, wc = rattn.gqa_decode(
        rl, jnp.asarray(xd), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.int32(pos), cfg=rc, px=PX, batch_entry=None, seq_entry=None)
    got, gc = tattn.gqa_decode(
        tlm.layer(tp["layers"], 0)["attn"], convert.tensor_from_numpy(xd),
        convert.params_from_numpy({"k": ck, "v": cv}), pos, cfg=tc)
    _close(got, want, BF16_TOL)
    for kv in ("k", "v"):
        _close(gc[kv], wc[kv], BF16_TOL, kv)
        # every row but the clamped last one is untouched, bit for bit
        assert np.array_equal(
            gc[kv][:, :-1].view(torch.int16).numpy().view(np.uint16),
            np.asarray(wc[kv])[:, :-1].view(np.uint16))


def test_argmax_takes_the_first_maximum():
    x = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]],
                     dtype=torch.bfloat16)
    assert tsteps.argmax_first(x).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(x.float().numpy()),
                                 -1)).tolist() == [1, 0]


# --- GAIA-MoE --------------------------------------------------------------


def _skewed(seed, E, G, shift=0):
    """Token counts (integer-valued, so every float sum is exact) where
    expert e is hammered by group (e + shift) % G."""
    r = np.random.default_rng(seed)
    base = np.floor(r.uniform(size=(G, E)) * 6.0)
    base[(np.arange(E) + shift) % G, np.arange(E)] += 100.0
    return base.astype(np.float32)


@pytest.mark.parametrize("E,G,mf,mt,window,interval", [
    (16, 4, 1.1, 0, 2, 1), (8, 2, 0.5, 0, 1, 3), (128, 4, 1.2, 8, 4, 8)])
def test_gaia_moe_exact_against_reference(E, G, mf, mt, window, interval):
    kw = dict(num_experts=E, num_groups=G, mf=mf, mt=mt, window=window,
              interval=interval)
    rc, tc = rgm.GaiaMoEConfig(**kw), tgm.GaiaMoEConfig(**kw)
    rs = rgm.init_state(rc)
    ts = convert.gaia_state_from_numpy(_np(rs))
    assert {k: (v.tolist() if torch.is_tensor(v) else v)
            for k, v in ts.items()} == {
        k: (v.tolist() if torch.is_tensor(v) else v)
        for k, v in tgm.init_state(tc, CPU).items()}
    L, F = 2, 3
    w = np.random.default_rng(0).normal(size=(L, E, F)).astype(np.float32)
    rw, tw = jnp.asarray(w), torch.from_numpy(w.copy())
    rperm = jnp.arange(E, dtype=jnp.int32)
    tperm = torch.arange(E, dtype=torch.int32)
    moves = 0
    for i in range(12):
        tr = _skewed(i, E, G, shift=1 + i // 4)
        rs, rn = rgm.maybe_update(rc, rs, jnp.asarray(tr))
        ts, tn = tgm.maybe_update(tc, ts, torch.from_numpy(tr))
        assert int(rn) == int(tn)
        for k in ("placement", "traffic", "last_mig"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(rs[k]))
        assert (ts["ptr"], ts["step"]) == (int(rs["ptr"]), int(rs["step"]))
        assert float(tgm.a2a_bytes(ts["placement"], torch.from_numpy(tr), 2)
                     ) == float(rgm.a2a_bytes(rs["placement"],
                                              jnp.asarray(tr), 2))
        if int(rn):
            moves += 1
            rp_, ro = rgm.placement_permutation(rs["placement"], E)
            tp_, to = tgm.placement_permutation(ts["placement"], E)
            np.testing.assert_array_equal(tp_.numpy(), np.asarray(rp_))
            np.testing.assert_array_equal(to.numpy(), np.asarray(ro))
            ridx = jnp.tile(rgm.migration_index(rperm, ro), (L, 1))
            tidx = tgm.migration_index(tperm, to)[None].expand(L, E)
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(ridx))
            assert int(tgm.count_moves(tidx)) == int(rgm.count_moves(ridx))
            rw = rgm.apply_migration_stacked(rw, ridx)
            tgm.apply_migration_stacked(tw, tidx)
            np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))
            rperm, tperm = rp_, tp_
    assert moves >= 1
    assert tgm.migration_bytes(3, 64, 32) == rgm.migration_bytes(3, 64, 32)


def test_gaia_moe_invariants():
    """tests/test_gaia_moe.py's invariants, on the port."""
    cfg = tgm.GaiaMoEConfig(num_experts=16, num_groups=4, mf=1.05, mt=0,
                            window=1, interval=1)
    st = tgm.init_state(cfg, CPU)
    st["placement"] = (torch.arange(16, dtype=torch.int32) + 1) % 4
    tr = torch.from_numpy(_skewed(1, 16, 4))
    before = float(tgm.a2a_bytes(st["placement"], tr, 2))
    total = 0
    for _ in range(4):
        st = tgm.observe(cfg, st, tr)
        st, n = tgm.evaluate(cfg, st)
        total += int(n)
        assert torch.bincount(st["placement"].long(),
                              minlength=4).tolist() == [4, 4, 4, 4]
    assert total > 0
    assert float(tgm.a2a_bytes(st["placement"], tr, 2)) < before
    # MT throttles
    cfg = tgm.GaiaMoEConfig(num_experts=8, num_groups=2, mf=1.05, mt=1000,
                            window=1, interval=1)
    st = tgm.init_state(cfg, CPU)
    st["placement"] = (torch.arange(8, dtype=torch.int32) + 1) % 2
    st["last_mig"] = torch.zeros(8, dtype=torch.int32)
    st = tgm.observe(cfg, st, torch.from_numpy(_skewed(2, 8, 2)))
    assert int(tgm.evaluate(cfg, st)[1]) == 0
    # the permutation's round trip
    perm, order = tgm.placement_permutation(
        torch.tensor([1, 0, 1, 0], dtype=torch.int32), 4)
    assert order.tolist() == [1, 3, 0, 2]
    assert perm[order.long()].tolist() == [0, 1, 2, 3]
    assert (perm // 2).tolist() == [1, 0, 1, 0]
    assert int(tgm.count_moves(torch.tensor([[0, 1, 2, 3], [1, 0, 2, 3]]))) \
        == 2
    with pytest.raises(ValueError, match="multiple"):
        tgm.init_state(tgm.GaiaMoEConfig(num_experts=10, num_groups=4), CPU)


def test_transparency_after_two_chained_migrations(smoke):
    """Permuting the stored weights and the routing ids leaves the MoE
    layer's output and per-expert counts unchanged, bit for bit, after
    two chained migrations (perm_old chained, not the identity)."""
    _, tc, _, tp = smoke
    m = dataclasses.replace(tc.moe, capacity_factor=0.5)  # with drops
    x = convert.tensor_from_numpy(np.asarray(_bf16(
        np.random.default_rng(8).normal(size=(2, 16, tc.d_model)))))
    p = dict(tlm.layer(tp["layers"]["moe"], 0))
    ident = torch.arange(8, dtype=torch.int32)
    out0, met0 = tmoe.moe_fwd(p, x, m=m, placement=ident)
    perm = ident
    stores = [p]
    for new in ([3, 0, 1, 2, 7, 4, 6, 5], [1, 7, 2, 0, 5, 6, 3, 4]):
        new = torch.tensor(new, dtype=torch.int32)
        order = torch.argsort(new)
        idx = tgm.migration_index(perm, order)
        p = dict(p)
        for k in ("w_gate", "w_up", "w_down"):
            p[k] = tgm.apply_migration(p[k], idx)
        perm = new
        out1, met1 = tmoe.moe_fwd(p, x, m=m, placement=perm)
        assert torch.equal(out1, out0)
        assert torch.equal(met1["expert_counts"], met0["expert_counts"])
        assert int(met1["moe_dropped"]) == int(met0["moe_dropped"]) > 0
        stores.append(p)
    # the identity as perm_old on the second move breaks the store
    idx = tgm.migration_index(ident, torch.argsort(perm))
    bad = {k: tgm.apply_migration(stores[1][k], idx)
           for k in ("w_gate", "w_up", "w_down")}
    out2, _ = tmoe.moe_fwd({**p, **bad}, x, m=m, placement=perm)
    assert not torch.equal(out2, out0)


# --- the whole slice -------------------------------------------------------

B, P, GEN = 8, 8, 24


def _reference_serve(rc, rp, prompts, gcfg):
    """The serve loop of examples/serve_moe.py on the reference, with
    perm_old chained through migrations. Returns tokens (B, GEN + 1),
    per-step logits, migration steps and the final placement."""
    E, L = rc.moe.num_experts, rc.n_layers
    cache, logits = rlm.prefill(rp, {"tokens": jnp.asarray(prompts)}, rc, PX,
                                cache_len=P + GEN)
    decode = jax.jit(lambda p, e, c, t, pos: rlm.decode_step(
        p, c, t, pos, e, rc, PX))
    extras = rlm.init_extras(rc)
    params = rp
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


def _slice_errors(rc, tc, rp, tp, seed=0):
    """Run both serve loops on the same weights and prompts, the port
    teacher-forced on the reference's tokens. Returns the comparison."""
    prompts = np.random.default_rng(seed).integers(
        0, rc.vocab_size, (B, P)).astype(np.int32)
    gkw = dict(num_experts=rc.moe.num_experts, num_groups=4, mf=1.2, mt=8,
               window=4, interval=8)
    rtoks, rlogs, rsteps, rplace = _reference_serve(
        rc, rp, prompts, rgm.GaiaMoEConfig(**gkw))
    out = tserve.serve(tc, tgm.GaiaMoEConfig(**gkw), B, P, GEN, seed, "cpu",
                       params=tp, prompts=torch.from_numpy(prompts),
                       forced=torch.from_numpy(rtoks), keep_logits=True)
    scale = max(float(np.abs(lg).max()) for lg in rlogs)
    errs = [np.abs(g.float().numpy() - w).max(-1) / scale
            for g, w in zip(out["logits"], rlogs)]
    margins = []
    for lg in rlogs:
        top2 = np.sort(lg, -1)[:, -2:]
        margins.append((top2[:, 1] - top2[:, 0]) / scale)
    return {
        "row_errs": np.stack(errs, 1).tolist(), "scale": scale,
        "ref_tokens": rtoks.tolist(), "tokens": out["tokens"].tolist(),
        "margins": np.stack(margins, 1).tolist(),
        "ref_steps": rsteps, "steps": out["migration_steps"],
        "ref_placement": rplace.tolist(),
        "placement": out["placement"].tolist(),
        "migrations": out["migrations"],
    }


def _check_slice(res, typ, most):
    errs = np.asarray(res["row_errs"])  # (B, GEN + 1), share of scale
    assert np.median(errs) <= typ, np.median(errs)
    assert errs.max() <= most, errs.max()
    sure = np.asarray(res["margins"]) > 2 * errs
    assert sure.mean() > 0.5  # the comparison is not vacuous
    np.testing.assert_array_equal(np.asarray(res["tokens"])[sure],
                                  np.asarray(res["ref_tokens"])[sure])
    assert res["steps"] == res["ref_steps"] and len(res["steps"]) >= 2
    assert res["placement"] == res["ref_placement"]


def test_serve_slice_equals_reference_bf16(smoke):
    rc, tc, rp, tp = smoke
    tp = convert.params_from_numpy(_np(rp))  # serve permutes in place
    _check_slice(_slice_errors(rc, tc, rp, tp), LOGIT_TOL, LOGIT_MAX)


def test_serve_slice_equals_reference_f32():
    """The same in float32 (REPRO_FORCE_F32=1 for both packages), with
    the jnp attention twins at F32_TOL, in a subprocess."""
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, REPRO_FORCE_F32="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, __file__], check=True,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["param_dtypes"] == ["float32"]
    assert res["flash_heads_err"] <= F32_TOL
    assert res["decode_attend_err"] <= F32_TOL
    _check_slice(res, F32_TOL, F32_TOL)


def _f32_child():
    """Body of the float32 subprocess: prints one JSON line."""
    from repro.models import attention as rattn
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_decode import ref as fd_ref
    rc, tc = rcfg.get_smoke(ARCH), tcfg.get_smoke(ARCH)
    rp = rlm.init_params(jax.random.key(0), rc)
    tp = convert.params_from_numpy(_np(rp))
    res = _slice_errors(rc, tc, rp, tp, seed=1)
    res["param_dtypes"] = sorted({str(t.dtype).split(".")[-1] for t in
                                  jax.tree.leaves(tp)})
    r = np.random.default_rng(3)
    q, k, v = (r.normal(size=(2, 4, 96, 16)).astype(np.float32)
               for _ in range(3))
    want = rattn.flash_heads(*map(jnp.asarray, (q, k, v)), causal=True,
                             px=make_ctx(None, q_block=32, kv_block=32),
                             batch_entry=None, head_entry=None)
    got = fa_ref.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                       True)
    res["flash_heads_err"] = float(np.abs(got.numpy() - want).max())
    qd = r.normal(size=(2, 4, 16)).astype(np.float32)
    kc, vc = (r.normal(size=(2, 40, 2, 16)).astype(np.float32)
              for _ in range(2))
    want = rattn.decode_attend(*map(jnp.asarray, (qd, kc, vc)),
                               jnp.int32(29), px=make_ctx(None),
                               batch_entry=None, seq_entry=None)
    got = fd_ref.flash_decode_plain(*map(torch.from_numpy, (qd, kc, vc)), 29)
    res["decode_attend_err"] = float(np.abs(got.numpy() - want).max())
    print(json.dumps(res))


# --- entry points and imports --------------------------------------------


def test_serve_demands_a_gpu_unless_given_the_cpu(smoke):
    _, tc, _, _ = smoke
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tserve.serve(tc, None, 2, 4, 2, 0)
    out = tserve.serve(tc, None, 2, 4, 2, 0, "cpu")
    assert out["tokens"].shape == (2, 3) and out["migrations"] == 0
    with pytest.raises(ValueError, match="num_experts"):
        tserve.serve(tc, tgm.GaiaMoEConfig(num_experts=16, num_groups=4),
                     2, 4, 2, 0, "cpu")


def test_serve_module_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch.serve\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
            "print(bad)\n")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.stdout.strip() == "[]"


if __name__ == "__main__":
    _f32_child()
