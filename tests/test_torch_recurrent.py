"""The recurrent families in the port — rwkv6 (chunked WKV time mix,
channel mix, exact decode step) and zamba2 (Mamba2's chunked SSD and
exact step, the shared attention block) — held against the reference on
the CPU on the two smoke configs.

Weights cross from JAX through `models.convert`; inputs come from numpy
seeds. The leaves that init makes constant (the mix base, the decay
base, the bonus, Mamba2's A_log, D and dt_bias, the norm scales) are
redrawn at random first (`_perturbed`), so that every term of the time
mix and of the SSD shows in the outputs. Tolerances, each on a module's
or the model's output as a share of the reference's largest |value|
(every leaf of a tuple or cache on its own):

- float32 (REPRO_FORCE_F32=1 for both packages, in a subprocess of
  this file): F32_TOL, summation order only; the loss likewise, each
  gradient leaf within GRAD_TOL of its largest |value| (zamba2:
  HYBRID_GRAD_TOL, see there) and one train step's parameters within
  PARAM_TOL absolute (tests/test_torch_train.py's bounds);
- bfloat16: a module on one layer within MODULE_BF16_TOL: both
  packages round to bfloat16 at the same places. The smoke's prefill
  and decode step within MODEL_BF16_TOL: the reference's compiled scan
  fuses chains of bfloat16 elementwise ops and rounds once where
  PyTorch rounds after each op, and the layers carry that into the
  recurrent state. The served logits per (step, row) follow
  tests/test_torch_serve.py's rule (median row within LOGIT_TOL, every
  row within LOGIT_MAX);
- the chunked prefill against the exact recurrence, within the port, in
  float32: every state leaf and the logits within F32_TOL (the
  reference's own test promises it but checks only that decode is
  finite; on the reference the gaps are 1.4e-6 and 7.7e-6).
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
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import mamba2 as rm2  # noqa: E402
from repro.models import rwkv6 as rr6  # noqa: E402
from repro.parallel.ctx import make_ctx  # noqa: E402

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import rwkv6 as tr6  # noqa: E402

from test_torch_serve import LOGIT_MAX, LOGIT_TOL  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("rwkv6-1.6b", "zamba2-1.2b")
F32_TOL = 1e-5
GRAD_TOL = 1e-4
#: zamba2's whole-model gradients and grad norm: a relative perturbation
#: grows ~5x through each pass of the shared block (measured on the
#: smoke in float32: 1e-6 at the embedding, 1.3e-5, 8e-5 and 2.9e-4
#: after the first three invocations), while the block's own gradients
#: stay within BLOCK_GRAD_TOL (test_shared_block_grads_equal_reference)
HYBRID_GRAD_TOL = 5e-4
BLOCK_GRAD_TOL = 2e-5
PARAM_TOL = 1e-5
#: AdamW's first update is lr g / (|g| + eps): an entry whose gradient
#: sits near zero moves by a fraction of lr set by the gradient's last
#: bits; at most this share of entries may be off by more than a tenth
#: of the largest move (tests/test_torch_train.py's rule for such a step)
FAR_SHARE = 1e-3
#: bfloat16: one layer's module against the reference run op by op
#: (both round at the same places; the plain attention rounds P once over
#: the row, the reference in 32-key blocks): measured at most 1.7e-3
MODULE_BF16_TOL = 1e-2
#: bfloat16: the smoke's prefill and decode step, every leaf (logits and
#: cache), against the reference's compiled `lax.scan`, which fuses
#: chains of bfloat16 ops and rounds them once: measured at most 2.9e-2
MODEL_BF16_TOL = 6e-2
PX = make_ctx(None)
#: the smokes' batch and prompt: two chunks of 16
B, S = 2, 32
#: the full configs' parameters as the reference allocates them
#: (`jax.eval_shape` of `init_params`)
ALLOCATED = {"rwkv6-1.6b": 1_599_571_968, "zamba2-1.2b": 1_279_369_344}
#: each module's cases, by family
MODULES = {
    "rwkv6-1.6b": ("rwkv_time_mix", "rwkv_channel_mix", "rwkv_block_fwd",
                   "rwkv_decode_step", "prefill", "decode_step"),
    "zamba2-1.2b": ("ssd_chunked", "mamba2_fwd", "mamba2_fwd_decode",
                    "shared_block_fwd", "shared_block_decode", "prefill",
                    "decode_step"),
}
CASES = [(a, m) for a in ARCHS for m in MODULES[a]]
#: prompt lengths of the chunked-against-recurrent states: below one
#: chunk, one chunk, two chunks; and of prefill n + decode one token
#: against a prefill of n + 1 (a prompt must be a multiple of the chunk
#: or within one, so both n and n + 1 are within the first)
STATE_LENGTHS = (15, 16, 32)
NEXT_LENGTHS = (8, 15)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _perturbed(rp, seed=0):
    """The reference's parameters with their constant leaves redrawn:
    mixes and the bonus around 0, the decay base around -3, A_log,
    dt_bias around 0, D and the norm scales around 1."""
    r = np.random.default_rng(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "'scale'" in name or "'D'" in name:
            v = 1.0 + 0.2 * r.normal(size=a.shape)
        elif "'w_base'" in name:
            v = -3.0 + 0.5 * r.normal(size=a.shape)
        elif any(f"'{k}'" in name for k in ("mix_base", "bonus_u", "A_log",
                                             "dt_bias")):
            v = 0.3 * r.normal(size=a.shape)
        else:
            return a
        return v.astype(np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(draw, _np(rp))


def _setup(arch):
    """(reference config, port config, reference params as jnp, port
    params), the params perturbed."""
    rc, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
    rp = _perturbed(rlm.init_params(jax.random.key(0), rc))
    return rc, tc, jax.tree.map(jnp.asarray, rp), \
        convert.params_from_numpy(rp)


def _rnd(r, shape, dt, scale=1.0):
    """A numpy draw rounded to `dt` (the reference's dtype name)."""
    a = (scale * r.normal(size=shape)).astype(np.float32)
    return np.asarray(jnp.asarray(a).astype(dt))


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a))


def _both(tree_np):
    """A nested tree of numpy arrays as (jnp, torch)."""
    return (jax.tree.map(jnp.asarray, tree_np),
            convert.params_from_numpy(tree_np))


def _flat(t):
    """The leaves of a result of either package (nested dicts, tuples,
    tensors or arrays) in the reference's order, as float32 numpy."""
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


def module_case(arch, what, seed=0):
    """(port result, reference result) of one module on the same
    weights and inputs (layer 0; the smoke's prompt for prefill and
    decode_step, the decode from the reference's prefill cache)."""
    rc, tc, rp, tp = _setup(arch)
    dt = rlayers.COMPUTE_DT
    r = np.random.default_rng(100 + seed)
    d = rc.d_model
    rl = jax.tree.map(lambda a: a[0], rp["layers"])
    tl = tlm.layer(tp["layers"], 0)
    if what in ("prefill", "decode_step"):
        toks = r.integers(0, rc.vocab_size, (B, S)).astype(np.int32)
        wc, wl = rlm.prefill(rp, {"tokens": jnp.asarray(toks)}, rc, PX,
                             cache_len=S + 8)
        if what == "prefill":
            gc, gl = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                                 S + 8)
            return (gl, gc), (wl, wc)
        nxt = r.integers(0, rc.vocab_size, (B,)).astype(np.int32)
        wc2, wl2 = rlm.decode_step(rp, wc, jnp.asarray(nxt), jnp.int32(S),
                                   rlm.init_extras(rc), rc, PX)
        gc2, gl2 = tlm.decode_step(tp, convert.params_from_numpy(_np(wc)),
                                   torch.from_numpy(nxt), S, {}, tc)
        return (gl2, gc2), (wl2, wc2)
    if arch == "rwkv6-1.6b":
        H, N = rc.n_heads, rc.rwkv.head_dim
        Sx = 1 if what == "rwkv_decode_step" else S
        carry = {"state": _rnd(r, (B, H, N, N), np.float32, 0.5),
                 "shift_a": _rnd(r, (B, d), dt),
                 "shift_f": _rnd(r, (B, d), dt)}
        x = _rnd(r, (B, Sx, d), dt)
        jc, tcar = _both(carry)
        jx, tx = jnp.asarray(x), _t(x)
        kw = dict(px=PX, batch_entry=None)
        if what == "rwkv_time_mix":
            return (tr6.rwkv_time_mix(tl, tx, tcar["state"], tcar["shift_a"],
                                      cfg=tc),
                    rr6.rwkv_time_mix(rl, jx, jc["state"], jc["shift_a"],
                                      cfg=rc, **kw))
        if what == "rwkv_channel_mix":
            return (tr6.rwkv_channel_mix(tl, tx, tcar["shift_f"]),
                    rr6.rwkv_channel_mix(rl, jx, jc["shift_f"], **kw))
        fn = {"rwkv_block_fwd": (tr6.rwkv_block_fwd, rr6.rwkv_block_fwd),
              "rwkv_decode_step": (tr6.rwkv_decode_step,
                                   rr6.rwkv_decode_step)}[what]
        return fn[0](tl, tx, tcar, cfg=tc), fn[1](rl, jx, jc, cfg=rc, **kw)
    s = rc.ssm
    di = s.expand * d
    H, P, N = di // s.head_dim, s.head_dim, s.d_state
    if what == "ssd_chunked":
        ins = {"xh": _rnd(r, (B, S, H, P), dt), "bh": _rnd(r, (B, S, N), dt),
               "ch": _rnd(r, (B, S, N), dt),
               "dt": np.log1p(np.exp(_rnd(r, (B, S, H), np.float32))),
               "h0": _rnd(r, (B, H, P, N), np.float32, 0.5)}
        j, t = _both(ins)
        return (tm2._ssd_chunked(t["xh"], t["bh"], t["ch"], t["dt"],
                                 tl["A_log"], t["h0"], s.chunk),
                rm2._ssd_chunked(j["xh"], j["bh"], j["ch"], j["dt"],
                                 rl["A_log"], j["h0"], s.chunk))
    if what.startswith("mamba2_fwd"):
        decode = what.endswith("decode")
        carry = {"ssm": _rnd(r, (B, H, P, N), np.float32, 0.5),
                 "conv": _rnd(r, (B, s.d_conv - 1, di + 2 * N), dt)}
        x = _rnd(r, (B, 1 if decode else S, d), dt)
        jc, tcar = _both(carry)
        return (tm2.mamba2_fwd(tl, _t(x), tcar, cfg=tc, decode=decode),
                rm2.mamba2_fwd(rl, jnp.asarray(x), jc, cfg=rc, px=PX,
                               batch_entry=None, decode=decode))
    rs, ts = rp["shared_block"], tp["shared_block"]
    if what == "shared_block_fwd":
        h, e = _rnd(r, (B, S, d), dt), _rnd(r, (B, S, d), dt)
        return (tblocks.shared_block_fwd(ts, _t(h), _t(e), cfg=tc,
                                         return_kv=True),
                rblocks.shared_block_fwd(rs, jnp.asarray(h), jnp.asarray(e),
                                         cfg=rc, px=PX, batch_entry=None,
                                         return_kv=True))
    # shared_block_decode: a cache of 24 rows, the new row at 20
    hd = 2 * d // rc.n_heads
    cache = {k: _rnd(r, (B, 24, rc.n_kv_heads, hd), dt) for k in "kv"}
    h, e = _rnd(r, (B, 1, d), dt), _rnd(r, (B, 1, d), dt)
    jc, tcache = _both(cache)
    return (tblocks.shared_block_decode(ts, _t(h), _t(e), tcache, 20,
                                        cfg=tc),
            rblocks.shared_block_decode(rs, jnp.asarray(h), jnp.asarray(e),
                                        jc, jnp.int32(20), cfg=rc, px=PX,
                                        batch_entry=None, seq_entry=None))


def _zero_cache(tc, Smax):
    """The port's cache before the first token: every carry zero, the
    K/V stacks empty."""
    L = tc.n_layers

    def stacked(one):
        return tree.tree_map(lambda t: t.expand(L, *t.shape).clone(), one)

    if tc.rwkv is not None:
        return stacked(tlm.zero_rwkv_carry(tc, B, "cpu"))
    hd = 2 * tc.d_model // tc.n_heads
    kv = torch.zeros((tlm.n_shared(tc), B, Smax, tc.n_kv_heads, hd),
                     dtype=tlm.COMPUTE_DT)
    return {"mamba": stacked(tlm.zero_mamba_carry(tc, B, "cpu")),
            "attn_k": kv, "attn_v": kv.clone()}


def chunked_vs_recurrent(arch, n):
    """Within the port: the cache of a chunked prefill of n tokens
    against n exact decode steps from a zero carry, every leaf (for
    zamba2 the K/V rows too)."""
    _, tc, _, tp = _setup(arch)
    toks = torch.from_numpy(np.random.default_rng(n).integers(
        0, tc.vocab_size, (B, n)).astype(np.int32))
    pc, _ = tlm.prefill(tp, {"tokens": toks}, tc, n + 1)
    rc_ = _zero_cache(tc, n + 1)
    for pos in range(n):
        rc_, _ = tlm.decode_step(tp, rc_, toks[:, pos], pos, {}, tc)
    if tc.ssm is not None:  # the row the prefill left as padding
        for name in ("attn_k", "attn_v"):
            assert not pc[name][:, :, n:].any()
    return _errs(rc_, pc)


def decode_after_prefill(arch, n):
    """Within the port: the last logits of a prefill of n + 1 tokens
    against a prefill of n and one decode step."""
    _, tc, _, tp = _setup(arch)
    toks = torch.from_numpy(np.random.default_rng(n).integers(
        0, tc.vocab_size, (B, n + 1)).astype(np.int32))
    _, want = tlm.prefill(tp, {"tokens": toks}, tc, n + 1)
    cache, _ = tlm.prefill(tp, {"tokens": toks[:, :n]}, tc, n + 1)
    _, got = tlm.decode_step(tp, cache, toks[:, n], n, {}, tc)
    return _errs(got, want[:, -1])[0]


# --- configs ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("get", ["get_arch", "get_smoke"])
def test_configs_equal_the_reference(arch, get):
    r, t = getattr(rcfg, get)(arch), getattr(tcfg, get)(arch)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    for prop in ("resolved_head_dim", "padded_vocab"):
        assert getattr(r, prop) == getattr(t, prop)
    assert r.param_count() == t.param_count()
    assert r.active_param_count() == t.active_param_count()
    assert r.shapes() == t.shapes()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_as_the_repo_defines_them(arch):
    c = tcfg.get_arch(arch)
    if arch == "rwkv6-1.6b":
        assert (c.n_layers, c.d_model, c.n_heads, c.rwkv.head_dim,
                c.rwkv.chunk, c.d_ff) == (24, 2048, 32, 64, 128, 7168)
        assert c.param_count() == 1_850_736_640
    else:
        assert (c.n_layers, c.d_model, c.ssm.expand, c.ssm.d_state,
                c.ssm.head_dim, c.ssm.chunk, c.shared_every) == (
                    38, 2048, 2, 64, 64, 128, 6)
        # the shared block attends at 2 d over 32 heads: D 128, which
        # both attention kernels take
        view = tblocks.attn_cfg_view(c, 2 * c.d_model)
        assert (view.n_heads, view.n_kv_heads, view.resolved_head_dim) == (
            32, 32, 128)
        assert c.param_count() == 1_490_026_496
    shapes = jax.eval_shape(lambda: rlm.init_params(jax.random.key(0),
                                                    rcfg.get_arch(arch)))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == ALLOCATED[arch]


@pytest.mark.parametrize("get", ["get_arch", "get_smoke"])
@pytest.mark.parametrize("n_layers", [None, 7, 1])
def test_shared_slots_index_the_reference_kv_stack(get, n_layers):
    """`lm.shared_slot` / `n_shared` place zamba2's shared block as the
    reference does: before every `shared_every`-th layer, the i-th run
    on the i-th slice of its (n_inv, ...) K/V stack; none for rwkv6."""
    c = getattr(tcfg, get)("zamba2-1.2b")
    if n_layers:
        c = dataclasses.replace(c, n_layers=n_layers)
    rc = dataclasses.replace(getattr(rcfg, get)("zamba2-1.2b"),
                             n_layers=c.n_layers)
    n_inv = (rc.n_layers + rc.shared_every - 1) // rc.shared_every
    slots = [tlm.shared_slot(c, i) for i in range(c.n_layers)]
    assert tlm.n_shared(c) == n_inv
    assert [s for s in slots if s is not None] == list(range(n_inv))
    assert [i for i, s in enumerate(slots) if s is not None] == [
        i for i in range(rc.n_layers) if i % rc.shared_every == 0]
    assert tlm.n_shared(getattr(tcfg, get)("rwkv6-1.6b")) == 0


#: what each family ported after the recurrent ones sets in its config
LATER = {"internvl2-2b": {"n_vision_tokens": 4},
         "seamless-m4t-medium": {"encoder_decoder": True}}


@pytest.mark.parametrize("name", sorted(LATER))
def test_later_families_still_raise(name):
    """The families once queued behind this slice are ported: `get_arch`
    and `get_smoke` return the reference's configs, and a dense smoke
    with the family's field set builds the reference's parameter tree
    (vision: `vision_proj`; encoder-decoder: the `encdec` stacks)."""
    assert name not in tcfg.NOT_PORTED and name in rcfg.ARCHS
    for get in ("get_arch", "get_smoke"):
        assert dataclasses.asdict(getattr(tcfg, get)(name)) == \
            dataclasses.asdict(getattr(rcfg, get)(name))
    fields = dict(LATER[name], name="later-smoke")
    tc = dataclasses.replace(tcfg.get_smoke("tinyllama-1.1b"), **fields)
    rc = dataclasses.replace(rcfg.get_smoke("tinyllama-1.1b"), **fields)
    got = tlm.init_params(torch.Generator().manual_seed(0), tc)
    want = jax.eval_shape(lambda: rlm.init_params(jax.random.key(0), rc))
    assert jax.tree.map(lambda a: (a.shape, a.dtype.name), want) == \
        tree.tree_map(lambda t: (tuple(t.shape),
                                 str(t.dtype).split(".")[-1]), got)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_bit_for_bit(arch):
    rc, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
    rp = _np(rlm.init_params(jax.random.key(0), rc))
    tp = convert.params_from_numpy(rp)
    for path, a in jax.tree_util.tree_leaves_with_path(rp):
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[a.dtype.name]
        assert np.array_equal(t.float().numpy(), a.astype(np.float32))
    ti = tlm.init_params(torch.Generator().manual_seed(0), tc)
    assert jax.tree.map(lambda a: (a.shape, a.dtype.name), rp) == \
        tree.tree_map(lambda t: (tuple(t.shape),
                                 str(t.dtype).split(".")[-1]), ti)
    # the constant leaves are the reference's constants
    for path, a in jax.tree_util.tree_leaves_with_path(rp):
        name = path[-1].key
        if name in ("mix_base", "bonus_u", "w_base", "A_log", "D",
                    "dt_bias", "scale"):
            t = ti
            for key in path:
                t = t[key.key]
            assert np.array_equal(t.float().numpy(), a.astype(np.float32))
    assert tlm.init_extras(tc, "cpu") == {}


# --- bfloat16 parity (in process) ------------------------------------------


@pytest.mark.parametrize("arch,what", CASES)
def test_module_equals_reference_bf16(arch, what):
    got, want = module_case(arch, what)
    errs = _errs(got, want)
    tol = MODEL_BF16_TOL if what in ("prefill", "decode_step") \
        else MODULE_BF16_TOL
    assert max(errs) <= tol, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_not_a_multiple_of_the_chunk_raises_as_the_reference(arch):
    """24 tokens over chunks of 16: rwkv6 asserts, Mamba2's reshape
    raises TypeError; 15 (within one chunk) runs."""
    rc, tc, rp, tp = _setup(arch)
    toks = np.zeros((1, 24), np.int32)
    with pytest.raises(Exception) as ref:
        rlm.prefill(rp, {"tokens": jnp.asarray(toks)}, rc, PX, cache_len=32)
    with pytest.raises(Exception) as port:
        tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, 32)
    assert type(port.value) is type(ref.value) is {
        "rwkv6-1.6b": AssertionError, "zamba2-1.2b": TypeError}[arch]
    _, logits = tlm.prefill(tp, {"tokens": torch.zeros((1, 15),
                                                      dtype=torch.int32)},
                            tc, 32)
    assert torch.isfinite(logits.float()).all()


def _reference_serve(rc, rp, prompts, gen):
    cache, logits = rlm.prefill(rp, {"tokens": jnp.asarray(prompts)}, rc,
                                PX, cache_len=prompts.shape[1] + gen)
    decode = jax.jit(lambda p, c, t, pos: rlm.decode_step(
        p, c, t, pos, {}, rc, PX))
    toks = [jnp.argmax(logits[:, -1], -1).astype(jnp.int32)]
    logs = [np.asarray(logits[:, -1], np.float32)]
    for step in range(gen):
        cache, lg = decode(rp, cache, toks[-1],
                           jnp.int32(prompts.shape[1] + step))
        toks.append(jnp.argmax(lg, -1).astype(jnp.int32))
        logs.append(np.asarray(lg, np.float32))
    return np.stack([np.asarray(t) for t in toks], 1), logs


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_equals_reference_bf16(arch):
    """`launch.serve.serve` on the CPU, teacher-forced on the reference's
    greedy tokens: 4 prompts of 32 tokens, 12 steps."""
    rc, tc, rp, tp = _setup(arch)
    gen = 12
    prompts = np.random.default_rng(3).integers(
        0, rc.vocab_size, (4, S)).astype(np.int32)
    rtoks, rlogs = _reference_serve(rc, rp, prompts, gen)
    out = tserve.serve(tc, None, 4, S, gen, 0, "cpu", params=tp,
                       prompts=torch.from_numpy(prompts),
                       forced=torch.from_numpy(rtoks), keep_logits=True)
    scale = max(float(np.abs(lg).max()) for lg in rlogs)
    errs = np.stack([np.abs(g.float().numpy() - w).max(-1) / scale
                     for g, w in zip(out["logits"], rlogs)])
    assert np.median(errs) <= LOGIT_TOL, errs
    assert errs.max() <= LOGIT_MAX, errs
    assert out["migrations"] == 0 and tuple(out["tokens"].shape) == (4, 13)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_needs_a_gpu_unless_asked_for_the_cpu(arch):
    tc = tcfg.get_smoke(arch)
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(tc, None, 2, 16, 2, 0)
    with pytest.raises(ValueError, match="no MoE layers"):
        tserve.serve(tc, object(), 2, 16, 2, 0, "cpu")


def test_ssd_gradients_finite_where_a_chunk_decays_past_float32():
    """A full chunk of 128 whose decay sums past ~88 (A_log 0, dt ~1: the
    decay zamba2-1.2b's init gives): the port's SSD output equals the
    reference's, its gradients are finite, and its x gradient equals the
    reference's; the reference's own dt and A_log gradients are NaN
    there (`where` after `exp`: 0 x inf in its backward), the port masks
    the exponent before the exponential. The port's dt and A_log
    gradients are held against the reference's on the same inputs in
    chunks of 16, where no exponent passes 16 (the SSD's value does not
    depend on the chunk): dt's within F32_TOL, A_log's (one sum a head
    over the whole chunk's reverse cumsum) within GRAD_TOL. The
    reference's own chunk of 128 in float32 is 3.1e-5 from a float64
    recurrence in A_log's gradient at dt 0.5, where it does not
    overflow."""
    r = np.random.default_rng(9)
    Bq, Sq, H, P, N = 1, 128, 2, 4, 8
    xh, bh, ch = (r.normal(size=s).astype(np.float32)
                  for s in ((Bq, Sq, H, P), (Bq, Sq, N), (Bq, Sq, N)))
    dt = np.full((Bq, Sq, H), 1.0, np.float32)
    A_log, h0 = np.zeros(H, np.float32), np.zeros((Bq, H, P, N), np.float32)

    def ref(x, d, a, chunk=Sq):
        y, h = rm2._ssd_chunked(x, jnp.asarray(bh), jnp.asarray(ch), d, a,
                                jnp.asarray(h0), chunk)
        return y.sum() + h.sum(), (y, h)

    args = (jnp.asarray(xh), jnp.asarray(dt), jnp.asarray(A_log))
    (_, (ry, rh)), rg = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                           has_aux=True)(*args)
    wg = jax.grad(lambda x, d, a: ref(x, d, a, 16)[0],
                  argnums=(0, 1, 2))(*args)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xh, dt, A_log)]
    ty, th = tm2._ssd_chunked(leaves[0], torch.from_numpy(bh),
                              torch.from_numpy(ch), leaves[1], leaves[2],
                              torch.from_numpy(h0), Sq)
    tg = torch.autograd.grad(ty.sum() + th.sum(), leaves)
    assert max(_errs((ty, th), (ry, rh))) <= F32_TOL
    assert all(bool(torch.isfinite(g).all()) for g in tg)
    assert _errs(tg[0], rg[0])[0] <= F32_TOL
    assert not np.isfinite(np.asarray(rg[1])).all()
    assert all(np.isfinite(np.asarray(g)).all() for g in wg)
    errs = _errs(tg, wg)
    assert max(errs[:2]) <= F32_TOL and errs[2] <= GRAD_TOL, errs


# --- float32 (the subprocess's results) -------------------------------------


@pytest.fixture(scope="module")
def f32():
    """The float32 comparisons, computed once in a REPRO_FORCE_F32=1
    subprocess of this file (the reference's gradients and train step
    once a family)."""
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, REPRO_FORCE_F32="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, __file__], check=True,
                         capture_output=True, text=True, env=env,
                         timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_child_ran_in_float32(f32):
    assert f32["param_dtypes"] == ["float32"]


@pytest.mark.parametrize("arch,what", CASES)
def test_module_equals_reference_f32(f32, arch, what):
    errs = f32["modules"][f"{arch}/{what}"]
    assert max(errs) <= F32_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", STATE_LENGTHS)
def test_chunked_prefill_state_equals_recurrence_f32(f32, arch, n):
    errs = f32["chunked_vs_recurrent"][f"{arch}/{n}"]
    assert max(errs) <= F32_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", NEXT_LENGTHS)
def test_decode_after_prefill_equals_longer_prefill_f32(f32, arch, n):
    err = f32["decode_after_prefill"][f"{arch}/{n}"]
    assert err <= F32_TOL, err


def _grad_tol(arch):
    return HYBRID_GRAD_TOL if arch == "zamba2-1.2b" else GRAD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_equal_reference_f32(f32, arch):
    r = f32["loss"][arch]
    assert r["loss_rel"] <= F32_TOL, r
    assert r["xent_rel"] <= F32_TOL, r
    assert r["n_grads"] == r["n_ref_grads"] > 0
    assert max(r["grad_rel"].values()) <= _grad_tol(arch), r["grad_rel"]


def test_shared_block_grads_equal_reference_f32(f32):
    errs = f32["shared_block_grads"]
    assert len(errs) == 10 and max(errs) <= BLOCK_GRAD_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference_f32(f32, arch):
    r = f32["step"][arch]
    err = max(r["param_err"].values())
    assert err <= PARAM_TOL, r["param_err"]
    # not vacuous: the step moved the weights by far more than the two
    # packages differ, but for the few entries in AdamW's eps regime
    if arch == "zamba2-1.2b":
        assert r["far_share"] <= FAR_SHARE, r
        assert r["moved"] > err, r
    else:
        assert r["moved"] > 10 * err, r
    for k in ("loss", "lr"):
        assert r["metric_rel"][k] <= F32_TOL, r["metric_rel"]
    assert r["metric_rel"]["grad_norm"] <= _grad_tol(arch) / 10, r


def _train_parity(arch):
    """loss_fn and its gradients (loss chunk 8, remat full), and one
    AdamW step over 2 microbatches, of the perturbed smoke against the
    reference's."""
    from repro.configs.base import ShapeConfig as RShape
    from repro.launch import steps as rsteps
    from repro.optim import adamw as radamw
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.launch import steps as tsteps
    from repro_torch.optim import adamw as tadamw

    rc, tc, rp, tp = _setup(arch)

    def rel(got, want):
        return _errs(got, want)[0]

    def paths(t):
        return [jax.tree_util.keystr(p) for p, _ in
                jax.tree_util.tree_leaves_with_path(t)]

    toks = np.random.default_rng(5).integers(0, rc.vocab_size,
                                             (4, S)).astype(np.int32)
    batch = {"tokens": toks, "loss_mask": np.ones((4, S), np.float32)}
    half = {k: v[:2] for k, v in batch.items()}
    rpx = make_ctx(None, loss_chunk=8)
    (rloss, rmet), rg = jax.value_and_grad(
        lambda p: rlm.loss_fn(p, jax.tree.map(jnp.asarray, half), {}, rc,
                              rpx), has_aux=True)(rp)
    preq = tree.tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    tloss, tmet = tlm.loss_fn(preq, {k: torch.from_numpy(v) for k, v in
                                     half.items()}, {}, tc, loss_chunk=8)
    tg = torch.autograd.grad(tloss, tree.leaves(preq))
    rgl = jax.tree.leaves(rg)
    loss = {"loss_rel": rel(tloss, rloss),
            "xent_rel": rel(tmet["xent"], rmet["xent"]),
            "n_grads": len(tg), "n_ref_grads": len(rgl),
            "grad_rel": {p: rel(g, w) for p, g, w in
                         zip(paths(rg), tg, rgl)}}
    rpx = make_ctx(None, loss_chunk=8, num_microbatches=2)
    rb = rsteps.build_train_step(rc, RShape("t", S, 4, "train"), rpx)
    rp2, _, _, rm = jax.jit(rb.fn)(rp, radamw.adamw_init(rp), {},
                                   jax.tree.map(jnp.asarray, batch))
    tfn = tsteps.build_train_step(
        tc, TShape("t", S, 4, "train"),
        tsteps.TrainCtx(num_microbatches=2, loss_chunk=8))
    tp2, _, _, tm = tfn(tp, tadamw.adamw_init(tp), {}, batch)
    step = {"param_err": {p: float(np.abs(g.float().numpy() - w).max())
                          for p, g, w in zip(paths(rp2), tree.leaves(tp2),
                                             jax.tree.leaves(_np(rp2)))},
            "moved": max(float(np.abs(np.asarray(a, np.float32)
                                      - np.asarray(b, np.float32)).max())
                         for a, b in zip(jax.tree.leaves(rp2),
                                         jax.tree.leaves(rp))),
            "metric_rel": {k: rel(tm[k], rm[k])
                           for k in ("loss", "grad_norm", "lr")}}
    # the share of entries off by more than a tenth of the move
    n = sum(int(np.size(a)) for a in jax.tree.leaves(rp2))
    step["far_share"] = sum(
        int((np.abs(g.float().numpy() - w) > 0.1 * step["moved"]).sum())
        for g, w in zip(tree.leaves(tp2), jax.tree.leaves(_np(rp2)))) / n
    return loss, step


def _shared_block_grads():
    """The shared block's parameter gradients alone (the sum of its
    output times a fixed random tensor) against the reference's."""
    rc, tc, rp, tp = _setup("zamba2-1.2b")
    r = np.random.default_rng(6)
    h, e, w = (r.normal(size=(B, S, rc.d_model)).astype(np.float32)
               for _ in range(3))

    def ref(p):
        y, _ = rblocks.shared_block_fwd(p, jnp.asarray(h), jnp.asarray(e),
                                        cfg=rc, px=PX, batch_entry=None)
        return (y * w).sum()

    want = jax.grad(ref)(rp["shared_block"])
    preq = tree.tree_map(lambda t: t.detach().clone().requires_grad_(),
                         tp["shared_block"])
    y, _ = tblocks.shared_block_fwd(preq, torch.from_numpy(h),
                                    torch.from_numpy(e), cfg=tc)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                              tree.leaves(preq))
    return _errs(list(got), jax.tree.leaves(want))


def _f32_child():
    """Body of the float32 subprocess: prints one JSON line."""
    _, _, _, probe = _setup("rwkv6-1.6b")
    res = {"param_dtypes": sorted({str(t.dtype).split(".")[-1]
                                   for t in tree.leaves(probe)}),
           "modules": {}, "chunked_vs_recurrent": {},
           "decode_after_prefill": {}, "loss": {}, "step": {}}
    for arch, what in CASES:
        res["modules"][f"{arch}/{what}"] = _errs(*module_case(arch, what))
    for arch in ARCHS:
        for n in STATE_LENGTHS:
            res["chunked_vs_recurrent"][f"{arch}/{n}"] = \
                chunked_vs_recurrent(arch, n)
        for n in NEXT_LENGTHS:
            res["decode_after_prefill"][f"{arch}/{n}"] = \
                decode_after_prefill(arch, n)
        res["loss"][arch], res["step"][arch] = _train_parity(arch)
    res["shared_block_grads"] = _shared_block_grads()
    print(json.dumps(res))


if __name__ == "__main__":
    _f32_child()
