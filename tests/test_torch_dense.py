"""The dense families (yi-9b, tinyllama-1.1b, yi-6b, qwen2-7b) in the
port, held against the reference on the CPU: their configs, one serve
step and decode against prefill (the cases of tests/test_arch_smoke.py
for the four dense smokes), and the package surfaces the reference
exports (core, parallel, checkpoint, optim, data, configs).

Weights cross from JAX through `models.convert`; tolerances as in
tests/test_torch_serve.py: bfloat16 logits per row within LOGIT_MAX of
the reference's largest |logit| (a few bf16 ULPs carried through two
layers), greedy tokens equal where the reference's top-1 margin exceeds
twice that error; integer outputs exact.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402
import repro.parallel  # noqa: E402
from repro import configs as rcfg  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.parallel.ctx import make_ctx  # noqa: E402

import repro_torch.core  # noqa: E402
import repro_torch.parallel  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

DENSE = ("yi-9b", "tinyllama-1.1b", "yi-6b", "qwen2-7b")
#: the families ported last (the encoder-decoder and vision tokens)
LATER = ("internvl2-2b", "seamless-m4t-medium")
LOGIT_MAX = 3e-2
PX = make_ctx(None)
DECODE = ShapeConfig("smoke_dec", seq_len=64, global_batch=2, kind="decode")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _row_err(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max(-1) / np.abs(want).max()


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    arch = request.param
    rc, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
    rp = rlm.init_params(jax.random.key(0), rc)
    return arch, rc, tc, rp, convert.params_from_numpy(_np(rp))


# --- configs ---------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("get", ["get_arch", "get_smoke"])
def test_dense_configs_equal_the_reference(arch, get):
    r, t = getattr(rcfg, get)(arch), getattr(tcfg, get)(arch)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    for prop in ("resolved_head_dim", "padded_vocab"):
        assert getattr(r, prop) == getattr(t, prop)
    assert r.param_count() == t.param_count()
    assert r.shapes() == t.shapes()


def test_registry_lists_the_ported_and_the_later():
    """Every architecture the reference registers is ported, the later
    families too: `NOT_PORTED` is empty and each name resolves to the
    reference's config."""
    assert sorted(tcfg.ARCHS) == sorted(DENSE + (
        "qwen3-moe-30b-a3b", "deepseek-v3-671b", "rwkv6-1.6b",
        "zamba2-1.2b") + LATER)
    assert tcfg.NOT_PORTED == ()
    assert sorted(tcfg.ARCHS) == sorted(rcfg.ARCHS)
    for name in rcfg.ARCHS:
        for get in ("get_arch", "get_smoke"):
            assert dataclasses.asdict(getattr(tcfg, get)(name)) == \
                dataclasses.asdict(getattr(rcfg, get)(name))


def test_full_dense_configs_as_the_repo_defines_them():
    t = tcfg.get_arch("tinyllama-1.1b")
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.d_ff,
            t.vocab_size, t.resolved_head_dim) == (22, 2048, 32, 4, 5632,
                                                   32000, 64)
    q = tcfg.get_arch("qwen2-7b")
    assert (q.n_heads // q.n_kv_heads, q.resolved_head_dim,
            q.qkv_bias) == (7, 128, True)
    assert tcfg.get_smoke("qwen2-7b").resolved_head_dim == 8


# --- serve step and decode against prefill -----------------------------------


def test_params_have_the_reference_tree(dense):
    _, _, tc, rp, tp = dense
    ti = tlm.init_params(torch.Generator().manual_seed(0), tc)
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), _np(rp))
    assert shapes == tlm.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), ti)


def test_serve_step_equals_reference(dense):
    """test_arch_smoke's serve step: a decode step at pos 3 against a
    cache of random rows, the same weights and cache in both."""
    _, rc, tc, rp, tp = dense
    b = rsteps.build_serve_step(rc, DECODE, PX)
    r = np.random.default_rng(1)
    cache = jax.tree.map(
        lambda s: (r.normal(size=s.shape) * 0.02).astype(np.float32),
        b.in_sds[2])
    cache = jax.tree.map(lambda a, s: jnp.asarray(a).astype(s.dtype), cache,
                         b.in_sds[2])
    tokens = np.full((DECODE.global_batch,), 5, np.int32)
    _, want = jax.jit(b.fn)(rp, rlm.init_extras(rc), cache,
                            jnp.asarray(tokens), jnp.int32(3))
    tcache = convert.params_from_numpy(_np(cache))
    _, tlog = tlm.decode_step(tp, tcache, torch.from_numpy(tokens), 3, {},
                              tc)
    _, wlog = rlm.decode_step(rp, cache, jnp.asarray(tokens), jnp.int32(3),
                              {}, rc, PX)
    assert _row_err(tlog, wlog).max() <= LOGIT_MAX
    serve_step = tsteps.build_serve_step(tc)
    _, got = serve_step(tp, {}, convert.params_from_numpy(_np(cache)),
                        torch.from_numpy(tokens), 3)
    assert got.shape == (DECODE.global_batch,) and got.dtype == torch.int32
    assert torch.equal(got, tsteps.argmax_first(tlog))
    w = np.asarray(wlog, np.float32)
    top2 = np.sort(w, -1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) / np.abs(w).max() > 2 * LOGIT_MAX
    np.testing.assert_array_equal(got.numpy()[sure], np.asarray(want)[sure])


def test_decode_matches_prefill_logits(dense):
    """test_arch_smoke's decode-vs-prefill case in the port (the cache is
    consistent), and each side against the reference."""
    _, rc, tc, rp, tp = dense
    toks = np.asarray(jax.random.randint(jax.random.key(1), (2, 16), 0, 200),
                      np.int32)
    nxt = toks[:, -1]
    cache, _ = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, 32)
    _, got = tlm.decode_step(tp, cache, torch.from_numpy(nxt), 16, {}, tc)
    full = np.concatenate([toks, nxt[:, None]], 1)
    _, want = tlm.prefill(tp, {"tokens": torch.from_numpy(full)}, tc, 32)
    np.testing.assert_allclose(got.float().numpy(),
                               want[:, 0].float().numpy(), atol=3e-2,
                               rtol=3e-2)
    _, rwant = rlm.prefill(rp, {"tokens": jnp.asarray(full)}, rc, PX,
                           cache_len=32)
    assert _row_err(want[:, 0], rwant[:, 0]).max() <= LOGIT_MAX


# --- package surfaces ----------------------------------------------------------


def test_core_names_cover_the_reference():
    assert set(repro.core.__all__) <= set(repro_torch.core.__all__)
    assert repro_torch.core.wire_cost is not None
    for name in repro.core.__all__:
        assert getattr(repro_torch.core, name) is not None, name


def test_core_legacy_names_stay_importable_outside_all():
    for legacy in ("run", "run_batch"):
        assert hasattr(repro_torch.core, legacy)
        assert legacy not in repro_torch.core.__all__
    from repro_torch.core import EngineConfig
    from repro_torch import random as trandom
    cfg = dataclasses.replace(EngineConfig(), timesteps=3)
    cfg = dataclasses.replace(cfg, abm=dataclasses.replace(
        cfg.abm, n_se=200, area=2000.0))
    with pytest.warns(DeprecationWarning, match="Engine"):
        st, _, counters = repro_torch.core.run(trandom.key(0), cfg, "cpu")
    want = repro_torch.core.Engine(cfg, device="cpu").run(seed=0)
    assert torch.equal(st["lp"], want[0]["lp"])
    assert counters == want[2]
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        for name in repro_torch.core.__all__:
            getattr(repro_torch.core, name)


#: the reference's package -> the names its __init__ exports
EXPORTS = {
    "checkpoint": ("CheckpointManager",),
    "optim": ("AdamWConfig", "adamw_init", "adamw_apply"),
    "parallel": ("ParallelCtx", "make_ctx", "ShardSpec", "make_shard_spec",
                 "run_sharded"),
    "data": ("DataConfig", "SyntheticLM", "make_pipeline"),
    "configs": ("get_arch", "get_smoke", "get_shape", "ARCHS", "SHAPES"),
}


@pytest.mark.parametrize("pkg", sorted(EXPORTS))
def test_package_names_cover_the_reference(pkg):
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    exported = {n for n in dir(ref) if not n.startswith("_")
                and not isinstance(getattr(ref, n), type(importlib))}
    assert set(EXPORTS[pkg]) <= exported
    for name in EXPORTS[pkg]:
        assert getattr(port, name) is not None, name
        want, got = getattr(ref, name), getattr(port, name)
        if isinstance(want, type):  # the same fields, by name
            assert isinstance(got, type), name
            if hasattr(want, "__dataclass_fields__"):
                assert list(want.__dataclass_fields__) == list(
                    got.__dataclass_fields__), name


def test_package_surfaces_work_from_the_package():
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_shape
    from repro_torch.data import DataConfig, SyntheticLM, make_pipeline
    from repro_torch.optim import AdamWConfig, adamw_apply, adamw_init
    from repro_torch.checkpoint import manager
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw
    assert CheckpointManager is manager.CheckpointManager
    assert (DataConfig, SyntheticLM, make_pipeline) == (
        pipeline.DataConfig, pipeline.SyntheticLM, pipeline.make_pipeline)
    assert (AdamWConfig, adamw_init, adamw_apply) == (
        adamw.AdamWConfig, adamw.adamw_init, adamw.adamw_apply)
    assert dataclasses.asdict(get_shape("train_4k")) == dataclasses.asdict(
        rcfg.get_shape("train_4k"))
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("train_8k")
    it = make_pipeline(DataConfig(vocab_size=50, seq_len=9,
                                  global_batch=2, seed=1))
    assert next(it)["tokens"].shape == (2, 9)
    it.close()


def test_parallel_names_cover_the_reference():
    import importlib
    ref = {n for n in dir(repro.parallel) if not n.startswith("_")
           and not isinstance(getattr(repro.parallel, n), type(importlib))}
    assert ref == {"ParallelCtx", "make_ctx", "ShardSpec",
                   "make_shard_spec", "run_sharded"}
    assert ref <= set(repro_torch.parallel.__all__)
    for name in ref:  # a dataclass has the reference's fields, in order
        want, got = (getattr(m, name) for m in (repro.parallel,
                                                repro_torch.parallel))
        if hasattr(want, "__dataclass_fields__"):
            assert list(want.__dataclass_fields__) == list(
                got.__dataclass_fields__), name


def test_run_sharded_is_the_engine_runner():
    from repro_torch import random as trandom
    from repro_torch.core import EngineConfig
    cfg = dataclasses.replace(EngineConfig(), timesteps=3, n_devices=2)
    cfg = dataclasses.replace(cfg, abm=dataclasses.replace(
        cfg.abm, n_se=200, area=2000.0))
    st, _, counters = repro_torch.parallel.run_sharded(trandom.key(0), cfg,
                                                       device="cpu")
    want = repro_torch.core.Engine(
        dataclasses.replace(cfg, sharding="lp_device"), device="cpu").run(
        seed=0)
    assert torch.equal(st["lp"], want[0]["lp"])
    assert counters == want[2]
