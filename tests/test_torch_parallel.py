"""The LM stack's parallelism held against the reference on the CPU, in
one process: the meshes, `ParallelCtx`, the sharding rules, the
optimizer-state and input specs of every registered architecture, the
blocks a spec gives each rank (against jax's own tiling), q8 compression
and DiLoCo, GPipe with one stage, the train step on a one-rank mesh,
`remat="dots"` and the MoE dispatch groups. The multi-rank cases run in
gloo processes, `tests/test_torch_parallel_ranks.py`.

The reference's specs need a mesh of the shape, which jax's
`AbstractMesh` gives without devices. Its jax mesh for tiling and for
the MoE groups needs Auto axes (its layouts are sharding constraints).
Float32 comparisons run in one REPRO_FORCE_F32=1 subprocess of this
file with four forced host devices: the loss of `remat="dots"` within
DOTS_TOL of the reference's `remat="dots"` and its gradients within
GRAD_TOL (relative to each leaf's largest value: the two frameworks'
float32 gradients of these smokes lie 1.6e-5 and 2.0e-5 apart under
any remat, while the reference's own "dots", "full" and "none" agree
within 6e-7; tests/test_torch_train.py holds the same comparison at
GRAD_TOL) and no further from the reference's "dots" than the port's
gradients are from the reference's "full", and `moe_fwd` in 2 dispatch groups where tokens
drop within MOE_TOL, with the same drops and group counts. Specs,
shapes, q8 and DiLoCo are bit-equal; a step on a one-rank mesh and
`remat="dots"` give the one-device `remat="full"` step's bits.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the card has no JAX: skip there

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as rcfg  # noqa: E402
from repro.launch import mesh as rmesh  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.optim import compress as rq8  # noqa: E402
from repro.optim import diloco as rdiloco  # noqa: E402
from repro.parallel import ctx as rctx  # noqa: E402
from repro.parallel import sharding as rsh  # noqa: E402

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import compress as tq8  # noqa: E402
from repro_torch.optim import diloco as tdiloco  # noqa: E402
from repro_torch.parallel import ctx as tctx  # noqa: E402
from repro_torch.parallel import pipeline as tpipe  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

torch.set_num_threads(1)
ARCHS = sorted(tcfg.ARCHS)
#: mesh shapes of the spec comparisons: a local one, a pod, two pods
MESHES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
DOTS_TOL = 1e-5
GRAD_TOL = 1e-4
MOE_TOL = 1e-5
DOTS_ARCHS = ("tinyllama-1.1b", "deepseek-v3-671b")


def _meshes(shape):
    names = MESHES[shape]
    return AbstractMesh(shape, names), tmesh.Mesh(shape, names)


@functools.lru_cache(maxsize=None)
def _ref_sds(arch):
    return rsteps._param_sds(rcfg.get_arch(arch))


@functools.lru_cache(maxsize=None)
def _port_sds(arch):
    return tsteps._param_sds(tcfg.get_arch(arch))


def _ref_flat(t):
    """{path of dict keys: leaf} of a jax tree, specs as tuples."""
    P = jax.sharding.PartitionSpec
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            t, is_leaf=lambda x: isinstance(x, P)):
        key = tuple(str(k.key) for k in path)
        out[key] = tuple(leaf) if isinstance(leaf, P) else leaf
    return out


def _port_flat(t, path=()):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_port_flat(v, path + (str(k),)))
        return out
    return {path: tuple(t) if isinstance(t, tctx.P) else t}


def _dt(d):
    return str(d).split(".")[-1]


# --- shapes, specs ------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_reference(arch):
    ref, port = _ref_flat(_ref_sds(arch)), _port_flat(_port_sds(arch))
    assert ref.keys() == port.keys()
    for k in ref:
        assert tuple(ref[k].shape) == tuple(port[k].shape), k
        assert _dt(ref[k].dtype) == _dt(port[k].dtype), k
        assert port[k].device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    rs, ps = _ref_sds(arch), _port_sds(arch)
    for shape in MESHES:
        rm, pm = _meshes(shape)
        for fsdp in (False, True):
            for ep2d in (False, True):
                want = rsh.param_specs(rs, rctx.make_ctx(
                    rm, fsdp=fsdp, ep2d=ep2d))
                got = tsh.param_specs(ps, tctx.make_ctx(
                    pm, fsdp=fsdp, ep2d=ep2d))
                assert _port_flat(got) == _ref_flat(want), (shape, fsdp,
                                                            ep2d)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_equal_reference(arch):
    rs, ps = _ref_sds(arch), _port_sds(arch)
    for shape in MESHES:
        rm, pm = _meshes(shape)
        rpx, ppx = rctx.make_ctx(rm), tctx.make_ctx(pm)
        rp, pp = rsh.param_specs(rs, rpx), tsh.param_specs(ps, ppx)
        for zero1 in (False, True):
            for factored, lean in ((False, False), (True, False),
                                   (True, True)):
                want = rsh.opt_specs(rp, rs, rpx, zero1=zero1,
                                     factored=factored, lean=lean)
                got = tsh.opt_specs(pp, ps, ppx, zero1=zero1,
                                    factored=factored, lean=lean)
                assert _port_flat(got) == _ref_flat(want), (
                    shape, zero1, factored, lean)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    rc, pc = rcfg.get_arch(arch), tcfg.get_arch(arch)
    for name, shape in tcfg.SHAPES.items():
        rshape = rcfg.SHAPES[name]
        for mshape in MESHES:
            rm, pm = _meshes(mshape)
            rsds, rspec = rspecs.input_specs(rc, rshape, rctx.make_ctx(rm))
            psds, pspec = tspecs.input_specs(pc, shape, tctx.make_ctx(pm))
            assert _port_flat(pspec) == _ref_flat(rspec), (name, mshape)
            want, got = _ref_flat(rsds), _port_flat(psds)
            assert want.keys() == got.keys()
            for k in want:
                assert tuple(want[k].shape) == tuple(got[k].shape), k
                assert _dt(want[k].dtype) == _dt(got[k].dtype), k
                assert got[k].device.type == "meta"


def test_zero1_adds_data_axis():
    """The reference's tier-1 case (tests/test_parallel.py:73-93)."""
    px = tctx.make_ctx(tmesh.Mesh((2, 4), ("data", "model")))
    assert tsh.zero1_spec(tctx.P(None, "model"), (64, 8), px) == \
        tctx.P("data", "model")
    assert tsh.zero1_spec(tctx.P(), (7, 3), px) == tctx.P()
    assert tctx.P() == () and tctx.P(None) != tctx.P()


def test_to_shardings_without_a_mesh_is_none():
    assert tsh.to_shardings({"w": tctx.P()}, tctx.make_ctx(None)) is None
    px = tctx.make_ctx(tmesh.Mesh((2, 4), ("data", "model")))
    sh = tsh.to_shardings({"w": tctx.P("data")}, px)["w"]
    assert sh.spec == ("data",) and sh.mesh is px.mesh
    assert px.sharding("data", None).spec == ("data", None)


# --- the context and the meshes -----------------------------------------------


def test_ctx_fields_and_defaults_equal_reference():
    rf = dataclasses.fields(rctx.ParallelCtx)
    pf = dataclasses.fields(tctx.ParallelCtx)
    assert [f.name for f in rf] == [f.name for f in pf]
    assert [f.default for f in rf] == [f.default for f in pf]
    assert rctx.make_ctx(None) == rctx.ParallelCtx(None, (), None)
    assert dataclasses.asdict(tctx.make_ctx(None)) == {
        f.name: getattr(rctx.make_ctx(None), f.name) for f in rf}


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_ctx_methods_equal_reference(shape):
    rm, pm = _meshes(shape)
    r, p = rctx.make_ctx(rm), tctx.make_ctx(pm)
    assert (r.batch_axes, r.model_axis) == (p.batch_axes, p.model_axis)
    assert (r.data_size, r.model_size, r.ep_axes) == (
        p.data_size, p.model_size, p.ep_axes)
    assert p.n_devices == math.prod(shape)
    entries = [None, "data", "model", ("data", "model")] + (
        [("pod", "data"), "pod"] if "pod" in MESHES[shape] else [])
    for e in entries:
        assert r.axis_size(e) == p.axis_size(e), e
        for d in (1, 2, 3, 8, 12, 16, 32, 48, 256, 512):
            assert r.shard_if(d, e) == p.shard_if(d, e), (d, e)
    for n in (1, 2, 3, 4, 8, 16, 24, 32, 64, 128, 256, 512, 1024, 32768):
        assert r.batch_spec(n) == p.batch_spec(n), n
        assert r.seq_entry(n) == p.seq_entry(n), n
        assert r.seq_mega_spec(n) == p.seq_mega_spec(n), n
    x = torch.zeros(2, 3)
    assert p.constrain(x, "data", None) is x
    with pytest.raises(AssertionError):
        p.constrain(x, "data")
    q = tctx.make_ctx(None)
    assert q.constrain(x, "data") is x  # no mesh: no check, as there
    assert q.batch_spec(8) is None and q.sharding("data") is None


def test_make_ctx_and_meshes_refuse_as_the_reference():
    with pytest.raises(ValueError, match="unrecognized mesh axes"):
        rctx.make_ctx(AbstractMesh((2,), ("x",)))
    with pytest.raises(ValueError, match="unrecognized mesh axes"):
        tctx.make_ctx(tmesh.Mesh((2,), ("x",)))
    for multi in (False, True):
        for tp in (1, 4, 16, 64):
            m = tmesh.make_production_mesh(multi_pod=multi, tp=tp)
            want = ((2,) if multi else ()) + (256 // tp, tp)
            assert tuple(m.shape.values()) == want
            assert m.axis_names == (("pod",) if multi else ()) + (
                "data", "model")
            assert not m.live and m.size == math.prod(want)
    with pytest.raises(AssertionError):
        rmesh.make_production_mesh(tp=3)
    with pytest.raises(AssertionError):
        tmesh.make_production_mesh(tp=3)
    have = len(jax.devices())
    with pytest.raises(ValueError, match=f"need {2 * have} devices, have "
                       f"{have}"):
        rmesh.make_local_mesh(2, have)
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        tmesh.make_local_mesh(2, 2)
    one = tmesh.make_local_mesh()  # one rank, no process group
    assert one.live and not one.distributed and one.size == 1
    assert one.group("data") is None and one.index("data") == 0


# --- blocks --------------------------------------------------------------------


@pytest.mark.parametrize("spec", [("data", "model"), (("data", "model"),),
                                  (None, ("model", "data")), ("model",),
                                  (None, "data"), ()])
def test_blocks_tile_as_named_sharding(spec):
    """block_of gives each rank of a (2, 2) mesh the block jax's
    NamedSharding places on the device at its coordinates."""
    auto = jax.sharding.AxisType.Auto
    jm = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto),
                       devices=jax.devices()[:4])
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    placed = jax.device_put(x, jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(*spec)))
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    mesh = tmesh.Mesh((2, 2), ("data", "model"))
    held = 0
    for shard in placed.addressable_shards:
        c = where[shard.device.id]
        px = tctx.make_ctx(mesh.at(c[0] * 2 + c[1]))
        got = tsh.block_of(torch.from_numpy(x), tctx.P(*spec), px)
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
        held += got.numel()
    n = math.prod(px.axis_size(e) for e in spec)
    assert held == x.size * 4 // n  # every rank 1 / n of the leaf


def test_reblock_and_owners():
    mesh = tmesh.Mesh((2, 2), ("data", "model"))
    x = torch.arange(48.0).reshape(4, 12)
    src, dst = tctx.P(None, "model"), tctx.P("data", "model")
    owners = []
    for r in range(4):
        px = tctx.make_ctx(mesh.at(r))
        got = tsh.reblock(tsh.block_of(x, src, px), src, dst, px)
        assert torch.equal(got, tsh.block_of(x, dst, px))
        owners.append((tsh.owns(src, px), tsh.owns(dst, px),
                       tsh.owns(tctx.P(), px)))
    # a block held by both data ranks counted once; P() on rank 0 alone
    assert owners == [(True, True, True), (True, True, False),
                      (False, True, False), (False, True, False)]
    with pytest.raises(ValueError, match="cannot take dim"):
        tsh.reblock(x, tctx.P("data"), tctx.P("model"), px)


def test_shard_and_gather_without_a_process_group():
    px = tctx.make_ctx(tmesh.make_local_mesh(1, 1))
    t = {"a": torch.randn(4, 6), "b": [torch.arange(3.0)]}
    specs = {"a": tctx.P("data", "model"), "b": [tctx.P()]}
    held = tsh.shard_tree(t, specs, px)
    back = tsh.gather_tree(held, specs, px)
    assert torch.equal(back["a"], t["a"]) and torch.equal(back["b"][0],
                                                          t["b"][0])


# --- q8 compression and DiLoCo --------------------------------------------------


@pytest.mark.parametrize("shape", [(1000,), (256,), (7,), (3, 300),
                                   (2, 5, 129)])
def test_q8_bit_equal_reference(shape):
    r = np.random.default_rng(sum(shape))
    x = (r.normal(size=shape) * 10 ** r.uniform(-3, 2)).astype(np.float32)
    x.reshape(-1)[::17] = 0.0
    rq, rs = rq8.quantize_q8(jnp.asarray(x))
    pq, ps = tq8.quantize_q8(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        tq8.dequantize_q8(pq, ps, shape).numpy(),
        np.asarray(rq8.dequantize_q8(rq, rs, shape)))


def test_q8_ties_round_half_to_even():
    x = np.zeros(256, np.float32)
    x[0] = 127.0  # scale 1: the entries below are exact halves
    x[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    q, _ = tq8.quantize_q8(torch.from_numpy(x))
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_ef_q8_step_one_pod_bit_equal_reference():
    r = np.random.default_rng(4)
    g = r.normal(size=(3, 100)).astype(np.float32)
    e = (r.normal(size=(3, 100)) * 1e-3).astype(np.float32)
    want = jax.vmap(lambda a, b: rq8.ef_q8_step(a, b, "pod", 1),
                    axis_name="pod")(jnp.asarray(g)[None],
                                     jnp.asarray(e)[None])
    got = tq8.ef_q8_step(torch.from_numpy(g), torch.from_numpy(e), None, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[0])


def test_q8_roundtrip_error_bounded():
    """tests/test_optim.py's case, on the port."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=1000).astype(np.float32) * 3)
    q, s = tq8.quantize_q8(x)
    y = tq8.dequantize_q8(q, s, x.shape)
    assert float((x - y).abs().max()) <= float(s.max()) / 2 + 1e-6


def test_error_feedback_accumulates_residual():
    """tests/test_optim.py's case, on the port: plain q8 transmits 0 for
    the small entries of a block with an outlier; EF recovers them."""
    g = torch.full((256,), 1e-4)
    g[0] = 0.1
    q0, s0 = tq8.quantize_q8(g)
    assert float(tq8.dequantize_q8(q0, s0, g.shape)[1:].max()) == 0.0
    e, total, steps = torch.zeros_like(g), torch.zeros_like(g), 200
    for _ in range(steps):
        mean, e = tq8.ef_q8_step(g, e, None, 1)
        total = total + mean
    np.testing.assert_allclose(total[1:].numpy() / steps, g[1:].numpy(),
                               rtol=0.1)


def test_diloco_outer_step_bit_equal_reference():
    r = np.random.default_rng(5)
    shapes = {"w": (4, 3), "b": (3,)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg_r, cfg_p = rdiloco.DiLoCoConfig(), tdiloco.DiLoCoConfig()
    assert dataclasses.asdict(cfg_r) == dataclasses.asdict(cfg_p)
    rs = rdiloco.diloco_init(jax.tree.map(jnp.asarray, p0))
    ps = tdiloco.diloco_init(tree.tree_map(torch.from_numpy, p0))
    for _ in range(3):
        mean = {k: r.normal(size=s).astype(np.float32)
                for k, s in shapes.items()}
        rs, rg = rdiloco.outer_step(cfg_r, rs, jax.tree.map(jnp.asarray,
                                                            mean))
        ps, pg = tdiloco.outer_step(cfg_p, ps, tree.tree_map(
            torch.from_numpy, mean))
        for k in shapes:
            np.testing.assert_array_equal(pg[k].numpy(), np.asarray(rg[k]))
            np.testing.assert_array_equal(ps["velocity"][k].numpy(),
                                          np.asarray(rs["velocity"][k]))


def test_diloco_outer_moves_toward_pod_mean():
    st = tdiloco.diloco_init({"w": torch.zeros(3)})
    cfg = tdiloco.DiLoCoConfig(outer_lr=0.7, outer_momentum=0.0)
    _, new = tdiloco.outer_step(cfg, st, {"w": torch.ones(3)})
    np.testing.assert_allclose(new["w"].numpy(), [0.7] * 3, rtol=1e-6)


def test_diloco_momentum_accelerates():
    cfg_m = tdiloco.DiLoCoConfig(outer_lr=0.3, outer_momentum=0.9)
    cfg_0 = tdiloco.DiLoCoConfig(outer_lr=0.3, outer_momentum=0.0)
    sm = s0 = tdiloco.diloco_init({"w": torch.zeros(1)})
    for _ in range(3):  # the pods keep agreeing on +1 from the start
        sm, gm = tdiloco.outer_step(cfg_m, sm, {"w": sm["global"]["w"] + 1})
        s0, g0 = tdiloco.outer_step(cfg_0, s0, {"w": s0["global"]["w"] + 1})
    assert float(gm["w"]) > float(g0["w"]) > 0


def test_optim_exports_the_reference_names():
    import repro.optim
    import repro_torch.optim
    names = {n for n in dir(repro.optim) if not n.startswith("_")
             and not isinstance(getattr(repro.optim, n), type(repro))}
    assert names <= set(dir(repro_torch.optim))


# --- GPipe, the step on a one-rank mesh, TrainCtx -------------------------------


def test_gpipe_one_stage_is_the_sequential_run():
    W = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8, 8)).astype(np.float32))
    xs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 2, 8)).astype(np.float32))
    pipe = tpipe.gpipe(lambda w, x: torch.tanh(x @ w),
                       tmesh.Mesh((1,), ("pod",)), "pod", 4)
    want = torch.stack([torch.tanh(x @ W[0]) for x in xs])
    assert torch.equal(pipe(W, xs), want)


def _one_step(arch, px, seed=0):
    cfg = tcfg.get_smoke(arch)
    shape = ShapeConfig("t", 16, 4, "train")
    params = tlm.init_params(torch.Generator().manual_seed(seed), cfg)
    opt = tsteps.opt_init(px)(params)
    if px.mesh is not None:
        params, opt = tsteps.shard_state(cfg, px, params, opt)
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (4, 16)).astype(
        np.int32), "loss_mask": (r.random((4, 16)) > 0.2).astype(np.float32)}
    if cfg.encoder_decoder:
        batch["frames"] = torch.from_numpy(r.normal(size=(
            4, 16, 1024)).astype(np.float32)).to(tlm.COMPUTE_DT)
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = torch.from_numpy(r.normal(size=(
            4, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)).to(
                tlm.COMPUTE_DT)
    p2, o2, e2, m = tsteps.build_train_step(cfg, shape, px)(
        params, opt, tlm.init_extras(cfg, "cpu"), batch)
    return p2, o2, e2, m


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v3-671b", "rwkv6-1.6b",
                                  "zamba2-1.2b", "seamless-m4t-medium",
                                  "internvl2-2b"])
def test_one_rank_mesh_step_is_the_one_device_step(arch):
    """zero1 and fsdp on a (1, 1) mesh: every block is the whole leaf, so
    the step is the mesh-less one bit for bit."""
    knobs = dict(num_microbatches=2, loss_chunk=8)
    want = _one_step(arch, tctx.make_ctx(None, **knobs))
    got = _one_step(arch, tctx.make_ctx(tmesh.make_local_mesh(1, 1),
                                        zero1=True, fsdp=True, **knobs))
    for a, b in zip(tree.leaves(got[:3]), tree.leaves(want[:3])):
        assert torch.equal(a, b)
    assert {k: float(v) for k, v in got[3].items()} == {
        k: float(v) for k, v in want[3].items()}


def test_trainctx_is_make_ctx_none():
    px = tsteps.TrainCtx(num_microbatches=2, remat="dots")
    assert isinstance(px, tctx.ParallelCtx) and px.mesh is None
    assert px == tctx.make_ctx(None, num_microbatches=2, remat="dots")
    for bad in ({"optimizer": "sgd"}, {"grad_dtype": "f16"},
                {"remat": "some"}):
        with pytest.raises(ValueError):
            tsteps.TrainCtx(**bad)
    with pytest.raises(ValueError):
        tsteps.build_train_step(tcfg.get_smoke("yi-9b"),
                                ShapeConfig("t", 16, 4, "train"),
                                tctx.make_ctx(None, remat="some"))
    with pytest.raises(TypeError):
        tsteps.TrainCtx(mesh_axes=2)


def test_adafactor_refused_on_a_mesh_of_several_devices():
    px = tctx.make_ctx(tmesh.Mesh((2, 1), ("data", "model")),
                       optimizer="adafactor")
    with pytest.raises(NotImplementedError, match="adamw"):
        tsteps.build_train_step(tcfg.get_smoke("yi-9b"),
                                ShapeConfig("t", 16, 4, "train"), px)


@pytest.mark.parametrize("mesh", ["bare", "production", "at"])
def test_step_refuses_a_mesh_without_a_process_group(mesh):
    """A mesh of several devices that no `torch.distributed` world spans
    would cut blocks it never gathers: the step refuses it."""
    m = {"bare": lambda: tmesh.Mesh((2, 1), ("data", "model")),
         "production": lambda: tmesh.make_production_mesh(),
         "at": lambda: tmesh.Mesh((2, 2), ("data", "model")).at(3)}[mesh]()
    with pytest.raises(ValueError, match="process group"):
        tsteps.build_train_step(tcfg.get_smoke("yi-9b"),
                                ShapeConfig("t", 16, 4, "train"),
                                tctx.make_ctx(m))


# --- remat="dots" ----------------------------------------------------------------


def _loss_and_grads(arch, remat, seed=3):
    cfg = tcfg.get_smoke(arch)
    params = tlm.init_params(torch.Generator().manual_seed(seed), cfg)
    preq = tree.tree_map(lambda t: t.detach().requires_grad_(), params)
    r = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(r.integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)),
        "loss_mask": torch.ones(2, 16)}
    if cfg.encoder_decoder:
        batch["frames"] = torch.from_numpy(r.normal(size=(
            2, 16, 1024)).astype(np.float32)).to(torch.bfloat16)
    loss_fn = tsteps.model_fns(cfg)[0]
    loss, _ = loss_fn(preq, batch, tlm.init_extras(cfg, "cpu"), cfg,
                      loss_chunk=8, remat=remat)
    return loss, torch.autograd.grad(loss, tree.leaves(preq))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b",
                                  "rwkv6-1.6b", "seamless-m4t-medium"])
def test_dots_gives_the_bits_of_full(arch):
    """Remat changes what is kept, not what is computed: "dots", "full"
    and "none" give the same loss and gradients (the encoder-decoder
    checkpoints whole blocks under any remat, as the reference's)."""
    loss, grads = _loss_and_grads(arch, "dots")
    for other in ("full", "none"):
        l2, g2 = _loss_and_grads(arch, other)
        assert torch.equal(loss, l2)
        assert all(torch.equal(a, b) for a, b in zip(grads, g2))


def test_dots_keeps_the_products():
    """Under "dots" the backward recomputes no matrix product: the
    forward's mm/bmm count is the whole pass's, where "full" does them
    again."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in tlm.DOTS:
                seen.append(func)
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "full", "dots"):
        seen.clear()
        with Count():
            _loss_and_grads("tinyllama-1.1b", remat)
        counts[remat] = len(seen)
    assert counts["full"] > counts["none"]
    assert counts["dots"] == counts["none"]


# --- float32, in a subprocess --------------------------------------------------


@pytest.fixture(scope="module")
def f32():
    """The float32 comparisons, computed once in a REPRO_FORCE_F32=1
    subprocess of this file (four forced host devices)."""
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, REPRO_FORCE_F32="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, __file__], check=True,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", DOTS_ARCHS)
def test_dots_equals_the_references_dots(f32, arch):
    r = f32["dots"][arch]
    assert r["dtype"] == "float32"
    assert r["loss_rel"] <= DOTS_TOL, r
    assert r["n_grads"] == r["n_ref_grads"] > 0
    gap = max(r["grad_rel"].values())
    assert gap <= GRAD_TOL, r["grad_rel"]
    assert gap <= r["full_gap"] + 1e-6, (gap, r["full_gap"])
    assert r["full_bit_equal"], r


def test_moe_groups_equal_the_references_groups(f32):
    r = f32["moe_groups"]
    assert r["dropped"] == r["ref_dropped"] > 0, r
    assert r["group_counts_equal"] and r["n_groups"] == 2, r
    assert r["out_rel"] <= MOE_TOL, r
    # the groups matter: one group drops other slots
    assert r["one_group_dropped"] != r["dropped"], r


def _child():
    """Body of the float32 subprocess: prints one JSON line."""
    from repro.models import lm as rlm
    from repro.models import moe as rmoe
    from repro.configs.base import MoEConfig as RMoE
    from repro_torch.configs.base import MoEConfig as TMoE
    from repro_torch.models import convert
    from repro_torch.models import moe as tmoe

    def rel(got, want):
        got = got.detach().float().numpy() if torch.is_tensor(got) else got
        want = np.asarray(want, np.float32)
        return float(np.abs(got - want).max()
                     / max(np.abs(want).max(), 1e-30))

    res = {"dots": {}}
    for arch in DOTS_ARCHS:
        rc, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
        rp = rlm.init_params(jax.random.key(1), rc)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, rp))
        toks = np.random.default_rng(3).integers(
            0, rc.vocab_size, (2, 19)).astype(np.int32)
        batch = {"tokens": toks, "loss_mask": np.ones((2, 19), np.float32)}
        re = rlm.init_extras(rc)

        def ref(remat):
            rpx = rctx.make_ctx(None, loss_chunk=8, remat=remat)
            return jax.value_and_grad(
                lambda p: rlm.loss_fn(p, jax.tree.map(jnp.asarray, batch),
                                      re, rc, rpx), has_aux=True)(rp)

        (rloss, _), rg = ref("dots")
        rg_full = jax.tree.leaves(ref("full")[1])
        out = {}
        for remat in ("dots", "full"):
            preq = tree.tree_map(lambda t: t.detach().requires_grad_(), tp)
            tloss, _ = tlm.loss_fn(
                preq, {k: torch.from_numpy(v) for k, v in batch.items()},
                convert.params_from_numpy(jax.tree.map(np.asarray, re)), tc,
                loss_chunk=8, remat=remat)
            out[remat] = (tloss, torch.autograd.grad(tloss,
                                                     tree.leaves(preq)))
        tloss, tg = out["dots"]
        rgl = jax.tree.leaves(rg)
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_leaves_with_path(rg)]
        res["dots"][arch] = {
            "dtype": _dt(tloss.dtype), "loss_rel": rel(tloss, rloss),
            "n_grads": len(tg), "n_ref_grads": len(rgl),
            "grad_rel": {p: rel(g, w) for p, g, w in zip(paths, tg, rgl)},
            "full_gap": max(rel(g, w) for g, w in zip(out["full"][1],
                                                        rg_full)),
            "full_bit_equal": bool(torch.equal(tloss, out["full"][0]) and all(
                torch.equal(a, b) for a, b in zip(tg, out["full"][1])))}

    # the MoE dispatch in 2 groups (a (2, 2) mesh, batch over "data")
    # where tokens drop, against the reference on 4 host devices
    kw = dict(num_experts=8, top_k=2, d_expert=16, capacity_factor=0.6)
    rm, tm = RMoE(**kw), TMoE(**kw)
    rp = rmoe.init_moe(jax.random.key(0), 32, rm)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, rp))
    x = (np.random.default_rng(6).normal(size=(4, 8, 32)) * 0.5).astype(
        np.float32)
    auto = jax.sharding.AxisType.Auto
    jm = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
    rout, rmet = jax.jit(lambda p_, x_: rmoe.moe_fwd(
        p_, x_, m=rm, px=rctx.make_ctx(jm), batch_entry="data"))(
        rp, jnp.asarray(x))
    px = tctx.make_ctx(tmesh.Mesh((2, 2), ("data", "model")))
    tout, tmet = tmoe.moe_fwd(tp, torch.from_numpy(x), m=tm, px=px,
                              batch_entry="data")
    _, one = tmoe.moe_fwd(tp, torch.from_numpy(x), m=tm)
    res["moe_groups"] = {
        "out_rel": rel(tout, rout), "dropped": int(tmet["moe_dropped"]),
        "ref_dropped": int(rmet["moe_dropped"]),
        "n_groups": int(tmet["group_expert_counts"].shape[0]),
        "group_counts_equal": bool(np.array_equal(
            tmet["group_expert_counts"].numpy(),
            np.asarray(rmet["group_expert_counts"]))),
        "one_group_dropped": int(one["moe_dropped"])}
    print(json.dumps(res))


if __name__ == "__main__":
    torch.set_num_threads(1)
    _child()
