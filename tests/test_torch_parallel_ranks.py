"""The LM stack's parallelism across `torch.distributed` processes (gloo,
on the CPU): four ranks on a (2, 2) ("data", "model") mesh, spawned once
for every case, in float32 (REPRO_FORCE_F32=1), beside one process of
the reference on a (2, 2) mesh of forced host devices.

The train steps run AdamW at LINEAR_OPT: no clip, no weight decay and
an eps far above every |g|, so that the first step moves each weight by
lr * g / (|g| + eps), about LINEAR_GAIN * g. The update is then the
gradient, scaled: a gradient off by a constant factor, or one summed
over too few or too many ranks, moves the weights by another amount
(at the default config the first step is lr * sign(g) after the clip
has normalised g, which such a gradient leaves as it is). The updates
are also far above the weights' float32 ULPs, so the comparison reads
the gradients' own rounding.

- yi-9b's and deepseek-v3's smokes (MLA, MoE, MTP; a capacity at which
  nothing drops) and zamba2's (the shared block outside the layer
  stack): one (2, 2) train step, with zero1, with zero1 off and with
  fsdp, equals the port's one-device step: the loss within
  LOSS_REL relative, the clipping norm of the whole gradient within
  NORM_REL relative, and every parameter within UPDATE_SHARE of its
  leaf's largest |update|. yi-9b's loss also equals the reference's
  one-device loss within REF_LOSS_BAR, the reference's own bar for its
  mesh.
- qwen3-moe's smoke at a capacity where tokens drop: the port's (2, 2)
  step equals the reference's (2, 2) step (each data rank's group drops
  its own slots), both at LINEAR_OPT: every leaf's update within the
  train tests' GRAD_TOL of that leaf's largest |update|, the loss and
  the gradient's norm within their float32 tolerances, the same dropped
  count and `router_bias` exact.
- `gpipe` over 4 stages equals the sequential stages within 1e-5;
  `q8_cross_pod_mean` over 2 pods is bit-equal to the reference's mean
  (two terms: the sum is exact) with the residual within one
  quantisation step; `moe_fwd` with `ep2d` off and on agree within the
  reference's 0.03 / 0.05 and hold the expert weights' blocks the specs
  give; `shard_tree` then `gather_tree` is the identity, one rank
  holding 1/n of a leaf sharded n ways.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.parallel import multihost  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
LOSS_REL, NORM_REL, UPDATE_SHARE = 1e-6, 1e-5, 1e-5
REF_LOSS_BAR = 0.05
#: the train tests' float32 tolerances (tests/test_torch_train.py)
REF_LOSS_REL, REF_NORM_REL, GRAD_TOL = 1e-5, 1e-4, 1e-4
#: AdamW whose first step is LINEAR_GAIN * g / (1 + |g| / LINEAR_EPS)
LINEAR_EPS, LINEAR_GAIN = 1e3, 1e3
LINEAR_OPT = dict(lr=LINEAR_EPS * LINEAR_GAIN, eps=LINEAR_EPS,
                  weight_decay=0.0, clip_norm=float("inf"), warmup_steps=1)
SEQ, ROWS = 32, 4
#: arch -> (capacity factor or None, microbatches, loss_chunk, variants)
STEP_CASES = {
    "yi-9b": (None, 2, 0, ({}, {"zero1": False}, {"fsdp": True})),
    "deepseek-v3-671b": (16.0, 2, 8, ({}, {"fsdp": True})),
    "zamba2-1.2b": (None, 2, 8, ({"fsdp": True},)),
}
DROP_ARCH, DROP_CAPACITY = "qwen3-moe-30b-a3b", 0.5


def _cfg(arch, capacity):
    import dataclasses
    from repro_torch.configs import get_smoke
    cfg = get_smoke(arch)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return cfg


def _params(cfg, seed=0):
    from repro_torch.models import lm
    return lm.init_params(torch.Generator().manual_seed(seed), cfg)


def _batch(cfg, seed=1):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(
        np.int32), "loss_mask": (r.random((ROWS, SEQ)) > 0.25).astype(
            np.float32)}


def _leaves_np(t):
    from repro_torch import tree
    return [x.detach().float().numpy() for x in tree.leaves(t)]


# --- one rank ----------------------------------------------------------------


def _rank_main(rank, out):
    """Every case on this rank; writes out/rank{r}.json (and rank 0 the
    qwen3-moe step's params, for the reference's)."""
    from repro_torch import tree
    from repro_torch.configs.base import MoEConfig, ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh, make_local_mesh
    from repro_torch.models import lm, moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import q8_cross_pod_mean
    from repro_torch.parallel import pipeline, sharding
    from repro_torch.parallel.ctx import P, make_ctx
    torch.set_num_threads(1)
    res = {"rank": rank}
    mesh = make_local_mesh(2, 2)
    shape = ShapeConfig("t", SEQ, ROWS, "train")

    def step(cfg, px, params, extras, batch):
        fn = steps.build_train_step(cfg, shape, px,
                                    AdamWConfig(**LINEAR_OPT))
        p = tree.tree_map(lambda t: t.clone(), params)
        o = steps.opt_init(px)(p)
        if px.mesh is not None:
            p, o = steps.shard_state(cfg, px, p, o)
        p2, _, e2, m = fn(p, o, dict(extras), batch)
        if px.mesh is not None:
            p2 = sharding.gather_tree(p2, steps.train_specs(cfg, px)[0], px)
        return p2, e2, {k: float(v) for k, v in m.items()}

    # 1, 2: the (2, 2) train steps against the one-device step
    res["steps"] = {}
    for arch, (cap, M, chunk, variants) in STEP_CASES.items():
        cfg = _cfg(arch, cap)
        params, batch = _params(cfg), _batch(cfg)
        extras = lm.init_extras(cfg, "cpu")
        kw = dict(num_microbatches=M, loss_chunk=chunk)
        one_p, one_e, one_m = step(cfg, make_ctx(None, **kw), params,
                                   extras, batch)
        # each leaf's largest |update| in the one-device step
        upd = [float(np.abs(a - b).max()) for a, b in
               zip(_leaves_np(one_p), _leaves_np(params))]
        w = max(float(np.abs(a).max()) for a in _leaves_np(params))
        for v in variants:
            p2, e2, m = step(cfg, make_ctx(mesh, **kw, **v), params, extras,
                             batch)
            err = [float(np.abs(a - b).max()) for a, b in
                   zip(_leaves_np(p2), _leaves_np(one_p))]
            r = {"loss": m["loss"], "one_loss": one_m["loss"],
                 "leaf_share": max(e / u for e, u in zip(err, upd)),
                 "least_update": min(upd), "weights": w,
                 "grad_norm": m["grad_norm"],
                 "one_grad_norm": one_m["grad_norm"]}
            if cfg.moe is not None:
                r["dropped"] = m["moe_dropped"]
                r["one_dropped"] = one_m["moe_dropped"]
                r["bias_equal"] = bool(torch.equal(e2["router_bias"],
                                                   one_e["router_bias"]))
            res["steps"][f"{arch}/{json.dumps(v, sort_keys=True)}"] = r

    # 3: qwen3-moe where tokens drop, for the reference's (2, 2) step
    cfg = _cfg(DROP_ARCH, DROP_CAPACITY)
    p2, e2, m = step(cfg, make_ctx(mesh), _params(cfg), lm.init_extras(
        cfg, "cpu"), _batch(cfg))
    res["drop"] = m
    if rank == 0:
        np.savez(os.path.join(out, "drop_params.npz"),
                 *_leaves_np(p2), router_bias=e2["router_bias"].numpy())
        np.savez(os.path.join(out, "drop_start.npz"),
                 *_leaves_np(_params(cfg)))

    # 4: GPipe over 4 stages
    pmesh = Mesh((4,), ("pod",), live=True)
    r = np.random.default_rng(0)
    Ws = torch.from_numpy((r.normal(size=(4, 16, 16)) * 0.3).astype(
        np.float32))
    xs = torch.from_numpy(r.normal(size=(8, 2, 16)).astype(np.float32))

    def stage_fn(W, x):
        return torch.tanh(x @ W)

    got = pipeline.gpipe(stage_fn, pmesh, "pod", 8)(Ws[rank:rank + 1], xs)
    want = xs
    for i in range(4):
        want = torch.stack([stage_fn(Ws[i], x) for x in want])
    res["gpipe_err"] = float((got - want).abs().max())

    # 5: the q8 mean over 2 pods (pods x data = 2 x 2)
    qmesh = Mesh((2, 2), ("pod", "data"), live=True)
    pod = qmesh.coords["pod"]
    g = np.random.default_rng(3).normal(size=(2, 3, 300)).astype(np.float32)
    mean, new_e = q8_cross_pod_mean(
        {"w": torch.from_numpy(g[pod:pod + 1])},
        {"w": torch.zeros((1, 3, 300))}, qmesh, "pod")
    res["q8_mean"] = mean["w"][0].numpy().tolist()
    res["q8_err"] = new_e["w"][0].numpy().tolist()

    # 6: moe_fwd with ep2d off and on
    m_cfg = MoEConfig(num_experts=8, top_k=2, d_expert=16,
                      capacity_factor=8.0)
    pm = moe.init_moe(torch.Generator().manual_seed(5), 32, m_cfg)
    x = torch.from_numpy((np.random.default_rng(6).normal(
        size=(4, 8, 32)) * 0.5).astype(np.float32))
    one = moe.moe_fwd(pm, x, m=m_cfg)[0]
    outs, blocks = {}, {}
    for flag in (False, True):
        px = make_ctx(mesh, ep2d=flag)
        i = px.index("data")
        y, met = moe.moe_fwd(pm, x[2 * i:2 * i + 2], m=m_cfg, px=px,
                             batch_entry="data")
        outs[flag] = px.row_gather(y, "data").reshape(4, 8, 32)
        spec = sharding.param_specs({"moe": pm}, px)["moe"]
        blocks[flag] = {k: sharding.shard_tree(pm[k], spec[k], px).numel()
                        for k in ("w_gate", "w_up", "w_down")}
        res[f"moe_dropped_{flag}"] = int(met["moe_dropped"])
    res["ep2d_close"] = bool(np.allclose(outs[False].numpy(),
                                         outs[True].numpy(), atol=0.03,
                                         rtol=0.05))
    res["ep2d_err"] = float((outs[False] - outs[True]).abs().max())
    res["moe_one_err"] = float((outs[False] - one).abs().max())
    res["expert_numel"] = {str(k): v for k, v in blocks.items()}
    res["expert_total"] = pm["w_gate"].numel()

    # 7: shard_tree then gather_tree
    px = make_ctx(mesh)
    whole = {"a": torch.randn(8, 6, generator=torch.Generator().manual_seed(
        7)), "b": torch.arange(12.0), "c": torch.tensor(3.0)}
    specs = {"a": P("data", "model"), "b": P(("data", "model")), "c": P()}
    held = sharding.shard_tree(whole, specs, px)
    back = sharding.gather_tree(held, specs, px)
    res["round_trip"] = all(torch.equal(back[k], whole[k]) for k in whole)
    res["held"] = {k: held[k].numel() for k in held}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


WORKER = """
import sys, torch, torch.distributed as dist
rank, addr, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://" + addr,
                        world_size=4, rank=rank)
sys.path.insert(0, sys.argv[4])
from test_torch_parallel_ranks import _rank_main
_rank_main(rank, out)
dist.destroy_process_group()
"""


# --- the reference -----------------------------------------------------------


def _reference_main(out):
    """The reference's side, on 4 forced host devices: yi-9b's one-device
    loss and qwen3-moe's (2, 2) step where tokens drop, from the port's
    weights."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig
    from repro.launch.steps import build_train_step
    from repro.models import lm as rlm
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel import sharding as shard_mod
    from repro.parallel.ctx import make_ctx
    from repro_torch import tree
    import dataclasses
    torch.set_num_threads(1)
    shape = ShapeConfig("t", SEQ, ROWS, "train")

    def ref_cfg(arch, cap):
        from repro.configs import get_smoke
        cfg = get_smoke(arch)
        if cap is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cap))
        return cfg

    def weights(cfg_port):
        return tree.tree_map(lambda t: jnp.asarray(t.numpy()),
                             _params(cfg_port))

    res = {}
    # yi-9b, one device, as the ranks' step (two microbatches)
    cap, M, chunk, _ = STEP_CASES["yi-9b"]
    rc = ref_cfg("yi-9b", cap)
    p = weights(_cfg("yi-9b", cap))
    b = build_train_step(rc, shape, make_ctx(None, num_microbatches=M,
                                             loss_chunk=chunk))
    batch = jax.tree.map(jnp.asarray, _batch(rc))
    res["yi_loss"] = float(jax.jit(b.fn)(p, adamw_init(p), {}, batch)[3][
        "loss"])
    # qwen3-moe on a (2, 2) mesh where tokens drop
    rc = ref_cfg(DROP_ARCH, DROP_CAPACITY)
    p = weights(_cfg(DROP_ARCH, DROP_CAPACITY))
    # Auto axes: the reference's step hints its layouts by sharding
    # constraints, which jax's default Explicit axes refuse
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
    px = make_ctx(mesh)
    b = build_train_step(rc, shape, px, AdamWConfig(**LINEAR_OPT))
    in_sh = jax.tree.map(
        lambda s: shard_mod.to_shardings(s, px), b.in_specs,
        is_leaf=lambda x: x is None or isinstance(
            x, jax.sharding.PartitionSpec))
    p2, _, e2, m = jax.jit(b.fn, in_shardings=in_sh)(
        p, adamw_init(p), rlm.init_extras(rc),
        jax.tree.map(jnp.asarray, _batch(rc)))
    res["drop"] = {k: float(v) for k, v in m.items()}
    np.savez(os.path.join(out, "ref_drop_params.npz"),
             *[np.asarray(x, np.float32) for x in jax.tree.leaves(p2)],
             router_bias=np.asarray(e2["router_bias"]))
    with open(os.path.join(out, "reference.json"), "w") as f:
        json.dump(res, f)


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
from test_torch_parallel_ranks import _reference_main
_reference_main(sys.argv[1])
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks and the reference, spawned together once."""
    out = str(tmp_path_factory.mktemp("ranks"))
    addr = f"127.0.0.1:{multihost._free_port()}"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               REPRO_FORCE_F32="1", JAX_PLATFORMS="cpu")
    cmds = [[sys.executable, "-c", WORKER, str(r), addr, out, TESTS]
            for r in range(4)]
    cmds.append([sys.executable, "-c", REFERENCE, out, TESTS])
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:  # a rank that hangs in a collective fails the test here
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json")))
             for r in range(4)]
    ref = json.load(open(os.path.join(out, "reference.json")))
    return out, ranks, ref


CASES = [(a, json.dumps(v, sort_keys=True)) for a, c in STEP_CASES.items()
         for v in c[3]]


@pytest.mark.parametrize("arch,variant", CASES)
def test_mesh_train_step_equals_one_device(runs, arch, variant):
    _, ranks, _ = runs
    for r in ranks:  # every rank reports the same step
        got = r["steps"][f"{arch}/{variant}"]
        assert abs(got["loss"] - got["one_loss"]) <= LOSS_REL * abs(
            got["one_loss"]), got
        assert abs(got["grad_norm"] - got["one_grad_norm"]) <= NORM_REL * \
            got["one_grad_norm"], got
        assert got["leaf_share"] <= UPDATE_SHARE, got
        # the step moved every leaf by more than the weights themselves
        assert got["least_update"] > got["weights"], got
        if "dropped" in got:
            assert got["dropped"] == got["one_dropped"] == 0, got
            assert got["bias_equal"], got


def test_dense_loss_within_the_references_bar(runs):
    _, ranks, ref = runs
    got = ranks[0]["steps"]['yi-9b/{}']["loss"]
    assert abs(got - ref["yi_loss"]) < REF_LOSS_BAR, (got, ref["yi_loss"])


def test_dropping_moe_step_equals_the_references_mesh_step(runs):
    out, ranks, ref = runs
    got = np.load(os.path.join(out, "drop_params.npz"))
    want = np.load(os.path.join(out, "ref_drop_params.npz"))
    start = np.load(os.path.join(out, "drop_start.npz"))
    assert np.array_equal(got["router_bias"], want["router_bias"])
    assert np.abs(want["router_bias"]).max() > 0  # the bias moved
    n = len([k for k in want.files if k.startswith("arr_")])
    assert n == len([k for k in got.files if k.startswith("arr_")])
    for i in range(n):  # each leaf's update, the gradient scaled
        a, b, p = got[f"arr_{i}"], want[f"arr_{i}"], start[f"arr_{i}"]
        upd = float(np.abs(b - p).max())
        assert upd > 0, i
        assert float(np.abs(a - b).max()) <= GRAD_TOL * upd, i
    for r in ranks:
        m, rm = r["drop"], ref["drop"]
        assert m["moe_dropped"] == rm["moe_dropped"] > 0, (m, rm)
        assert abs(m["loss"] - rm["loss"]) <= REF_LOSS_REL * abs(
            rm["loss"]), (m, rm)
        assert abs(m["grad_norm"] - rm["grad_norm"]) <= REF_NORM_REL * \
            rm["grad_norm"], (m, rm)


def test_gpipe_over_four_stages_equals_sequential(runs):
    for r in runs[1]:
        assert r["gpipe_err"] <= 1e-5, r["gpipe_err"]


def test_q8_cross_pod_mean_equals_reference(runs):
    import jax
    import jax.numpy as jnp
    from repro.optim.compress import q8_cross_pod_mean
    g = np.random.default_rng(3).normal(size=(2, 3, 300)).astype(np.float32)
    mesh = jax.make_mesh((2,), ("pod",), devices=jax.devices()[:2],
                         axis_types=(jax.sharding.AxisType.Auto,))
    mean, new_e = q8_cross_pod_mean(jnp.asarray(g), jnp.zeros_like(g), mesh,
                                    "pod")
    mean, new_e = np.asarray(mean), np.asarray(new_e)
    step = np.abs(g).max() / 127
    for r in runs[1]:
        pod = r["rank"] // 2
        assert np.array_equal(np.asarray(r["q8_mean"], np.float32),
                              mean[pod])
        got_e = np.asarray(r["q8_err"], np.float32)
        assert np.abs(got_e).max() <= step + 1e-6
        assert np.array_equal(got_e, new_e[pod])


def test_ep2d_equals_grouped_experts_and_shards_the_experts(runs):
    for r in runs[1]:
        assert r["ep2d_close"], r["ep2d_err"]
        assert r["moe_one_err"] <= 1e-6, r["moe_one_err"]
        assert r["moe_dropped_False"] == r["moe_dropped_True"] == 0
        # experts over "model" (2 ways) without ep2d, over data x model
        # (4 ways) with it
        assert r["expert_numel"]["False"] == {
            k: r["expert_total"] // 2 for k in ("w_gate", "w_up", "w_down")}
        assert r["expert_numel"]["True"] == {
            k: r["expert_total"] // 4 for k in ("w_gate", "w_up", "w_down")}


def test_shard_then_gather_is_the_identity(runs):
    for r in runs[1]:
        assert r["round_trip"]
        assert r["held"] == {"a": 12, "b": 3, "c": 1}
