"""Training of the encoder-decoder (seamless-m4t-medium) and vision-token
(internvl2-2b) families in the port, held against the reference on the
CPU on their smoke configs: the batch source (`launch.train.
FamilyInputs`) against `repro.data.pipeline.SyntheticLM` and
`repro.launch.specs.train_batch_specs`, one `build_train_step` step
against the reference's, and the train CLI. Their crash restarts are
cases of `tests/test_torch_fault_tolerance.py::test_lm_crash_restart_bit_exact`.

Weights cross from JAX through `models.convert`; the batch is the
source's. The float32 step runs in one subprocess with REPRO_FORCE_F32=1
for both packages (read at import), with tests/test_torch_train.py's
bars: the loss and lr within METRIC_TOL relative, the grad norm within
GRAD_NORM_TOL relative, every parameter within PARAM_TOL (absolute: at
step 1 the warmup lr is 3e-6, and AdamW's first update is about lr *
sign(g)), at most FAR_SHARE of the entries off by more than a tenth of
the step's move. seamless's smoke attends almost by argmax (scores to
~60: tests/test_torch_encdec.py), so its gradients move under a one-ULP
change of the frames: as there, its grad norm is held within ULP_FACTOR
times the reference's own move under that change where that is the
larger bar (measured: the reference's own move 3.3e-5, the port 1.3e-4
from the reference; internvl2 4.7e-6).
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

from repro import configs as rcfg  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro.parallel.ctx import make_ctx  # noqa: E402

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.models.layers import COMPUTE_DT  # noqa: E402

METRIC_TOL = 1e-5
GRAD_NORM_TOL = 1e-4
PARAM_TOL = 1e-5
FAR_SHARE = 1e-3
#: tests/test_torch_encdec.py's factor over the reference's own move
ULP_FACTOR = 10
ARCHS = ("seamless-m4t-medium", "internvl2-2b")
#: internvl2's smoke puts its 8 vision tokens in the first positions
B, S = 4, 16


def _data_cfg(cfg, seed=7):
    return tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                            global_batch=B, seed=seed)


@pytest.fixture(scope="module")
def f32():
    """One train step of each smoke in both packages, in a
    REPRO_FORCE_F32=1 subprocess of this file."""
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, REPRO_FORCE_F32="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, __file__], check=True,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_source_tokens_are_the_reference_stream(arch, step):
    """The tokens and loss mask are `SyntheticLM`'s of the reference, bit
    for bit: the frames and vision embeddings are drawn from generators
    of their own."""
    cfg = tcfg.get_smoke(arch)
    got = ltrain.FamilyInputs(cfg, _data_cfg(cfg)).batch_at(step)
    want = rpipe.SyntheticLM(rpipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
        seed=7)).batch_at(step)
    for k in ("tokens", "loss_mask"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_source_inputs_follow_the_train_batch_specs(arch):
    """The batch has `train_batch_specs`' keys and shapes, frames and
    vision embeddings in the compute dtype, as the reference's."""
    rc = rcfg.get_smoke(arch)
    sds, _ = rspecs.train_batch_specs(rc, RShape("t", S, B, "train"),
                                      make_ctx(None))
    cfg = tcfg.get_smoke(arch)
    got = ltrain.FamilyInputs(cfg, _data_cfg(cfg)).batch_at(0)
    assert sorted(got) == sorted(sds)
    extra = "frames" if cfg.encoder_decoder else "vision_embeds"
    assert extra in got
    for k, spec in sds.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
    assert got[extra].dtype == COMPUTE_DT
    assert str(sds[extra].dtype) == str(COMPUTE_DT).split(".")[-1]
    assert bool(torch.isfinite(got[extra]).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_source_inputs_replay_by_seed_and_step(arch):
    """Two draws of one (seed, step) are equal (a restarted run replays
    them); another step or seed draws others."""
    cfg = tcfg.get_smoke(arch)
    extra = "frames" if cfg.encoder_decoder else "vision_embeds"

    def draw(step, seed=7):
        return ltrain.FamilyInputs(cfg, _data_cfg(cfg, seed)).batch_at(
            step)[extra]
    a = draw(2)
    assert torch.equal(a, draw(2))
    assert not torch.equal(a, draw(3))
    assert not torch.equal(a, draw(2, seed=8))


@pytest.mark.parametrize("arch,family", [
    ("seamless-m4t-medium", True), ("internvl2-2b", True),
    ("tinyllama-1.1b", False)])
def test_trainer_takes_the_family_source(tmp_path, arch, family):
    """`make_trainer` gives the Trainer `FamilyInputs` where the batch
    holds more than tokens; otherwise the Trainer's default stream."""
    tr = ltrain.make_trainer(tcfg.get_smoke(arch), seq=S, batch=B, steps=1,
                             ckpt_dir=str(tmp_path), device="cpu",
                             log=lambda s: None)
    assert isinstance(tr.source, ltrain.FamilyInputs) == family
    if not family:
        assert isinstance(tr.source, tpipe.SyntheticLM)


def test_child_ran_in_float32(f32):
    assert f32["param_dtypes"] == ["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference_f32(f32, arch):
    """One `build_train_step` step (2 microbatches, AdamW, remat, loss
    chunk 8, which seamless's full-vocabulary loss ignores) on the
    source's batch against the reference's on the same weights and
    batch."""
    r = f32["step"][arch]
    assert r["batch_keys"] == sorted(["tokens", "loss_mask", r["extra"]])
    assert max(r["param_err"].values()) <= PARAM_TOL, r["param_err"]
    # not vacuous: almost every entry is where the reference's step put
    # it, to a tenth of the move (an entry whose gradient's sign turns on
    # its last bits is off by up to twice the move)
    assert r["moved"] > 0 and r["far_share"] <= FAR_SHARE, r["far_share"]
    for k in ("loss", "lr"):
        assert r["metric_rel"][k] <= METRIC_TOL, r["metric_rel"]
    tol = max(GRAD_NORM_TOL, ULP_FACTOR * r["ulp_move"]["grad_norm"])
    assert r["metric_rel"]["grad_norm"] <= tol, (r["metric_rel"],
                                                 r["ulp_move"])


def test_global_norm_does_not_overflow_where_the_reference_does():
    """A deliberate difference: a gradient norm past ~1.8e19 overflows
    the reference's float32 sum of squares (inf, and its clip then
    zeroes the step); the port accumulates each leaf's norm in float64,
    so there too its float32 norm is the exact one's to 1e-6. Below it
    the two agree to 1e-6."""
    from repro.optim import adamw as radamw
    from repro_torch.optim import adamw as tadamw
    r = np.random.default_rng(0)
    small = {"b": r.normal(size=(8,)).astype(np.float32),
             "w": r.normal(size=(64, 8)).astype(np.float32)}
    big = dict(small, w=small["w"] * np.float32(1e19))
    for grads, overflows in ((small, False), (big, True)):
        want = np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                           for v in grads.values()))
        ref = float(radamw.global_norm(jax.tree.map(jnp.asarray, grads)))
        got = tadamw.global_norm({k: torch.from_numpy(v)
                                  for k, v in grads.items()})
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= 1e-6 * want
        assert np.isfinite(ref) != overflows
        if not overflows:
            assert abs(ref - want) <= 1e-6 * want


def test_train_cli_runs_seamless_smoke_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train --arch seamless-m4t-medium
    --smoke --device cpu` takes a step on the source's frames and prints
    its JSON line."""
    torch.set_num_threads(1)
    ltrain.main(["--arch", "seamless-m4t-medium", "--smoke", "--device",
                 "cpu", "--steps", "1", "--seq", str(S), "--batch", str(B),
                 "--microbatches", "2", "--loss-chunk", "8",
                 "--checkpoint-every", "1", "--ckpt", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "seamless-smoke" and out["device"] == "cpu"
    assert out["data_step"] == 1 and out["steps"] == 1
    assert np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])
    assert CheckpointManager(str(tmp_path)).latest_step() == 1


# --- the float32 subprocess --------------------------------------------------


def _child():
    """Body of the float32 subprocess: prints one JSON line."""
    torch.set_num_threads(1)
    from repro.launch import steps as rsteps
    from repro.models import lm as rlm
    from repro.optim import adamw as radamw

    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import convert
    from repro_torch.models import lm as tlm
    from repro_torch.optim import adamw as tadamw

    def npy(t):
        return jax.tree.map(np.asarray, t)

    def rel(got, want):
        w = float(np.asarray(want))
        return abs(float(got) - w) / max(abs(w), 1e-30)

    def paths(t):
        return [jax.tree_util.keystr(p) for p, _ in
                jax.tree_util.tree_leaves_with_path(t)]

    res = {"step": {}}
    dtypes = set()
    for arch in ARCHS:
        rc, tc = rcfg.get_smoke(arch), tcfg.get_smoke(arch)
        rp = rlm.init_params(jax.random.key(4), rc)
        tp = convert.params_from_numpy(npy(rp))
        dtypes |= {str(t.dtype).split(".")[-1] for t in tree.leaves(tp)}
        batch = ltrain.FamilyInputs(tc, _data_cfg(tc)).batch_at(0)
        rbatch = {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}
        rb = rsteps.build_train_step(rc, RShape("t", S, B, "train"),
                                     make_ctx(None, loss_chunk=8,
                                              num_microbatches=2))
        rp2, _, _, rm = jax.jit(rb.fn)(rp, radamw.adamw_init(rp),
                                       rlm.init_extras(rc), rbatch)
        tfn = tsteps.build_train_step(
            tc, TShape("t", S, B, "train"),
            tsteps.TrainCtx(num_microbatches=2, loss_chunk=8))
        tp2, _, _, tm = tfn(tp, tadamw.adamw_init(tp),
                            tlm.init_extras(tc, "cpu"), batch)
        extra = "frames" if tc.encoder_decoder else "vision_embeds"
        # the reference's own step with the frames or vision embeddings
        # one ULP up: how far its rounding alone moves the metrics
        up = dict(rbatch, **{extra: jnp.asarray(np.nextafter(
            np.asarray(batch[extra]), np.float32(np.inf)))})
        _, _, _, rm3 = jax.jit(rb.fn)(rp, radamw.adamw_init(rp),
                                        rlm.init_extras(rc), up)
        moved = max(float(np.abs(np.asarray(a, np.float32)
                                 - np.asarray(b, np.float32)).max())
                    for a, b in zip(jax.tree.leaves(rp2),
                                    jax.tree.leaves(rp)))
        far = sum(int((np.abs(g.float().numpy() - w) > 0.1 * moved).sum())
                  for g, w in zip(tree.leaves(tp2),
                                  jax.tree.leaves(npy(rp2))))
        res["step"][arch] = {
            "ulp_move": {k: rel(rm3[k], rm[k]) for k in ("loss",
                                                         "grad_norm")},
            "far_share": far / sum(int(np.size(a)) for a in
                                   jax.tree.leaves(rp2)),
            "extra": extra, "batch_keys": sorted(batch),
            "param_err": {p: float(np.abs(g.float().numpy() - w).max())
                          for p, g, w in zip(paths(rp2), tree.leaves(tp2),
                                             jax.tree.leaves(npy(rp2)))},
            "moved": moved,
            "metric_rel": {k: rel(tm[k], rm[k])
                           for k in ("loss", "grad_norm", "lr")}}
    res["param_dtypes"] = sorted(dtypes)
    print(json.dumps(res))


if __name__ == "__main__":
    _child()
