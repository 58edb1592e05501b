"""The port's checkpoint manager, trainer and watchdog: the ten cases of
tests/test_fault_tolerance.py against `repro_torch.checkpoint` and
`repro_torch.runtime`, the crash-restart of a real train step (bit for
bit on the CPU), and on the card a checkpoint that crosses between the
card and the CPU.

This file imports no JAX: its `cuda` tests run on the card with
`python -m pytest --noconftest -m cuda tests/test_torch_fault_tolerance.py`.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch.steps import TrainCtx  # noqa: E402
from repro_torch.launch.train import make_trainer  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.runtime.watchdog import Watchdog  # noqa: E402


def _tree(seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 8), generator=g).to(device),
            "b": torch.arange(5, dtype=torch.int32).to(device),
            "h": (torch.randn((3, 4), generator=g) * 3).to(
                torch.bfloat16).to(device),
            "step": torch.tensor(seed, dtype=torch.int32).to(device)}


def _equal(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x.cpu(), y.cpu())
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


# --- checkpoint manager ------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    m.save(3, t)
    got, step = m.restore(t)
    assert step == 3 and _equal(t, got)
    assert sorted(got) == sorted(t)


def test_restore_picks_latest_committed(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree(1))
    m.save(5, _tree(5))
    # a torn save (crash mid-write) leaves only a .tmp dir — ignored
    os.makedirs(tmp_path / "step_9.tmp")
    assert m.latest_step() == 5
    got, step = m.restore(_tree())
    assert step == 5 and _equal(got, _tree(5))


def test_corruption_detected(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(2, _tree())
    leaf = tmp_path / "step_2" / "leaf_0.npy"
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0xFF
    leaf.write_bytes(bytes(data))
    with pytest.raises(IOError):
        m.restore(_tree())


def test_async_save_equivalent(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree(4)
    m.save(7, t, blocking=False)
    m.wait()
    got, _ = m.restore(t)
    assert _equal(t, got)


def test_async_save_failure_raises_on_wait(tmp_path, monkeypatch):
    """A save that fails in the background raises at the next wait (and
    once): the trainer must not go on as if the step were saved."""
    from repro_torch.checkpoint import manager

    def boom(path, arr):
        raise OSError("disk full")
    monkeypatch.setattr(manager, "_write_leaf", boom)
    m = CheckpointManager(str(tmp_path))
    m.save(7, _tree(4), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        m.wait()
    m.wait()
    assert m.latest_step() is None


def test_retention_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree(s))
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]


def test_restore_onto_a_device_and_without_a_template(tmp_path):
    """The reference's elastic reshape: the files do not depend on the
    device that wrote them; restore places the tensors on `device` and
    rebuilds the tree from the manifest (the leaves in sorted-key order,
    a bf16 leaf stored as its uint16 bits)."""
    m = CheckpointManager(str(tmp_path))
    t = (_tree(), {"m": {"b": torch.ones(2), "a": torch.zeros(3)}}, {})
    m.save(1, t)
    got, _ = m.restore(device="cpu")
    assert isinstance(got, tuple) and got[2] == {}
    assert _equal(t, got) and got[0]["h"].device.type == "cpu"
    meta = m.manifest()
    assert [f["dtype"] for f in meta["files"]][:4] == [
        "int32", "bfloat16", "int32", "float32"]  # b, h, step, w
    arr = np.load(tmp_path / "step_1" / "leaf_1.npy")
    assert arr.dtype == np.uint16
    with pytest.raises(ValueError, match="leaves"):
        m.restore({"w": torch.zeros(1)})


# --- trainer crash/restart ---------------------------------------------------


def _toy_trainer(ckpt_dir, total=12):
    """Tiny model: w learns the batch mean."""
    data_cfg = DataConfig(vocab_size=32, seq_len=8, global_batch=2, seed=3)

    def init_state():
        return ({"w": torch.zeros(8)}, {"v": torch.zeros(8)}, {})

    def step_fn(params, opt, extras, batch):
        x = torch.as_tensor(batch["tokens"]).float().mean(0)
        grad = params["w"] - x
        v = 0.9 * opt["v"] + grad
        w = params["w"] - 0.1 * v
        return {"w": w}, {"v": v}, extras, {"loss": torch.sum(grad ** 2)}

    cfg = TrainerConfig(total_steps=total, checkpoint_every=4,
                        checkpoint_dir=str(ckpt_dir), log_every=100,
                        async_save=False)
    return Trainer(cfg, step_fn, init_state, data_cfg, log=lambda s: None,
                   device="cpu")


def test_crash_restart_bit_exact(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    ref = _toy_trainer(d1).run()
    with pytest.raises(RuntimeError):
        _toy_trainer(d2).run(fail_at=7)
    out = _toy_trainer(d2).run()
    assert torch.equal(ref["params"]["w"], out["params"]["w"])
    assert ref["data_step"] == out["data_step"] == 12


def test_resume_starts_from_checkpoint(tmp_path):
    tr = _toy_trainer(tmp_path, total=8)
    tr.run()
    assert tr.ckpt.latest_step() == 8
    logs = []
    tr2 = _toy_trainer(tmp_path, total=8)
    tr2.log = logs.append
    tr2.run()  # nothing left to do; resumes at 8 and saves final
    assert any("resumed from step 8" in line for line in logs)


def test_final_save_written_once_or_not_at_all(tmp_path):
    """The last step is written once (the final save), or, with
    save_final off, not at all; the periodic saves before it stay."""
    tr = _toy_trainer(tmp_path / "a", total=8)
    saves = []
    orig = tr.ckpt.save
    tr.ckpt.save = lambda step, *a, **k: (saves.append(step),
                                          orig(step, *a, **k))
    tr.run()
    assert saves == [4, 8]
    tr = _toy_trainer(tmp_path / "b", total=8)
    tr.cfg.save_final = False
    tr.run()
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 4


def test_trainer_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    """Without a device the Trainer takes the card, where a resumed run
    restores its checkpoint; where no GPU is visible it raises as the
    Engine does, and device="cpu" is the CPU."""
    def make(**kw):
        return Trainer(TrainerConfig(checkpoint_dir=str(tmp_path)),
                       lambda *a: a, lambda: ({}, {}, {}),
                       DataConfig(vocab_size=8, seq_len=4, global_batch=1),
                       log=lambda s: None, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        make()
    assert make(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert make().device == torch.device("cuda")


def _lm_trainer(ckpt_dir, arch, device="cpu", steps=4):
    cfg = tcfg.get_smoke(arch)
    return make_trainer(cfg, seq=16, batch=4, steps=steps,
                        ckpt_dir=str(ckpt_dir), device=device,
                        px=TrainCtx(num_microbatches=2, loss_chunk=8),
                        checkpoint_every=2, log=lambda s: None)


def _manifest_shas(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return [x["sha256"] for x in json.load(f)["files"]]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_lm_crash_restart_bit_exact(tmp_path, arch):
    """The real train step (AdamW, microbatches, chunked loss, remat,
    for MoE the router-bias update): killed after step 3, restarted from
    its step-2 checkpoint, it ends with the uninterrupted run's params,
    optimizer state, extras and data cursor, bit for bit."""
    torch.set_num_threads(1)
    d1, d2 = tmp_path / "a", tmp_path / "b"
    ref = _lm_trainer(d1, arch).run()
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        _lm_trainer(d2, arch).run(fail_at=3)
    assert CheckpointManager(str(d2)).latest_step() == 2
    out = _lm_trainer(d2, arch).run()
    for k in ("params", "opt_state", "extras"):
        assert _equal(ref[k], out[k]), k
    assert ref["data_step"] == out["data_step"] == 4
    assert _manifest_shas(d1, 4) == _manifest_shas(d2, 4)
    assert float(ref["metrics"]["loss"]) == float(out["metrics"]["loss"])


# --- watchdog ------------------------------------------------------------------


def test_watchdog_flags_straggler_and_hang():
    wd = Watchdog(min_samples=3, straggler_factor=2.0, hang_factor=5.0)
    for i in range(5):
        assert wd.observe(i, 1.0) == "ok"
    assert wd.observe(5, 2.5) == "straggler"
    assert wd.stragglers == 1
    assert wd.observe(6, 50.0) == "hang"
    assert wd.ema < 3.0  # clamped EMA: one hang doesn't poison the baseline
    assert wd.observe(7, 1.0) == "ok"


def test_watchdog_deadline():
    wd = Watchdog(min_samples=2, hang_factor=4.0)
    assert wd.deadline() == float("inf")
    wd.observe(0, 1.0)
    wd.observe(1, 1.0)
    assert wd.deadline() == pytest.approx(4.0, rel=0.3)


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (run `python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_checkpoint_crosses_between_card_and_cpu(cuda, tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree(2, cuda)
    m.save(1, t)
    got, _ = m.restore(device="cpu")
    assert _equal(t, got) and got["w"].device.type == "cpu"
    m.save(2, got)
    back, _ = m.restore(device=cuda)
    assert _equal(t, back) and back["w"].device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_card_run_resumes_on_the_cpu(cuda, tmp_path, arch):
    """A run killed on the card resumes from its checkpoint on the CPU:
    the CPU continues the card's state (the same files), and the card
    restarted from the same checkpoint repeats its own run bit for
    bit."""
    d1, d2 = tmp_path / "card", tmp_path / "cpu"
    ref = _lm_trainer(d1, arch, cuda).run()
    with pytest.raises(RuntimeError):
        _lm_trainer(d2, arch, cuda).run(fail_at=3)
    out = _lm_trainer(d2, arch, "cpu").run()
    assert out["data_step"] == 4
    assert tree.leaves(out["params"])[0].device.type == "cpu"
    for a, b in zip(tree.leaves(ref["params"]), tree.leaves(out["params"])):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().numpy(), atol=2e-2, rtol=2e-2)
