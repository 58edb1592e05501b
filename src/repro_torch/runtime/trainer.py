"""Fault-tolerant training loop — the port of `repro.runtime.trainer`.

Wires together: the data pipeline (deterministic, resumable), the train
step, the checkpoint manager (async atomic saves), the watchdog
(straggler/hang detection) and restart from the newest checkpoint, on
any device (a checkpoint's files do not depend on the one that wrote
them).

Restart contract (tested in tests/test_torch_train.py and on the card
by `chip_smoke.py`): killing the trainer at any step and restarting from
the latest checkpoint replays the identical token stream and reproduces
the uninterrupted run's parameters, optimizer state and data cursor bit
for bit (the step function is deterministic).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.service import resolve_device
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.runtime.watchdog import Watchdog


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    #: relative to the working directory (the reference's default is
    #: under /tmp; the port writes nothing outside where it runs)
    checkpoint_dir: str = "checkpoints"
    async_save: bool = True
    log_every: int = 10
    #: write the last step's checkpoint when the run ends (the
    #: reference always does); a run whose final state is only compared,
    #: not kept, turns it off to spare the disk a full copy of the state
    save_final: bool = True


def _sync(state) -> None:
    """Wait for the device work behind `state`'s tensors."""
    for t in tree.leaves(state):
        if torch.is_tensor(t) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 init_state: Callable[[], tuple], data_cfg: DataConfig,
                 log: Callable[[str], None] = print, device=None):
        """step_fn(params, opt_state, extras, batch) ->
        (params, opt_state, extras, metrics); init_state() builds the
        step-0 (params, opt_state, extras) on `device`, where a resumed
        run's checkpoint is restored too: the card unless the caller
        passes device="cpu" (raises where no GPU is visible)."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.init_state = init_state
        self.data_cfg = data_cfg
        self.ckpt = CheckpointManager(cfg.checkpoint_dir)
        self.watchdog = Watchdog()
        self.log = log
        self.device = resolve_device(device)
        #: wall seconds of each step run, in order (steps end in a sync)
        self.step_seconds = []

    # ------------------------------------------------------------------
    def run(self, fail_at: Optional[int] = None) -> Dict[str, Any]:
        """Run (or resume) training. `fail_at` injects a crash after the
        given global step completes — used by the fault-tolerance tests.
        The result's `data_step` is the data cursor: the step of the
        next batch the stream would give."""
        start = self.ckpt.latest_step()
        if start is None:
            params, opt_state, extras = self.init_state()
            step0 = 0
            self.log("[trainer] cold start")
        else:
            (params, opt_state, extras), step0 = self.ckpt.restore(
                device=self.device)
            self.log(f"[trainer] resumed from step {step0}")
        data = make_pipeline(self.data_cfg, start_step=step0)

        metrics = {}
        cursor = step0
        try:
            for step in range(step0, self.cfg.total_steps):
                batch = next(data)
                cursor += 1
                t0 = time.perf_counter()
                params, opt_state, extras, metrics = self.step_fn(
                    params, opt_state, extras, batch)
                _sync(metrics)
                dt = time.perf_counter() - t0
                self.step_seconds.append(dt)
                verdict = self.watchdog.observe(step, dt)
                if verdict != "ok":
                    self.log(f"[watchdog] step {step}: {verdict} "
                             f"(ema {self.watchdog.ema:.3f}s)")
                if (step + 1) % self.cfg.log_every == 0:
                    loss = float(metrics.get("loss", float("nan")))
                    self.log(f"[trainer] step {step + 1} loss {loss:.4f}")
                # the last step is the final save's (the reference writes
                # it twice, the second copy over the first)
                if ((step + 1) % self.cfg.checkpoint_every == 0
                        and step + 1 < self.cfg.total_steps):
                    self.ckpt.save(step + 1, (params, opt_state, extras),
                                   blocking=not self.cfg.async_save)
                if fail_at is not None and step + 1 >= fail_at:
                    self.ckpt.wait()
                    raise RuntimeError(f"injected failure at step {step + 1}")
        finally:
            data.close()
        self.ckpt.wait()
        if self.cfg.save_final:
            self.ckpt.save(self.cfg.total_steps, (params, opt_state, extras))
        return {"params": params, "opt_state": opt_state, "extras": extras,
                "metrics": metrics, "data_step": cursor,
                "stragglers": self.watchdog.stragglers}
