"""End-to-end training of a registered architecture — the port's
counterpart of the reference's `examples/train_lm.py`: the synthetic
Markov stream, the train step (microbatches, remat, chunked loss),
AdamW with its schedule, async atomic checkpoints, the watchdog and
crash-safe resume, through `runtime.Trainer`.

    python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --seq 4096 --batch 8 --microbatches 4 --loss-chunk 1024 --steps 6
    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \\
        --device cpu --steps 4 --seq 32 --batch 4

Weights are random, drawn from `--seed` on the device. It runs on the
card unless `--device cpu` is passed. `--fail-at N` crashes after step
N (a restart from the newest checkpoint resumes there). `--layers L`
cuts the depth (full width). Prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.service import resolve_device
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.steps import TrainCtx, build_train_step, opt_init
from repro_torch.models import lm as lm_mod
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def make_trainer(cfg, *, seq: int, batch: int, steps: int,
                 ckpt_dir: str, device=None, px: TrainCtx = TrainCtx(),
                 opt: AdamWConfig = None, seed: int = 0,
                 checkpoint_every: int = 25, async_save: bool = True,
                 save_final: bool = True, log=print) -> Trainer:
    """The Trainer of `cfg` on the synthetic stream (vocab = the
    config's): weights from `seed` on `device` (the card by default),
    the optimizer `px.optimizer`, checkpoints in `ckpt_dir`."""
    dev = resolve_device(device)
    opt = opt or AdamWConfig(warmup_steps=min(100, steps),
                             total_steps=max(steps, 1))
    shape = ShapeConfig("train", seq, batch, "train")
    step_fn = build_train_step(cfg, shape, px, opt)

    def init_state():
        params = lm_mod.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        return params, opt_init(px)(params), lm_mod.init_extras(cfg, dev)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=seed)
    tcfg = TrainerConfig(total_steps=steps, checkpoint_every=checkpoint_every,
                         checkpoint_dir=ckpt_dir, async_save=async_save,
                         log_every=1, save_final=save_final)
    return Trainer(tcfg, step_fn, init_state, data_cfg, log=log, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--loss-chunk", type=int, default=1024)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--checkpoint-every", type=int, default=3)
    ap.add_argument("--ckpt", default="checkpoints/train")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a crash after N steps (restart demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    a = ap.parse_args(argv)
    cfg = get_smoke(a.arch) if a.smoke else get_arch(a.arch)
    if a.layers:
        cfg = dataclasses.replace(cfg, n_layers=a.layers)
    px = TrainCtx(num_microbatches=a.microbatches, remat=a.remat,
                  loss_chunk=a.loss_chunk, optimizer=a.optimizer)
    tr = make_trainer(cfg, seq=a.seq, batch=a.batch, steps=a.steps,
                      ckpt_dir=a.ckpt, device=a.device, px=px, seed=a.seed,
                      checkpoint_every=a.checkpoint_every)
    t0 = time.perf_counter()
    out = tr.run(fail_at=a.fail_at or None)
    wall = time.perf_counter() - t0
    tail = tr.step_seconds[-4:]
    s_step = statistics.median(tail) if tail else float("nan")
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers,
        "params": cfg.param_count(), "seq": a.seq, "batch": a.batch,
        "microbatches": a.microbatches, "steps": a.steps,
        "device": str(tr.device), "wall_s": wall,
        "s_per_step": s_step, "tokens_per_s": a.batch * a.seq / s_step,
        "loss": float(out["metrics"]["loss"]),
        "grad_norm": float(out["metrics"]["grad_norm"]),
        "data_step": out["data_step"]}))


if __name__ == "__main__":
    main()
