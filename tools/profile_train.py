"""Profile a tinyllama-1.1b training step by kernel, and time the attention
backward alone, for several checkouts of this repo in turns, on one GPU.

    python3 tools/profile_train.py DIR [DIR ...] [--steps N]

Each DIR is the root of a checkout: `.` for this one, or an earlier
commit unpacked under a git-ignored directory
(`mkdir -p dist/old && git archive REV | tar -x -C dist/old`). A turn is
one process that imports DIR's `repro_torch`, builds its kernels into
DIR's own build directory, and

1. calls `flash_attention_bwd` at `chip_smoke.py`'s two bf16 shapes
   (tinyllama's B 2, H 32/4, S 4,096, D 64 and qwen2-7b's B 1, H 28/4,
   D 128, causal): the call (CUDA events, as `chip_smoke.time_ms`) and
   each kernel's device ms (`torch.profiler`), with the fused
   attention's backward (autograd of `scaled_dot_product_attention`, on
   a kept graph) beside it as the yardstick;
2. builds phase train's tinyllama-1.1b run (`chip_smoke.TRAIN`: 8 x
   4,096 tokens in 4 microbatches, AdamW, remat full, loss chunk 1,024)
   through `launch.train.make_trainer`, runs the Trainer's step function
   on the synthetic stream for N steps (no checkpoints), then traces one
   more step with `torch.profiler`: device time by kernel and by group
   (attention backward and forward, GEMMs, elementwise and reductions,
   the rest), the device's busy share of the step, and s/step (median
   of the steps after the first), tokens/s and the model-FLOPs share of
   989 TFLOP/s as `chip_smoke.py` counts them.

The turns run in the order given and then reversed (A B, B A). Each
prints one JSON line per item; the card's nvidia-smi line comes first.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (B, H, Hkv, S, D) of the backward's bf16 shapes in chip_smoke.py
BWD_SHAPES = ((2, 32, 4, 4096, 64), (1, 28, 4, 4096, 128))
#: the backward's kernels, both designs
BWD_KERNELS = ("dkdv_wgmma_kernel", "dq_wgmma_kernel", "prep_kernel",
               "sum_heads_kernel", "dkdv_mma_kernel", "dq_mma_kernel",
               "delta_kernel", "dkdv_f32_kernel", "dq_f32_kernel")
FWD_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_mma_kernel",
               "flash_attention_kernel")
GEMM = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
ELEMENTWISE = ("elementwise", "vectorized", "reduce", "unrolled",
               "foreach", "multi_tensor")


def short(name: str) -> str:
    """A kernel's name with its template arguments (functors included),
    without `void`, the common namespaces and the argument list."""
    n = re.sub(r"^void ", "", name)
    for ns in ("(anonymous namespace)::", "at::native::"):
        n = n.replace(ns, "")
    return n.split("(")[0][:160]


def group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in BWD_KERNELS):
        return "attention_backward"
    if any(k in name for k in FWD_KERNELS):
        return "attention_forward"
    if any(k in low for k in GEMM):
        return "gemm"
    if any(k in low for k in ELEMENTWISE):
        return "elementwise_and_reductions"
    return "other"


def backward(cs, dev):
    import torch
    from repro_torch.kernels.flash_attention import ops
    F = torch.nn.functional
    for B, H, Hkv, S, D in BWD_SHAPES:
        q = cs._randn((B, H, S, D), 11, dev, torch.bfloat16)
        k = cs._randn((B, Hkv, S, D), 12, dev, torch.bfloat16)
        v = cs._randn((B, Hkv, S, D), 13, dev, torch.bfloat16)
        do = cs._randn((B, H, S, D), 14, dev, torch.bfloat16)
        out, lse = ops._forward(q, k, v, True, True)
        call = lambda: ops.flash_attention_bwd(  # noqa: E731
            q, k, v, out, do, lse, True)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                 enable_gqa=True)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, leaves, do, retain_graph=True)
        split = cs.device_split(call)
        cs.emit(item="flash_attention_bwd", B=B, H=H, Hkv=Hkv, S=S, D=D,
                ms=cs.time_ms(call, reps=5, batch=2),
                device_ms=sum(split.values()), device_ms_by_kernel=split,
                library_ms=cs.time_ms(lib, reps=5, batch=2),
                library_device_ms=sum(cs.device_split(lib).values()))
        del lib_out, leaves


def train_step(cs, dev, steps: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import TrainCtx
    from repro_torch.launch.train import make_trainer
    spec, cfg = cs.TRAIN, get_arch(cs.TRAIN["arch"])
    px = TrainCtx(num_microbatches=spec["microbatches"],
                  loss_chunk=spec["loss_chunk"])
    tr = make_trainer(cfg, seq=spec["seq"], batch=spec["batch"],
                      steps=steps + 1, device=dev,
                      ckpt_dir=str(ROOT / "results" / "profile_ckpt"),
                      px=px, log=lambda s: None)
    state = tr.init_state()
    data = make_pipeline(tr.data_cfg, start_step=0)
    secs = []
    for _ in range(steps):
        batch = next(data)
        t0 = time.perf_counter()
        *state, m = tr.step_fn(*state, batch)
        float(m["loss"])  # the step's end
        secs.append(time.perf_counter() - t0)
    batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        *state, m = tr.step_fn(*state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    data.close()
    by_kernel, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, c = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (n + us, c + 1)
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):  # the union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(us for us, _ in by_kernel.values())
    groups = {}
    for name, (us, _) in by_kernel.items():
        g = group(name)
        groups[g] = groups.get(g, 0.0) + us
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    s_step = statistics.median(secs[1:])
    tokens = spec["batch"] * spec["seq"]
    n_mm = cfg.param_count() - cfg.padded_vocab * cfg.d_model
    flops_tok = 6 * n_mm + 6 * cfg.n_layers * spec["seq"] * cfg.d_model
    cs.emit(item="train_step", arch=cfg.name, steps=steps,
            s_per_step=s_step, step_seconds=secs,
            tokens_per_s=tokens / s_step,
            mfu_vs_989_tflops=flops_tok * tokens / s_step / cs.PEAK_BF16_S,
            traced_step_s=wall, device_kernel_ms=total / 1e3,
            device_busy_ms=busy / 1e3, busy_share=busy / 1e6 / wall,
            group_ms={g: us / 1e3 for g, us in sorted(groups.items())},
            group_share={g: us / total for g, us in sorted(groups.items())},
            top=[{"kernel": short(n), "ms": us / 1e3, "calls": c,
                  "share": us / total} for n, (us, c) in top])


def turn(tree: Path, steps: int):
    """One tree's measurements (runs in its own process)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src/ first: undo it
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}'s")
    from repro_torch.kernels import build as kbuild
    kbuild.build_all()
    dev = torch.device("cuda")
    cs.emit(tree=str(tree), item="turn")
    backward(cs, dev)
    torch.cuda.empty_cache()
    train_step(cs, dev, steps)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", type=Path,
                   help="roots of checkouts, each with src/repro_torch")
    p.add_argument("--steps", type=int, default=4,
                   help="untraced steps before the traced one")
    p.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    trees = [t.resolve() for t in a.trees]
    if a.turn:
        turn(trees[0], a.steps)
        return
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("profile_train.py needs a CUDA GPU; none is visible")
    cs.card()
    env = {k: v for k, v in os.environ.items()
           if k != "REPRO_TORCH_BUILD_DIR"}
    for tree in trees + trees[::-1]:
        subprocess.run([sys.executable, __file__, "--turn", str(tree),
                        "--steps", str(a.steps)], check=True, env=env)


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
