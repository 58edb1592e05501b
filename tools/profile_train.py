"""Profile a tinyllama-1.1b training step by kernel, and time the attention
backward alone, for several checkouts of this repo in turns, on one GPU.

    python3 tools/profile_train.py DIR [DIR ...] [--steps N] [--traced K]
        [--arch A]

`--arch rwkv6-1.6b` (or `zamba2-1.2b`, `seamless-m4t-medium`,
`internvl2-2b`, at full width and depth) profiles that arch's step with
the same recipe instead, without the attention backward's shapes; the
batches come from the trainer's source (with an encoder-decoder's
source frames or the vision embeddings).

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
   on its source's batches for N steps (no checkpoints), then traces K
   more steps, each in a profile of its own (every step's seconds, the
   allocator's retries in it and the card's SM clock, power and
   temperature after it; each traced step's device ms and busy share),
   and of the last: device time by kernel and by group
   (attention backward and forward, GEMMs, elementwise and reductions,
   the rest), the device's busy share of the step, the kernels a step,
   the host's busiest operators (self CPU ms), and s/step (median of the
   steps after the first), tokens/s and the model-FLOPs share of 989
   TFLOP/s as `chip_smoke.py` counts them.

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
WKV_KERNELS = ("wkv_intra_kernel", "wkv_intra_bwd_kernel")
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
    if any(k in name for k in WKV_KERNELS):
        return "wkv"
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


def clocks() -> str:
    """The card's SM clock, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def kernels(prof):
    """({kernel name: (device us, calls)}, [(start, end) of each])."""
    import torch
    by_kernel, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, c = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (n + us, c + 1)
            spans.append((e.time_range.start, e.time_range.end))
    return by_kernel, spans


def busy_us(spans) -> float:
    """The union of the kernels' intervals, us."""
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def train_step(cs, dev, steps: int, arch: str, traced_steps: int = 1):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import TrainCtx
    from repro_torch.launch.train import make_trainer
    spec, cfg = cs.TRAIN, get_arch(arch)
    px = TrainCtx(num_microbatches=spec["microbatches"],
                  loss_chunk=spec["loss_chunk"])
    tr = make_trainer(cfg, seq=spec["seq"], batch=spec["batch"],
                      steps=steps + traced_steps, device=dev,
                      ckpt_dir=str(ROOT / "results" / "profile_ckpt"),
                      px=px, log=lambda s: None)
    state = tr.init_state()
    # a tree from before the Trainer took a source streams tokens only
    data = make_pipeline(tr.data_cfg, start_step=0,
                         source=getattr(tr, "source", None))

    def one_step(state):
        """One step on the next batch: (state, seconds, {seconds, the
        allocator's retries in the step, the card's clocks after it})."""
        batch = next(data)
        torch.cuda.synchronize()
        r0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        t0 = time.perf_counter()
        *state, m = tr.step_fn(*state, batch)
        float(m["loss"])  # the step's end
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return state, sec, {
            "s": sec, "alloc_retries": torch.cuda.memory_stats().get(
                "num_alloc_retries", 0) - r0, "clocks": clocks()}

    secs, untraced = [], []
    for _ in range(steps):
        state, sec, info = one_step(state)
        secs.append(sec)
        untraced.append(info)
    traced = []
    for _ in range(traced_steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, wall, info = one_step(state)
        traced.append((prof, wall, info))
    data.close()
    per_traced = []
    for prof, wall, info in traced:
        kern, spans = kernels(prof)
        per_traced.append(dict(info, device_kernel_ms=sum(
            us for us, _ in kern.values()) / 1e3,
            device_busy_ms=busy_us(spans) / 1e3,
            busy_share=busy_us(spans) / 1e6 / wall))
    prof, wall, _ = traced[-1]
    by_kernel, spans = kernels(prof)
    busy = busy_us(spans)
    total = sum(us for us, _ in by_kernel.values())
    groups = {}
    for name, (us, _) in by_kernel.items():
        g = group(name)
        groups[g] = groups.get(g, 0.0) + us
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    s_step = statistics.median(secs[1:])
    tokens = spec["batch"] * spec["seq"]
    if cfg.rwkv is not None or cfg.ssm is not None:
        flops_tok = cs._recurrent_flops_per_token(cfg, state[0], spec["seq"])
    elif cfg.encoder_decoder or cfg.n_vision_tokens:
        flops_tok = cs._encdec_vision_flops_per_token(cfg, state[0],
                                                      spec["seq"])
    else:
        n_mm = cfg.param_count() - cfg.padded_vocab * cfg.d_model
        flops_tok = 6 * n_mm + 6 * cfg.n_layers * spec["seq"] * cfg.d_model
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    cs.emit(item="train_step", arch=cfg.name, steps=steps,
            s_per_step=s_step, step_seconds=secs,
            tokens_per_s=tokens / s_step,
            mfu_vs_989_tflops=flops_tok * tokens / s_step / cs.PEAK_BF16_S,
            untraced=untraced, traced=per_traced,
            traced_step_s=wall, device_kernel_ms=total / 1e3,
            device_busy_ms=busy / 1e3, busy_share=busy / 1e6 / wall,
            group_ms={g: us / 1e3 for g, us in sorted(groups.items())},
            group_share={g: us / total for g, us in sorted(groups.items())},
            device_kernels=len(spans),
            host_top=[{"op": e.key[:80], "self_cpu_ms": e.self_cpu_time_total
                       / 1e3, "calls": e.count} for e in host[:12]],
            top=[{"kernel": short(n), "ms": us / 1e3, "calls": c,
                  "share": us / total} for n, (us, c) in top])


def turn(tree: Path, steps: int, arch: str, traced: int):
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
    if arch == cs.TRAIN["arch"]:
        backward(cs, dev)
        torch.cuda.empty_cache()
    train_step(cs, dev, steps, arch, traced)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", type=Path,
                   help="roots of checkouts, each with src/repro_torch")
    p.add_argument("--steps", type=int, default=4,
                   help="untraced steps before the traced ones")
    p.add_argument("--traced", type=int, default=1,
                   help="steps traced, each in a profile of its own")
    p.add_argument("--arch", default="tinyllama-1.1b",
                   help="the arch whose step is profiled (full width and "
                        "depth)")
    p.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    trees = [t.resolve() for t in a.trees]
    if a.turn:
        turn(trees[0], a.steps, a.arch, a.traced)
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
                        "--steps", str(a.steps), "--arch", a.arch,
                        "--traced", str(a.traced)],
                       check=True, env=env)


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
