"""Time the kernels of several checkouts of this repo in turns, on one
GPU: the two proximity kernels, the MoE gate (the serve call, the
training call with the probability mean and the backward), the cell
sums, the capacity assignment, the attention forward and the chunked
WKV pair.

    python3 tools/compare_kernels.py DIR [DIR ...] [--only FAMILY ...]

Each DIR is the root of a checkout: `.` for this one, or an earlier
commit unpacked under a git-ignored directory
(`mkdir -p dist/old && git archive REV | tar -x -C dist/old`). A turn is
one process that imports DIR's `repro_torch`, builds its kernels into
DIR's own build directory, and calls its wrappers
(`ops.proximity_lp_counts_grid`, `ops.proximity_lp_counts`,
`moe_gate.ops.moe_gate`, `moe_gate.ops.moe_gate_bwd`,
`cell_sums.ops.cell_sums`,
`capacity_assign.ops.capacity_assign`,
`flash_attention.ops.flash_attention`, `wkv.ops.wkv_intra` and
`wkv.ops.wkv_intra_bwd`: every build keeps their signatures, whatever
its C interface) at the shapes `chip_smoke.py` checks first (every shape
of the last three; the WKV pair through `chip_smoke.check_wkv_intra` /
`check_wkv_intra_bwd`, which hold it to DIR's plain versions, two calls
bit-equal and one kernel a call), each result held to DIR's
plain version (proximity counts, cell-sum bits and assignment maps
exactly; the gate's ids and counts exactly, its probabilities, mean
and float32 d logits within `chip_smoke.GATE_TOL`, bfloat16 d logits
and the attention's output within `chip_smoke.ATTN_TOL`; the mean's sha256 is printed, so two
trees that sum in one order show equal bits). The turns run in the
order given and then reversed (A B, B A). Each prints one JSON line per
shape: the call
(CUDA events over batches of 10, median of 20, as `chip_smoke.py`'s
`time_ms`), the kernel on the device, and everything the call issues
on the device (`torch.profiler`). The card's nvidia-smi line comes
first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (kernel, n, area, range, seed, layout), as in chip_smoke.py
PROXIMITY = (("grid", 10_000, 10_000.0, 250.0, 1, "engine"),
             ("grid", 1_000_000, 100_000.0, 250.0, 2, "engine"),
             ("grid", 10_000, 10_000.0, 250.0, 5, "clustered"),
             ("dense", 2_000, 600.0, 250.0, 3, "engine"),
             ("dense", 10_000, 10_000.0, 250.0, 4, "engine"))
#: (T, E, k, dtype): the gate at prefill (float32, bfloat16) and decode,
#: with chip_smoke.py's logits and zero bias
GATE = ((8192, 128, 8, "float32"), (8192, 128, 8, "bfloat16"),
        (16, 128, 8, "float32"))
#: (T, E, k, dtype) of the training calls: the forward with the
#: probability mean and the backward, at the cut-depth MoE's shape
GATE_TRAIN = ((8192, 128, 8, "float32"), (8192, 128, 8, "bfloat16"))


def proximity(tree: Path, cs, dev):
    import torch
    from repro_torch.core import neighbors
    from repro_torch.kernels.proximity import ops, ref
    for kernel, n, area, rng, seed, layout in PROXIMITY:
        cfg, pos, lp, snd = cs.world(n, area, rng, seed, dev)
        if layout == "clustered":
            pos = cs.clustered(n, area, seed, dev)
        args = (pos, lp, snd, cfg.n_lp, area, rng)
        if kernel == "grid":
            spec = cfg.grid_spec()
            args += (spec, neighbors.build_grid(pos, spec))
            fn, plain = ops.proximity_lp_counts_grid, ref.grid_lp_counts_plain
        else:
            fn, plain = ops.proximity_lp_counts, ref.dense_lp_counts_plain
        call = lambda: fn(*args)  # noqa: E731
        if not torch.equal(call(), plain(*args)):
            raise AssertionError(f"{tree}: {kernel} at n={n}, {layout} "
                                 f"differs from its plain version")
        cs.emit(tree=str(tree), kernel=kernel, n=n, area=area, range=rng,
                layout=layout, ms=cs.time_ms(call),
                kernel_device_ms=cs.device_ms(call, f"{kernel}_lp_counts"),
                **cs.call_profile(call))


def gate(tree: Path, cs, dev):
    import hashlib

    import torch
    from repro_torch.kernels.moe_gate import ops, ref
    for T, E, k, dtype in GATE:
        logits = cs._randn((T, E), T + E, dev, getattr(torch, dtype), 0.7)
        bias = torch.zeros(E, device=dev)
        call = lambda: ops.moe_gate(logits, k, bias=bias)  # noqa: E731
        got, want = call(), ref.moe_gate_plain(logits, k, bias, True)
        err = float((got[0] - want[0]).abs().max())
        if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                and err <= cs.GATE_TOL):
            raise AssertionError(f"{tree}: moe_gate at T={T}, {dtype} "
                                 f"differs from its plain version")
        cs.emit(tree=str(tree), kernel="moe_gate", T=T, E=E, k=k,
                dtype=dtype, max_abs_err=err, ms=cs.time_ms(call),
                kernel_device_ms=cs.device_ms(call, "moe_gate_kernel"),
                **cs.call_profile(call))
    # the training calls, with chip_smoke.py's check_moe_gate_bwd inputs:
    # the forward with the mean, then the backward
    for T, E, k, dtype in GATE_TRAIN:
        dt = getattr(torch, dtype)
        logits = cs._randn((T, E), T + E + 7, dev, dt, 0.7)
        b = cs._randn((E,), E + 3, dev, scale=0.05)
        gtp, gpm = cs._randn((T, k), 21, dev), cs._randn((E,), 22, dev)
        fwd = lambda: ops.moe_gate(logits, k, b, True, prob_mean=True)  # noqa
        _, top_e, counts, pm = fwd()
        want = ref.moe_gate_plain(logits, k, b, True, prob_mean=True)
        pm_err = float((pm - want[3]).abs().max() / want[3].abs().max())
        if not (torch.equal(top_e, want[1]) and torch.equal(counts, want[2])
                and pm_err <= cs.GATE_TOL):
            raise AssertionError(f"{tree}: moe_gate with the mean at T={T}, "
                                 f"{dtype} differs from its plain version")
        bwd = lambda: ops.moe_gate_bwd(logits, top_e, gtp, gpm, True)  # noqa
        dl = bwd().float()
        wg = ref.moe_gate_grads_plain(logits, k, b, True, gtp, gpm)
        err = float((dl - wg).abs().max() / wg.abs().max())
        tol = cs.GATE_TOL if dt == torch.float32 else cs.ATTN_TOL[dt]
        if err > tol:
            raise AssertionError(f"{tree}: moe_gate_bwd at T={T}, {dtype}: "
                                 f"d logits err {err}")
        # the mean's bits, to set the trees' orders side by side
        digest = hashlib.sha256(pm.cpu().numpy().tobytes()).hexdigest()[:16]
        cs.emit(tree=str(tree), kernel="moe_gate_prob_mean", T=T, E=E, k=k,
                dtype=dtype, prob_mean_err=pm_err, prob_mean_sha256=digest,
                ms=cs.time_ms(fwd),
                kernel_device_ms=cs.device_ms(fwd),  # every kernel
                **cs.call_profile(fwd))
        cs.emit(tree=str(tree), kernel="moe_gate_bwd", T=T, E=E, k=k,
                dtype=dtype, max_abs_err=err, ms=cs.time_ms(bwd),
                kernel_device_ms=cs.device_ms(bwd, "moe_gate_bwd_kernel"),
                **cs.call_profile(bwd))


#: chip_smoke.py's cell-sum shapes: (n, area, seed, mobility, replicas)
CELL_SUMS = ((10_000, 10_000.0, 9, "flock", 1),
             (10_000, 10_000.0, 10, "hotspot", 1),
             (10_000, 10_000.0, 40, "flock", 4))


def cell_sums(tree: Path, cs, dev):
    import torch
    from repro_torch.kernels.cell_sums import ops, ref
    for n, area, seed, mobility, replicas in CELL_SUMS:
        pos, vec, grid = cs.cell_sums_inputs(n, area, seed, dev, mobility,
                                             replicas)
        call = lambda: ops.cell_sums(pos, vec, grid)  # noqa: E731
        want = ref.cell_sums_plain(pos.reshape(-1, 2), vec.reshape(-1, 2),
                                   grid)
        if not torch.equal(call().view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{tree}: cell_sums on {replicas} x "
                                 f"{mobility} differs from its plain version")
        cs.emit(tree=str(tree), kernel="cell_sums", n=n, layout=mobility,
                replicas=replicas, ms=cs.time_ms(call),
                kernel_device_ms=cs.device_ms(call, "cell_sums_kernel"),
                **cs.call_profile(call))


def capacity_assign(tree: Path, cs, dev):
    import torch
    from repro_torch.kernels.capacity_assign import ops, ref
    for kind, seed in cs.ASSIGN_SHAPES:
        cost, w, caps = cs.assign_inputs(kind, seed, dev)
        call = lambda: ops.capacity_assign(cost, w, caps)  # noqa: E731
        want = ref.capacity_assign_plain(cost, w, caps)
        if not torch.equal(call().cpu(), want.cpu()):
            raise AssertionError(f"{tree}: capacity_assign on {kind} "
                                 f"differs from its plain version")
        cs.emit(tree=str(tree), kernel="capacity_assign", cost=kind,
                n=cost.shape[0], n_lp=cost.shape[1],
                ms=cs.time_ms(call, reps=10, batch=2),
                kernel_device_ms=cs.device_ms(call, "capacity_assign_kernel"),
                **cs.call_profile(call))


#: (B, H, Hkv, S, D, Dv) of the attention forward in bf16, causal: the
#: prefill of qwen3-moe-30b-a3b, of qwen2-7b (a group of 7, S 4,096) and
#: of deepseek-v3-671b's MLA (Dk 192, Dv 128); then MLA's heads and
#: lengths at D 64 and 128 (no group: every head its own K/V)
ATTENTION = ((16, 32, 4, 512, 64, 64), (1, 28, 4, 4096, 128, 128),
             (16, 128, 128, 512, 192, 128), (16, 128, 128, 512, 64, 64),
             (16, 128, 128, 512, 128, 128))


def attention(tree: Path, cs, dev):
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    bf = torch.bfloat16
    for B, H, Hkv, S, D, Dv in ATTENTION:
        q = cs._randn((B, H, S, D), 1, dev, bf)
        k = cs._randn((B, Hkv, S, D), 2, dev, bf)
        v = cs._randn((B, Hkv, S, Dv), 3, dev, bf)
        call = lambda: ops.flash_attention(q, k, v, True)  # noqa: E731
        try:
            got = call()
        except ValueError as e:  # a tree that does not take the shape
            cs.emit(tree=str(tree), kernel="flash_attention", B=B, H=H,
                    Hkv=Hkv, S=S, D=D, Dv=Dv, refused=str(e)[:120])
            continue
        over, err = cs._attn_err(got, ref.flash_attention_plain(
            q, k, v, True), bf)
        if over > 0:
            raise AssertionError(f"{tree}: flash_attention at "
                                 f"{(B, H, Hkv, S, D, Dv)}: err {err}")
        cs.emit(tree=str(tree), kernel="flash_attention", B=B, H=H, Hkv=Hkv,
                S=S, D=D, Dv=Dv, max_abs_err=err, ms=cs.time_ms(call),
                kernel_device_ms=cs.device_ms(call, "flash_attention"))


def wkv(tree: Path, cs, dev):
    for shape, decay in cs.WKV_CHECKS:
        for kernel, check in (("wkv_intra", cs.check_wkv_intra),
                              ("wkv_intra_bwd", cs.check_wkv_intra_bwd)):
            cs.emit(tree=str(tree), kernel=kernel,
                    **check(*shape, dev, decay))


FAMILIES = {"proximity": proximity, "gate": gate, "cell_sums": cell_sums,
            "capacity_assign": capacity_assign, "attention": attention,
            "wkv": wkv}


def turn(tree: Path, only):
    """One tree's kernels at every shape (runs in its own process)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src/ first: undo it
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}'s")
    dev = torch.device("cuda")
    for family in only:
        FAMILIES[family](tree, cs, dev)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", type=Path,
                   help="roots of checkouts, each with src/repro_torch")
    p.add_argument("--only", nargs="+", choices=list(FAMILIES),
                   default=list(FAMILIES), help="kernel families to time")
    p.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    trees = [t.resolve() for t in a.trees]
    if a.turn:
        turn(trees[0], a.only)
        return
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("compare_kernels.py needs a CUDA GPU; none is visible")
    cs.card()
    env = {k: v for k, v in os.environ.items()
           if k != "REPRO_TORCH_BUILD_DIR"}
    for tree in trees + trees[::-1]:
        subprocess.run([sys.executable, __file__, "--turn", str(tree),
                        "--only", *a.only], check=True, env=env)


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
