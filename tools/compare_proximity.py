"""Time the proximity kernels of several checkouts of this repo in turns,
on one GPU.

    python3 tools/compare_proximity.py DIR [DIR ...]

Each DIR is the root of a checkout: `.` for this one, or an earlier
commit unpacked under a git-ignored directory
(`mkdir -p dist/old && git archive REV | tar -x -C dist/old`). A turn is
one process that imports DIR's `repro_torch`, builds its kernels into
DIR's own build directory, and calls its two wrappers
(`ops.proximity_lp_counts_grid`, `ops.proximity_lp_counts`: every build
keeps their signatures, whatever its C interface) at the shapes
`chip_smoke.py` checks, each result held exactly to DIR's plain version.
The turns run in the order given and then reversed (A B, B A). Each
prints one JSON line per shape: the call (CUDA events over batches of
10, median of 20, as `chip_smoke.py`'s `time_ms`), the kernel on the
device, and everything the call issues on the device (`torch.profiler`).
The card's nvidia-smi line comes first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (kernel, n, area, range, seed, layout), as in chip_smoke.py
SHAPES = (("grid", 10_000, 10_000.0, 250.0, 1, "engine"),
          ("grid", 1_000_000, 100_000.0, 250.0, 2, "engine"),
          ("grid", 10_000, 10_000.0, 250.0, 5, "clustered"),
          ("dense", 2_000, 600.0, 250.0, 3, "engine"),
          ("dense", 10_000, 10_000.0, 250.0, 4, "engine"))


def turn(tree: Path):
    """One tree's kernels at every shape (runs in its own process)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src/ first: undo it
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.core import neighbors
    from repro_torch.kernels.proximity import ops, ref
    if not Path(ops.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {ops.__file__}, not {tree}'s")
    dev = torch.device("cuda")
    for kernel, n, area, rng, seed, layout in SHAPES:
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


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", type=Path,
                   help="roots of checkouts, each with src/repro_torch")
    p.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    trees = [t.resolve() for t in a.trees]
    if a.turn:
        turn(trees[0])
        return
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("compare_proximity.py needs a CUDA GPU; none is visible")
    cs.card()
    env = {k: v for k, v in os.environ.items()
           if k != "REPRO_TORCH_BUILD_DIR"}
    for tree in trees + trees[::-1]:
        subprocess.run([sys.executable, __file__, "--turn", str(tree)],
                       check=True, env=env)


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
