"""The gap between the chunked prefill and the exact recurrence of the
recurrent families at full width, on the card by depth and on the CPU.

    python3 tools/recurrent_split_gap.py [--cpu-batch 4] [--out FILE]
    REPRO_FORCE_F32=1 python3 tools/recurrent_split_gap.py ...

For each model of `chip_smoke.RECURRENT_SERVE` (rwkv6-1.6b, zamba2-1.2b)
with phase recurrent_serve's weights (drawn on the card from its seed)
and its prompts, it prints `chip_smoke.chunked_vs_recurrent`'s row
errors: a prefill of 384 tokens and 128 teacher-forced decode steps
against one prefill of 512, per row max |difference| of the last logits
as a share of the largest |logit|.

1. On the card, all 16 prompts, the model cut to its first n layers
   for each n of `--depths` and whole: how the gap grows with depth.
2. With `--plain`, on the card, the whole model through the plain
   versions of the attention kernels (`chip_smoke._gates`).
3. On the CPU (the plain versions and the host's arithmetic, no
   kernel), the whole model with the same weights copied from the card,
   over the first `--cpu-batch` prompts; and the card over the same
   prompts beside it.

Runs in the dtype the port runs in (bfloat16, or float32 under
REPRO_FORCE_F32=1). Needs one GPU. Prints one JSON line per run (the
card's nvidia-smi line first) and appends them to `--out`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu-batch", type=int, default=4,
                   help="prompts run on the CPU (0: none)")
    p.add_argument("--depths", default="rwkv6-1.6b:1,6,12;"
                   "zamba2-1.2b:1,6,7,12,13,24",
                   help="cut depths on the card, ARCH:N,N;...")
    p.add_argument("--plain", action="store_true",
                   help="also the whole model on the card through the "
                   "plain versions")
    p.add_argument("--archs", nargs="+", help="models (default: both)")
    p.add_argument("--out", default="", help="also append the lines here")
    a = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    torch.set_num_threads(os.cpu_count())
    dev = torch.device("cuda")
    depths = dict((arch, [int(n) for n in ns.split(",")]) for arch, ns in
                  (part.split(":") for part in a.depths.split(";") if part))
    out = open(a.out, "a") if a.out else None

    def emit(**kv):
        cs.emit(**kv)
        if out:
            out.write(json.dumps(kv) + "\n")
            out.flush()

    smi = cs.card()
    emit(nvidia_smi=smi, torch=torch.__version__)
    B, P, split, seed = (cs.RECURRENT_SERVE[k] for k in (
        "batch", "prompt_len", "split", "seed"))

    def run(arch, cfg, params, prompts, where, dv):
        t0 = time.perf_counter()
        r = cs.chunked_vs_recurrent(cfg, params, prompts, split, dv)
        emit(arch=arch, where=where, layers=cfg.n_layers,
             rows=prompts.shape[0], dtype=str(lm.COMPUTE_DT), card=smi,
             s=time.perf_counter() - t0, **r)

    for arch in a.archs or cs.RECURRENT_SERVE["archs"]:
        cfg = get_arch(arch)
        params = lm.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        prompts = torch.randint(
            0, cfg.vocab_size, (B, P),
            generator=torch.Generator().manual_seed(seed + 1))
        for n in depths.get(arch, []) + [cfg.n_layers]:
            cut = dataclasses.replace(cfg, n_layers=n)
            run(arch, cut, dict(params, layers=tree.tree_map(
                lambda t: t[:n], params["layers"])), prompts, "card", dev)
        if a.plain:
            with cs._gates(True, []):
                run(arch, cfg, params, prompts, "card, plain versions", dev)
        if a.cpu_batch:
            rows = prompts[:a.cpu_batch]
            run(arch, cfg, params, rows, "card", dev)
            host = tree.tree_map(lambda t: t.cpu(), params)
            del params
            torch.cuda.empty_cache()
            run(arch, cfg, host, rows, "cpu", torch.device("cpu"))
            del host
        else:
            del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
