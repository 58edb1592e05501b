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

    REPRO_FORCE_F32=1 python3 tools/recurrent_split_gap.py --layers \\
        [--cpu-batch 4] [--ulps 8] [--out FILE]

bisects zamba2-1.2b's gap instead, card against CPU, over the first
`--cpu-batch` prompts with the same weights:

1. Layer by layer, for each of its passes in order (the shared block
   before every 6th Mamba2 layer, each Mamba2 layer): the card's
   chunked hidden state against the CPU's, free-running (`free`); then,
   teacher-forced on the CPU's chunked input to the pass, the pass over
   all P tokens (`chunked`) and over `split` tokens followed by P -
   split exact decode steps (`recurrent`), card against CPU; and on each
   device the pass's own split gap (`gap_card`, `gap_cpu`: the
   recurrent rows against the chunked rows). A distance is the largest
   |difference| as a share of the largest |value|, the same in float32
   ULPs of that value (`ulps`), and the median row's share. The shared
   block's passes also through the plain versions of the attention
   kernels on the card (`*_plain`).
2. Op by op, under a dispatch mode that reruns every aten op of the
   card on the CPU on copies of the same inputs: the first Mamba2 pass
   whose chunked or recurrent distance passes `--ulps` ULPs (else the
   first Mamba2 pass) and the first shared-block pass through the plain
   versions, each over all P tokens and as its last decode step
   (teacher-forced on the CPU's input and carry). Each op's largest
   |difference| in ULPs of its output's largest |value| and elementwise
   (over the spacing at the CPU's value); the ops by distance, and every
   op in order in `--out`.
3. End to end, the gap of the whole model on the card and on the CPU
   over the same prompts.

It first measures, on the card and on the CPU, how far the last rows of
a float32 product of 2,048 rows (a prefill's 4 x 512 tokens) are from
the same rows multiplied alone as a 4-row product (a decode step's), at
the shapes of zamba2's shared block (K 4,096 to N 4,096 and 8,192, K
8,192 to N 2,048), in ULPs of the output's largest |value|: the
summation orders a library picks for the two row counts.

"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ulp(x: float) -> float:
    """The float32 spacing at |x| (normal numbers)."""
    return 2.0 ** (math.frexp(abs(x))[1] - 24) if x else 2.0 ** -149


def _dist(got, want) -> dict:
    """The largest |got - want| as a share of the largest |want| and in
    float32 ULPs of it, and the median row's share."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(w.abs().max())
    d = (g - w).abs()
    top = float(d.max()) if d.numel() else 0.0
    rows = d.reshape(-1, d.shape[-1]).amax(-1) if d.dim() else d[None]
    return {"max": top / scale if scale else top, "ulps": top / _ulp(scale),
            "row_median": float(rows.median()) / scale if scale else 0.0}


def _elem_ulps(got, want) -> float:
    """The largest |got - want| over the float32 spacing at each of
    want's nonzero values."""
    import torch
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    keep = (w != 0) & torch.isfinite(w) & torch.isfinite(g)
    if not bool(keep.any()):
        return 0.0
    aw = w[keep].abs()
    spacing = torch.nextafter(aw, torch.full_like(aw, math.inf)) - aw
    return float(((g[keep] - w[keep]).abs() / spacing).max())


def _op_by_op(fn, where: list):
    """Run fn() on the card under a dispatch mode that reruns each aten
    op on the CPU on copies of the op's inputs; append (op, shape,
    ulps of the output's scale, elementwise ulps) of each floating
    output to `where`. Returns fn()'s result."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map

    cpu = torch.device("cpu")

    def host(t):
        if isinstance(t, torch.Tensor):
            return t.detach().to(cpu, copy=True)
        if isinstance(t, torch.device):
            return cpu
        return t

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func.overloadpacket.__name__)
            skip = "empty" in name or name in ("set_", "_local_scalar_dense")
            if not skip:
                cargs, ckw = tree_map(host, args), tree_map(host, kwargs)
            out = func(*args, **kwargs)
            if skip:
                return out
            with torch.no_grad():
                want = func(*cargs, **ckw)
            got_l, want_l = tree_flatten(out)[0], tree_flatten(want)[0]
            for g, w in zip(got_l, want_l):
                if (isinstance(g, torch.Tensor) and g.is_floating_point()
                        and g.numel()):
                    d = _dist(g, w)
                    where.append({"op": name, "shape": list(g.shape),
                                  "ulps": d["ulps"], "max": d["max"],
                                  "elem_ulps": _elem_ulps(g, w)})
            return out

    with Mode():
        return fn()


#: (K, N) of zamba2-1.2b's shared-block products: the attention's
#: projections at 2 d, the MLP's up and down
GEMMS = ((4096, 4096), (4096, 8192), (8192, 2048))


def gemm_rows(dev, rows: int = 2048, tail: int = 4) -> list:
    """The last `tail` rows of a (rows, K) x (K, N) float32 product
    against the same rows multiplied alone, on `dev`, for each (K, N)
    of GEMMS: `_dist` of each."""
    import torch
    gen = torch.Generator().manual_seed(0)
    out = []
    for K, N in GEMMS:
        x = torch.randn((rows, K), generator=gen).to(dev)
        w = (torch.randn((K, N), generator=gen) * K ** -0.5).to(dev)
        full = torch.matmul(x, w)[-tail:]
        alone = torch.matmul(x[-tail:].clone(), w)
        out.append({"K": K, "N": N, "rows": rows, "tail": tail,
                    **_dist(alone, full)})
    return out


def _passes(cfg):
    """zamba2's passes in order: ("shared", i) before Mamba2 layer i
    where the shared block runs, and ("mamba2", i)."""
    from repro_torch.models import lm
    out = []
    for i in range(cfg.n_layers):
        if lm.shared_slot(cfg, i) is not None:
            out.append(("shared", i))
        out.append(("mamba2", i))
    return out


def _run_pass(kind, i, params, x, emb0, cfg, split, full_only=False,
              last=None):
    """One pass on x (B, P, d) (emb0: the embeddings, for the shared
    block): (its output over all P tokens, its rows split.. from a pass
    over `split` tokens and P - split exact decode steps, or None with
    `full_only`). `last` receives the last decode step's arguments."""
    import torch
    from repro_torch.models import blocks, lm, mamba2
    B, P = x.shape[:2]
    if kind == "shared":
        sp = params["shared_block"]
        full, _ = blocks.shared_block_fwd(sp, x, emb0, cfg=cfg)
        if full_only:
            return full, None
        _, (k, v) = blocks.shared_block_fwd(
            sp, x[:, :split], emb0[:, :split], cfg=cfg, return_kv=True)
        kv = {n: t.new_zeros((B, P, *t.shape[2:])) for n, t in
              (("k", k), ("v", v))}
        kv["k"][:, :split], kv["v"][:, :split] = k, v
        steps = []
        for t in range(split, P):
            if last is not None and t == P - 1:
                last.update(x=x[:, t:t + 1], e=emb0[:, t:t + 1],
                            kv={n: c.clone() for n, c in kv.items()}, t=t)
            y, kv = blocks.shared_block_decode(
                sp, x[:, t:t + 1], emb0[:, t:t + 1], kv, t, cfg=cfg)
            steps.append(y)
        return full, torch.cat(steps, 1)
    p_l = lm.layer(params["layers"], i)
    zero = lm.zero_mamba_carry(cfg, B, x.device)
    full, _ = mamba2.mamba2_fwd(p_l, x, zero, cfg=cfg)
    if full_only:
        return full, None
    _, carry = mamba2.mamba2_fwd(p_l, x[:, :split], zero, cfg=cfg)
    steps = []
    for t in range(split, P):
        if last is not None and t == P - 1:
            last.update(x=x[:, t:t + 1], carry=carry)
        y, carry = mamba2.mamba2_fwd(p_l, x[:, t:t + 1], carry, cfg=cfg,
                                     decode=True)
        steps.append(y)
    return full, torch.cat(steps, 1)


def _op_rows(kind, i, params, inp, last, cfg, dev, plain, emit, out,
             what):
    """Op by op (`_op_by_op`) of pass (kind, i) on the card over all P
    tokens from the CPU's input `inp` (x, emb0), and as its last decode
    step from the CPU's `last`; emits the ops by distance and writes
    every op in order to `out`."""
    import torch
    from repro_torch import tree
    from repro_torch.models import blocks, lm, mamba2
    import chip_smoke as cs
    on = lambda t: tree.tree_map(lambda a: a.to(dev), t)  # noqa: E731
    x, e = on(inp[0]), on(inp[1])
    p_l = (params["shared_block"] if kind == "shared"
           else lm.layer(params["layers"], i))

    def chunked():
        if kind == "shared":
            return blocks.shared_block_fwd(p_l, x, e, cfg=cfg)[0]
        return mamba2.mamba2_fwd(p_l, x, lm.zero_mamba_carry(
            cfg, x.shape[0], dev), cfg=cfg)[0]

    def step():
        if kind == "shared":
            return blocks.shared_block_decode(
                p_l, on(last["x"]), on(last["e"]), on(last["kv"]),
                last["t"], cfg=cfg)[0]
        return mamba2.mamba2_fwd(p_l, on(last["x"]), on(last["carry"]),
                                 cfg=cfg, decode=True)[0]

    for form, fn in (("chunked", chunked), ("decode step", step)):
        rows = []
        with cs._gates(plain, []):
            _op_by_op(fn, rows)
        top = sorted(rows, key=lambda r: -r["ulps"])[:12]
        emit(bisect="op by op", what=what, pass_kind=kind, layer=i,
             form=form, plain_attention=plain, ops=len(rows),
             ops_differing=sum(r["ulps"] > 0 for r in rows), top=top)
        if out:
            out.write(json.dumps({"ops_in_order": rows, "what": what,
                                  "form": form}) + "\n")


def layers(cfg, params, prompts, split, dev, emit, ulps, out, smi):
    """The `--layers` bisect of one hybrid model (module docstring)."""
    import torch
    from repro_torch import tree
    from repro_torch.models.layers import embed_fwd
    import chip_smoke as cs
    cpu = torch.device("cpu")
    host = tree.tree_map(lambda t: t.to(cpu), params)
    prompts = prompts.to(cpu)
    x_c = e_c = embed_fwd(host["embed"], prompts)
    x_free = embed_fwd(params["embed"], prompts.to(dev))
    e_g = e_c.to(dev)
    passes = _passes(cfg)
    inputs, first = [], None
    for kind, i in passes:
        t0 = time.perf_counter()
        inputs.append((x_c, e_c))
        full_c, rec_c = _run_pass(kind, i, host, x_c, e_c, cfg, split)
        x_g = x_c.to(dev)
        full_g, rec_g = _run_pass(kind, i, params, x_g, e_g, cfg, split)
        free_g, _ = _run_pass(kind, i, params, x_free, e_g, cfg, split,
                              full_only=True)
        row = {"pass": kind, "layer": i,
               "free": _dist(free_g, full_c),
               "chunked": _dist(full_g, full_c),
               "recurrent": _dist(rec_g, rec_c),
               "gap_card": _dist(rec_g, full_g[:, split:]),
               "gap_cpu": _dist(rec_c, full_c[:, split:])}
        if kind == "shared":
            with cs._gates(True, []):
                pf, pr = _run_pass(kind, i, params, x_g, e_g, cfg, split)
            row.update(chunked_plain=_dist(pf, full_c),
                       recurrent_plain=_dist(pr, rec_c),
                       gap_card_plain=_dist(pr, pf[:, split:]))
        elif first is None and max(row["chunked"]["ulps"],
                                   row["recurrent"]["ulps"]) > ulps:
            first = (kind, i, len(inputs) - 1)
        row["s"] = time.perf_counter() - t0
        emit(bisect="layer", arch=cfg.name, card=smi, **row)
        x_c, x_free = full_c, free_g
        del full_g, rec_g, rec_c
    mamba0 = next(j for j, (k, _) in enumerate(passes) if k == "mamba2")
    shared0 = next(j for j, (k, _) in enumerate(passes) if k == "shared")
    targets = [first or (*passes[mamba0], mamba0),
               (*passes[shared0], shared0)]
    for kind, i, j in targets:
        last = {}
        x_in, e_in = inputs[j]
        _run_pass(kind, i, host, x_in, e_in, cfg, split, last=last)
        what = ("first Mamba2 pass past the ULP limit" if first and
                kind == "mamba2" and (kind, i, j) == first else
                f"first {kind} pass")
        _op_rows(kind, i, params, (x_in, e_in), last, cfg, dev,
                 kind == "shared", emit, out, what)


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
    p.add_argument("--layers", action="store_true",
                   help="bisect zamba2-1.2b layer by layer and op by op, "
                   "card against CPU, instead")
    p.add_argument("--ulps", type=float, default=8.0,
                   help="with --layers: the distance, in ULPs of a pass's "
                   "output, that picks the pass to run op by op")
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

    if a.layers:
        for where, dv in (("card", dev), ("cpu", torch.device("cpu"))):
            emit(bisect="gemm rows", where=where, card=smi,
                 products=gemm_rows(dv))
        cfg = get_arch("zamba2-1.2b")
        params = lm.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        rows = torch.randint(
            0, cfg.vocab_size, (B, P),
            generator=torch.Generator().manual_seed(seed + 1))[
                :a.cpu_batch or B]
        layers(cfg, params, rows, split, dev, emit, a.ulps, out, smi)
        run(cfg.name, cfg, params, rows, "card", dev)
        host = tree.tree_map(lambda t: t.cpu(), params)
        del params
        run(cfg.name, cfg, host, rows, "cpu", torch.device("cpu"))
        return
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
