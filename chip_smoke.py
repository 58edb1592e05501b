"""Drive the PyTorch/CUDA port (`src/repro_torch`) end to end on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero
and prints no result):

  1. card     the GPU's name and power limit (nvidia-smi), torch, CUDA
  2. build    the five kernels built from the checkout's sources, with
              nvcc's -Xptxas -v figures (registers, shared memory,
              spills) of every kernel
  3. kernels  each kernel held against its plain PyTorch version on the
              card (exact integer counts for the proximity kernels; ids
              and counts exact, top_p to 1e-5 for the MoE gate; 1e-5 in
              float32 and 2e-2 in bfloat16 for the attention kernels),
              at the shapes the main paths give it and at one more (the
              cell-list kernel also on a clustered world whose grid
              overflows); CUDA-event times of the kernel and the plain
              version, the kernel's device time (torch.profiler) and,
              for the proximity kernels and the MoE gate, every kernel
              and memset the call issues on the device (a gate call
              must be one kernel; its shapes add a nonzero bias and
              tie-heavy logits), the bound and, for
              the attention kernels, PyTorch's fused attention, both as
              a call (library_ms, beside ms) and on the device
              (library_device_ms, beside kernel_device_ms); first, one
              line with the device time of an empty kernel launched the
              same way (the floor under microsecond kernels)
  4. main     the default EngineConfig() (10k SEs, 1,200 steps) with
              GAIA off and on through the cell-list kernel, and a world
              with area / range < 3 through the dense kernel; launch
              counts are set to 0 just before and read just after
  5. scale    a 1M-SE window (area 100,000, paper density)
  6. cpu      the port on the card against the port on the CPU: integer
              series identical, positions within one ULP of `area`
  7. serve    qwen3-moe-30b-a3b at full width and depth (48 layers,
              random weights drawn on the card) serving 16 prompts of
              512 tokens and 64 greedy steps with GAIA expert placement
              (examples/serve_moe.py's settings); launch counts set to
              0 just before and read just after. Then the same with GAIA
              off (tokens must be identical: placement is transparent),
              and every layer of the same prefill and decode, teacher-
              forced on the kernels' tokens and hidden states, through
              the kernels and through their plain versions (rows that
              route alike agree within the bf16 tolerance)
  8. serve_cpu the smoke config on the card against the port on the CPU,
              teacher-forced (logits within the bf16 tolerance)

Every line but the last is one JSON object (the card's nvidia-smi line
excepted); the last is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile 20

instead builds the kernels and measures 20 steps of the default config
(after 5 warm-up ones): each phase's elapsed time on the stream (CUDA
events), the untraced time per step, and, from a `torch.profiler` trace
of 20 more, the device's busy time per step (the union of its kernels'
intervals; its share of the untraced step is the busy share) and its
kernels by time. It prints no result line.

    python3 chip_smoke.py --profile-serve 8

does the same for the serve phase's model: one traced prefill, then 8
untraced and 8 traced decode steps.

    python3 chip_smoke.py --gen 4 --steps 50 --dense-steps 20 \
        --scale-steps 3 --cpu-steps 20

is a shake-out run that cuts every phase short (--gen sets the serve
phase's decode steps).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the
#: tensor cores, bfloat16 on the tensor cores (dense)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12
#: kernel against plain version, as in tests/test_torch_attention.py
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: top_p of the MoE gate against its plain version
GATE_TOL = 1e-5
#: logits of two bf16 runs (phase serve_cpu: the 2-layer smoke model,
#: card against CPU; phase serve: after the last layer, kernels against
#: plain versions on the same input), per (step, row), as a share of the
#: largest |logit|: the median row within SERVE_TYP (about one bfloat16
#: ULP, carried through the layers), every row within SERVE_MAX (a token
#: whose top-k boundary lies within that noise routes to another expert
#: in some layer)
SERVE_TYP = 1e-2
SERVE_MAX = 0.15
#: phase serve, layer by layer: a row whose routing agrees between the
#: kernels and the plain versions is within LAYER_TOL of the layer
#: output's largest |value| (a couple of bfloat16 ULPs); at most
#: FLIP_MAX of the rows route differently (their top-k boundary lies
#: within the two versions' rounding difference)
LAYER_TOL = 2e-2
FLIP_MAX = 0.05
#: float32 operations per pair test: 2 sub, 2 abs, 2 sub (area - d),
#: 2 min, 1 mul, 1 fma (2), 1 compare
OPS_PER_PAIR = 12
#: float32 positions stay in [0, area); one ULP of `area` bounds a
#: rounding difference anywhere in that range
ULP = 2.0 ** -23


def emit(**kv):
    print(json.dumps(kv), flush=True)


def time_ms(fn, reps: int = 20, batch: int = 10, warmup: int = 3) -> float:
    """Median over `reps` runs of the CUDA-event time of `batch` calls
    of fn() issued back to back, per call, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def device_profile(fn, kernel=None, calls: int = 20):
    """(ms, kernels per call, names) of the CUDA kernels whose names hold
    `kernel` (every kernel when None), per call of fn(), over `calls`
    calls (torch.profiler); ms is None when none ran."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and (kernel is None or kernel in e.name)]
    ms = sum(e.time_range.elapsed_us() for e in ev) / calls / 1e3
    return (ms if ev else None), len(ev) / calls, sorted(
        {e.name[:80] for e in ev})


def device_ms(fn, kernel=None, calls: int = 20):
    """Duration on the device of the CUDA kernels whose names hold
    `kernel` (every kernel when None), per call of fn(), in ms."""
    return device_profile(fn, kernel, calls)[0]


def card():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    emit(phase="card", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return line


def _kernel_name(mangled: str) -> str:
    """`flash_decode_kernel<bf16,64>` from an Itanium-mangled name: the
    first length-prefixed identifier ending in "kernel", with its
    template arguments (types float / bf16, integer literals)."""
    i, name, rest = 0, mangled, ""
    while i < len(mangled):
        if not mangled[i].isdigit():
            i += 1
            continue
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        ident, i = mangled[j:j + n], j + n
        if ident.endswith("kernel"):
            name, rest = ident, mangled[i:]
            break
    args, k = [], 1
    while rest.startswith("I") and k < len(rest) and rest[k] != "E":
        if rest[k] == "f":
            args.append("f32")
            k += 1
        elif rest.startswith("13__nv_bfloat16", k):
            args.append("bf16")
            k += len("13__nv_bfloat16")
        elif rest[k] == "L":
            end = rest.index("E", k)
            args.append(rest[k + 2:end])
            k = end + 1
        else:
            break
    return f"{name}<{','.join(args)}>" if args else name


def build():
    from repro_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    libs = kbuild.build_all()
    ptxas = {stem: [{"kernel": _kernel_name(r["function"]),
                     **{k: r.get(k) for k in ("registers", "smem_bytes",
                                              "spill_stores",
                                              "spill_loads")}}
                    for r in kbuild.ptxas_report(lib)]
             for stem, lib in sorted(libs.items())}
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=sorted(str(p.name) for p in libs.values()), ptxas=ptxas)


def world(n: int, area: float, rng: float, seed: int, dev):
    """Positions, LPs and senders as the main path gives them: the
    engine's own init and sender draw."""
    from repro_torch import random as trandom
    from repro_torch.core.abm import ABMConfig, init_abm
    cfg = ABMConfig(n_se=n, area=area, interaction_range=rng)
    k1, k2 = trandom.split(trandom.key(seed))
    st = init_abm(k1, cfg, dev)
    sender = trandom.bernoulli(k2, cfg.p_interact, (n,), device=dev)
    return cfg, st["pos"], st["lp"], sender


def clustered(n: int, area: float, seed: int, dev):
    """(n, 2) float32 positions in three tight blobs (as the clustered
    layout of tests/test_torch_neighbors.py): cells far fuller than the
    uniform capacity, so the grid overflows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.tensor([[0.1, 0.1], [0.5, 0.9], [0.9, 0.4]],
                           dtype=torch.float64, device=dev) * area
    noise = torch.randn((n, 2), generator=g, dtype=torch.float64,
                        device=dev)
    pos = centers[torch.arange(n, device=dev) % 3] + noise * 0.015 * area
    return (pos % area).to(torch.float32)


def call_profile(call) -> dict:
    """Every kernel and memset the call issues on the device: ms and
    count per call, and their names."""
    ms, per_call, names = device_profile(call)
    return {"call_device_ms": ms, "call_device_ops_per_call": per_call,
            "call_device_ops": names}


def check_grid(n, area, rng, seed, dev, layout="engine"):
    """The cell-list kernel against its plain version, exactly, on the
    engine's own world or (layout "clustered") on three blobs, where the
    grid must overflow and the drop set matters."""
    from repro_torch.core import neighbors
    from repro_torch.kernels.proximity import ops, ref
    cfg, pos, lp, snd = world(n, area, rng, seed, dev)
    if layout == "clustered":
        pos = clustered(n, area, seed, dev)
    spec = cfg.grid_spec()
    grid = neighbors.build_grid(pos, spec)
    args = (pos, lp, snd, cfg.n_lp, area, rng, spec, grid)
    got = ops.proximity_lp_counts_grid(*args)
    want = ref.grid_lp_counts_plain(*args)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    overflow = bool(grid["overflow"])
    if err != 0 or overflow != (layout == "clustered"):
        raise AssertionError(f"grid kernel at n={n}, {layout}: "
                             f"max_abs_err={err}, overflow={overflow}")
    # work this run's data needs: every sender tests the members of its
    # 9 cells' windows (up to capacity), less itself where it is in one
    seg = grid["counts"].clamp(max=spec.capacity)
    nc = spec.ncell
    cx, cy = grid["cell"] // nc, grid["cell"] % nc
    cand = sum(seg[((cx + di) % nc) * nc + (cy + dj) % nc]
               for di in (-1, 0, 1) for dj in (-1, 0, 1))
    rank = torch.arange(n, device=dev) - grid["starts"][grid["cell_sorted"]]
    in_window = torch.empty_like(rank)
    in_window[grid["order"]] = (rank < spec.capacity).long()
    pairs = int((cand - in_window)[snd].sum())
    # pos, lp, sender flag, order and cell_sorted per row, the CSR
    # offsets, the output
    nbytes = n * (8 + 4 + 1 + 8 + 4) + nc * nc * 16 + n * cfg.n_lp * 4
    call = lambda: ops.proximity_lp_counts_grid(*args)  # noqa: E731
    return {"n": n, "area": area, "range": rng, "layout": layout,
            "capacity": spec.capacity,
            "max_cell": int(grid["counts"].max()), "overflow": overflow,
            "max_abs_err": err, "ms": time_ms(call),
            "kernel_device_ms": device_ms(call, "grid_lp_counts_kernel"),
            **call_profile(call),
            "plain_ms": time_ms(lambda: ref.grid_lp_counts_plain(*args),
                                batch=1),
            **bound(nbytes, pairs * OPS_PER_PAIR), "pair_tests": pairs,
            "library_ms": None}


def check_dense(n, area, rng, seed, dev):
    from repro_torch.kernels.proximity import ops, ref
    cfg, pos, lp, snd = world(n, area, rng, seed, dev)
    args = (pos, lp, snd, cfg.n_lp, area, rng)
    got = ops.proximity_lp_counts(*args)
    want = ref.dense_lp_counts_plain(*args)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err != 0:
        raise AssertionError(f"dense kernel at n={n}: max_abs_err={err}")
    pairs = int(snd.sum()) * (n - 1)
    nbytes = n * (8 + 4 + 1) + n * cfg.n_lp * 4
    call = lambda: ops.proximity_lp_counts(*args)  # noqa: E731
    return {"n": n, "area": area, "range": rng, "max_abs_err": err,
            "ms": time_ms(call),
            "kernel_device_ms": device_ms(call, "dense_lp_counts_kernel"),
            **call_profile(call),
            "plain_ms": time_ms(lambda: ref.dense_lp_counts_plain(*args),
                                batch=1, warmup=1),
            **bound(nbytes, pairs * OPS_PER_PAIR), "pair_tests": pairs,
            "library_ms": None}


def launch_floor():
    """The device time of an empty kernel launched as the proximity
    kernels are (a ctypes C entry on the current stream): the floor
    under their microsecond device times."""
    from repro_torch.kernels import build as kbuild
    fn = kbuild.load("proximity_dense").proximity_empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def call():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel did not launch")
    emit(phase="launch_floor", kernel="empty_kernel<<<1, 32>>>",
         device_ms=device_ms(call, "empty_kernel"), ms=time_ms(call))


def bound(nbytes: int, ops: int, peak_ops: float = PEAK_F32_S) -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _randn(shape, seed, dev, dtype=torch.float32, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _attn_err(got, want, dtype):
    """Largest |got - want| beyond the stated tolerance's slack (<= 0
    passes), and the largest |got - want|."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    tol = ATTN_TOL[dtype]
    return float((d - tol * (1 + w.abs())).max()), float(d.max())


def check_moe_gate(T, E, k, dtype, dev, bias=False, ties=False):
    """The MoE gate against its plain version (ids and counts exact,
    top_p within GATE_TOL); a call must be one operation on the device.
    The bias is zeros, as the serve path's router bias, unless `bias`;
    `ties` rounds the logits to halves, so that many probabilities tie
    exactly and the lower id must win."""
    from repro_torch.kernels.moe_gate import ops, ref
    logits = _randn((T, E), T + E, dev, dtype, scale=0.7)
    if ties:
        logits = torch.round(logits * 2) / 2
    b = _randn((E,), E + 1, dev, scale=0.1) if bias else torch.zeros(
        E, device=dev)
    got = ops.moe_gate(logits, k, bias=b)
    want = ref.moe_gate_plain(logits, k, b, True)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    what = f"moe_gate at T={T}, E={E}, k={k}, {dtype}, bias={bias}, " \
           f"ties={ties}"
    if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
            and err <= GATE_TOL):
        raise AssertionError(f"{what}: ids/counts differ or top_p err {err}")
    esize = logits.element_size()
    nbytes = T * E * esize + E * 4 + T * k * 8 + E * 4
    # per row: sub, exp, sum, div and bias add over E, k compare sweeps
    ops_n = T * E * (5 + 2 * k)
    call = lambda: ops.moe_gate(logits, k, bias=b)  # noqa: E731
    prof = call_profile(call)
    if prof["call_device_ops_per_call"] != 1:
        raise AssertionError(f"{what}: a call issued {prof} on the device, "
                             f"not one kernel")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"T": T, "E": E, "k": k, "dtype": str(dtype).split(".")[-1],
            "bias": bias, "ties": ties, "blocks": ops.grid_plan(T, sms),
            "max_abs_err": err, "ms": time_ms(call),
            "kernel_device_ms": device_ms(call, "moe_gate_kernel"), **prof,
            "plain_ms": time_ms(lambda: ref.moe_gate_plain(
                logits, k, b, True), batch=1),
            **bound(nbytes, ops_n), "library_ms": None}


def check_flash_attention(B, H, Hkv, S, D, dtype, dev):
    from repro_torch.kernels.flash_attention import ops, ref
    F = torch.nn.functional
    q = _randn((B, H, S, D), 1, dev, dtype)
    k = _randn((B, Hkv, S, D), 2, dev, dtype)
    v = _randn((B, Hkv, S, D), 3, dev, dtype)
    got = ops.flash_attention(q, k, v, True)
    want = ref.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    over, err = _attn_err(got, want, dtype)
    if over > 0:
        raise AssertionError(f"flash_attention at {(B, H, Hkv, S, D)} "
                             f"{dtype}: max_abs_err {err}")
    esize = q.element_size()
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * esize
    pairs = B * H * S * (S + 1) // 2  # causal (query, key) pairs
    ops_n = 4 * D * pairs  # QK^T and PV, a multiply and an add each
    peak = PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_F32_S
    call = lambda: ops.flash_attention(q, k, v, True)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    return {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "causal": True,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "ms": time_ms(call),
            "kernel_device_ms": device_ms(call, "flash_attention"),
            "plain_ms": time_ms(lambda: ref.flash_attention_plain(
                q, k, v, True), batch=1),
            **bound(nbytes, ops_n, peak),
            "library_ms": time_ms(lib), "library_device_ms": device_ms(lib)}


def check_flash_decode(B, H, Hkv, S, D, pos, dtype, dev):
    from repro_torch.kernels.flash_decode import ops, ref
    F = torch.nn.functional
    q = _randn((B, H, D), 4, dev, dtype)
    kc = _randn((B, S, Hkv, D), 5, dev, dtype)
    vc = _randn((B, S, Hkv, D), 6, dev, dtype)
    got = ops.flash_decode(q, kc, vc, pos)
    want = ref.flash_decode_plain(q, kc, vc, pos)
    torch.cuda.synchronize()
    over, err = _attn_err(got, want, dtype)
    if over > 0:
        raise AssertionError(f"flash_decode at {(B, H, Hkv, S, D, pos)} "
                             f"{dtype}: max_abs_err {err}")
    esize = q.element_size()
    n = pos + 1  # the cache rows this call must read
    nbytes = (2 * B * H * D + 2 * B * n * Hkv * D) * esize
    ops_n = 4 * B * H * D * n
    peak = PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_F32_S
    qs = q[:, :, None]
    ks, vs = (c[:, :n].transpose(1, 2) for c in (kc, vc))
    call = lambda: ops.flash_decode(q, kc, vc, pos)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, enable_gqa=True)
    dev_ms, per_call, names = device_profile(call)  # every kernel it runs
    return {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "pos": pos,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "ms": time_ms(call), "kernel_device_ms": dev_ms,
            "device_kernels_per_call": per_call, "device_kernels": names,
            "plain_ms": time_ms(lambda: ref.flash_decode_plain(
                q, kc, vc, pos), batch=1),
            **bound(nbytes, ops_n, peak),
            "library_ms": time_ms(lib), "library_device_ms": device_ms(lib)}


def check_lm_kernels(dev):
    """The three kernels of the serving path at the shapes qwen3-moe-
    30b-a3b's prefill (16 x 512 tokens) and decode (16 tokens, cache
    576) give them, and more: the gate in bfloat16, with a nonzero bias
    and on tie-heavy logits, the attention kernels in float32."""
    bf, f32 = torch.bfloat16, torch.float32
    return {
        "moe_gate": [check_moe_gate(8192, 128, 8, f32, dev),
                     check_moe_gate(16, 128, 8, f32, dev),
                     check_moe_gate(8192, 128, 8, bf, dev),
                     check_moe_gate(8192, 128, 8, f32, dev, bias=True),
                     check_moe_gate(8192, 128, 8, f32, dev, ties=True)],
        "flash_attention": [
            check_flash_attention(16, 32, 4, 512, 64, bf, dev),
            check_flash_attention(2, 8, 2, 384, 128, f32, dev)],
        "flash_decode": [
            check_flash_decode(16, 32, 4, 576, 64, 543, bf, dev),
            check_flash_decode(4, 8, 2, 1000, 128, 777, f32, dev)],
    }


def _row_errs(got_logits, want_logits):
    """Per (step, row) max |got - want| as a share of the largest |want|
    over all steps."""
    scale = max(float(w.float().abs().max()) for w in want_logits)
    errs = torch.stack([(g.float().cpu() - w.float().cpu()).abs().amax(-1)
                        for g, w in zip(got_logits, want_logits)])
    return errs / scale, scale


def _check_logits(what, got_logits, want_logits):
    errs, scale = _row_errs(got_logits, want_logits)
    q = torch.quantile(errs.flatten(),
                       torch.tensor([0.5, 0.9, 1.0])).tolist()
    out = {"logit_scale": scale, "row_err_median": q[0],
           "row_err_p90": q[1], "row_err_max": q[2]}
    if q[0] > SERVE_TYP or q[2] > SERVE_MAX:
        raise AssertionError(f"{what}: logits differ beyond the bf16 "
                             f"tolerance: {out}")
    return out


@contextmanager
def _gates(plain: bool, picks: list):
    """Run the model through the kernels (or, with `plain`, through
    their plain versions) and record each MoE gate call's expert ids in
    `picks`."""
    from repro_torch.kernels.flash_attention import ops as fa, ref as far
    from repro_torch.kernels.flash_decode import ops as fd, ref as fdr
    from repro_torch.kernels.moe_gate import ops as mg, ref as mgr
    gate = mgr.moe_gate_plain if plain else mg.moe_gate

    def recorded(*args, **kw):
        out = gate(*args, **kw)
        picks.append(out[1])
        return out

    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(mg, "moe_gate", recorded))
        if plain:
            stack.enter_context(mock.patch.object(
                fa, "flash_attention", far.flash_attention_plain))
            stack.enter_context(mock.patch.object(
                fd, "flash_decode", fdr.flash_decode_plain))
        yield


class _Agreement:
    """Rows of one layer's output through the kernels against the same
    layer through the plain versions, on the same input."""

    def __init__(self):
        self.errs, self.flips, self.rows = [], 0, 0

    def add(self, got, want, picks_got, picks_want):
        g = got.reshape(-1, got.shape[-1]).float()
        w = want.reshape(-1, want.shape[-1]).float()
        flip = (picks_got.sort(1).values != picks_want.sort(1).values).any(1)
        err = (g - w).abs().amax(-1) / g.abs().max()
        self.errs.append(err[~flip])
        self.flips += int(flip.sum())
        self.rows += g.shape[0]

    def summary(self):
        e = torch.cat(self.errs)
        return {"rows": self.rows, "flipped_share": self.flips / self.rows,
                "agreeing_row_err_median": float(e.median()),
                "agreeing_row_err_max": float(e.max())}


def layerwise_vs_plain(cfg, seed, prompts, tokens, dev):
    """Prefill and decode teacher-forced on the kernel run's tokens and,
    layer by layer, on the kernel path's hidden state: every layer (and
    the logits after the last) is computed through the kernels and
    through their plain versions from the same input, so the two are
    compared without the divergence a random-weight 48-layer model
    builds from bf16 rounding differences."""
    from repro_torch.models import blocks, lm
    from repro_torch.models.layers import embed_fwd, lm_head_fwd, rmsnorm
    params = lm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg)
    extras = lm.init_extras(cfg, dev)
    prompts, tokens = prompts.to(dev), tokens.to(dev)
    P, gen, L = prompts.shape[1], tokens.shape[1] - 1, cfg.n_layers
    agree = {"prefill": _Agreement(), "decode": _Agreement()}

    def both(kind, fn):
        """fn(plain) through the kernels and through the plain versions;
        returns both results."""
        pk, pp = [], []
        with _gates(False, pk):
            out_k = fn(False)
        with _gates(True, pp):
            out_p = fn(True)
        agree[kind].add(out_k[0], out_p[0], pk[0], pp[0])
        return out_k, out_p

    def logit_err(hk, hp):
        """Per row, after the last layer; the last layer's routing flips
        show here too."""
        lk, lp = (lm_head_fwd(params["embed"], rmsnorm(
            params["final_norm"], h, cfg.norm_eps)) for h in (hk, hp))
        return (lk - lp).abs().amax(-1).float().flatten() / lk.abs().max()

    x = embed_fwd(params["embed"], prompts)
    kvs, logit_errs = [], []
    for i in range(L):
        lay = lm.layer(params["layers"], i)
        kw = dict(cfg=cfg, router_bias=extras["router_bias"][i],
                  placement=extras["placement"][i])
        (x, kv, _), (xp, _, _) = both(
            "prefill", lambda plain: blocks.tf_block_fwd(
                lay, x, return_kv=True, **kw))
        kvs.append(kv)
    logit_errs.append(logit_err(x[:, -1:], xp[:, -1:]))
    cache = lm._pad_cache_to({"main": (torch.stack([k for k, _ in kvs]),
                                       torch.stack([v for _, v in kvs]))},
                             cfg, P + gen)
    del kvs
    for step in range(gen):
        x = embed_fwd(params["embed"], tokens[:, step, None])
        for i in range(L):
            lay = lm.layer(params["layers"], i)
            kw = dict(cfg=cfg, router_bias=extras["router_bias"][i],
                      placement=extras["placement"][i])
            c = lm.layer(cache["main"], i)
            twin = {k: t.clone() for k, t in c.items()}
            (x, _), (xp, _) = both(
                "decode", lambda plain: blocks.tf_block_decode(
                    lay, x, twin if plain else c, P + step, **kw))
        logit_errs.append(logit_err(x, xp))
    res = {k: a.summary() for k, a in agree.items()}
    le = torch.cat([e.flatten() for e in logit_errs]).cpu()
    res["logits_row_err_median"] = float(le.median())
    res["logits_row_err_max"] = float(le.max())
    bad = [k for k in agree if res[k]["agreeing_row_err_max"] > LAYER_TOL
           or res[k]["flipped_share"] > FLIP_MAX]
    if (res["logits_row_err_median"] > SERVE_TYP
            or res["logits_row_err_max"] > SERVE_MAX):
        bad.append("logits")
    if bad:
        raise AssertionError(f"serve: kernels vs plain versions, layer by "
                             f"layer, beyond the bf16 tolerance: {res}")
    return res


SERVE = dict(arch="qwen3-moe-30b-a3b", batch=16, prompt_len=512, seed=0)


def serve_phase(gen: int, dev):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.serve import example_gaia_config, serve
    cfg = get_arch(SERVE["arch"])
    gcfg = example_gaia_config(cfg)
    B, P, seed = SERVE["batch"], SERVE["prompt_len"], SERVE["seed"]
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    run = serve(cfg, gcfg, B, P, gen, seed, dev, keep_logits=True)
    launches = kbuild.launches()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": L, "flash_decode": L * gen,
            "moe_gate": L * (gen + 1)}
    off = serve(cfg, None, B, P, gen, seed, dev, keep_logits=True)
    same = torch.equal(off["tokens"], run["tokens"])
    off_gap = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(off["logits"], run["logits"]))
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(seed + 1))
    vs_plain = layerwise_vs_plain(cfg, seed, prompts, run["tokens"], dev)
    res = {
        "arch": cfg.name, "layers": L, "batch": B, "prompt_len": P,
        "gen": gen, "cache_len": P + gen,
        "params": cfg.param_count(),
        "gaia": dataclasses.asdict(gcfg),
        "launches": {k: launches[k] for k in want},
        "migrations": run["migrations"],
        "migration_steps": run["migration_steps"],
        "max_memory_allocated": peak,
        "prefill_s": run["prefill_s"],
        "prefill_tokens_per_s": B * P / run["prefill_s"],
        "decode_ms_per_step": 1e3 * run["decode_s"] / gen,
        "decode_tokens_per_s": B * gen / run["decode_s"],
        "gaia_off": {"prefill_s": off["prefill_s"],
                     "decode_ms_per_step": 1e3 * off["decode_s"] / gen,
                     "same_tokens": same, "max_logit_gap": off_gap},
        "vs_plain_layerwise": vs_plain,
    }
    emit(phase="serve", **res)
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"serve launched {launches}, want {want}")
    if run["migrations"] <= 0:
        raise AssertionError("serve: GAIA migrated no expert")
    if not same:
        raise AssertionError("serve: GAIA on and off gave other tokens")
    return res


def serve_cpu_phase(dev, gen: int = 16):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import example_gaia_config, serve
    from repro_torch.models import lm
    cfg = get_smoke(SERVE["arch"])
    gcfg = example_gaia_config(cfg)
    B, P = 8, 32
    params = lm.init_params(torch.Generator().manual_seed(1), cfg)
    cpu = serve(cfg, gcfg, B, P, gen, 1, "cpu", params=params,
                keep_logits=True)
    params = lm.init_params(torch.Generator().manual_seed(1), cfg)
    params = lm.tree_map(lambda t: t.to(dev), params)
    card = serve(cfg, gcfg, B, P, gen, 1, dev, params=params,
                 forced=cpu["tokens"], keep_logits=True)
    res = _check_logits("serve_cpu: card vs CPU", card["logits"],
                        cpu["logits"])
    same_steps = card["migration_steps"] == cpu["migration_steps"]
    emit(phase="serve_cpu", arch=cfg.name, batch=B, prompt_len=P, gen=gen,
         migrations=cpu["migrations"], same_migration_steps=same_steps,
         **res)
    if not same_steps:
        raise AssertionError("serve_cpu: migrations differ")


def profile_serve(steps: int, dev):
    """Where the serve phase's model spends its time: one traced
    prefill, then `steps` untraced and `steps` traced decode steps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import argmax_first
    from repro_torch.models import lm
    cfg = get_arch(SERVE["arch"])
    B, P = SERVE["batch"], SERVE["prompt_len"]
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    extras = lm.init_extras(cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev)
    lm.prefill(params, {"tokens": prompts}, cfg, P + 3 * steps)  # warm-up
    torch.cuda.synchronize()

    def summarize(prof, n, wall_ms, what):
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        by_name = {}
        for e in kern:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        busy_ms = busy / n / 1e3
        emit(phase="profile_serve", part=what, arch=cfg.name, batch=B,
             prompt_len=P, calls=n, untraced_ms_per_call=wall_ms,
             device_kernels_per_call=len(kern) / n,
             device_busy_ms_per_call=busy_ms,
             device_busy_share=busy_ms / wall_ms,
             top_kernels=[{"name": nm[:120], "ms_per_call": t / n / 1e3,
                           "launches_per_call": c / n}
                          for nm, (t, c) in top])

    t0 = time.perf_counter()
    cache, logits = lm.prefill(params, {"tokens": prompts}, cfg,
                               P + 3 * steps)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        cache, logits = lm.prefill(params, {"tokens": prompts}, cfg,
                                   P + 3 * steps)
        torch.cuda.synchronize()
    summarize(prof, 1, wall, "prefill")
    tok = argmax_first(logits[:, -1])
    pos = P
    for _ in range(2):  # warm-up
        cache, lg = lm.decode_step(params, cache, tok, pos, extras, cfg)
        tok, pos = argmax_first(lg), pos + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        cache, lg = lm.decode_step(params, cache, tok, pos, extras, cfg)
        tok, pos = argmax_first(lg), pos + 1
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / steps
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            cache, lg = lm.decode_step(params, cache, tok, pos, extras, cfg)
            tok, pos = argmax_first(lg), pos + 1
        torch.cuda.synchronize()
    summarize(prof, steps, wall, "decode")


def run_engine(cfg, dev, seed=0):
    from repro_torch.core import Engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, series, counters = Engine(cfg, device=dev).run(seed=seed)
    torch.cuda.synchronize()
    return st, series, counters, time.perf_counter() - t0


def main_path(steps: int, dense_steps: int, dev):
    from repro_torch.core import ABMConfig, EngineConfig
    from repro_torch.core.balance import bincount
    from repro_torch.kernels.proximity import ops
    out = {}
    ops.reset_launches()
    for gaia in (False, True):
        cfg = EngineConfig(gaia_on=gaia, timesteps=steps)
        st, _, c, sec = run_engine(cfg, dev)
        pop = bincount(st["lp"], cfg.abm.n_lp).tolist()
        out[f"gaia_{'on' if gaia else 'off'}"] = {
            "mean_lcr": c["mean_lcr"], "migrations": c["migrations"],
            "grid_overflow": c["grid_overflow"], "s_per_step": sec / steps,
            "population": pop}
        if c["grid_overflow"] != 0:
            raise AssertionError(f"grid overflow with gaia_on={gaia}")
        if len(set(pop)) != 1:
            raise AssertionError(f"per-LP populations drifted: {pop}")
    grid_launches = ops.grid_kernel.launches
    # the exact path of a world too small to tessellate
    dcfg = EngineConfig(abm=ABMConfig(n_se=2000, area=600.0,
                                      interaction_range=250.0),
                        timesteps=dense_steps)
    _, _, dc, dsec = run_engine(dcfg, dev)
    out["dense_world"] = {"n_se": 2000, "area": 600.0, "range": 250.0,
                          "mean_lcr": dc["mean_lcr"],
                          "migrations": dc["migrations"],
                          "s_per_step": dsec / dense_steps}
    launches = ops.launches()
    emit(phase="main", steps=steps, launches=launches, **out)
    if grid_launches != 2 * steps or launches["proximity_dense"] < 1:
        raise AssertionError(f"main path missed a kernel: {launches}")
    if not out["gaia_on"]["mean_lcr"] > out["gaia_off"]["mean_lcr"]:
        raise AssertionError("LCR with GAIA on is not above GAIA off")
    return launches


def scale(steps: int, dev):
    from repro_torch.core import ABMConfig, Engine, EngineConfig
    cfg = EngineConfig(abm=ABMConfig(n_se=1_000_000, area=100_000.0),
                       timesteps=steps)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, device=dev).init(seed=0)
    eng.step(1)  # first step: allocator warm-up, not timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = eng.step(steps)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    emit(phase="scale", n_se=1_000_000, area=100_000.0, steps=steps,
         s_per_step=sec / steps, mean_lcr=c["mean_lcr"],
         grid_overflow=c["grid_overflow"],
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if c["grid_overflow"] != 0:
        raise AssertionError("grid overflow in the 1M-SE window")


def card_vs_cpu(steps: int, dev):
    from repro_torch.core import ABMConfig, EngineConfig
    area = 4472.0  # 2,000 SEs at the paper's density of 1e-4 per unit^2
    cfg = EngineConfig(abm=ABMConfig(n_se=2000, area=area), timesteps=steps)
    gst, gser, _, _ = run_engine(cfg, dev)
    from repro_torch.core import Engine
    cst, cser, _ = Engine(cfg, device="cpu").run(seed=0)
    bad = [k for k in cser if not torch.equal(gser[k].cpu(), cser[k])]
    gap = float((gst["pos"].cpu() - cst["pos"]).abs().max())
    ulps = gap / (area * ULP)
    same = {k: torch.equal(gst[k].cpu(), cst[k])
            for k in ("lp", "waypoint", "pending_dst", "ring")}
    emit(phase="cpu", n_se=2000, steps=steps, series_mismatch=bad,
         max_pos_gap=gap, max_pos_gap_area_ulps=ulps, state_equal=same)
    if bad or ulps > 1.0 or not all(same.values()):
        raise AssertionError("the card's run differs from the CPU's")


def profile(steps: int, dev):
    """Where a step of the default config spends its time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from repro_torch.core import Engine, EngineConfig
    from repro_torch.core import engine as teng
    cfg = EngineConfig()
    eng = Engine(cfg, device=dev).init(seed=0)
    eng.step(5)
    state, phases = eng.state, teng.step_phases(cfg)
    per_phase = {name: [] for name, _ in phases}
    for _ in range(steps):  # CUDA events between phases, one step at a time
        px = {"st": state, "mf": cfg.heuristic.mf}
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()
        for _, fn in phases:
            px = fn(px)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        torch.cuda.synchronize()
        for (name, _), a, b in zip(phases, marks, marks[1:]):
            per_phase[name].append(a.elapsed_time(b))
        state = px["new_state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = teng.step(state, cfg)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = teng.step(state, cfg)
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kern:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    busy_ms = busy / steps / 1e3
    emit(phase="profile", config="EngineConfig()", steps=steps,
         phase_ms_median={k: statistics.median(v)
                          for k, v in per_phase.items()},
         untraced_ms_per_step=step_ms,
         device_kernels_per_step=len(kern) / steps,
         device_busy_ms_per_step=busy_ms,
         device_busy_share=busy_ms / step_ms,
         top_kernels=[{"name": n[:120], "ms_per_step": t / steps / 1e3,
                       "launches_per_step": c / steps}
                      for n, (t, c) in top])


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--dense-steps", type=int, default=200)
    p.add_argument("--scale-steps", type=int, default=20)
    p.add_argument("--cpu-steps", type=int, default=100)
    p.add_argument("--gen", type=int, default=64,
                   help="decode steps of the serve phase")
    p.add_argument("--profile", type=int, default=0, metavar="STEPS",
                   help="trace STEPS steps of the default config instead")
    p.add_argument("--profile-serve", type=int, default=0, metavar="STEPS",
                   help="trace the serve phase's prefill and STEPS decode "
                        "steps instead")
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU; none is visible")
    dev = torch.device("cuda")
    smi = card()
    build()
    if a.profile:
        profile(a.profile, dev)
        return
    if a.profile_serve:
        profile_serve(a.profile_serve, dev)
        return
    launch_floor()
    shapes = {"grid": [check_grid(10_000, 10_000.0, 250.0, 1, dev),
                       check_grid(1_000_000, 100_000.0, 250.0, 2, dev),
                       check_grid(10_000, 10_000.0, 250.0, 5, dev,
                                  layout="clustered")],
              "dense": [check_dense(2_000, 600.0, 250.0, 3, dev),
                        check_dense(10_000, 10_000.0, 250.0, 4, dev)],
              **check_lm_kernels(dev)}
    emit(phase="kernels_checked", shapes=shapes)
    served = serve_phase(a.gen, dev)
    launches = main_path(a.steps, a.dense_steps, dev)
    scale(a.scale_steps, dev)
    card_vs_cpu(a.cpu_steps, dev)
    serve_cpu_phase(dev)
    launches.update(served["launches"])
    src = "src/repro_torch/kernels/"
    meta = {
        "grid": ("proximity_lp_counts_grid", "proximity_grid",
                 src + "proximity/csrc/proximity_grid.cu",
                 "src/repro/kernels/proximity/grid.py:61"),
        "dense": ("proximity_lp_counts", "proximity_dense",
                  src + "proximity/csrc/proximity_dense.cu",
                  "src/repro/kernels/proximity/proximity.py:50"),
        "moe_gate": ("moe_gate", "moe_gate",
                     src + "moe_gate/csrc/moe_gate.cu",
                     "src/repro/kernels/moe_gate/moe_gate.py:55"),
        "flash_attention": (
            "flash_attention", "flash_attention",
            src + "flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:67"),
        "flash_decode": ("flash_decode", "flash_decode",
                         src + "flash_decode/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode/flash_decode.py:60"),
    }
    kernels = []
    for k, (name, stem, source, replaces) in meta.items():
        main_shape = shapes[k][0]  # the shape the main path gives it
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[stem],
            **{f: main_shape[f] for f in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            **{f: main_shape.get(f) for f in ("kernel_device_ms",
                                              "library_device_ms")},
            "shapes": shapes[k]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
