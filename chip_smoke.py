"""Drive the PyTorch/CUDA port (`src/repro_torch`) end to end on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero
and prints no result):

  1. card     the GPU's name and power limit (nvidia-smi), torch, CUDA
  2. build    the eleven kernels built from the checkout's sources, with
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
              same way (the floor under microsecond kernels). The
              scenario shapes: the cell-list kernel as the epidemic's
              exposure sweep (n_lp = 2) and on an exp6 hotspot world,
              the dense kernel with every SE a sender (`bestresponse`),
              the flock's cell-sum kernel (bit for bit; library
              `index_add_`) and the partitioners' capacity-assign
              kernel on kmeans' and bestresponse's costs. The batched
              shapes (replicas stacked on a leading axis, one launch
              for all): the cell-list kernel at 10 x 10k SEs, the dense
              kernel at 4 x 2,000 and the cell sums at 4 x 10k flock SEs.
              The open-world shapes (dead rows: lp -1, out of the grid):
              the cell-list kernel on 10k slots with a dead tail of
              2,000, solo and at R = 4, its output memory filled with a
              nonzero pattern first (every dead row must come out
              zero), and the dense kernel at 2,000 SEs, 500 of them dead
  4. main     the default EngineConfig() (10k SEs, 300 of Exp. 1's
              1,200 steps: `--steps`) with
              GAIA off and on through the cell-list kernel, and a world
              with area / range < 3 through the dense kernel; launch
              counts are set to 0 just before and read just after
  4b. replicas the batched engine, `Engine.run(seeds=...)`: the default
              config, GAIA on, 300 steps, R = 10 seeds 0-9 in one pass
              (replica 0 bit-equal to phase main's GAIA-on run, replica
              3 to a solo 300-step run; 300 cell-list launches for all
              ten; s/step, s/step a replica, t_batch / t_single and peak
              memory); exp6's epidemic and flock and the dense world,
              R = 4, 60 steps (replica 1 bit-equal to its solo run; two
              cell-list, one cell-sum and one dense launch a step,
              whatever R); the batched tuner
              (`intra_run_tune_batch`, R = 4, window 100, 300 steps),
              each history the solo tuner's
  4c. sharded the LP-per-device engine (`repro_torch.parallel`): the
              default config at D = 1, 2, 4 shards for 300 steps,
              each bit-equal to phase main's GAIA-on run (unsharded
              state and every series), shard_overflow 0, one cell-list
              launch a step (s/step against the oracle's, peak memory,
              halo_frac and LCR by 100-step window, bytes_on_wire), and
              the synchronising calls of an `Engine.step(300)` window
              against the oracle's; exp5's full world (50k SEs, 8 LPs)
              at D = 8 for 150 steps; at D = 2 for 60 steps the dense
              world, exp6's epidemic (2 cell-list launches a step),
              flock (1 cell-sum launch a step) and hotspot + kmeans
              every 50 (the oracle's capacity-assign launches), each
              bit-equal to its oracle; the open world at D = 4 (zero
              churn against the closed world, exp9's churn for 20
              iterations, the queries against brute force); R = 4
              replicas at D = 2 against their solo runs; telemetry at
              D = 4 (ledger columns against the series, one trace span
              a shard, phase and step, each span's per-shard n_valid
              and halo_n that shard's counts); the launcher
              (`python -m repro_torch.parallel.multihost --processes 1
              --local-shards 4 --backend nccl`) against the in-process
              run; rwp at 2,000 SEs, D = 2, card against CPU
  5. scenarios exp6's fleet at full width (10k SEs, area 10,000, GAIA
              on): the epidemic for 300 of its 1,200 steps (two
              cell-list launches
              a step), hotspot, group, flock and trace replay, and
              exp7's hotspot with kmeans repartitioning every 100 steps
              (300 steps each), each priced by `wct_env` on four
              environments; then one `bestresponse` init (8 dense and
              8 capacity-assign launches); launch counts set to 0 just
              before each run
  5b. service the resident service at full width (the default config,
              10k slots, open_world=True): zero churn for 300 steps,
              bit-equal to the closed world; exp9's churn loop (n_active
              9,800, 120 x depart 200 / arrive 200 / step 1: events/s,
              step p50 / p99, population held, one cell-list launch a
              step); query_lcr, query_region (a quadrant, a box across
              the seam) and query_neighbors of 64 ids against brute
              force on the card; ReplicaService with 4 slots and 12
              requests of 60-300 steps, and 3 slots and 5 requests of
              hotspot + kmeans every 50 steps: every request's counters
              its solo run's, t_service / t_sequential printed
  5c. obs     runtime telemetry at full width (the default config,
              ObsConfig(enabled=True, drain_every=10)): `Engine.step`
              windows of 7, 68, 25 and 200 steps against the obs-off
              window runner, bit-equal (state, counters, every ledger
              counter column against its series), 300 rows, as many
              cell-list launches and synchronising calls (sync debug
              mode) on both sides; `overhead_ratio` (on / off, min of 3
              interleaved reps of 300 steps, beside the reference's
              1.10, printed); exp9's churn for 20 iterations (arrive /
              depart stamps, `pop` 9,800); `intra_run_tune`'s
              `tuner_move` events against its history; `trace_run` of
              20 steps (phase ms, results/obs_trace.json, the traced
              state bit-equal to the fused run); a 2,000-SE run's
              ledger on the card and the CPU
  6. scale    a 1M-SE window (area 100,000, paper density)
  7. cpu      the port on the card against the port on the CPU, for rwp
              and every scenario at 2,000 SEs, 30 steps: integer series
              identical, positions within one ULP of `area` (kmeans,
              voronoi and flock: their agreement is printed); batched
              rwp and hotspot runs (R = 3) held the same way; an open
              world under churn (30 steps of 20 departures and arrivals)
              and a 3-slot ReplicaService of 5 requests, counters
              identical
  8. serve    qwen3-moe-30b-a3b at full width and depth (48 layers,
              random weights drawn on the card) serving 16 prompts of
              512 tokens and 16 greedy steps with GAIA expert placement
              (examples/serve_moe.py's settings); launch counts set to
              0 just before and read just after. Then the same with GAIA
              off (tokens must be identical: placement is transparent),
              and every layer of the same prefill and decode, teacher-
              forced on the kernels' tokens and hidden states, through
              the kernels and through their plain versions (rows that
              route alike agree within the bf16 tolerance)
  8b. mla_serve deepseek-v3-671b at full width cut to 4 layers (3 dense,
              1 MoE of 256 routed experts and a shared one; MTP head
              drawn, not run: 15.8 B parameters allocated, printed
              beside `param_count()`), run right after phase serve with
              its traffic (16 x 512 prompts, 16 greedy steps), GAIA on
              and off (identical tokens); MLA prefill through the
              attention kernel at Dk 192 / Dv 128 (4 launches), absorbed
              MLA decode in torch ops (0 flash_decode launches), the
              gate once a step (65 launches); every layer, dense stack
              first, against the plain versions
  9. serve_cpu the smoke configs of qwen3-moe-30b-a3b, rwkv6-1.6b,
              zamba2-1.2b, seamless-m4t-medium and internvl2-2b on the
              card against the port on the CPU, teacher-forced (logits
              within the bf16 tolerance)
 10. train    the training path: the flash-attention backward (with the
              forward's row log-sum-exp) at tinyllama-1.1b's and
              qwen2-7b's shapes and in float32, and the gate's backward
              and probability-mean forward, against autograd through the
              plain versions (calls in a row bit-equal; library:
              autograd through PyTorch's fused attention), the
              attention backward also at zamba2's (2, 32/32, 4,096,
              128), the attention forward and backward at phase
              encdec_vision_train's shapes (seamless's (2, 16/16, 4,096,
              64) non-causal and causal, internvl2's (2, 16/8, 4,096,
              128); library: SDPA and its autograd), rwkv6-1.6b's WKV
              intra-chunk forward at its training
              microbatch (2, 32, 4,096, 64; 32 chunks) and serve prefill
              (16, 32, 512, 64) and its backward at both shapes, and at
              the training shape with steep decays and with a cliff of
              0..60 a token, against the plain versions (1e-5 of the
              largest |A|, 1e-4 of each gradient's largest value; one
              kernel a call, two calls bit-equal; beside the bound the
              exponentials the sub-chunk design evaluates and their
              SFU time, and those of a direct exponent a pair; these,
              the gate's and the attention at encdec_vision_train's
              shapes in a fresh process of this script,
              `--train-kernels-child`);
              tinyllama-1.1b at full width and depth through
              `launch.train`'s Trainer (8 x 4,096 tokens a step in 4
              microbatches, AdamW, remat, chunked loss, 6 steps, an
              async checkpoint at step 3; s/step, tokens/s, the
              model-FLOPs share, peak memory, launches a step), then
              from that checkpoint a run killed after step 4 and a
              restart, bit for bit the first run; qwen3-moe-30b-a3b at
              full width cut to 2 layers (expert counts sum to T k,
              router_bias moves by +-1e-3, a restart from its state
              after step 2 bit for bit); one float32 step of the two
              smokes on the card against the CPU (a REPRO_FORCE_F32=1
              subprocess; also rwkv6-smoke, whose step runs the WKV
              pair at N 16, c 16, zamba2-smoke, seamless-smoke on its
              source frames and internvl2-smoke on its vision
              embeddings; loss, lr, params, the share of entries
              further than a tenth of the step's move, grad norm). One
              15.4 GB
              checkpoint is written: the card machine takes ~45 GiB of
              disk writes a call
 11. dense_serve qwen2-7b at full width and depth (28 layers, a group
              of 7 at D 128, QKV bias) serving 4 x 512 prompts and 16
              greedy steps, then every layer through the kernels and
              through the plain versions
 12. recurrent_serve rwkv6-1.6b (24 layers, chunked WKV) and zamba2-1.2b
              (38 Mamba2 layers, the shared attention block at 2 d every
              6, 32 heads at D 128) at full width and depth, random
              weights drawn on the card (1.60 B and 1.28 B parameters
              allocated, printed beside `param_count()`), serving 16 x
              512 prompts and 16 greedy steps: launches set to 0 just
              before and read just after (zamba2 7 attention, 448
              decode; rwkv6 24 WKV forward, one a layer), prefill s,
              decode ms a step, peak
              memory; the chunked prefill against the exact recurrence
              (a prefill of 384 tokens and 128 teacher-forced decode
              steps against a prefill of 512): every layer in bf16
              within LAYER_TOL, end to end in bf16 and in float32
              (a REPRO_FORCE_F32=1 subprocess) within SPLIT_ROWS, set
              per model from the H100's readings; zamba2's shared
              block, every invocation of the same prefill and decode,
              through the kernels and through their plain versions.
              The attention kernels at
              zamba2's shapes are in phase kernels
 13. recurrent_train rwkv6-1.6b and zamba2-1.2b at full width, cut to
              12 of 24 and 18 of 38 layers (3 of 7 shared-block
              passes), through `launch.train`'s Trainer with phase
              train's recipe
              (8 x 4,096 tokens in 4 microbatches, AdamW, remat, loss
              chunk 1,024, 6 steps, no checkpoint): s/step (median of
              the last 4), tokens/s, the model-FLOPs share, peak memory
              and launches a step, exactly 96 / 48 WKV (rwkv6) and 24 /
              12 attention (zamba2) forward / backward; finite losses,
              every master weight moved; rwkv6 restarted from a host
              copy of its state after step 3 ends bit for bit (every
              leaf's sha256)
 14. encdec_vision_serve seamless-m4t-medium (12 encoder + 12 decoder
              layers, d 1,024, 16 heads of 64, vocab 256,256; 978.9 M
              parameters) and internvl2-2b (24 layers, d 2,048, 16/8
              heads of 128, 256 vision tokens; 1.89 B) at full width and
              depth, random weights drawn on the card, serving 16 x 512
              (seamless: source frames; internvl2: prompt tokens, the
              first 256 of them vision embeddings) and 16 greedy steps:
              launches set to 0 just before and read just after
              (seamless 12 non-causal attention a prefill and 24 decode
              a step, 12 self over the 64-row target cache and 12 cross
              over the read-only 512-row encoder cache; internvl2 24 /
              24), prefill s, decode ms a step, peak memory, finite
              logits; every layer of the prefill and of every decode
              step, teacher-forced on the kernel run, through the
              kernels against the plain versions (median row within
              SERVE_TYP, every row within SERVE_MAX, at most FLIP_MAX
              beyond LAYER_TOL: the full-width models attend almost by
              argmax, so a near-tie moves a row) and, on the prefill
              and the first 8 steps, no further from float32 than the
              plain versions; the logits after each step by the row
              rule, greedy picks equal where the margin is clear. How
              far whole prefills through the kernels, the plain
              versions and float32 land apart is printed. The attention
              kernels at their shapes are in phase kernels
 15. encdec_vision_train seamless-m4t-medium and internvl2-2b at full
              width and depth through `launch.train`'s Trainer, whose
              source adds the source frames (8 x 4,096 x 1,024) or the
              vision embeddings (8 x 256 x 2,048), drawn from (seed,
              step) in the prefetch thread, with phase recurrent_train's
              recipe (8 x 4,096 tokens in 4 microbatches, AdamW, remat,
              loss chunk 1,024, which seamless's full-vocabulary loss
              ignores, 6 steps): s/step (median of the last 4),
              tokens/s, the model-FLOPs share, peak memory and launches
              a step, exactly 288 / 144 (seamless: 12 encoder, 12
              decoder self and 12 cross attention layers, non-causal
              but the self attention) and 192 / 96 (internvl2) attention
              forward / backward, no decode, gate or WKV launch; finite
              losses, every master weight moved; each restarted from a
              host copy of its state after step 3 ends bit for bit
              (every leaf's sha256). The kernels at its shapes are in
              phase train

Every line but the last is one JSON object (the card's nvidia-smi line
excepted); a `seconds` line gives each phase's wall time; the last is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile 20

instead builds the kernels and measures 20 steps of the default config
(with `--scenario epidemic|hotspot|group|flock|trace`, of that exp6
scenario at full width; with `--replicas R`, of a batch of R replicas),
after 5 warm-up ones: each phase's elapsed
time on the stream (CUDA events), the untraced time per step, and, from
a `torch.profiler` trace of 20 more, the device's busy time per step
(the union of its kernels' intervals; its share of the untraced step is
the busy share) and its kernels by time. It prints no result line.

    python3 chip_smoke.py --profile-serve 8

does the same for the serve phase's model: one traced prefill, then 8
untraced and 8 traced decode steps (`--profile-arch zamba2-1.2b`: of
that arch at full width and depth instead; seamless-m4t-medium
decodes from target position 0 over its encoder's cross cache,
internvl2-2b's prompts carry its vision embeddings).

    python3 chip_smoke.py --gen 8 --steps 50 --dense-steps 20 \
        --scale-steps 3 --cpu-steps 20 --epi-steps 50 \
        --scenario-steps 110 --replica-scenario-steps 20 --tune-steps 200 \
        --service-iters 20 --service-requests 4 --exp5-steps 20 \
        --shard-steps 20 --shard-churn 5

is a shake-out run that cuts every phase short (--gen sets the serve
phase's decode steps) but phases train, dense_serve and recurrent_train
(`--train-steps`, `--train-moe-steps` and `--dense-gen` cut the first
two; recurrent_train runs its 6 steps, the fewest its restart check
needs room for).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
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
#: H100 SXM exponentials a second on the SFUs: 132 SMs x 16 a clock x
#: the 1.98 GHz boost clock (the WKV kernels' exponentials' floor,
#: printed beside their bound)
PEAK_EXP_S = 132 * 16 * 1.98e9
#: rows of the WKV kernels' sub-chunks (`kernels/wkv/csrc/wkv.cuh`)
WKV_SUB = 16
#: the WKV forward against its plain version, as a share of the largest
#: |A|; the backward, of each gradient's largest |value|
#: (tests/test_torch_wkv.py's FWD_TOL and BWD_TOL)
WKV_FWD_TOL = 1e-5
WKV_BWD_TOL = 1e-4
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
#: phase recurrent_serve, the chunked prefill against the recurrence
#: (a prefill of 384 tokens and 128 decode steps against one of 512):
#: each layer within LAYER_TOL (the shared block reads 1.73e-2: the
#: attention kernel on one side, flash decode on the other); end to end,
#: per model and dtype, (median, max) row limits, each about 3x the
#: H100's readings (PERF.md §6: float32 rwkv6 1.6e-5 / 1.9e-5,
#: zamba2 2.8e-3 / 1.7e-2; bfloat16 rwkv6 0.036 / 0.046, zamba2 0.162 /
#: 0.229, 0.132 / 0.282 through the plain versions; the CPU gives the
#: same order with the same weights, `tools/recurrent_split_gap.py`,
#: but for zamba2 in float32, ~16x narrower: the card's library sums a
#: prefill's 2,048-row products and a decode step's 4-row ones in other
#: orders, and the random weights amplify that with depth; ROADMAP.md
#: §3, F3)
SPLIT_ROWS = {("rwkv6-1.6b", "float32"): (5e-5, 1e-4),
              ("zamba2-1.2b", "float32"): (1e-2, 5e-2),
              ("rwkv6-1.6b", "bfloat16"): (0.1, 0.15),
              ("zamba2-1.2b", "bfloat16"): (0.35, 0.5)}
#: float32 operations per pair test: 2 sub, 2 abs, 2 sub (area - d),
#: 2 min, 1 mul, 1 fma (2), 1 compare
OPS_PER_PAIR = 12
#: float32 positions stay in [0, area); one ULP of `area` bounds a
#: rounding difference anywhere in that range
ULP = 2.0 ** -23
#: the epidemic of benchmarks/exp6_scenarios.py (`EPI`): a slow SIS wave
#: whose infectious SEs send 5x more often
EPI = dict(workload="epidemic", epi_beta=0.05, epi_gamma=0.08,
           epi_seed_frac=0.05, epi_boost=5.0)
#: the environments exp6 and exp7 price each run on
ENVS = ("shm", "lan", "wan2", "hetero")


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


def device_profile(fn, kernel=None, calls: int = 20, tries: int = 5,
                   expect: int = 0):
    """(ms, kernels per call, names) of the CUDA kernels whose names hold
    `kernel` (every kernel when None), per call of fn(), over `calls`
    calls (torch.profiler); ms is None when none ran.

    Every call issues the same kernels, so a count that is not a whole
    multiple of `calls` (or, given `expect`, not `expect` a call), or
    none at all, means the trace lost records (seen once in 19 of 20
    moe_gate launches, for two thirds of the attention backward's
    launches, and for every gate backward launch of a trace late in the
    script): the calls are traced again, up to `tries` times in all, and
    the last trace is returned."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (kernel is None or kernel in e.name)]
        if len(ev) == expect * calls if expect else (
                ev and len(ev) % calls == 0):
            break
    ms = sum(e.time_range.elapsed_us() for e in ev) / calls / 1e3
    return (ms if ev else None), len(ev) / calls, sorted(
        {e.name[:80] for e in ev})


def device_split(fn, calls: int = 5) -> dict:
    """{kernel name without its arguments: device ms per call of fn()}
    over `calls` calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+kernel)(<[^>(]*>)?", e.name)
            nm = m.group(0) if m else e.name[:60]
            out[nm] = out.get(nm, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / calls for k, v in sorted(out.items())}


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


def scenario_world(mobility: str, seed: int, dev, **abm):
    """Positions and state of an exp6-sized world (10k SEs) of the given
    mobility model (and workload) from the engine's own init."""
    from repro_torch import random as trandom
    from repro_torch.core.abm import ABMConfig, init_abm
    cfg = ABMConfig(mobility=mobility, **abm)
    return cfg, init_abm(trandom.key(seed), cfg, dev)


def _grid_pairs(pos, snd, spec, valid=None):
    """The pair tests a cell-list sweep of one world makes: every live
    sender tests the members of its 9 cells' windows (up to capacity),
    less itself where it is in one (a dead row tests nothing)."""
    from repro_torch.core import neighbors
    grid = neighbors.build_grid(pos, spec, valid=valid)
    seg = grid["counts"].clamp(max=spec.capacity)
    nc, ncells = spec.ncell, seg.shape[0]
    cell = neighbors.cell_ids(pos, spec).long()
    cx, cy = cell // nc, cell % nc
    cand = sum(seg[((cx + di) % nc) * nc + (cy + dj) % nc]
               for di in (-1, 0, 1) for dj in (-1, 0, 1))
    live = grid["cell_sorted"] < ncells
    rank = torch.arange(pos.shape[0], device=pos.device) \
        - grid["starts"][grid["cell_sorted"].clamp(max=ncells - 1)]
    in_window = torch.empty_like(rank)
    in_window[grid["order"]] = ((rank < spec.capacity) & live).long()
    if valid is not None:
        snd = snd & valid
    return int((cand - in_window)[snd].sum())


def dirty(nbytes: int, dev) -> int:
    """Fill a fresh block of `nbytes` on the card with a nonzero pattern
    and free it, so that the caching allocator hands it to the next
    allocation of that size; returns its address."""
    torch.cuda.empty_cache()
    junk = torch.full((nbytes // 4,), 0x5A5A5A5A, dtype=torch.int32,
                      device=dev)
    ptr = junk.data_ptr()
    del junk
    return ptr


def dead_rows(shape, n_dead: int, dev, tail=True):
    """(..., N) bool live-row masks with `n_dead` dead rows a world: the
    last ones (`tail`: the service's free slots at init), or a seeded
    scatter (after churn)."""
    n = shape[-1]
    if tail:
        live = torch.arange(n, device=dev) < n - n_dead
        return live.expand(shape).contiguous()
    g = torch.Generator(device="cpu").manual_seed(n_dead)
    keys = torch.rand(shape, generator=g)
    return (keys.argsort(-1).argsort(-1) >= n_dead).to(dev)


def check_grid(n, area, rng, seed, dev, layout="engine", replicas=1,
               dead=0):
    """The cell-list kernel against its plain version, exactly, on the
    engine's own world, on three blobs (layout "clustered": the grid
    must overflow and the drop set matters), on an exp6 hotspot world
    (layout "hotspot": crowded cells under the clustered capacity) or
    as the epidemic's exposure sweep (layout "epidemic": n_lp = 2, the
    infectious senders' 0/1 labels, the susceptible rows). With
    `replicas` > 1, that many engine worlds (seeds seed, seed + 1, ...)
    stacked as a batched step gives them: one launch for all. With
    `dead` > 0, an open world's: that many dead rows a world at its
    tail (lp -1, their sender flags left set), binned out of the grid,
    the output's memory filled with a nonzero pattern before the call,
    and every dead row must come out zero."""
    from repro_torch import random as trandom
    from repro_torch.core import neighbors
    from repro_torch.core.abm import epidemic_send_prob
    from repro_torch.kernels.proximity import ops, ref
    valid = None
    if layout == "sharded":
        # the sharded engine's D = `replicas` views of its first step:
        # own rows (senders), then the halo rows every peer sent
        # (non-senders) and their padding (lp -1, out of the grid)
        cfg, pos, lp, snd = sharded_views(seed, replicas, dev)
        n, valid = pos.shape[-2], lp >= 0
    elif replicas > 1:
        worlds = [world(n, area, rng, seed + r, dev) for r in range(replicas)]
        cfg = worlds[0][0]
        pos, lp, snd = (torch.stack([w[i] for w in worlds])
                        for i in (1, 2, 3))
    else:
        cfg, pos, lp, snd = world(n, area, rng, seed, dev)
    n_lp = cfg.n_lp
    if layout == "clustered":
        pos = clustered(n, area, seed, dev)
    elif layout == "hotspot":
        cfg, st = scenario_world("hotspot", seed, dev, n_se=n, area=area,
                                 interaction_range=rng)
        pos, lp = st["pos"], st["lp"]
    elif layout == "epidemic":
        cfg, st = scenario_world("rwp", seed, dev, n_se=n, area=area,
                                 interaction_range=rng, **EPI)
        pos, n_lp = st["pos"], 2
        hot = trandom.uniform(trandom.key(seed + 1), (n,), device=dev) \
            < epidemic_send_prob(st["epi"], cfg)
        lp = ((st["epi"] > 0) & hot).to(torch.int32)
        snd = st["epi"] == 0
    spec = cfg.grid_spec()
    if dead:
        valid = dead_rows(snd.shape, dead, dev)
        lp = torch.where(valid, lp, -1)
    grid = neighbors.build_grid(pos, spec, valid=valid)
    args = (pos, lp, snd, n_lp, area, rng, spec, grid)
    ptr = dirty(snd.numel() * n_lp * 4, dev)
    got = ops.proximity_lp_counts_grid(*args)
    want = ref.grid_lp_counts_plain(*args)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    overflow = bool(grid["overflow"].any())
    dead_zero = valid is None or bool((got[~(valid & snd)] == 0).all())
    if (dead or layout == "sharded") and got.data_ptr() != ptr:
        raise AssertionError("the cell-list kernel's output did not land "
                             "in the dirtied block")
    if err != 0 or overflow != (layout == "clustered") or not dead_zero:
        raise AssertionError(f"grid kernel at n={n}, {layout}, {dead} dead:"
                             f" max_abs_err={err}, overflow={overflow}, "
                             f"dead rows zero {dead_zero}")
    ops.reset_launches()
    ops.proximity_lp_counts_grid(*args)
    if ops.grid_kernel.launches != 1:
        raise AssertionError(f"grid kernel at {replicas} x {n}: "
                             f"{ops.grid_kernel.launches} launches a call")
    # work this run's data needs, a world at a time
    live = valid if valid is not None else torch.ones_like(snd)
    pairs = sum(_grid_pairs(p, s, spec, v) for p, s, v in
                zip(pos.view(-1, n, 2), snd.view(-1, n), live.view(-1, n)))
    nc = spec.ncell
    # pos, lp, order and cell_sorted per row in the grid (a dead or
    # padding row is binned out: never read as a neighbour), the sender
    # flag and the output per row, the CSR offsets
    rows = replicas * n
    nbytes = int(live.sum()) * (8 + 4 + 8 + 4) + rows * (1 + n_lp * 4) \
        + replicas * nc * nc * 16
    call = lambda: ops.proximity_lp_counts_grid(*args)  # noqa: E731
    dead_kw = {"dead_rows": dead, "dead_rows_zero": dead_zero,
               "output_dirtied": True} if dead else {}
    if layout == "sharded":
        dead_kw = {"shards": replicas, "view_rows": n,
                   "padding_rows": int((~valid).sum()),
                   "halo_and_padding_rows_zero": dead_zero,
                   "output_dirtied": True}
    return {"n": n, "replicas": replicas, "area": area, "range": rng,
            "layout": layout, "n_lp": n_lp, "capacity": spec.capacity,
            "max_cell": int(grid["counts"].max()), "overflow": overflow,
            **dead_kw, "max_abs_err": err, "ms": time_ms(call),
            "kernel_device_ms": device_ms(call, "grid_lp_counts_kernel"),
            **call_profile(call),
            "plain_ms": time_ms(lambda: ref.grid_lp_counts_plain(*args),
                                batch=1),
            **bound(nbytes, pairs * OPS_PER_PAIR), "pair_tests": pairs,
            "library_ms": None}


def trace_args_mismatch(spans, cfg, dev, steps: int) -> list:
    """The sharded trace's spans whose per-shard args disagree with a
    plain run of the same seed: on shard row d, `n_valid` must be shard
    d's live slots after that step's arrivals, and the step's `halo_n`
    over the rows must give the series' halo_frac. Returns the
    (phase, step, shard) of each mismatch."""
    import numpy as np
    from repro_torch import random as trandom
    from repro_torch.core import engine as teng
    st = teng._init_engine(trandom.key(0), cfg, dev)
    want = {}
    for _ in range(steps):
        t = st["t"]
        st, m = teng.step(st, cfg)
        want[t] = ((st["gid"] >= 0).sum(-1).tolist(),
                   float(m["halo_frac"]))
    bad, halo = [], {}
    for e in spans:
        a, d = e["args"], e["tid"]
        n_valid, _ = want[a["step"]]
        if a.get("n_valid") != n_valid[d]:
            bad.append((e["name"], a["step"], d))
        if "halo_n" in a:
            halo.setdefault((e["name"], a["step"]), {})[d] = a["halo_n"]
    for (name, t), by_shard in halo.items():
        n_valid, frac = want[t]
        got = np.float32(sum(by_shard.values()) /
                         ((len(n_valid) - 1) * sum(n_valid)))
        if len(by_shard) != len(n_valid) or float(got) != frac:
            bad.append((name, t, "halo_frac"))
    return bad


def sharded_views(seed: int, D: int, dev):
    """(abm config, view_pos, view_lp, senders) of the default config's
    sharded first step at D shards: the (D, C + D * halo_cap) views the
    cell-list kernel takes, with the shards' senders on their own rows
    only."""
    from repro_torch import random as trandom
    from repro_torch.core import EngineConfig
    from repro_torch.core import engine as teng
    from repro_torch.parallel import lp_shard
    cfg = EngineConfig(sharding="lp_device", n_devices=D)
    px = {"st": teng._init_engine(trandom.key(seed), cfg, dev), "mf": 1.2,
          "active": None}
    for name, fn in lp_shard.sharded_phases(cfg):
        px = fn(px)
        if name == "halo_exchange":
            break
    pos, lp, own = px["view_pos"], px["view_lp"], px["sender"]
    snd = torch.cat([own, torch.zeros(
        (D, pos.shape[-2] - own.shape[-1]), dtype=torch.bool, device=dev)],
        -1)
    return cfg.abm, pos, lp, snd


def check_dense(n, area, rng, seed, dev, all_senders=False, replicas=1,
                dead=0):
    """The dense kernel against its plain version, exactly; with
    `all_senders`, as `bestresponse` calls it (every SE a sender, on
    the stripe partition's map); with `replicas` > 1, that many worlds
    stacked as a batched step gives them (one launch); with `dead` > 0,
    an open world's (that many dead rows scattered over the world: lp
    -1, no sender, as the engine hands them; they must come out
    zero)."""
    from repro_torch.kernels.proximity import ops, ref
    if replicas > 1:
        worlds = [world(n, area, rng, seed + r, dev) for r in range(replicas)]
        cfg = worlds[0][0]
        pos, lp, snd = (torch.stack([w[i] for w in worlds])
                        for i in (1, 2, 3))
    else:
        cfg, pos, lp, snd = world(n, area, rng, seed, dev)
    if all_senders:
        from repro_torch.core import partition as part
        snd = torch.ones_like(snd)
        lp = part.partition(None, pos, torch.ones(n, device=dev),
                            part.PartitionConfig(backend="stripe",
                                                 area=area))
    if dead:
        valid = dead_rows(snd.shape, dead, dev, tail=False)
        lp, snd = torch.where(valid, lp, -1), snd & valid
    args = (pos, lp, snd, cfg.n_lp, area, rng)
    got = ops.proximity_lp_counts(*args)
    want = ref.dense_lp_counts_plain(*args)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    dead_zero = not dead or bool((got[~valid] == 0).all())
    if err != 0 or not dead_zero:
        raise AssertionError(f"dense kernel at n={n}, {dead} dead: "
                             f"max_abs_err={err}, dead rows zero {dead_zero}")
    ops.reset_launches()
    ops.proximity_lp_counts(*args)
    if ops.dense_kernel.launches != 1:
        raise AssertionError(f"dense kernel at {replicas} x {n}: "
                             f"{ops.dense_kernel.launches} launches a call")
    pairs = int(snd.sum()) * (n - dead - 1)  # live candidates only
    nbytes = replicas * (n * (8 + 4 + 1) + n * cfg.n_lp * 4)
    call = lambda: ops.proximity_lp_counts(*args)  # noqa: E731
    return {"n": n, "replicas": replicas, "area": area, "range": rng,
            "all_senders": all_senders,
            **({"dead_rows": dead, "dead_rows_zero": dead_zero}
               if dead else {}),
            "max_abs_err": err, "ms": time_ms(call),
            "kernel_device_ms": device_ms(call, "dense_lp_counts_kernel"),
            **call_profile(call),
            "plain_ms": time_ms(lambda: ref.dense_lp_counts_plain(*args),
                                batch=1, warmup=1),
            **bound(nbytes, pairs * OPS_PER_PAIR), "pair_tests": pairs,
            "library_ms": None}


def cell_sums_inputs(n, area, seed, dev, mobility="flock", replicas=1):
    """(pos, vec, grid) of an exp6 world of the given mobility (with
    `replicas` > 1, that many stacked as a batched step gives them)."""
    from repro_torch.core import neighbors
    sts = [scenario_world(mobility, seed + r, dev, n_se=n, area=area)
           for r in range(replicas)]
    cfg = sts[0][0]
    pos = torch.stack([st["pos"] for _, st in sts]).view(-1, n, 2)
    vec = torch.stack([st["mob"] for _, st in sts]).view(-1, n, 2)
    if replicas == 1:
        pos, vec = pos[0], vec[0]
    return pos, vec, neighbors.build_grid(pos, cfg.grid_spec())


def check_cell_sums(n, area, seed, dev, mobility="flock", replicas=1):
    """The flock's cell-sum kernel against its plain version (the
    in-order CPU sum), bit for bit, on an exp6 flock world (with
    `replicas` > 1, that many stacked as a batched step gives them:
    R * ncell^2 cells, one launch); the library call is `index_add_` of
    the five quantities (atomics, in no fixed order, so not the same
    bits)."""
    from repro_torch.kernels.cell_sums import ops, ref
    pos, vec, grid = cell_sums_inputs(n, area, seed, dev, mobility, replicas)
    got = ops.cell_sums(pos, vec, grid)
    pos, vec = pos.reshape(-1, 2), vec.reshape(-1, 2)
    want = ref.cell_sums_plain(pos, vec, grid)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = float((got - want).abs().max())
    if not same:
        raise AssertionError(f"cell_sums kernel at n={n}: not bit-equal "
                             f"(max_abs_err={err})")
    ops.reset_launches()
    ops.cell_sums(pos, vec, grid)
    if ops.kernel.launches != 1:
        raise AssertionError(f"cell_sums at {replicas} x {n}: "
                             f"{ops.kernel.launches} launches a call")
    n = replicas * n
    ncells = grid["starts"].shape[0]
    vals = torch.stack([torch.ones_like(pos[:, 0]), pos[:, 0], pos[:, 1],
                        vec[:, 0], vec[:, 1]])
    acc = torch.zeros((5, ncells), dtype=torch.float32, device=dev)
    cell = grid["cell"].long()
    # pos, vec and order per SE, the CSR offsets, the five sums
    nbytes = n * (8 + 8 + 8) + ncells * (16 + 20)
    call = lambda: ops.cell_sums(pos, vec, grid)  # noqa: E731
    return {"n": n, "replicas": replicas, "area": area, "layout": mobility,
            "cells": ncells,
            "max_cell": int(grid["counts"].max()), "max_abs_err": err,
            "bit_equal": same, "ms": time_ms(call),
            "kernel_device_ms": device_ms(call, "cell_sums_kernel"),
            **call_profile(call),
            "plain_ms": time_ms(lambda: ref.cell_sums_plain(pos, vec, grid),
                                batch=1),
            **bound(nbytes, 5 * n),
            "library_ms": time_ms(lambda: acc.index_add_(1, cell, vals)),
            "library_device_ms": device_ms(
                lambda: acc.index_add_(1, cell, vals))}


def assign_inputs(kind, seed, dev):
    """(cost, weights, caps) as the partitioners give them to the
    capacity assignment: kmeans' squared distances to 4 centroids and
    bestresponse's negated affinities on the stripe map of an exp6
    hotspot world; kmeans' on the engine's open world (9,800 of 10k
    slots live: weights 0 and 1, dead rows at 0) and on exp5's 50k-SE
    world with 8 LPs; and kmeans' with weights of 0.5, 1 and 2."""
    from repro_torch import random as trandom
    from repro_torch.core import partition as part
    from repro_torch.core.abm import ABMConfig, init_abm
    from repro_torch.kernels.proximity import ops as prox
    if kind == "exp5":
        cfg = ABMConfig(**EXP5_FULL)
        st = init_abm(trandom.key(seed), cfg, dev)
    else:
        cfg, st = scenario_world("hotspot", seed, dev)
    pos, n, L = st["pos"], cfg.n_se, cfg.n_lp
    w = torch.ones(n, device=dev)
    if kind == "open":
        live = dead_rows((n,), 200, dev, tail=False)
        w, pos = live.float(), torch.where(live[:, None], pos, 0.0)
    elif kind == "uneven":
        g = torch.Generator(device=dev).manual_seed(seed)
        w = torch.tensor([0.5, 1.0, 2.0], device=dev)[
            torch.randint(0, 3, (n,), generator=g, device=dev)]
    if kind == "bestresponse":
        lp = part.partition(None, pos, w, part.PartitionConfig(
            backend="stripe"))
        aff = prox.proximity_lp_counts(pos, lp, torch.ones_like(lp).bool(),
                                       L, cfg.area, cfg.interaction_range)
        cost = -aff.float()
    else:
        cent = trandom.uniform(trandom.key(seed), (L, 2), maxval=cfg.area,
                               device=dev)
        cost = part._toroidal_dist2(pos, cent, cfg.area, True)
    return cost, w, part.capacity_bounds(part.PartitionConfig(n_lp=L),
                                         w.sum().item())


#: (kind, seed) of the capacity-assign shapes `chip_smoke.py` checks
ASSIGN_SHAPES = (("kmeans", 11), ("bestresponse", 12), ("open", 13),
                 ("exp5", 14), ("uneven", 15))


def check_capacity_assign(kind, seed, dev):
    """The partitioners' capacity-assignment kernel (with its device
    sort) against its plain version (a host loop), exactly, on
    `assign_inputs(kind, seed)`. Weights of 0 or 1 must take the
    kernel's rounds, others its serial scan; each call prints its
    rounds and branch."""
    from repro_torch.kernels.capacity_assign import ops, ref
    cost, w, caps = assign_inputs(kind, seed, dev)
    n, L = cost.shape
    got = ops.capacity_assign(cost, w, caps)
    rounds = int(ops.last_rounds())
    want = ref.capacity_assign_plain(cost, w, caps)
    torch.cuda.synchronize()
    err = int((got.cpu() - want.cpu()).abs().max())
    if err != 0:
        raise AssertionError(f"capacity_assign kernel ({kind}): "
                             f"max_abs_err={err}")
    unit = bool(((w == 0) | (w == 1)).all())
    if (rounds > 0) != unit:
        raise AssertionError(f"capacity_assign ({kind}): {rounds} rounds "
                             f"with {'unit' if unit else 'uneven'} weights")
    call = lambda: ops.capacity_assign(cost, w, caps)  # noqa: E731
    # the costs and weights read once, the map written once; one
    # comparison a pair
    return {"n": n, "n_lp": L, "cost": kind, "live": int((w > 0).sum()),
            "branch": "rounds" if rounds else "serial", "rounds": rounds,
            "max_abs_err": err, "ms": time_ms(call, reps=10, batch=2),
            "kernel_device_ms": device_ms(call, "capacity_assign_kernel"),
            **call_profile(call),
            "plain_ms": time_ms(lambda: ref.capacity_assign_plain(
                cost, w, caps), reps=3, batch=1, warmup=1),
            **bound(n * L * 4 + n * 8, n * L), "library_ms": None}


@contextmanager
def capacity_assign_rounds():
    """Record the rounds tensor of every capacity-assign launch made in
    the block (no sync: each launch writes its own); yields the list."""
    from repro_torch.kernels.capacity_assign import ops
    real, got = ops.capacity_assign, []

    def call(*args, **kw):
        out = real(*args, **kw)
        if out.is_cuda:
            got.append(ops.last_rounds())
        return out
    with mock.patch.object(ops, "capacity_assign", call):
        yield got


def engine_rounds(phase: str, got: list) -> None:
    """Every capacity-assign launch of an engine phase took the rounds
    branch (the engine's weights are 0 or 1)."""
    rounds = torch.cat(got).tolist() if got else []
    serial = rounds.count(0)
    emit(phase="capacity_assign_rounds", of=phase, calls=len(rounds),
         serial_calls=serial, rounds_min=min(rounds, default=None),
         rounds_max=max(rounds, default=None))
    if serial:
        raise AssertionError(f"{phase}: {serial} of {len(rounds)} "
                             f"capacity-assign launches took the serial "
                             f"branch")


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


def check_flash_attention(B, H, Hkv, S, D, dtype, dev, Dv=None,
                          causal=True):
    """The attention forward at q, k (., D) and v (., Dv; D when None),
    causal or not (the encoder's), against its plain version; PyTorch's
    fused attention as the library call."""
    from repro_torch.kernels.flash_attention import ops, ref
    F = torch.nn.functional
    Dv = D if Dv is None else Dv
    q = _randn((B, H, S, D), 1, dev, dtype)
    k = _randn((B, Hkv, S, D), 2, dev, dtype)
    v = _randn((B, Hkv, S, Dv), 3, dev, dtype)
    got = ops.flash_attention(q, k, v, causal)
    want = ref.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    over, err = _attn_err(got, want, dtype)
    if over > 0:
        raise AssertionError(f"flash_attention at {(B, H, Hkv, S, D, Dv)} "
                             f"causal={causal} {dtype}: max_abs_err {err}")
    del got, want
    esize = q.element_size()
    nbytes = (B * H * S * (D + Dv) + B * Hkv * S * (D + Dv)) * esize
    # the (query, key) pairs the mask keeps
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    # QK^T over D and PV over Dv, a multiply and an add each
    ops_n = 2 * (D + Dv) * pairs
    peak = PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_F32_S
    call = lambda: ops.flash_attention(q, k, v, causal)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal, enable_gqa=Hkv < H)
    return {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "Dv": Dv,
            "causal": causal, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "ms": time_ms(call),
            "kernel_device_ms": device_ms(call, "flash_attention"),
            "plain_ms": time_ms(lambda: ref.flash_attention_plain(
                q, k, v, causal), batch=1),
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
    and on tie-heavy logits, the attention kernels in float32; and the
    two kernels of deepseek-v3-671b's prefill (phase mla_serve): the
    attention at Dk 192, Dv 128 (16 x 512 tokens, 128 heads) and the
    gate over 256 experts with its router bias; and zamba2-1.2b's shared
    block (phase recurrent_serve): 32 query and 32 KV heads at D 128,
    the attention over 16 x 512 tokens, decode over a cache of 576; and
    phase encdec_vision_serve's: seamless-m4t-medium's encoder attention
    (non-causal, 16/16 heads at D 64 over 16 x 512 frames), its
    cross-attention decode over the read-only 512-row encoder cache (at
    pos 511: every row) and its self-attention decode over the 64-row
    target cache, internvl2-2b's attention (16/8 heads at D 128, 16 x
    512 tokens) and decode (cache 576, pos 543)."""
    bf, f32 = torch.bfloat16, torch.float32
    return {
        "moe_gate": [check_moe_gate(8192, 128, 8, f32, dev),
                     check_moe_gate(16, 128, 8, f32, dev),
                     check_moe_gate(8192, 128, 8, bf, dev),
                     check_moe_gate(8192, 128, 8, f32, dev, bias=True),
                     check_moe_gate(8192, 128, 8, f32, dev, ties=True),
                     check_moe_gate(8192, 256, 8, f32, dev, bias=True),
                     check_moe_gate(16, 256, 8, f32, dev, bias=True)],
        "flash_attention": [
            check_flash_attention(16, 32, 4, 512, 64, bf, dev),
            check_flash_attention(2, 8, 2, 384, 128, f32, dev),
            check_flash_attention(16, 128, 128, 512, 192, bf, dev, Dv=128),
            check_flash_attention(16, 32, 32, 512, 128, bf, dev),
            check_flash_attention(16, 16, 16, 512, 64, bf, dev,
                                  causal=False),
            check_flash_attention(16, 16, 8, 512, 128, bf, dev)],
        "flash_decode": [
            check_flash_decode(16, 32, 4, 576, 64, 543, bf, dev),
            check_flash_decode(4, 8, 2, 1000, 128, 777, f32, dev),
            check_flash_decode(16, 32, 32, 576, 128, 543, bf, dev),
            check_flash_decode(16, 16, 16, 512, 64, 511, bf, dev),
            check_flash_decode(16, 16, 16, 64, 64, 63, bf, dev),
            check_flash_decode(16, 16, 8, 576, 128, 543, bf, dev)],
    }


def _row_errs(got_logits, want_logits):
    """Per (step, row) max |got - want| as a share of the largest |want|
    over all steps."""
    scale = max(float(w.float().abs().max()) for w in want_logits)
    errs = torch.stack([(g.float().cpu() - w.float().cpu()).abs().amax(-1)
                        for g, w in zip(got_logits, want_logits)])
    return errs / scale, scale


def _logit_rows(got_logits, want_logits) -> dict:
    """The median, 90th percentile and largest per-row error of
    `_row_errs`, and the logits' scale."""
    errs, scale = _row_errs(got_logits, want_logits)
    q = torch.quantile(errs.flatten(),
                       torch.tensor([0.5, 0.9, 1.0])).tolist()
    return {"logit_scale": scale, "row_err_median": q[0],
            "row_err_p90": q[1], "row_err_max": q[2]}


def _hold_rows(what, out: dict) -> dict:
    """Raise unless the median row is within SERVE_TYP and every row
    within SERVE_MAX."""
    if out["row_err_median"] > SERVE_TYP or out["row_err_max"] > SERVE_MAX:
        raise AssertionError(f"{what}: logits differ beyond the bf16 "
                             f"tolerance: {out}")
    return out


def _check_logits(what, got_logits, want_logits):
    return _hold_rows(what, _logit_rows(got_logits, want_logits))


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
        """picks: the layer's expert ids through each version (None for
        a dense layer: no row can route differently)."""
        g = got.reshape(-1, got.shape[-1]).float()
        w = want.reshape(-1, want.shape[-1]).float()
        if picks_got is None:
            flip = torch.zeros(g.shape[0], dtype=torch.bool,
                               device=g.device)
        else:
            flip = (picks_got.sort(1).values
                    != picks_want.sort(1).values).any(1)
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
    P, gen = prompts.shape[1], tokens.shape[1] - 1
    agree = {"prefill": _Agreement(), "decode": _Agreement()}

    def both(kind, fn):
        """fn(plain) through the kernels and through the plain versions;
        returns both results."""
        pk, pp = [], []
        with _gates(False, pk):
            out_k = fn(False)
        with _gates(True, pp):
            out_p = fn(True)
        agree[kind].add(out_k[0], out_p[0], pk[0] if pk else None,
                        pp[0] if pp else None)
        return out_k, out_p

    def logit_err(hk, hp):
        """Per row, after the last layer; the last layer's routing flips
        show here too."""
        lk, lp = (lm_head_fwd(params["embed"], rmsnorm(
            params["final_norm"], h, cfg.norm_eps)) for h in (hk, hp))
        return (lk - lp).abs().amax(-1).float().flatten() / lk.abs().max()

    x = embed_fwd(params["embed"], prompts)
    logit_errs = []

    def kwargs(moe, i):
        if not moe:
            return dict(cfg=cfg)
        return dict(cfg=cfg, router_bias=extras["router_bias"][i],
                    placement=extras["placement"][i])

    # the stacks in order: `dense_layers` (first_k_dense), then `layers`
    cache = {}
    for name, n, moe in lm.stacks(cfg):
        kvs = []
        for i in range(n):
            lay = lm.layer(params[lm.STACK_PARAMS[name]], i)
            kw = kwargs(moe, i)
            (x, kv, _), (xp, _, _) = both(
                "prefill", lambda plain: blocks.tf_block_fwd(
                    lay, x, return_kv=True, **kw))
            kvs.append(kv)
        cache[name] = lm.tree_map(lambda *t: torch.stack(t), *kvs)
        del kvs
    logit_errs.append(logit_err(x[:, -1:], xp[:, -1:]))
    cache = lm._pad_cache_to(cache, cfg, P + gen)
    for step in range(gen):
        x = embed_fwd(params["embed"], tokens[:, step, None])
        for name, n, moe in lm.stacks(cfg):
            for i in range(n):
                lay = lm.layer(params[lm.STACK_PARAMS[name]], i)
                kw = kwargs(moe, i)
                c = lm.layer(cache[name], i)
                twin = lm.tree_map(lambda t: t.clone(), c)
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


#: phase mla_serve: deepseek-v3-671b at full width, its 61 layers cut to
#: its 3 dense layers and 1 MoE layer (15.8 B parameters; the full model
#: does not fit one card), serve's traffic (16 x 512 prompts)
MLA_SERVE = dict(arch="deepseek-v3-671b", layers=4, batch=16,
                 prompt_len=512, seed=0)


def mla_serve_phase(gen: int, smi: str, dev):
    """deepseek-v3-671b cut to 4 layers (3 dense, 1 MoE of 256 experts
    with a shared expert) serving 16 prompts of 512 tokens and `gen`
    greedy steps through `launch/serve.py` with GAIA on and off; MLA
    prefill through the attention kernel at Dk 192 / Dv 128 (one launch
    a layer), absorbed MLA decode in torch ops (no flash_decode launch),
    the gate once a step in the one MoE layer; then every layer, dense
    stack first, against the plain versions (teacher-forced)."""
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.serve import example_gaia_config, serve
    from repro_torch.models import lm
    torch.cuda.empty_cache()  # phase serve's 60 GB go back first
    cfg = dataclasses.replace(get_arch(MLA_SERVE["arch"]),
                              n_layers=MLA_SERVE["layers"])
    gcfg = example_gaia_config(cfg)
    B, P, seed = (MLA_SERVE[k] for k in ("batch", "prompt_len", "seed"))
    torch.cuda.reset_peak_memory_stats()
    # the weights serve draws from `seed`, drawn here to count them (GAIA
    # on permutes them in place; the off run draws its own again)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(seed),
                            cfg)
    allocated = sum(t.numel() for t in tree.leaves(params))
    kbuild.reset_launches()
    run = serve(cfg, gcfg, B, P, gen, seed, dev, params=params,
                keep_logits=True)
    launches = kbuild.launches()
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    off = serve(cfg, None, B, P, gen, seed, dev, keep_logits=True)
    same = torch.equal(off["tokens"], run["tokens"])
    off_gap = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(off["logits"], run["logits"]))
    finite = all(bool(torch.isfinite(lg).all()) for lg in run["logits"])
    del off, run["logits"]
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(seed + 1))
    vs_plain = layerwise_vs_plain(cfg, seed, prompts, run["tokens"], dev)
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    want = {"flash_attention": cfg.n_layers, "flash_decode": 0,
            "moe_gate": n_moe * (gen + 1)}
    res = {"card": smi, "arch": cfg.name, "layers": cfg.n_layers,
           "dense_layers": cfg.moe.first_k_dense, "moe_layers": n_moe,
           "params_allocated": allocated,
           "param_count": cfg.param_count(),
           "batch": B, "prompt_len": P, "gen": gen, "cache_len": P + gen,
           "gaia": dataclasses.asdict(gcfg),
           "launches": {k: launches[k] for k in want},
           "migrations": run["migrations"],
           "migration_steps": run["migration_steps"],
           "max_memory_allocated": peak, "prefill_s": run["prefill_s"],
           "prefill_tokens_per_s": B * P / run["prefill_s"],
           "decode_ms_per_step": 1e3 * run["decode_s"] / gen,
           "decode_tokens_per_s": B * gen / run["decode_s"],
           "logits_finite": finite,
           "gaia_off": {"same_tokens": same, "max_logit_gap": off_gap},
           "vs_plain_layerwise": vs_plain}
    emit(phase="mla_serve", **res)
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"mla_serve launched {launches}, want {want}")
    if run["migrations"] <= 0:
        raise AssertionError("mla_serve: GAIA migrated no expert")
    if not same:
        raise AssertionError("mla_serve: GAIA on and off gave other tokens")
    if not finite or tuple(run["tokens"].shape) != (B, gen + 1):
        raise AssertionError("mla_serve: non-finite logits or tokens of "
                             f"shape {tuple(run['tokens'].shape)}")
    return res


def serve_cpu_phase(dev, gen: int = 16):
    """The smoke configs of phase serve's model (GAIA on), of the
    recurrent families and of the encoder-decoder and vision families on
    the card against the port on the CPU, teacher-forced on the CPU's
    tokens (seamless-smoke: 32 frames; internvl2-smoke: 32 prompt
    tokens, the first 8 vision tokens; both attend at D 16)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import example_gaia_config, serve
    from repro_torch.models import lm
    B, P = 8, 32
    for arch in ((SERVE["arch"],) + RECURRENT_SERVE["archs"]
                 + ENCDEC_VISION_SERVE["archs"]):
        cfg = get_smoke(arch)
        gcfg = example_gaia_config(cfg) if cfg.moe is not None else None
        params = lm.init_params(torch.Generator().manual_seed(1), cfg)
        cpu = serve(cfg, gcfg, B, P, gen, 1, "cpu", params=params,
                    keep_logits=True)
        params = lm.init_params(torch.Generator().manual_seed(1), cfg)
        params = lm.tree_map(lambda t: t.to(dev), params)
        card = serve(cfg, gcfg, B, P, gen, 1, dev, params=params,
                     forced=cpu["tokens"], keep_logits=True)
        res = _check_logits(f"serve_cpu {cfg.name}: card vs CPU",
                            card["logits"], cpu["logits"])
        same_steps = card["migration_steps"] == cpu["migration_steps"]
        emit(phase="serve_cpu", arch=cfg.name, batch=B, prompt_len=P,
             gen=gen, migrations=cpu["migrations"],
             same_migration_steps=same_steps, **res)
        if not same_steps:
            raise AssertionError(f"serve_cpu {cfg.name}: migrations differ")


def profile_serve(steps: int, dev, arch: str = ""):
    """Where the serve phase's model (or `arch`, at full width and
    depth) spends its time: one traced prefill, then `steps` untraced
    and `steps` traced decode steps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.launch.steps import argmax_first, model_fns
    from repro_torch.models import lm
    cfg = get_arch(arch or SERVE["arch"])
    B, P = SERVE["batch"], SERVE["prompt_len"]
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    extras = lm.init_extras(cfg, dev)
    # the prompts (an encoder-decoder's frames; vision embeddings too)
    # serve draws, and its prefill, decode and positions
    inputs = serve_inputs(cfg, B, P, 0, None, None, None, dev)
    _, prefill, decode = model_fns(cfg)
    start = 0 if cfg.encoder_decoder else P
    cache_len = start + 3 * steps
    prefill(params, inputs, cfg, cache_len)  # warm-up
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
    cache, logits = prefill(params, inputs, cfg, cache_len)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        cache, logits = prefill(params, inputs, cfg, cache_len)
        torch.cuda.synchronize()
    summarize(prof, 1, wall, "prefill")
    tok = argmax_first(logits[:, -1])
    pos = start
    for _ in range(2):  # warm-up
        cache, lg = decode(params, cache, tok, pos, extras, cfg)
        tok, pos = argmax_first(lg), pos + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        cache, lg = decode(params, cache, tok, pos, extras, cfg)
        tok, pos = argmax_first(lg), pos + 1
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / steps
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            cache, lg = decode(params, cache, tok, pos, extras, cfg)
            tok, pos = argmax_first(lg), pos + 1
        torch.cuda.synchronize()
    summarize(prof, steps, wall, "decode")


# ---------------------------------------------------------------------------
# Phase train: the training path's kernels, tinyllama-1.1b at full width
# and depth through the Trainer, qwen3-moe-30b-a3b at full width and cut
# depth, and one float32 step on the card against the CPU
# ---------------------------------------------------------------------------

#: phase train's runs: train_4k's sequence; its global batch of 256 cut
#: to 8 rows in 4 microbatches (the MoE run: 4 rows in 2, 2 layers)
TRAIN = dict(arch="tinyllama-1.1b", seq=4096, batch=8, microbatches=4,
             loss_chunk=1024, checkpoint_every=3, fail_at=4)
TRAIN_MOE = dict(arch="qwen3-moe-30b-a3b", layers=2, seq=4096, batch=4,
                 microbatches=2, loss_chunk=1024, checkpoint_every=1000)
#: the float32 step of the smoke configs, card against CPU
#: (tests/test_torch_train.py's tolerances): the loss and lr within
#: TRAIN_F32_TOL relative, params within it absolute, the grad norm
#: within TRAIN_GRAD_TOL relative (the gradients' own tolerance: the
#: first layer's rmsnorm divides by the embedding's RMS, ~0.02, so its
#: input gradient is a difference of large terms), router_bias exact
TRAIN_F32_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
#: seamless's smoke attends almost by argmax (tests/test_torch_encdec.py),
#: so its gradients move under a one-ULP change of its frames: where a
#: batch has float inputs, the grad norm is held within TRAIN_ULP_FACTOR
#: times the CPU's own move under that change where that is the larger
#: bar (tests/test_torch_encdec_train.py's rule against the reference)
TRAIN_ULP_FACTOR = 10
#: and, since the warmup's first step moves each entry by about lr (3e-6
#: here), below TRAIN_F32_TOL, at most this share of the entries may be
#: further than a tenth of the step's move from the CPU's
#: (tests/test_torch_encdec_train.py's FAR_SHARE)
TRAIN_FAR_SHARE = 1e-3


def check_flash_attention_bwd(B, H, Hkv, S, D, dtype, dev, causal=True):
    """The backward kernel (and the forward's row log-sum-exp), causal or
    not (an encoder's and a cross attention's), against autograd through
    the plain version in float32 on the same inputs: each gradient
    within ATTN_TOL of its largest |value|; two calls bit-equal; in bf16
    at D 64 and 128 the kernels that ran are the wgmma ones, never the
    mma.sync ones. The library call is autograd through PyTorch's fused
    attention (its backward alone, on a kept graph)."""
    from repro_torch.kernels.flash_attention import ops, ref
    F = torch.nn.functional
    q = _randn((B, H, S, D), 11, dev, dtype)
    k = _randn((B, Hkv, S, D), 12, dev, dtype)
    v = _randn((B, Hkv, S, D), 13, dev, dtype)
    do = _randn((B, H, S, D), 14, dev, dtype)
    out, lse = ops._forward(q, k, v, causal, True)
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, causal)
    lse_err = float((lse - ref.flash_attention_lse_plain(
        q, k, causal)).abs().max())
    want = ref.flash_attention_grads_plain(
        *(t.float() for t in (q, k, v, do)), causal)
    errs = [float((g.float() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    del want
    torch.cuda.synchronize()
    what = (f"flash_attention_bwd at {(B, H, Hkv, S, D)} causal={causal} "
            f"{dtype}")
    if max(errs) > ATTN_TOL[dtype] or lse_err > 1e-3:
        raise AssertionError(f"{what}: errors {errs}, lse {lse_err}")
    again = ops.flash_attention_bwd(q, k, v, out, do, lse, causal)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two calls differ")
    del got, again
    esize = q.element_size()
    # read q, O, dO, k, v and lse once; write dq, dk, dv once
    nbytes = ((4 * B * H * S * D + 4 * B * Hkv * S * D) * esize
              + B * H * S * 4)
    # the (query, key) pairs the mask keeps
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    ops_n = 10 * D * pairs  # S, dP, dV, dK, dQ: a multiply and an add each
    peak = PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_F32_S
    call = lambda: ops.flash_attention_bwd(  # noqa: E731
        q, k, v, out, do, lse, causal)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=True)
    lib = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, leaves, do, retain_graph=True)
    # wgmma (bf16, D 64 / 128): prep, dK/dV, the group sum where
    # Hkv < H, dQ; else delta, dK/dV, dQ
    wgmma = dtype == torch.bfloat16 and D >= 64
    expect = 3 + (wgmma and Hkv < H)
    dev_ms, per_call, names = device_profile(call, calls=5, expect=expect)
    old = [n for n in names if "dkdv_mma_kernel" in n or "dq_mma_kernel" in n]
    new = [n for n in names if "wgmma_kernel" in n]
    if wgmma and (old or len(new) != 2):
        raise AssertionError(f"{what}: ran {names}, not the wgmma kernels")
    res = {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D, "causal": causal,
           "dtype": str(dtype).split(".")[-1], "max_abs_err": max(errs),
           "errs_dq_dk_dv": errs, "lse_err": lse_err,
           "ms": time_ms(call, reps=5, batch=2),
           "kernel_device_ms": dev_ms, "device_kernels_per_call": per_call,
           "device_kernels": names, "device_ms_by_kernel": device_split(call),
           "plain_ms": time_ms(lambda: ref.flash_attention_grads_plain(
               q, k, v, do, causal), reps=3, batch=1, warmup=1),
           **bound(nbytes, ops_n, peak),
           "library_ms": time_ms(lib, reps=5, batch=2),
           "library_device_ms": device_ms(lib, calls=5)}
    del lib_out, leaves
    return res


def check_moe_gate_bwd(T, E, k, dtype, dev, ties=False):
    """The gate's probability-mean forward (one kernel a call) and its
    backward kernel against the plain version and autograd through it:
    ids and counts exact, the mean and d logits within GATE_TOL of their
    largest |value|, two calls bit-equal. No single library call
    computes it."""
    from repro_torch.kernels.moe_gate import ops, ref
    logits = _randn((T, E), T + E + 7, dev, dtype, scale=0.7)
    if ties:
        logits = torch.round(logits * 2) / 2
    b = _randn((E,), E + 3, dev, scale=0.05)
    gtp = _randn((T, k), 21, dev)
    gpm = _randn((E,), 22, dev)
    top_p, top_e, counts, pm = ops.moe_gate(logits, k, b, True,
                                            prob_mean=True)
    want = ref.moe_gate_plain(logits, k, b, True, prob_mean=True)
    got = ops.moe_gate_bwd(logits, top_e, gtp, gpm, True)
    wg = ref.moe_gate_grads_plain(logits, k, b, True, gtp, gpm)
    torch.cuda.synchronize()
    pm_err = float((pm - want[3]).abs().max() / want[3].abs().max())
    err = float((got.float() - wg).abs().max() / wg.abs().max())
    what = f"moe_gate_bwd at T={T}, E={E}, k={k}, {dtype}, ties={ties}"
    if not (torch.equal(top_e, want[1]) and torch.equal(counts, want[2])
            and pm_err <= GATE_TOL and err <= GATE_TOL):
        raise AssertionError(f"{what}: ids/counts differ, prob_mean err "
                             f"{pm_err}, d logits err {err}")
    same = torch.equal(got, ops.moe_gate_bwd(logits, top_e, gtp, gpm, True))
    same = same and torch.equal(pm, ops.moe_gate(logits, k, b, True,
                                                 prob_mean=True)[3])
    if not same:
        raise AssertionError(f"{what}: two calls differ")
    esize = logits.element_size()
    # read logits, ids, g_top_p and g_prob_mean; write d logits
    nbytes = 2 * T * E * esize + T * k * 8 + E * 4
    ops_n = T * E * 8  # max, sub, exp, sum, div, dot, sub and mul a value
    call = lambda: ops.moe_gate_bwd(logits, top_e, gtp, gpm, True)  # noqa
    fwd = lambda: ops.moe_gate(logits, k, b, True, prob_mean=True)  # noqa
    fwd_ms, fwd_per_call, fwd_names = device_profile(fwd, expect=1)
    if fwd_per_call != 1:
        raise AssertionError(f"{what}: the forward with the mean issued "
                             f"{fwd_names}, {fwd_per_call} a call, not one "
                             f"kernel")
    # the forward's bytes and operations (check_moe_gate's) and the mean's
    fwd_bytes = T * E * esize + E * 4 + T * k * 8 + E * 4 + E * 4
    fwd_ops = T * E * (5 + 2 * k) + T * E
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"T": T, "E": E, "k": k, "dtype": str(dtype).split(".")[-1],
            "ties": ties, "blocks": ops.grid_plan(T, sms),
            "max_abs_err": err, "prob_mean_err": pm_err,
            "ms": time_ms(call),
            "kernel_device_ms": device_ms(call, "moe_gate_bwd_kernel"),
            "plain_ms": time_ms(lambda: ref.moe_gate_grads_plain(
                logits, k, b, True, gtp, gpm), batch=1),
            **bound(nbytes, ops_n), "library_ms": None,
            "prob_mean_forward": {
                "ms": time_ms(fwd), "device_ms": fwd_ms,
                "device_kernels_per_call": fwd_per_call,
                "device_kernels": fwd_names,
                "plain_ms": time_ms(lambda: ref.moe_gate_plain(
                    logits, k, b, True, prob_mean=True), batch=1),
                **bound(fwd_bytes, fwd_ops)}}


#: log-decay laws of `wkv_inputs`: a token's uniform (low, high) range
WKV_DECAYS = {"steep": (2.9, 3.1), "cliff": (0.0, 60.0)}


def wkv_inputs(B, H, S, N, chunk, seed, dev, decay="trained"):
    """r, k, l_prev and l (B, H, S, N) float32 as rwkv6's time mix gives
    them: log-decays -exp(w) with w ~ N(-3, 1) (the trained range
    straddles the init's -6 and 0), summed inside each chunk. `decay`
    "steep": log-decays uniform in -3.1..-2.9 a token, so l falls to
    about -380 in a chunk of 128, far past the -88 where a factored
    exp(-l) overflows float32; "cliff": uniform in -60..0, l to about
    -3,800 (the sub-chunk factors underflow to 0 where the true terms
    do)."""
    r = _randn((B, H, S, N), seed, dev)
    k = _randn((B, H, S, N), seed + 1, dev)
    shape = (B, H, S // chunk, chunk, N)
    if decay in WKV_DECAYS:
        lo, hi = WKV_DECAYS[decay]
        g = torch.Generator(device=dev).manual_seed(seed + 2)
        lw = -lo - (hi - lo) * torch.rand(shape, generator=g, device=dev)
    else:
        lw = -torch.exp(_randn(shape, seed + 2, dev) - 3)
    l = torch.cumsum(lw, 3)
    return [t.reshape(B, H, S, N).contiguous() for t in (r, k, l - lw, l)]


def wkv_exponentials(chunk, N):
    """The exponentials the WKV kernels evaluate for one chunk of
    `chunk` rows at head size N: each diagonal sub-chunk's pairs below
    its diagonal, one column factor a row of each sub-chunk that a later
    one reads, and one row factor a row of each sub-chunk and column
    sub-chunk before it (97,280 at c 128, N 64)."""
    rows = [min(WKV_SUB, chunk - s) for s in range(0, chunk, WKV_SUB)]
    return N * (sum(m * (m - 1) // 2 for m in rows)
                + WKV_SUB * (len(rows) - 1)
                + sum(T * m for T, m in enumerate(rows)))


def _wkv_timings(what, call, plain, B, H, S, N, chunk, nbytes, per_pair):
    """The times of a WKV kernel's call and of its plain version, its
    bound (`per_pair` operations a (t, i, n) triple below the diagonal:
    the function's work, whatever the design), the exponentials the
    sub-chunk design evaluates and their SFU time, beside those of a
    direct exponent a triple; raises unless a call runs one kernel."""
    chunks = B * H * (S // chunk)
    pairs = chunks * chunk * (chunk - 1) // 2 * N
    exps = chunks * wkv_exponentials(chunk, N)
    dev_ms, per_call, names = device_profile(call, calls=10, expect=1)
    if per_call != 1:
        raise AssertionError(f"{what}: a call ran {names}, not one kernel")
    return {"B": B, "H": H, "S": S, "N": N, "chunk": chunk,
            "ms": time_ms(call), "kernel_device_ms": dev_ms,
            "device_kernels": names,
            "plain_ms": time_ms(plain, reps=3, batch=1, warmup=1),
            **bound(nbytes, per_pair * pairs), "exponentials": exps,
            "exponentials_a_chunk": wkv_exponentials(chunk, N),
            "sfu_exp_ms": 1e3 * exps / PEAK_EXP_S,
            "exponentials_direct": pairs,
            "sfu_exp_direct_ms": 1e3 * pairs / PEAK_EXP_S,
            "library_ms": None}


def check_wkv_intra(B, H, S, N, chunk, dev, decay="trained"):
    """The WKV intra-chunk forward against its plain version (within
    WKV_FWD_TOL of the largest |A|), two calls bit-equal, one kernel a
    call (`decay`: see `wkv_inputs`). No single PyTorch call computes
    A."""
    from repro_torch.kernels.wkv import ops, ref
    r, k, lp, l = wkv_inputs(B, H, S, N, chunk, 31, dev, decay)
    got = ops.wkv_intra(r, k, lp, l, chunk)
    want = ref.wkv_intra_plain(r, k, lp, l, chunk)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    what = f"wkv_intra at {(B, H, S, N)}, chunk {chunk}, decay {decay}"
    if rel > WKV_FWD_TOL or not torch.equal(
            got, ops.wkv_intra(r, k, lp, l, chunk)):
        raise AssertionError(f"{what}: error {rel} of the largest |A|, "
                             f"or two calls differ")
    del got, want
    return {"decay": decay, "max_abs_err": err, "err_of_largest": rel,
            **_wkv_timings(
                what, lambda: ops.wkv_intra(r, k, lp, l, chunk),
                lambda: ref.wkv_intra_plain(r, k, lp, l, chunk),
                B, H, S, N, chunk,
                # read r, k, l_prev and l once; write A once
                4 * B * H * S * N * 4 + B * H * S * chunk * 4,
                5)}  # sub, exp, r k, fused add (2)


def check_wkv_intra_bwd(B, H, S, N, chunk, dev, decay="trained"):
    """The WKV backward kernel against the plain backward (each gradient
    within WKV_BWD_TOL of its largest |value|), two calls bit-equal
    (`decay`: see `wkv_inputs`). No single PyTorch call computes it."""
    from repro_torch.kernels.wkv import ops, ref
    r, k, lp, l = wkv_inputs(B, H, S, N, chunk, 41, dev, decay)
    dA = _randn((B, H, S // chunk, chunk, chunk), 45, dev)
    got = ops.wkv_intra_bwd(r, k, lp, l, dA, chunk)
    want = ref.wkv_intra_bwd_plain(r, k, lp, l, dA, chunk)
    torch.cuda.synchronize()
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    what = (f"wkv_intra_bwd at {(B, H, S, N)}, chunk {chunk}, "
            f"decay {decay}")
    again = ops.wkv_intra_bwd(r, k, lp, l, dA, chunk)
    if max(errs) > WKV_BWD_TOL or not all(
            torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: errors (dr, dk, dl_prev, dl) "
                             f"{errs}, or two calls differ")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del got, want, again
    return {"decay": decay, "max_abs_err": err, "errs_dr_dk_dlp_dl": errs,
            **_wkv_timings(
                what, lambda: ops.wkv_intra_bwd(r, k, lp, l, dA, chunk),
                lambda: ref.wkv_intra_bwd_plain(r, k, lp, l, dA, chunk),
                B, H, S, N, chunk,
                # read r, k, l_prev, l and dA once; write dr, dk,
                # dl_prev, dl once
                8 * B * H * S * N * 4 + B * H * S * chunk * 4,
                7)}  # sub, exp, dA e, two fused adds (2 each)


#: (B, H, S, N, chunk) and decay of the WKV pair's checks: rwkv6-1.6b's
#: training microbatch (the kernels line's shape), its serve prefill,
#: and the training microbatch with steep decays and with a cliff
WKV_CHECKS = (((2, 32, 4096, 64, 128), "trained"),
              ((16, 32, 512, 64, 128), "trained"),
              ((2, 32, 4096, 64, 128), "steep"),
              ((2, 32, 4096, 64, 128), "cliff"))


def train_kernels_child(dev):
    """Body of `--train-kernels-child`: the checks of phase train that
    run in a fresh process (`child_checks`), one JSON line."""
    bf, f32 = torch.bfloat16, torch.float32
    print(json.dumps({
        "wkv_intra": [check_wkv_intra(*shape, dev, decay)
                      for shape, decay in WKV_CHECKS],
        "wkv_intra_bwd": [check_wkv_intra_bwd(*shape, dev, decay)
                          for shape, decay in WKV_CHECKS],
        "moe_gate_bwd": [check_moe_gate_bwd(8192, 128, 8, f32, dev),
                         check_moe_gate_bwd(8192, 128, 8, f32, dev,
                                            ties=True)],
        "flash_attention_bwd_train": [
            check_flash_attention_bwd(B, H, Hkv, S, D, bf, dev, causal=c)
            for B, H, Hkv, S, D, c in ENCDEC_VISION_TRAIN_SHAPES],
        "flash_attention_train": [
            check_flash_attention(B, H, Hkv, S, D, bf, dev, causal=c)
            for B, H, Hkv, S, D, c in ENCDEC_VISION_TRAIN_SHAPES]}),
        flush=True)


def child_checks() -> dict:
    """`train_kernels_child`'s checks: the WKV pair's, the gate's
    backward and probability-mean forward, and the attention forward and
    backward at `ENCDEC_VISION_TRAIN_SHAPES`, in a fresh process of this
    script (`--train-kernels-child`). Late in the script torch.profiler
    twice recorded none of the WKV backward's launches in five traces in
    a row, and once 19 of the gate's 20 forward launches in each of
    five, which the one-kernel-a-call holds read; in a fresh process
    none of 60 traces lost one."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--train-kernels-child"], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"train kernels child failed:\n"
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


#: phase encdec_vision_train's attention calls, (B, H, Hkv, S = Skv, D,
#: causal) at its 2 x 4,096 microbatch: seamless-m4t-medium's encoder and
#: cross attention (non-causal, 16/16 heads at D 64), its decoder's self
#: attention (causal) and internvl2-2b's (causal, 16/8 heads at D 128)
ENCDEC_VISION_TRAIN_SHAPES = ((2, 16, 16, 4096, 64, False),
                              (2, 16, 16, 4096, 64, True),
                              (2, 16, 8, 4096, 128, True))


def check_train_kernels(dev):
    """The training path's kernels at the shapes its runs give them:
    tinyllama's and qwen2-7b's attention backward, zamba2's (32 query
    and 32 KV heads at D 128, the branch without the group sum),
    and, in a fresh process (`child_checks`), phase
    encdec_vision_train's forward and backward
    (`ENCDEC_VISION_TRAIN_SHAPES`), the gate's, and rwkv6-1.6b's WKV
    pair (both at the training microbatch and at the serve prefill, and
    at the training microbatch with steep decays and with a cliff)."""
    bf, f32 = torch.bfloat16, torch.float32
    child = child_checks()
    return {
        "flash_attention_bwd": [
            check_flash_attention_bwd(2, 32, 4, 4096, 64, bf, dev),
            check_flash_attention_bwd(1, 28, 4, 4096, 128, bf, dev),
            check_flash_attention_bwd(1, 4, 2, 1024, 16, f32, dev),
            check_flash_attention_bwd(2, 32, 32, 4096, 128, bf, dev),
            *child.pop("flash_attention_bwd_train")],
        **child,
        # qwen2-7b's group of 7 at D 128, forward and decode
        "flash_attention_g7": [
            check_flash_attention(1, 28, 4, 4096, 128, bf, dev)],
        "flash_decode_g7": [
            check_flash_decode(4, 28, 4, 528, 128, 527, bf, dev)],
    }


def _digests(state) -> list:
    """sha256 and dtype of each leaf's bytes, in the checkpoint's order
    (bf16 as its uint16 bits): two states are bit-equal where these
    are."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import tree
    from repro_torch.checkpoint.manager import _to_host

    def one(t):
        arr, dt = _to_host(t)
        return hashlib.sha256(arr.data).hexdigest() + ":" + dt
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        return list(ex.map(one, tree.leaves(state)))


def _train_run(cfg, spec, steps, ckpt, dev, fail_at=None, snapshot_at=0):
    """One Trainer run of phase train (AdamW, remat, chunked loss, a
    checkpoint every spec["checkpoint_every"] steps, async; none at the
    end: the card machine's disk takes ~45 GiB of writes a call, and
    tinyllama's state is 15.4 GB). Returns (result, or None where it
    crashed as asked; per-step loss, grad norm, lr and the allocator's
    retries so far; per-step seconds, without the snapshot's copy; the
    run's trainer; the state after step `snapshot_at` on the host, or
    None)."""
    from repro_torch import tree
    from repro_torch.launch.steps import TrainCtx
    from repro_torch.launch.train import make_trainer
    px = TrainCtx(num_microbatches=spec["microbatches"],
                  loss_chunk=spec["loss_chunk"])
    tr = make_trainer(cfg, seq=spec["seq"], batch=spec["batch"],
                      steps=steps, ckpt_dir=ckpt, device=dev, px=px,
                      checkpoint_every=spec["checkpoint_every"],
                      save_final=False, log=lambda s: None)
    per_step, inner, snap = [], tr.step_fn, []

    def step_fn(*args):
        out = inner(*args)
        per_step.append({**{k: float(out[3][k])
                            for k in ("loss", "grad_norm", "lr")},
                         "alloc_retries": torch.cuda.memory_stats().get(
                             "num_alloc_retries", 0)})
        if snapshot_at and len(per_step) == snapshot_at:
            # a copy: the next step updates the optimizer state in place
            t0 = time.perf_counter()
            snap.append(tree.tree_map(lambda t: t.to("cpu", copy=True),
                                      out[:3]))
            snap.append(time.perf_counter() - t0)
        return out
    tr.step_fn = step_fn
    try:
        res = tr.run(fail_at=fail_at)
    except RuntimeError as e:
        if fail_at is None or "injected failure" not in str(e):
            raise
        res = None
    secs = list(tr.step_seconds)
    if snap:
        secs[snapshot_at - 1] -= snap[1]
    tr.step_fn = inner
    return res, per_step, secs, tr, (snap[0] if snap else None)


def _moved(cfg, master, dev):
    """Per leaf: the largest change of the float32 master weights from
    the seed's initial weights (a bf16 weight may round back to its
    start after a few warmup steps; its master does not)."""
    from repro_torch import tree
    from repro_torch.models import lm
    init = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    return [float((a.float() - b).abs().max())
            for a, b in zip(tree.leaves(init), tree.leaves(master))]


def _finite(per_step):
    return all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in per_step)


def _state(res):
    return res["params"], res["opt_state"], res["extras"]


def train_dense(steps: int, smi: str, dev):
    """tinyllama-1.1b at full width and depth through the Trainer:
    `steps` steps with an async checkpoint at step 3; then, from that
    checkpoint, a run killed after step 4 and a second restart, which
    must end with the first run's params, optimizer state, extras and
    data cursor, bit for bit (every leaf's sha256). One checkpoint is
    written in all. Returns the first run's launches."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    spec, cfg = TRAIN, get_arch(TRAIN["arch"])
    root = os.path.join(HERE, "results", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    res, per_step, secs, _, _ = _train_run(cfg, spec, steps, root, dev)
    wall = time.perf_counter() - t0
    launches = kbuild.launches()
    peak = torch.cuda.max_memory_allocated()
    moved = _moved(cfg, res["opt_state"]["master"], dev)
    first = (_digests(_state(res)), res["data_step"], per_step[-1]["loss"])
    del res
    t0 = time.perf_counter()
    crashed, _, _, _, _ = _train_run(cfg, spec, steps, root, dev,
                                     fail_at=spec["fail_at"])
    resumed, per2, _, _, _ = _train_run(cfg, spec, steps, root, dev)
    t_restart = time.perf_counter() - t0
    second = (_digests(_state(resumed)), resumed["data_step"],
              per2[-1]["loss"])
    del resumed
    shutil.rmtree(root)
    s_step = statistics.median(secs[-4:])
    steady = statistics.median(secs[1:])  # after the first (warm-up)
    tokens = spec["batch"] * spec["seq"]
    # model FLOPs a token: 6 x the matmul parameters (the input embedding
    # is a lookup) + 6 L S d for causal attention (forward and backward)
    n_mm = cfg.param_count() - cfg.padded_vocab * cfg.d_model
    flops_tok = 6 * n_mm + 6 * cfg.n_layers * spec["seq"] * cfg.d_model
    out = {"run": "dense", "card": smi, "arch": cfg.name,
           "layers": cfg.n_layers, "params": cfg.param_count(),
           **{k: spec[k] for k in ("seq", "batch", "microbatches",
                                   "loss_chunk", "checkpoint_every")},
           "steps": steps, "remat": "full", "optimizer": "adamw",
           "s_per_step": s_step, "s_per_step_after_first": steady,
           "step_seconds": secs, "tokens_per_s": tokens / s_step,
           "model_flops_per_step": flops_tok * tokens,
           "mfu_vs_989_tflops": flops_tok * tokens / s_step / PEAK_BF16_S,
           "max_memory_allocated": peak, "wall_s": wall,
           "launches_per_step": {k: n / steps for k, n in launches.items()
                                 if n},
           "per_step": per_step, "params_moved_min": min(moved),
           "restart": {"fail_at": spec["fail_at"],
                       "resumed_from": spec["checkpoint_every"],
                       "seconds": t_restart, "leaves": len(first[0]),
                       "bit_exact": first == second and crashed is None}}
    emit(phase="train", **out)
    want = {"flash_attention": 2 * cfg.n_layers * spec["microbatches"],
            "flash_attention_bwd": cfg.n_layers * spec["microbatches"]}
    if any(launches[k] != n * steps for k, n in want.items()):
        raise AssertionError(f"train: launched {launches}, want {want} "
                             f"a step")
    if not _finite(per_step) or min(moved) <= 0:
        raise AssertionError("train: a non-finite loss or grad norm, or a "
                             "weight that did not move")
    if not out["restart"]["bit_exact"]:
        raise AssertionError("train: the restarted run differs from the "
                             "uninterrupted one")
    return launches


def train_moe(steps: int, smi: str, dev):
    """qwen3-moe-30b-a3b at full width, cut to 2 layers, through the
    Trainer: each microbatch's expert counts sum to T k in every layer
    and move router_bias by +-BIAS_LR where they differ from their mean;
    the run restarted from its state after step `steps` - 1 (kept on the
    host: a 25.6 GB checkpoint would not fit the call's disk writes
    beside tinyllama's) ends bit for bit where it ended."""
    import shutil

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import steps as tsteps
    spec = TRAIN_MOE
    cfg = dataclasses.replace(get_arch(spec["arch"]),
                              n_layers=spec["layers"])
    root = os.path.join(HERE, "results", "train_moe_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    rec = []
    orig = tsteps._update_router_bias

    def spy(extras, metrics):
        new = orig(extras, metrics)
        rec.append((extras["router_bias"].clone(),
                    metrics["expert_counts"].clone(),
                    new["router_bias"].clone()))
        return new
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    with mock.patch.object(tsteps, "_update_router_bias", spy):
        res, per_step, secs, tr, snap = _train_run(
            cfg, spec, steps, root, dev, snapshot_at=steps - 1)
    launches = kbuild.launches()
    peak = torch.cuda.max_memory_allocated()
    moved = _moved(cfg, res["opt_state"]["master"], dev)
    first = (_digests(_state(res)), res["data_step"], per_step[-1]["loss"])
    del res
    T = spec["batch"] // spec["microbatches"] * spec["seq"]
    K = cfg.moe.top_k
    sums_ok, bias_ok, dev_from_lr = True, True, 0.0
    for before, counts, after in rec:
        sums_ok &= bool((counts.sum(-1) == T * K).all())
        c = counts.float()
        mean = c.mean(-1, keepdim=True)
        want = torch.where(c != mean,
                           before + tsteps.BIAS_LR * torch.sign(mean - c),
                           before)
        bias_ok &= torch.equal(after, want)
        d = (after.double() - before.double()).abs()
        dev_from_lr = max(dev_from_lr, float(
            (d - tsteps.BIAS_LR * (c != mean)).abs().max()))
    # the restart: the run's own step on the host state after step
    # steps - 1 and the stream's batch at that cursor
    t0 = time.perf_counter()
    batch = SyntheticLM(tr.data_cfg).batch_at(steps - 1)
    state = tree.tree_map(lambda t: t.to(dev), snap)
    del snap
    p, o, e, m = tr.step_fn(*state, batch)
    del state
    second = (_digests((p, o, e)), steps, float(m["loss"]))
    del p, o, e
    t_restart = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    s_step = statistics.median(secs[1:])  # after the first (warm-up)
    out = {"run": "moe", "card": smi, "arch": cfg.name,
           "layers": cfg.n_layers, "params": cfg.param_count(),
           **{k: spec[k] for k in ("seq", "batch", "microbatches",
                                   "loss_chunk")},
           "steps": steps, "s_per_step": s_step, "step_seconds": secs,
           "tokens_per_s": spec["batch"] * spec["seq"] / s_step,
           "max_memory_allocated": peak,
           "launches_per_step": {k: n / steps for k, n in launches.items()
                                 if n},
           "per_step": per_step, "params_moved_min": min(moved),
           "microbatches_seen": len(rec), "counts_sum_to_TK": sums_ok,
           "router_bias_sign_update": bias_ok,
           "bias_move_max_dev_from_lr": dev_from_lr,
           "restart": {"from_step": steps - 1, "seconds": t_restart,
                       "leaves": len(first[0]),
                       "bit_exact": first == second}}
    emit(phase="train", **out)
    mb = spec["microbatches"]
    want = {"moe_gate": 2 * cfg.n_layers * mb,
            "moe_gate_bwd": cfg.n_layers * mb,
            "flash_attention_bwd": cfg.n_layers * mb}
    if any(launches[k] != n * steps for k, n in want.items()):
        raise AssertionError(f"train moe: launched {launches}, want {want} "
                             f"a step")
    if not (_finite(per_step) and min(moved) > 0 and sums_ok and bias_ok
            and len(rec) == steps * mb and out["restart"]["bit_exact"]):
        raise AssertionError(f"train moe: a check failed: {out}")
    return launches


#: phase train's float32 step, card against CPU: each smoke config and
#: the backward kernel its step must launch on the card
TRAIN_CPU = {"tinyllama-1.1b": "flash_attention_bwd",
             "qwen3-moe-30b-a3b": "flash_attention_bwd",
             "rwkv6-1.6b": "wkv_intra_bwd",
             "zamba2-1.2b": "flash_attention_bwd",
             "seamless-m4t-medium": "flash_attention_bwd",
             "internvl2-2b": "flash_attention_bwd"}


def train_cpu_child(dev):
    """Body of phase train's float32 subprocess (REPRO_FORCE_F32=1): one
    train step of the dense, the MoE, the two recurrent, the
    encoder-decoder and the vision-token smoke configs on `dev` and on
    the CPU from the same weights and batch (the trainer's source's:
    frames or vision embeddings where the family takes them). Prints
    one JSON line."""
    from repro_torch import tree
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.steps import TrainCtx, build_train_step
    from repro_torch.launch.train import batch_source
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init
    out = {}
    for arch in TRAIN_CPU:
        cfg = get_smoke(arch)
        S, B = 64, 8
        fn = build_train_step(cfg, ShapeConfig("t", S, B, "train"),
                              TrainCtx(num_microbatches=2, loss_chunk=16))
        data_cfg = DataConfig(cfg.vocab_size, S, B, seed=1)
        batch = batch_source(cfg, data_cfg).batch_at(0)
        params = lm.init_params(torch.Generator().manual_seed(3), cfg)
        runs = {}
        kbuild.reset_launches()
        for d in ("cpu", dev):
            p = tree.tree_map(lambda t: t.to(d), params)
            runs[str(d)] = fn(p, adamw_init(p), lm.init_extras(cfg, d),
                              batch)
        torch.cuda.synchronize()
        c, g = runs["cpu"], runs[str(dev)]

        def rel_to(m, want):
            return abs(float(m) - float(want)) / max(abs(float(want)),
                                                     1e-30)
        rel = {k: rel_to(g[3][k], c[3][k])
               for k in ("loss", "grad_norm", "lr")}
        perr = max(float((a.cpu() - b).abs().max()) for a, b in
                   zip(tree.leaves(g[0]), tree.leaves(c[0])))
        # the step's move on the CPU, and the share of entries the card
        # put further than a tenth of it from the CPU's
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(tree.leaves(c[0]), tree.leaves(params)))
        far = sum(int(((a.cpu() - b).abs() > 0.1 * moved).sum()) for a, b
                  in zip(tree.leaves(g[0]), tree.leaves(c[0])))
        ulp_move = 0.0
        for k in ("frames", "vision_embeds"):
            if k in batch:  # the CPU's own step, that input one ULP up
                up = dict(batch, **{k: torch.nextafter(
                    batch[k], torch.tensor(math.inf))})
                m = fn(params, adamw_init(params),
                       lm.init_extras(cfg, "cpu"), up)[3]
                ulp_move = rel_to(m["grad_norm"], c[3]["grad_norm"])
        row = {"params_dtype": str(tree.leaves(params)[0].dtype),
               "metric_rel": rel, "param_err": perr, "moved": moved,
               "far_share": far / sum(t.numel() for t in
                                      tree.leaves(params)),
               "grad_tol": max(TRAIN_GRAD_TOL, TRAIN_ULP_FACTOR * ulp_move),
               "cpu_ulp_move": ulp_move,
               "launches": {k: n for k, n in kbuild.launches().items() if n},
               "backward_kernel": TRAIN_CPU[arch]}
        if cfg.moe is not None:
            row["router_bias_equal"] = torch.equal(
                g[2]["router_bias"].cpu(), c[2]["router_bias"])
        out[cfg.name] = row
    print(json.dumps(out), flush=True)


def train_cpu(smi: str):
    """Phase train's float32 step, card against CPU, in a
    REPRO_FORCE_F32=1 subprocess (the port reads it at import)."""
    env = dict(os.environ, REPRO_FORCE_F32="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--train-cpu-child"], capture_output=True,
                          text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"train cpu child failed:\n{proc.stderr}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    emit(phase="train", run="card vs cpu", card=smi, dtype="float32",
         tol=TRAIN_F32_TOL, grad_tol=TRAIN_GRAD_TOL,
         far_share_max=TRAIN_FAR_SHARE, **res)
    for name, r in res.items():
        rel = r["metric_rel"]
        bad = (r["params_dtype"] != "torch.float32"
               or max(rel["loss"], rel["lr"]) > TRAIN_F32_TOL
               or rel["grad_norm"] > r["grad_tol"]
               or r["param_err"] > TRAIN_F32_TOL
               or not (r["moved"] > 0 and r["far_share"] <= TRAIN_FAR_SHARE)
               or not r.get("router_bias_equal", True)
               or r["launches"].get(r["backward_kernel"], 0) < 1)
        if bad:
            raise AssertionError(f"train card vs cpu, {name}: {r}")


def train(steps: int, moe_steps: int, smi: str, dev):
    """Phase train: the kernels, then the runs. Returns (the kernel
    checks' shapes, the dense run's launches, the MoE run's)."""
    shapes = check_train_kernels(dev)
    emit(phase="train_kernels_checked", shapes=shapes)
    torch.cuda.empty_cache()
    dense = train_dense(steps, smi, dev)
    torch.cuda.empty_cache()
    moe = train_moe(moe_steps, smi, dev)
    torch.cuda.empty_cache()
    train_cpu(smi)
    return shapes, dense, moe


#: the dense serve: qwen2-7b at full width and depth
DENSE_SERVE = dict(arch="qwen2-7b", batch=4, prompt_len=512, seed=0)


def dense_serve_phase(gen: int, smi: str, dev):
    """qwen2-7b (28 layers, group of 7, D 128, QKV bias) serving 4
    prompts of 512 tokens and `gen` greedy steps through
    `launch/serve.py`, then every layer through the kernels against the
    plain versions (teacher-forced, as phase serve)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.serve import serve
    cfg = get_arch(DENSE_SERVE["arch"])
    B, P, seed = (DENSE_SERVE[k] for k in ("batch", "prompt_len", "seed"))
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    run = serve(cfg, None, B, P, gen, seed, dev, keep_logits=True)
    launches = kbuild.launches()
    peak = torch.cuda.max_memory_allocated()
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(seed + 1))
    vs_plain = layerwise_vs_plain(cfg, seed, prompts, run["tokens"], dev)
    want = {"flash_attention": cfg.n_layers,
            "flash_decode": cfg.n_layers * gen, "moe_gate": 0}
    res = {"card": smi, "arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.param_count(), "batch": B, "prompt_len": P,
           "gen": gen, "launches": {k: launches[k] for k in want},
           "max_memory_allocated": peak, "prefill_s": run["prefill_s"],
           "prefill_tokens_per_s": B * P / run["prefill_s"],
           "decode_ms_per_step": 1e3 * run["decode_s"] / gen,
           "decode_tokens_per_s": B * gen / run["decode_s"],
           "vs_plain_layerwise": vs_plain}
    emit(phase="dense_serve", **res)
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"dense serve launched {launches}, want {want}")
    return res



#: phase recurrent_serve: the recurrent families at full width and
#: depth, serve's traffic (16 x 512 prompts); the chunked prefill is held
#: against the recurrence by a prefill of SPLIT tokens and P - SPLIT
#: teacher-forced decode steps
RECURRENT_SERVE = dict(archs=("rwkv6-1.6b", "zamba2-1.2b"), batch=16,
                       prompt_len=512, split=384, seed=0)


def chunked_vs_recurrent(cfg, params, prompts, split: int, dev) -> dict:
    """The last logits of a prefill of all P prompt tokens against a
    prefill of `split` tokens followed by P - split exact decode steps
    fed the prompt's next tokens: the chunked scan against the
    recurrence at full width, end to end (`_logit_rows`)."""
    from repro_torch.models import lm
    prompts = prompts.to(dev)
    B, P = prompts.shape
    _, want = lm.prefill(params, {"tokens": prompts}, cfg, P)
    cache, _ = lm.prefill(params, {"tokens": prompts[:, :split]}, cfg, P)
    for pos in range(split, P):
        cache, got = lm.decode_step(params, cache, prompts[:, pos], pos, {},
                                    cfg)
    del cache
    return _logit_rows([got], [want[:, -1]])


def layerwise_chunked_vs_recurrent(cfg, params, prompts, split: int, dev):
    """The chunked form against the recurrence layer by layer, teacher-
    forced on the chunked path's hidden states: each layer (rwkv6's
    block; zamba2's shared block and each Mamba2 layer) over all P
    tokens at once, against the same layer over the first `split`
    tokens and then P - split exact decode steps from its carry (the
    shared block: from its K/V of the `split` tokens), on the same
    input. Rows P - split.. of each layer within LAYER_TOL."""
    from repro_torch.models import blocks, lm, mamba2, rwkv6
    from repro_torch.models.layers import embed_fwd
    prompts = prompts.to(dev)
    B, P = prompts.shape
    agree = {}

    def add(kind, got, want):
        agree.setdefault(kind, _Agreement()).add(got, want, None, None)

    x = emb0 = embed_fwd(params["embed"], prompts)
    for i in range(cfg.n_layers):
        p_l = lm.layer(params["layers"], i)
        if cfg.rwkv is not None:
            zero = lm.zero_rwkv_carry(cfg, B, dev)
            full, _ = rwkv6.rwkv_block_fwd(p_l, x, zero, cfg=cfg)
            _, carry = rwkv6.rwkv_block_fwd(p_l, x[:, :split], zero,
                                            cfg=cfg)
            steps = []
            for t in range(split, P):
                y, carry = rwkv6.rwkv_decode_step(p_l, x[:, t:t + 1], carry,
                                                  cfg=cfg)
                steps.append(y)
            add("rwkv6 block", torch.cat(steps, 1), full[:, split:])
            x = full
            continue
        if lm.shared_slot(cfg, i) is not None:
            sp = params["shared_block"]
            full, _ = blocks.shared_block_fwd(sp, x, emb0, cfg=cfg)
            _, (k, v) = blocks.shared_block_fwd(
                sp, x[:, :split], emb0[:, :split], cfg=cfg, return_kv=True)
            kv = {n: t.new_zeros((B, P, *t.shape[2:])) for n, t in
                  (("k", k), ("v", v))}
            kv["k"][:, :split], kv["v"][:, :split] = k, v
            steps = []
            for t in range(split, P):
                y, kv = blocks.shared_block_decode(
                    sp, x[:, t:t + 1], emb0[:, t:t + 1], kv, t, cfg=cfg)
                steps.append(y)
            add("shared block", torch.cat(steps, 1), full[:, split:])
            x = full
        zero = lm.zero_mamba_carry(cfg, B, dev)
        full, _ = mamba2.mamba2_fwd(p_l, x, zero, cfg=cfg)
        _, carry = mamba2.mamba2_fwd(p_l, x[:, :split], zero, cfg=cfg)
        steps = []
        for t in range(split, P):
            y, carry = mamba2.mamba2_fwd(p_l, x[:, t:t + 1], carry, cfg=cfg,
                                         decode=True)
            steps.append(y)
        add("mamba2", torch.cat(steps, 1), full[:, split:])
        x = full
    res = {k: a.summary() for k, a in agree.items()}
    bad = [k for k, r in res.items() if r["agreeing_row_err_max"] > LAYER_TOL]
    if bad:
        raise AssertionError(f"{cfg.name}: chunked against recurrent, layer "
                             f"by layer, beyond LAYER_TOL: {res}")
    return res


def _hold_split(arch: str, dtype: str, r: dict) -> dict:
    """Raise unless the chunked-against-recurrent rows of `arch` in
    `dtype` are within SPLIT_ROWS."""
    typ, most = SPLIT_ROWS[arch, dtype]
    if r["row_err_median"] > typ or r["row_err_max"] > most:
        raise AssertionError(f"{arch} in {dtype}: prefill "
                             f"{RECURRENT_SERVE['split']} + decode steps "
                             f"against one prefill beyond {(typ, most)}: "
                             f"{r}")
    return r


def recurrent_f32_child(dev):
    """Body of phase recurrent_serve's float32 subprocess
    (REPRO_FORCE_F32=1): `chunked_vs_recurrent` of both models at full
    width. Prints one JSON line."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    B, P, split, seed = (RECURRENT_SERVE[k] for k in (
        "batch", "prompt_len", "split", "seed"))
    out = {}
    for arch in RECURRENT_SERVE["archs"]:
        cfg = get_arch(arch)
        params = lm.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        prompts = torch.randint(
            0, cfg.vocab_size, (B, P),
            generator=torch.Generator().manual_seed(seed + 1))
        out[arch] = {"dtype": str(params["embed"]["embedding"].dtype),
                     **chunked_vs_recurrent(cfg, params, prompts, split,
                                            dev)}
        del params
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def recurrent_f32(smi: str) -> dict:
    """The end-to-end chunked-against-recurrent check of both models in
    float32, in a REPRO_FORCE_F32=1 subprocess, held within
    SPLIT_ROWS."""
    env = dict(os.environ, REPRO_FORCE_F32="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--recurrent-f32-child"], capture_output=True,
                          text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"recurrent f32 child failed:\n{proc.stderr}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    emit(phase="recurrent_serve", run="float32", card=smi, **res)
    for arch, r in res.items():
        if r["dtype"] != "torch.float32":
            raise AssertionError(f"recurrent f32 child ran {r['dtype']}")
        _hold_split(arch, "float32", r)
    return res


def hybrid_layerwise_vs_plain(cfg, params, prompts, tokens, dev):
    """zamba2's layers of the same prefill and decode, teacher-forced on
    the kernel run's tokens and hidden states: each shared-block
    invocation through the kernels and through their plain versions from
    the same input (rows within LAYER_TOL), the Mamba2 layers (no
    kernel) on the kernel path; from the last invocation on, both paths
    run to the logits (SERVE_TYP / SERVE_MAX)."""
    from repro_torch.models import blocks, lm, mamba2
    from repro_torch.models.layers import embed_fwd, lm_head_fwd, rmsnorm
    prompts, tokens = prompts.to(dev), tokens.to(dev)
    B, P = prompts.shape
    gen = tokens.shape[1] - 1
    sp = params["shared_block"]
    last = max(i for i in range(cfg.n_layers)
               if lm.shared_slot(cfg, i) is not None)
    agree = {"prefill": _Agreement(), "decode": _Agreement()}

    def both(kind, fn):
        """fn(plain) through the kernels and through the plain
        versions."""
        with _gates(False, []):
            out_k = fn(False)
        with _gates(True, []):
            out_p = fn(True)
        agree[kind].add(out_k[0], out_p[0], None, None)
        return out_k, out_p

    def logit_err(hk, hp):
        lk, lp = (lm_head_fwd(params["embed"], rmsnorm(
            params["final_norm"], h, cfg.norm_eps)) for h in (hk, hp))
        return (lk - lp).abs().amax(-1).float().flatten() / lk.abs().max()

    emb0 = x = embed_fwd(params["embed"], prompts)
    zero = lm.zero_mamba_carry(cfg, B, dev)
    ks, vs, mstates = [], [], []
    for i in range(cfg.n_layers):
        if lm.shared_slot(cfg, i) is not None:
            (x, kv), (xp, _) = both("prefill", lambda plain: (
                blocks.shared_block_fwd(sp, x, emb0, cfg=cfg,
                                        return_kv=True)))
            ks.append(kv[0])
            vs.append(kv[1])
        p_m = lm.layer(params["layers"], i)
        if i >= last:
            xp, _ = mamba2.mamba2_fwd(p_m, xp, zero, cfg=cfg)
        x, mc = mamba2.mamba2_fwd(p_m, x, zero, cfg=cfg)
        mstates.append(mc)
    logit_errs = [logit_err(x[:, -1:], xp[:, -1:])]
    cache = lm._pad_cache_to(
        {"mamba": lm._stacked(mstates),
         "attn_k": torch.stack(ks), "attn_v": torch.stack(vs)}, cfg,
        P + gen)
    del ks, vs, mstates
    for step in range(gen):
        emb0 = x = embed_fwd(params["embed"], tokens[:, step, None])
        for i in range(cfg.n_layers):
            j = lm.shared_slot(cfg, i)
            if j is not None:
                kv = {"k": cache["attn_k"][j], "v": cache["attn_v"][j]}
                twin = lm.tree_map(lambda t: t.clone(), kv)
                (x, _), (xp, _) = both(
                    "decode", lambda plain: blocks.shared_block_decode(
                        sp, x, emb0, twin if plain else kv, P + step,
                        cfg=cfg))
                del twin
            p_m = lm.layer(params["layers"], i)
            c = lm.layer(cache["mamba"], i)
            if i >= last:  # the plain path runs on from a copy
                xp, _ = mamba2.mamba2_fwd(
                    p_m, xp, lm.tree_map(lambda t: t.clone(), c), cfg=cfg,
                    decode=True)
            x, new = mamba2.mamba2_fwd(p_m, x, c, cfg=cfg, decode=True)
            lm.tree_map(lambda a, b: a.copy_(b), c, new)
        logit_errs.append(logit_err(x, xp))
    res = {k: a.summary() for k, a in agree.items()}
    le = torch.cat([e.flatten() for e in logit_errs]).cpu()
    res["logits_row_err_median"] = float(le.median())
    res["logits_row_err_max"] = float(le.max())
    bad = [k for k in agree if res[k]["agreeing_row_err_max"] > LAYER_TOL]
    if (res["logits_row_err_median"] > SERVE_TYP
            or res["logits_row_err_max"] > SERVE_MAX):
        bad.append("logits")
    if bad:
        raise AssertionError(f"{cfg.name}: kernels vs plain versions, layer "
                             f"by layer, beyond the bf16 tolerance: {res}")
    return res


def recurrent_serve_phase(gen: int, smi: str, dev):
    """rwkv6-1.6b and zamba2-1.2b at full width and depth (random weights
    drawn on the card) serving 16 prompts of 512 tokens and `gen` greedy
    steps through `launch/serve.py`: launches counted (zamba2: the
    attention kernel once an invocation of its shared block, 7 a
    prefill, and flash decode 7 a step; rwkv6: the WKV kernel once a
    layer, 24 a prefill, and none a decode step); the chunked
    prefill against the recurrence at full width (a prefill of `split`
    tokens and P - split decode steps against a prefill of P): layer by
    layer in bfloat16 (LAYER_TOL), end to end in bfloat16 and in
    float32 (a subprocess), each within SPLIT_ROWS; zamba2's shared
    block layer by layer against the plain versions."""
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    B, P, split, seed = (RECURRENT_SERVE[k] for k in (
        "batch", "prompt_len", "split", "seed"))
    out = {}
    for arch in RECURRENT_SERVE["archs"]:
        torch.cuda.empty_cache()
        cfg = get_arch(arch)
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        allocated = sum(t.numel() for t in tree.leaves(params))
        kbuild.reset_launches()
        run = serve(cfg, None, B, P, gen, seed, dev, params=params,
                    keep_logits=True)
        launches = kbuild.launches()
        peak = torch.cuda.max_memory_allocated()
        finite = all(bool(torch.isfinite(lg).all()) for lg in run["logits"])
        del run["logits"]
        n_inv = lm.n_shared(cfg)
        want = {"flash_attention": n_inv, "flash_decode": n_inv * gen,
                "moe_gate": 0,
                "wkv_intra": cfg.n_layers if cfg.rwkv is not None else 0,
                "wkv_intra_bwd": 0}
        prompts = torch.randint(
            0, cfg.vocab_size, (B, P),
            generator=torch.Generator().manual_seed(seed + 1))
        t0 = time.perf_counter()
        split_bf16 = chunked_vs_recurrent(cfg, params, prompts, split, dev)
        split_layers = layerwise_chunked_vs_recurrent(cfg, params, prompts,
                                                      split, dev)
        split_s = time.perf_counter() - t0
        res = {"card": smi, "arch": cfg.name, "layers": cfg.n_layers,
               "shared_invocations": n_inv,
               "params_allocated": allocated,
               "param_count": cfg.param_count(), "batch": B,
               "prompt_len": P, "gen": gen, "cache_len": P + gen,
               "launches": {k: launches[k] for k in want},
               "max_memory_allocated": peak,
               "prefill_s": run["prefill_s"],
               "prefill_tokens_per_s": B * P / run["prefill_s"],
               "decode_ms_per_step": 1e3 * run["decode_s"] / gen,
               "decode_tokens_per_s": B * gen / run["decode_s"],
               "logits_finite": finite,
               "chunked_vs_recurrent": {
                   "split": split, "s": split_s,
                   "bf16_end_to_end": split_bf16,
                   "bf16_layerwise": split_layers}}
        if cfg.ssm is not None:
            res["vs_plain_layerwise"] = hybrid_layerwise_vs_plain(
                cfg, params, prompts, run["tokens"], dev)
        emit(phase="recurrent_serve", **res)
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"recurrent_serve {arch} launched "
                                 f"{launches}, want {want}")
        _hold_split(arch, "bfloat16", split_bf16)
        if not finite or tuple(run["tokens"].shape) != (B, gen + 1):
            raise AssertionError(f"recurrent_serve {arch}: non-finite "
                                 f"logits or tokens of shape "
                                 f"{tuple(run['tokens'].shape)}")
        out[arch] = res
        del params, run
    torch.cuda.empty_cache()
    out["float32"] = recurrent_f32(smi)
    return out

#: phase recurrent_train: both recurrent families at full width and
#: depth with phase train's recipe (train_4k's 4,096 tokens, 8 rows in 4
#: microbatches, AdamW, remat, loss chunk 1,024); no checkpoint is
#: written (the call's disk), rwkv6 restarts from a host copy of its
#: state after step `snapshot_at` and runs to step `steps` again (the
#: median of the last 4 steps needs 4 after the snapshot's step)
#: phase recurrent_train: both at full width, cut to half their depth
#: since PR 31 (rwkv6 12 of 24 layers; zamba2 18 of 38, 3 shared-block
#: passes of 7) to keep the script inside its time limit
TRAIN_RECURRENT = dict(archs=("rwkv6-1.6b", "zamba2-1.2b"), seq=4096,
                       batch=8, microbatches=4, loss_chunk=1024,
                       checkpoint_every=1000, snapshot_at=3, steps=6,
                       layers={"rwkv6-1.6b": 12, "zamba2-1.2b": 18})


def _recurrent_flops_per_token(cfg, params, seq: int) -> int:
    """Model FLOPs a token of a train step: 6 x the matmul parameters as
    a pass uses them (the input embedding is a lookup unless it is also
    the head; zamba2's shared block counts once a pass through it) plus
    6 S d_attn a shared-block pass for its causal attention. rwkv6's
    intra-chunk term (~0.4% more) is not counted."""
    from repro_torch import tree
    from repro_torch.models import lm
    n = sum(t.numel() for t in tree.leaves(params))
    if "lm_head" in params["embed"]:
        n -= params["embed"]["embedding"].numel()
    n_inv = lm.n_shared(cfg)
    if n_inv:
        n += (n_inv - 1) * sum(t.numel() for t in
                               tree.leaves(params["shared_block"]))
        return 6 * n + 6 * n_inv * seq * 2 * cfg.d_model  # heads at 2 d
    return 6 * n


def recurrent_train_phase(smi: str, dev):
    """rwkv6-1.6b and zamba2-1.2b at full width, cut to
    `TRAIN_RECURRENT["layers"]`, through the Trainer, `steps` steps each:
    s/step (median of the last 4), tokens/s, the model-FLOPs share of
    989 TFLOP/s, peak memory and launches a step, which must be exactly
    rwkv6's WKV forward 2 x L x 4 (the forward and remat's recompute)
    and backward L x 4, and zamba2's attention forward 2 x n x 4 and
    backward n x 4 (n shared-block passes); losses and grad
    norms finite, every master weight moved; rwkv6 restarted from a host
    copy of its state after step `snapshot_at` ends bit for bit where
    the run ended (every leaf's sha256). Returns {arch: its row}."""
    import shutil

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import lm
    spec = TRAIN_RECURRENT
    mb, at, steps = (spec[k] for k in ("microbatches", "snapshot_at",
                                       "steps"))
    if not 0 < at < steps:
        raise ValueError(f"recurrent_train: a snapshot after step {at} of "
                         f"{steps} leaves no step to replay")
    root = os.path.join(HERE, "results", "train_recurrent_ckpt")
    out = {}
    for arch in spec["archs"]:
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_arch(arch),
                                  n_layers=spec["layers"][arch])
        rwkv = cfg.rwkv is not None
        torch.cuda.reset_peak_memory_stats()
        kbuild.reset_launches()
        t0 = time.perf_counter()
        res, per_step, secs, tr, snap = _train_run(
            cfg, spec, steps, root, dev, snapshot_at=at if rwkv else 0)
        wall = time.perf_counter() - t0
        launches = kbuild.launches()
        peak = torch.cuda.max_memory_allocated()
        moved = _moved(cfg, res["opt_state"]["master"], dev)
        flops_tok = _recurrent_flops_per_token(cfg, res["params"],
                                               spec["seq"])
        n_inv = lm.n_shared(cfg)
        want = ({"wkv_intra": 2 * cfg.n_layers * mb,
                 "wkv_intra_bwd": cfg.n_layers * mb,
                 "flash_attention": 0, "flash_attention_bwd": 0} if rwkv
                else {"flash_attention": 2 * n_inv * mb,
                      "flash_attention_bwd": n_inv * mb,
                      "wkv_intra": 0, "wkv_intra_bwd": 0})
        restart = None
        if rwkv:
            first = (_digests(_state(res)), res["data_step"],
                     per_step[-1]["loss"])
            del res
            t1 = time.perf_counter()
            state = tree.tree_map(lambda t: t.to(dev), snap)
            del snap
            data = SyntheticLM(tr.data_cfg)
            for i in range(at, steps):
                *state, m = tr.step_fn(*state, data.batch_at(i))
            second = (_digests(tuple(state)), steps, float(m["loss"]))
            del state
            restart = {"from_step": at, "steps": steps - at,
                       "seconds": time.perf_counter() - t1,
                       "leaves": len(first[0]),
                       "bit_exact": first == second}
        else:
            del res
        shutil.rmtree(root, ignore_errors=True)
        s_step = statistics.median(secs[-4:])
        tokens = spec["batch"] * spec["seq"]
        row = {"card": smi, "arch": cfg.name, "layers": cfg.n_layers,
               "shared_invocations": n_inv,
               **{k: spec[k] for k in ("seq", "batch", "microbatches",
                                       "loss_chunk")},
               "steps": steps, "remat": "full", "optimizer": "adamw",
               "s_per_step": s_step, "step_seconds": secs,
               "tokens_per_s": tokens / s_step,
               "model_flops_per_step": flops_tok * tokens,
               "mfu_vs_989_tflops": flops_tok * tokens / s_step
               / PEAK_BF16_S,
               "max_memory_allocated": peak, "wall_s": wall,
               "launches": {k: launches[k] for k in want},
               "launches_per_step": {k: n / steps for k, n in
                                     launches.items() if n},
               "per_step": per_step, "params_moved_min": min(moved),
               "restart": restart}
        emit(phase="recurrent_train", **row)
        if any(launches[k] != n * steps for k, n in want.items()):
            raise AssertionError(f"recurrent_train {arch}: launched "
                                 f"{launches}, want {want} a step")
        if not _finite(per_step) or min(moved) <= 0:
            raise AssertionError(f"recurrent_train {arch}: a non-finite "
                                 f"loss or grad norm, or a weight that "
                                 f"did not move")
        if rwkv and not restart["bit_exact"]:
            raise AssertionError(f"recurrent_train {arch}: the restart "
                                 f"from step {at} differs")
        out[arch] = row
        del tr
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase encdec_vision_serve: the encoder-decoder and vision families at
# full width and depth
# ---------------------------------------------------------------------------

#: phase encdec_vision_serve: serve's traffic (16 x 512: seamless's
#: source frames, internvl2's prompt tokens, its first 256 vision tokens)
ENCDEC_VISION_SERVE = dict(archs=("seamless-m4t-medium", "internvl2-2b"),
                           batch=16, prompt_len=512, seed=0)


#: phase encdec_vision_serve, layer by layer. The full-width models'
#: attention is peaky (scores to ~350 in seamless, ~985 in internvl2:
#: the init scales a (d, H, Dh) projection by H^-1/2), so a row whose
#: top keys nearly tie moves when two bf16 paths round differently (one
#: bf16 layer is up to ~22% of the layer's scale from the same layer in
#: float32 on a few rows, median below 1%: this phase's `vs_f32`
#: readings, PERF.md §6). Such a row is held
#: as phase serve holds a row that routes differently: at most FLIP_MAX
#: of the rows beyond LAYER_TOL, the median row within SERVE_TYP and
#: every row within SERVE_MAX; and on the prefill and the first
#: TRUTH_STEPS decode steps the kernels' rows are no further from the
#: same layer in float32 (the plain versions, float32 compute) than
#: TRUTH_SLACK times the plain versions' rows, median and largest
TRUTH_STEPS = 8
TRUTH_SLACK = 1.25


@contextmanager
def _f32_compute():
    """The models compute in float32 (bf16 weights cast as they are
    read) through the attention kernels' plain versions."""
    from repro_torch.models import attention, blocks, encdec, layers, lm
    with ExitStack() as stack:
        for m in (layers, attention, blocks, encdec, lm):
            if hasattr(m, "COMPUTE_DT"):
                stack.enter_context(mock.patch.object(m, "COMPUTE_DT",
                                                      torch.float32))
        stack.enter_context(_gates(True, []))
        yield


class _ThreeWay:
    """Rows of one layer's output through the kernels against the same
    layer through the plain versions and, where computed, in float32,
    from the same input."""

    def __init__(self):
        self.kp, self.kt, self.pt = [], [], []

    @staticmethod
    def _rows(a, b, ref):
        a = a.reshape(-1, a.shape[-1]).float()
        b = b.reshape(-1, b.shape[-1]).float()
        return ((a - b).abs().amax(-1) / ref.float().abs().max()).cpu()

    def add(self, k, p, t=None):
        self.kp.append(self._rows(k, p, k))
        if t is not None:
            self.kt.append(self._rows(k, t, t))
            self.pt.append(self._rows(p, t, t))

    def summary(self):
        kp = torch.cat(self.kp)
        out = {"rows": kp.numel(), "row_err_median": float(kp.median()),
               "row_err_max": float(kp.max()),
               "beyond_layer_tol_share": float((kp > LAYER_TOL).float()
                                               .mean())}
        if self.kt:
            kt, pt = torch.cat(self.kt), torch.cat(self.pt)
            out["vs_f32"] = {"rows": kt.numel(),
                             "kernels_median": float(kt.median()),
                             "kernels_max": float(kt.max()),
                             "plain_median": float(pt.median()),
                             "plain_max": float(pt.max())}
        return out

    @staticmethod
    def bad(r) -> bool:
        t = r.get("vs_f32")
        return (r["beyond_layer_tol_share"] > FLIP_MAX
                or r["row_err_median"] > SERVE_TYP
                or r["row_err_max"] > SERVE_MAX
                or (t is not None and (
                    t["kernels_median"] > TRUTH_SLACK * t["plain_median"]
                    or t["kernels_max"] > TRUTH_SLACK * t["plain_max"])))


def encdec_vision_layerwise(cfg, params, inputs, tokens, dev):
    """seamless-m4t-medium's or internvl2-2b's layers of the same
    prefill and decode, teacher-forced on the kernel run's tokens and
    hidden states: every prefill layer (seamless: the encoder's,
    non-causal; internvl2: over the vision and text positions) and every
    layer of every decode step (seamless: self-attention decode over the
    target cache and cross decode over the read-only encoder cache)
    through the kernels, through their plain versions and, on the
    prefill and the first TRUTH_STEPS steps, in float32, from the same
    input (`_ThreeWay`), and the logits after each (SERVE_TYP /
    SERVE_MAX; greedy picks equal where the margin is clear)."""
    from repro_torch.launch.steps import argmax_first
    from repro_torch.models import blocks, encdec, lm
    from repro_torch.models.layers import (COMPUTE_DT, embed_fwd,
                                           lm_head_fwd, rmsnorm)
    tokens = tokens.to(dev)
    inputs = {k: v.to(dev) for k, v in inputs.items()}
    B, gen = tokens.shape[0], tokens.shape[1] - 1
    agree = {"prefill": _ThreeWay(), "decode": _ThreeWay()}

    def three(kind, fn, x, cache=None, truth=True, pick=lambda o: o):
        """fn(x, cache) through the kernels (on `cache`), the plain
        versions (on a copy) and, with `truth`, in float32; returns the
        kernels' and the plain versions' outputs."""
        twin = lm.tree_map(lambda t: t.clone(), cache)
        with _gates(False, []):
            out_k = fn(x, cache)
        with _gates(True, []):
            out_p = fn(x, twin)
        out_t = None
        if truth:
            with _f32_compute():
                out_t = pick(fn(x.float(), lm.tree_map(
                    lambda t: t.float(), cache)))
        agree[kind].add(pick(out_k), pick(out_p), out_t)
        return out_k, out_p

    picks = {"sure_rows": 0, "sure_rows_agreeing": 0, "rows": 0}

    def logit_err(hk, hp, norm):
        """Per row, the logits after the last layer through the kernels
        against the plain versions; their greedy picks must agree where
        the plain logits' top-2 margin exceeds twice the row's gap."""
        lk, lp = (lm_head_fwd(params["embed"], rmsnorm(
            norm, h, cfg.norm_eps))[:, -1].float() for h in (hk, hp))
        gap = (lk - lp).abs().amax(-1)
        top2 = lp.topk(2, -1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * gap
        same = argmax_first(lk) == argmax_first(lp)
        picks["rows"] += lk.shape[0]
        picks["sure_rows"] += int(sure.sum())
        picks["sure_rows_agreeing"] += int((sure & same).sum())
        return gap / lk.abs().max()

    if cfg.encoder_decoder:
        x = torch.matmul(inputs["frames"].to(COMPUTE_DT),
                         params["src_proj"].to(COMPUTE_DT))
        for i in range(cfg.n_layers):
            p = lm.layer(params["enc_layers"], i)
            x, xp = three("prefill", lambda xx, c: encdec.enc_block(
                p, xx, cfg), x)
        enc_out, enc_plain = (rmsnorm(params["enc_norm"], h, cfg.norm_eps)
                              for h in (x, xp))
        logit_errs = [logit_err(enc_out[:, -1:], enc_plain[:, -1:],
                                params["final_norm"])]  # BOS
        Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        cache = {"self": {k: torch.zeros(
                    (cfg.n_layers, B, gen, Hkv, Dh), dtype=COMPUTE_DT,
                    device=dev) for k in "kv"},
                 "cross": encdec.cross_cache(params, enc_out, cfg)}
        stack, start = params["dec_layers"], 0
    else:
        x = lm._embed_inputs(params, inputs, cfg)
        P, kvs = x.shape[1], []
        for i in range(cfg.n_layers):
            p = lm.layer(params["layers"], i)
            (x, kv, _), (xp, _, _) = three(
                "prefill", lambda xx, c: blocks.tf_block_fwd(
                    p, xx, cfg=cfg, return_kv=True), x,
                pick=lambda o: o[0])
            kvs.append(kv)
        logit_errs = [logit_err(x[:, -1:], xp[:, -1:], params["final_norm"])]
        cache = lm._pad_cache_to({"main": lm._stacked(kvs)}, cfg, P + gen)
        del kvs
        stack, start = params["layers"], P
    for step in range(gen):
        x = embed_fwd(params["embed"], tokens[:, step, None])
        for i in range(cfg.n_layers):
            p = lm.layer(stack, i)
            if cfg.encoder_decoder:
                c = {k: lm.layer(cache[k], i) for k in ("self", "cross")}
                fn = lambda xx, cc: encdec.dec_block_decode(  # noqa: E731
                    p, xx, cc["self"], cc["cross"], step, cfg)
            else:
                c = lm.layer(cache["main"], i)
                fn = lambda xx, cc: blocks.tf_block_decode(  # noqa: E731
                    p, xx, cc, start + step, cfg=cfg)[0]
            x, xp = three("decode", fn, x, c, truth=step < TRUTH_STEPS)
        logit_errs.append(logit_err(x, xp, params["final_norm"]))
    res = {k: a.summary() for k, a in agree.items()}
    le = torch.cat([e.flatten() for e in logit_errs]).cpu()
    res["logits_row_err_median"] = float(le.median())
    res["logits_row_err_max"] = float(le.max())
    res["sure_picks"] = picks
    bad = [k for k in agree if _ThreeWay.bad(res[k])]
    if (res["logits_row_err_median"] > SERVE_TYP
            or res["logits_row_err_max"] > SERVE_MAX):
        bad.append("logits")
    if picks["sure_rows_agreeing"] != picks["sure_rows"]:
        bad.append("picks")
    if bad:
        raise AssertionError(f"{cfg.name}: kernels vs plain versions, layer "
                             f"by layer, beyond the bf16 rule: {bad}: {res}")
    return res


def prefill_spread(cfg, params, inputs, dev) -> dict:
    """How far apart whole bf16 prefills land at full width: the last
    logits (B, V) of the prefill through the kernels, through the plain
    versions and in float32 (plain versions), each pair's largest |gap|
    over the float32 logits' scale. A random-weight model at full width
    attends almost by argmax (scores in the hundreds), so differences of
    rounding that every layer holds within the bf16 rule grow over the
    layers; this is measured, not held."""
    from repro_torch.launch.steps import model_fns
    prefill = model_fns(cfg)[1]
    inputs = {k: v.to(dev) for k, v in inputs.items()}
    out = {}
    for name, ctx in (("kernels", _gates(False, [])),
                      ("plain", _gates(True, [])), ("f32", _f32_compute())):
        with ctx:
            out[name] = prefill(params, inputs, cfg, 1)[1][:, -1].float()
    scale = float(out["f32"].abs().max())
    return {f"{a}_vs_{b}": float((out[a] - out[b]).abs().max()) / scale
            for a, b in (("kernels", "plain"), ("kernels", "f32"),
                         ("plain", "f32"))}


def encdec_vision_serve_phase(gen: int, smi: str, dev):
    """seamless-m4t-medium (12 encoder + 12 decoder layers, d 1,024, 16
    heads of 64, vocab 256,256) and internvl2-2b (24 layers, d 2,048,
    16/8 heads of 128, 256 vision tokens) at full width and depth,
    random weights drawn on the card, serving 16 x 512 (frames, or
    prompt tokens with the vision embeddings in front) and `gen` greedy
    steps through `launch/serve.py`: launches set to 0 just before and
    read just after (seamless: 12 non-causal attention a prefill, 24
    flash decode a step, 12 self and 12 cross; internvl2: 24 and 24),
    prefill s, decode ms a step, peak memory, finite logits; how far
    whole prefills through the kernels, the plain versions and float32
    land apart (`prefill_spread`, printed); every layer against the
    plain versions and float32, teacher-forced on the kernel run
    (`encdec_vision_layerwise`)."""
    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.models import lm
    B, P, seed = (ENCDEC_VISION_SERVE[k] for k in ("batch", "prompt_len",
                                                   "seed"))
    out = {}
    for arch in ENCDEC_VISION_SERVE["archs"]:
        torch.cuda.empty_cache()
        cfg = get_arch(arch)
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        allocated = sum(t.numel() for t in tree.leaves(params))
        kbuild.reset_launches()
        run = serve(cfg, None, B, P, gen, seed, dev, params=params,
                    keep_logits=True)
        launches = kbuild.launches()
        peak = torch.cuda.max_memory_allocated()
        finite = all(bool(torch.isfinite(lg).all()) for lg in run["logits"])
        L = cfg.n_layers
        if cfg.encoder_decoder:
            want = {"flash_attention": L, "flash_decode": 2 * L * gen}
        else:
            want = {"flash_attention": L, "flash_decode": L * gen}
        want.update(moe_gate=0, wkv_intra=0, wkv_intra_bwd=0)
        del run["logits"]
        # the inputs serve drew from the seed
        inputs = serve_inputs(cfg, B, P, seed, None, None, None, "cpu")
        spread = prefill_spread(cfg, params, inputs, dev)
        torch.cuda.empty_cache()
        layers = encdec_vision_layerwise(cfg, params, inputs, run["tokens"],
                                         dev)
        res = {"card": smi, "arch": cfg.name, "layers": L,
               "encoder_decoder": cfg.encoder_decoder,
               "vision_tokens": cfg.n_vision_tokens,
               "params_allocated": allocated,
               "param_count": cfg.param_count(), "batch": B,
               "prompt_len": P, "gen": gen,
               "cache_len": gen if cfg.encoder_decoder else P + gen,
               "launches": {k: launches[k] for k in want},
               "max_memory_allocated": peak,
               "prefill_s": run["prefill_s"],
               "prefill_tokens_per_s": B * P / run["prefill_s"],
               "decode_ms_per_step": 1e3 * run["decode_s"] / gen,
               "decode_tokens_per_s": B * gen / run["decode_s"],
               "logits_finite": finite, "prefill_spread": spread,
               "vs_plain_layerwise": layers}
        emit(phase="encdec_vision_serve", **res)
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"encdec_vision_serve {arch} launched "
                                 f"{launches}, want {want}")
        if not finite or tuple(run["tokens"].shape) != (B, gen + 1):
            raise AssertionError(f"encdec_vision_serve {arch}: non-finite "
                                 f"logits or tokens of shape "
                                 f"{tuple(run['tokens'].shape)}")
        out[arch] = res
        del params, run
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase encdec_vision_train: the encoder-decoder and vision families
# trained at full width and depth
# ---------------------------------------------------------------------------

#: phase encdec_vision_train: phase recurrent_train's recipe (8 x 4,096
#: tokens in 4 microbatches, AdamW, remat full, loss chunk 1,024, which
#: internvl2 takes and seamless's full-vocabulary loss ignores, as the
#: reference's does), each run restarted from a host copy of its state
#: after step `snapshot_at`
TRAIN_ENCDEC_VISION = dict(archs=("seamless-m4t-medium", "internvl2-2b"),
                           seq=4096, batch=8, microbatches=4,
                           loss_chunk=1024, checkpoint_every=1000,
                           snapshot_at=3, steps=6)


def _encdec_vision_flops_per_token(cfg, params, seq: int) -> float:
    """Model FLOPs a token of a train step of an encoder-decoder or a
    vision-token config: 6 x the matmul parameters (the input embedding
    is a lookup; `vision_proj` runs on n_vision_tokens of the `seq`
    positions) plus 12 S d_attn a non-causal layer (the encoder's and
    the cross attention, S_src = S) and 6 S d_attn a causal one."""
    from repro_torch import tree
    n = (sum(t.numel() for t in tree.leaves(params))
         - params["embed"]["embedding"].numel())
    d_attn = cfg.n_heads * cfg.resolved_head_dim
    if cfg.encoder_decoder:
        return 6 * n + (12 + 12 + 6) * cfg.n_layers * seq * d_attn
    vp = params["vision_proj"].numel()
    return (6 * (n - vp) + 6 * vp * cfg.n_vision_tokens / seq
            + 6 * cfg.n_layers * seq * d_attn)


def encdec_vision_train_phase(smi: str, dev):
    """seamless-m4t-medium and internvl2-2b at full width and depth
    through the Trainer (`launch.train.make_trainer`, whose source adds
    the source frames or the vision embeddings), `steps` steps each:
    s/step (median of the last 4), tokens/s, the model-FLOPs share of 989
    TFLOP/s, peak memory and launches a step, which must be exactly
    seamless's attention forward 2 x 36 x 4 (12 encoder, 12 decoder
    self and 12 cross attention layers a microbatch; the forward and
    remat's recompute) and backward 36 x 4, internvl2's 2 x 24 x 4 and
    24 x 4, no flash decode, gate or WKV launch; losses and grad norms
    finite, every master weight moved; a restart from a host copy of the
    state after step `snapshot_at` ends bit for bit where the run ended
    (every leaf's sha256). Returns {arch: its row}."""
    import shutil

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    spec = TRAIN_ENCDEC_VISION
    mb, at, steps = (spec[k] for k in ("microbatches", "snapshot_at",
                                       "steps"))
    if not 0 < at < steps:
        raise ValueError(f"encdec_vision_train: a snapshot after step {at} "
                         f"of {steps} leaves no step to replay")
    root = os.path.join(HERE, "results", "train_encdec_vision_ckpt")
    out = {}
    for arch in spec["archs"]:
        torch.cuda.empty_cache()
        cfg = get_arch(arch)
        torch.cuda.reset_peak_memory_stats()
        kbuild.reset_launches()
        t0 = time.perf_counter()
        res, per_step, secs, tr, snap = _train_run(
            cfg, spec, steps, root, dev, snapshot_at=at)
        wall = time.perf_counter() - t0
        launches = kbuild.launches()
        peak = torch.cuda.max_memory_allocated()
        moved = _moved(cfg, res["opt_state"]["master"], dev)
        flops_tok = _encdec_vision_flops_per_token(cfg, res["params"],
                                                   spec["seq"])
        n_attn = (3 if cfg.encoder_decoder else 1) * cfg.n_layers
        want = {"flash_attention": 2 * n_attn * mb,
                "flash_attention_bwd": n_attn * mb, "flash_decode": 0,
                "moe_gate": 0, "wkv_intra": 0, "wkv_intra_bwd": 0}
        first = (_digests(_state(res)), res["data_step"],
                 per_step[-1]["loss"])
        del res
        t1 = time.perf_counter()
        state = tree.tree_map(lambda t: t.to(dev), snap)
        del snap
        for i in range(at, steps):
            *state, m = tr.step_fn(*state, tr.source.batch_at(i))
        second = (_digests(tuple(state)), steps, float(m["loss"]))
        del state, m
        restart = {"from_step": at, "steps": steps - at,
                   "seconds": time.perf_counter() - t1,
                   "leaves": len(first[0]), "bit_exact": first == second}
        shutil.rmtree(root, ignore_errors=True)
        s_step = statistics.median(secs[-4:])
        tokens = spec["batch"] * spec["seq"]
        row = {"card": smi, "arch": cfg.name, "layers": cfg.n_layers,
               "encoder_decoder": cfg.encoder_decoder,
               "vision_tokens": cfg.n_vision_tokens,
               "params": cfg.param_count(),
               **{k: spec[k] for k in ("seq", "batch", "microbatches",
                                       "loss_chunk")},
               "steps": steps, "remat": "full", "optimizer": "adamw",
               "s_per_step": s_step, "step_seconds": secs,
               "tokens_per_s": tokens / s_step,
               "model_flops_per_step": flops_tok * tokens,
               "mfu_vs_989_tflops": flops_tok * tokens / s_step
               / PEAK_BF16_S,
               "max_memory_allocated": peak, "wall_s": wall,
               "launches": {k: launches[k] for k in want},
               "launches_per_step": {k: n / steps for k, n in
                                     launches.items() if n},
               "per_step": per_step, "params_moved_min": min(moved),
               "restart": restart}
        emit(phase="encdec_vision_train", **row)
        if any(launches[k] != n * steps for k, n in want.items()):
            raise AssertionError(f"encdec_vision_train {arch}: launched "
                                 f"{launches}, want {want} a step")
        if not _finite(per_step) or min(moved) <= 0:
            raise AssertionError(f"encdec_vision_train {arch}: a non-finite "
                                 f"loss or grad norm, or a weight that did "
                                 f"not move")
        if not restart["bit_exact"]:
            raise AssertionError(f"encdec_vision_train {arch}: the restart "
                                 f"from step {at} differs")
        out[arch] = row
        del tr
    torch.cuda.empty_cache()
    return out


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
    out, solo = {}, None
    ops.reset_launches()
    for gaia in (False, True):
        cfg = EngineConfig(gaia_on=gaia, timesteps=steps)
        st, series, c, sec = run_engine(cfg, dev)
        if gaia:  # the replicas phase holds its replica 0 to this run
            solo = (st, series, sec)
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
    return launches, solo


def _held_equal(what, batch_state, batch_series, r, state, series,
                final=True):
    """Replica r of a batched run against a solo run, bit for bit: every
    series over the solo run's steps, and (`final`: the runs are as long)
    the final state and key."""
    t = next(iter(series.values())).shape[0]
    bad = [k for k in series
           if not torch.equal(batch_series[k][:t, r], series[k])]
    if final:
        bad += [k for k in state if k != "t" and
                not torch.equal(batch_state[k][r], state[k])]
    if bad:
        raise AssertionError(f"{what}: replica {r} differs from its solo "
                             f"run in {bad}")


def replicas(steps: int, scen_steps: int, tune_steps: int, solo, dev):
    """The batched engine (`Engine.run(seeds=...)`) on the card:

    - the default EngineConfig() (10k SEs), GAIA on, R = 10 seeds 0-9,
      `steps` steps in one pass: replica 0 bit-equal to the main phase's
      solo run of seed 0 (`solo`), replica 3 to a solo run of seed 3
      over 300 steps; `steps` cell-list launches for all ten; s/step,
      s/step a replica, t_batch / t_single (exp8's batch_overhead,
      printed, not gated) and peak memory;
    - exp6's epidemic and flock and phase main's dense world (area /
      range < 3), R = 4, `scen_steps` steps: replica 1 bit-equal to its
      solo run; the epidemic two cell-list launches a step, the flock
      one cell-sum launch a step, the dense world one dense launch a
      step, whatever R;
    - `intra_run_tune_batch` on the default config, R = 4, window 100,
      `tune_steps` steps: each history the solo tuner's.

    Launch counts are set to 0 just before each batched run and read
    just after; their sum is returned."""
    from repro_torch.core import (ABMConfig, Engine, EngineConfig,
                                  SelfTuneConfig, intra_run_tune,
                                  intra_run_tune_batch)
    from repro_torch import random as trandom
    from repro_torch.kernels import build as kbuild
    total = {}

    def count(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    cfg = EngineConfig(timesteps=steps)
    seeds = list(range(10))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    bst, bser, reps = Engine(cfg, device=dev).run(seeds=seeds)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    got = kbuild.launches()
    count(got)
    peak = torch.cuda.max_memory_allocated()
    st0, ser0, t_single = solo
    _held_equal("replicas default", bst, bser, 0, st0, ser0)
    short = dataclasses.replace(cfg, timesteps=min(300, steps))
    st3, ser3, _ = Engine(short, device=dev).run(seed=3)
    _held_equal("replicas default", bst, bser, 3, st3, ser3,
                final=short.timesteps == steps)
    ovf = [c["grid_overflow"] for c in reps]
    emit(phase="replicas", run="default", replicas=len(seeds), steps=steps,
         s_per_step=t_batch / steps,
         s_per_step_per_replica=t_batch / steps / len(seeds),
         single_s_per_step=t_single / steps,
         batch_overhead=t_batch / t_single, peak_memory_bytes=peak,
         launches=got, mean_lcr=[c["mean_lcr"] for c in reps],
         migrations=[c["migrations"] for c in reps], grid_overflow=ovf,
         replica0_equals_main_solo=True, replica3_equals_solo=True,
         replica3_steps=short.timesteps)
    if got["proximity_grid"] != steps or any(ovf):
        raise AssertionError(f"replicas default: {got['proximity_grid']} "
                             f"cell-list launches (want {steps}), "
                             f"grid_overflow {ovf}")
    dense = EngineConfig(abm=ABMConfig(n_se=2000, area=600.0,
                                       interaction_range=250.0),
                         timesteps=scen_steps)
    for scenario in ("epidemic", "flock", "dense_world"):
        cfg = dense if scenario == "dense_world" else \
            exp6_cfg(scenario, scen_steps)
        seeds = [0, 1, 2, 3]
        kbuild.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst, bser, reps = Engine(cfg, device=dev).run(seeds=seeds)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = kbuild.launches()
        count(got)
        st1, ser1, _ = Engine(cfg, device=dev).run(seed=1)
        _held_equal(f"replicas {scenario}", bst, bser, 1, st1, ser1)
        want = {"proximity_grid": {"epidemic": 2, "flock": 1}.get(
                    scenario, 0) * scen_steps,
                "proximity_dense": scen_steps if scenario == "dense_world"
                else 0,
                "cell_sums": scen_steps if scenario == "flock" else 0}
        emit(phase="replicas", run=scenario, replicas=len(seeds),
             steps=scen_steps, s_per_step=sec / scen_steps,
             s_per_step_per_replica=sec / scen_steps / len(seeds),
             launches=got, mean_lcr=[c["mean_lcr"] for c in reps],
             grid_overflow=[c["grid_overflow"] for c in reps],
             replica1_equals_solo=True)
        if any(got[k] != v for k, v in want.items()) or \
                any(c["grid_overflow"] for c in reps):
            raise AssertionError(f"replicas {scenario}: launches {got}, "
                                 f"want {want}")
    cfg = EngineConfig(timesteps=tune_steps)
    tc = SelfTuneConfig(window=100)
    seeds = [0, 1, 2, 3]
    kbuild.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hists = intra_run_tune_batch(cfg, tc, seeds, device=dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    count(kbuild.launches())
    for seed, hist in zip(seeds, hists):
        _, solo_hist = intra_run_tune(trandom.key(seed), cfg, tc, device=dev)
        if hist != solo_hist:
            raise AssertionError(f"batched tuner, seed {seed}: {hist} != "
                                 f"{solo_hist}")
    emit(phase="replicas", run="intra_run_tune_batch", replicas=len(seeds),
         steps=tune_steps, window=tc.window, s=sec,
         mf=[[h[1] for h in hist] for hist in hists],
         window_lcr=[[h[2] for h in hist] for hist in hists],
         histories_equal_solo=True)
    return total


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


#: phase cpu: the runs whose card and CPU trajectories are held bit for
#: bit (integer series identical, positions within one ULP of area),
#: and those whose agreement is measured (float matmuls and float32
#: sin / cos / atan2 of the circular means, whose last bits differ
#: between cuBLAS / CUDA and the CPU; the flock is listed with them as
#: the reference's own float32 flock is not bitwise)
CPU_EXACT = (("rwp", {}), ("epidemic", {}), ("hotspot", {}), ("group", {}),
             ("trace", {}),
             ("group", dict(partitioner="bestresponse", repartition_every=25)))
CPU_MEASURED = (("flock", {}),
                ("hotspot", dict(partitioner="kmeans", repartition_every=25)),
                ("hotspot", dict(partitioner="voronoi",
                                 repartition_every=25)))


def card_vs_cpu(steps: int, dev):
    """Each scenario at 2,000 SEs (area 4,472, the paper's density) on
    the card and on the CPU, from the same seed."""
    from repro_torch.core import Engine
    area = 4472.0
    bad_runs = []
    for exact, runs in ((True, CPU_EXACT), (False, CPU_MEASURED)):
        for scenario, kw in runs:
            cfg = exp6_cfg(scenario, steps, n=2000, area=area, **kw)
            gst, gser, _, _ = run_engine(cfg, dev)
            cst, cser, _ = Engine(cfg, device="cpu").run(seed=0)
            bad = [k for k in cser if not torch.equal(gser[k].cpu(), cser[k])]
            first = {k: int((gser[k].cpu() != cser[k]).reshape(steps, -1)
                            .any(1).nonzero()[0]) for k in bad}
            gap = float((gst["pos"].cpu() - cst["pos"]).abs().max())
            ulps = gap / (area * ULP)
            same = {k: torch.equal(gst[k].cpu(), cst[k])
                    for k in ("lp", "waypoint", "mob", "pending_dst", "ring")}
            name = scenario + (f"+{kw['partitioner']}" if kw else "")
            emit(phase="cpu", run=name, held="bitwise" if exact
                 else "measured", n_se=2000, steps=steps,
                 series_mismatch=bad, first_mismatch_step=first,
                 lp_agreement=float((gst["lp"].cpu() == cst["lp"])
                                    .float().mean()),
                 max_pos_gap=gap, max_pos_gap_area_ulps=ulps,
                 state_equal=same)
            if exact and (bad or ulps > 1.0 or not all(same.values())):
                bad_runs.append(name)
    for scenario in ("rwp", "hotspot"):  # batched: R = 3 in one pass
        cfg = exp6_cfg(scenario, steps, n=2000, area=area)
        seeds = [0, 1, 2]
        gst, gser, _ = Engine(cfg, device=dev).run(seeds=seeds)
        cst, cser, _ = Engine(cfg, device="cpu").run(seeds=seeds)
        bad = [k for k in cser if not torch.equal(gser[k].cpu(), cser[k])]
        ulps = float((gst["pos"].cpu() - cst["pos"]).abs().max()) \
            / (area * ULP)
        name = f"{scenario} x{len(seeds)} batched"
        emit(phase="cpu", run=name, held="bitwise", n_se=2000, steps=steps,
             replicas=len(seeds), series_mismatch=bad,
             max_pos_gap_area_ulps=ulps,
             lp_equal=torch.equal(gst["lp"].cpu(), cst["lp"]))
        if bad or ulps > 1.0 or not torch.equal(gst["lp"].cpu(), cst["lp"]):
            bad_runs.append(name)
    bad_runs += cpu_service(steps, dev)
    if bad_runs:
        raise AssertionError(f"the card's run differs from the CPU's: "
                             f"{bad_runs}")


def churn_script(cfg, dev, steps: int, batch: int = 20, seed: int = 0):
    """An open world under churn through `Engine`: each step departs
    `batch` random live ids and admits `batch` uniform positions (one
    numpy stream, the same on any device), then steps once. Returns the
    ids each arrival got, each step's counters and the engine."""
    import numpy as np

    from repro_torch.core import Engine
    eng = Engine(cfg, device=dev).init(seed=seed)
    g = np.random.default_rng(seed)
    ids, per_step = [], []
    for _ in range(steps):
        eng.depart(g.choice(eng.live_ids(), batch, replace=False))
        ids.append(eng.arrive({"pos": g.uniform(0, cfg.abm.area,
                                                (batch, 2))}))
        per_step.append(eng.step(1))
    return ids, per_step, eng


def cpu_service(steps: int, dev) -> list:
    """Phase cpu's service runs, card against CPU at 2,000 SEs (area
    4,472): the churn script over `steps` steps (n_active 1,960, 20
    departures and arrivals a step; ids and every step's counters
    identical, positions within one ULP of `area`), and a 3-slot
    ReplicaService of 5 unequal requests (counters identical). Returns
    the names of the runs that differ."""
    from repro_torch.core import ReplicaService
    area, bad_runs = 4472.0, []
    cfg = dataclasses.replace(exp6_cfg("rwp", steps, n=2000, area=area),
                              open_world=True, n_active=1960)
    gids, gsteps, geng = churn_script(cfg, dev, steps)
    cids, csteps, ceng = churn_script(cfg, "cpu", steps)
    first = next((i for i, (a, b) in enumerate(zip(gsteps, csteps))
                  if a != b), None)
    ulps = float((geng.state["pos"].cpu() - ceng.state["pos"]).abs().max()) \
        / (area * ULP)
    lp_equal = torch.equal(geng.state["lp"].cpu(), ceng.state["lp"])
    emit(phase="cpu", run="rwp churn", held="bitwise", n_se=2000,
         n_active=1960, steps=steps, ids_equal=gids == cids,
         first_mismatch_step=first, max_pos_gap_area_ulps=ulps,
         lp_equal=lp_equal, population=geng.population(),
         migrations=sum(c["migrations"] for c in gsteps))
    if gids != cids or first is not None or ulps > 1.0 or not lp_equal:
        bad_runs.append("rwp churn")
    cfg = exp6_cfg("rwp", 0, n=2000, area=area)
    jobs = list(zip(range(5), (40, 15, 30, 20, 25)))
    res = []
    for d in (dev, "cpu"):
        svc = ReplicaService(cfg, 3, device=d)
        rids = [svc.submit(s, n) for s, n in jobs]
        out = svc.drain()
        res.append([out[r] for r in rids])
    same = res[0] == res[1]
    emit(phase="cpu", run="replica_service", held="bitwise", n_se=2000,
         slots=3, steps=[n for _, n in jobs], counters_equal=same,
         migrations=[c["migrations"] for c in res[0]])
    if not same:
        bad_runs.append("replica_service")
    return bad_runs


def exp6_trace(n: int, area: float, steps: int) -> str:
    """Register exp6's commuter trace (8 hubs, seed 0, steps + 1 frames,
    so `exact` covers the run) and return its name. At exp6's full
    spec a few float32 frame values round up to `area` itself, which
    both packages' `synthetic_trace` reject; they are folded to the
    largest float32 below `area` (the torus point they stand for)."""
    import numpy as np

    from repro_torch.data import pipeline as dpipe
    name = f"exp6-{n}-{steps}"
    if name not in dpipe.trace_names():
        frames = dpipe.commute_frames(dpipe.TraceSpec(
            n_se=n, area=area, timesteps=steps + 1,
            speed=11.0 * area / 10_000.0, n_hubs=8, seed=0))
        top = np.nextafter(np.float32(area), np.float32(0))
        folded = int((frames >= area).sum())
        frames = np.where(frames >= area, top, frames)
        dpipe.register_trace(name, dpipe.Trace(frames, area))
        emit(phase="scenarios", trace=name, frames=frames.shape[0],
             values_folded_below_area=folded)
    return name


def exp6_cfg(scenario: str, steps: int, n: int = 10_000,
             area: float = 10_000.0, partitioner: str = "random",
             repartition_every: int = 0):
    """benchmarks/exp6_scenarios.py's `scenario_cfg` (and exp7's
    `exp_cfg`), GAIA on: 4 LPs, range 250, p_interact 0.2, 8 groups of
    radius 250, MF 1.2, MT 10; speed 11 at area 10,000, scaled with
    the area."""
    from repro_torch.core import ABMConfig, EngineConfig, HeuristicConfig
    abm = dict(n_se=n, n_lp=4, area=area, speed=11.0 * area / 10_000.0,
               interaction_range=250.0, p_interact=0.2, mobility=scenario,
               n_groups=8, group_radius=250.0, partitioner=partitioner)
    if scenario == "trace":
        abm.update(trace_name=exp6_trace(n, area, steps),
                   trace_policy="exact")
    elif scenario == "epidemic":
        abm.update(mobility="rwp", **EPI)
    return EngineConfig(abm=ABMConfig(**abm),
                        heuristic=HeuristicConfig(mf=1.2, mt=10),
                        timesteps=steps, repartition_every=repartition_every)


def scenarios(epi_steps: int, steps: int, dev):
    """exp6's scenario fleet and exp7's periodic kmeans at full width
    (10k SEs, area 10,000), GAIA on, through `Engine` on the card. Each
    run: s/step, LCR, migrations, the grid_overflow sum (must be 0),
    the kernels' launches (counts set to 0 just before the run and read
    just after; the epidemic must launch the cell-list kernel twice a
    step, flock the cell-sum kernel once, kmeans the capacity-assign
    kernel 9 times a partition), and the run priced on the four
    environments (`wct_env`, exp6's message sizes). Then one
    `bestresponse` init: 8 dense and 8 capacity-assign launches."""
    from repro_torch.core import costmodel as cm
    from repro_torch.kernels import build as kbuild
    runs = [("epidemic", epi_steps, {}), ("hotspot", steps, {}),
            ("group", steps, {}), ("flock", steps, {}), ("trace", steps, {}),
            ("hotspot", steps, dict(partitioner="kmeans",
                                    repartition_every=100))]
    launches = {}
    for scenario, n_steps, kw in runs:
        cfg = exp6_cfg(scenario, n_steps, **kw)
        kbuild.reset_launches()
        st, series, c, sec = run_engine(cfg, dev)
        got = kbuild.launches()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        name = scenario + (f"+{kw['partitioner']}/{kw['repartition_every']}"
                           if kw else "")
        row = {"run": name, "steps": n_steps, "s_per_step": sec / n_steps,
               "mean_lcr": c["mean_lcr"], "migrations": c["migrations"],
               "repartitions": c["repartitions"],
               "grid_overflow": c["grid_overflow"], "launches": got,
               "wct_env_s": {k: cm.wct_env(
                   c, cm.DISTRIBUTED, cm.make_env(k, 4), n_steps,
                   interaction_bytes=100, migration_bytes=256)["TEC"]
                   for k in ENVS}}
        if scenario == "epidemic":
            inf = series["infected"].cpu()
            row.update(infected_first=float(inf[0]),
                       infected_last=float(inf[-1]))
        emit(phase="scenarios", **row)
        want_grid = (2 if scenario == "epidemic" else 1) * n_steps
        if c["grid_overflow"] != 0:
            raise AssertionError(f"{name}: grid overflow")
        if got["proximity_grid"] != want_grid:
            raise AssertionError(f"{name}: {got['proximity_grid']} cell-list "
                                 f"launches, want {want_grid}")
        if scenario == "flock" and got["cell_sums"] != n_steps:
            raise AssertionError(f"flock: {got['cell_sums']} cell-sum "
                                 f"launches, want {n_steps}")
        if kw and c["repartitions"] <= 0:
            raise AssertionError(f"{name}: no repartition fired")
        # kmeans: 9 scans a partition, at init and at each repartition
        want_ca = 9 * (1 + (n_steps - 1) // kw["repartition_every"]) \
            if kw else 0
        if got["capacity_assign"] != want_ca:
            raise AssertionError(f"{name}: {got['capacity_assign']} "
                                 f"capacity-assign launches, want {want_ca}")
    from repro_torch.core import Engine
    cfg = exp6_cfg("hotspot", 1, partitioner="bestresponse")
    kbuild.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev).init(seed=0)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = kbuild.launches()
    dense, scans = got["proximity_dense"], got["capacity_assign"]
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    from repro_torch.core.balance import bincount
    pop = bincount(eng.state["lp"], 4).tolist()
    emit(phase="scenarios", run="bestresponse init", s=sec,
         dense_launches=dense, capacity_assign_launches=scans,
         population=pop)
    if dense != 8 or scans != 8 or pop != [cfg.abm.n_se // 4] * 4:
        raise AssertionError(f"bestresponse init: {dense} dense and {scans} "
                             f"capacity-assign launches, populations {pop}")
    return launches


#: the service phase's churn batch (exp9's CHURN_BATCH) and slots
CHURN_BATCH = 200
SERVICE_SLOTS = 4
#: integer counters a request must share with its solo run
REQUEST_COUNTERS = ("migrations", "local_msgs", "remote_msgs", "heu_evals",
                    "repartitions")


def request_lengths(n: int, lo: int = 60, hi: int = 300) -> list:
    """n unequal request lengths spread over [lo, hi] (a fixed shuffle
    of the range, so slots finish apart)."""
    return [lo + (hi - lo) * ((5 * i) % 12) // 11 for i in range(n)]


def replica_service(cfg, jobs, slots: int, dev, what: str):
    """Drain `jobs` (seed, steps) through a ReplicaService of `slots`
    slots, and run each solo, in that order; every request's integer
    counters must equal its solo run's. Returns the row to print (with
    t_service / t_sequential, exp9's service_vs_sequential) and the
    service's kernel launches."""
    from repro_torch.core import Engine, ReplicaService
    from repro_torch.kernels import build as kbuild
    svc = ReplicaService(cfg, slots, device=dev)
    rids = [svc.submit(seed=s, steps=n) for s, n in jobs]
    kbuild.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = svc.drain()
    torch.cuda.synchronize()
    t_service = time.perf_counter() - t0
    launches = kbuild.launches()
    t0 = time.perf_counter()
    solo = [Engine(dataclasses.replace(cfg, timesteps=n), device=dev).run(
        seed=s)[2] for s, n in jobs]
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    bad = [(rid, k, res[rid][k], c[k]) for rid, c in zip(rids, solo)
           for k in REQUEST_COUNTERS if res[rid][k] != c[k]]
    row = {"run": what, "slots": slots, "requests": len(jobs),
           "steps": [n for _, n in jobs],
           "repartition_every": cfg.repartition_every,
           "t_service_s": t_service, "t_sequential_s": t_seq,
           "service_vs_sequential": t_service / t_seq,
           "migrations": [res[r]["migrations"] for r in rids],
           "repartitions": [res[r]["repartitions"] for r in rids],
           "grid_overflow": sum(res[r]["grid_overflow"] for r in rids),
           "launches": launches, "counters_equal_solo": not bad}
    if bad or row["grid_overflow"]:
        raise AssertionError(f"{what}: requests differ from their solo "
                             f"runs {bad[:4]}, grid_overflow "
                             f"{row['grid_overflow']}")
    return row, launches


def service(zero_steps: int, iters: int, n_requests: int, smi: str, dev):
    """The resident service at full width: the default EngineConfig()
    with 10k slots and open_world=True.

    - zero churn, `zero_steps` steps: bit-equal to the closed-world solo
      run of the same seed (series and final state), one cell-list
      launch a step;
    - exp9's churn loop (benchmarks/exp9_service.py:68-110): n_active
      9,800, then `iters` iterations of depart 200 random live ids,
      arrive 200 uniform positions, step 1: events/s, step p50 / p99
      (host clock around `Engine.step(1)`, which ends in a read of the
      counters), migrations; population stays 9,800, grid_overflow 0,
      one cell-list launch a step;
    - the queries: `query_lcr` (one more launch), `query_region` on a
      quadrant and on a box across the seam, `query_neighbors` of 64
      live ids, each against a brute-force recompute on the card;
    - `ReplicaService`: SERVICE_SLOTS slots, `n_requests` requests
      (seeds 0, 1, ...) of unequal lengths from 60 to 300 steps; then
      3 slots and 5 requests of exp7's hotspot with kmeans every 50
      steps (slots reach their repartitions at different global
      steps). Every request's integer counters equal its solo run's.

    Launch counts are set to 0 just before each run and read just
    after; their sum is returned."""
    import numpy as np

    from repro_torch.core import Engine, EngineConfig, neighbors
    from repro_torch.core.stats import percentile
    from repro_torch.kernels import build as kbuild
    total = {}

    def count(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    # zero churn: every slot live
    cfg = EngineConfig(timesteps=zero_steps, open_world=True)
    kbuild.reset_launches()
    ost, oser, oc, osec = run_engine(cfg, dev)
    got = kbuild.launches()
    count(got)
    cst, cser, _, csec = run_engine(
        dataclasses.replace(cfg, open_world=False), dev)
    bad = [k for k in cser if not torch.equal(oser[k], cser[k])] + \
        [k for k in cst if k != "t" and not torch.equal(ost[k], cst[k])]
    emit(phase="service", run="zero churn", card=smi, steps=zero_steps,
         s_per_step=osec / zero_steps, closed_s_per_step=csec / zero_steps,
         mean_pop=oc["mean_pop"], launches=got, mismatch=bad)
    if bad or got["proximity_grid"] != zero_steps or \
            oc["mean_pop"] != cfg.abm.n_se:
        raise AssertionError(f"zero churn: differs from the closed world "
                             f"in {bad}, launches {got}")
    del ost, oser, cst, cser

    # exp9's churn loop
    n = cfg.abm.n_se
    cfg = EngineConfig(open_world=True, n_active=n - CHURN_BATCH)
    area = cfg.abm.area
    g = np.random.default_rng(0)
    eng = Engine(cfg, device=dev).init(seed=0)
    eng.step(1)  # warm: one step, one arrival and departure batch
    eng.depart(eng.arrive({"pos": g.uniform(0, area, (CHURN_BATCH, 2))}))
    kbuild.reset_launches()
    step_s, migrations, overflow = [], 0.0, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        eng.depart(g.choice(eng.live_ids(), CHURN_BATCH, replace=False))
        eng.arrive({"pos": g.uniform(0, area, (CHURN_BATCH, 2))})
        ts = time.perf_counter()
        c = eng.step(1)
        step_s.append(time.perf_counter() - ts)
        migrations += c["migrations"]
        overflow += c["grid_overflow"]
    wall = time.perf_counter() - t0
    got = kbuild.launches()
    count(got)
    pop = eng.population()
    live_dev = int((eng.state["lp"] >= 0).sum())
    emit(phase="service", run="churn", card=smi, n_se=n, batch=CHURN_BATCH,
         iters=iters, events=2 * CHURN_BATCH * iters, wall_s=wall,
         events_per_s=2 * CHURN_BATCH * iters / wall,
         step_p50_ms=1e3 * percentile(step_s, 50.0),
         step_p99_ms=1e3 * percentile(step_s, 99.0),
         migrations=migrations, population=pop, live_rows_on_card=live_dev,
         grid_overflow=overflow, launches=got)
    if pop != n - CHURN_BATCH or live_dev != pop or overflow or \
            got["proximity_grid"] != iters:
        raise AssertionError(f"churn: population {pop} ({live_dev} live on "
                             f"the card), grid_overflow {overflow}, "
                             f"launches {got}")

    # the queries, each against a brute-force recompute on the card
    abm = cfg.abm
    pos, lp = eng.state["pos"], eng.state["lp"]
    valid = lp >= 0
    kbuild.reset_launches()
    t0 = time.perf_counter()
    lcr = eng.query_lcr()
    lcr_s = time.perf_counter() - t0
    got = kbuild.launches()
    count(got)
    L = abm.n_lp
    counts = neighbors.dense_lp_counts(pos, lp, valid, L, area,
                                       abm.interaction_range)
    flows = torch.zeros((L, L), dtype=torch.int64, device=dev)
    flows.index_add_(0, lp.clamp(0, L - 1).long(), counts.long())
    local, tot = int(flows.trace()), int(flows.sum())
    want_lcr = float(np.float32(local) / np.float32(max(tot, 1)))
    p, v = pos.cpu().numpy(), valid.cpu().numpy()
    boxes = {"quadrant": (0.0, 0.0, area / 2, area / 2),
             "seam": (area - 700.0, area - 700.0, 700.0, 700.0)}
    regions = {}
    for name, (x0, y0, x1, y1) in boxes.items():
        t0 = time.perf_counter()
        hit = eng.query_region((x0, y0, x1, y1))
        sec = time.perf_counter() - t0
        x, y = p[:, 0], p[:, 1]
        inx = (x >= x0) & (x <= x1) if x0 <= x1 else (x >= x0) | (x <= x1)
        iny = (y >= y0) & (y <= y1) if y0 <= y1 else (y >= y0) | (y <= y1)
        want = np.nonzero(v & inx & iny)[0].tolist()
        regions[name] = {"hits": len(hit), "s": sec, "equal": hit == want}
    q = eng.live_ids()[::max(1, pop // 64)][:64]
    t0 = time.perf_counter()
    nbr = eng.query_neighbors(q)
    nbr_s = time.perf_counter() - t0
    qi = torch.tensor(q, device=dev)
    rng2 = float(np.float32(abm.interaction_range * abm.interaction_range))
    d2 = neighbors.toroidal_d2(pos[qi][:, None, :], pos[None, :, :], area,
                               fused=False)
    ok = valid[None, :] & (d2 <= rng2)
    ok[torch.arange(len(q), device=dev), qi] = False
    want_nbr = {i: torch.nonzero(row)[:, 0].tolist()
                for i, row in zip(q, ok.cpu())}
    emit(phase="service", run="queries", card=smi, query_lcr=lcr,
         query_lcr_s=lcr_s, query_lcr_equal=lcr == want_lcr,
         launches=got, regions=regions, neighbors_ids=len(q),
         neighbors_found=sum(len(x) for x in nbr.values()),
         query_neighbors_s=nbr_s, query_neighbors_equal=nbr == want_nbr)
    if lcr != want_lcr or got["proximity_grid"] != 1 or nbr != want_nbr \
            or not all(r["equal"] for r in regions.values()):
        raise AssertionError(f"queries: lcr {lcr} against {want_lcr}, "
                             f"launches {got}, regions {regions}, "
                             f"neighbours equal {nbr == want_nbr}")
    del eng, pos, lp, counts, d2, ok

    # ReplicaService: continuous batching of unequal requests
    jobs = list(enumerate(request_lengths(n_requests)))
    row, got = replica_service(EngineConfig(), jobs, SERVICE_SLOTS, dev,
                               "replica_service")
    count(got)
    emit(phase="service", card=smi, **row)
    cfg = exp6_cfg("hotspot", 0, partitioner="kmeans", repartition_every=50)
    jobs = list(zip(range(5), (130, 70, 160, 90, 110)))
    row, got = replica_service(cfg, jobs, 3, dev,
                               "replica_service hotspot+kmeans/50")
    count(got)
    emit(phase="service", card=smi, **row)
    if not all(row["repartitions"]):
        raise AssertionError("hotspot+kmeans/50: a request saw no "
                             "repartition")
    # 9 scans a partition: each request's init and its own boundaries
    # (idle slots, queue exhausted, do not repartition)
    want_ca = 9 * sum(1 + (n - 1) // cfg.repartition_every for _, n in jobs)
    if got["capacity_assign"] != want_ca:
        raise AssertionError(f"hotspot+kmeans/50: {got['capacity_assign']} "
                             f"capacity-assign launches, want {want_ca}")
    return total


#: phase sharded: the shard counts of the default config, exp5's `full`
#: world (benchmarks/exp5_sharded.py:45, 58-63), and the launcher's run
SHARD_COUNTS = (1, 2, 4)
EXP5_FULL = dict(n_se=50_000, n_lp=8, area=10_000.0, speed=11.0,
                 interaction_range=250.0, p_interact=0.2)


def _lp_device(cfg, D: int, **kw):
    return dataclasses.replace(cfg, sharding="lp_device", n_devices=D, **kw)


def _run_mismatch(state, series, ref_state, ref_series, live=None):
    """The keys where a sharded run (state unsharded) differs from an
    oracle run: every oracle series it has, every state leaf (an open
    world's live rows only)."""
    bad = [k for k in ref_series if k in series
           and not torch.equal(series[k], ref_series[k])]
    for k, v in state.items():
        if k == "t":
            continue
        a, b = v, ref_state[k]
        if live is not None and k != "mob_g" and k != "key":
            a, b = (a[:, live], b[:, live]) if k == "ring" else \
                (a[live], b[live])
        if not torch.equal(a, b):
            bad.append(k)
    return bad


def _windows(x, width: int = 100) -> list:
    """Means of a per-step series over windows of `width` steps."""
    w = min(width, x.shape[0])
    return x[:x.shape[0] // w * w].view(-1, w).double().mean(1).tolist()


def sharded(steps: int, exp5_steps: int, steps_short: int, churn_iters: int,
            solo, smi: str, dev):
    """The LP-per-device engine (`repro_torch.parallel`) on the card:

    - the default EngineConfig() at D = 1, 2, 4 for `steps` steps: the
      unsharded final state and every oracle series bit-equal to phase
      main's GAIA-on run (`solo`), shard_overflow 0, one cell-list launch
      a step; s/step beside the oracle's, peak memory, halo_frac and LCR
      by 100-step window, bytes_on_wire; and the synchronising calls of
      one `Engine.step(300)` window, sharded (D = 4) against the oracle;
    - exp5's `full` world (50k SEs, 8 LPs, mig_capacity 12,500) at D = 8
      for `exp5_steps` steps against its oracle on the card;
    - phase main's dense world at D = 2, exp6's epidemic, flock and
      hotspot + kmeans every 50 steps at D = 2, `steps_short` steps each,
      against their oracles, with the kernels' launches a step (epidemic
      2 cell-list, flock 1 cell-sum, the oracle's capacity-assign count);
    - the open world at D = 4: zero churn against the closed world, then
      exp9's churn for `churn_iters` iterations (n_active 9,800, 200
      departures and arrivals, 1 step) and the three queries against
      brute force over the slot universe;
    - R = 4 replicas at D = 2, `steps_short` steps: each replica its solo
      sharded run's, one cell-list launch a step;
    - telemetry at D = 4 (drain_every 10, `min(300, steps)` steps): the
      ledger's halo_frac / bytes_on_wire / shard_overflow columns equal
      to the obs-off series; a 5-step trace with one span a (shard,
      phase, step);
    - the launcher (`python -m repro_torch.parallel.multihost
      --processes 1 --local-shards 4 --backend nccl`): its RESULT
      counters equal to the in-process run;
    - rwp at 2,000 SEs, D = 2, `steps_short` steps, card against CPU.

    Launch counts are set to 0 just before each run and read just after;
    their sum is returned."""
    import numpy as np

    from repro_torch import random as trandom
    from repro_torch.core import (ABMConfig, Engine, EngineConfig,
                                  HeuristicConfig, neighbors)
    from repro_torch.core import engine as teng
    from repro_torch.kernels import build as kbuild
    from repro_torch.obs import ObsConfig, trace_run
    from repro_torch.parallel import lp_shard
    total = {}

    def count(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    def launched(fn, *args):
        kbuild.reset_launches()
        out = fn(*args)
        torch.cuda.synchronize()
        got = kbuild.launches()
        count(got)
        return out, got

    # the default config at D = 1, 2, 4 against phase main's run
    sst, sser, ssec = solo
    for D in SHARD_COUNTS:
        cfg = _lp_device(EngineConfig(timesteps=steps), D)
        torch.cuda.reset_peak_memory_stats()
        (st, ser, c, sec), got = launched(run_engine, cfg, dev)
        bad = _run_mismatch(st, ser, sst, sser)
        spec, _ = lp_shard.layout(cfg)
        emit(phase="sharded", run="default", card=smi, shards=D,
             steps=steps, slots_a_shard=spec.cap, halo_cap=spec.halo_cap,
             mig_cap=spec.mig_cap, s_per_step=sec / steps,
             oracle_s_per_step=ssec / steps, vs_oracle=sec / ssec,
             peak_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
             halo_frac_by_100=_windows(ser["halo_frac"]),
             lcr_by_100=_windows(ser["lcr"]),
             bytes_on_wire=c["bytes_on_wire"],
             mean_halo_frac=c["mean_halo_frac"],
             shard_overflow=c["shard_overflow"],
             migrations=c["migrations"], launches=got, mismatch=bad)
        if bad or c["shard_overflow"] or got["proximity_grid"] != steps:
            raise AssertionError(f"sharded default D={D}: differs from the "
                                 f"oracle in {bad}, overflow "
                                 f"{c['shard_overflow']}, launches {got}")
    del st, ser, sst, sser

    # synchronising calls of one Engine.step window, sharded and not
    n = min(300, steps)
    syncs = {}
    for name, cfg in (("oracle", EngineConfig()),
                      ("sharded", _lp_device(EngineConfig(), 4))):
        eng = Engine(cfg, device=dev).init(seed=0)
        eng.step(1)
        with sync_count() as sc:
            eng.step(n)
        syncs[name] = sc["syncs"]
    emit(phase="sharded", run="syncs", card=smi, shards=4, steps=n, **syncs)
    if syncs["oracle"] != syncs["sharded"]:
        raise AssertionError(f"sharded window synchronises more: {syncs}")

    # exp5's full world at D = 8, and the short worlds at D = 2
    exp5 = EngineConfig(abm=ABMConfig(**EXP5_FULL),
                        heuristic=HeuristicConfig(mf=1.2, mt=10),
                        timesteps=exp5_steps, mig_capacity=12_500)
    short = [
        ("exp5 full", exp5, 8, {"proximity_grid": exp5_steps}),
        ("dense world", EngineConfig(
            abm=ABMConfig(n_se=2000, area=600.0, interaction_range=250.0),
            timesteps=steps_short), 2, {"proximity_dense": steps_short}),
        ("epidemic", exp6_cfg("epidemic", steps_short), 2,
         {"proximity_grid": 2 * steps_short}),
        ("flock", exp6_cfg("flock", steps_short), 2,
         {"cell_sums": steps_short}),
        ("hotspot+kmeans/50", exp6_cfg("hotspot", steps_short,
                                       partitioner="kmeans",
                                       repartition_every=50), 2, None),
    ]
    for name, cfg, D, want in short:
        (ost, oser, oc, osec), ogot = launched(run_engine, cfg, dev)
        (st, ser, c, sec), got = launched(run_engine, _lp_device(cfg, D),
                                          dev)
        bad = _run_mismatch(st, ser, ost, oser)
        want = want or {"capacity_assign": ogot["capacity_assign"]}
        off = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        emit(phase="sharded", run=name, card=smi, shards=D,
             n_se=cfg.abm.n_se, steps=cfg.timesteps, s_per_step=sec /
             cfg.timesteps, oracle_s_per_step=osec / cfg.timesteps,
             bytes_on_wire=c["bytes_on_wire"],
             mean_halo_frac=c["mean_halo_frac"],
             shard_overflow=c["shard_overflow"],
             migrations=c["migrations"], repartitions=c["repartitions"],
             launches=got, oracle_launches=ogot, mismatch=bad)
        if bad or off or c["shard_overflow"]:
            raise AssertionError(f"sharded {name}: differs from the oracle "
                                 f"in {bad}, launches {off}, overflow "
                                 f"{c['shard_overflow']}")
        del ost, oser, st, ser

    # the open world at D = 4: zero churn, exp9's churn, the queries
    zero = EngineConfig(timesteps=steps_short, open_world=True)
    (ost, oser, _, _), _ = launched(run_engine,
                                    dataclasses.replace(zero,
                                                        open_world=False),
                                    dev)
    (st, ser, c, _), got = launched(run_engine, _lp_device(zero, 4), dev)
    bad = _run_mismatch(st, {k: v for k, v in ser.items() if k != "pop"},
                        ost, oser)
    if bad or c["mean_pop"] != zero.abm.n_se:
        raise AssertionError(f"sharded zero churn: differs from the closed "
                             f"world in {bad}")
    del ost, oser, st, ser
    n_se = zero.abm.n_se
    cfg = _lp_device(EngineConfig(open_world=True,
                                  n_active=n_se - CHURN_BATCH), 4)
    area = cfg.abm.area
    g = np.random.default_rng(0)
    eng = Engine(cfg, device=dev).init(seed=0)
    kbuild.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    overflow = 0.0
    for _ in range(churn_iters):
        eng.depart(g.choice(eng.live_ids(), CHURN_BATCH, replace=False))
        eng.arrive({"pos": g.uniform(0, area, (CHURN_BATCH, 2))})
        overflow += eng.step(1)["shard_overflow"]
    wall = time.perf_counter() - t0
    got = kbuild.launches()
    count(got)
    pos, lp, gid = lp_shard.slot_universe(eng.state, cfg)
    valid = gid >= 0
    pop = eng.population()
    abm, L = cfg.abm, cfg.abm.n_lp
    lcr = eng.query_lcr()
    counts = neighbors.dense_lp_counts(pos, lp, valid, L, area,
                                       abm.interaction_range)
    flows = torch.zeros((L, L), dtype=torch.int64, device=dev)
    flows.index_add_(0, lp.clamp(0, L - 1).long(), counts.long())
    local, tot = int(flows.trace()), int(flows.sum())
    want_lcr = float(np.float32(local) / np.float32(max(tot, 1)))
    p, v, ids = pos.cpu().numpy(), valid.cpu().numpy(), gid.cpu().numpy()
    regions = {}
    for name, (x0, y0, x1, y1) in {
            "quadrant": (0.0, 0.0, area / 2, area / 2),
            "seam": (area - 700.0, area - 700.0, 700.0, 700.0)}.items():
        x, y = p[:, 0], p[:, 1]
        inx = (x >= x0) & (x <= x1) if x0 <= x1 else (x >= x0) | (x <= x1)
        iny = (y >= y0) & (y <= y1) if y0 <= y1 else (y >= y0) | (y <= y1)
        regions[name] = eng.query_region((x0, y0, x1, y1)) == sorted(
            ids[v & inx & iny].tolist())
    q = eng.live_ids()[::max(1, pop // 64)][:64]
    nbr = eng.query_neighbors(q)
    slot = {int(i): s for s, i in enumerate(ids) if i >= 0}
    qi = torch.tensor([slot[i] for i in q], device=dev)
    rng2 = float(np.float32(abm.interaction_range * abm.interaction_range))
    d2 = neighbors.toroidal_d2(pos[qi][:, None, :], pos[None, :, :], area,
                               fused=False)
    ok = valid[None, :] & (d2 <= rng2)
    ok[torch.arange(len(q), device=dev), qi] = False
    want_nbr = {i: sorted(ids[row].tolist())
                for i, row in zip(q, ok.cpu().numpy())}
    emit(phase="sharded", run="open world", card=smi, shards=4,
         zero_churn_steps=steps_short, iters=churn_iters,
         events_per_s=2 * CHURN_BATCH * churn_iters / wall,
         population=pop, live_slots=int(valid.sum()),
         shard_overflow=overflow, launches=got, query_lcr=lcr,
         query_lcr_equal=lcr == want_lcr, regions_equal=regions,
         query_neighbors_equal=nbr == want_nbr)
    if pop != n_se - CHURN_BATCH or int(valid.sum()) != pop or overflow \
            or got["proximity_grid"] != churn_iters or lcr != want_lcr \
            or nbr != want_nbr or not all(regions.values()):
        raise AssertionError(f"sharded open world: population {pop}, "
                             f"overflow {overflow}, launches {got}, lcr "
                             f"{lcr} / {want_lcr}, regions {regions}")
    del eng, pos, lp, gid, counts, d2, ok

    # R = 4 replicas at D = 2 against their solo sharded runs
    cfg = _lp_device(EngineConfig(timesteps=steps_short), 2)
    seeds = [0, 1, 2, 3]
    (bst, bser, _), got = launched(
        lambda: Engine(cfg, device=dev).run(seeds=seeds))
    for r, seed in enumerate(seeds):
        st, ser, _ = Engine(cfg, device=dev).run(seed=seed)
        _held_equal("sharded batch", bst, bser, r, st, ser)
    emit(phase="sharded", run="batch", card=smi, shards=2, replicas=4,
         steps=steps_short, launches=got)
    if got["proximity_grid"] != steps_short:
        raise AssertionError(f"sharded batch: launches {got}")
    del bst, bser, st, ser

    # telemetry at D = 4: the sharded ledger columns, and the trace
    n = min(300, steps)
    cfg = _lp_device(EngineConfig(timesteps=0), 4)
    on = dataclasses.replace(cfg, obs=ObsConfig(enabled=True,
                                                drain_every=OBS_DRAIN))
    eng = Engine(on, device=dev).init(seed=0)
    kbuild.reset_launches()
    eng.step(n)
    count(kbuild.launches())
    state = teng._init_engine(trandom.key(0), cfg, dev)
    kbuild.reset_launches()
    state, ser = teng._run_steps(state, cfg, n)
    count(kbuild.launches())
    led = eng.ledger()
    cols = ("halo_frac", "bytes_on_wire", "shard_overflow", "lcr",
            "migrations")
    col_bad = [k for k in cols if not np.array_equal(
        led.column(k), ser[k].cpu().double().numpy())]
    rec = trace_run(on, seed=0, n_steps=5, warmup=1, device=dev)
    spans = [e for e in rec.events if e.get("ph") == "X"]
    phases = {e["name"] for e in spans}
    span_bad = trace_args_mismatch(spans, cfg, dev, steps=1 + 5)
    emit(phase="sharded", run="telemetry", card=smi, shards=4, steps=n,
         rows=len(led), column_mismatch=col_bad, trace_spans=len(spans),
         trace_phases=sorted(phases), trace_args_mismatch=span_bad,
         trace_ms=[{k: v["mean"] * 1e3} for k, v in
                   rec.phase_summary().items()])
    eng.close()
    if col_bad or len(led) != n or span_bad \
            or len(spans) != 4 * len(phases) * 5:
        raise AssertionError(f"sharded telemetry: columns {col_bad}, rows "
                             f"{len(led)}, spans {len(spans)}, span args "
                             f"{span_bad}")
    del eng, state, ser

    # the launcher on the card: one process holding 4 shards, nccl
    args = ["--processes", "1", "--local-shards", "4", "--backend", "nccl"]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.parallel.multihost", *args],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    wall = time.perf_counter() - t0
    lines = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    if out.returncode or not lines:
        raise AssertionError(f"multihost exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    result = json.loads(lines[0][7:])
    from repro_torch.parallel import multihost
    lcfg = multihost.build_config(multihost.parser().parse_args(args))
    eng = Engine(lcfg, device=dev).init(seed=0)
    eng.step(lcfg.timesteps)
    c = eng.step(lcfg.timesteps)
    want = {"bytes_on_wire": c["bytes_on_wire"],
            "migrations": c["migrations"],
            "shard_overflow": c["shard_overflow"],
            "mean_lcr": round(c["mean_lcr"], 4),
            "mean_halo_frac": round(c["mean_halo_frac"], 4)}
    off = {k: (result[k], v) for k, v in want.items() if result[k] != v}
    emit(phase="sharded", run="multihost", card=smi, args=args,
         result=result, wall_s=wall, in_process=want, mismatch=off)
    if off or result["devices"] != 4:
        raise AssertionError(f"multihost RESULT differs: {off}")
    del eng

    # card against CPU: rwp at 2,000 SEs, D = 2
    area = 4472.0
    cfg = _lp_device(exp6_cfg("rwp", steps_short, n=2000, area=area), 2)
    gst, gser, _, _ = run_engine(cfg, dev)
    cst, cser, _ = Engine(cfg, device="cpu").run(seed=0)
    bad = [k for k in cser if not torch.equal(gser[k].cpu(), cser[k])]
    ulps = float((gst["pos"].cpu() - cst["pos"]).abs().max()) / (area * ULP)
    emit(phase="sharded", run="card vs cpu", card=smi, shards=2, n_se=2000,
         steps=steps_short, series_mismatch=bad, max_pos_gap_area_ulps=ulps,
         lp_equal=torch.equal(gst["lp"].cpu(), cst["lp"]))
    if bad or ulps > 1.0 or not torch.equal(gst["lp"].cpu(), cst["lp"]):
        raise AssertionError(f"sharded card against CPU: {bad}, {ulps} "
                             "ULPs")
    return total


#: phase obs: the ledger ring's depth, and the reference's bar on the
#: telemetry's wall overhead (benchmarks/exp10_obs.py, printed beside
#: the port's ratio, not gated)
OBS_DRAIN = 10
OBS_BAR = 1.10


def obs_windows(steps: int) -> tuple:
    """Phase obs's `Engine.step` windows over `steps` steps: (7, 293,
    100, 800) at 1,200, so windows end mid-ring (a tail to flush) and
    start mid-ring (wrap blocks with slots from before the window)."""
    return (7, steps // 4 - 7, steps // 12, steps - steps // 4 - steps // 12)


#: the warning of PyTorch's sync debug mode, one a synchronising call
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextmanager
def sync_count():
    """The warnings raised inside the block with PyTorch's sync debug mode
    on: yields a dict that holds, once the block ends, "syncs" (the
    synchronising calls) and "other" (the other warnings' texts)."""
    import warnings
    out = {}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode("default")
    texts = [str(w.message) for w in caught]
    out["syncs"] = sum(SYNC_WARNING in t for t in texts)
    out["other"] = sorted({t[:160] for t in texts if SYNC_WARNING not in t})


def obs(steps: int, tune_steps: int, cpu_steps: int, smi: str, dev):
    """Runtime telemetry (`repro_torch.obs`) at full width, the default
    EngineConfig() with ObsConfig(enabled=True, drain_every=10):

    - `Engine.step` windows of `obs_windows(steps)`, against the obs-off
      window runner (`engine._run_steps`, then `series_counters`, as
      `Engine.step` runs it without telemetry) of the same seed and
      windows: final state bit-equal, each window's counters equal, one
      ledger row a step with every counter column equal to the obs-off
      series and the per-LP loads summing to the population, as many
      cell-list launches and as many synchronising calls on both sides;
    - the overhead: `Engine.step(300)` with telemetry on and off, three
      interleaved reps each side, the ratio of their minima;
    - exp9's churn for 20 iterations (n_active 9,800, depart 200 /
      arrive 200 / step 1): arrive and depart events stamped at the
      engine's step, the `pop` column at 9,800;
    - `intra_run_tune` (window 100, `tune_steps` steps) with a session:
      one `tuner_move` a change of MF in its history;
    - `trace_run` of 20 steps after 2 of warm-up: the phase summary in
      ms, the JSON under results/, and `trace_steps`' state bit-equal to
      `_run_steps`' from the same init;
    - a 2,000-SE run of `cpu_steps` steps on the card and on the CPU:
      ledger rows and events equal.

    Launch counts are set to 0 just before each run and read just
    after; their sum is returned."""
    import numpy as np

    from repro_torch import random as trandom
    from repro_torch.core import Engine, EngineConfig, SelfTuneConfig
    from repro_torch.core import engine as teng
    from repro_torch.core.selftune import intra_run_tune
    from repro_torch.kernels import build as kbuild
    from repro_torch.obs import (ObsConfig, Telemetry, runtime, trace_run,
                                 trace_steps, TraceRecorder)
    total = {}

    def count(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    on = ObsConfig(enabled=True, drain_every=OBS_DRAIN)
    cfg = EngineConfig(timesteps=0, obs=on)
    off = EngineConfig(timesteps=0)
    windows = obs_windows(steps)
    eng = Engine(cfg, device=dev).init(seed=0)
    with sync_count() as warm:  # a first synchronising call, uncounted
        torch.zeros(1, device=dev).cpu()
    kbuild.reset_launches()
    with sync_count() as on_syncs:
        got_on = [eng.step(n) for n in windows]
    on_launches = kbuild.launches()
    state = teng._init_engine(trandom.key(0), off, dev)
    series, got_off = [], []
    kbuild.reset_launches()
    with sync_count() as off_syncs:
        for n in windows:
            state, s = teng._run_steps(state, off, n)
            got_off.append(teng.series_counters(s))
            series.append(s)
    off_launches = kbuild.launches()
    count(on_launches)
    count(off_launches)
    series = {k: torch.cat([s[k] for s in series]).cpu() for k in series[0]}
    led = eng.ledger()
    cols = ("lcr", "local_msgs", "remote_msgs", "migrations", "heu_evals",
            "repartitions", "grid_overflow")
    col_bad = [k for k in cols if not np.array_equal(
        led.column(k), series[k].double().numpy())]
    loads = sum(led.column(f"lp_load_{i}") for i in range(cfg.abm.n_lp))
    state_bad = [k for k in state if k != "t" and
                 not torch.equal(state[k], eng.state[k])]
    row = {"run": "default", "card": smi, "windows": list(windows),
           "drain_every": OBS_DRAIN, "rows": len(led),
           "steps_stamped": bool(np.array_equal(
               led.column("step"), np.arange(float(steps)))),
           "column_mismatch": col_bad, "state_mismatch": state_bad,
           "counters_equal": got_on == got_off,
           "loads_sum": sorted(set(loads.tolist())),
           "launches_on": on_launches, "launches_off": off_launches,
           "syncs_on": on_syncs["syncs"], "syncs_off": off_syncs["syncs"],
           "warm_syncs": warm["syncs"],
           "other_warnings": sorted(set(warm["other"] + on_syncs["other"]
                                        + off_syncs["other"])),
           "drain_stalls": eng.telemetry.drain.stalls,
           "events": len(eng.events())}
    emit(phase="obs", **row)
    if col_bad or state_bad or got_on != got_off or len(led) != steps or \
            not row["steps_stamped"] or row["loads_sum"] != [cfg.abm.n_se] \
            or on_launches["proximity_grid"] != steps or \
            off_launches["proximity_grid"] != steps or \
            on_syncs["syncs"] != off_syncs["syncs"]:
        raise AssertionError(f"obs: telemetry on differs from off: {row}")
    eng.close()
    del eng, state, series

    # the overhead, off and on in turns
    n = min(300, steps)
    engs = {k: Engine(c, device=dev).init(seed=0)
            for k, c in (("off", off), ("on", cfg))}
    times = {"off": [], "on": []}
    kbuild.reset_launches()
    for order in (("off", "on"), ("on", "off"), ("off", "on")):
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engs[k].step(n)
            times[k].append(time.perf_counter() - t0)
    count(kbuild.launches())
    t_on, t_off = min(times["on"]), min(times["off"])
    emit(phase="obs", run="overhead", card=smi, steps=n, reps=3,
         s_per_step_on=t_on / n, s_per_step_off=t_off / n,
         overhead_ratio=t_on / t_off, reference_bar=OBS_BAR,
         times_on=times["on"], times_off=times["off"])
    del engs

    # exp9's churn with telemetry
    n_se = cfg.abm.n_se
    ccfg = EngineConfig(open_world=True, n_active=n_se - CHURN_BATCH, obs=on)
    g = np.random.default_rng(0)
    eng = Engine(ccfg, device=dev).init(seed=0)
    iters = 20
    kbuild.reset_launches()
    for _ in range(iters):
        eng.depart(g.choice(eng.live_ids(), CHURN_BATCH, replace=False))
        eng.arrive({"pos": g.uniform(0, ccfg.abm.area, (CHURN_BATCH, 2))})
        eng.step(1)
    count(kbuild.launches())
    want = [(k, t, CHURN_BATCH, p) for t in range(iters)
            for k, p in (("depart", n_se - 2 * CHURN_BATCH),
                         ("arrive", n_se - CHURN_BATCH))]
    got = [(e.kind, e.step, e.data["count"], e.data["population"])
           for e in eng.events() if e.kind in ("arrive", "depart")]
    pop = sorted(set(eng.ledger().column("pop").tolist()))
    emit(phase="obs", run="churn", card=smi, iters=iters,
         batch=CHURN_BATCH, churn_events=len(got), stamps_exact=got == want,
         pop=pop, rows=len(eng.ledger()))
    if got != want or pop != [n_se - CHURN_BATCH] or len(eng.ledger()) \
            != iters:
        raise AssertionError(f"obs churn: events {got[:4]}, pop {pop}")
    eng.close()
    del eng

    # the tuner's moves
    tele = Telemetry(off)
    kbuild.reset_launches()
    with runtime.use(tele):
        _, hist = intra_run_tune(trandom.key(0), EngineConfig(),
                                 SelfTuneConfig(window=100),
                                 total_steps=tune_steps, device=dev)
    count(kbuild.launches())
    moves = [(e.data["window"], e.data["prev_mf"], e.data["mf"], e.step)
             for e in tele.events.records("tuner_move")]
    want = [(w, hist[w][1], hist[w + 1][1], (w + 1) * 100)
            for w in range(len(hist) - 1) if hist[w + 1][1] != hist[w][1]]
    emit(phase="obs", run="tuner", card=smi, steps=tune_steps, window=100,
         moves=len(moves), mf=[h[1] for h in hist])
    if not want or moves[:len(want)] != want:
        raise AssertionError(f"obs tuner: moves {moves} against {want}")

    # the trace, and a traced run against the fused one
    kbuild.reset_launches()
    rec = trace_run(EngineConfig(), seed=0, n_steps=20, warmup=2,
                    device=dev)
    os.makedirs(os.path.join(HERE, "results"), exist_ok=True)
    path = rec.save(os.path.join(HERE, "results", "obs_trace.json"))
    start = teng._init_engine(trandom.key(0), off, dev)
    traced = trace_steps(start, off, 20, TraceRecorder(), warmup=2)
    fused, _ = teng._run_steps(start, off, 22)
    count(kbuild.launches())
    bad = [k for k in fused if k != "t" and
           not torch.equal(fused[k], traced[k])]
    summ = rec.phase_summary()
    emit(phase="obs", run="trace", card=smi, steps=20, warmup=2,
         path=os.path.relpath(path, HERE),
         phase_ms={k: 1e3 * v["mean"] for k, v in summ.items()},
         spans={k: v["n"] for k, v in summ.items()},
         step_ms=1e3 * sum(v["mean"] for v in summ.values()),
         state_mismatch=bad)
    if bad or any(v["n"] != 20 for v in summ.values()):
        raise AssertionError(f"obs trace: traced state differs in {bad}")

    # the card against the CPU
    ccfg = dataclasses.replace(exp6_cfg("rwp", cpu_steps, n=2000,
                                        area=4472.0), obs=on)
    teles = []
    kbuild.reset_launches()
    for d in (dev, "cpu"):
        e = Engine(ccfg, device=d)
        e.run(seed=0)
        teles.append(e.telemetry)
    count(kbuild.launches())
    rows_equal = bool(np.array_equal(teles[0].ledger.rows(),
                                     teles[1].ledger.rows()))
    ev = [[(e.kind, e.step, e.data) for e in t.events.records()]
          for t in teles]
    emit(phase="obs", run="card vs cpu", card=smi, n_se=2000,
         steps=cpu_steps, rows=len(teles[0].ledger), rows_equal=rows_equal,
         events_equal=ev[0] == ev[1])
    if not rows_equal or ev[0] != ev[1] or len(teles[0].ledger) != cpu_steps:
        raise AssertionError("obs: the card's ledger differs from the CPU's")
    runtime.set_current(None)
    return total


def profile(steps: int, dev, scenario: str = "", n_rep: int = 1):
    """Where a step of the default config (or of an exp6 scenario at
    full width) spends its time; with `n_rep` > 1, a step of a batch of
    that many replicas (seeds 0, 1, ...)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from repro_torch.core import Engine, EngineConfig
    from repro_torch.core import engine as teng
    cfg = exp6_cfg(scenario, 2 * steps + 5) if scenario else EngineConfig()
    eng = Engine(cfg, device=dev).init(
        seeds=list(range(n_rep)) if n_rep > 1 else None)
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
    emit(phase="profile", config=f"exp6 {scenario}" if scenario
         else "EngineConfig()", replicas=n_rep, steps=steps,
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
    # 300 of Exp. 1's 1,200 steps, and below the epidemic's 300 of its
    # 1,200, the cpu phase's 30, the batched scenarios' 60, the tuners'
    # 300, 6 service requests, exp5's 150 steps, the sharded worlds' 60
    # (kmeans repartitions at 50) and 20 churn iterations, and 16 decode
    # steps: cut so that the script stays inside its time limit as it
    # grows
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--dense-steps", type=int, default=200)
    p.add_argument("--scale-steps", type=int, default=20)
    p.add_argument("--cpu-steps", type=int, default=30,
                   help="steps of the cpu phase's runs, its churn script "
                        "included, and of phase obs's card-against-CPU "
                        "ledger")
    p.add_argument("--epi-steps", type=int, default=300,
                   help="steps of the scenarios phase's epidemic run")
    p.add_argument("--scenario-steps", type=int, default=300,
                   help="steps of the scenarios phase's other runs")
    p.add_argument("--replica-scenario-steps", type=int, default=60,
                   help="steps of the replicas phase's epidemic and flock")
    p.add_argument("--tune-steps", type=int, default=300,
                   help="steps of the replicas phase's batched tuner")
    p.add_argument("--service-iters", type=int, default=120,
                   help="iterations of the service phase's churn loop")
    p.add_argument("--service-requests", type=int, default=6,
                   help="requests of the service phase's ReplicaService")
    p.add_argument("--exp5-steps", type=int, default=150,
                   help="steps of the sharded phase's exp5 full world")
    p.add_argument("--shard-steps", type=int, default=60,
                   help="steps of the sharded phase's other worlds")
    p.add_argument("--shard-churn", type=int, default=20,
                   help="churn iterations of the sharded phase's open "
                        "world")
    p.add_argument("--gen", type=int, default=16,
                   help="decode steps of the serve phases (serve, "
                        "mla_serve, recurrent_serve, encdec_vision_serve)")
    p.add_argument("--profile", type=int, default=0, metavar="STEPS",
                   help="trace STEPS steps of the default config instead")
    p.add_argument("--scenario", default="", choices=(
        "", "epidemic", "hotspot", "group", "flock", "trace"),
        help="with --profile: an exp6 scenario at full width instead")
    p.add_argument("--replicas", type=int, default=1,
                   help="with --profile: a batch of this many replicas")
    p.add_argument("--train-steps", type=int, default=6,
                   help="steps of phase train's tinyllama-1.1b run")
    p.add_argument("--train-moe-steps", type=int, default=3,
                   help="steps of phase train's cut-depth qwen3-moe run")
    p.add_argument("--dense-gen", type=int, default=16,
                   help="decode steps of the dense serve (qwen2-7b)")
    p.add_argument("--train-cpu-child", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--recurrent-f32-child", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--train-kernels-child", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--profile-serve", type=int, default=0, metavar="STEPS",
                   help="trace the serve phase's prefill and STEPS decode "
                        "steps instead")
    p.add_argument("--profile-arch", default="",
                   help="with --profile-serve: this arch at full width "
                        "and depth instead (e.g. rwkv6-1.6b)")
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU; none is visible")
    if a.train_cpu_child:
        train_cpu_child(torch.device("cuda"))
        return
    if a.recurrent_f32_child:
        recurrent_f32_child(torch.device("cuda"))
        return
    if a.train_kernels_child:
        train_kernels_child(torch.device("cuda"))
        return
    dev = torch.device("cuda")
    smi = card()
    build()
    if a.profile:
        profile(a.profile, dev, a.scenario, a.replicas)
        return
    if a.profile_serve:
        profile_serve(a.profile_serve, dev, a.profile_arch)
        return
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    t_kernels = time.perf_counter()
    launch_floor()
    shapes = {"grid": [check_grid(10_000, 10_000.0, 250.0, 1, dev),
                       check_grid(1_000_000, 100_000.0, 250.0, 2, dev),
                       check_grid(10_000, 10_000.0, 250.0, 5, dev,
                                  layout="clustered"),
                       check_grid(10_000, 10_000.0, 250.0, 6, dev,
                                  layout="epidemic"),
                       check_grid(10_000, 10_000.0, 250.0, 7, dev,
                                  layout="hotspot"),
                       check_grid(10_000, 10_000.0, 250.0, 20, dev,
                                  replicas=10),
                       check_grid(10_000, 10_000.0, 250.0, 50, dev,
                                  dead=2_000),
                       check_grid(10_000, 10_000.0, 250.0, 51, dev,
                                  replicas=4, dead=2_000),
                       check_grid(10_000, 10_000.0, 250.0, 0, dev,
                                  layout="sharded", replicas=4)],
              "dense": [check_dense(2_000, 600.0, 250.0, 3, dev),
                        check_dense(10_000, 10_000.0, 250.0, 4, dev),
                        check_dense(10_000, 10_000.0, 250.0, 8, dev,
                                    all_senders=True),
                        check_dense(2_000, 600.0, 250.0, 30, dev,
                                    replicas=4),
                        check_dense(2_000, 600.0, 250.0, 52, dev,
                                    dead=500)],
              "cell_sums": [check_cell_sums(10_000, 10_000.0, 9, dev),
                            check_cell_sums(10_000, 10_000.0, 10, dev,
                                            mobility="hotspot"),
                            check_cell_sums(10_000, 10_000.0, 40, dev,
                                            replicas=4)],
              "capacity_assign": [check_capacity_assign(kind, seed, dev)
                                  for kind, seed in ASSIGN_SHAPES],
              **check_lm_kernels(dev)}
    emit(phase="kernels_checked", shapes=shapes)
    seconds["kernels"] = time.perf_counter() - t_kernels
    served = timed("serve", serve_phase, a.gen, dev)
    mla_served = timed("mla_serve", mla_serve_phase, a.gen, smi, dev)
    launches, solo = timed("main", main_path, a.steps, a.dense_steps, dev)
    # the engine's capacity-assign launches must all take the rounds
    with capacity_assign_rounds() as got:
        replica_launches = timed("replicas", replicas, a.steps,
                                 a.replica_scenario_steps, a.tune_steps,
                                 solo, dev)
    engine_rounds("replicas", got)
    with capacity_assign_rounds() as got:
        sharded_launches = timed("sharded", sharded, a.steps, a.exp5_steps,
                                 a.shard_steps, a.shard_churn, solo,
                                 smi, dev)
    engine_rounds("sharded", got)
    del solo
    with capacity_assign_rounds() as got:
        scenario_launches = timed("scenarios", scenarios, a.epi_steps,
                                  a.scenario_steps, dev)
    engine_rounds("scenarios", got)
    for stem in ("cell_sums", "capacity_assign"):
        launches[stem] = scenario_launches[stem]
    with capacity_assign_rounds() as got:
        service_launches = timed("service", service, min(300, a.steps),
                                 a.service_iters, a.service_requests, smi,
                                 dev)
    engine_rounds("service", got)
    obs_launches = timed("obs", obs, a.steps, a.tune_steps, a.cpu_steps,
                         smi, dev)
    timed("scale", scale, a.scale_steps, dev)
    timed("cpu", card_vs_cpu, a.cpu_steps, dev)
    timed("serve_cpu", serve_cpu_phase, dev)
    train_shapes, train_launches, moe_launches = timed(
        "train", train, a.train_steps, a.train_moe_steps, smi, dev)
    timed("dense_serve", dense_serve_phase, a.dense_gen, smi, dev)
    recurrent = timed("recurrent_serve", recurrent_serve_phase, a.gen, smi,
                      dev)
    recurrent_train = timed("recurrent_train", recurrent_train_phase, smi,
                            dev)
    encdec_vision = timed("encdec_vision_serve", encdec_vision_serve_phase,
                          a.gen, smi, dev)
    encdec_vision_train = timed("encdec_vision_train",
                                encdec_vision_train_phase, smi, dev)
    emit(phase="seconds", **seconds)
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
        # a port-only kernel: it replaces the reference's jnp scatter-add
        # `bin2d` of cell_block_mean, not a Pallas kernel
        "cell_sums": ("cell_sums", "cell_sums",
                      src + "cell_sums/csrc/cell_sums.cu",
                      "src/repro/core/neighbors.py:510"),
        # port-only too: the `lax.scan` of partition.capacity_assign
        "capacity_assign": ("capacity_assign", "capacity_assign",
                            src + "capacity_assign/csrc/capacity_assign.cu",
                            "src/repro/core/partition.py:178"),
    }
    # the training path's kernels: launches from phase train's runs
    # (tinyllama-1.1b; the gate's from the cut-depth qwen3-moe run)
    train_meta = {
        "flash_attention_bwd": (
            "flash_attention_bwd", "flash_attention_bwd",
            src + "flash_attention/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:67",
            train_launches),
        "moe_gate_bwd": ("moe_gate_bwd", "moe_gate_bwd",
                         src + "moe_gate/csrc/moe_gate_bwd.cu",
                         "src/repro/kernels/moe_gate/moe_gate.py:55",
                         moe_launches),
        # port-only: the reference's jnp intra-chunk term of its WKV
        # scan; launches from rwkv6-1.6b's run in phase recurrent_train
        "wkv_intra": ("wkv_intra", "wkv_intra",
                      src + "wkv/csrc/wkv_intra.cu",
                      "src/repro/models/rwkv6.py:117",
                      recurrent_train["rwkv6-1.6b"]["launches"]),
        "wkv_intra_bwd": ("wkv_intra_bwd", "wkv_intra_bwd",
                          src + "wkv/csrc/wkv_intra_bwd.cu",
                          "src/repro/models/rwkv6.py:117",
                          recurrent_train["rwkv6-1.6b"]["launches"]),
    }

    def family_launches(stem):
        """A kernel's launches in each recurrent phase's runs and in
        phases encdec_vision_serve's and encdec_vision_train's."""
        return {f"{phase}_launches": {arch: runs[arch]["launches"].get(
                    stem, 0) for arch in spec["archs"]}
                for phase, runs, spec in (
                    ("recurrent_serve", recurrent, RECURRENT_SERVE),
                    ("recurrent_train", recurrent_train, TRAIN_RECURRENT),
                    ("encdec_vision_serve", encdec_vision,
                     ENCDEC_VISION_SERVE),
                    ("encdec_vision_train", encdec_vision_train,
                     TRAIN_ENCDEC_VISION))}

    def measured(shape):
        """The kernels line's measured fields of a kernel's main shape."""
        return {**{f: shape[f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
            **{f: shape.get(f) for f in ("kernel_device_ms",
                                         "library_device_ms")}}

    kernels = []
    for k, (name, stem, source, replaces) in meta.items():
        main_shape = shapes[k][0]  # the shape the main path gives it
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[stem],
            "scenario_launches": scenario_launches.get(stem, 0),
            "replicas_launches": replica_launches.get(stem, 0),
            "service_launches": service_launches.get(stem, 0),
            "obs_launches": obs_launches.get(stem, 0),
            "sharded_launches": sharded_launches.get(stem, 0),
            "mla_serve_launches": mla_served["launches"].get(stem, 0),
            **family_launches(stem),
            "train_launches": train_launches.get(stem, 0),
            "train_moe_launches": moe_launches.get(stem, 0),
            **measured(main_shape),
            "shapes": shapes[k] + train_shapes.get(f"{k}_g7", [])
            + train_shapes.get(f"{k}_train", [])})
    for k, (name, stem, source, replaces, runs) in train_meta.items():
        main_shape = train_shapes[k][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": runs[stem],
            **measured(main_shape), **family_launches(stem),
            "shapes": train_shapes[k]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
