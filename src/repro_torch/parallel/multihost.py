"""Multi-process launcher for the sharded engine (`torch.distributed`),
the port of `repro.parallel.multihost`.

One process holds `--local-shards` shards of the "lp" mesh on its
device; P processes make a mesh of D = P x local shards, and the
collectives of `parallel.lp_shard` (psum, all_gather, all_to_all) move
real bytes between them: the sparse halo's `bytes_on_wire` becomes
traffic. Launch P processes with identical arguments except
--process-id:

    PYTHONPATH=src python -m repro_torch.parallel.multihost \\
        --coordinator 10.0.0.1:9911 --processes 2 --process-id 0 ...
    PYTHONPATH=src python -m repro_torch.parallel.multihost \\
        --coordinator 10.0.0.1:9911 --processes 2 --process-id 1 ...

or --spawn to start all P ranks from one command (as children of this
one). Rank 0 prints the run's counters as a ``RESULT {json}`` line.

The backend is gloo (each process computes on the CPU) or nccl (each
process on its CUDA device: NCCL refuses two ranks on one device, so on
one card the launcher runs one process). Right after the process
group is up, a one-element `all_reduce` probes the backend; a backend
that refuses exits with code 3 instead of failing mid-run.

Every rank builds the identical initial state from the seed and keeps
its own shards' rows (`lp_shard.init_sharded`), so a P-process run
computes what one process with all D shards computes, which is the
oracle's run bit for bit. The run is a warm-up window then a timed
window of --steps each; the counters are the timed window's.
"""
from __future__ import annotations

import argparse
import datetime
import json
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

_UNSUPPORTED_EXIT = 3  # the backend cannot run the collectives
#: how long a collective waits for its peers before it fails
TIMEOUT = datetime.timedelta(seconds=300)


def build_config(args):
    """The reference launcher's engine config (exp5's world) at D =
    processes x local shards."""
    from repro_torch.core.abm import ABMConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.heuristics import HeuristicConfig
    return EngineConfig(
        abm=ABMConfig(n_se=args.n_se, n_lp=args.n_lp, area=10_000.0,
                      speed=11.0, interaction_range=250.0, p_interact=0.2,
                      mobility=args.mobility),
        heuristic=HeuristicConfig(mf=1.2, mt=10),
        gaia_on=not args.gaia_off, timesteps=args.steps,
        sharding="lp_device", n_devices=args.processes * args.local_shards,
        mig_capacity=max(512, args.n_se // 4))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _probe(device) -> bool:
    """One one-element all_reduce: False when the backend refuses."""
    try:
        x = torch.ones(1, device=device)
        dist.all_reduce(x)
        return float(x) == dist.get_world_size()
    except RuntimeError as e:
        print(f"[multihost] collective probe failed: {e}", file=sys.stderr)
        return False


def run(args, device) -> dict:
    """The warm-up and the timed window on this process's shards;
    returns the timed window's counters (every rank computes them)."""
    from repro_torch.core.engine import _init_engine, _run_window
    from repro_torch import random as trandom
    cfg = build_config(args)
    state = _init_engine(trandom.key(args.seed), cfg, device)
    state, _ = _run_window(state, cfg, args.steps)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()
    state, counters = _run_window(state, cfg, args.steps)
    sync()
    counters["per_step_s"] = (time.perf_counter() - t0) / args.steps
    return counters


def run_distributed(args) -> int:
    if args.backend == "nccl":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        # the step's many small ops run fastest on one intra-op thread,
        # and P processes on one host would otherwise oversubscribe it
        torch.set_num_threads(1)
    addr = args.coordinator or f"127.0.0.1:{_free_port()}"
    dist.init_process_group(
        args.backend, init_method=f"tcp://{addr}",
        world_size=args.processes, rank=args.process_id, timeout=TIMEOUT)
    try:
        from repro_torch.parallel import lp_shard
        spec, _ = lp_shard.layout(build_config(args))
        if args.process_id == 0:
            print(f"[multihost] {args.processes} process(es), mesh "
                  f"lp={spec.n_dev}, {spec.cap} slots a shard, backend="
                  f"{args.backend}, device={device}", flush=True)
        if not _probe(device):
            print(f"[multihost] backend {args.backend!r} cannot run the "
                  "collectives; rerun with --processes 1 or another "
                  "backend", file=sys.stderr)
            return _UNSUPPORTED_EXIT
        c = run(args, device)
        if args.process_id == 0:
            out = dict(processes=args.processes, devices=spec.n_dev,
                       n_se=args.n_se, n_lp=args.n_lp, steps=args.steps,
                       per_step_s=round(c["per_step_s"], 4),
                       bytes_on_wire=c["bytes_on_wire"],
                       mean_halo_frac=round(c["mean_halo_frac"], 4),
                       mean_lcr=round(c["mean_lcr"], 4),
                       migrations=c["migrations"],
                       shard_overflow=c["shard_overflow"])
            print("RESULT " + json.dumps(out), flush=True)
        return 0
    finally:
        dist.destroy_process_group()


def _spawn_ranks(args, argv) -> int:
    """Start all P ranks of this launcher as children (rank 0 included)
    and wait for them; when one fails, stop the others."""
    addr = args.coordinator or f"127.0.0.1:{_free_port()}"
    base = [sys.executable, "-m", "repro_torch.parallel.multihost",
            *[a for a in argv if a != "--spawn"], "--coordinator", addr]
    procs = [subprocess.Popen(base + ["--process-id", str(r)])
             for r in range(args.processes)]
    try:
        codes = [None] * len(procs)
        while None in codes:
            for i, p in enumerate(procs):
                codes[i] = p.poll()
            if any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if _UNSUPPORTED_EXIT in codes:
        return _UNSUPPORTED_EXIT
    return max(abs(c) for c in codes)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="run the sharded GAIA engine across torch.distributed "
                    "processes")
    ap.add_argument("--coordinator", default="",
                    help="rank 0's address:port (default: a free port on "
                         "127.0.0.1, for --spawn and --processes 1)")
    ap.add_argument("--processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--spawn", action="store_true",
                    help="start all --processes ranks from this command")
    ap.add_argument("--local-shards", type=int, default=1,
                    help="shards of the lp mesh each process holds")
    ap.add_argument("--backend", default="nccl", choices=("gloo", "nccl"),
                    help="nccl computes on the card, gloo on the CPU")
    ap.add_argument("--n-se", type=int, default=10_000)
    ap.add_argument("--n-lp", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mobility", default="rwp")
    ap.add_argument("--gaia-off", action="store_true")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if args.spawn:
        return _spawn_ranks(args, argv)
    return run_distributed(args)


if __name__ == "__main__":
    sys.exit(main())
