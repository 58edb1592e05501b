"""The paper's cost analysis (§3, Eqs. 1-6) as an executable model — the
port's own copy of the part of `repro.core.costmodel` this slice uses
(`SETUPS`, `wct`, `ExecutionEnvironment`); host-only Python.

    TEC = MCC/f(N) + (SC + LCC + RCC + MMC) + MigC          (Eq. 5)
    MigC = MigCPU + MigComm + Heu                           (Eq. 6)

f(N) is the parallel speedup. The paper's text says "f(N) > N ... there
is a sequential fraction that can not be parallelized", which is
internally inconsistent (a sequential fraction implies speedup < N); we
implement Amdahl's law, f(N) = 1/(s + (1-s)/N) <= N, and note the
discrepancy in DESIGN.md §Deviations.

Two calibrated parameter sets model the paper's testbeds: PARALLEL
(shared-memory multicore, §5.4 Table 2) and DISTRIBUTED (GbE LAN cluster,
Table 3). Calibration targets the OFF-row wall-clock structure of the
paper's tables (latency-dominated remote messages on the LAN; memory-
bandwidth-bound local delivery in shared memory).

`ExecutionEnvironment` describes a heterogeneous cluster (per-LP speed
factors and a pairwise link-class matrix); its pricing (`wct_env`) comes
with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CostParams:
    name: str
    # communication (per interaction message)
    t_local_msg: float  # s per intra-LP delivery
    t_local_byte: float
    t_remote_msg: float  # s per inter-LP delivery (latency term)
    t_remote_byte: float  # s per payload byte (bandwidth term)
    # model computation per delivered event
    t_event_cpu: float
    # synchronization + middleware per LP per timestep
    t_sync: float
    t_mmc: float
    # migration
    t_mig_cpu: float  # serialize/deserialize per migration
    t_mig_msg: float  # transfer latency per migration message
    t_mig_byte: float
    # heuristic evaluation (per SE evaluation) — the Heu term
    t_heu: float
    serial_frac: float  # Amdahl


# Calibrated against the OFF rows of Table 2 (parallel: DELL R620,
# shared memory) and Table 3 (distributed: GbE cluster), 1200 timesteps,
# ~47M deliveries (10k SEs x pi=0.2 x ~19.6 proximity neighbors):
#
#   parallel     94.87 / 98.48 / 130.11 s at 1 / 100 / 1024 B
#   distributed 741.00 / 849.23 / 2698.50 s
#
# Key structural fact (matches the tables, and why per-message LAN
# latency does NOT appear): time-stepped PADS middleware batches all
# messages for a given LP into one network send per timestep, so the
# remote path costs per-message *marshaling* (~us) plus *bandwidth*
# (~45 ns/B effective on the 2003-era GbE cluster; ~1 ns/B through
# shared memory), while the per-timestep barrier carries the latency.
# This is what makes Table 3's inter=1 gains small (~5%) and lets an
# 80 KiB migration payload flip the sign — the reproduction target.
PARALLEL = CostParams(
    name="parallel",
    t_local_msg=3.0e-7, t_local_byte=0.0,  # intra-LP: pointer hand-off
    t_remote_msg=5.0e-7, t_remote_byte=1.0e-9,
    t_event_cpu=1.2e-6,
    t_sync=5.0e-5, t_mmc=1.0e-5,
    t_mig_cpu=3.0e-6, t_mig_msg=3.0e-6, t_mig_byte=1.0e-9,
    t_heu=5.0e-8,
    serial_frac=0.05,
)

DISTRIBUTED = CostParams(
    name="distributed",
    t_local_msg=3.0e-7, t_local_byte=0.0,
    t_remote_msg=3.0e-6, t_remote_byte=4.5e-8,
    t_event_cpu=1.2e-6,
    t_sync=1.0e-3, t_mmc=2.0e-5,  # per-timestep LAN barrier
    t_mig_cpu=5.0e-6, t_mig_msg=3.0e-6, t_mig_byte=4.5e-8,
    t_heu=5.0e-8,
    serial_frac=0.05,
)

SETUPS: Dict[str, CostParams] = {"parallel": PARALLEL,
                                 "distributed": DISTRIBUTED}


def amdahl(n_lp: int, s: float) -> float:
    return 1.0 / (s + (1.0 - s) / n_lp)


def wct(counters: Dict[str, float], p: CostParams, n_lp: int,
        timesteps: int, interaction_bytes: int = 1,
        migration_bytes: int = 32) -> Dict[str, float]:
    """Estimate wall-clock time from engine counters.

    counters: local_msgs, remote_msgs, migrations, heu_evals (floats).
    Returns the component breakdown of Eq. 5/6.
    """
    local = float(counters["local_msgs"])
    remote = float(counters["remote_msgs"])
    migs = float(counters["migrations"])
    evals = float(counters["heu_evals"])

    mcc = (local + remote) * p.t_event_cpu / amdahl(n_lp, p.serial_frac)
    lcc = local * (p.t_local_msg + interaction_bytes * p.t_local_byte)
    rcc = remote * (p.t_remote_msg + interaction_bytes * p.t_remote_byte)
    sc = timesteps * p.t_sync
    mmc = timesteps * p.t_mmc
    mig_cpu = migs * p.t_mig_cpu
    mig_comm = migs * (p.t_mig_msg + migration_bytes * p.t_mig_byte)
    heu = evals * p.t_heu
    total = mcc + lcc + rcc + sc + mmc + mig_cpu + mig_comm + heu
    return {
        "MCC": mcc, "LCC": lcc, "RCC": rcc, "SC": sc, "MMC": mmc,
        "MigCPU": mig_cpu, "MigComm": mig_comm, "Heu": heu,
        "MigC": mig_cpu + mig_comm + heu,
        "TEC": total,
    }


# ---------------------------------------------------------------------------
# Heterogeneous execution environments (per-LP speeds + pairwise links)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkClass:
    """One §3 interconnect class: per-message marshaling cost plus
    per-payload-byte bandwidth cost (the per-message *latency* rides in
    the per-timestep barrier — see the calibration note above)."""
    name: str
    t_msg: float
    t_byte: float


#: "shm"/"lan" reuse the PARALLEL/DISTRIBUTED remote-path calibration;
#: "wan" models an inter-site path: heavier marshaling (TLS/tunneling)
#: and ~1/3 of the GbE effective bandwidth. WAN *latency* belongs in the
#: barrier — see ExecutionEnvironment.t_sync.
LINK_CLASSES: Dict[str, LinkClass] = {
    "shm": LinkClass("shm", t_msg=5.0e-7, t_byte=1.0e-9),
    "lan": LinkClass("lan", t_msg=3.0e-6, t_byte=4.5e-8),
    "wan": LinkClass("wan", t_msg=6.0e-6, t_byte=1.5e-7),
}


@dataclasses.dataclass(frozen=True)
class ExecutionEnvironment:
    """A heterogeneous cluster: per-LP speed factors and a pairwise
    link-class matrix. Frozen + tuple-typed so it is hashable and can
    ride inside EngineConfig (the engine uses `speed` as the default
    asymmetric-balance capacity profile; `wct_env` prices flows with
    the link matrix)."""
    name: str
    speed: Tuple[float, ...]  # relative PEU speed per LP (1.0 = calibrated)
    link: Tuple[Tuple[str, ...], ...]  # link-class name per (src, dst) pair
    t_sync: Optional[float] = None  # per-timestep barrier override

    def __post_init__(self):
        L = len(self.speed)
        if any(s <= 0 for s in self.speed):
            raise ValueError(f"speed factors must be > 0: {self.speed}")
        if len(self.link) != L or any(len(row) != L for row in self.link):
            raise ValueError(f"link matrix must be {L}x{L}")
        for s in range(L):
            for d in range(L):
                if s != d and self.link[s][d] not in LINK_CLASSES:
                    raise ValueError(
                        f"unknown link class {self.link[s][d]!r} at "
                        f"({s}, {d}); known: {sorted(LINK_CLASSES)}")

    @property
    def n_lp(self) -> int:
        return len(self.speed)

    def capacity_shares(self) -> Tuple[float, ...]:
        """speed factors normalized to sum 1 — the asymmetric-balance
        capacity profile this environment implies (paper §4.4: capacity
        = relative PEU speed)."""
        tot = sum(self.speed)
        return tuple(s / tot for s in self.speed)
