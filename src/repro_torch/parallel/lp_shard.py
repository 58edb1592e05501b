"""LP-per-device sharded execution of the GAIA engine (the port of
`repro.parallel.lp_shard`).

LPs map onto the D shards of an `LPMesh` (block map `dev_of_lp`), and
each shard owns the SE rows of its LPs: positions, waypoints, heuristic
windows and migration state live in per-shard slot buffers of
`shard_capacity` (C) slots, (Dl, C, ...) on each process's device, with
a replica axis in front for a batch, (R, Dl, C, ...); the heuristic ring
is (w, Dl, C, L). The reference's flat slot-major layout (D * C, ...)
is a reshape of it (`sharded_state_from_numpy` / `..._to_numpy`). Per
step:

  * proximity is resolved per shard over a sparse, neighbour-only halo:
    each shard knows, one step ahead, which grid cells every shard may
    query (the `halo_need` bitmaps), packs exactly the rows each peer
    needs into per-pair buffers of `halo_cap` rows (one batched stable
    sort over (Dl, D, C)) and exchanges them with one all_to_all. The
    D local views (own C rows, then D * halo_cap received rows, padding
    at lp = -1) are the R-world stack of a replica batch: one grid
    build and one cell-list kernel launch for all of them, the shard's
    senders on its own rows and none on halo rows;
  * the bitmaps steering step t + 1's exchange are negotiated at the
    tail of step t: occupancy plus the cells of rows pending migration
    toward each shard, dilated by 2 + max displacement / cell, a sound
    superset of the true need;
  * the LCR terms, the candidate matrix and every counter are psum'd;
  * GAIA migrations reshard: when a migration's delay elapses and its
    LP lives on another shard, the SE's full row (heuristic window
    included) is packed into a per-shard migration buffer of `mig_cap`
    rows, all-gathered, and written into a free slot of the
    destination; the source slot is vacated (gid = lp = -1). A row that
    does not fit waits (exact or loud: `shard_overflow`).

Bit for bit the port's oracle (`sharding="none"`) on the same seed: the
row-local mobility models draw full-size id-order arrays and take their
rows by SE id; the flock and the periodic partitioner rebuild the
id-order state from an all-gather and run the oracle's own functions;
every count is an integer. Three capacities must bound the true maxima
for that to hold; overflow is reported per step in `shard_overflow`.

Wire accounting (`bytes_on_wire` a step, `wire_flows` its (D, D)
matrix): the useful payload a ragged transport would move, packed halo
rows at 12 B (16 for the epidemic's label), admitted cross-shard
migration rows at their full size, and the valid rows of the id-order
gathers of the flock and the repartition. Control-plane reductions are
not counted.

One process (the card's case) runs all D shards on its device with no
`torch.distributed` call; across processes the collectives go through
the default process group (`multihost.py`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import balance as bal
from repro_torch.core import engine as eng
from repro_torch.core import heuristics as heu
from repro_torch.core import neighbors
from repro_torch.core import partition as part
from repro_torch.core.abm import (epidemic_draws, epidemic_row_update,
                                  epidemic_send_prob, infection_table,
                                  init_abm, max_step_displacement,
                                  mobility_row_apply, mobility_row_draws,
                                  mobility_step, row_local_mobility)
from repro_torch.fp32 import div32
from repro_torch.kernels.proximity import ops as prox
from repro_torch.parallel.mesh import LPMesh, make_mesh, world

#: per-SE state rows that migrate with an SE between shards ("mob" is
#: the mobility state, "epi" the infection flag)
_ROW_FIELDS = ("pos", "waypoint", "mob", "last_mig", "ptr", "since_eval",
               "epi", "gid")

#: every per-slot field: the rows, the LP and the migration protocol
#: ((..., Dl, C, ...); the ring is (..., w, Dl, C, L))
SLOT_FIELDS = _ROW_FIELDS + ("lp", "pending_dst", "pending_eta")

#: bytes per halo row on the wire: pos (2 x f32) + lp (i32)
HALO_ROW_BYTES = 12

_I32 = torch.int32


def _halo_row_bytes(cfg) -> int:
    """Bytes per halo row: the epidemic ships one more i32 (the
    infectious-sender label the receiver's exposure sweep reads)."""
    return HALO_ROW_BYTES + (4 if cfg.abm.workload == "epidemic" else 0)


def _mig_row_bytes(window: int, n_lp: int, epidemic: bool = False) -> int:
    """Bytes per migrated SE row: the 8 row fields (pos / waypoint / mob
    2 x f32 each, last_mig / ptr / since_eval / epi / gid i32), the
    destination i32 and the (window, n_lp) i32 heuristic ring rows; the
    `epi` flag counts for epidemic runs only."""
    return 44 + (4 if epidemic else 0) + 4 * window * n_lp


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Static geometry of the LP-per-device layout."""
    n_dev: int  # shards on the "lp" mesh
    n_lp: int
    n_se: int
    cap: int  # SE slots per shard (bounds the largest shard population)
    mig_cap: int  # migration-buffer rows per shard per step
    halo_cap: int  # halo rows per (src, dst) shard pair per step
    grid: Optional[neighbors.GridSpec]  # local-view cell list (live SEs)

    @property
    def n_slots(self) -> int:
        return self.n_dev * self.cap


def dev_of_lp(lp, spec: ShardSpec):
    """Block LP -> shard map: shard d owns a contiguous LP range."""
    return (lp * spec.n_dev) // spec.n_lp


def _sparse_halo(spec: ShardSpec) -> bool:
    """Does this layout run the neighbour-only exchange? It needs a
    grid (footprints are cell bitmaps) and a second shard."""
    return spec.grid is not None and spec.n_dev > 1


def _dilation_radius(spec: ShardSpec, abm) -> int:
    """Cells of Chebyshev dilation that turn step-t occupancy into a
    sound step-t+1 need: 1 for the 3x3 block plus the cell shift of one
    mobility step (a move of at most `disp` per axis crosses at most
    floor(disp / cell) + 1 cell boundaries)."""
    return 2 + int(max_step_displacement(abm) // spec.grid.cell)


def make_shard_spec(cfg) -> ShardSpec:
    """The sharded layout of an EngineConfig (sharding="lp_device").
    `n_devices` 0 is one shard a process (1 without a process group),
    never more shards than LPs; a shard count the world's processes do
    not divide raises ValueError."""
    abm = cfg.abm
    n, L = abm.n_se, abm.n_lp
    procs, _ = world()
    d = min(cfg.n_devices if cfg.n_devices > 0 else procs, L)
    if d % procs:
        raise ValueError(f"n_devices={d} is not a multiple of the {procs} "
                         "processes of the world")
    backend = abm.proximity_backend
    if backend.startswith("pallas"):
        raise NotImplementedError(
            f"sharding='lp_device' supports proximity_backend 'grid' and "
            f"'dense', not {backend!r} (the Pallas kernels are per-device "
            "TPU kernels; run them under sharding='none')")
    budget_mb = abm.mem_budget_mb
    if cfg.shard_capacity > 0:
        cap = cfg.shard_capacity
    elif d == 1:
        cap = n
    else:
        # 2x the balanced share: symmetric balance exactly, asymmetric
        # drift up to a 2/d capacity share
        cap = min(n, -(-2 * n // d) + 8)
    if cfg.mig_capacity > 0:
        mig_cap = min(cap, cfg.mig_capacity)
    else:
        mig_cap = min(cap, max(32, cap // 2))
        if budget_mb > 0 and d > 1:
            # the gathered migration buffer gets a quarter of the budget
            w = cfg.heuristic.kappa if cfg.heuristic.kind == 1 \
                else cfg.heuristic.omega
            rows = (budget_mb << 18) // (d * _mig_row_bytes(
                w, L, abm.workload == "epidemic"))
            mig_cap = min(mig_cap, max(16, rows))
    grid = abm.grid_spec() if backend == "grid" else None
    if grid is None or d == 1:
        halo_cap = 1  # no exchange: dense fallback or one shard
    elif cfg.halo_capacity > 0:
        halo_cap = min(cfg.halo_capacity, cap)
    elif budget_mb > 0:
        # send + receive buffers get a quarter of the budget
        rows = (budget_mb << 18) // (2 * d * _halo_row_bytes(cfg))
        halo_cap = min(cap, max(32, rows))
    else:
        # a peer can need every row a shard owns (a random initial
        # partition scatters each LP over the whole torus)
        halo_cap = cap
    return ShardSpec(n_dev=d, n_lp=L, n_se=n, cap=cap, mig_cap=mig_cap,
                     halo_cap=halo_cap, grid=grid)


@functools.lru_cache(maxsize=64)
def _layout(cfg, procs: int, rank: int):
    spec = make_shard_spec(cfg)
    return spec, LPMesh(spec.n_dev, procs, rank)


def layout(cfg) -> tuple:
    """(ShardSpec, LPMesh) of a config in the current world."""
    return _layout(cfg, *world())


# ---------------------------------------------------------------------------
# row helpers: per-shard tensors are (..., Dl, C, *rest)
# ---------------------------------------------------------------------------


def _take(x, idx):
    """x's rows `idx` of each shard: x (..., Dl, C, *rest), idx
    (..., Dl, M) -> (..., Dl, M, *rest)."""
    rest = x.shape[idx.dim():]
    i = idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest)
    return x.gather(idx.dim() - 1, i)


def _select(rows, idx):
    """Rows of a per-replica table for each slot (an id-order tensor by
    each slot's SE id, say): rows (..., M, *rest), idx (..., Dl, C) with
    entries in [0, M) -> (..., Dl, C, *rest) (one index_select; a
    batch's tables are offset by r * M)."""
    nl = idx.dim() - 2
    m = rows.shape[nl]
    rest = rows.shape[nl + 1:]
    flat = idx.long()
    if nl:
        flat = flat + torch.arange(0, rows.shape[0] * m, m,
                                   device=idx.device)[:, None, None]
    out = rows.reshape((-1,) + rest).index_select(0, flat.reshape(-1))
    return out.view(idx.shape + rest)


def _to_id_order(x_all, tgt, n: int, fill):
    """The id-order (..., n, *rest) tensor of gathered slot rows x_all
    (..., S, *rest) whose ids are `tgt` (..., S) (n for empty slots,
    dropped); ids no slot holds get `fill`."""
    nl = tgt.dim() - 1
    rest = x_all.shape[tgt.dim():]
    out = torch.full(tgt.shape[:nl] + (n + 1,) + rest, fill,
                     dtype=x_all.dtype, device=x_all.device)
    i = tgt.long().reshape(tgt.shape + (1,) * len(rest)).expand(x_all.shape)
    return out.scatter(nl, i, x_all).narrow(nl, 0, n)


def _slot_step(tv):
    """The step as per-slot fields compare with it: the int, or a
    batch's (R, 1) per-replica steps as (R, 1, 1)."""
    return tv[..., None] if isinstance(tv, torch.Tensor) else tv


def _arrival_sources(target, m: int, cap: int):
    """(..., Dl, C) int64: for each slot, the index of the arriving row
    written there, or m. `target` (..., Dl, M) holds each row's slot
    (cap: none); slots are distinct."""
    src = torch.full(target.shape[:-1] + (cap + 1,), m, dtype=torch.int64,
                     device=target.device)
    src.scatter_(-1, target.long(), torch.arange(
        target.shape[-1], device=target.device).expand(target.shape))
    return src[..., :cap]


def _write_rows(x, src, vals):
    """x with the slots whose `src` < M overwritten by rows vals[src]:
    x (..., Dl, C, *rest), src (..., Dl, C), vals (..., M, *rest)."""
    nl = src.dim() - 2
    m = vals.shape[nl]
    pad = torch.zeros(vals.shape[:nl] + (1,) + vals.shape[nl + 1:],
                      dtype=vals.dtype, device=vals.device)
    rows = _select(torch.cat([vals, pad], nl), src)
    has = (src < m).reshape(src.shape + (1,) * (x.dim() - src.dim()))
    return torch.where(has, rows, x)


def _write_ring(ring, src, vals):
    """The ring (..., w, Dl, C, L) with arriving rows vals (..., M, w, L)
    written at their slots."""
    rows = _write_rows(ring.movedim(-4, -2), src, vals)
    return rows.movedim(-2, -4).contiguous()


def _footprint(owner, cell, valid, pending_dst, spec: ShardSpec):
    """(..., D, ncells) int32, 1 on the cells a shard's rows occupy:
    each valid row marks its cell for its owner shard and, when it is
    pending migration, for its destination's shard. owner / cell /
    valid / pending_dst are (..., M) rows."""
    D = spec.n_dev
    ncells = spec.grid.ncell ** 2
    nc1 = ncells + 1
    safe = torch.where(valid, cell, ncells).long()
    pend = valid & (pending_dst >= 0)
    pdev = torch.where(pend, dev_of_lp(pending_dst.clamp(min=0), spec),
                       D).long()
    idx = torch.cat([owner.long() * nc1 + safe, pdev * nc1 + safe], -1)
    out = torch.zeros(cell.shape[:-1] + ((D + 1) * nc1,), dtype=_I32,
                      device=cell.device)
    out.scatter_(-1, idx, 1)
    return out.view(cell.shape[:-1] + (D + 1, nc1))[..., :D, :ncells]


def _need(footprint, spec: ShardSpec, abm):
    """The dilated (..., D, ncells) bool need bitmaps of a footprint."""
    nc = spec.grid.ncell
    occ = (footprint > 0).view(footprint.shape[:-1] + (nc, nc))
    return neighbors.dilate_mask(occ, _dilation_radius(spec, abm)).view(
        footprint.shape)


def halo_need_bitmaps(pos, valid, pending_dst, spec: ShardSpec, abm):
    """(n_dev, ncell^2) bool: the cells whose occupants shard d may
    query next step, from the global slot-major state ((S, 2) / (S,)):
    the cells its valid slots occupy, plus those of rows pending
    migration toward one of its LPs, dilated by `_dilation_radius`. It
    seeds `init_sharded`; the step computes the same bitmaps from its
    shards' rows at its tail."""
    owner = torch.arange(pos.shape[0], device=pos.device) // spec.cap
    fp = _footprint(owner, neighbors.cell_ids(pos, spec.grid), valid,
                    pending_dst, spec)
    return _need(fp, spec, abm)


# ---------------------------------------------------------------------------
# init, layout conversions, unshard
# ---------------------------------------------------------------------------


def _shard_axis(k: str, n_lead: int) -> int:
    return n_lead + 1 if k == "ring" else n_lead


def _split(k, x, spec: ShardSpec, mesh: LPMesh, n_lead: int):
    """A flat slot-major field (..., S, ...) as this process's shards
    (..., Dl, C, ...); replicated leaves pass through."""
    if k not in SLOT_FIELDS and k != "ring":
        return x
    sd = _shard_axis(k, n_lead)
    shards = x.reshape(x.shape[:sd] + (spec.n_dev, spec.cap)
                       + x.shape[sd + 1:])
    return mesh.local_part(shards, sd).contiguous()


def _join(k, x, mesh: LPMesh, n_lead: int):
    """Inverse of `_split`: every shard's rows, flat slot-major."""
    if k not in SLOT_FIELDS and k != "ring":
        return x
    sd = _shard_axis(k, n_lead)
    return mesh.all_gather(x, sd).flatten(sd, sd + 1)


def slot_universe(state, cfg) -> tuple:
    """(pos, lp, gid) of every shard's slots of one replica, flat
    slot-major (the service's queries read them without unsharding)."""
    _, mesh = layout(cfg)
    return tuple(_join(k, state[k], mesh, 0) for k in ("pos", "lp", "gid"))


def init_sharded(key, cfg, spec: ShardSpec, device, mesh: LPMesh = None):
    """Sharded engine state at t = 0: shard d owns slots [d * cap,
    (d + 1) * cap), filled in SE id order; each process keeps its own
    shards. Draws exactly as `engine._init_engine` (same k1/k2 split),
    so SE i's position, waypoint and LP are the oracle's row i. Empty
    slots get spread-out pad positions from `fold_in(key, 0x5107)` and
    lp = gid = -1. The sparse halo adds the first need bitmaps."""
    mesh = mesh or make_mesh(spec.n_dev)
    n, L, S, C = spec.n_se, spec.n_lp, spec.n_slots, spec.cap
    k1, k2 = trandom.split(key)
    st = init_abm(k1, cfg.abm, device)
    hst = heu.init_state(cfg.heuristic, n, L, device)
    dev = st["lp"].cpu().numpy().astype(np.int64) * spec.n_dev // L
    counts = np.bincount(dev, minlength=spec.n_dev)
    if counts.max() > C:
        raise ValueError(
            f"initial per-device population {counts.max()} exceeds "
            f"shard_capacity {C}; raise EngineConfig.shard_capacity")
    order = np.argsort(dev, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_of_se = np.empty(n, np.int64)
    slot_of_se[order] = dev[order] * C + np.arange(n) - starts[dev[order]]
    slot = torch.from_numpy(slot_of_se).to(device)
    pad = trandom.uniform(trandom.fold_in(key, 0x5107), (S, 2),
                          maxval=cfg.abm.area, device=device)

    def scat(x, fill):
        out = torch.full((S,) + x.shape[1:], fill, dtype=x.dtype,
                         device=device)
        return out.index_copy(0, slot, x)

    none = torch.full((S,), -1, dtype=_I32, device=device)
    state = {
        "pos": pad.index_copy(0, slot, st["pos"]),
        "waypoint": pad.index_copy(0, slot, st["waypoint"]),
        "mob": scat(st["mob"], 0.0),
        "mob_g": st["mob_g"],
        "lp": scat(st["lp"], -1),
        "epi": scat(st["epi"], 0),
        "gid": scat(torch.arange(n, dtype=_I32, device=device), -1),
        "pending_dst": none,
        "pending_eta": none.clone(),
        "ring": torch.zeros((hst["ring"].shape[0], S, L), dtype=_I32,
                            device=device).index_copy(1, slot, hst["ring"]),
        "ptr": scat(hst["ptr"], 0),
        "since_eval": scat(hst["since_eval"], 0),
        "last_mig": scat(hst["last_mig"], -10**6),
        "key": k2,
        "t": 0,
    }
    live = cfg.initial_live()
    if cfg.open_world and live < n:
        # ids [live, n) start as free slots; every SE was placed first,
        # so the live prefix's bits are the oracle's
        dead = state["gid"] >= live
        state["gid"] = torch.where(dead, -1, state["gid"])
        state["lp"] = torch.where(dead, -1, state["lp"])
    if _sparse_halo(spec):
        state["halo_need"] = halo_need_bitmaps(
            state["pos"], state["gid"] >= 0, state["pending_dst"], spec,
            cfg.abm)
    return {k: _split(k, v, spec, mesh, 0) for k, v in state.items()}


def sharded_state_from_numpy(arrays, spec: ShardSpec, device,
                             mesh: LPMesh = None):
    """The port's sharded state from the reference's (numpy, flat
    slot-major, one replica or stacked; the key as its uint32 words):
    this process's shards of it."""
    mesh = mesh or make_mesh(spec.n_dev)
    st = eng.state_from_numpy(arrays, device)
    nl = 1 if st["key"].dim() == 2 else 0
    return {k: _split(k, v, spec, mesh, nl) for k, v in st.items()}


def sharded_state_to_numpy(state, mesh: LPMesh) -> dict:
    """Inverse of `sharded_state_from_numpy`: every shard, flat
    slot-major, as numpy (the reference's layout)."""
    nl = state["gid"].dim() - 2
    return eng.state_to_numpy({k: _join(k, v, mesh, nl)
                               for k, v in state.items()})


def unshard_state(state, spec: ShardSpec, mesh: LPMesh = None):
    """Scatter one replica's sharded state back to id order (the
    oracle's layout), gathering every shard; ids no slot holds (an open
    world's free ids) get zeros. The `halo_need` double buffer has no
    oracle counterpart and is dropped."""
    mesh = mesh or make_mesh(spec.n_dev)
    n = spec.n_se
    flat = {k: _join(k, v, mesh, 0) for k, v in state.items()}
    tgt = torch.where(flat["gid"] >= 0, flat["gid"], n)
    out = {k: _to_id_order(flat[k], tgt, n, 0) for k in
           ("pos", "waypoint", "mob", "lp", "epi", "pending_dst",
            "pending_eta", "ptr", "since_eval", "last_mig")}
    ring = _to_id_order(flat["ring"].movedim(0, 1), tgt, n, 0)
    out.update(ring=ring.movedim(1, 0).contiguous(), mob_g=flat["mob_g"],
               key=flat["key"], t=flat["t"])
    return out


def unshard_batch(states, spec: ShardSpec, mesh: LPMesh = None):
    """Each replica of a stacked sharded state unsharded to id order,
    stacked again on the replica axis."""
    n_rep = states["key"].shape[0]
    ts = states["t"] if isinstance(states["t"], tuple) \
        else (states["t"],) * n_rep
    return eng.stack_states([
        unshard_state({k: ts[r] if k == "t" else v[r]
                       for k, v in states.items()}, spec, mesh)
        for r in range(n_rep)])


# ---------------------------------------------------------------------------
# one sharded timestep
# ---------------------------------------------------------------------------


def _apply_arrivals(f, ts, cfg, spec: ShardSpec, mesh: LPMesh, me, sd):
    """Complete in-flight migrations: a local one flips `lp` in place; a
    cross-shard one is packed, all-gathered and written into a free
    slot of its destination (the resharding op). Returns (fields,
    buffer overflow (..., Dl), slot overflow (...), wire (..., D, D) of
    the admitted cross-shard rows).

    Exact or loud: a leaver that does not fit the buffer, or whose
    destination has no free slot this step, keeps its slot and pending
    state and retries next step (arrivals test eta <= t). Every shard
    decides admission from the same gathered buffer and free counts, so
    a source vacates exactly the rows its destination writes. Free slots
    are counted before vacating: a slot freed this step is not handed to
    this step's arrivals."""
    B, C, D = spec.mig_cap, spec.cap, spec.n_dev
    gid, dst, eta = f["gid"], f["pending_dst"], f["pending_eta"]
    lead = gid.shape[:-2]
    due = (eta >= 0) & (eta <= ts) & (gid >= 0)
    home = dev_of_lp(dst.clamp(min=0), spec) == me[:, None]
    stay, leave = due & home, due & ~home
    f = dict(f)
    f["lp"] = torch.where(stay, dst, f["lp"])
    f["pending_dst"] = torch.where(stay, -1, dst)
    f["pending_eta"] = torch.where(stay, -1, eta)
    no = torch.zeros(lead, dtype=torch.bool, device=gid.device)
    if D == 1:  # every destination is local
        return f, torch.zeros(gid.shape[:-1], dtype=torch.bool,
                              device=gid.device), no, torch.zeros(
            lead + (1, 1), dtype=_I32, device=gid.device)

    # pack leavers in ascending slot order (a stable sort puts them
    # first), fill the rest of the buffer with blanks
    leaver = torch.argsort((~leave).to(torch.uint8), dim=-1,
                           stable=True)[..., :B]
    n_leave = leave.sum(-1)
    is_row = torch.arange(B, device=gid.device) < n_leave[..., None]
    mig_overflow = n_leave > B

    def pack(x, fill):
        v = _take(x, leaver)
        keep = is_row.reshape(is_row.shape + (1,) * (v.dim() - is_row.dim()))
        return torch.where(keep, v, fill)

    buf = {k: pack(f[k], -1 if k == "gid" else 0) for k in _ROW_FIELDS}
    buf["dst"] = pack(dst, -1)
    buf["ring"] = pack(f["ring"].movedim(-4, -2), 0)  # (..., Dl, B, w, L)

    # exchange; every shard takes the same admission decision
    g = {k: mesh.all_gather(v, sd).flatten(sd, sd + 1)
         for k, v in buf.items()}  # (..., D * B, ...)
    free = gid < 0
    free_counts = mesh.all_gather(free.sum(-1), sd)  # (..., D)
    g_dev = dev_of_lp(g["dst"].clamp(min=0), spec).long()
    g_valid = g["gid"] >= 0
    # rank of each buffer row among the rows bound for its destination
    per_dev = g_valid.unsqueeze(-2) & (g_dev.unsqueeze(-2) == torch.arange(
        D, device=gid.device)[:, None])
    rank = (per_dev.cumsum(-1) - 1).gather(-2, g_dev.unsqueeze(-2))[..., 0, :]
    admitted = g_valid & (rank < free_counts.gather(-1, g_dev))
    cap_overflow = (g_valid & ~admitted).any(-1)

    # the admitted cross-shard rows are the priced migration payload
    src_dev = torch.arange(D * B, device=gid.device) // B
    crossed = admitted & (g_dev != src_dev)
    row_bytes = _mig_row_bytes(f["ring"].shape[-4], spec.n_lp,
                               cfg.abm.workload == "epidemic")
    wire = torch.zeros(lead + (D * D,), dtype=_I32, device=gid.device)
    wire.scatter_add_(-1, (src_dev * D + g_dev).expand(crossed.shape),
                      crossed.to(_I32) * row_bytes)

    # vacate exactly the admitted leavers (deferred rows keep their slot
    # and pending state; the stale ring rows are inert: evaluate masks
    # by valid, and an arrival overwrites the whole row)
    adm_local = mesh.local_part(admitted.view(lead + (D, B)), sd)
    vacate = torch.zeros_like(leave).scatter(-1, leaver, is_row & adm_local)
    for k, v in (("gid", -1), ("lp", -1), ("pending_dst", -1),
                 ("pending_eta", -1), ("last_mig", -10**6), ("ptr", 0),
                 ("since_eval", 0)):
        f[k] = torch.where(vacate, v, f[k])

    # write the admitted rows bound for each shard into its free slots
    mine = admitted.unsqueeze(sd) & (g_dev.unsqueeze(sd) == me[:, None])
    free_order = torch.argsort((~free).to(torch.uint8), dim=-1, stable=True)
    arr_rank = (mine.cumsum(-1) - 1).clamp(0, C - 1)
    target = torch.where(mine, free_order.gather(-1, arr_rank), C)
    src = _arrival_sources(target, D * B, C)
    for k in _ROW_FIELDS:
        f[k] = _write_rows(f[k], src, g[k])
    f["lp"] = _write_rows(f["lp"], src, g["dst"])
    arrived = src < D * B
    f["pending_dst"] = torch.where(arrived, -1, f["pending_dst"])
    f["pending_eta"] = torch.where(arrived, -1, f["pending_eta"])
    f["ring"] = _write_ring(f["ring"], src, g["ring"])
    return f, mig_overflow, cap_overflow, wire.view(lead + (D, D))


def _gather_row_bytes(cfg) -> int:
    """Bytes a valid row costs in the id-order gathers a step makes
    (the flock's mobility, the periodic repartition)."""
    row_local = row_local_mobility(cfg.abm)
    grb = 0 if row_local else 20  # flock: pos + mob + gid
    if cfg.repartition_every > 0:
        # post-mobility pos + gid a valid row; gid rides the flock's
        # gather when there is one
        grb += 12 if row_local else 8
        if part.uses_prev(part.from_engine(cfg)):
            grb += 4  # hysteresis partitioners read the id-order map too
    return grb


def _place_local(x, mesh: LPMesh, sd: int, fill):
    """(..., D, ...): x at this process's shards, `fill` elsewhere (x
    itself on one process)."""
    if mesh.procs == 1:
        return x
    shape = list(x.shape)
    shape[sd] = mesh.n_dev
    out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    out.narrow(sd, mesh.first, mesh.local).copy_(x)
    return out


def _sharded_phases(cfg, spec: ShardSpec, mesh: LPMesh):
    """Ordered (name, fn, adds) phases of one sharded step, with the
    reference's names and cut points. Each fn maps the phase context
    `px` (the state under "st", the per-slot fields under "f", and what
    earlier phases added; `adds` names what this one adds) to a new
    one, as `engine.step_phases` does; finalize adds "new_state" and
    "metrics"."""
    abm = cfg.abm
    n, L, C, D = spec.n_se, spec.n_lp, spec.cap, spec.n_dev
    Dl = mesh.local
    epidemic = abm.workload == "epidemic"
    chunk = neighbors.chunk_entries(abm.mem_budget_mb)
    delay = cfg.migration_delay

    def flat(x):  # (..., Dl, C) -> (..., Dl * C): the heuristic's rows
        return x.flatten(-2)

    def ph_migrate(px):
        st = px["st"]
        dev = st["gid"].device
        sd = st["gid"].dim() - 2
        tv = px["tv"] if "tv" in px else eng.steps_on(st["t"], dev)
        key, k_move, k_send = trandom.split(st["key"], 3)
        me = mesh.axis_index(dev)
        f = {k: v for k, v in st.items() if k not in ("key", "t")}
        f, mig_ovf, cap_ovf, wire = _apply_arrivals(
            f, _slot_step(tv), cfg, spec, mesh, me, sd)
        valid = f["gid"] >= 0
        n_valid = valid.sum(-1, dtype=_I32)
        return dict(px, t=st["t"], tv=tv, key=key, k_move=k_move,
                    k_send=k_send, me=me, sd=sd, f=f, wire=wire,
                    reshard_overflow=mig_ovf, cap_overflow=cap_ovf,
                    valid=valid, safe_gid=f["gid"].clamp(0, n - 1),
                    n_valid=n_valid, all_valid=mesh.psum(n_valid, sd))

    def ph_mobility(px):
        # the row-local models draw full-size id-order arrays and each
        # slot takes its SE's rows (the same randomness wherever an SE
        # lives); the flock rebuilds the id-order state from a gather
        # and runs the oracle's own step
        f, valid, sg, sd = dict(px["f"]), px["valid"], px["safe_gid"], \
            px["sd"]
        dev = valid.device
        keep = valid[..., None]
        out = dict(px)
        if row_local_mobility(abm):
            draws, f["mob_g"] = mobility_row_draws(px["k_move"], n,
                                                   f["mob_g"], abm, dev)
            mine = {k: _select(v, sg) for k, v in draws.items()}
            pos, wp = mobility_row_apply(f["pos"], f["waypoint"], f["mob"],
                                         mine, abm)
            f["pos"] = torch.where(keep, pos, f["pos"])
            f["waypoint"] = torch.where(keep, wp, f["waypoint"])
        else:
            gid_all = mesh.all_gather(f["gid"], sd)
            tgt = torch.where(gid_all >= 0, gid_all, n).flatten(-2)
            pos_n = _to_id_order(
                mesh.all_gather(f["pos"], sd).flatten(sd, sd + 1), tgt, n,
                0.0)
            mob_n = _to_id_order(
                mesh.all_gather(f["mob"], sd).flatten(sd, sd + 1), tgt, n,
                0.0)
            # an open world's flock means leave out the ids no slot holds
            valid_n = _to_id_order(tgt < n, tgt, n, False) \
                if cfg.open_world else None
            pos_n, _, mob_n, f["mob_g"] = mobility_step(
                px["k_move"], pos_n, torch.zeros_like(pos_n), mob_n,
                f["mob_g"], abm, valid=valid_n)
            f["pos"] = torch.where(keep, _select(pos_n, sg), f["pos"])
            f["mob"] = torch.where(keep, _select(mob_n, sg), f["mob"])
            out["gid_all"] = gid_all
        if epidemic:
            u = _select(trandom.uniform(px["k_send"], (n,), device=dev), sg)
            sender = valid & (u < epidemic_send_prob(f["epi"], abm))
        else:
            sender = valid & _select(trandom.bernoulli(
                px["k_send"], abm.p_interact, (n,), device=dev), sg)
        out.update(f=f, sender=sender)
        return out

    def ph_halo(px):
        # assemble each shard's view: own rows, then what every peer
        # sent it; the epidemic ships a label a row (1 on infectious
        # senders, 0 on other live rows, -1 on padding)
        f, valid, wire, me, sd = px["f"], px["valid"], px["wire"], \
            px["me"], px["sd"]
        lead = valid.shape[:-2]
        if epidemic:
            own_labels = torch.where(
                valid, ((f["epi"] > 0) & px["sender"]).to(_I32), -1)
        if spec.grid is None:
            # dense fallback (a world too small to tessellate): every
            # position and LP to every shard
            out = dict(
                px, pos_g=mesh.all_gather(f["pos"], sd).flatten(sd, sd + 1),
                lp_g=mesh.all_gather(f["lp"], sd).flatten(sd, sd + 1),
                halo_overflow=torch.zeros(lead + (Dl,), dtype=torch.bool,
                                          device=valid.device),
                halo_n=px["all_valid"][..., None] - px["n_valid"])
            if D > 1:
                vcnt = mesh.all_gather(px["n_valid"], sd)
                out["wire"] = wire + vcnt[..., :, None] * _halo_row_bytes(
                    cfg) * _off_diag(D, wire.device)
            if epidemic:
                out["eis_g"] = mesh.all_gather(own_labels, sd).flatten(
                    sd, sd + 1)
            return out
        gspec = spec.grid
        ncells = gspec.ncell ** 2
        cellC = neighbors.cell_ids(f["pos"], gspec)
        halo_ovf = torch.zeros(lead + (Dl,), dtype=torch.bool,
                               device=valid.device)
        halo_n = torch.zeros(lead + (Dl,), dtype=_I32, device=valid.device)
        view_pos, view_lp = f["pos"], f["lp"]
        view_eis = own_labels if epidemic else None
        if D > 1:
            hc = spec.halo_cap
            # pack, for each peer, the rows its (one-step-stale,
            # dilated) need bitmap asks for: one stable sort over
            # (Dl, D, C)
            need = f["halo_need"].unsqueeze(sd).expand(lead + (Dl, D, ncells))
            cidx = torch.where(valid, cellC, 0).long().unsqueeze(-2)
            want = need.gather(-1, cidx.expand(lead + (Dl, D, C)))
            peer = torch.arange(D, device=me.device) != me[:, None]
            send = want & valid.unsqueeze(-2) & peer[..., None]
            cnt = send.sum(-1, dtype=_I32)  # (..., Dl, D)
            order = torch.argsort((~send).to(torch.uint8), dim=-1,
                                  stable=True)[..., :hc]
            is_row = torch.arange(hc, device=me.device) < cnt[..., None]
            rows = order.flatten(-2)
            shape = lead + (Dl, D, hc)
            send_pos = torch.where(is_row[..., None], _take(
                f["pos"], rows).view(shape + (2,)), 0.0)
            send_lp = torch.where(is_row, _take(f["lp"], rows).view(shape),
                                  -1)
            halo_ovf = (cnt > hc).any(-1)
            # the one same-step collective of the proximity path
            recv_pos = mesh.all_to_all(send_pos, sd).flatten(-3, -2)
            recv_lp = mesh.all_to_all(send_lp, sd).flatten(-2)
            view_pos = torch.cat([f["pos"], recv_pos], -2)
            view_lp = torch.cat([f["lp"], recv_lp], -1)
            if epidemic:
                send_eis = torch.where(
                    is_row, _take(own_labels, rows).view(shape), -1)
                view_eis = torch.cat(
                    [own_labels, mesh.all_to_all(send_eis, sd).flatten(-2)],
                    -1)
            wire = wire + mesh.all_gather(
                cnt.clamp(max=hc) * _halo_row_bytes(cfg), sd)
            # the exact halo: received rows inside the shard's true 3x3
            # need now (the exchange is sound, so all of them arrived)
            halo_n = ((recv_lp >= 0) & neighbors.halo_mask(
                neighbors.cell_ids(recv_pos, gspec), cellC, valid,
                gspec)).sum(-1, dtype=_I32)
        return dict(px, wire=wire, cellC=cellC, view_pos=view_pos,
                    view_lp=view_lp, view_eis=view_eis,
                    halo_overflow=halo_ovf, halo_n=halo_n)

    def grid_counts(px, labels, rows_mask, n_lp, grid=None):
        """The cell-list kernel over the stacked views (one launch for
        every shard and replica): `rows_mask` on own rows, none on halo
        rows; each shard keeps its first C rows."""
        vp = px["view_pos"]
        V = vp.shape[-2]
        mask = torch.cat([rows_mask, torch.zeros(
            rows_mask.shape[:-1] + (V - C,), dtype=torch.bool,
            device=vp.device)], -1)
        vp2, lab2 = vp.reshape(-1, V, 2), labels.reshape(-1, V)
        if grid is None:
            grid = neighbors.build_grid(vp2, spec.grid,
                                        valid=px["view_lp"].reshape(-1, V)
                                        >= 0)
        out = prox.proximity_lp_counts_grid(
            vp2, lab2, mask.reshape(-1, V), n_lp, abm.area,
            abm.interaction_range, spec.grid, grid, chunk)
        return out.view(labels.shape + (n_lp,))[..., :C, :], grid

    def dense_counts(px, labels_g, rows_mask, n_lp):
        """The dense kernel over the gathered world (one launch), with
        this process's rows asking; its shards' rows are kept."""
        sd = px["sd"]
        mask = _place_local(rows_mask, mesh, sd, False).flatten(sd, sd + 1)
        out = prox.proximity_lp_counts(px["pos_g"], labels_g, mask, n_lp,
                                       abm.area, abm.interaction_range)
        lead = rows_mask.shape[:-2]
        return mesh.local_part(out.view(lead + (D, C, n_lp)), sd)

    def ph_proximity(px):
        if spec.grid is not None:
            counts, grid = grid_counts(px, px["view_lp"], px["sender"], L)
            ovf = grid["overflow"].view(px["valid"].shape[:-1])
            return dict(px, counts=counts, grid_overflow=ovf, grid=grid)
        counts = dense_counts(px, px["lp_g"], px["sender"], L)
        return dict(px, counts=counts, grid_overflow=torch.zeros_like(
            px["halo_overflow"]))

    def ph_workload(px):
        # the epidemic over the views: exposure is one more 2-class
        # sweep (the shipped labels stand in for the oracle's id-order
        # ones, over the proximity phase's grid), and the SI/SIS update
        # takes full-size id-order draws by SE id
        f, valid = dict(px["f"]), px["valid"]
        epi = f["epi"]
        qmask = valid & (epi == 0)
        if spec.grid is not None:
            ex, _ = grid_counts(px, px["view_eis"], qmask, 2, px["grid"])
        else:
            ex = dense_counts(px, px["eis_g"], qmask, 2)
        draws = epidemic_draws(px["k_move"], n, abm, epi.device)
        mine = {k: _select(v, px["safe_gid"]) for k, v in draws.items()}
        new = epidemic_row_update(epi, ex[..., 1], mine, abm,
                                  infection_table(abm, epi.device))
        f["epi"] = torch.where(valid, new, epi)
        infected = mesh.psum(((f["epi"] > 0) & valid).sum(-1, dtype=_I32),
                             px["sd"])
        return dict(px, f=f, infected=infected)

    def ph_account(px):
        # the per-pair flow matrix is integer, so the sum over shards is
        # exactly the oracle's id-order one; the LCR terms derive from
        # it. Padding rows are non-senders: their LP-0 rows add nothing
        f = px["f"]
        safe_lp = f["lp"].clamp(0, L - 1)
        flows, local, total = eng.lp_flows(flat(safe_lp),
                                           px["counts"].flatten(-3, -2), L)
        if mesh.procs > 1:
            flows = mesh.allreduce(flows)
            local = flows.diagonal(dim1=-2, dim2=-1).sum(-1, dtype=_I32)
            total = flows.sum((-2, -1), dtype=_I32)
        zero = torch.zeros_like(local)
        return dict(px, safe_lp=safe_lp, flows=flows, local=local,
                    total=total, remote=total - local, migs=zero,
                    n_evals=zero, reparts=zero,
                    mig_flows=torch.zeros_like(flows))

    def pair_flows(src, dst, mask, like):
        return mesh.allreduce(eng._pair_add(torch.zeros_like(like),
                                            flat(src), flat(dst), flat(mask)))

    def ph_repartition(px):
        # the oracle's hook: rebuild the id-order positions, run the
        # same partitioner, and take each slot's SE back; the replicas
        # at their boundary only
        t, every = px["t"], cfg.repartition_every
        f, valid, sd = dict(px["f"]), px["valid"], px["sd"]
        lead = valid.shape[:-2]
        ts = t if isinstance(t, tuple) else (t,) * math.prod(lead)
        active = px.get("active") or (True,) * len(ts)
        due = [r for r, tr in enumerate(ts)
               if active[r] and tr > 0 and tr % every == 0]
        if not due:
            return px
        pcfg = part.from_engine(cfg)
        gid_all = px["gid_all"] if "gid_all" in px else \
            mesh.all_gather(f["gid"], sd)
        tgt = torch.where(gid_all >= 0, gid_all, n).flatten(-2)

        def id_order(x, fill):
            return _to_id_order(mesh.all_gather(x, sd).flatten(sd, sd + 1),
                                tgt, n, fill)
        pos_n = id_order(f["pos"], 0.0)
        prev = id_order(f["lp"], -1) if part.uses_prev(pcfg) else None
        # an open world's dead ids: weight 0 at position 0, as the
        # oracle feeds them
        weights = _to_id_order(torch.ones(tgt.shape, device=tgt.device),
                               tgt, n, 0.0) if cfg.open_world else \
            torch.ones(lead + (n,), device=tgt.device)
        keys = trandom.fold_in(px["k_move"], eng.REPART_SALT)

        def repartition(r):
            ix = (r,) if lead else ()
            new = part.partition(keys[ix], pos_n[ix], weights[ix], pcfg,
                                 prev=None if prev is None else prev[ix],
                                 compiled=True)
            return _select(new, px["safe_gid"][ix])
        if not lead:
            new_lp = repartition(0)
        else:
            new_lp = f["lp"].clone()
            for r in due:
                new_lp[r] = repartition(r)
        tvs = _slot_step(px["tv"])
        move = valid & (new_lp != f["lp"]) & (f["pending_dst"] < 0)
        f["pending_dst"] = torch.where(move, new_lp, f["pending_dst"])
        f["pending_eta"] = torch.where(move, tvs + delay, f["pending_eta"])
        f["last_mig"] = torch.where(move, tvs, f["last_mig"])
        reparts = mesh.psum(move.sum(-1, dtype=_I32), sd)
        return dict(px, f=f, reparts=reparts, migs=px["migs"] + reparts,
                    mig_flows=px["mig_flows"] + pair_flows(
                        px["safe_lp"], new_lp, move, px["flows"]))

    def ph_heuristic(px):
        # window update and evaluation are row-local; the balancer's
        # inputs are summed over the shards so every shard sees the same
        # grants, and selection stays shard-local (the candidates of a
        # pair all live on the shard of its source LP; the tie-break is
        # the SE id, the oracle's row order)
        f, tv = dict(px["f"]), px["tv"]
        lp, valid, safe_lp = flat(f["lp"]), flat(px["valid"]), \
            flat(px["safe_lp"])
        hstate = {"ring": f["ring"].flatten(-3, -2), "ptr": flat(f["ptr"]),
                  "since_eval": flat(f["since_eval"]),
                  "last_mig": flat(f["last_mig"])}
        hstate = heu.update_window(cfg.heuristic, hstate,
                                   px["counts"].flatten(-3, -2),
                                   flat(px["sender"]), tv)
        cand, dest, alpha, hstate, n_evals = heu.evaluate(
            cfg.heuristic, hstate, lp, tv, valid=valid, mf=px["mf"])
        pending_dst = flat(f["pending_dst"])
        cand = cand & (pending_dst < 0)
        cmat = mesh.allreduce(bal.candidate_matrix(cand, safe_lp, dest, L))
        if cfg.balance == "asymmetric":
            cap = torch.tensor(cfg.effective_capacity(), dtype=torch.float32,
                               device=lp.device)
            current = mesh.allreduce(bal.bincount(
                torch.where(valid, lp, L), L + 1)[..., :L])
            grants = bal.asymmetric_grants(cmat, current, cap)
        else:
            grants = bal.symmetric_grants(cmat)
        admit = bal.select_migrations(cand, safe_lp, dest, alpha, grants, L,
                                      tiebreak=flat(f["gid"]))
        shape = f["lp"].shape
        f["pending_dst"] = torch.where(admit, dest, pending_dst).view(shape)
        f["pending_eta"] = torch.where(admit, tv + delay, flat(
            f["pending_eta"])).view(shape)
        f["ring"] = hstate["ring"].view(f["ring"].shape)
        f["ptr"] = hstate["ptr"].view(shape)
        f["since_eval"] = hstate["since_eval"].view(shape)
        f["last_mig"] = torch.where(admit, tv, hstate["last_mig"]).view(
            shape)
        migs = mesh.allreduce(admit.sum(-1, dtype=_I32))
        return dict(px, f=f, n_evals=mesh.allreduce(n_evals),
                    migs=px["migs"] + migs,
                    mig_flows=px["mig_flows"] + pair_flows(
                        px["safe_lp"], dest.view(shape), admit.view(shape),
                        px["flows"]))

    def ph_finalize(px):
        f, valid, wire, sd = dict(px["f"]), px["valid"], px["wire"], \
            px["sd"]
        grb = _gather_row_bytes(cfg)
        if grb and D > 1:
            # the id-order gathers' valid rows are row payload too
            vcnt = mesh.all_gather(px["n_valid"], sd)
            wire = wire + vcnt[..., :, None] * grb * _off_diag(D, wire.device)
        if _sparse_halo(spec):
            # negotiate step t+1's halo on step t's tail: each shard's
            # post-mobility occupancy plus the cells of its rows pending
            # toward each destination, OR'd over the shards, dilated
            owner = px["me"][:, None].expand(valid.shape)
            fp = _footprint(flat(owner), flat(px["cellC"]), flat(valid),
                            flat(f["pending_dst"]), spec)
            f["halo_need"] = _need(mesh.allreduce(fp), spec, abm)
        local, total = px["local"].float(), px["total"].float()
        halo_total = mesh.psum(px["halo_n"], sd).float()
        remote_slots = ((D - 1) * px["all_valid"]).float()
        overflow = (px["reshard_overflow"] | px["grid_overflow"]
                    | px["halo_overflow"]).any(-1)
        overflow = mesh.allreduce(overflow) | px["cap_overflow"]
        metrics = {
            "local_msgs": local,
            "remote_msgs": px["remote"].float(),
            "migrations": px["migs"].float(),
            "heu_evals": px["n_evals"].float(),
            "lcr": div32(local, total.clamp(min=1.0)),
            "lp_flows": px["flows"],
            "mig_flows": px["mig_flows"],
            "repartitions": px["reparts"].float(),
            # the mean remote SEs a shard needs (its halo) as a share of
            # all remote SEs: GAIA's clustering drives it down
            "halo_frac": div32(halo_total, remote_slots.clamp(min=1.0)),
            "bytes_on_wire": wire.sum((-2, -1)).float(),
            "wire_flows": wire,
            "shard_overflow": overflow.float(),
        }
        if cfg.open_world:  # the live population after the arrivals
            metrics["pop"] = px["all_valid"].float()
        if epidemic:
            metrics["infected"] = px["infected"].float()
        t = px["t"]
        t = tuple(x + 1 for x in t) if isinstance(t, tuple) else t + 1
        new_state = dict(f, key=px["key"], t=t)
        return dict(px, f=f, new_state=new_state, metrics=metrics)

    halo_adds = ("cellC", "view_pos", "view_lp", "view_eis") \
        if spec.grid is not None else ("pos_g", "lp_g")
    halo_adds += ("halo_overflow", "halo_n")
    if epidemic and spec.grid is None:
        halo_adds += ("eis_g",)
    phases = [
        ("migrate", ph_migrate,
         ("t", "tv", "key", "k_move", "k_send", "me", "sd", "f", "wire",
          "reshard_overflow", "cap_overflow", "valid", "safe_gid",
          "n_valid", "all_valid")),
        ("mobility", ph_mobility, ("sender",) if row_local_mobility(abm)
         else ("sender", "gid_all")),
        ("halo_exchange", ph_halo, halo_adds),
        ("proximity", ph_proximity, ("counts", "grid_overflow")
         + (("grid",) if spec.grid is not None else ())),
        ("accounting", ph_account,
         ("safe_lp", "flows", "local", "total", "remote", "migs",
          "n_evals", "mig_flows", "reparts")),
    ]
    if epidemic:
        phases.insert(4, ("workload", ph_workload, ("infected",)))
    if cfg.repartition_every > 0:
        phases.append(("repartition", ph_repartition, ()))
    if cfg.gaia_on:
        phases.append(("heuristic", ph_heuristic, ()))
    phases.append(("finalize", ph_finalize, ("new_state", "metrics")))
    return phases


def _off_diag(D: int, device):
    return 1 - torch.eye(D, dtype=_I32, device=device)


@functools.lru_cache(maxsize=64)
def _phases_cached(cfg, procs: int, rank: int):
    spec, mesh = _layout(cfg, procs, rank)
    return [(name, fn) for name, fn, _ in _sharded_phases(cfg, spec, mesh)]


def sharded_phases(cfg):
    """Ordered (name, fn) phases of one sharded step, as
    `engine.step_phases` gives the oracle's (the same context protocol:
    "st" in, "new_state" and "metrics" out)."""
    procs, rank = world()
    if cfg.obs.enabled and procs > 1:
        raise ValueError("telemetry (obs.enabled) runs on one process; the "
                         f"world has {procs}")
    return _phases_cached(cfg, procs, rank)


def step_sharded(state, cfg, mf=None, tv=None, active=None):
    """One sharded timestep of one replica or a batch (the reference's
    `step_sharded` and `step_sharded_batch`): `engine.step`'s contract
    on sharded state; the metrics add halo_frac, bytes_on_wire,
    wire_flows and shard_overflow (and have no grid_overflow, as the
    reference's)."""
    px = {"st": state, "mf": mf, "active": active}
    if tv is not None:
        px["tv"] = tv
    for _, fn in sharded_phases(cfg):
        px = fn(px)
    return px["new_state"], px["metrics"]


# ---------------------------------------------------------------------------
# open-world churn (the sharded `engine.oracle_arrive` / `oracle_depart`)
# ---------------------------------------------------------------------------


def _vacate_slots(f, hit):
    """Free the slots `hit`: gid = lp = -1 and their whole history reset
    (ring included, as `engine.oracle_depart`)."""
    f = dict(f)
    for k, v in (("gid", -1), ("lp", -1), ("pending_dst", -1),
                 ("pending_eta", -1), ("last_mig", -10**6), ("ptr", 0),
                 ("since_eval", 0), ("epi", 0)):
        f[k] = torch.where(hit, v, f[k])
    f["ring"] = torch.where(hit.unsqueeze(-3)[..., None], 0, f["ring"])
    return f


def depart_sharded(state, cfg, ids):
    """Vacate the slots of the SE ids `ids` ((B,) int32 on the state's
    device; -1 is padding). Returns (state, found): the (B,) bool mask
    of the ids some slot held."""
    _, mesh = layout(cfg)
    gid = state["gid"]
    eq = (gid[..., None] == ids) & (gid >= 0)[..., None]  # (Dl, C, B)
    found = mesh.allreduce(eq.any(-2).any(0))
    return _vacate_slots(state, eq.any(-1)), found


def arrive_sharded(state, cfg, ids, rows):
    """Insert the SEs `ids` ((B,) int32 on the state's device; -1 is
    padding) into free slots of the shards owning rows["lp"]; `rows` as
    `engine.oracle_arrive` takes them. Each shard packs its arrivals
    into its free slots in ascending slot order. Returns (state,
    admitted): the (B,) bool mask; a refused arrival (no free slot on
    its shard) writes nothing. The admitted arrivals' cells are OR'd
    (dilated) into their owner's need bitmap, so the next step's
    exchange covers them."""
    spec, mesh = layout(cfg)
    C = spec.cap
    f = dict(state)
    dev = ids.device
    me = mesh.axis_index(dev)
    real = ids >= 0
    lps = rows["lp"]
    owner = dev_of_lp(lps.clamp(min=0), spec)
    mine = real & (owner == me[:, None])  # (Dl, B)
    free = f["gid"] < 0
    free_order = torch.argsort((~free).to(torch.uint8), dim=-1, stable=True)
    arr_rank = mine.cumsum(-1) - 1
    admitted = mine & (arr_rank < free.sum(-1, keepdim=True))
    target = torch.where(admitted, free_order.gather(
        -1, arr_rank.clamp(0, C - 1)), C)
    src = _arrival_sources(target, ids.shape[0], C)
    pos = rows["pos"]
    fills = {"pos": pos, "waypoint": rows.get("waypoint", pos),
             "mob": rows.get("mob", torch.zeros_like(pos)),
             "epi": rows.get("epi", torch.zeros_like(lps)),
             "gid": ids, "lp": lps}
    for k, v in fills.items():
        f[k] = _write_rows(f[k], src, v)
    arrived = src < ids.shape[0]
    for k, v in (("pending_dst", -1), ("pending_eta", -1), ("ptr", 0),
                 ("since_eval", 0), ("last_mig", -10**6)):
        f[k] = torch.where(arrived, v, f[k])
    f["ring"] = torch.where(arrived.unsqueeze(-3)[..., None], 0, f["ring"])
    if _sparse_halo(spec):
        # the negotiated bitmaps predate these arrivals; a departure only
        # shrinks the true need, so its stale superset stays sound
        fp = _footprint(torch.where(real, owner, spec.n_dev),
                        neighbors.cell_ids(pos, spec.grid), real,
                        torch.full_like(lps, -1), spec)
        f["halo_need"] = f["halo_need"] | _need(fp, spec, cfg.abm)
    return f, mesh.allreduce(admitted.any(0))
