"""The "lp" mesh: D shards spread over P processes, and its collectives
(the port's stand-in for `jax.sharding.Mesh` and the `jax.lax`
collectives the reference's `shard_map` body calls).

Each process holds `Dl = D / P` shards on its one device, stacked on a
shard axis of every per-shard tensor: (Dl, C, ...) for one replica,
(R, Dl, C, ...) for a batch. Process p holds shards [p * Dl, (p + 1) *
Dl). A collective takes the position of that axis (`sd`):

  psum        a sum over the local shard axis, then `all_reduce` across
              processes (the reference's psums are all over integers or
              bools, so the result is exact and order-free)
  all_gather  the (..., D, ...) stack of every shard's tensor (tiled:
              callers reshape (D, C) to D * C)
  all_to_all  recv[d, s] = send[s, d] over the (src, dst) shard axes

With P = 1 (one process, the card's case) no `torch.distributed` call
is made: a psum is a local sum, an all_gather returns its input, an
all_to_all is a transpose. Across processes the calls go through the
default process group, which the caller initialises
(`multihost.py`; gloo on the CPU).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


def world() -> tuple:
    """(P, p): the process count and this process's rank of the default
    process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _wire(x):
    """A tensor as a collective sends it (gloo has no bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


@dataclasses.dataclass(frozen=True)
class LPMesh:
    n_dev: int  # D: shards on the mesh
    procs: int = 1  # P: processes
    rank: int = 0  # p: this process

    def __post_init__(self):
        if self.n_dev % self.procs:
            raise ValueError(
                f"n_devices={self.n_dev} is not a multiple of the "
                f"{self.procs} processes of the world")

    @property
    def local(self) -> int:
        """Dl: the shards this process holds."""
        return self.n_dev // self.procs

    @property
    def first(self) -> int:
        """The mesh index of this process's first shard."""
        return self.rank * self.local

    def axis_index(self, device):
        """(Dl,) int32: the mesh index of each local shard."""
        return torch.arange(self.first, self.first + self.local,
                            dtype=torch.int32, device=device)

    def local_part(self, x, sd: int = 0):
        """This process's shards of a (..., D, ...) stack (a view)."""
        return x.narrow(sd, self.first, self.local)

    def allreduce(self, x):
        """x summed over the processes (x itself when P = 1)."""
        if self.procs == 1:
            return x
        y = _wire(x).clone()
        if y.dtype == torch.uint8:
            y = y.to(torch.int32)
        dist.all_reduce(y)
        return y.to(x.dtype) if x.dtype != torch.bool else y > 0

    def psum(self, x, sd: int = 0):
        """The sum over every shard of x's shard axis `sd` (integers)."""
        return self.allreduce(x.sum(sd, dtype=x.dtype))

    def all_gather(self, x, sd: int = 0):
        """(..., D, ...): every shard's slice of x, in mesh order."""
        if self.procs == 1:
            return x
        y = _wire(x).movedim(sd, 0).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.procs)]
        dist.all_gather(parts, y)
        out = torch.cat(parts, 0).movedim(0, sd)
        return out.bool() if x.dtype == torch.bool else out

    def all_to_all(self, x, sd: int = 0):
        """recv[..., d, s, ...] = send[..., s, d, ...] for x's source
        shard axis `sd` (Dl local) and destination axis `sd + 1` (D):
        the result holds, for each local destination shard, what every
        source shard sent it."""
        if self.procs == 1:
            return x.transpose(sd, sd + 1)
        P, Dl = self.procs, self.local
        y = _wire(x).movedim((sd, sd + 1), (0, 1))
        rest = y.shape[2:]
        # [q][s][d_q]: the blocks bound for each process q in turn
        send = y.reshape((Dl, P, Dl) + rest).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        # recv[q][s_q][d]: from process q's shard s_q to local shard d
        out = recv.permute((2, 0, 1) + tuple(range(3, recv.dim())))
        out = out.reshape((Dl, self.n_dev) + rest).movedim((0, 1),
                                                          (sd, sd + 1))
        return out.bool() if x.dtype == torch.bool else out


def make_mesh(n_dev: int) -> LPMesh:
    """The mesh of D shards over the default process group's world."""
    procs, rank = world()
    return LPMesh(n_dev=n_dev, procs=procs, rank=rank)
