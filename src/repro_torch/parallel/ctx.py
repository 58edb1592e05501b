"""Parallel execution context — the port of `repro.parallel.ctx`.

``ParallelCtx`` carries the mesh and the layout policy through the model
code, with the reference's fields, in its order, with its defaults.
Axis convention (see launch/mesh.py):

    single-pod : ("data", "model")            = (16, 16)
    multi-pod  : ("pod", "data", "model")     = (2, 16, 16)

Batch is sharded over ("pod", "data"); tensor-parallel dims over
"model".

PyTorch has no partitioner, so a mesh here means what
`parallel/sharding.py` spells out: each rank stores its blocks of the
parameters (and under `zero1` of the optimizer state) under the
reference's specs, gathers a layer's weights where it uses them, and
computes the rows `batch_spec` gives its coordinates. `constrain` is
therefore a check of rank and nothing more.

The fields the port reads: `mesh`, `batch_axes`, `model_axis`,
`num_microbatches`, `remat`, `zero1`, `fsdp`, `ep2d`, `grad_dtype`,
`loss_chunk`, `optimizer` and `seq_parallel` (through `seq_entry`, for
the layouts). `seq_shard_attn`, `use_pallas`, `q_block`, `kv_block`,
`causal_skip` and `scan_unroll` size or schedule the reference's jnp
attention and its cost lowering; they keep their defaults and change
nothing here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh

AxisEntry = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry a dim (None, an axis name, or a tuple
    of names, the first major), compared as a tuple; `P()` is `()`."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of jax's NamedSharding)."""
    mesh: Mesh
    spec: P


def axes_of(entry: AxisEntry) -> Tuple[str, ...]:
    """The axis names of a spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[Mesh]
    batch_axes: Tuple[str, ...]  # ("pod","data") or ("data",) or ()
    model_axis: Optional[str]  # "model" or None
    # --- layout / schedule policy knobs
    seq_shard_attn: bool = False  # qwen2 fallback: shard S instead of heads
    # sequence parallelism: the residual stream's layout between blocks
    seq_parallel: bool = True
    num_microbatches: int = 1
    remat: str = "full"  # "none" | "full" | "dots"
    zero1: bool = True
    use_pallas: bool = False
    # attention flash block sizes (the reference's jnp path)
    q_block: int = 512
    kv_block: int = 1024
    # causal scheduling: skip fully-masked KV blocks
    causal_skip: bool = True
    # unroll inner scans (the reference's cost lowering only)
    scan_unroll: bool = False
    # FSDP-style weight sharding: every param additionally shards its
    # largest free dim over the data axes (gathered at use)
    fsdp: bool = False
    # 2-D expert parallelism: experts shard over (data x model) jointly;
    # grouped EP when E doesn't divide the joint axis size
    ep2d: bool = False
    # gradient accumulator dtype ("f32" | "bf16")
    grad_dtype: str = "f32"
    # sequence-chunked cross-entropy (0 = off)
    loss_chunk: int = 0
    # optimizer: "adamw" | "adafactor" | "adafactor_lean"
    optimizer: str = "adamw"

    # ------------------------------------------------------------------
    @property
    def data_size(self) -> int:
        if self.mesh is None:
            return 1
        if not self.batch_axes:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.batch_axes)

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def n_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    @property
    def ep_axes(self) -> AxisEntry:
        """Expert-parallel axes: innermost data axis + model axis (pods
        replicate experts)."""
        if self.mesh is None or self.model_axis is None:
            return None
        if self.batch_axes:
            return (self.batch_axes[-1], self.model_axis)
        return self.model_axis

    # ------------------------------------------------------------------
    def constrain(self, x: torch.Tensor, *spec: AxisEntry) -> torch.Tensor:
        """The reference's sharding constraint: checks the spec's rank
        against x's and returns x. There is no partitioner to hint; the
        train step applies the layouts itself (`parallel/sharding.py`)."""
        if self.mesh is None:
            return x
        assert len(spec) == x.dim(), (spec, tuple(x.shape))
        return x

    def sharding(self, *spec: AxisEntry) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, P(*spec))

    # ------------------------------------------------------------------
    def axis_size(self, entry: AxisEntry) -> int:
        if entry is None or self.mesh is None:
            return 1
        if isinstance(entry, str):
            return self.mesh.shape[entry]
        return math.prod(self.mesh.shape[a] for a in entry)

    def shard_if(self, dim: int, entry: AxisEntry) -> AxisEntry:
        """Return `entry` if `dim` divides its total size, else None."""
        n = self.axis_size(entry)
        return entry if (n > 1 and dim % n == 0) else None

    def batch_spec(self, batch: int) -> AxisEntry:
        """Largest prefix of the batch axes that divides `batch`."""
        if self.mesh is None or not self.batch_axes:
            return None
        axes = []
        prod = 1
        for a in self.batch_axes:
            if batch % (prod * self.mesh.shape[a]) == 0:
                axes.append(a)
                prod *= self.mesh.shape[a]
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    def seq_entry(self, seq: int) -> AxisEntry:
        """Sequence-parallel residual sharding (None when off/indivisible)."""
        if not self.seq_parallel:
            return None
        return self.shard_if(seq, self.model_axis)

    def seq_mega_spec(self, seq: int) -> AxisEntry:
        """Shard a long sequence over every available axis (long_500k KV)."""
        if self.mesh is None:
            return None
        axes = tuple(self.batch_axes) + ((self.model_axis,)
                                         if self.model_axis else ())
        prod = math.prod(self.mesh.shape[a] for a in axes)
        if axes and seq % prod == 0:
            return axes
        return self.shard_if(seq, self.model_axis)

    # ------------------------------------------------------------------
    # the port's collectives over a live mesh (no-ops without one)
    @property
    def distributed(self) -> bool:
        """True on a mesh that spans `torch.distributed` processes."""
        return self.mesh is not None and self.mesh.distributed

    def index(self, entry: AxisEntry) -> int:
        """This rank's block index along `entry` (0 without a mesh)."""
        if self.mesh is None or not self.mesh.live:
            return 0
        return self.mesh.index(axes_of(entry))

    def row_sum(self, x: torch.Tensor, entry: AxisEntry) -> torch.Tensor:
        """x summed over the ranks that hold the other rows of a batch
        sharded by `entry` (a new tensor, outside autograd; x itself
        where nothing is summed)."""
        if not self.distributed or entry is None:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, group=self.mesh.group(axes_of(entry)))
        return y

    def row_gather(self, x: torch.Tensor, entry: AxisEntry) -> torch.Tensor:
        """(n, *x.shape): x of every rank along `entry`, in block order
        (x[None] where nothing is gathered); outside autograd."""
        if not self.distributed or entry is None:
            return x[None]
        parts = [torch.empty_like(x) for _ in range(self.axis_size(entry))]
        dist.all_gather(parts, x.detach().contiguous(),
                        group=self.mesh.group(axes_of(entry)))
        return torch.stack(parts)


def make_ctx(mesh: Optional[Mesh], **kw) -> ParallelCtx:
    """Build a ParallelCtx from a mesh created by launch.mesh."""
    if mesh is None:
        return ParallelCtx(mesh=None, batch_axes=(), model_axis=None, **kw)
    names = mesh.axis_names
    if names == ("pod", "data", "model"):
        return ParallelCtx(mesh, ("pod", "data"), "model", **kw)
    if names == ("data", "model"):
        return ParallelCtx(mesh, ("data",), "model", **kw)
    if names == ("data",):
        return ParallelCtx(mesh, ("data",), None, **kw)
    raise ValueError(f"unrecognized mesh axes {names}")
