"""Parallel execution: the LM stack's (`ctx.ParallelCtx` and `make_ctx`,
`sharding`'s layouts, `pipeline`'s GPipe) and the engine's across LP
shards: `mesh.LPMesh` (the shard axis and its collectives), `lp_shard`
(the LP-per-device engine) and `multihost` (the `torch.distributed`
launcher).

`ParallelCtx`, `make_ctx`, `ShardSpec`, `make_shard_spec` and
`run_sharded` are the names the reference's `repro.parallel` exports."""
from repro_torch.parallel.ctx import ParallelCtx, make_ctx  # noqa: F401
from repro_torch.parallel.lp_shard import (  # noqa: F401
    ShardSpec, make_shard_spec, run_sharded)

__all__ = ["ParallelCtx", "make_ctx", "ShardSpec", "make_shard_spec",
           "run_sharded"]
