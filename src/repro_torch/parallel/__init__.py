"""Execution across LP shards: `mesh.LPMesh` (the shard axis and its
collectives), `lp_shard` (the LP-per-device engine) and `multihost`
(the `torch.distributed` launcher).

`ShardSpec`, `make_shard_spec` and `run_sharded` are the names the
reference's `repro.parallel` exports for the sharded engine."""
from repro_torch.parallel.lp_shard import (  # noqa: F401
    ShardSpec, make_shard_spec, run_sharded)

__all__ = ["ShardSpec", "make_shard_spec", "run_sharded"]
