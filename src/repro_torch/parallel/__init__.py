"""Execution across LP shards: `mesh.LPMesh` (the shard axis and its
collectives), `lp_shard` (the LP-per-device engine) and `multihost`
(the `torch.distributed` launcher)."""
