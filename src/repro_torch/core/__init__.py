"""GAIA self-clustering core, ported to PyTorch (main path: one
closed-world replica of the rwp model).

- abm: the evaluation model, §5.1 (rwp mobility + proximity counts)
- neighbors: cell-list neighbor search behind the proximity hot spot
- heuristics: self-clustering heuristics #1/#2/#3, §4.3
- balance: symmetric/asymmetric load balancing, §4.4
- partition: the initial SE -> LP map ("random")
- engine: the timestepped adaptive-partitioning engine, §4
- service: the `Engine` facade (init / step / run / metrics)
- costmodel, stats: host-only copies of the reference's modules
"""
from repro_torch.core.abm import (ABMConfig, MOBILITY_MODELS,  # noqa: F401
                                  PROXIMITY_BACKENDS)
from repro_torch.core.costmodel import (DISTRIBUTED, PARALLEL,  # noqa: F401
                                        SETUPS, CostParams,
                                        ExecutionEnvironment, wct)
from repro_torch.core.engine import (EngineConfig,  # noqa: F401
                                     state_from_numpy, state_to_numpy)
from repro_torch.core.heuristics import HeuristicConfig  # noqa: F401
from repro_torch.core.neighbors import (GridSpec, build_grid,  # noqa: F401
                                        grid_lp_counts, make_grid_spec)
from repro_torch.core.partition import (PARTITION_BACKENDS,  # noqa: F401
                                        PartitionConfig)
from repro_torch.core.service import Engine, ReplicaService  # noqa: F401
from repro_torch.core.stats import (merge_counters,  # noqa: F401
                                    replica_stats, summarize)

__all__ = [
    "ABMConfig", "EngineConfig", "HeuristicConfig", "PartitionConfig",
    "Engine", "ReplicaService",
    "MOBILITY_MODELS", "PROXIMITY_BACKENDS", "PARTITION_BACKENDS",
    "SETUPS", "DISTRIBUTED", "PARALLEL", "CostParams",
    "ExecutionEnvironment", "wct",
    "GridSpec", "build_grid", "grid_lp_counts", "make_grid_spec",
    "state_from_numpy", "state_to_numpy",
    "merge_counters", "replica_stats", "summarize",
]
