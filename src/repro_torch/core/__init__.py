"""GAIA self-clustering core, ported to PyTorch: the evaluation model
with every mobility model and workload, one replica or a batch of R,
closed or open world, behind the resident service.

- abm: the evaluation model, §5.1 (mobility models, the epidemic
  workload, proximity counts)
- neighbors: cell-list neighbor search behind the proximity hot spot
- heuristics: self-clustering heuristics #1/#2/#3, §4.3
- balance: symmetric/asymmetric load balancing, §4.4
- partition: the SE -> LP partitioners (initial and periodic)
- engine: the timestepped adaptive-partitioning engine, §4
- service: the resident `Engine` facade (init / step / run / metrics,
  open-world churn, device-state queries), one replica or a batch, and
  `ReplicaService` (continuous batching of requests over the replicas)
- selftune: the §5.5 MF tuners (intra-run, batched, inter-run)
- costmodel, stats: host-only copies of the reference's modules
"""
from repro_torch.core.abm import (ABMConfig, MOBILITY_MODELS,  # noqa: F401
                                  PROXIMITY_BACKENDS)
from repro_torch.core.costmodel import (DISTRIBUTED, PARALLEL,  # noqa: F401
                                        SETUPS, CostParams,
                                        ExecutionEnvironment, make_env, wct,
                                        wct_env)
from repro_torch.core.engine import (EngineConfig,  # noqa: F401
                                     state_from_numpy, state_to_numpy)
from repro_torch.core.heuristics import HeuristicConfig  # noqa: F401
from repro_torch.core.neighbors import (GridSpec, build_grid,  # noqa: F401
                                        grid_lp_counts, make_grid_spec)
from repro_torch.core.partition import (PARTITION_BACKENDS,  # noqa: F401
                                        PartitionConfig)
from repro_torch.core.selftune import (SelfTuneConfig,  # noqa: F401
                                       inter_run_tune, intra_run_tune,
                                       intra_run_tune_batch)
from repro_torch.core.service import Engine, ReplicaService  # noqa: F401
from repro_torch.core.stats import (is_stats, merge_counters,  # noqa: F401
                                    percentile, replica_stats, summarize)

__all__ = [
    "ABMConfig", "EngineConfig", "HeuristicConfig", "PartitionConfig",
    "Engine", "ReplicaService",
    "MOBILITY_MODELS", "PROXIMITY_BACKENDS", "PARTITION_BACKENDS",
    "SETUPS", "DISTRIBUTED", "PARALLEL", "CostParams",
    "ExecutionEnvironment", "make_env", "wct", "wct_env",
    "GridSpec", "build_grid", "grid_lp_counts", "make_grid_spec",
    "state_from_numpy", "state_to_numpy",
    "merge_counters", "replica_stats", "summarize", "is_stats",
    "percentile", "SelfTuneConfig", "intra_run_tune",
    "intra_run_tune_batch", "inter_run_tune",
]
