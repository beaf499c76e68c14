"""The TD-Orch core on PyTorch: task-data orchestration (Fig. 1) and the
TD-Orch engine (§3) — communication forest + meta-task sets + distributed
push-pull + merge-able write-backs — plus the §2.3 baselines, the
cost-model-driven `engine="auto"` policy, reusable Orchestrator sessions,
declarative multi-round `StagePlan`s, hot-chunk replication and the elastic
subsystem (live chunk migration, Phase-3 work stealing, stage-boundary
failure recovery). Numerics run on the CUDA card through
`TorchBackend` (the default backend), over a mesh of one shard a machine
through `TorchSpmdBackend` (``backend="torch_spmd"``), or on the host
through the float64 numpy oracle; the cost model is host-side numpy and bit-identical across
backends."""
from .backend import (NumpyBackend, TorchBackend, TorchSpmdBackend,
                      make_backend)
from .comm_forest import CommForest, theory_fanout
from .config import KWARG_ALIASES, SessionConfig, resolve_session_config
from .cost import (ELASTIC_PHASES, CostAccumulator, PhaseCost, SessionReport,
                   StageReport, assert_cost_parity, assert_session_parity)
from .datastore import DataStore, ShardLayout, TaskBatch
from .elasticity import (ElasticityConfig, ElasticityManager, MigrationConfig,
                         MigrationPlanner, RecoveryConfig, RecoveryManager,
                         StealConfig, WorkStealer, make_elasticity)
from .engine import OrchestrationResult, TDOrchEngine
from .baselines import DirectPullEngine, DirectPushEngine, SortBasedEngine
from .execution import gather_values
from .fusedlam import FUSED_READ_OPS, FusedStageLambda, fused_read
from .interface import ENGINES, make_engine, orchestration, register_engine
from .mergeops import MERGE_OPS, MergeOp, get_merge_op
from .plan import CARRY, LoopRecord, PlanResult, PlanState, StagePlan
from .policy import (AutoEngine, PhaseCostEstimate, PolicyConfig,
                     PolicyDecision, StageLayout, StagePolicy)
from .replication import (HotChunkReplicator, ReplicaSet, ReplicationConfig,
                          make_replicator)
from .session import Orchestrator

__all__ = [
    "NumpyBackend", "TorchBackend", "TorchSpmdBackend", "make_backend",
    "CommForest", "theory_fanout",
    "KWARG_ALIASES", "SessionConfig", "resolve_session_config",
    "CostAccumulator", "PhaseCost", "SessionReport", "StageReport",
    "assert_cost_parity", "assert_session_parity", "ELASTIC_PHASES",
    "DataStore", "ShardLayout", "TaskBatch",
    "ElasticityConfig", "ElasticityManager", "MigrationConfig",
    "MigrationPlanner", "RecoveryConfig", "RecoveryManager",
    "StealConfig", "WorkStealer", "make_elasticity",
    "OrchestrationResult", "TDOrchEngine",
    "DirectPullEngine", "DirectPushEngine", "SortBasedEngine",
    "gather_values",
    "FUSED_READ_OPS", "FusedStageLambda", "fused_read",
    "ENGINES", "make_engine", "orchestration", "register_engine",
    "MERGE_OPS", "MergeOp", "get_merge_op",
    "CARRY", "LoopRecord", "PlanResult", "PlanState", "StagePlan",
    "AutoEngine", "PhaseCostEstimate", "PolicyConfig", "PolicyDecision",
    "StageLayout", "StagePolicy",
    "HotChunkReplicator", "ReplicaSet", "ReplicationConfig", "make_replicator",
    "Orchestrator",
]
