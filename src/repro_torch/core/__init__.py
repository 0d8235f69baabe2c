"""CRAFT core on PyTorch: application-level checkpoint/restart + automatic
fault tolerance (the paper's contribution as a composable library), ported
from ``repro.core``.

Public surface:
    Checkpoint, Box           — paper Listing 2 API
    CpBase, register_adapter  — extension mechanism (paper §2.3)
    aft_zone, AftZone         — AFT_BEGIN/AFT_END analog (paper §3)
    FTComm + backends         — ULFM-semantics communicator
    CraftEnv                  — paper Table 2 environment variables
    StorageTier               — storage backend interface (tiers & codec)
    metrics / telemetry       — live telemetry plane (/metrics, /healthz)

Not ported yet: the multi-process runtime (``repro.runtime``), the
JAX-mesh elastic helpers (``repro.core.elastic``) and the trace
simulate/tune loop.
"""
from repro_torch.core import metrics, telemetry
from repro_torch.core.aft import AftAbortedError, AftZone, aft_zone
from repro_torch.core.checkpoint import Checkpoint
from repro_torch.core.checkpointables import (
    Box, FuncCp, NdArrayCp, PodCp, PytreeCp, ShardCp, TorchTensorCp,
    register_adapter,
)
from repro_torch.core.comm import (
    CommError, FTComm, NullComm, ProcFailedError, RevokedError,
)
from repro_torch.core.cpbase import CheckpointError, CpBase, IOContext
from repro_torch.core.env import CraftEnv
from repro_torch.core.mem_level import MemFabric, MemStore, MemTierError
from repro_torch.core.scheduler import CheckpointPolicy, Decision, daly_interval
from repro_torch.core.tiers import StorageTier

__all__ = [
    "AftAbortedError", "AftZone", "aft_zone",
    "Checkpoint", "Box", "FuncCp", "NdArrayCp", "PodCp", "PytreeCp",
    "ShardCp", "TorchTensorCp", "register_adapter",
    "CommError", "FTComm", "NullComm", "ProcFailedError", "RevokedError",
    "CheckpointError", "CpBase", "IOContext", "CraftEnv", "StorageTier",
    "MemFabric", "MemStore", "MemTierError",
    "CheckpointPolicy", "Decision", "daly_interval",
    "metrics", "telemetry",
]
