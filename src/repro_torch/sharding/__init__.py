"""Logical sharding rules and activation constraints on a DeviceMesh."""
from repro_torch.sharding.logical import (  # noqa: F401
    DEFAULT_RULES, LogicalRules, placements, shard_specs, spec_for,
)
