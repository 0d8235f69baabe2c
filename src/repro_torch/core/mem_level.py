"""Memory tier — placeholder until the AFT/memory-tier slice of the port.

The write path catches :class:`MemTierError` (a collective budget refusal
of the RAM tier) around every tier write, so the name must resolve even
though no memory tier exists yet; :class:`~repro_torch.core.checkpoint.
Checkpoint` refuses a ``CRAFT_TIER_CHAIN`` that names ``mem``.
"""
from __future__ import annotations

from repro_torch.core.cpbase import CheckpointError


class MemTierError(CheckpointError):
    """The memory tier declined a version (budget exceeded on some rank)."""
