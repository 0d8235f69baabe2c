"""Deterministic synthetic token pipeline with a checkpointable cursor.

A copy of ``repro/data/pipeline.py`` (numpy only): the same ``(seed, step,
shard)`` gives the same batch, bit for bit, in both packages.

Counter-based (Philox) generation makes the stream a pure function of
``(seed, step, shard)``: restart from a checkpointed cursor reproduces the
exact batch sequence — no filesystem state, no iterator pickling — and each
data-parallel process generates only its own shard (host data loading).

The "tokens" follow a Zipfian-ish distribution (realistic embedding-gather
skew) with ``labels = tokens shifted left`` (next-token prediction).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


class DataCursor:
    """Checkpointable position in the stream (add to a Checkpoint as POD)."""

    __slots__ = ("step",)

    def __init__(self, step: int = 0):
        self.step = step


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"{self.n_shards} shards")
        self.local_batch = self.global_batch // self.n_shards

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The (step, shard) batch: {"tokens", "labels"} of (local_B, L)."""
        rng = np.random.Generator(np.random.Philox(
            key=[(self.seed << 32) | (step & 0xFFFFFFFF),
                 (self.shard << 32) | 0xC0FFEE]))
        raw = rng.zipf(self.zipf_a, size=(self.local_batch, self.seq_len + 1))
        tokens = (raw - 1) % self.vocab
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def batches(self, cursor: DataCursor, n: Optional[int] = None):
        """Iterate from the cursor, advancing it (resume-exact)."""
        produced = 0
        while n is None or produced < n:
            yield self.batch(cursor.step)
            cursor.step += 1
            produced += 1
