"""Bytes of a Zamba2 training state from the published widths: what one
checkpoint version of the memory tier holds and what a restore copies onto
the card."""
from __future__ import annotations

from bench.reference.zamba2 import n_params


def float32_params(hp: dict) -> int:
    """The parameters kept in float32 whatever the weights' dtype: each
    mamba layer's per-head dt_bias, A_log and D."""
    heads = int(hp["mamba_expand"]) * int(hp["hidden_size"]) \
        // int(hp["mamba_headdim"])
    return int(hp["num_hidden_layers"]) * 3 * heads


def version_bytes(hp: dict, weight_bytes: int = 2) -> int:
    """The training state's tensors: every weight in bfloat16 (the per-head
    scalars in float32) and AdamW's float32 m and v for each (no float32
    master copy, as launch.train sets it); the step counts and the
    data cursor add bytes only."""
    n, f32 = n_params(hp), float32_params(hp)
    return weight_bytes * (n - f32) + 4 * f32 + 8 * n
