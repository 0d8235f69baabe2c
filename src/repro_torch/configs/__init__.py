"""Architecture registry + assigned input shapes (40 cells).

``--arch <id>`` resolution, the four assigned shapes, and the cell matrix
with the sanctioned ``long_500k`` skips (pure full-attention archs cannot
decode a 524k dense KV cache sub-quadratically; SSM / hybrid / SWA archs
run it — see DESIGN.md §4).

A copy of ``repro/configs`` (the reference's registry imports
``repro.models.common``, which imports JAX), with the same ids and shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.configs import (
    deepseek_v3_671b,
    falcon_mamba_7b,
    glm4_9b,
    h2o_danube_1p8b,
    kimi_k2_1t_a32b,
    llava_next_34b,
    musicgen_medium,
    phi4_mini_3p8b,
    yi_34b,
    zamba2_2p7b,
    zamba2_7b,
)
from repro_torch.models.common import ModelConfig

_MODULES = {
    "zamba2-2.7b": zamba2_2p7b,
    "musicgen-medium": musicgen_medium,
    "falcon-mamba-7b": falcon_mamba_7b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "yi-34b": yi_34b,
    "h2o-danube-1.8b": h2o_danube_1p8b,
    "glm4-9b": glm4_9b,
    "llava-next-34b": llava_next_34b,
}

ARCH_IDS = tuple(_MODULES)

#: architectures of the port alone (the reference's registry has none of
#: them): resolved by ``get_config``, outside the dry-run's cell matrix
PORT_ONLY = ("zamba2-7b",)
_MODULES["zamba2-7b"] = zamba2_7b


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: archs with sub-quadratic attention state — the only ones long_500k runs on
SUBQUADRATIC = ("zamba2-2.7b", "falcon-mamba-7b", "h2o-danube-1.8b")


#: runtime-registered configs (user presets, e.g. the 100M example model)
_EXTRA: Dict[str, tuple] = {}


def register_config(arch_id: str, cfg: ModelConfig,
                    tiny: Optional[ModelConfig] = None) -> None:
    """Register a custom architecture so ``--arch <id>`` resolves to it."""
    _EXTRA[arch_id] = (cfg, tiny if tiny is not None else cfg)


def get_config(arch_id: str, tiny: bool = False) -> ModelConfig:
    if arch_id in _EXTRA:
        return _EXTRA[arch_id][1 if tiny else 0]
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{', '.join(ARCH_IDS + PORT_ONLY)}")
    mod = _MODULES[arch_id]
    return mod.TINY if tiny else mod.CONFIG


def cell_supported(arch_id: str, shape: str) -> Tuple[bool, Optional[str]]:
    """(supported, reason-if-skipped) for one (arch × shape) cell."""
    if shape == "long_500k" and arch_id not in SUBQUADRATIC:
        return False, ("pure full-attention arch: a 524k dense KV decode is "
                       "not sub-quadratic (sanctioned skip, DESIGN.md §4)")
    return True, None


def cells(include_skipped: bool = False) -> Iterator[Tuple[str, str]]:
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, _ = cell_supported(arch, shape)
            if ok or include_skipped:
                yield arch, shape
