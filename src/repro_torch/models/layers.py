"""Shared layer primitives: RMSNorm, RoPE, SwiGLU MLP, embedding.

The reference's ``repro/models/layers.py`` on tensors.  Random weights come
from an explicit ``torch.Generator`` through :class:`Init`; they do not
reproduce ``jax.random``'s bits (tests carry the reference's weights over
with ``convert.params_from_numpy``).  Rounding follows the reference:
``rms_norm`` and ``apply_rope`` compute in float32 and round to the input's
dtype once, at the end.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from repro_torch.sharding.activations import gather_rows, is_dtensor

_SQRT2 = math.sqrt(2.0)
# the standard normal CDF at -2 and 2: the truncation bounds in [0, 1]
_LO = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
_HI = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))


class Init:
    """Where parameters are made: a ``torch.Generator`` and its device.

    On the ``meta`` device no random number is drawn (``gen`` may be None):
    the tree then carries only shapes and dtypes, which is how
    ``convert.params_from_numpy`` checks a tree without allocating one.
    """

    def __init__(self, gen: Optional[torch.Generator], device="cuda"):
        self.device = torch.device(device)
        self.gen = gen
        if self.device.type != "meta":
            if gen is None:
                raise ValueError("Init: a torch.Generator is required off "
                                 "the meta device")
            if torch.device(gen.device).type != self.device.type:
                raise ValueError(f"Init: generator on {gen.device}, "
                                 f"parameters on {self.device}")

    @property
    def meta(self) -> bool:
        return self.device.type == "meta"

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=dtype,
                          device=self.device)


# ---------------------------------------------------------------- helpers
# elements above which dense_init draws a tensor slab by slab (a deepseek
# expert stack, 256 x 7168 x 2048, would take 15 GB in float32 at once)
_SLAB = 1 << 30


def dense_init(ini: Init, shape, in_dim: int, dtype) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(in_dim), drawn in
    float32 on the device and rounded to ``dtype`` (one tensor at a time,
    so a 7B tree never exists in float32; a tensor of more than 2^30
    elements one slab of its leading axis at a time)."""
    shape = tuple(shape)
    if ini.meta:
        return torch.empty(shape, dtype=dtype, device=ini.device)
    if math.prod(shape) > _SLAB and shape[0] > 1:
        out = torch.empty(shape, dtype=dtype, device=ini.device)
        rows = max(1, shape[0] * _SLAB // (4 * math.prod(shape)))
        for i in range(0, shape[0], rows):
            out[i:i + rows] = dense_init(
                ini, (min(rows, shape[0] - i), *shape[1:]), in_dim, dtype)
        return out
    u = torch.empty(shape, dtype=torch.float32, device=ini.device)
    u.uniform_(2.0 * _LO - 1.0, 2.0 * _HI - 1.0, generator=ini.gen)
    x = u.erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0)
    return x.mul_(1.0 / math.sqrt(max(1, in_dim))).to(dtype)


def stack_init(init_fn, ini: Init, n: int):
    """``n`` layers of ``init_fn(ini)`` stacked on a leading axis.  The
    stacked leaves are allocated once and filled layer by layer, so the
    peak is the stack plus one layer (one layer is its own stack)."""
    first = init_fn(ini)
    if n == 1:
        return pytree.tree_map(lambda x: x.unsqueeze(0), first)
    out = pytree.tree_map(
        lambda x: torch.empty((n, *x.shape), dtype=x.dtype, device=x.device),
        first)
    if ini.meta:
        return out
    layer = first
    for i in range(n):
        if i:
            layer = init_fn(ini)
        pytree.tree_map(lambda dst, src: dst[i].copy_(src), out, layer)
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., L, D even); positions: (L,) or (B, L)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                     # (D/2,)
    ang = positions.to(torch.float32)[..., None] * inv       # (..., L, D/2)
    while ang.dim() < x.dim():
        ang = ang[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([xf1 * cos - xf2 * sin, xf1 * sin + xf2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------- embedding
def embed_init(ini: Init, cfg):
    return {"embedding": dense_init(ini, (cfg.vocab, cfg.d_model),
                                    cfg.d_model, cfg.dtype)}


def embed_logical(cfg):
    return {"embedding": ("vocab", "embed")}


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embedding"]
    if is_dtensor(table):
        return gather_rows(table, tokens)
    return table[tokens.long()]


def unembed_apply(params, x: torch.Tensor, fp32: bool = True) -> torch.Tensor:
    logits = x @ params["embedding"].t()                     # (B, L, V)
    return logits.float() if fp32 else logits


# ---------------------------------------------------------------- SwiGLU MLP
def mlp_init(ini: Init, cfg, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(ini, (d, f), d, cfg.dtype),
        "w_up": dense_init(ini, (d, f), d, cfg.dtype),
        "w_down": dense_init(ini, (f, d), f, cfg.dtype),
    }


def mlp_logical(cfg):
    return {
        "w_gate": ("embed", "mlp"),
        "w_up": ("embed", "mlp"),
        "w_down": ("mlp", "embed"),
    }


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]
