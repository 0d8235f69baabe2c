"""AdamW on parameter trees, with an 8-bit state option (the reference's
``repro/optim/adamw.py``).

8-bit moments (``state_bits=8``): blockwise absmax int8 quantization
(block = last axis) of m and v for every leaf whose last axis has at least
4 values, dequantized on use.  The state tree has the reference's layout
key for key (``m``, ``v``, ``count``, optional ``master``; an 8-bit moment
is ``{"q": int8, "scale": float32 (*shape[:-1], 1)}``), so a train
checkpoint written by either package restores in the other.

The update runs eagerly and in place, one slice of each leaf at a time
along its leading axis (:data:`SLICE_ELEMS` values a slice): the port's
parameters are stacked on a leading layer axis, and one float32 temporary
of a whole stacked leaf is 5.8 GB for zamba2-2.7b's ``in_proj`` and 17.2 GB
for falcon-mamba-7b's, of which a straight per-leaf update builds about
five.  The int8 blocks run along the last axis, so slicing the leading
axis of a leaf with two or more axes leaves every value as it was; a 1-D
leaf is one block and is updated whole.  The global norm is summed the
same way.

``count`` is a host (CPU) int32 scalar, so the learning rate and the bias
corrections need no device sync; every other leaf lives on its
parameter's device.  ``opt_state_logical`` (sharding metadata) comes with
the sharding slice of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.profiler import record_function

SLICE_ELEMS = 1 << 27        # values of a leaf updated at once (512 MB fp32)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_bits: int = 32          # 32 or 8
    master_fp32: bool = True      # keep an fp32 master copy of bf16 params


def warmup_cosine(cfg: OptimConfig, step) -> float:
    """The learning rate at ``step`` (an int or a 0-d tensor), computed in
    float32 as the reference does."""
    f32 = np.float32
    step = f32(int(step))
    warm = min(f32(1.0), (step + f32(1)) / f32(max(1, cfg.warmup_steps)))
    frac = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(1, cfg.total_steps - cfg.warmup_steps)),
                   f32(0.0), f32(1.0))
    lr = (f32(cfg.lr) * warm * f32(0.5)
          * (f32(1.0) + np.cos(f32(math.pi) * frac, dtype=f32)))
    return float(f32(lr))


# ----------------------------------------------------------- int8 moments
def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


# ----------------------------------------------------------------- init
def adamw_init(params, cfg: OptimConfig):
    """Zeroed moments on each parameter's device, the host ``count``, and
    (``master_fp32``) float32 copies of the parameters."""

    def moment(p: torch.Tensor):
        if cfg.state_bits == 8 and p.dim() >= 1 and p.shape[-1] >= 4:
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros((*p.shape[:-1], 1),
                                         dtype=torch.float32,
                                         device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {
        "m": pytree.tree_map(moment, params),
        "v": pytree.tree_map(moment, params),
        "count": torch.zeros((), dtype=torch.int32),
    }
    if cfg.master_fp32:
        state["master"] = pytree.tree_map(
            lambda p: p.to(torch.float32, copy=True), params)
    return state


# ----------------------------------------------------------------- update
def _slices(x: torch.Tensor) -> Iterator:
    """Slices of ``x``'s leading axis of about :data:`SLICE_ELEMS` values
    (the whole leaf, ``...``, for 0-d and 1-D leaves)."""
    if x.dim() < 2:
        yield ...
        return
    per_row = max(1, x.numel() // max(1, x.shape[0]))
    rows = max(1, SLICE_ELEMS // per_row)
    for i in range(0, x.shape[0], rows):
        yield slice(i, i + rows)


def _sorted_leaves(tree):
    """The leaves in the order of their sorted key paths (the reference's
    dict order), whatever order the dicts were built in: a restore rebuilds
    the state's dicts in sorted order, and a sum must not move with it."""
    flat = pytree.tree_flatten_with_path(tree)[0]
    flat.sort(key=lambda kv: [str(getattr(k, "key", k)) for k in kv[0]])
    return [x for _, x in flat]


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed in float32 one
    slice at a time, the leaves in sorted key order."""
    total = None
    for x in _sorted_leaves(tree):
        for sl in _slices(x):
            part = torch.sum(torch.square(x[sl].to(torch.float32)))
            total = part if total is None else total + part
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def _walk(params, grads, m, v, master, path=()):
    """(p, g, m, v, master) for every parameter leaf; the state trees
    follow the parameter tree down to its leaves."""
    if isinstance(params, torch.Tensor):
        yield params, grads, m, v, master
        return
    if not isinstance(params, dict):
        raise TypeError(f"adamw: unexpected node {type(params)} at {path}")
    for k in params:
        yield from _walk(params[k], grads[k], m[k], v[k],
                         None if master is None else master[k], path + (k,))


def adamw_update(grads, state, params, cfg: OptimConfig,
                 lr: Optional[float] = None):
    """One AdamW step, in place: ``params``, the moments, ``count`` and
    ``master`` are updated where they lie.  Returns (params, state,
    metrics) as the reference does; metrics are ``{"grad_norm": 0-d
    float32 tensor on the gradients' device, "lr": float}``."""
    count = int(state["count"]) + 1
    if lr is None:
        lr = warmup_cosine(cfg, count - 1)
    gnorm = _global_norm(grads)
    clip = torch.where(gnorm > cfg.clip_norm, cfg.clip_norm / gnorm,
                       torch.ones_like(gnorm))
    b1, b2 = cfg.beta1, cfg.beta2
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(b1) ** f32(count))
    bc2 = float(f32(1.0) - f32(b2) ** f32(count))
    master = state.get("master")

    with torch.no_grad(), record_function("craft::adamw"):
        for p, g, m0, v0, w in _walk(params, grads, state["m"],
                                     state["v"], master):
            for sl in _slices(p):
                gf = g[sl].to(torch.float32) * clip
                if _is_q(m0):
                    m = b1 * _dequantize(m0["q"][sl], m0["scale"][sl]) \
                        + (1 - b1) * gf
                else:
                    m = b1 * m0[sl] + (1 - b1) * gf
                if _is_q(v0):
                    vv = b2 * _dequantize(v0["q"][sl], v0["scale"][sl]) \
                        + (1 - b2) * torch.square(gf)
                else:
                    vv = b2 * v0[sl] + (1 - b2) * torch.square(gf)
                del gf
                update = (m / bc1) / (torch.sqrt(vv / bc2) + cfg.eps)
                wf = (w if w is not None else p)[sl].to(torch.float32)
                wf = wf - lr * (update + cfg.weight_decay * wf)
                del update
                p[sl].copy_(wf)
                if w is not None:
                    w[sl].copy_(wf)
                del wf
                for mom, val in ((m0, m), (v0, vv)):
                    if _is_q(mom):
                        q, s = _quantize(val)
                        mom["q"][sl].copy_(q)
                        mom["scale"][sl].copy_(s)
                    else:
                        mom[sl].copy_(val)
                del m, vv
    state["count"].fill_(count)
    return params, state, {"grad_norm": gnorm, "lr": lr}
