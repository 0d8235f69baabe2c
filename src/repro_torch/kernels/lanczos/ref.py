"""Plain PyTorch mirror of the fused Lanczos step (``csrc/lanczos.cu``).

One three-term step on the graphene lattice, ``(nx, ny, 2)`` float32, in
the kernel's three passes and with its sums grouped as the kernel groups
them, so that the CPU tests reach the arithmetic that the card runs:

1. **stencil + α**: w = H v_cur (the tight-binding stencil plus the
   on-site term), and one partial of Σ w · v_cur a block;
2. **update + β**: α from the partials, w' = w − α v_cur − β v_prev, and
   one partial of Σ w'² a block;
3. **scale**: β_new = √Σ w'² from the partials, v_new = w' / β_new (or
   / 1 where β_new = 0).

The grouping (:func:`geometry`): a block of :data:`THREADS` threads covers
a strip of :data:`STRIP` sites of a row, two a thread, and walks ``rows``
consecutive rows.  A thread adds its products in memory order (row by
row; within a row site by site, component by component) into one float32
sum from zero; the block adds its threads' sums by the warp-shuffle tree
(:func:`_tree`) and writes one partial, at ``group * strips + strip``.  A
sum of partials is thread ``i`` adding partials ``i, i + THREADS, …`` in
order, then the same tree.  Every add and product is one float32 rounding
(the kernel forbids fused multiply-adds), so the mirror gives the kernel's
bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

THREADS = 256
WARP = 32
STRIP = 2 * THREADS
# blocks a stencil pass aims at: 16 blocks of 256 threads for each of the
# H100's 132 SMs, so the last wave of blocks is a small share of the pass
TARGET_BLOCKS = 132 * 16


@dataclasses.dataclass(frozen=True)
class Geometry:
    strips: int     # blocks across a row
    groups: int     # blocks down the rows
    rows: int       # rows a block walks

    @property
    def blocks(self) -> int:
        return self.strips * self.groups


def geometry(nx: int, ny: int) -> Geometry:
    """The stencil passes' grid: it depends on (nx, ny) alone, so the sums
    are grouped alike on every run and every card."""
    strips = -(-ny // STRIP)
    rows = max(1, min(nx, -(-nx * strips // TARGET_BLOCKS)))
    return Geometry(strips, -(-nx // rows), rows)


def stencil(t: float, eps: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = H v: the honeycomb stencil with periodic boundaries (by
    ``torch.roll``) plus the on-site term; ``apps/lanczos.matvec``, the
    plain route's, is this function."""
    a, b = v[..., 0], v[..., 1]
    hb = t * (a + torch.roll(a, -1, 0) + torch.roll(a, -1, 1))
    ha = t * (b + torch.roll(b, 1, 0) + torch.roll(b, 1, 1))
    return torch.stack([ha, hb], dim=-1) + eps * v


def _tree(x: torch.Tensor) -> torch.Tensor:
    """The warp's shuffle-down tree over the last dim (32 lanes): lane i
    adds lane i + o for o = 16, 8, 4, 2, 1; returns lane 0."""
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o] + x[..., o:2 * o]
    return x[..., 0]


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """The block's sum of its threads' values (last dim, THREADS): each
    warp's tree, then warp 0's tree over the warp sums padded to 32."""
    warps = _tree(x.reshape(*x.shape[:-1], THREADS // WARP, WARP))
    pad = torch.zeros(*warps.shape[:-1], WARP - warps.shape[-1],
                      dtype=x.dtype)
    return _tree(torch.cat([warps, pad], dim=-1))


def block_partials(prod: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """One partial a block of the elementwise products ``prod`` (nx, ny,
    2), as the stencil passes form them; (blocks,) in partial order."""
    nx, ny, _ = prod.shape
    full = torch.zeros(geo.groups * geo.rows, geo.strips * STRIP, 2,
                       dtype=prod.dtype)
    full[:nx, :ny] = prod
    # (group, row, strip, thread, its two sites' four values)
    full = full.reshape(geo.groups, geo.rows, geo.strips, THREADS, 4)
    acc = torch.zeros(geo.groups, geo.strips, THREADS, dtype=prod.dtype)
    for r in range(geo.rows):
        for k in range(4):
            acc = acc + full[:, r, :, :, k]
    return _block_sum(acc).reshape(-1)


def sum_partials(part: torch.Tensor) -> torch.Tensor:
    """The 0-d sum of the partials in the kernel's fixed order."""
    n = part.numel()
    cols = max(1, math.ceil(n / THREADS))
    full = torch.zeros(cols * THREADS, dtype=part.dtype)
    full[:n] = part
    full = full.reshape(cols, THREADS)
    acc = torch.zeros(THREADS, dtype=part.dtype)
    for c in range(cols):
        acc = acc + full[c]
    return _block_sum(acc)


def lanczos_step_ref(t: float, eps: torch.Tensor, v_prev: torch.Tensor,
                     v_cur: torch.Tensor, beta: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(α, β_new, v_new) of one step on CPU float32 (nx, ny, 2) tensors,
    pass by pass; ``beta`` is taken as float32."""
    geo = geometry(v_cur.shape[0], v_cur.shape[1])
    w = stencil(t, eps, v_cur)                                 # pass 1
    alpha = sum_partials(block_partials(w * v_cur, geo))
    beta32 = torch.tensor(beta, dtype=torch.float32)           # pass 2
    w = w - alpha * v_cur - beta32 * v_prev
    beta_new = torch.sqrt(sum_partials(block_partials(w * w, geo)))
    v_new = w / torch.where(beta_new == 0, 1.0, beta_new)      # pass 3
    return alpha, beta_new, v_new
