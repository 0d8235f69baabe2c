"""Plain PyTorch reference of the graphene Lanczos solve (CRAFT, §5.1).

It imports nothing of the program.  The problem is the benchmark's own:
the on-site disorder W * uniform[-1, 1) and the unnormalised start vector
are drawn here from the seed (one ``torch.Generator`` on the device) and
handed to the program and to the reference alike.  The Hamiltonian is
the nearest-neighbour tight-binding stencil of the honeycomb lattice on an
(nx, ny, 2) grid with periodic boundaries plus the on-site term:

    (H psi)_A(x, y) = t [psi_B(x, y) + psi_B(x-1, y) + psi_B(x, y-1)]
    (H psi)_B(x, y) = t [psi_A(x, y) + psi_A(x+1, y) + psi_A(x, y+1)]

and the solve is the plain three-term Lanczos recurrence, without
reorthogonalisation, in ``dtype`` (float64 for the reference, bfloat16
for the control).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def problem(seed: int, lat: dict, device, index: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(on-site term, unnormalised start vector), float32 on ``device``,
    the ``index``-th problem of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(index)) % (1 << 63))
    shape = (lat["nx"], lat["ny"], 2)
    eps = torch.empty(shape, dtype=torch.float32, device=device)
    eps.uniform_(-1.0, 1.0, generator=gen).mul_(lat["disorder"])
    v0 = torch.randn(shape, generator=gen, dtype=torch.float32,
                     device=device)
    return eps, v0


def matvec(t: float, eps: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    a, b = psi[..., 0], psi[..., 1]
    hb = t * (a + torch.roll(a, -1, 0) + torch.roll(a, -1, 1))
    ha = t * (b + torch.roll(b, 1, 0) + torch.roll(b, 1, 1))
    return torch.stack([ha, hb], dim=-1) + eps * psi


def follow(lat: dict, eps: torch.Tensor, v0: torch.Tensor, n_iter: int,
           dtype=torch.float64) -> Dict[str, np.ndarray]:
    """{"alphas" (n_iter), "betas" (n_iter + 1, betas[0] = 0)} of the
    solve in ``dtype``."""
    eps = eps.to(dtype)
    v = v0.to(dtype)
    v = v / torch.sqrt(torch.sum(v * v))
    vp = torch.zeros_like(v)
    alphas = np.zeros(n_iter)
    betas = np.zeros(n_iter + 1)
    beta = torch.zeros((), dtype=dtype, device=v.device)
    for k in range(n_iter):
        w = matvec(lat["t"], eps, v)
        alpha = torch.sum(w * v)
        w = w - alpha * v - beta * vp
        beta = torch.sqrt(torch.sum(w * w))
        vp, v = v, w / beta
        alphas[k], betas[k + 1] = float(alpha), float(beta)
    return {"alphas": alphas, "betas": betas}


def ritz_min(alphas: np.ndarray, betas: np.ndarray) -> float:
    """Smallest eigenvalue of the tridiagonal of ``alphas`` and
    ``betas[1:len(alphas)]``."""
    k = len(alphas)
    tri = np.diag(np.asarray(alphas, np.float64))
    if k > 1:
        off = np.asarray(betas[1:k], np.float64)
        tri += np.diag(off, 1) + np.diag(off, -1)
    return float(np.min(np.linalg.eigvalsh(tri)))


def gaps(alphas, betas, ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The widest gaps of a solve's alphas and betas from the reference's,
    over the iterations the solve gave and over their first half, the
    iteration of the widest alpha gap, and the gap of the smallest Ritz
    value."""
    k = len(alphas)
    a = np.abs(np.asarray(alphas, np.float64) - ref["alphas"][:k])
    nb = min(len(betas), k + 1)
    b = np.abs(np.asarray(betas, np.float64)[:nb] - ref["betas"][:nb])
    h = max(1, k // 2)
    return {
        "alpha_gap": float(np.max(a)),
        "beta_gap": float(np.max(b)),
        "alpha_gap_half": float(np.max(a[:h])),
        "beta_gap_half": float(np.max(b[:h + 1])),
        "alpha_worst_at": int(np.argmax(a)),
        "ritz_gap": abs(ritz_min(alphas, betas)
                        - ritz_min(ref["alphas"][:k], ref["betas"])),
    }


NUMBERS = ("alpha_gap", "beta_gap", "alpha_gap_half", "beta_gap_half",
           "ritz_gap")
