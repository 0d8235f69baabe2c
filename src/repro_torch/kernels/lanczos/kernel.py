"""Hand-written CUDA Lanczos step (``csrc/lanczos.cu``) and its wrapper.

Replaces no TPU kernel: the reference runs the graphene matvec and the
three-term step as plain jnp (``repro/apps/lanczos.py``).  Three launches
take one step, bound by device-memory bytes: the stencil with α's block
partials, the update with β's, and the scale (see the source for the
design and :mod:`ref` for the same arithmetic in plain PyTorch).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lanczos.ref import geometry


def _takes(*vectors: torch.Tensor) -> bool:
    """Whether the kernel takes these vectors: CUDA float32 (nx, ny, 2)
    grids of one shape on one device, nx at least 2, ny even, contiguous
    and 16-byte aligned."""
    first = vectors[0]
    return (first.device.type == "cuda" and first.dim() == 3
            and first.shape[2] == 2 and first.shape[0] >= 2
            and first.shape[1] >= 2 and first.shape[1] % 2 == 0
            and all(v.device == first.device and v.dtype == torch.float32
                    and v.shape == first.shape and v.is_contiguous()
                    and v.data_ptr() % 16 == 0 for v in vectors))


def lanczos_step_cuda(t: float, eps: torch.Tensor, v_prev: torch.Tensor,
                      v_cur: torch.Tensor, beta: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(α, β_new, v_new) of one step; α and β_new are 0-d views of one
    2-element device buffer, side by side.  ``beta`` is passed as float32.
    Raises for vectors the kernel does not take: on the CPU, of another
    dtype, not contiguous, not 16-byte aligned, ny odd or nx < 2."""
    if not _takes(eps, v_prev, v_cur):
        raise ValueError(
            "lanczos_step_cuda: expected contiguous 16-byte aligned CUDA "
            "float32 (nx, ny, 2) vectors with nx >= 2 and ny even, got "
            f"{tuple(v_cur.shape)} {v_cur.dtype} on {v_cur.device}")
    nx, ny, _ = v_cur.shape
    geo = geometry(nx, ny)
    v_new = torch.empty_like(v_cur)
    scratch = torch.empty(2 + 2 * geo.blocks, dtype=torch.float32,
                          device=v_cur.device)
    lib = _build.load("lanczos")
    with torch.cuda.device(v_cur.device):
        stream = torch.cuda.current_stream(v_cur.device).cuda_stream
        rc = lib.craft_lanczos_step(v_prev.data_ptr(), v_cur.data_ptr(),
                                    eps.data_ptr(), v_new.data_ptr(),
                                    scratch.data_ptr(), nx, ny, geo.rows,
                                    t, beta, stream)
    _build.check(rc, "lanczos_step_cuda")
    _build.count_launch(lanczos_step_cuda)
    return scratch[0], scratch[1], v_new


lanczos_step_cuda.launches = 0
