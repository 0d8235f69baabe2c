"""Public selective-scan op: dispatch on the tensors' device.

mamba1 vs mamba2 is inferred from the ranks, as in the reference's
``ops.selective_scan``.  A CUDA tensor goes to the hand-written kernel and
nothing else (a failed build or launch raises).  A CPU tensor goes to the
plain chunked scan (``ref.chunked_scan_ref``, the reference model's
``_fused_ssd_scan``) with ``chunk`` steps per chunk, so the port's models
on the CPU compute what the reference's do.  On the card the wrapper picks
its route from L (``kernel.choose_route``): a decode step (L = 1) and
short L run the sequential kernel, long L the chunked one, whose chunk
length is the kernel's own (``kernel.CHUNK``), not ``chunk``.
"""
from __future__ import annotations

from repro_torch.kernels.ssm_scan.kernel import s6_scan_cuda, ssd_scan_cuda
from repro_torch.kernels.ssm_scan.ref import chunked_scan_ref


def selective_scan(dtx, bh, ch, dt, A, h0, *, chunk: int = 256):
    """Returns (y, h_last): y (B, L, *head) in dtx's dtype on the card and
    float32 on the CPU (as the reference model's chunked scan), h_last
    float32."""
    if dtx.device.type == "cuda":
        fn = ssd_scan_cuda if dtx.dim() == 4 else s6_scan_cuda
        return fn(dtx, bh, ch, dt, A, h0)
    if dtx.device.type == "cpu":
        return chunked_scan_ref(dtx, bh, ch, dt, A, h0, chunk)
    raise ValueError(f"selective_scan: unsupported device {dtx.device}")
