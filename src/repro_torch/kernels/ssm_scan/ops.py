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

Training: where autograd records (grad mode on and an input requiring a
gradient), the call goes through :class:`ScanFn`: its forward is the same
kernel on its chunked route at any L (the route whose carry leaves each
chunk's incoming state; a width it does not take raises) or the plain
chunked scan, keeping those states; its backward is
:func:`backward.scan_bwd` on either device.  Serving and decode never
record, so they keep the path above.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.kernels.ssm_scan.backward import scan_bwd
from repro_torch.kernels.ssm_scan.kernel import (
    CHUNK, s6_scan_cuda, ssd_scan_cuda,
)
from repro_torch.kernels.ssm_scan.ref import chunked_scan_ref


def scan_with_states(dtx, bh, ch, dt, A, h0, chunk: int):
    """(y, h_last, states, q): the kernel's chunked route (CUDA tensors) or
    the plain chunked scan (CPU tensors), with each chunk's incoming state
    for chunks of ``q`` steps."""
    if dtx.device.type == "cuda":
        fn = ssd_scan_cuda if dtx.dim() == 4 else s6_scan_cuda
        return (*fn(dtx, bh, ch, dt, A, h0, return_states=True), CHUNK)
    if dtx.device.type == "cpu":
        return (*chunked_scan_ref(dtx, bh, ch, dt, A, h0, chunk,
                                  return_states=True), chunk)
    raise ValueError(f"selective_scan: unsupported device {dtx.device}")


class ScanFn(torch.autograd.Function):
    """The selective scan with a gradient: forward :func:`scan_with_states`,
    saving the inputs and the chunk-entry states; backward
    :func:`backward.scan_bwd`.  ``bh``/``ch`` may be stride-0 broadcasts of
    grouped B/C: their gradients come back per head, and the expand
    outside sums them over the heads."""

    @staticmethod
    def forward(ctx, dtx, bh, ch, dt, A, h0, chunk):
        y, h_last, states, q = scan_with_states(dtx, bh, ch, dt, A, h0,
                                                chunk)
        ctx.q = q
        ctx.save_for_backward(dtx, bh, ch, dt, A, h0, states)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        with record_function("craft::scan_bwd"):
            grads = scan_bwd(*ctx.saved_tensors, ctx.q, dy, dh_last)
        return (*grads, None)


def selective_scan(dtx, bh, ch, dt, A, h0, *, chunk: int = 256):
    """Returns (y, h_last): y (B, L, *head) in dtx's dtype on the card and
    float32 on the CPU (as the reference model's chunked scan), h_last
    float32."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dtx, bh, ch, dt, A, h0)):
        return ScanFn.apply(dtx, bh, ch, dt, A, h0, chunk)
    if dtx.device.type == "cuda":
        fn = ssd_scan_cuda if dtx.dim() == 4 else s6_scan_cuda
        return fn(dtx, bh, ch, dt, A, h0)
    if dtx.device.type == "cpu":
        return chunked_scan_ref(dtx, bh, ch, dt, A, h0, chunk)
    raise ValueError(f"selective_scan: unsupported device {dtx.device}")
