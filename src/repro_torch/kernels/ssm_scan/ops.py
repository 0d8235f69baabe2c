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

Meshes and tracing: DTensor inputs (a mesh run: the model pins them to
batch x heads for mamba2, batch x channels for mamba1) enter through
``local_map``, so each rank's call scans exactly its rows and heads or
channels, on the card with the hand kernel; mamba1's B and C, whole on a
mesh dimension that splits the channels, and A where the batch is split,
get partial gradients there.
The forward is also the custom op ``craft::selective_scan``
(``craft::selective_scan_states`` with the chunk states), with a
fake-tensor shape function and a flop formula (2 B L' S for a state of S
values a batch row over L' = L rounded up to whole chunks: the
reference's dot count of its chunked scan's read-out), so a fake-tensor
trace passes through it and the roofline counts it.  Every call goes
through it, serving's and the gradient path's alike; a fake tensor takes
the card's route (y in the input's dtype, chunk states every
``kernel.CHUNK`` steps): the dry-run's trace stands for the card.
:func:`custom_ops` registers them at first use.

Training: where autograd records (grad mode on and an input requiring a
gradient), the call goes through :class:`ScanFn`: its forward is the same
kernel on its chunked route at any L (the route whose carry leaves each
chunk's incoming state; a width it does not take raises) or the plain
chunked scan, keeping those states; its backward is
:func:`backward.scan_bwd` on either device.  Serving and decode never
record, so they keep the path above.
"""
from __future__ import annotations

import math
import threading
from typing import List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.profiler import record_function

from repro_torch.kernels.ssm_scan.backward import scan_bwd
from repro_torch.kernels.ssm_scan.kernel import (
    CHUNK, s6_scan_cuda, ssd_scan_cuda,
)
from repro_torch.kernels.ssm_scan.ref import chunked_scan_ref
from repro_torch.sharding.activations import is_dtensor


def _card_route(dtx) -> bool:
    """Whether ``dtx`` takes the card's route: a CUDA tensor, or a fake one
    (a dry-run's trace stands for the card)."""
    return dtx.device.type == "cuda" or isinstance(dtx, FakeTensor)


def _states_chunk(dtx, chunk: int) -> int:
    """The ``q`` of :func:`scan_with_states` (chunks of ``min(q, L)``
    steps)."""
    return CHUNK if _card_route(dtx) else int(chunk)


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


def _scan(dtx, bh, ch, dt, A, h0, chunk: int):
    if dtx.device.type == "cuda":
        fn = ssd_scan_cuda if dtx.dim() == 4 else s6_scan_cuda
        return fn(dtx, bh, ch, dt, A, h0)
    if dtx.device.type == "cpu":
        return chunked_scan_ref(dtx, bh, ch, dt, A, h0, chunk)
    raise ValueError(f"selective_scan: unsupported device {dtx.device}")


# ----------------------------------------------------- custom ops (tracing)
def _y_dtype(dtx):
    return dtx.dtype if _card_route(dtx) else torch.float32


_OPS = []
_LOCK = threading.Lock()


def custom_ops():
    """``torch.ops.craft`` with ``selective_scan`` and
    ``selective_scan_states`` registered (once, at first use: registering
    costs a second of imports no serving process needs)."""
    if not _OPS:
        with _LOCK:     # threads (SimWorld ranks) race to the first call
            if not _OPS:
                _register()
    return _OPS[0]


def _register() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("craft::selective_scan", mutates_args=())
    def selective_scan_op(dtx: torch.Tensor, bh: torch.Tensor,
                          ch: torch.Tensor, dt: torch.Tensor,
                          A: torch.Tensor, h0: torch.Tensor,
                          chunk: int) -> List[torch.Tensor]:
        return list(_scan(dtx, bh, ch, dt, A, h0, chunk))

    @selective_scan_op.register_fake
    def _(dtx, bh, ch, dt, A, h0, chunk):
        return [dtx.new_empty(dtx.shape, dtype=_y_dtype(dtx)),
                h0.new_empty(h0.shape, dtype=torch.float32)]

    @torch.library.custom_op("craft::selective_scan_states",
                             mutates_args=())
    def selective_scan_states_op(
            dtx: torch.Tensor, bh: torch.Tensor, ch: torch.Tensor,
            dt: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
            chunk: int) -> List[torch.Tensor]:
        return list(scan_with_states(dtx, bh, ch, dt, A, h0, chunk)[:3])

    @selective_scan_states_op.register_fake
    def _(dtx, bh, ch, dt, A, h0, chunk):
        l = dtx.shape[1]
        nc = -(-l // max(1, min(_states_chunk(dtx, chunk), l)))
        return [dtx.new_empty(dtx.shape, dtype=_y_dtype(dtx)),
                h0.new_empty(h0.shape, dtype=torch.float32),
                h0.new_empty((h0.shape[0], nc, *h0.shape[1:]),
                             dtype=torch.float32)]

    register_flop_formula([torch.ops.craft.selective_scan,
                           torch.ops.craft.selective_scan_states])(
        _scan_flops)
    _OPS.append(torch.ops.craft)


def _scan_flops(dtx_shape, bh_shape, ch_shape, dt_shape, A_shape, h0_shape,
                chunk, *args, out_shape=None, **kwargs) -> int:
    """2 B L' S: the read-out ``y = C . h`` of every step over whole
    chunks (L' = L rounded up to ``min(chunk, L)``), as the reference's
    dot count of its chunked scan gives it."""
    b, l = dtx_shape[0], dtx_shape[1]
    c = max(1, min(int(chunk), l))
    return 2 * b * (-(-l // c) * c) * math.prod(h0_shape[1:])


# ----------------------------------------------------------------- meshes
def _mesh_scan(dtx, bh, ch, dt, A, h0, chunk: int):
    """The scan on DTensors: each rank's local call on its own rows and
    heads or channels (``local_map``).  ``dtx``'s split of its batch and
    head (or channel) dims sets every input's; a plain input (a zero
    initial state) is taken as replicated and split to match."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = dtx.device_mesh
    for pl in dtx.placements:
        if isinstance(pl, Shard) and pl.dim not in (0, 2):
            raise ValueError(f"selective_scan on a mesh: dtx split on dim "
                             f"{pl.dim}; pin it to batch x heads first")
    mamba2 = dtx.dim() == 4
    # where each input takes dtx's dim 0 (batch) and dim 2 (heads/channels)
    where = [(0, 2), (0, 2 if mamba2 else None), (0, 2 if mamba2 else None),
             (0, 2), (None, 0), (0, 1)]

    def split(dims):
        return tuple(
            Shard(dims[0]) if isinstance(pl, Shard) and pl.dim == 0
            and dims[0] is not None else
            Shard(dims[1]) if isinstance(pl, Shard) and pl.dim == 2
            and dims[1] is not None else Replicate()
            for pl in dtx.placements)

    pls = tuple(split(d) for d in where)
    ins = []
    for t, pl in zip((dtx, bh, ch, dt, A, h0), pls):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        ins.append(t)
    # A has no batch dim: where the batch is split its gradient is a
    # partial sum; so are mamba1's B and C (B, L, st) where the channels
    # are split
    grads = list(pls)
    grads[4] = tuple(Partial() if isinstance(a, Shard) and a.dim == 0 else b
                     for a, b in zip(dtx.placements, pls[4]))
    if not mamba2:
        for i in (1, 2):
            grads[i] = tuple(
                Partial() if isinstance(a, Shard) and a.dim == 2 else b
                for a, b in zip(dtx.placements, pls[i]))
    fn = local_map(lambda *xs: _local_scan(*xs, chunk),
                   out_placements=(list(pls[0]), list(pls[5])),
                   in_placements=pls, in_grad_placements=tuple(grads),
                   device_mesh=mesh)
    return tuple(fn(*ins))


def _local_scan(dtx, bh, ch, dt, A, h0, chunk: int):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dtx, bh, ch, dt, A, h0)):
        return ScanFn.apply(dtx, bh, ch, dt, A, h0, chunk)
    return tuple(custom_ops().selective_scan(dtx, bh, ch, dt, A, h0, chunk))


class ScanFn(torch.autograd.Function):
    """The selective scan with a gradient: forward :func:`scan_with_states`,
    saving the inputs and the chunk-entry states; backward
    :func:`backward.scan_bwd`.  ``bh``/``ch`` may be stride-0 broadcasts of
    grouped B/C: their gradients come back per head, and the expand
    outside sums them over the heads."""

    @staticmethod
    def forward(ctx, dtx, bh, ch, dt, A, h0, chunk):
        y, h_last, states = custom_ops().selective_scan_states(
            dtx, bh, ch, dt, A, h0, chunk)
        ctx.q = _states_chunk(dtx, chunk)
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
    if dtx.device.type not in ("cuda", "cpu"):
        raise ValueError(f"selective_scan: unsupported device {dtx.device}")
    if is_dtensor(dtx):
        return _mesh_scan(dtx, bh, ch, dt, A, h0, chunk)
    return _local_scan(dtx, bh, ch, dt, A, h0, chunk)
