"""Hand-written CUDA selective-scan kernels (``csrc/ssm_scan.cu``) and
their wrappers.

Replace the Pallas TPU kernels ``repro/kernels/ssm_scan/kernel.py::
ssd_scan`` (mamba2: scalar decay per head, state (hd, st) per batch row and
head) and ``::s6_scan`` (mamba1: per-channel decay ``exp(dt ⊗ A)``, state
(st,) per channel).  L is a run-time argument (decode is L = 1) and nothing
is padded.  Two routes each, picked by :func:`choose_route` from L and the
shape alone (a route that fails to build or launch raises):

- ``sequential``: one pass over time inside a block, the state in
  registers; one launch.  Decode and short L.  Bound on the H100 by the
  latency of one dependent step times L (160 or 256 blocks at the
  serving widths, under a warp per scheduler).
- ``chunked``: the time axis in chunks of :data:`CHUNK` steps that run at
  once; three launches (each chunk's end state from 0, a carry over the
  chunks, each chunk's outputs from its incoming state).  Bound on the
  H100 by operations: mamba1's two exps a state value and step on the
  special-function units, mamba2's FP32 instructions (PERF.md).  The
  wrapper allocates the float32 scratch of the chunk states (h_in):
  4 * B * ceil(L / Q) * (state values of one batch row) bytes, 168 MB for
  zamba2-2.7b's call at B 2, L 8192 and 67 MB for falcon-mamba-7b's.

Route threshold (:data:`CHUNKED_MIN_L`), from the sweep of both routes
over L at the serving widths in ``chip_smoke.py`` (kernels phase,
``scan_sweep``; PERF.md): mamba2 takes the chunked route from two chunks
(256 steps) on: with one chunk it does the sequential kernel's work twice
and is slower at L = 64 and 128.  mamba1's chunked passes step faster
than its sequential kernel (MUFU ex2 against full-precision expf, the
tiles copied ahead), so it wins from L = 64 on even as a single chunk.
Decode (L = 1) always takes the sequential route: one launch a call.
See the source for the design and the bounds.

With ``return_states=True`` the wrappers take the chunked route at any L
(the sequential route keeps no chunk states, so naming it raises) and also
return its scratch, which the carry leaves holding each chunk's incoming
state (float32 (B, ceil(L / CHUNK), *state)): the residual of the training
backward.  A width that the chunked route does not take raises.

``ssd_scan_cuda.launches`` and ``s6_scan_cuda.launches`` count the wrapper
calls that launched (one per call, whatever the route), ``.routes`` the
calls of each route.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ST_MAX = 128
ROUTES = ("sequential", "chunked")
CHUNK = 128                  # Q: steps a chunk of the chunked route
# shortest L that takes the chunked route, by scan (see the module note)
CHUNKED_MIN_L = {"ssd_scan": 2 * CHUNK, "s6_scan": 64}
CHUNK_THREADS = 256          # mamba2 chunked: most threads a head
CHUNK_ROWS = 4               # mamba2 chunked: state rows a thread
_SPT = 16                    # state values of a row a thread holds


def threads_per_row(st: int) -> int:
    """Threads that share one state row of ``st`` values (16 each, rounded
    up to a power of two), as the kernels split it."""
    t = 1
    while t * _SPT < st:
        t *= 2
    return t


def chunked_fits(h0_shape: Sequence[int]) -> bool:
    """Whether the chunked route takes a state of ``h0_shape`` (mamba2's
    head of hd rows must split into :data:`CHUNK_ROWS`-row slices over at
    most :data:`CHUNK_THREADS` threads; every mamba1 width fits)."""
    if len(h0_shape) != 4:
        return True
    _, _, hd, st = h0_shape
    return (hd % CHUNK_ROWS == 0
            and hd // CHUNK_ROWS * threads_per_row(st) <= CHUNK_THREADS)


def choose_route(l: int, h0_shape: Sequence[int]) -> str:
    """The scan route for ``l`` steps from a state of ``h0_shape``: (B, nh,
    hd, st) for mamba2, (B, di, st) for mamba1."""
    mamba2 = len(h0_shape) == 4
    if l < CHUNKED_MIN_L["ssd_scan" if mamba2 else "s6_scan"]:
        return "sequential"
    return "chunked" if chunked_fits(h0_shape) else "sequential"


def _check(what: str, dtx, bh, ch, dt, A, h0) -> None:
    for name, t in (("dtx", dtx), ("bh", bh), ("ch", ch), ("dt", dt),
                    ("A", A), ("h0", h0)):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: CUDA tensor expected for {name}, got "
                             f"{t.device}")
        if t.device != dtx.device:
            raise ValueError(f"{what}: {name} on {t.device}, dtx on "
                             f"{dtx.device}")
    if dtx.dtype not in _DTYPES or bh.dtype != dtx.dtype \
            or ch.dtype != dtx.dtype:
        raise TypeError(f"{what}: dtx, bh, ch must share a dtype in "
                        f"{list(_DTYPES)}; got {dtx.dtype}, {bh.dtype}, "
                        f"{ch.dtype}")
    st = bh.shape[-1]
    if not 0 < st <= ST_MAX:
        raise ValueError(f"{what}: state size {st} not in 1..{ST_MAX}")


def _route(what: str, route: Optional[str], l: int, h0_shape,
           return_states: bool) -> str:
    if return_states:
        route = "chunked" if route is None else route
        if route != "chunked":
            raise ValueError(f"{what}: only the chunked route keeps the "
                             f"chunk states, not {route!r}")
    route = choose_route(l, h0_shape) if route is None else route
    if route not in ROUTES:
        raise ValueError(f"{what}: route {route!r} not in {ROUTES}")
    if route == "chunked" and not chunked_fits(h0_shape):
        raise ValueError(f"{what}: the chunked route does not take a state "
                         f"of {tuple(h0_shape)}")
    return route


def _last_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def ssd_scan_cuda(dtx, bh, ch, dt, A, h0, *, route: Optional[str] = None,
                  return_states: bool = False):
    """mamba2 scan of CUDA tensors.  dtx (B, L, nh, hd); bh/ch
    (B, L, nh, st) (stride-0 head axes accepted, as a broadcast of grouped
    B/C); dt (B, L, nh); A (nh,); h0 (B, nh, hd, st).  dtx, bh, ch float32
    or bfloat16 (one type); dt, A, h0 are taken as float32.  ``route``
    names one of :data:`ROUTES` (default :func:`choose_route`, or chunked
    with ``return_states``).  Returns (y (B, L, nh, hd) in dtx's dtype,
    h_last (B, nh, hd, st) float32), and with ``return_states`` the
    chunked route's chunk-entry states (B, nc, nh, hd, st)."""
    _check("ssd_scan_cuda", dtx, bh, ch, dt, A, h0)
    b, l, nh, hd = dtx.shape
    st = bh.shape[-1]
    if (bh.shape != (b, l, nh, st) or ch.shape != bh.shape
            or dt.shape != (b, l, nh) or A.shape != (nh,)
            or h0.shape != (b, nh, hd, st)):
        raise ValueError(
            f"ssd_scan_cuda: shapes dtx {tuple(dtx.shape)}, bh "
            f"{tuple(bh.shape)}, ch {tuple(ch.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, h0 {tuple(h0.shape)} do not agree")
    route = _route("ssd_scan_cuda", route, l, h0.shape,
                   return_states)
    dtx, bh, ch = (_last_contiguous(t) for t in (dtx, bh, ch))
    dt = dt.to(torch.float32)
    A, h0 = _f32(A), _f32(h0)
    y = torch.empty((b, l, nh, hd), dtype=dtx.dtype, device=dtx.device)
    if l == 0:
        empty = h0.new_empty((b, 0, nh, hd, st))
        return (y, h0.clone(), empty) if return_states else (y, h0.clone())
    h_last = torch.empty((b, nh, hd, st), dtype=torch.float32,
                         device=dtx.device)
    strides = (dtx.stride(0), dtx.stride(1), dtx.stride(2), bh.stride(0),
               bh.stride(1), bh.stride(2), ch.stride(0), ch.stride(1),
               ch.stride(2), dt.stride(0), dt.stride(1), dt.stride(2))
    ptrs = (dtx.data_ptr(), bh.data_ptr(), ch.data_ptr(), dt.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr())
    states = None
    lib = _build.load("ssm_scan")
    with torch.cuda.device(dtx.device):
        stream = torch.cuda.current_stream(dtx.device).cuda_stream
        if route == "chunked":
            nc = -(-l // CHUNK)
            states = torch.empty((b, nc, nh, hd, st), dtype=torch.float32,
                                 device=dtx.device)
            dsum = torch.empty((b, nc, nh), dtype=torch.float32,
                               device=dtx.device)
            rc = lib.craft_ssd_scan_chunked(
                *ptrs, states.data_ptr(), dsum.data_ptr(), b, l, nh, hd, st,
                CHUNK, *strides, _DTYPES[dtx.dtype], stream)
        else:
            rc = lib.craft_ssd_scan(*ptrs, b, l, nh, hd, st, *strides,
                                    _DTYPES[dtx.dtype], stream)
    _build.check(rc, f"ssd_scan_cuda ({route})")
    _build.count_launch(ssd_scan_cuda, route)
    return (y, h_last, states) if return_states else (y, h_last)


ssd_scan_cuda.launches = 0
ssd_scan_cuda.routes = dict.fromkeys(ROUTES, 0)


def s6_scan_cuda(dtx, bh, ch, dt, A, h0, *, route: Optional[str] = None,
                 return_states: bool = False):
    """mamba1 scan of CUDA tensors.  dtx/dt (B, L, di); bh/ch (B, L, st);
    A (di, st); h0 (B, di, st).  dtx, bh, ch float32 or bfloat16 (one
    type); dt, A, h0 are taken as float32.  ``route`` as in
    :func:`ssd_scan_cuda`.  Returns (y (B, L, di) in dtx's dtype, h_last
    (B, di, st) float32), and with ``return_states`` the chunked route's
    chunk-entry states (B, nc, di, st)."""
    _check("s6_scan_cuda", dtx, bh, ch, dt, A, h0)
    b, l, di = dtx.shape
    st = bh.shape[-1]
    if (bh.shape != (b, l, st) or ch.shape != bh.shape
            or dt.shape != (b, l, di) or A.shape != (di, st)
            or h0.shape != (b, di, st)):
        raise ValueError(
            f"s6_scan_cuda: shapes dtx {tuple(dtx.shape)}, bh "
            f"{tuple(bh.shape)}, ch {tuple(ch.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, h0 {tuple(h0.shape)} do not agree")
    route = _route("s6_scan_cuda", route, l, h0.shape,
                   return_states)
    dtx, bh, ch = (_last_contiguous(t) for t in (dtx, bh, ch))
    dt = _last_contiguous(dt.to(torch.float32))
    A, h0 = _f32(A), _f32(h0)
    y = torch.empty((b, l, di), dtype=dtx.dtype, device=dtx.device)
    if l == 0:
        empty = h0.new_empty((b, 0, di, st))
        return (y, h0.clone(), empty) if return_states else (y, h0.clone())
    h_last = torch.empty((b, di, st), dtype=torch.float32, device=dtx.device)
    strides = (dtx.stride(0), dtx.stride(1), bh.stride(0), bh.stride(1),
               ch.stride(0), ch.stride(1), dt.stride(0), dt.stride(1))
    ptrs = (dtx.data_ptr(), bh.data_ptr(), ch.data_ptr(), dt.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr())
    states = None
    lib = _build.load("ssm_scan")
    with torch.cuda.device(dtx.device):
        stream = torch.cuda.current_stream(dtx.device).cuda_stream
        if route == "chunked":
            nc = -(-l // CHUNK)
            states = torch.empty((b, nc, di, st), dtype=torch.float32,
                                 device=dtx.device)
            dsum = torch.empty((b, nc, di), dtype=torch.float32,
                               device=dtx.device)
            rc = lib.craft_s6_scan_chunked(
                *ptrs, states.data_ptr(), dsum.data_ptr(), b, l, di, st,
                CHUNK, *strides, _DTYPES[dtx.dtype], stream)
        else:
            rc = lib.craft_s6_scan(*ptrs, b, l, di, st, *strides,
                                   _DTYPES[dtx.dtype], stream)
    _build.check(rc, f"s6_scan_cuda ({route})")
    _build.count_launch(s6_scan_cuda, route)
    return (y, h_last, states) if return_states else (y, h_last)


s6_scan_cuda.launches = 0
s6_scan_cuda.routes = dict.fromkeys(ROUTES, 0)
