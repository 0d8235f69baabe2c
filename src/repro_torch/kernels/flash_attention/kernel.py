"""Hand-written CUDA attention kernels (``csrc/flash_attention.cu``) and
their wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention``: blocked attention forward with an online softmax and
float32 accumulation, GQA, causal / sliding-window / ``q_offset`` /
``kv_len`` masks, fully masked rows giving 0, and, as there, a V head dim
``dv`` of its own beside q's and k's ``dqk`` (MLA: 192 and 128), each up
to :data:`D_MAX`.  The ragged edge is masked in the kernels, so nothing is
padded.  See the source for the design.

Three routes, picked by :func:`choose_route` from the dtype and the shape
alone (a route that fails to build or launch raises):

- ``tc_prefill``: bf16 with more than :data:`DECODE_ROWS` rows of (query,
  group head), ``(dqk, dv)`` one of :data:`TC_DIMS` — tensor cores
  (mma.sync).
- ``split_decode``: at most :data:`DECODE_ROWS` such rows, float32 or bf16,
  ``(dqk, dv)`` one of :data:`TC_DIMS` and the block's shared memory
  within the card's — one block per (batch, kv head, split of the keys),
  the split count from :func:`decode_splits`, then a combine kernel.
- ``scalar``: float32 prefill and every other ``(dqk, dv)`` — scalar fp32
  FMAs.

With ``return_lse=True`` the wrapper also returns each row's log-sum-exp
of its scaled scores (float32 (B, Hq, Lq), -1e30 for a row that sees no
key, as the reference's blocked forward): the residual of the training
backward.  ``tc_prefill`` and ``scalar`` write it; rows that would take
``split_decode`` take ``scalar`` then, by the same rule every time.

``flash_attention_cuda.launches`` counts the wrapper calls that launched
(one per call, whatever the route), ``flash_attention_cuda.routes`` the
calls of each route, and ``flash_attention_cuda.dims`` the calls of each
``(dqk, route)``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 256              # dqk and dv, every route
ROUTES = ("tc_prefill", "split_decode", "scalar")
# (dqk, dv) pairs instantiated for tc_prefill and split_decode: the served
# models' head dims (dqk == dv), MLA's 128 + 64 / 128 and Zamba2-7B's 224
TC_DIMS = frozenset({(d, d) for d in range(16, 129, 16)}
                    | {(192, 128), (224, 224)})
DECODE_ROWS = 64         # rows (Lq * group) of one split_decode block
DECODE_TILE = 64         # keys a split_decode block stages at a time
BLOCKS_PER_SM = 2        # split_decode blocks the split count aims for
H100_SMS = 132
SMEM_MAX = 232448        # shared memory one block may use on the H100


def decode_smem_bytes(dtype: torch.dtype, dqk: int, dv: int,
                      rows: int) -> int:
    """Shared memory of one split_decode block (``dec::smem_bytes`` in
    the source): two stages of 64 K and V rows padded by 16 bytes, and
    float32 q rows, scores, (m, l, alpha) and key-group partials for
    ``rows`` padded to a multiple of 4."""
    elem = 4 if dtype == torch.float32 else 2
    padded = -(-rows // 4) * 4
    return (128 + elem * 2 * DECODE_TILE * (dqk + dv + 2 * 16 // elem)
            + 4 * (padded * dqk + padded * DECODE_TILE + padded * 3
                   + 128 * 2 * 4))


def choose_route(dtype: torch.dtype, lq: int, group: int, dqk: int,
                 dv: Optional[int] = None, lse: bool = False) -> str:
    """The kernel route for q of ``dtype`` with ``lq`` rows, ``group`` q
    heads per kv head, q/k head dim ``dqk`` and v head dim ``dv`` (default
    ``dqk``); ``lse``: the call must also return the log-sum-exp
    (``split_decode`` writes none)."""
    dv = dqk if dv is None else dv
    if (dqk, dv) not in TC_DIMS:
        return "scalar"
    rows = lq * group
    if rows <= DECODE_ROWS:
        if lse or decode_smem_bytes(dtype, dqk, dv, rows) > SMEM_MAX:
            return "scalar"
        return "split_decode"
    return "tc_prefill" if dtype == torch.bfloat16 else "scalar"


def key_range(lq: int, lk: int, causal: bool, window: Optional[int],
              q_offset: int, kv_len: Optional[int]) -> Tuple[int, int]:
    """``[k_begin, k_end)``: the keys that some query row of ``q_offset ..
    q_offset + lq - 1`` may see (empty when ``k_end == k_begin``)."""
    k_end = lk if kv_len is None else min(lk, kv_len)
    if causal:
        k_end = min(k_end, q_offset + lq)
    k_begin = max(0, q_offset - window + 1) if window else 0
    return k_begin, max(k_begin, k_end)


def decode_splits(batch: int, hkv: int, n_keys: int,
                  sms: int = H100_SMS) -> Tuple[int, int]:
    """``(splits, split_len)`` of the split-KV decode over ``n_keys`` keys:
    enough splits that ``batch * hkv * splits`` blocks give every SM about
    :data:`BLOCKS_PER_SM`, each split a whole number of
    :data:`DECODE_TILE`-key tiles, and no split empty."""
    tiles = max(1, math.ceil(n_keys / DECODE_TILE))
    want = max(1, math.ceil(BLOCKS_PER_SM * sms / (batch * hkv)))
    per = math.ceil(tiles / min(tiles, want))
    return math.ceil(tiles / per), per * DECODE_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a contiguous last axis (a copy only where it is not)."""
    return x if x.stride(-1) == 1 else x.contiguous()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a contiguous last axis and a 16-byte aligned base and
    strides, as the 16-byte copies need (a copy only where it is not)."""
    es = x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s * es % 16 == 0 for s, n in zip(x.stride()[:-1],
                                                   x.shape[:-1]) if n > 1))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    sm_scale: Optional[float] = None, q_offset: int = 0,
    kv_len: Optional[int] = None, return_lse: bool = False,
):
    """Attention of CUDA tensors q (B, Hq, Lq, Dqk), k (B, Hkv, Lk, Dqk),
    v (B, Hkv, Lk, Dv), all float32 or all bfloat16, Dqk and Dv up to
    :data:`D_MAX`; returns (B, Hq, Lq, Dv) in q's dtype (``sm_scale``
    defaults to ``Dqk ** -0.5``, as the TPU kernel's), and with
    ``return_lse`` also the (B, Hq, Lq) float32 log-sum-exp.
    Any strides of the batch, head and row axes are taken (copied where
    the route's 16-byte copies need alignment).  Raises for tensors that
    are not on a CUDA device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: CUDA tensor expected "
                             f"for {name}, got {t.device}")
        if t.dim() != 4:
            raise TypeError(f"flash_attention_cuda: {name} must be 4-D, got "
                            f"{tuple(t.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: q, k, v must share a dtype "
                        f"in {list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, hq, lq, dqk = q.shape
    _, hkv, lk, _ = k.shape
    dv = v.shape[3]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != dqk:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "agree")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if not (0 < dqk <= D_MAX and 0 < dv <= D_MAX):
        raise ValueError(f"flash_attention_cuda: head dims {dqk}, {dv} not "
                         f"in 1..{D_MAX}")
    if sm_scale is None:
        sm_scale = dqk ** -0.5
    kv_len = lk if kv_len is None else int(kv_len)
    if kv_len < 0 or (window is not None and int(window) <= 0):
        raise ValueError(f"flash_attention_cuda: kv_len {kv_len} must be "
                         f">= 0 and window {window} None or > 0")
    window = 0 if window is None else int(window)      # 0: no window
    out = torch.empty((b, hq, lq, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        route = choose_route(q.dtype, lq, hq // hkv, dqk, dv,
                             lse=return_lse)
        _launch(route, q, k, v, out, causal=bool(causal), window=window,
                sm_scale=float(sm_scale), q_offset=int(q_offset),
                kv_len=kv_len, lse=lse)
    return (out, lse) if return_lse else out


def _launch(route: str, q, k, v, out, *, causal: bool, window: int,
            sm_scale: float, q_offset: int, kv_len: int,
            lse: Optional[torch.Tensor] = None) -> None:
    """Launch ``route``'s kernel(s) on checked arguments and count it;
    ``lse`` (float32 (B, Hq, Lq)) is written by the scalar and tc_prefill
    routes."""
    b, hq, lq, dqk = q.shape
    _, hkv, lk, _ = k.shape
    dv = v.shape[3]
    lib = _build.load("flash_attention")
    if route == "scalar":
        q, k, v = _rows_view(q), _rows_view(k), _rows_view(v)
    else:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if lse is not None and route == "split_decode":
        raise ValueError("flash_attention_cuda: split_decode writes no lse")
    lse_ptr = None if lse is None else lse.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "scalar":
            rc = lib.craft_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_ptr, b, hq, hkv, lq, lk, dqk, dv, *strides, sm_scale,
                int(causal), window, q_offset, kv_len, _DTYPES[q.dtype],
                stream)
        elif route == "tc_prefill":
            rc = lib.craft_flash_prefill_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_ptr, b, hq, hkv, lq, lk, dqk, dv, *strides, sm_scale,
                int(causal), window, q_offset, kv_len, stream)
        elif route == "split_decode":
            k_begin, k_end = key_range(lq, lk, causal, window or None,
                                       q_offset, kv_len)
            splits, split_len = decode_splits(
                b, hkv, k_end - k_begin, _sm_count(q.device.index))
            # float32 partials: o (B, Hkv, splits, rows, Dv), then (m, l)
            n_o = b * hkv * splits * lq * (hq // hkv) * dv
            part = torch.empty(n_o + 2 * n_o // dv, dtype=torch.float32,
                               device=q.device)
            rc = lib.craft_flash_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                part.data_ptr(), part.data_ptr() + 4 * n_o, b, hq, hkv, lq,
                dqk, dv, *strides, sm_scale, int(causal), window, q_offset,
                min(lk, kv_len), k_begin, k_end, split_len, splits,
                _DTYPES[q.dtype], stream)
        else:
            raise ValueError(f"flash_attention_cuda: unknown route {route}")
    _build.check(rc, f"flash_attention_cuda ({route})")
    _build.count_launch(flash_attention_cuda, route, key=(dqk, route))


flash_attention_cuda.launches = 0
flash_attention_cuda.routes = dict.fromkeys(ROUTES, 0)
flash_attention_cuda.dims = {}
