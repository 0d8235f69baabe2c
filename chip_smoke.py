#!/usr/bin/env python3
"""Drive the PyTorch port of CRAFT (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # every phase (the default)

Phases, each printing one JSON line:

1. build   — compile the hand-written CUDA kernels (``checksum``,
   ``snapshot``, ``xor_reduce``, ``gf_matmul``, ``flash_attention``,
   ``ssd_scan`` and ``s6_scan``: six sources, the two scans share one)
   from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, all sources
   at once; print the build seconds and the card.
2. kernels — every kernel against its plain PyTorch version on the card,
   bit-exact (integer results): random words, words near 2^32, zeros, ragged
   grids, dirty/clean prev tables, the main path's call shapes and one
   (873, 1048576)-word matrix (the full-size state viewed as 4 MiB chunks);
   the parity kernels on G = 1..8 ragged rows, special and all 256
   coefficients, the rs_matrix(4,2) encode and a decode inverse, and one
   (4, largest stage) word matrix.  CUDA-event medians of each kernel and
   its plain version at the full size.  The LM kernels against their plain
   versions within stated tolerances: flash_attention in float32 and
   bfloat16 over GQA groups 1 and 4, D 16/40/64/80/128, ragged Lq/Lk,
   causal with and without a window, kv_len (0 too), q_offset, Lq = 1,
   fully masked rows and splits, each call's route (tc_prefill,
   split_decode, scalar) checked against the wrapper's rule; MLA's head
   dims (dqk 192, dv 128) on each route in both dtypes; then at the
   serving path's shapes (danube, zamba2 and deepseek-v3's MLA prefill at
   B 2, L 8192; musicgen's MHA 24 x 64 over its 64-frame prefix, L 8256,
   a ragged last tile; llava's GQA 56/8 x 128 over its 1152-patch prefix,
   L 9344; one decode step over each full cache) in float32 and
   bfloat16, timed in bfloat16 on its route and on the scalar route beside
   the plain version and scaled_dot_product_attention, with the
   HMMA/HGMMA count of the built library (cuobjdump -sass); ssd_scan and
   s6_scan at
   L = 1, ragged L, h0 != 0 and dt = 0 steps on the sequential route and
   at L = 1000 on the chunked one (each call's route checked against the
   wrapper's rule), then at (2, 8192, 80, 64, 64) and (2, 8192, 8192, 16)
   on both routes, timed beside the plain chunked scan, and a sweep of
   both routes over L (64 to 2048 at B 2, and 8192 at B 16).  The
   training path's use of them: the attention kernel's log-sum-exp on
   tc_prefill and scalar (rows that see no key, kv_len 0, zamba2's width
   at (2, 32, 4096, 80)) against the plain one; the attention Function
   (kernel forward, blocked backward) at zamba2's width (32 heads of 80,
   L 2048; GQA 4 with a window at L 1024) in bf16 and float32, and the
   scan Function, whose forward takes the chunked route at every L, at
   both models' widths (80 x 64 x 64, 8192 x 16; L 1024, and L 40 in one
   ragged chunk), against the plain versions' autograd in float32.
3. main    — the paper's Listing-2 loop through ``repro_torch.core.Checkpoint``
   on the full parameter set of h2o-danube-1.8b (configs/h2o_danube_1p8b.py:
   24 layers, d_model 2560, 32/8 heads of 80, d_ff 6912, vocab 32000,
   untied) in bf16 on the card, random from a seeded generator, through the
   state-dict checkpointable with CRAFT_DEVICE_SNAPSHOT=1 and CRAFT_DELTA=1
   on CRAFT_TIER_CHAIN=pfs (node tier cut to bound the disk footprint):
   3 versions with 2 of 24 layers updated in place between them, then a
   restore into zeroed tensors through a fresh Checkpoint, torch.equal on
   the card for every tensor.
4. default — the default configuration (codec v1, node,pfs, PARTNER) on
   256 MiB of CUDA state: write, bit-exact restore, then one flipped payload
   byte in every tier's copy must raise the checksum-mismatch error.
3b. control — CRAFT's control plane on the same h2o-danube-1.8b bf16
   state: 12 opportunities of the Listing-2 loop (2 layers change between
   them) on the default chain node,pfs with CRAFT_DEVICE_SNAPSHOT=1,
   CRAFT_DELTA=1 and the adaptive scheduler's count cadences
   CRAFT_TIER_EVERY=node:2,pfs:4, under a node-tier outage
   (CRAFT_CHAOS=node:eio:p=1+after=4+count=6, no retries, breaker
   threshold 2, cooldown 0.05 s), CRAFT_KEEP_VERSIONS=2, traced
   (CRAFT_TRACE) and exported (CRAFT_METRICS_PORT=0 on localhost).  The
   breaker must trip and route versions to the PFS, the node tier must be
   re-admitted with a full version and then take deltas; ``top --once``
   renders the live exporter during the outage (node breaker not closed)
   and the trace at the end; a fresh Checkpoint restores the newest
   version through its delta chain, torch.equal for every tensor; the
   port's ``replay`` of the trace must re-derive every decision and land
   the live per-tier counts and bytes; ``python -m repro_torch.tune
   --fail-on-regression`` must exit 0.  Prints each version's write
   seconds and bytes by tier (full or delta), snapshot and restore
   seconds, the replay mismatches, the simulated as-run and recommended
   overheads with the recommended env block, and the disk bytes.
5. redundancy — the h2o-danube-1.8b state at full width cut to 12 of its
   24 blocks (PARITY_LAYERS, for the smoke's time; 1,995,043,840 bytes)
   split over 4 ranks as a 4-stage pipeline-parallel job holds it (rank
   0: embedding + layers 0-2, ranks 1-2: 3 layers each, rank 3: layers
   9-11 + final norm + lm_head; 0.42-0.58 GB each, unequal), the ranks
   being SimWorld threads on the one card, CRAFT_TIER_CHAIN=node with
   groups of 4: XOR writes 2 versions (2 layers updated between them),
   loses one node's tree and rebuilds it through xor_reduce; RS
   (CRAFT_RS_PARITY=2) does the same losing two nodes (gf_matmul syndrome
   + inverse); one rotted parity shard is re-encoded by the scrubber, one
   rotted member file is repaired on read.  Every restore is torch.equal
   for every tensor.
6. aft — aft_zone over the same 4 ranks and 12-block state,
   NON-SHRINKING, mem,node with RS (m=2) and one RAM replica: ranks 1 and
   2 die mid-loop and lose their node trees; the final state must equal
   (torch.equal) the same loop run without failures.
7. lanczos — the paper's showcase (§5.1, Table 4, Fig. 8):
   ``repro_torch.apps.lanczos`` on an 8192 x 8192 honeycomb lattice with
   on-site disorder 0.3 (n = 134,217,728; 512 MiB a float32 vector), 200
   iterations, a version every 40, deterministic algorithms on.  Table 4's
   modes (no checkpoint; synchronous pfs with CRAFT_DEVICE_SNAPSHOT=1;
   CRAFT_WRITE_ASYNC=1; the node tier, LOCAL, in the build scratch) must
   give equal alphas and betas; a run crashing at 60 and its
   rerun must restart at 40 and give the same alphas and betas; two
   SimWorld ranks in an AFT zone (one spare node, NON-SHRINKING, async
   writes), rank 0 fail-stopped by ``SimWorld.kill`` at 60, must resume
   from 40 and end on the same numbers; the clean lattice's smallest Ritz
   value must lie within [-3 - 1e-5, -3 + 1e-3] and the disordered one's
   within [-3.3 - 1e-5, -3]; checksum and snapshot launched.
8. cluster — the same scenario on real worker processes
   (``apps.lanczos.cluster_lanczos`` over ``repro_torch.runtime.Cluster``),
   each rank a process with its own CUDA context on the card: (a) the
   lanczos phase's problem and plan, 2 ranks and a spare node,
   NON-SHRINKING, async writes, rank 0 SIGKILLs itself at 60; a spawned
   replacement hydrates from 40; (b) at 4096², 3 ranks, SHRINKING, sync
   writes through the device snapshot, rank 2 SIGKILLed by this process
   once it passed 60.  Every member's alphas and betas must equal an
   uninterrupted one-process run's, the recovery must name the killed
   rank, no worker may outlive its Cluster, and the workers must have
   launched checksum and snapshot (each reports its own counts).  Prints
   per-rank iteration ms, Table 3's recovery phases, the replacement's
   spawn-to-hello seconds, Fig. 8's overheads, per-rank peak device bytes
   and the card's least free memory.
8b. mesh — the sharding layer: (b) h2o-danube-1.8b's parameters at full
   width (3,662,402,560 bytes) as DTensors on a (2, 2) ("data", "model")
   mesh over 4 worker processes sharing the card (a gloo group: NCCL
   refuses two ranks on one device), written to the PFS with the device
   snapshot, then restored on ``shrink_mesh(2, model_parallel=2)`` over 2
   fresh processes (``repro_torch.examples.elastic_restore``): every
   rank's local shard torch.equal to the seeded global state's slice,
   snapshot launched in the writers and checksum in the readers; (c) one
   full-size dry-run cell, h2o-danube-1.8b x train_4k on the 16 x 16
   production mesh (a fake process group of 256 ranks, fake tensors) in
   its own process with its own time limit: per-device bytes, fits_80GB,
   the three roofline terms on the H100's constants and model / traced
   FLOPs; it runs on the host beside (b).  Each part's seconds.  (a),
   the one-rank mesh, is in the train phase.
9. serve — ``repro_torch.launch.serve.run`` on h2o-danube-1.8b,
   zamba2-2.7b, falcon-mamba-7b, deepseek-v3-671b, musicgen-medium (cut
   to depth 24 of 48, ``musicgen-medium-d24``),
   llava-next-34b and kimi-k2-1t-a32b at full width (their CONFIGs;
   deepseek cut to depth 2, one dense and one MoE block beside its MTP
   head's parameters, registered as ``deepseek-v3-671b-d2``; llava cut to
   depth 8, ``llava-next-34b-d8``; kimi to depth 2, one dense and one MoE
   block, ``kimi-k2-1t-a32b-d2``) in bf16, random weights from a seeded
   generator, one model on the card at a time: batch 2, an 8192-token
   prompt (longer than danube's 4096 window; musicgen and llava prefill
   their frontend's stub, 64 frames and 1152 patches, before it) and 32
   greedy tokens uninterrupted; the same with a decode checkpoint
   every 16 tokens (CRAFT_TIER_CHAIN=pfs, CRAFT_DEVICE_SNAPSHOT=1) failing
   at token 20; the resumed run must restart at token 16 and give the
   uninterrupted run's tokens and last logits, every logit finite, every
   attention call of the prefill on the tc_prefill route (one a layer;
   MLA's at dqk 192 / dv 128), of the decode on split_decode (one a layer
   and token; MLA's absorbed decode attends in latent
   space with plain einsums, as the reference: no kernel call), none on
   scalar, and in each run every scan call of the prefill on the
   chunked route and of the decode on the sequential one.  Then
   torch.profiler traces of a few decode steps (the device's busy time and
   idle share) and of one prefill (device seconds by kernel family).
10. train — in a child process (``--phases train-child``, with
   CUBLAS_WORKSPACE_CONFIG=:4096:8 and deterministic algorithms): zamba2-2.7b
   at full width, cut to depth 24 of 54 (``zamba2-2.7b-d24``), through
   ``repro_torch.launch.train.run``, bf16, B 2 x L 2048,
   seeded random weights, AdamW with 32-bit moments, per-block remat: a
   run checkpointing every 2 steps (CRAFT_TIER_CHAIN=pfs,
   CRAFT_DEVICE_SNAPSHOT=1, CRAFT_KEEP_VERSIONS=1; about 11 GB a version) cut
   after step 3, the resumed run (restart at 2, end at 4), both on a
   one-rank (1, 1) NCCL mesh (DTensor state under the sharding rules, the
   hand kernels through ``local_map``), and an uninterrupted mesh-free
   4-step run: losses 3-4, parameters and optimizer state torch.equal; every attention call on tc_prefill and every scan call
   chunked, twice a block and step (remat); checksum and snapshot launched.
   A traced train step splits its device time by family (hand forward
   kernels, attention and scan backwards, cuBLAS matmuls, optimizer,
   elementwise).  Then falcon-mamba-7b at full width, int8 moments, B 2 x
   L 2048: three steps on one batch must lower the loss; a fourth, traced,
   is split the same way.  Deterministic mode's NaN fill of new
   allocations stays on, so an output that a kernel leaves unwritten shows.

Each phase's line carries its wall seconds (``wall_s``), and a line before
the kernel table sums them.
Each path phase (main, control, redundancy, aft, lanczos, cluster, mesh,
serve, train) sets
the kernels' launch counts to 0 before it runs and reads them after (the
cluster and mesh phases add the counts their worker processes report).  Then the
kernel table (JSON), the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line; so does a machine without a CUDA card, or a directory without
the port's sources.  Scratch files go to ``build/`` inside the checkout and
are removed at the end.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 20240116
HBM_BYTES_PER_S = 3.35e12        # H100 SXM published HBM3 rate
INT_OPS_PER_S = 67e12            # published non-tensor 32-bit rate (fp32)
CHUNK_BYTES = 4 * 1024 * 1024
FULL_ROWS, FULL_WPC = 873, CHUNK_BYTES // 4

# h2o-danube-1.8b (configs/h2o_danube_1p8b.py)
N_LAYERS, D_MODEL, N_HEADS, N_KV, HEAD_DIM, D_FF, VOCAB = (
    24, 2560, 32, 8, 80, 6912, 32000)
N_STAGES = 4                     # ranks of the redundancy / aft phases
DEVICE = "cuda"                  # the redundancy / aft / serve phases' device


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of ``fn()`` in milliseconds: ``reps`` calls captured in
    one CUDA graph, replayed and timed with CUDA events, so no host work
    sits between the launches (``cuda_ms`` of a call whose host side
    outlasts its kernels measures the host).  Not torch.profiler: a
    profiler session this early left the later phases' host RSS 12-21 GiB
    higher on the H100."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, 5, 1) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


class Failure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------- phase 1
def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(_build.KERNELS)
    for name in _build.KERNELS:
        _build.load(name)
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in _build.KERNELS:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln
                           or "entry function" in ln]
    return {"phase": "build", "seconds": secs, "card": card_line(),
            "ptxas": ptxas}


# ---------------------------------------------------------------- phase 2
def _max_err(a, b) -> int:
    import torch

    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max()) if ua.numel() else 0


def phase_kernels(results: dict) -> dict:
    import torch

    from repro_torch.kernels.checksum.kernel import checksum_rows
    from repro_torch.kernels.checksum.ref import checksum_rows_ref
    from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda
    from repro_torch.kernels.snapshot.ref import snapshot_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand_words(rows, wpc):
        return torch.randint(-2**31, 2**31, (rows, wpc), dtype=torch.int32,
                             device=dev, generator=g)

    cases = []

    def check(label, words, prev=None):
        ck, ck_ref = checksum_rows(words), checksum_rows_ref(words)
        err = {"checksum": _max_err(ck, ck_ref)}
        require(torch.equal(ck, ck_ref), f"checksum != plain on {label}")
        if prev is None:
            prev = torch.zeros_like(ck)
        for hist in (True, False):
            sn = snapshot_chunks_cuda(words, prev, with_hist=hist)
            sn_ref = snapshot_ref(words, prev, with_hist=hist)
            err[f"snapshot_hist={hist}"] = _max_err(sn, sn_ref)
            require(torch.equal(sn, sn_ref),
                    f"snapshot(with_hist={hist}) != plain on {label}")
            require(torch.equal(sn[:, :2], ck),
                    f"snapshot digest columns != checksum on {label}")
        cases.append({"case": label, "shape": list(words.shape),
                      "max_abs_err": err})
        return ck

    check("random", rand_words(3, 8192 * 2 + 100))
    near = rand_words(4, 4096)
    near[:, ::2] = -1 - (near[:, ::2] & 0xFF)          # 0xFFFFFFxx words
    check("near-2^32", near)
    check("zeros", torch.zeros((5, 1024), dtype=torch.int32, device=dev))
    for wpc in (1, 3, 131, 8193):                       # ragged single rows
        check(f"ragged-1x{wpc}", rand_words(1, wpc))
    # a view starting one word into its storage: not 16-byte aligned
    check("unaligned", rand_words(1, 4101).view(-1)[1:].view(1, 4100))
    w = rand_words(6, 3000)
    dig = checksum_rows(w)
    clean = snapshot_chunks_cuda(w, dig)
    require(bool((clean[:, 2] == 0).all()), "dirty set for prev == current")
    pert = dig.clone()
    pert[::2, 1] += 1
    flag = snapshot_chunks_cuda(w, pert, with_hist=False)[:, 2]
    require(flag.tolist() == [1, 0, 1, 0, 1, 0], "dirty wrong vs perturbed")
    check("prev-perturbed", w, pert)
    # the main path's call shapes: one 4 MiB chunk per restore verification,
    # the embedding (40 chunks) and a q projection (4 chunks) per snapshot
    for rows in (1, 4, 40):
        check(f"main-path-{rows}x{FULL_WPC}", rand_words(rows, FULL_WPC))

    full = rand_words(FULL_ROWS, FULL_WPC)
    ck = check(f"full-{FULL_ROWS}x{FULL_WPC}", full)
    check(f"full-dirty-{FULL_ROWS}x{FULL_WPC}", full, ck)
    nbytes = full.numel() * 4
    word_n = full.numel()
    timing = {
        "checksum": {
            "ms": cuda_ms(lambda: checksum_rows(full)),
            "plain_ms": cuda_ms(lambda: checksum_rows_ref(full), 3, 1),
            "bytes": nbytes + FULL_ROWS * 8,
            "ops": 4 * word_n,       # 2 adds, 1 multiply, 1 index add
        },
        # the main path runs the snapshot without the histogram (it feeds
        # only the zstd gate); the histogram variant is timed beside it
        "snapshot": {
            "ms": cuda_ms(
                lambda: snapshot_chunks_cuda(full, ck, with_hist=False)),
            "plain_ms": cuda_ms(
                lambda: snapshot_ref(full, ck, with_hist=False), 3, 1),
            "bytes": nbytes + FULL_ROWS * 8 + FULL_ROWS * 3 * 4,
            "ops": 4 * word_n,       # the digest; dirty is one compare a row
            "ms_with_hist": cuda_ms(lambda: snapshot_chunks_cuda(full, ck)),
            "plain_ms_with_hist": cuda_ms(lambda: snapshot_ref(full, ck),
                                          3, 1),
            # digest + 8 nibbles x (shift, mask, increment)
            "ops_with_hist": (4 + 24) * word_n,
        },
    }
    for name in ("checksum", "snapshot"):
        t = timing[name]
        t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                            t["ops"] / INT_OPS_PER_S) * 1e3
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / INT_OPS_PER_S else "operations")
        t["GBps"] = t["bytes"] / (t["ms"] * 1e-3) / 1e9
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["max_abs_err"] = max(
            v for c in cases for k, v in c["max_abs_err"].items()
            if k.startswith(name))
    for rows in (1, 40):
        part = full[:rows]
        timing["checksum"][f"ms_{rows}x{FULL_WPC}"] = cuda_ms(
            lambda: checksum_rows(part))
        timing["snapshot"][f"ms_{rows}x{FULL_WPC}"] = cuda_ms(
            lambda: snapshot_chunks_cuda(part, ck[:rows], with_hist=False))
    del full
    torch.cuda.empty_cache()
    parity_kernels(cases, timing, rand_words)
    lm_kernels(cases, timing)
    train_kernels(cases, timing)
    dispatch = dispatch_cost()
    results["timing"] = timing
    return {"phase": "kernels", "cases": cases, "timing": timing,
            "dispatch_us": dispatch}


def dispatch_cost(calls: int = 200, rounds: int = 5) -> dict:
    """Host microseconds a call at the decode shapes of h2o-danube-1.8b
    (attention: q (2, 32, 1, 80) over a (2, 8, 8224, 80) bf16 cache) and
    zamba2-2.7b (the scan: one step of (2, 80, 64) heads, state 64): the
    public op (``attention``, ``selective_scan``: the custom op, then the
    kernel) and the kernel's wrapper called directly: ``host``, the time
    to issue a call, and ``wall``, to its end on the card.  The difference
    of the hosts' is the custom op's dispatch, paid once a layer and token.
    Medians of ``rounds`` rounds of ``calls`` calls, each round ended by a
    sync."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
    )
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.kernel import ssd_scan_cuda

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v = randn(2, 32, 1, 80), randn(2, 8, 8224, 80), randn(2, 8, 8224,
                                                              80)
    kw = dict(causal=True, q_offset=8200, kv_len=8201)
    scan = (randn(2, 1, 80, 64), randn(2, 1, 80, 64), randn(2, 1, 80, 64),
            torch.rand((2, 1, 80), generator=g, device=dev) * 0.5,
            -(0.5 + torch.rand((80,), generator=g, device=dev)),
            randn(2, 80, 64, 64, dtype=torch.float32))
    fns = {"attention_op": lambda: fa_ops.attention(q, k, v, **kw),
           "attention_wrapper": lambda: flash_attention_cuda(q, k, v, **kw),
           "scan_op": lambda: scan_ops.selective_scan(*scan),
           "scan_wrapper": lambda: ssd_scan_cuda(*scan)}
    out = {}
    with torch.no_grad():
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            host, wall = [], []
            for _ in range(rounds):
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                host.append((t1 - t0) / calls * 1e6)
                wall.append((time.perf_counter() - t0) / calls * 1e6)
            out[name] = {"host": statistics.median(host),
                         "wall": statistics.median(wall)}
    for op in ("attention", "scan"):
        out[f"{op}_dispatch_host"] = (out[f"{op}_op"]["host"]
                                      - out[f"{op}_wrapper"]["host"])
    return out


def gf_ops(matrix) -> int:
    """Integer operations per word of a GF(2^8) matrix product: for each
    non-zero coefficient c, one XOR per set bit and one 6-op xtime per bit
    below the highest."""
    return sum(bin(int(c)).count("1") + 6 * (int(c).bit_length() - 1)
               for row in matrix for c in row if int(c))


def parity_kernels(cases: list, timing: dict, rand_words) -> None:
    """xor_reduce and gf_matmul against their plain versions, bit-exact,
    then one full-size call each (4 members of the largest pipeline
    stage's size) timed beside its plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels.rs_erasure.kernel import gf_matmul_cuda
    from repro_torch.kernels.rs_erasure.ops import gf_mat_inv, rs_matrix
    from repro_torch.kernels.rs_erasure.ref import gf_matmul_ref
    from repro_torch.kernels.xor_parity.kernel import xor_reduce_cuda
    from repro_torch.kernels.xor_parity.ref import xor_reduce_ref

    def gf_plain(words, mat):
        return gf_matmul_ref(words.view(torch.uint8), mat).view(torch.int32)

    def check(label, words, mat):
        x = xor_reduce_cuda(words)
        x_ref = xor_reduce_ref(words)
        g = gf_matmul_cuda(words, mat)
        g_ref = gf_plain(words, mat)
        err = {"xor_reduce": _max_err(x, x_ref),
               "gf_matmul": _max_err(g, g_ref)}
        require(torch.equal(x, x_ref), f"xor_reduce != plain on {label}")
        require(torch.equal(g, g_ref), f"gf_matmul != plain on {label}")
        cases.append({"case": label, "shape": list(words.shape),
                      "matrix": np.asarray(mat).shape, "max_abs_err": err})

    rng = np.random.default_rng(SEED)
    special = np.array([0, 1, 2, 0x80, 0xFF, 0x1B, 0x53, 0xCA], np.uint8)
    for g in range(1, 9):
        for n in (1, 5, 128, 4099, 70_001):            # ragged widths
            w = rand_words(g, n)
            w[g // 2] = 0                               # an all-zero row
            mat = rng.integers(0, 256, (3, g), dtype=np.uint8)
            mat[0] = special[:g]
            check(f"g{g}-n{n}", w, mat)
    every = rng.permutation(256).astype(np.uint8).reshape(32, 8)
    check("every-coefficient", rand_words(8, 8192 + 3), every)
    enc = rs_matrix(4, 2)
    inv = gf_mat_inv(enc[np.ix_([0, 1], [1, 2])])      # lose members 1, 2
    check("rs_matrix(4,2)", rand_words(4, 100_003), enc)
    check("decode-inverse", rand_words(2, 100_003), inv)
    flat = rand_words(1, 4 * 4099 + 1).view(-1)[1:]    # not 16-B aligned
    check("unaligned", flat.view(4, 4099), enc)

    n = stage_words()
    full = rand_words(4, n)
    check(f"full-4x{n}", full, enc)
    synd = rand_words(2, n)
    check(f"full-decode-2x{n}", synd, inv)
    timing["xor_reduce"] = {
        "shape": [4, n],
        "ms": cuda_ms(lambda: xor_reduce_cuda(full)),
        "plain_ms": cuda_ms(lambda: xor_reduce_ref(full), 3, 1),
        "bytes": (4 + 1) * n * 4,
        "ops": 3 * n,                       # one XOR per word and row after 0
    }
    timing["gf_matmul"] = {
        "shape": [4, n], "matrix": enc.tolist(),
        "ms": cuda_ms(lambda: gf_matmul_cuda(full, enc)),
        "plain_ms": cuda_ms(lambda: gf_plain(full, enc), 3, 1),
        "bytes": (4 + 2) * n * 4,
        "ops": gf_ops(enc) * n,
        "decode_ms": cuda_ms(lambda: gf_matmul_cuda(synd, inv)),
        "decode_bound_ms": max((2 + 2) * n * 4 / HBM_BYTES_PER_S,
                               gf_ops(inv) * n / INT_OPS_PER_S) * 1e3,
    }
    for name in ("xor_reduce", "gf_matmul"):
        t = timing[name]
        t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                            t["ops"] / INT_OPS_PER_S) * 1e3
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / INT_OPS_PER_S else "operations")
        t["ops_bound_ms"] = t["ops"] / INT_OPS_PER_S * 1e3
        t["GBps"] = t["bytes"] / (t["ms"] * 1e-3) / 1e9
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["max_abs_err"] = max(c["max_abs_err"].get(name, 0) for c in cases)
    del full, synd
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- LM kernels
FLOPS_BF16 = 989e12              # H100 SXM dense bf16 tensor-core rate
FLOPS_FP32 = 67e12               # H100 SXM non-tensor fp32 rate
# exp2 on the special-function units: 16 a clock per SM (compute capability
# 9.0), 132 SMs at the 1980 MHz boost clock
EXP_PER_S = 16 * 132 * 1.98e9
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # as tests/test_kernels.py
# (rtol, atol) of bf16 at the serving path's shapes: rows there attend to
# up to 8224 keys, so |out| falls to about 0.02 and an atol of 2e-2 would
# pass a dropped key tile; 2e-3 is about ten bf16 ulps of such a row
ATTN_TOL_FULL = (2e-2, 2e-3)
MLA_DQK, MLA_DV = 128 + 64, 128  # deepseek-v3's qk (nope + rope) and v dims
FRONTEND_PREFILLS = ("musicgen_prefill", "llava_prefill")
# the scans against the plain chunked scan: the two associate the float
# sums in another order and the state compounds it over L steps
SCAN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
SCAN_TOL_FULL = (1e-4, 1e-3)     # (rtol, atol), float32 over L = 8192


def attn_pairs(lq: int, lk: int, causal: bool, window, q_offset: int,
               kv_len) -> int:
    """Unmasked (query, key) pairs of one head: the work attention must do."""
    import numpy as np

    qpos = q_offset + np.arange(lq, dtype=np.int64)
    hi = np.full(lq, min(lk, lk if kv_len is None else kv_len), np.int64)
    if causal:
        hi = np.minimum(hi, qpos + 1)
    lo = np.zeros(lq, np.int64)
    if window:
        lo = np.maximum(lo, qpos - window + 1)
    return int(np.clip(hi - lo, 0, None).sum())


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _route_of(before: dict, after: dict) -> str:
    """The one flash_attention route counted between two readings."""
    moved = [r for r in after if after[r] != before[r]]
    require(len(moved) == 1 and after[moved[0]] == before[moved[0]] + 1,
            f"expected one flash_attention route, counted {before} -> "
            f"{after}")
    return moved[0]


def tensor_core_sass(name: str) -> dict:
    """Tensor-core instructions in kernel ``name``'s built library
    (``cuobjdump -sass``): HMMA (mma.sync) and HGMMA (wgmma) counts."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build._lib_path(name))], check=True,
                          capture_output=True, text=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HMMA", "HGMMA")}


def fused_library(q, k, v, lq: int, kv_len) -> dict:
    """PyTorch's fused attention timed on the kernel's inputs (scale
    dqk^-0.5; MLA's dqk 192 / dv 128 too; ``enable_gqa`` where k has fewer
    heads than q), restricted to its fused backends (flash, memory
    efficient, cuDNN): the math backend would hold every score at once.
    Where none of them takes the call (dv != dqk), ``library_ms`` is None
    and ``library`` says why."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    scale = q.shape[-1] ** -0.5
    gqa = q.shape[1] != k.shape[1]
    if lq > 1:
        args, kw = (q, k, v), dict(is_causal=True, scale=scale)
        what = "F.scaled_dot_product_attention(is_causal=True, scale"
    else:                          # decode: every cached key is visible
        args = (q, k[:, :, :kv_len], v[:, :, :kv_len])
        kw = dict(scale=scale)
        what = "F.scaled_dot_product_attention(q, k[:kv_len], v[:kv_len]"
    if gqa:
        kw["enable_gqa"] = True
    what += ", enable_gqa=True)" if gqa else ")"

    def call():
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(*args, **kw)

    try:
        call()
    except RuntimeError as exc:            # no fused backend takes the call
        first = str(exc).strip().splitlines()[0][:200]
        return {"library_ms": None, "library": f"none: {first}"}
    return {"library_ms": cuda_ms(call), "library": what
            + " (flash / memory-efficient / cuDNN backends)"}


def lm_kernels(cases: list, timing: dict) -> None:
    """flash_attention, ssd_scan and s6_scan against their plain versions
    on the card (small cases, then the serving path's full shapes), and
    CUDA-event medians at the path's shapes beside the plain versions and,
    for attention, PyTorch's scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        _launch, choose_route, decode_splits, flash_attention_cuda,
        key_range)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan.kernel import CHUNK as scan_chunk
    from repro_torch.kernels.ssm_scan.kernel import (
        s6_scan_cuda, ssd_scan_cuda)
    from repro_torch.kernels.ssm_scan.kernel import \
        choose_route as choose_scan_route
    from repro_torch.kernels.ssm_scan.ref import (
        chunked_scan_ref, s6_scan_ref, ssd_scan_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    dt_name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # ---- flash_attention: small cases, both dtypes (each route)
    attn_err = 0.0
    for case in [
        # (b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len)
        (1, 2, 2, 128, 128, 64, True, None, 0, None),    # group 1, D 64
        (2, 8, 2, 100, 260, 80, True, None, 160, None),  # group 4, ragged
        (1, 4, 1, 70, 70, 128, True, 16, 0, None),       # window, D 128
        (2, 4, 4, 64, 200, 80, False, None, 0, 137),     # kv_len
        (1, 8, 2, 1, 300, 80, True, None, 250, 251),     # Lq = 1, growing
        (1, 8, 2, 1, 64, 80, False, None, 0, 40),        # Lq = 1, rolling
        (1, 2, 2, 64, 64, 32, True, 8, 0, 4),            # fully masked rows
        (1, 4, 1, 130, 130, 80, False, 32, 0, None),     # window, no causal
        (1, 2, 1, 200, 200, 16, True, None, 0, None),    # D 16
        (2, 4, 2, 333, 517, 80, True, None, 184, None),  # ragged, q_offset
        (1, 4, 2, 257, 400, 64, True, 100, 143, None),   # window mid-tile
        (2, 2, 2, 140, 140, 64, True, 8, 0, 4),          # masked rows, tc
        (1, 2, 2, 100, 100, 40, True, None, 0, None),    # D 40: scalar
        (1, 2, 1, 1, 64, 64, False, None, 0, 0),         # no key at all
        (1, 1, 1, 64, 200, 64, True, 16, 100, None),     # a masked split
    ]:
        b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len = case
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len)
        for dtype in (torch.float32, torch.bfloat16):
            q = randn((b, lq, hq, d), dtype).transpose(1, 2)
            k, v = randn((b, hkv, lk, d), dtype), randn((b, hkv, lk, d), dtype)
            r0 = dict(flash_attention_cuda.routes)
            out, ref = flash_attention_cuda(q, k, v, **kw), attention_ref(
                q, k, v, **kw)
            torch.cuda.synchronize()
            route = _route_of(r0, flash_attention_cuda.routes)
            require(route == choose_route(dtype, lq, hq // hkv, d),
                    f"flash_attention took {route} on {case} {dtype}")
            tol = ATTN_TOL[dt_name[dtype]]
            err = _err(out, ref)
            require(torch.allclose(out.float(), ref.float(), rtol=tol,
                                   atol=tol),
                    f"flash_attention != plain on {case} {dtype}: {err}")
            if kv_len == 4:
                require(not bool(out[:, :, 12:].any()),
                        "a fully masked row is not 0")
            if kv_len == 0:
                require(not bool(out.any()), "a row with no key is not 0")
            attn_err = max(attn_err, err)
            cases.append({"case": f"flash {case}", "dtype": dt_name[dtype],
                          "route": route,
                          "max_abs_err": {"flash_attention": err}})

    # ---- MLA's head dims (dqk = 128 + 64, dv = 128) on each route: bf16
    # prefill on tc_prefill, float32 prefill on scalar, decode steps on
    # split_decode in both dtypes
    for case in [
        # (b, h, lq, lk, q_offset, kv_len), causal, one kv head a q head
        (1, 4, 200, 200, 0, None),
        (2, 2, 333, 517, 184, None),          # ragged, q_offset
        (1, 2, 140, 140, 0, 4),               # kv_len inside the tile
        (1, 8, 1, 300, 299, 300),             # decode step
        (2, 128, 1, 1000, 999, 1000),         # decode, MLA's 128 heads
        (1, 2, 64, 64, 0, 0),                 # no key at all
    ]:
        b, h, lq, lk, q_offset, kv_len = case
        kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
        for dtype in (torch.float32, torch.bfloat16):
            q = randn((b, lq, h, MLA_DQK), dtype).transpose(1, 2)
            k = randn((b, h, lk, MLA_DQK), dtype)
            v = randn((b, h, lk, MLA_DV), dtype)
            r0 = dict(flash_attention_cuda.routes)
            out, ref = flash_attention_cuda(q, k, v, **kw), attention_ref(
                q, k, v, **kw)
            torch.cuda.synchronize()
            route = _route_of(r0, flash_attention_cuda.routes)
            require(route == choose_route(dtype, lq, 1, MLA_DQK, MLA_DV)
                    and out.shape == (b, h, lq, MLA_DV),
                    f"flash_attention took {route} (out {tuple(out.shape)}) "
                    f"on MLA {case} {dtype}")
            tol = ATTN_TOL[dt_name[dtype]]
            err = _err(out, ref)
            require(torch.allclose(out.float(), ref.float(), rtol=tol,
                                   atol=tol),
                    f"flash_attention != plain on MLA {case} {dtype}: {err}")
            if kv_len == 0:
                require(not bool(out.any()), "a row with no key is not 0")
            attn_err = max(attn_err, err)
            cases.append({"case": f"flash MLA {case}", "dims": [MLA_DQK,
                                                                MLA_DV],
                          "dtype": dt_name[dtype], "route": route,
                          "max_abs_err": {"flash_attention": err}})

    # ---- the serving path's attention shapes (bf16, B = 2, L = 8192)
    L, B = 8192, 2
    shapes = {
        # danube prefill: GQA 32/8, window 4096
        "danube_prefill": (32, 8, L, L, True, 4096, 0, None),
        # zamba2 shared block prefill: MHA 32/32, causal
        "zamba2_prefill": (32, 32, L, L, True, None, 0, None),
        # one decode step over the full cache: danube's rolling window and
        # zamba2's growing cache (prompt 8192 + 32 generated)
        "danube_decode": (32, 8, 1, 4096, False, None, 0, 4096),
        "zamba2_decode": (32, 32, 1, L + 32, True, None, L + 31, L + 32),
        # deepseek-v3's MLA prefill (128 heads re-expanded from the latent,
        # dqk 192, dv 128) and one step of its re-expanded decode
        "mla_prefill": (128, 128, L, L, True, None, 0, None),
        "mla_decode": (128, 128, 1, L + 32, True, None, L + 31, L + 32),
        # the frontend models' prefills over their stub prefix and the
        # prompt: musicgen-medium's MHA 24 x 64 (8256 rows, so the last
        # 128-row tile is ragged) and llava-next-34b's GQA 56/8 x 128
        "musicgen_prefill": (24, 24, L + 64, L + 64, True, None, 0, None),
        "llava_prefill": (56, 8, L + 1152, L + 1152, True, None, 0, None),
    }
    dims = {"mla_prefill": (MLA_DQK, MLA_DV), "mla_decode": (MLA_DQK, MLA_DV),
            "musicgen_prefill": (64, 64), "llava_prefill": (128, 128)}
    attn = {}
    for name, (hq, hkv, lq, lk, causal, window, q_offset, kv_len) in \
            shapes.items():
        dqk, dv = dims.get(name, (HEAD_DIM, HEAD_DIM))
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len)
        # float32 first, at the float32 tolerance: a wrong mask edge or
        # offset moves these rows by far more than 2e-5
        q = randn((B, hq, lq, dqk))
        k, v = randn((B, hkv, lk, dqk)), randn((B, hkv, lk, dv))
        r0 = dict(flash_attention_cuda.routes)
        out, ref = (flash_attention_cuda(q, k, v, **kw),
                    attention_ref(q, k, v, **kw))
        route32 = _route_of(r0, flash_attention_cuda.routes)
        err32, tol = _err(out, ref), ATTN_TOL["float32"]
        require(torch.allclose(out, ref, rtol=tol, atol=tol),
                f"flash_attention != plain at {name} float32: {err32}")
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        r0 = dict(flash_attention_cuda.routes)
        out, ref = (flash_attention_cuda(q, k, v, **kw),
                    attention_ref(q, k, v, **kw))
        route = _route_of(r0, flash_attention_cuda.routes)
        require(route == ("tc_prefill" if lq > 1 else "split_decode"),
                f"flash_attention took {route} at {name} bfloat16")
        err = _err(out, ref)
        ref_std = float(ref.float().std())
        rtol, atol = ATTN_TOL_FULL
        require(torch.allclose(out.float(), ref.float(), rtol=rtol,
                               atol=atol),
                f"flash_attention != plain at {name}: {err} "
                f"(ref std {ref_std})")
        del out, ref
        pairs = attn_pairs(lq, lk, causal, window, q_offset, kv_len)
        flops = 2 * (dqk + dv) * B * hq * pairs
        # each input read once: q, the visible K/V rows, the output written
        k_begin, k_end = key_range(lq, lk, causal, window, q_offset, kv_len)
        nbytes = 2 * (q.numel() + B * hq * lq * dv
                      + B * hkv * (k_end - k_begin) * (dqk + dv))
        kwl = dict(causal=causal, window=window or 0, sm_scale=dqk ** -0.5,
                   q_offset=q_offset, kv_len=kv_len or lk)
        scratch = q.new_empty((B, hq, lq, dv))
        t = {"shape": {"q": list(q.shape), "k": list(k.shape),
                       "v": list(v.shape),
                       "causal": causal, "window": window,
                       "q_offset": q_offset, "kv_len": kv_len},
             "route": route, "float32_route": route32,
             "ms": cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
             "device_ms": graph_ms(lambda: flash_attention_cuda(q, k, v,
                                                                **kw)),
             # the scalar route (PR 13's kernel) on the same bf16 inputs
             "scalar_ms": cuda_ms(lambda: _launch("scalar", q, k, v, scratch,
                                                  **kwl), 5, 1),
             "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, **kw), 3, 1),
             "bytes": nbytes, "flops": flops, "max_abs_err": err,
             "float32_err": err32, "ref_std": ref_std}
        if route == "split_decode":
            t["splits"] = list(decode_splits(
                B, hkv, k_end - k_begin,
                torch.cuda.get_device_properties(0).multi_processor_count))
        t["bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                            flops / FLOPS_BF16) * 1e3
        t["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / FLOPS_BF16 else "operations")
        t["TFLOPs"] = flops / (t["ms"] * 1e-3) / 1e12
        t["GBps"] = nbytes / (t["ms"] * 1e-3) / 1e9
        # PyTorch's fused attention on the same inputs (timed only)
        if name.startswith("mla") or name in FRONTEND_PREFILLS:
            t.update(fused_library(q, k, v, lq, kv_len))
        elif name == "zamba2_prefill":
            t["library"] = "F.scaled_dot_product_attention(is_causal=True)"
            t["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
        elif name == "danube_prefill":
            qp = torch.arange(lq, device=dev)[:, None]
            kp = torch.arange(lk, device=dev)[None, :]
            mask = (kp <= qp) & (kp > qp - window)
            t["library"] = ("F.scaled_dot_product_attention(attn_mask="
                            "bool causal window, enable_gqa=True)")
            t["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True))
            del mask
        else:                      # decode: every cached key is visible
            t["library"] = ("F.scaled_dot_product_attention(q, k[:, :, "
                            ":kv_len], v[:, :, :kv_len], enable_gqa=True)")
            t["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k[:, :, :kv_len], v[:, :, :kv_len], enable_gqa=True))
        attn[name] = t
        del q, k, v, scratch
        torch.cuda.empty_cache()
    # the table's row: the zamba2 prefill, the shape where one library call
    # computes the same function with no mask tensor; MLA's and the
    # frontend models' prefills beside
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library", "max_abs_err", "float32_err")
    row = dict(attn["zamba2_prefill"])
    row.update({"max_abs_err": max(attn_err, max(
        a["max_abs_err"] for a in attn.values())), "shapes": attn,
        "sass": tensor_core_sass("flash_attention")})
    for name in ("mla_prefill", *FRONTEND_PREFILLS):
        row[name] = {k: attn[name][k] for k in keep}
    require(row["sass"]["HMMA"] + row["sass"]["HGMMA"] > 0,
            f"no tensor-core instruction in flash_attention: {row['sass']}")
    timing["flash_attention"] = row

    # ---- scans: small cases, both dtypes
    def scan_inputs(mamba2, b, l, heads, st, dtype, dt_zero=True):
        if mamba2:
            nh, hd = heads
            xs, ss, dts, a_s, hs = ((b, l, nh, hd), (b, l, nh, st),
                                    (b, l, nh), (nh,), (b, nh, hd, st))
        else:
            (di,) = heads
            xs, ss, dts, a_s, hs = ((b, l, di), (b, l, st), (b, l, di),
                                    (di, st), (b, di, st))
        dt = torch.rand(dts, generator=g, device=dev) * 0.5
        if dt_zero:
            dt[:, ::5] = 0.0
        A = -(0.5 + 1.5 * torch.rand(a_s, generator=g, device=dev))
        return (randn(xs, dtype), randn(ss, dtype), randn(ss, dtype), dt, A,
                randn(hs))

    scan_err = {"ssd_scan": 0.0, "s6_scan": 0.0}
    wrappers = {"ssd_scan": ssd_scan_cuda, "s6_scan": s6_scan_cuda}

    def scan_route(name, *args, **kw):
        """The scan's result and the one route it was counted under."""
        fn = wrappers[name]
        r0 = dict(fn.routes)
        out = fn(*args, **kw)
        moved = [r for r in fn.routes if fn.routes[r] != r0[r]]
        require(len(moved) == 1, f"{name}: routes {r0} -> {fn.routes}")
        return out, moved[0]

    # L = 1 and short L take the sequential route; L = 1000 (eight chunks,
    # a ragged tail) the chunked one
    for mamba2, b, l, heads, st in [
        (True, 2, 1, (3, 64), 64), (True, 1, 37, (2, 64), 64),
        (True, 2, 160, (3, 16), 8), (True, 1, 33, (2, 16), 48),
        (True, 2, 1000, (3, 64), 64), (True, 1, 1000, (2, 16), 48),
        (False, 1, 1, (64,), 16), (False, 2, 45, (100,), 16),
        (False, 2, 96, (256,), 8), (False, 1, 17, (64,), 40),
        (False, 2, 1000, (100,), 16), (False, 1, 1000, (64,), 40),
    ]:
        plain = ssd_scan_ref if mamba2 else s6_scan_ref
        name = "ssd_scan" if mamba2 else "s6_scan"
        want = choose_scan_route(l, (b, *heads, st))
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(mamba2, b, l, heads, st, dtype)
            (y, h), route = scan_route(name, *args)
            require(route == want, f"{name} took {route} at L = {l}")
            y_r, h_r = plain(*args)
            torch.cuda.synchronize()
            rtol, atol = SCAN_TOL[dt_name[dtype]]
            err = max(_err(y, y_r), _err(h, h_r))
            require(torch.allclose(y.float(), y_r.float(), rtol=rtol,
                                   atol=atol)
                    and torch.allclose(h, h_r, rtol=rtol, atol=atol),
                    f"{name} != plain on {(b, l, heads, st)} {dtype}: {err}")
            scan_err[name] = max(scan_err[name], err)
            cases.append({"case": f"{name} {(b, l, heads, st)}",
                          "dtype": dt_name[dtype], "route": route,
                          "max_abs_err": {name: err}})

    # ---- the serving path's scan shapes (float32, B = 2, L = 8192), as the
    # models call them: zamba2 (80 heads of 64, state 64, one B/C group
    # broadcast over the heads) and falcon-mamba-7b (8192 channels, state
    # 16); both routes on the same inputs, each against the plain scan
    def path_args(mamba2, b, l, heads, st):
        args = list(scan_inputs(mamba2, b, l, heads, st, torch.float32,
                                dt_zero=False))
        args[3] = args[3] * 0.05          # softplus(-4 + ...)-sized steps
        if mamba2:
            args[1] = args[1][:, :, :1].expand(-1, -1, heads[0], -1)
            args[2] = args[2][:, :, :1].expand(-1, -1, heads[0], -1)
        return args

    for name, mamba2, heads, st in (("ssd_scan", True, (80, 64), 64),
                                    ("s6_scan", False, (8192,), 16)):
        kernel = wrappers[name]
        args = path_args(mamba2, B, L, heads, st)
        (y, h), route = scan_route(name, *args)
        require(route == "chunked", f"{name} took {route} at the path shape")
        y_r, h_r = chunked_scan_ref(*args)
        err = max(_err(y, y_r), _err(h, h_r))
        rtol, atol = SCAN_TOL_FULL
        require(torch.allclose(y, y_r, rtol=rtol, atol=atol)
                and torch.allclose(h, h_r, rtol=rtol, atol=atol),
                f"{name} (chunked) != plain at the path's shape: {err}")
        (y, h), _ = scan_route(name, *args, route="sequential")
        err_seq = max(_err(y, y_r), _err(h, h_r))
        require(torch.allclose(y, y_r, rtol=rtol, atol=atol)
                and torch.allclose(h, h_r, rtol=rtol, atol=atol),
                f"{name} (sequential) != plain at the path's shape: "
                f"{err_seq}")
        del y, h, y_r, h_r
        state = B * L * (heads[0] * heads[1] if mamba2 else heads[0]) * st
        if mamba2:
            # h = fma(decay, h, x * b) and y = fma(h, c, y): 5 flops a state
            # value and step; one exp a head and step
            flops = 5 * state + B * L * heads[0]
            exps = B * L * heads[0]
            nbytes = 4 * (2 * args[0].numel() + 2 * B * L * st
                          + args[3].numel() + args[4].numel()
                          + 2 * args[5].numel())
        else:
            # exp(dt * A) adds a multiply and an exp: 7 a state value
            flops = 7 * state
            exps = state
            nbytes = 4 * (3 * args[0].numel() + 2 * B * L * st
                          + args[4].numel() + 2 * args[5].numel())
        terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "fp32": flops / FLOPS_FP32 * 1e3,
                 "exp": exps / EXP_PER_S * 1e3}
        bound_by = max(terms, key=terms.get)
        t = {"shape": [list(a.shape) for a in args], "route": route,
             "chunk": scan_chunk,
             "ms": cuda_ms(lambda: kernel(*args), 5, 1),
             # the sequential route (PR 13's kernel) on the same inputs
             "sequential_ms": cuda_ms(
                 lambda: kernel(*args, route="sequential"), 3, 1),
             "plain_ms": cuda_ms(lambda: chunked_scan_ref(*args), 3, 1),
             "plain": "ref.chunked_scan_ref (chunk 256)",
             "bytes": nbytes, "flops": flops, "exps": exps,
             "bound_terms_ms": terms,
             "bound_ms": terms[bound_by],
             "bound_by": "bytes" if bound_by == "bytes" else "operations",
             "bound_unit": bound_by,
             "max_abs_err": max(scan_err[name], err, err_seq),
             "full_shape_err": err, "full_shape_err_sequential": err_seq,
             "library_ms": None,
             "library": "none: PyTorch has no selective scan"}
        timing[name] = t
        del args
        torch.cuda.empty_cache()

    # ---- where the chunked route starts to pay: both routes over L at the
    # path's widths (B = 2), and at B = 16 for the full L
    sweep = []
    for name, mamba2, heads, st in (("ssd_scan", True, (80, 64), 64),
                                    ("s6_scan", False, (8192,), 16)):
        kernel = wrappers[name]
        for b, l in ((2, 16), (2, 32), (2, 64), (2, 128), (2, 256),
                     (2, 512), (2, 1024), (2, 2048), (16, 8192)):
            args = path_args(mamba2, b, l, heads, st)
            sweep.append({
                "scan": name, "B": b, "L": l,
                "rule": choose_scan_route(l, (b, *heads, st)),
                "chunked_ms": cuda_ms(
                    lambda: kernel(*args, route="chunked"), 5, 1),
                "sequential_ms": cuda_ms(
                    lambda: kernel(*args, route="sequential"), 5, 1)})
            del args
            torch.cuda.empty_cache()
    timing["scan_sweep"] = sweep


# ------------------------------------------------ the training path's kernels
LSE_TOL = (1e-5, 1e-4)           # (rtol, atol): float32 sums, another order
# gradients against the plain version's autograd in float32, as a share of
# each gradient's largest magnitude: bf16 inputs and outputs round at 2^-8
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SCAN_GRAD_TOL = 1e-4             # float32 scans, share of the largest |g|


def _grad_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.detach().float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def train_kernels(cases: list, timing: dict) -> None:
    """The training path's use of the LM kernels on the card: the
    attention kernel's log-sum-exp against the plain one on both routes
    that write it; the attention Function (kernel forward, blocked
    backward) and the scan Function (chunked-route forward, plain
    backward) against the plain versions' autograd."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse_ref, attention_ref)
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.kernel import (
        CHUNK as scan_chunk, s6_scan_cuda, ssd_scan_cuda)
    from repro_torch.kernels.ssm_scan.ref import chunked_scan_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 29)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out: dict = {"lse": [], "attention_grads": [], "scan_grads": []}
    # ---- lse: tc_prefill (bf16, > 64 rows), scalar (float32, or <= 64
    # rows), rows that see no key, kv_len 0, and zamba2's width at L 4096
    for case in [
        # (b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len)
        (1, 2, 2, 128, 128, 64, True, None, 0, None),
        (2, 8, 2, 100, 260, 80, True, None, 160, None),
        (1, 4, 1, 200, 200, 80, True, 16, 0, None),
        (2, 2, 2, 140, 140, 64, True, 8, 0, 4),
        (1, 2, 2, 100, 100, 64, False, None, 0, 0),
        (1, 2, 1, 40, 40, 64, True, None, 0, None),
        (2, 32, 32, 4096, 4096, 80, True, None, 0, None),
    ]:
        b, hq, hkv, lq, lk, d, causal, window, q_offset, kv_len = case
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len)
        for dtype in (torch.float32, torch.bfloat16):
            q = randn((b, hq, lq, d), dtype)
            k, v = randn((b, hkv, lk, d), dtype), randn((b, hkv, lk, d), dtype)
            r0 = dict(flash_attention_cuda.routes)
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
            route = _route_of(r0, flash_attention_cuda.routes)
            want = ("tc_prefill" if dtype == torch.bfloat16
                    and lq * hq // hkv > 64 else "scalar")
            require(route == want, f"lse call took {route} on {case}")
            o_r, lse_r = attention_lse_ref(q, k, v, **kw)
            err = _err(lse, lse_r)
            require(torch.allclose(lse, lse_r, rtol=LSE_TOL[0],
                                   atol=LSE_TOL[1])
                    and torch.equal(lse == -1e30, lse_r == -1e30),
                    f"flash_attention lse != plain on {case} {dtype}: {err}")
            require(torch.allclose(o.float(), o_r.float(), rtol=2e-2,
                                   atol=2e-2 if dtype == torch.bfloat16
                                   else 2e-5),
                    f"flash_attention out (with lse) != plain on {case}")
            out["lse"].append({"case": list(case), "dtype": str(dtype),
                               "route": route, "max_abs_err": err,
                               "empty_rows": int((lse_r == -1e30).sum())})
            del q, k, v, o, lse, o_r, lse_r
    torch.cuda.empty_cache()
    # ---- attention gradients at zamba2's width (32 heads of 80), causal,
    # L = 2048 (the plain version's (1, 32, L, L) float32 scores fit), and
    # GQA 4 with a window: the kernel's forward and the blocked backward
    # against the plain version's autograd in float32 on the same values
    for b, hq, hkv, l, window in ((1, 32, 32, 2048, None),
                                  (1, 32, 8, 1024, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((b, h, l, HEAD_DIM), dtype)
                       for h in (hq, hkv, hkv))
            dout = randn((b, hq, l, HEAD_DIM), dtype)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            r0 = dict(flash_attention_cuda.routes)
            o = fa_ops.attention(*leaves, causal=True, window=window)
            route = _route_of(r0, flash_attention_cuda.routes)
            o.backward(dout)
            ref = [t.float().requires_grad_() for t in (q, k, v)]
            o_r = attention_ref(*ref, causal=True, window=window)
            o_r.backward(dout.float())
            errs = {n: _grad_err(a, w) for n, a, w in zip(
                ("out", "dq", "dk", "dv"), [o] + [t.grad for t in leaves],
                [o_r] + [t.grad for t in ref])}
            tol = GRAD_TOL["bfloat16" if dtype == torch.bfloat16
                           else "float32"]
            require(max(errs.values()) <= tol,
                    f"attention gradients != plain at {(b, hq, hkv, l)} "
                    f"{dtype}: {errs}")
            out["attention_grads"].append(
                {"shape": [b, hq, hkv, l, HEAD_DIM], "window": window,
                 "dtype": str(dtype), "route": route,
                 "max_err_over_max": errs, "tol": tol})
            del q, k, v, dout, leaves, o, ref, o_r
            torch.cuda.empty_cache()
    # ---- scan gradients at both models' widths, the Function's forward on
    # the chunked route at L = 1024 and at L = 40 (one ragged chunk, where
    # serving takes the sequential route), a stride-0 head axis of B/C for
    # mamba2 (the model's call)
    for name, mamba2, heads, st in (("ssd_scan", True, (80, 64), 64),
                                    ("s6_scan", False, (8192,), 16)):
        kernel = ssd_scan_cuda if mamba2 else s6_scan_cuda
        for l in (1024, 40):
            b = 1
            if mamba2:
                nh, hd = heads
                xs, ss, dts, a_s, hs = ((b, l, nh, hd), (b, l, 1, st),
                                        (b, l, nh), (nh,), (b, nh, hd, st))
            else:
                (di,) = heads
                xs, ss, dts, a_s, hs = ((b, l, di), (b, l, st), (b, l, di),
                                        (di, st), (b, di, st))
            base = [randn(xs), randn(ss), randn(ss),
                    torch.rand(dts, generator=g, device=dev) * 0.05,
                    -(0.5 + 1.5 * torch.rand(a_s, generator=g, device=dev)),
                    randn(hs)]
            dy = randn(xs)
            dh = randn(hs)

            def run(fn):
                leaves = [t.clone().requires_grad_() for t in base]
                bh, ch = leaves[1], leaves[2]
                if mamba2:
                    bh, ch = (t.expand(-1, -1, heads[0], -1)
                              for t in (bh, ch))
                y, h = fn(leaves[0], bh, ch, *leaves[3:])
                ((y * dy).sum() + (h * dh).sum()).backward()
                return leaves

            ref = run(lambda *a: chunked_scan_ref(*a, chunk=scan_chunk))
            r0 = dict(kernel.routes)
            got = run(scan_ops.selective_scan)
            used = {r: n - r0[r] for r, n in kernel.routes.items()}
            require(used == {"sequential": 0, "chunked": 1},
                    f"{name} Function forward at L {l} took {used}")
            errs = {n: _grad_err(a.grad, w.grad) for n, a, w in zip(
                ("dtx", "B", "C", "dt", "A", "h0"), got, ref)}
            require(max(errs.values()) <= SCAN_GRAD_TOL,
                    f"{name} gradients at L {l} != plain: {errs}")
            out["scan_grads"].append({"scan": name, "route": "chunked",
                                      "shape": list(xs), "state": st,
                                      "max_err_over_max": errs,
                                      "tol": SCAN_GRAD_TOL})
            del got, ref, base
        torch.cuda.empty_cache()
    timing["flash_attention"]["lse_max_abs_err"] = max(
        c["max_abs_err"] for c in out["lse"])
    timing["train_backward"] = out
    cases.append({"case": "training path", "max_abs_err": {
        "flash_attention_lse": timing["flash_attention"]["lse_max_abs_err"]}})


# ---------------------------------------------------------------- phase 3
def danube_shapes(n_layers: int = N_LAYERS) -> dict:
    """Shapes of the h2o-danube-1.8b parameter set, by state-dict key
    (``n_layers`` of its blocks)."""
    d, hd = D_MODEL, HEAD_DIM
    shapes = {"embed.embedding": (VOCAB, d), "final_ln": (d,),
              "lm_head": (d, VOCAB)}
    for i in range(n_layers):
        p = f"blocks.{i:02d}."
        shapes.update({
            p + "ln1": (d,), p + "ln2": (d,),
            p + "attn.wq": (d, N_HEADS, hd), p + "attn.wk": (d, N_KV, hd),
            p + "attn.wv": (d, N_KV, hd), p + "attn.wo": (N_HEADS, hd, d),
            p + "ffn.w_gate": (d, D_FF), p + "ffn.w_up": (d, D_FF),
            p + "ffn.w_down": (D_FF, d),
        })
    return shapes


def danube_state(device, gen, n_layers: int = N_LAYERS):
    """The h2o-danube-1.8b parameter set as a flat bf16 state dict."""
    import torch

    return {k: torch.randn(s, generator=gen, device=device,
                           dtype=torch.bfloat16) * 0.02
            for k, s in danube_shapes(n_layers).items()}


# depth of the redundancy and aft phases' state: their 4 rank threads stage
# every byte on the host, so the smoke's time limit cuts them to half the
# blocks (full width; embedding and lm_head whole)
PARITY_LAYERS = 12


def stage_of(key: str) -> int:
    """The pipeline stage (rank) holding ``key`` in a 4-stage split."""
    if key.startswith("embed."):
        return 0
    if key.startswith("blocks."):
        return int(key.split(".")[1]) // (PARITY_LAYERS // N_STAGES)
    return N_STAGES - 1                       # final_ln, lm_head


def stage_words() -> int:
    """Words of the largest stage's parameters, padded to the parity lane
    (the shape the redundancy path gives the parity kernels)."""
    per = [0] * N_STAGES
    for k, shp in danube_shapes(PARITY_LAYERS).items():
        n = 1
        for x in shp:
            n *= x
        per[stage_of(k)] += 2 * n
    return -(-max(per) // 512) * 128


def _wrappers() -> dict:
    from repro_torch.kernels.checksum.kernel import checksum_rows
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.rs_erasure.kernel import gf_matmul_cuda
    from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda
    from repro_torch.kernels.ssm_scan.kernel import s6_scan_cuda, ssd_scan_cuda
    from repro_torch.kernels.xor_parity.kernel import xor_reduce_cuda

    return {"checksum": checksum_rows, "snapshot": snapshot_chunks_cuda,
            "xor_reduce": xor_reduce_cuda, "gf_matmul": gf_matmul_cuda,
            "flash_attention": flash_attention_cuda,
            "ssd_scan": ssd_scan_cuda, "s6_scan": s6_scan_cuda}


def _counts():
    return {k: w.launches for k, w in _wrappers().items()}


def _reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0
        if hasattr(w, "routes"):
            w.routes = dict.fromkeys(w.routes, 0)


def _attn_routes() -> dict:
    return dict(_wrappers()["flash_attention"].routes)


SCANS = ("ssd_scan", "s6_scan")


def _scan_routes() -> dict:
    return {k: dict(_wrappers()[k].routes) for k in SCANS}


def _scan_route_delta(r0: dict, r1: dict) -> dict:
    return {k: _delta(r0[k], r1[k]) for k in SCANS}


def _require_scan_routes(arch: str, run: str, routes: dict,
                         decode_steps: int) -> None:
    """One serve run's scan calls: one prefill (L = SERVE_PROMPT) of every
    scan layer on the chunked route, ``decode_steps`` steps (L = 1) of
    every scan layer on the sequential route."""
    for k in SERVE_KERNELS[arch]:
        if k not in SCANS:
            continue
        r = routes[k]
        require(r["chunked"] > 0
                and r["sequential"] == decode_steps * r["chunked"],
                f"{arch} {run}: {k} routes {r} for one prefill and "
                f"{decode_steps} decode steps")


def phase_main(results: dict, scratch: Path) -> dict:
    import torch

    from repro_torch.core import Box, Checkpoint, CraftEnv, metrics

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = danube_state(dev, gen)
    n_params = sum(t.numel() for t in state.values())
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    env = CraftEnv.capture({
        "CRAFT_CP_PATH": str(scratch / "pfs"),
        "CRAFT_TIER_CHAIN": "pfs",
        "CRAFT_DEVICE_SNAPSHOT": "1",
        "CRAFT_DELTA": "1",
        "CRAFT_METRICS": "1",
    })
    torch.cuda.synchronize()
    _reset_counts()
    versions = []
    it = Box(0)
    cp = Checkpoint("danube", env=env)
    cp.add("iteration", it)
    cp.add("params", Box(state))
    cp.commit()
    require(not cp.restart_if_needed(), "fresh run found a checkpoint")
    for step in (1, 2, 3):
        if step > 1:            # 2 of 24 layers change in place
            for layer in (2 * step, 2 * step + 1):
                for k, t in state.items():
                    if k.startswith(f"blocks.{layer:02d}."):
                        t.add_(torch.randn(t.shape, generator=gen,
                                           device=dev, dtype=t.dtype) * 0.01)
        it.value = step
        before = dict(cp.stats)
        m0 = metrics.snapshot()["counters"]
        c0 = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        require(cp.need_checkpoint(step), f"policy skipped step {step}")
        cp.update_and_write(step)
        total = time.perf_counter() - t0
        m1 = metrics.snapshot()["counters"]
        c1 = _counts()
        write_s = cp.stats["write_seconds"] - before["write_seconds"]
        chunks = cp.stats["delta_chunks_total"] - before["delta_chunks_total"]
        refs = (cp.stats["delta_chunks_skipped"]
                - before["delta_chunks_skipped"])
        d2h = m1.get("snapshot_d2h_bytes", 0) - m0.get("snapshot_d2h_bytes", 0)
        saved = (m1.get("snapshot_d2h_bytes_saved", 0)
                 - m0.get("snapshot_d2h_bytes_saved", 0))
        versions.append({
            "version": cp.version, "snapshot_s": total - write_s,
            "write_s": write_s, "d2h_bytes": d2h, "d2h_bytes_saved": saved,
            "dirty_fraction": (chunks - refs) / max(1, chunks),
            "chunks": chunks, "ref_chunks": refs,
            "phys_bytes": (cp.stats["tier_bytes_written"]
                           - before["tier_bytes_written"]),
            "launches": {k: c1[k] - c0[k] for k in c1},
        })
    cp.close()
    require(cp.version == 3, f"wrote {cp.version} versions, not 3")
    require(versions[1]["ref_chunks"] > 0, "delta version skipped no chunk")

    live = {k: torch.zeros_like(t) for k, t in state.items()}
    it2 = Box(0)
    cp2 = Checkpoint("danube", env=env)
    cp2.add("iteration", it2)
    cp2.add("params", Box(live))
    cp2.commit()
    c0 = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(cp2.restart_if_needed(), "restore found no checkpoint")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    c1 = _counts()
    cp2.close()
    require(it2.value == 3 and cp2.version == 3, "restored the wrong version")
    bad = [k for k in state if not torch.equal(state[k], live[k])]
    require(not bad, f"restored tensors differ: {bad[:5]}")
    launches = _counts()
    results["launches"] = launches
    results["main_versions"] = versions
    del live
    return {"phase": "main", "params": n_params, "state_bytes": state_bytes,
            "tensors": len(state), "versions": versions,
            "restore_s": restore_s,
            "restore_launches": {k: c1[k] - c0[k] for k in c1},
            "launches": launches, "restore_bit_exact": True,
            "cuts": {"tier_chain": "pfs (node tier cut: disk footprint)"}}


# ---------------------------------------------------------------- phase 4
def phase_default(scratch: Path) -> dict:
    import torch

    from repro_torch.core import Box, Checkpoint, CheckpointError, CraftEnv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    state = {f"t{i}": torch.randn((2048, 4096), generator=gen, device=dev,
                                  dtype=torch.float32)
             for i in range(8)}                      # 8 x 32 MiB = 256 MiB
    env = CraftEnv.capture({"CRAFT_CP_PATH": str(scratch / "pfs"),
                            "CRAFT_NODE_CP_PATH": str(scratch / "node")})
    require(env.codec_version == 1 and env.tier_chain == ("node", "pfs")
            and env.node_redundancy == "PARTNER",
            "defaults are not codec v1 / node,pfs / PARTNER")
    _reset_counts()
    cp = Checkpoint("default", env=env)
    cp.add("state", Box(state))
    cp.commit()
    t0 = time.perf_counter()
    cp.update_and_write(1)
    write_s = time.perf_counter() - t0
    cp.close()
    write_launches = _counts()

    def restore():
        live = {k: torch.zeros_like(t) for k, t in state.items()}
        c = Checkpoint("default", env=env)
        c.add("state", Box(live))
        c.commit()
        try:
            require(c.restart_if_needed(), "default restore found nothing")
        finally:
            c.close()
        return live, c

    t0 = time.perf_counter()
    live, c = restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(all(torch.equal(state[k], live[k]) for k in state),
            "default-path restore differs")
    tiers = sorted({c.stats["restore_tier"]})
    flipped = []
    for root in (scratch / "node", scratch / "pfs"):
        for f in sorted(root.rglob("v-*/state/*.bin")):
            raw = bytearray(f.read_bytes())
            hlen = int.from_bytes(raw[4:12], "little")
            pos = 12 + hlen + 12345
            raw[pos] ^= 0x40
            f.write_bytes(bytes(raw))
            flipped.append(str(f.relative_to(scratch)))
            break
    require(len(flipped) == 2, f"found {flipped} payload files to flip")
    try:
        restore()
    except CheckpointError as exc:
        require("checksum mismatch" in str(exc),
                f"corrupt restore raised another error: {exc}")
        detected = str(exc)[:300]
    else:
        raise Failure("a flipped payload byte restored without an error")
    return {"phase": "default",
            "state_bytes": sum(t.numel() * 4 for t in state.values()),
            "write_s": write_s, "restore_s": restore_s,
            "restore_tier": tiers, "write_launches": write_launches,
            "launches": _counts(), "flipped": flipped, "detected": detected}


# ---------------------------------------------------------------- phase 3b
CONTROL_ITERS = 12               # checkpoint opportunities of the loop
CONTROL_EVERY = "node:2,pfs:4"   # the adaptive scheduler's count cadences
CONTROL_CHAOS = "node:eio:p=1+after=4+count=6"


def _control_env(root: Path, **extra):
    from repro_torch.core import CraftEnv

    return CraftEnv.capture({
        "CRAFT_CP_PATH": str(root / "pfs"),
        "CRAFT_NODE_CP_PATH": str(root / "node"),
        "CRAFT_DEVICE_SNAPSHOT": "1",
        "CRAFT_DELTA": "1",
        "CRAFT_KEEP_VERSIONS": "2",
        **extra,
    })


def _top_frame(top, argv) -> list:
    """One ``top --once`` frame as lines (the CLI's own entry point)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = top.main([*argv, "--once", "--no-color"])
    require(rc == 0, f"top {argv} exited {rc}")
    return buf.getvalue().splitlines()


def phase_control(results: dict, scratch: Path) -> dict:
    import torch

    from repro_torch import top
    from repro_torch.core import Box, Checkpoint, telemetry, tiers, trace
    from repro_torch.core.simulate import load_trace, replay

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    state = danube_state(dev, gen)
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    trace_path = scratch / "control-trace.jsonl"
    env = _control_env(
        scratch, CRAFT_TIER_EVERY=CONTROL_EVERY, CRAFT_CHAOS=CONTROL_CHAOS,
        CRAFT_IO_RETRIES="0", CRAFT_IO_BACKOFF_MS="1",
        CRAFT_BREAKER_THRESHOLD="2", CRAFT_BREAKER_COOLDOWN_S="0.05",
        CRAFT_TRACE=str(trace_path), CRAFT_METRICS="1",
        CRAFT_METRICS_PORT="0")
    require(env.tier_chain == ("node", "pfs") and env.delta
            and env.device_snapshot, "control env is not node,pfs + delta "
            "+ device snapshot")
    torch_sync()
    _reset_counts()
    it = Box(0)
    cp = Checkpoint("control", env=env, device=DEVICE)
    cp.add("iteration", it)
    cp.add("params", Box(state))
    cp.commit()
    require(not cp.restart_if_needed(), "fresh run found a checkpoint")
    url = f"http://localhost:{telemetry.port()}"
    versions, live_frame = [], None
    try:
        for step in range(1, CONTROL_ITERS + 1):
            t0 = time.perf_counter()
            for layer in (2 * step % N_LAYERS, (2 * step + 1) % N_LAYERS):
                for k, t in state.items():
                    if k.startswith(f"blocks.{layer:02d}."):
                        t.add_(torch.randn(t.shape, generator=gen,
                                           device=dev, dtype=t.dtype) * 0.01)
            torch_sync()
            cp.policy.observe_step_seconds(time.perf_counter() - t0)
            it.value = step
            if not cp.need_checkpoint(step):
                continue
            before = dict(cp.stats)
            t0 = time.perf_counter()
            cp.update_and_write(step)
            total = time.perf_counter() - t0
            write_s = cp.stats["write_seconds"] - before["write_seconds"]
            versions.append({
                "iteration": step, "version": cp.version,
                "snapshot_s": total - write_s, "write_s": write_s,
                "degraded": (cp.stats["degraded_writes"]
                             - before["degraded_writes"]),
                "node_breaker": cp.health["node"].state})
            if live_frame is None and cp.health["node"].state != "closed":
                # the outage, seen through the live exporter
                live = top.model_from_url(url)
                require(live["breakers"].get("node") not in (None, "closed"),
                        f"exporter shows node breaker {live['breakers']}")
                live_frame = _top_frame(top, ["--url", url])
        cp.wait()
        stats = dict(cp.stats)
        final_version = cp.version
    finally:
        cp.close()
        trace.uninstall()
        telemetry.stop()
    require(live_frame is not None, "the node breaker never left closed")
    require(stats["degraded_writes"] > 0 and stats["breaker_trips"] >= 1,
            f"no degraded route: {stats['degraded_writes']} degraded, "
            f"{stats['breaker_trips']} trips")

    events = load_trace(trace_path)
    writes = [e for e in events if e["kind"] == "tier_write"]
    for v in versions:
        # a version with no ref chunk is self-contained (full), else delta
        v["tiers"] = {e["slot"]: {
            "seconds": e["seconds"], "phys_bytes": e["phys_bytes"],
            "kind": "delta" if e["ref_chunks"] else "full"}
            for e in writes if e["version"] == v["version"]}
    tripped_at = min(e["t"] for e in events if e["kind"] == "breaker")
    readmit = [e for e in writes if e["slot"] == "node"
               and e["t"] > tripped_at]
    require(readmit and readmit[0]["ref_chunks"] == 0
            and not tiers.read_delta_deps(
                scratch / "node" / "node-0" / "control"
                / f"v-{readmit[0]['version']}"),
            "the node tier's re-admission write was not full")
    require(any(e["ref_chunks"] for e in readmit[1:]),
            "no delta version on the node tier after re-admission")

    live = {k: torch.zeros_like(t) for k, t in state.items()}
    it2 = Box(0)
    cp2 = Checkpoint("control", env=_control_env(scratch), device=DEVICE)
    cp2.add("iteration", it2)
    cp2.add("params", Box(live))
    cp2.commit()
    torch_sync()
    t0 = time.perf_counter()
    require(cp2.restart_if_needed(), "restore found no checkpoint")
    torch_sync()
    restore_s = time.perf_counter() - t0
    cp2.close()
    tier = cp2.stats["restore_tier"]
    require(cp2.version == final_version and it2.value == CONTROL_ITERS,
            f"restored v{cp2.version} (iteration {it2.value})")
    vdir = (scratch / "node" / "node-0" if tier == "node"
            else scratch / "pfs") / "control" / f"v-{final_version}"
    deps = sorted(tiers.read_delta_deps(vdir))
    require(deps, f"the restore from {tier} read no delta chain")
    bad = [k for k in state if not torch.equal(state[k], live[k])]
    require(not bad, f"restored tensors differ: {bad[:5]}")
    del live
    launches = _counts()
    require(launches["checksum"] > 0 and launches["snapshot"] > 0,
            f"checksum / snapshot not launched: {launches}")
    results["control_launches"] = launches

    rep = replay(events)
    require(rep.decisions_match,
            f"replay mismatches at {rep.mismatches[:5]}")
    require(rep.tier_landed.get("node") == stats["node_writes"]
            and rep.tier_landed.get("pfs") == stats["pfs_writes"],
            f"replay landed {rep.tier_landed}, live {stats['node_writes']} "
            f"node / {stats['pfs_writes']} pfs")
    require(sum(rep.tier_landed_bytes.values())
            == sum(e["nbytes"] for e in writes),
            "replayed landed bytes differ from the trace's tier writes")
    trace_frame = _top_frame(top, ["--trace", str(trace_path)])

    score = scratch / "tune-scorecard.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--trace",
         str(trace_path), "--json", str(score), "--fail-on-regression"],
        capture_output=True, text=True, timeout=300, cwd=scratch,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    require(proc.returncode == 0,
            f"tune exited {proc.returncode}: {proc.stderr[-2000:]}")
    rows = {r["name"]: r["value"] for r in json.loads(score.read_text())}
    block = proc.stdout[proc.stdout.index("# craft tune"):]
    block = [ln for ln in block.splitlines()
             if ln and not ln.startswith("wrote scorecard")]
    return {"phase": "control", "state_bytes": state_bytes,
            "tensors": len(state), "iterations": CONTROL_ITERS,
            "versions": versions, "restore_s": restore_s,
            "restore_tier": tier, "restore_delta_deps": deps,
            "restore_bit_exact": True,
            "degraded_writes": stats["degraded_writes"],
            "breaker_trips": stats["breaker_trips"],
            "node_writes": stats["node_writes"],
            "pfs_writes": stats["pfs_writes"],
            "replay_decisions": len(rep.sim_decisions),
            "replay_mismatches": len(rep.mismatches),
            "tier_landed_bytes": rep.tier_landed_bytes,
            "as_run_overhead_s": rows["as_run_overhead"],
            "recommended_overhead_s": rows["recommended_overhead"],
            "tune_improvement_pct": rows["improvement"],
            "tune_rc": proc.returncode, "recommended_env": block,
            "top_live": live_frame, "top_trace": trace_frame,
            "disk_bytes": _dir_bytes(scratch), "launches": launches,
            "cuts": {"iterations": f"{CONTROL_ITERS} (the reference test "
                     "runs 40 on 32 KiB)",
                     "keep_versions": "2 (disk footprint)"}}


# ---------------------------------------------------------------- phase 5
STAGES = ("read", "digest", "pad", "h2d", "kernel", "d2h", "write")


def _split(m0: dict, m1: dict) -> dict:
    """Seconds per parity stage (summed over the rank threads) between two
    metrics snapshots: member/parity file reads, digests, host padding, H2D,
    kernel, D2H and parity/member writes."""
    return {k: m1.get(f"parity_seconds|stage={k}", 0.0)
            - m0.get(f"parity_seconds|stage={k}", 0.0) for k in STAGES}


def _delta(c0: dict, c1: dict) -> dict:
    return {k: c1[k] - c0[k] for k in c1}


def rss_gib() -> float:
    """Peak resident set of this process so far, GiB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def split_stages(state: dict) -> list:
    stages = [{} for _ in range(N_STAGES)]
    for k, t in state.items():
        stages[stage_of(k)][k] = t
    return stages


def rank_comm(rank: int, size: int):
    """A one-rank communicator standing for rank ``rank`` of ``size``, one
    rank per node (restores and scrubs of a single rank)."""
    from repro_torch.core import NullComm

    class RankComm(NullComm):
        @property
        def rank(self):
            return rank

        @property
        def size(self):
            return size

        def node_id(self):
            return rank

    return RankComm()


def update_layers(stages: list, layers, seed: int) -> None:
    """Add seeded noise, in place on the card, to every tensor of
    ``layers`` (whichever stage holds them)."""
    import torch

    for stage in stages:
        for i, (k, t) in enumerate(sorted(stage.items())):
            if k.startswith("blocks.") and int(k.split(".")[1]) in layers:
                g = torch.Generator(device=t.device).manual_seed(seed + i)
                t.add_(torch.randn(t.shape, generator=g, device=t.device,
                                   dtype=t.dtype) * 0.01)


def _write_group(env, stages, versions: int) -> list:
    """Every rank (a SimWorld thread) writes ``versions`` versions of its
    stage; 2 layers change between versions.  Returns seconds per write."""
    from repro_torch.core import Box, Checkpoint
    from repro_torch.core.comm_sim import SimWorld

    secs = []

    def fn(comm):
        cp = Checkpoint("stages", comm, env=env, device=DEVICE)
        cp.add(f"stage-{comm.rank}", Box(stages[comm.rank]))
        cp.commit()
        for v in range(1, versions + 1):
            if v > 1 and comm.rank == 0:
                update_layers(stages, (5, 8 + v), SEED + v)
            comm.barrier()
            t0 = time.perf_counter()
            cp.update_and_write(v)
            comm.barrier()
            if comm.rank == 0:
                secs.append(time.perf_counter() - t0)
        cp.close()

    SimWorld(N_STAGES, procs_per_node=1, env=env).run(fn, timeout=900)
    return secs


def _restore_rank(env, stages, comm):
    """Restore ``comm.rank``'s stage into zeroed tensors: (restored,
    checkpoint, every tensor torch.equal)."""
    import torch

    from repro_torch.core import Box, Checkpoint

    r = comm.rank
    live = {k: torch.zeros_like(t) for k, t in stages[r].items()}
    cp = Checkpoint("stages", comm, env=env, device=DEVICE)
    cp.add(f"stage-{r}", Box(live))
    cp.commit()
    ok = cp.restart_if_needed()
    cp.close()
    torch_sync()
    return ok, cp, all(torch.equal(live[k], stages[r][k]) for k in live)


def _restore_group(env, stages) -> dict:
    """Every rank (a SimWorld thread) restores; returns {rank: (restore
    tier, version, every tensor torch.equal)}."""
    from repro_torch.core.comm_sim import SimWorld

    out = {}

    def fn(comm):
        ok, cp, same = _restore_rank(env, stages, comm)
        out[comm.rank] = (cp.stats["restore_tier"] if ok else None,
                          cp.version, same)

    SimWorld(N_STAGES, procs_per_node=1, env=env).run(fn, timeout=900)
    return out


def _redundancy_env(root: Path, redundancy: str):
    from repro_torch.core import CraftEnv

    return CraftEnv.capture({
        "CRAFT_NODE_CP_PATH": str(root / "node"),
        "CRAFT_TIER_CHAIN": "node",
        "CRAFT_NODE_REDUNDANCY": redundancy,
        "CRAFT_XOR_GROUP_SIZE": str(N_STAGES),
        "CRAFT_RS_PARITY": "2",
        "CRAFT_METRICS": "1",
    })


def _lost_and_rebuilt(env, stages, lost) -> dict:
    """Delete the ``lost`` nodes' trees, restore every rank; every tensor
    must come back bit for bit."""
    from repro_torch.core import metrics

    for n in lost:
        shutil.rmtree(env.node_cp_path / f"node-{n}")
    c0, m0 = _counts(), metrics.snapshot()["counters"]
    torch_sync()
    t0 = time.perf_counter()
    out = _restore_group(env, stages)
    restore_s = time.perf_counter() - t0
    c1, m1 = _counts(), metrics.snapshot()["counters"]
    bad = [r for r, (tier, v, same) in out.items()
           if tier != "node" or v != 2 or not same]
    require(not bad, f"restore after losing nodes {lost} failed on ranks "
                     f"{bad}: {out}")
    return {"lost_nodes": list(lost), "restore_s": restore_s,
            "restore_tier": {r: v[0] for r, v in out.items()},
            "rebuild_split_s": _split(m0, m1), "rebuild_launches":
            _delta(c0, c1), "bit_exact": True}


def torch_sync() -> None:
    import torch

    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def phase_redundancy(results: dict, scratch: Path) -> dict:
    import torch

    from repro_torch.core import metrics
    from repro_torch.core.scrubber import corrupt_file

    metrics.install()
    dev = torch.device(DEVICE)
    stages = split_stages(danube_state(dev, torch.Generator(
        device=dev).manual_seed(SEED), PARITY_LAYERS))
    sizes = [sum(t.numel() * 2 for t in s.values()) for s in stages]
    torch_sync()
    _reset_counts()
    report = {"phase": "redundancy", "stage_bytes": sizes,
              "tensors": [len(s) for s in stages]}
    for redundancy, lost in (("XOR", (1,)), ("RS", (0, 1))):
        root = scratch / redundancy.lower()
        env = _redundancy_env(root, redundancy)
        c0, m0 = _counts(), metrics.snapshot()["counters"]
        secs = _write_group(env, stages, versions=2)
        m1, c1 = metrics.snapshot()["counters"], _counts()
        sub = {"write_s": secs, "encode_split_s": _split(m0, m1),
               "encode_launches": _delta(c0, c1), "rss_gib": rss_gib()}
        sub.update(_lost_and_rebuilt(env, stages, lost))
        kernel = "xor_reduce" if redundancy == "XOR" else "gf_matmul"
        want = 1 if redundancy == "XOR" else 2 * len(lost)
        got = sub["rebuild_launches"][kernel]
        require(got >= want, f"{redundancy} rebuild launched {kernel} "
                             f"{got} times, expected {want}")
        if redundancy == "RS":
            # a rotted parity shard: the scrubber re-encodes it in place
            shard = (env.node_cp_path / "node-2" / "rs-group-0" / "stages"
                     / "v-2" / "parity-0.bin")
            good = shard.read_bytes()
            corrupt_file(shard, offset=12345)
            ok, cp, _ = _restore_rank(env, stages, rank_comm(2, N_STAGES))
            c0 = _counts()
            scan = cp.scrubber.scan_once()
            scan_launches = _delta(c0, _counts())
            require(scan["parity_repaired"] == 1 and
                    shard.read_bytes() == good,
                    f"parity shard not re-encoded: {scan}")
            # a rotted member file: the restore repairs it on read
            member = sorted((env.node_cp_path / "node-3" / "stages" / "v-2")
                            .rglob("*.bin"))[0]
            corrupt_file(member)
            c0 = _counts()
            ok, cp, same = _restore_rank(env, stages,
                                         rank_comm(3, N_STAGES))
            require(ok and same and cp.stats["read_repairs"] == 1,
                    f"repair-on-read: ok={ok} same={same} "
                    f"read_repairs={cp.stats['read_repairs']}")
            sub.update({"scrub": {k: scan[k] for k in (
                "parity_checked", "parity_repaired", "corrupt_found",
                "bytes_scanned")}, "scrub_launches": scan_launches,
                "read_repairs": cp.stats["read_repairs"],
                "read_repair_launches": _delta(c0, _counts())})
        report[redundancy] = sub
        shutil.rmtree(root, ignore_errors=True)
    launches = _counts()
    report["launches"] = launches
    report["rss_gib"] = rss_gib()
    for k in ("xor_reduce", "gf_matmul"):
        require(launches[k] > 0, f"{k} never launched on the redundancy path")
    results["redundancy_launches"] = launches
    del stages
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------- phase 6
AFT_KILL_AT, AFT_LAST = 3, 4     # v-3's RS parity rows sit on nodes 3 and 0


def phase_aft(results: dict, scratch: Path) -> dict:
    import torch

    from repro_torch.core import Box, Checkpoint, CraftEnv, aft_zone, metrics
    from repro_torch.core.comm_sim import SimWorld

    metrics.install()
    dev = torch.device(DEVICE)
    init = split_stages(danube_state(dev, torch.Generator(
        device=dev).manual_seed(SEED + 7), PARITY_LAYERS))

    def env_of(enable: str):
        return CraftEnv.capture({
            "CRAFT_ENABLE": enable,
            "CRAFT_NODE_CP_PATH": str(scratch / "node"),
            "CRAFT_MEM_SCRATCH": str(scratch / "shm"),
            "CRAFT_TIER_CHAIN": "mem,node",
            "CRAFT_NODE_REDUNDANCY": "RS",
            "CRAFT_XOR_GROUP_SIZE": str(N_STAGES),
            "CRAFT_RS_PARITY": "2",
            "CRAFT_MEM_REPLICAS": "1",
            "CRAFT_COMM_RECOVERY_POLICY": "NON-SHRINKING",
            "CRAFT_METRICS": "1",
        })

    def run(kill: bool):
        env = env_of("1" if kill else "0")
        world = SimWorld(N_STAGES, procs_per_node=1, env=env)
        final, restores, writes = {}, {}, []

        def body(comm):
            r = comm.rank
            state = {k: v.clone() for k, v in init[r].items()}
            it = Box(0)
            cp = Checkpoint("aft", comm, env=env, device=DEVICE)
            cp.add("it", it)
            cp.add(f"stage-{r}", Box(state))
            cp.commit()
            c0 = _counts()
            t0 = time.perf_counter()
            if cp.restart_if_needed():
                torch_sync()
                restores[r] = {
                    "epoch": comm.epoch,
                    "replacement": comm.is_replacement(),
                    "tier": cp.stats["restore_tier"], "version": cp.version,
                    "seconds": time.perf_counter() - t0,
                    "launches_in_window": _delta(c0, _counts()),
                    "node_dir_rebuilt": (scratch / "node" / f"node-{r}"
                                         / "aft" / f"v-{cp.version}").is_dir(),
                }
            keys = sorted(state)
            while it.value < AFT_LAST:
                it.value += 1
                t = state[keys[(it.value * 7) % len(keys)]]
                t.mul_(0.5).add_(float(it.value * (r + 1)))
                comm.barrier()
                t0 = time.perf_counter()
                cp.update_and_write()
                comm.barrier()
                if r == 0:
                    writes.append(time.perf_counter() - t0)
                if kill and comm.epoch == 0 and r == 0 \
                        and it.value == AFT_KILL_AT:
                    world.kill(1)
                    world.kill(2)
                    for n in (1, 2):
                        shutil.rmtree(scratch / "node" / f"node-{n}")
                comm.barrier()
            cp.close()
            torch_sync()
            final[r] = state
            return comm.size

        res = world.run(lambda c: aft_zone(c, body, env=env), timeout=900)
        require(set(res.values()) == {N_STAGES}, f"aft run ended with {res}")
        return final, restores, writes

    torch_sync()
    clean, _, _ = run(kill=False)
    _reset_counts()
    m0 = metrics.snapshot()["counters"]
    t0 = time.perf_counter()
    final, restores, writes = run(kill=True)
    total_s = time.perf_counter() - t0
    launches = _counts()
    m1 = metrics.snapshot()["counters"]
    bad = [(r, k) for r in range(N_STAGES) for k in clean[r]
           if not torch.equal(final[r][k], clean[r][k])]
    require(not bad, f"aft final state differs from the failure-free run: "
                     f"{bad[:5]}")
    tiers = {r: v["tier"] for r, v in restores.items()}
    require(tiers == {r: "node" for r in range(N_STAGES)},
            f"aft restore tiers {tiers}")
    require(restores[1]["replacement"] and restores[1]["node_dir_rebuilt"]
            and restores[1]["launches_in_window"]["gf_matmul"] > 0,
            f"rank 1 was not rebuilt through RS: {restores[1]}")
    results["aft_launches"] = launches
    del init, clean, final
    torch.cuda.empty_cache()
    return {"phase": "aft", "write_s": writes, "total_s": total_s,
            "restores": restores, "split_s": _split(m0, m1),
            "launches": launches, "rss_gib": rss_gib(),
            "final_equal_failure_free": True,
            "note": "rank 1's RAM replica sat on rank 2, so v-3 is not "
                    "whole in RAM: every rank restores from the node tier, "
                    "ranks 1 and 2 through the RS rebuild (as the "
                    "reference does)"}


# ---------------------------------------------------------------- phase 7
# The paper's showcase (§5.1, Table 4, Fig. 8): the Lanczos eigensolver of
# repro_torch.apps.lanczos on an 8192 x 8192 honeycomb lattice, n =
# 134,217,728 unknowns, 512 MiB a float32 vector (about 1 GiB of Lanczos
# vectors a version and rank), the reference's --full iteration plan
# (benchmarks/lanczos_aft.py): 200 iterations, a version every 40, a
# failure at 60, the midpoint of an interval.
LANCZOS_NX = 8192
LANCZOS_ITERS, LANCZOS_CP_FREQ, LANCZOS_FAIL_AT = 200, 40, 60
LANCZOS_DISORDER = 0.3
CLEAN_EDGE = (-3.0 - 1e-5, -3.0 + 1e-3)      # the clean spectrum's edge -3|t|
DISORDERED_EDGE = (-3.3 - 1e-5, -3.0)        # within [-3|t| - W, -3|t|]


def _lanczos_mode_env(mode: str, root: Path) -> dict:
    """Table 4's modes as benchmarks/cr_overhead.py defines them; the
    synchronous one also takes the device snapshot path, and the node
    tier lives in the build scratch (the checkout's own disk), not in
    /dev/shm as there."""
    env = {"CRAFT_CP_PATH": str(root / "pfs"), "CRAFT_USE_SCR": "0"}
    if mode == "none":
        env["CRAFT_ENABLE"] = "0"
    elif mode == "sync":
        env["CRAFT_DEVICE_SNAPSHOT"] = "1"
    elif mode == "async":
        env["CRAFT_WRITE_ASYNC"] = "1"
    elif mode == "node":
        env.update({"CRAFT_USE_SCR": "1",
                    "CRAFT_NODE_CP_PATH": str(root / "node"),
                    "CRAFT_NODE_REDUNDANCY": "LOCAL",
                    "CRAFT_PFS_EVERY": "1000000"})      # node tier only
    return env


def phase_lanczos(results: dict, scratch: Path) -> dict:
    import numpy as np
    import torch

    from repro_torch.apps import lanczos as L
    from repro_torch.core import CraftEnv

    dev = torch.device(DEVICE)
    cfg = L.GrapheneConfig(nx=LANCZOS_NX, ny=LANCZOS_NX,
                           disorder=LANCZOS_DISORDER, seed=SEED)
    vec_bytes = cfg.n * 4
    n_versions = LANCZOS_ITERS // LANCZOS_CP_FREQ
    deterministic = torch.are_deterministic_algorithms_enabled()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rss = RssPeak()
    _reset_counts()
    t_phase = time.perf_counter()
    # the uninterrupted run once more without deterministic algorithms:
    # what they cost an iteration, and that the sums were deterministic
    free = L.run_lanczos(cfg, n_iter=LANCZOS_ITERS, device=dev)
    if dev.type == "cuda":
        # bit-exact resume, as the train child: deterministic algorithms.
        # The Lanczos step is elementwise passes, rolls and full sums, no
        # cuBLAS, so CUBLAS_WORKSPACE_CONFIG (read when cuBLAS starts,
        # which an earlier phase did) is left to the later phases.
        torch.use_deterministic_algorithms(True)
    try:
        modes, launches_of = {}, {}
        runs = {}
        for mode in ("none", "sync", "async", "node"):
            root = scratch / mode
            envmap = _lanczos_mode_env(mode, root)
            c0 = _counts()
            res = L.run_lanczos(
                cfg, n_iter=LANCZOS_ITERS,
                cp_freq=0 if mode == "none" else LANCZOS_CP_FREQ,
                cp_name=f"l_{mode}", env=CraftEnv.capture(envmap),
                device=dev)
            launches_of[mode] = _delta(c0, _counts())
            runs[mode] = res
            st = res.cp_stats
            modes[mode] = {
                "runtime_s": res.wall_s + res.fence_s,
                "iter_median_s": statistics.median(res.iter_s),
                "versions": st.get("writes", 0),
                "write_s_per_version": (st["write_seconds"] / st["writes"]
                                        if st.get("writes") else None),
                "tier_bytes_written": st.get("tier_bytes_written", 0),
                "launches": {k: launches_of[mode][k]
                             for k in ("checksum", "snapshot")}}
            shutil.rmtree(root, ignore_errors=True)
        none = runs["none"]
        require(np.array_equal(free.alphas, none.alphas)
                and np.array_equal(free.betas, none.betas),
                "lanczos: the run without deterministic algorithms gave "
                "other alphas/betas")
        modes["none"]["iter_median_s_not_deterministic"] = \
            statistics.median(free.iter_s)
        base_s = modes["none"]["runtime_s"]
        for mode in ("sync", "async", "node"):
            m = modes[mode]
            require(np.array_equal(runs[mode].alphas, none.alphas)
                    and np.array_equal(runs[mode].betas, none.betas),
                    f"lanczos {mode}: checkpointing changed alphas/betas")
            require(m["versions"] == n_versions,
                    f"lanczos {mode}: {m['versions']} versions, "
                    f"not {n_versions}")
            m["overhead_s"] = m["runtime_s"] - base_s
            m["overhead_per_cp_s"] = m["overhead_s"] / n_versions
        lo, hi = DISORDERED_EDGE
        require(lo <= none.eigenvalue <= hi,
                f"lanczos W={LANCZOS_DISORDER}: smallest Ritz value "
                f"{none.eigenvalue} outside [{lo}, {hi}]")

        # crash at FAIL_AT, then a second call resumes from the version
        # before it (synchronous pfs)
        env = CraftEnv.capture(_lanczos_mode_env("crash", scratch / "crash"))
        try:
            L.run_lanczos(cfg, n_iter=LANCZOS_ITERS,
                          cp_freq=LANCZOS_CP_FREQ, env=env,
                          fail_at=LANCZOS_FAIL_AT, device=dev)
            crashed = None
        except RuntimeError as exc:
            crashed = str(exc)
        require(crashed == f"injected failure at iteration {LANCZOS_FAIL_AT}",
                f"lanczos crash run ended with {crashed!r}")
        rerun = L.run_lanczos(cfg, n_iter=LANCZOS_ITERS,
                              cp_freq=LANCZOS_CP_FREQ, env=env, device=dev)
        last_cp = LANCZOS_FAIL_AT // LANCZOS_CP_FREQ * LANCZOS_CP_FREQ
        require(rerun.restarted_at == last_cp,
                f"lanczos rerun restarted at {rerun.restarted_at}, not "
                f"{last_cp}")
        require(np.array_equal(rerun.alphas, none.alphas)
                and np.array_equal(rerun.betas, none.betas),
                "lanczos rerun: alphas/betas differ from the uninterrupted "
                "run")
        crash = {"restarted_at": rerun.restarted_at,
                 "restore_s": rerun.cp_stats["read_seconds"],
                 "restore_tier": rerun.cp_stats["restore_tier"],
                 "rerun_runtime_s": rerun.wall_s + rerun.fence_s}
        shutil.rmtree(scratch / "crash", ignore_errors=True)

        peak_one_rank = (torch.cuda.max_memory_allocated()
                         if dev.type == "cuda" else None)
        # Fig. 8: two ranks in an AFT zone with one spare node, async writes;
        # rank 0 fail-stopped by SimWorld.kill at FAIL_AT dies on its writer
        # thread at the next version's publish barrier
        aft = L.aft_lanczos(scratch / "aft", cfg, LANCZOS_ITERS,
                            LANCZOS_CP_FREQ, LANCZOS_FAIL_AT, device=dev,
                            kill=True, envmap={"CRAFT_WRITE_ASYNC": "1"},
                            timeout=600)
        members = aft["members"]
        require([m["rank"] for m in members] == [0, 1],
                f"lanczos aft members {[m['rank'] for m in members]}")
        for m in members:
            require(m["resumed_from"] == last_cp,
                    f"lanczos aft rank {m['rank']} resumed from "
                    f"{m['resumed_from']}")
            require(m["eig"] == none.eigenvalue
                    and np.array_equal(m["alphas"], none.alphas)
                    and np.array_equal(m["betas"], none.betas),
                    f"lanczos aft rank {m['rank']}: differs from the "
                    f"failure-free run")
        failed = [s["failed"] for s in aft["recoveries"]]
        require(failed and all(f == [0] for f in failed),
                f"lanczos aft recoveries {failed}")
        iter_s = modes["none"]["iter_median_s"]
        redo_steps = aft["hook_calls"][1] - LANCZOS_ITERS
        fig8 = {"oh_cp_s": modes["async"]["overhead_s"],
                "oh_rec_s": max(s["total_s"] for s in aft["recoveries"]),
                "redo_steps": redo_steps,
                "oh_redo_s": redo_steps * iter_s,
                "aft_wall_s": aft["wall_s"],
                "member_wall_s": [m["wall_s"] for m in members],
                "restore_s": [m["stats"]["read_seconds"] for m in members],
                "restore_tier": [m["stats"]["restore_tier"]
                                 for m in members]}
        shutil.rmtree(scratch / "aft", ignore_errors=True)

        # an answer the card checks on its own: the clean lattice's edge
        clean = L.run_lanczos(
            L.GrapheneConfig(nx=LANCZOS_NX, ny=LANCZOS_NX, disorder=0.0,
                             seed=SEED),
            n_iter=LANCZOS_ITERS, device=dev)
        lo, hi = CLEAN_EDGE
        require(lo <= clean.eigenvalue <= hi,
                f"lanczos W=0: smallest Ritz value {clean.eigenvalue} "
                f"outside [{lo}, {hi}]")
    finally:
        if dev.type == "cuda":
            torch.use_deterministic_algorithms(deterministic)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    require(launches["checksum"] > 0 and launches["snapshot"] > 0
            and launches_of["sync"]["snapshot"] > 0,
            f"lanczos phase launches {launches}, of the device snapshot "
            f"run {launches_of['sync']}")
    results["lanczos_launches"] = launches
    return {"phase": "lanczos", "n": cfg.n, "vector_bytes": vec_bytes,
            "iterations": LANCZOS_ITERS, "cp_freq": LANCZOS_CP_FREQ,
            "fail_at": LANCZOS_FAIL_AT, "modes": modes, "crash": crash,
            "fig8": fig8, "eigenvalue": none.eigenvalue,
            "clean_eigenvalue": clean.eigenvalue,
            "peak_device_bytes": peak,
            "peak_device_bytes_before_aft": peak_one_rank,
            "rss_peak_gib": rss.stop(),
            "launches": launches, "bit_exact": True,
            "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------- cluster
# Fig. 8 on real worker processes (``apps.lanczos.cluster_lanczos`` over
# ``repro_torch.runtime.Cluster``): one process a rank, each with its own
# CUDA context on the card, fail-stopped by SIGKILL and repaired by the
# ULFM recipe.  (a) is the lanczos phase's problem and plan; (b) is cut to
# 4096² (128 MiB a vector) to save phase time.
CLUSTER_RUNS = (
    # name, lattice side, ranks, recovery, who kills, killed rank, CRAFT env
    ("a", LANCZOS_NX, 2, "NON-SHRINKING", "self", 0,
     {"CRAFT_WRITE_ASYNC": "1"}),
    ("b", 4096, 3, "SHRINKING", "parent", 2, {"CRAFT_DEVICE_SNAPSHOT": "1"}),
)
CLUSTER_TIMEOUT_S = 300


def _worker_orphans() -> list:
    """Names of this process's live Cluster worker children."""
    import multiprocessing

    return [p.name for p in multiprocessing.active_children()
            if p.name.startswith("craft-worker-")]


def _cluster_run(run, dev, scratch: Path) -> tuple:
    """One of CLUSTER_RUNS against an uninterrupted single-process run in
    this process; returns its summary and the workers' launch counts."""
    import numpy as np
    import torch

    from repro_torch.apps import lanczos as L

    name, nx, n_procs, policy, kill_by, fail_rank, envmap = run
    cfg = L.GrapheneConfig(nx=nx, ny=nx, disorder=LANCZOS_DISORDER,
                           seed=SEED)
    clean = L.run_lanczos(cfg, n_iter=LANCZOS_ITERS, device=dev)
    _free_host_cache()          # the workers get the card's memory
    out = L.cluster_lanczos(scratch / name, cfg, LANCZOS_ITERS,
                            LANCZOS_CP_FREQ, LANCZOS_FAIL_AT, n_procs,
                            device=dev, policy=policy, kill_by=kill_by,
                            fail_rank=fail_rank, envmap=envmap,
                            timeout=CLUSTER_TIMEOUT_S)
    orphans = _worker_orphans()
    require(not orphans, f"cluster {name}: workers outlived their Cluster: "
            f"{orphans}")
    members = out["members"]
    require([(m["rank"], m["size"]) for m in members] == [(0, 2), (1, 2)],
            f"cluster {name}: (rank, size) of the members "
            f"{[(m['rank'], m['size']) for m in members]}")
    for m in members:
        require(np.array_equal(m["alphas"], clean.alphas)
                and np.array_equal(m["betas"], clean.betas),
                f"cluster {name} rank {m['rank']}: alphas/betas differ from "
                f"the uninterrupted run")
    failed = [s["failed"] for s in out["recoveries"]]
    require(failed == [[fail_rank]], f"cluster {name}: recoveries {failed}")
    rec = out["recoveries"][0]
    last_cp = LANCZOS_FAIL_AT // LANCZOS_CP_FREQ * LANCZOS_CP_FREQ
    hydrated = [m["hydrated"] for m in members if m["hydrated"]]
    if policy == "NON-SHRINKING":
        require(all(m["resumed_from"] == last_cp for m in members),
                f"cluster {name}: resumed from "
                f"{[m['resumed_from'] for m in members]}, not {last_cp}")
        require(len(hydrated) == 1 and hydrated[0]["restored"]
                and hydrated[0]["tier"],
                f"cluster {name}: replacement hydration {hydrated}")
    iter_ms = {m["rank"]: statistics.median(m["iter_s"]) * 1e3
               for m in members}
    clean_ms = statistics.median(clean.iter_s) * 1e3
    per_rank = {m["rank"]: {
        "iter_ms": iter_ms[m["rank"]], "start_s": m["start_s"],
        "zone_s": m["zone_s"], "steps_begun": m["hook_calls"],
        "resumed_from": m["resumed_from"],
        "restore_s": m["stats"].get("read_seconds"),
        "restore_tier": m["stats"].get("restore_tier"),
        "replacement": bool(m["hydrated"]),
        "peak_device_bytes": m["peak_device_bytes"],
        "launches": m["launches"]} for m in members}
    # Fig. 8's terms for the first survivor: its zone's seconds against 200
    # steps at its own pace; OH_rec the coordinator's recovery, OH_redo the
    # steps begun twice, the rest (version writes, the restore) OH_cp
    m = next(m for m in members if not m["hydrated"])
    sec = iter_ms[m["rank"]] / 1e3
    overhead = m["zone_s"] - LANCZOS_ITERS * sec
    redo = m["hook_calls"] - LANCZOS_ITERS
    fig8 = {"rank": m["rank"], "overhead_s": overhead, "redo_steps": redo,
            "oh_redo_s": redo * sec, "oh_rec_s": rec["total_s"],
            "oh_cp_and_restore_s": overhead - redo * sec - rec["total_s"]}
    summary = {
        "run": name, "nx": nx, "ranks": n_procs, "policy": policy,
        "kill_by": kill_by, "killed_rank": fail_rank,
        "env": envmap, "wall_s": out["wall_s"],
        "iter_ms_uninterrupted_one_process": clean_ms,
        "per_rank": per_rank, "fig8": fig8,
        "table3": {k: rec[k] for k in ("revoke_shrink_s", "spawn_info_s",
                                       "spawn_merge_s", "redistribute_s",
                                       "resource_mgmt_s")},
        "replacement_spawn_to_hello_s": (rec["spawn_merge_s"]
                                         if policy == "NON-SHRINKING"
                                         else None),
        "hydrated": hydrated[0] if hydrated else None,
        "card_free_bytes_min": out["min_free_bytes"]}
    launches = collections.Counter()
    for m in members:
        launches.update(m["launches"])
    return summary, launches


def phase_cluster(results: dict, scratch: Path) -> dict:
    import torch

    dev = torch.device(DEVICE)
    deterministic = torch.are_deterministic_algorithms_enabled()
    _free_host_cache()          # what earlier phases left in the caches
    rss = RssPeak()
    _reset_counts()
    runs, workers = [], collections.Counter()
    if dev.type == "cuda":
        # as the lanczos phase; cluster_lanczos turns them on in the
        # workers because they are on here
        torch.use_deterministic_algorithms(True)
    try:
        for run in CLUSTER_RUNS:
            summary, launches = _cluster_run(run, dev, scratch)
            runs.append(summary)
            workers.update(launches)
            shutil.rmtree(scratch / run[0], ignore_errors=True)
    finally:
        if dev.type == "cuda":
            torch.use_deterministic_algorithms(deterministic)
    require(workers["checksum"] > 0 and workers["snapshot"] > 0,
            f"cluster phase: worker launches {dict(workers)}")
    parent = _counts()
    # the kernels run in the workers; the parent's own runs checkpoint
    # nothing and launch none of them
    launches = {k: parent[k] + workers.get(k, 0) for k in parent}
    results["cluster_launches"] = launches
    return {"phase": "cluster", "runs": runs, "launches": launches,
            "parent_launches": parent, "parent_rss_peak_gib": rss.stop(),
            "bit_exact": True}


# ---------------------------------------------------------------- mesh
MESH_TINY = False                # full-size configurations (CPU rehearsal: True)
MESH_ARCH = "h2o-danube-1.8b"
MESH_WRITE = (2, 2)              # the writers' ("data", "model") mesh
MESH_SURVIVORS = 2               # restored on shrink_mesh(2, model_parallel=2)
MESH_TIMEOUT_S = 300             # each Cluster's limit
DRYRUN_CELL = ("h2o-danube-1.8b", "train_4k")   # on the 16 x 16 fake mesh
DRYRUN_TIMEOUT_S = 300           # the dry-run subprocess's limit


def mesh_elastic(scratch: Path) -> dict:
    """h2o-danube-1.8b's parameters as DTensors on a (2, 2) mesh over 4
    worker processes sharing the card (gloo), written with the device
    snapshot; restored on ``shrink_mesh(2, model_parallel=2)`` over 2
    fresh processes, every local shard torch.equal to the seeded global
    state's slice (``examples.elastic_restore``)."""
    from repro_torch.configs import get_config
    from repro_torch.examples.elastic_restore import elastic_restore
    from repro_torch.models import model as M

    cfg = get_config(MESH_ARCH, tiny=MESH_TINY)
    shapes = M.init_params(None, cfg, "meta")
    param_bytes = _tree_bytes(shapes)
    _free_host_cache()
    out = elastic_restore(scratch, MESH_ARCH, tiny=MESH_TINY, device=DEVICE,
                          write_mesh=MESH_WRITE, survivors=MESH_SURVIVORS,
                          model_parallel=2, seed=SEED, snapshot=True,
                          timeout=MESH_TIMEOUT_S)
    orphans = _worker_orphans()
    require(not orphans, f"mesh: workers outlived their Cluster: {orphans}")
    readers, writers = out["readers"], out["writers"]
    require(len(writers) == MESH_WRITE[0] * MESH_WRITE[1]
            and len(readers) == MESH_SURVIVORS,
            f"mesh: {len(writers)} writers, {len(readers)} readers")
    require(all(r["mesh"] == (1, 2) and r["restored"] for r in readers),
            f"mesh: readers {[(r['mesh'], r['restored']) for r in readers]}")
    require(out["equal"], "mesh: a restored shard differs from the seeded "
            "state's slice")
    wl = collections.Counter()
    for w in writers:
        wl.update(w["launches"])
    rl = collections.Counter()
    for r in readers:
        rl.update(r["launches"])
    if DEVICE == "cuda":
        require(wl["snapshot"] > 0 and rl["checksum"] > 0,
                f"mesh: writer launches {dict(wl)}, reader {dict(rl)}")
    return {"arch": MESH_ARCH, "param_bytes": param_bytes,
            "write_mesh": list(MESH_WRITE), "restore_mesh": [1, 2],
            "write_s": [w["write_s"] for w in writers],
            "restore_s": [r["restore_s"] for r in readers],
            "reader_local_bytes": [r["local_bytes"] for r in readers],
            "wall_s": out["wall_s"], "bit_exact": True,
            "writer_launches": dict(wl), "reader_launches": dict(rl)}


def start_dryrun(scratch: Path):
    """Start one full-size dry-run cell in its own process (it runs on the
    host's CPU, beside the elastic restore): the 16 x 16 production mesh
    on a fake process group of 256 ranks, the train step traced on fake
    tensors."""
    arch, shape = DRYRUN_CELL
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--json-dir", str(scratch)]
    if MESH_TINY:
        cmd.append("--tiny")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(ROOT))


def mesh_dryrun(proc, scratch: Path, t0: float) -> dict:
    """The dry-run cell's result within its own time limit (from its start
    at ``t0``): per-device bytes, the 80 GB check and the roofline on the
    H100's constants."""
    arch, shape = DRYRUN_CELL
    try:
        out, err = proc.communicate(
            timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise Failure(f"dry-run {arch} x {shape} passed its "
                      f"{DRYRUN_TIMEOUT_S} s limit")
    if proc.returncode != 0:
        raise Failure(f"dry-run {arch} x {shape} exited {proc.returncode}:"
                      f"\n{out[-2000:]}\n{err[-3000:]}")
    rec = json.loads((scratch / "16x16" / f"{arch}__{shape}.json")
                     .read_text())
    roof = rec["roofline"]
    require(roof["flops"] > 0 and roof["hbm_bytes"] > 0
            and roof["collective_bytes"] > 0,
            f"dry-run {arch} x {shape}: {roof}")
    return {"cell": f"{arch} x {shape} x 16x16",
            "start_to_result_s": time.perf_counter() - t0,
            "trace_s": rec["trace_s"],
            "build_s": rec["build_s"], "memory": rec["memory"],
            "fits_80GB": rec["memory"]["fits_80GB"],
            "flops_per_device": roof["flops"],
            "hbm_bytes_per_device": roof["hbm_bytes"],
            "collective_bytes_per_device": roof["collective_bytes"],
            "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
            "collective_s": roof["collective_s"],
            "dominant": roof["dominant"],
            "collective_by_kind": roof["collective_by_kind"],
            "collectives_by_shape": rec["collectives_by_shape"],
            "model_flops_per_chip": rec["model_flops_per_chip"],
            "model_over_traced_flops": rec["model_traced_ratio"],
            "constants": rec["device"]}


def phase_mesh(results: dict, scratch: Path) -> dict:
    """The sharding layer on the card: the elastic restore across worker
    processes and, beside it on the host, one full-size dry-run cell
    (zamba2's one-rank-mesh runs are the train phase's)."""
    _reset_counts()
    t_dry = time.perf_counter()
    proc = start_dryrun(scratch / "dryrun")
    try:
        t0 = time.perf_counter()
        elastic = mesh_elastic(scratch / "elastic")
        elastic_s = time.perf_counter() - t0
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    shutil.rmtree(scratch / "elastic", ignore_errors=True)
    dry = mesh_dryrun(proc, scratch / "dryrun", t_dry)
    dry_s = time.perf_counter() - t_dry
    parent = _counts()
    workers = collections.Counter(elastic["writer_launches"])
    workers.update(elastic["reader_launches"])
    launches = {k: parent[k] + workers.get(k, 0) for k in parent}
    results["mesh_launches"] = launches
    return {"phase": "mesh", "elastic": elastic, "dryrun": dry,
            "part_s": {"elastic": elastic_s, "dryrun": dry_s},
            "launches": launches, "parent_launches": parent}


# ---------------------------------------------------------------- phase 8
# deepseek-v3-671b at its published widths, cut to depth 2 (one dense
# block, one MoE block) beside its MTP head's parameters: 25.5 B
# parameters, 51 GB in bf16; a third layer would take the weights to 74 GB
MOE_ARCH = "deepseek-v3-671b-d2"
# llava-next-34b's yi-34b backbone cut to depth 8 of 60 (5.4 B parameters,
# 10.8 GB; all 60 would be 69 GB), kimi-k2 to depth 2 of 61, one dense and
# one MoE block of 384 experts (20.0 B parameters, 39.9 GB; a third layer
# adds 34 GB); musicgen-medium cut to depth 24 of 48 when the mesh phase
# came (its 4.9 GB cache's writes and restore were the serve phase's
# largest share: the smoke's phases must stay within 1000 s)
LLAVA_ARCH = "llava-next-34b-d8"
KIMI_ARCH = "kimi-k2-1t-a32b-d2"
MUSICGEN_ARCH = "musicgen-medium-d24"
SERVE_ARCHS = ("h2o-danube-1.8b", "zamba2-2.7b", "falcon-mamba-7b", MOE_ARCH,
               MUSICGEN_ARCH, LLAVA_ARCH, KIMI_ARCH)
# the registered cuts: (config module, the fields they change)
SERVE_CUTS = {MOE_ARCH: ("deepseek_v3_671b",
                         dict(n_layers=2, first_dense_layers=1)),
              LLAVA_ARCH: ("llava_next_34b", dict(n_layers=8)),
              MUSICGEN_ARCH: ("musicgen_medium", dict(n_layers=24)),
              KIMI_ARCH: ("kimi_k2_1t_a32b",
                          dict(n_layers=2, first_dense_layers=1))}
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 8192, 32
SERVE_CP_FREQ, SERVE_FAIL_AT = 16, 20
SERVE_TINY = False               # full-size configurations (CPU rehearsal: True)
TRACE_STEPS = 4                  # decode steps in each model's trace
# the kernels each model's path must launch
SERVE_KERNELS = {"h2o-danube-1.8b": ("flash_attention",),
                 "zamba2-2.7b": ("flash_attention", "ssd_scan"),
                 "falcon-mamba-7b": ("s6_scan",),
                 MOE_ARCH: ("flash_attention",),
                 MUSICGEN_ARCH: ("flash_attention",),
                 LLAVA_ARCH: ("flash_attention",),
                 KIMI_ARCH: ("flash_attention",)}


def register_serve_configs() -> None:
    """Register the cuts of :data:`SERVE_CUTS` (each with its TINY twin at
    the same depth, for a CPU rehearsal) with the port's registry, so
    ``launch.serve.run`` resolves them by name."""
    import importlib

    from repro_torch.configs import register_config

    for name, (module, fields) in SERVE_CUTS.items():
        mod = importlib.import_module(f"repro_torch.configs.{module}")
        cut = dict(arch_id=name, **fields)
        register_config(name, mod.CONFIG.replace(**cut),
                        mod.TINY.replace(**cut))


def _serve_inputs(cfg, dev):
    """(prompts, stub embeds, first decode position) of ``serve.run``
    for the phase's batch, on ``dev``: the prompts from
    ``default_rng(SEED)``, the embeds None without a frontend."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import prefix_len, stub_embeds

    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    return (torch.from_numpy(prompts).to(dev),
            stub_embeds(cfg, SERVE_BATCH, SEED, dev),
            SERVE_PROMPT + prefix_len(cfg))


def _attention_layers(cfg) -> int:
    """flash_attention calls of one forward: one a transformer block,
    zamba2's one a shared-block application, none for mamba1."""
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.shared_attn_every
                if cfg.shared_attn_every else 0)
    return 0 if cfg.family == "ssm" else cfg.n_layers


def _tree_bytes(tree) -> int:
    import torch.utils._pytree as pytree

    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


def _tier_writes():
    """(count, seconds) of the tier writes so far (``tier_write_seconds``
    histograms of the metrics registry, every tier)."""
    from repro_torch.core import metrics

    hists = metrics.snapshot()["histograms"]
    sel = [h for k, h in hists.items() if k.startswith("tier_write_seconds")]
    return sum(h["count"] for h in sel), sum(h["sum"] for h in sel)


def decode_trace(cfg, params, dev, untraced_s: float) -> dict:
    """Trace ``TRACE_STEPS`` decode steps of the serve loop (a prefill and
    one untraced step first) with torch.profiler: the device's busy time a
    token (the union of its kernel and copy intervals), its idle share of
    the traced wall time and of the untraced run's time a token
    (``untraced_s``), device operations a token, and the five kernels
    that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.steps import make_decode_step, make_prefill

    tokens, embeds, start = _serve_inputs(cfg, dev)
    cache, logits = make_prefill(cfg, SERVE_BATCH, start + SERVE_GEN, dev)(
        params, tokens, embeds)
    decode = make_decode_step(cfg)
    tok, pos = torch.argmax(logits, dim=-1).to(torch.int32), start

    def step():                  # the serve loop's body
        nonlocal cache, tok, pos
        cache, lg = decode(params, cache, tok[:, None], pos)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        tok.cpu()
        pos += 1

    step()
    torch_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACE_STEPS):
            step()
        torch_sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in ops):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict = {}
    for e in ops:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    per_tok = busy / TRACE_STEPS * 1e-6
    return {"steps": TRACE_STEPS, "traced_s_per_token":
            wall_us / TRACE_STEPS * 1e-6,
            "device_busy_s_per_token": per_tok if ops else None,
            "idle_share_traced": 1 - busy / wall_us if ops else None,
            "idle_share_untraced": 1 - per_tok / untraced_s if ops else None,
            "device_ops_per_token": len(ops) / TRACE_STEPS,
            "top_kernels": [{"name": n[:80], "per_token": c / TRACE_STEPS,
                             "s_per_token": us / TRACE_STEPS * 1e-6}
                            for n, (c, us) in top]}


# kernel families of a prefill trace, by the first name fragment that matches
PREFILL_FAMILIES = (("attention", ("flash",)),
                    ("scan", ("ssd_", "s6_", "carry_kernel")),
                    ("matmul", ("nvjet", "gemm", "cutlass", "sm90_")))


def prefill_split(cfg, params, dev) -> dict:
    """One prefill of the serve phase's batch traced with torch.profiler
    (one untraced first): wall and device-busy seconds, device seconds by
    kernel family (``PREFILL_FAMILIES``, the rest "other") and the six
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.steps import make_prefill

    tokens, embeds, start = _serve_inputs(cfg, dev)
    prefill = make_prefill(cfg, SERVE_BATCH, start + SERVE_GEN, dev)
    prefill(params, tokens, embeds)
    torch_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, tokens, embeds)
        torch_sync()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in ops):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    family: dict = {}
    by_name: dict = {}
    for e in ops:
        us = e.time_range.elapsed_us()
        fam = next((f for f, keys in PREFILL_FAMILIES
                    if any(k in e.name for k in keys)), "other")
        family[fam] = family.get(fam, 0.0) + us * 1e-6
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_s": wall, "device_busy_s": busy * 1e-6,
            "device_s_by_family": family,
            "top_kernels": [{"name": n[:80], "calls": c, "s": us * 1e-6}
                            for n, (c, us) in top]}


def serve_one(arch: str, scratch: Path) -> dict:
    """One full-size model through ``repro_torch.launch.serve.run``: an
    uninterrupted run, a run that checkpoints every 16 tokens and fails
    at token 20, and the resumed run, which must restart at token 16 and
    produce the uninterrupted run's tokens."""
    import dataclasses

    import numpy as np
    import torch
    import torch.utils._pytree

    from repro_torch.configs import get_config
    from repro_torch.core import CraftEnv
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg = get_config(arch, tiny=SERVE_TINY)
    on_card = dev.type == "cuda"
    # closed Checkpoints of earlier phases and runs sit in reference cycles
    # with the state they held: collect them, so the peak below is this
    # model's own
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() if on_card else None
    torch_sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, dev)
    torch_sync()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() if on_card else None
    cache_bytes = _tree_bytes(M.init_cache(
        cfg, SERVE_BATCH, SERVE_PROMPT + serve.prefix_len(cfg) + SERVE_GEN,
        device="meta"))
    sc = serve.ServeConfig(arch=arch, tiny=SERVE_TINY, batch=SERVE_BATCH,
                           prompt_len=SERVE_PROMPT, gen_tokens=SERVE_GEN,
                           seed=SEED, device=DEVICE, cp_name="serve")
    c0, r0, s0 = _counts(), _attn_routes(), _scan_routes()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    clean = serve.run(sc, params=params)
    launches = _delta(c0, _counts())
    routes = _delta(r0, _attn_routes())
    s1 = _scan_routes()
    scan_routes = {"clean": _scan_route_delta(s0, s1)}
    _require_scan_routes(arch, "clean", scan_routes["clean"], SERVE_GEN)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    env = CraftEnv.capture({"CRAFT_CP_PATH": str(scratch / arch),
                            "CRAFT_TIER_CHAIN": "pfs",
                            "CRAFT_DEVICE_SNAPSHOT": "1",
                            "CRAFT_METRICS": "1"})
    ck = dataclasses.replace(sc, cp_freq=SERVE_CP_FREQ)
    w0 = _tier_writes()
    t0 = time.perf_counter()
    try:
        serve.run(ck, env=env, params=params, fail_at_token=SERVE_FAIL_AT)
    except RuntimeError as exc:
        require("injected failure" in str(exc), f"{arch}: {exc}")
    else:
        raise Failure(f"{arch}: the failing run did not fail")
    failing_s = time.perf_counter() - t0
    w1, c1, s2 = _tier_writes(), _counts(), _scan_routes()
    scan_routes["failing"] = _scan_route_delta(s1, s2)
    _require_scan_routes(arch, "failing", scan_routes["failing"],
                         SERVE_FAIL_AT)
    resumed = serve.run(ck, env=env, params=params)
    resume_launches = _delta(c1, _counts())
    scan_routes["resumed"] = _scan_route_delta(s2, _scan_routes())
    _require_scan_routes(arch, "resumed", scan_routes["resumed"],
                         SERVE_GEN - SERVE_CP_FREQ)
    w2 = _tier_writes()
    require(clean["logits_finite"] and resumed["logits_finite"],
            f"{arch}: a logit was not finite")
    require(resumed["resumed_at"] == SERVE_CP_FREQ,
            f"{arch}: resumed at {resumed['resumed_at']}, not "
            f"{SERVE_CP_FREQ}")
    require(np.array_equal(resumed["tokens"], clean["tokens"]),
            f"{arch}: the resumed run's tokens differ from the "
            "uninterrupted run's")
    # stronger than the tokens where random weights repeat one token: the
    # last step's logits, bit for bit (the same kernels on the same inputs)
    require(np.array_equal(resumed["last_logits"], clean["last_logits"]),
            f"{arch}: the resumed run's last logits differ from the "
            "uninterrupted run's")
    for k in SERVE_KERNELS[arch]:
        require(launches[k] > 0, f"{arch}: {k} never launched on serve")
    # bf16 attention: prefill calls on the tensor cores, decode steps
    # split over the keys, the scalar route never; MLA's absorbed decode
    # attends in latent space with plain einsums (as the reference), so
    # there every attention call is a prefill's, at dqk 192 / dv 128
    if "flash_attention" not in SERVE_KERNELS[arch]:
        pass
    elif cfg.attn_type == "mla" and cfg.mla_absorb:
        require(routes["scalar"] == 0 and routes["split_decode"] == 0
                and routes["tc_prefill"] == launches["flash_attention"]
                == cfg.n_layers,
                f"{arch}: attention routes on serve {routes}")
    else:
        n_attn = _attention_layers(cfg)
        require(routes == {"tc_prefill": n_attn,
                           "split_decode": n_attn * SERVE_GEN, "scalar": 0}
                and launches["flash_attention"] == n_attn * (1 + SERVE_GEN),
                f"{arch}: attention routes on serve {routes} (one a layer "
                f"of {n_attn} and a pass)")
    out = {"arch": arch, "prefix": serve.prefix_len(cfg), "params": sum(
        t.numel() for t in torch.utils._pytree.tree_leaves(params)),
           "param_bytes": _tree_bytes(params),
           "init_s": init_s, "init_peak_device_bytes": init_peak,
           "prefill_s": clean["prefill_s"],
           "decode_s_per_token": clean["decode_s"] / SERVE_GEN,
           "cache_bytes": cache_bytes, "peak_device_bytes": peak,
           "resident_device_bytes_before": resident,
           "failing_run_s": failing_s,
           "failing_run_tier_writes": [w1[0] - w0[0], w1[1] - w0[1]],
           "resumed_at": resumed["resumed_at"],
           "restore_s": resumed["restore_s"],
           "resumed_cp_writes_s": resumed["cp_writes"],
           "resumed_tier_writes": [w2[0] - w1[0], w2[1] - w1[1]],
           "resumed_prefill_s": resumed["prefill_s"],
           "resumed_decode_s_per_token": resumed["decode_s"] / (
               SERVE_GEN - SERVE_CP_FREQ),
           "tokens_equal": True, "last_logits_equal": True,
           "logits_finite": True,
           "first_tokens": clean["tokens"][0, :8].tolist(),
           "launches": launches, "attention_routes": routes,
           "scan_routes": scan_routes,
           "resume_launches": resume_launches,
           "card": card_line() if on_card else None}
    del clean, resumed
    if on_card:
        out["decode_trace"] = decode_trace(cfg, params, dev,
                                           out["decode_s_per_token"])
        out["prefill_trace"] = prefill_split(cfg, params, dev)
    del params
    shutil.rmtree(scratch / arch, ignore_errors=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_start
    return out


def phase_serve(results: dict, scratch: Path) -> dict:
    from repro_torch.core import metrics

    metrics.install()
    register_serve_configs()
    _reset_counts()
    models = [serve_one(arch, scratch) for arch in SERVE_ARCHS]
    launches, routes = _counts(), _attn_routes()
    require(routes["scalar"] == 0,
            f"the bf16 serve path reached the scalar attention: {routes}")
    results["serve_launches"] = launches
    return {"phase": "serve", "batch": SERVE_BATCH,
            "prompt_len": SERVE_PROMPT, "gen_tokens": SERVE_GEN,
            "cp_freq": SERVE_CP_FREQ, "fail_at_token": SERVE_FAIL_AT,
            "models": models, "launches": launches,
            "attention_routes": routes, "scan_routes": _scan_routes()}


# ---------------------------------------------------------------- train
TRAIN_TINY = False               # full-size configurations (CPU rehearsal: True)
# zamba2 trains at depth 24 of 54 (four groups of six mamba2 blocks and the
# shared attention block) since the mesh phase came: its 23.4 GB version's
# write and restore were the train phase's largest share, and the phases
# must stay within 1000 s
ZAMBA_TRAIN_ARCH, ZAMBA_TRAIN_LAYERS = "zamba2-2.7b-d24", 24
TRAIN_BATCH = 2
# zamba2 cut from L 4096 and 6 steps to L 2048 and 4 steps when the serve
# phase took seven models: the smoke's phases must stay within 1000 s
ZAMBA_SEQ, FALCON_SEQ = 2048, 2048
TRAIN_STEPS, TRAIN_CP_FREQ, TRAIN_FAIL_AT = 4, 2, 3
FALCON_STEPS, FALCON_LR = 3, 1e-4
TRAIN_TIMEOUT_S = 700            # the child's limit
# kernel families of a traced train step: the plain backwards and the
# optimizer by their trace spans (``craft::...`` record_function ranges),
# the rest by kernel name as in PREFILL_FAMILIES
TRAIN_SPANS = {"craft::attention_bwd": "attention_backward",
               "craft::scan_bwd": "scan_backward",
               "craft::adamw": "optimizer"}
HAND_KERNELS = ("flash_", "ssd_", "s6_", "carry_kernel")
MATMUL_KERNELS = ("nvjet", "gemm", "cutlass", "sm90_")


class _Interrupted(Exception):
    """Raised from ``on_step`` to cut a training run, as a kill would."""


def _train_env(root: Path, device_snapshot: bool = True):
    from repro_torch.core import CraftEnv

    return CraftEnv.capture({"CRAFT_CP_PATH": str(root),
                             "CRAFT_TIER_CHAIN": "pfs",
                             "CRAFT_DEVICE_SNAPSHOT": str(int(device_snapshot)),
                             "CRAFT_KEEP_VERSIONS": "1",
                             "CRAFT_METRICS": "1"})


def _dir_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def _trees_equal(a, b) -> bool:
    """The same key paths, each leaf torch.equal (dict order aside: a
    restore rebuilds the dicts in sorted order; a DTensor of a one-rank
    mesh by its local shard, which is the whole tensor)."""
    import torch
    import torch.utils._pytree as pytree

    ma, mb = ({pytree.keystr(k): _local(v) for k, v in
               pytree.tree_flatten_with_path(t)[0]} for t in (a, b))
    return set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh over a one-process group: NCCL on
    the card (gloo in a CPU rehearsal), on a free localhost port."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    on_card = DEVICE == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    return make_mesh((1, 1), ("data", "model"),
                     device_type="cuda" if on_card else "cpu")


def train_trace(cfg, state, batch, ocfg) -> dict:
    """One train step on ``state`` under torch.profiler: wall and
    device-busy seconds and device seconds by family (the hand forward
    kernels, the attention and scan backwards, cuBLAS matmuls, the
    optimizer, elementwise and copies), kernels counted once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.steps import TrainStepConfig, make_train_step

    step = make_train_step(cfg, ocfg, TrainStepConfig(loss_chunk=32))
    torch_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state["params"], state["opt"], batch)
        torch_sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    # the craft:: spans also appear on the device's timeline (user
    # annotations spanning their kernels): kernels only here
    ops = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("craft::")]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in ops):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    total = sum(e.time_range.elapsed_us() for e in ops) * 1e-6

    def by_name(name: str) -> str:
        if any(k in name for k in HAND_KERNELS):
            return "hand_forward_kernels"
        if any(k in name for k in MATMUL_KERNELS):
            return "matmul"
        return "elementwise_and_copies"

    family = dict.fromkeys(("hand_forward_kernels", "attention_backward",
                            "scan_backward", "optimizer", "matmul",
                            "elementwise_and_copies"), 0.0)
    for e in ops:
        family[by_name(e.name)] += e.time_range.elapsed_us() * 1e-6
    # a span's kernels (launched by the ops under it) move from their name
    # family to the span's
    def walk(ev, fam):
        for kern in ev.kernels:
            sec = kern.duration * 1e-6
            family[fam] += sec
            family[by_name(kern.name)] -= sec
        for ch in ev.cpu_children:
            walk(ch, fam)

    def under(ev) -> float:
        return (sum(k.duration for k in ev.kernels) * 1e-6
                + sum(under(ch) for ch in ev.cpu_children))

    spans, forward = {}, 0.0
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        fam = TRAIN_SPANS.get(e.name)
        if fam is not None:
            spans[fam] = spans.get(fam, 0) + 1
            walk(e, fam)
        elif e.name == "craft::forward":
            forward += under(e)
    # the backward (autograd's thread, remat recompute included) is what
    # the forward and the optimizer leave of the step's kernel time
    split = {"forward": forward, "optimizer": family["optimizer"]}
    split["backward"] = total - forward - family["optimizer"]
    return {"wall_s": wall, "device_busy_s": busy * 1e-6,
            "device_kernel_s": total, "device_ops": len(ops),
            "device_s_by_family": family, "device_s_by_pass": split,
            "backward_share": split["backward"] / total if total else None,
            "span_counts": spans}


def _host_stats() -> dict:
    """The pinned host caching allocator's current and peak bytes, where
    this PyTorch reports them."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", None)
    if DEVICE != "cuda" or stats is None:
        return {}
    return {k: v for k, v in stats().items()
            if k.startswith(("allocated_bytes", "reserved_bytes"))}


def _free_host_cache() -> None:
    """Collect cycles and hand the card's and the pinned host caches back
    (a closed Checkpoint's mirrors are the state's size)."""
    import torch

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
            release = getattr(torch._C, name, None)
            if release is not None:
                release()
                break


def rss_now_gib() -> float:
    """Resident set of this process now (VmRSS), GiB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 2**20
    return float("nan")


class RssPeak:
    """This process's own peak resident set, sampled every 0.2 s on a
    thread: ``ru_maxrss`` of a child started by fork and exec carries its
    parent's peak, and the card's machine reports no VmHWM."""

    def __init__(self):
        import threading

        self.peak = rss_now_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(0.2):
            self.peak = max(self.peak, rss_now_gib())

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        return max(self.peak, rss_now_gib())


def train_zamba2(scratch: Path) -> dict:
    """zamba2-2.7b at full width, cut to ZAMBA_TRAIN_LAYERS, through
    ``launch.train.run``: a run
    checkpointing every TRAIN_CP_FREQ steps cut at step TRAIN_FAIL_AT, the
    resumed run, which must restart at TRAIN_CP_FREQ, and an uninterrupted
    run, which the resumed one must equal bit for bit.  The cut and
    resumed runs go through a one-rank (1, 1) mesh (``run(mesh=...)``:
    DTensor state, the model under the sharding rules, the hand kernels
    through ``local_map``, the checkpoint of DTensor shards); the
    uninterrupted run is mesh-free.  It comes last and takes the host
    snapshot path (CRAFT_DEVICE_SNAPSHOT=0, and it writes no version): the
    resumed run's final state stays on the card beside it, and the device
    snapshot's word buffer (the state's size) would not fit there too."""
    import dataclasses

    import torch
    import torch.distributed as dist
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config, register_config
    from repro_torch.configs import zamba2_2p7b as Z
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.optim.adamw import adamw_update

    arch = ZAMBA_TRAIN_ARCH
    cut = dict(arch_id=arch, n_layers=ZAMBA_TRAIN_LAYERS)
    register_config(arch, Z.CONFIG.replace(**cut), Z.TINY.replace(**cut))
    cfg = get_config(arch, tiny=TRAIN_TINY)
    on_card = DEVICE == "cuda"
    tc = train.TrainConfig(arch=arch, tiny=TRAIN_TINY, steps=TRAIN_STEPS,
                           global_batch=TRAIN_BATCH, seq_len=ZAMBA_SEQ,
                           cp_freq=TRAIN_STEPS + 1, seed=SEED, device=DEVICE)
    ck = dataclasses.replace(tc, cp_freq=TRAIN_CP_FREQ)
    _reset_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def interrupt(step, metrics):
        if step == TRAIN_FAIL_AT:
            raise _Interrupted(f"interrupted after step {step}")

    mesh = one_rank_mesh()
    w0 = _tier_writes()
    t0 = time.perf_counter()
    try:
        train.run(ck, env=_train_env(scratch / "ck"), on_step=interrupt,
                  mesh=mesh)
    except _Interrupted:
        pass
    else:
        raise Failure(f"{arch}: the interrupted run was not interrupted")
    cut_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    _free_host_cache()
    w1 = _tier_writes()
    version_bytes = _dir_bytes(scratch / "ck")
    # the resumed run writes no version of its own (the cut run measured a
    # write): cp_freq past the last step
    resumed = train.run(tc, env=_train_env(scratch / "ck"), mesh=mesh)
    w2 = _tier_writes()
    mesh_leaves = sum(hasattr(x, "device_mesh") and x.device_mesh == mesh
                      for x in pytree.tree_leaves(resumed["state"]))
    require(w2[0] == w1[0], f"{arch}: the resumed run wrote a version")
    rss_ck = rss_now_gib()
    _free_host_cache()
    shutil.rmtree(scratch / "ck", ignore_errors=True)
    rss_freed = rss_now_gib()
    clean = train.run(tc, env=_train_env(scratch / "clean",
                                         device_snapshot=False))
    launches, routes, scans = _counts(), _attn_routes(), _scan_routes()
    steps_run = TRAIN_STEPS + TRAIN_FAIL_AT + TRAIN_STEPS - TRAIN_CP_FREQ
    require(resumed["start_step"] == TRAIN_CP_FREQ
            and resumed["final_step"] == TRAIN_STEPS,
            f"{arch}: resumed at {resumed['start_step']}, ended at "
            f"{resumed['final_step']}")
    require(resumed["losses"] == clean["losses"][TRAIN_CP_FREQ:],
            f"{arch}: resumed losses {resumed['losses']} != "
            f"{clean['losses'][TRAIN_CP_FREQ:]}")
    finite = all(math.isfinite(x) for r in (clean, resumed)
                 for x in r["losses"] + r["grad_norms"])
    require(finite, f"{arch}: a loss or grad norm was not finite")
    require(mesh_leaves == len(pytree.tree_leaves(resumed["state"])) - 1,
            f"{arch}: {mesh_leaves} of the resumed state's leaves are "
            "DTensors on the one-rank mesh (all but the host count)")
    require(_trees_equal(resumed["state"], clean["state"]),
            f"{arch}: the resumed run's parameters or optimizer state "
            "differ from the uninterrupted run's")
    n_shared = cfg.n_layers // cfg.shared_attn_every
    if on_card:
        # remat: every block's forward runs twice a step
        require(launches["flash_attention"] == 2 * n_shared * steps_run
                and routes["tc_prefill"] == launches["flash_attention"],
                f"{arch}: attention launches {launches} routes {routes}")
        require(launches["ssd_scan"] == 2 * cfg.n_layers * steps_run
                and scans["ssd_scan"]["chunked"] == launches["ssd_scan"],
                f"{arch}: scan launches {launches} routes {scans}")
        require(launches["checksum"] > 0 and launches["snapshot"] > 0,
                f"{arch}: checksum/snapshot never launched: {launches}")
    # the traces and the optimizer below run on the uninterrupted run's
    # (mesh-free) state, equal to the resumed one
    params, opt = clean["state"]["params"], clean["state"]["opt"]
    out = {"arch": arch, "batch": TRAIN_BATCH, "seq_len": ZAMBA_SEQ,
           "mesh": {"shape": list(mesh.shape),
                    "names": list(mesh.mesh_dim_names),
                    "backend": dist.get_backend(),
                    "runs": ["cut", "resumed"],
                    "dtensor_leaves": mesh_leaves},
           "param_bytes": _tree_bytes(params),
           "moment_bytes": _tree_bytes({"m": opt["m"], "v": opt["v"]}),
           "losses": clean["losses"], "grad_norms": clean["grad_norms"],
           "resumed_losses": resumed["losses"],
           "step_s": clean["step_s"],
           "median_step_s": statistics.median(clean["step_s"]),
           "resumed_step_s": resumed["step_s"],
           "cut_and_resumed_on_one_rank_mesh": True,
           "peak_device_bytes": peak,
           "peak_device_bytes_all_runs": (torch.cuda.max_memory_allocated()
                                          if on_card else None),
           "rss_gib_after_resumed_run": rss_ck,
           "rss_gib_after_host_cache_release": rss_freed,
           "rss_gib_after_uninterrupted_run": rss_now_gib(),
           "host_memory_stats": _host_stats(),
           "cut_run_s": cut_s,
           "cut_run_tier_writes": [w1[0] - w0[0], w1[1] - w0[1]],
           "version_bytes_on_disk": version_bytes,
           "restore_s": resumed["restore_s"],
           "restore_read_bytes": resumed["stats"].get("restore_read_bytes"),
           "resumed_tier_writes": [w2[0] - w1[0], w2[1] - w1[1]],
           "start_step": resumed["start_step"],
           "final_step": resumed["final_step"],
           "losses_equal": True, "state_equal": True, "finite": finite,
           "launches": launches, "attention_routes": routes,
           "scan_routes": scans}
    del resumed
    gc.collect()
    dist.destroy_process_group()
    batch = SyntheticTokens(vocab=cfg.vocab, seq_len=ZAMBA_SEQ,
                            global_batch=TRAIN_BATCH, seed=SEED).batch(0)
    ocfg = train.optim_config(tc)
    if on_card:
        out["trace"] = train_trace(cfg, clean["state"], batch, ocfg)
        # the optimizer alone on the live state: seconds and the bytes it
        # allocates above what is resident
        grads = pytree.tree_map(lambda p: torch.randn(
            p.shape, device=p.device, dtype=torch.float32).to(p.dtype),
            params)
        torch_sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        adamw_update(grads, opt, params, ocfg)
        torch_sync()
        out["update_s"] = time.perf_counter() - t0
        out["update_peak_extra_bytes"] = (torch.cuda.max_memory_allocated()
                                          - base)
        del grads
    del clean, params, opt
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def train_falcon() -> dict:
    """falcon-mamba-7b at full width, 8-bit moments: FALCON_STEPS steps on
    one batch must lower the loss; every s6_scan call chunked."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.optim.adamw import OptimConfig
    from repro_torch.train.steps import TrainStepConfig, make_train_step

    arch = "falcon-mamba-7b"
    cfg = get_config(arch, tiny=TRAIN_TINY)
    on_card = DEVICE == "cuda"
    ocfg = OptimConfig(lr=FALCON_LR, warmup_steps=1, total_steps=10,
                       state_bits=8, master_fp32=False)
    _reset_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = train.init_state(cfg, ocfg, SEED, DEVICE)
    torch_sync()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, ocfg, TrainStepConfig(loss_chunk=32))
    batch = SyntheticTokens(vocab=cfg.vocab, seq_len=FALCON_SEQ,
                            global_batch=TRAIN_BATCH, seed=SEED).batch(0)
    losses, norms, step_s = [], [], []
    for _ in range(FALCON_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
    launches, scans = _counts(), _scan_routes()
    require(all(math.isfinite(x) for x in losses + norms),
            f"{arch}: a loss or grad norm was not finite: {losses} {norms}")
    require(losses[-1] < losses[0], f"{arch}: the loss did not fall on one "
            f"batch: {losses}")
    if on_card:
        require(launches["s6_scan"] == 2 * cfg.n_layers * FALCON_STEPS
                and scans["s6_scan"]["chunked"] == launches["s6_scan"],
                f"{arch}: scan launches {launches} routes {scans}")
    trace = (train_trace(cfg, {"params": params, "opt": opt}, batch, ocfg)
             if on_card else None)
    out = {"arch": arch, "batch": TRAIN_BATCH, "seq_len": FALCON_SEQ,
           "state_bits": 8, "lr": FALCON_LR, "init_s": init_s,
           "param_bytes": _tree_bytes(params),
           "moment_bytes": _tree_bytes({"m": opt["m"], "v": opt["v"]}),
           "losses": losses, "grad_norms": norms, "step_s": step_s,
           "median_step_s": statistics.median(step_s),
           "peak_device_bytes": (torch.cuda.max_memory_allocated()
                                 if on_card else None),
           "launches": launches, "scan_routes": scans, "trace": trace}
    del params, opt
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def phase_train_child(scratch: Path) -> dict:
    """The train phase's body, in its own process (see phase_train)."""
    import torch

    from repro_torch.core import metrics

    if DEVICE == "cuda":
        require(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8",
                "the train child needs CUBLAS_WORKSPACE_CONFIG=:4096:8")
        # deterministic mode also fills each new allocation with NaN, so
        # an output that a kernel leaves unwritten shows in the losses
        torch.use_deterministic_algorithms(True)
    metrics.install()
    rss = RssPeak()
    zamba = train_zamba2(scratch)
    shutil.rmtree(scratch, ignore_errors=True)
    falcon = train_falcon()
    launches = {k: zamba["launches"][k] + falcon["launches"][k]
                for k in zamba["launches"]}
    return {"phase": "train", "zamba2": zamba, "falcon_mamba": falcon,
            "launches": launches,
            "child_peak_rss_gib": rss.stop(),
            "host_cache_release": [n for n in (
                "_host_emptyCache", "_accelerator_emptyHostCache")
                if hasattr(torch._C, n)]}


def phase_train(results: dict) -> dict:
    """Run the train phase in a child process (``--phases train-child``),
    so its ~28 GB of state and its host buffers do not stack on the
    earlier phases' resident memory; its non-zero exit fails the smoke."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    _free_host_cache()
    parent_rss = rss_now_gib()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--phases",
         "train-child"], env=env, capture_output=True, text=True,
        timeout=TRAIN_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise Failure(f"train child exited {proc.returncode}:\n"
                      f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out = json.loads(lines[-1])
    out["child_s"] = time.perf_counter() - t0
    out["parent_rss_gib_at_start"] = parent_rss
    results["train_launches"] = out["launches"]
    return out


# ---------------------------------------------------------------- report
KERNELS = [
    {"name": "checksum", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/checksum.cu",
     "replaces": "src/repro/kernels/checksum/kernel.py:49"},
    {"name": "snapshot", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/snapshot.cu",
     "replaces": "src/repro/kernels/snapshot/kernel.py:77"},
    {"name": "xor_reduce", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/xor_parity.cu",
     "replaces": "src/repro/kernels/xor_parity/kernel.py:37"},
    {"name": "gf_matmul", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/rs_erasure.cu",
     "replaces": "src/repro/kernels/rs_erasure/kernel.py:81"},
    {"name": "flash_attention", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
     "replaces": "src/repro/kernels/flash_attention/kernel.py:103"},
    {"name": "ssd_scan", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
     "replaces": "src/repro/kernels/ssm_scan/kernel.py:64"},
    {"name": "s6_scan", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
     "replaces": "src/repro/kernels/ssm_scan/kernel.py:133"},
]
# the path phase whose launches the table reports for each kernel
PATH_OF = {"checksum": "launches", "snapshot": "launches",
           "xor_reduce": "redundancy_launches",
           "gf_matmul": "redundancy_launches",
           "flash_attention": "serve_launches",
           "ssd_scan": "serve_launches", "s6_scan": "serve_launches"}
ALL_PHASES = ["build", "kernels", "main", "default", "control",
              "redundancy", "aft", "lanczos", "cluster", "mesh", "serve",
              "train"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset (debugging); the default "
                         "runs every phase and prints the result lines")
    ap.add_argument("--serve-archs", default=None,
                    help="comma-separated subset of the serve phase's "
                         "models (debugging; only with --phases)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if args.serve_archs:
        global SERVE_ARCHS
        require(phases != ALL_PHASES, "--serve-archs needs --phases")
        SERVE_ARCHS = tuple(args.serve_archs.split(","))
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: the port's sources are not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="smoke-", dir=ROOT / "build"))
    results: dict = {}
    wall: dict = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        wall[name] = out["wall_s"] = time.perf_counter() - t0
        emit(out)

    try:
        if "build" in phases:
            run("build", phase_build)
        if "kernels" in phases:
            run("kernels", phase_kernels, results)
        if "main" in phases:
            run("main", phase_main, results, scratch / "main")
            shutil.rmtree(scratch / "main", ignore_errors=True)
        if "default" in phases:
            run("default", phase_default, scratch / "default")
            shutil.rmtree(scratch / "default", ignore_errors=True)
        if "control" in phases:
            run("control", phase_control, results, scratch / "control")
            shutil.rmtree(scratch / "control", ignore_errors=True)
        if "redundancy" in phases:
            run("redundancy", phase_redundancy, results,
                scratch / "redundancy")
            shutil.rmtree(scratch / "redundancy", ignore_errors=True)
        if "aft" in phases:
            run("aft", phase_aft, results, scratch / "aft")
            shutil.rmtree(scratch / "aft", ignore_errors=True)
        if "lanczos" in phases:
            run("lanczos", phase_lanczos, results, scratch / "lanczos")
            shutil.rmtree(scratch / "lanczos", ignore_errors=True)
        if "cluster" in phases:
            run("cluster", phase_cluster, results, scratch / "cluster")
            shutil.rmtree(scratch / "cluster", ignore_errors=True)
        if "mesh" in phases:
            run("mesh", phase_mesh, results, scratch / "mesh")
            shutil.rmtree(scratch / "mesh", ignore_errors=True)
        if "serve" in phases:
            run("serve", phase_serve, results, scratch / "serve")
        if "train" in phases:
            run("train", phase_train, results)
        if "train-child" in phases:
            run("train-child", phase_train_child, scratch / "train")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    if phases != ALL_PHASES:
        return 0
    launches = {k["name"]: results[PATH_OF[k["name"]]][k["name"]]
                for k in KERNELS}
    missing = [k for k, n in launches.items() if n <= 0]
    require(not missing, f"kernels never launched on their path: {missing}")
    table = []
    for k in KERNELS:
        t = results["timing"][k["name"]]
        table.append({**k, "launches": launches[k["name"]],
                      "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                      "bound_by": t["bound_by"],
                      "library_ms": t.get("library_ms"),
                      "train_launches": results["train_launches"][
                          k["name"]],
                      "lanczos_launches": results["lanczos_launches"][
                          k["name"]],
                      "cluster_launches": results["cluster_launches"][
                          k["name"]],
                      "control_launches": results["control_launches"][
                          k["name"]],
                      "mesh_launches": results["mesh_launches"][k["name"]],
                      **{n: t[n] for n in ("mla_prefill",
                                           *FRONTEND_PREFILLS) if n in t}})
    emit({"phase_wall_s": wall, "total_wall_s": sum(wall.values())})
    emit({"kernels": table})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
