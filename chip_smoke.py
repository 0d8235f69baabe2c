#!/usr/bin/env python3
"""Drive the PyTorch port of CRAFT (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # every phase (the default)

Phases, each printing one JSON line:

1. build   — compile the hand-written CUDA kernels (``checksum``,
   ``snapshot``) from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a,
   all sources at once; print the build seconds and the card.
2. kernels — every kernel against its plain PyTorch version on the card,
   bit-exact (integer results): random words, words near 2^32, zeros, ragged
   grids, dirty/clean prev tables, the main path's call shapes and one
   (873, 1048576)-word matrix (the full-size state viewed as 4 MiB chunks).
   CUDA-event medians of the kernel and the plain version on that matrix.
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

Then the kernel table (JSON), the card's name and power limit, and the last
line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line; so does a machine without a CUDA card, or a directory without
the port's sources.  Scratch files go to ``build/`` inside the checkout and
are removed at the end.
"""
from __future__ import annotations

import argparse
import json
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


class Failure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------- phase 1
def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(["checksum", "snapshot"])
    _build.load("checksum")
    _build.load("snapshot")
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in ("checksum", "snapshot"):
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
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
    results["timing"] = timing
    return {"phase": "kernels", "cases": cases, "timing": timing}


# ---------------------------------------------------------------- phase 3
def danube_state(device, gen):
    """The h2o-danube-1.8b parameter set as a flat bf16 state dict."""
    import torch

    d, hd = D_MODEL, HEAD_DIM
    shapes = {"embed.embedding": (VOCAB, d), "final_ln": (d,),
              "lm_head": (d, VOCAB)}
    for i in range(N_LAYERS):
        p = f"blocks.{i:02d}."
        shapes.update({
            p + "ln1": (d,), p + "ln2": (d,),
            p + "attn.wq": (d, N_HEADS, hd), p + "attn.wk": (d, N_KV, hd),
            p + "attn.wv": (d, N_KV, hd), p + "attn.wo": (N_HEADS, hd, d),
            p + "ffn.w_gate": (d, D_FF), p + "ffn.w_up": (d, D_FF),
            p + "ffn.w_down": (D_FF, d),
        })
    return {k: torch.randn(s, generator=gen, device=device,
                           dtype=torch.bfloat16) * 0.02
            for k, s in shapes.items()}


def _counts():
    from repro_torch.kernels.checksum.kernel import checksum_rows
    from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda

    return {"checksum": checksum_rows.launches,
            "snapshot": snapshot_chunks_cuda.launches}


def _reset_counts() -> None:
    from repro_torch.kernels.checksum.kernel import checksum_rows
    from repro_torch.kernels.snapshot.kernel import snapshot_chunks_cuda

    checksum_rows.launches = 0
    snapshot_chunks_cuda.launches = 0


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


# ---------------------------------------------------------------- report
KERNELS = [
    {"name": "checksum", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/checksum.cu",
     "replaces": "src/repro/kernels/checksum/kernel.py:49"},
    {"name": "snapshot", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/snapshot.cu",
     "replaces": "src/repro/kernels/snapshot/kernel.py:77"},
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="build,kernels,main,default",
                    help="comma-separated subset (debugging); the default "
                         "runs every phase and prints the result lines")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
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
    try:
        if "build" in phases:
            emit(phase_build())
        if "kernels" in phases:
            emit(phase_kernels(results))
        if "main" in phases:
            emit(phase_main(results, scratch / "main"))
        if "default" in phases:
            emit(phase_default(scratch / "default"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    if phases != ["build", "kernels", "main", "default"]:
        return 0
    launches = results["launches"]
    missing = [k for k, n in launches.items() if n <= 0]
    require(not missing, f"kernels never launched on the main path: {missing}")
    table = []
    for k in KERNELS:
        t = results["timing"][k["name"]]
        table.append({**k, "launches": launches[k["name"]],
                      "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                      "bound_by": t["bound_by"], "library_ms": None})
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
