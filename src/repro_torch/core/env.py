"""CRAFT environment variables (paper Table 2), with read-once semantics.

The paper reads these variables exactly once — either at the definition of a
``Checkpoint`` object or at the start of an AFT zone — so changing them mid-run
has no effect.  We mirror that: ``CraftEnv.capture()`` snapshots the
environment; each ``Checkpoint`` / AFT zone stores its own snapshot.
"""
from __future__ import annotations

import dataclasses
import os
import signal as _signal
from pathlib import Path
from typing import Optional

# Paper Table 2 names.  CRAFT_USE_SCR is kept as an alias for the node-level
# tier toggle (SCR is the paper's node-level backend; ours is built in).
_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _bool(env: dict, key: str, default: bool) -> bool:
    raw = env.get(key)
    if raw is None:
        return default
    raw = raw.strip().lower()
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    raise ValueError(f"{key}={raw!r}: expected one of {_TRUE | _FALSE}")


@dataclasses.dataclass(frozen=True)
class CraftEnv:
    """Snapshot of every CRAFT_* control knob (paper Table 2 + extensions)."""

    # --- paper Table 2 ---------------------------------------------------
    cp_path: Path                    # CRAFT_CP_PATH        (default: $PWD)
    enable: bool                     # CRAFT_ENABLE         (default: 1)
    write_async: bool                # CRAFT_WRITE_ASYNC    (default: 0)
    write_async_zero_copy: bool      # CRAFT_WRITE_ASYNC_ZERO_COPY (default: 0)
    async_thread_pin_cpulist: tuple  # CRAFT_ASYNC_THREAD_PIN_CPULIST ("10_20")
    use_node_level: bool             # CRAFT_USE_SCR / CRAFT_USE_NODE_LEVEL (1)
    read_cp_on_restart: bool         # CRAFT_READ_CP_ON_RESTART (default: 1)
    comm_recovery_policy: str        # CRAFT_COMM_RECOVERY_POLICY:
                                     # NON-SHRINKING (default) | SHRINKING
    comm_spawn_policy: str           # CRAFT_COMM_SPAWN_POLICY:
                                     # NO-REUSE (default) | REUSE
    # --- TPU-era extensions (documented in DESIGN.md §2) ------------------
    node_cp_path: Optional[Path]     # CRAFT_NODE_CP_PATH   (node-tier dir)
    node_redundancy: str             # CRAFT_NODE_REDUNDANCY:
                                     # LOCAL|PARTNER|XOR|RS
    xor_group_size: int              # CRAFT_XOR_GROUP_SIZE (default: 8;
                                     # also the RS group size k)
    rs_parity: int                   # CRAFT_RS_PARITY: parity buffers m per
                                     # RS group — survives any m simultaneous
                                     # member losses (default: 2)
    pfs_every: int                   # CRAFT_PFS_EVERY: every k-th version also
                                     # lands on the PFS tier (default: 1)
    keep_versions: int               # CRAFT_KEEP_VERSIONS (default: 2)
    compress: str                    # CRAFT_COMPRESS: none|zstd (default none)
    zstd_level: int                  # CRAFT_ZSTD_LEVEL: zstd compression level
                                     # (default 3; compressors are built once
                                     # per IO worker, not once per chunk)
    zstd_gate_bits: float            # CRAFT_ZSTD_GATE_BITS: per-chunk
                                     # compressibility gate — chunks whose
                                     # order-0 nibble-entropy estimate is >=
                                     # this many bits/byte are stored raw
                                     # instead of zstd-compressed (default
                                     # 7.95; 0 disables the gate)
    checksum: str                    # CRAFT_CHECKSUM: crc32|fletcher|none
                                     # (default crc32; v1 files always store
                                     # the kernel fletcher digest when on)
    codec_version: int               # CRAFT_CODEC_VERSION: 0 legacy | 1 chunked
                                     # | 2 chunk-delta (incremental)
    chunk_bytes: int                 # CRAFT_CHUNK_BYTES (default 4 MiB)
    io_workers: int                  # CRAFT_IO_WORKERS: writer pool size
    delta: bool                      # CRAFT_DELTA: skip unchanged chunks by
                                     # diffing against the previous version
                                     # (implies codec v2; default off)
    delta_max_chain: int             # CRAFT_DELTA_MAX_CHAIN: max versions in
                                     # a delta chain before a full rewrite
                                     # (compaction; default 4)
    device_snapshot: bool            # CRAFT_DEVICE_SNAPSHOT: fused on-device
                                     # snapshot pipeline — per-chunk digests,
                                     # dirty mask and compressibility gate are
                                     # computed on the accelerator and only
                                     # dirty chunks cross device→host
                                     # (default off)
    # --- elastic restore (docs/architecture.md §elastic restore) -----------
    reshard: str                     # CRAFT_RESHARD: auto|range|full — N→M
                                     # restore assembly strategy (auto range-
                                     # reads only when the restoring extent
                                     # is a sub-extent of the global array or
                                     # shards live in peer version trees)
    elastic_hydrate: bool            # CRAFT_ELASTIC_HYDRATE: after a mem-tier
                                     # restore, re-seed the restoring rank's
                                     # RAM-fabric slots from surviving peer
                                     # replicas so replacement ranks rejoin
                                     # the redundancy group (default: 1)
    # --- memory tier (docs/architecture.md §memory tier) -------------------
    tier_chain: tuple                # CRAFT_TIER_CHAIN: ordered subset of
                                     # mem,node,pfs (default "node,pfs";
                                     # "mem,node,pfs" enables the RAM tier)
    mem_replicas: int                # CRAFT_MEM_REPLICAS: peer copies of each
                                     # rank's shards (round-robin, default 1)
    mem_budget_bytes: int            # CRAFT_MEM_BUDGET_BYTES: per-rank RAM
                                     # cap for the memory tier (0 = unlimited)
    mem_scratch: Optional[Path]      # CRAFT_MEM_SCRATCH: read for parity with
                                     # the reference's field set, used by
                                     # nothing (the memory tier stages no
                                     # files)
    # --- adaptive scheduler (docs/tuning.md) -------------------------------
    tier_every: tuple                # CRAFT_TIER_EVERY: per-tier cadence spec,
                                     # "mem:1,node:8,pfs:64" counts, "auto" =
                                     # Young/Daly intervals; empty = legacy
                                     # (every version + CRAFT_PFS_EVERY)
    mtbf_seconds: float              # CRAFT_MTBF_SECONDS: mean time between
                                     # failures feeding the Daly formula
                                     # (0 = use the communicator's empirical
                                     # rate, else a 1-day default)
    walltime_seconds: float          # CRAFT_WALLTIME_SECONDS: job walltime
                                     # budget; the policy lands one final full
                                     # checkpoint before it expires (0 = off)
    walltime_margin_seconds: float   # CRAFT_WALLTIME_MARGIN_SECONDS: safety
                                     # margin subtracted from the walltime on
                                     # top of the estimated write cost
    cp_signal: tuple                 # CRAFT_CP_SIGNAL: signal names (e.g.
                                     # "SIGTERM,SIGUSR1") that trigger a
                                     # synchronous flush of the deepest tier
                                     # (batch-scheduler preemption notice)
    # --- integrity scrubber (core/scrubber.py) -----------------------------
    scrub_every: float               # CRAFT_SCRUB_EVERY: seconds between
                                     # background scrub slices, run in idle
                                     # checkpoint opportunities (0 = no
                                     # background scrubbing; repair-on-read
                                     # stays active)
    scrub_bytes_per_s: float         # CRAFT_SCRUB_BYTES_PER_S: scrub IO
                                     # throttle — bytes verified per second,
                                     # accumulated between slices
                                     # (0 = unthrottled)
    # --- chaos + resilient IO (core/chaos.py / core/health.py) -------------
    chaos: str                       # CRAFT_CHAOS: fault-injection spec,
                                     # "slot:fault:k=v+k=v,..." rules (or
                                     # "on" to arm the engine with no rules;
                                     # empty = chaos off)
    chaos_seed: int                  # CRAFT_CHAOS_SEED: seed for the
                                     # per-operation injection RNG so fault
                                     # schedules replay bit-identically
    io_retries: int                  # CRAFT_IO_RETRIES: retry attempts for
                                     # transient tier IO errors (EIO/EAGAIN/
                                     # EINTR/ETIMEDOUT) per operation
    io_backoff_ms: float             # CRAFT_IO_BACKOFF_MS: base retry delay,
                                     # doubled per attempt with +-50% jitter
    io_deadline_s: float             # CRAFT_IO_DEADLINE_S: wall-clock budget
                                     # per tier write before it is abandoned
                                     # as hung (0 = no deadline)
    breaker_threshold: int           # CRAFT_BREAKER_THRESHOLD: consecutive
                                     # tier failures before its circuit
                                     # breaker opens and writes degrade to
                                     # the next chain level
    breaker_cooldown_s: float        # CRAFT_BREAKER_COOLDOWN_S: seconds an
                                     # open breaker waits before admitting a
                                     # half-open health probe
    # --- trace recording + auto-tuning (core/trace.py / core/tune.py) ------
    trace_path: str                  # CRAFT_TRACE: JSONL run-trace output
                                     # path; empty = recorder stays the
                                     # module-level no-op (zero overhead)
    tune_online: bool                # CRAFT_TUNE_ONLINE: periodically
                                     # re-solve per-tier cadences inside
                                     # CheckpointPolicy from live write-cost
                                     # EWMAs + the empirical failure log
                                     # (default off)
    tune_every_s: float              # CRAFT_TUNE_EVERY_S: seconds between
                                     # online re-tuning solves (default 60)
    # --- live telemetry plane (core/metrics.py / core/telemetry.py) --------
    metrics: bool                    # CRAFT_METRICS: arm the process-global
                                     # metrics registry (counters/gauges/
                                     # histograms) and, with no trace file,
                                     # the memory span recorder; unset =
                                     # every hook is a single no-op call
                                     # (default off)
    metrics_port: int                # CRAFT_METRICS_PORT: serve Prometheus
                                     # text at /metrics and JSON at /healthz
                                     # on this port (0 picks an ephemeral
                                     # port; -1 = exporter off, default)

    def tier_every_for(self, slot: str):
        """Cadence spec for a chain slot: int count, "auto", or None (legacy).

        A bare ``CRAFT_TIER_EVERY=auto`` applies to every slot (stored under
        the ``*`` wildcard); otherwise only explicitly named slots are
        overridden and the rest keep their legacy default.
        """
        spec = dict(self.tier_every)
        return spec.get(slot, spec.get("*"))

    @staticmethod
    def capture(environ: Optional[dict] = None) -> "CraftEnv":
        env = dict(os.environ if environ is None else environ)
        pin_raw = env.get("CRAFT_ASYNC_THREAD_PIN_CPULIST", "").strip()
        pin = tuple(int(tok) for tok in pin_raw.split("_") if tok) if pin_raw else ()
        use_node = _bool(env, "CRAFT_USE_SCR", True) and _bool(
            env, "CRAFT_USE_NODE_LEVEL", True
        )
        recovery = env.get("CRAFT_COMM_RECOVERY_POLICY", "NON-SHRINKING").upper()
        if recovery not in ("NON-SHRINKING", "SHRINKING"):
            raise ValueError(f"CRAFT_COMM_RECOVERY_POLICY={recovery!r}")
        spawn = env.get("CRAFT_COMM_SPAWN_POLICY", "NO-REUSE").upper()
        if spawn not in ("NO-REUSE", "REUSE"):
            raise ValueError(f"CRAFT_COMM_SPAWN_POLICY={spawn!r}")
        node_path = env.get("CRAFT_NODE_CP_PATH")
        redundancy = env.get("CRAFT_NODE_REDUNDANCY", "PARTNER").upper()
        if redundancy not in ("LOCAL", "PARTNER", "XOR", "RS"):
            raise ValueError(f"CRAFT_NODE_REDUNDANCY={redundancy!r}")
        rs_parity = int(env.get("CRAFT_RS_PARITY", "2"))
        if rs_parity < 1:
            raise ValueError(f"CRAFT_RS_PARITY={rs_parity!r}")
        compress = env.get("CRAFT_COMPRESS", "none").lower()
        if compress not in ("none", "zstd"):
            raise ValueError(f"CRAFT_COMPRESS={compress!r}")
        zstd_level = int(env.get("CRAFT_ZSTD_LEVEL", "3"))
        if not 1 <= zstd_level <= 22:
            raise ValueError(f"CRAFT_ZSTD_LEVEL={zstd_level!r}: expected 1..22")
        zstd_gate_bits = float(env.get("CRAFT_ZSTD_GATE_BITS", "7.95"))
        if not 0 <= zstd_gate_bits <= 8:
            raise ValueError(
                f"CRAFT_ZSTD_GATE_BITS={zstd_gate_bits!r}: expected 0..8")
        checksum = env.get("CRAFT_CHECKSUM", "crc32").lower()
        if checksum not in ("crc32", "fletcher", "none"):
            raise ValueError(f"CRAFT_CHECKSUM={checksum!r}")
        codec_version = int(env.get("CRAFT_CODEC_VERSION", "1"))
        if codec_version not in (0, 1, 2):
            raise ValueError(f"CRAFT_CODEC_VERSION={codec_version!r}")
        delta = _bool(env, "CRAFT_DELTA", codec_version == 2)
        if delta and codec_version == 0:
            raise ValueError(
                "CRAFT_DELTA=1 needs the chunked codec "
                "(CRAFT_CODEC_VERSION >= 1, got 0)"
            )
        if delta:
            codec_version = 2        # delta writes are format v2
        delta_max_chain = int(env.get("CRAFT_DELTA_MAX_CHAIN", "4"))
        if delta_max_chain < 1:
            raise ValueError(f"CRAFT_DELTA_MAX_CHAIN={delta_max_chain!r}")
        device_snapshot = _bool(env, "CRAFT_DEVICE_SNAPSHOT", False)
        chunk_bytes = int(env.get("CRAFT_CHUNK_BYTES", str(4 * 1024 * 1024)))
        if chunk_bytes <= 0:
            raise ValueError(f"CRAFT_CHUNK_BYTES={chunk_bytes!r}")
        reshard = env.get("CRAFT_RESHARD", "auto").lower()
        if reshard not in ("auto", "range", "full"):
            raise ValueError(
                f"CRAFT_RESHARD={reshard!r}: expected auto|range|full")
        elastic_hydrate = _bool(env, "CRAFT_ELASTIC_HYDRATE", True)
        chain_raw = env.get("CRAFT_TIER_CHAIN", "node,pfs").lower()
        tier_chain = tuple(t.strip() for t in chain_raw.split(",") if t.strip())
        if not tier_chain or len(set(tier_chain)) != len(tier_chain) or not (
            set(tier_chain) <= {"mem", "node", "pfs"}
        ):
            raise ValueError(
                f"CRAFT_TIER_CHAIN={chain_raw!r}: expected an ordered, "
                "duplicate-free subset of mem,node,pfs"
            )
        mem_replicas = int(env.get("CRAFT_MEM_REPLICAS", "1"))
        if mem_replicas < 0:
            raise ValueError(f"CRAFT_MEM_REPLICAS={mem_replicas!r}")
        mem_budget = int(env.get("CRAFT_MEM_BUDGET_BYTES", "0"))
        if mem_budget < 0:
            raise ValueError(f"CRAFT_MEM_BUDGET_BYTES={mem_budget!r}")
        mem_scratch = env.get("CRAFT_MEM_SCRATCH")
        tier_every = _parse_tier_every(env.get("CRAFT_TIER_EVERY", ""))
        mtbf_seconds = float(env.get("CRAFT_MTBF_SECONDS", "0"))
        if mtbf_seconds < 0:
            raise ValueError(f"CRAFT_MTBF_SECONDS={mtbf_seconds!r}")
        walltime_seconds = float(env.get("CRAFT_WALLTIME_SECONDS", "0"))
        if walltime_seconds < 0:
            raise ValueError(f"CRAFT_WALLTIME_SECONDS={walltime_seconds!r}")
        walltime_margin = float(env.get("CRAFT_WALLTIME_MARGIN_SECONDS", "60"))
        if walltime_margin < 0:
            raise ValueError(
                f"CRAFT_WALLTIME_MARGIN_SECONDS={walltime_margin!r}")
        cp_signal = _parse_cp_signal(env.get("CRAFT_CP_SIGNAL", ""))
        scrub_every = float(env.get("CRAFT_SCRUB_EVERY", "0"))
        if scrub_every < 0:
            raise ValueError(f"CRAFT_SCRUB_EVERY={scrub_every!r}")
        scrub_bytes_per_s = float(env.get("CRAFT_SCRUB_BYTES_PER_S", "0"))
        if scrub_bytes_per_s < 0:
            raise ValueError(
                f"CRAFT_SCRUB_BYTES_PER_S={scrub_bytes_per_s!r}")
        chaos = env.get("CRAFT_CHAOS", "").strip()
        if chaos:
            # validate eagerly so typos fail at capture, not mid-write
            from repro_torch.core.chaos import parse_chaos_spec
            parse_chaos_spec(chaos)
        chaos_seed = int(env.get("CRAFT_CHAOS_SEED", "0"))
        io_retries = int(env.get("CRAFT_IO_RETRIES", "2"))
        if io_retries < 0:
            raise ValueError(f"CRAFT_IO_RETRIES={io_retries!r}")
        io_backoff_ms = float(env.get("CRAFT_IO_BACKOFF_MS", "25"))
        if io_backoff_ms < 0:
            raise ValueError(f"CRAFT_IO_BACKOFF_MS={io_backoff_ms!r}")
        io_deadline_s = float(env.get("CRAFT_IO_DEADLINE_S", "0"))
        if io_deadline_s < 0:
            raise ValueError(f"CRAFT_IO_DEADLINE_S={io_deadline_s!r}")
        breaker_threshold = int(env.get("CRAFT_BREAKER_THRESHOLD", "3"))
        if breaker_threshold < 1:
            raise ValueError(f"CRAFT_BREAKER_THRESHOLD={breaker_threshold!r}")
        breaker_cooldown_s = float(env.get("CRAFT_BREAKER_COOLDOWN_S", "30"))
        if breaker_cooldown_s < 0:
            raise ValueError(f"CRAFT_BREAKER_COOLDOWN_S={breaker_cooldown_s!r}")
        trace_path = env.get("CRAFT_TRACE", "").strip()
        tune_online = _bool(env, "CRAFT_TUNE_ONLINE", False)
        tune_every_s = float(env.get("CRAFT_TUNE_EVERY_S", "60"))
        if tune_every_s <= 0:
            raise ValueError(f"CRAFT_TUNE_EVERY_S={tune_every_s!r}")
        metrics = _bool(env, "CRAFT_METRICS", False)
        metrics_port_raw = env.get("CRAFT_METRICS_PORT", "").strip()
        metrics_port = int(metrics_port_raw) if metrics_port_raw else -1
        if metrics_port < -1 or metrics_port > 65535:
            raise ValueError(f"CRAFT_METRICS_PORT={metrics_port!r}")
        if metrics_port >= 0:
            metrics = True      # an exporter implies an armed registry
        io_workers_raw = env.get("CRAFT_IO_WORKERS")
        if io_workers_raw is None:
            io_workers = min(4, os.cpu_count() or 1)
        else:
            io_workers = int(io_workers_raw)
        if io_workers < 1:
            raise ValueError(f"CRAFT_IO_WORKERS={io_workers!r}")
        return CraftEnv(
            cp_path=Path(env.get("CRAFT_CP_PATH", os.getcwd())),
            enable=_bool(env, "CRAFT_ENABLE", True),
            write_async=_bool(env, "CRAFT_WRITE_ASYNC", False),
            write_async_zero_copy=_bool(env, "CRAFT_WRITE_ASYNC_ZERO_COPY", False),
            async_thread_pin_cpulist=pin,
            use_node_level=use_node,
            read_cp_on_restart=_bool(env, "CRAFT_READ_CP_ON_RESTART", True),
            comm_recovery_policy=recovery,
            comm_spawn_policy=spawn,
            node_cp_path=Path(node_path) if node_path else None,
            node_redundancy=redundancy,
            xor_group_size=int(env.get("CRAFT_XOR_GROUP_SIZE", "8")),
            rs_parity=rs_parity,
            pfs_every=int(env.get("CRAFT_PFS_EVERY", "1")),
            keep_versions=int(env.get("CRAFT_KEEP_VERSIONS", "2")),
            compress=compress,
            zstd_level=zstd_level,
            zstd_gate_bits=zstd_gate_bits,
            checksum=checksum,
            codec_version=codec_version,
            chunk_bytes=chunk_bytes,
            io_workers=io_workers,
            delta=delta,
            delta_max_chain=delta_max_chain,
            device_snapshot=device_snapshot,
            reshard=reshard,
            elastic_hydrate=elastic_hydrate,
            tier_chain=tier_chain,
            mem_replicas=mem_replicas,
            mem_budget_bytes=mem_budget,
            mem_scratch=Path(mem_scratch) if mem_scratch else None,
            tier_every=tier_every,
            mtbf_seconds=mtbf_seconds,
            walltime_seconds=walltime_seconds,
            walltime_margin_seconds=walltime_margin,
            cp_signal=cp_signal,
            scrub_every=scrub_every,
            scrub_bytes_per_s=scrub_bytes_per_s,
            chaos=chaos,
            chaos_seed=chaos_seed,
            io_retries=io_retries,
            io_backoff_ms=io_backoff_ms,
            io_deadline_s=io_deadline_s,
            breaker_threshold=breaker_threshold,
            breaker_cooldown_s=breaker_cooldown_s,
            trace_path=trace_path,
            tune_online=tune_online,
            tune_every_s=tune_every_s,
            metrics=metrics,
            metrics_port=metrics_port,
        )


_AUTO = {"auto", "daly"}


def _parse_tier_every(raw: str) -> tuple:
    """``CRAFT_TIER_EVERY`` → ((slot, count|"auto"), ...).

    Accepted forms: ``auto`` (every chained tier on Daly intervals),
    ``mem:1,node:8,pfs:64`` (write counts per tier), and mixtures like
    ``node:8,pfs:auto``.  Counts are per *checkpoint opportunity* (calls that
    pass the ``cp_freq`` gate), so a sparse deep tier never starves.
    """
    raw = raw.strip().lower()
    if not raw:
        return ()
    if raw in _AUTO:
        return (("*", "auto"),)
    out = []
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if ":" not in tok:
            raise ValueError(
                f"CRAFT_TIER_EVERY entry {tok!r}: expected slot:count or "
                "slot:auto (or a bare 'auto' for every tier)"
            )
        slot, val = (s.strip() for s in tok.split(":", 1))
        if slot not in ("mem", "node", "pfs"):
            raise ValueError(f"CRAFT_TIER_EVERY slot {slot!r}: "
                             "expected one of mem,node,pfs")
        if val in _AUTO:
            out.append((slot, "auto"))
        else:
            count = int(val)
            if count < 1:
                raise ValueError(f"CRAFT_TIER_EVERY {slot}:{val}: count >= 1")
            out.append((slot, count))
    slots = [s for s, _ in out]
    if len(set(slots)) != len(slots):
        raise ValueError(f"CRAFT_TIER_EVERY={raw!r}: duplicate slot")
    return tuple(out)


def _parse_cp_signal(raw: str) -> tuple:
    """``CRAFT_CP_SIGNAL`` → tuple of validated signal names ("SIGTERM", …)."""
    names = []
    for tok in raw.replace(";", ",").split(","):
        tok = tok.strip().upper()
        if not tok:
            continue
        if not tok.startswith("SIG"):
            tok = "SIG" + tok
        if not isinstance(getattr(_signal, tok, None), _signal.Signals):
            raise ValueError(f"CRAFT_CP_SIGNAL: unknown signal {tok!r}")
        names.append(tok)
    if len(set(names)) != len(names):
        raise ValueError(f"CRAFT_CP_SIGNAL={raw!r}: duplicate signal")
    return tuple(names)
