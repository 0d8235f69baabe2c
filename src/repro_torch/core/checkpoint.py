"""The ``Checkpoint`` class — CRAFT's user-facing CR interface (paper §2.2).

Life cycle (paper Listing 2):

    cp = Checkpoint("myCP", comm)          # directories named by cpName
    cp.add("iteration", it_box)            # gather checkpointables
    cp.add("params", params_box)
    cp.commit()                            # freeze — no further add()
    cp.restart_if_needed()                 # read latest version, if any
    while ...:
        ...
        if cp.need_checkpoint(iteration):  # the policy decides when/where
            cp.update_and_write(iteration)

Scheduling: every committed checkpoint owns a
:class:`~repro_torch.core.scheduler.CheckpointPolicy` that decides, per step,
whether to write and to which tiers — per-tier cadences or Young/Daly
intervals (``CRAFT_TIER_EVERY``), preemption signals (``CRAFT_CP_SIGNAL``),
and a walltime guard (``CRAFT_WALLTIME_SECONDS``); see ``docs/tuning.md``.
The raw ``cp.update_and_write(iteration, cp_freq)`` modulo idiom from earlier
revisions still works — ``cp_freq`` is applied as a frequency gate on top of
the policy — but it is a **deprecated idiom**: new code should rely on the
policy knobs (or probe ``need_checkpoint()``) instead of hand-rolled
``iteration % freq`` checks; the two-argument form is kept for paper parity
and back-compat.

Tiers (``CRAFT_TIER_CHAIN``, fastest first): the optional **memory tier**
(RAM shards replicated onto peer ranks — rapid post-shrink recovery), the
**node tier** (fast node-local storage with partner/XOR/RS redundancy — the
SCR analog) when enabled, and every ``pfs_every``-th version additionally lands
on the **PFS tier** (the durable parallel file system).  Reads drain the
chain in order; writes go through to every chained tier (the memory tier is
skipped for a version when its budget is exceeded — :class:`MemTierError` is
collective, so the fallback is consistent across ranks).
``disable_node_level()`` is the paper's ``disableSCR()``.

Asynchrony (paper §2.4): with ``CRAFT_WRITE_ASYNC=1`` the device→host
snapshot (``update()``) happens inline and the file IO runs on a dedicated
writer thread; with ``CRAFT_WRITE_ASYNC_ZERO_COPY=1`` even the snapshot runs
on the writer thread and the caller must ``wait()`` before mutating the data.

Device: ``Checkpoint(..., device="cuda")`` (the default) runs the codec's
chunk digests, the memory tier's digests and the node tier's parity math on
the card through the hand-written kernels; pass ``device="cpu"`` to run
them on the host.  Tensors carry their own device.  A
``node_store_factory(cp)`` builds the node tier from the checkpoint and
reads ``cp.device`` for it.
"""
from __future__ import annotations

import dataclasses
import errno
import os
import time
from pathlib import Path
from typing import Dict, Optional

from repro_torch.core import (checkpointables, metrics, nested, storage, telemetry,
                        tiers, trace)
from repro_torch.core.async_writer import AsyncWriter
from repro_torch.core.comm import ChannelComm, NullComm
from repro_torch.core.cpbase import CheckpointError, CpBase, IOContext
from repro_torch.core.env import CraftEnv


class Checkpoint:
    """A named collection of checkpointable objects (paper Fig. 2 ``cpMap``)."""

    def __init__(
        self,
        name: str,
        comm=None,
        env: Optional[CraftEnv] = None,
        node_store_factory=None,
        clock=time.monotonic,
        device="cuda",
    ):
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"checkpoint name must be a valid directory name: {name!r}")
        self.name = name
        self.device = str(device)
        base_comm = comm if comm is not None else NullComm()
        # All checkpoint coordination runs on a dedicated collective channel
        # so writer-thread barriers never interleave with user collectives.
        self.comm = ChannelComm(base_comm, f"cp:{name}")
        # paper §4.1: env is read exactly once, at Checkpoint definition
        self.env = env if env is not None else CraftEnv.capture()
        self._map: Dict[str, CpBase] = {}
        self._committed = False
        self._closed = False
        self._version = 0                     # in-memory CP-version counter
        self._node_enabled = self.env.use_node_level
        self._node_store_factory = node_store_factory
        self._pfs: Optional[storage.VersionStore] = None
        self._node = None
        self._mem = None
        self._writer: Optional[AsyncWriter] = None
        # scheduling (core/scheduler.py): built at commit() once the tier
        # chain exists; ``clock`` is injectable for deterministic tests
        self._clock = clock
        self._policy = None
        self._scrubber = None
        self._decision_cache = None   # (iteration, version, Decision)
        # resilience plane: the fault injector (CRAFT_CHAOS, None when off)
        # and per-slot circuit breakers (core/health.py), built at commit()
        self._chaos = None
        self._health: Dict[str, object] = {}
        # Per-tier-slot delta state: the chunk manifests of the last version
        # written to (or restored from) that tier, diffed against at the next
        # write.  {"version", "deps": set, "files": {rel: manifest}}
        self._delta_state: Dict[str, dict] = {}
        self._last_write_t = None    # monotonic stamp of the last landed
                                     # version (telemetry /healthz age)
        # StatsView: a plain dict to every existing caller, but numeric
        # writes mirror into the live metrics registry (CRAFT_METRICS) as
        # cp_* series labelled with this checkpoint's name
        self.stats = metrics.StatsView(name, {
            "writes": 0,
            "mem_writes": 0,
            "mem_skipped": 0,
            "node_writes": 0,
            "pfs_writes": 0,
            "bytes_written": 0,       # logical payload size (all tiers)
            "tier_bytes_written": 0,  # bytes physically written by the codec
            "delta_chunks_total": 0,
            "delta_chunks_skipped": 0,   # chunks written as refs, not bytes
            "delta_compactions": 0,
            "write_seconds": 0.0,
            "reads": 0,
            "read_seconds": 0.0,
            "restore_tier": None,     # label of the tier the last read used
            "tier_reads": {},         # successful restores per tier label
            "restore_read_bytes": 0,  # payload bytes the last restore fetched
                                      # (range reads < full payload on N→M)
            "mem_rehydrations": 0,    # fabric slots re-seeded after mem
                                      # restores (CRAFT_ELASTIC_HYDRATE)
            "preempt_flushes": 0,     # CRAFT_CP_SIGNAL-triggered sync flushes
            "final_writes": 0,        # walltime-guard final full checkpoints
            "read_repairs": 0,        # restores saved by repair-on-read
            "retries": 0,             # transient IO errors absorbed by the
                                      # retry/backoff layer (CRAFT_IO_RETRIES)
            "breaker_trips": 0,       # circuit-breaker CLOSED/HALF_OPEN→OPEN
                                      # transitions across all tiers
            "degraded_writes": 0,     # scheduled tier writes skipped or lost
                                      # to a fault and routed down the chain
            "abandoned_writes": 0,    # hung writes cut off by the
                                      # CRAFT_IO_DEADLINE_S watchdog
            "enospc_retires": 0,      # emergency retention squeezes that
                                      # freed space for a write in flight
        })

    # ------------------------------------------------------------------ add
    def add(self, key: str, obj, **kw) -> None:
        """Register a checkpointable under ``key`` (paper's overloaded add())."""
        if self._committed:
            raise CheckpointError(
                f"Checkpoint {self.name!r} is committed — add() is frozen "
                "(create a new Checkpoint for additional data, paper §2.2)"
            )
        if not key or "/" in key or key.startswith("."):
            raise ValueError(f"checkpoint key must be a valid file name: {key!r}")
        if key in self._map:
            raise CheckpointError(f"duplicate checkpoint key {key!r}")
        # Device-resident snapshot path (CRAFT_DEVICE_SNAPSHOT): tensor
        # checkpointables get a fused on-device digest/dirty/entropy pass at
        # update() time, keyed to the same chunk grid the codec writes.
        kw.setdefault("device_snapshot", self.env.device_snapshot)
        kw.setdefault("chunk_bytes", self.env.chunk_bytes)
        # The entropy histogram only feeds the zstd gate — skip the extra
        # device work entirely when no write can consult it.
        kw.setdefault("device_hist", self.env.compress == "zstd"
                      and self.env.zstd_gate_bits > 0)
        # A second host mirror only serves a writer thread that may still
        # read the previous version's while the next snapshot patches the
        # other; synchronous writes finish first, so one mirror (the size
        # of the state in pinned host memory) is enough.
        kw.setdefault("double_buffer", self.env.write_async
                      or self.env.write_async_zero_copy)
        with trace.TRACER.span("craft::cp.add", cp=self.name, key=key) as sp:
            item = checkpointables.wrap(obj, **kw)
            if sp.armed:
                sp.set(bytes=item.nbytes())
        self._map[key] = item

    # --------------------------------------------------------------- commit
    def commit(self) -> None:
        if self._committed:
            raise CheckpointError(f"Checkpoint {self.name!r} already committed")
        if not self._map:
            raise CheckpointError(f"Checkpoint {self.name!r} has no data")
        self._committed = True
        if not self.env.enable:
            return
        # Arm the run-trace recorder (CRAFT_TRACE) and stamp the trace with
        # the knobs this checkpoint was captured under — the replayer
        # re-captures a CraftEnv from exactly this snapshot.
        trace.maybe_install_from_env(self.env)
        # Arm the live telemetry plane (CRAFT_METRICS / CRAFT_METRICS_PORT):
        # the metrics registry, the /metrics + /healthz exporter, and this
        # checkpoint's /healthz registration (weak — no lifetime extension).
        metrics.maybe_install_from_env(self.env)
        telemetry.maybe_start_from_env(self.env)
        telemetry.register_checkpoint(self)
        trace.TRACER.emit(
            "config",
            name=self.name,
            **trace.env_snapshot(self.env, payload_bytes=self.nbytes(),
                                 comm_size=self.comm.size),
        )
        chain = self.env.tier_chain
        if "pfs" in chain:
            self._pfs = storage.VersionStore(
                self.env.cp_path,
                self.name,
                keep_versions=self.env.keep_versions,
                comm=self.comm,
            )
        if "node" in chain and self._node_enabled \
                and self._node_store_factory is not None:
            self._node = self._node_store_factory(self)
        elif "node" in chain and self._node_enabled \
                and self.env.node_cp_path is not None:
            from repro_torch.core.node_level import NodeStore

            self._node = NodeStore(
                base=self.env.node_cp_path,
                name=self.name,
                comm=self.comm,
                env=self.env,
                device=self.device,
            )
        if "mem" in chain:
            from repro_torch.core.mem_level import MemStore

            self._mem = MemStore(self.name, self.comm, self.env,
                                 device=self.device)
        if (
            self.env.write_async
            or self.env.write_async_zero_copy
            or self.env.io_workers > 1
        ):
            # The ordered lane serializes versions (async modes); the worker
            # pool fans out per-array/per-chunk IO — also used in sync mode.
            self._writer = AsyncWriter(
                workers=self.env.io_workers,
                pin_cpulist=self.env.async_thread_pin_cpulist,
                name=f"craft-writer-{self.name}",
            )
        if self.env.chaos:
            from repro_torch.core.chaos import ChaosEngine

            self._chaos = ChaosEngine(self.env.chaos, seed=self.env.chaos_seed)
            for store, slot, _ in self._chained_stores():
                store.chaos_scope = self._chaos.scope(slot)
        from repro_torch.core.health import TierHealth

        self._health = {
            slot: TierHealth(
                slot,
                threshold=self.env.breaker_threshold,
                cooldown_s=self.env.breaker_cooldown_s,
                clock=self._clock,
            )
            for _, slot, _ in self._chained_stores()
        }
        from repro_torch.core.scheduler import CheckpointPolicy

        stores = {slot: store for store, slot, _ in self._chained_stores()}
        writer = self._writer
        self._policy = CheckpointPolicy(
            self.env,
            stores,
            clock=self._clock,
            backpressure=(lambda: writer.pending) if writer is not None
            else None,
            # the simulator/runtime communicators expose an empirical MTBF
            # from their failure log; plain NullComm does not (→ None)
            mtbf_fn=getattr(self.comm, "empirical_mtbf", None),
        )
        if self.env.cp_signal:
            self._policy.install_signal_handlers()
        from repro_torch.core.scrubber import Scrubber

        # always built: repair-on-read works even when background scrubbing
        # (CRAFT_SCRUB_EVERY) is off — the policy gates the idle slices
        self._scrubber = Scrubber(self)

    # ----------------------------------------------------- nested (subCP())
    def sub_cp(self, child: "Checkpoint") -> None:
        """Declare ``child`` a nested checkpoint of ``self`` (paper §2.5)."""
        nested.GLOBAL_REGISTRY.link(self, child)

    def disable_node_level(self) -> None:
        """Keep this checkpoint off the node tier (paper ``disableSCR()``)."""
        if self._committed:
            raise CheckpointError("disable_node_level() must precede commit()")
        self._node_enabled = False

    def invalidate(self) -> None:
        """Wipe every stored version of this checkpoint (nested-child wipe)."""
        self._delta_state.clear()
        for store, _, _ in self._chained_stores():
            store.invalidate_all()

    def _chained_stores(self):
        """[(store, chain_slot, store.label)] in CRAFT_TIER_CHAIN order.

        The chain slot ("mem"/"node"/"pfs") selects write/read *semantics*
        (best-effort RAM, every-version node, pfs_every-gated PFS) even for
        factory-injected stores; ``store.label`` is the display name feeding
        stats["restore_tier"] and restore-error reports.
        """
        by_slot = {"mem": self._mem, "node": self._node, "pfs": self._pfs}
        return [
            (by_slot[slot], slot, by_slot[slot].label)
            for slot in self.env.tier_chain
            if by_slot[slot] is not None
        ]

    # ---------------------------------------------------------------- write
    def update_and_write(
        self, iteration: Optional[int] = None, cp_freq: int = 1
    ) -> bool:
        """Write a new checkpoint version if the policy schedules one.

        ``cp_freq`` is the paper's fixed-frequency gate, applied on top of
        the policy (deprecated idiom — prefer the ``CRAFT_TIER_EVERY`` /
        Daly knobs; see the module docstring).  Returns True when a version
        was (or began being) written.
        """
        decision = self._decide(iteration, cp_freq)
        if not decision.write:
            return False
        version = self._version + 1

        if decision.sync:
            # preemption / walltime flush: drain in-flight versions, then
            # write inline so the version is durable before returning.
            if self._writer is not None:
                self._writer.wait()
            self._snapshot_and_write(version, decision)
        elif self.env.write_async_zero_copy:
            # zero-copy: snapshot *and* IO on the writer thread; the caller
            # must wait() before mutating live data (paper §2.4).
            self._writer.submit(
                lambda v=version, d=decision: self._snapshot_and_write(v, d),
                label=f"{self.name} v-{version}")
        elif self.env.write_async:
            # copy-based: snapshot inline (cheap D2H), IO on writer thread.
            # Each checkpointable holds one snapshot buffer, which the
            # previous version's job may still be writing: fence it first,
            # or that version lands torn (its early files from one
            # snapshot, its late ones from this).  The reference does not.
            self._writer.wait()
            self._update_all()
            self._writer.submit(
                lambda v=version, d=decision: self._write_version(v, d),
                label=f"{self.name} v-{version}")
        else:
            # synchronous: IO inline — the writer (if any) only serves
            # run_parallel fanout of per-array/per-chunk jobs.
            self._update_all()
            self._write_version(version, decision)
        self._version = version
        self._last_write_t = self._clock()
        metrics.set_gauge("cp_version", version, cp=self.name)
        self._policy.record_written(decision, version)
        if decision.reason == "preempt":
            self.stats.inc("preempt_flushes")
        if decision.final:
            self.stats.inc("final_writes")
        return True

    # ------------------------------------------------------------ scheduling
    @property
    def policy(self):
        """The :class:`CheckpointPolicy` deciding when/where to write
        (``None`` before commit() or when checkpointing is disabled)."""
        return self._policy

    @property
    def scrubber(self):
        """The :class:`~repro_torch.core.scrubber.Scrubber` guarding this
        checkpoint's tiers (``None`` before commit()/when disabled).  Call
        ``scrubber.scan_once()`` for a synchronous full integrity pass."""
        return self._scrubber

    @property
    def should_stop(self) -> bool:
        """The application should exit its loop: a preemption flush landed
        or the walltime guard wrote its final checkpoint."""
        return self._policy is not None and self._policy.should_stop

    def need_checkpoint(
        self, iteration: Optional[int] = None, cp_freq: int = 1
    ) -> bool:
        """Should this step checkpoint?  (paper §2 ``needCheckpoint()``.)

        Delegates to the :class:`CheckpointPolicy`; the decision is cached so
        the canonical ``if cp.need_checkpoint(it): cp.update_and_write(it)``
        pattern evaluates the policy exactly once per step.
        """
        return self._decide(iteration, cp_freq).write

    def _decide(self, iteration: Optional[int], cp_freq: int):
        from repro_torch.core.scheduler import Decision

        self._require_committed()
        if not self.env.enable or self._policy is None:
            return Decision(write=False)
        cached = self._decision_cache
        if cached is not None and cached[0] == iteration \
                and cached[1] == self._version:
            return cached[2]
        d = self._policy.need_checkpoint(
            iteration, cp_freq, next_version=self._version + 1)
        # a skip with no iteration key would never invalidate (the version
        # does not advance) — recompute those instead of pinning the cache
        if d.write or iteration is not None:
            self._decision_cache = (iteration, self._version, d)
        if not d.write and self._scrubber is not None:
            # skipped steps are the scrubber's idle windows (throttled by
            # CRAFT_SCRUB_EVERY / CRAFT_SCRUB_BYTES_PER_S via the policy)
            self._scrubber.opportunity()
        # Async stall watchdog: heartbeat gauge + one warning per job that
        # outlives CRAFT_IO_DEADLINE_S — only when some observer is armed.
        if self._writer is not None and (metrics.REGISTRY.enabled
                                         or trace.TRACER.enabled):
            self._writer.check_stall(self.env.io_deadline_s)
        return d

    def _update_all(self) -> None:
        for item in self._map.values():
            item.update()

    def _snapshot_and_write(self, version: int, decision=None) -> None:
        self._update_all()
        self._write_version(version, decision)

    def _write_version(self, version: int, decision=None) -> None:
        """Write ``version`` to the scheduled tiers, degrading around faults.

        Per tier: an open circuit breaker skips the tier outright; a write
        failure (after the storage layer's transient retries) records a
        breaker failure and, either way, the tier's payload is *routed* to
        the next chain level so the version still lands somewhere durable.
        A degraded tier's delta state is dropped — its next successful write
        (breaker re-admission) is forced full, so no delta chain ever spans
        an outage.  ``ENOSPC`` gets one emergency retention squeeze + retry
        before degrading.  Only when *no* tier lands does the last error
        propagate (the caller keeps the previous version; the in-memory
        version counter does not advance).
        """
        with trace.TRACER.timed("craft::cp.write", cp=self.name,
                                version=version) as sp:
            wrote_bytes = self._write_tiers(version, decision)
        self.stats.inc("writes")
        self.stats.inc("bytes_written", wrote_bytes)
        self.stats.inc("write_seconds", sp.seconds)

    def _write_tiers(self, version: int, decision) -> int:
        """The tier writes of :meth:`_write_version`; returns the version's
        logical bytes."""
        from repro_torch.core import health as health_mod
        from repro_torch.core.chaos import ChaosCrash
        from repro_torch.core.mem_level import MemTierError

        wrote_bytes = sum(item.nbytes() for item in self._map.values())
        # the policy picked the tier set; a missing decision (internal
        # callers) falls back to the legacy every-tier + pfs_every gating
        if decision is not None:
            slots = set(decision.tiers)
            force_full = decision.full
        else:
            to_pfs = (
                self._node is None
                or self.env.pfs_every <= 1
                or version % self.env.pfs_every == 0
            )
            slots = {s for _, s, _ in self._chained_stores()
                     if s != "pfs" or to_pfs}
            force_full = False
        # cheap half-open probes first: a tripped tier past its cooldown is
        # re-admitted (or re-opened) by a metadata touch, never by gambling
        # the full version write below.  Degraded slots keep the policy
        # always-due, so the scrubber's idle windows cannot reach a tripped
        # tier — the front of the write is its other probe ride.
        self._probe_tiers()
        landed = []
        routed = False        # a shallower tier's payload needs a new home
        last_exc: Optional[BaseException] = None
        for store, slot, _ in self._chained_stores():
            if slot not in slots and not routed:
                continue
            health = self._health.get(slot)
            if health is not None and not health.allow():
                # breaker open: skip without touching the (known-bad) tier
                self._note_degraded(slot)
                routed = True
                continue
            # a degraded slot's next write is self-contained (no delta base
            # from before the outage) — force full for routed targets too
            tier_full = force_full or routed or slot not in slots
            with trace.TRACER.timed("craft::cp.tier_write", cp=self.name,
                                    version=version, slot=slot) as ts:
                try:
                    io_stats = self._write_store_guarded(
                        store, version, slot, tier_full)
                except MemTierError:
                    # the RAM tier is best-effort write-through: a collective
                    # budget refusal skips it, the durable tiers still land
                    self.stats.inc("mem_skipped")
                    continue
                except ChaosCrash:
                    raise             # simulated process death: no cleanup
                except Exception as exc:
                    if isinstance(exc, OSError) and exc.errno == errno.ENOSPC \
                            and getattr(store, "retire_for_space",
                                        lambda: False)():
                        self.stats.inc("enospc_retires")
                        try:
                            io_stats = self._write_store_guarded(
                                store, version, slot, tier_full)
                        except ChaosCrash:
                            raise
                        except Exception as exc2:
                            exc = exc2
                        else:
                            exc = None
                    if exc is not None:
                        last_exc = exc
                        if isinstance(exc, health_mod.WriteDeadlineExceeded):
                            self.stats.inc("abandoned_writes")
                        if health is not None and health.record_failure(exc):
                            self.stats.inc("breaker_trips")
                            trace.TRACER.emit("breaker", slot=slot)
                        self._note_degraded(slot)
                        routed = True
                        continue
                seconds = ts.stop()
            # tier write landed
            if health is not None:
                health.record_success()
            if self._policy is not None:
                self._policy.note_tier_written(slot)
            landed.append(slot)
            routed = False
            self.stats.inc(f"{slot}_writes")
            # feed the scheduler's per-tier cost model (EWMA on the tier)
            store.record_write(seconds, wrote_bytes)
            trace.TRACER.emit(
                "tier_write",
                version=version,
                slot=slot,
                seconds=round(seconds, 6),
                nbytes=wrote_bytes,
                phys_bytes=(io_stats or {}).get("bytes", 0),
                chunks=(io_stats or {}).get("chunks", 0),
                ref_chunks=(io_stats or {}).get("ref_chunks", 0),
                full=bool(tier_full),
            )
        if not landed and last_exc is not None:
            # nothing landed anywhere: surface the failure unchanged so the
            # caller sees the original error type (and the version counter
            # stays on the last complete version)
            raise last_exc
        # Parent published ⇒ children are now inconsistent (paper Table 1).
        nested.GLOBAL_REGISTRY.invalidate_children(self)
        return wrote_bytes

    def _note_degraded(self, slot: str) -> None:
        """Bookkeeping for a tier write that did not land on its tier."""
        self.stats.inc("degraded_writes")
        # no delta chain crosses an outage: the tier's next successful
        # write diffs against nothing, i.e. is a forced full write
        self._delta_state.pop(slot, None)
        if self._policy is not None:
            self._policy.note_degraded(slot)

    def _write_store_guarded(self, store, version: int, slot: str,
                             force_full: bool) -> None:
        """One tier write, under the ``CRAFT_IO_DEADLINE_S`` watchdog: a
        write that exceeds the deadline is abandoned (the helper thread may
        stay hung; it can only abort its own staging dir, never publish)
        instead of wedging the sequencer or a sync commit.  Returns the
        write's codec ``io_stats`` dict."""
        deadline = self.env.io_deadline_s
        if deadline > 0:
            from repro_torch.core.health import call_with_deadline

            return call_with_deadline(
                lambda: self._write_to_store(store, version, slot, force_full),
                deadline, name=f"{self.name} {slot} v-{version}")
        return self._write_to_store(store, version, slot, force_full)

    def _delta_plan(self, slot: str, force_full: bool = False) -> Optional[dict]:
        """Delta state to diff against for this write, or None for a full
        write.  ``force_full`` (preemption flush, walltime final write,
        post-recovery write) always produces a self-contained version.
        Compaction: when the prospective chain (this version + the
        previous version + its recorded bases) would exceed
        ``CRAFT_DELTA_MAX_CHAIN`` versions, fall back to a self-contained
        write so restore/retention never walk unbounded chains."""
        if force_full or not self.env.delta or slot == "mem":
            return None
        state = self._delta_state.get(slot)
        if state is None:
            return None
        prospective = {state["version"]} | set(state["deps"])
        if 1 + len(prospective) > self.env.delta_max_chain:
            self.stats.inc("delta_compactions")
            return None
        return state

    def _write_to_store(self, store, version: int, slot: str = "pfs",
                        force_full: bool = False) -> dict:
        staged = store.stage(version)
        delta_state = self._delta_plan(slot, force_full)
        delta_on = self.env.delta and slot != "mem"
        try:
            checksums: dict = {}
            chunks_db: dict = {}
            io_stats: dict = {}
            ctx = IOContext(
                proc_rank=self.comm.rank,
                proc_count=self.comm.size,
                compress=self.env.compress,
                checksum=self.env.checksum,
                checksum_db=checksums,
                rel_root=staged,
                codec_version=self.env.codec_version,
                chunk_bytes=self.env.chunk_bytes,
                fanout=self._writer.run_parallel if self._writer else None,
                delta_prev=delta_state["files"] if delta_state else None,
                delta_base=delta_state["version"] if delta_state else 0,
                chunks_db=chunks_db if delta_on else None,
                io_stats=io_stats,
                zstd_level=self.env.zstd_level,
                zstd_gate_bits=self.env.zstd_gate_bits,
                device_meta={} if self.env.device_snapshot else None,
                device=self.device,
                chaos=getattr(store, "chaos_scope", None),
                io_retries=self.env.io_retries,
                io_retry_backoff_ms=self.env.io_backoff_ms,
            )
            overrides = store.write_ctx_overrides(staged)
            if overrides:
                ctx = dataclasses.replace(ctx, **overrides)
            # Independent checkpointables flush in parallel across the IO
            # pool; publish() below is the barrier that preserves per-version
            # ordering (a version is only promoted once every file landed).
            jobs = []
            for key, item in self._map.items():
                sub = staged / key
                storage.make_dir(sub, ctx)
                jobs.append(
                    lambda item=item, sub=sub, key=key:
                    self._run_item_write(item, sub, ctx, slot, version, key))
            storage.run_jobs(jobs, ctx)
            deps: set = set()
            if delta_on:
                # Any ref chunk chains this version on the previous one (and,
                # transitively, on its bases); record the dependency set in
                # the version dir so retention pins bases and restore can
                # check chain completeness without opening array headers.
                if delta_state is not None and any(
                    m.get("refs", 0) for m in chunks_db.values()
                ):
                    deps = {delta_state["version"]} | set(delta_state["deps"])
                storage.write_json(
                    staged / tiers.delta_deps_name(self.comm.rank),
                    {"version": version, "deps": sorted(deps)},
                    ctx=ctx,
                )
            store.publish(
                staged,
                version,
                extra_meta={
                    "keys": sorted(self._map),
                    "codec": self.env.codec_version,
                    # rank 0's view of the per-file digest manifest; restore
                    # checks these files exist before reading the version
                    "checksums": checksums,
                    **({"delta_deps": sorted(deps)} if delta_on else {}),
                },
            )
        except BaseException as exc:
            from repro_torch.core.chaos import ChaosCrash
            from repro_torch.core.comm import KilledError

            # a simulated process death (a chaos crash, a killed simulated
            # rank) leaves its staging dir behind — the crash-consistency
            # protocol (tmp sweep on next start) owns the cleanup, exactly
            # as after a real crash; a dead rank must not delete the
            # staging its replacement and the survivors write into
            if not isinstance(exc, (ChaosCrash, KilledError)):
                store.abort(staged)
            self.stats.inc("retries", io_stats.get("retries", 0))
            raise
        if delta_on:
            self._delta_state[slot] = {
                "version": version, "deps": deps, "files": chunks_db,
            }
        self.stats.inc("tier_bytes_written", io_stats.get("bytes", 0))
        self.stats.inc("delta_chunks_total", io_stats.get("chunks", 0))
        self.stats.inc("delta_chunks_skipped", io_stats.get("ref_chunks", 0))
        self.stats.inc("retries", io_stats.get("retries", 0))
        # per-tier codec series (the delta hit rate is ref_chunks / chunks)
        metrics.inc("tier_phys_bytes", io_stats.get("bytes", 0), slot=slot)
        metrics.inc("tier_chunks", io_stats.get("chunks", 0), slot=slot)
        metrics.inc("tier_ref_chunks", io_stats.get("ref_chunks", 0),
                    slot=slot)
        return io_stats

    def _run_item_write(self, item, sub: Path, ctx: IOContext,
                        slot: str, version: int, key: str) -> None:
        """One checkpointable's write with failure context attached: the
        tier, version and array id ride along on the re-raised error (an
        async failure otherwise surfaces at a later fence with no hint
        where it happened).  OSError keeps its type and errno — callers
        dispatch on them (transient retry, ENOSPC handling)."""
        try:
            item.write(sub, ctx)
        except OSError as exc:
            if ctx.files is not None and exc.filename is not None:
                # storage's file table touches no file: the item did
                raise CheckpointError(
                    f"{slot} tier v-{version} array {key!r}: "
                    f"{type(item).__name__} opened {exc.filename} itself; "
                    "a checkpointable does its I/O through storage with the "
                    "ctx it is handed") from exc
            msg = (f"{slot} tier v-{version} array {key!r}: "
                   f"{exc.strerror or exc}")
            wrapped = type(exc)(exc.errno, msg) if exc.errno is not None \
                else type(exc)(msg)
            raise wrapped from exc
        except CheckpointError as exc:
            raise type(exc)(
                f"{slot} tier v-{version} array {key!r}: {exc}") from exc

    # ----------------------------------------------------------------- read
    def restart_if_needed(self, iteration_box=None) -> bool:
        """Restore the latest consistent version, if any (paper Listing 2).

        Nested semantics (paper §2.5): a non-zero in-memory CP-version means
        this is a successive (inner-loop) call of an already-running program —
        return immediately without reading.

        ``iteration_box`` is accepted for signature parity with the paper's
        ``restartIfNeeded(&iteration)``; the iteration should normally simply
        be one of the added checkpointables.
        """
        with trace.TRACER.span("craft::cp.restart", cp=self.name) as sp:
            restored = self._restart()
            sp.set(restored=restored)
        return restored

    def _restart(self) -> bool:
        self._require_committed()
        if not self.env.enable or not self.env.read_cp_on_restart:
            return False
        if self._version != 0:
            return False  # successive nested-loop call — not a restart
        version = self._agree_version()
        if version <= 0:
            return False
        t0 = time.perf_counter()
        self._read_version(version)
        self._version = version
        self.stats.inc("reads")
        self.stats.inc("read_seconds", time.perf_counter() - t0)
        if self._policy is not None:
            # restart the per-tier interval clocks so the resumed run does
            # not immediately re-write the version it just read
            self._policy.notify_restore()
        return True

    def _agree_version(self) -> int:
        """All processes must restore the same version: min over the best
        *chain-complete* version of each tier, so every rank falls back
        together when a delta version's base chain is gone somewhere."""
        local = 0
        for store, _, _ in self._chained_stores():
            local = max(local, self._restorable_version(store))
        return self.comm.allreduce_min(local)

    def _restorable_version(self, store) -> int:
        """Newest version of ``store`` whose full delta-base chain is present.

        Versions whose directory is not locally visible (e.g. a node-tier
        version recoverable from a partner/parity peer) are trusted here and
        re-validated after materialization in ``_read_version``.
        """
        latest = store.latest_version()
        if latest <= 0:
            return 0
        meta = store.meta() if hasattr(store, "meta") else {}
        candidates = sorted(
            {int(v) for v in meta.get("versions", [])} | {latest},
            reverse=True,
        )
        for version in candidates:
            if version > latest:
                continue
            vdir = Path(store.version_dir(version))
            if not vdir.is_dir():
                if version == latest:
                    return version  # the store claims it (peer-recoverable,
                    #                 e.g. node mirror/XOR) — validated at read
                continue            # stale metadata entry — skip
            deps = tiers.read_delta_deps(vdir)
            if all(Path(store.version_dir(b)).is_dir() for b in deps):
                return version
        return 0

    def _read_version(self, version: int) -> None:
        base_ctx = IOContext(
            proc_rank=self.comm.rank,
            proc_count=self.comm.size,
            compress=self.env.compress,
            checksum=self.env.checksum,
            codec_version=self.env.codec_version,
            chunk_bytes=self.env.chunk_bytes,
            fanout=self._writer.run_parallel if self._writer else None,
            reshard=self.env.reshard,
            device=self.device,
        )
        errors = []
        for store, slot, label in self._chained_stores():
            for attempt in (0, 1):
                err = self._read_from_store(
                    store, slot, label, version, base_ctx)
                if err is None:
                    return
                # Repair-on-read: a failed verification hands the tier to
                # the scrubber (redundancy rebuild / peer-tier re-encode /
                # quarantine) and the read retries once — a restore never
                # falls through while a same-tier repair is possible.
                if attempt == 0 and self._scrubber is not None \
                        and self._scrubber.repair_version(store, slot, version):
                    self.stats.inc("read_repairs")
                    continue
                errors.append(err)
                break
        raise CheckpointError(
            f"could not restore {self.name!r} v-{version}: " + "; ".join(errors)
        )

    def _read_from_store(self, store, slot, label, version, base_ctx):
        """One tier's restore attempt; returns None on success, else the
        error string to report (the caller may repair and retry once)."""
        with trace.TRACER.timed("craft::cp.restore", cp=self.name,
                                version=version, slot=slot) as sp:
            return self._read_tier(store, slot, label, version, base_ctx, sp)

    def _read_tier(self, store, slot, label, version, base_ctx, sp):
        """:meth:`_read_from_store` inside its span ``sp``, whose end is the
        restore's one clock read."""
        try:
            # may trigger replica / partner / XOR / RS recovery; an
            # unrecoverable tier falls through to the next one (the
            # base-class materialize is a plain local-dir check)
            vdir = store.materialize(version)
        except CheckpointError as exc:
            return f"{label}: {exc}"
        if vdir is None:
            return f"{label}: version v-{version} not present"
        # Delta chain: every base version the v2 refs resolve through
        # must be materialized on this same tier before reading; a hole
        # in the chain fails this tier explicitly (no decode crash).
        try:
            base_dirs = self._materialize_chain(store, Path(vdir), version)
        except CheckpointError as exc:
            return f"{label}: v-{version} {exc}"
        overrides = dict(store.read_ctx_overrides(version))
        overrides.setdefault("rel_root", Path(vdir))
        overrides.setdefault("chaos", getattr(store, "chaos_scope", None))
        overrides.setdefault("io_retries", self.env.io_retries)
        overrides.setdefault("io_retry_backoff_ms", self.env.io_backoff_ms)
        if base_dirs:
            overrides.setdefault("base_dirs", base_dirs)
        # Elastic N→M: peer version roots this tier can reach (node tier on a
        # shared FS) complement the materialized dir's shard files.
        aux = store.aux_read_dirs(version) \
            if hasattr(store, "aux_read_dirs") else []
        if aux:
            overrides.setdefault(
                "aux_dirs", tuple(Path(a) for a in aux))
        overrides["io_stats"] = {}
        ctx = dataclasses.replace(base_ctx, **overrides)
        missing = self._manifest_missing(store, Path(vdir), version, ctx)
        if missing:
            return f"{label}: v-{version} incomplete, missing {missing[:3]}"
        try:
            # independent items restore in parallel (chunk digest checks
            # and decompression fan out across the same pool underneath)
            storage.run_jobs(
                [
                    lambda key=key, item=item: item.read(Path(vdir) / key, ctx)
                    for key, item in self._map.items()
                ],
                ctx,
            )
        except (CheckpointError, OSError) as exc:
            self.stats.inc("retries", (ctx.io_stats or {}).get("retries", 0))
            return f"{label}: {exc}"
        self.stats.inc("retries", (ctx.io_stats or {}).get("retries", 0))
        self.stats["restore_tier"] = label
        self.stats["tier_reads"][label] = \
            self.stats["tier_reads"].get(label, 0) + 1
        self.stats["restore_read_bytes"] = \
            (ctx.io_stats or {}).get("read_bytes", 0)
        if sp.armed:
            sp.set(bytes=self.nbytes(),
                   leaves=(ctx.io_stats or {}).get("leaves", 0))
        seconds = sp.stop()
        metrics.inc("restores", slot=slot)
        metrics.observe("restore_seconds", seconds, slot=slot)
        metrics.inc("restore_read_bytes",
                    self.stats["restore_read_bytes"], slot=slot)
        trace.TRACER.emit(
            "restore",
            version=version,
            tier=label,
            slot=slot,
            seconds=round(seconds, 6),
            read_bytes=self.stats["restore_read_bytes"],
        )
        if slot == "mem" and self.env.elastic_hydrate \
                and hasattr(store, "rehydrate"):
            # Replacement-rank hydration: a rank that restored from peer
            # replicas re-seeds its own fabric slots so the redundancy
            # group is whole again — all without touching disk.
            self.stats.inc("mem_rehydrations", store.rehydrate(version))
        self._prime_delta_state(version, restored_slot=slot)
        return None

    def _materialize_chain(self, store, vdir: Path, version: int) -> dict:
        """Materialize every delta-base version ``vdir`` depends on; returns
        {base_version: Path}.  Raises :class:`CheckpointError` naming the
        first base that is absent from this tier."""
        deps = tiers.read_delta_deps(vdir)
        base_dirs = {}
        for base in sorted(deps, reverse=True):
            try:
                bdir = store.materialize(base)
            except CheckpointError as exc:
                raise CheckpointError(
                    f"delta base v-{base} unrecoverable: {exc}"
                ) from exc
            if bdir is None or not Path(bdir).is_dir():
                raise CheckpointError(
                    f"delta base v-{base} is missing (chain broken — the "
                    "version cannot be reassembled on this tier)"
                )
            base_dirs[base] = Path(bdir)
        return base_dirs

    def _prime_delta_state(self, version: int, restored_slot: str) -> None:
        """Seed per-tier delta state after a restore so the *first* write of
        the resumed run can already skip clean chunks.

        The chunk digests come from the memory tier's decoded shards when the
        restore was served from RAM (no disk read at all); otherwise from a
        header-only scan of each disk tier's version directory.  Only tiers
        that locally hold ``version`` are primed — a tier without it simply
        does a full write next time.
        """
        if not self.env.delta:
            return
        mem_files = None
        if restored_slot == "mem" and self._mem is not None:
            mem_files = self._mem.chunk_digests(version, self.env.chunk_bytes)
        for store, slot, _ in self._chained_stores():
            if slot == "mem":
                continue
            vdir = Path(store.version_dir(version))
            if not vdir.is_dir():
                continue
            files = mem_files if mem_files is not None \
                else self._delta_files_from_dir(vdir)
            if not files:
                continue
            self._delta_state[slot] = {
                "version": version,
                "deps": tiers.read_delta_deps(vdir),
                "files": files,
            }

    def _delta_files_from_dir(self, vdir: Path) -> dict:
        """Header-only chunk-manifest scan of a version directory (disk-tier
        delta priming).  Files whose raw digests are unknowable (v0 blobs,
        compressed v1 chunks digest post-compression bytes) are skipped and
        will simply be full-written next version."""
        files = {}
        for p in sorted(q for q in vdir.rglob("*") if q.is_file()):
            mf = storage.read_chunk_manifest(p)
            if mf is None or mf["chunk_bytes"] != self.env.chunk_bytes:
                continue
            if mf["fmt"] == storage.CODEC_V1 and mf["compress"] == "zstd":
                continue    # v1+zstd digests the compressed bytes — no rdigest
            if mf["checksum"] == "none":
                continue    # written without digests — nothing to diff
            chunks = mf["chunks"]
            rdigests = [list(c.get("rdigest", c.get("digest", [0, 0])))
                        for c in chunks]
            files[str(p.relative_to(vdir))] = {
                "rdigests": rdigests,
                "ulens": [int(c["ulen"]) for c in chunks],
                "nbytes": mf["nbytes"],
                "chunk_bytes": mf["chunk_bytes"],
            }
        return files

    @staticmethod
    def _manifest_missing(store, vdir: Path, version: int,
                          ctx: IOContext) -> list:
        """Manifest files absent from ``vdir`` (the metadata's file-set check).

        The stored checksum manifest describes the *latest* published version
        only, so older versions (and stores without metadata) skip the check;
        per-file payload integrity is still verified by the in-file digests.
        """
        meta = store.meta() if hasattr(store, "meta") else {}
        if meta.get("latest") != version:
            return []
        return [
            rel for rel in meta.get("checksums", {})
            if not storage.exists(vdir / rel, ctx)
        ]

    # ------------------------------------------------------- health probing
    def _probe_tiers(self) -> None:
        """Half-open probes for tripped tiers, ridden on the scrubber's idle
        windows: a cheap touch/fsync/unlink in the tier root (the chaos gate
        sees it as a write, so a still-faulty tier fails the probe) decides
        re-admission without risking a real version write."""
        for store, slot, _ in self._chained_stores():
            health = self._health.get(slot)
            if health is None or not health.probe_due():
                continue
            if not health.allow():       # another probe is already in flight
                continue
            try:
                self._probe_store(store, slot)
            except Exception as exc:
                if health.record_failure(exc):
                    self.stats.inc("breaker_trips")
                    trace.TRACER.emit("breaker", slot=slot)
            else:
                health.record_success()

    def _probe_store(self, store, slot: str) -> None:
        scope = getattr(store, "chaos_scope", None)
        if scope is not None:
            scope.check("write", path="<health-probe>")
        if slot == "mem":
            return                       # RAM fabric: the gate is the probe
        root = Path(store.version_dir(0)).parent
        root.mkdir(parents=True, exist_ok=True)
        probe = root / f".probe-{self.comm.rank}"
        try:
            with open(probe, "wb") as fh:
                fh.write(b"craft-probe")
                fh.flush()
                os.fsync(fh.fileno())
        finally:
            probe.unlink(missing_ok=True)

    @property
    def chaos(self):
        """The live :class:`~repro_torch.core.chaos.ChaosEngine` (``None`` unless
        ``CRAFT_CHAOS`` armed one at commit) — tests and soak harnesses add
        or clear fault rules on it mid-run."""
        return self._chaos

    @property
    def health(self) -> Dict[str, object]:
        """Per-slot :class:`~repro_torch.core.health.TierHealth` (breaker state)."""
        return self._health

    # ----------------------------------------------------------------- misc
    @property
    def version(self) -> int:
        return self._version

    @property
    def committed(self) -> bool:
        return self._committed

    def keys(self):
        return sorted(self._map)

    def nbytes(self) -> int:
        return sum(item.nbytes() for item in self._map.values())

    def wait(self) -> None:
        """Fence for asynchronous writes (paper ``Checkpoint::wait()``)."""
        if self._writer is not None:
            self._writer.wait()

    def close(self) -> None:
        if self._closed:
            return
        if self._policy is not None:
            self._policy.uninstall_signal_handlers()
        if self._chaos is not None:
            # unblock injected hangs so abandoned writer threads can die
            # (they fail their op and abort their staging; never publish)
            self._chaos.release()
        if self._writer is not None:
            self._writer.close()
        self._closed = True

    def __enter__(self) -> "Checkpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def _require_committed(self) -> None:
        if not self._committed:
            raise CheckpointError(
                f"Checkpoint {self.name!r} not committed — call commit() first"
            )
