"""Adaptive multi-level checkpoint scheduling (paper §2 ``needCheckpoint`` /
``updateAndWrite``, §4 overhead analysis).

The paper exposes *when* to checkpoint as the dominant cost knob but leaves
the decision to a fixed ``iteration % frequency`` modulo.  With three tiers
of wildly different write cost (mem ≪ node ≪ pfs) and a delta codec whose
cost varies with the dirty fraction, a fixed frequency is always wrong for
at least one tier.  :class:`CheckpointPolicy` replaces the modulo with a
per-tier decision, each step, of *whether* to checkpoint and *to which
tiers*:

* **cost model** — every landed write feeds an EWMA on its
  :class:`~repro_torch.core.tiers.StorageTier` (seeded by the first full write;
  the RAM tier carries a cheap prior), so the schedule tracks the delta
  codec's actual cost, not the nominal payload size;
* **Young/Daly intervals** — ``CRAFT_TIER_EVERY=auto`` derives each tier's
  interval from its write cost δ and the MTBF M
  (:func:`daly_interval`); M comes from ``CRAFT_MTBF_SECONDS``, else from
  the communicator's empirical failure rate
  (``CollectiveEngine.empirical_mtbf``), else a 1-day default;
* **per-tier cadences** — ``CRAFT_TIER_EVERY=mem:1,node:8,pfs:64`` counts
  checkpoint opportunities per tier (the generalization of
  ``CRAFT_PFS_EVERY`` to the whole chain);
* **backpressure** — when the async writer queue is saturated the policy
  stretches intervals instead of stacking versions behind a slow tier;
* **preemption** — ``CRAFT_CP_SIGNAL=SIGTERM`` installs a handler that
  forces a synchronous, full (non-delta) flush of the deepest tier at the
  next step (batch-scheduler preemption notice);
* **walltime guard** — ``CRAFT_WALLTIME_SECONDS`` (+ margin + estimated
  write cost) schedules one final full checkpoint before the job dies;
* **recovery reset** — an AFT recovery bumps a process-wide epoch
  (:func:`notify_recovery`); every live policy then resets its estimators
  and forces its next write to be full (survivor tiers may have holes).

Tuning guide with worked examples: ``docs/tuning.md``.
"""
from __future__ import annotations

import dataclasses
import math
import signal as _signal
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import metrics, trace
from repro_torch.core.env import CraftEnv

#: Fallback MTBF when neither ``CRAFT_MTBF_SECONDS`` nor an empirical rate
#: is available (one day — conservative for a single-node run).
DEFAULT_MTBF_SECONDS = 86400.0

#: Job-start reference for the walltime guard.  Captured at import (the
#: ``repro_torch.core`` package imports this module, so effectively at program
#: start) — a batch scheduler's walltime clock starts at launch, not at
#: ``Checkpoint.commit()``, and setup time before commit() must count
#: against ``CRAFT_WALLTIME_SECONDS``.
_JOB_T0 = time.monotonic()

# ---------------------------------------------------------------------------
# process-wide recovery epoch
# ---------------------------------------------------------------------------
_EPOCH_LOCK = threading.Lock()
_RECOVERY_EPOCH = 0


def notify_recovery(stats: Optional[dict] = None) -> int:
    """Record that an AFT recovery happened (called by ``aft``); every
    live :class:`CheckpointPolicy` notices at its next decision, resets its
    cost estimators, and forces a full (non-delta) write."""
    global _RECOVERY_EPOCH
    trace.TRACER.emit("recovery")
    with _EPOCH_LOCK:
        _RECOVERY_EPOCH += 1
        return _RECOVERY_EPOCH


def recovery_epoch() -> int:
    with _EPOCH_LOCK:
        return _RECOVERY_EPOCH


# ---------------------------------------------------------------------------
# the Young/Daly optimum
# ---------------------------------------------------------------------------
def daly_interval(write_cost: float, mtbf: float) -> float:
    """Daly's higher-order optimum checkpoint interval (seconds of compute
    between checkpoints) for write cost ``write_cost`` (δ) and ``mtbf`` (M).

    For δ < 2M:  T = √(2δM)·[1 + ⅓·√(δ/2M) + (δ/2M)/9] − δ  (Daly 2006,
    reducing to Young's √(2δM) first-order form for δ ≪ M); for δ ≥ 2M the
    optimum saturates at T = M.  Monotonically increasing in δ over the
    useful range: a costlier tier checkpoints less often.
    """
    if write_cost <= 0.0:
        return 0.0
    if mtbf <= 0.0 or math.isinf(mtbf):
        return math.inf
    if write_cost >= 2.0 * mtbf:
        # saturation; the write-cost floor keeps this branch continuous and
        # monotone with the formula below (which floors the same way)
        return max(mtbf, write_cost)
    ratio = write_cost / (2.0 * mtbf)
    t = math.sqrt(2.0 * write_cost * mtbf) * (
        1.0 + math.sqrt(ratio) / 3.0 + ratio / 9.0
    ) - write_cost
    # never checkpoint more often than one write takes to land
    return max(t, write_cost)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One step's scheduling verdict, consumed by ``Checkpoint``."""

    write: bool                      # write a new version at all?
    tiers: Tuple[str, ...] = ()      # chain slots this version lands on
    full: bool = False               # bypass the delta codec (self-contained)
    sync: bool = False               # inline write + drained async lane
    final: bool = False              # the walltime guard's last checkpoint
    reason: str = ""                 # "cadence" | "preempt" | "walltime" | …


_SKIP = Decision(write=False)


class CheckpointPolicy:
    """Per-checkpoint scheduler: decides, each step, whether to write and to
    which tiers (the paper's ``needCheckpoint()`` made cost-aware).

    ``stores`` maps chain slots (``"mem"``/``"node"``/``"pfs"``, in
    ``CRAFT_TIER_EVERY`` order) to the live :class:`StorageTier` objects —
    the policy reads each tier's write-cost EWMA from the tier itself.
    ``clock`` is injectable for deterministic tests and simulated sweeps;
    ``backpressure`` returns the async writer's queue depth;
    ``mtbf_fn`` returns the communicator's empirical MTBF (or ``None``).
    """

    def __init__(
        self,
        env: CraftEnv,
        stores: Dict[str, object],
        *,
        clock: Callable[[], float] = time.monotonic,
        backpressure: Optional[Callable[[], int]] = None,
        mtbf_fn: Optional[Callable[[], Optional[float]]] = None,
    ):
        self.env = env
        self._stores = dict(stores)
        self._chain: Tuple[str, ...] = tuple(stores)
        self._clock = clock
        self._backpressure = backpressure or (lambda: 0)
        self._mtbf_fn = mtbf_fn
        now = clock()
        # walltime elapses from job start (module import) on the real clock;
        # an injected clock (tests, simulations) starts at policy creation
        self._t_start = _JOB_T0 if clock is time.monotonic else now
        self._last_write_t = {slot: now for slot in self._chain}
        self._ticks = 0                       # checkpoint opportunities seen
        self._deferred: set = set()           # count-cadence hits delayed by
        #                                       backpressure, owed at the next
        #                                       un-saturated opportunity
        self._degraded: set = set()           # slots whose scheduled write was
        #                                       degraded away (breaker open /
        #                                       tier fault): owed every
        #                                       opportunity until a write
        #                                       actually lands there
        self._last_iteration: Optional[int] = None
        self._last_opportunity: Optional[int] = None
        self._last_tick_t: Optional[float] = None
        self._step_ewma: Optional[float] = None
        self._step_direct = False     # a driver feeds measured step times
        self._preempt = threading.Event()
        self._preempt_flushed = False
        self._final_written = False
        self._force_full = False
        self._seen_epoch = recovery_epoch()
        self._installed: list = []            # [(signum, previous handler)]
        self._cadence = self._resolve_cadence()
        # integrity scrubbing rides idle checkpoint opportunities: the first
        # slice is only due a full CRAFT_SCRUB_EVERY after policy creation,
        # so startup (restore, first writes) is never competing with scrub IO
        self._last_scrub_t = now
        # online re-tuning (CRAFT_TUNE_ONLINE): first solve is only due a
        # full CRAFT_TUNE_EVERY_S after policy creation, once live EWMAs
        # and a step estimate exist
        self._last_retune_t = now
        self._trace_inputs: Tuple = (None, 1, 1, 0)
        self.stats = {
            "decisions": 0, "writes": 0, "skips": 0,
            "preempt_flushes": 0, "final_writes": 0,
            "backpressure_stretches": 0, "recovery_resets": 0,
            "scrub_slices": 0, "online_retunes": 0,
        }

    # ------------------------------------------------------------- cadences
    def _resolve_cadence(self) -> Dict[str, object]:
        """Per-slot cadence: an int opportunity count or "auto" (Daly).

        Without ``CRAFT_TIER_EVERY`` the legacy semantics are preserved
        exactly: every chained tier writes every version, except the PFS
        tier which honors ``CRAFT_PFS_EVERY`` when a node tier shields it.
        """
        cadence: Dict[str, object] = {}
        for slot in self._chain:
            spec = self.env.tier_every_for(slot)
            if spec is None:
                if slot == "pfs" and "node" in self._chain \
                        and self.env.pfs_every > 1:
                    spec = self.env.pfs_every
                else:
                    spec = 1
            cadence[slot] = spec
        return cadence

    @property
    def chain(self) -> Tuple[str, ...]:
        return self._chain

    def cadence(self, slot: str):
        return self._cadence.get(slot)

    # ---------------------------------------------------------------- costs
    def tier_cost(self, slot: str) -> Optional[float]:
        store = self._stores.get(slot)
        if store is None:
            return None
        return store.write_cost()

    def mtbf(self) -> float:
        """MTBF feeding Daly: configured > empirical > 1-day default."""
        if self.env.mtbf_seconds > 0:
            return self.env.mtbf_seconds
        if self._mtbf_fn is not None:
            try:
                emp = self._mtbf_fn()
            except Exception:
                emp = None
            if emp is not None and emp > 0:
                return float(emp)
        return DEFAULT_MTBF_SECONDS

    def interval_seconds(self, slot: str) -> float:
        """This tier's Daly interval given its current cost estimate; 0.0
        while the cost is unknown (schedule the seeding write immediately)."""
        cost = self.tier_cost(slot)
        if cost is None:
            return 0.0
        return daly_interval(cost, self.mtbf())

    def step_seconds(self) -> Optional[float]:
        """EWMA of the application's step duration (observed from the gaps
        between decisions, or fed directly via :meth:`observe_step_seconds`)."""
        return self._step_ewma

    def observe_step_seconds(self, seconds: float) -> None:
        """Direct step-duration measurement (e.g. the train loop's timer) —
        overrides the decision-gap inference."""
        if seconds <= 0:
            return
        trace.TRACER.emit("step", seconds=seconds)
        self._step_direct = True
        prev = self._step_ewma
        self._step_ewma = seconds if prev is None else (
            0.8 * prev + 0.2 * seconds)

    # ------------------------------------------------------------- triggers
    def trigger_preemption(self) -> None:
        """Arm the preemption flush (what the signal handler does; tests and
        schedulers without signals call this directly)."""
        self._preempt.set()

    @property
    def preempted(self) -> bool:
        return self._preempt.is_set()

    @property
    def should_stop(self) -> bool:
        """The application should exit its loop: the preemption flush landed
        or the walltime guard wrote its final checkpoint."""
        return self._preempt_flushed or self._final_written

    def install_signal_handlers(self) -> None:
        """Install ``CRAFT_CP_SIGNAL`` handlers (main thread only — a no-op
        elsewhere, matching CPython's signal constraints)."""
        for name in self.env.cp_signal:
            signum = getattr(_signal, name)
            try:
                old = _signal.signal(signum, self._on_signal)
            except ValueError:       # not the main thread
                return
            self._installed.append((signum, old))

    def uninstall_signal_handlers(self) -> None:
        installed, self._installed = self._installed, []
        for signum, old in installed:
            try:
                _signal.signal(signum, old)
            except (ValueError, TypeError):
                pass

    def _on_signal(self, signum, frame) -> None:   # signal-safe: sets a flag
        self._preempt.set()

    # ------------------------------------------------------------ scrubbing
    def scrub_due(self) -> bool:
        """Should an integrity-scrub slice run now?  True only in an idle
        window: ``CRAFT_SCRUB_EVERY`` elapsed since the last slice, no
        preemption pending, and the async writer queue drained (scrub IO
        must never stretch a checkpoint landing)."""
        if self.env.scrub_every <= 0:
            return False
        if self._preempt.is_set() or self._final_written:
            return False
        if self._backpressure() > 0:
            return False
        return self._clock() - self._last_scrub_t >= self.env.scrub_every

    def note_scrub(self) -> None:
        """A scrub slice was scheduled — restart the scrub interval clock."""
        self._last_scrub_t = self._clock()
        self.stats["scrub_slices"] += 1

    # ------------------------------------------------------------- recovery
    def _maybe_reset_on_recovery(self) -> None:
        epoch = recovery_epoch()
        if epoch == self._seen_epoch:
            return
        self._seen_epoch = epoch
        self.reset_estimators()

    def reset_estimators(self) -> None:
        """Post-recovery reset: drop every tier's learned cost and force the
        next write full (survivor tiers may have holes).  Public so the
        trace replayer (:mod:`repro_torch.core.simulate`) can apply a recorded
        recovery without touching the process-wide epoch."""
        for store in self._stores.values():
            store.reset_cost()
        self._force_full = True
        self.stats["recovery_resets"] += 1

    def notify_restore(self) -> None:
        """A restore just completed: restart every tier's interval clock so
        the resumed run doesn't immediately re-write what it just read."""
        now = self._clock()
        for slot in self._chain:
            self._last_write_t[slot] = now

    # ------------------------------------------------------------- decision
    def need_checkpoint(
        self,
        iteration: Optional[int] = None,
        cp_freq: int = 1,
        *,
        next_version: int = 1,
    ) -> Decision:
        """The scheduling decision for this step (paper ``needCheckpoint()``).

        Idempotent within a step: the opportunity counter advances once per
        distinct ``iteration``, so probing the decision and then writing
        (the paper's ``needCheckpoint()`` → ``updateAndWrite()`` pattern)
        never double-counts (``Checkpoint`` additionally caches it).
        """
        now = self._clock()
        self._observe_tick(now, iteration)
        self._maybe_reset_on_recovery()
        self._maybe_retune(now)
        self.stats["decisions"] += 1
        # one backpressure reading per decision (also what the trace
        # records, so a replayed policy sees the identical input)
        pending = max(0, int(self._backpressure()))
        self._trace_inputs = (iteration, cp_freq, next_version, pending)

        # external triggers trump every cadence gate
        if self._preempt.is_set() and not self._preempt_flushed:
            return self._emit(Decision(
                write=True, tiers=(self._deepest(),), full=True, sync=True,
                reason="preempt",
            ))
        if self._walltime_due(now):
            return self._emit(Decision(
                write=True, tiers=self._chain, full=True, sync=True,
                final=True, reason="walltime",
            ))

        # the paper's frequency gate still applies when the caller uses it
        if iteration is not None and cp_freq > 1 and iteration % cp_freq != 0:
            return self._emit(_SKIP)
        if not self._chain:
            return self._emit(_SKIP)

        stretch = 1.0 + pending
        adaptive = bool(self.env.tier_every)
        if adaptive and pending > 0:
            self.stats["backpressure_stretches"] += 1

        # one opportunity per distinct iteration past the cp_freq gate
        if iteration is None or iteration != self._last_opportunity:
            self._ticks += 1
            self._last_opportunity = iteration
        ticks = self._ticks
        due = []
        for slot in self._chain:
            if slot in self._degraded:
                # its last scheduled write never landed (routed to a deeper
                # tier) — keep scheduling it until one does
                due.append(slot)
                continue
            spec = self._cadence[slot]
            if spec == "auto":
                interval = self.interval_seconds(slot) * stretch
                if now - self._last_write_t[slot] >= interval:
                    due.append(slot)
            elif adaptive:
                # opportunity-count cadence; a saturated writer queue defers
                # the hit — it is owed (not skipped) at the next opportunity
                # where the queue has drained
                hit = ticks % int(spec) == 0
                if pending > 0:
                    if hit:
                        self._deferred.add(slot)
                elif hit or slot in self._deferred:
                    due.append(slot)
            else:
                # legacy, version-number based (bit-compatible with the old
                # `pfs_every` modulo)
                if int(spec) <= 1 or next_version % int(spec) == 0:
                    due.append(slot)
        if not due:
            return self._emit(_SKIP)
        full = self._force_full
        return self._emit(Decision(
            write=True, tiers=tuple(due), full=full,
            reason="recovery-full" if full else "cadence",
        ))

    def record_written(self, decision: Decision, version: int) -> None:
        """Advance cadence state after ``Checkpoint`` scheduled the write."""
        if not decision.write:
            return
        trace.TRACER.emit("scheduled", version=version,
                          tiers=list(decision.tiers), reason=decision.reason)
        now = self._clock()
        for slot in decision.tiers:
            if slot in self._degraded:
                # the write was routed away from this tier — landing on a
                # deeper tier must not satisfy this tier's cadence
                continue
            self._last_write_t[slot] = now
            self._deferred.discard(slot)
        if decision.reason == "preempt":
            self._preempt_flushed = True
            self.stats["preempt_flushes"] += 1
        if decision.final:
            self._final_written = True
            self.stats["final_writes"] += 1
        self._force_full = False
        self.stats["writes"] += 1

    # ------------------------------------------- degraded-mode notifications
    def note_degraded(self, slot: str) -> None:
        """``Checkpoint`` degraded a scheduled write away from ``slot``
        (circuit breaker open, or the tier write failed).  The slot becomes
        overdue — and stays owed at every opportunity — until a write lands
        on it again (:meth:`note_tier_written`)."""
        if slot not in self._chain:
            return
        trace.TRACER.emit("degraded", slot=slot)
        self._degraded.add(slot)
        self._last_write_t[slot] = -math.inf
        metrics.set_gauge("policy_degraded_slots", len(self._degraded))

    def note_tier_written(self, slot: str) -> None:
        """A write actually landed on ``slot`` (called by ``Checkpoint`` on
        tier-write success — the authoritative cadence reset, unlike
        :meth:`record_written` which only sees the *scheduled* tier set)."""
        self._degraded.discard(slot)
        self._deferred.discard(slot)
        metrics.set_gauge("policy_degraded_slots", len(self._degraded))
        if slot in self._last_write_t:
            self._last_write_t[slot] = self._clock()

    def degraded_slots(self) -> Tuple[str, ...]:
        return tuple(s for s in self._chain if s in self._degraded)

    # -------------------------------------------------- online re-tuning
    def _maybe_retune(self, now: float) -> None:
        """``CRAFT_TUNE_ONLINE``: periodically re-solve the count cadences
        from live write-cost EWMAs and the empirical MTBF — the offline
        ``craft tune`` solve, folded into the running policy.

        Only count cadences under ``CRAFT_TIER_EVERY`` are touched ("auto"
        slots already re-derive their Daly interval every decision; the
        legacy version-modulo mode keeps its bit-compatible behavior), and
        only once a step-duration estimate exists to convert seconds into
        checkpoint opportunities.
        """
        if not (self.env.tune_online and self.env.tier_every):
            return
        if now - self._last_retune_t < self.env.tune_every_s:
            return
        self._last_retune_t = now
        step = self._step_ewma
        if not step or step <= 0:
            return
        mtbf = self.mtbf()
        changed = {}
        for slot in self._chain:
            spec = self._cadence.get(slot)
            if not isinstance(spec, int):
                continue
            cost = self.tier_cost(slot)
            if cost is None or cost <= 0:
                continue
            interval = daly_interval(cost, mtbf)
            if not math.isfinite(interval):
                continue
            count = max(1, int(round(interval / step)))
            if count != spec:
                self._cadence[slot] = count
                changed[slot] = count
        if changed:
            self.stats["online_retunes"] += 1
            metrics.inc("policy_retunes")

    # ------------------------------------------------------------ internals
    def _emit(self, d: Decision) -> Decision:
        if not d.write:
            self.stats["skips"] += 1
        if metrics.REGISTRY.enabled:   # skip the kwargs build on the no-op
            metrics.inc("policy_decisions", reason=d.reason or "skip",
                        write="true" if d.write else "false")
        tr = trace.TRACER
        if tr.enabled:
            it, cp_freq, next_version, pending = self._trace_inputs
            tr.emit(
                "decision", it=it, cp_freq=cp_freq,
                next_version=next_version, pending=pending,
                write=d.write, tiers=list(d.tiers), full=d.full,
                sync=d.sync, final=d.final, reason=d.reason,
            )
        return d

    def _deepest(self) -> str:
        return self._chain[-1] if self._chain else "pfs"

    def _walltime_due(self, now: float) -> bool:
        wt = self.env.walltime_seconds
        if wt <= 0 or self._final_written:
            return False
        est_write = sum(self.tier_cost(s) or 0.0 for s in self._chain)
        # decisions happen once per step: if this one doesn't fire, the next
        # chance is a full step away — budget for it too
        est_step = self._step_ewma or 0.0
        deadline = wt - self.env.walltime_margin_seconds - est_write - est_step
        return (now - self._t_start) >= deadline

    def _observe_tick(self, now: float, iteration: Optional[int]) -> None:
        """Infer step duration from the EWMA of gaps between successive
        decisions (distinct iterations only, so probing twice is free).
        Inference stops as soon as a driver feeds measured step times via
        :meth:`observe_step_seconds` — gaps include checkpoint-write time,
        direct measurements don't."""
        if iteration is not None and iteration == self._last_iteration:
            return
        if self._last_tick_t is not None and not self._step_direct:
            gap = now - self._last_tick_t
            if gap > 0:
                prev = self._step_ewma
                self._step_ewma = gap if prev is None else (
                    0.8 * prev + 0.2 * gap)
        self._last_tick_t = now
        self._last_iteration = iteration
