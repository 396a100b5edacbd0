"""``PlacementService``: the long-running placement serving loop.

``PlacementSession`` is batched *cold* placement: every ``place_many``
decodes every task from scratch.  Production traffic is a stream of
millions of near-duplicate requests with slowly drifting table
popularity, and this module turns the session into a service for that
workload:

1. **Placement cache** -- requests are keyed on a blake2b task digest
   (``repro_torch.api.digest.task_key``; structural features only by
   default, so popularity drift maps to ONE entry).  Repeat tasks are
   served in dictionary time, skipping decode entirely.
2. **Micro-batch admission** -- cache misses queue briefly, coalesced
   by digest, and are flushed per ``(M_pad, D)`` bucket (``max_batch``
   full, or the oldest request older than ``max_wait_ms``), so every
   batched decode on the agent's device amortizes its per-step launches
   across a full batch instead of paying ragged singleton calls.
3. **Drift-triggered re-placement** -- per-table access-histogram
   EWMAs (``DriftTracker``) are compared to the placed snapshot on
   every hit; past ``drift_threshold`` the entry is re-placed
   *incrementally*: ``SearchPlacer.refine`` seeded from the incumbent,
   scored through a ``MigrationCostOracle`` so moves must pay for the
   bytes they migrate.
4. **Fault tolerance** -- with a ``FaultInjector`` attached, the
   service rides out device loss, capacity shrink, transient oracle
   errors, and decode-latency spikes: affected cache entries fail over
   onto the surviving mesh (greedy repair seeded into
   ``SearchPlacer.refine`` under the migration objective, so recovery
   moves only what it must), decodes that bust the deadline degrade
   down a fallback chain (DreamShard -> expert -> greedy-legal), oracle
   errors retry with bounded backoff, and every request completes with
   a legal placement or a typed ``ServeError`` -- never an exception
   out of ``submit``/``flush``.  ``save``/``restore`` checkpoint the
   whole serving state (cache, drift EWMAs, fault epoch, latency
   ledger) through ``repro_torch.checkpoint`` for warm restarts.

Everything is observable through ``serve.*`` telemetry (cache
hit/miss/eviction counters, flush spans, re-place spans,
``serve.faults.*`` / ``serve.fallback.*`` fault-path counters) plus the
instance-level ``stats()`` snapshot.  The reference's
``benchmarks/b11_serve.py`` replays a synthetic drifting trace through
its loop and ``benchmarks/b12_resilience.py`` one against an injected
failure schedule; ``chip_smoke.py`` replays both paper regimes through
this one on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch import telemetry as tele
from repro_torch.api.digest import task_key
from repro_torch.api.oracle import ensure_oracle
from repro_torch.api.placement import Placement
from repro_torch.api.session import PlacementSession
from repro_torch.core import features as F
from repro_torch.core.baselines import expert_place
from repro_torch.data.tasks import Task
from repro_torch.embedding.plan import build_plan
from repro_torch.serve.cache import CacheEntry, PlacementCache
from repro_torch.serve.drift import (DriftTracker, MigrationCostOracle,
                                     dist_divergence)
from repro_torch.serve.errors import (CapacityError, DecodeTimeout,
                                      IllegalTaskError, ServeError,
                                      TransientOracleError)
from repro_torch.serve.faults import (KINDS, DegradedMeshOracle, FaultInjector,
                                      FaultyOracle, repair_assignment)
from repro_torch.serve.ledger import LatencyReservoir
from repro_torch.sim.costsim import assignments_legal

FALLBACK_STAGES = ("expert", "greedy")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs for one ``PlacementService``.

    Admission: a queued bucket flushes when it holds ``max_batch``
    distinct tasks or its oldest request has waited ``max_wait_ms``.
    Cache: ``cache_entries`` LRU capacity; ``key_distribution=True``
    folds the access histograms into the digest (every drifted request
    then misses -- the always-decode policy; the default keys on
    structural features only).
    Drift: histogram EWMAs (``ewma_alpha``) trigger a re-placement when
    their max per-table total-variation distance from the placed
    snapshot exceeds ``drift_threshold`` (``None`` disables the loop);
    the refinement runs ``replace_strategy`` under
    ``replace_max_evals``/``replace_budget_ms`` with a migration term
    of ``migration_ms_per_gb`` x bytes moved in its objective.
    Resilience: a decode whose injected latency spike reaches
    ``decode_deadline_ms`` skips DreamShard and walks
    ``fallback_chain`` (``"expert"``: greedy size-balance on the
    surviving devices; ``"greedy"``: guaranteed-legal best-fit; an
    empty chain turns a busted deadline into ``DecodeTimeout``).
    Transient oracle errors retry up to ``oracle_retries`` times with
    ``retry_backoff_ms * 2**attempt`` sleeps (0 disables sleeping).
    Failover refinement is metered by ``failover_max_evals``; per-
    request latencies sample into a ``reservoir_size`` ledger.
    Sharding: ``shard_oversized=True`` adds a last-resort stage on the
    healthy mesh -- a task no whole-table layout can hold (e.g. one
    table larger than a device's HBM) gets a column-sharded placement
    via ``repro_torch.sharding.ShardingPlacer`` instead of a
    ``CapacityError``.  Off by default: the legacy serving path stays
    bitwise.
    """

    max_wait_ms: float = 2.0
    max_batch: int = 16
    cache_entries: int = 4096
    key_distribution: bool = False
    ewma_alpha: float = 0.1
    drift_threshold: float | None = 0.1
    migration_ms_per_gb: float = 25.0
    replace_strategy: str = "lns"
    replace_max_evals: int | None = 96
    replace_budget_ms: float | None = None
    seed: int = 0
    decode_deadline_ms: float | None = None
    fallback_chain: tuple[str, ...] = ("expert", "greedy")
    oracle_retries: int = 2
    retry_backoff_ms: float = 0.0
    failover_max_evals: int | None = 64
    reservoir_size: int = 4096
    shard_oversized: bool = False

    def __post_init__(self):
        for stage in self.fallback_chain:
            if stage not in FALLBACK_STAGES:
                raise ValueError(f"unknown fallback stage {stage!r}; "
                                 f"expected one of {FALLBACK_STAGES}")


@dataclasses.dataclass
class ServeResult:
    """One served request: the placement plus serving provenance.

    ``source`` is ``"cache"`` / ``"decode"`` / ``"fallback"`` (a
    degraded-mode stage produced the placement) / ``"error"`` (no legal
    placement; ``placement`` is ``None`` and ``error`` carries the
    typed ``ServeError``).  ``degraded`` names the degradation applied
    (``"repair"`` / ``"expert"`` / ``"greedy"``), ``None`` on the
    healthy path.
    """

    placement: Placement | None
    source: str             # "cache" | "decode" | "fallback" | "error"
    latency_ms: float       # submit -> placement available
    queue_wait_ms: float    # admission-queue share of the latency
    replaced: bool = False  # a drift re-placement ran while serving this
    tag: object = None      # caller's correlation token
    error: ServeError | None = None
    degraded: str | None = None


@dataclasses.dataclass
class _Pending:
    """One queued decode (unique task digest) with its waiting tickets."""

    key: bytes
    raw: np.ndarray
    n_devices: int
    tickets: list[tuple[object, float]]   # (tag, t_enqueue)


class PlacementService:
    """Cache + admission + drift + fault loop over a ``PlacementSession``.

    Parameters
    ----------
    agent: a trained ``DreamShard`` (decode path), or pass ``session=``
        to reuse an existing warmed ``PlacementSession``.
    oracle: the ``CostOracle`` scoring drift re-placements (defaults to
        the agent's training oracle).
    faults: an optional ``FaultInjector``; when present it is ticked
        once per request, its events drive failover/degradation, and
        the serving oracle is wrapped in ``FaultyOracle`` so injected
        measurement errors exercise the retry path.
    clock: seconds-valued time source (injectable for deterministic
        admission tests; defaults to ``time.perf_counter``).

    The service takes no device: decode runs where the agent's networks
    live (``cuda`` unless the agent was built for the CPU); the cache,
    admission, drift and fault paths are host numpy, bitwise
    ``repro.serve``'s, and a ``save`` of either package restores in the
    other.

    ``submit`` returns the list of requests *completed by that call*: a
    cache hit completes immediately; a miss enqueues and may complete
    together with other queued requests when its bucket flushes.  Call
    ``flush()`` to drain stragglers (end of stream) and ``poll()`` to
    flush buckets whose wait deadline passed without new traffic.
    Neither ever raises for a bad request: malformed tasks and
    unplaceable meshes come back as ``ServeResult.error``.
    """

    def __init__(self, agent=None, oracle=None,
                 config: ServeConfig | None = None,
                 session: PlacementSession | None = None,
                 faults: FaultInjector | None = None,
                 clock: Callable[[], float] = time.perf_counter):
        if session is None:
            if agent is None:
                raise ValueError("pass a DreamShard agent or a session")
            session = PlacementSession(agent)
        self.session = session
        self.oracle = ensure_oracle(
            oracle if oracle is not None else session.agent.oracle)
        self.faults = faults
        if faults is not None:
            self.oracle = FaultyOracle(self.oracle, faults)
        self.config = config if config is not None else ServeConfig()
        self.clock = clock
        self.cache = PlacementCache(self.config.cache_entries)
        self.drift = DriftTracker(self.config.ewma_alpha)
        self.latency = LatencyReservoir(self.config.reservoir_size,
                                        seed=self.config.seed)
        self._queues: dict[tuple, dict[bytes, _Pending]] = {}
        self.requests = 0
        self.coalesced = 0          # misses absorbed by a queued duplicate
        self.decode_batches = 0
        self.decoded_tasks = 0
        self.replace_events = 0     # drift triggers (refine ran)
        self.migrations = 0         # triggers that actually moved tables
        self.bytes_moved_gb = 0.0
        # fault-path counters
        self.fault_events = {k: 0 for k in KINDS}
        self.evacuations = 0        # failover re-placements applied
        self.evacuation_failures = 0   # entries dropped (mesh can't hold)
        self.failover_bytes_gb = 0.0   # failover share of bytes_moved_gb
        self.fallbacks = {s: 0 for s in FALLBACK_STAGES}
        self.shard_fallbacks = 0    # sharded last-resort placements served
        self.repairs = 0            # decode outputs re-homed onto survivors
        self.deadline_skips = 0     # flushes that skipped DreamShard
        self.decode_errors = 0      # place_many raised (served via fallback)
        self.typed_errors = 0       # requests completed with a ServeError
        self.rejected = 0           # malformed requests (IllegalTaskError)
        self.retries = 0            # transient-oracle attempts that failed
        self.retry_exhausted = 0    # retry budgets fully consumed

    # ---- keying --------------------------------------------------------------

    def request_key(self, raw_features: np.ndarray, n_devices: int) -> bytes:
        return task_key(raw_features, n_devices,
                        include_distribution=self.config.key_distribution)

    # ---- serving -------------------------------------------------------------

    def submit(self, raw_features: np.ndarray, n_devices: int,
               tag: object = None) -> list[ServeResult]:
        """Serve one request; returns every request completed by this
        call (the hit itself, or queued requests whose bucket flushed).
        Never raises for a bad request -- malformed tasks complete
        immediately with a typed ``IllegalTaskError`` result."""
        now = self.clock()
        self.requests += 1
        tele.count("serve.requests")
        if self.faults is not None:
            for ev in self.faults.advance():
                self._on_fault(ev)
        err = self._validate(raw_features, n_devices)
        if err is not None:
            self.rejected += 1
            self.typed_errors += 1
            tele.count("serve.fallback.errors")
            latency = (self.clock() - now) * 1e3
            self.latency.record(latency)
            return [ServeResult(placement=None, source="error",
                                latency_ms=latency, queue_wait_ms=0.0,
                                error=err, tag=tag)]
        raw = np.asarray(raw_features, dtype=np.float64)
        key = self.request_key(raw, n_devices)
        ewma = self.drift.observe(key, raw[:, F.DIST_START:])

        entry = self.cache.get(key)
        if entry is not None:
            replaced = self._maybe_replace(key, entry, raw, ewma, n_devices)
            latency = (self.clock() - now) * 1e3
            self.latency.record(latency)
            return [ServeResult(placement=entry.placement, source="cache",
                                latency_ms=latency, queue_wait_ms=0.0,
                                replaced=replaced, tag=tag)]

        bucket = self.session.bucket_key(Task.of(raw, n_devices))
        queue = self._queues.setdefault(bucket, {})
        pending = queue.get(key)
        if pending is not None:                   # near-duplicate in flight
            self.coalesced += 1
            tele.count("serve.coalesced")
            pending.tickets.append((tag, now))
        else:
            queue[key] = _Pending(key=key, raw=raw, n_devices=n_devices,
                                  tickets=[(tag, now)])
        return self._flush_due(now)

    def poll(self) -> list[ServeResult]:
        """Flush buckets whose oldest request outwaited ``max_wait_ms``
        (call between requests on a quiet stream)."""
        return self._flush_due(self.clock())

    def flush(self) -> list[ServeResult]:
        """Drain every queued request regardless of batch/wait state."""
        out = []
        for bucket in list(self._queues):
            out.extend(self._flush_bucket(bucket))
        return out

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ---- validation ----------------------------------------------------------

    def _validate(self, raw_features, n_devices) -> IllegalTaskError | None:
        try:
            raw = np.asarray(raw_features, dtype=np.float64)
        except Exception:
            return IllegalTaskError("raw_features is not numeric")
        if raw.ndim != 2 or raw.shape[1] != F.NUM_FEATURES:
            return IllegalTaskError(
                f"raw_features must be (M, {F.NUM_FEATURES}), "
                f"got shape {raw.shape}")
        if raw.shape[0] == 0:
            return IllegalTaskError("task has no tables")
        if not np.isfinite(raw).all():
            return IllegalTaskError("raw_features contains non-finite values")
        if (raw[:, F.TABLE_SIZE_GB] < 0.0).any():
            return IllegalTaskError("negative table sizes")
        try:
            n = int(n_devices)
        except (TypeError, ValueError):
            return IllegalTaskError(f"bad n_devices {n_devices!r}")
        if n < 1 or n != n_devices:
            return IllegalTaskError(f"n_devices must be a positive int, "
                                    f"got {n_devices!r}")
        return None

    # ---- fault handling ------------------------------------------------------

    def _mesh(self, n_devices: int) -> tuple[np.ndarray, float]:
        """(survivors mask, per-device capacity) for the current epoch."""
        if self.faults is None:
            return (np.ones(n_devices, dtype=bool),
                    self.oracle.mem_capacity_gb)
        return (self.faults.allowed_mask(n_devices),
                self.faults.capacity_gb(self.oracle.mem_capacity_gb))

    def _on_fault(self, ev) -> None:
        self.fault_events[ev.kind] += 1
        tele.count(f"serve.faults.{ev.kind}")
        if ev.kind in ("device_loss", "capacity_shrink"):
            self._failover_sweep(ev.kind)
        # device_recovery only widens the mesh (nothing cached is newly
        # illegal); oracle_error / decode_spike stay armed in the
        # injector until the next measurement / flush consumes them

    def _failover_sweep(self, reason: str) -> None:
        """Re-validate every cached placement against the shrunk mesh
        and evacuate the ones it can no longer hold."""
        t0 = self.clock()
        doomed: list[tuple[bytes, CacheEntry]] = []
        for key, entry in self.cache.items():
            D = entry.placement.n_devices
            allowed, capacity = self._mesh(D)
            if entry.raw is None:
                doomed.append((key, entry))       # nothing to re-place from
                continue
            a = entry.placement.assignment
            on_lost = not allowed[np.clip(a, 0, D - 1)].all()
            sizes = entry.raw[:, F.TABLE_SIZE_GB]
            fits = bool(assignments_legal(sizes, a[None, :], D, capacity)[0])
            if on_lost or not fits:
                doomed.append((key, entry))
        with tele.span("serve.failover", reason=reason,
                       affected=len(doomed)) as sp:
            moved0 = self.failover_bytes_gb
            for key, entry in doomed:
                self._evacuate(key, entry)
            sp.set(moved_gb=round(self.failover_bytes_gb - moved0, 4),
                   ms=round((self.clock() - t0) * 1e3, 3))

    def _evacuate(self, key: bytes, entry: CacheEntry) -> None:
        """Fail one cached placement over to the surviving mesh: greedy
        repair for immediate legality, then ``SearchPlacer.refine``
        seeded from that repair under the migration objective (restricted
        to survivors), so recovery moves only the bytes it must."""
        cfg = self.config
        if entry.raw is None:
            self.cache.invalidate(lambda k, e: k == key)
            self.evacuation_failures += 1
            tele.count("serve.faults.invalidated")
            return
        incumbent = entry.placement
        D = incumbent.n_devices
        allowed, capacity = self._mesh(D)
        sizes = entry.raw[:, F.TABLE_SIZE_GB]
        seed_a = repair_assignment(sizes, incumbent.assignment, allowed,
                                   capacity)
        if seed_a is None:                 # survivors cannot hold the task
            self.cache.invalidate(lambda k, e: k == key)
            self.evacuation_failures += 1
            tele.count("serve.faults.invalidated")
            return
        current = np.array(entry.raw)
        ewma = self.drift.estimate(key)
        if ewma is not None:
            current[:, F.DIST_START:] = ewma
        task = Task.of(current, D)
        from repro_torch.search import SearchConfig, SearchPlacer
        oracle = DegradedMeshOracle(
            MigrationCostOracle.wrap(self.oracle, incumbent.assignment,
                                     cfg.migration_ms_per_gb),
            allowed, capacity)
        placer = SearchPlacer(
            oracle, agent=self.session.agent, name="serve.failover",
            config=SearchConfig(strategy=cfg.replace_strategy,
                                budget_ms=cfg.replace_budget_ms,
                                max_evals=cfg.failover_max_evals,
                                seed=cfg.seed))
        seed = Placement(assignment=seed_a,
                         plan=build_plan(current, seed_a, D),
                         n_devices=D, strategy="serve.failover")
        refined = self._with_retries(lambda: placer.refine(task, seed))
        if refined is None:                # retry budget exhausted: the
            refined = seed                 # repaired seed is still legal
        moved_gb = float(((refined.assignment != incumbent.assignment)
                          * sizes).sum())
        entry.placement = refined
        if ewma is not None:
            entry.snapshot = np.array(ewma)
        self.evacuations += 1
        self.failover_bytes_gb += moved_gb
        self.bytes_moved_gb += moved_gb
        self.migrations += 1
        tele.count("serve.faults.evacuated")
        tele.count("serve.migrations")

    def _with_retries(self, fn):
        """Run ``fn`` retrying ``TransientOracleError`` with bounded
        exponential backoff; ``None`` when the budget is exhausted."""
        cfg = self.config
        for attempt in range(cfg.oracle_retries + 1):
            try:
                return fn()
            except TransientOracleError:
                self.retries += 1
                tele.count("serve.fallback.retries")
                if attempt < cfg.oracle_retries and cfg.retry_backoff_ms > 0:
                    time.sleep(cfg.retry_backoff_ms * (2 ** attempt) / 1e3)
        self.retry_exhausted += 1
        tele.count("serve.fallback.retry_exhausted")
        return None

    # ---- admission -----------------------------------------------------------

    def _flush_due(self, now: float) -> list[ServeResult]:
        cfg = self.config
        out = []
        for bucket in list(self._queues):
            queue = self._queues[bucket]
            if not queue:
                continue
            oldest = min(t for p in queue.values() for _, t in p.tickets)
            if len(queue) >= cfg.max_batch or \
                    (now - oldest) * 1e3 >= cfg.max_wait_ms:
                out.extend(self._flush_bucket(bucket))
        return out

    def _flush_bucket(self, bucket: tuple) -> list[ServeResult]:
        pendings = list(self._queues.pop(bucket, {}).values())
        if not pendings:
            return []
        cfg = self.config
        t0 = self.clock()
        oldest = min(t for p in pendings for _, t in p.tickets)
        tasks = [Task.of(p.raw, p.n_devices) for p in pendings]
        spike_ms = (self.faults.take_spike_ms()
                    if self.faults is not None else 0.0)
        busted = (cfg.decode_deadline_ms is not None
                  and spike_ms >= cfg.decode_deadline_ms)
        decoded: list[Placement | None]
        if busted:
            self.deadline_skips += 1
            tele.count("serve.fallback.deadline")
            decoded = [None] * len(tasks)
        else:
            try:
                with tele.span("serve.flush", m_pad=bucket[0],
                               n_devices=bucket[1], tasks=len(tasks),
                               queue_wait_ms=round((t0 - oldest) * 1e3, 3)):
                    decoded = self.session.place_many(tasks)
                self.decode_batches += 1
                self.decoded_tasks += len(tasks)
                tele.count("serve.flushes")
                tele.count("serve.decoded", len(tasks))
            except Exception:              # decode itself died: the chain
                self.decode_errors += 1    # still owes every ticket an answer
                tele.count("serve.fallback.decode_errors")
                decoded = [None] * len(tasks)
        resolved = [self._resolve(task, placement, busted)
                    for task, placement in zip(tasks, decoded)]
        t1 = self.clock()
        out = []
        for pend, (placement, err, degraded) in zip(pendings, resolved):
            if placement is not None:
                self.cache.put(pend.key, CacheEntry(
                    placement=placement,
                    snapshot=np.array(pend.raw[:, F.DIST_START:]),
                    raw=np.array(pend.raw)))
            source = "error" if err is not None else \
                ("fallback" if degraded in (*FALLBACK_STAGES, "shard")
                 else "decode")
            if err is not None:
                self.typed_errors += len(pend.tickets)
                tele.count("serve.fallback.errors", len(pend.tickets))
            for tag, t_enq in pend.tickets:
                latency = (t1 - t_enq) * 1e3
                self.latency.record(latency)
                out.append(ServeResult(
                    placement=placement, source=source,
                    latency_ms=latency,
                    queue_wait_ms=(t0 - t_enq) * 1e3, tag=tag,
                    error=err, degraded=degraded))
        return out

    def _resolve(self, task: Task, decoded: Placement | None, busted: bool):
        """Turn one decode output (or its absence) into a legal placement
        via the fallback chain -> ``(placement, error, degraded)``."""
        cfg = self.config
        D = task.n_devices
        allowed, capacity = self._mesh(D)
        degraded_mesh = self.faults is not None and self.faults.degraded
        sizes = task.raw_features[:, F.TABLE_SIZE_GB]
        if decoded is not None:
            if not degraded_mesh:
                if cfg.shard_oversized and not bool(assignments_legal(
                        sizes, decoded.assignment[None], D, capacity)[0]):
                    # no whole-table layout can hold this task (e.g. one
                    # oversized table): opt-in column-sharded answer
                    placement = self._shard_stage(task)
                    if placement is not None:
                        self.shard_fallbacks += 1
                        tele.count("serve.fallback.shard")
                        return placement, None, "shard"
                return decoded, None, None       # healthy path: bitwise
            repaired = repair_assignment(sizes, decoded.assignment,
                                         allowed, capacity)
            if repaired is not None:
                if np.array_equal(repaired, decoded.assignment):
                    return decoded, None, None
                self.repairs += 1
                tele.count("serve.fallback.repairs")
                fixed = Placement(
                    assignment=repaired,
                    plan=build_plan(task.raw_features, repaired, D),
                    n_devices=D, strategy=decoded.strategy + "+repair",
                    candidates=decoded.candidates,
                    oracle_evals=decoded.oracle_evals)
                return fixed, None, "repair"
            # survivors can't hold the decode's layout at all; the chain
            # below gets its own shot before we declare capacity failure
        for stage in cfg.fallback_chain:
            placement = self._fallback_stage(stage, task, sizes, allowed,
                                             capacity)
            if placement is not None:
                self.fallbacks[stage] += 1
                tele.count(f"serve.fallback.{stage}")
                return placement, None, stage
        if cfg.shard_oversized and bool(allowed.all()):
            placement = self._shard_stage(task)
            if placement is not None:
                self.shard_fallbacks += 1
                tele.count("serve.fallback.shard")
                return placement, None, "shard"
        if busted and decoded is None and not cfg.fallback_chain:
            return None, DecodeTimeout(
                f"decode deadline {cfg.decode_deadline_ms}ms busted and "
                "no fallback stage is enabled"), None
        return None, CapacityError(
            f"no legal placement for {task.n_tables} tables on the "
            f"surviving mesh ({int(allowed.sum())}/{D} devices, "
            f"{capacity:.2f} GB each)"), None

    def _fallback_stage(self, stage: str, task: Task, sizes: np.ndarray,
                        allowed: np.ndarray,
                        capacity: float) -> Placement | None:
        """One degraded-mode placement attempt; ``None`` when the stage
        cannot produce a legal layout on the surviving devices."""
        D = task.n_devices
        survivors = np.flatnonzero(allowed)
        if survivors.size == 0:
            return None
        if stage == "expert":
            # greedy size-balance on the compressed survivor mesh, then
            # mapped back to physical ids (expert_place may overflow as a
            # last resort, so re-check)
            compressed = expert_place(task.raw_features, survivors.size,
                                      capacity, "size")
            a = survivors[compressed]
        else:                              # "greedy": guaranteed-legal
            a = repair_assignment(sizes, np.full(task.n_tables, -1,
                                                 dtype=np.int64),
                                  allowed, capacity)
            if a is None:
                return None
        if not bool(assignments_legal(sizes, a[None, :], D, capacity)[0]):
            return None
        return Placement(assignment=np.asarray(a, dtype=np.int64),
                         plan=build_plan(task.raw_features, a, D),
                         n_devices=D, strategy=f"serve.fallback.{stage}")

    def _shard_stage(self, task: Task) -> Placement | None:
        """Opt-in last resort (``shard_oversized``): column-shard so a
        task no whole-table layout can hold still serves.  Healthy-mesh
        only -- sharding does not know the degraded device mask."""
        from repro_torch.api.oracle import legal_sharded
        from repro_torch.sharding import ShardingPlacer
        try:
            placement = ShardingPlacer(self.oracle).place(task)
        except Exception:
            return None
        if placement.sharding is not None:
            legal = bool(legal_sharded(
                self.oracle, task.raw_features, placement.sharding,
                placement.shard_assignment[None], task.n_devices)[0])
        else:
            legal = bool(assignments_legal(
                task.raw_features[:, F.TABLE_SIZE_GB],
                placement.assignment[None], task.n_devices,
                self.oracle.mem_capacity_gb)[0])
        return placement if legal else None

    # ---- drift ---------------------------------------------------------------

    def _maybe_replace(self, key: bytes, entry: CacheEntry,
                       raw: np.ndarray, ewma: np.ndarray,
                       n_devices: int) -> bool:
        cfg = self.config
        if cfg.drift_threshold is None:
            return False
        divergence = dist_divergence(ewma, entry.snapshot)
        if divergence <= cfg.drift_threshold:
            return False
        # re-place against the *current* traffic estimate: structural
        # features from the request, histograms from the EWMA
        from repro_torch.search import SearchConfig, SearchPlacer
        current = np.array(raw)
        current[:, F.DIST_START:] = ewma
        task = Task.of(current, n_devices)
        incumbent = entry.placement
        with tele.span("serve.replace", divergence=round(divergence, 4),
                       M=task.n_tables, n_devices=n_devices) as sp:
            oracle = MigrationCostOracle.wrap(
                self.oracle, incumbent.assignment, cfg.migration_ms_per_gb)
            if self.faults is not None and self.faults.degraded:
                # drift refinement must not re-home tables onto a lost
                # device while the mesh is degraded
                allowed, capacity = self._mesh(n_devices)
                oracle = DegradedMeshOracle(oracle, allowed, capacity)
            placer = SearchPlacer(
                oracle, agent=self.session.agent, name="serve.replace",
                config=SearchConfig(strategy=cfg.replace_strategy,
                                    budget_ms=cfg.replace_budget_ms,
                                    max_evals=cfg.replace_max_evals,
                                    seed=cfg.seed))
            refined = self._with_retries(
                lambda: placer.refine(task, incumbent))
            if refined is None:            # retries exhausted: keep serving
                sp.set(kept_incumbent=True)   # the incumbent unchanged
                return False
            moved_gb = float(((refined.assignment != incumbent.assignment)
                              * current[:, F.TABLE_SIZE_GB]).sum())
            sp.set(moved_gb=round(moved_gb, 4))
        entry.placement = refined
        entry.snapshot = np.array(ewma)
        entry.raw = np.array(raw)
        entry.replaces += 1
        self.replace_events += 1
        self.bytes_moved_gb += moved_gb
        tele.count("serve.replace_events")
        if moved_gb > 0.0:
            self.migrations += 1
            tele.count("serve.migrations")
        return True

    # ---- checkpointing -------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the serving state (cache entries in LRU order,
        drift EWMAs, admission queues, counters, latency ledger, fault
        epoch) through ``repro_torch.checkpoint.save_state``.  Queued request
        tickets are serialized too, so a warm restart owes exactly the
        in-flight work the crash interrupted -- their ``tag`` values
        must be JSON-serializable (or ``flush()`` first)."""
        from repro_torch import checkpoint
        arrays: dict[str, np.ndarray] = {}
        entries_meta = []
        i = 0
        for key, e in self.cache.items():
            if e.raw is None:       # hand-built entry: nothing to restore
                continue            # a placement from, so not checkpointed
            arrays[f"entry{i}.raw"] = e.raw
            arrays[f"entry{i}.snapshot"] = e.snapshot
            arrays[f"entry{i}.assignment"] = e.placement.assignment
            entries_meta.append({
                "key": key.hex(),
                "n_devices": e.placement.n_devices,
                "strategy": e.placement.strategy,
                "est_cost_ms": e.placement.est_cost_ms,
                "candidates": e.placement.candidates,
                "oracle_evals": e.placement.oracle_evals,
                "requests": e.requests, "replaces": e.replaces})
            i += 1
        drift_keys = []
        for i, (key, ewma) in enumerate(self.drift._ewma.items()):
            arrays[f"ewma{i}"] = ewma
            drift_keys.append(key.hex())
        queues_meta = []
        q = 0
        for bucket, queue in self._queues.items():
            pendings_meta = []
            for pend in queue.values():
                arrays[f"queue{q}.raw"] = pend.raw
                pendings_meta.append({
                    "key": pend.key.hex(), "raw_idx": q,
                    "n_devices": pend.n_devices,
                    "tickets": [[tag, t] for tag, t in pend.tickets]})
                q += 1
            queues_meta.append({"bucket": [int(b) for b in bucket],
                                "pendings": pendings_meta})
        meta = {
            "entries": entries_meta,
            "drift_keys": drift_keys,
            "queues": queues_meta,
            "counters": self._counter_state(),
            "cache_counters": {"hits": self.cache.hits,
                               "misses": self.cache.misses,
                               "evictions": self.cache.evictions,
                               "invalidations": self.cache.invalidations},
            "reservoir": self.latency.state_dict(),
            "faults": (self.faults.state_dict()
                       if self.faults is not None else None),
        }
        checkpoint.save_state(path, arrays, meta)
        tele.count("serve.checkpoint.saves")

    @classmethod
    def restore(cls, path: str, agent=None, oracle=None,
                config: ServeConfig | None = None,
                session: PlacementSession | None = None,
                faults: FaultInjector | None = None,
                clock: Callable[[], float] = time.perf_counter
                ) -> "PlacementService":
        """Warm-restart a service from a ``save`` checkpoint.  The model
        and oracle are reconstructed by the caller (they have their own
        checkpoints); this restores the *serving* state -- cache, drift,
        queued tickets, counters, ledger -- and advances ``faults`` to
        the epoch the
        checkpoint was taken at, so replaying the remaining stream is
        bitwise-identical to a run that never stopped."""
        from repro_torch import checkpoint
        arrays, meta = checkpoint.load_state(path)
        svc = cls(agent=agent, oracle=oracle, config=config,
                  session=session, faults=faults, clock=clock)
        if faults is not None and meta["faults"] is not None:
            faults.load_state_dict(meta["faults"])
        for i, em in enumerate(meta["entries"]):
            raw = np.asarray(arrays[f"entry{i}.raw"], dtype=np.float64)
            a = np.asarray(arrays[f"entry{i}.assignment"], dtype=np.int64)
            placement = Placement(
                assignment=a,
                plan=build_plan(raw, a, int(em["n_devices"])),
                n_devices=int(em["n_devices"]), strategy=em["strategy"],
                est_cost_ms=em["est_cost_ms"],
                candidates=int(em["candidates"]),
                oracle_evals=int(em["oracle_evals"]))
            svc.cache.put(bytes.fromhex(em["key"]), CacheEntry(
                placement=placement,
                snapshot=np.asarray(arrays[f"entry{i}.snapshot"],
                                    dtype=np.float64),
                requests=int(em["requests"]),
                replaces=int(em["replaces"]), raw=raw))
        for i, key_hex in enumerate(meta["drift_keys"]):
            svc.drift._ewma[bytes.fromhex(key_hex)] = np.asarray(
                arrays[f"ewma{i}"], dtype=np.float64)
        for qm in meta.get("queues", []):
            queue = svc._queues.setdefault(tuple(qm["bucket"]), {})
            for pm in qm["pendings"]:
                key = bytes.fromhex(pm["key"])
                queue[key] = _Pending(
                    key=key,
                    raw=np.asarray(arrays[f"queue{pm['raw_idx']}.raw"],
                                   dtype=np.float64),
                    n_devices=int(pm["n_devices"]),
                    tickets=[(tag, float(t)) for tag, t in pm["tickets"]])
        svc._load_counter_state(meta["counters"])
        cc = meta["cache_counters"]
        svc.cache.hits = int(cc["hits"])
        svc.cache.misses = int(cc["misses"])
        svc.cache.evictions = int(cc["evictions"])
        svc.cache.invalidations = int(cc["invalidations"])
        svc.latency.load_state_dict(meta["reservoir"])
        tele.count("serve.checkpoint.restores")
        return svc

    def _counter_state(self) -> dict:
        return {
            "requests": self.requests, "coalesced": self.coalesced,
            "decode_batches": self.decode_batches,
            "decoded_tasks": self.decoded_tasks,
            "replace_events": self.replace_events,
            "migrations": self.migrations,
            "bytes_moved_gb": self.bytes_moved_gb,
            "fault_events": dict(self.fault_events),
            "evacuations": self.evacuations,
            "evacuation_failures": self.evacuation_failures,
            "failover_bytes_gb": self.failover_bytes_gb,
            "fallbacks": dict(self.fallbacks),
            "repairs": self.repairs,
            "deadline_skips": self.deadline_skips,
            "decode_errors": self.decode_errors,
            "typed_errors": self.typed_errors,
            "rejected": self.rejected,
            "retries": self.retries,
            "retry_exhausted": self.retry_exhausted,
        }

    def _load_counter_state(self, state: dict) -> None:
        for name in ("requests", "coalesced", "decode_batches",
                     "decoded_tasks", "replace_events", "migrations",
                     "evacuations", "evacuation_failures", "repairs",
                     "deadline_skips", "decode_errors", "typed_errors",
                     "rejected", "retries", "retry_exhausted"):
            setattr(self, name, int(state[name]))
        self.bytes_moved_gb = float(state["bytes_moved_gb"])
        self.failover_bytes_gb = float(state["failover_bytes_gb"])
        self.fault_events = {k: int(v)
                             for k, v in state["fault_events"].items()}
        self.fallbacks = {k: int(v) for k, v in state["fallbacks"].items()}

    # ---- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Serving-behaviour snapshot (instance counters; the same
        signals stream through ``serve.*`` telemetry counters)."""
        return {
            "requests": self.requests,
            "hits": self.cache.hits,
            "misses": self.cache.misses,
            "hit_rate": self.cache.hit_rate,
            "evictions": self.cache.evictions,
            "invalidations": self.cache.invalidations,
            "entries": len(self.cache),
            "coalesced": self.coalesced,
            "pending": self.pending,
            "decode_batches": self.decode_batches,
            "decoded_tasks": self.decoded_tasks,
            "replace_events": self.replace_events,
            "migrations": self.migrations,
            "bytes_moved_gb": self.bytes_moved_gb,
            "fault_events": dict(self.fault_events),
            "fault_epoch": (self.faults.epoch
                            if self.faults is not None else 0),
            "evacuations": self.evacuations,
            "evacuation_failures": self.evacuation_failures,
            "failover_bytes_gb": self.failover_bytes_gb,
            "fallbacks": dict(self.fallbacks),
            "repairs": self.repairs,
            "deadline_skips": self.deadline_skips,
            "decode_errors": self.decode_errors,
            "typed_errors": self.typed_errors,
            "rejected": self.rejected,
            "retries": self.retries,
            "retry_exhausted": self.retry_exhausted,
            "latency": self.latency.summary(),
        }
