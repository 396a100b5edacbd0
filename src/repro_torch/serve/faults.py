"""Deterministic fault injection for the serving stack.

Real fleets lose devices mid-flight, return transient measurement
errors, and miss decode deadlines.  This module makes those regimes
*replayable*: a ``FaultSchedule`` pins every event to a request index
(never wall clock), a ``FaultInjector`` folds the schedule into mesh
state as the service ticks it forward, and two thin oracle wrappers
project that state onto any ``CostOracle`` without touching its hot
paths:

* ``FaultyOracle``      -- raises ``TransientOracleError`` from
  ``evaluate``/``evaluate_many`` while errors are armed (legality
  probes never fault: a memory check is pure arithmetic, not a
  measurement);
* ``DegradedMeshOracle`` -- restricts legality to the surviving device
  set at (possibly shrunk) capacity, so ``SearchPlacer`` refinement and
  the fallback chain can only ever emit placements the degraded mesh
  can hold.

Because every decision is keyed on the request counter, replaying the
same schedule over the same trace is bitwise-identical -- the property
``benchmarks/b12_resilience.py`` asserts.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.serve.errors import TransientOracleError
from repro_torch.sim.costsim import assignments_legal

KINDS = ("device_loss", "device_recovery", "capacity_shrink",
         "oracle_error", "decode_spike")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault, pinned to a request index.

    ``at``       request index the event fires on (0-based; fires when
                 the injector's tick counter reaches it);
    ``kind``     one of ``KINDS``;
    ``device``   target device id (device_loss / device_recovery);
    ``factor``   surviving capacity fraction in (0, 1] (capacity_shrink;
                 multiplicative with earlier shrinks);
    ``count``    consecutive oracle calls that fail (oracle_error);
    ``spike_ms`` injected decode latency (decode_spike; consumed by the
                 next flush).
    """

    at: int
    kind: str
    device: int | None = None
    factor: float | None = None
    count: int | None = None
    spike_ms: float | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in ("device_loss", "device_recovery") \
                and self.device is None:
            raise ValueError(f"{self.kind} needs device=")
        if self.kind == "capacity_shrink" and \
                not (self.factor and 0.0 < self.factor <= 1.0):
            raise ValueError("capacity_shrink needs factor in (0, 1]")
        if self.kind == "oracle_error" and not (self.count and self.count > 0):
            raise ValueError("oracle_error needs count > 0")
        if self.kind == "decode_spike" and \
                (self.spike_ms is None or self.spike_ms < 0.0):
            raise ValueError("decode_spike needs spike_ms >= 0")

    def to_dict(self) -> dict:
        d = {"at": self.at, "kind": self.kind}
        for f in ("device", "factor", "count", "spike_ms"):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        return d


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, replayable sequence of ``FaultEvent``s.

    Events are stored sorted by ``at`` (ties keep construction order).
    ``generate`` builds a seeded random schedule; ``to_json`` /
    ``from_json`` round-trip exactly, so a benchmark can commit the
    schedule it measured against.
    """

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        ordered = tuple(sorted(self.events, key=lambda e: e.at))
        object.__setattr__(self, "events", ordered)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @classmethod
    def generate(cls, seed: int, n_requests: int, n_devices: int,
                 n_losses: int = 1, recover: bool = True,
                 n_oracle_errors: int = 2, n_spikes: int = 2,
                 spike_ms: float = 50.0) -> "FaultSchedule":
        """Seeded random schedule: ``n_losses`` device losses in the
        middle half of the trace (each recovered later when ``recover``),
        plus transient oracle errors and decode spikes scattered over
        the full trace.  Same seed + shape args -> identical schedule."""
        rng = np.random.default_rng([int(seed), n_requests, n_devices])
        events: list[FaultEvent] = []
        lo, hi = n_requests // 4, max(n_requests // 4 + 1, n_requests // 2)
        devices = rng.permutation(n_devices)[:max(0, min(n_losses,
                                                         n_devices - 1))]
        for dev in devices:
            at = int(rng.integers(lo, hi))
            events.append(FaultEvent(at=at, kind="device_loss",
                                     device=int(dev)))
            if recover:
                back = int(rng.integers(min(at + 1, n_requests),
                                        n_requests + 1))
                events.append(FaultEvent(at=back, kind="device_recovery",
                                         device=int(dev)))
        for _ in range(n_oracle_errors):
            events.append(FaultEvent(
                at=int(rng.integers(0, n_requests)), kind="oracle_error",
                count=int(rng.integers(1, 3))))
        for _ in range(n_spikes):
            events.append(FaultEvent(
                at=int(rng.integers(0, n_requests)), kind="decode_spike",
                spike_ms=float(spike_ms)))
        return cls(events=tuple(events))

    def to_json(self) -> str:
        return json.dumps({"events": [e.to_dict() for e in self.events]})

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        payload = json.loads(text)
        return cls(events=tuple(FaultEvent(**e) for e in payload["events"]))


class FaultInjector:
    """Folds a ``FaultSchedule`` into live mesh state, one tick at a time.

    The service calls ``advance()`` once per submitted request; events
    whose ``at`` equals the current tick fire (in schedule order) and
    are returned so the caller can react (failover, re-validation).
    Between ticks the injector answers the degraded-mesh questions:

    * ``down``            -- set of lost device ids;
    * ``allowed_mask(D)`` -- boolean survivors mask;
    * ``capacity_gb(b)``  -- base capacity after cumulative shrinks;
    * ``take_error()``    -- consume one armed transient-oracle error;
    * ``take_spike_ms()`` -- consume the pending decode spike.

    ``epoch`` bumps on every topology event (loss / recovery /
    shrink) -- the version stamp checkpointed with service state so a
    warm restart resumes mid-schedule exactly where it stopped
    (``state_dict`` / ``load_state_dict``).
    """

    def __init__(self, schedule: FaultSchedule | None = None,
                 n_devices: int | None = None):
        self.schedule = schedule if schedule is not None else FaultSchedule()
        self.n_devices = n_devices
        self.tick = 0
        self.cursor = 0              # next un-fired event in the schedule
        self.down: set[int] = set()
        self.capacity_scale = 1.0
        self.armed_errors = 0
        self.pending_spike_ms = 0.0
        self.epoch = 0

    # ---- ticking -------------------------------------------------------------

    def advance(self) -> list[FaultEvent]:
        """Fire every event scheduled at the current tick, then move on.
        Returns the fired events so the caller can react to each."""
        fired: list[FaultEvent] = []
        events = self.schedule.events
        while self.cursor < len(events) and \
                events[self.cursor].at <= self.tick:
            ev = events[self.cursor]
            self.cursor += 1
            self._apply(ev)
            fired.append(ev)
        self.tick += 1
        return fired

    def _apply(self, ev: FaultEvent) -> None:
        if ev.kind == "device_loss":
            if ev.device not in self.down:
                self.down.add(ev.device)
                self.epoch += 1
        elif ev.kind == "device_recovery":
            if ev.device in self.down:
                self.down.discard(ev.device)
                self.epoch += 1
        elif ev.kind == "capacity_shrink":
            self.capacity_scale *= ev.factor
            self.epoch += 1
        elif ev.kind == "oracle_error":
            self.armed_errors += ev.count
        elif ev.kind == "decode_spike":
            self.pending_spike_ms = max(self.pending_spike_ms, ev.spike_ms)

    # ---- degraded-mesh queries -----------------------------------------------

    @property
    def degraded(self) -> bool:
        return bool(self.down) or self.capacity_scale < 1.0

    def allowed_mask(self, n_devices: int) -> np.ndarray:
        """(D,) bool mask of surviving devices."""
        mask = np.ones(n_devices, dtype=bool)
        for dev in self.down:
            if 0 <= dev < n_devices:
                mask[dev] = False
        return mask

    def capacity_gb(self, base_gb: float) -> float:
        return base_gb * self.capacity_scale

    def take_error(self) -> bool:
        """Consume one armed transient-oracle error (False when none)."""
        if self.armed_errors > 0:
            self.armed_errors -= 1
            return True
        return False

    def take_spike_ms(self) -> float:
        """Consume the pending decode-latency spike (0.0 when none)."""
        spike, self.pending_spike_ms = self.pending_spike_ms, 0.0
        return spike

    # ---- checkpointing -------------------------------------------------------

    def state_dict(self) -> dict:
        """Runtime state for ``PlacementService.save`` (the schedule
        itself is configuration and travels separately)."""
        return {"tick": self.tick, "cursor": self.cursor,
                "down": sorted(self.down),
                "capacity_scale": self.capacity_scale,
                "armed_errors": self.armed_errors,
                "pending_spike_ms": self.pending_spike_ms,
                "epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.tick = int(state["tick"])
        self.cursor = int(state["cursor"])
        self.down = set(int(d) for d in state["down"])
        self.capacity_scale = float(state["capacity_scale"])
        self.armed_errors = int(state["armed_errors"])
        self.pending_spike_ms = float(state["pending_spike_ms"])
        self.epoch = int(state["epoch"])


class FaultyOracle:
    """``CostOracle`` wrapper that fails measurements on command.

    While the injector has errors armed, each ``evaluate`` /
    ``evaluate_many`` call consumes one and raises
    ``TransientOracleError``; otherwise every call delegates bitwise to
    the inner oracle.  Legality probes (``legal`` / ``legal_batch``)
    NEVER fault -- they are spec arithmetic, not hardware measurements,
    and the fallback chain depends on them staying available.
    """

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    @property
    def mem_capacity_gb(self) -> float:
        return self.inner.mem_capacity_gb

    @property
    def num_evaluations(self) -> int:
        return self.inner.num_evaluations

    def _maybe_fault(self):
        if self.injector.take_error():
            raise TransientOracleError("injected transient oracle failure")

    def evaluate(self, raw, assignment, n_devices):
        self._maybe_fault()
        return self.inner.evaluate(raw, assignment, n_devices)

    def evaluate_many(self, raw, assignments, n_devices):
        self._maybe_fault()
        from repro_torch.api.oracle import evaluate_many
        return evaluate_many(self.inner, raw, assignments, n_devices)

    def legal(self, raw, assignment, n_devices) -> bool:
        return bool(self.legal_batch(
            raw, np.asarray(assignment)[None, :], n_devices)[0])

    def legal_batch(self, raw, assignments, n_devices) -> np.ndarray:
        from repro_torch.api.oracle import legal_batch
        return legal_batch(self.inner, raw, assignments, n_devices)


class DegradedMeshOracle:
    """``CostOracle`` wrapper that narrows legality to the surviving mesh.

    ``legal_batch`` rejects any placement touching a disallowed device
    and checks per-device loads against the (possibly shrunk)
    ``capacity_gb`` on survivors only.  ``evaluate`` delegates
    unchanged -- costs are still the inner oracle's; only the feasible
    set shrinks.  Wrap this *outermost* (e.g. around a
    ``MigrationCostOracle``) so search strategies can only admit
    candidates the degraded mesh can actually hold.
    """

    def __init__(self, inner, allowed: np.ndarray,
                 capacity_gb: float | None = None):
        self.inner = inner
        self.allowed = np.asarray(allowed, dtype=bool)
        self._capacity_gb = (inner.mem_capacity_gb if capacity_gb is None
                             else float(capacity_gb))

    @property
    def mem_capacity_gb(self) -> float:
        return self._capacity_gb

    @property
    def num_evaluations(self) -> int:
        return self.inner.num_evaluations

    def evaluate(self, raw, assignment, n_devices):
        return self.inner.evaluate(raw, assignment, n_devices)

    def evaluate_many(self, raw, assignments, n_devices):
        from repro_torch.api.oracle import evaluate_many
        return evaluate_many(self.inner, raw, assignments, n_devices)

    def legal(self, raw, assignment, n_devices) -> bool:
        return bool(self.legal_batch(
            raw, np.asarray(assignment)[None, :], n_devices)[0])

    def legal_batch(self, raw, assignments, n_devices) -> np.ndarray:
        from repro_torch.core import features as F
        raw = np.asarray(raw, dtype=np.float64)
        assignments = np.asarray(assignments)
        ok = assignments_legal(raw[:, F.TABLE_SIZE_GB], assignments,
                               n_devices, self._capacity_gb)
        allowed = self.allowed
        if len(allowed) < n_devices:     # devices beyond the mask survive
            allowed = np.concatenate(
                [allowed, np.ones(n_devices - len(allowed), dtype=bool)])
        in_range = (assignments >= 0) & (assignments < n_devices)
        on_lost = np.where(in_range, ~allowed[np.clip(assignments, 0,
                                                      n_devices - 1)], False)
        return ok & ~on_lost.any(axis=1)


def repair_assignment(sizes_gb: np.ndarray, assignment: np.ndarray,
                      allowed: np.ndarray,
                      capacity_gb: float) -> np.ndarray | None:
    """Deterministic greedy repair of one assignment onto a degraded mesh.

    Tables stranded on disallowed devices -- plus, after a capacity
    shrink, tables shed from over-full surviving devices (largest
    first) -- are re-homed one at a time onto the allowed device with
    the most headroom (ties -> lowest id).  Moves only what it must:
    tables already legal on surviving devices never move.  Returns the
    repaired ``(M,)`` assignment, or ``None`` when the surviving
    capacity cannot hold the task at all.
    """
    sizes = np.asarray(sizes_gb, dtype=np.float64)
    a = np.asarray(assignment).copy()
    allowed = np.asarray(allowed, dtype=bool)
    D = len(allowed)
    if not allowed.any():
        return None
    settled = (a >= 0) & (a < D) & allowed[np.clip(a, 0, D - 1)]
    loads = np.bincount(a[settled], weights=sizes[settled],
                        minlength=D)[:D].astype(np.float64)
    stranded = [int(t) for t in np.nonzero(~settled)[0]]
    # shed: surviving devices over the (possibly shrunk) budget drop
    # their largest tables until they fit
    for dev in np.nonzero(allowed)[0]:
        if loads[dev] <= capacity_gb:
            continue
        on_dev = sorted((int(t) for t in np.nonzero(settled & (a == dev))[0]),
                        key=lambda t: (-sizes[t], t))
        for t in on_dev:
            if loads[dev] <= capacity_gb:
                break
            loads[dev] -= sizes[t]
            stranded.append(t)
    # re-home largest first onto the max-headroom survivor (ties -> lowest
    # id): deterministic, and big tables claim space before fragments do
    stranded.sort(key=lambda t: (-sizes[t], t))
    for t in stranded:
        headroom = np.where(allowed, capacity_gb - loads, -np.inf)
        dev = int(np.argmax(headroom))
        if headroom[dev] < sizes[t]:
            return None
        a[t] = dev
        loads[dev] += sizes[t]
    if not bool(assignments_legal(sizes, a[None, :], D, capacity_gb)[0]):
        return None
    return a
