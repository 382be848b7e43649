"""Continuous batching scheduler with scenario-bucketed admission (a copy
of ``repro.serve.batching``, which is pure Python).

Fixed-slot batching (the KV cache is a static (B, S) arena under jit):
requests occupy slots; a finished request frees its slot immediately and a
queued request is admitted on the next step with a per-slot prefill.
Admission control rejects requests longer than the arena.

Queued requests are *bucketed by tuned scenario key* (the
``core/scenario.py`` ``format_key`` strings wisdom records are selected
by): admission drains one bucket FIFO before switching to the oldest
remaining bucket, so the slots running concurrently share a scenario and
each decode launch lands on a wisdom-exact config instead of forcing a
shape-miss fallback. Within a bucket, admission order is submission order
— never reordered (property-tested for the reference in
``tests/test_serve_batching.py``; ``tests/test_torch_serve.py`` holds this
copy to it).

Token-level callers (``ServeEngine`` in token mode) pass their arena
write cursor to :meth:`ContinuousBatcher.admit`: a request that no longer
fits the remaining arena blocks admission head-of-line (no skipping —
that would starve long requests) until the engine opens a fresh arena
generation. Pure bookkeeping, unit-tested without a model.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass


@dataclass
class Slot:
    request_id: int | None = None
    pos: int = 0                  # tokens generated so far (incl. prompt)
    max_pos: int = 0              # stop position
    active: bool = False
    scenario: str = ""            # bucket the request was admitted from
    start: int = 0                # arena write cursor at admission


@dataclass
class QueuedRequest:
    """One queued submission: identity, lengths, its scenario bucket, and
    a global arrival sequence number (the FIFO evidence — ``queue`` sorts
    on it, and the stress tests assert per-bucket admission follows it)."""
    request_id: int
    prompt_len: int
    max_new_tokens: int
    scenario: str
    seq: int


class ContinuousBatcher:
    """Slot scheduler for continuous batching (see module docstring).

    Bookkeeping only — owns no model or cache. ``submit`` enqueues (or
    rejects oversize), ``admit`` fills free slots from the scenario
    buckets, ``step``/``advance`` move slots forward and free finished
    ones. ``finished``/``rejected`` are append-only audit logs."""

    def __init__(self, n_slots: int, max_seq: int):
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.slots = [Slot() for _ in range(n_slots)]
        self.finished: list[int] = []
        self.rejected: list[int] = []
        # scenario key -> FIFO of queued requests. A dict preserves
        # insertion order; _next() picks by oldest head, not dict order.
        self.buckets: dict[str, deque[QueuedRequest]] = {}
        #: Bucket admissions are currently drawing from (sticky until it
        #: empties, so slots keep sharing a scenario).
        self.active_scenario: str | None = None
        #: Times admission moved to a different bucket (telemetry: each
        #: switch is a likely config/compile change for the next launch).
        self.scenario_switches = 0
        self._arrivals = 0

    # -- intake --------------------------------------------------------------

    def submit(self, request_id: int, prompt_len: int,
               max_new_tokens: int, scenario: str = "") -> bool:
        """Enqueue a request into its scenario bucket; False (and logged
        in ``rejected``) if it cannot ever fit the arena."""
        if prompt_len + max_new_tokens > self.max_seq:
            self.rejected.append(request_id)
            return False
        bucket = self.buckets.setdefault(str(scenario), deque())
        bucket.append(QueuedRequest(request_id, prompt_len, max_new_tokens,
                                    str(scenario), self._arrivals))
        self._arrivals += 1
        return True

    # -- admission -----------------------------------------------------------

    def _oldest_bucket(self) -> str | None:
        live = [(q[0].seq, name) for name, q in self.buckets.items() if q]
        if not live:
            return None
        return min(live)[1]

    def _next(self, arena_pos: int) -> QueuedRequest | None:
        """Pop the next admissible request: stay on the active bucket
        until it drains, then switch to the bucket whose head arrived
        first. Head-of-line within the bucket: if the head does not fit
        the remaining arena, nothing is admitted (no skipping)."""
        name = self.active_scenario
        if name is None or not self.buckets.get(name):
            name = self._oldest_bucket()
            if name is None:
                return None
            if self.active_scenario is not None \
                    and name != self.active_scenario:
                self.scenario_switches += 1
            self.active_scenario = name
        head = self.buckets[name][0]
        if arena_pos + head.prompt_len + head.max_new_tokens > self.max_seq:
            return None
        return self.buckets[name].popleft()

    def admit(self, arena_pos: int = 0) -> list[tuple[int, int, int]]:
        """Fill free slots from the scenario buckets.

        ``arena_pos`` is the caller's arena write cursor (token-level
        engines); a request needing more arena than remains blocks
        head-of-line. Cohort callers leave it 0 (whole arena free).
        Returns [(slot_idx, request_id, prompt_len)] needing prefill."""
        admitted = []
        for i, s in enumerate(self.slots):
            if s.active:
                continue
            nxt = self._next(arena_pos)
            if nxt is None:
                break
            self.slots[i] = Slot(request_id=nxt.request_id,
                                 pos=nxt.prompt_len,
                                 max_pos=nxt.prompt_len + nxt.max_new_tokens,
                                 active=True, scenario=nxt.scenario,
                                 start=arena_pos)
            admitted.append((i, nxt.request_id, nxt.prompt_len))
        return admitted

    # -- progress ------------------------------------------------------------

    def advance(self, slot_idx: int) -> int | None:
        """Advance one slot by one token; frees the slot and returns the
        request id when it finishes (else None). Token-level engines call
        this per slot per generated token — slots still being prefilled
        are simply not advanced that step."""
        s = self.slots[slot_idx]
        if not s.active:
            return None
        s.pos += 1
        if s.pos >= s.max_pos:
            rid = s.request_id
            self.finished.append(rid)
            s.active = False
            s.request_id = None
            return rid
        return None

    def step(self) -> list[int]:
        """Advance every active slot one token (lock-step/cohort view);
        returns freed request ids."""
        freed = []
        for i, s in enumerate(self.slots):
            if s.active:
                rid = self.advance(i)
                if rid is not None:
                    freed.append(rid)
        return freed

    # -- introspection -------------------------------------------------------

    @property
    def queue(self) -> list[QueuedRequest]:
        """All queued requests in global arrival order (flattened view
        over the scenario buckets; read-only snapshot)."""
        out = [r for bucket in self.buckets.values() for r in bucket]
        out.sort(key=lambda r: r.seq)
        return out

    @property
    def queue_depth(self) -> int:
        return sum(len(bucket) for bucket in self.buckets.values())

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self.slots if s.active)

    def done(self) -> bool:
        return self.queue_depth == 0 and self.active_slots == 0
