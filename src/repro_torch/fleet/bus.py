"""Control bus: typed fleet-control channels over a wisdom Transport.

The orchestrator needs to move four kinds of control documents between
workers and the coordinator: demand snapshots, job specs, shard leases,
and shard results. Rather than invent a second rendezvous mechanism, they
ride the *same* :class:`~repro_torch.distrib.sync.Transport` the wisdom files
do — a shared directory (or the in-memory test transport) the operator
already has — under the reserved ``CONTROL_PREFIX`` namespace the wisdom
sync layer skips. One mount point, one permission model, one thing to
rsync.

Names are ``fleet--<channel>--<name>``; ``name`` must be filename-safe
(the directory transport stores one file per document).

Time is injected (:class:`Clock`) so lease expiry — the one place the
orchestrator depends on wall clock — is deterministic under test
(:class:`ManualClock`) and real in production (:class:`WallClock`).
"""

from __future__ import annotations

import re
import time
from typing import Protocol

from repro_torch.distrib.store import CONTROL_PREFIX
from repro_torch.distrib.sync import Transport

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")
_SEP = "--"

#: Channels the orchestrator uses (documentation; the bus accepts any
#: filename-safe channel string). ``latency`` carries serving hosts'
#: observed per-scenario latencies — the signal the coordinator checks
#: transferred records' predictions against (repro_torch.transfer);
#: ``metrics`` carries per-host observability snapshots
#: (repro_torch.fleet.health) the coordinator merges into fleet-wide health.
CHANNELS = ("demand", "job", "lease", "state", "result", "done", "latency",
            "metrics")


def _check(kind: str, value: str) -> str:
    if not _NAME_RE.match(value) or _SEP in value:
        raise ValueError(f"{kind} {value!r} is not transport-safe "
                         f"(allowed: [A-Za-z0-9._-], no {_SEP!r})")
    return value


class Clock(Protocol):
    """Injectable time source: anything with ``now() -> float`` seconds.

    The orchestrator touches wall clock in exactly one place — lease
    expiry — and always through this protocol, so production uses
    :class:`WallClock` and tests drive expiry deterministically with a
    :class:`ManualClock`. Example: ``claim_shard(bus, job, "s000",
    "w1", clock)``.
    """

    def now(self) -> float: ...


class WallClock:
    """Real time (``time.time``) — the production :class:`Clock`.

    The default everywhere a clock is optional; only tests and the
    deterministic local harness substitute something else.
    Example: ``FleetWorker(bus, "host-1", clock=WallClock())``.
    """

    def now(self) -> float:
        return time.time()


class ManualClock:
    """Logical time advanced explicitly — the deterministic :class:`Clock`.

    ``advance(dt)`` is the only way time moves, which makes lease
    expiry (and therefore crash-reclaim scheduling) a pure function of
    the test script rather than host speed.

    Example::

        clock = ManualClock()
        lease = claim_shard(bus, job, "s000", "w1", clock)
        clock.advance(LEASE_TTL_S + 1)      # w1's lease is now expired
    """

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


class ControlBus:
    """Publish/fetch/list fleet control documents on a transport.

    The single rendezvous abstraction of the orchestrator: demand
    snapshots, job specs, leases, checkpoints and results are all just
    JSON documents on named channels, stored through whatever wisdom
    :class:`~repro_torch.distrib.sync.Transport` the deployment already has
    (a shared directory in production, memory in tests) under the
    reserved ``fleet--`` namespace.

    Example::

        bus = ControlBus(DirectoryTransport("/mnt/shared/wisdom"))
        bus.publish("demand", "host-1", {"worker": "host-1", ...})
        docs = bus.docs("demand")
    """

    def __init__(self, transport: Transport):
        self.transport = transport

    @staticmethod
    def key(channel: str, name: str) -> str:
        return CONTROL_PREFIX + _check("channel", channel) + _SEP + name

    def publish(self, channel: str, name: str, doc: dict) -> None:
        _check("name", name.replace(_SEP, "."))   # segments must be safe
        self.transport.publish(self.key(channel, name), doc)

    def fetch(self, channel: str, name: str) -> dict | None:
        return self.transport.fetch(self.key(channel, name))

    def names(self, channel: str) -> list[str]:
        """Document names present on ``channel``, sorted."""
        prefix = CONTROL_PREFIX + _check("channel", channel) + _SEP
        return sorted(n[len(prefix):]
                      for n in self.transport.list_kernels()
                      if n.startswith(prefix))

    def docs(self, channel: str) -> list[dict]:
        """Every document on ``channel``, in name order (skipping any that
        vanished between list and fetch — transports are shared)."""
        out = []
        for name in self.names(channel):
            doc = self.fetch(channel, name)
            if doc is not None:
                out.append(doc)
        return out
