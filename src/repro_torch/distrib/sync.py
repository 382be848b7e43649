"""Wisdom sync: move tuning results between a host and the fleet.

Port of ``repro.distrib.sync``: the same transports, the same documents
byte for byte, the same counters. Beyond-paper (the distribution step
the paper leaves to "ship the JSON files"): a *transport* is anywhere
wisdom documents can be published and fetched — a shared directory (NFS
mount, object-store FUSE, rsync target) via :class:`DirectoryTransport`,
or an in-process dict via :class:`MemoryTransport` for deterministic
tests. On top of a transport:

* :class:`PushSync` publishes local wisdom, merging into what the fleet
  already has (never clobbering a better remote record), and gives the
  online promotion pipeline its ``broadcast`` hook so a confident winner
  leaves the machine the moment it is promoted;
* :class:`PullSync` merges fleet wisdom into the local store and refreshes
  attached ``WisdomKernel`` selection caches; its :meth:`PullSync.tick` is
  cheap enough to call every decode step (``ServeEngine`` does), actually
  pulling only every ``interval`` ticks. A pull runs on the caller's
  host thread; it reads files and launches nothing.

Both directions go through the merge engine, so sync is idempotent,
order-independent, and can only ever improve a store.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from pathlib import Path
from typing import Protocol

from repro_torch.core.wisdom import Wisdom, WisdomRecord, migrate_doc
from repro_torch.obs import runtime as obs

from .merge import MergeReport, merge_wisdom
from .store import CONTROL_PREFIX, WISDOM_SUFFIX, WisdomStore


class Transport(Protocol):
    """Where the fleet's wisdom lives, reduced to three operations.

    Names are usually kernel names, but the ``CONTROL_PREFIX`` namespace
    is reserved for the fleet orchestrator's control documents (demand,
    jobs, leases, results) — transports must round-trip those names too;
    the wisdom sync layer simply skips them.
    """

    def list_kernels(self) -> list[str]: ...

    def fetch(self, kernel_name: str) -> dict | None: ...

    def publish(self, kernel_name: str, doc: dict) -> None: ...


class DirectoryTransport:
    """A shared directory of wisdom files as the fleet rendezvous point."""

    def __init__(self, root: Path | str):
        self.store = WisdomStore(root)

    def list_kernels(self) -> list[str]:
        # The raw transport view: control documents included (the store's
        # own kernels() hides them from the wisdom layer).
        root = self.store.root
        if not root.is_dir():
            return []
        return sorted(p.name[:-len(WISDOM_SUFFIX)]
                      for p in root.glob(f"*{WISDOM_SUFFIX}"))

    def fetch(self, kernel_name: str) -> dict | None:
        return self.store.load_doc(kernel_name)

    def publish(self, kernel_name: str, doc: dict) -> None:
        path = self.store.path_for(kernel_name)
        path.parent.mkdir(parents=True, exist_ok=True)
        # Unlike the single-writer local Wisdom.save, a shared directory
        # has many hosts publishing concurrently: the tmp name must be
        # unique per writer or interleaved writes to the same tmp file
        # could get renamed into place as corrupt JSON.
        fd, tmp = tempfile.mkstemp(prefix=f".{kernel_name}.",
                                   suffix=".tmp", dir=path.parent)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
            os.replace(tmp, path)  # atomic
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise

    def __repr__(self) -> str:  # pragma: no cover
        return f"DirectoryTransport({str(self.store.root)!r})"


class MemoryTransport:
    """In-process transport: {kernel: doc}. Deterministic tests, and the
    reference for what a networked transport must implement."""

    def __init__(self):
        self.docs: dict[str, dict] = {}
        self.publishes = 0
        self.fetches = 0

    def list_kernels(self) -> list[str]:
        return sorted(self.docs)

    def fetch(self, kernel_name: str) -> dict | None:
        self.fetches += 1
        doc = self.docs.get(kernel_name)
        return json.loads(json.dumps(doc)) if doc is not None else None

    def publish(self, kernel_name: str, doc: dict) -> None:
        self.publishes += 1
        self.docs[kernel_name] = json.loads(json.dumps(doc))


def transport_wisdom(transport: Transport, kernel_name: str) -> Wisdom:
    """One kernel's wisdom as the transport currently holds it (empty when
    the fleet has none), migrated to the current schema."""
    doc = transport.fetch(kernel_name)
    if doc is None:
        return Wisdom(kernel_name)
    doc = migrate_doc(doc, source=f"<transport:{kernel_name}>")
    return Wisdom(kernel_name,
                  [WisdomRecord.from_json(r) for r in doc.get("records", [])])


_remote_wisdom = transport_wisdom


class PushSync:
    """Publish local wisdom to the fleet, merge-on-write."""

    def __init__(self, store: WisdomStore, transport: Transport):
        self.store = store
        self.transport = transport

    def push(self, kernel_name: str | None = None) -> MergeReport:
        """Merge local wisdom into the transport's copy and publish.

        Fetch-merge-publish rather than blind upload: a slow host must not
        overwrite a faster record some other host already published.
        """
        report = MergeReport()
        names = ([kernel_name] if kernel_name is not None
                 else self.store.kernels())
        for name in names:
            merged = merge_wisdom(self.store.load(name),
                                  _remote_wisdom(self.transport, name),
                                  report=report)
            self.transport.publish(name, merged.to_doc())
        m = obs.metrics()
        if m is not None:
            m.counter("sync.ops", direction="push").inc()
            m.counter("sync.records",
                      direction="push").inc(report.records_out)
        return report

    def broadcast(self, kernel_name: str, record: WisdomRecord) -> None:
        """Publish one newly-promoted record (the online pipeline's hook).

        Merging a single record is what makes broadcasting safe to run on
        the serving path's promotion tail: one fetch, one publish, and the
        fleet copy still only ever improves.
        """
        merged = merge_wisdom(Wisdom(kernel_name, [record]),
                              _remote_wisdom(self.transport, kernel_name))
        self.transport.publish(kernel_name, merged.to_doc())
        m = obs.metrics()
        if m is not None:
            m.counter("sync.ops", direction="broadcast").inc()
            m.counter("sync.records", direction="broadcast").inc()


class PullSync:
    """Merge fleet wisdom into the local store, hot-refreshing kernels."""

    def __init__(self, store: WisdomStore, transport: Transport,
                 kernels: list | None = None, interval: int = 64):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.store = store
        self.transport = transport
        #: WisdomKernel objects whose selection caches are refreshed after a
        #: pull that changed their kernel's wisdom.
        self.kernels = list(kernels or [])
        self.interval = interval
        self.pulls = 0
        self.failures = 0
        self.last_error: Exception | None = None
        self._ticks = 0

    def attach(self, kernel) -> None:
        self.kernels.append(kernel)

    def pull(self) -> MergeReport:
        """Fetch every fleet kernel and merge into the local store.

        Two-phase: every transport fetch and in-memory merge completes
        *before* the first local write. A transport that dies mid-pull
        (shared mount hiccup, truncated document) therefore raises with
        the local store byte-identical to its pre-pull state — serving
        hosts never select from a half-synced store.
        """
        report = MergeReport()
        staged: list[Wisdom] = []
        for name in self.transport.list_kernels():
            if name.startswith(CONTROL_PREFIX):
                continue        # fleet control documents are not wisdom
            local = self.store.load(name)
            before = json.dumps(local.to_doc(), sort_keys=True)
            merged = merge_wisdom(local, _remote_wisdom(self.transport, name),
                                  report=report)
            # Full-document comparison: even a lineage-only difference
            # (same winners, pooled provenance history) must be persisted.
            if json.dumps(merged.to_doc(), sort_keys=True) != before:
                staged.append(merged)
        changed: set[str] = set()
        for merged in staged:       # all fetches succeeded: now persist
            self.store.save(merged)
            changed.add(merged.kernel_name)
        self.pulls += 1
        for k in self.kernels:
            if k.builder.name in changed:
                k.refresh_wisdom()
        m = obs.metrics()
        if m is not None:
            m.counter("sync.ops", direction="pull").inc()
            m.counter("sync.records",
                      direction="pull").inc(report.records_out)
            m.counter("sync.kernels_changed").inc(len(changed))
        return report

    def tick(self) -> MergeReport | None:
        """Serving-loop hook: pulls on every ``interval``-th call (first
        call included, so a fresh engine starts from fleet wisdom).

        Failure-isolated: a raising transport must not kill the decode
        step that sponsored the tick, so errors are swallowed here —
        counted in ``failures``, the exception kept in ``last_error`` —
        and the previously served wisdom stays in effect until the next
        due tick retries. Callers who need the error should call
        :meth:`pull` directly.
        """
        due = self._ticks % self.interval == 0
        self._ticks += 1
        if not due:
            return None
        try:
            return self.pull()
        except Exception as e:  # noqa: BLE001 — serving must outlive sync
            self.failures += 1
            self.last_error = e
            m = obs.metrics()
            if m is not None:
                m.counter("sync.failures", direction="pull").inc()
            return None
