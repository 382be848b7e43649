"""Versioned wisdom store — the on-disk unit of fleet distribution.

Port of ``repro.distrib.store``: the same files, byte for byte.

Beyond-paper (builds on the §4.4 wisdom-file format): a ``WisdomStore``
wraps one wisdom directory — the thing the paper's workflow ships between
machines — with schema awareness: enumerating kernels, loading through the
``WISDOM_VERSION`` migration path, refusing future-version files loudly,
validating every document, and pruning. It is the local endpoint the merge
engine (:mod:`.merge`) and sync transports (:mod:`.sync`) operate on.
"""

from __future__ import annotations

import datetime
import json
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.core.wisdom import (WISDOM_VERSION, Wisdom, WisdomRecord,
                                     WisdomVersionError, default_wisdom_dir,
                                     doc_version, migrate_doc)

WISDOM_SUFFIX = ".wisdom.json"

#: Default bound on the per-store LRU of loaded :class:`Wisdom` objects.
#: Serving touches a handful of kernels per process but PullSync re-loads
#: each one every pull interval; caching the parsed object (validated
#: against the file's stat signature) makes the steady state O(1) stat
#: calls instead of O(records) JSON parses per kernel per tick.
DEFAULT_CACHE_KERNELS = 16

#: Transport-name namespace reserved for non-wisdom control documents.
#: The fleet orchestrator (``repro.fleet``) publishes demand tables, job
#: specs, shard leases and shard results through the *same* transports
#: wisdom moves over, under names with this prefix. Kernel names must not
#: use it: ``WisdomStore.kernels`` (and so validate/prune/push) skips it,
#: and ``PullSync`` never merges it.
CONTROL_PREFIX = "fleet--"


@dataclass
class ValidationIssue:
    kernel: str          # kernel name ("" when not determinable)
    path: str
    problem: str

    def __str__(self) -> str:
        return f"{self.path}: {self.problem}"


@dataclass
class PruneReport:
    """What ``WisdomStore.prune`` removed, per kernel."""
    dropped: dict[str, int] = field(default_factory=dict)

    @property
    def total(self) -> int:
        return sum(self.dropped.values())


class WisdomStore:
    """A wisdom directory with schema versioning and fleet-merge support."""

    def __init__(self, root: Path | str | None = None,
                 cache_kernels: int = DEFAULT_CACHE_KERNELS):
        self.root = Path(root) if root is not None else default_wisdom_dir()
        # Bounded LRU of parsed wisdom: kernel -> (stat signature, Wisdom).
        # 0 disables caching entirely (every load re-parses).
        self.cache_kernels = int(cache_kernels)
        self._cache: OrderedDict[str, tuple[tuple | None, Wisdom]] = \
            OrderedDict()

    def __repr__(self) -> str:  # pragma: no cover
        return f"WisdomStore({str(self.root)!r})"

    # -- enumeration ---------------------------------------------------------

    def path_for(self, kernel_name: str) -> Path:
        return Wisdom.path_for(kernel_name, self.root)

    def kernels(self) -> list[str]:
        """Kernel names present in the store, sorted. Control documents
        (``CONTROL_PREFIX`` namespace) sharing the directory are not
        kernels and are excluded."""
        if not self.root.is_dir():
            return []
        return sorted(p.name[:-len(WISDOM_SUFFIX)]
                      for p in self.root.glob(f"*{WISDOM_SUFFIX}")
                      if not p.name.startswith(CONTROL_PREFIX))

    def __contains__(self, kernel_name: str) -> bool:
        return self.path_for(kernel_name).exists()

    def __len__(self) -> int:
        return len(self.kernels())

    # -- load/save -----------------------------------------------------------

    def _stat_key(self, kernel_name: str) -> tuple | None:
        """File identity signature the cache is validated against (None
        when the file is absent). Any writer — this process or another —
        that lands a new file changes (mtime_ns, size, inode) and the
        next load re-parses; ``DirectoryTransport.publish`` and external
        tools therefore cannot serve a stale cache entry."""
        try:
            st = self.path_for(kernel_name).stat()
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    def _remember(self, kernel_name: str, key: tuple | None,
                  wisdom: Wisdom) -> None:
        self._cache[kernel_name] = (key, wisdom)
        self._cache.move_to_end(kernel_name)
        while len(self._cache) > self.cache_kernels:
            self._cache.popitem(last=False)

    def load(self, kernel_name: str) -> Wisdom:
        """Load one kernel's wisdom (empty if absent), migrating old schema
        versions in memory and refusing future ones loudly.

        Cached: repeat loads of an unchanged file return the *same*
        parsed :class:`Wisdom` (and its select index) from a bounded LRU,
        validated against the file's stat signature. Callers share the
        object — the in-repo contract is load → mutate → :meth:`save`
        (which refreshes the cache) or read-only use, so sharing is safe;
        a caller wanting an isolated copy goes through
        :meth:`invalidate_cache` or ``Wisdom.load`` directly."""
        if self.cache_kernels <= 0:
            return Wisdom.load(kernel_name, self.root)
        key = self._stat_key(kernel_name)
        hit = self._cache.get(kernel_name)
        from repro_torch.obs import runtime as obs_runtime
        m = obs_runtime.metrics()
        if hit is not None and hit[0] == key:
            self._cache.move_to_end(kernel_name)
            if m is not None:
                m.counter("store.cache", outcome="hit").inc()
            return hit[1]
        wisdom = Wisdom.load(kernel_name, self.root)
        self._remember(kernel_name, key, wisdom)
        if m is not None:
            m.counter("store.cache", outcome="miss").inc()
        return wisdom

    def invalidate_cache(self, kernel_name: str | None = None) -> None:
        """Drop cached parsed wisdom (one kernel, or everything). Only
        needed when a caller wants a private copy or has mutated a loaded
        object without saving it."""
        if kernel_name is None:
            self._cache.clear()
        else:
            self._cache.pop(kernel_name, None)

    def load_doc(self, kernel_name: str) -> dict | None:
        """Raw JSON document for one kernel, or None if absent. No version
        check — for inspection and migration tooling."""
        path = self.path_for(kernel_name)
        if not path.exists():
            return None
        with open(path) as f:
            return json.load(f)

    def save(self, wisdom: Wisdom) -> Path:
        path = wisdom.save(self.root)
        if self.cache_kernels > 0:
            # The object we just wrote IS the freshest parse of the file:
            # re-key the cache to the new stat signature instead of
            # forcing the next load to re-parse what we already hold.
            self._remember(wisdom.kernel_name,
                           self._stat_key(wisdom.kernel_name), wisdom)
        return path

    def version_of(self, kernel_name: str) -> int | None:
        doc = self.load_doc(kernel_name)
        return None if doc is None else doc_version(doc)

    # -- maintenance ---------------------------------------------------------

    def validate(self) -> list[ValidationIssue]:
        """Check every wisdom file; returns [] when the store is healthy.

        Flags unreadable JSON, future schema versions, kernel/filename
        mismatches, and records missing required fields. Never raises — the
        point is a complete report, not the first failure.
        """
        issues: list[ValidationIssue] = []
        for name in self.kernels():
            path = self.path_for(name)
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                issues.append(ValidationIssue(name, str(path),
                                              f"unreadable JSON: {e}"))
                continue
            if not isinstance(doc, dict):
                issues.append(ValidationIssue(
                    name, str(path),
                    f"not a JSON object (got {type(doc).__name__})"))
                continue
            if doc.get("kernel") != name:
                issues.append(ValidationIssue(
                    name, str(path),
                    f"kernel field {doc.get('kernel')!r} does not match "
                    f"filename"))
            try:
                doc = migrate_doc(doc, source=str(path))
            except WisdomVersionError as e:
                issues.append(ValidationIssue(name, str(path), str(e)))
                continue
            for i, rec in enumerate(doc.get("records", [])):
                try:
                    WisdomRecord.from_json(rec)
                except (KeyError, TypeError, ValueError) as e:
                    issues.append(ValidationIssue(
                        name, str(path), f"record #{i} malformed: {e!r}"))
        return issues

    def migrate(self) -> list[str]:
        """Rewrite every old-version file at the current ``WISDOM_VERSION``.

        Returns the kernels migrated. Current-version files are left
        untouched (byte-stable); future-version files raise
        :class:`WisdomVersionError` so an old binary can never downgrade a
        newer fleet's store in place.
        """
        migrated = []
        for name in self.kernels():
            doc = self.load_doc(name)
            if doc_version(doc) == WISDOM_VERSION:
                continue
            self.save(Wisdom(name, [
                WisdomRecord.from_json(r)
                for r in migrate_doc(doc, str(self.path_for(name)))["records"]
            ]))
            migrated.append(name)
        return migrated

    def prune(self, kernel: str | None = None,
              max_age_days: float | None = None,
              device_kind: str | None = None) -> PruneReport:
        """Drop redundant records: non-best duplicates per scenario always;
        optionally records older than ``max_age_days`` or for devices other
        than ``device_kind``. Kernel files left empty are removed."""
        cutoff = None
        if max_age_days is not None:
            cutoff = (datetime.datetime.now(datetime.timezone.utc)
                      - datetime.timedelta(days=max_age_days)).isoformat()
        report = PruneReport()
        for name in ([kernel] if kernel is not None else self.kernels()):
            wisdom = self.load(name)
            before = len(wisdom)
            kept = Wisdom(name)
            for rec in wisdom.records:
                if device_kind is not None and rec.device_kind != device_kind:
                    continue
                if cutoff is not None:
                    date = str(rec.provenance.get("date", ""))
                    if date and date < cutoff:
                        continue
                kept.add(rec)           # keep_best dedups per scenario
            dropped = before - len(kept)
            if dropped:
                report.dropped[name] = dropped
                if len(kept):
                    self.save(kept)
                else:
                    self.path_for(name).unlink()
        return report
