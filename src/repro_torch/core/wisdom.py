"""Wisdom files (paper §4.4) and runtime selection heuristic (paper §4.5).

The port of ``repro.core.wisdom``. The on-disk format is the same (version
2), so a file written by either package loads in the other, and
:meth:`Wisdom.select_record` picks the same record in the same tier.
Provenance records the torch and CUDA versions where the reference records
``jax_version``. The port's default wisdom directory is its own
(``./wisdom-torch``): the reference's fallback tiers serve records from any
device, and a TPU config means nothing to a CUDA kernel.

A wisdom file is a human-readable JSON document per kernel holding one record
per tuning session: the best configuration found for one (device, problem
size, dtype) *scenario*, plus provenance. Re-tuning appends/refreshes records.

Beyond the paper, the format is *versioned* (``WISDOM_VERSION``, with a
migration path for old files and a loud refusal of files from the future)
and each record carries a *lineage*: the provenance blocks of every record
it superseded, locally or during a fleet merge (``repro.distrib``). See
``docs/wisdom-format.md`` for the field-by-field schema.

Selection heuristic — the paper's §4.5 list, extended with dtype as a
scenario component (our precision analogue of the paper's float/double)
and with a *transfer* tier for cross-device predictions
(``repro.transfer``):

  1. measured record matching device kind AND problem size (preferring
     same dtype);
  2. else, a *transferred* record for this device kind and dtype whose
     confidence clears ``TRANSFER_MIN_CONFIDENCE`` (closest problem
     size) — predictions outrank scenario-distance fallback but never
     shadow a measurement;
  3. else, same device kind, problem size closest in Euclidean distance;
  4. else, same device *family*, closest problem size;
  5. else, any measured record, closest problem size;
  6. else (empty/missing wisdom), the default configuration.
"""

from __future__ import annotations

import datetime
import getpass
import hashlib
import json
import math
import os
import platform
import socket
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Sequence

import torch

from .device import get_device
from .scenario import SELECT_TIERS

# The canonical tier names live in core/scenario.py (shared with the
# online tracker's MISS_TIERS/HIT_TIERS and the observability report);
# select_record() produces exactly these, in exactly this order.
(T_EXACT, T_TRANSFER, T_DEVICE_DTYPE, T_DEVICE, T_FAMILY_DTYPE, T_FAMILY,
 T_ANY_DTYPE, T_ANY, T_DEFAULT) = SELECT_TIERS

#: Current on-disk schema version. v1: unversioned-or-``version: 1`` files
#: without lineage; v2 adds per-record ``lineage`` (provenance history).
WISDOM_VERSION = 2
WISDOM_DIR_ENV = "KERNEL_LAUNCHER_WISDOM_DIR"

#: Lineage entries kept per record after a merge (oldest dropped first).
LINEAGE_MAX = 16

#: Minimum transfer confidence a predicted record needs before
#: ``select_record`` will serve it. Calibrated against the shipped tpu-v5e -> tpu-v4 pair
#: (well above threshold) and tpu -> cpu (far below): see
#: ``repro.transfer.confidence`` and docs/transfer-tuning.md.
TRANSFER_MIN_CONFIDENCE = 0.30


class WisdomVersionError(ValueError):
    """A wisdom file declares a schema version this build cannot handle.

    Raised for files from the *future* (version > ``WISDOM_VERSION``):
    silently dropping or partially reading them could discard or corrupt
    fleet tuning results, so loading refuses loudly instead.
    """


def default_wisdom_dir() -> Path:
    return Path(os.environ.get(WISDOM_DIR_ENV, Path.cwd() / "wisdom-torch"))


def make_provenance(strategy: str = "", evals: int = 0,
                    objective: str = "") -> dict:
    """Provenance block stored with each record (paper §4.4).

    Every host lookup degrades to ``"unknown"`` instead of raising: a
    wisdom write must never crash over missing provenance cosmetics.
    """
    try:
        user = getpass.getuser()
    except (KeyError, OSError):  # pragma: no cover - no passwd entry
        user = "unknown"
    try:
        host = socket.gethostname()
    except OSError:  # pragma: no cover
        host = "unknown"
    return {
        "date": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "host": host,
        "user": user,
        "platform": platform.platform(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "strategy": strategy,
        "evaluations": evals,
        "objective": objective,
    }


def make_fleet_provenance(strategy: str, evals: int, objective: str,
                          job_id: str, n_shards: int,
                          round_: int = 0) -> dict:
    """Provenance for a coordinator-assembled fleet tuning record
    (``repro_torch.fleet``).

    Deterministic: no timestamp, host or user. A fleet job's result is a
    pure function of (demand, config space, evaluator), and any
    coordinator assembling the same shard results writes the same record
    (``record_id`` hashes provenance). The job id and shard count say
    where the number came from. The reference records ``jax_version``
    where the port records ``torch_version``.
    """
    return {
        "source": "fleet",
        "strategy": strategy,
        "evaluations": int(evals),
        "objective": objective,
        "job": job_id,
        "shards": int(n_shards),
        "round": int(round_),
        "torch_version": torch.__version__,
    }


def make_transfer_provenance(source_device: str, source_entries: int,
                             confidence: float, predicted_us: float,
                             predictor: str = "ridge+capability",
                             round_: int = 0,
                             backends: str = "") -> dict:
    """Provenance for a cross-device *transferred* record
    (``repro_torch.transfer``).

    Deterministic: no timestamp, host or user, so any host transferring the
    same recorded space to the same target writes the same record.
    ``confidence`` is the gate ``Wisdom.select_record`` applies before
    serving the prediction; ``predicted_us`` what observed latency is later
    held to. ``backends`` (e.g. ``"tpu->gpu"``) marks a cross-backend
    prediction and is absent for same-backend transfers. The reference
    records ``jax_version`` where the port records ``torch_version``.
    """
    prov = {
        "source": "transfer",
        "source_device": source_device,
        "source_entries": int(source_entries),
        "confidence": round(float(confidence), 6),
        "predicted_us": round(float(predicted_us), 6),
        "predictor": predictor,
        "round": int(round_),
        "torch_version": torch.__version__,
    }
    if backends:
        prov["backends"] = backends
    return prov


def merge_lineage(*records: "WisdomRecord", extra: Sequence[dict] = ()
                  ) -> list[dict]:
    """Combine the provenance history of ``records`` into one lineage list.

    Collects every record's own provenance plus its existing lineage,
    deduplicates, orders chronologically (ties broken by canonical JSON so
    the result is identical regardless of merge order), and keeps the most
    recent ``LINEAGE_MAX`` entries.
    """
    entries: list[dict] = []
    for r in records:
        if r.provenance:
            entries.append(dict(r.provenance))
        entries.extend(dict(e) for e in r.lineage)
    entries.extend(dict(e) for e in extra)
    seen: set[str] = set()
    unique: list[dict] = []
    for e in entries:
        key = json.dumps(e, sort_keys=True)
        if key not in seen:
            seen.add(key)
            unique.append(e)
    unique.sort(key=lambda e: (str(e.get("date", "")),
                               json.dumps(e, sort_keys=True)))
    return unique[-LINEAGE_MAX:]


@dataclass
class WisdomRecord:
    device_kind: str
    device_family: str
    problem_size: tuple[int, ...]
    dtype: str
    config: dict[str, Any]
    score_us: float                      # best objective value (lower=better)
    provenance: dict = field(default_factory=dict)
    #: Provenance blocks of records this one superseded (re-tune keep-best,
    #: fleet merge). Chronological, capped at LINEAGE_MAX. Schema v2.
    lineage: list[dict] = field(default_factory=list)

    def to_json(self) -> dict:
        d = asdict(self)
        d["problem_size"] = list(self.problem_size)
        return d

    @staticmethod
    def from_json(d: dict) -> "WisdomRecord":
        return WisdomRecord(
            device_kind=d["device_kind"],
            device_family=d["device_family"],
            problem_size=tuple(int(x) for x in d["problem_size"]),
            dtype=d["dtype"],
            config=dict(d["config"]),
            score_us=float(d["score_us"]),
            provenance=dict(d.get("provenance", {})),
            lineage=[dict(e) for e in d.get("lineage", [])],
        )

    def scenario(self) -> tuple:
        return (self.device_kind, self.problem_size, self.dtype)

    def evaluations(self) -> int:
        """Tuning-effort weight used for statistical tie-breaks in merges."""
        try:
            return int(self.provenance.get("evaluations", 0))
        except (TypeError, ValueError):
            return 0

    def is_transferred(self) -> bool:
        """True for records *predicted* by the cross-device transfer layer
        rather than measured. Transferred records live in their own
        selection tier (below exact, above scenario-distance fallback)
        and always lose to a measured record for the same scenario."""
        return self.provenance.get("source") == "transfer"

    def transfer_confidence(self) -> float:
        """The transfer predictor's confidence in [0, 1] (0.0 for
        measured records and malformed provenance): the quantity
        ``select`` gates on before serving a transferred record."""
        try:
            return float(self.provenance.get("confidence", 0.0))
        except (TypeError, ValueError):
            return 0.0

    def oracle_verified(self) -> dict | None:
        """The correctness-oracle provenance stamp, or None.

        Records promoted through a :class:`repro_torch.sandbox.OracleGate`
        carry ``provenance["verified"] = {"rtol", "atol", "ref"}``: the
        dtype-aware tolerances the config's output met against the named
        plain version. None means the record predates the gate or its
        kernel was unverifiable."""
        v = self.provenance.get("verified")
        return dict(v) if isinstance(v, dict) else None

    def record_id(self) -> str:
        """Stable content identity of this tuning result.

        Hash of scenario + config + score + provenance (lineage excluded:
        two hosts holding the same result with different merge histories
        still refer to the same record). Used for cross-store deduplication
        and as the last, fully deterministic merge tie-break. Cached — the
        identity fields are never mutated after construction (only
        ``lineage`` is, and it does not participate).
        """
        cached = self.__dict__.get("_record_id")
        if cached is not None:
            return cached
        body = json.dumps({
            "device_kind": self.device_kind,
            "device_family": self.device_family,
            "problem_size": list(self.problem_size),
            "dtype": self.dtype,
            "config": self.config,
            "score_us": self.score_us,
            "provenance": self.provenance,
        }, sort_keys=True)
        rid = hashlib.sha256(body.encode()).hexdigest()[:16]
        self.__dict__["_record_id"] = rid
        return rid


def _distance(a: Sequence[int], b: Sequence[int]) -> float:
    """Scale-normalized distance between problem sizes.

    Euclidean distance over per-dimension log2 ratios rather than raw
    extents: a 4096-wide axis would otherwise drown out every other
    dimension in the tier 2–4 nearest-scenario comparisons, making e.g. a
    2x change on a size-8 axis (which matters enormously for tiling) count
    for nothing next to a 5% change on the 4096 axis. Log ratios weigh
    relative change equally per dimension. Missing dimensions (rank
    mismatch) are padded with 1, i.e. treated as a degenerate axis.
    """
    n = max(len(a), len(b))
    a = tuple(a) + (1,) * (n - len(a))
    b = tuple(b) + (1,) * (n - len(b))
    return math.sqrt(sum(
        math.log2(max(x, 1) / max(y, 1)) ** 2 for x, y in zip(a, b)))


def _metrics():
    """The process metrics registry, or None (obs disabled).

    Imported lazily: ``repro_torch.obs`` imports
    ``repro_torch.core.scenario`` for its tier vocabulary, so a
    module-level import here could deadlock package initialization
    depending on which package is imported first."""
    from repro_torch.obs import runtime as obs_runtime
    return obs_runtime.metrics()


class WisdomIndex:
    """Hash index over one kernel's records — the §4.5 select hot path.

    ``Wisdom.select_record`` historically re-filtered every record per
    call, so select latency grew linearly with the store exactly as the
    fleet succeeded at filling it. The index buckets records once:

    * ``exact``: (device_kind, problem_size, dtype) → measured records,
      giving O(1) dict hops for the common serve-time exact hit;
    * one bucket family per fallback tier (device+dtype, device,
      family+dtype, family, dtype, all-measured), so a fallback select
      scans only its tier's candidates, not the whole store;
    * ``transferred``: (device_kind, dtype) → predicted records (the
      confidence gate stays per-query, it depends on the threshold);
    * ``scenario_slot``: scenario → first list position, which turns
      ``Wisdom.add``'s keep-best duplicate scan into one lookup.

    Buckets map ``id(record) → record`` so membership updates during
    ``add()`` are O(1) and iteration order stays insertion order (the
    tie-break never depends on it — selection orders by distance, score,
    record_id). The index is derived state: :meth:`Wisdom.index` rebuilds
    it whenever ``Wisdom.records`` was rebound or resized behind its
    back, so direct list mutation stays legal, just unindexed-until-read.
    """

    __slots__ = ("source", "size", "scenario_slot", "exact",
                 "by_device_dtype", "by_device", "by_family_dtype",
                 "by_family", "by_dtype", "measured", "transferred")

    def __init__(self, records: Sequence["WisdomRecord"] = ()):
        self.source = records          # identity-checked by Wisdom.index()
        self.size = 0
        self.scenario_slot: dict[tuple, int] = {}
        self.exact: dict[tuple, dict] = {}
        self.by_device_dtype: dict[tuple, dict] = {}
        self.by_device: dict[str, dict] = {}
        self.by_family_dtype: dict[tuple, dict] = {}
        self.by_family: dict[str, dict] = {}
        self.by_dtype: dict[str, dict] = {}
        self.measured: dict[int, "WisdomRecord"] = {}
        self.transferred: dict[tuple, dict] = {}
        for position, rec in enumerate(records):
            self.insert(rec, position)

    def insert(self, rec: "WisdomRecord", position: int) -> None:
        """Index ``rec`` living at ``records[position]``."""
        self.scenario_slot.setdefault(rec.scenario(), position)
        key = id(rec)
        if rec.is_transferred():
            self.transferred.setdefault(
                (rec.device_kind, rec.dtype), {})[key] = rec
        else:
            self.exact.setdefault(rec.scenario(), {})[key] = rec
            self.by_device_dtype.setdefault(
                (rec.device_kind, rec.dtype), {})[key] = rec
            self.by_device.setdefault(rec.device_kind, {})[key] = rec
            self.by_family_dtype.setdefault(
                (rec.device_family, rec.dtype), {})[key] = rec
            self.by_family.setdefault(rec.device_family, {})[key] = rec
            self.by_dtype.setdefault(rec.dtype, {})[key] = rec
            self.measured[key] = rec
        self.size += 1

    def replace(self, old: "WisdomRecord", new: "WisdomRecord",
                position: int) -> None:
        """Swap ``old`` for ``new`` at the same list position (keep-best
        resolution in :meth:`Wisdom.add`). ``scenario_slot`` is untouched:
        both records share the scenario and the position."""
        key = id(old)
        if old.is_transferred():
            self.transferred[(old.device_kind, old.dtype)].pop(key, None)
        else:
            self.exact[old.scenario()].pop(key, None)
            self.by_device_dtype[(old.device_kind, old.dtype)].pop(key, None)
            self.by_device[old.device_kind].pop(key, None)
            self.by_family_dtype[(old.device_family, old.dtype)].pop(
                key, None)
            self.by_family[old.device_family].pop(key, None)
            self.by_dtype[old.dtype].pop(key, None)
            self.measured.pop(key, None)
        self.size -= 1
        self.insert(new, position)


def doc_version(doc: dict) -> int:
    """Schema version a wisdom document declares (pre-versioning files
    count as v1)."""
    try:
        return int(doc.get("version", 1))
    except (TypeError, ValueError):
        raise WisdomVersionError(
            f"wisdom document declares non-integer version "
            f"{doc.get('version')!r}") from None


def migrate_doc(doc: dict, source: str = "<memory>") -> dict:
    """Migrate a wisdom document to the current ``WISDOM_VERSION``.

    Returns a new document (the input is not mutated). v1 -> v2 adds the
    empty per-record ``lineage`` list. Documents from a *newer* schema
    raise :class:`WisdomVersionError` — refusing loudly beats silently
    dropping fields a future writer considered essential.
    """
    version = doc_version(doc)
    if version > WISDOM_VERSION:
        raise WisdomVersionError(
            f"wisdom document {source} has version {version}, but this "
            f"build understands at most {WISDOM_VERSION}; upgrade before "
            f"loading it (records were NOT read)")
    out = json.loads(json.dumps(doc))     # deep copy, JSON-clean
    if version < 2:
        for rec in out.get("records", []):
            rec.setdefault("lineage", [])
    out["version"] = WISDOM_VERSION
    return out


class Wisdom:
    """All tuning results for one kernel (one file per kernel, paper §4.4)."""

    def __init__(self, kernel_name: str,
                 records: list[WisdomRecord] | None = None):
        self.kernel_name = kernel_name
        self.records: list[WisdomRecord] = list(records or [])
        self._index: WisdomIndex | None = None

    def index(self) -> WisdomIndex:
        """The :class:`WisdomIndex` over :attr:`records`, (re)built lazily.

        Staleness check: the index remembers which list object it was
        built from and how many records it indexed; rebinding ``records``
        or changing its length invalidates it. In-place *replacement*
        behind our back (``w.records[i] = other``) is not detected —
        every in-repo mutation goes through :meth:`add`, which maintains
        the index incrementally."""
        idx = self._index
        if (idx is None or idx.source is not self.records
                or idx.size != len(self.records)):
            idx = self._index = WisdomIndex(self.records)
        return idx

    # -- persistence ---------------------------------------------------------

    @staticmethod
    def path_for(kernel_name: str, wisdom_dir: Path | str | None = None) -> Path:
        d = Path(wisdom_dir) if wisdom_dir is not None else default_wisdom_dir()
        return d / f"{kernel_name}.wisdom.json"

    @staticmethod
    def load(kernel_name: str, wisdom_dir: Path | str | None = None) -> "Wisdom":
        path = Wisdom.path_for(kernel_name, wisdom_dir)
        if not path.exists():
            return Wisdom(kernel_name)
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(
                f"wisdom file {path} is not a JSON object "
                f"(got {type(doc).__name__})")
        if doc.get("kernel") != kernel_name:
            raise ValueError(
                f"wisdom file {path} is for kernel {doc.get('kernel')!r}, "
                f"not {kernel_name!r}")
        doc = migrate_doc(doc, source=str(path))
        recs = [WisdomRecord.from_json(r) for r in doc.get("records", [])]
        return Wisdom(kernel_name, recs)

    def to_doc(self) -> dict:
        return {
            "kernel": self.kernel_name,
            "version": WISDOM_VERSION,
            "records": [r.to_json() for r in self.records],
        }

    def save(self, wisdom_dir: Path | str | None = None) -> Path:
        path = Wisdom.path_for(self.kernel_name, wisdom_dir)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)  # atomic
        return path

    # -- mutation ------------------------------------------------------------

    def add(self, record: WisdomRecord, keep_best: bool = True) -> None:
        """Add a tuning result. If a record for the same scenario exists and
        ``keep_best``, keep whichever scored better (re-tuning semantics);
        the survivor absorbs both records' provenance into its lineage.

        The same-scenario lookup goes through the index's
        ``scenario_slot`` map (one dict hop), not a list scan, so bulk
        re-adds (fleet merge echoes, prune rebuilds) are O(1) per record
        instead of O(n)."""
        if keep_best:
            idx = self.index()
            i = idx.scenario_slot.get(record.scenario())
            if i is not None:
                r = self.records[i]
                if r.record_id() == record.record_id():
                    # Same result re-added (e.g. a sync echo): pool
                    # lineages only, keep re-adds a no-op otherwise.
                    if record.lineage != r.lineage:
                        r.lineage = merge_lineage(
                            extra=[*r.lineage, *record.lineage])
                    return
                # Measured beats transferred regardless of score (a
                # prediction must never displace a real measurement
                # — that is what verification jobs are for, see
                # repro.transfer); equal scores fall through to
                # record_id so the survivor is insertion-order
                # independent, like select_record() and better_record.
                winner, loser = ((record, r)
                                 if ((record.is_transferred(),
                                      record.score_us,
                                      -record.evaluations(),
                                      record.record_id())
                                     < (r.is_transferred(), r.score_us,
                                        -r.evaluations(),
                                        r.record_id()))
                                 else (r, record))
                winner.lineage = merge_lineage(winner, loser)
                self.records[i] = winner
                if winner is not r:
                    idx.replace(r, winner, i)
                return
            self.records.append(record)
            idx.insert(record, len(self.records) - 1)
            return
        self.records.append(record)
        # keep_best=False appends allow duplicate scenarios; extend the
        # index only if it is live and current, else let it rebuild.
        idx = self._index
        if (idx is not None and idx.source is self.records
                and idx.size == len(self.records) - 1):
            idx.insert(record, len(self.records) - 1)

    # -- selection (paper §4.5) ----------------------------------------------

    def select(self, device_kind: str, problem_size: Sequence[int],
               dtype: str, default_config: dict,
               min_transfer_confidence: float | None = None
               ) -> tuple[dict, str]:
        """Pick a config for a scenario. Returns (config, match_tier).
        Thin wrapper over :meth:`select_record` for callers that only
        need the config dict (``default_config`` where no record serves);
        callers that want the matched record itself (its score,
        provenance, transfer confidence) use ``select_record``."""
        rec, tier = self.select_record(device_kind, problem_size, dtype,
                                       min_transfer_confidence)
        if rec is None:
            return dict(default_config), tier
        return dict(rec.config), tier

    def select_record(self, device_kind: str, problem_size: Sequence[int],
                      dtype: str,
                      min_transfer_confidence: float | None = None
                      ) -> tuple["WisdomRecord | None", str]:
        """The §4.5 heuristic, returning the matched record itself.

        Returns (record, tier); record is None only for the "default"
        tier (empty/unusable wisdom), where the caller supplies its own
        default configuration.

        Measured records go through the paper's §4.5 fuzzy tiers.
        Transferred records (cross-device predictions) take part only in
        their own ``"transfer"`` tier, directly below ``"exact"``: same
        device kind and dtype, confidence at least
        ``min_transfer_confidence`` (default
        :data:`TRANSFER_MIN_CONFIDENCE`).

        Routed through :class:`WisdomIndex`: the exact tier is two dict
        hops, each fallback tier touches only its own candidates — select
        cost no longer grows with the store. ``tests/test_torch_core.py``
        holds it to ``repro.core.Wisdom.select_record`` on the same files.
        """
        problem = tuple(int(x) for x in problem_size)
        family = get_device(device_kind).family
        threshold = (TRANSFER_MIN_CONFIDENCE
                     if min_transfer_confidence is None
                     else float(min_transfer_confidence))
        idx = self.index()

        def best(cands) -> WisdomRecord | None:
            if not cands:
                return None
            # record_id as the last key: equal-distance equal-score
            # candidates must resolve the same way on every host, not by
            # whatever order records happened to be inserted or merged.
            return min(cands, key=lambda r: (_distance(r.problem_size,
                                                       problem),
                                             r.score_us, r.record_id()))

        empty: dict = {}
        transferred = [
            r for r in idx.transferred.get((device_kind, dtype),
                                           empty).values()
            if r.transfer_confidence() >= threshold]
        tiers = (
            (T_EXACT,
             idx.exact.get((device_kind, problem, dtype), empty).values()),
            (T_TRANSFER, transferred),
            (T_DEVICE_DTYPE,
             idx.by_device_dtype.get((device_kind, dtype), empty).values()),
            (T_DEVICE, idx.by_device.get(device_kind, empty).values()),
            (T_FAMILY_DTYPE,
             idx.by_family_dtype.get((family, dtype), empty).values()),
            (T_FAMILY, idx.by_family.get(family, empty).values()),
            (T_ANY_DTYPE, idx.by_dtype.get(dtype, empty).values()),
            (T_ANY, idx.measured.values()),
        )

        result: tuple[WisdomRecord | None, str] = (None, T_DEFAULT)
        for tier_name, cands in tiers:
            rec = best(cands)
            if rec is not None:
                result = (rec, tier_name)
                break
        m = _metrics()
        if m is not None:
            outcome = ("hit" if result[1] == T_EXACT
                       else "default" if result[0] is None else "fallback")
            m.counter("select.index_hit", kernel=self.kernel_name,
                      outcome=outcome).inc()
        return result

    def __len__(self) -> int:
        return len(self.records)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Wisdom({self.kernel_name!r}, {len(self.records)} records)"
