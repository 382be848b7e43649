"""Fleet wisdom merge engine: combine stores from many hosts into one.

Port of ``repro.distrib.merge``: the same winners and lineage, byte for
byte.

Beyond-paper (generalises the §4.4 re-tune keep-best rule to a fleet): the
paper's wisdom files are written by whoever tuned last on one machine; when
many hosts tune concurrently — offline sessions, online promotions — their
stores conflict. Following the aggregate-and-compare methodology of the
KTT line of work (Petrovič et al.) and the HIP auto-tuning study (Lurati
et al.), conflicts are resolved *statistically* per (device, problem,
dtype) scenario:

  1. lower measured ``score_us`` wins (the statistical winner);
  2. equal scores: the record with more recorded evaluations wins (more
     tuning effort behind the number -> more trustworthy);
  3. still equal: lowest ``record_id()`` wins — an arbitrary but fully
     deterministic pick, so every host merging the same inputs in any
     order converges to byte-identical wisdom.

No provenance is discarded: the surviving record's ``lineage`` absorbs the
provenance of every record it beat (see ``core.wisdom.merge_lineage``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.core.wisdom import Wisdom, WisdomRecord, merge_lineage

from .store import WisdomStore


@dataclass
class MergeReport:
    """Per-kernel accounting of one merge."""
    kernels: list[str] = field(default_factory=list)
    records_in: int = 0        # total records seen across all inputs
    records_out: int = 0       # records in the merged result
    conflicts: int = 0         # scenarios contested by >1 distinct record
    replaced: int = 0          # scenarios where a non-first input won

    def summary(self) -> str:
        return (f"{len(self.kernels)} kernel(s), {self.records_in} -> "
                f"{self.records_out} records, {self.conflicts} conflict(s), "
                f"{self.replaced} replaced")


def better_record(a: WisdomRecord, b: WisdomRecord) -> WisdomRecord:
    """The statistical winner of two same-scenario records (deterministic
    under argument swap). Also the rule the fleet coordinator applies to
    same-scenario shard winners, so assembly and merge can never disagree
    about which result survives.

    A *measured* record always beats a *transferred* one (predictions
    carry a score, but a prediction displacing a measurement would defeat
    the verification loop — see ``repro_torch.transfer``); two transferred
    records compete on the usual score/evaluations/id key.
    """
    ka = (a.is_transferred(), a.score_us, -a.evaluations(), a.record_id())
    kb = (b.is_transferred(), b.score_us, -b.evaluations(), b.record_id())
    return a if ka <= kb else b


_better = better_record


def merge_wisdom(*inputs: Wisdom, report: MergeReport | None = None) -> Wisdom:
    """Merge several kernels' worth of wisdom for the *same* kernel.

    Input order never affects the result (only which side the report counts
    as "replaced"). Inputs are not mutated.
    """
    if not inputs:
        raise ValueError("merge_wisdom needs at least one input")
    names = {w.kernel_name for w in inputs}
    if len(names) > 1:
        raise ValueError(f"refusing to merge wisdom of different kernels: "
                         f"{sorted(names)}")
    best: dict[tuple, WisdomRecord] = {}
    contested: set[tuple] = set()
    n_in = 0
    replaced = 0
    for w in inputs:
        for rec in w.records:
            n_in += 1
            key = rec.scenario()
            cur = best.get(key)
            if cur is None:
                best[key] = rec
                continue
            if cur.record_id() == rec.record_id():
                # Same result (e.g. already synced): pool the lineages
                # only. Folding the record's own provenance in here would
                # make merging a store with itself a lineage-growing
                # non-no-op, breaking pull/push idempotence.
                if rec.lineage != cur.lineage:
                    best[key] = replace(cur, lineage=merge_lineage(
                        extra=[*cur.lineage, *rec.lineage]))
                continue
            contested.add(key)
            winner = _better(cur, rec)
            if winner.record_id() != cur.record_id():
                replaced += 1
            best[key] = replace(winner, lineage=merge_lineage(cur, rec))
    merged = Wisdom(inputs[0].kernel_name,
                    sorted(best.values(),
                           key=lambda r: (r.scenario(), r.record_id())))
    if report is not None:
        report.kernels.append(merged.kernel_name)
        report.records_in += n_in
        report.records_out += len(merged)
        report.conflicts += len(contested)
        report.replaced += replaced
    return merged


def merge_stores(dest: WisdomStore, *sources: WisdomStore) -> MergeReport:
    """Merge ``sources`` into ``dest`` on disk, kernel by kernel.

    ``dest`` participates as an input (its existing records compete on
    equal terms), so repeated merges are idempotent.
    """
    report = MergeReport()
    kernels = set(dest.kernels())
    for src in sources:
        kernels.update(src.kernels())
    for name in sorted(kernels):
        inputs = [dest.load(name)] + [src.load(name) for src in sources]
        dest.save(merge_wisdom(*inputs, report=report))
    return report
