"""Fleet-scale wisdom distribution (beyond-paper, builds on §4.4), the port
of ``repro.distrib``:

* :mod:`.store` — :class:`WisdomStore`: a wisdom directory with schema
  versioning (``WISDOM_VERSION``), migration, validation, pruning;
* :mod:`.merge` — combine stores from many hosts, statistical winner per
  (device, problem, dtype) scenario, provenance preserved as lineage.

Files and merge results are the reference's byte for byte. The sync
transports (``repro.distrib.sync``) and the ``wisdom`` operator CLI
(``repro.distrib.cli``) are not ported yet (ROADMAP.md queue 1 item 13).
"""

from .merge import MergeReport, better_record, merge_stores, merge_wisdom
from .store import CONTROL_PREFIX, PruneReport, ValidationIssue, WisdomStore

__all__ = [
    "MergeReport", "better_record", "merge_stores", "merge_wisdom",
    "CONTROL_PREFIX", "PruneReport", "ValidationIssue", "WisdomStore",
]
