"""Fleet-scale wisdom distribution (beyond-paper, builds on §4.4), the port
of ``repro.distrib``:

* :mod:`.store` — :class:`WisdomStore`: a wisdom directory with schema
  versioning (``WISDOM_VERSION``), migration, validation, pruning;
* :mod:`.merge` — combine stores from many hosts, statistical winner per
  (device, problem, dtype) scenario, provenance preserved as lineage;
* :mod:`.sync`  — pluggable transports (directory, in-memory) with
  :class:`PushSync` (publish / promotion broadcast) and :class:`PullSync`
  (periodic fleet pull, wired into ``ServeEngine``);
* :mod:`.cli`   — the ``python -m repro_torch.wisdom`` operator tool
  (inspect/diff/merge/prune/validate/migrate).

Files, merge results and CLI output are the reference's byte for byte;
provenance carries ``torch_version`` where the reference's carries
``jax_version``.
"""

from .merge import MergeReport, better_record, merge_stores, merge_wisdom
from .store import CONTROL_PREFIX, PruneReport, ValidationIssue, WisdomStore
from .sync import (DirectoryTransport, MemoryTransport, PullSync, PushSync,
                   Transport, transport_wisdom)

__all__ = [
    "MergeReport", "better_record", "merge_stores", "merge_wisdom",
    "CONTROL_PREFIX", "PruneReport", "ValidationIssue", "WisdomStore",
    "DirectoryTransport", "MemoryTransport", "PullSync", "PushSync",
    "Transport", "transport_wisdom",
]
