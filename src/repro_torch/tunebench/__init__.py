"""Recorded tuning-space datasets + simulated strategy benchmarking.

Port of ``repro.tunebench``: the same formats and reports, byte for byte,
with spaces recorded by wall clock on the card as well as by the cost
model. Beyond-paper subsystem. The paper's workflow (capture → tune →
wisdom) keeps only each tuning session's winner; this package keeps the whole
search: every ``(config, score, status)`` evaluation of a scenario lands
in a schema-versioned :class:`SpaceDataset`, a :class:`SimulatedRunner`
replays recorded spaces so all strategies run deterministically with
zero hardware, and the harness turns the replays into
fraction-of-optimum-vs-budget curves with per-strategy regression
thresholds — the dataset-driven methodology of the auto-tuning
benchmarking literature (Schoonhoven et al.; Tørring et al.).

* :mod:`.dataset`  — :class:`SpaceDataset` (versioned JSON, config-hash
  keys), :class:`DatasetStore`, recording and warm-start plumbing;
* :mod:`.simulate` — :class:`SimulatedRunner`: datasets as objectives;
* :mod:`.harness`  — :func:`compare`: strategies x datasets ->
  machine-readable report with thresholds;
* :mod:`.cli`      — ``python -m repro_torch.tunebench``
  (record / run / compare / report).

Docs: ``docs/tuning-datasets.md`` (format),
``docs/strategy-benchmarking.md`` (methodology).
"""

from .dataset import (DATASET_SUFFIX, DATASET_VERSION, DatasetStore,
                      DatasetVersionError, SpaceDataset, SpaceEvaluation,
                      dataset_doc_version, history_from_dataset,
                      migrate_dataset_doc, record_space)
from .harness import (DEFAULT_BUDGET, DEFAULT_SEEDS, DEFAULT_THRESHOLDS,
                      REPORT_VERSION, compare, dump_report, fraction_curve,
                      report_to_text, run_on_dataset)
from .simulate import DatasetMiss, SimulatedRunner

__all__ = [
    "DATASET_SUFFIX", "DATASET_VERSION", "DatasetStore",
    "DatasetVersionError", "SpaceDataset", "SpaceEvaluation",
    "dataset_doc_version", "history_from_dataset", "migrate_dataset_doc",
    "record_space",
    "DEFAULT_BUDGET", "DEFAULT_SEEDS", "DEFAULT_THRESHOLDS",
    "REPORT_VERSION", "compare", "dump_report", "fraction_curve",
    "report_to_text", "run_on_dataset",
    "DatasetMiss", "SimulatedRunner",
]
