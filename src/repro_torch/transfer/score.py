"""Transfer quality scoring against held-out ground truth.

Methodology (the held-out-device protocol of the cross-device tuning
literature): record a scenario's space on the *target* device, hide it
from the transfer engine, transfer from a *source* device's recorded
space, then look the chosen configs up in the hidden recording:

    fraction_of_optimum = target_optimum_us / score(chosen config)

1.0 means transfer found the target's true optimum; a config that is
infeasible (or unrecorded) on the target scores 0. The report compares
the transfer tier against the *cold fallback* — what ``Wisdom.select``
would serve with no transferred record, i.e. the scenario-distance
fallback onto source-device wisdom — which is exactly the baseline a
device family without tuning runs degrades to today.
"""

from __future__ import annotations

import json

from repro_torch.core.device import get_device
from repro_torch.core.param import Config
from repro_torch.core.wisdom import Wisdom, WisdomRecord, make_provenance
from repro_torch.tunebench.dataset import SpaceDataset

from .predictor import transfer_scenario

__all__ = ["fraction_of_optimum", "holdout_report", "dump_holdout_report"]

#: Report schema version (bump on structural changes).
HOLDOUT_REPORT_VERSION = 1


def fraction_of_optimum(dataset: SpaceDataset, config: Config
                        ) -> float | None:
    """How close ``config`` comes to ``dataset``'s recorded optimum.

    Returns ``optimum_us / score_us`` in (0, 1] for a feasible recorded
    config, 0.0 for one the dataset knows to be infeasible (or never
    recorded — on an exhaustively recorded space that means restricted),
    and None when the dataset has no feasible entry at all.
    """
    best = dataset.best()
    if best is None:
        return None
    entry = dataset.lookup(config)
    if entry is None or not entry.feasible:
        return 0.0
    return best.score_us / entry.score_us


def _measured_record(dataset: SpaceDataset) -> WisdomRecord:
    """The wisdom record a tuning session on ``dataset``'s device would
    have written (its recorded optimum), with deterministic provenance."""
    best = dataset.best()
    if best is None:
        raise ValueError(f"dataset {dataset.name()} has no feasible entry")
    prov = make_provenance(strategy="exhaustive",
                           evals=len(dataset.evaluations),
                           objective=dataset.objective)
    # Determinism: strip the host/time fields make_provenance collected.
    prov = {k: prov[k] for k in ("strategy", "evaluations", "objective")}
    prov["source"] = "recorded"
    dev = get_device(dataset.device_kind)
    return WisdomRecord(
        device_kind=dev.kind, device_family=dev.family,
        problem_size=tuple(dataset.problem_size), dtype=dataset.dtype,
        config=dict(best.config), score_us=round(best.score_us, 6),
        provenance=prov)


def holdout_report(source: SpaceDataset, truth: SpaceDataset,
                   builder=None) -> dict:
    """Score one held-out-device transfer: source space -> target truth.

    ``truth`` is the target device's recording of the *same* kernel,
    problem size and dtype (recorded for evaluation, hidden from the
    predictor). The report carries the fraction-of-optimum reached by
    the transferred config, by the cold scenario-distance fallback, and
    by the default config, plus the selection tiers that produced them —
    all deterministic, no timestamps.

    Example::

        report = holdout_report(v5e_dataset, v4_dataset)
        assert report["transfer"]["fraction"] >= 0.8
    """
    if (source.kernel, tuple(source.problem_size), source.dtype) != \
            (truth.kernel, tuple(truth.problem_size), truth.dtype):
        raise ValueError(
            f"source {source.name()} and truth {truth.name()} are not the "
            f"same (kernel, problem, dtype) scenario")
    result = transfer_scenario(source, truth.device_kind, builder=builder)
    wisdom = Wisdom(source.kernel, [_measured_record(source)])
    if result.eligible():
        wisdom.add(result.record())
    default = truth.space().default_config()

    def scored(min_conf: float | None) -> dict:
        cfg, tier = wisdom.select(
            truth.device_kind, truth.problem_size, truth.dtype, default,
            min_transfer_confidence=min_conf)
        frac = fraction_of_optimum(truth, cfg)
        entry = truth.lookup(cfg)
        return {
            "tier": tier,
            "config": dict(cfg),
            "fraction": round(frac, 6) if frac is not None else None,
            "score_us": (round(entry.score_us, 6)
                         if entry is not None and entry.feasible else None),
        }

    optimum = truth.best()
    return {
        "version": HOLDOUT_REPORT_VERSION,
        "kernel": source.kernel,
        "scenario": truth.scenario_key(),
        "source_device": source.device_kind,
        "target_device": truth.device_kind,
        "confidence": result.confidence,
        "components": dict(result.components),
        "optimum_us": (round(optimum.score_us, 6)
                       if optimum is not None else None),
        "transfer": scored(None),
        # min_transfer_confidence=2.0 disables the transfer tier (no
        # confidence reaches 2): exactly the cold pre-transfer behavior.
        "fallback": scored(2.0),
        "default": {
            "config": dict(default),
            "fraction": (round(fraction_of_optimum(truth, default), 6)
                         if optimum is not None else None),
        },
    }


def dump_holdout_report(report: dict) -> str:
    """Canonical byte form of a holdout report (sorted keys, two-space
    indent, trailing newline) — byte-identical for equal reports, which
    is what the port's tests assert against the reference's."""
    return json.dumps(report, indent=2, sort_keys=True) + "\n"
