"""Transfer predictor: recorded source spaces -> ranked target configs.

The pipeline per (kernel, scenario):

  1. fit the :func:`repro_torch.tuner.costmodel.fit_from_dataset` ridge
     surrogate on the *source* device's recorded space — a smoothed,
     data-grounded view of the landscape (raw scores carry measurement
     ruggedness that does not transfer; the fitted trend does);
  2. calibrate each feasible config's surrogate score to the target
     device through the :class:`~repro_torch.transfer.model.DeviceModel`
     capability ratios — with the kernel's workload hook available, the
     per-config compute/memory balance picks the exact blend (and VMEM
     overflow on the target marks the config infeasible there); without
     it, the capability-only geometric blend stands in;
  3. rank, keep the winner, and score *confidence* — device similarity x
     (surrogate fit quality, space coverage) — which decides whether the
     resulting ``transfer``-provenance record is eligible to serve
     (``Wisdom.select`` gates on it) and how urgent verification is.

Everything is deterministic: same dataset + same target -> byte-identical
records on any host (transfer provenance carries no timestamps).

Port of ``repro.transfer.predictor``. The registry's builders are the
port's, whose tuning spaces are Hopper-native, so a dataset recorded on the
reference's TPU space (every file in ``benchmarks/datasets/``) does not fit
them: :func:`transfer_scenario` raises ``ValueError`` naming both parameter
tables rather than price a config through a workload hook that was never
written for it. A kernel the registry lacks takes the capability-only path,
as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.device import get_device
from repro_torch.core.param import Config
from repro_torch.core.registry import get_kernel
from repro_torch.core.wisdom import (TRANSFER_MIN_CONFIDENCE, WisdomRecord,
                                     make_transfer_provenance)
from repro_torch.tuner.costmodel import CostModel, fit_from_dataset
from repro_torch.tunebench.dataset import SpaceDataset

__all__ = ["TransferPrediction", "TransferResult", "transfer_scenario",
           "transfer_store"]

#: Confidence mix: sqrt(similarity) x (base + fit-quality + coverage
#: terms). Multiplicative in similarity so a dissimilar device pair can
#: never be rescued by a good fit; the additive terms reward a surrogate
#: that learned the landscape and a space that was densely recorded.
CONFIDENCE_BASE = 0.30
CONFIDENCE_FIT_WEIGHT = 0.50
CONFIDENCE_COVERAGE_WEIGHT = 0.20

#: Confidence penalty when the kernel's workload hook is unavailable and
#: calibration had to fall back to the capability-only blend ratio.
#: Additionally scaled by the VMEM ratio when the target's on-chip
#: memory is *smaller* than the source's: without the workload hook
#: there is no per-config feasibility check, and a source config sized
#: for the bigger memory may not compile on the target at all — the
#: shrinking-memory direction must not clear the serving gate blind.
CAPABILITY_ONLY_FACTOR = 0.8

#: Cap on space enumeration when computing recorded coverage.
_COVERAGE_CAP = 4096


@dataclass
class TransferPrediction:
    """One source config's predicted standing on the target device.

    ``source_us`` is the *recorded* source score, ``smoothed_us`` the
    ridge surrogate's view of it (measurement ruggedness does not
    transfer; the fitted trend does). Ranking uses the smoothed score
    calibrated through the capability model (``rank_us``); the
    ``predicted_us`` the record carries — what observed serve latency is
    verified against — calibrates the recorded score instead, because
    the surrogate's absolute level extrapolates poorly at space corners
    while the recorded value is ground truth for that exact config.
    """

    config: Config
    source_us: float         # recorded on the source device
    smoothed_us: float       # ridge-surrogate fit of the source score
    rank_us: float           # smoothed_us x calibration ratio (sort key)
    predicted_us: float      # source_us x calibration ratio (verify target)

    def to_json(self) -> dict:
        return {"config": dict(self.config),
                "source_us": round(self.source_us, 6),
                "smoothed_us": round(self.smoothed_us, 6),
                "rank_us": round(self.rank_us, 6),
                "predicted_us": round(self.predicted_us, 6)}


@dataclass
class TransferResult:
    """Everything the transfer of one scenario produced.

    Carries the ranked predictions, the confidence score with its
    components, and enough identity to mint a ``transfer``-provenance
    :class:`~repro_torch.core.wisdom.WisdomRecord` via :meth:`record`.

    Example::

        result = transfer_scenario(dataset, "gpu-h100")
        if result.eligible():
            wisdom.add(result.record())
    """

    kernel: str
    source_device: str
    target_device: str
    problem_size: tuple[int, ...]
    dtype: str
    predictions: list[TransferPrediction]
    confidence: float
    components: dict = field(default_factory=dict)

    def best(self) -> TransferPrediction | None:
        """The top-ranked prediction (None when nothing transferred —
        e.g. every source config overflows the target's VMEM)."""
        return self.predictions[0] if self.predictions else None

    def eligible(self, min_confidence: float | None = None) -> bool:
        """Whether the result clears the serving gate (defaults to
        :data:`~repro_torch.core.wisdom.TRANSFER_MIN_CONFIDENCE`)."""
        threshold = (TRANSFER_MIN_CONFIDENCE if min_confidence is None
                     else float(min_confidence))
        return self.best() is not None and self.confidence >= threshold

    def record(self, gate=None) -> WisdomRecord:
        """The transferred wisdom record for the target device (raises
        ``ValueError`` when there is no prediction at all).

        With a :class:`~repro_torch.sandbox.gate.OracleGate`, predictions are
        walked in rank order and the first one whose config passes the
        correctness oracle becomes the record — a top-ranked config that
        computes the wrong answer on this host falls through to the
        runner-up instead of being served. Raises ``ValueError`` when
        the gate vetoes every prediction.
        """
        top = self.best()
        if top is None:
            raise ValueError(
                f"no transferable config for {self.kernel} "
                f"{self.source_device} -> {self.target_device}")
        verdict = None
        if gate is not None:
            top = None
            for pred in self.predictions:
                verdict = gate.check(self.kernel, pred.config,
                                     self.problem_size, self.dtype)
                if gate.allows(verdict):
                    top = pred
                    break
            if top is None:
                raise ValueError(
                    f"every transferable config for {self.kernel} "
                    f"{self.source_device} -> {self.target_device} failed "
                    f"the correctness oracle")
        target = get_device(self.target_device)
        backends = self.components.get("backends", "")
        cross = backends and len(set(backends.split("->"))) > 1
        provenance = make_transfer_provenance(
            source_device=self.source_device,
            source_entries=int(self.components.get("entries", 0)),
            confidence=self.confidence,
            predicted_us=round(top.predicted_us, 6),
            predictor=self.components.get("calibration", "capability"),
            backends=backends if cross else "")
        if gate is not None:
            provenance = gate.stamp(provenance, self.kernel, verdict)
        return WisdomRecord(
            device_kind=target.kind, device_family=target.family,
            problem_size=tuple(self.problem_size), dtype=self.dtype,
            config=dict(top.config),
            score_us=round(top.predicted_us, 6),
            provenance=provenance)

    def to_json(self, top: int = 5) -> dict:
        return {
            "kernel": self.kernel,
            "source_device": self.source_device,
            "target_device": self.target_device,
            "problem_size": list(self.problem_size),
            "dtype": self.dtype,
            "confidence": self.confidence,
            "components": dict(self.components),
            "predictions": [p.to_json() for p in self.predictions[:top]],
        }


def _coverage(dataset: SpaceDataset) -> float:
    """Fraction of the (capped) valid space the recording covers."""
    total = dataset.space().valid_cardinality(cap=_COVERAGE_CAP)
    if total <= 0:
        return 0.0
    return min(1.0, len(dataset.evaluations) / total)


def _param_table(space) -> list:
    """A space's parameter table: (name, values, default) in order."""
    return [(p.name, list(p.values), p.default)
            for p in space.params.values()]


def transfer_scenario(dataset: SpaceDataset, target_kind: str,
                      builder=None) -> TransferResult:
    """Transfer one recorded scenario to an untuned target device.

    ``builder`` supplies the kernel's workload hook for per-config
    calibration; when omitted it is looked up in the registry, and when
    the kernel is unknown on this host the capability-only blend is used
    (with a confidence penalty). Raises ``ValueError`` when the dataset's
    parameter table is not the builder's (a space recorded for another
    kernel design), for a source == target transfer (nothing to
    predict — the dataset already *is* the target's ground truth) and
    when the dataset has too few feasible entries to fit the surrogate.

    Example::

        ds = SpaceDataset.load("matmul--gpu-a100--512x512x1024--float32"
                               ".space.json")
        result = transfer_scenario(ds, "gpu-h100")
        result.record()     # transfer-provenance WisdomRecord
    """
    if dataset.device_kind == target_kind:
        raise ValueError(
            f"dataset {dataset.name()} is already recorded on "
            f"{target_kind}; transfer needs a different target device")
    source = get_device(dataset.device_kind)
    target = get_device(target_kind)
    from .model import DeviceModel
    model = DeviceModel(source, target)
    fitted = fit_from_dataset(dataset)
    if builder is None:
        try:
            builder = get_kernel(dataset.kernel)
        except KeyError:
            builder = None
    if builder is not None and \
            _param_table(builder.space) != _param_table(dataset.space()):
        raise ValueError(
            f"dataset {dataset.name()} was recorded on the parameter table "
            f"{_param_table(dataset.space())}, but kernel {builder.name!r} "
            f"here tunes {_param_table(builder.space)}: its workload hook "
            f"cannot price those configs")
    calibration = "workload" if builder is not None else "capability"
    source_cost = CostModel(source, noise_sigma=0.0)
    target_cost = CostModel(target, noise_sigma=0.0)

    predictions: list[tuple[str, TransferPrediction]] = []
    for entry in dataset.feasible():
        base = fitted.predict(entry.config)
        if builder is not None:
            w = builder.make_workload(entry.config, dataset.problem_size,
                                      dataset.dtype)
            ts = source_cost.time(w, dataset.dtype)
            tt = target_cost.time(w, dataset.dtype)
            if not (math.isfinite(ts) and math.isfinite(tt)) or ts <= 0:
                continue        # infeasible on the target (e.g. VMEM)
            ratio = tt / ts
        else:
            ratio = model.blend_ratio(dataset.dtype)
        predictions.append((dataset.key_for(entry.config),
                            TransferPrediction(
                                config=dict(entry.config),
                                source_us=entry.score_us,
                                smoothed_us=base,
                                rank_us=base * ratio,
                                predicted_us=entry.score_us * ratio)))
    # Rank by calibrated smoothed target time; the config-hash key makes
    # equal predictions resolve identically on every host.
    predictions.sort(key=lambda kp: (kp[1].rank_us, kp[0]))
    ranked = [p for _k, p in predictions]

    fit_quality = fitted.fit_quality()
    similarity = model.similarity()
    coverage = _coverage(dataset)
    unmeasured = model.unmeasured_axes()
    confidence = (math.sqrt(similarity)
                  * (CONFIDENCE_BASE
                     + CONFIDENCE_FIT_WEIGHT * fit_quality
                     + CONFIDENCE_COVERAGE_WEIGHT * coverage))
    if calibration == "capability":
        confidence *= CAPABILITY_ONLY_FACTOR * min(1.0, model.vmem_ratio())
    confidence = round(min(1.0, max(0.0, confidence)), 6)
    return TransferResult(
        kernel=dataset.kernel,
        source_device=dataset.device_kind, target_device=target_kind,
        problem_size=tuple(dataset.problem_size), dtype=dataset.dtype,
        predictions=ranked, confidence=confidence,
        components={
            "similarity": round(similarity, 6),
            "fit_quality": round(fit_quality, 6),
            "coverage": round(coverage, 6),
            "calibration": calibration,
            "entries": len(dataset.evaluations),
            "transferable": len(ranked),
            # Cross-backend bookkeeping: similarity above already
            # *includes* the penalty (and the estimated-spec floor);
            # recording the factor separately makes "the penalty was
            # applied" auditable on every result and record.
            "backends": f"{source.backend}->{target.backend}",
            "backend_penalty": round(model.backend_penalty(), 6),
            "estimated": model.estimated(),
            # Axes 0 on either side (not measured) left out of the
            # similarity; absent when none was, so every pair the
            # reference can score keeps its byte-identical components.
            **({"unmeasured_axes": ",".join(unmeasured)}
               if unmeasured else {}),
        })


def transfer_store(store, target_kind: str, kernel: str | None = None
                   ) -> list[TransferResult]:
    """Transfer every recorded scenario in a
    :class:`~repro_torch.tunebench.DatasetStore` to ``target_kind``.

    Scenarios already recorded *on* the target device are skipped (they
    need no prediction), as are datasets too small to fit the surrogate.
    Results come back in deterministic filename order.

    Example::

        results = transfer_store(DatasetStore("datasets"), "gpu-h100")
        records = [r.record() for r in results if r.eligible()]
    """
    results: list[TransferResult] = []
    for kern, dev, _problem, _dtype, path in store.scenarios(kernel=kernel):
        if dev == target_kind:
            continue
        dataset = SpaceDataset.load(path)
        try:
            results.append(transfer_scenario(dataset, target_kind))
        except ValueError:
            continue            # too few feasible entries to fit
    return results
