"""Recorded tuning-space datasets — the search space as a reusable asset.

The capture → tune → wisdom workflow (paper §4.2–§4.4) keeps only each
session's *winner* and discards every other evaluation. A
:class:`SpaceDataset` keeps them all: one schema-versioned JSON document
per (kernel, device, problem size, dtype) scenario holding every
``(config, score, status)`` the objective ever produced for that
scenario, keyed by :meth:`~repro_torch.core.param.ConfigSpace.config_hash`.
Recorded spaces are what make strategies comparable (replay the same
space through every strategy, deterministically, with zero hardware —
:mod:`repro_torch.tunebench.simulate`), the tuner regression-testable
(:mod:`repro_torch.tunebench.harness`), and cost models fittable from data
(:func:`repro_torch.tuner.costmodel.fit_from_dataset`).

Like wisdom files, the format is versioned (``DATASET_VERSION``), loads
migrate old documents in memory, and documents from a *newer* schema are
refused loudly (:class:`DatasetVersionError`) rather than silently
misread. See ``docs/tuning-datasets.md`` for the field-by-field spec.

Port of ``repro.tunebench.dataset``. The JSON is the reference's byte for
byte, so a space recorded by either package loads and re-saves unchanged in
the other. What the port adds is the measured objective on the card:
``record_space(..., objective="wallclock")`` times every config of a
Hopper-native space with CUDA events through
:class:`~repro_torch.tuner.runner.WallClockEvaluator`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Sequence

import torch

from repro_torch.core.param import Config, ConfigSpace
from repro_torch.tuner.runner import EvalResult
from repro_torch.tuner.strategies import Evaluation

#: Current on-disk schema version for ``*.space.json`` documents.
DATASET_VERSION = 1

#: Filename suffix for dataset files (mirrors ``.wisdom.json``).
DATASET_SUFFIX = ".space.json"

#: Score stored for evaluations that produced no finite time.
_INFEASIBLE = float("inf")


class DatasetVersionError(ValueError):
    """A dataset document declares a schema version this build cannot
    handle. Raised for documents from the *future* (version >
    ``DATASET_VERSION``): partially reading them could silently corrupt a
    benchmark baseline, so loading refuses loudly instead."""


def dataset_doc_version(doc: dict) -> int:
    """Schema version a dataset document declares (missing counts as 1)."""
    try:
        return int(doc.get("version", 1))
    except (TypeError, ValueError):
        raise DatasetVersionError(
            f"dataset document declares non-integer version "
            f"{doc.get('version')!r}") from None


def migrate_dataset_doc(doc: dict, source: str = "<memory>") -> dict:
    """Migrate a dataset document to the current ``DATASET_VERSION``.

    Returns a new document (the input is not mutated). Documents from a
    newer schema raise :class:`DatasetVersionError` — refusing loudly
    beats silently dropping fields a future writer considered essential.
    """
    version = dataset_doc_version(doc)
    if version > DATASET_VERSION:
        raise DatasetVersionError(
            f"dataset document {source} has version {version}, but this "
            f"build understands at most {DATASET_VERSION}; upgrade before "
            f"loading it (evaluations were NOT read)")
    out = json.loads(json.dumps(doc))      # deep copy, JSON-clean
    out["version"] = DATASET_VERSION
    return out


@dataclass
class SpaceEvaluation:
    """One recorded evaluation: a config, its score, and what happened.

    ``status`` is ``"ok"`` (feasible, ``score_us`` is the objective
    value) or ``"infeasible"`` (restricted, VMEM overflow, failed
    verification, build error — ``error`` says which, ``score_us`` is
    ``inf``). ``verdict`` optionally carries the sandbox verdict that
    produced an infeasible entry (``timeout``/``crash``/``oom``/
    ``numerics-mismatch`` — see :mod:`repro_torch.sandbox.verdict`), so a
    replayed space remembers *how* a config failed, not just that it
    did; benchmarks charge strategies for re-proposing known-fatal
    configs. ``profile`` optionally carries the roofline counters the
    profiler attached to the evaluation
    (:func:`repro_torch.prof.profile_fields`
    — FLOPs, HBM bytes, roofline time terms, bottleneck class), which is
    what lets :func:`repro_torch.tuner.costmodel.fit_from_dataset` learn from
    hardware structure instead of raw config coordinates. Both are
    empty for ordinary entries and omitted from JSON, keeping previously
    recorded datasets byte-identical."""

    config: Config
    score_us: float
    status: str
    error: str = ""
    verdict: str = ""
    profile: dict = field(default_factory=dict)

    @property
    def feasible(self) -> bool:
        return self.status == "ok"

    def to_json(self) -> dict:
        out = {"config": dict(self.config),
               "score_us": (self.score_us if self.feasible else None),
               "status": self.status, "error": self.error}
        if self.verdict:
            out["verdict"] = self.verdict
        if self.profile:
            out["profile"] = dict(self.profile)
        return out

    @staticmethod
    def from_json(d: dict) -> "SpaceEvaluation":
        score = d.get("score_us")
        return SpaceEvaluation(
            config=dict(d["config"]),
            score_us=(_INFEASIBLE if score is None else float(score)),
            status=str(d.get("status", "ok")),
            error=str(d.get("error", "")),
            verdict=str(d.get("verdict", "")),
            profile=dict(d.get("profile", {})))


class SpaceDataset:
    """Every recorded evaluation of one tuning scenario's config space.

    A dataset is self-describing: it snapshots the parameter table
    (names, value sets, defaults — in declaration order, which fixes the
    ``config_hash`` key derivation) so a recorded space can be replayed
    on a host that does not even have the kernel registered.

    Example::

        ds = SpaceDataset("matmul", builder.space, (256, 256, 256),
                          "float32", "gpu-h100")
        ds.add({"block_m": 128, ...}, 412.7, "ok")
        ds.save("matmul.space.json")
    """

    def __init__(self, kernel: str, space: ConfigSpace,
                 problem_size: Sequence[int], dtype: str, device_kind: str,
                 objective: str = "costmodel",
                 provenance: dict | None = None):
        self.kernel = kernel
        self.problem_size = tuple(int(x) for x in problem_size)
        self.dtype = dtype
        self.device_kind = device_kind
        self.objective = objective
        self.provenance = dict(provenance or {})
        # Snapshot the space: params only. Restrictions are kept as source
        # strings for provenance — membership in the recorded set is the
        # operative feasibility notion when replaying.
        self._space = ConfigSpace()
        for p in space.params.values():
            self._space.tune(p.name, p.values, p.default)
        self.restriction_srcs = list(getattr(space, "_restriction_srcs", []))
        self.evaluations: dict[str, SpaceEvaluation] = {}

    # -- identity ------------------------------------------------------------

    def space(self) -> ConfigSpace:
        """The snapshotted parameter space (no restrictions: the recorded
        entries themselves define what was reachable)."""
        return self._space

    def key_for(self, config: Config) -> str:
        """Entry key: the config's stable 64-bit hash, hex-encoded."""
        return f"{self._space.config_hash(config):016x}"

    def scenario_key(self) -> str:
        """Canonical scenario string (the online tracker's key format)."""
        problem = "x".join(str(d) for d in self.problem_size)
        return f"{self.device_kind}|{problem}|{self.dtype}"

    def name(self) -> str:
        """Filesystem-safe dataset name (used by :class:`DatasetStore`)."""
        problem = "x".join(str(d) for d in self.problem_size)
        return (f"{self.kernel}--{self.device_kind}--{problem}"
                f"--{self.dtype}")

    # -- mutation ------------------------------------------------------------

    def add(self, config: Config, score_us: float, status: str,
            error: str = "", verdict: str = "",
            profile: dict | None = None) -> None:
        """Record one evaluation. Re-recording the same config keeps the
        better outcome (an ``"ok"`` score always beats infeasible; two
        ok scores keep the lower), so repeated sessions only sharpen the
        dataset and recording stays deterministic in any order."""
        ev = SpaceEvaluation(dict(config), float(score_us), status, error,
                             verdict, dict(profile or {}))
        key = self.key_for(config)
        cur = self.evaluations.get(key)
        if cur is not None:
            if cur.feasible and (not ev.feasible
                                 or cur.score_us <= ev.score_us):
                return
        self.evaluations[key] = ev

    def record(self, config: Config, result: EvalResult) -> None:
        """Record a tuner :class:`~repro_torch.tuner.runner.EvalResult` — the
        hook the evaluators' ``record_to`` parameter calls. Results that
        came through a :class:`~repro_torch.sandbox.SandboxedEvaluator` carry
        their verdict (``info["sandbox"]``) into the entry; ``"ok"`` is
        not stored (it is the default)."""
        verdict = str(result.info.get("sandbox", ""))
        if verdict == "ok":
            verdict = ""
        self.add(config, result.score_us,
                 "ok" if result.feasible else "infeasible",
                 error=result.error, verdict=verdict,
                 profile=result.info.get("profile"))

    # -- queries -------------------------------------------------------------

    def lookup(self, config: Config) -> SpaceEvaluation | None:
        return self.evaluations.get(self.key_for(config))

    def feasible(self) -> list[SpaceEvaluation]:
        """Feasible entries, in key order (deterministic)."""
        return [self.evaluations[k] for k in sorted(self.evaluations)
                if self.evaluations[k].feasible]

    def best(self) -> SpaceEvaluation | None:
        """The dataset's optimum: lowest feasible score (ties broken by
        key so the answer is unique)."""
        feas = self.feasible()
        if not feas:
            return None
        return min(feas, key=lambda e: (e.score_us, self.key_for(e.config)))

    def __len__(self) -> int:
        return len(self.evaluations)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"SpaceDataset({self.name()!r}, {len(self)} entries, "
                f"{len(self.feasible())} feasible)")

    # -- persistence ---------------------------------------------------------

    def to_doc(self) -> dict:
        return {
            "format": "tuning-space",
            "version": DATASET_VERSION,
            "kernel": self.kernel,
            "device_kind": self.device_kind,
            "problem_size": list(self.problem_size),
            "dtype": self.dtype,
            "objective": self.objective,
            "provenance": self.provenance,
            "space": {
                "params": [{"name": p.name, "values": list(p.values),
                            "default": p.default}
                           for p in self._space.params.values()],
                "restrictions": list(self.restriction_srcs),
            },
            "evaluations": {k: e.to_json()
                            for k, e in sorted(self.evaluations.items())},
        }

    @staticmethod
    def from_doc(doc: dict, source: str = "<memory>") -> "SpaceDataset":
        if not isinstance(doc, dict):
            raise ValueError(f"dataset {source} is not a JSON object "
                             f"(got {type(doc).__name__})")
        if doc.get("format") not in (None, "tuning-space"):
            raise ValueError(f"dataset {source} has format "
                             f"{doc.get('format')!r}, not 'tuning-space'")
        doc = migrate_dataset_doc(doc, source)
        space = ConfigSpace()
        for p in doc.get("space", {}).get("params", []):
            space.tune(p["name"],
                       [_json_value(v) for v in p["values"]],
                       _json_value(p["default"]))
        ds = SpaceDataset(doc["kernel"], space,
                          doc["problem_size"], doc["dtype"],
                          doc["device_kind"],
                          objective=doc.get("objective", "costmodel"),
                          provenance=doc.get("provenance"))
        ds.restriction_srcs = [str(s) for s in
                               doc.get("space", {}).get("restrictions", [])]
        for key, entry in doc.get("evaluations", {}).items():
            ev = SpaceEvaluation.from_json(entry)
            want = ds.key_for(ev.config)
            if key != want:
                raise ValueError(
                    f"dataset {source}: entry key {key} does not match "
                    f"its config (expected {want}) — file corrupted or "
                    f"hand-edited")
            ds.evaluations[key] = ev
        return ds

    def save(self, path: Path | str) -> Path:
        """Write atomically (tmp + rename), indented, keys sorted — like
        wisdom files, datasets are meant to be diffed and checked in."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(path: Path | str) -> "SpaceDataset":
        path = Path(path)
        with open(path) as f:
            doc = json.load(f)
        return SpaceDataset.from_doc(doc, source=str(path))


def _json_value(v):
    """JSON round-trip normalization for parameter values (lists that were
    tuples come back as tuples so membership checks keep working)."""
    return tuple(v) if isinstance(v, list) else v


class DatasetStore:
    """A directory of recorded spaces, one file per scenario.

    The dataset analogue of :class:`~repro_torch.distrib.store.WisdomStore`:
    deterministic filenames derived from the scenario, so any process
    that knows (kernel, device, problem, dtype) finds the same file.

    Example::

        store = DatasetStore("datasets")
        store.save(ds)
        again = store.load_for("matmul", "gpu-h100", (256, 256, 256),
                               "float32")
    """

    def __init__(self, root: Path | str):
        self.root = Path(root)

    def path_for(self, kernel: str, device_kind: str,
                 problem_size: Sequence[int], dtype: str) -> Path:
        problem = "x".join(str(int(d)) for d in problem_size)
        return (self.root / f"{kernel}--{device_kind}--{problem}--{dtype}"
                            f"{DATASET_SUFFIX}")

    def save(self, dataset: SpaceDataset) -> Path:
        return dataset.save(self.root / (dataset.name() + DATASET_SUFFIX))

    def load_for(self, kernel: str, device_kind: str,
                 problem_size: Sequence[int],
                 dtype: str) -> SpaceDataset | None:
        """The scenario's dataset, or None when nothing was recorded."""
        path = self.path_for(kernel, device_kind, problem_size, dtype)
        if not path.exists():
            return None
        return SpaceDataset.load(path)

    def datasets(self) -> list[Path]:
        """Every dataset file in the store, sorted."""
        if not self.root.is_dir():
            return []
        return sorted(self.root.glob(f"*{DATASET_SUFFIX}"))

    def scenarios(self, kernel: str | None = None,
                  device_kind: str | None = None
                  ) -> list[tuple[str, str, tuple[int, ...], str, Path]]:
        """Recorded (kernel, device_kind, problem, dtype, path) tuples,
        parsed from the store's deterministic filenames and optionally
        filtered. This is how the transfer layer discovers which *source*
        devices have recorded spaces for a kernel without opening every
        file. Files whose names do not parse are skipped (they were not
        written by a :class:`DatasetStore`).

        Example::

            for kern, dev, problem, dtype, path in store.scenarios(
                    kernel="matmul"):
                ...
        """
        out = []
        for path in self.datasets():
            # rsplit: device/problem/dtype never contain "--", but a
            # kernel name could — it owns whatever is left on the left.
            parts = path.name[:-len(DATASET_SUFFIX)].rsplit("--", 3)
            if len(parts) != 4:
                continue
            kern, dev, problem_s, dtype = parts
            try:
                problem = tuple(int(d) for d in problem_s.split("x") if d)
            except ValueError:
                continue
            if kernel is not None and kern != kernel:
                continue
            if device_kind is not None and dev != device_kind:
                continue
            out.append((kern, dev, problem, dtype, path))
        return out


def history_from_dataset(dataset: SpaceDataset,
                         space: ConfigSpace | None = None
                         ) -> list[Evaluation]:
    """Convert recorded entries into strategy warm-start ``history``.

    The returned list plugs straight into any strategy's ``history``
    parameter (the same plumbing fleet workers checkpoint through): when
    the strategy proposes a config the dataset has a score for, the
    session replays the recorded evaluation instead of re-measuring.
    ``space`` filters entries to its valid set — a fleet worker passes
    its *shard* space so off-shard history can never leak a measurement
    into the wrong shard's result. Entries are ordered by key, so the
    history is identical on every host.
    """
    out: list[Evaluation] = []
    for key in sorted(dataset.evaluations):
        e = dataset.evaluations[key]
        if space is not None and not space.is_valid(e.config):
            continue
        out.append(Evaluation(config=dict(e.config), score_us=e.score_us,
                              feasible=e.feasible, wall_s=0.0,
                              error=e.error))
    return out


def record_space(builder, problem_size: Sequence[int], dtype: str,
                 device_kind: str, objective: str = "costmodel",
                 verify_args: Iterable | None = None,
                 limit: int | None = None,
                 device: str | torch.device = "cuda") -> SpaceDataset:
    """Exhaustively evaluate a kernel's config space into a dataset.

    The ``record`` CLI's engine: every valid config (capped at ``limit``,
    in space order, so a ``limit`` records a prefix) goes through the
    scenario's evaluator with recording on, so the resulting dataset
    contains the space's true optimum and every infeasibility. With the
    deterministic cost-model objective (priced for ``device_kind``, no
    launch) the same call produces byte-identical datasets on any host.
    With ``objective="wallclock"`` each config is built, checked against
    the plain version and timed on ``device`` (the card unless the caller
    asks for the CPU), on ``verify_args`` or, without them, the kernel's
    probe tensors for the scenario: the best of the evaluator's timed
    launches, a config's first, cold launch unscored.

    Example::

        ds = record_space(get_kernel("matmul"), (512, 512, 1024),
                          "float32", "gpu-h100", objective="wallclock")
    """
    from repro_torch.core.device import resolve_device
    from repro_torch.tuner.runner import CostModelEvaluator, WallClockEvaluator
    from repro_torch.tuner.strategies import tune_exhaustive

    dataset = SpaceDataset(builder.name, builder.space, problem_size, dtype,
                           device_kind, objective=objective)
    if objective == "costmodel":
        evaluate = CostModelEvaluator(
            builder, tuple(problem_size), dtype, device_kind,
            verify_args=(list(verify_args) if verify_args is not None
                         else None),
            record_to=dataset)
    elif objective == "wallclock":
        dev = resolve_device(device)
        if verify_args is None:
            verify_args = builder.make_probe_args(tuple(problem_size), dtype)
        evaluate = WallClockEvaluator(builder, list(verify_args), device=dev,
                                      record_to=dataset)
    else:
        raise ValueError(f"unknown objective {objective!r}")
    limit = limit if limit is not None else 1_000_000
    tune_exhaustive(builder.space, evaluate, limit=limit)
    dataset.provenance = {
        "recorder": "record_space",
        "objective": objective,
        "space_cardinality": builder.space.cardinality(),
        "limit": limit,
    }
    if objective == "wallclock":
        dataset.provenance["device"] = (torch.cuda.get_device_name(dev)
                                        if dev.type == "cuda" else "cpu")
        dataset.provenance["repeats"] = evaluate.repeats
    return dataset
