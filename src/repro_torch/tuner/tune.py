"""Tuning entry points + capture replay (paper §4.3) and the CLI.

Port of ``repro.tuner.tune``. ``tune_kernel`` tunes one (kernel, problem,
dtype, device kind) scenario by wall clock on the card, or by the analytical
cost model (``objective="costmodel"``: no launch), and writes the winner
into the kernel's wisdom file through a
:class:`~repro_torch.distrib.WisdomStore` (format version 2).
``record_dataset`` also records every evaluation of the session as a
tuning-space dataset (:mod:`repro_torch.tunebench`). ``tune_capture``
replays a captured launch: no hand-written tuning script, no synthetic
data.

CLI (the paper's "command-line script", §4.3)::

    python -m repro_torch.tuner.tune --captures 'captures/*.capture.json' \
        --strategy bayes --budget-evals 40 [--device cpu] \
        [--record-dataset datasets/]
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.builder import KernelBuilder
from repro_torch.core.capture import Capture, load_capture
from repro_torch.core.device import (current_device_kind, get_device,
                                     resolve_device)
from repro_torch.core.registry import get_kernel
from repro_torch.core.wisdom import WisdomRecord, make_provenance
from repro_torch.distrib.store import WisdomStore

from .runner import CostModelEvaluator, WallClockEvaluator
from .strategies import STRATEGIES, TuningResult

DEFAULT_BUDGET_EVALS = 200
DEFAULT_TIME_BUDGET_S = 15 * 60.0


def tune_kernel(builder: KernelBuilder, problem: tuple[int, ...], dtype: str,
                device_kind: str, strategy: str = "bayes",
                max_evals: int = DEFAULT_BUDGET_EVALS,
                time_budget_s: float | None = DEFAULT_TIME_BUDGET_S,
                verify_args: Sequence[torch.Tensor] | None = None,
                objective: str = "wallclock",
                wisdom_dir: Path | str | None = None,
                write_wisdom: bool = True,
                seed: int = 0,
                device: str | torch.device = "cuda",
                repeats: int = 5,
                store: WisdomStore | None = None,
                record_dataset: Path | str | None = None) -> TuningResult:
    """Tune one scenario; record the winner.

    ``objective="wallclock"`` times each config on ``device``;
    ``verify_args`` are the concrete arguments the configs run on (a
    capture's), and without them the kernel's probe hook synthesizes the
    scenario's inputs. ``objective="costmodel"`` scores each config with
    the analytical model for ``device_kind`` and launches nothing, except
    that with ``verify_args`` each config is checked once on them, moved
    to ``device``.

    The winner is written through a :class:`~repro_torch.distrib.WisdomStore`
    (``store`` wins over ``wisdom_dir``). ``record_dataset`` additionally
    records *every* evaluation of the session into a
    :class:`~repro_torch.tunebench.SpaceDataset`: a directory (one
    scenario-named file, merged with any prior recording of the same
    scenario and objective) or an explicit ``*.space.json`` path.

    Example::

        res = tune_kernel(get_kernel("matmul"), (512, 512, 1024),
                          "float32", "gpu-h100", max_evals=20,
                          record_dataset="datasets")
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"have {sorted(STRATEGIES)}")
    dataset = dataset_path = None
    if record_dataset is not None:
        # Local import: tunebench builds on the tuner's primitives.
        from repro_torch.tunebench import (DATASET_SUFFIX, DatasetStore,
                                           SpaceDataset)
        path = Path(record_dataset)
        if str(path).endswith(DATASET_SUFFIX) or path.suffix == ".json":
            dataset_path = path
        else:
            dataset_path = DatasetStore(path).path_for(
                builder.name, device_kind, problem, dtype)
        if dataset_path.exists():
            dataset = SpaceDataset.load(dataset_path)   # merge into prior
            # Merging across scenarios (or objectives) would mix
            # incomparable scores under one header, and a foreign param
            # table would break key derivation mid-session. Refuse now.
            want = (builder.name, tuple(problem), dtype, device_kind,
                    objective)
            have = (dataset.kernel, dataset.problem_size, dataset.dtype,
                    dataset.device_kind, dataset.objective)
            if want != have:
                raise ValueError(
                    f"dataset {dataset_path} records scenario {have}, "
                    f"cannot merge a {want} session into it")
        else:
            dataset = SpaceDataset(builder.name, builder.space, problem,
                                   dtype, device_kind, objective=objective)
    if objective == "costmodel":
        if verify_args is not None:
            dev = resolve_device(device)
            verify_args = [torch.as_tensor(a).to(dev) for a in verify_args]
        evaluate = CostModelEvaluator(builder, problem, dtype,
                                      get_device(device_kind),
                                      verify_args=verify_args,
                                      record_to=dataset)
    elif objective == "wallclock":
        if verify_args is None:
            verify_args = builder.make_probe_args(problem, dtype)
        evaluate = WallClockEvaluator(builder, verify_args,
                                      device=resolve_device(device),
                                      repeats=repeats, record_to=dataset)
    else:
        raise ValueError(f"unknown objective {objective!r}")
    rng = np.random.default_rng(seed)
    result = STRATEGIES[strategy](builder.space, evaluate,
                                  max_evals=max_evals, rng=rng,
                                  time_budget_s=time_budget_s)
    if dataset is not None:
        dataset.provenance.setdefault("recorder", "tune_kernel")
        dataset.save(dataset_path)
    if write_wisdom and result.best_config is not None:
        dev = get_device(device_kind)
        if store is None:
            store = WisdomStore(wisdom_dir)
        wisdom = store.load(builder.name)
        wisdom.add(WisdomRecord(
            device_kind=dev.kind, device_family=dev.family,
            problem_size=tuple(problem), dtype=dtype,
            config=result.best_config, score_us=result.best_score_us,
            provenance=make_provenance(strategy=strategy,
                                       evals=len(result.evaluations),
                                       objective=objective)))
        store.save(wisdom)
    return result


def tune_capture(capture: Path | str | Capture, device_kind: str,
                 strategy: str = "bayes",
                 max_evals: int = DEFAULT_BUDGET_EVALS,
                 time_budget_s: float | None = DEFAULT_TIME_BUDGET_S,
                 objective: str = "wallclock",
                 wisdom_dir: Path | str | None = None,
                 seed: int = 0,
                 device: str | torch.device = "cuda",
                 store: WisdomStore | None = None,
                 record_dataset: Path | str | None = None) -> TuningResult:
    """Replay a captured launch through the tuner (paper §4.2/§4.3).

    Accepts a capture file path (written by either package) or a loaded
    :class:`Capture`; it supplies the problem size, dtype and arguments.

    Example::

        res = tune_capture("captures/matmul-512x512x1024-float32.capture.json",
                           "gpu-h100", strategy="bayes", max_evals=20)
    """
    cap = capture if isinstance(capture, Capture) else load_capture(capture)
    builder = get_kernel(cap.kernel_name)
    return tune_kernel(builder, cap.problem_size, cap.dtype, device_kind,
                       strategy=strategy, max_evals=max_evals,
                       time_budget_s=time_budget_s, verify_args=cap.args,
                       objective=objective, wisdom_dir=wisdom_dir, seed=seed,
                       device=device, store=store,
                       record_dataset=record_dataset)


def plan_captures(paths: Sequence[str], device_kind: str
                  ) -> list[tuple[Capture, list[str]]]:
    """Group capture files into unique (kernel, problem, dtype) scenarios,
    in first-seen order, with every path that mapped to each.

    The CLI tunes each scenario once, however many launches captured it.

    Example::

        for cap, paths in plan_captures(sorted(glob.glob("captures/*")),
                                        "gpu-h100"):
            tune_capture(cap, "gpu-h100", max_evals=20)
    """
    plan: dict[tuple, tuple[Capture, list[str]]] = {}
    for p in paths:
        cap = load_capture(p)
        key = (cap.kernel_name, tuple(cap.problem_size), cap.dtype,
               device_kind)
        if key in plan:
            plan[key][1].append(p)
        else:
            plan[key] = (cap, [p])
    return list(plan.values())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay captured kernel launches through the tuner.")
    ap.add_argument("--captures", default="captures/*.capture.json",
                    help="glob of capture files to replay")
    ap.add_argument("--strategy", default="bayes",
                    choices=sorted(STRATEGIES))
    ap.add_argument("--budget-evals", type=int, default=DEFAULT_BUDGET_EVALS)
    ap.add_argument("--budget-seconds", type=float,
                    default=DEFAULT_TIME_BUDGET_S)
    ap.add_argument("--device", default="cuda",
                    help="torch device to tune on (cuda, or cpu for the "
                         "plain versions)")
    ap.add_argument("--device-kind", default=None,
                    help="device kind the wisdom records name (default: "
                         "the device's own)")
    ap.add_argument("--objective", default="wallclock",
                    choices=("wallclock", "costmodel"))
    ap.add_argument("--wisdom-dir", default=None)
    ap.add_argument("--record-dataset", default=None, metavar="DIR",
                    help="also record every evaluation into a tuning-space "
                         "dataset directory (see docs/tuning-datasets.md)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dry-run", action="store_true",
                    help="print the deduplicated scenario plan and exit "
                         "without tuning")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    kind = args.device_kind or current_device_kind(device)
    paths = sorted(glob.glob(args.captures))
    if not paths:
        print(f"no captures match {args.captures!r}")
        return 1
    plan = plan_captures(paths, kind)
    dups = len(paths) - len(plan)
    for cap, scenario_paths in plan:
        label = (f"{cap.kernel_name} "
                 f"{'x'.join(str(d) for d in cap.problem_size)} "
                 f"{cap.dtype} on {kind}")
        if args.dry_run:
            extra = (f" (+{len(scenario_paths) - 1} duplicate(s))"
                     if len(scenario_paths) > 1 else "")
            print(f"would tune {label}: {scenario_paths[0]}{extra}")
            continue
        res = tune_capture(cap, kind, strategy=args.strategy,
                           max_evals=args.budget_evals,
                           time_budget_s=args.budget_seconds,
                           objective=args.objective,
                           wisdom_dir=args.wisdom_dir, seed=args.seed,
                           device=device,
                           record_dataset=args.record_dataset)
        print(f"{scenario_paths[0]}: best={res.best_score_us:.2f}us "
              f"evals={len(res.evaluations)} config={res.best_config}")
        for skipped in scenario_paths[1:]:
            print(f"{skipped}: skipped (same scenario: {label})")
    print(f"{len(plan)} scenario(s) from {len(paths)} capture(s)"
          + (f", {dups} duplicate(s) skipped" if dups else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
