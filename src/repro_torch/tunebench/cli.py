"""``python -m repro_torch.tunebench`` — record, replay, and compare.

Subcommands:

  record    exhaustively evaluate one scenario's config space into a
            ``*.space.json`` dataset: by the cost model (deterministic, no
            launch) or by wall clock on the card (``--objective
            wallclock``; ``--device cpu`` times the plain versions on the
            host instead)
  run       one simulated tuning session of one strategy over a recorded
            space; prints the result (``--json`` for machines)
  compare   every strategy x every dataset -> fraction-of-optimum report
            with per-strategy regression thresholds (``--check`` exits
            non-zero when any strategy is below its gate)
  report    render a previously written report JSON as text

The loop end to end::

    python -m repro_torch.tunebench record --kernel matmul \
        --problem 512,512,1024 --dtype float32 --objective wallclock --out ds/
    python -m repro_torch.tunebench compare --datasets 'ds/*.space.json' \
        --out report.json --check
    python -m repro_torch.tunebench report report.json
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from pathlib import Path

from repro_torch.core.device import current_device_kind, resolve_device
from repro_torch.core.registry import get_kernel
from repro_torch.tuner.strategies import STRATEGIES

from .dataset import DATASET_SUFFIX, DatasetStore, SpaceDataset, record_space
from .harness import (DEFAULT_BUDGET, DEFAULT_SEEDS, compare, dump_report,
                      report_to_text, run_on_dataset)


def _parse_problem(text: str) -> tuple[int, ...]:
    return tuple(int(x) for x in text.replace("x", ",").split(",") if x)


def _cmd_record(args) -> int:
    builder = get_kernel(args.kernel)
    problem = _parse_problem(args.problem)
    if args.objective == "wallclock":
        device = resolve_device(args.device)
        kind = args.device_kind or current_device_kind(device)
    else:
        device, kind = args.device, args.device_kind or "gpu-h100"
    ds = record_space(builder, problem, args.dtype, kind,
                      objective=args.objective, limit=args.limit,
                      device=device)
    out = Path(args.out)
    if out.suffix == ".json" or str(out).endswith(DATASET_SUFFIX):
        path = ds.save(out)
    else:
        path = DatasetStore(out).save(ds)
    best = ds.best()
    print(f"recorded {len(ds)} evaluation(s) "
          f"({len(ds.feasible())} feasible) -> {path}")
    if best is not None:
        print(f"optimum: {best.score_us:.2f}us {best.config}")
    return 0


def _load_datasets(patterns: list[str]) -> list[SpaceDataset]:
    paths: list[str] = []
    for pat in patterns:
        paths.extend(sorted(glob.glob(pat)))
    return [SpaceDataset.load(p) for p in dict.fromkeys(paths)]


def _cmd_run(args) -> int:
    ds = SpaceDataset.load(args.dataset)
    result = run_on_dataset(ds, args.strategy, budget=args.budget,
                            seed=args.seed)
    optimum = ds.best()
    payload = {
        "dataset": ds.name(), "strategy": args.strategy,
        "budget": args.budget, "seed": args.seed,
        "evals": len(result.evaluations),
        "best_score_us": (round(result.best_score_us, 6)
                          if result.best_config is not None else None),
        "best_config": result.best_config,
        "optimum_us": (round(optimum.score_us, 6)
                       if optimum is not None else None),
    }
    if args.json:
        print(json.dumps(payload, indent=2, sort_keys=True))
        return 0
    print(f"{payload['dataset']}: {args.strategy} x{payload['evals']} "
          f"evals -> best={payload['best_score_us']}us "
          f"(optimum {payload['optimum_us']}us)")
    print(f"config: {payload['best_config']}")
    return 0


def _cmd_compare(args) -> int:
    datasets = _load_datasets(args.datasets)
    if not datasets:
        print(f"no datasets match {args.datasets!r}", file=sys.stderr)
        return 1
    seeds = tuple(int(s) for s in args.seeds.split(","))
    report = compare(datasets, strategies=args.strategies,
                     budget=args.budget, seeds=seeds)
    text = dump_report(report)
    if args.out:
        Path(args.out).write_text(text)
        print(f"report -> {args.out}")
    print(report_to_text(report))
    if args.check and not report["pass"]:
        return 1
    return 0


def _cmd_report(args) -> int:
    with open(args.report) as f:
        report = json.load(f)
    print(report_to_text(report))
    if args.check and not report.get("pass", False):
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tunebench",
        description="Recorded tuning-space datasets and simulated "
                    "strategy benchmarking.")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("record",
                       help="exhaustively record one scenario's space")
    p.add_argument("--kernel", required=True)
    p.add_argument("--problem", required=True,
                   help="problem size, e.g. 256,256,256 or 256x256x256")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda",
                   help="torch device a wallclock recording times on "
                        "(cuda, or cpu for the plain versions)")
    p.add_argument("--device-kind", default=None,
                   help="device kind the dataset names (default: the "
                        "device's own for wallclock, gpu-h100 for "
                        "costmodel)")
    p.add_argument("--objective", default="costmodel",
                   choices=("costmodel", "wallclock"),
                   help="costmodel prices each config for --device-kind "
                        "without a launch; wallclock times it on --device "
                        "on the kernel's probe tensors")
    p.add_argument("--limit", type=int, default=None,
                   help="cap on configs evaluated (default: whole space)")
    p.add_argument("--out", default="datasets",
                   help="dataset directory, or an explicit *.space.json "
                        "path")
    p.set_defaults(fn=_cmd_record)

    p = sub.add_parser("run", help="one simulated session on one dataset")
    p.add_argument("--dataset", required=True)
    p.add_argument("--strategy", default="bayes",
                   choices=sorted(STRATEGIES))
    p.add_argument("--budget", type=int, default=DEFAULT_BUDGET)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("compare",
                       help="all strategies x all datasets -> report")
    p.add_argument("--datasets", nargs="+",
                   default=[f"datasets/*{DATASET_SUFFIX}"],
                   help="dataset globs")
    p.add_argument("--strategies", nargs="+", default=None,
                   choices=sorted(STRATEGIES))
    p.add_argument("--budget", type=int, default=DEFAULT_BUDGET)
    p.add_argument("--seeds", default=",".join(str(s)
                                               for s in DEFAULT_SEEDS))
    p.add_argument("--out", default=None, help="write report JSON here")
    p.add_argument("--check", action="store_true",
                   help="exit non-zero when any strategy misses its "
                        "threshold")
    p.set_defaults(fn=_cmd_compare)

    p = sub.add_parser("report", help="render a report JSON as text")
    p.add_argument("report")
    p.add_argument("--check", action="store_true")
    p.set_defaults(fn=_cmd_report)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
