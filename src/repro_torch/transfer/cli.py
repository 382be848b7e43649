"""``python -m repro_torch.transfer`` — predict, score, export.

Subcommands:

  predict   transfer recorded source spaces to an untuned target device;
            prints the ranked results and (with ``--wisdom-dir``) merges
            the eligible ``transfer``-provenance records into a local
            wisdom store (measured records always survive the merge)
  score     held-out evaluation: transfer a source dataset and look the
            chosen config up in a *truth* recording of the same scenario
            on the target device (fraction-of-optimum, vs cold fallback)
  export    write the transferred records for one kernel as a wisdom
            JSON document (publishable to any sync transport)

The loop end to end::

    python -m repro_torch.tunebench record --kernel matmul \
        --problem 512,512,1024 --device-kind gpu-a100 --out datasets/
    python -m repro_torch.transfer predict --dataset-dir datasets/ \
        --target gpu-h100 --wisdom-dir wisdom/
    python -m repro_torch.transfer score \
        --source datasets/matmul--gpu-a100--512x512x1024--float32.space.json \
        --truth  datasets/matmul--gpu-h100--512x512x1024--float32.space.json

Port of ``repro.transfer.cli``. ``predict --wisdom-dir`` and ``export``
check each record's config against the kernel's plain version through the
correctness oracle on ``--device`` (the card unless ``--device cpu``;
``--no-verify`` skips the check and touches no tensor).
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from pathlib import Path

from repro_torch.core.device import resolve_device
from repro_torch.core.wisdom import TRANSFER_MIN_CONFIDENCE, Wisdom
from repro_torch.distrib.merge import merge_wisdom
from repro_torch.distrib.store import WisdomStore
from repro_torch.sandbox.gate import OracleGate
from repro_torch.tunebench.dataset import (DATASET_SUFFIX, DatasetStore,
                                           SpaceDataset)

from .predictor import TransferResult, transfer_scenario
from .score import dump_holdout_report, holdout_report


def _load_sources(args) -> list[SpaceDataset]:
    if args.dataset_dir:
        store = DatasetStore(args.dataset_dir)
        paths = [p for _k, dev, _pr, _dt, p in
                 store.scenarios(kernel=args.kernel)
                 if dev != args.target]
    else:
        paths = []
        for pat in args.datasets:
            paths.extend(sorted(glob.glob(pat)))
        paths = list(dict.fromkeys(paths))
    out = []
    for p in paths:
        ds = SpaceDataset.load(p)
        if ds.device_kind == args.target:
            continue
        if args.kernel and ds.kernel != args.kernel:
            continue
        out.append(ds)
    return out


def _gate(args) -> OracleGate | None:
    """The correctness oracle records are checked through, on the
    requested device (made only once a record is to be checked); None with
    ``--no-verify``."""
    if args.no_verify:
        return None
    return OracleGate(device=resolve_device(args.device))


def _result_line(r: TransferResult, threshold: float) -> str:
    top = r.best()
    gate = "ok  " if r.confidence >= threshold and top is not None else "SKIP"
    predicted = f"{top.predicted_us:.2f}us" if top is not None else "-"
    problem = "x".join(str(d) for d in r.problem_size)
    return (f"  {gate} {r.kernel} {problem} {r.dtype} "
            f"{r.source_device} -> {r.target_device}: "
            f"predicted {predicted}, confidence {r.confidence:.3f} "
            f"(sim {r.components['similarity']:.3f}, "
            f"fit {r.components['fit_quality']:.3f}, "
            f"{r.components['calibration']})")


def _cmd_predict(args) -> int:
    sources = _load_sources(args)
    if not sources:
        print("no source datasets (or all are already recorded on "
              f"{args.target!r})", file=sys.stderr)
        return 1
    threshold = (TRANSFER_MIN_CONFIDENCE if args.min_confidence is None
                 else args.min_confidence)
    results = []
    for ds in sources:
        try:
            results.append(transfer_scenario(ds, args.target))
        except ValueError as e:
            print(f"  skip {ds.name()}: {e}", file=sys.stderr)
    if args.json:
        print(json.dumps([r.to_json() for r in results],
                         indent=2, sort_keys=True))
    else:
        print(f"transfer -> {args.target} "
              f"(confidence threshold {threshold:.2f}):")
        for r in results:
            print(_result_line(r, threshold))
    eligible = [r for r in results if r.eligible(args.min_confidence)]
    if args.wisdom_dir:
        gate = _gate(args) if eligible else None
        store = WisdomStore(args.wisdom_dir)
        by_kernel: dict[str, list] = {}
        for r in eligible:
            try:
                by_kernel.setdefault(r.kernel, []).append(
                    r.record(gate=gate))
            except ValueError as e:
                print(f"  reject {r.kernel} "
                      f"{'x'.join(str(d) for d in r.problem_size)} "
                      f"{r.dtype}: {e}", file=sys.stderr)
        for kernel, records in sorted(by_kernel.items()):
            merged = merge_wisdom(store.load(kernel),
                                  Wisdom(kernel, records))
            store.save(merged)
            print(f"merged {len(records)} transferred record(s) into "
                  f"{store.path_for(kernel)}")
    if not eligible:
        print("nothing eligible to serve (confidence below threshold)",
              file=sys.stderr)
        return 2
    return 0


def _cmd_score(args) -> int:
    source = SpaceDataset.load(args.source)
    truth = SpaceDataset.load(args.truth)
    report = holdout_report(source, truth)
    if args.json:
        sys.stdout.write(dump_holdout_report(report))
        return 0
    t, f = report["transfer"], report["fallback"]
    print(f"{report['kernel']} {report['scenario']}: "
          f"{report['source_device']} -> {report['target_device']}")
    print(f"  optimum        {report['optimum_us']}us")
    print(f"  transfer       fraction {t['fraction']} (tier {t['tier']}, "
          f"confidence {report['confidence']:.3f})")
    print(f"  cold fallback  fraction {f['fraction']} (tier {f['tier']})")
    print(f"  default        fraction {report['default']['fraction']}")
    if args.check and (t["fraction"] is None
                       or t["fraction"] < args.threshold):
        print(f"FAIL: transfer fraction below {args.threshold}",
              file=sys.stderr)
        return 1
    return 0


def _cmd_export(args) -> int:
    sources = _load_sources(args)
    kernels = sorted({ds.kernel for ds in sources})
    if len(kernels) != 1:
        print(f"export needs exactly one kernel (have {kernels}); "
              f"use --kernel", file=sys.stderr)
        return 1
    gate = None
    records = []
    for ds in sources:
        try:
            result = transfer_scenario(ds, args.target)
        except ValueError:
            continue
        if result.eligible(args.min_confidence):
            if gate is None:
                gate = _gate(args)
            try:
                records.append(result.record(gate=gate))
            except ValueError as e:
                print(f"  reject {ds.name()}: {e}", file=sys.stderr)
    doc = Wisdom(kernels[0], records).to_doc()
    text = json.dumps(doc, indent=2, sort_keys=True) + "\n"
    if args.out and args.out != "-":
        Path(args.out).write_text(text)
        print(f"{len(records)} transferred record(s) -> {args.out}")
    else:
        sys.stdout.write(text)
    return 0 if records else 2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.transfer",
        description="Cross-device wisdom transfer: serve good configs on "
                    "devices never tuned.")
    sub = ap.add_subparsers(dest="command", required=True)

    def _sources(p):
        p.add_argument("--dataset-dir", default=None,
                       help="DatasetStore directory of recorded spaces")
        p.add_argument("--datasets", nargs="+",
                       default=[f"datasets/*{DATASET_SUFFIX}"],
                       help="dataset globs (ignored with --dataset-dir)")
        p.add_argument("--kernel", default=None,
                       help="restrict to one kernel")
        p.add_argument("--target", required=True,
                       help="target device kind, e.g. gpu-h100")
        p.add_argument("--min-confidence", type=float, default=None,
                       help="override the serving confidence gate")
        p.add_argument("--no-verify", action="store_true",
                       help="skip the correctness-oracle check on "
                            "records (verified provenance is then "
                            "omitted)")
        p.add_argument("--device", default="cuda",
                       help="torch device the oracle checks on (cuda, or "
                            "cpu for the plain versions)")

    p = sub.add_parser("predict",
                       help="transfer recorded spaces to a target device")
    _sources(p)
    p.add_argument("--wisdom-dir", default=None,
                   help="merge eligible transferred records into this "
                        "wisdom store")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_predict)

    p = sub.add_parser("score",
                       help="held-out evaluation against a truth recording")
    p.add_argument("--source", required=True,
                   help="source device dataset (*.space.json)")
    p.add_argument("--truth", required=True,
                   help="target device recording of the same scenario")
    p.add_argument("--threshold", type=float, default=0.8)
    p.add_argument("--check", action="store_true",
                   help="exit non-zero when transfer fraction is below "
                        "--threshold")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_score)

    p = sub.add_parser("export",
                       help="transferred records as a wisdom JSON document")
    _sources(p)
    p.add_argument("--out", default="-",
                   help="output path ('-' for stdout)")
    p.set_defaults(fn=_cmd_export)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
