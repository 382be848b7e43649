"""``python -m repro_torch.sandbox`` — check candidates and run the demo.

Port of ``repro.sandbox.cli``. Subcommands:

  check     verify one config of a registered kernel against its plain
            version on the device (``--kernel/--problem/--dtype/--set``;
            the card unless ``--device cpu``), or — with ``--demo`` — run
            the injected-fault gauntlet (hang/crash/oom/wrong-output
            candidates through the spawned sandbox, the oracle, the
            online promotion path, the fleet coordinator's assembly and a
            transfer's records) and fail
            unless zero bad promotions happened. ``--out`` writes the
            verdict report as JSON.

Examples::

    python -m repro_torch.sandbox check --kernel advec_u \
        --problem 64,64,64 --dtype float32 --set body=tile
    python -m repro_torch.sandbox check --demo --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.core.device import resolve_device
from repro_torch.core.registry import get_kernel

from .demo import run_demo
from .gate import OracleGate


def _parse_set(pairs: list[str]) -> dict:
    config: dict = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set needs name=value, got {pair!r}")
        name, value = pair.split("=", 1)
        for cast in (int, float):
            try:
                value = cast(value)
                break
            except ValueError:
                continue
        config[name] = value
    return config


def _cmd_check_one(args) -> int:
    try:
        builder = get_kernel(args.kernel)
    except KeyError:
        print(f"unknown kernel {args.kernel!r}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    problem = tuple(int(d) for d in args.problem.split(",") if d)
    config = dict(builder.space.default_config())
    config.update(_parse_set(args.set or []))
    gate = OracleGate(device=device)
    verdict = gate.check(builder, config, problem, args.dtype)
    doc = {"kernel": args.kernel, "problem": list(problem),
           "dtype": args.dtype, "device": str(device), "config": config,
           "verdict": verdict.to_json()}
    if args.out:
        Path(args.out).write_text(json.dumps(doc, indent=2,
                                             sort_keys=True) + "\n")
    print(f"{args.kernel} {problem} {args.dtype} on {device}: "
          f"{verdict.status}"
          + (f" ({verdict.detail})" if verdict.detail else ""))
    return 0 if gate.allows(verdict) else 1


def _cmd_check(args) -> int:
    if not args.demo:
        if not args.kernel:
            print("check needs --kernel (or --demo)", file=sys.stderr)
            return 2
        return _cmd_check_one(args)
    report = run_demo(timeout_s=args.timeout, memory_mb=args.memory_mb,
                      device=args.device)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2,
                                             sort_keys=True) + "\n")
        print(f"verdict report -> {args.out}")
    print(f"legs run: {', '.join(report['legs'])}")
    print("sandbox verdicts: "
          + ", ".join(f"{mode}={v['status']}"
                      for mode, v in sorted(report["sandbox"].items())))
    print(f"oracle: honest={report['oracle']['honest']['status']}, "
          f"wrong={report['oracle']['wrong']['status']}")
    for path, doc in sorted(report["paths"].items()):
        print(f"  {path}: {json.dumps(doc, sort_keys=True)}")
    print(f"bad promotions: {report['bad_promotions']}")
    for problem in report["problems"]:
        print(f"FAIL: {problem}", file=sys.stderr)
    print("PASS" if report["pass"] else "FAIL")
    return 0 if report["pass"] else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sandbox",
        description="Crash-isolated evaluation and the correctness "
                    "oracle that gates wisdom promotion.")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("check",
                       help="oracle-check a config, or run the fault demo")
    p.add_argument("--demo", action="store_true",
                   help="run the injected-fault gauntlet (hang, crash, "
                        "oom, wrong output) through the sandbox, the "
                        "oracle, the online promotion path, the fleet "
                        "coordinator's assembly and a transfer's records")
    p.add_argument("--kernel", default=None,
                   help="registered kernel to check (non-demo mode)")
    p.add_argument("--problem", default="256,256,256",
                   help="comma-separated problem size")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--set", nargs="*", default=None, metavar="NAME=VALUE",
                   help="config overrides on top of the space default")
    p.add_argument("--device", default="cuda",
                   help="torch device the checks run on (cuda, or cpu for "
                        "the plain versions)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="spawned child's wall-clock ceiling in seconds, "
                        "from its start (demo)")
    p.add_argument("--memory-mb", type=int, default=None,
                   help="host-memory headroom of a CPU child in MiB (demo)")
    p.add_argument("--out", default=None,
                   help="write the verdict report JSON here")
    p.set_defaults(fn=_cmd_check)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
