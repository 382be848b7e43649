"""``python -m repro_torch.obs`` — snapshot / report / trace / demo.

Operator entry points over the observability artifacts (port of
``repro.obs.cli``):

* ``snapshot`` — merge metric snapshots (files and/or every snapshot
  published on a fleet bus directory) into one snapshot file;
* ``report``   — render the wisdom-health report from snapshot files, a
  saved Chrome trace, or a fleet bus directory;
* ``trace``    — validate a Chrome trace file and summarize it;
* ``demo``     — run the instrumented demo (launches on ``--device``, the
  card by default; ``--fleet`` adds a tiny local fleet) and write
  snapshot/trace/report artifacts.

Every command is deterministic given its inputs: the same snapshot
bytes always render the same report bytes.
"""

from __future__ import annotations

import argparse
import sys

from .metrics import load_snapshot, merge_snapshots, save_snapshot
from .report import render_report, snapshot_from_trace
from .trace import load_trace, validate_trace


def _bus_snapshots(bus_dir: str) -> list[dict]:
    from repro_torch.distrib.sync import DirectoryTransport
    from repro_torch.fleet.bus import ControlBus
    from repro_torch.fleet.health import fleet_snapshots
    return list(fleet_snapshots(ControlBus(DirectoryTransport(bus_dir)))
                .values())


def _gather(args: argparse.Namespace) -> dict:
    snaps = [load_snapshot(p) for p in args.snapshots]
    if args.trace:
        snaps.append(snapshot_from_trace(load_trace(args.trace)))
    if args.bus:
        snaps.extend(_bus_snapshots(args.bus))
    if not snaps:
        raise SystemExit("nothing to read: pass snapshot files, "
                         "--trace, or --bus")
    return snaps[0] if len(snaps) == 1 else merge_snapshots(snaps)


def _add_inputs(p: argparse.ArgumentParser) -> None:
    p.add_argument("snapshots", nargs="*",
                   help="metric snapshot JSON files")
    p.add_argument("--trace", help="saved Chrome trace to reduce to "
                                   "select.tier/latency series")
    p.add_argument("--bus", help="fleet bus directory: read every "
                                 "published fleet--metrics-- snapshot")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="metrics snapshots, Chrome traces, wisdom health")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("snapshot",
                       help="merge snapshots into one file")
    _add_inputs(p)
    p.add_argument("--out", required=True, help="output snapshot path")

    p = sub.add_parser("report", help="render the wisdom-health report")
    _add_inputs(p)
    p.add_argument("--top", type=int, default=10,
                   help="missing-scenario rows to show (default 10)")
    p.add_argument("--out", help="also write the report to this path")

    p = sub.add_parser("trace", help="validate + summarize a Chrome trace")
    p.add_argument("trace_file")

    p = sub.add_parser("demo", help="run the instrumented demo")
    p.add_argument("--out", default="obs-demo",
                   help="artifact directory (default obs-demo)")
    p.add_argument("--device", default="cuda",
                   help="torch device the launches run on (default cuda; "
                        "cpu runs the plain versions)")
    p.add_argument("--fleet", action="store_true",
                   help="add the local-fleet portion (its gate checks on "
                        "--device)")

    args = ap.parse_args(argv)

    if args.cmd == "snapshot":
        merged = _gather(args)
        path = save_snapshot(merged, args.out)
        print(f"wrote {path} ({len(merged.get('counters', {}))} counters, "
              f"{len(merged.get('gauges', {}))} gauges, "
              f"{len(merged.get('histograms', {}))} histograms)")
        return 0

    if args.cmd == "report":
        text = render_report(_gather(args), top=args.top)
        sys.stdout.write(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        return 0

    if args.cmd == "trace":
        try:
            doc = load_trace(args.trace_file)
        except ValueError as e:
            print(f"INVALID: {e}")
            return 1
        events = doc["traceEvents"]
        by_cat: dict[str, int] = {}
        for ev in events:
            by_cat[ev.get("cat", "?")] = by_cat.get(ev.get("cat", "?"), 0) + 1
        cats = " ".join(f"{c}={by_cat[c]}" for c in sorted(by_cat))
        print(f"valid Chrome trace: {len(events)} event(s) [{cats}]")
        print("open in https://ui.perfetto.dev or chrome://tracing")
        return 0

    if args.cmd == "demo":
        from .demo import run_demo
        art = run_demo(args.out, fleet=args.fleet, device=args.device)
        for name in ("snapshot", "fleet_snapshot", "trace", "report_path"):
            print(f"{name}: {art[name]}")
        sys.stdout.write("\n" + art["report"])
        return 0

    raise AssertionError(f"unhandled command {args.cmd!r}")


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(main())
