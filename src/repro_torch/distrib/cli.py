"""``python -m repro_torch.wisdom`` — operator CLI for wisdom stores.

Port of ``repro.distrib.cli``: the same subcommands, stdout and exit codes
on the same stores. ``--dir`` defaults to the port's own wisdom directory
(``default_wisdom_dir()``: ``$KERNEL_LAUNCHER_WISDOM_DIR`` or
``./wisdom-torch``), never the reference's ``./wisdom``.

Beyond-paper (the management counterpart of the paper's §4.3 tuning
script): the paper ships a command-line tool for *producing* wisdom files;
this one is for *operating* them at fleet scale. Subcommands:

  inspect    summarize a store (kernels, scenarios, versions, provenance)
  diff       compare two stores scenario-by-scenario
  merge      merge source stores into a destination (same engine ServeEngine
             pulls through, so CLI and runtime agree byte-for-byte)
  prune      drop redundant/old/off-device records
  validate   report schema problems; exit non-zero if any
  migrate    rewrite old-version files at the current WISDOM_VERSION

Every subcommand works on plain directories, so the CLI composes with
rsync/scp/NFS — the transports operators already have.
"""

from __future__ import annotations

import argparse

from repro_torch.core.wisdom import WISDOM_VERSION, WisdomVersionError

from .merge import merge_stores
from .store import WisdomStore


def _fmt_problem(problem) -> str:
    return "x".join(str(x) for x in problem)


def _cmd_inspect(args) -> int:
    store = WisdomStore(args.dir)
    kernels = [args.kernel] if args.kernel else store.kernels()
    if not kernels:
        print(f"{store.root}: empty store")
        return 0
    for name in kernels:
        try:
            wisdom = store.load(name)
        except WisdomVersionError as e:
            print(f"{name}: UNREADABLE — {e}")
            continue
        version = store.version_of(name)
        print(f"{name}: {len(wisdom)} record(s), version {version}")
        for rec in sorted(wisdom.records, key=lambda r: r.scenario()):
            prov = rec.provenance
            line = (f"  {rec.device_kind} {_fmt_problem(rec.problem_size)} "
                    f"{rec.dtype}: {rec.score_us:.2f}us "
                    f"config={rec.config}")
            if rec.is_transferred():
                line += (f" [transfer from "
                         f"{prov.get('source_device', '?')}, "
                         f"confidence {rec.transfer_confidence():.2f}]")
            if args.verbose:
                line += (f" strategy={prov.get('strategy', '?')}"
                         f" evals={rec.evaluations()}"
                         f" host={prov.get('host', '?')}"
                         f" lineage={len(rec.lineage)}")
            print(line)
    return 0


def _cmd_diff(args) -> int:
    a, b = WisdomStore(args.a), WisdomStore(args.b)
    differs = False
    for name in sorted(set(a.kernels()) | set(b.kernels())):
        recs_a = {r.scenario(): r for r in a.load(name).records}
        recs_b = {r.scenario(): r for r in b.load(name).records}
        for scen in sorted(set(recs_a) | set(recs_b)):
            ra, rb = recs_a.get(scen), recs_b.get(scen)
            where = f"{name} {scen[0]} {_fmt_problem(scen[1])} {scen[2]}"
            if ra is None:
                print(f"only in B: {where} ({rb.score_us:.2f}us)")
            elif rb is None:
                print(f"only in A: {where} ({ra.score_us:.2f}us)")
            elif ra.record_id() != rb.record_id():
                print(f"conflict:  {where} A={ra.score_us:.2f}us "
                      f"B={rb.score_us:.2f}us")
            else:
                continue
            differs = True
    if not differs:
        print("stores are identical (per record identity)")
    return 1 if differs else 0


def _cmd_merge(args) -> int:
    dest = WisdomStore(args.into)
    sources = [WisdomStore(s) for s in args.sources]
    report = merge_stores(dest, *sources)
    print(f"merged {len(sources)} store(s) into {dest.root}: "
          f"{report.summary()}")
    return 0


def _cmd_prune(args) -> int:
    store = WisdomStore(args.dir)
    report = store.prune(kernel=args.kernel, max_age_days=args.max_age_days,
                         device_kind=args.device)
    for name, n in sorted(report.dropped.items()):
        print(f"{name}: dropped {n} record(s)")
    print(f"pruned {report.total} record(s) total")
    return 0


def _cmd_validate(args) -> int:
    store = WisdomStore(args.dir)
    issues = store.validate()
    for issue in issues:
        print(issue)
    print(f"{store.root}: {len(store)} kernel file(s), "
          f"{len(issues)} issue(s)")
    return 1 if issues else 0


def _cmd_migrate(args) -> int:
    store = WisdomStore(args.dir)
    migrated = store.migrate()
    for name in migrated:
        print(f"{name}: migrated to version {WISDOM_VERSION}")
    print(f"{len(migrated)} file(s) migrated, "
          f"{len(store) - len(migrated)} already current")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.wisdom",
        description="Manage wisdom stores: inspect, diff, merge, prune, "
                    "validate, migrate.")
    sub = ap.add_subparsers(dest="command", required=True)

    def add_dir(p):
        p.add_argument("--dir", default=None,
                       help="wisdom directory (default: "
                            "$KERNEL_LAUNCHER_WISDOM_DIR or "
                            "./wisdom-torch)")

    p = sub.add_parser("inspect", help="summarize a wisdom store")
    add_dir(p)
    p.add_argument("kernel", nargs="?", help="limit to one kernel")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="include provenance + lineage counts")
    p.set_defaults(fn=_cmd_inspect)

    p = sub.add_parser("diff", help="compare two stores")
    p.add_argument("a", help="first store directory")
    p.add_argument("b", help="second store directory")
    p.set_defaults(fn=_cmd_diff)

    p = sub.add_parser("merge",
                       help="merge source stores into --into (statistical "
                            "winner per scenario, lineage preserved)")
    p.add_argument("--into", required=True, help="destination store")
    p.add_argument("sources", nargs="+", help="source store directories")
    p.set_defaults(fn=_cmd_merge)

    p = sub.add_parser("prune", help="drop redundant/old/off-device records")
    add_dir(p)
    p.add_argument("--kernel", default=None, help="limit to one kernel")
    p.add_argument("--max-age-days", type=float, default=None,
                   help="drop records older than this many days")
    p.add_argument("--device", default=None,
                   help="keep only records for this device kind")
    p.set_defaults(fn=_cmd_prune)

    p = sub.add_parser("validate", help="report schema problems (exit 1 "
                                        "if any)")
    add_dir(p)
    p.set_defaults(fn=_cmd_validate)

    p = sub.add_parser("migrate",
                       help=f"rewrite old files at version {WISDOM_VERSION}")
    add_dir(p)
    p.set_defaults(fn=_cmd_migrate)

    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except WisdomVersionError as e:
        # Version skew is an expected operator situation (old binary, newer
        # fleet), not a crash: print the guidance, exit distinctly.
        print(f"error: {e}")
        return 2


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
