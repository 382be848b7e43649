"""``python -m repro_torch.prof`` — profile / report / roofline / diff / demo.

Operator entry points over kernel profiles (port of ``repro.prof.cli``):

* ``profile``  — profile one kernel scenario: join the config's workload
  with a latency and print the versioned :class:`KernelProfile` JSON. The
  latency is ``--latency-us`` when given; otherwise the config is built and
  launched once on the card and timed with CUDA events (the port has no
  cost model to simulate it), which raises on a host without a card;
* ``report``   — summarize saved profile documents (byte-deterministic);
* ``roofline`` — print a device's roofline (peaks, ridge points) and,
  given a scenario, where its config sits;
* ``diff``     — compare two saved profile documents (latency deltas,
  bottleneck changes);
* ``demo``     — run the instrumented demo and write every artifact.

``report --datasets`` and ``demo --datasets`` read recorded tuning spaces,
which need ``repro.tunebench``: not ported yet (ROADMAP.md queue 1 item
13), so both raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.device import get_device

from .profile import profile_from_workload
from .profiler import load_profiles
from .report import render_attribution, render_profiles


def _parse_config(raw: str | None) -> dict | None:
    if not raw:
        return None
    out = {}
    for part in raw.split(","):
        k, _, v = part.partition("=")
        if not _:
            raise SystemExit(f"bad --config item {part!r} (want key=value)")
        try:
            out[k.strip()] = int(v)
        except ValueError:
            out[k.strip()] = v.strip()
    return out


def _problem(raw: str) -> tuple[int, ...]:
    return tuple(int(x) for x in raw.split(",") if x)


def _measure_us(builder, config: dict, problem: tuple[int, ...],
                dtype: str) -> float:
    """One launch of ``config`` on the card, timed with CUDA events after
    a launch that checks it against the plain version and a warm-up, the
    L2 flushed before it (the tuner's evaluator, one repeat)."""
    from repro_torch.core.device import resolve_device
    from repro_torch.tuner.runner import WallClockEvaluator

    device = resolve_device("cuda")
    ev = WallClockEvaluator(builder, builder.make_probe_args(problem, dtype),
                            device=device, repeats=1)
    r = ev(config)
    if not r.feasible:
        raise SystemExit(f"config {config} failed on the card: {r.error}")
    return r.score_us


def _cmd_profile(args) -> int:
    from repro_torch.core.registry import get_kernel

    builder = get_kernel(args.kernel)
    problem = _problem(args.problem)
    device = get_device(args.device)
    config = _parse_config(args.config) or builder.default_config()
    w = builder.make_workload(config, problem, args.dtype)
    if not w.valid:
        print(f"config {config} is infeasible for {problem}")
        return 1
    if args.latency_us is not None:
        latency = float(args.latency_us)
    else:
        latency = _measure_us(builder, config, problem, args.dtype)
    p = profile_from_workload(w, device, args.dtype, latency,
                              kernel=builder.name, problem_size=problem,
                              config=config)
    doc = json.dumps(p.to_json(), indent=2, sort_keys=True)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    print(f"# {p.bottleneck}-bound, roofline fraction "
          f"{p.roofline_fraction:.3f}, AI {p.arithmetic_intensity:.2f}",
          file=sys.stderr)
    return 0


def _cmd_report(args) -> int:
    if args.datasets:
        render_attribution(args.datasets)   # raises: not ported yet
    profiles = []
    for path in args.profiles:
        profiles.extend(load_profiles(path))
    text = render_profiles(profiles)
    sys.stdout.write(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


def _cmd_roofline(args) -> int:
    device = get_device(args.device)
    rows = [
        ("peak bf16", f"{device.flops_bf16 / 1e12:.1f} TFLOP/s"),
        ("peak f32", f"{device.flops_f32 / 1e12:.1f} TFLOP/s"),
        ("memory bandwidth", f"{device.hbm_bw / 1e9:.0f} GB/s"),
        ("link bandwidth", f"{device.ici_bw / 1e9:.0f} GB/s"),
        ("on-chip memory", f"{device.vmem_bytes // 2**10} KiB"),
        ("ridge AI bf16", f"{device.flops_bf16 / device.hbm_bw:.1f} "
                          f"FLOP/byte"),
        ("ridge AI f32", f"{device.flops_f32 / device.hbm_bw:.1f} "
                         f"FLOP/byte"),
    ]
    print(f"roofline: {device.kind} (family {device.family}, "
          f"backend {device.backend})"
          + (" — ESTIMATED peaks cloned from the "
             f"{device.backend} baseline; every roof below is a guess"
             if device.estimated else ""))
    for k, v in rows:
        print(f"  {k:18} {v}")
    if args.kernel:
        from repro_torch.core.registry import get_kernel
        builder = get_kernel(args.kernel)
        problem = _problem(args.problem)
        config = _parse_config(args.config) or builder.default_config()
        w = builder.make_workload(config, problem, args.dtype)
        p = profile_from_workload(w, device, args.dtype, 0.0,
                                  kernel=builder.name,
                                  problem_size=problem, config=config)
        print(f"  {builder.name} @ {problem} {args.dtype}: "
              f"AI={p.arithmetic_intensity:.2f} -> {p.bottleneck}-bound "
              f"(compute {p.compute_us:.3f}us vs memory "
              f"{p.memory_us:.3f}us)")
    return 0


def _cmd_diff(args) -> int:
    a = {(p.kernel, p.device_kind, p.problem_size, p.dtype): p
         for p in load_profiles(args.a)}
    b = {(p.kernel, p.device_kind, p.problem_size, p.dtype): p
         for p in load_profiles(args.b)}
    changed = 0
    for key in sorted(set(a) | set(b)):
        ka = a.get(key)
        kb = b.get(key)
        name = f"{key[0]} {key[1]}|{'x'.join(map(str, key[2]))}|{key[3]}"
        if ka is None or kb is None:
            print(f"{name}: only in {'b' if ka is None else 'a'}")
            changed += 1
            continue
        ratio = (kb.latency_us / ka.latency_us
                 if ka.latency_us > 0 else float("inf"))
        mark = ""
        if kb.bottleneck != ka.bottleneck:
            mark += f" bottleneck {ka.bottleneck}->{kb.bottleneck}"
        if abs(ratio - 1.0) > args.tolerance:
            mark += f" latency x{ratio:.3f}"
        if mark:
            print(f"{name}:{mark}")
            changed += 1
        else:
            print(f"{name}: unchanged (x{ratio:.3f})")
    print(f"{changed} profile(s) changed")
    return 1 if (changed and args.check) else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.prof",
        description="kernel profiles: roofline counters and bottleneck "
                    "attribution")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("profile", help="profile one kernel scenario")
    p.add_argument("--kernel", required=True)
    p.add_argument("--problem", required=True,
                   help="comma-separated problem size, e.g. 512,512,512")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="gpu-h100",
                   help="device spec whose peaks the roofline uses")
    p.add_argument("--config", help="key=value,... (default: the "
                                    "kernel's default config)")
    p.add_argument("--latency-us", type=float,
                   help="measured latency; default: launch the config "
                        "once on the card and time it with CUDA events")
    p.add_argument("--out", help="also write the profile JSON here")

    p = sub.add_parser("report",
                       help="launch-profile report (byte-deterministic)")
    p.add_argument("--datasets",
                   help="recorded tuning-space glob (not ported yet)")
    p.add_argument("--profiles", nargs="*", default=[],
                   help="saved .prof.json documents to summarize")
    p.add_argument("--out", help="also write the report to this path")

    p = sub.add_parser("roofline", help="device roofline + ridge points")
    p.add_argument("--device", default="gpu-h100")
    p.add_argument("--kernel", help="also place this kernel's config "
                                    "on the roofline")
    p.add_argument("--problem", default="512,512,512")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--config")

    p = sub.add_parser("diff", help="compare two profile documents")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--tolerance", type=float, default=0.10,
                   help="latency ratio considered unchanged "
                        "(default 0.10)")
    p.add_argument("--check", action="store_true",
                   help="exit non-zero if anything changed")

    p = sub.add_parser("demo", help="run the instrumented profiler demo")
    p.add_argument("--out", default="prof-demo",
                   help="artifact directory (default prof-demo)")
    p.add_argument("--device", default="cuda",
                   help="torch device the launches run on (default cuda; "
                        "cpu runs the plain versions)")
    p.add_argument("--datasets",
                   help="recorded tuning-space glob (not ported yet)")

    args = ap.parse_args(argv)

    if args.cmd == "profile":
        return _cmd_profile(args)
    if args.cmd == "report":
        return _cmd_report(args)
    if args.cmd == "roofline":
        return _cmd_roofline(args)
    if args.cmd == "diff":
        return _cmd_diff(args)
    if args.cmd == "demo":
        from .demo import run_demo
        art = run_demo(args.out, device=args.device,
                       dataset_glob=args.datasets)
        for name in ("profiles", "trace", "snapshot", "report_path"):
            print(f"{name}: {art[name]}")
        print(f"profiles recorded: {art['n_profiles']} "
              f"(drift events: {art['drift_events']})")
        sys.stdout.write("\n" + art["report"])
        return 0
    raise AssertionError(f"unhandled command {args.cmd!r}")


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(main())
