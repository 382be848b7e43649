"""The readings the limits of ``klbench/workloads/<cell>.json`` are set
from, at the cell's own size, on the card:

* ``program``: a run of the cell (a short window) on each of ``--seeds``,
  its compared numbers;
* ``control``: on each of ``--control-seeds``, the reference in the
  precision below the configuration's put in the program's place (bf16
  for the f32 stencils, float8 for the bf16 decoder);
* ``fault:half_batch`` (training): the reference put in the program's
  place, fed half of each batch and taking the mean over it.

    python3 klbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 2

One JSON line a reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from klbench.run import CHECKOUT, pin_environment  # noqa: E402


def readings(checks) -> dict:
    return {c.name: c.value for c in checks}


def control_checks(loop, run) -> dict:
    """kind -> checks of the controls (and planted faults) of ``loop``,
    whose program has run its set-up and window and been released."""
    from klbench.loops import train
    kind = run.traffic["loop"]
    if kind == "stencil_steps":
        return {"control": loop.check(loop.control_outputs())}
    if kind == "prefill":
        return {"control": loop.check(fp8_control=True)}
    ref = loop.reference()
    b = run.traffic["batch"]
    return {"control": train.readings_checks(loop.reference(fp8=True), ref,
                                             run.limits),
            "fault:half_batch": train.readings_checks(
                loop.reference(rows=slice(0, b // 2)), ref, run.limits)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    pin_environment()
    from klbench import harness

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    for seed in seeds(args.seeds):
        run = harness.make_run(CHECKOUT, args.workload, seed, args.seconds,
                               False, "cuda", time.perf_counter())
        res = harness.execute(run, {})
        print(json.dumps({"seed": seed, "kind": "program",
                          "correct": res["correct"],
                          "readings": {k: v["value"] for k, v
                                       in res["checks"].items()}}),
              flush=True)
    for seed in seeds(args.control_seeds):
        run = harness.make_run(CHECKOUT, args.workload, seed, args.seconds,
                               False, "cuda", time.perf_counter())
        loop, _ = harness.measure(run, {})
        for kind, checks in control_checks(loop, run).items():
            print(json.dumps({"seed": seed, "kind": kind,
                              "readings": readings(checks)}), flush=True)
        del loop
        harness.release(run.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
