"""The readings the limits of ``klbench/workloads/deepseek-v2-lite.
prefill-16k.json`` are set from, at the cell's own size, on the card:

* ``program``: a run of the cell (a short window) on each of ``--seeds``,
  its compared numbers;
* on each of ``--control-seeds``, after a run's window, the planted
  faults of ``prefill_mla_moe.VARIANTS`` put in the program's place:
  ``control:fp8`` (the reference in float8, one precision below the
  configuration's bf16), ``fault:renorm`` (top-k gates renormalised to sum
  1), ``fault:plain_rope`` (plain rope with the (nope + rope)^-0.5 scale)
  and ``fault:capacity`` (the program's MoE layers on the capacity path at
  a factor of 1.25, which drops pairs).

    python3 klbench/control_dsv2.py --seeds 1,2,3 --control-seeds 4 \
        --seconds 2

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

CELL = "deepseek-v2-lite.prefill-16k"
FAULTS = {"control:fp8": "fp8", "fault:renorm": "renorm",
          "fault:plain_rope": "plain_rope", "fault:capacity": "capacity"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pin_environment()
    from klbench import harness

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    def make(seed):
        return harness.make_run(CHECKOUT, CELL, seed, args.seconds, False,
                                args.device, time.perf_counter())

    for seed in seeds(args.seeds):
        res = harness.execute(make(seed), {})
        print(json.dumps({"seed": seed, "kind": "program",
                          "correct": res["correct"],
                          "readings": {k: v["value"] for k, v
                                       in res["checks"].items()}}),
              flush=True)
    for seed in seeds(args.control_seeds):
        run = make(seed)
        loop, _ = harness.measure(run, {})
        for kind, variant in FAULTS.items():
            checks = loop.check(variant)
            print(json.dumps({"seed": seed, "kind": kind,
                              "correct": all(c.ok for c in checks),
                              "readings": {c.name: c.value for c in checks},
                              "over_limit": {c.name: c.value / c.limit
                                             for c in checks if c.limit}}),
                  flush=True)
        del loop
        harness.release(run.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
