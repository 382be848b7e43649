"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 klbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which are also the last lines of standard
error. Without a CUDA device, or with fewer than the cell asks for, it
exits 2 and prints no result; with JAX or the JAX package loaded, 3.

Build and kernel caches stay inside the checkout: the program's nvcc
output in ``src/repro_torch/kernels/build/``, and PyTorch's extension,
Triton and inductor caches under ``.klbench-cache/``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def pin_environment() -> None:
    """Fix what the program reads from the environment: no tuning, capture,
    telemetry or profiling switched on from outside, the default wisdom
    directory, and caches at fixed paths in the checkout."""
    for key in [k for k in os.environ if k.startswith("KERNEL_LAUNCHER_")]:
        del os.environ[key]
    cache = CHECKOUT / ".klbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    for p in (str(CHECKOUT), str(CHECKOUT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def emit(result: dict) -> None:
    """The checks on standard error, then the result line on standard
    output, ``checks`` its last key."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_environment()
    os.chdir(CHECKOUT)
    from klbench import guard, harness

    bench = harness.benchmark(CHECKOUT)
    chips = harness.cell_entry(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"klbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.make_run(CHECKOUT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T0)
    readers = harness.metric_readers(bench, args.workload) \
        if args.trace else {}
    result = harness.execute(run, readers, guard=guard.check)
    guard.check()
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
