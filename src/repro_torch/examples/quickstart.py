"""Quickstart: the Kernel Launcher flow on the matmul kernel, end to end.

  1. launch a tunable kernel (default config),
  2. capture the launch (KERNEL_LAUNCHER_CAPTURE),
  3. replay-tune it on this device by wall clock,
  4. relaunch: the wisdom-selected config now wins (tier "exact").

Port of ``examples/quickstart.py``. Run on the card (the default) or, with
the plain PyTorch version, on the host:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import (WisdomKernel, current_device_kind, get_kernel,
                              list_captures, resolve_device)
from repro_torch.core.capture import CAPTURE_DIR_ENV, CAPTURE_ENV
from repro_torch.tuner import tune_capture, verify_outcome


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block, restoring them after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--max-evals", type=int, default=20)
    ap.add_argument("--budget-seconds", type=float, default=120.0)
    ap.add_argument("--wisdom-dir", default=None,
                    help="keep the wisdom here (default: a temporary dir)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kind = current_device_kind(device)

    rng = np.random.default_rng(0)
    a = torch.from_numpy(
        rng.standard_normal((args.m, args.k)).astype(np.float32)).to(device)
    b = torch.from_numpy(
        rng.standard_normal((args.k, args.n)).astype(np.float32)).to(device)

    with tempfile.TemporaryDirectory(prefix="kl-quickstart-") as tmp:
        wisdom_dir = args.wisdom_dir or f"{tmp}/wisdom"
        kernel = WisdomKernel(get_kernel("matmul"), wisdom_dir=wisdom_dir,
                              device_kind=kind)
        # 1+2: launch (runs + captures)
        with _env(**{CAPTURE_ENV: "matmul",
                     CAPTURE_DIR_ENV: f"{tmp}/captures"}):
            c = kernel(a, b)
        st1 = kernel.stats[-1]
        print(f"launch #1: tier={st1.tier} config={st1.config}")

        # 3: replay the capture through the tuner (Bayesian, wall clock)
        cap = list_captures(f"{tmp}/captures")[0]
        res = tune_capture(cap, kind, strategy="bayes",
                           max_evals=args.max_evals,
                           time_budget_s=args.budget_seconds,
                           wisdom_dir=wisdom_dir, device=device)
        print(f"tuned on {kind}: best={res.best_score_us:.1f}us after "
              f"{len(res.evaluations)} evals -> {res.best_config}")

        # 4: relaunch — runtime selection now finds the tuned record
        kernel.invalidate()
        c2 = kernel(a, b)
        st2 = kernel.stats[-1]
        print(f"launch #2: tier={st2.tier} config={st2.config}")
    check = verify_outcome(c2, c, "float32")
    if not check.ok:
        raise RuntimeError(f"relaunch disagrees with launch #1: {check.error}")
    default_us = res.evaluations[0].score_us
    print(f"wall clock on {kind}: default={default_us:.1f}us "
          f"tuned={res.best_score_us:.1f}us "
          f"({default_us / res.best_score_us:.2f}x)")
    return {"a": a, "b": b, "c": c, "c2": c2, "tiers": (st1.tier, st2.tier),
            "stats": kernel.stats, "result": res, "default_us": default_us,
            "max_err": check.max_err}


if __name__ == "__main__":
    main()
