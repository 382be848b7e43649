"""Pre-tune every built-in kernel for the port's device kind by the cost
model and write the wisdom files, so a fresh deployment starts from tuned
configs instead of defaults (the paper's deployment story: wisdom files
are versioned application assets).

Port of ``repro.tuner.pretune``. The reference pretunes its simulated TPU
pair; the port pretunes ``gpu-h100`` with the analytical cost model on the
H100 spec (``objective="costmodel"``: no launch, no card needed). The card's
own times then replace these records as wall-clock tuning or online
promotion measures each scenario (a measured record beats a modelled one
only by score, so re-tune on the card before trusting them).

  PYTHONPATH=src python -m repro_torch.tuner.pretune --out wisdom-torch
"""

from __future__ import annotations

import argparse

from repro_torch.core import all_kernels
from repro_torch.tuner.tune import tune_kernel

# representative problem sizes per kernel family
PROBLEMS = {
    "advec_u": [(64, 64, 128), (256, 256, 256), (512, 512, 512)],
    "diff_uvw": [(64, 64, 128), (256, 256, 256), (512, 512, 512)],
    "matmul": [(512, 512, 1024), (4096, 4096, 4096), (8192, 8192, 8192)],
    "flash_attention_causal": [(256, 64, 4096, 128), (32, 8, 32768, 128)],
    "flash_attention_full": [(256, 64, 4096, 128)],
}
DEVICES = ("gpu-h100",)
DTYPES = ("bfloat16", "float32")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="wisdom-torch")
    ap.add_argument("--strategy", default="bayes")
    ap.add_argument("--evals", type=int, default=120)
    args = ap.parse_args(argv)

    for name, builder in sorted(all_kernels().items()):
        for problem in PROBLEMS.get(name, []):
            for device in DEVICES:
                for dtype in DTYPES:
                    res = tune_kernel(
                        builder, problem, dtype, device,
                        strategy=args.strategy, max_evals=args.evals,
                        time_budget_s=120, wisdom_dir=args.out,
                        objective="costmodel")
                    print(f"{name} {problem} {dtype} {device}: "
                          f"{res.best_score_us:.1f}us "
                          f"({len(res.evaluations)} evals)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
