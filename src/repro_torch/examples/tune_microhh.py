"""The paper's evaluation, miniaturized: tune both MicroHH kernels by wall
clock for every 256^3 scenario on this device, show the runtime selection
picking per-scenario winners, then launch both kernels at 512^3 — a grid
nobody tuned, served by a fallback tier — and check them against their plain
versions.

Port of ``examples/tune_microhh.py``. Run on the card (the default) or, at
the smoke grids with the plain versions, on the host:

    PYTHONPATH=src python -m repro_torch.examples.tune_microhh \
        [--max-evals 8] [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
import zlib

import torch

from repro_torch.configs.microhh import GRIDS, SMOKE_GRIDS, scenarios
from repro_torch.core import (WisdomKernel, current_device_kind, get_kernel,
                              resolve_device, torch_dtype)
from repro_torch.kernels.ops import pack_scalars
from repro_torch.tuner import tune_kernel, verify_outcome


def stable_seed(key: str) -> int:
    """Per-scenario rng seed. crc32, not hash(): the builtin is
    randomized per process (PYTHONHASHSEED)."""
    return zlib.crc32(key.encode()) % 2**31


def launch_args(kernel: str, grid, dtype: str, device: torch.device,
                seed: int = 0) -> list[torch.Tensor]:
    """Random fields for one launch, made on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_fields = 3 if kernel == "advec_u" else 4
    fields = [torch.randn(grid, generator=g, device=device)
              for _ in range(n_fields)]
    if kernel == "diff_uvw":
        fields[3] = fields[3].abs() + 0.1    # eddy viscosity is nonnegative
    fields = [f.to(torch_dtype(dtype)) for f in fields]
    return [*fields, pack_scalars(1.1, 0.9, 1.3, device)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-evals", type=int, default=8,
                    help="evaluation budget per scenario")
    ap.add_argument("--budget-seconds", type=float, default=120.0)
    ap.add_argument("--smoke", action="store_true",
                    help="tune and launch at the small smoke grids")
    ap.add_argument("--wisdom-dir", default=None,
                    help="keep the wisdom here (default: a temporary dir)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kind = current_device_kind(device)
    tune_grid, launch_grid = SMOKE_GRIDS if args.smoke else GRIDS

    with tempfile.TemporaryDirectory(prefix="kl-microhh-") as tmp:
        wisdom_dir = args.wisdom_dir or tmp
        scs = scenarios(grids=(tune_grid,), devices=(kind,))
        tuned = []
        for sc in scs:
            res = tune_kernel(get_kernel(sc.kernel), sc.grid, sc.dtype,
                              sc.device, strategy="bayes",
                              max_evals=args.max_evals,
                              time_budget_s=args.budget_seconds,
                              wisdom_dir=wisdom_dir,
                              seed=stable_seed(sc.key), device=device)
            if res.best_config is None:
                raise RuntimeError(f"{sc.key}: no feasible config in "
                                   f"{len(res.evaluations)} evaluations")
            n_ok = len(res.feasible_evaluations)
            print(f"tuned {sc.key:42s} best={res.best_score_us:9.1f}us "
                  f"evals={len(res.evaluations)} feasible={n_ok}")
            tuned.append((sc, res))

        print("\nruntime selection (paper §4.5):")
        selected = []
        for sc in scs:
            k = WisdomKernel(get_kernel(sc.kernel), wisdom_dir=wisdom_dir,
                             device_kind=sc.device)
            cfg, tier = k.select_config(sc.grid, sc.dtype)
            print(f"  {sc.key:42s} tier={tier:8s} config={cfg}")
            selected.append((sc, tier, cfg))

        g = launch_grid[0]
        print(f"\nlaunch at {g}^3 (untuned):")
        launched = []
        for name in ("advec_u", "diff_uvw"):
            k = WisdomKernel(get_kernel(name), wisdom_dir=wisdom_dir,
                             device_kind=kind)
            for dtype in ("float32", "bfloat16"):
                args_ = launch_args(name, launch_grid, dtype, device)
                out = k(*args_)
                st = k.stats[-1]
                want = k.builder.make_reference()(*args_)
                check = verify_outcome(out, want, dtype)
                if not check.ok:
                    raise RuntimeError(f"{name} {g}^3 {dtype}: {check.error}")
                print(f"  {name}-{g}^3-{dtype:9s} tier={st.tier:12s} "
                      f"launch={st.launch_s * 1e6:.1f}us "
                      f"max_err={check.max_err:.3e} config={st.config}")
                launched.append((name, dtype, st, check.max_err))
                del args_, out, want
    return {"tuned": tuned, "selected": selected, "launched": launched}


if __name__ == "__main__":
    main()
