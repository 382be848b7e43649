"""Online autotuning demo: wisdom misses become tuning work, live.

A matmul WisdomKernel starts with an *empty* wisdom dir — every launch
falls through the §4.5 heuristic to the default config. With the online
tuner attached, synthetic traffic drives the whole loop:

  miss detection -> budgeted cost-model screening -> epsilon-greedy live
  trials (successive halving) -> the winner passes the correctness gate on
  the launch's device -> promoted into wisdom with ``online`` provenance ->
  the next launch selects it at tier "exact".

Port of ``examples/online_serving.py``. Run on the card (the default) or,
with the plain PyTorch version, on the host:

    PYTHONPATH=src python -m repro_torch.examples.online_serving \
        [--device cpu] [--objective wallclock]

With ``--objective wallclock`` the trials are scored by their launches'
CUDA-event times instead of the cost model.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import (Wisdom, WisdomKernel, current_device_kind,
                              get_device, get_kernel, resolve_device)
from repro_torch.online import enable_online_tuning
from repro_torch.tuner import CostModelEvaluator, tune_exhaustive


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--objective", default="costmodel",
                    choices=("costmodel", "wallclock"))
    ap.add_argument("--size", type=int, default=256,
                    help="m = n = k of the matmul")
    ap.add_argument("--launches", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wisdom-dir", default=None,
                    help="keep the wisdom here (default: a temporary dir)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kind = current_device_kind(device)
    wisdom_dir = args.wisdom_dir or os.path.join(
        tempfile.mkdtemp(prefix="kl-online-"), "wisdom")
    problem = (args.size,) * 3

    builder = get_kernel("matmul")
    kernel = WisdomKernel(builder, wisdom_dir=wisdom_dir, device_kind=kind)
    svc = enable_online_tuning(kernel, objective=args.objective,
                               seed=args.seed)

    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((args.size, args.size))
                             .astype(np.float32)).to(device)
            for _ in range(2))

    ev = CostModelEvaluator(builder, problem, "float32", get_device(kind),
                            verify="none")
    offline = tune_exhaustive(builder.space, ev)
    print(f"offline optimum on {kind} (cost model, exhaustive, "
          f"{len(offline.evaluations)} evals): "
          f"{offline.best_score_us:.2f}us  {offline.best_config}")

    last_tier = None
    for i in range(1, args.launches + 1):
        kernel(a, b)
        st = kernel.stats[-1]
        if st.tier != last_tier:
            print(f"launch {i:3d}: tier -> {st.tier:8s} (modelled "
                  f"{ev(st.config).score_us:7.2f}us, launch "
                  f"{st.launch_s * 1e6:8.1f}us)")
            last_tier = st.tier
        if svc.promotions() and st.tier == "exact":
            break

    s = svc.status()
    out = {"kernel": kernel, "service": svc, "status": s,
           "offline": offline, "wisdom_dir": wisdom_dir}
    if svc.promotions():
        promo = svc.promotions()[0]
        print(f"\npromoted after {s['launches']} launches: "
              f"{promo.record.config}")
        ratio = ev(promo.record.config).score_us / offline.best_score_us
        print(f"  incumbent was {promo.incumbent_score_us:.2f}us, promoted "
              f"{promo.record.score_us:.2f}us "
              f"({100 * promo.improvement:.0f}% faster); modelled ratio to "
              f"the offline optimum {ratio:.3f}")
        print(f"  provenance: strategy={promo.record.provenance['strategy']}"
              f" evals={promo.record.provenance['evaluations']} "
              f"live={promo.record.provenance['live_measurements']} "
              f"verified={promo.record.oracle_verified()}")
        swap = kernel.stats[-1]
        print(f"  swap launch: tier {swap.tier}, compile "
              f"{swap.compile_s:.3f}s, cached {swap.cached}")
    else:
        print(f"\nno promotion in {s['launches']} launches: "
              f"{[e[0] for e in svc.events]}")
    print(f"\ntraffic: {s['launches']} launches, {s['trials']} trials "
          f"({100 * s['trials'] / max(s['launches'], 1):.0f}%), "
          f"{s['screens']} cost-model screens, "
          f"{1e6 * s['overhead_per_launch_s']:.0f}us overhead/launch")
    w = Wisdom.load("matmul", wisdom_dir)
    print(f"wisdom file now holds {len(w)} record(s) at {wisdom_dir}")
    return out


if __name__ == "__main__":
    main()
