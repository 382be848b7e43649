#!/usr/bin/env python3
"""Time the stencils' two bodies over a grid of configs on the card.

    python3 tools/stencil_sweep.py [--out FILE]

For K1 (advec_u), K2a (diff_uvw, fused) and K2b (diff_uvw, single-field:
one call is three launches) at 256^3 and 512^3, in float32 and bfloat16,
this times

* the tile body: each block of ``TILE_BLOCKS`` at every ``strip_z`` and
  every ``min_blocks_per_sm`` its space allows;
* K1's ldg body: every config of ``LDG_GRID`` (block x 32-256, y 1-8,
  tile factor 1-8, 1 or 2 blocks an SM, unravel xyz) and the configs the
  MicroHH tuner picked for the ldg-only space before the tile body
  (``LDG_EARLIER``).

Each config is first held against the plain version at 256^3 under the
tuner's tolerance. Times are chip_smoke.py's: the median of 10 launches,
each after a 64 MiB L2 flush, by CUDA events. One JSON line a timed config
goes to FILE (default chiprun_out/stencil_sweep.jsonl); standard output
gets, for each (kernel, grid, dtype), the best config of each body beside
the bound, each tile block's time at each strip, and last a JSON count of
the (kernel, grid, dtype, block, blocks an SM) cases each strip wins or
comes within 2 % of. Builds every library first (one nvcc each, all
started together; K2a's tile configs share K2b's libraries). Needs the
card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from chip_smoke import get_kernel, stencil_defines  # noqa: E402

KERNELS = ("advec_u", "diff_uvw_fused", "diff_uvw_single")
GRIDS = (256, 512)
TILE_BLOCKS = ((32, 2), (32, 4), (32, 8), (64, 2), (64, 4), (64, 8),
               (128, 2), (128, 4), (256, 2))
LDG_GRID = [{"body": "ldg", "block_size_x": bx, "block_size_y": by,
             "block_size_z": 1, "tile_factor_z": tf, "strip_z": 64,
             "unravel_permutation": "xyz", "min_blocks_per_sm": mb}
            for bx, by, tf, mb in itertools.product(
                (32, 64, 128, 256), (1, 2, 4, 8), (1, 2, 4, 8), (1, 2))]
#: The MicroHH tuner's picks for advec_u at 256^3 (f32, bf16) when the
#: space held the ldg body alone (chip_smoke.py phase 4, PR 15 run F).
LDG_EARLIER = [
    {"body": "ldg", "block_size_x": 256, "block_size_y": 4, "block_size_z": 1,
     "tile_factor_z": 8, "strip_z": 64, "unravel_permutation": "xyz",
     "min_blocks_per_sm": 1},
    {"body": "ldg", "block_size_x": 128, "block_size_y": 1, "block_size_z": 2,
     "tile_factor_z": 8, "strip_z": 64, "unravel_permutation": "yzx",
     "min_blocks_per_sm": 4},
]


def space_of(name: str):
    return get_kernel("advec_u" if name == "advec_u" else "diff_uvw").space


def tile_configs(name: str) -> list[dict]:
    """Each block of TILE_BLOCKS at every strip and every number of blocks
    an SM the space allows it."""
    space = space_of(name)
    out = []
    for (bx, by), mb, s in itertools.product(
            TILE_BLOCKS, (1, 2, 4), space.params["strip_z"].values):
        cfg = cs.kernel_cfg(name, {
            "body": "tile", "block_size_x": bx, "block_size_y": by,
            "block_size_z": 1, "tile_factor_z": 2, "strip_z": s,
            "unravel_permutation": "xyz", "min_blocks_per_sm": mb})
        if space.is_valid(cfg):
            out.append(cfg)
    return out


def ldg_configs() -> list[dict]:
    space = space_of("advec_u")
    out = [c for c in LDG_GRID if space.is_valid(c)]
    return out + [c for c in LDG_EARLIER if c not in out]


def label(cfg: dict) -> str:
    s = (f"{cfg['block_size_x']}x{cfg['block_size_y']}"
         f"x{cfg['block_size_z']} mb{cfg['min_blocks_per_sm']}")
    if cfg["body"] == "tile":
        return f"tile {s} strip {cfg['strip_z']}"
    return (f"ldg {s} tf{cfg['tile_factor_z']} "
            f"{cfg['unravel_permutation']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                          / "stencil_sweep.jsonl"))
    args = ap.parse_args()
    if not cs.torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    configs = {name: tile_configs(name) for name in KERNELS}
    configs["advec_u"] += ldg_configs()
    specs = {(cs.SOURCES[name], stencil_defines(c))
             for name, cfgs in configs.items() for c in cfgs}
    t0 = cs.time.perf_counter()
    cs._build.build_many(sorted(specs))
    print(f"built {len(specs)} libraries in "
          f"{cs.time.perf_counter() - t0:.1f} s", flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    with out.open("w") as fh:
        for name, dtype in itertools.product(KERNELS, cs.DTYPES):
            small = cs.stencil_args("diff_uvw_fused", (256,) * 3, dtype)
            small = small[:3] + small[4:] if name == "advec_u" else small
            for cfg in configs[name]:
                cs.compare(name, cfg, small, dtype, "256^3", verbose=False)
            for g in GRIDS:
                shape = (g, g, g)
                a = small if g == 256 else cs.stencil_args(
                    "diff_uvw_fused", shape, dtype)
                if g != 256 and name == "advec_u":
                    a = a[:3] + a[4:]
                bound_ms, _ = cs.bound(name, shape, dtype,
                                       cs.kernel_cfg(name, {}))
                for cfg in configs[name]:
                    ms = cs.time_ms(cs.calls(name, cfg, a)[0])
                    row = {"kernel": name, "grid": g, "dtype": dtype,
                           "body": cfg["body"], "config": cfg, "ms": ms,
                           "bound_ms": bound_ms}
                    fh.write(json.dumps(row) + "\n")
                    rows.append(row)
                del a
            del small
            cs.torch.cuda.empty_cache()

    wins = {s: 0 for s in space_of("advec_u").params["strip_z"].values}
    near = dict(wins)
    for (name, dtype), g in itertools.product(
            itertools.product(KERNELS, cs.DTYPES), GRIDS):
        case = [r for r in rows if (r["kernel"], r["grid"], r["dtype"])
                == (name, g, dtype)]
        for body in ("tile", "ldg"):
            mine = [r for r in case if r["body"] == body]
            if not mine:
                continue
            best = min(mine, key=lambda r: r["ms"])
            print(f"best {name:15s} {g}^3 {dtype:8s} {body:4s} "
                  f"{best['ms']:.4f} ms ({best['bound_ms'] / best['ms']:.1%}"
                  f" of the {best['bound_ms']:.4f} ms bound) "
                  f"{label(best['config'])} of {len(mine)}", flush=True)
        if name == "advec_u":
            for c in LDG_EARLIER:
                r = next(r for r in case if r["config"] == c)
                print(f"     {name:15s} {g}^3 {dtype:8s} earlier ldg pick "
                      f"{r['ms']:.4f} ms {label(c)}")
        for (bx, by), mb in itertools.product(TILE_BLOCKS, (1, 2, 4)):
            blk = [r for r in case if r["body"] == "tile"
                   and (r["config"]["block_size_x"],
                        r["config"]["block_size_y"],
                        r["config"]["min_blocks_per_sm"]) == (bx, by, mb)]
            if not blk:
                continue
            fastest = min(r["ms"] for r in blk)
            for r in blk:
                s = r["config"]["strip_z"]
                wins[s] += r["ms"] == fastest
                near[s] += r["ms"] <= 1.02 * fastest
            print(f"strip {name:15s} {g}^3 {dtype:8s} {bx}x{by} mb{mb}: "
                  + ", ".join(f"{r['config']['strip_z']} {r['ms']:.4f}"
                              for r in blk))
    print("strip_wins " + json.dumps({"fastest": wins, "within_2pct": near}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
