#!/usr/bin/env python3
"""Build the stencils' tile body at the tightest register budget the
tuning space allows and print what ptxas reports for each kernel.

    python3 tools/stencil_ptxas.py

A tile config may ask ``__launch_bounds__`` for up to 1024 threads an SM
(``block_size_x * block_size_y * min_blocks_per_sm``), which leaves a
thread 64 registers. This builds, for every 2-D block shape of the space,
the config that reaches that bound, for advec_u.cu and diff_uvw.cu (whose
builds hold both its tile kernels, fused and single-field), with
``nvcc -Xptxas -v`` (one nvcc each, all started together), and prints one
line per kernel instantiation: registers, spill stores and spill loads.
Exits non-zero if a build fails or any instantiation spills. Needs nvcc;
runs on the card's machine.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import get_kernel  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._stencil_common import stencil_defines  # noqa: E402

SOURCES = {"advec_u": "advec_u.cu", "diff_uvw": "diff_uvw.cu"}
PROPS = re.compile(r"Function properties for (\S*tile_kernel\S*)")
KERNEL = re.compile(r"[a-z][a-z_]*_tile_kernel")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def tight_configs(name: str) -> list[dict]:
    """One valid tile config a block shape, at 1024 threads an SM."""
    space = get_kernel(name).space
    seen, out = set(), []
    for cfg in space.enumerate():
        shape = (cfg["block_size_x"], cfg["block_size_y"])
        threads = shape[0] * shape[1]
        if (cfg["body"] == "tile" and shape not in seen
                and threads * cfg["min_blocks_per_sm"] == 1024):
            seen.add(shape)
            out.append(cfg)
    return out


def instantiation(mangled: str) -> str:
    dtype = "bf16" if "bfloat16" in mangled else "f32"
    return dtype + (" 16-byte" if "Lb1E" in mangled else " element")


def main() -> int:
    procs = []
    with tempfile.TemporaryDirectory(prefix="stencil-ptxas-") as tmp:
        for name, src in SOURCES.items():
            for i, cfg in enumerate(tight_configs(name)):
                cmd = _build.nvcc_command(src, stencil_defines(cfg),
                                          Path(tmp) / f"{name}-{i}.so")
                procs.append((src, cfg, subprocess.Popen(
                    [*cmd, "-Xptxas", "-v"], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)))
        bad = 0
        for src, cfg, proc in procs:
            _, err = proc.communicate()
            label = (f"{src} {cfg['block_size_x']}x{cfg['block_size_y']} "
                     f"min_blocks {cfg['min_blocks_per_sm']}")
            if proc.returncode:
                print(f"{label}: nvcc failed\n{err}")
                bad += 1
                continue
            lines = err.splitlines()
            for i, line in enumerate(lines):
                m = PROPS.search(line)
                if not m:
                    continue
                spill = SPILL.search(lines[i + 1])
                regs = REGS.search(lines[i + 2])
                stores, loads = int(spill.group(1)), int(spill.group(2))
                bad += bool(stores or loads)
                print(f"{label} {KERNEL.search(m.group(1)).group(0)} "
                      f"{instantiation(m.group(1))}: "
                      f"{regs.group(1)} registers, {stores} bytes spill "
                      f"stores, {loads} bytes spill loads")
    print(f"{len(procs)} builds, {bad} with a spill or a failure")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
