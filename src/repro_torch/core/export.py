"""Compile-time kernel selection — the *baseline* the paper compares
against (paper §3: Kernel Tuner's generated C headers). Port of
``repro.core.export``.

``export_header`` bakes the best known config per device into a static
table (one "header" per kernel, JSON + a C header of ``#define``s, the
same files the reference writes from the same wisdom); ``StaticKernel``
consumes the baked table the way a Make/CMake target would: the config is
fixed at "build" time for one device, with **no problem-size dispatch and
no fuzzy matching** — exactly the limitation the paper's runtime selection
removes (recompile per GPU, one config per build). On CUDA the baked
header is literally what ``kernels/_build.py`` compiles: the config's
tunables as ``-D`` defines, built through ``builder.make`` and its nvcc
cache like every other launch.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from .builder import KernelBuilder, args_meta
from .device import resolve_device
from .param import Config
from .wisdom import Wisdom


def export_header(kernel_name: str, device_kind: str,
                  wisdom_dir: Path | str | None = None,
                  out_dir: Path | str = "generated",
                  reference_problem: tuple[int, ...] | None = None) -> Path:
    """Bake the best config for (kernel, device) into a static header.

    Mirrors Kernel Tuner's ``store_defaults``-style export: if multiple
    problem sizes were tuned, the one closest to ``reference_problem``
    (or the best-scoring record) wins — the compile-time approach cannot
    dispatch on problem size at run time."""
    wisdom = Wisdom.load(kernel_name, wisdom_dir)
    recs = [r for r in wisdom.records if r.device_kind == device_kind]
    if not recs:
        raise FileNotFoundError(
            f"no wisdom for {kernel_name!r} on {device_kind!r}; tune first")
    if reference_problem is not None:
        cfg, _ = wisdom.select(device_kind, reference_problem,
                               recs[0].dtype, recs[0].config)
    else:
        cfg = min(recs, key=lambda r: r.score_us).config

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    doc = {"kernel": kernel_name, "device": device_kind, "config": cfg}
    jpath = out / f"{kernel_name}-{device_kind}.header.json"
    with open(jpath, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    # C-header rendering, for fidelity with the paper's workflow
    hpath = out / f"{kernel_name}-{device_kind}.h"
    guard = f"{kernel_name}_{device_kind}".upper().replace("-", "_")
    lines = [f"#ifndef {guard}_H", f"#define {guard}_H", ""]
    for k, v in sorted(cfg.items()):
        macro = f"{kernel_name}_{k}".upper().replace("-", "_")
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, str):
            v = f'"{v}"'
        lines.append(f"#define {macro} {v}")
    lines += ["", "#endif", ""]
    hpath.write_text("\n".join(lines))
    return jpath


def load_header(path: Path | str) -> dict:
    with open(path) as f:
        return json.load(f)


class StaticKernel:
    """Compile-time-selected kernel: one fixed config per build/device.
    No wisdom lookups, no per-problem dispatch — the paper's baseline.

    ``device`` is the torch device the kernel runs on: the card by default
    (raises where there is none), ``"cpu"`` for the plain PyTorch version.
    Arguments must live there. Each argument shape builds the header's
    config once (nvcc, for CUDA tensors) and reuses it after.

    Example::

        k = StaticKernel(get_kernel("advec_u"),
                         export_header("advec_u", "gpu-h100"))
        ut = k(u, v, w, scal)
    """

    def __init__(self, builder: KernelBuilder, header_path: Path | str,
                 device: str | torch.device = "cuda"):
        self.builder = builder
        doc = load_header(header_path)
        if doc["kernel"] != builder.name:
            raise ValueError(
                f"header is for {doc['kernel']!r}, not {builder.name!r}")
        self.config: Config = doc["config"]
        self.device_kind: str = doc["device"]
        self.device = resolve_device(device)
        self._compiled: dict = {}

    def __call__(self, *args):
        meta = args_meta(*args)
        if any(m.shape and m.device.type != self.device.type
               for m in meta):
            raise ValueError(f"StaticKernel({self.builder.name!r}) runs on "
                             f"{self.device}; got arguments on "
                             f"{sorted({str(m.device) for m in meta})}")
        key = tuple((m.shape, m.dtype) for m in meta)
        fn = self._compiled.get(key)
        if fn is None:
            fn = self._compiled[key] = self.builder.make(self.config, meta)
        return fn(*args)
