#!/usr/bin/env python3
"""Drive the port's main path on one H100 and check every kernel on it.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:

1. environment: torch, CUDA and nvcc versions, the card's name, capability
   (must be 9.0) and power limit;
2. build every kernel of the paths from ``src/repro_torch/kernels/csrc``
   (one nvcc per source and config, all started together) and hold each
   CUDA kernel against its plain PyTorch version on the card: the stencils
   on the small test shapes and a ragged (5, 7, 9) in float32 and
   bfloat16, in three ldg configs and four tile ones (K1, K2a and K2b), and
   at the MicroHH grids 256^3 and 512^3 in the default and both bodies,
   each launch counted under the body its config names; matmul in five
   configs (both bodies, split_k 1/2/4, stages 2-4) at its test shapes, a
   ragged one, a bfloat16 one that TMA cannot take, (m, n, k) = (512, 512,
   1024) and 8192^3 in float32 and bfloat16 (naming the body each case
   ran), flash attention at GQA 4/4, 4/2 and
   8/1, causal and full, S 256, 512 and a ragged 200, D 128, in four
   configs (bfloat16 runs two in the wgmma body and two in the mma body;
   each line names them), and at the LM slice's prefill shape BH 128 x
   S 2048 x D 128 in bfloat16 in three configs, both bodies;
3. the quickstart loop: matmul (512, 512, 1024) float32, capture ->
   wall-clock tune (bayes, 20 evaluations) -> relaunch in tier "exact",
   equal to the first launch;
4. the MicroHH loop: tune advec_u and diff_uvw at 256^3 in float32 and
   bfloat16, select each in tier "exact", then launch both at 512^3 through a
   fallback tier and check them against their plain versions; the stencils'
   launches are printed by body and by (body, dtype), and advec_u must have
   run its tile body;
5. the LM slice on codeqwen1.5-7b at full width: (a) in float32 with 2
   layers, prefill logits (flash kernel) against the same prompt fed token
   by token through decode_step; (b) in bfloat16 with all 32 layers, prefill
   4 x 2048 tokens (32 flash launches each, all in the wgmma body) and 32
   greedy decode steps; (c) bfloat16 prefill of 256 tokens against
   decode_step; (d) capture the prefill's attention launch, tune it (8
   evaluations), and the next prefill selects tier "exact"; (e)
   ServeEngine in token mode answers 8 requests;
6. times from CUDA events beside each kernel's bound, its plain version's
   time and, for matmul and flash attention, the library call's; K1, K2a
   and K2b at 256^3 and 512^3 in both dtypes (each in the default, the
   tuned config and both bodies at one block; K2a and K2b also at the tile
   default, K2a's time beside K2b's a call); matmul in
   bfloat16 too; flash attention at the slice shape in the default
   (wgmma), tuned and one mma config; matmul (512, 512, 1024) float32 and
   flash attention at the slice shape in every config of their spaces
   (naming each flash config's body); every bound comes from the kernel's
   workload hook and ``profile_from_workload`` on the ``gpu-h100`` spec;
7. telemetry, profiles, export. Phases 3-5 run with ``repro_torch.obs``
   enabled and one profiler sampling every launch (the ambient
   ``KERNEL_LAUNCHER_PROF`` profiler, attached to ``ops``' kernels too).
   Between phases 4 and 5, after the main path's launch counts are read,
   a WisdomKernel is forced to launch diff_uvw at 512^3 in both fused
   variants of the selected config (the path's selection runs one of its
   two CUDA kernels), so both go through the launch path; their profiles
   form the "forced" group. Each profile line names the bodies its
   group's launches ran. Phase 7 checks that ``launch.count`` of each
   kernel equals the WisdomKernel stats entries the runs appended and the
   profiles taken;
   that the saved trace passes ``validate_trace``, holds one ``launch``
   span for each profiled launch, covering every CUDA kernel, and one
   ``serve.arena`` span per generation of (e); prints one profile line per
   kernel and run (main, forced, lm) and holds every roofline fraction to
   (0, 1.05]; and exports headers from the phase 3-4 wisdom (``export_header``)
   and launches ``StaticKernel`` from them at 512^3 and (512, 512, 1024)
   against a WisdomKernel forced to the same config (bit for bit for the
   stencils, the tuner's tolerance for matmul), with both times and the
   WisdomKernel's own selection beside the header's config.

Launch counts are set to 0 just before each path (phases 3-4, phase 5) and
read just after; every kernel of the path must have launched there. The
last two lines are the ``kernels`` JSON (each kernel's launches on its path,
in all and by body and dtype) and ``{"ok": true, "device": ...}``.
With no card, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter, defaultdict
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import (WisdomKernel, current_device_kind,  # noqa: E402
                              get_kernel, list_captures)
from repro_torch.core.capture import CAPTURE_DIR_ENV, CAPTURE_ENV  # noqa: E402
from repro_torch.core.device import get_device  # noqa: E402
from repro_torch.core.export import (StaticKernel, export_header,  # noqa: E402
                                     load_header)
from repro_torch.core.scenario import format_key  # noqa: E402
from repro_torch.core.wisdom import WISDOM_DIR_ENV  # noqa: E402
from repro_torch.examples import quickstart, tune_microhh  # noqa: E402
from repro_torch.kernels import (_build, advec_u, diff_uvw,  # noqa: E402
                                 flash_attention, matmul, ops, ref)
from repro_torch.kernels._stencil_common import stencil_defines  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import load_trace, validate_trace  # noqa: E402
from repro_torch.obs import runtime as obs_runtime  # noqa: E402
from repro_torch.prof import (PROF_ENV, process_profiler,  # noqa: E402
                              profile_from_workload, reset_process_profiler)
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.tuner import tune_capture  # noqa: E402
from repro_torch.tuner.runner import (L2_FLUSH_BYTES,  # noqa: E402
                                      _tolerances, verify_outcome)

#: The spec every bound is computed against: NVIDIA's H100 SXM data sheet
#: (dense, at the 700 W limit), in ``core/device.py``.
H100 = get_device("gpu-h100")
#: The largest roofline fraction a profile may show: above 1 the kernel
#: would beat its bound, so the workload's counts would be wrong; the 5 %
#: covers the CUDA events' resolution.
MAX_ROOFLINE_FRACTION = 1.05
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SMALL_STENCIL = [(8, 8, 128), (16, 32, 128), (32, 16, 256), (32, 32, 128)]
SMALL_MATMUL = [(128, 128, 256), (256, 512, 128), (64, 128, 1024)]
#: (m, n, k) of the quickstart's launch, the main path's matmul.
QS_MATMUL = (512, 512, 1024)
BIG_MATMUL = (8192, 8192, 8192)
#: Phase 2's matmul shapes beyond the test ones: ragged (no tile divides
#: m, n or k; TMA still takes bf16), one whose bf16 rows TMA cannot take
#: (n, k not multiples of 8: the simt body reads bf16), the quickstart's
#: and 8192^3.
MATMUL_SHAPES = [*SMALL_MATMUL, (190, 136, 200), (100, 77, 50), QS_MATMUL,
                 BIG_MATMUL]
#: Stencil configs checked in the ldg body (updates of each builder's
#: default): diff_uvw's default (the ldg body as it was before the tile
#: body, advec_u's old default too), and two more.
LDG_CONFIGS = [
    {"body": "ldg", "block_size_x": 32, "block_size_y": 4, "block_size_z": 1,
     "tile_factor_z": 2, "strip_z": 64, "unravel_permutation": "xyz",
     "min_blocks_per_sm": 1},
    {"body": "ldg", "block_size_x": 128, "block_size_y": 2, "block_size_z": 2,
     "tile_factor_z": 4, "strip_z": 64, "unravel_permutation": "zyx",
     "min_blocks_per_sm": 2},
    {"body": "ldg", "block_size_x": 16, "block_size_y": 16, "block_size_z": 1,
     "tile_factor_z": 8, "strip_z": 64, "unravel_permutation": "yzx",
     "min_blocks_per_sm": 4},
]
#: advec_u's default: a tile config, checked and timed in K2a and K2b too.
TILE_DEFAULT = get_kernel("advec_u").default_config()
#: The tile body at the ldg default's block, timed beside it in phase 6.
TILE_LDG_BLOCK = {"body": "tile", "block_size_x": 32, "block_size_y": 4,
                  "strip_z": 64, "unravel_permutation": "xyz",
                  "min_blocks_per_sm": 1}
#: Stencil configs checked in the tile body (each stencil kernel): advec_u's
#: default, the ldg block, the smallest tile with the shortest strip, and
#: the widest tile with the longest.
TILE_CONFIGS = [
    TILE_DEFAULT, TILE_LDG_BLOCK,
    {"body": "tile", "block_size_x": 16, "block_size_y": 2, "strip_z": 32,
     "unravel_permutation": "xyz", "min_blocks_per_sm": 1},
    {"body": "tile", "block_size_x": 256, "block_size_y": 4, "strip_z": 128,
     "unravel_permutation": "zyx", "min_blocks_per_sm": 1},
]
#: A ragged grid smaller than a tile: nx odd (no 16-byte copy fits a row),
#: every axis shorter than some block's, the halo wider than the grid.
RAGGED_STENCIL = (5, 7, 9)
STENCILS = ("advec_u", "diff_uvw_fused", "diff_uvw_single")
#: Updates of the default (128 x 128, block_k 8, 2 stages, split_k 1):
#: split_k 1, 2 and 4, stages 2-4, 64- and 128-wide tiles; in bfloat16 one
#: (block_m 64) or two (128) warpgroups at every stage count.
MATMUL_CONFIGS = [
    {},
    {"block_m": 64, "block_n": 64, "block_k": 16, "stages": 3, "split_k": 4},
    {"block_m": 128, "block_n": 64, "block_k": 32, "stages": 4, "split_k": 2,
     "grid_order": "nmk"},
    {"block_m": 64, "block_n": 128, "block_k": 8, "stages": 2, "split_k": 2},
    {"block_m": 128, "block_n": 128, "block_k": 16, "stages": 3,
     "split_k": 4, "grid_order": "nmk"},
]
#: Extra matmul configs timed in phase 6 (bfloat16: a deeper ring).
MATMUL_TIMED = {"stages4": {"stages": 4}}
#: Updates of the default (64, 64, 128): in bfloat16 at D = 128 the default
#: and the two-warpgroup 128 x 128 run the wgmma body, the other two mma.
FA_CONFIGS = [
    {},
    {"block_q": 128, "block_k": 32, "threads": 128},
    {"block_q": 32, "block_k": 128, "threads": 64},
    {"block_q": 128, "block_k": 128, "threads": 256},
]
#: The mma-body config checked and timed at the slice shape beside the
#: wgmma default.
FA_MMA = {"block_q": 128, "block_k": 64, "threads": 128}
#: The configs checked at the slice shape: the default and the 128 x 128
#: two-warpgroup config (wgmma), and FA_MMA.
FA_SLICE_CONFIGS = [{}, FA_CONFIGS[3], FA_MMA]
FA_GQA = [(4, 4), (4, 2), (8, 1)]
#: 200: a ragged S that no block divides (the TMA edge and the key mask).
FA_SEQ = (256, 512, 200)
FA_HEAD_DIM = 128
TPU_KERNELS = {   # CUDA kernel -> the Pallas call it replaces
    "advec_u": "src/repro/kernels/advec_u.py:91",
    "diff_uvw_fused": "src/repro/kernels/diff_uvw.py:111",
    "diff_uvw_single": "src/repro/kernels/diff_uvw.py:126",
    "matmul": "src/repro/kernels/matmul.py:137",
    "flash_attention": "src/repro/kernels/flash_attention.py:123",
}
SOURCES = {"advec_u": "advec_u.cu", "diff_uvw_fused": "diff_uvw.cu",
           "diff_uvw_single": "diff_uvw.cu", "matmul": "matmul.cu",
           "flash_attention": "flash_attention.cu"}
#: The CUDA kernels each main path must launch.
LOOP_KERNELS = ("advec_u", "diff_uvw_fused", "diff_uvw_single", "matmul")
LM_KERNELS = ("flash_attention",)

# The LM slice: codeqwen1.5-7b at full width and depth, random weights.
LM_ARCH = "codeqwen1.5-7b"
LM_BATCH, LM_SEQ, LM_DECODE = 4, 2048, 32
#: (a) float32 prefill (flash kernel) vs decode_step (plain attention):
#: both IEEE float32, summed in other orders over 4096-wide products.
LM_F32_TOL = 1e-3
#: (c) bfloat16 over 32 layers: 8-bit mantissas round at every product,
#: norm and residual add of every layer, and prefill and decode round at
#: other places (the flash kernel rounds P to bf16; decode attention
#: rounds p). Max abs error within this share of max(1, max|ref|), and
#: relative L2 error within it too. The sound kernel reads about 0.02 on
#: both; chip_fault_check.py plants faults in the flash kernel and shows
#: that they read above this bound.
LM_BF16_TOL = 0.05


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs

def fields(shape, n: int, dtype: str, seed: int = 0) -> list[torch.Tensor]:
    """n random fields on the card; the last is the eddy viscosity when
    n == 4 (nonnegative)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = [torch.randn(shape, generator=g, device="cuda") for _ in range(n)]
    if n == 4:
        out[3] = out[3].abs() + 0.1
    return [f.to(DTYPES[dtype]) for f in out]


def scal() -> torch.Tensor:
    return torch.tensor([[1.1, 0.9, 1.3, 0.0]], device="cuda")


def matrices(m: int, n: int, k: int, dtype: str, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(m, k, generator=g, device="cuda").to(DTYPES[dtype]),
            torch.randn(k, n, generator=g, device="cuda").to(DTYPES[dtype]))


# ------------------------------------------------- kernels and plain versions

def qkv(bh: int, bhkv: int, s: int, d: int, dtype: str, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(DTYPES[dtype])
            for shape in ((bh, s, d), (bhkv, s, d), (bhkv, s, d))]


def kernel_cfg(name: str, upd: dict) -> dict:
    """The default config of CUDA kernel ``name`` updated by ``upd``."""
    if name in ("advec_u", "matmul", "flash_attention_causal",
                "flash_attention_full"):
        return get_kernel(name).default_config() | upd
    return get_kernel("diff_uvw").default_config() | upd | {
        "fuse_outputs": name == "diff_uvw_fused"}


def calls(name: str, cfg: dict, args):
    """(kernel call, plain call) for one CUDA kernel on ``args``."""
    if name == "advec_u":
        return (lambda: advec_u.launch(cfg, *args),
                lambda: ref.advec_u_ref(*args))
    if name == "diff_uvw_fused":
        return (lambda: diff_uvw.launch_fused(cfg, *args),
                lambda: ref.diff_uvw_ref(*args))
    if name == "diff_uvw_single":
        u, v, w, e, s = args
        return (lambda: tuple(diff_uvw.launch_single(cfg, f, e, s)
                              for f in (u, v, w)),
                lambda: tuple(ref.diff_one_ref(f, e, s) for f in (u, v, w)))
    if name.startswith("flash_attention"):
        causal = name == "flash_attention_causal"
        return (lambda: flash_attention.launch(cfg, *args, causal=causal),
                lambda: ref.flash_attention_ref_factory(causal)(*args))
    return (lambda: matmul.launch(cfg, *args), lambda: ref.matmul_ref(*args))


def compare(name: str, cfg: dict, args, dtype: str, label: str,
            verbose: bool = True) -> dict:
    """Run the kernel and its plain version on ``args``; raise unless they
    agree within the tuner's tolerance for ``dtype`` and, for flash
    attention, within ``flash_attention.ROW_L2_TOL`` row by row. Returns
    the max absolute error and, for flash attention, max|ref| and the
    largest relative L2 error of a row."""
    kernel, plain = calls(name, cfg, args)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    out = verify_outcome(got, want, dtype)
    check(out.ok, f"{name} {label} {dtype} {cfg}: {out.error}")
    res = {"max_abs_err": out.max_err}
    extra = ""
    if name.startswith("flash_attention"):
        res["max_abs_ref"] = float(want.abs().max())
        res["row_l2_err"] = flash_attention.row_l2_error(got, want)
        check(res["row_l2_err"] <= flash_attention.ROW_L2_TOL[dtype],
              f"{name} {label} {dtype} {cfg}: row relative L2 error "
              f"{res['row_l2_err']:.3e} > {flash_attention.ROW_L2_TOL[dtype]}")
        extra = (f" max|ref|={res['max_abs_ref']:.3g} row_l2_err="
                 f"{res['row_l2_err']:.3e} (tol "
                 f"{flash_attention.ROW_L2_TOL[dtype]:g})")
    if verbose:
        print(f"check {name:16s} {label:14s} {dtype:8s} max_abs_err="
              f"{out.max_err:.3e} {tolerance(dtype)}{extra} ok config={cfg}",
              flush=True)
    return res


def tolerance(dtype: str) -> str:
    rtol, atol = _tolerances(dtype)
    return f"tol=(rtol {rtol:g}, atol {atol:g} x max(1, max|ref|))"


def stencil_args(name: str, shape, dtype: str):
    n = 3 if name == "advec_u" else 4
    return [*fields(shape, n, dtype), scal()]


# ------------------------------------------------------------------ timing

_FLUSH = None


def time_ms(fn, reps: int = 10) -> float:
    """Median ms of ``reps`` launches of ``fn``, each after an L2 flush,
    timed with CUDA events after one warm-up call."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def builder_of(name: str):
    """The builder that launches CUDA kernel (or builder) ``name``."""
    return get_kernel("diff_uvw" if name.startswith("diff_uvw") else name)


def cuda_kernel(builder: str, cfg: dict) -> str:
    """The CUDA kernel (a key of TPU_KERNELS) a launch of ``builder`` in
    ``cfg`` runs, as the builder's kernel module says (``kernel_of``)."""
    return sys.modules[get_kernel(builder).source].kernel_of(cfg).name


def bound(name: str, shape, dtype: str, cfg: dict) -> tuple[float, str]:
    """Least time in ms for CUDA kernel ``name`` in ``cfg`` on ``shape``,
    and whether bytes or operations set it: the builder's workload hook
    (each input read once, each output written once; the unfused diff_uvw
    a call of three launches) joined with the H100's peaks by the
    program's own ``profile_from_workload``."""
    w = builder_of(name).make_workload(cfg, tuple(shape), dtype)
    check(w.valid, f"{name} {shape} {dtype} {cfg}: invalid workload")
    p = profile_from_workload(w, H100, dtype, 1.0)
    return (max(p.compute_us, p.memory_us) / 1e3,
            "operations" if p.bottleneck == "compute" else "bytes")


def library_call(a, b):
    """torch.matmul with TF32 off: the yardstick, never used by the port."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sdpa_call(q, k, v):
    """scaled_dot_product_attention, causal: the yardstick, never used by
    the port. q, k, v are (BH, S, D) with BH == BHkv."""
    return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                          is_causal=True)[0]


LIBRARY = {"matmul": library_call, "flash_attention_causal": sdpa_call}


def timing_row(name: str, shape, dtype: str, configs: dict, args) -> dict:
    """Times of each named config, the plain version and (matmul, flash
    attention) the library call, beside the bound; printed and returned."""
    row = {"kernel": name, "shape": list(shape), "dtype": dtype}
    for label, cfg in configs.items():
        row[f"{label}_ms"] = time_ms(calls(name, cfg, args)[0])
    row["plain_ms"] = time_ms(calls(name, next(iter(configs.values())),
                                    args)[1], reps=3)
    lib = LIBRARY.get(name)
    row["library_ms"] = time_ms(lambda: lib(*args)) if lib else None
    row["bound_ms"], row["bound_by"] = bound(
        name, shape, dtype, next(iter(configs.values())))
    print("time " + json.dumps(row), flush=True)
    return row


# ------------------------------------------------------------------ phases

def phase_environment() -> str:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc.stdout.strip().splitlines()[-1]}")
    print(f"device {name} capability {cap} count "
          f"{torch.cuda.device_count()}")
    check(cap == (9, 0), f"expected an sm_90 card, got capability {cap}")
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    return smi


def stencil_configs(name: str) -> list[dict]:
    """The configs phase 2 checks ``name`` in: LDG_CONFIGS and
    TILE_CONFIGS."""
    return [kernel_cfg(name, u) for u in [*LDG_CONFIGS, *TILE_CONFIGS]]


def phase_build() -> None:
    specs = []
    for name in STENCILS:
        src = "advec_u.cu" if name == "advec_u" else "diff_uvw.cu"
        specs += [(src, stencil_defines(c)) for c in stencil_configs(name)]
    specs += matmul_specs()
    specs += flash_specs()
    specs = list(dict.fromkeys((src, tuple(d)) for src, d in specs))
    secs = _build.build_many(specs)
    print(f"built {len(specs)} libraries with nvcc -gencode "
          f"arch=compute_90a,code=sm_90a in {secs:.1f}s (parallel)",
          flush=True)


def fa_body(cfg: dict, dtype: str) -> str:
    """The body a launch of ``cfg`` at D = 128 in ``dtype`` runs."""
    return flash_attention.choose_body(dtype, FA_HEAD_DIM, cfg)


def flash_defines(cfg: dict, causal: bool, dtype: str) -> tuple:
    """The defines of the build that runs ``cfg`` at D = 128 in ``dtype``."""
    return flash_attention.defines(cfg, causal, FA_HEAD_DIM,
                                   fa_body(cfg, dtype))


def flash_specs() -> list:
    """Every flash library phases 2-6 launch: each causal config of the
    space in bfloat16 (the LM tuning phase and the sweep pick among them)
    and the check configs, causal and full, in both dtypes."""
    out = [flash_defines(c, True, "bfloat16")
           for c in get_kernel("flash_attention_causal").space.enumerate()]
    for causal in (True, False):
        name = "flash_attention_causal" if causal else "flash_attention_full"
        out += [flash_defines(kernel_cfg(name, u), causal, dtype)
                for u in FA_CONFIGS for dtype in DTYPES]
    return [("flash_attention.cu", d) for d in out]


def matmul_specs() -> list:
    """Every matmul library phases 2-6 launch: each config of the space
    on the quickstart's float32 problem (its tuning and the sweep), and the
    check and timed configs at every phase-2 shape in both dtypes."""
    space = get_kernel("matmul").space
    out = [matmul.defines(c, matmul.plan(c, *QS_MATMUL, "float32"))
           for c in space.enumerate()]
    for u in [*MATMUL_CONFIGS, *MATMUL_TIMED.values()]:
        cfg = kernel_cfg("matmul", u)
        out += [matmul.defines(cfg, matmul.plan(cfg, *shape, dtype))
                for dtype in DTYPES for shape in MATMUL_SHAPES]
    return [("matmul.cu", d) for d in out]


def matmul_check(cfg: dict, args, want: torch.Tensor, dtype: str):
    """One matmul launch against the plain version's output ``want``
    under the tuner's tolerance: (VerifyOutcome, the body that ran)."""
    got = matmul.launch(cfg, *args)
    torch.cuda.synchronize()
    return verify_outcome(got, want, dtype), matmul.launch_plan(cfg,
                                                                *args).body


def phase_matmul() -> float:
    """Every config of MATMUL_CONFIGS against ref.matmul_ref at every
    shape of MATMUL_SHAPES in both dtypes; one line a (shape, dtype) names
    the body that ran, which must be the shape rule's. Returns the default
    config's max error on the quickstart's float32 problem."""
    headline = 0.0
    for dtype in DTYPES:
        for m, n, k in MATMUL_SHAPES:
            label = f"m{m}n{n}k{k}"
            args = matrices(m, n, k, dtype)
            want = ref.matmul_ref(*args)
            expect = ("wgmma" if dtype == "bfloat16" and n % 8 == 0
                      and k % 8 == 0 else "simt")
            errs = []
            for u in MATMUL_CONFIGS:
                out, body = matmul_check(kernel_cfg("matmul", u), args, want,
                                         dtype)
                check(out.ok, f"matmul {label} {dtype} {u}: {out.error}")
                check(body == expect, f"matmul {label} {dtype} {u}: ran the "
                      f"{body} body, the shape rule says {expect}")
                errs.append(out.max_err)
            if (m, n, k) == QS_MATMUL and dtype == "float32":
                headline = errs[0]
            print(f"check matmul           {label:17s} {dtype:8s} body="
                  f"{expect:5s} {len(errs)} configs max_abs_err="
                  f"{max(errs):.3e} {tolerance(dtype)} ok", flush=True)
            del args, want
    torch.cuda.empty_cache()
    return headline


def check_stencil(name: str, cfgs: list[dict], shape, dtype: str,
                  label: str, verbose: bool = False) -> list[float]:
    """Hold ``name`` against its plain version in each config on one
    grid; raise unless each launch ran the body its config names. Returns
    each config's max abs error."""
    k = _build.CUDA_KERNELS[name]
    args = stencil_args(name, shape, dtype)
    errs = []
    for cfg in cfgs:
        body = cfg["body"]
        n0 = k.body_launches.get(body, 0)
        errs.append(compare(name, cfg, args, dtype, label,
                            verbose=verbose)["max_abs_err"])
        check(k.body_launches.get(body, 0) - n0 == (
            3 if name == "diff_uvw_single" else 1),
            f"{name} {label} {dtype} {cfg}: did not run the {body} body")
    return errs


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the max error at
    the headline shapes."""
    headline = {}
    for dtype in DTYPES:
        for name in STENCILS:
            for body in ("ldg", "tile"):
                cfgs = [c for c in stencil_configs(name)
                        if c["body"] == body]
                shapes = [*SMALL_STENCIL, RAGGED_STENCIL]
                err = max(max(check_stencil(name, cfgs, shape, dtype,
                                            "x".join(map(str, shape))))
                          for shape in shapes)
                print(f"check {name:16s} body={body:4s} {len(cfgs)} configs"
                      f" x {len(shapes)} shapes (test shapes, ragged "
                      f"{RAGGED_STENCIL}) {dtype:8s} max_abs_err={err:.3e} "
                      f"{tolerance(dtype)} ok", flush=True)
    for dtype in DTYPES:
        for g in (256, 512):
            for name in STENCILS:   # the default and both bodies
                cfgs = [kernel_cfg(name, u)
                        for u in ({}, LDG_CONFIGS[0], TILE_DEFAULT)]
                cfgs = list({json.dumps(c, sort_keys=True): c
                             for c in cfgs}.values())
                errs = check_stencil(name, cfgs, (g, g, g), dtype, f"{g}^3",
                                     verbose=True)
                if g == 512 and dtype == "float32":
                    headline[name] = errs[0]   # the default config's
    headline["matmul"] = phase_matmul()
    fa = _build.CUDA_KERNELS["flash_attention"]
    for dtype in DTYPES:
        for name in ("flash_attention_causal", "flash_attention_full"):
            for upd in FA_CONFIGS:
                cfg = kernel_cfg(name, upd)
                body = fa_body(cfg, dtype)
                n0 = fa.body_launches.get(body, 0)
                errs = []
                for hq, hkv in FA_GQA:
                    for s in FA_SEQ:
                        args = qkv(hq, hkv, s, FA_HEAD_DIM, dtype)
                        errs.append(compare(name, cfg, args, dtype,
                                            f"gqa{hq}/{hkv} s{s}",
                                            verbose=False))
                check(fa.body_launches.get(body, 0) - n0 == len(errs),
                      f"{name} {dtype} {cfg}: not every case ran the "
                      f"{body} body")
                print(f"check {name:22s} {dtype:8s} body={body:5s} "
                      f"{len(errs)} cases (GQA 4/4, 4/2, 8/1 x S 256, 512, "
                      f"200 x D 128) max_abs_err="
                      f"{max(e['max_abs_err'] for e in errs):.3e} "
                      f"{tolerance(dtype)} row_l2_err="
                      f"{max(e['row_l2_err'] for e in errs):.3e} (tol "
                      f"{flash_attention.ROW_L2_TOL[dtype]:g}) ok config="
                      f"{json.dumps(cfg)}", flush=True)
    args = qkv(128, 128, LM_SEQ, FA_HEAD_DIM, "bfloat16")
    for upd in FA_SLICE_CONFIGS:
        cfg = kernel_cfg("flash_attention_causal", upd)
        err = compare("flash_attention_causal", cfg, args, "bfloat16",
                      f"BH128 S2048 D128 {fa_body(cfg, 'bfloat16')}")
        if not upd:
            headline["flash_attention"] = err["max_abs_err"]
    del args
    torch.cuda.empty_cache()
    return headline


def phase_main_path(wisdom: Path) -> tuple[dict, dict, dict]:
    """Phases 3-4, their wisdom kept under ``wisdom``. Returns the two
    examples' results and the CUDA kernels' launches."""
    _build.reset_launch_counts()
    qs = quickstart.main(["--device", "cuda", "--max-evals", "20",
                          "--budget-seconds", "120",
                          "--wisdom-dir", str(wisdom / "quickstart")])
    check(qs["tiers"] == ("default", "exact"),
          f"quickstart tiers {qs['tiers']}, want ('default', 'exact')")
    mh = tune_microhh.main(["--device", "cuda", "--max-evals", "8",
                            "--budget-seconds", "120",
                            "--wisdom-dir", str(wisdom / "microhh")])
    for sc, tier, cfg in mh["selected"]:
        check(tier == "exact", f"{sc.key}: selected tier {tier}")
    for name, dtype, st, _ in mh["launched"]:
        check(st.tier not in ("exact", "default", "forced"),
              f"{name} 512^3 {dtype}: tier {st.tier} is not a fallback")
    counts = {k: _build.CUDA_KERNELS[k].launches for k in LOOP_KERNELS}
    bodies = {k: dict(_build.CUDA_KERNELS[k].body_launches)
              for k in STENCILS}
    print(f"main-path launches: {json.dumps(counts)}; stencils by body: "
          f"{json.dumps(bodies)}; by body and dtype: "
          f"{json.dumps(launches_by(STENCILS))}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")
    check(bodies["advec_u"].get("tile", 0) > 0,
          "advec_u did not launch its tile body on the main path")
    return qs, mh, counts


def launches_by(names) -> dict:
    """Each CUDA kernel's launches since the counts were last reset, by
    "body dtype"."""
    return {k: {f"{body} {dtype}": n for (body, dtype), n in sorted(
        _build.CUDA_KERNELS[k].body_dtype_launches.items(), key=str)}
            for k in names}


def both_diff_kernels(mh: dict, wisdom: Path) -> int:
    """diff_uvw at 512^3 float32 through a WisdomKernel forced into both
    fused variants of the config the fallback tier selected (its own body
    in each), each checked against the plain version. The main path's
    selection launches one of diff_uvw's two CUDA kernels through the
    launch path (the tuner launches both, but not through a WisdomKernel);
    this gives the other a launch span and a profile too. Run after the
    main path's counts are read, so they are not counted there. Returns
    the launches."""
    sel = next(st.config for name, dtype, st, _ in mh["launched"]
               if (name, dtype) == ("diff_uvw", "float32"))
    k = WisdomKernel(get_kernel("diff_uvw"), wisdom_dir=wisdom,
                     device_kind=current_device_kind())
    args = tune_microhh.launch_args("diff_uvw", (512,) * 3, "float32",
                                    torch.device("cuda"))
    want = ref.diff_uvw_ref(*args)
    for cfg in (sel | {"fuse_outputs": True},
                sel | {"fuse_outputs": False}):
        check(k.builder.space.is_valid(cfg), f"diff_uvw: {cfg} invalid")
        out = verify_outcome(k(*args, config=cfg), want, "float32")
        check(out.ok, f"diff_uvw 512^3 {cfg}: {out.error}")
        print(f"forced: diff_uvw 512^3 float32 as "
              f"{cuda_kernel('diff_uvw', cfg)} max_abs_err={out.max_err:.3e}"
              f" ok config={json.dumps(cfg)}", flush=True)
    del args, want
    return len(k.stats)


# -------------------------------------------------------------- telemetry

def instrument():
    """Turn on ``repro_torch.obs`` and one profiler that samples every
    launch: the ambient one (``KERNEL_LAUNCHER_PROF``), which every
    WisdomKernel and ServeEngine built from here on picks up, attached to
    ``ops``' kernels (built at import) too. Returns (registry, tracer,
    profiler)."""
    os.environ[PROF_ENV] = "1"
    reset_process_profiler()
    pr = process_profiler()
    pr.sample_every = 1
    for k in ops._ALL_KERNELS:
        k.attach_profiler(pr)
    obs_runtime.disable()
    reg, tr = obs_runtime.enable()
    return reg, tr, pr


def uninstrument() -> None:
    obs_runtime.disable()
    os.environ.pop(PROF_ENV, None)
    reset_process_profiler()
    for k in ops._ALL_KERNELS:
        k.attach_profiler(None)


def phase_telemetry(reg, tr, pr, stats: Counter, paths: list,
                    generations: int) -> dict:
    """Phase 7's reading of phases 3-5: counts, trace, profiles.
    ``paths`` names the runs in order, each with the number of profiles
    taken when it ended: ("main", n), ("forced", n), ("lm", n)."""
    snap = reg.snapshot()
    for name, n in sorted(stats.items()):
        got = snap["counters"].get(f"launch.count{{kernel={name}}}", 0)
        n_prof = sum(p.kernel == name for p in pr.profiles)
        check(got == n == n_prof, f"launch.count{{kernel={name}}} = {got},"
              f" {n} stats entries, {n_prof} profiles")
        print(f"telemetry launch.count{{kernel={name}}} = {got:g}: equals "
              f"the {n} WisdomKernel stats entries and {n_prof} profiles",
              flush=True)

    with tempfile.TemporaryDirectory(prefix="kl-trace-") as tmp:
        doc = load_trace(tr.save(Path(tmp) / "trace.json"))
    check(validate_trace(doc) == [], "trace failed validate_trace")
    spans = defaultdict(list)
    for e in doc["traceEvents"]:
        if e["name"] == "launch":
            spans[e["args"]["kernel"]].append(e)
    # One span and one profile a launch: the same (tier, scenario) pairs
    # for each builder, so the CUDA kernels the profiles' configs ran are
    # those the spans record.
    seen = set()
    for builder, evs in spans.items():
        profs = [p for p in pr.profiles if p.kernel == builder]
        got = Counter((e["args"]["tier"], e["args"]["scenario"])
                      for e in evs)
        want = Counter((p.tier, format_key(p.scenario_key())) for p in profs)
        check(got == want, f"{builder}: launch spans {dict(got)}, "
              f"profiles {dict(want)}")
        seen.update(cuda_kernel(builder, p.config) for p in profs)
    check(seen >= set(TPU_KERNELS),
          f"no launch span for {sorted(set(TPU_KERNELS) - seen)}")
    arenas = sum(e["name"] == "serve.arena" for e in doc["traceEvents"])
    check(arenas == generations,
          f"{arenas} serve.arena spans, {generations} generations")
    print(f"telemetry trace: valid Chrome trace of "
          f"{len(doc['traceEvents'])} events, "
          f"{sum(map(len, spans.values()))} launch spans covering "
          f"{sorted(seen)}, {arenas} serve.arena spans for {generations} "
          f"generations", flush=True)

    groups = defaultdict(list)
    for i, p in enumerate(pr.profiles):
        kernel = (p.kernel if p.kernel == "serve.decode"
                  else cuda_kernel(p.kernel, p.config))
        path = next(name for name, end in paths if i < end)
        groups[(path, kernel)].append(p)
    # The main path's selection runs one diff_uvw kernel; the forced
    # launches run both.
    wants = ([("main", k) for k in ("advec_u", "matmul")]
             + [("forced", k) for k in STENCILS[1:]]
             + [("lm", k) for k in LM_KERNELS])
    for want in wants:
        check(want in groups, f"no profile of {want[1]} on the "
              f"{want[0]} path")
    check(any(("main", k) in groups for k in STENCILS[1:]),
          "no profile of a diff_uvw kernel on the main path")
    for (path, kernel), ps in sorted(groups.items()):
        fracs = [p.roofline_fraction for p in ps]
        check(all(0 < f <= MAX_ROOFLINE_FRACTION for f in fracs),
              f"{kernel} on the {path} path: roofline fractions {fracs}")
        p = ps[-1]
        print("profile " + json.dumps({
            "path": path, "kernel": kernel, "builder": p.kernel,
            "problem": list(p.problem_size), "dtype": p.dtype,
            "config": p.config, "tier": p.tier,
            "latency_us": p.latency_us, "compute_us": p.compute_us,
            "memory_us": p.memory_us, "bottleneck": p.bottleneck,
            "roofline_fraction": p.roofline_fraction, "profiles": len(ps),
            "bodies": dict(Counter(q.config.get("body") for q in ps)),
            "fraction_range": [min(fracs), max(fracs)]}), flush=True)
    return snap


def phase_export(kind: str, wisdom: Path, out: Path) -> None:
    """The paper's compile-time baseline: headers exported from the phase
    3-4 wisdom, each launched by StaticKernel against a WisdomKernel
    forced to the header's config, with both times, and what the
    WisdomKernel itself selects at that size."""
    cuda = torch.device("cuda")
    for name, wdir, shape in (
            ("advec_u", wisdom / "microhh", (512,) * 3),
            ("diff_uvw", wisdom / "microhh", (512,) * 3),
            ("matmul", wisdom / "quickstart", QS_MATMUL)):
        b = get_kernel(name)
        hdr = export_header(name, kind, wisdom_dir=wdir, out_dir=out)
        cfg = load_header(hdr)["config"]
        static = StaticKernel(b, hdr)
        wk = WisdomKernel(b, wisdom_dir=wdir, device_kind=kind)
        args = (matrices(*shape, "float32") if name == "matmul" else
                tune_microhh.launch_args(name, shape, "float32", cuda))
        got, want = static(*args), wk(*args, config=cfg)
        if name == "matmul":
            out_ = verify_outcome(got, want, "float32")
            check(out_.ok, f"StaticKernel {name}: {out_.error}")
            agree = f"max_abs_err={out_.max_err:.3e} {tolerance('float32')}"
        else:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"StaticKernel {name} differs from the forced "
                  f"WisdomKernel")
            agree = "bit for bit"
        static_ms = time_ms(lambda: static(*args))
        wk_ms = time_ms(lambda: wk(*args, config=cfg))
        sel, tier = wk.select_config(tuple(shape), "float32")
        print(f"export {name} {'x'.join(map(str, shape))} float32: "
              f"StaticKernel vs WisdomKernel forced to the header's config "
              f"agree {agree}; StaticKernel {static_ms:.4f} ms, WisdomKernel"
              f" {wk_ms:.4f} ms; header config {json.dumps(cfg)}; the "
              f"WisdomKernel selects tier {tier} config {json.dumps(sel)}",
              flush=True)
        del args, got, want
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ LM slice

def lm_tokens(b: int, s: int, vocab: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g, device="cuda")


def feed(model, params, tokens: torch.Tensor, max_seq: int) -> torch.Tensor:
    """The last logits of ``tokens`` fed one at a time through decode_step
    (plain decode attention: no flash launch)."""
    cache = model.init_cache(tokens.shape[0], max_seq)
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1])
    return logits


def logit_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    g, w = got.to(torch.float64), want.to(torch.float64)
    return {"max_abs_err": float((g - w).abs().max()),
            "max_abs_ref": float(w.abs().max()),
            "rel_l2_err": float((g - w).norm() / w.norm()),
            "same_argmax": bool(torch.equal(g.argmax(-1), w.argmax(-1)))}


def lm_bf16_ok(err: dict) -> bool:
    """Check (c)'s acceptance of :func:`logit_errors` readings."""
    return (err["max_abs_err"] <= LM_BF16_TOL * max(1.0, err["max_abs_ref"])
            and err["rel_l2_err"] <= LM_BF16_TOL)


def n_elements(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_elements(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_elements(v) for v in tree)
    return tree.numel()


def timed(fn):
    """(result, host seconds) of ``fn`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_profile(fn, label: str, steps: int = 1, top: int = 6,
                   own: str = "") -> dict:
    """Run ``fn`` under torch.profiler: the device's kernel time per step,
    the window's host time per step (profiler overhead included), the
    kernels that took the most device time and, where ``own`` names a
    kernel function, that kernel's own device time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3   # ms
    res = {"device_ms_per_step": busy / steps,
           "profiled_wall_ms_per_step": wall * 1e3 / steps,
           "top": [(e.key[:70], round(e.self_device_time_total / 1e3
                                      / steps, 4)) for e in kernels[:top]]}
    if own:
        res["own_ms_per_step"] = sum(
            e.self_device_time_total for e in kernels if own in e.key) \
            / 1e3 / steps
    if not kernels:
        print(f"profile {label}: the profiler saw no device kernels; "
              f"device time not measured", flush=True)
    else:
        print(f"profile {label}: device kernels {res['device_ms_per_step']:.2f}"
              f" ms/step, profiled host window "
              f"{res['profiled_wall_ms_per_step']:.2f} ms/step; top kernels "
              f"(ms/step): {json.dumps(res['top'])}", flush=True)
        if own:
            print(f"profile {label}: {own} {res['own_ms_per_step']:.3f} "
                  f"ms/step ({res['own_ms_per_step'] / busy * steps:.1%} "
                  f"of the device kernels' time)", flush=True)
    return res


def lm_f32_check(fa) -> dict:
    """(a) full width in float32 with 2 layers: prefill (flash kernel)
    against decode_step (plain attention) on one 256-token prompt."""
    cfg = replace(get_arch(LM_ARCH), n_layers=2, param_dtype="float32",
                  compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    tok = lm_tokens(1, 256, cfg.vocab, seed=1)
    n0 = fa.launches
    pre, _ = model.prefill(params, tok, model.init_cache(1, 256))
    check(fa.launches - n0 == cfg.n_layers,
          f"f32 prefill launched flash {fa.launches - n0} times, want 2")
    err = logit_errors(pre, feed(model, params, tok, 256))
    check(err["max_abs_err"] <= LM_F32_TOL * max(1.0, err["max_abs_ref"]),
          f"(a) f32 prefill vs decode: {err}")
    print(f"lm (a) {LM_ARCH} full width, 2 layers, float32, 256 tokens: "
          f"prefill (flash) vs decode_step {json.dumps(err)} tol "
          f"{LM_F32_TOL:g} x max(1, max|ref|) ok", flush=True)
    del model, params
    torch.cuda.empty_cache()
    return err


def phase_lm() -> dict:
    """The LM slice on the card; returns what it measured."""
    fa = _build.CUDA_KERNELS["flash_attention"]
    out = {"f32": lm_f32_check(fa)}
    cfg = get_arch(LM_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = timed(lambda: model.init(
        torch.Generator(device="cuda").manual_seed(0)))
    n_params = n_elements(params)
    print(f"lm {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters in {cfg.param_dtype} "
          f"(ArchConfig.n_params {cfg.n_params() / 1e9:.3f} B + QKV biases),"
          f" initialised on the card in {init_s:.1f} s", flush=True)

    # (b) full depth: prefill 4 x 2048, then 32 greedy decode steps
    tok = lm_tokens(LM_BATCH, LM_SEQ, cfg.vocab, seed=2)
    prefill_s = []
    for _ in range(3):          # the first is a warm-up
        cache = model.init_cache(LM_BATCH, LM_SEQ + LM_DECODE)
        n0, w0 = fa.launches, fa.body_launches.get("wgmma", 0)
        (logits, cache), sec = timed(lambda: model.prefill(params, tok,
                                                           cache))
        check(fa.launches - n0 == cfg.n_layers,
              f"prefill launched flash {fa.launches - n0} times, want "
              f"{cfg.n_layers}")
        check(fa.body_launches.get("wgmma", 0) - w0 == cfg.n_layers,
              f"prefill ran the wgmma body "
              f"{fa.body_launches.get('wgmma', 0) - w0} times, want "
              f"{cfg.n_layers}")
        prefill_s.append(sec)
    check(logits.shape == (LM_BATCH, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "prefill logits not finite or of the wrong shape")
    nxt = logits[:, -1].argmax(-1, keepdim=True)

    def decode():
        nonlocal cache, nxt
        for _ in range(LM_DECODE):
            lg, cache = model.decode_step(params, cache, nxt)
            nxt = lg[:, -1].argmax(-1, keepdim=True)
        return lg

    lg, dec_s = timed(decode)
    check(cache["pos"] == LM_SEQ + LM_DECODE
          and bool(torch.isfinite(lg[..., :cfg.vocab]).all()),
          "decode logits not finite, or the cursor is wrong")
    out["prefill_ms"] = statistics.median(prefill_s[1:]) * 1e3
    out["prefill_tok_s"] = LM_BATCH * LM_SEQ / (out["prefill_ms"] / 1e3)
    out["decode_ms_per_step"] = dec_s / LM_DECODE * 1e3
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"lm (b) {LM_ARCH} bf16 x {cfg.n_layers} layers: prefill "
          f"{LM_BATCH} x {LM_SEQ} tokens in {out['prefill_ms']:.1f} ms "
          f"({out['prefill_tok_s']:.0f} tokens/s; runs "
          f"{[round(x * 1e3, 1) for x in prefill_s]} ms, the first a "
          f"warm-up), flash +{cfg.n_layers} launches per prefill, all "
          f"in the wgmma body; "
          f"{LM_DECODE} greedy decode steps at batch {LM_BATCH} in "
          f"{out['decode_ms_per_step']:.2f} ms/step; peak device memory "
          f"{out['peak_gb']:.1f} GB", flush=True)
    del cache, logits, lg

    # where the time goes: one prefill and 4 decode steps under the profiler
    state = {"cache": model.init_cache(LM_BATCH, LM_SEQ + 4)}

    def prefill_once():
        state["logits"], state["cache"] = model.prefill(params, tok,
                                                        state["cache"])

    def decode_4():
        for _ in range(4):
            nxt = state["logits"][:, -1].argmax(-1, keepdim=True)
            state["logits"], state["cache"] = model.decode_step(
                params, state["cache"], nxt)

    out["profile_prefill"] = device_profile(prefill_once, "prefill 4 x 2048",
                                            own="fa_wgmma_kernel")
    out["profile_decode"] = device_profile(decode_4, "decode batch 4",
                                           steps=4)
    busy = out["profile_decode"]["device_ms_per_step"]
    print(f"lm decode: device busy {busy:.2f} of "
          f"{out['decode_ms_per_step']:.2f} ms/step unprofiled "
          f"({busy / out['decode_ms_per_step']:.0%}); prefill: device busy "
          f"{out['profile_prefill']['device_ms_per_step']:.1f} of "
          f"{out['prefill_ms']:.1f} ms", flush=True)
    del state

    # (c) bf16 consistency: prefill vs decode_step on 256 tokens
    tok_c = lm_tokens(1, 256, cfg.vocab, seed=3)
    pre, _ = model.prefill(params, tok_c, model.init_cache(1, 256))
    err = logit_errors(pre, feed(model, params, tok_c, 256))
    check(lm_bf16_ok(err), f"(c) bf16 prefill vs decode: {err}")
    out["bf16"] = err
    print(f"lm (c) bf16 x {cfg.n_layers} layers, 256 tokens: prefill "
          f"(flash) vs decode_step {json.dumps(err)} tol {LM_BF16_TOL:g} "
          f"(max abs, x max(1, max|ref|); and relative L2) ok", flush=True)

    # (d) capture the prefill's attention launch, tune it, select "exact"
    with tempfile.TemporaryDirectory(prefix="kl-lm-") as tmp:
        one = build_model(replace(cfg, n_layers=1))
        with quickstart._env(**{CAPTURE_ENV: "flash_attention_causal",
                                CAPTURE_DIR_ENV: f"{tmp}/captures"}):
            one.prefill({**params, "layers": params["layers"][:1]}, tok,
                        one.init_cache(LM_BATCH, LM_SEQ))
        caps = list_captures(f"{tmp}/captures")
        check(len(caps) == 1, f"{len(caps)} captures, want 1")
        res = tune_capture(caps[0], current_device_kind(), strategy="bayes",
                           max_evals=8, time_budget_s=120,
                           wisdom_dir=f"{tmp}/wisdom", device="cuda")
        with quickstart._env(**{WISDOM_DIR_ENV: f"{tmp}/wisdom"}):
            ops.reload_wisdom()
            tiers0 = dict(ops.fa_causal_kernel.tier_counts)
            _, sec = timed(lambda: model.prefill(
                params, tok, model.init_cache(LM_BATCH, LM_SEQ)))
            tiers = {t: n - tiers0.get(t, 0)
                     for t, n in ops.fa_causal_kernel.tier_counts.items()
                     if n != tiers0.get(t, 0)}
        ops.reload_wisdom()
    check(tiers == {"exact": cfg.n_layers},
          f"tuned prefill selected {tiers}, want exact x {cfg.n_layers}")
    out["tuned"] = res.best_config
    out["tuned_prefill_ms"] = sec * 1e3
    print(f"lm (d) captured {caps[0].name}, tuned by wall clock: best "
          f"{res.best_score_us:.1f} us after {len(res.evaluations)} evals -> "
          f"{res.best_config} (body {fa_body(res.best_config, 'bfloat16')});"
          f" next prefill selected {tiers} in {sec * 1e3:.1f} ms",
          flush=True)

    # (e) serve: token mode, 8 requests on 4 slots
    eng = ServeEngine(model, params, n_slots=4, max_seq=256, mode="token")
    rng = np.random.default_rng(0)
    for rid in range(8):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(8, 33)),
                              dtype=np.int32)
        check(eng.submit(Request(rid, prompt, max_new_tokens=16)),
              f"request {rid} rejected")
    rep, sec = timed(eng.run)
    check(rep.requests_completed == 8 and rep.mode == "token"
          and all(len(t) == 16 for t in rep.values()),
          f"serve: {rep.to_json()}")
    out["serve"] = rep.to_json() | {"seconds": sec,
                                    "tok_s": 8 * 16 / sec}
    print(f"lm (e) ServeEngine token mode, 4 slots, max_seq 256: "
          f"{rep.requests_completed} requests, {rep.steps} steps, occupancy "
          f"{rep.occupancy}, {8 * 16} tokens in {sec:.2f} s "
          f"({8 * 16 / sec:.1f} generated tokens/s)", flush=True)
    del model, params, eng
    torch.cuda.empty_cache()
    return out


def phase_times(qs: dict, mh: dict) -> dict:
    rows = {}
    tuned_256 = {(sc.kernel, sc.dtype): res.best_config
                 for sc, res in mh["tuned"]}
    sel_512 = {(name, dtype): st.config for name, dtype, st, _ in
               mh["launched"]}
    for dtype in DTYPES:
        for g, chosen in ((256, tuned_256), (512, sel_512)):
            shape = (g, g, g)
            args = stencil_args("diff_uvw_fused", shape, dtype)
            a_cfg = chosen[("advec_u", dtype)]
            d_cfg = chosen[("diff_uvw", dtype)]
            rows[("advec_u", g, dtype)] = timing_row(
                "advec_u", shape, dtype,
                {"default": kernel_cfg("advec_u", {}), "tuned": a_cfg,
                 "ldg": kernel_cfg("advec_u", LDG_CONFIGS[0]),
                 "tile": kernel_cfg("advec_u", TILE_LDG_BLOCK)},
                [*args[:3], args[4]])
            for name in STENCILS[1:]:
                rows[(name, g, dtype)] = timing_row(
                    name, shape, dtype,
                    {"default": kernel_cfg(name, {}),
                     "tuned": d_cfg | {"fuse_outputs":
                                       name == "diff_uvw_fused"},
                     "ldg": kernel_cfg(name, LDG_CONFIGS[0]),
                     "tile": kernel_cfg(name, TILE_LDG_BLOCK),
                     "tile_default": kernel_cfg(name, TILE_DEFAULT)}, args)
            fused, single = (rows[(n, g, dtype)] for n in STENCILS[1:])
            print("time K2a vs K2b a call " + json.dumps({
                "shape": list(shape), "dtype": dtype} | {
                f"{label}_ms": [fused[f"{label}_ms"], single[f"{label}_ms"],
                                fused[f"{label}_ms"] / single[f"{label}_ms"]]
                for label in ("tile", "tile_default")} | {
                "bound_ms": [fused["bound_ms"], single["bound_ms"]]}) +
                  " ([K2a, K2b, K2a / K2b])", flush=True)
            del args
    print(f"time stencils: default and tuned as selected (tuned K2a and "
          f"K2b: the tuned config in each fused variant); ldg and tile at "
          f"one block ({TILE_LDG_BLOCK['block_size_x']} x "
          f"{TILE_LDG_BLOCK['block_size_y']}); tile_default "
          f"{json.dumps(TILE_DEFAULT)} (advec_u's default)", flush=True)
    res = qs["result"]
    rows[("matmul", 512, "float32")] = timing_row(
        "matmul", QS_MATMUL, "float32",
        {"default": kernel_cfg("matmul", {}), "tuned": res.best_config},
        [qs["a"], qs["b"]])
    matmul_sweep([qs["a"], qs["b"]], res.best_config)
    rows[("matmul", 8192, "float32")] = timing_row(
        "matmul", BIG_MATMUL, "float32", {"default": kernel_cfg("matmul", {})},
        matrices(*BIG_MATMUL, "float32"))
    for shape in (QS_MATMUL, BIG_MATMUL):
        rows[("matmul", shape[0], "bfloat16")] = timing_row(
            "matmul", shape, "bfloat16",
            {"default": kernel_cfg("matmul", {})} | {
                label: kernel_cfg("matmul", u)
                for label, u in MATMUL_TIMED.items()},
            matrices(*shape, "bfloat16"))
    torch.cuda.empty_cache()
    return rows


def matmul_sweep(args, tuned: dict) -> None:
    """Every float32 config of the space on the quickstart's operands,
    median of 5, fastest first; and where the tuner's pick ranks."""
    space = get_kernel("matmul").space
    sweep = sorted(((c, time_ms(calls("matmul", c, args)[0], reps=5))
                    for c in space.enumerate()), key=lambda x: x[1])
    print("sweep matmul float32 " + json.dumps(
        [[c["block_m"], c["block_n"], c["block_k"], c["stages"],
          c["split_k"], c["grid_order"], round(ms, 4)] for c, ms in sweep])
          + " ([block_m, block_n, block_k, stages, split_k, grid_order, ms])",
          flush=True)
    rank = next(i for i, (c, _) in enumerate(sweep) if c == tuned)
    print(f"sweep matmul float32: {len(sweep)} configs, fastest "
          f"{sweep[0][1]:.4f} ms, slowest {sweep[-1][1]:.4f} ms; the tuned "
          f"config ranks {rank + 1} at {sweep[rank][1]:.4f} ms", flush=True)


def phase_lm_times(lm: dict) -> dict:
    """K4 at the shape the LM prefill gives it: (B*H, B*Hkv, S, D)."""
    cfg = get_arch(LM_ARCH)
    shape = (LM_BATCH * cfg.n_heads, LM_BATCH * cfg.n_kv_heads, LM_SEQ,
             cfg.d_head)
    args = qkv(*shape, "bfloat16")
    row = timing_row(
        "flash_attention_causal", shape, "bfloat16",
        {"default": kernel_cfg("flash_attention_causal", {}),
         "tuned": lm["tuned"],
         "mma": kernel_cfg("flash_attention_causal", FA_MMA)}, args)
    print(f"time flash_attention_causal bodies: default "
          f"{fa_body(kernel_cfg('flash_attention_causal', {}), 'bfloat16')},"
          f" tuned {fa_body(lm['tuned'], 'bfloat16')}, mma "
          f"{fa_body(kernel_cfg('flash_attention_causal', FA_MMA), 'bfloat16')}",
          flush=True)
    sweep = [(cfg, time_ms(calls("flash_attention_causal", cfg, args)[0],
                           reps=5))
             for cfg in get_kernel("flash_attention_causal").space.enumerate()]
    sweep.sort(key=lambda x: x[1])
    print("sweep flash_attention_causal " + json.dumps(
        [[c["block_q"], c["block_k"], c["threads"], fa_body(c, "bfloat16"),
          round(ms, 4)] for c, ms in sweep])
          + " ([block_q, block_k, threads, body, ms])", flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE float32 products
    t0 = time.perf_counter()
    phase_environment()
    phase_build()
    headline = phase_kernels()
    print(f"[{time.perf_counter() - t0:.0f}s] kernels agree with their "
          f"plain versions", flush=True)
    with tempfile.TemporaryDirectory(prefix="kl-smoke-") as tmp:
        wisdom = Path(tmp) / "wisdom"
        reg, tr, pr = instrument()
        qs, mh, counts = phase_main_path(wisdom)
        by = launches_by(LOOP_KERNELS)
        paths = [("main", len(pr.profiles))]
        stats = Counter({"matmul": len(qs["stats"])})
        stats.update(name for name, *_ in mh["launched"])
        stats["diff_uvw"] += both_diff_kernels(mh, wisdom / "microhh")
        paths.append(("forced", len(pr.profiles)))
        print(f"[{time.perf_counter() - t0:.0f}s] main path done", flush=True)
        _build.reset_launch_counts()
        ops_stats0 = {k: len(k.stats) for k in ops._ALL_KERNELS}
        lm = phase_lm()
        stats.update({k.builder.name: len(k.stats) - n
                      for k, n in ops_stats0.items() if len(k.stats) > n})
        paths.append(("lm", len(pr.profiles)))
        uninstrument()
        lm_counts = {k: _build.CUDA_KERNELS[k].launches for k in LM_KERNELS}
        print(f"lm-path launches: {json.dumps(lm_counts)}; flash_attention "
              f"by body: {json.dumps(flash_attention.BODY_LAUNCHES)}",
              flush=True)
        for name, n in lm_counts.items():
            check(n > 0, f"{name} was not launched on the LM path")
        counts |= lm_counts
        by |= launches_by(LM_KERNELS)
        print(f"[{time.perf_counter() - t0:.0f}s] LM path done", flush=True)
        rows = phase_times(qs, mh)
        rows[("flash_attention", 2048, "bfloat16")] = phase_lm_times(lm)
        t7 = time.perf_counter()
        phase_telemetry(reg, tr, pr, stats, paths, lm["serve"]["cohorts"])
        phase_export(current_device_kind(), wisdom, Path(tmp) / "generated")
        print(f"[{time.perf_counter() - t0:.0f}s] phase 7 (telemetry, "
              f"profiles, export) took {time.perf_counter() - t7:.1f}s",
              flush=True)
    kernels = []
    for name in TPU_KERNELS:
        key = ((name, 2048, "bfloat16") if name == "flash_attention"
               else (name, 512, "float32"))
        row = rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES[name]}",
            "replaces": TPU_KERNELS[name], "launches": counts[name],
            "launches_by_body_dtype": by[name],
            "max_abs_err": headline[name], "ms": row["tuned_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    print(f"[{time.perf_counter() - t0:.0f}s] done", flush=True)
    print(nvidia_smi())   # name, power limit: as nvidia-smi prints them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
