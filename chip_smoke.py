#!/usr/bin/env python3
"""Drive the port's main path on one H100 and check every kernel on it.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:

1. environment: torch, CUDA and nvcc versions, the card's name, capability
   (must be 9.0) and power limit;
2. build every kernel of the path from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source and config, all started together) and hold each CUDA
   kernel against its plain PyTorch version on the card: the small test
   shapes in float32 and bfloat16 at three configs, the MicroHH grids 256^3
   and 512^3, matmul at 512 x 1024 x 512 and 8192^3;
3. the quickstart loop: matmul 512 x 1024 x 512 float32, capture -> wall-clock
   tune (bayes) -> relaunch in tier "exact", equal to the first launch;
4. the MicroHH loop: tune advec_u and diff_uvw at 256^3 in float32 and
   bfloat16, select each in tier "exact", then launch both at 512^3 through a
   fallback tier and check them against their plain versions;
5. times from CUDA events beside each kernel's bound, its plain version's
   time and, for matmul, torch.matmul's.

Launch counts are set to 0 just before phases 3-4 and read just after; every
kernel must have launched there. The last two lines are the ``kernels`` JSON
and ``{"ok": true, "device": ...}``. With no card, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import get_kernel  # noqa: E402
from repro_torch.examples import quickstart, tune_microhh  # noqa: E402
from repro_torch.kernels import _build, advec_u, diff_uvw, matmul, ref  # noqa: E402
from repro_torch.kernels._stencil_common import stencil_defines  # noqa: E402
from repro_torch.tuner.runner import (L2_FLUSH_BYTES,  # noqa: E402
                                      _tolerances, verify_outcome)

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
BYTES = {"float32": 4, "bfloat16": 2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SMALL_STENCIL = [(8, 8, 128), (16, 32, 128), (32, 16, 256), (32, 32, 128)]
SMALL_MATMUL = [(128, 128, 256), (256, 512, 128), (64, 128, 1024)]
STENCIL_CONFIGS = [
    {},
    {"block_size_x": 128, "block_size_y": 2, "block_size_z": 2,
     "tile_factor_z": 4, "unravel_permutation": "zyx", "min_blocks_per_sm": 2},
    {"block_size_x": 16, "block_size_y": 16, "block_size_z": 1,
     "tile_factor_z": 8, "unravel_permutation": "yzx", "min_blocks_per_sm": 4},
]
MATMUL_CONFIGS = [
    {},
    {"block_m": 128, "block_n": 32, "block_k": 32, "grid_order": "nmk"},
    {"block_m": 128, "block_n": 128, "block_k": 8},
]
TPU_KERNELS = {   # CUDA kernel -> the Pallas call it replaces
    "advec_u": "src/repro/kernels/advec_u.py:91",
    "diff_uvw_fused": "src/repro/kernels/diff_uvw.py:111",
    "diff_uvw_single": "src/repro/kernels/diff_uvw.py:126",
    "matmul": "src/repro/kernels/matmul.py:137",
}
SOURCES = {"advec_u": "advec_u.cu", "diff_uvw_fused": "diff_uvw.cu",
           "diff_uvw_single": "diff_uvw.cu", "matmul": "matmul.cu"}


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

def kernel_cfg(name: str, upd: dict) -> dict:
    """The default config of CUDA kernel ``name`` updated by ``upd``."""
    if name in ("advec_u", "matmul"):
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
    return (lambda: matmul.launch(cfg, *args), lambda: ref.matmul_ref(*args))


def compare(name: str, cfg: dict, args, dtype: str, label: str,
            verbose: bool = True) -> float:
    """Run the kernel and its plain version on ``args``; raise unless they
    agree within the tuner's tolerance for ``dtype``. Returns the max
    absolute error."""
    kernel, plain = calls(name, cfg, args)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    out = verify_outcome(got, want, dtype)
    check(out.ok, f"{name} {label} {dtype} {cfg}: {out.error}")
    if verbose:
        print(f"check {name:16s} {label:14s} {dtype:8s} max_abs_err="
              f"{out.max_err:.3e} {tolerance(dtype)} ok config={cfg}",
              flush=True)
    return out.max_err


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


def bound(nbytes: float, flops: float, op_dtype: str) -> tuple[float, str]:
    """Least time in ms: bytes over HBM bandwidth vs operations over the
    peak for their type, whichever is larger, and which one it was."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[op_dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def work(name: str, shape, dtype: str) -> tuple[float, float]:
    """(bytes, flops) the function must move and do: each input read once,
    each output written once. diff_uvw_single is three launches, each
    reading one field and evisc and writing one tendency."""
    b = BYTES[dtype]
    if name == "matmul":
        m, n, k = shape
        return (m * k + k * n + m * n) * b, 2.0 * m * n * k
    pts = shape[0] * shape[1] * shape[2]
    fields_moved = {"advec_u": 4, "diff_uvw_fused": 7,
                    "diff_uvw_single": 9}[name]
    flops = (ref.ADVEC_FLOPS_PER_POINT if name == "advec_u"
             else 3 * ref.DIFF_FLOPS_PER_POINT_PER_FIELD) * pts
    return fields_moved * pts * b + 16, float(flops)


def library_call(a, b):
    """torch.matmul with TF32 off: the yardstick, never used by the port."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def timing_row(name: str, shape, dtype: str, configs: dict, args) -> dict:
    """Times of each named config, the plain version and (matmul) the
    library call, beside the bound; printed and returned."""
    row = {"kernel": name, "shape": list(shape), "dtype": dtype}
    for label, cfg in configs.items():
        row[f"{label}_ms"] = time_ms(calls(name, cfg, args)[0])
    row["plain_ms"] = time_ms(calls(name, next(iter(configs.values())),
                                    args)[1], reps=3)
    row["library_ms"] = (time_ms(lambda: library_call(*args))
                         if name == "matmul" else None)
    nbytes, flops = work(name, shape, dtype)
    # the stencils compute in float32 whatever dtype they store
    row["bound_ms"], row["bound_by"] = bound(
        nbytes, flops, dtype if name == "matmul" else "float32")
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


def phase_build() -> None:
    specs = []
    for upd in STENCIL_CONFIGS:
        d = stencil_defines(kernel_cfg("advec_u", upd))
        specs += [("advec_u.cu", d), ("diff_uvw.cu", d)]
    specs += [("matmul.cu", matmul._defines(kernel_cfg("matmul", u)))
              for u in MATMUL_CONFIGS]
    secs = _build.build_many(specs)
    print(f"built {len(specs)} libraries with nvcc -gencode "
          f"arch=compute_90a,code=sm_90a in {secs:.1f}s (parallel)",
          flush=True)


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the max error at
    the headline shapes."""
    headline = {}
    for dtype in DTYPES:
        for name in ("advec_u", "diff_uvw_fused", "diff_uvw_single",
                     "matmul"):
            errs = []
            shapes = SMALL_MATMUL if name == "matmul" else SMALL_STENCIL
            for shape in shapes:
                args = (matrices(*shape, dtype) if name == "matmul"
                        else stencil_args(name, shape, dtype))
                for upd in (MATMUL_CONFIGS if name == "matmul"
                            else STENCIL_CONFIGS):
                    errs.append(compare(name, kernel_cfg(name, upd), args,
                                        dtype, "x".join(map(str, shape)),
                                        verbose=False))
            print(f"check {name:16s} {len(errs)} cases ({len(shapes)} test "
                  f"shapes x 3 configs) {dtype:8s} max_abs_err="
                  f"{max(errs):.3e} {tolerance(dtype)} ok", flush=True)
    for dtype in DTYPES:
        for g in (256, 512):
            for name in ("advec_u", "diff_uvw_fused", "diff_uvw_single"):
                args = stencil_args(name, (g, g, g), dtype)
                err = compare(name, kernel_cfg(name, {}), args, dtype,
                              f"{g}^3")
                if g == 512 and dtype == "float32":
                    headline[name] = err
                del args
        args = matrices(512, 512, 1024, dtype)
        err = compare("matmul", kernel_cfg("matmul", {}), args, dtype,
                      "m512n512k1024")
        if dtype == "float32":
            headline["matmul"] = err
    compare("matmul", kernel_cfg("matmul", {}),
            matrices(8192, 8192, 8192, "float32"), "float32", "m=n=k=8192")
    torch.cuda.empty_cache()
    return headline


def phase_main_path() -> tuple[dict, dict, dict]:
    _build.reset_launch_counts()
    qs = quickstart.main(["--device", "cuda", "--max-evals", "10",
                          "--budget-seconds", "120"])
    check(qs["tiers"] == ("default", "exact"),
          f"quickstart tiers {qs['tiers']}, want ('default', 'exact')")
    mh = tune_microhh.main(["--device", "cuda", "--max-evals", "8",
                            "--budget-seconds", "120"])
    for sc, tier, cfg in mh["selected"]:
        check(tier == "exact", f"{sc.key}: selected tier {tier}")
    for name, dtype, st, _ in mh["launched"]:
        check(st.tier not in ("exact", "default", "forced"),
              f"{name} 512^3 {dtype}: tier {st.tier} is not a fallback")
    counts = {k: v.launches for k, v in _build.CUDA_KERNELS.items()}
    print(f"main-path launches: {json.dumps(counts)}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")
    return qs, mh, counts


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
                {"default": kernel_cfg("advec_u", {}), "tuned": a_cfg},
                [*args[:3], args[4]])
            for name, fuse in (("diff_uvw_fused", True),
                               ("diff_uvw_single", False)):
                rows[(name, g, dtype)] = timing_row(
                    name, shape, dtype,
                    {"default": kernel_cfg(name, {}),
                     "tuned": d_cfg | {"fuse_outputs": fuse}}, args)
            del args
    res = qs["result"]
    rows[("matmul", 512, "float32")] = timing_row(
        "matmul", (512, 512, 1024), "float32",
        {"default": kernel_cfg("matmul", {}), "tuned": res.best_config},
        [qs["a"], qs["b"]])
    rows[("matmul", 8192, "float32")] = timing_row(
        "matmul", (8192, 8192, 8192), "float32",
        {"default": kernel_cfg("matmul", {})},
        matrices(8192, 8192, 8192, "float32"))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_environment()
    phase_build()
    headline = phase_kernels()
    print(f"[{time.perf_counter() - t0:.0f}s] kernels agree with their "
          f"plain versions", flush=True)
    qs, mh, counts = phase_main_path()
    print(f"[{time.perf_counter() - t0:.0f}s] main path done", flush=True)
    rows = phase_times(qs, mh)
    kernels = []
    for name in TPU_KERNELS:
        key = (name, 512, "float32")
        row = rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES[name]}",
            "replaces": TPU_KERNELS[name], "launches": counts[name],
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
