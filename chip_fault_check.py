#!/usr/bin/env python3
"""Plant faults in the flash-attention (K4), matmul (K3) and stencil (K1,
K2a, K2b) kernels and read what the checks of ``chip_smoke.py`` make of
them, on one H100.

    python3 chip_fault_check.py

Builds the kernels as they are and altered copies, in a temporary directory
(the checkout is not touched):

* ``no_mask`` (K4): the causal build attends to every key (the full mask);
* ``late_tile`` (K4): the query tiles whose diagonal lies in the later half
  of the keys skip that last k/v tile, a fault confined to late rows;
* ``kv_release_before_softmax`` (K4): the wgmma body's ring releases a
  k/v stage, and thread 0 refills it, as soon as Q.K^T is done, so the
  refill may land before P.V reads V;
* ``drop_last_split`` (K3): the split-K reduction skips the last slice;
* ``early_stage_reuse`` (K3): the bfloat16 body's ring releases a stage,
  and thread 0 refills it, before the wgmma that reads it has been waited
  on;
* ``clamp_halo`` (K1): the tile body's halo clamps at the grid's edge
  instead of wrapping (``tile::halo_index`` in ``stencil_tile.cuh``);
* ``stale_z_queue`` (K2b): the single-field tile body's register queue of
  f skips its shift on the second staged plane of each strip;
* ``fused_field_alias`` (K2a): the fused tile body reads w's y neighbours
  from v's ring buffer.

The readings, as ``chip_smoke.py`` takes them:

1. K4 (sound kernel and K4 faults): phase 2's K4 checks at the LM
   prefill's shape (BH 128 x S 2048 x D 128, bfloat16, causal) in every
   config of ``chip_smoke.FA_SLICE_CONFIGS``: the default and the
   two-warpgroup 128 x 128 (wgmma body) and an mma-body one; the tuner's
   allclose and the largest relative L2 error of a row against
   ``flash_attention.ROW_L2_TOL``; it passes only if every config does;
2. check (c) (sound kernel and K4 faults): codeqwen1.5-7b in bfloat16 with
   all 32 layers and the same seeded weights (default config: the wgmma
   body), the last logits of a 256-token prefill against the same tokens
   fed through ``decode_step`` (which runs no flash kernel), against
   ``chip_smoke.LM_BF16_TOL``;
3. K3 (sound kernel and K3 faults): phase 2's matmul check at 8192^3 in
   float32 and bfloat16, every config of ``chip_smoke.MATMUL_CONFIGS``, the
   tuner's allclose; it passes only if every config does;
4. K1, K2a and K2b (sound kernels and the stencil faults): phase 2's
   tile-body checks of advec_u, diff_uvw_fused and diff_uvw_single, every
   config of ``chip_smoke.TILE_CONFIGS`` on the test shapes and the ragged
   one, in float32 and bfloat16, the tuner's allclose; each passes only if
   every case does.

Exits non-zero unless the sound kernels pass every reading and every fault
fails each reading of its kernel.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as smoke
from repro_torch.configs import get_arch
from repro_torch.kernels import _build, flash_attention, matmul, ref
from repro_torch.kernels._stencil_common import stencil_defines
from repro_torch.models import build_model
from repro_torch.tuner.runner import verify_outcome

#: fault -> (source under csrc/, its edits: (text to alter, replacement))
FAULTS = {
    "no_mask": ("flash_attention.cu", (
        ("namespace {\n", "#undef CAUSAL\n#define CAUSAL 0\nnamespace {\n"),)),
    "late_tile": ("flash_attention.cu", (
        ("  return diag < n ? diag : n;\n",
         "  return diag <= n / 2 ? diag : (diag < n ? diag : n) - 1;\n"),)),
    "kv_release_before_softmax": ("flash_attention.cu", (
        ("      wgmma_wait<0>();\n"
         "      wgmma_fence_operands<SACC>(sc);\n",
         "      wgmma_wait<0>();\n"
         "      wgmma_fence_operands<SACC>(sc);\n"
         "      release();\n"),
        ("      wgmma_fence_operands<OACC>(acc);\n"
         "      release();\n",
         "      wgmma_fence_operands<OACC>(acc);\n"))),
    "drop_last_split": ("matmul.cu", (
        ("for (int z = 1; z < SPLIT_K; ++z)",
         "for (int z = 1; z < SPLIT_K - 1; ++z)"),)),
    "early_stage_reuse": ("matmul.cu", (
        ("    wgmma_wait<1>();\n"
         "    wgmma_fence_operands<ACC>(acc);\n"
         "    const int done = t - 1;\n",
         "    wgmma_fence_operands<ACC>(acc);\n"
         "    const int done = t;\n"),)),
    "clamp_halo": ("stencil_tile.cuh", (
        ("  const int r = a % n;\n"
         "  return r < 0 ? r + n : r;\n",
         "  return a < 0 ? 0 : (a >= n ? n - 1 : a);\n"),)),
    "stale_z_queue": ("diff_uvw.cu", (
        ("        tile::push(fq, tile::to_f32(sf[front]));\n",
         "        if (p != 1) tile::push(fq, tile::to_f32(sf[front]));\n"),)),
    "fused_field_alias": ("diff_uvw.cu", (
        ("          const float fy[3] = {at(f, -S::PITCH), q[f][1], "
         "at(f, S::PITCH)};\n",
         "          const int g = f == 2 ? 1 : f;\n"
         "          const float fy[3] = {at(g, -S::PITCH), q[f][1], "
         "at(g, S::PITCH)};\n"),)),
}
#: The readings taken for each fault: those of the kernel it is planted in.
READINGS = {"no_mask": ("k4", "lm_c"), "late_tile": ("k4", "lm_c"),
            "kv_release_before_softmax": ("k4", "lm_c"),
            "drop_last_split": ("k3",), "early_stage_reuse": ("k3",),
            "clamp_halo": ("k1",), "stale_z_queue": ("k2b",),
            "fused_field_alias": ("k2a",)}
#: The stencil readings: reading -> the kernel it holds.
STENCIL_READINGS = {"k1": "advec_u", "k2a": "diff_uvw_fused",
                    "k2b": "diff_uvw_single"}


def use_source(csrc: Path, build: Path) -> None:
    """Build and load the kernels from ``csrc`` from now on."""
    _build.CSRC, _build.BUILD_DIR = csrc, build
    _build._LOADED.clear()


def faulted_copy(sound: Path, tmp: Path, fault: str) -> Path:
    """A copy of ``sound`` (every .cu and .cuh) with ``fault`` planted."""
    source, edits = FAULTS[fault]
    csrc = tmp / fault
    csrc.mkdir()
    for path in [*sound.glob("*.cu"), *sound.glob("*.cuh")]:
        shutil.copy(path, csrc)
    text = (sound / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{fault}: the text to alter is not in "
                               f"{source} once")
        text = text.replace(old, new)
    (csrc / source).write_text(text)
    return csrc


def build_k4() -> None:
    """Build the K4 libraries of the K4 reading and (c) from the current
    sources together, one nvcc each, before any is loaded."""
    _build.build_many(
        ("flash_attention.cu", smoke.flash_defines(
            smoke.kernel_cfg("flash_attention_causal", u), True, "bfloat16"))
        for u in smoke.FA_SLICE_CONFIGS)


def k3_reading(big: dict) -> dict:
    """Phase 2's matmul check at 8192^3: every check config in both dtypes
    against the plain version's output."""
    _build.build_many(
        ("matmul.cu", matmul.defines(c, matmul.plan(c, *smoke.BIG_MATMUL, dt)))
        for dt in big for c in (smoke.kernel_cfg("matmul", u)
                                for u in smoke.MATMUL_CONFIGS))
    cases = {}
    for dtype, (args, want) in big.items():
        for u in smoke.MATMUL_CONFIGS:
            out, body = smoke.matmul_check(smoke.kernel_cfg("matmul", u), args,
                                           want, dtype)
            cases[f"{dtype} {body} {json.dumps(u)}"] = {
                "ok": out.ok, "max_abs_err": out.max_err}
    return {"ok": all(c["ok"] for c in cases.values()), "cases": cases}


def stencil_reading(name: str) -> dict:
    """Phase 2's tile-body checks of stencil ``name``: every config of
    ``TILE_CONFIGS`` on the test shapes and the ragged one, both dtypes."""
    cfgs = [smoke.kernel_cfg(name, u) for u in smoke.TILE_CONFIGS]
    src = "advec_u.cu" if name == "advec_u" else "diff_uvw.cu"
    _build.build_many((src, stencil_defines(c)) for c in cfgs)
    cases = {}
    for dtype in smoke.DTYPES:
        for shape in [*smoke.SMALL_STENCIL, smoke.RAGGED_STENCIL]:
            args = smoke.stencil_args(name, shape, dtype)
            for cfg in cfgs:
                kernel, plain = smoke.calls(name, cfg, args)
                got = kernel()
                torch.cuda.synchronize()
                out = verify_outcome(got, plain(), dtype)
                cases[f"{dtype} {shape} {json.dumps(cfg)}"] = {
                    "ok": out.ok, "max_abs_err": out.max_err}
    return {"ok": all(c["ok"] for c in cases.values()),
            "cases_failed": sum(not c["ok"] for c in cases.values()),
            "cases": len(cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases.values())}


def kernel_reading(args, want: torch.Tensor) -> dict:
    """Phase 2's K4 checks at the slice shape: every config of
    ``FA_SLICE_CONFIGS`` against the plain version's output ``want``."""
    cases = {}
    for u in smoke.FA_SLICE_CONFIGS:
        cfg = smoke.kernel_cfg("flash_attention_causal", u)
        got = flash_attention.launch(cfg, *args, causal=True)
        torch.cuda.synchronize()
        out = verify_outcome(got, want, "bfloat16")
        row = flash_attention.row_l2_error(got, want)
        cases[f"{smoke.fa_body(cfg, 'bfloat16')} {json.dumps(cfg)}"] = {
            "allclose_ok": out.ok, "max_abs_err": out.max_err,
            "row_l2_err": row,
            "ok": out.ok and row <= flash_attention.ROW_L2_TOL["bfloat16"]}
    return {"ok": all(c["ok"] for c in cases.values()),
            "max_abs_ref": float(want.abs().max()), "cases": cases}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sound = (_build.CSRC, _build.BUILD_DIR)
    cfg = get_arch(smoke.LM_ARCH)
    args = smoke.qkv(128, 128, smoke.LM_SEQ, smoke.FA_HEAD_DIM, "bfloat16")
    fa_want = ref.flash_attention_ref_factory(True)(*args)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tok = smoke.lm_tokens(1, 256, cfg.vocab, seed=3)
    want = smoke.feed(model, params, tok, 256)
    big = {}
    for dtype in smoke.DTYPES:
        ab = smoke.matrices(*smoke.BIG_MATMUL, dtype)
        big[dtype] = (ab, ref.matmul_ref(*ab))
    readings = {}
    with tempfile.TemporaryDirectory(prefix="kernel-fault-") as tmp:
        for fault in (None, *FAULTS):
            if fault is None:
                use_source(*sound)
                checks = ("k4", "lm_c", "k3", *STENCIL_READINGS)
            else:
                csrc = faulted_copy(sound[0], Path(tmp), fault)
                use_source(csrc, csrc / "build")
                checks = READINGS[fault]
            name = fault or "sound"
            r = {}
            if "k4" in checks:
                build_k4()
                r["k4"] = kernel_reading(args, fa_want)
                pre, _ = model.prefill(params, tok, model.init_cache(1, 256))
                r["lm_c"] = smoke.logit_errors(pre, want)
                r["lm_c"]["ok"] = smoke.lm_bf16_ok(r["lm_c"])
                print(f"fault {name}: K4 BH128 S2048 D128 bf16 "
                      f"{json.dumps(r['k4'])}; (c) prefill vs decode_step "
                      f"{json.dumps(r['lm_c'])}", flush=True)
            if "k3" in checks:
                r["k3"] = k3_reading(big)
                print(f"fault {name}: K3 8192^3 {json.dumps(r['k3'])}",
                      flush=True)
            for reading, kernel in STENCIL_READINGS.items():
                if reading in checks:
                    r[reading] = stencil_reading(kernel)
                    print(f"fault {name}: {kernel} tile body "
                          f"{json.dumps(r[reading])}", flush=True)
            readings[name] = r
    use_source(*sound)
    print(f"tolerances: K4 allclose {smoke.tolerance('bfloat16')}, row "
          f"relative L2 {flash_attention.ROW_L2_TOL['bfloat16']}; (c) "
          f"{smoke.LM_BF16_TOL} (max abs, x max(1, max|ref|); and relative "
          f"L2); K3 allclose {smoke.tolerance('float32')} in float32, "
          f"{smoke.tolerance('bfloat16')} in bfloat16; K1, K2a and K2b as K3")
    print(smoke.nvidia_smi())
    bad = [f"{name} {check}" for name, r in readings.items()
           for check in r if r[check]["ok"] != (name == "sound")]
    print(json.dumps({"ok": not bad, "unexpected": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
