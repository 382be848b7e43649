#!/usr/bin/env python3
"""Plant faults in the flash-attention kernel and read what the checks of
``chip_smoke.py`` make of them, on one H100.

    python3 chip_fault_check.py

Builds ``csrc/flash_attention.cu`` as it is and two altered copies, in a
temporary directory (the checkout is not touched):

* ``no_mask``: the causal build attends to every key (the full mask);
* ``late_tile``: the query tiles whose diagonal lies in the later half of
  the keys skip that last k/v tile, a fault confined to late rows.

For each it prints two readings, as ``chip_smoke.py`` takes them:

1. the K4 check at the LM prefill's shape (BH 128 x S 2048 x D 128,
   bfloat16, causal, default config): the tuner's allclose and the largest
   relative L2 error of a row against ``flash_attention.ROW_L2_TOL``;
2. check (c): codeqwen1.5-7b in bfloat16 with all 32 layers and the same
   seeded weights, the last logits of a 256-token prefill against the same
   tokens fed through ``decode_step`` (which runs no flash kernel), against
   ``chip_smoke.LM_BF16_TOL``.

Exits non-zero unless the sound kernel passes both checks and every fault
fails both.
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
from repro_torch.kernels import _build, flash_attention, ref
from repro_torch.models import build_model
from repro_torch.tuner.runner import verify_outcome

#: fault -> (text of csrc/flash_attention.cu, its replacement)
FAULTS = {
    "no_mask": ("namespace {\n",
                "#undef CAUSAL\n#define CAUSAL 0\nnamespace {\n"),
    "late_tile": ("  return diag < n ? diag : n;\n",
                  "  return diag <= n / 2 ? diag : (diag < n ? diag : n) - 1;\n"),
}


def use_source(csrc: Path, build: Path) -> None:
    """Build and load flash_attention.cu from ``csrc`` from now on."""
    _build.CSRC, _build.BUILD_DIR = csrc, build
    _build._LOADED.clear()


def kernel_reading(args) -> dict:
    cfg = flash_attention.causal_builder.default_config()
    got = flash_attention.launch(cfg, *args, causal=True)
    want = ref.flash_attention_ref_factory(True)(*args)
    out = verify_outcome(got, want, "bfloat16")
    row = flash_attention.row_l2_error(got, want)
    return {"allclose_ok": out.ok, "max_abs_err": out.max_err,
            "max_abs_ref": float(want.abs().max()), "row_l2_err": row,
            "ok": out.ok and row <= flash_attention.ROW_L2_TOL["bfloat16"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sound = (_build.CSRC, _build.BUILD_DIR)
    cfg = get_arch(smoke.LM_ARCH)
    args = smoke.qkv(128, 128, smoke.LM_SEQ, smoke.FA_HEAD_DIM, "bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tok = smoke.lm_tokens(1, 256, cfg.vocab, seed=3)
    want = smoke.feed(model, params, tok, 256)
    readings = {}
    with tempfile.TemporaryDirectory(prefix="fa-fault-") as tmp:
        for fault in (None, *FAULTS):
            if fault is None:
                use_source(*sound)
            else:
                csrc = Path(tmp) / fault
                csrc.mkdir()
                text = (sound[0] / "flash_attention.cu").read_text()
                old, new = FAULTS[fault]
                if text.count(old) != 1:
                    raise RuntimeError(f"{fault}: the text to alter is not "
                                       f"in flash_attention.cu once")
                (csrc / "flash_attention.cu").write_text(
                    text.replace(old, new))
                for extra in sound[0].glob("*.cuh"):
                    shutil.copy(extra, csrc)
                use_source(csrc, csrc / "build")
            name = fault or "sound"
            k4 = kernel_reading(args)
            pre, _ = model.prefill(params, tok, model.init_cache(1, 256))
            lm = smoke.logit_errors(pre, want)
            lm["ok"] = smoke.lm_bf16_ok(lm)
            readings[name] = {"k4": k4, "lm_c": lm}
            print(f"fault {name}: K4 BH128 S2048 D128 bf16 {json.dumps(k4)};"
                  f" (c) prefill vs decode_step {json.dumps(lm)}", flush=True)
    use_source(*sound)
    print(f"tolerances: K4 allclose {smoke.tolerance('bfloat16')}, row "
          f"relative L2 {flash_attention.ROW_L2_TOL['bfloat16']}; (c) "
          f"{smoke.LM_BF16_TOL} (max abs, x max(1, max|ref|); and relative "
          f"L2)")
    print(smoke.nvidia_smi())
    bad = [f"{name} {check}" for name, r in readings.items()
           for check in ("k4", "lm_c")
           if r[check]["ok"] != (name == "sound")]
    print(json.dumps({"ok": not bad, "unexpected": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
