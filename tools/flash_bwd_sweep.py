#!/usr/bin/env python3
"""Build, check and time the flash-attention backward kernel
(``kernels/flash_attention_bwd.py``) over its whole tuning space.

    python3 tools/flash_bwd_sweep.py [--out chiprun_out/flash_bwd_sweep.json]

For each config of both builders (causal and full) it builds the library
with ``nvcc -Xptxas -v`` and prints each kernel's registers and spills,
checks the gradients on a ragged shape (GQA 8/2, S 200) against the plain
version's autograd in float32 on the same bfloat16 inputs, and times the
causal launch at the training cell's shape (BH 64, BHkv 8, S 2048, D 128)
with CUDA events, beside its bound, the plain backward and PyTorch's SDPA
backward (the yardstick, never called by the port). Then it checks the
fastest config and the default at that shape, twice, for bit-identical
gradients. Needs the card; exits non-zero if a build, a check or a repeat
fails.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build, flash_attention, ref  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fb  # noqa: E402

DEVICE = "cuda"
CELL = (64, 8, 2048, 128)
RAGGED = (8, 2, 200, 128)
#: The card's test bounds: relative L2 of each gradient, worst row's.
REL_L2_TOL, ROW_L2_TOL = 1e-2, 5e-2
PEAK_BF16 = 989e12
L2_FLUSH_BYTES = 256 << 20
KERNEL = re.compile(
    r"Function properties for (\S*fa_bwd_(dq|dkdv)_kernel\S*)")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def ptxas(builders) -> list[dict]:
    """Registers and spills of both kernels of every config's build."""
    procs = []
    with tempfile.TemporaryDirectory(prefix="fa-bwd-ptxas-") as tmp:
        for i, (causal, cfg) in enumerate(
                (c, cfg) for c, b in builders for cfg in b.space.enumerate()):
            cmd = _build.nvcc_command(fb.kernel.source,
                                      fb.defines(cfg, causal),
                                      Path(tmp) / f"{i}.so")
            procs.append((causal, cfg, subprocess.Popen(
                [*cmd, "-Xptxas", "-v"], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        out = []
        for causal, cfg, proc in procs:
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {cfg} causal={causal}:\n"
                                   f"{err}")
            lines = err.splitlines()
            row = {"causal": causal, "config": cfg}
            for i, line in enumerate(lines):
                m = KERNEL.search(line)
                if m:
                    spill = SPILL.search(lines[i + 1])
                    regs = REGS.search(lines[i + 2])
                    row[m.group(2)] = {"registers": int(regs.group(1)),
                                       "spill_stores": int(spill.group(1)),
                                       "spill_loads": int(spill.group(2))}
            print("ptxas " + json.dumps(row), flush=True)
            out.append(row)
        return out


def inputs(problem, seed: int):
    bh, bhkv, s, d = problem
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=DEVICE)
                   .to(torch.bfloat16) for shape in
                   ((bh, s, d), (bhkv, s, d), (bhkv, s, d), (bh, s, d)))
    return q, k, v, do


def errors(got, want) -> dict:
    """Relative L2 of each gradient and its worst row, against float32."""
    out = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.double(), w.double()
        out[name] = {"rel_l2": float((a - w).norm() / w.norm()),
                     "row_l2": flash_attention.row_l2_error(a, w)}
    return out


def ok(errs: dict) -> bool:
    return all(e["rel_l2"] <= REL_L2_TOL and e["row_l2"] <= ROW_L2_TOL
               for e in errs.values())


class Case:
    """One problem's bfloat16 inputs and the plain float32 gradient of
    the same inputs."""

    def __init__(self, problem, causal: bool, seed: int):
        self.problem, self.causal = problem, causal
        self.q, self.k, self.v, self.do = inputs(problem, seed)
        self.want = ref.flash_attention_bwd_ref_factory(causal)(
            *(t.float() for t in (self.q, self.k, self.v, self.do)))

    def run(self, cfg):
        return fb.launch(cfg, self.q, self.k, self.v, self.do,
                         causal=self.causal)


def time_ms(fn, reps: int = 10) -> float:
    """Median ms of ``reps`` calls, each after an L2 flush."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sdpa_backward(case: Case):
    """SDPA's backward on the same tensors (GQA by ``enable_gqa``)."""
    leaves = [t.detach().requires_grad_(True)
              for t in (case.q, case.k, case.v)]
    out = F.scaled_dot_product_attention(
        *(t[None] for t in leaves), is_causal=case.causal,
        enable_gqa=True)[0]
    return lambda: torch.autograd.grad(out, leaves, case.do,
                                       retain_graph=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/flash_bwd_sweep.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}", flush=True)
    builders = [(True, fb.causal_builder), (False, fb.full_builder)]
    report = {"device": smi, "ptxas": ptxas(builders), "checks": [],
              "times": []}
    _build.build_many((fb.kernel.source, fb.defines(cfg, c))
                      for c, b in builders for cfg in b.space.enumerate())
    bad = 0
    for causal, b in builders:
        case = Case(RAGGED, causal, seed=1)
        for cfg in b.space.enumerate():
            errs = errors(case.run(cfg), case.want)
            row = {"problem": RAGGED, "causal": causal, "config": cfg,
                   "errors": errs, "ok": ok(errs)}
            bad += not row["ok"]
            print("check " + json.dumps(row), flush=True)
            report["checks"].append(row)
    cell = Case(CELL, True, seed=2)
    b = fb.causal_builder
    w = b.make_workload(b.default_config(), CELL, "bfloat16")
    bound_ms = w.flops / PEAK_BF16 * 1e3
    for cfg in b.space.enumerate():
        ms = time_ms(lambda: cell.run(cfg))
        row = {"config": cfg, "ms": ms, "bound_ms": bound_ms,
               "peak_share": bound_ms / ms}
        print("time " + json.dumps(row), flush=True)
        report["times"].append(row)
    best = min(report["times"], key=lambda r: r["ms"])["config"]
    for label, cfg in (("default", b.default_config()), ("best", best)):
        first, second = cell.run(cfg), cell.run(cfg)
        errs = errors(first, cell.want)
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        row = {"label": label, "problem": CELL, "config": cfg,
               "errors": errs, "ok": ok(errs), "bit_identical": same}
        bad += not (row["ok"] and same)
        print("cell " + json.dumps(row), flush=True)
        report[f"cell_{label}"] = row
    plain = ref.flash_attention_bwd_ref_factory(True)
    report["plain_ms"] = time_ms(lambda: plain(cell.q, cell.k, cell.v,
                                               cell.do), reps=3)
    report["library_ms"] = time_ms(sdpa_backward(cell))
    print(f"plain backward {report['plain_ms']:.3f} ms, SDPA backward "
          f"{report['library_ms']:.3f} ms, bound {bound_ms:.4f} ms "
          f"(operations, {w.flops / 1e9:.1f} GFLOP)", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(f"flash_bwd_sweep: {bad} failures", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
