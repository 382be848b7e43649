"""Render the dry-run tables from its JSON records (port of
``repro.roofline.report``; the same text from the same records)."""

from __future__ import annotations

import json
from pathlib import Path


def load_records(dryrun_dir: Path | str) -> list[dict]:
    out = []
    for p in sorted(Path(dryrun_dir).glob("*.json")):
        with open(p) as f:
            out.append(json.load(f))
    return out


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def dryrun_table(records: list[dict], mesh_tag: str) -> str:
    rows = ["| arch | shape | status | compile | flops/chip | bytes/chip "
            "| coll/chip | temp GiB |",
            "|---|---|---|---|---|---|---|---|"]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh_tag") != mesh_tag:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP (documented) "
                        f"| — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | **{r['status']}** "
                        f"| — | — | — | — | — |")
            continue
        w = r["hlo_walk"]
        coll = r["collective_bytes"]["total"]
        tmp = r["memory_analysis"].get("temp_bytes")
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']:.0f}s "
            f"| {w['flops']:.2e} | {w['bytes_fused']:.2e} | {coll:.2e} "
            f"| {tmp/2**30:.1f} |" if tmp else
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']:.0f}s "
            f"| {w['flops']:.2e} | {w['bytes_fused']:.2e} | {coll:.2e} "
            f"| n/a |")
    return "\n".join(rows)


def roofline_table(records: list[dict], mesh_tag: str = "singlepod") -> str:
    rows = ["| arch | shape | compute | memory | collective | dominant "
            "| model TF | useful | roofline |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh_tag") != mesh_tag or r["status"] != "ok":
            continue
        f = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(f['compute_s'])} "
            f"| {_fmt_s(f['memory_s'])} | {_fmt_s(f['collective_s'])} "
            f"| {f['dominant']} | {f['model_flops']/1e12:.1f} "
            f"| {f['useful_flops_ratio']:.2f} "
            f"| {f['roofline_fraction']:.3f} |")
    return "\n".join(rows)


def main() -> None:  # pragma: no cover
    recs = load_records("experiments/dryrun_torch")
    print("## Dry-run (single pod)\n")
    print(dryrun_table(recs, "singlepod"))
    print("\n## Dry-run (multi-pod)\n")
    print(dryrun_table(recs, "multipod"))
    print("\n## Roofline (single pod)\n")
    print(roofline_table(recs))


if __name__ == "__main__":  # pragma: no cover
    main()
