"""Multi-pod dry-run (port of ``repro.launch.dryrun``): run every
(architecture x input shape) cell on the production meshes and record the
per-chip cost, collective and memory analysis that the roofline tables
read.

The production meshes are fake (``launch.mesh``): 256 or 512 ranks of
which this process is rank 0, holding ``meta`` shards. So the dry-run is
shape-only by design: the model builds on ``meta``, its parameters,
optimiser state, cache and batch become ``DTensor``s by the sharding
rules, and the cell's step runs eagerly under
``roofline.op_count.OpCounter``, which counts this rank's local ops, its
collectives and the kernels' workloads. Eager compiles nothing, so
``compile_s`` is 0.0 and ``lower_s`` is the counting run's seconds.

On the 1x1 debug mesh (``make_debug_mesh``) the same step runs for real on
the card (or the host, when asked), with weights and inputs drawn from a
seed, and the record adds the step's seconds, the device's peak memory
and, for a train step, its loss.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

With more than one cell, each runs in a child process (a fresh fake
group), as many at once as the host has cores, and one that runs past
``CELL_LIMIT_S`` is recorded ``unfinished``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (make_production_mesh, mesh_device,
                                     mesh_shape, use_mesh)
from repro_torch.launch.shapes import (SHAPES, ShapeSpec, cell_skip_reason,
                                       input_specs, microbatches_for)
from repro_torch.models import build_model
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.roofline import roofline_report
from repro_torch.roofline.op_count import CountTimeout, OpCounter
from repro_torch.tree import leaves
from repro_torch.train import init_train_state, make_train_step

DEFAULT_OUT = Path("experiments/dryrun_torch")
#: A cell whose counting run passes this many seconds is ``unfinished``.
CELL_LIMIT_S = 600.0


def _local_bytes(tree_) -> int:
    """Bytes of this rank's shards of every tensor leaf of ``tree``."""
    from torch.distributed.tensor import DTensor

    total = 0
    for leaf in leaves(tree_):
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            total += t.numel() * t.element_size()
    return total


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _cell_step(model, cfg: ArchConfig, arch: str, shape: ShapeSpec,
               shape_name: str, mesh, device: str, seed: int):
    """(step, arguments) of one cell, its inputs distributed on ``mesh``."""
    specs = input_specs(cfg, shape, device=device, seed=seed)
    if shape.kind == "train":
        optimizer = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))
        state = init_train_state(model, optimizer, seed)
        state = sh.distribute_tree(state, sh.state_pspecs(state, mesh, cfg),
                                   mesh)
        batch = sh.distribute_tree(
            specs["batch"], sh.batch_pspecs(specs["batch"], mesh), mesh)
        step = make_train_step(model, optimizer,
                               microbatches_for(arch, shape_name))
        return step, (state, batch)
    params = model.init(seed)
    params = sh.distribute_tree(
        params, sh.param_pspecs(params, mesh, cfg, serve=True), mesh)
    cache = sh.distribute_tree(specs["cache"],
                               sh.cache_pspecs(specs["cache"], mesh), mesh)
    tokens = sh.distribute_tree(
        {"t": specs["tokens"]},
        sh.batch_pspecs({"t": specs["tokens"]}, mesh), mesh)["t"]
    if shape.kind == "decode":
        return model.decode_step, (params, cache, tokens)
    extras = {k: specs[k] for k in ("img", "frames") if k in specs}
    extras = sh.distribute_tree(extras, sh.batch_pspecs(extras, mesh), mesh)

    def prefill_step(params, tokens, cache, extras):
        if cfg.enc_dec:
            return model.prefill(params, tokens, cache, extras["frames"])
        if cfg.cross_attn_period:
            return model.prefill(params, tokens, cache, img=extras["img"])
        return model.prefill(params, tokens, cache)

    return prefill_step, (params, tokens, cache, extras)


def lower_cell(arch: str, shape_name: str, mesh, verbose: bool = True, *,
               cfg: ArchConfig | None = None, shape: ShapeSpec | None = None,
               seed: int = 0, limit_s: float | None = None) -> dict:
    """Build, distribute and run (counting) one cell. Returns the analysis
    record, with the reference's keys. ``cfg`` and ``shape`` replace the
    cell's own (a cut of depth or batch for the debug mesh). On a fake
    mesh the step runs on ``meta`` and the microbatch loop is counted by
    its trip count (``core.trip_count.loop``); on a real device it runs whole,
    counted once, then once more timed."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    skip = cell_skip_reason(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": skip}
    device = mesh_device(mesh)
    model = build_model(cfg, device=device, remat=(shape.kind == "train"))
    step, args = _cell_step(model, cfg, arch, shape, shape_name, mesh,
                            device, seed)
    chips = math.prod(mesh_shape(mesh).values())
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    arg_bytes = _local_bytes(args)

    t0 = time.perf_counter()
    with use_mesh(mesh), OpCounter(fold_loops=device == "meta",
                                   limit_s=limit_s) as counter:
        out = step(*args)
        _sync(device)
    t_lower = time.perf_counter() - t0
    walk = counter.result()
    rec_extra: dict = {"device": device,
                       "kernel_launches": {k: round(v) for k, v in
                                           counter.launches.items()}}

    temp = None
    if device != "meta":
        del out
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _sync(device)
        t0 = time.perf_counter()
        with use_mesh(mesh):
            out = step(*args)
            _sync(device)
        rec_extra["step_s"] = time.perf_counter() - t0
        if device == "cuda":
            rec_extra["peak_bytes"] = torch.cuda.max_memory_allocated()
            temp = rec_extra["peak_bytes"] - arg_bytes
        if shape.kind == "train":
            rec_extra["loss"] = float(out[1]["loss"].full_tensor())
    mem_info = {"argument_bytes": arg_bytes,
                "output_bytes": _local_bytes(out),
                "temp_bytes": temp, "generated_code_bytes": None}

    coll = walk["collectives"]
    roof = roofline_report(
        flops_per_chip=walk["flops"], bytes_per_chip=walk["bytes"],
        collective_per_chip=coll, chips=chips, cfg=cfg, kind=shape.kind,
        global_batch=shape.global_batch, seq=shape.seq,
        dtype=cfg.compute_dtype)
    rec = {
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": mesh_shape(mesh), "chips": chips, "kind": shape.kind,
        "global_batch": shape.global_batch, "seq": shape.seq,
        "n_layers": cfg.n_layers,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "lower_s": t_lower, "compile_s": 0.0,
        "cost_analysis": {"flops": walk["flops"],
                          "bytes accessed": walk["bytes"]},
        "hlo_walk": {"flops": walk["flops"], "bytes_fused": walk["bytes"],
                     "bytes_upper": walk["bytes_upper"]},
        "memory_analysis": mem_info,
        "collective_bytes": coll,
        "roofline": roof,
        **rec_extra,
    }
    if verbose:
        print(f"  lower={t_lower:.1f}s flops/chip={walk['flops']:.3e} "
              f"bytes/chip={walk['bytes']:.3e} "
              f"coll/chip={coll['total']:.3e} "
              f"args={arg_bytes / 2**30:.2f}GiB "
              f"dominant={roof['dominant']} "
              f"roofline={roof['roofline_fraction']:.3f}")
    return rec


def run_cell(arch: str, shape_name: str, mesh, **kw) -> dict:
    """:func:`lower_cell`, with a failure recorded as the reference does:
    ``status`` ``error`` and its message, or ``unfinished`` past the time
    limit."""
    try:
        return lower_cell(arch, shape_name, mesh, **kw)
    except CountTimeout as e:
        return {"arch": arch, "shape": shape_name, "status": "unfinished",
                "error": str(e)}
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        notes = "".join(f" [{n}]" for n in getattr(e, "__notes__", ()))
        return {"arch": arch, "shape": shape_name, "status": "error",
                "error": f"{type(e).__name__}: {e}{notes}",
                "where": traceback.format_exc()[-3000:]}


def _write(rec: dict, out_dir: Path, mesh_tag: str) -> None:
    rec["mesh_tag"] = mesh_tag
    path = out_dir / f"{rec['arch']}--{rec['shape']}--{mesh_tag}.json"
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)


def _report(rec: dict) -> None:
    if rec["status"] == "skipped":
        print(f"  SKIP: {rec['reason']}")
    elif rec["status"] != "ok":
        print(f"  {rec['status'].upper()}: {rec['error']}")
    print(f"  {rec['wall_s']:.1f}s", flush=True)


def run_cell_process(arch: str, shape: str, multi_pod: bool,
                     out_dir: Path) -> dict:
    """One production-mesh cell in a process of its own (a fresh fake
    group; a cell that hangs past the limit is stopped): its record, also
    written to ``out_dir``."""
    mesh_tag = "multipod" if multi_pod else "singlepod"
    path = out_dir / f"{arch}--{shape}--{mesh_tag}.json"
    out_dir.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", str(out_dir)]
    cmd += ["--multi-pod"] if multi_pod else []
    src = str(Path(__file__).resolve().parents[2])    # the package's root
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, (src, os.environ.get("PYTHONPATH"))))}
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=CELL_LIMIT_S + 60)
        rec = json.loads(path.read_text()) if path.exists() else {
            "arch": arch, "shape": shape, "status": "error",
            "error": f"exit {p.returncode}: {p.stderr[-500:]}"}
    except subprocess.TimeoutExpired:
        rec = {"arch": arch, "shape": shape, "status": "unfinished",
               "error": f"still running after {CELL_LIMIT_S + 60:.0f} s"}
    rec["wall_s"] = time.perf_counter() - t0
    _write(rec, out_dir, mesh_tag)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    mesh_tag = "multipod" if args.multi_pod else "singlepod"
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    cells = ([(args.arch, args.shape)] if args.arch and args.shape
             else [(a, s) for a in (list_archs() if args.all or not args.arch
                                    else [args.arch])
                   for s in (list(SHAPES) if args.all or not args.shape
                             else [args.shape])])
    if len(cells) > 1:
        # each cell in a child process, as many at once as there are cores
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            recs = list(pool.map(
                lambda c: run_cell_process(*c, args.multi_pod, out_dir),
                cells))
        for rec in recs:
            print(f"[dryrun] {rec['arch']} x {rec['shape']} on {mesh_tag}")
            _report(rec)
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        arch, shape = cells[0]
        print(f"[dryrun] {arch} x {shape} on {mesh_tag} "
              f"{tuple(mesh_shape(mesh).values())}", flush=True)
        t0 = time.perf_counter()
        rec = run_cell(arch, shape, mesh, limit_s=CELL_LIMIT_S)
        rec["wall_s"] = time.perf_counter() - t0
        _write(rec, out_dir, mesh_tag)
        _report(rec)
        recs = [rec]
    failures = sum(r["status"] in ("error", "unfinished") for r in recs)
    print(f"[dryrun] done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
