"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``, in
the reference's format, so each package reads the other's checkpoints):

  * atomic: write to ``step-N.tmp/`` then ``os.replace`` to ``step-N/``;
    a crash mid-write never corrupts the latest checkpoint;
  * self-describing: ``manifest.json`` (step, each leaf's path, file,
    shape and dtype name, extra metadata) + one ``leaf-NNNNN.npy`` per
    leaf, leaves in the reference's order (``repro_torch.tree``: dict keys
    sorted, list items by index);
  * keep-k retention;
  * resumable data pipeline: the step number addresses the deterministic
    dataset, so no data-state file is needed.

bfloat16 leaves cross numpy, which has no bfloat16, through the 16-bit
view ``core/capture.py`` uses: the file holds 2-byte records, as the
reference's ``ml_dtypes`` arrays reload, and the manifest names the dtype.
The port runs on one device, so ``shardings`` must be ``None``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.capture import to_numpy, to_torch
from repro_torch.tree import leaves, leaves_with_paths, unflatten

MANIFEST = "manifest.json"


def config_hash(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def save_checkpoint(directory: Path | str, step: int, state,
                    extra_meta: dict | None = None) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step-{step:08d}"
    tmp = directory / f"step-{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": [], "extra": extra_meta or {}}
    for i, (p, leaf) in enumerate(leaves_with_paths(state)):
        arr, dtype = to_numpy(torch.as_tensor(leaf))
        fname = f"leaf-{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"path": p, "file": fname, "shape": list(arr.shape),
             "dtype": dtype})
    with open(tmp / MANIFEST, "w") as f:
        json.dump(manifest, f, indent=2)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


def load_checkpoint(directory: Path | str, step: int | None = None,
                    like=None, shardings=None,
                    device: str | torch.device | None = None):
    """Restore. Without ``like``: ``(manifest, tensors on the host)``.
    With ``like``, a tree of tensors (``meta`` ones will do) giving the
    structure, shapes and dtypes: ``(state, manifest)``, each leaf on
    ``device``, or on its ``like`` leaf's device when ``device`` is
    None."""
    if shardings is not None:
        raise ValueError("the port restores onto one device: shardings "
                         "must be None")
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = directory / f"step-{step:08d}"
    with open(d / MANIFEST) as f:
        manifest = json.load(f)
    arrays = [to_torch(np.load(d / rec["file"]), rec["dtype"])
              for rec in manifest["leaves"]]
    if like is None:
        return manifest, arrays
    flat = leaves(like)
    if len(flat) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, state needs "
            f"{len(flat)}")
    for rec, leaf in zip(manifest["leaves"], flat):
        if tuple(rec["shape"]) != tuple(leaf.shape):
            raise ValueError(
                f"leaf {rec['path']}: checkpoint shape {rec['shape']} != "
                f"state shape {tuple(leaf.shape)}")
    arrays = [a.to(device=device if device is not None else leaf.device,
                   dtype=leaf.dtype) for a, leaf in zip(arrays, flat)]
    return unflatten(like, arrays), manifest


def latest_step(directory: Path | str) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step-") \
                and not p.name.endswith(".tmp") \
                and (p / MANIFEST).exists():
            steps.append(int(p.name.split("-")[1]))
    return max(steps) if steps else None


class CheckpointManager:
    def __init__(self, directory: Path | str, keep: int = 3,
                 save_every: int = 100):
        self.directory = Path(directory)
        self.keep = keep
        self.save_every = save_every

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, state, extra_meta: dict | None = None) -> Path:
        path = save_checkpoint(self.directory, step, state, extra_meta)
        self._gc()
        return path

    def restore_latest(self, like, shardings=None, device=None):
        return load_checkpoint(self.directory, None, like, shardings,
                               device=device)

    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("-")[1])
            for p in self.directory.iterdir()
            if p.is_dir() and p.name.startswith("step-")
            and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step-{s:08d}",
                          ignore_errors=True)
        for p in self.directory.glob("*.tmp"):
            shutil.rmtree(p, ignore_errors=True)
