"""Kernel-launch capture (paper §4.2), port of ``repro.core.capture``.

Setting ``KERNEL_LAUNCHER_CAPTURE`` to a comma-separated list of kernel names
(or ``*``) makes :class:`~repro_torch.core.wisdom_kernel.WisdomKernel` export,
on launch, everything needed to replay that launch offline: the kernel name,
problem size, dtype and argument arrays.

The format is the reference's: ``<name>-<problem>-<dtype>.capture.json`` plus
a sibling ``.npz``. Tensors are copied to the host before ``np.savez``.
bfloat16 needs care in both directions: numpy has no bfloat16, the
reference's bf16 arrays are ``ml_dtypes`` arrays that reload from ``.npz`` as
raw ``|V2`` records, and ``torch.from_numpy`` rejects both. :func:`to_torch`
and :func:`to_numpy` convert through a 16-bit integer view of the same bits,
with the dtype name taken from the capture's ``arg_dtypes``.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .builder import dtype_name

CAPTURE_ENV = "KERNEL_LAUNCHER_CAPTURE"
CAPTURE_DIR_ENV = "KERNEL_LAUNCHER_CAPTURE_DIR"
CAPTURE_VERSION = 1


def to_torch(array: np.ndarray, dtype: str,
             device: str | torch.device = "cpu") -> torch.Tensor:
    """A numpy array of the reference's (``ml_dtypes`` bf16 or ``|V2``
    included) as a tensor of dtype name ``dtype`` on ``device``."""
    a = np.require(array, requirements=["C", "W"])
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 data needs 2-byte items, got {a.dtype}")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.astype(dtype, copy=False))
    return t.to(device)


def to_numpy(tensor: torch.Tensor) -> tuple[np.ndarray, str]:
    """Inverse of :func:`to_torch`: a host array and its dtype name.
    bfloat16 comes back as ``|V2`` records, as the reference's reload."""
    t = tensor.detach().to("cpu").contiguous()
    name = dtype_name(t.dtype)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), name
    return t.numpy(), name


def capture_requested(kernel_name: str) -> bool:
    spec = os.environ.get(CAPTURE_ENV, "")
    if not spec:
        return False
    names = [s.strip() for s in spec.split(",") if s.strip()]
    return "*" in names or kernel_name in names


def capture_dir() -> Path:
    return Path(os.environ.get(CAPTURE_DIR_ENV, Path.cwd() / "captures"))


@dataclass
class Capture:
    kernel_name: str
    problem_size: tuple[int, ...]
    dtype: str
    args: list[torch.Tensor]          # on the host
    meta: dict[str, Any]
    path: Path | None = None

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.args)


def _slug(problem: tuple[int, ...], dtype: str) -> str:
    return "x".join(str(p) for p in problem) + "-" + dtype


def write_capture(kernel_name: str, problem_size: tuple[int, ...],
                  dtype: str, args, out_dir: Path | str | None = None,
                  extra_meta: dict | None = None) -> Path:
    """Serialize one launch. Returns the json path. Timing of this function
    is the paper's Table 3 'capture time'."""
    t0 = time.perf_counter()
    d = Path(out_dir) if out_dir is not None else capture_dir()
    d.mkdir(parents=True, exist_ok=True)
    pairs = [to_numpy(torch.as_tensor(a)) for a in args]
    arrays = [a for a, _ in pairs]
    base = f"{kernel_name}-{_slug(problem_size, dtype)}"
    npz_path = d / f"{base}.npz"
    json_path = d / f"{base}.capture.json"
    np.savez(npz_path, **{f"arg{i}": a for i, a in enumerate(arrays)})
    meta = {
        "version": CAPTURE_VERSION,
        "kernel": kernel_name,
        "problem_size": list(problem_size),
        "dtype": dtype,
        "num_args": len(arrays),
        "arg_shapes": [list(a.shape) for a in arrays],
        "arg_dtypes": [name for _, name in pairs],
        "nbytes": int(sum(a.nbytes for a in arrays)),
        "npz": npz_path.name,
        "captured_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(),
        "capture_seconds": None,   # filled below
    }
    meta.update(extra_meta or {})
    meta["capture_seconds"] = time.perf_counter() - t0
    tmp = json_path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, json_path)
    return json_path


def load_capture(json_path: Path | str) -> Capture:
    """Load a capture written by either package; args are CPU tensors."""
    json_path = Path(json_path)
    with open(json_path) as f:
        meta = json.load(f)
    with np.load(json_path.parent / meta["npz"]) as z:
        args = [to_torch(z[f"arg{i}"], meta["arg_dtypes"][i])
                for i in range(meta["num_args"])]
    return Capture(
        kernel_name=meta["kernel"],
        problem_size=tuple(int(x) for x in meta["problem_size"]),
        dtype=meta["dtype"],
        args=args,
        meta=meta,
        path=json_path,
    )


def list_captures(in_dir: Path | str | None = None) -> list[Path]:
    d = Path(in_dir) if in_dir is not None else capture_dir()
    if not d.exists():
        return []
    return sorted(d.glob("*.capture.json"))
