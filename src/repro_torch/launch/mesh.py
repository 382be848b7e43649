"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module never
creates a process group. A mesh is a ``torch.distributed`` ``DeviceMesh``
with the reference's axis names:

* the production meshes (16x16 ``("data", "model")``, or 2x16x16 with
  ``"pod"``) sit on a *fake* process group of 256 or 512 ranks
  (``torch.testing._internal.distributed.fake_pg``): this process plays
  rank 0, collectives are issued (and counted) but move nothing, and
  tensors are ``meta`` shards, so the dry-run sizes every cell without a
  device, as the reference's 512 placeholder host devices do;
* the debug mesh is 1x1 over the real device, on a one-rank group of the
  device's backend, so a step runs for real under the same sharding code.

A process keeps one default group. Each function here replaces a group of
another size or backend, and :func:`release` tears it down.
:func:`use_mesh` is the counterpart of the reference's ``with mesh:``: it
makes the mesh the one ``models.common.constrain_batch`` reads.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device
from repro_torch.models import common

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}

_GROUP: dict = {}        # {"backend": ..., "world": ...} of the live group


def release() -> None:
    """Destroy the process group this module made, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP.clear()


def _group(backend: str, world: int, store) -> None:
    if dist.is_initialized() and _GROUP == {"backend": backend,
                                            "world": world}:
        return
    release()
    dist.init_process_group(backend, store=store, rank=0, world_size=world)
    _GROUP.update(backend=backend, world=world)


def make_fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``shape`` mesh named ``axes`` over a fake group of
    ``prod(shape)`` ranks (rank 0 is this process). Its tensors are
    ``meta`` shards; nothing runs on a device."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    _group("fake", math.prod(shape), FakeStore())
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; multi-pod adds a leading 2-pod axis.
    Fake ranks: the dry-run's tensors are ``meta``."""
    return make_fake_mesh(*PRODUCTION_SHAPES[multi_pod])


def make_debug_mesh(device: str | torch.device = "cuda"):
    """The 1x1 ``("data", "model")`` mesh over the one real device. The
    reference's ``data`` and ``model`` sizes are capped at the devices
    there are; the port's debug mesh has one, so it has no such sizes.
    ``cuda`` (the default) raises without a card; pass ``cpu`` for the
    host."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    _group(backend, 1, dist.HashStore())
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def mesh_device(mesh) -> str:
    """The device a mesh's tensors live on: ``meta`` on the fake group,
    else the mesh's device type (``cuda`` or ``cpu``)."""
    return "meta" if _GROUP.get("backend") == "fake" else mesh.device_type


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh (``constrain_batch`` reads it) inside
    the block, and let plain tensors that the model makes there (positions,
    masks, zero accumulators) join DTensor ops as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    before = common.ACTIVE_MESH
    common.ACTIVE_MESH = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        common.ACTIVE_MESH = before


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of a stand-in with
    ``axis_names`` and a ``shape`` dict (as the reference's tests build)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def mesh_axis(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the global batch."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def dp_size(mesh) -> int:
    return math.prod(mesh_axis(mesh, a) for a in dp_axes(mesh))
