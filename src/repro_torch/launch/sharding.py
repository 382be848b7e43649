"""Sharding rules: parameter / optimizer / batch / cache specs (port of
``repro.launch.sharding``).

Scheme (the reference's):
  * batch over ("pod", "data") — data parallelism;
  * tensor parallelism over "model": attention heads, d_ff, vocab, and the
    MoE expert axis (expert parallelism);
  * FSDP over "data" (and "pod" for >=30B params): the non-TP dim of every
    weight is sharded;
  * KV caches: batch over dp; heads over "model" when divisible, else the
    sequence axis.

Every proposed axis is divisibility-checked against the actual dim and
dropped if it does not divide, so one rule table serves all 10
architectures.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of axis names — ``PartitionSpec``'s entries. The rules index
dims from the end, so they hold for the port's per-layer parameter lists
(``models/convert.py``) as for the reference's stacked ``(L, ...)`` leaves:
a layer's spec is the reference's without the stacked leading dims.
:func:`to_placements` turns a spec into ``DTensor`` placements, and
:func:`distribute_tree` a tree of tensors into ``DTensor``s by a tree of
specs. Trees are the port's nested dicts and lists (``repro_torch.tree``);
a leaf that is not a tensor (a cache's host-int ``pos``) gets ``()``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models.config import ArchConfig

from .mesh import axis_names, dp_axes, mesh_shape

# leaf name -> (role), resolved against the last two (or one) dims
_COL = {"wq", "wk", "wv", "w_in", "w_gate", "shared_in", "shared_gate",
        "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "w_r", "w_k", "w_v",
        "w_g", "cm_r", "cm_k", "decay_a", "decay_b"}
_ROW = {"wo", "w_out", "shared_out", "cm_v", "w_o"}
_VEC_MODEL = {"bq", "bk", "bv", "dt_bias", "D_skip", "bonus", "decay_base"}
_REPL = {"scale", "bias", "gate", "mu", "mu_c", "pos_embed", "dec_pos",
         "enc_pos"}
_MODEL_DIM2 = {"A_log", "w_bcdt"}      # (..., di, small): model on dim -2
_MODEL_LAST = {"conv_w"}               # (..., small, di): model on dim -1

Spec = tuple


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    out = 1
    for a in axes:
        out *= shape.get(a, 1)
    return out


def _fit(mesh, dim: int, axes):
    """axes if they divide dim and exist in the mesh, else None."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in axis_names(mesh))
    if not axes:
        return None
    if dim % _axis_size(mesh, axes):
        return None
    return axes if len(axes) > 1 else axes[0]


def _spec(mesh, shape, assignment: dict[int, Any]) -> Spec:
    """assignment: dim index -> proposed axes (checked + fallback None)."""
    entries = []
    for i, d in enumerate(shape):
        ax = assignment.get(i)
        ax = _fit(mesh, d, ax) if ax is not None else None
        entries.append(ax)
    return tuple(entries)


def fsdp_axes(mesh, cfg: ArchConfig | None = None):
    if cfg is not None and cfg.n_params() >= 30_000_000_000 \
            and "pod" in axis_names(mesh):
        return ("pod", "data")
    return ("data",)


# Serving: if the TP-only (model-axis) shard of the weights fits comfortably
# in device memory, drop the FSDP dim (the reference's budget, kept).
SERVE_TP_BUDGET_BYTES = 6e9


def serve_tp_only(mesh, cfg: ArchConfig | None) -> bool:
    if cfg is None or "model" not in axis_names(mesh):
        return False
    bytes_per_param = 2 if cfg.param_dtype == "bfloat16" else 4
    per_chip = cfg.n_params() * bytes_per_param / mesh_shape(mesh)["model"]
    return per_chip <= SERVE_TP_BUDGET_BYTES


def _param_spec(path_names: tuple[str, ...], leaf, mesh,
                cfg: ArchConfig | None, serve: bool = False) -> Spec:
    name = path_names[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    fsdp = None if (serve and serve_tp_only(mesh, cfg)) \
        else fsdp_axes(mesh, cfg)
    in_moe = "moe" in path_names
    if name == "embed":
        if cfg is not None and cfg.tie_embeddings:
            # vocab-sharded so the (transposed) LM head keeps logits
            # sharded over "model"; the lookup pays a reshard.
            return _spec(mesh, shape, {0: "model", 1: fsdp})
        # untied: shard d_model only; the separate head carries the vocab
        return _spec(mesh, shape, {1: ("data", "model")})
    if name == "head":
        return _spec(mesh, shape, {0: fsdp, 1: "model"})
    if name == "router":
        return _spec(mesh, shape, {nd - 2: fsdp})
    if in_moe and name in ("w_in", "w_gate"):
        # (E, D, Fe): expert parallelism on E, FSDP on D
        return _spec(mesh, shape, {nd - 3: "model", nd - 2: fsdp})
    if in_moe and name == "w_out":
        # (E, Fe, D)
        return _spec(mesh, shape, {nd - 3: "model", nd - 1: fsdp})
    if name in _COL:
        if nd == 1:
            return _spec(mesh, shape, {0: "model"})
        return _spec(mesh, shape, {nd - 2: fsdp, nd - 1: "model"})
    if name in _ROW:
        return _spec(mesh, shape, {nd - 2: "model", nd - 1: fsdp})
    if name in _VEC_MODEL:
        return _spec(mesh, shape, {nd - 1: "model"})
    if name in _MODEL_DIM2:
        return _spec(mesh, shape, {nd - 2: "model"})
    if name in _MODEL_LAST:
        return _spec(mesh, shape, {nd - 1: "model"})
    if name == "scale" and "ln_x" in path_names:
        return _spec(mesh, shape, {nd - 1: "model"})
    # default: replicated (norm scales, gates, mixing vectors, counts)
    return (None,) * nd


def map_with_path(fn, tree, *rest, path: tuple[str, ...] = ()):
    """``fn(path_names, leaf, *rest_leaves)`` over the leaves of ``tree``
    (nested dicts and lists), keeping its structure; ``rest`` are trees of
    the same structure whose leaves may be tuples (specs)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, *(r[i] for r in rest),
                              path=path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _leaf_or_scalar(fn):
    """``fn`` for tensor leaves; ``()`` for host scalars (a cache's pos)."""
    def go(path, leaf, *rest):
        if not isinstance(leaf, torch.Tensor):
            return ()
        return fn(path, leaf, *rest)
    return go


def param_pspecs(params_shape, mesh, cfg: ArchConfig | None = None,
                 serve: bool = False):
    return map_with_path(_leaf_or_scalar(
        lambda path, leaf: _param_spec(path, leaf, mesh, cfg, serve)),
        params_shape)


def opt_pspecs(opt_shape, mesh, cfg: ArchConfig | None = None):
    """m/v mirror the parameter specs; count replicated."""
    return map_with_path(_leaf_or_scalar(
        lambda path, leaf: (
            () if path[-1] == "count"
            else _param_spec(path[1:], leaf, mesh, cfg))),
        opt_shape)


def state_pspecs(state_shape, mesh, cfg: ArchConfig | None = None):
    return {
        "params": param_pspecs(state_shape["params"], mesh, cfg),
        "opt": opt_pspecs(state_shape["opt"], mesh, cfg),
        "step": (),
    }


def batch_pspecs(batch_shape, mesh):
    dp = dp_axes(mesh)

    def spec(path, leaf):
        if leaf.ndim == 0:
            return ()
        return _spec(mesh, leaf.shape, {0: dp})

    return map_with_path(_leaf_or_scalar(spec), batch_shape)


def _cache_spec(path_names, leaf, mesh) -> Spec:
    name = path_names[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    dp = dp_axes(mesh)
    if nd == 0:
        return ()
    if name in ("k", "v"):
        # (L, B, H, S, D) (kv / cross_kv stacks)
        assign = {1: dp}
        if _fit(mesh, shape[2], "model"):
            assign[2] = "model"
        else:
            assign[3] = "model" if _fit(mesh, shape[1], dp) else \
                ("data", "model")
        return _spec(mesh, shape, assign)
    if name in ("c_kv", "k_pe"):
        # (L, B, S, lat)
        assign = {1: dp, 2: "model"}
        if not _fit(mesh, shape[1], dp):
            assign = {2: ("data", "model")}
        return _spec(mesh, shape, assign)
    if name == "ssm":
        return _spec(mesh, shape, {1: dp, 2: "model"})
    if name == "conv":
        return _spec(mesh, shape, {1: dp, 3: "model"})
    if name == "wkv":
        return _spec(mesh, shape, {1: dp, 2: "model"})
    if name in ("prev_t", "prev_c"):
        return _spec(mesh, shape, {1: dp, 2: "model"})
    return (None,) * nd


def cache_pspecs(cache_shape, mesh):
    return map_with_path(_leaf_or_scalar(
        lambda path, leaf: _cache_spec(path, leaf, mesh)), cache_shape)


def logits_pspec(mesh, batch: int | None = None,
                 vocab: int | None = None) -> Spec:
    if batch is None or vocab is None:
        dp = dp_axes(mesh)      # one axis is named alone, as P(...) does
        return (dp[0] if len(dp) == 1 else dp or None, None, "model")
    return _spec(mesh, (batch, 1, vocab), {0: dp_axes(mesh), 2: "model"})


def validate_specs(shapes_tree, specs_tree, mesh) -> list[str]:
    """Sanity: every sharded dim divisible. Returns list of violations."""
    errors = []

    def check(path, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return None
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            size = _axis_size(mesh, ax)
            if leaf.shape[i] % size:
                errors.append(
                    f"{'/'.join(path)}: dim {i} "
                    f"({leaf.shape[i]}) not divisible by {ax} ({size})")
        return None

    map_with_path(check, shapes_tree, specs_tree)
    return errors


# ------------------------------------------------------------- DTensor ----

def to_placements(spec: Spec, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh`` (the reference's
    ``to_named``): for each mesh dim, ``Shard(d)`` where it shards tensor
    dim ``d``, else ``Replicate()``. A tuple of axes on one dim shards it
    over those mesh dims, major first; the rules only name them in mesh
    order, which is the order ``DTensor`` splits a dim in. An axis of size
    1 splits nothing: its mesh dim is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    placements = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                placements[i] = Shard(d)
    return tuple(placements)


def local_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for d, axes in enumerate(spec):
        out[d] //= _axis_size(mesh, axes)
    return tuple(out)


def distribute(leaf: torch.Tensor, spec: Spec, mesh):
    """``leaf`` as a ``DTensor`` on ``mesh`` under ``spec``. On a mesh of
    one rank the leaf is its own shard (no copy); a ``meta`` leaf becomes
    a ``meta`` shard (no data, no collective); a real one on more ranks
    is scattered by ``distribute_tensor``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = to_placements(spec, mesh)
    if math.prod(mesh_shape(mesh).values()) == 1:
        return DTensor.from_local(leaf, mesh, placements, run_check=False)
    if leaf.device.type != "meta":
        return distribute_tensor(leaf, mesh, placements)
    local = torch.empty(local_shape(leaf.shape, spec, mesh),
                        dtype=leaf.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=leaf.shape,
                              stride=torch.empty(leaf.shape,
                                                 device="meta").stride())


def distribute_tree(tree, specs, mesh):
    """Every tensor leaf of ``tree`` as a ``DTensor`` by its spec in
    ``specs``; other leaves (a cache's ``pos``) as they are."""
    return map_with_path(
        lambda path, leaf, spec: (distribute(leaf, spec, mesh)
                                  if isinstance(leaf, torch.Tensor)
                                  else leaf),
        tree, specs)
