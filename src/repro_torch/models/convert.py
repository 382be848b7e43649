"""Weights from the JAX package's ``DecoderLM.init`` / ``EncDecLM.init``
pytree, for the port.

``params_from_jax(cfg, params)`` takes that pytree as nested dicts (and
lists) of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
and returns the port's parameters, whose stacked layers are split into
lists of per-layer dicts:

* dense, mamba+attn (each block's ``mamba`` subtree included) and rwkv:
  ``"layers"`` stacked ``(L, ...)`` -> a list of L layers;
* MoE (and MLA): ``"dense_prefix"``, already a list in the reference,
  stays one; ``"layers"`` stacked ``(n_layers - len(dense_layers), ...)``
  -> a list of that many MoE layers;
* vision: ``"cross"`` stacked ``(G, ...)`` -> a list of G cross blocks,
  ``"layers"`` stacked ``(G, period - 1, ...)`` -> a list of G lists of
  ``period - 1`` self layers;
* encoder-decoder: ``"encoder"`` stacked ``(n_enc_layers, ...)`` and
  ``"decoder"`` stacked ``(n_layers, ...)`` -> lists of per-layer dicts.

Every other entry (embedding, head, final norms, learned positions) is
copied as it is.
Dtypes are kept; bfloat16 arrays (``ml_dtypes``) cross through a 16-bit
view, as ``core/capture.py`` does. Nothing here imports JAX: the arrays
are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.capture import to_torch

from .config import ArchConfig


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    return to_torch(a, str(a.dtype), device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def _unstack(tree, n: int, device, index=()) -> list:
    """The ``n`` slices along the leading (after ``index``) axis of every
    leaf of ``tree``, as n trees of tensors."""
    return [_tree(tree, lambda a, i=i: _tensor(np.asarray(a)[(*index, i)],
                                               device))
            for i in range(n)]


def params_from_jax(cfg: ArchConfig, params: dict,
                    device: str | torch.device = "cpu") -> dict:
    """The port's parameters for ``cfg`` from the reference's (numpy)."""
    stacked = {"layers", "cross", "encoder", "decoder"}
    out = {k: _tree(v, lambda a: _tensor(a, device))
           for k, v in params.items() if k not in stacked}
    if cfg.enc_dec:
        out["encoder"] = _unstack(params["encoder"], cfg.n_enc_layers, device)
        out["decoder"] = _unstack(params["decoder"], cfg.n_layers, device)
        return out
    if cfg.cross_attn_period:
        groups = cfg.n_layers // cfg.cross_attn_period
        n_self = cfg.cross_attn_period - 1
        out["cross"] = _unstack(params["cross"], groups, device)
        out["layers"] = [_unstack(params["layers"], n_self, device, (g,))
                         for g in range(groups)]
        return out
    n_dense = len(cfg.dense_layers) if cfg.moe is not None else 0
    out["layers"] = _unstack(params["layers"], cfg.n_layers - n_dense,
                             device)
    return out
