"""Weights from the JAX package's ``DecoderLM.init`` pytree, for the port.

``params_from_jax(cfg, params)`` takes that pytree as nested dicts of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), whose per-layer
leaves are stacked ``(L, ...)``, and returns the port's parameters: the
same dicts with ``"layers"`` split into a list of L per-layer dicts. Dtypes
are kept; bfloat16 arrays (``ml_dtypes``) cross through a 16-bit view, as
``core/capture.py`` does. Nothing here imports JAX: the arrays are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.capture import to_torch

from .config import ArchConfig
from .transformer import check_supported


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    return to_torch(a, str(a.dtype), device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg: ArchConfig, params: dict,
                    device: str | torch.device = "cpu") -> dict:
    """The port's parameters for ``cfg`` from the reference's (numpy)."""
    check_supported(cfg)
    out = {k: _tree(v, lambda a: _tensor(a, device))
           for k, v in params.items() if k != "layers"}
    stacked = params["layers"]
    out["layers"] = [_tree(stacked, lambda a, i=i: _tensor(np.asarray(a)[i],
                                                           device))
                     for i in range(cfg.n_layers)]
    return out
