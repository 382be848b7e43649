"""Assigned input shapes x architectures: the 40-cell matrix (port of
``repro.launch.shapes``).

``train_*`` runs the train step; ``prefill_*`` the parallel prefill;
``decode_*`` / ``long_*`` one decode step (one new token against a
seq_len KV cache). ``long_500k`` is skipped for pure full-attention archs
(quadratic), as in the reference.

Input stand-ins are ``meta`` tensors (the reference's
``ShapeDtypeStruct``s): no data, no device memory. A decode cell's cache
has ``pos = seq - 1``, so the new token is the cache's last: the port's
decode reads the written prefix ``[0, pos]`` of its cache, where the
reference's masked decode reads all of it whatever its position.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.models import build_model
from repro_torch.models.common import cdt
from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> str | None:
    """None if the (arch, shape) cell runs; else the documented skip."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention architecture: 500k decode is quadratic "
                "(see DESIGN.md §5)")
    return None


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in list_archs() for s in SHAPES]


def runnable_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, s in all_cells()
            if cell_skip_reason(get_arch(a), SHAPES[s]) is None]


# Per-(arch, shape) microbatch counts for gradient accumulation: the
# reference's, sized for its per-chip activation footprint.
MICROBATCHES: dict[tuple[str, str], int] = {
    ("deepseek-v2-236b", "train_4k"): 16,
    ("llama-3.2-vision-11b", "train_4k"): 8,
    ("codeqwen1.5-7b", "train_4k"): 8,
    ("rwkv6-7b", "train_4k"): 8,
    ("deepseek-moe-16b", "train_4k"): 4,
    ("hymba-1.5b", "train_4k"): 4,
    ("gemma2-2b", "train_4k"): 4,
    ("h2o-danube-1.8b", "train_4k"): 4,
    ("stablelm-1.6b", "train_4k"): 4,
    ("whisper-base", "train_4k"): 2,
}


def microbatches_for(arch: str, shape: str) -> int:
    return MICROBATCHES.get((arch, shape), 1)


def _tokens(cfg: ArchConfig, batch: int, seq: int, device,
            gen) -> torch.Tensor:
    if gen is None:
        return torch.empty((batch, seq), dtype=torch.int32, device=device)
    return torch.randint(0, cfg.vocab, (batch, seq), dtype=torch.int32,
                         device=device, generator=gen)


def _extras(cfg: ArchConfig, batch: int, device, gen) -> dict:
    """The image or audio-frame inputs of the configs that take them."""
    shapes = {}
    if cfg.cross_attn_period:
        shapes["img"] = (batch, cfg.n_img_tokens, cfg.d_model)
    if cfg.enc_dec:
        shapes["frames"] = (batch, cfg.enc_seq, cfg.d_model)
    if gen is None:
        return {k: torch.empty(s, dtype=cdt(cfg), device=device)
                for k, s in shapes.items()}
    return {k: torch.randn(s, device=device, generator=gen).to(cdt(cfg))
            for k, s in shapes.items()}


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                device: str | torch.device = "meta",
                seed: int = 0) -> dict:
    """Every model input of this cell: ``meta`` stand-ins by default; on
    another device, tokens, labels and image or frame inputs drawn from
    ``seed`` and a zeroed cache."""
    device = torch.device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    B, S = shape.global_batch, shape.seq
    if shape.kind == "train":
        batch = {"tokens": _tokens(cfg, B, S, device, gen),
                 "labels": _tokens(cfg, B, S, device, gen)}
        batch.update(_extras(cfg, B, device, gen))
        return {"batch": batch}

    model = build_model(cfg, device=device)
    cache = model.init_cache(B, S)
    if shape.kind == "prefill":
        return {"tokens": _tokens(cfg, B, S, device, gen), "cache": cache,
                **_extras(cfg, B, device, gen)}
    # decode: one new token against a cache of length seq
    cache["pos"] = S - 1
    return {"tokens": _tokens(cfg, B, 1, device, gen), "cache": cache}


def params_shape(cfg: ArchConfig) -> dict:
    """The parameter tree on ``meta``: shapes and dtypes, no data."""
    return build_model(cfg, device="meta").init()
