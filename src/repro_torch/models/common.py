"""Shared layer primitives: init, norms, rotary embeddings, MLPs (port of
``repro.models.common``).

Parameters are plain nested dicts of tensors. Every init function draws
from an explicit ``torch.Generator`` (``None`` on the ``meta`` device,
where nothing is drawn) onto an explicit device. ``constrain_batch``
pins an activation's sharding on the device mesh of an enclosing
``repro_torch.launch.mesh.use_mesh`` block, as the reference's does under
``with mesh:``; outside one it returns its input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.core.builder import torch_dtype

from .config import ArchConfig, YarnCfg


def dt(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def cdt(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


# ------------------------------------------------------------ sharding ----

#: The ``torch.distributed`` device mesh of the enclosing
#: ``launch.mesh.use_mesh`` block (the reference's ``with mesh:``), or None.
ACTIVE_MESH = None


def _active_mesh():
    return ACTIVE_MESH


def constrain_batch(x: torch.Tensor, head_dim: int | None = None
                    ) -> torch.Tensor:
    """Pin the leading (batch) dim of a ``DTensor`` to the data axes of the
    active mesh, keeping the head axis model-sharded where it divides
    evenly (the reference's rule and reasons: a head-split reshape whose
    model sharding does not align to head boundaries would otherwise
    replicate the activation). The tensor is redistributed to that
    placement, collectives included.

    Returns ``x`` itself, at once, outside a mesh or for a plain tensor:
    one attribute read, no torch op and no host sync on the serving
    path."""
    mesh = _active_mesh()
    if mesh is None or not isinstance(x, DTensor) or x.ndim == 0:
        return x
    from repro_torch.launch.mesh import dp_axes, dp_size, mesh_axis
    from repro_torch.launch.sharding import to_placements

    dp = dp_axes(mesh)
    size = dp_size(mesh)
    if not dp or size == 1 or x.shape[0] % size:
        return x
    entries: list = [dp] + [None] * (x.ndim - 1)
    if head_dim is not None and "model" in mesh.mesh_dim_names \
            and x.shape[head_dim] % mesh_axis(mesh, "model") == 0:
        entries[head_dim] = "model"
    return x.redistribute(mesh, to_placements(tuple(entries), mesh))


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with the sums it owes done: a ``DTensor`` left partial by a
    contraction over a sharded dim is all-reduced there (to a replica),
    the reduction the reference's partitioner inserts before such a
    product meets a sharded parameter. Anything else is returned as it
    is, at once."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; on a ``DTensor`` under the active mesh, through an
    identity whose backward brings the gradient to ``x``'s own placements.
    A parameter read twice (a tied embedding: the lookup and the head) gets
    two gradients in two placements, which autograd adds; ``DTensor``
    cannot always plan that sum (a shard to a partial), where the
    reference's partitioner gives every gradient its parameter's
    sharding. Outside a mesh, or on a plain tensor, returned at once."""
    if _active_mesh() is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def split_heads(x: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    """(B, S, n_heads * d_head) -> (B, S, n_heads, d_head), pinned by
    ``constrain_batch(..., head_dim=2)``.

    On a ``DTensor`` under the active mesh whose last dim is sharded on a
    mesh dim that does not divide ``n_heads`` (8 heads over 16 ranks), that
    dim is first gathered (replicated there): a shard boundary inside a
    head cannot be split into heads shard by shard. This is the resharding
    the reference's partitioner inserts at its head-split reshape, where
    ``constrain_batch`` after it asks for the heads replicated on that
    axis; every other placement is left to ``constrain_batch``, as there.
    Outside a mesh, or on a plain tensor, it is the view alone: no torch
    op besides it and no host sync."""
    if _active_mesh() is not None and isinstance(x, DTensor):
        mesh, last = x.device_mesh, x.ndim - 1
        pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                   and n_heads % mesh.size(i) else p
                   for i, p in enumerate(x.placements))
        if pl != tuple(x.placements):
            x = x.redistribute(mesh, pl)
    return constrain_batch(x.reshape(*x.shape[:-1], n_heads, d_head),
                           head_dim=2)


# ---------------------------------------------------------------- init ----

def init_generator(generator, device: torch.device):
    """The generator an ``init`` draws from: ``generator`` itself, a new
    one on ``device`` seeded with it (an int, or 0 for ``None``), or
    ``None`` on the ``meta`` device, where nothing is drawn."""
    if device.type == "meta":
        return None
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator or 0))


def _normal(generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def dense_init(generator, shape, dtype, device, in_axis: int = -2
               ) -> torch.Tensor:
    """Variance-scaling (fan-in) normal init."""
    std = shape[in_axis] ** -0.5
    return _normal(generator, shape, device).mul_(std).to(dtype)


def embed_init(generator, shape, dtype, device) -> torch.Tensor:
    return _normal(generator, shape, device).to(dtype)


# ---------------------------------------------------------------- norms ----

def init_norm(cfg: ArchConfig, d: int, device) -> dict:
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMS norm or LayerNorm, computed in float32 and cast back."""
    x32 = x.to(torch.float32)
    if cfg.norm == "rms":
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + 1e-6) * p["scale"]
    else:
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, correction=0)
        y = (x32 - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# --------------------------------------------------------------- rotary ----

def yarn_mscale(factor: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``: 0.1 mscale ln(factor) + 1, or 1
    where the factor does not stretch the context."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(y: YarnCfg, d_rot: int, theta: float
                          ) -> tuple[int, int]:
    """DeepSeek-V2's ``yarn_find_correction_range``: the rotary pairs from
    the one that turns ``beta_fast`` times over the original context
    (floored) to the one that turns ``beta_slow`` times (ceiled), clamped
    to [0, d_rot - 1]."""
    def dim(rotations: float) -> float:
        return (d_rot * math.log(y.original_max_pos
                                 / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(dim(y.beta_fast)), 0),
            min(math.ceil(dim(y.beta_slow)), d_rot - 1))


def rope_freqs(d_rot: int, theta: float, device=None,
               yarn: YarnCfg | None = None) -> torch.Tensor:
    """The inverse frequency of each rotary pair. With ``yarn``, as
    DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``: a linear ramp over
    the pairs of :func:`yarn_correction_range` blends the plain
    (extrapolated) frequency, kept below the range, into the frequency
    interpolated by ``factor``, taken above it."""
    base = theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                  device=device) / d_rot)
    extra = 1.0 / base
    if yarn is None:
        return extra
    inter = 1.0 / (yarn.factor * base)
    low, high = yarn_correction_range(yarn, d_rot, theta)
    high = high + 0.001 if low == high else high
    ramp = ((torch.arange(d_rot // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rope_frac: float,
               theta: float, yarn: YarnCfg | None = None) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) or (S,).

    Rotates the first ``rope_frac * D`` dims (partial rotary, stablelm) as
    interleaved pairs (x[2i], x[2i+1]), as the reference does, not the
    half-split layout; the tail stays unrotated. ``yarn`` gives YaRN's
    frequencies (:func:`rope_freqs`) and multiplies cos and sin by
    ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``."""
    d = x.shape[-1]
    d_rot = int(d * rope_frac)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    rot, keep = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, x.device, yarn)        # (d_rot/2,)
    angles = positions[..., None].to(torch.float32) * freqs
    if x.dim() - positions.dim() == 3:                      # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if yarn is not None:
        m = (yarn_mscale(yarn.factor, yarn.mscale)
             / yarn_mscale(yarn.factor, yarn.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    r1, r2 = rot[..., ::2], rot[..., 1::2]
    o1 = r1 * cos - r2 * sin
    o2 = r2 * cos + r1 * sin
    rotated = torch.stack([o1, o2], dim=-1).reshape(rot.shape)
    return torch.cat([rotated.to(x.dtype), keep], dim=-1)


# ------------------------------------------------------------------ MLP ----

def init_mlp(generator, cfg: ArchConfig, d_in: int, d_ff: int,
             device) -> dict:
    dtype = dt(cfg)
    p = {"w_in": dense_init(generator, (d_in, d_ff), dtype, device),
         "w_out": dense_init(generator, (d_ff, d_in), dtype, device)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(generator, (d_in, d_ff), dtype, device)
    return p


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_in"].to(x.dtype)
    if cfg.gated_mlp:
        g = x @ p["w_gate"].to(x.dtype)
        h = _act(cfg, g) * h
    else:
        h = _act(cfg, h)
    return h @ p["w_out"].to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def lm_head(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of the hidden states ``x`` through the tied embedding or
    ``p["head"]``, softcapped, the padded vocab columns at -1e30."""
    head = p["embed"].T if cfg.tie_embeddings else p["head"]
    logits = x @ head.to(x.dtype)
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab:
        valid = torch.arange(cfg.padded_vocab, device=logits.device) \
            < cfg.vocab
        logits = torch.where(valid, logits, -1e30)
    return logits


# ----------------------------------------------------------------- loss ----

def _ce_chunk(xc, head, yc, mc, final_softcap, vocab_ok):
    """Summed masked NLL of one sequence chunk: f32 logits, softcapped,
    padded vocab columns at -1e30."""
    logits = xc @ head.to(xc.dtype)
    logits = softcap(logits.to(torch.float32), final_softcap)
    if vocab_ok is not None:
        logits = torch.where(vocab_ok, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # A gather along the sharded vocab dim leaves a masked partial
        # that DTensor cannot reduce after the squeeze (torch 2.13): take
        # the gold logit as a one-hot sum, exact (every other term is 0),
        # whose sharding is a plain partial sum.
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(yc.long()[..., None] == vocab, logits,
                           0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return ((logz - gold) * mc).sum()


def chunked_ce_loss(x: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor | None = None,
                    final_softcap: float | None = None, chunk: int = 512,
                    valid_vocab: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy over seq chunks so (B, S, V) never materializes.

    x: (B, S, D) final hidden states; head: (D, V); labels: (B, S).
    ``valid_vocab``: real vocab size; columns beyond it (padding) are
    excluded from the logsumexp. Each chunk runs under
    ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``, so
    its (B, chunk, V) logits are recomputed in the backward, not kept.
    Returns (sum_nll, sum_weight); caller divides.
    """
    B, S, _ = x.shape
    V = head.shape[1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    vocab_ok = None
    if valid_vocab is not None and valid_vocab < V:
        vocab_ok = torch.arange(V, device=x.device) < valid_vocab
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        mc = mask[:, sl].to(torch.float32)
        nll_sum = nll_sum + checkpoint(
            _ce_chunk, x[:, sl], head, labels[:, sl], mc, final_softcap,
            vocab_ok, use_reentrant=False)
        w_sum = w_sum + mc.sum()
    return nll_sum, w_sum
