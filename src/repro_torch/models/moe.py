"""Fine-grained mixture-of-experts (DeepSeek-MoE / DeepSeek-V2 style):
shared experts + routed top-k experts with capacity-bucketed one-hot
dispatch (port of ``repro.models.moe``), or dropless grouped dispatch.

Dropless (``capacity_factor`` None, DeepSeek-V2-Lite): every (token,
choice) pair reaches its expert. The pairs are sorted by expert on the
device, the tokens gathered in that order, and each expert weight runs as
one grouped product (``torch._grouped_mm`` with the experts' end offsets
as a device tensor) over the expert's own rows, the pair's gate scaling
the input of the last one; the outputs go back to their pairs by the
inverse permutation and are summed over a token's choices in float32.
Nothing reads a count on the host, so the path adds no sync; the CPU and
the card run the same code. Its steps run in the spans ``route``,
``experts`` and ``combine`` inside the layer's ``moe`` span, and while
spans are on and a reader has put a list in :data:`EXPERT_LOAD`, each
call appends its routed pairs and its busiest expert's load, on the
device, to that list.

The sequence is processed in chunks of ``moe.chunk`` tokens (halved while
it does not divide S); capacity is per chunk. Within a chunk each (token,
k) choice takes the next free slot of its expert's bucket in (C*K) order
and is dropped when the bucket is full, exactly as the reference's
one-hot cumsum does. Router aux losses (load-balance + z-loss), averaged
over chunks, are returned for the train loss.

The reference scans the chunks with ``lax.scan`` and runs each under
``jax.checkpoint``; the port loops over them in Python and runs each under
``torch.utils.checkpoint`` when autograd records, so the dispatch and
combine one-hots are recomputed in the backward instead of kept. The
expert products are plain ``torch.einsum`` calls: the reference computes
them outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.obs import runtime as obs

from .common import dense_init, dt
from .config import ArchConfig, MoECfg

#: Where dropless MoE calls count their load: None (nobody reads it, the
#: default), or a list that a reader puts here and takes back, to which
#: each call made while spans are on (``obs.spans_on``) appends (routed
#: pairs, the busiest expert's pairs) as an int64 device tensor of two
#: elements. Nothing is counted, and nothing grows, without a reader.
EXPERT_LOAD: list[torch.Tensor] | None = None


def init_moe(generator, cfg: ArchConfig, device) -> dict:
    e = cfg.moe
    d = cfg.d_model
    dtype = dt(cfg)
    p = {
        "router": dense_init(generator, (d, e.n_routed), torch.float32,
                             device),
        "w_in": dense_init(generator, (e.n_routed, d, e.d_expert), dtype,
                           device, in_axis=-2),
        "w_gate": dense_init(generator, (e.n_routed, d, e.d_expert), dtype,
                             device, in_axis=-2),
        "w_out": dense_init(generator, (e.n_routed, e.d_expert, d), dtype,
                            device, in_axis=-2),
    }
    if e.n_shared:
        sh = e.n_shared * e.d_expert
        p["shared_in"] = dense_init(generator, (d, sh), dtype, device)
        p["shared_gate"] = dense_init(generator, (d, sh), dtype, device)
        p["shared_out"] = dense_init(generator, (sh, d), dtype, device)
    return p


def _capacity(e: MoECfg, chunk_tokens: int) -> int:
    cap = int(chunk_tokens * e.top_k / e.n_routed * e.capacity_factor)
    return max(4, ((cap + 3) // 4) * 4)


def moe_ffn(cfg: ArchConfig, p: dict, x: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out, aux): the routed experts (dropless, or
    chunked over S with capacity buckets) plus the shared experts."""
    with obs.span("moe", "model", x.device):
        if cfg.moe.capacity_factor is None:
            y, aux = _dropless(cfg, p, x)
        else:
            y, aux = _capacity_ffn(cfg, p, x)
        if cfg.moe.n_shared:
            h = x @ p["shared_in"].to(x.dtype)
            g = x @ p["shared_gate"].to(x.dtype)
            y = y + (F.silu(g) * h) @ p["shared_out"].to(x.dtype)
    return y, aux


def _capacity_ffn(cfg: ArchConfig, p: dict, x: torch.Tensor
                  ) -> tuple[torch.Tensor, dict]:
    """The routed experts with capacity-bucketed dispatch, chunked over
    S."""
    e = cfg.moe
    B, S, D = x.shape
    chunk = min(e.chunk, S)
    while S % chunk:
        chunk //= 2
    n_chunks = S // chunk
    cap = _capacity(e, chunk)

    lb_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(n_chunks):
        xc = x[:, i * chunk:(i + 1) * chunk]
        if torch.is_grad_enabled() and (xc.requires_grad
                                        or p["router"].requires_grad):
            # dispatch/combine one-hots are large: recompute in backward
            yc, lb, z = checkpoint(_moe_chunk, cfg, p, xc, cap,
                                   use_reentrant=False)
        else:
            yc, lb, z = _moe_chunk(cfg, p, xc, cap)
        lb_sum = lb_sum + lb
        z_sum = z_sum + z
        ys.append(yc)
    y = torch.cat(ys, dim=1)
    aux = {"moe_load_balance": lb_sum / n_chunks,
           "moe_z_loss": z_sum / n_chunks}
    return y, aux


def route(cfg: ArchConfig, p: dict, xc: torch.Tensor):
    """The router of xc (..., D): (float32 logits, probs, top-k gates,
    top-k expert ids), each (..., *). The product runs in the activation
    dtype (a float32 copy of xc would be as large as the hidden state)
    and only the logits are upcast, unless ``moe.router_f32`` (DeepSeek-V2's
    ``MoEGate`` multiplies in float32). The gates are the softmax's top-k
    probabilities, renormalised to sum to 1 where ``moe.norm_topk_prob``
    (the reference's rule for every config it has)."""
    e = cfg.moe
    if e.router_f32:
        logits = xc.to(torch.float32) @ p["router"].to(torch.float32)
    else:
        logits = (xc @ p["router"].to(xc.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                    # (..., E)
    gate, sel = torch.topk(probs, e.top_k, dim=-1)           # (..., K)
    if e.norm_topk_prob:
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    return logits, probs, gate, sel


def _aux(e: MoECfg, logits, probs, counts, pairs: int) -> dict:
    """The load-balance and z losses of one dispatch, from its per-expert
    pair ``counts`` (as the capacity path computes them per chunk)."""
    ce = counts.to(torch.float32) * (1.0 / pairs)            # choice share
    return {"moe_load_balance": e.n_routed * torch.sum(
                probs.reshape(-1, e.n_routed).mean(0) * ce),
            "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}


def _dropless(cfg: ArchConfig, p: dict, x: torch.Tensor
              ) -> tuple[torch.Tensor, dict]:
    """The routed experts of x (B, S, D) with no pair dropped: the pairs
    sorted by expert, one grouped product per expert weight, the outputs
    summed back by gate in float32."""
    e = cfg.moe
    B, S, D = x.shape
    T, K = B * S, e.top_k
    xt = x.reshape(T, D)
    with obs.span("route", "model", x.device):
        logits, probs, gate, sel = route(cfg, p, xt)        # (T, E), (T, K)
        # pairs by expert; each expert's end is found in the sorted ids
        # (bincount on a card reads its input's max on the host)
        ids, order = torch.sort(sel.reshape(-1), stable=True)
        ends = torch.searchsorted(
            ids, torch.arange(e.n_routed, device=ids.device), right=True,
            out_int32=True)
        counts = torch.diff(ends, prepend=ends.new_zeros(1)).long()
        xs = xt.index_select(0, order // K)                 # (T*K, D)
    load = EXPERT_LOAD
    if load is not None and obs.spans_on(x.device):
        load.append(torch.stack([counts.sum(), counts.max()]))
    with obs.span("experts", "model", x.device):
        cd = x.dtype
        h = torch._grouped_mm(xs, p["w_in"].to(cd), offs=ends)
        g = torch._grouped_mm(xs, p["w_gate"].to(cd), offs=ends)
        # each pair's gate scales the last product's input, which is
        # linear in it: no (T*K, D) float32 pass after the products
        a = F.silu(g) * h * gate.reshape(-1)[order, None].to(cd)
        ys = torch._grouped_mm(a, p["w_out"].to(cd), offs=ends)
    with obs.span("combine", "model", x.device):
        back = torch.empty_like(ys).index_copy_(0, order, ys)   # pair order
        y = back.view(T, K, D).sum(1, dtype=torch.float32)
    return y.to(x.dtype).view(B, S, D), _aux(e, logits, probs, counts, T * K)


def _experts(xe, w_in, w_gate, w_out):
    """The routed experts' gated MLPs on their buckets xe (B, E, cap, D)."""
    cd = xe.dtype
    h = torch.einsum("begd,edf->begf", xe, w_in.to(cd))
    g = torch.einsum("begd,edf->begf", xe, w_gate.to(cd))
    return torch.einsum("begf,efd->begd", F.silu(g) * h, w_out.to(cd))


def _sharded_experts(xe, w_in, w_gate, w_out):
    """:func:`_experts` on ``DTensor``s, each rank running its own experts
    on its own batch rows: expert parallelism on the mesh dims that split
    the weights' expert axis, the weights gathered over their FSDP split
    (the scheme gathers every weight a layer), the buckets keeping their
    batch split elsewhere. The products run on local shards, as DTensor's
    einsum on torch 2.11 mislays a local layout between the three."""
    mesh = xe.device_mesh
    expert = [isinstance(pw, Shard) and pw.dim == 0 for pw in w_in.placements]
    w_place = tuple(Shard(0) if e else Replicate() for e in expert)
    x_place = tuple(Shard(1) if e else (px if px == Shard(0) else Replicate())
                    for e, px in zip(expert, xe.placements))
    ws = [t.redistribute(mesh, w_place).to_local()
          for t in (w_in, w_gate, w_out)]
    out = _experts(xe.redistribute(mesh, x_place).to_local(), *ws)
    return DTensor.from_local(out, mesh, x_place, run_check=False)


def _moe_chunk(cfg: ArchConfig, p: dict, xc: torch.Tensor, cap: int):
    """One seq chunk: xc (B, C, D)."""
    e = cfg.moe
    B, C, D = xc.shape
    E, K = e.n_routed, e.top_k
    logits, probs, gate, sel = route(cfg, p, xc)

    # one-hots by comparison: no host sync on the card
    experts = torch.arange(E, dtype=sel.dtype, device=sel.device)
    onehot = (sel[..., None] == experts).to(torch.float32)   # (B, C, K, E)

    # aux losses
    me = probs.mean(dim=(0, 1))                              # (E,)
    ce = onehot.sum(dim=(0, 1, 2)) * (1.0 / (B * C * K))     # choice share
    load_balance = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # capacity-bucketed dispatch (Switch-style, per (batch, chunk))
    # position of each (token, k) within its expert's bucket, in (C*K) order
    flat = onehot.reshape(B, C * K, E)
    pos_in_e = torch.cumsum(flat, dim=1) - flat              # (B, C*K, E)
    pos_in_e = (pos_in_e * flat).sum(-1).to(torch.int32)     # (B, C*K)
    keep = (pos_in_e < cap).to(torch.float32)
    # one-hot of the slot; a position past the bucket has none
    slot = (pos_in_e[..., None] == torch.arange(
        cap, dtype=torch.int32, device=xc.device)).to(torch.float32)
    # dispatch[b, ck, e, cap]
    dispatch = flat[..., None] * slot[..., None, :] * keep[..., None, None]
    dispatch = dispatch.reshape(B, C, K, E, cap)
    combine = (dispatch * gate[..., None, None]).sum(2)      # (B, C, E, cap)
    dispatch = dispatch.sum(2)                               # (B, C, E, cap)

    cd = xc.dtype
    xe = torch.einsum("bceg,bcd->begd", dispatch.to(cd), xc)  # (B,E,cap,D)
    w = [p[k] for k in ("w_in", "w_gate", "w_out")]
    oe = (_sharded_experts(xe, *w) if isinstance(xe, DTensor)
          else _experts(xe, *w))                             # (B,E,cap,D)
    yc = torch.einsum("bceg,begd->bcd", combine.to(cd), oe)
    return yc, load_balance, z_loss
