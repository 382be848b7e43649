"""A dense decoder written plainly: the model of the ``codeqwen1.5-7b``
configurations (pre-norm RMS norm with the configuration's epsilon, rotary q
and k with biases, grouped-query causal attention, SiLU-gated MLP, separate
head).

Everything computes in float32 with TF32 off; the parameters are read from
the seeded bf16/f32 tree (``klbench.weights``) one layer at a time.
``fp8=True`` rounds both operands of every matrix product to float8 e4m3
with a per-tensor scale first: the control, one precision below the bf16
the configuration states.

:func:`prefill` gives each layer's K (after rotary) and V and the logits at
the last position. :func:`train` runs steps of mean next-token cross
entropy with AdamW on float32 arithmetic, each parameter stored between
steps in the dtype the configuration gives it (bf16 matrices and biases,
f32 norm scales), as the program stores it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from klbench.weights import flatten, insert

FP8_MAX = 448.0


@contextlib.contextmanager
def ieee_f32():
    """TF32 off for float32 products inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in f32;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    r = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (r - x.detach())


def mm(a, b, fp8: bool):
    return q8(a) @ q8(b) if fp8 else a @ b


def rmsnorm(c: dict, x, scale):
    return (x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                            + c["rms_norm_eps"]) * scale)


def rope(x, theta: float):
    """x: (B, H, S, D); rotary over interleaved pairs (x[2i], x[2i+1]) at
    positions 0..S-1."""
    S, D = x.shape[2], x.shape[3]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def attention(q, k, v, fp8: bool):
    """Causal softmax attention, (B, H, S, D), one batch row at a time."""
    S, D = q.shape[2], q.shape[3]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    out = []
    for b in range(q.shape[0]):
        s = mm(q[b], k[b].transpose(-1, -2), fp8) * D ** -0.5
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        out.append(mm(p, v[b], fp8))
    return torch.stack(out)


def f32_layer(lp: dict) -> dict:
    return {k: {n: t.to(torch.float32) for n, t in v.items()}
            for k, v in lp.items()}


def layer(c: dict, lp: dict, x, fp8: bool):
    """One block on f32 parameters ``lp``: (x, k, v)."""
    B, S, _ = x.shape
    H, Hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    a = lp["attn"]
    h = rmsnorm(c, x, lp["ln1"]["scale"])
    q = mm(h, a["wq"], fp8)
    k = mm(h, a["wk"], fp8)
    v = mm(h, a["wv"], fp8)
    if "bq" in a:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    q = rope(q.view(B, S, H, hd).transpose(1, 2), c["rope_theta"])
    k = rope(k.view(B, S, Hkv, hd).transpose(1, 2), c["rope_theta"])
    v = v.view(B, S, Hkv, hd).transpose(1, 2)
    kr, vr = k, v
    if Hkv != H:
        kr = k.repeat_interleave(H // Hkv, dim=1)
        vr = v.repeat_interleave(H // Hkv, dim=1)
    o = attention(q, kr, vr, fp8).transpose(1, 2).reshape(B, S, H * hd)
    x = x + mm(o, a["wo"], fp8)
    m = lp["mlp"]
    h = rmsnorm(c, x, lp["ln2"]["scale"])
    g = mm(h, m["w_gate"], fp8)
    x = x + mm(torch.nn.functional.silu(g) * mm(h, m["w_in"], fp8),
               m["w_out"], fp8)
    return x, k, v


@torch.no_grad()
def prefill(c: dict, params: dict, tokens, fp8: bool = False,
            on_kv=None) -> torch.Tensor:
    """Logits (B, V) at the last position of ``tokens`` (B, S); calls
    ``on_kv(i, k, v)`` with layer i's (B, Hkv, S, D) keys and values."""
    with ieee_f32():
        x = params["embed"][tokens.long()].to(torch.float32)
        for i, lp in enumerate(params["layers"]):
            x, k, v = layer(c, f32_layer(lp), x, fp8)
            if on_kv is not None:
                on_kv(i, k, v)
            del k, v
        h = rmsnorm(c, x[:, -1], params["final_norm"]["scale"])
        return mm(h, params["head"].to(torch.float32), fp8)


def _loss(c: dict, p: dict, tokens, labels, fp8: bool):
    x = p["embed"][tokens.long()]
    for lp in p["layers"]:
        if fp8:     # the rounded copies would not fit beside the state
            x = checkpoint(lambda x, lp: layer(c, lp, x, True)[0], x, lp,
                           use_reentrant=False)
        else:
            x = layer(c, lp, x, fp8)[0]
    h = rmsnorm(c, x, p["final_norm"]["scale"])
    logits = mm(h, p["head"], fp8)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def _tree(paths, leaves) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        insert(tree, path, leaf)
    return tree


def train(c: dict, params: dict, batches, opt: dict, microbatches: int,
          steps: int, fp8: bool = False, rows: slice | None = None) -> dict:
    """``steps`` training steps from ``params`` on ``batches`` (a list of
    {"tokens", "labels"} (B, S) tensors). The loss is the mean cross
    entropy over the batch; ``rows`` keeps only those rows (a fault
    planted for a check).

    Returns per step the loss of the last of ``microbatches`` slices (what
    the program reports), the gradient norm of each leaf at step 1 after
    clipping (what the optimizer takes in), and each leaf's change after
    the last step, by leaf path."""
    named = flatten(params)
    paths = [p for p, _ in named]
    dtypes = [t.dtype for _, t in named]
    p0 = [t for _, t in named]
    p = [t.to(torch.float32, copy=True).requires_grad_(True) for t in p0]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    losses, grad_norms = [], None
    with ieee_f32():
        for step in range(1, steps + 1):
            batch = batches[step - 1]
            tokens, labels = batch["tokens"], batch["labels"]
            if rows is not None:
                tokens, labels = tokens[rows], labels[rows]
            B = tokens.shape[0]
            per_mb = B // microbatches
            tree = _tree(paths, p)
            last = []
            for b in range(B):
                loss = _loss(c, tree, tokens[b:b + 1], labels[b:b + 1], fp8)
                (loss / B).backward()
                if b >= B - per_mb:
                    last.append(loss.detach())
                del loss
            losses.append(float(torch.stack(last).mean()))
            with torch.no_grad():
                grads = [t.grad for t in p]
                gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
                scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9),
                                    max=1.0)
                for g in grads:
                    g.mul_(scale)
                if step == 1:
                    grad_norms = {path: float(torch.linalg.vector_norm(g))
                                  for path, g in zip(paths, grads)}
                c1 = 1.0 - opt["b1"] ** step
                c2 = 1.0 - opt["b2"] ** step
                for t, g, mt, vt, dt in zip(p, grads, m, v, dtypes):
                    mt.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                    vt.mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
                    upd = (mt / c1) / (torch.sqrt(vt / c2) + opt["eps"])
                    upd.add_(t, alpha=opt["weight_decay"])
                    t.sub_(opt["lr"] * upd)
                    t.copy_(t.to(dt))
                    t.grad = None
    with torch.no_grad():
        change = {path: float(torch.linalg.vector_norm(t - t0.to(t.dtype)))
                  for path, t, t0 in zip(paths, p, p0)}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
