"""Seeded weights of a dense decoder, made on the device in a few large
calls, in the dtypes the configuration states.

The parameters come back in the program's layout (``DecoderLM.init``'s dict
of the dense family), each leaf a view into one of two flat buffers: bf16
for the matrices and biases, f32 for the norm scales. The same seed gives
the same values, so the reference makes its own copy after the program's
is gone.
"""

from __future__ import annotations

import torch

from klbench.seeds import generator

#: Elements a single ``randn`` call fills.
CHUNK = 1 << 30
BIAS_STD = 0.02
NORM_STD = 0.1


def leaf_specs(c: dict) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, dtype, std) of every leaf, in the program's layout."""
    d, ff, hd = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    dq = c["num_attention_heads"] * hd
    dkv = c["num_key_value_heads"] * hd
    v = c["vocab_size"]
    specs = [(("embed",), (v, d), "bf16", 1.0),
             (("final_norm", "scale"), (d,), "f32", NORM_STD),
             (("head",), (d, v), "bf16", d ** -0.5)]
    for i in range(c["num_hidden_layers"]):
        lay = ("layers", i)
        specs += [(lay + ("ln1", "scale"), (d,), "f32", NORM_STD),
                  (lay + ("ln2", "scale"), (d,), "f32", NORM_STD)]
        for name, shape in (("wq", (d, dq)), ("wk", (d, dkv)),
                            ("wv", (d, dkv)), ("wo", (dq, d))):
            specs.append((lay + ("attn", name), shape, "bf16",
                          shape[0] ** -0.5))
        if c.get("qkv_bias"):
            for name, n in (("bq", dq), ("bk", dkv), ("bv", dkv)):
                specs.append((lay + ("attn", name), (n,), "bf16", BIAS_STD))
        for name, shape in (("w_in", (d, ff)), ("w_gate", (d, ff)),
                            ("w_out", (ff, d))):
            specs.append((lay + ("mlp", name), shape, "bf16",
                          shape[0] ** -0.5))
    return specs


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _fill(n: int, dtype: torch.dtype, gen: torch.Generator, device
          ) -> torch.Tensor:
    flat = torch.empty(n, dtype=dtype, device=device)
    for s in range(0, n, CHUNK):
        flat[s:s + CHUNK].normal_(generator=gen)
    return flat


def insert(tree: dict, path: tuple, leaf) -> None:
    """Put ``leaf`` at ``path`` (dict keys and list indices) in ``tree``."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = leaf


def decoder_params(c: dict, seed: int, device) -> dict:
    """The program's parameter dict for config ``c``, drawn from ``seed``.

    bf16 leaves are laid out grouped by their standard deviation, so that
    one multiply scales each group; norm scales are 1 + N(0, 0.1^2)."""
    specs = leaf_specs(c)
    gen = generator(seed, "weights", device)
    bf = sorted((s for s in specs if s[2] == "bf16"), key=lambda s: s[3])
    f32 = [s for s in specs if s[2] == "f32"]
    flat_bf = _fill(sum(_numel(s[1]) for s in bf), torch.bfloat16, gen,
                    device)
    flat_f32 = _fill(sum(_numel(s[1]) for s in f32), torch.float32, gen,
                     device)
    flat_f32.mul_(NORM_STD).add_(1.0)
    tree: dict = {}
    off, group_start, group_std = 0, 0, None
    for path, shape, _, std in bf:
        if std != group_std:
            if group_std is not None:
                flat_bf[group_start:off].mul_(group_std)
            group_start, group_std = off, std
        n = _numel(shape)
        insert(tree, path, flat_bf[off:off + n].view(shape))
        off += n
    flat_bf[group_start:off].mul_(group_std)
    off = 0
    for path, shape, _, _ in f32:
        n = _numel(shape)
        insert(tree, path, flat_f32[off:off + n].view(shape))
        off += n
    return tree


def flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, leaf) pairs of a params-shaped tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = (enumerate(tree) if isinstance(tree, list)
             else sorted(tree.items()))
    out = []
    for k, v in items:
        out += flatten(v, prefix + (k,))
    return out
