"""Seeded weights of a DeepSeek-V2 decoder with MLA and a DeepSeekMoE FFN
(the ``deepseek-v2-lite`` configuration), made on the device in a few large
calls, in the dtypes the configuration states.

The parameters come back in the program's layout (``DecoderLM.init``'s dict
of the MoE family: ``dense_prefix`` and ``layers`` lists of blocks with
``mla`` and ``mlp`` or ``moe``), each leaf a view into one of three flat
buffers: bf16 for the matrices, f32 for the routers and f32 for the norm
scales. The same seed gives the same values, so the reference makes its
own copy after the program's is gone.
"""

from __future__ import annotations

import torch

from klbench.seeds import generator
from klbench.weights import NORM_STD, _fill, _numel, insert


def leaf_specs(c: dict) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, std) of every leaf, in the program's layout;
    kind is ``bf16``, ``router`` (f32 matrix) or ``norm`` (f32 scale)."""
    d, v, h = c["hidden_size"], c["vocab_size"], c["num_attention_heads"]
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    dv, lora = c["v_head_dim"], c["kv_lora_rank"]
    ff, fe = c["intermediate_size"], c["moe_intermediate_size"]
    e, sh = c["n_routed_experts"], c["n_shared_experts"] * fe
    n_dense = c["first_k_dense_replace"]
    specs = [(("embed",), (v, d), "bf16", 1.0),
             (("final_norm", "scale"), (d,), "norm", NORM_STD),
             (("head",), (d, v), "bf16", d ** -0.5)]
    for i in range(c["num_hidden_layers"]):
        lay = (("dense_prefix", i) if i < n_dense
               else ("layers", i - n_dense))
        specs += [(lay + ("ln1", "scale"), (d,), "norm", NORM_STD),
                  (lay + ("ln2", "scale"), (d,), "norm", NORM_STD),
                  (lay + ("mla", "kv_norm", "scale"), (lora,), "norm",
                   NORM_STD)]
        for name, shape in (("wq", (d, h * (nope + rope))),
                            ("wkv_a", (d, lora + rope)),
                            ("wk_b", (lora, h * nope)),
                            ("wv_b", (lora, h * dv)),
                            ("wo", (h * dv, d))):
            specs.append((lay + ("mla", name), shape, "bf16",
                          shape[0] ** -0.5))
        if i < n_dense:
            for name, shape in (("w_in", (d, ff)), ("w_gate", (d, ff)),
                                ("w_out", (ff, d))):
                specs.append((lay + ("mlp", name), shape, "bf16",
                              shape[0] ** -0.5))
            continue
        specs.append((lay + ("moe", "router"), (d, e), "router", d ** -0.5))
        for name, shape, fan in (("w_in", (e, d, fe), d),
                                 ("w_gate", (e, d, fe), d),
                                 ("w_out", (e, fe, d), fe),
                                 ("shared_in", (d, sh), d),
                                 ("shared_gate", (d, sh), d),
                                 ("shared_out", (sh, d), sh)):
            specs.append((lay + ("moe", name), shape, "bf16", fan ** -0.5))
    return specs


def _place(tree: dict, specs, flat: torch.Tensor, scaled: bool) -> None:
    """Views of ``flat`` into ``tree`` in ``specs``' order; with
    ``scaled`` each run of leaves of one std is multiplied by it once."""
    off, start, std = 0, 0, None
    for path, shape, _, s in specs:
        if scaled and s != std:
            if std is not None:
                flat[start:off].mul_(std)
            start, std = off, s
        n = _numel(shape)
        insert(tree, path, flat[off:off + n].view(shape))
        off += n
    if scaled and std is not None:
        flat[start:off].mul_(std)


def params(c: dict, seed: int, device) -> dict:
    """The program's parameter dict for config ``c``, drawn from ``seed``:
    bf16 leaves grouped by their standard deviation, then the f32 routers,
    then the norm scales, 1 + N(0, 0.1^2)."""
    specs = leaf_specs(c)
    gen = generator(seed, "weights", device)
    groups = {kind: [s for s in specs if s[2] == kind]
              for kind in ("bf16", "router", "norm")}
    groups["bf16"].sort(key=lambda s: s[3])
    tree: dict = {}
    for kind, dtype in (("bf16", torch.bfloat16), ("router", torch.float32),
                        ("norm", torch.float32)):
        flat = _fill(sum(_numel(s[1]) for s in groups[kind]), dtype, gen,
                     device)
        if kind == "norm":
            flat.mul_(NORM_STD).add_(1.0)
        _place(tree, groups[kind], flat, scaled=kind != "norm")
    return tree
