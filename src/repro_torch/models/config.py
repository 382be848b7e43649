"""Architecture configuration schema for the LM model zoo (a copy of
``repro.models.config``, which is pure Python).

One frozen dataclass describes every assigned architecture; the decoder in
``transformer.py`` consumes it. Per-layer behaviour (SWA vs global windows)
is expressed as data (the per-layer window vector). The reference scans one
layer body over it; the port loops over the layers in Python and hands each
its window as a plain ``int``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

FULL_WINDOW = 0  # sentinel in per-layer window vectors: full attention


@dataclass(frozen=True)
class MoECfg:
    n_routed: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    # None: dropless (every (token, choice) pair reaches its expert)
    capacity_factor: float | None = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    chunk: int = 256             # seq chunk for capacity dispatch
    norm_topk_prob: bool = True  # renormalise the top-k gates to sum 1
    router_f32: bool = False     # the router's product in float32


@dataclass(frozen=True)
class MLACfg:
    q_lora: int | None           # None: one ``wq``, no query LoRA
    kv_lora: int
    d_nope: int
    d_rope: int
    d_v: int


@dataclass(frozen=True)
class YarnCfg:
    """YaRN rotary scaling (DeepSeek-V2's ``rope_scaling`` of type
    ``yarn``): the rotary pairs that turn fewer than ``beta_slow`` times
    over ``original_max_pos`` positions rotate ``factor`` times slower,
    those that turn more than ``beta_fast`` times as before, a linear ramp
    between; the softmax scale is multiplied by ``mscale(factor,
    mscale_all_dim)`` squared."""
    factor: float
    original_max_pos: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


#: The fields the port's configs have beyond the reference's, by class,
#: with the value at which each behaves as the reference does. Every
#: config of the reference's architectures holds these values.
PORT_ONLY_FIELDS = {"ArchConfig": {"yarn": None},
                    "MoECfg": {"norm_topk_prob": True, "router_f32": False}}


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    expand: int = 2
    d_conv: int = 4


@dataclass(frozen=True)
class RWKVCfg:
    decay_lora: int = 64
    head_dim: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # mixer selection
    mixer: Literal["attn", "mamba+attn", "rwkv"] = "attn"

    # attention details
    windows: tuple[int, ...] = ()        # per-layer; FULL_WINDOW = full attn
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qkv_bias: bool = False
    rope_frac: float = 1.0
    rope_theta: float = 10000.0
    yarn: YarnCfg | None = None          # YaRN rope scaling (MLA only)

    # norms / MLP
    norm: Literal["rms", "ln"] = "rms"
    act: Literal["silu", "gelu"] = "silu"
    gated_mlp: bool = True
    post_norm: bool = False              # gemma2 sandwich norms
    tie_embeddings: bool = False

    # positions
    pos: Literal["rope", "learned", "none"] = "rope"
    max_seq: int = 1 << 20

    # optional submodules
    moe: MoECfg | None = None
    dense_layers: tuple[int, ...] = ()   # FFN stays dense at these layers
    mla: MLACfg | None = None
    mamba: MambaCfg | None = None
    rwkv: RWKVCfg | None = None

    # vision cross-attention (mllama-style)
    cross_attn_period: int = 0           # every Nth layer is a cross block
    n_img_tokens: int = 0

    # encoder-decoder (whisper-style); decoder uses the main fields
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500                  # stubbed frame-embedding length

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # capability flags
    supports_long_context: bool = False  # sub-quadratic decode at 500k

    def __post_init__(self):
        if self.windows and len(self.windows) != self.n_layers:
            raise ValueError(
                f"{self.name}: windows has {len(self.windows)} entries, "
                f"need n_layers={self.n_layers}")

    # ---- derived ----

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the LM head / logits
        shard cleanly over the model axis (production-standard padding;
        padded columns are masked out of the loss and decode argmax)."""
        return -(-self.vocab // 256) * 256

    @property
    def layer_windows(self) -> tuple[int, ...]:
        return self.windows if self.windows else (FULL_WINDOW,) * self.n_layers

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    def n_params(self) -> int:
        """Total parameter count (embedding included)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        v = self.padded_vocab
        total = v * d + (0 if self.tie_embeddings else d * v) + d
        if self.enc_dec:
            total += (self.max_seq + self.enc_seq) * d + d  # pos tables
        elif self.pos == "learned":
            total += self.max_seq * d

        def mlp(ff: int) -> int:
            return (3 if self.gated_mlp else 2) * d * ff

        for i in range(L):
            per = 2 * d + (2 * d if self.post_norm else 0)  # norms
            if self.mixer == "rwkv":
                c = self.rwkv or RWKVCfg()
                per += 5 * d * d                       # r, k, v, g, o
                per += d * c.decay_lora + c.decay_lora * d + 2 * d
                per += d * f + f * d + d * d           # channel mix
            else:
                if self.mla is not None:
                    m = self.mla
                    d_qk = self.n_heads * (m.d_nope + m.d_rope)
                    if m.q_lora is None:
                        per += d * d_qk
                    else:
                        per += d * m.q_lora + m.q_lora * d_qk
                    per += d * (m.kv_lora + m.d_rope)
                    per += m.kv_lora * self.n_heads * (m.d_nope + m.d_v)
                    per += self.n_heads * m.d_v * d
                else:
                    per += d * self.d_q + 2 * d * self.d_kv + self.d_q * d
                if self.mixer == "mamba+attn":
                    mb = self.mamba or MambaCfg()
                    di = mb.expand * d
                    per += d * 2 * di + di * d          # in/out proj
                    per += di * (2 * mb.d_state + 1)    # B, C, dt proj
                    per += di * mb.d_conv + di * mb.d_state + di
                if self.moe is not None and i not in self.dense_layers:
                    e = self.moe
                    per += d * e.n_routed
                    per += (e.n_routed + e.n_shared) * mlp(e.d_expert)
                else:
                    per += mlp(f)
            total += per
        if self.cross_attn_period:
            n_cross = L // self.cross_attn_period
            total += n_cross * (d * self.d_q + 2 * d * self.d_kv
                                + self.d_q * d + 3 * d)
        if self.enc_dec:
            # decoder cross-attention blocks (one per decoder layer)
            total += L * (d * self.d_q + 2 * d * self.d_kv
                          + self.d_q * d + 2 * d)
            # encoder stack
            total += self.n_enc_layers * (
                d * self.d_q + 2 * d * self.d_kv + self.d_q * d
                + mlp(f) + 4 * d)
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        expert = (3 if self.gated_mlp else 2) * self.d_model * e.d_expert
        n_moe = self.n_layers - len(self.dense_layers)
        inactive = n_moe * (e.n_routed - e.top_k) * expert
        return self.n_params() - inactive

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests."""
        d = {
            "n_layers": overrides.get("n_layers", min(self.n_layers, 2)),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads
            else self.n_kv_heads,
            "d_head": 16,
            "d_ff": 128,
            "vocab": 256,
            "max_seq": 512,
            "param_dtype": "float32",
            "compute_dtype": "float32",
        }
        if self.windows:
            w = [min(x, 8) if x else 0 for x in self.windows[:d["n_layers"]]]
            # keep at least one full-attn layer if the original had one
            if any(x == FULL_WINDOW for x in self.windows):
                w[-1] = FULL_WINDOW
            d["windows"] = tuple(w)
        if self.moe is not None:
            # capacity_factor 4 => no token drops, so decode == forward
            # exactly (capacity dropping is train-time-only behavior)
            d["moe"] = replace(self.moe, n_routed=4, top_k=2, d_expert=32,
                               n_shared=min(self.moe.n_shared, 1), chunk=16,
                               capacity_factor=None
                               if self.moe.capacity_factor is None else 4.0)
            d["dense_layers"] = tuple(x for x in self.dense_layers
                                      if x < d["n_layers"])
        if self.mla is not None:
            d["mla"] = MLACfg(q_lora=None if self.mla.q_lora is None else 32,
                              kv_lora=16, d_nope=16, d_rope=8, d_v=16)
        if self.mamba is not None:
            d["mamba"] = replace(self.mamba, d_state=4)
        if self.rwkv is not None:
            d["rwkv"] = RWKVCfg(decay_lora=8, head_dim=16)
        if self.cross_attn_period:
            d["cross_attn_period"] = 2
            d["n_img_tokens"] = 8
        if self.enc_dec:
            d["n_enc_layers"] = 2
            d["enc_seq"] = 16
        d.update(overrides)
        return replace(self, **d)
