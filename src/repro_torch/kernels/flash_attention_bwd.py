"""Flash attention's backward as a CUDA kernel
(``csrc/flash_attention_bwd.cu``) for the H100: dq, dk and dv from q, k, v
and the output's gradient dO, in bfloat16 at head dim 128, causal or full,
over the flattened heads of
:mod:`~repro_torch.kernels.flash_attention` (grouped kv included).

The reference has no backward kernel: its training differentiates the plain
attention. So this kernel serves only where :func:`takes` says, bfloat16 at
D 128 (the LM stack's training), and ``FlashAttentionFn.backward`` keeps
the plain version's gradient for every other launch (float32, D 256/384/512).

Two builders are registered (causal / full), as for the forward: causality
changes the problem's work. The problem is the forward's ``(BH, BHkv, S,
D)``. The space: ``threads`` (16 rows a warp, so each pass's block owns
``threads / 2`` rows: query rows in the dq pass, key rows in the dk/dv
pass), ``block_q`` (the q tile the dk/dv pass walks) and ``block_k`` (the
k tile the dq pass walks); :func:`card_refusal` refuses what the card
cannot hold in registers or shared memory. One launch is one ctypes call
that enqueues both passes; ``kernel.launches`` counts it once
(``CUDA_KERNELS["flash_attention_bwd"]``, apart from the forward's). On CPU
tensors the plain gradient runs (``ref.flash_attention_bwd_ref_factory``);
on ``meta`` tensors the shapes; on CUDA tensors the kernel, or an error.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import KernelBuilder, Workload, register
from repro_torch.core.builder import probe_array
from repro_torch.core.device import GPU_H100

from . import ref as _ref
from ._build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
kernel = CudaKernel("flash_attention_bwd", "flash_attention_bwd.cu",
                    "flash_attention_bwd_launch",
                    (_P,) * 9 + (_I, _I, _I, _I, _P))

#: The one dtype and head dim the kernel takes.
DTYPE = torch.bfloat16
HEAD_DIM = 128
#: Products of 2 * D flop a (query, key) pair the kernel runs: Q.K^T and
#: dO.V^T in the dq pass's two sweeps and in the dk/dv pass, P^T.dO, dS^T.Q
#: and dS.K (the gradient's minimum is 5).
PRODUCTS = 9
#: Most f32 accumulators a thread may hold (dK and dV, or dQ, plus the
#: score and dP fragments of a tile), leaving registers of the 255 for
#: fragments and addresses.
MAX_ACCUMULATORS = 192
#: Grid extent CUDA allows on the y axis, where the flattened heads go.
_MAX_GRID_Y = 65535
_STRIDE = HEAD_DIM + 8   # bf16 elements a shared-memory row


def takes(q: torch.Tensor) -> bool:
    """Whether ``FlashAttentionFn.backward`` runs this kernel for a
    forward on ``q``: bfloat16 at head dim 128, on any device (the CPU
    and ``meta`` go through the builder's plain gradient and shapes)."""
    return q.dtype == DTYPE and q.shape[-1] == HEAD_DIM


def smem_bytes(config) -> dict[str, int]:
    """Dynamic shared memory of a block of each pass, as the source lays
    it out: the owned rows of two operands, the walked tile of two, padded
    rows of bf16, and the f32 row statistics."""
    rows = config["threads"] // 2
    return {"dq": (2 * rows + 2 * config["block_k"]) * _STRIDE * 2,
            "dkdv": (2 * rows + 2 * config["block_q"]) * _STRIDE * 2
            + 8 * config["block_q"]}


def accumulators(config) -> dict[str, int]:
    """f32 accumulators a thread of each pass holds: a warp's 16 x 128 dQ
    (dK and dV) and the 16-row score and dP fragments of the walked tile."""
    per_row = HEAD_DIM // 2   # 16 x 128 floats over 32 lanes
    return {"dq": per_row + config["block_k"],
            "dkdv": 2 * per_row + config["block_q"]}


def card_refusal(config) -> str:
    """Why the H100 would refuse ``config`` (or spill it), or ``""``."""
    for name, n in smem_bytes(config).items():
        if n > GPU_H100.smem_per_block:
            return (f"the {name} pass needs {n} bytes of shared memory, "
                    f"above the {GPU_H100.smem_per_block} a block may have")
    for name, n in accumulators(config).items():
        if n > MAX_ACCUMULATORS:
            return (f"the {name} pass holds {n} f32 accumulators a thread, "
                    f"above {MAX_ACCUMULATORS} of its 255 registers")
    return ""


def fits_card(config) -> bool:
    """The space's restriction: the card takes ``config``."""
    return not card_refusal(config)


def defines(config, causal: bool) -> tuple[tuple[str, int], ...]:
    """The -D defines of the build of ``config``."""
    return (("BLOCK_Q", config["block_q"]), ("BLOCK_K", config["block_k"]),
            ("THREADS", config["threads"]), ("CAUSAL", int(causal)),
            ("HEAD_DIM", HEAD_DIM))


def check_args(q, k, v, do) -> None:
    """Raise unless q, dO (BH, S, 128) and k, v (BHkv, S, 128) are
    contiguous bfloat16 tensors of one device, with BH a multiple of
    BHkv."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or \
            do.shape != q.shape:
        raise ValueError(f"flash attention backward needs q, dO (BH, S, D) "
                         f"and k, v (BHkv, S, D), got "
                         f"{[tuple(t.shape) for t in (q, k, v, do)]}")
    bh, s, d = q.shape
    if tuple(k.shape[1:]) != (s, d) or d != HEAD_DIM:
        raise ValueError(f"flash attention backward takes head dim "
                         f"{HEAD_DIM} and k/v rows like q's, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    ts = (q, k, v, do)
    if any(t.dtype != DTYPE for t in ts) or \
            len({t.device for t in ts}) != 1:
        raise ValueError(f"flash attention backward takes {DTYPE} operands "
                         f"on one device, got "
                         f"{[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash attention backward operands must be "
                         "contiguous")
    if k.shape[0] < 1 or bh % k.shape[0] or s < 1:
        raise ValueError(f"flash attention backward: BH={bh} is not a "
                         f"multiple of BHkv={k.shape[0]}, or S={s} is empty")


def launch(config, q, k, v, do, *, causal: bool):
    """(dq, dk, dv): the CUDA kernel with ``config`` on CUDA tensors, the
    plain gradient on CPU tensors, empty tensors of the gradients' shapes
    on ``meta`` tensors (nothing launches)."""
    check_args(q, k, v, do)
    if q.device.type == "cpu":
        return _ref.flash_attention_bwd_ref_factory(causal)(q, k, v, do)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention backward: the kernel runs on CUDA"
                         f" tensors, got a {q.device.type} tensor")
    bh, s, d = q.shape
    ts = (q, k, v, do)
    if bh > _MAX_GRID_Y or bh * s * d >= 2**31 or \
            any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"flash attention backward problem "
                         f"{(bh, k.shape[0], s, d)} outside the kernel's "
                         f"range, or an operand not 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    kernel(defines(config, causal), "bfloat16",
           *(t.data_ptr() for t in (*ts, dq, dk, dv, lse, delta)),
           bh, k.shape[0], s, d,
           torch.cuda.current_stream(q.device).cuda_stream)
    return dq, dk, dv


def _make_builder(causal: bool) -> KernelBuilder:
    name = ("flash_attention_bwd_causal" if causal
            else "flash_attention_bwd_full")
    b = KernelBuilder(name, source="repro_torch.kernels.flash_attention_bwd")
    b.tune("block_q", (32, 64, 128), default=64)
    b.tune("block_k", (32, 64, 128), default=64)
    b.tune("threads", (64, 128, 256), default=128)
    b.restriction(fits_card)

    @b.problem_size
    def _problem(q, k, v, do):
        bh, s, d = q.shape
        return (int(bh), int(k.shape[0]), int(s), int(d))

    @b.build
    def _build(config, problem, meta):
        if problem[3] != HEAD_DIM:
            raise ValueError(f"{name}: head dim {problem[3]} is not "
                             f"{HEAD_DIM}")
        # nvcc: the JIT step
        lib = (kernel.load(defines(config, causal))
               if meta[0].device.type == "cuda" else None)

        def run(q, k, v, do):
            return launch(config, q, k, v, do, causal=causal)

        run.library = lib
        return run

    b.reference(_ref.flash_attention_bwd_ref_factory(causal))

    @b.workload
    def _workload(config, problem, dtype):
        """:data:`PRODUCTS` products of D multiply-adds for each (query,
        key) pair the gradient needs, S(S+1)/2 pairs a head when causal
        (the forward's count). The compulsory traffic reads q, k, v and dO
        once, writes dq, dk and dv once, and writes and reads the f32
        lse and delta once; the dk/dv pass's re-reads of q and dO for each
        k tile, and the dq pass's of k and v, are L2 hits, as the
        forward's. ``vmem_bytes`` is the larger pass's shared memory,
        ``grid`` the blocks of both passes; for the cost model ``mxu_tile``
        is the dk/dv pass's (rows, block_q, D). Invalid where
        :func:`launch` would refuse the problem or the card the config."""
        bh, bhkv, s, d = problem
        tiles = -(-s // (config["threads"] // 2))
        pairs = s * (s + 1) / 2 if causal else float(s * s)
        valid = (dtype == "bfloat16" and d == HEAD_DIM and bhkv >= 1
                 and bh % bhkv == 0 and s >= 1 and bh <= _MAX_GRID_Y
                 and bh * s * d < 2**31 and not card_refusal(config))
        return Workload(
            flops=2.0 * PRODUCTS * bh * d * pairs,
            hbm_bytes=float((3 * bh + 4 * bhkv) * s * d * 2 + 4 * bh * s * 4),
            vmem_bytes=max(smem_bytes(config).values()),
            grid=tiles * (bh + bhkv),
            mxu_tile=(config["threads"] // 2, config["block_q"], d),
            valid=valid)

    @b.probe
    def _probe(problem, dtype):
        """q, k, v drawn as the forward's probe draws them, then dO."""
        bh, bhkv, s, d = problem
        rng = np.random.default_rng(0)
        scale = 1.0 / (d ** 0.5)
        return (probe_array(rng, (bh, s, d), dtype, scale),
                probe_array(rng, (bhkv, s, d), dtype, scale),
                probe_array(rng, (bhkv, s, d), dtype, scale),
                probe_array(rng, (bh, s, d), dtype))

    register(b)
    return b


causal_builder = _make_builder(True)
full_builder = _make_builder(False)
