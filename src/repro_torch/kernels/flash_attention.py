"""Flash attention (forward) as a CUDA kernel (``csrc/flash_attention.cu``)
for the H100, with a tunable (block_q, block_k, threads) tiling — the LM
stack's hot spot. Port of ``repro.kernels.flash_attention``.

Layout as in the reference: heads are flattened into the leading axis,
q: (B*Hq, S, D), k/v: (B*Hkv, S, D); the kernel maps query head bh to kv
row bh // (BH // BHkv), so grouped kv is never materialised. The problem is
``(BH, BHkv, S, D)``, so captures and wisdom keep the reference's format.

MLA's heads (DeepSeek-V2) are wider for q and k than for v: the kernel also
takes the pairs of :data:`SPLIT_DIMS` (q/k 192, v 128), with v (BHkv, S,
Dv) and o (BH, S, Dv), and a softmax scale passed in (MLA's YaRN scale).
Their problem is ``(BH, BHkv, S, D, Dv)``; a launch passes the scale as a
fourth argument (``kernel(q, k, v, scale)``), which is no part of the
problem. The v head dim is compiled in beside D (``-DV_DIM``, only where
it differs from D, so the equal-dim builds keep their defines).

Two builders are registered (causal / full), as in the reference: causality
changes the problem's work, not just a value, so they tune and store
wisdom independently. One CUDA source serves both, with ``-DCAUSAL=0/1``,
and one launch counter (``kernel.launches``) counts both.

The tuning space is Hopper's, not the TPU's (``dim_semantics`` means
nothing here): query rows a block owns, key rows a shared-memory tile
holds, and threads a block. Each warp owns 16 or 32 query rows. The space
refuses configs that need more shared memory than a block may have
(227 KB, ``core/device.py``'s ``gpu-h100`` spec) at D = 128 in the body
each dtype selects (:func:`card_refusal`), and two m16 tiles per warp with
128-key tiles, whose accumulators would not fit in registers. The head
dimension is compiled in (``-DHEAD_DIM``), so a config is built once per D
it meets; D is 128, 256, 384 or 512 (:data:`HEAD_DIMS`). At D 384 and
512 the ``mma`` body launches ``D / 128`` warps for each row group of the
config, each owning a 128-wide slice of the output (:func:`launch_threads`),
and a selected config the card refuses at the launch's D and dtype (a
record tuned at D 128 serving a fallback tier, or the default in float32)
gives way to :data:`FIT_CONFIGS` (:func:`fit_config`). On CPU tensors the
plain version (``ref.flash_attention_ref_factory``) runs; on CUDA tensors
the kernel, or an error.

One source, two bodies, chosen by :func:`choose_body` from the launch's
dtype, D and config — never by trying one and falling back; a build
compiles one of them (``-DWGMMA``). Both read 16-byte chunks (TMA, or
``uint4`` loads), so :func:`launch` refuses operands that do not start on
16-byte boundaries rather than choose a body for them:

* ``"wgmma"``: bfloat16 at D = 128 with whole warpgroups of 16 rows a warp
  (``block_q`` 64 or 128, ``threads == 2 * block_q``) and ``block_k`` 64 or
  128: TMA loads through a two-stage mbarrier ring, both products on
  ``wgmma``.
* ``"mma"``: every other launch — float32 on the CUDA cores, bfloat16 on
  ``mma.sync``.

So four configs of the space run ``wgmma`` in bfloat16 at D = 128, the
default among them, and the tuner picks between bodies through the configs
it already has. :data:`BODY_LAUNCHES` counts the launches of each body.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import KernelBuilder, Workload, register
from repro_torch.core.builder import dtype_name, probe_array
from repro_torch.core.device import GPU_H100
from repro_torch.obs import runtime as obs

from . import flash_attention_bwd as _bwd
from . import ref as _ref
from ._build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
kernel = CudaKernel("flash_attention", "flash_attention.cu",
                    "flash_attention_launch",
                    (_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P))


def kernel_of(config) -> CudaKernel:
    """The CUDA kernel a launch in ``config`` runs."""
    return kernel

#: Head dims the kernel takes, and the card's tests check: 128 (the LM
#: slice's), 256, 384 and 512. ``ops.flashable`` admits any multiple of
#: 128; ``ops.attention`` sends a larger one to the plain version.
HEAD_DIMS = (128, 256, 384, 512)
#: (q/k head dim, v head dim) pairs of unequal dims the kernel takes: MLA's
#: (d_nope + d_rope, d_v) of DeepSeek-V2.
SPLIT_DIMS = ((192, 128),)
#: Most threads a block may have.
_MAX_THREADS = 1024
#: The config a launch runs when the card refuses the selected one at the
#: launch's head dim, by dtype: each fits at every D of :data:`HEAD_DIMS`
#: in the ``mma`` body and lies in the space.
FIT_CONFIGS = {"bfloat16": {"block_q": 64, "block_k": 64, "threads": 128},
               "float32": {"block_q": 32, "block_k": 32, "threads": 64}}
#: The head dim the space's shared-memory restriction is checked at.
SPACE_HEAD_DIM = 128
#: Grid extent CUDA allows on the y axis, where the flattened heads go.
_MAX_GRID_Y = 65535
#: Depth of the wgmma body's k/v ring.
WGMMA_STAGES = 2
#: Launches of each body, counted where the kernel launches, as
#: ``kernel.launches`` counts them all; zeroed with it by
#: ``_build.reset_launch_counts``.
BODY_LAUNCHES = kernel.body_launches


def takes_dims(head_dim: int, v_dim: int) -> bool:
    """Whether the kernel takes q/k head dim ``head_dim`` with v head dim
    ``v_dim``."""
    return ((head_dim == v_dim and head_dim in HEAD_DIMS)
            or (head_dim, v_dim) in SPLIT_DIMS)


def choose_body(dtype: str, head_dim: int, config,
                v_dim: int | None = None) -> str:
    """The body a launch runs: the rule, stated once. ``"wgmma"`` for
    bfloat16 at D = 128 (or q/k 192 with v 128) with whole warpgroups of
    16 rows a warp (``block_q`` 64 or 128, ``threads == 2 * block_q``)
    and a key tile ``wgmma`` takes (``block_k`` 64 or 128); ``"mma"``
    otherwise."""
    dims = (head_dim, head_dim if v_dim is None else v_dim)
    if (dtype == "bfloat16" and dims in ((128, 128), (192, 128))
            and config["block_q"] in (64, 128)
            and config["threads"] == 2 * config["block_q"]
            and config["block_k"] in (64, 128)):
        return "wgmma"
    return "mma"


def smem_bytes(config, body: str, head_dim: int, dtype: str,
               v_dim: int | None = None) -> int:
    """Dynamic shared memory of one block, as ``csrc/flash_attention.cu``
    lays it out. mma: the Q tile and one K and one V tile, rows padded.
    wgmma: 1024 bytes of alignment slack, the Q tile, two stages of K and
    V tiles (unpadded, 128-byte swizzled), and five mbarriers."""
    bq, bk = config["block_q"], config["block_k"]
    dv = head_dim if v_dim is None else v_dim
    if body == "wgmma":
        return (1024 + (bq * head_dim + WGMMA_STAGES * bk * (head_dim + dv))
                * 2 + (2 * WGMMA_STAGES + 1) * 8)
    if dtype == "bfloat16":
        return ((bq + bk) * (head_dim + 8) + bk * (dv + 8)) * 2
    return ((bq + bk) * (head_dim + 1) + bk * (dv + 1)) * 4


def launch_threads(config, body: str, head_dim: int,
                   v_dim: int | None = None) -> int:
    """Threads a block launches: ``threads``, or in the ``mma`` body at
    an output head dim above 256 ``threads * Dv / 128`` (one warp a row
    group and 128-wide slice of the output)."""
    dv = head_dim if v_dim is None else v_dim
    if body == "mma" and dv > 256:
        return config["threads"] * (dv // 128)
    return config["threads"]


def card_refusal(config, body: str, head_dim: int, dtype: str,
                 v_dim: int | None = None) -> str:
    """Why the H100 would refuse ``config`` in ``body``, or ``""``."""
    smem = smem_bytes(config, body, head_dim, dtype, v_dim)
    if smem > GPU_H100.smem_per_block:
        return (f"{body} body needs {smem} bytes of shared memory at D = "
                f"{head_dim} in {dtype}, above the "
                f"{GPU_H100.smem_per_block} a block may have")
    threads = launch_threads(config, body, head_dim, v_dim)
    if threads > _MAX_THREADS:
        return (f"{body} body launches {threads} threads a block at D = "
                f"{head_dim}, above the {_MAX_THREADS} a block may have")
    return ""


def fit_config(config, head_dim: int, dtype: str, v_dim: int | None = None):
    """``config``, or :data:`FIT_CONFIGS`'s for ``dtype`` where the card
    would refuse ``config`` at ``head_dim``: the selection hook, so a
    config chosen for another scenario (or the default, whose float32
    tiles overflow shared memory above D 256) never reaches a launch it
    cannot make. A config the caller forces is launched as it is."""
    dv = head_dim if v_dim is None else v_dim
    if dtype not in FIT_CONFIGS or not takes_dims(head_dim, dv) or \
            not card_refusal(config, choose_body(dtype, head_dim, config,
                                                 dv), head_dim, dtype, dv):
        return config
    return dict(FIT_CONFIGS[dtype])


def fits_card(config) -> bool:
    """The space's restriction: the card takes ``config`` at
    :data:`SPACE_HEAD_DIM` in either dtype, in the body each selects."""
    return not any(
        card_refusal(config, choose_body(dt, SPACE_HEAD_DIM, config),
                     SPACE_HEAD_DIM, dt) for dt in ("float32", "bfloat16"))


def row_l2_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative L2 error of one output row (one query of one
    head): ``|got - want| / |want|`` over the head dim, in float64. A row
    that ``want`` leaves at 0 (fully masked) counts its error's norm."""
    g = got.to(torch.float64).reshape(-1, got.shape[-1])
    w = want.to(torch.float64).reshape(-1, want.shape[-1])
    den = w.norm(dim=-1)
    return float(((g - w).norm(dim=-1) / torch.where(den > 0, den, 1.0))
                 .max())


#: The largest :func:`row_l2_error` a kernel output may have against the
#: plain version, besides the tuner's allclose. The allclose scales its
#: atol by max|ref|, which causal rows near the start (a copy of one v row)
#: set far above the late rows' values, so it cannot see a fault confined
#: to late rows; this bound can. bfloat16: rounding P and the output to
#: 8-bit mantissas gives errors of a few 1e-3 a row.
ROW_L2_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def defines(config, causal: bool, head_dim: int,
            body: str, v_dim: int | None = None) -> tuple[tuple[str, int],
                                                           ...]:
    """The -D defines of the build that runs ``body``; ``V_DIM`` only
    where v's head dim differs from q's and k's."""
    out = (("BLOCK_Q", config["block_q"]), ("BLOCK_K", config["block_k"]),
           ("THREADS", config["threads"]), ("CAUSAL", int(causal)),
           ("HEAD_DIM", head_dim), ("WGMMA", int(body == "wgmma")))
    if v_dim is not None and v_dim != head_dim:
        out += (("V_DIM", v_dim),)
    return out


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q (BH, S, D), k (BHkv, S, D) and v (BHkv, S, Dv) are
    contiguous float32 or bfloat16 tensors of one dtype and device, with
    BH a multiple of BHkv and (D, Dv) a pair the kernel takes
    (:func:`takes_dims`)."""
    if q.dim() != 3 or k.dim() != 3 or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"flash attention needs q (BH, S, D), k (BHkv, S, "
                         f"D) and v (BHkv, S, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    bhkv = k.shape[0]
    if tuple(k.shape[1:]) != (s, d):
        raise ValueError(f"k/v rows {tuple(k.shape[1:])} differ from q's "
                         f"{(s, d)}")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or \
            len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash attention operands differ in dtype or device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention operands must be contiguous")
    if bhkv < 1 or bh % bhkv or s < 1:
        raise ValueError(f"flash attention: BH={bh} is not a multiple of "
                         f"BHkv={bhkv}, or S={s} is empty")
    if not takes_dims(d, v.shape[2]):
        raise ValueError(f"flash attention takes head dims {HEAD_DIMS} "
                         f"and the (q/k, v) pairs {SPLIT_DIMS}, got "
                         f"{(d, v.shape[2])}")


def launch(config, q, k, v, scale: float | None = None, *,
           causal: bool) -> torch.Tensor:
    """Attention over flattened heads: the CUDA kernel with ``config`` on
    CUDA tensors, the plain version on CPU tensors, the output's shape on
    ``meta`` tensors (nothing launches). ``scale`` None is D^-0.5, which
    the kernel computes itself."""
    check_args(q, k, v)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref_factory(causal)(q, k, v, scale=scale)
    if q.device.type == "meta":       # shapes only, as every meta op
        return q.new_empty(q.shape[:2] + v.shape[2:])
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: the kernel runs on CUDA tensors, "
                         f"got a {q.device.type} tensor")
    bh, s, d = q.shape
    if bh > _MAX_GRID_Y or bh * s * d >= 2**31 or \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash attention problem {(bh, k.shape[0], s, d)} "
                         f"outside the kernel's range, or an operand not "
                         f"16-byte aligned")
    dtype = dtype_name(q.dtype)
    dv = v.shape[2]
    body = choose_body(dtype, d, config, dv)
    o = q.new_empty((bh, s, dv))
    kernel(defines(config, causal, d, body, dv), dtype, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, k.shape[0], s, d,
           dv, 0.0 if scale is None else float(scale),
           torch.cuda.current_stream(q.device).cuda_stream, body=body)
    return o


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention under autograd. The forward is ``kernel``'s launch
    (a :class:`WisdomKernel` of either builder, so selection, online
    trials, capture and telemetry see it as any launch). The backward is
    ``bwd_kernel``'s launch (a :class:`WisdomKernel` of a
    ``flash_attention_bwd`` builder: the hand-written backward kernel)
    where :func:`flash_attention_bwd.takes` the tensors, bfloat16 at head
    dim 128; otherwise the gradient of the plain version
    (``ref.flash_attention_bwd_ref_factory``: ``ref.attention_ref`` over
    the flattened heads, recomputed from the saved inputs). The reference
    has no backward kernel: its training forward differentiates the plain
    function. On CPU tensors both kernels run their plain versions, so the
    host exercises the same wiring as the card.

    ``ctx`` saves the inputs q, k, v, never the kernel's output, so under
    ``torch.utils.checkpoint`` a recompute launches the kernel again. A
    ``scale`` (MLA's) goes to the kernel as its fourth argument; such a
    call, and v narrower than q, take the plain recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, kernel, bwd_kernel, causal: bool,
                scale: float | None = None):
        ctx.save_for_backward(q, k, v)
        ctx.bwd_kernel = bwd_kernel
        ctx.causal = causal
        ctx.scale = scale
        return kernel(q, k, v) if scale is None else kernel(q, k, v, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with obs.span("attn_backward", "model", grad_out.device):
            if ctx.scale is None and v.shape == k.shape and _bwd.takes(q):
                dq, dk, dv = ctx.bwd_kernel(q, k, v, grad_out.contiguous())
            else:
                dq, dk, dv = _ref.flash_attention_bwd_ref_factory(
                    ctx.causal)(q, k, v, grad_out, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def through_flash_fn(out: torch.Tensor) -> bool:
    """Whether ``out``'s gradient passes through :class:`FlashAttentionFn`
    (behind the views ``ops.attention`` ends with)."""
    fn = out.grad_fn
    while fn is not None:
        if getattr(fn, "_forward_cls", None) is FlashAttentionFn:
            return True
        fn = fn.next_functions[0][0] if fn.next_functions else None
    return False


def _make_builder(causal: bool) -> KernelBuilder:
    name = "flash_attention_causal" if causal else "flash_attention_full"
    b = KernelBuilder(name, source="repro_torch.kernels.flash_attention")
    b.tune("block_q", (32, 64, 128, 256), default=64)
    b.tune("block_k", (32, 64, 128), default=64)
    b.tune("threads", (64, 128, 256), default=128)
    # 16 or 32 query rows per warp
    b.restriction("block_q * 32 in (16 * threads, 32 * threads)")
    # two m16 tiles per warp hold scores and output in registers only up
    # to 64-key tiles
    b.restriction("block_q * 32 == 16 * threads or block_k <= 64")
    b.restriction(fits_card)

    @b.problem_size
    def _problem(q, k, v, scale=None):
        bh, s, d = q.shape
        problem = (int(bh), int(k.shape[0]), int(s), int(d))
        return problem if v.shape[2] == d else problem + (int(v.shape[2]),)

    @b.build
    def _build(config, problem, meta):
        d, dv = problem[3], problem[-1]
        if not takes_dims(d, dv):
            raise ValueError(f"{name}: head dims {(d, dv)} are not one of "
                             f"{HEAD_DIMS} or {SPLIT_DIMS}")
        # nvcc: the JIT step, for the body this scenario's dtype selects
        body = choose_body(meta[0].dtype, d, config, dv)
        lib = (kernel.load(defines(config, causal, d, body, dv))
               if meta[0].device.type == "cuda" else None)

        def run(q, k, v, scale=None):
            return launch(config, q, k, v, scale, causal=causal)

        run.library = lib
        return run

    b.reference(_ref.flash_attention_ref_factory(causal))

    @b.fit
    def _fit(config, problem, dtype):
        return fit_config(config, problem[3], dtype, problem[-1])

    @b.workload
    def _workload(config, problem, dtype):
        """Two products of D multiply-adds for each (query, key) pair the
        output needs: S^2 pairs a head, S(S+1)/2 causal (the reference
        counts the diagonal tiles whole, the same count at one key a
        tile). The compulsory
        traffic reads q, k, v once and writes o once; the reference streams
        k/v once per query block, as a TPU must from its VMEM, where on the
        H100 the other query blocks' k/v reads hit the 50 MB L2.
        ``vmem_bytes`` is a block's shared memory in the body
        :func:`choose_body` picks, ``grid`` the blocks launched. For the
        cost model, ``mxu_tile`` is a block's (block_q, block_k, D) and
        ``unroll_ways`` the tiles in flight (the wgmma body's two-stage
        ring, one for mma); ``reuse`` stays 1, as the k/v re-reads are L2
        hits. Invalid where :func:`launch` would refuse the problem or the
        card the config. At unequal dims (``problem[4]`` = Dv) Q.K^T
        takes D and P.V Dv multiply-adds a pair; q, k move D elements a
        row and v, o Dv."""
        bh, bhkv, s, d = problem[:4]
        dv = problem[-1] if len(problem) == 5 else d
        body = choose_body(dtype, d, config, dv)
        byt = 4 if dtype == "float32" else 2
        pairs = s * (s + 1) / 2 if causal else float(s * s)
        valid = (dtype in ("float32", "bfloat16") and takes_dims(d, dv)
                 and bhkv >= 1 and bh % bhkv == 0 and s >= 1
                 and bh <= _MAX_GRID_Y and bh * s * d < 2**31
                 and not card_refusal(config, body, d, dtype, dv))
        return Workload(
            flops=2.0 * bh * (d + dv) * pairs,
            hbm_bytes=float((bh + bhkv) * s * (d + dv) * byt),
            vmem_bytes=smem_bytes(config, body, d, dtype, dv),
            grid=-(-s // config["block_q"]) * bh,
            mxu_tile=(config["block_q"], config["block_k"], d),
            unroll_ways=2 if body == "wgmma" else 1, valid=valid)

    @b.probe
    def _probe(problem, dtype):
        bh, bhkv, s, d = problem[:4]
        rng = np.random.default_rng(0)
        scale = 1.0 / (d ** 0.5)
        return (probe_array(rng, (bh, s, d), dtype, scale),
                probe_array(rng, (bhkv, s, d), dtype, scale),
                probe_array(rng, (bhkv, s, problem[-1]), dtype, scale))

    register(b)
    return b


causal_builder = _make_builder(True)
full_builder = _make_builder(False)
