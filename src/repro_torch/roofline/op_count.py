"""Per-chip FLOPs, bytes and collective bytes of an eager step: the port's
counterpart of ``repro.roofline.hlo_parse`` (the reference's trip-count
aware HLO walker), with the walker's keys.

There is no compiled program to read, so :class:`OpCounter` is a
``TorchDispatchMode`` that watches the step run and adds up each op it
sees, on the **local** tensors: an op on ``DTensor``s is handed back to
``DTensor`` (the mode returns ``NotImplemented``), which redistributes its
inputs and runs the op on this rank's shards, and the mode counts those
collectives and local ops. (A mode that counted the ``DTensor`` op would
count the global op; ``DTensor``'s own shape inference runs on
``FakeTensor``s, which the mode skips.)

  * flops — matrix products exactly (2·M·N·K, from
    ``torch.utils.flop_counter``'s registry); pointwise ops one op per
    output element and reductions one per input element, as the walker's
    ``_ELEMENTWISE_1`` and ``reduce``;
  * bytes — each op's tensor inputs plus outputs (views and allocations
    move nothing). Eager runs no fusion, so every op's traffic is real:
    ``bytes == bytes_upper``, where the walker's ``bytes`` leaves out
    traffic inside a fusion;
  * collectives — output bytes of each ``_c10d_functional`` all-reduce,
    all-gather, reduce-scatter and all-to-all, by the walker's kind names
    (``collective-permute`` stays 0; eager ``DTensor`` issues none), also
    added to bytes as the walker adds them. On a mesh of the ``cpu``
    device type (the fake production meshes) ``DTensor`` turns a
    shard-to-shard all-to-all into an all-gather and a chunk, so it is
    counted as the all-gather it issues.

The hand-written kernels launch through ``ctypes``, where no dispatch
mode sees them. A kernel launch on a CUDA tensor, or its stand-in on a
``meta`` one, adds the launch's ``@builder.workload`` flops and
compulsory bytes instead (``core.wisdom_kernel.LAUNCH_OBSERVERS``), the
numbers ``prof.profile_from_workload`` reads; on CPU tensors the plain
version runs and its ops are counted as any.

:func:`loop` (``core.trip_count``) is the walker's trip-count rule:
under a counter made with ``fold_loops=True`` a loop written
``for i in loop(n)`` runs its body once and counts it ``n`` times. The
train step's microbatch loop is written so; a CPU test holds the folded
count to the full one. Folding runs 1/n of the loop's work, so a folding
counter takes ``meta`` tensors only and raises on any other.
"""

from __future__ import annotations

import sys
import time
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import trip_count, wisdom_kernel

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "var", "std", "var_mean", "norm",
               "linalg_vector_norm", "cumsum", "cumprod", "_softmax",
               "_log_softmax", "topk", "sort", "argmax", "argmin", "any",
               "all"}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_wrap_tensor_autograd", "wait_tensor", "sym_size",
               "sym_stride", "sym_numel", "is_same_size",
               "_local_scalar_dense", "set_"}


class FoldOnRealData(RuntimeError):
    """A counter folding loops saw a tensor that is not ``meta``."""


class CountTimeout(RuntimeError):
    """The counted step ran past the counter's ``limit_s``."""


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


#: Modules between an op's caller and the counter: the dispatch mode
#: itself and the wrappers torch puts around internal functions.
_PASS_THROUGH = ("repro_torch.roofline.op_count", "torch.utils._python_dispatch",
                 "torch._ops", "torch._compile", "torch._dynamo")


def _called_from_dtensor() -> bool:
    """Whether the op being counted was called by ``DTensor``'s own code
    (its placement and sharding math), not by the step."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if not name.startswith(_PASS_THROUGH):
            return name.startswith("torch.distributed.tensor")
        f = f.f_back
    return False


def _numel(x) -> int:
    return sum(t.numel() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside ``with OpCounter() as c:``; read
    :meth:`result`. ``launches`` counts the kernel launches whose workload
    was added, by builder name. ``fold_loops``: fold each
    ``core.trip_count.loop`` by its trip count; only on ``meta`` tensors,
    since a folded loop does 1/n of its work (a folded microbatch loop
    would train on one microbatch), so any other tensor raises
    :class:`FoldOnRealData`. ``limit_s``: raise :class:`CountTimeout`
    once the block has run that long."""

    def __init__(self, fold_loops: bool = False,
                 limit_s: float | None = None):
        super().__init__()
        self.fold_loops = fold_loops
        self.limit_s = limit_s
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0.0 for k in _COLLECTIVES}
        self.launches: Counter = Counter()
        self.scale = 1.0
        self._t0 = 0.0
        self._ops = 0

    def __enter__(self):
        self._t0 = time.monotonic()
        wisdom_kernel.LAUNCH_OBSERVERS.append(self._on_launch)
        if self.fold_loops:
            trip_count.FOLDING.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        if self.fold_loops:
            trip_count.FOLDING.remove(self)
        wisdom_kernel.LAUNCH_OBSERVERS.remove(self._on_launch)
        return super().__exit__(*exc)

    def result(self) -> dict:
        coll = dict(self.collectives)
        coll["total"] = sum(coll[k] for k in _COLLECTIVES)
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_upper": self.bytes, "collectives": coll}

    def _on_launch(self, builder, config, problem, dtype) -> None:
        w = builder.make_workload(config, problem, dtype)
        self.flops += w.flops * self.scale
        self.bytes += w.hbm_bytes * self.scale
        self.launches[builder.name] += self.scale

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented      # DTensor splits it into local ops
        try:
            out = func(*args, **kwargs)
        except Exception as e:
            e.add_note(f"in {func} on local tensors " + ", ".join(
                f"{tuple(t.shape)}/{t.stride()}" for t in flat
                if isinstance(t, torch.Tensor)))
            raise
        if not any(isinstance(a, FakeTensor) for a in flat):
            self._count(func, args, kwargs, flat, out)
        return out

    def _count(self, func, args, kwargs, flat_in, out) -> None:
        self._ops += 1
        if self.limit_s is not None and self._ops % 256 == 0 \
                and time.monotonic() - self._t0 > self.limit_s:
            raise CountTimeout(f"counting ran past {self.limit_s:.0f} s")
        name = func.__name__.split(".")[0]
        ns = func.namespace
        s = self.scale
        if ns in ("_c10d_functional", "_dtensor", "c10d_functional") \
                and name in _COLLECTIVE_OPS:
            nb = sum(_nbytes(t) for t in tree_leaves(out))
            self.collectives[_COLLECTIVE_OPS[name]] += nb * s
            self.bytes += nb * s
            return
        if func.is_view or name in _NO_TRAFFIC:
            return
        if self.fold_loops:
            # DTensor's own bookkeeping (the mesh's rank map, the
            # tensors its shape inference starts from) is host views and
            # allocations, which do no work and are passed above, and
            # host tensors its placement code makes (the shard offsets of
            # a view that joins two sharded dims), passed here
            real = [t.device for t in (*flat_in, *tree_leaves(out))
                    if isinstance(t, torch.Tensor) and t.device.type != "meta"]
            if real and _called_from_dtensor():
                return
            if real:
                raise FoldOnRealData(
                    f"a counter folding loops takes meta tensors only; "
                    f"{func} ran on {real[0]}")
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out) * s
        elif torch.Tag.pointwise in func.tags:
            self.flops += _numel(out) * s
        elif name in _REDUCTIONS:
            self.flops += sum(t.numel() for t in flat_in
                              if isinstance(t, torch.Tensor)) * s
        self.bytes += (sum(_nbytes(t) for t in flat_in)
                       + sum(_nbytes(t) for t in tree_leaves(out))) * s


def op_cost_analysis(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and return its per-chip cost:
    ``{"flops", "bytes", "bytes_upper", "collectives": {kind: bytes, ...,
    "total"}}``, the walker's keys."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.result()
