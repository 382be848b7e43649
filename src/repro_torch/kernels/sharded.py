"""Attention on ``DTensor``s (a step under a device mesh): each rank
attends its own batch rows and heads.

Attention is independent across batch rows and across kv heads (with
their query group), so where q, k and v agree on how the batch and the
heads are split and every split is even (:func:`shared_placements`),
each rank runs the plain function, or the flash kernel, on its own
shards, as the reference's partitioner does. Where they do not, the
callers leave the ops to ``DTensor`` as they are: nothing is replicated
here to make a step run.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor, Replicate, Shard


def _shared(ps):
    """The placement every one of ``ps`` is, if it is a replica or a shard
    of dim 0 (batch) or 1 (heads); else None."""
    p = ps[0]
    if all(x == p for x in ps) and (
            isinstance(p, Replicate) or isinstance(p, Shard) and p.dim < 2):
        return p
    return None


def shared_placements(*tensors) -> tuple | None:
    """The placements ``tensors`` share when, on every mesh dim, all are
    replicated or all are sharded on the batch or on the heads, and the
    ranks that split a dim divide it in every tensor; else None. Only then
    do a rank's q heads map onto its own kv heads: ``DTensor`` chunks an
    uneven dim unevenly, and 4 kv heads over 16 ranks would leave a rank
    q heads whose kv heads another rank holds."""
    out = tuple(_shared(ps) for ps in zip(*(t.placements for t in tensors)))
    if None in out:
        return None
    mesh = tensors[0].device_mesh
    ways = {0: 1, 1: 1}                 # ranks splitting the batch, heads
    for i, p in enumerate(out):
        if isinstance(p, Shard):
            ways[p.dim] *= mesh.size(i)
    if any(t.shape[d] % n for t in tensors for d, n in ways.items()):
        return None
    return out


def local_attention(fn, q, *kv, **kw):
    """``fn(q, *kv, **kw)`` on each rank's shards, wrapped as a ``DTensor``
    of the same placements, when q and ``kv`` are ``DTensor``s that share
    their batch and head split; None otherwise (the caller then runs
    ``fn`` on the ``DTensor``s). ``to_local``/``from_local`` carry the
    gradient."""
    if not isinstance(q, DTensor):
        return None
    placements = shared_placements(q, *kv)
    if placements is None:
        return None
    out = fn(q.to_local(), *(t.to_local() for t in kv), **kw)
    return DTensor.from_local(out, q.device_mesh, placements,
                              run_check=False)
