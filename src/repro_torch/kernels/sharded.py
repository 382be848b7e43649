"""Attention on ``DTensor``s (a step under a device mesh): each rank
attends its own batch rows and heads.

Attention is independent across batch rows and across kv heads (with
their query group), so where q, k and v agree on how the batch and the
heads are split and every split is even (:func:`shared_placements`),
each rank runs the plain function, or the flash kernel, on its own
shards, as the reference's partitioner does. Grouped-query attention
whose q heads split where the kv heads cannot (8 kv heads over 16 ranks)
runs per shard too when each rank's q heads share one kv head: the rank
takes that head from its whole kv (:func:`gqa_kv_head`), a slice that
moves no bytes, as the partitioner slices a replicated operand. Where
neither holds, the callers leave the ops to ``DTensor``, after
:func:`gather_heads` where q splits heads that the kv tensors do not
(decode against a cache split on the sequence): nothing else is
replicated here to make a step run.
"""

from __future__ import annotations

import math

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


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


def gqa_kv_head(q, *kv) -> tuple[int, int] | None:
    """(mesh dim, kv head) when q and ``kv`` split the batch alike and
    evenly, q alone splits its heads on one mesh dim (``kv`` whole there),
    evenly, and this rank's q heads all read one kv head: that head's
    index. None otherwise."""
    mesh = q.device_mesh
    pk = kv[0].placements
    if any(t.placements != pk for t in kv):
        return None
    hq, hkv = q.shape[1], kv[0].shape[1]
    split = [i for i, (a, b) in enumerate(zip(q.placements, pk))
             if a == Shard(1) and b == Replicate()]
    rest_ok = all(a == b and (a == Replicate() or a == Shard(0))
                  for i, (a, b) in enumerate(zip(q.placements, pk))
                  if i not in split)
    if len(split) != 1 or not rest_ok or hq % hkv:
        return None
    i = split[0]
    ways = math.prod(mesh.size(j) for j, a in enumerate(q.placements)
                     if a == Shard(0))
    per_rank = hq // mesh.size(i)
    if hq % mesh.size(i) or (hq // hkv) % per_rank or any(
            t.shape[0] % ways for t in (q, *kv)):
        return None
    return i, mesh.get_coordinate()[i] * per_rank // (hq // hkv)


def local_attention(fn, q, *kv, **kw):
    """``fn(q, *kv, **kw)`` on each rank's shards, wrapped as a ``DTensor``
    of q's placements, when q and ``kv`` are ``DTensor``s that share their
    batch and head split, or whose split :func:`gqa_kv_head` takes (each
    rank then passes its one kv head; its gradient is a partial sum over
    the ranks that read it); None otherwise (the caller then runs ``fn``
    on the ``DTensor``s). ``to_local``/``from_local`` carry the
    gradient."""
    if not isinstance(q, DTensor):
        return None
    if shared_placements(q, *kv) is not None:
        local = [t.to_local() for t in kv]
    else:
        head = gqa_kv_head(q, *kv)
        if head is None:
            return None
        i, j = head
        grad = tuple(Partial() if d == i else p
                     for d, p in enumerate(kv[0].placements))
        local = [t.to_local(grad_placements=grad)[:, j:j + 1] for t in kv]
    out = fn(q.to_local(), *local, **kw)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def gather_heads(q, kv):
    """``q`` with its heads gathered on each mesh dim where it splits them
    and ``kv`` (a cache split on the sequence there) does not: the side of
    the two whose redistribution moves fewer bytes, one token's queries
    against a whole cache. ``q`` itself where nothing differs, or for a
    plain tensor."""
    if not isinstance(q, DTensor) or not isinstance(kv, DTensor):
        return q
    pl = tuple(Replicate() if a == Shard(1) and b != a else a
               for a, b in zip(q.placements, kv.placements))
    return q if pl == tuple(q.placements) else q.redistribute(
        q.device_mesh, pl)


def per_shard(fn, args, roles, out_roles):
    """``fn(*args)`` on each rank's shards, for an ``fn`` that treats every
    batch row and every head on its own (a recurrence over the sequence,
    the rwkv state): ``roles[i]`` is (batch dim, head dim) of ``args[i]``,
    None where it has none, and ``out_roles`` the same for each output.

    Takes the call when the ``DTensor`` arguments split, on each mesh dim,
    either nothing, or the batch, or the heads, and every split is even;
    an argument that lacks the split dim (the per-head bonus on the data
    axis) is whole there. An argument whose placement differs is first
    redistributed to the one the call needs. Returns the outputs as
    ``DTensor``s, or None (plain tensors, or a split ``fn`` does not
    allow), in which case the caller runs ``fn`` on what it has."""
    lead = next((a for a, (b, h) in zip(args, roles)
                 if isinstance(a, DTensor) and b is not None
                 and h is not None), None)
    if lead is None:
        return None
    ri = next(r for a, r in zip(args, roles) if a is lead)
    kinds = []           # per mesh dim: None, 0 (batch) or 1 (heads)
    for p in lead.placements:
        if p == Replicate():
            kinds.append(None)
        elif isinstance(p, Shard) and p.dim in ri:
            kinds.append(ri.index(p.dim))
        else:
            return None
    mesh = lead.device_mesh

    def placements(role):
        return tuple(Replicate() if k is None or role[k] is None
                     else Shard(role[k]) for k in kinds)

    local = []
    for a, role in zip(args, roles):
        if not isinstance(a, DTensor):
            if any(k is not None and role[k] is not None for k in kinds):
                return None
            local.append(a)
            continue
        pl = placements(role)
        if any(isinstance(p, Shard) and a.shape[p.dim] % mesh.size(i)
               for i, p in enumerate(pl)):
            return None
        local.append((a if tuple(a.placements) == pl
                      else a.redistribute(mesh, pl)).to_local())
    outs = fn(*local)
    return tuple(DTensor.from_local(o, mesh, placements(role),
                                    run_check=False)
                 for o, role in zip(outs, out_roles))
