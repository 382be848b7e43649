"""Loops whose iterations all cost the same, written so a counter can fold
them by their trip count (the HLO walker's rule for a scan).

A counter that folds loops (``roofline.op_count.OpCounter(fold_loops=True)``,
on ``meta`` tensors only) pushes itself on :data:`FOLDING`; a loop written
``for i in loop(n)`` then runs its body once (index 0) and the counter
counts everything it does ``n`` times. With no such counter every
iteration runs, so the train step's microbatch loop is written so without
depending on the counter.

The microbatch loop's backward runs inside its body. A model's chunk loop
(:func:`scan`) is recorded by autograd and differentiated after it, so a
folded one runs its first step as it is and brackets its second with two
markers whose backward raises the counter's scale by ``n - 1`` before
that step's backward and lowers it after: autograd runs one device's
nodes in the reverse order of their creation, so the step's backward
falls between them and is counted for every later step too.
"""

from __future__ import annotations

import torch

#: Counters folding loops, innermost last; each has a float ``scale`` that
#: multiplies what it counts.
FOLDING: list = []


def loop(n: int):
    """``range(n)``, or index 0 alone with the innermost folding counter's
    ``scale`` multiplied by ``n`` while the body runs."""
    if not FOLDING or n <= 1:
        yield from range(n)
        return
    c = FOLDING[-1]
    c.scale *= n
    try:
        yield 0
    finally:
        c.scale /= n


class _Rescale(torch.autograd.Function):
    """Identity on tensors; its backward multiplies the innermost folding
    counter's scale by ``factor``."""

    @staticmethod
    def forward(ctx, factor, *ts):
        ctx.factor = factor
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        if FOLDING:
            FOLDING[-1].scale *= ctx.factor
        return (None, *grads)


class _Pieces(torch.autograd.Function):
    """The first, second and last of ``n`` equal pieces of ``t`` along
    ``dim``, views; the backward joins the first's gradient, ``n - 2``
    copies of the second's and the last's (zeros where one has none), as
    the backward of splitting ``t`` into the ``n`` pieces of an unfolded
    scan joins theirs."""

    @staticmethod
    def forward(ctx, n, dim, t):
        size = t.shape[dim] // n
        ctx.n, ctx.dim = n, dim
        return (t.narrow(dim, 0, size), t.narrow(dim, size, size),
                t.narrow(dim, (n - 1) * size, size))

    @staticmethod
    def backward(ctx, g0, g1, g2):
        return None, None, torch.cat([g0] + [g1] * (ctx.n - 2) + [g2],
                                     dim=ctx.dim)


class _Reuse(torch.autograd.Function):
    """Identity; the backward adds its gradient up ``n`` times, as autograd
    sums the gradients of a tensor that each of ``n`` unfolded steps
    reads."""

    @staticmethod
    def forward(ctx, n, t):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        out = grad
        for _ in range(ctx.n - 1):
            out = out + grad
        return None, out


class _Join(torch.autograd.Function):
    """``first``, ``n`` copies of ``mid`` and ``last`` joined along ``dim``
    (a folded scan's second output standing for the middle steps'); the
    backward passes a view of the gradient to each, as the join of the
    unfolded steps' outputs passes views."""

    @staticmethod
    def forward(ctx, n, dim, first, mid, last):
        ctx.n, ctx.dim = n, dim
        ctx.sizes = (first.shape[dim], mid.shape[dim], last.shape[dim])
        return torch.cat([first] + [mid] * n + [last], dim=dim)

    @staticmethod
    def backward(ctx, grad):
        s0, s1, s2 = ctx.sizes
        end = s0 + ctx.n * s1
        return (None, None, grad.narrow(ctx.dim, 0, s0),
                grad.narrow(ctx.dim, s0, s1), grad.narrow(ctx.dim, end, s2))


def _recorded(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.requires_grad
            and torch.is_grad_enabled())


def _marked(factor, tensors):
    """``tensors`` with those autograd records passed through one
    :class:`_Rescale` node (the rest as they are)."""
    idx = [i for i, t in enumerate(tensors) if _recorded(t)]
    out = list(tensors)
    if idx:
        marked = _Rescale.apply(factor, *(tensors[i] for i in idx))
        for i, t in zip(idx, marked):
            out[i] = t
    return out


def scan(n: int, step, carry: tuple, xs: tuple = (), seqs: tuple = (),
         dim: int = 0):
    """``step(i, carry, *xs, *pieces) -> (carry, out)`` for i in
    ``range(n)``, where ``pieces`` are the i-th of ``n`` equal pieces of
    each of ``seqs`` along ``dim`` and ``xs`` are read whole by every
    step; returns the last carry (a tuple of tensors) and the outputs
    joined along ``dim`` (None where ``step`` gives None). Every step must
    cost the same.

    Under a folding counter (``n`` > 3) the first and the last step run
    as they are (the first's carry starts from a fresh value, the last's
    is the loop's result) and step 1 is counted for steps 1 to ``n - 2``,
    its backward too where autograd records it; its output stands for
    theirs (``meta`` tensors: shapes only), and the gradients the unfolded
    loop would join (the pieces') or sum (``xs``') are joined and summed
    as often. ``step`` takes every tensor autograd records through
    ``carry``, ``xs`` and ``seqs``, never from a closure, so the markers
    bracket its backward."""
    if n == 0:
        return carry, None
    if not FOLDING or n <= 3:
        pieces = [x.split(x.shape[dim] // n, dim) for x in seqs]
        outs = []
        for i in range(n):
            carry, out = step(i, carry, *xs, *(p[i] for p in pieces))
            outs.append(out)
        return carry, (None if outs[0] is None else torch.cat(outs, dim))
    m = n - 2
    split = [_Pieces.apply(n, dim, x) if _recorded(x) else
             (lambda p: (p[0], p[1], p[-1]))(x.split(x.shape[dim] // n, dim))
             for x in seqs]
    first, mid, last = ([p[i] for p in split] for i in range(3))
    carry, out0 = step(0, carry, *xs, *first)
    k, nx = len(carry), len(xs)
    reused = [_Reuse.apply(m, x) if _recorded(x) else x for x in xs]
    marked = _marked(1.0 / m, [*carry, *reused, *mid])    # backward: last
    grad = any(_recorded(t) for t in marked)
    c = FOLDING[-1]
    c.scale *= m
    try:
        carry, out = step(1, tuple(marked[:k]), *marked[k:k + nx],
                          *marked[k + nx:])
    finally:
        c.scale /= m
    if grad:
        marked = _marked(float(m), [*carry, out])         # backward: first
        carry, out = tuple(marked[:k]), marked[k]
    carry, out2 = step(n - 1, carry, *xs, *last)
    return carry, (None if out is None
                   else _Join.apply(m, dim, out0, out, out2))
