"""Loops whose iterations all cost the same, written so a counter can fold
them by their trip count (the HLO walker's rule for a scan).

A counter that folds loops (``roofline.op_count.OpCounter(fold_loops=True)``,
on ``meta`` tensors only) pushes itself on :data:`FOLDING`; a loop written
``for i in loop(n)`` then runs its body once (index 0) and the counter
counts everything it does ``n`` times. With no such counter every
iteration runs, so the train step's microbatch loop is written so without
depending on the counter.
"""

from __future__ import annotations

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
