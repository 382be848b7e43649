"""Trees of tensors: nested dicts and lists, as the port's parameters and
training state are, walked in the order JAX flattens its pytrees (dict
keys sorted, list items by index). The optimiser, the train step and the
checkpoint share it, so a checkpoint's leaves come in the reference's
order and carry its ``a/b/0/c`` paths.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in JAX's flattening order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(leaves_with_paths(sub, f"{prefix}/{key}" if prefix
                                     else key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, values) -> Any:
    """``like``'s structure with its leaves replaced by ``values`` (in
    :func:`leaves` order)."""
    return _build(like, iter(values))


def _build(node, it) -> Any:
    """``node`` rebuilt from the iterator ``it``. A module-level function,
    not a closure over itself: a recursive closure is a reference cycle
    (the function, its cell), which would keep ``it`` and every value in
    it (a train state's tensors) alive until the cycle collector runs."""
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``,
    which must have ``tree``'s structure."""
    flat = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
