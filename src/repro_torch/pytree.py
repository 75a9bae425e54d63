"""Nested containers of tensors, flattened in ``jax.tree.flatten``'s order.

Training state is a tree: dicts of tensors (the parameters), a
NamedTuple (the optimizer state), tuples, and ``None`` for an absent part
(no master weights).  :func:`flatten` lists its leaves in the order JAX
lists them — dict keys sorted, NamedTuple and tuple fields in order,
``None`` holding no leaf — so leaf ``k`` of a checkpoint is the same
array in both packages.  Anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


class _Leaf:
    def __repr__(self) -> str:
        return "*"


LEAF = _Leaf()


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten(tree) -> tuple[list, Any]:
    """(leaves, treedef): the leaves in JAX's order and the structure with
    every leaf replaced by :data:`LEAF`."""
    leaves: list = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(walk(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(walk(x) for x in t)
        leaves.append(t)
        return LEAF
    treedef = walk(tree)
    del walk        # a closure over itself: the cycle would hold the leaves
    return leaves, treedef    # until the collector ran


def unflatten(treedef, leaves) -> Any:
    """The tree of ``treedef``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def walk(t):
        if t is LEAF:
            return next(it)
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if _is_namedtuple(t):
            return type(t)(*(walk(x) for x in t))
        return type(t)(walk(x) for x in t)
    out = walk(treedef)
    del walk        # as in flatten: no cycle holds the leaves
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree) -> Any:
    """The tree with ``fn`` applied to each leaf."""
    flat, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in flat])


def describe(treedef) -> str:
    """The structure as text, in the form of JAX's ``PyTreeDef``: ``*``
    for a leaf."""
    if treedef is LEAF:
        return "*"
    if treedef is None:
        return "None"
    if isinstance(treedef, dict):
        return "{" + ", ".join(f"{k!r}: {describe(v)}"
                               for k, v in treedef.items()) + "}"
    if _is_namedtuple(treedef):
        return type(treedef).__name__ + "(" + ", ".join(
            f"{f}={describe(v)}" for f, v in zip(treedef._fields, treedef)) \
            + ")"
    inner = ", ".join(describe(v) for v in treedef)
    if isinstance(treedef, list):
        return f"[{inner}]"
    return f"({inner},)" if len(treedef) == 1 else f"({inner})"
