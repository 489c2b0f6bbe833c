"""Nested dicts of tensors as the port's pytrees.

Leaves are visited in sorted key order, the order ``jax.tree_util`` gives a
dict, so sums over leaves (the global gradient norm) add in the reference's
order.
"""
from __future__ import annotations

from typing import Callable, Iterator, Mapping


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise to ``tree`` and the trees of ``rest`` (same
    keys), as a new nested dict."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(``"a/b/c"`` path, leaf) pairs in sorted key order."""
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], Mapping):
            yield from tree_items(tree[k], name)
        else:
            yield name, tree[k]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_build(items) -> dict:
    """The nested dict of ``("a/b/c", leaf)`` pairs (``tree_items``'s inverse)."""
    out: dict = {}
    for name, value in items:
        *path, last = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value
    return out
