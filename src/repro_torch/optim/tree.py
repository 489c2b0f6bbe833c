"""Nested dicts of tensors as the port's pytrees.

Leaves are visited in sorted key order, the order ``jax.tree_util`` gives a
dict, so sums over leaves (the global gradient norm) add in the reference's
order.  A list (xLSTM's per-layer dicts) is visited in index order, its
items named by index (``layers/0``, ``layers/1``, ..., ``layers/10``), as
``jax.tree_util`` visits a list.
"""
from __future__ import annotations

from typing import Callable, Iterator, Mapping


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise to ``tree`` and the trees of ``rest`` (same
    keys), as a new nested dict (lists stay lists)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def _children(tree):
    if isinstance(tree, Mapping):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), t) for i, t in enumerate(tree)]


def tree_items(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(``"a/b/c"`` path, leaf) pairs: dict keys in sorted order, list items
    in index order."""
    for k, child in _children(tree):
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(child, (Mapping, list)):
            yield from tree_items(child, name)
        else:
            yield name, child


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_build(items) -> dict:
    """The nested dict of ``("a/b/c", leaf)`` pairs (``tree_items``'s
    inverse): a node whose keys are exactly ``"0"`` .. ``"n-1"`` becomes a
    list."""
    out: dict = {}
    for name, value in items:
        *path, last = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value
    return _lists(out)


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(map(str, range(len(node)))):
        return [node[str(i)] for i in range(len(node))]
    return node
