"""Parameter trees: nested dicts of tensors, flattened in JAX's order.

``jax.tree`` flattens a dict in sorted key order; these helpers do the
same, so a tree's leaf order -- and with it every ``core.flatbuf`` slot
offset -- matches the JAX package leaf for leaf (the MLP lays out as
``b1, b2, w1, w2``).  Anything that is not a dict is a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """Structure of a tree: None for a leaf, else sorted keys + children."""
    keys: tuple | None = None
    children: tuple = ()


def tree_flatten(tree: PyTree) -> tuple[list, TreeDef]:
    if not isinstance(tree, dict):
        return [tree], TreeDef()
    keys = tuple(sorted(tree))
    leaves, children = [], []
    for k in keys:
        sub, td = tree_flatten(tree[k])
        leaves += sub
        children.append(td)
    return leaves, TreeDef(keys, tuple(children))


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    it = iter(leaves)

    def build(td):
        if td.keys is None:
            return next(it)
        return {k: build(c) for k, c in zip(td.keys, td.children)}

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def flatten_up_to(treedef: TreeDef, tree: PyTree) -> list:
    """Leaves of ``tree``, which must have the structure ``treedef``."""
    leaves, td = tree_flatten(tree)
    if td != treedef:
        raise ValueError("tree structure does not match the layout")
    return leaves


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves, td = tree_flatten(tree)
    others = [flatten_up_to(td, r) for r in rest]
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])
