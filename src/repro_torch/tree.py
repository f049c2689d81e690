"""Nested-dict parameter trees, flattened in ``jax.tree_util`` order
(dict keys sorted), so leaf order and ravel order match the reference."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def paths(tree, prefix: str = "") -> List[str]:
    """'/'-joined key paths of the leaves, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def structure(tree):
    """The tree with every leaf replaced by None (a treedef)."""
    if isinstance(tree, dict):
        return {k: structure(tree[k]) for k in sorted(tree)}
    return None


def unflatten(treedef, items) -> Any:
    return _build(treedef, iter(items))


def _build(node, it):
    # a module-level function: a nested one that calls itself is a
    # reference cycle, which would hold ``items`` (and every leaf) until
    # the garbage collector runs
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


def map(fn: Callable, tree, *rest):  # noqa: A001 — mirrors jax.tree.map
    return unflatten(structure(tree),
                     [fn(*xs) for xs in zip(leaves(tree),
                                            *[leaves(r) for r in rest])])
