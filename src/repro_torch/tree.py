"""Nested dict / tuple / list trees of tensors (the pytrees of the JAX
package), flattened in ``jax.tree_util``'s order: dict keys sorted,
sequences in order.  ``None`` is an empty subtree, as in JAX."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for x in tree for l in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: v for k, v in
                    ((k, build(node[k])) for k in sorted(node))}
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
