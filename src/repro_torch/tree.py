"""Nested dicts of tensors (the port's parameter and optimizer trees): map
over leaves and list them, in ``jax.tree``'s order (dict keys sorted)."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``; returns a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves, dict keys visited in sorted order (``jax.tree.leaves``'s)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure whose leaves are ``leaves``, in
    ``tree_leaves``'s order (the inverse of ``tree_leaves``)."""
    it = iter(leaves)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(tree[k]) for k in sorted(tree)}
        return next(it)

    return fill(like)
