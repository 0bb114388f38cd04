"""Parameter trees as nested dicts, walked in sorted-key order (the order
`jax.tree.flatten` gives a dict)."""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_map", "leaves_like"]


def tree_leaves(tree):
    """The leaves of nested dicts, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the same places of `rest`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def leaves_like(like, tree):
    """The entries of `tree` at the leaf places of `like`, in sorted-key
    order (`flatten_up_to`): a leaf of `tree` there may itself be a dict,
    as a factored second moment {"r", "c"} is."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in leaves_like(like[k], tree[k])]
    return [tree]
