"""Parameter trees: nested dicts and lists of tensors.

The models keep their parameters as the JAX package keeps its pytrees
(``{"encoder": [{"w": ..., "b": ...}, ...], ...}``), so a checkpoint's
flat key paths and a JAX pytree map onto them one to one.
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result keeps the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
