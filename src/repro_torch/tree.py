"""Trees of tensors: the port's parameter, gradient, cache and optimizer
trees are nested dicts and lists (tuples read as lists) with tensor, array
or scalar leaves.  A leaf's path is the tuple of dict keys and list
indices from the root."""

from __future__ import annotations


def tree_paths(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] of ``tree``, in insertion order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in tree_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, prefix: tuple = ()):
    """``fn(leaf, path)`` over the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, prefix + (i,))
                for i, v in enumerate(tree)]
    return fn(tree, prefix)


def tree_get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value
