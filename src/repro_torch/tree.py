"""Nested dicts, lists and tuples of tensors: the port's parameter trees.

Leaves are visited in `jax.tree_util`'s order (dict keys sorted, sequences
by index), and a leaf's path is its keys and indices joined by "/", the
reference checkpoint format's leaf names. ``None`` and empty containers
hold no leaf, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves", "leaves_with_paths", "map", "unflatten", "structure"]


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """[(path tuple, leaf), ...] in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the structure is kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(template, new_leaves: list) -> Any:
    """``template``'s structure with its leaves replaced, in `leaves` order."""
    paths = [path for path, _ in leaves_with_paths(template)]
    if len(paths) != len(new_leaves):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(paths)}")
    by_path = dict(zip(paths, new_leaves))

    def build(t, prefix):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (i,)) for i, v in enumerate(t))
        return by_path[prefix]
    return build(template, ())


def structure(tree) -> str:
    """The tree's shape with every leaf written ``*``: ``{'a': *, 'b':
    [*, *]}``."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(v)}"
                               for k, v in tree.items()) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return ("(" + ", ".join(structure(v) for v in tree)
                + ("," if len(tree) == 1 else "") + ")")
    return "*"
