"""Parameter and state trees: nested dicts and NamedTuples of tensors.

The port's counterpart of the ``jax.tree_util`` calls the training stack
makes, in JAX's leaf order (dict keys sorted, NamedTuple fields in
order, ``None`` holding no leaf), so a path names the same leaf in both
packages (``params/blocks/wq``, ``opt/mu/embed``, ``opt/step``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_path(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], prefix + (str(k),))
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += flatten_with_path(getattr(tree, name), prefix + (name,))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_str(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def map_tree(fn: Callable, tree, *rest):
    """`tree` with every leaf replaced by ``fn(leaf, *matching leaves of
    rest)``; the trees share one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(tree, flat: list):
    """`tree`'s structure with its leaves, in JAX's order, replaced by
    `flat`."""
    it = iter(flat)
    paths = [p for p, _ in flatten_with_path(tree)]
    by_path = {p: next(it) for p in paths}

    def walk(node, prefix):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(walk(getattr(node, f), prefix + (f,)) for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, prefix + (str(i),)) for i, v in enumerate(node))
        return by_path[prefix]

    return walk(tree, ())
