"""Small tree helpers for the train tier: the nested dict / list / tuple
containers the reference walks with ``jax.tree`` (metrics, batches,
elastic state), without JAX. Dict keys are visited in sorted order, as
``jax.tree`` does."""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """Every leaf of ``tree`` (anything that is not a dict, list or tuple)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_leaves(fn: Callable, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf, containers kept."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def flatten(tree: Any, is_leaf: Callable[[Any], bool]) -> tuple[list, Any]:
    """``(leaves, spec)``: the leaves for which ``is_leaf`` holds, in
    :func:`leaves` order, and a picklable spec of the rest of the tree
    (containers, and every other leaf kept as a constant) that
    :func:`unflatten` rebuilds the tree from."""
    out: list = []

    def walk(node):
        if isinstance(node, dict):
            return ("dict", [(k, walk(node[k])) for k in sorted(node)])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, [walk(v) for v in node])
        if is_leaf(node):
            out.append(node)
            return ("leaf",)
        return ("const", node)

    return out, walk(tree)


def unflatten(spec: Any, values: list) -> Any:
    """The tree of ``spec`` with its leaves taken from ``values`` in order."""
    it = iter(values)

    def build(node):
        kind = node[0]
        if kind == "dict":
            return {k: build(v) for k, v in node[1]}
        if kind in ("list", "tuple"):
            seq = [build(v) for v in node[1]]
            return seq if kind == "list" else tuple(seq)
        if kind == "leaf":
            return next(it)
        return node[1]

    return build(spec)
