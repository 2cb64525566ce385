"""Nested-dict parameter trees, flattened in the order `jax.tree` uses.

The JAX package keeps parameters as nested dicts, and `jax.tree.flatten`
visits dict keys in sorted order. That order decides which elements share
a 1024-element scale row in a comm bucket, so the port flattens the same
way. Lists are descended in order, as `jax.tree` does (the LM trees keep
unscanned layers and their caches in a list under ``"tail"``); a list
index is an int in a path. A leaf is any value that is neither a dict nor
a list; `None` counts as a leaf here (JAX would drop it), so per-leaf
optional state keeps its slot.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]   # dict keys (str) and list indices (int)


def flatten(tree, prefix: Path = ()) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves) in sorted-key order, lists in index order."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = list(enumerate(tree))
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for k, sub in items:
        p, l = flatten(sub, prefix + (k,))
        paths += p
        leaves += l
    return paths, leaves


def leaves(tree) -> List[Any]:
    return flatten(tree)[1]


def unflatten(paths: List[Path], values) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return _lists(out)


def _lists(node):
    """Turn the int-keyed dicts `unflatten` built back into lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def flatten_up_to(paths: List[Path], tree) -> List[Any]:
    """The entries of `tree` at `paths` (another tree's leaf paths); a
    subtree there (e.g. an EF dict {"e1": ...}) is returned whole."""
    out = []
    for path in paths:
        node = tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` (and the entries of `rest` at the same
    places, whole subtrees included), keeping its structure: empty lists
    stay."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def keystr(path: Path) -> str:
    """`jax.tree_util.keystr` of a path: "['gen']['fc']['w']", "['tail'][0]"."""
    return "".join(f"[{k!r}]" for k in path)
