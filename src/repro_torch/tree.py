"""Nested-dict parameter trees, flattened in the order `jax.tree` uses.

The JAX package keeps parameters as nested dicts, and `jax.tree.flatten`
visits dict keys in sorted order. That order decides which elements share
a 1024-element scale row in a comm bucket, so the port flattens the same
way. A leaf is any value that is not a dict; `None` counts as a leaf here
(JAX would drop it), so per-leaf optional state keeps its slot.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[str, ...]


def flatten(tree, prefix: Path = ()) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves) in sorted-key order."""
    if not isinstance(tree, dict):
        return [prefix], [tree]
    paths, leaves = [], []
    for k in sorted(tree):
        p, l = flatten(tree[k], prefix + (k,))
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
    return out


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
    paths, ls = flatten(tree)
    others = [flatten_up_to(paths, r) for r in rest]
    return unflatten(paths, [fn(*xs) for xs in zip(ls, *others)])


def keystr(path: Path) -> str:
    """`jax.tree_util.keystr` of a dict-key path: "['gen']['fc']['w']"."""
    return "".join(f"[{k!r}]" for k in path)
