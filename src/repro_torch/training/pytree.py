"""Nested-container walks in ``jax.tree_util``'s order, for the training
modules: dicts by sorted key, lists and tuples in order, ``None`` an empty
node, anything else a leaf.  Flatten order is what ``BucketPlan``'s leaf
indices and the optimizer's per-leaf loops refer to, so it must be the
reference's: a bucket plan of the same tree names the same leaves in both
packages."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["TreeDef", "tree_flatten", "tree_unflatten", "tree_leaves",
           "tree_map", "flatten_up_to"]


class TreeDef:
    """The structure of a flattened tree: ``kind`` is ``"leaf"``,
    ``"none"``, ``"dict"`` (``keys`` sorted), ``"list"`` or ``"tuple"``."""

    __slots__ = ("kind", "keys", "children")

    def __init__(self, kind: str, keys=(), children=()):
        self.kind, self.keys, self.children = kind, tuple(keys), \
            tuple(children)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)


def _walk(tree, out: List[Any]) -> TreeDef:
    if tree is None:
        return TreeDef("none")
    if isinstance(tree, dict):
        keys = sorted(tree)
        return TreeDef("dict", keys, [_walk(tree[k], out) for k in keys])
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return TreeDef(kind, (), [_walk(v, out) for v in tree])
    out.append(tree)
    return TreeDef("leaf")


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    vals = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, vals))
    return vals if td.kind == "list" else tuple(vals)


def tree_unflatten(td: TreeDef, leaves) -> Any:
    leaves = list(leaves)
    if len(leaves) != td.num_leaves:
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{td.num_leaves}")
    return _build(td, iter(leaves))


def flatten_up_to(td: TreeDef, tree) -> List[Any]:
    """``tree``'s subtrees at the leaves of ``td`` (a leaf of ``td`` may
    hold a whole subtree of ``tree``, as an int8 moment's ``{"q", "s"}``
    does under a parameter leaf)."""
    if td.kind == "leaf":
        return [tree]
    if td.kind == "none":
        return []
    if td.kind == "dict":
        if not isinstance(tree, dict) or sorted(tree) != list(td.keys):
            raise ValueError(f"tree does not match the structure: keys "
                             f"{td.keys}")
        parts = [tree[k] for k in td.keys]
    else:
        if not isinstance(tree, (list, tuple)) or \
                len(tree) != len(td.children):
            raise ValueError("tree does not match the structure")
        parts = list(tree)
    out: List[Any] = []
    for c, p in zip(td.children, parts):
        out.extend(flatten_up_to(c, p))
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching subtrees of
    ``rest``), in ``tree``'s structure."""
    leaves, td = tree_flatten(tree)
    others = [flatten_up_to(td, r) for r in rest]
    return tree_unflatten(td, [fn(*a) for a in zip(leaves, *others)])
