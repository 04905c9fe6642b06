"""Parameter trees: nested dicts of tensors, walked in jax tree order.

jax flattens a dict by its SORTED keys, recursively; the port keeps that
order everywhere a tree is flattened (wire.TreeSpec, optimizer state), so
the flat wire buffer lines up coordinate for coordinate with the reference.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[str, ...]


def tree_paths(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in jax tree order (dict keys sorted, depth first)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError("tree_map: trees differ in structure")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_set(tree: dict, path: Path, value: Any) -> None:
    """Set the leaf at ``path`` in a nested dict, creating inner dicts."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
