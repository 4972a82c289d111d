"""Nested-dict trees: the port's stand-in for JAX pytrees.

Parameters and decode caches are nested ``dict``s (and ``list``s, as in
the ResNet's ``stages``) whose leaves are tensors (or, for axis metadata,
ints), laid out exactly like the reference's unboxed pytrees so the two
packages can be compared leaf by leaf. A list element's path is its
index, e.g. ``stages/1/0/conv1``; tuples are leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or other.keys() != tree.keys():
                raise ValueError(f"tree structures differ: {sorted(tree)} vs "
                                 f"{sorted(other) if isinstance(other, dict) else other!r}")
        return {k: tree_map(fn, tree[k], *(o[k] for o in rest)) for k in tree}
    if isinstance(tree, list):
        for other in rest:
            if not isinstance(other, list) or len(other) != len(tree):
                raise ValueError(f"tree structures differ: a list of "
                                 f"{len(tree)} vs {other!r:.80}")
        return [tree_map(fn, x, *(o[i] for o in rest))
                for i, x in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in key order; paths look like ``a/b/c``."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from tree_leaves(x, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def tree_unbind(tree: Dict) -> List[Dict]:
    """The layers of a stacked tree, from one ``unbind(0)`` per leaf:
    every layer is a view, and the backward of each leaf's unbind is one
    stack of the layer gradients."""
    parts = tree_map(lambda x: x.unbind(0), tree)
    n = len(next(tree_leaves(parts))[1])
    return [tree_map(lambda xs: xs[i], parts) for i in range(n)]
