"""Trees of tensors in the reference's leaf order and key paths.

The reference's parameter and optimizer trees are nested dicts, and jax
orders a dict's leaves by sorted key at every level.  The port keeps flat
dicts with dotted names (``{"fc1.w": ..., "fc1.b": ...}``), so a dotted
name is walked as the nested keys it stands for: the leaves of
``{"a.b": x, "a-c": y}`` come in the order of ``{"a": {"b": x}, "a-c": y}``
(``a.b`` first, although ``"a-c" < "a.b"`` as strings).  Lists and tuples
keep their order and name their items ``#i``; a NamedTuple names its fields;
``None`` holds no leaf.  A path is the tuple of those names.
"""
from __future__ import annotations

from typing import Any, Callable


def _parts(key) -> tuple:
    return tuple(key.split(".")) if isinstance(key, str) else (str(key),)


def leaves_with_path(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """Every leaf of ``tree`` with its path, in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree, key=_parts):
            out += leaves_with_path(tree[key], prefix + _parts(key))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for name in tree._fields
                for leaf in leaves_with_path(getattr(tree, name), prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, child in enumerate(tree)
                for leaf in leaves_with_path(child, prefix + (f"#{i}",))]
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable[[tuple, Any], Any], tree: Any, prefix: tuple = ()) -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``; containers
    keep their type and a dict its key order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: map_with_path(fn, value, prefix + _parts(key)) for key, value in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, name), prefix + (name,))
                            for name in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, child, prefix + (f"#{i}",))
                          for i, child in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the leaves at the same paths of
    the trees in ``rest`` (each of ``tree``'s structure)."""
    others = [dict(leaves_with_path(t)) for t in rest]
    return map_with_path(lambda path, leaf: fn(leaf, *(o[path] for o in others)), tree)
