"""Trees of tensors: the parts of ``jax.tree`` this package uses.

A tree is nested dicts, tuples, lists and NamedTuples with tensors (or
arrays) at the leaves; ``None`` is an empty subtree.  LM parameters are
dicts of layer-stacked tensors; optimizer states are NamedTuples of such
dicts, whose entries may be tuples (Adafactor's factored moments).
"""
from __future__ import annotations


def tree_map(fn, tree):
    """Apply ``fn`` to the leaves of a tuple/list/dict tree, as
    `jax.tree.map` does: each container keeps its type (a namedtuple is
    rebuilt field by field) and ``None`` is an empty subtree, kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        mapped = [tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*mapped)
        return type(tree)(mapped)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's flattening order: dict keys sorted,
    sequences in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def map_up_to(fn, tree, *rest):
    """``fn`` over the leaves of the dict tree ``tree``, with the matching
    entries of ``rest``: trees of its dict structure whose entries may be
    subtrees (``jax.tree``'s ``flatten_up_to``), such as Adafactor's
    (row, col) moments."""
    if isinstance(tree, dict):
        return {k: map_up_to(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
