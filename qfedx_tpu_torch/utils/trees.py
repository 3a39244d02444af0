"""Whole-tree helpers over the port's nested dicts of tensors.

Counterpart of ``qfedx_tpu/utils/trees.py`` (a copy: the port imports
nothing of the JAX package). A parameter tree is a dict whose values are
tensors or dicts of the same kind, keyed like the reference's pytree;
leaves are visited in sorted-key order, the order ``jax.tree.leaves``
gives a dict.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure, visiting the
    leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, a)


def global_norm_sq(tree: Tree) -> torch.Tensor:
    """Squared ℓ2 norm across the whole tree. Use this (not
    ``global_norm(t)**2``) inside differentiated code: sqrt at 0 has an
    infinite gradient."""
    return sum(torch.sum(torch.square(x)) for x in tree_leaves(tree))


def global_norm(tree: Tree) -> torch.Tensor:
    """ℓ2 norm across the whole tree."""
    return torch.sqrt(global_norm_sq(tree))
