"""Pytree leaves in the JAX package's order, for the training step and the
checkpoint (counterpart of what `jax.tree.leaves` / `jax.tree.unflatten`
do for piquant_tpu/train.py and piquant_tpu/utils/checkpoint.py).

A tree is a dict (its keys sorted, as JAX sorts them), a list or tuple (a
namedtuple too), None (no leaves), a `QuantizedLinear` or
`QuantizedExpertStack` (its data, scale, zero point, s_chunk and z_chunk,
in the reference's `tree_flatten` order, None skipped), or a leaf: any
other value, a tensor as a rule.  So a params tree of the port and its JAX
counterpart list the same leaves in the same order."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

from piquant_tpu_torch.quant.linear import (QuantizedExpertStack,
                                           QuantizedLinear)

_QUANT_CHILDREN = ("data", "scale", "zero_point", "s_chunk", "z_chunk")


def _children(node) -> Tuple[list, Callable[[list], Any]]:
    """A node's children and how to rebuild it from new ones; None for a
    leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return ([node[k] for k in keys],
                lambda ch: type(node)(zip(keys, ch)))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node), lambda ch: type(node)(*ch)
    if isinstance(node, (list, tuple)):
        return list(node), lambda ch: type(node)(ch)
    if node is None:
        return [], lambda ch: None
    if isinstance(node, (QuantizedLinear, QuantizedExpertStack)):
        return ([getattr(node, f) for f in _QUANT_CHILDREN],
                lambda ch: dataclasses.replace(
                    node, **dict(zip(_QUANT_CHILDREN, ch))))
    return None


def flatten(tree) -> Tuple[List[Any], Callable[[Sequence[Any]], Any]]:
    """(the tree's leaves in order, a function that rebuilds the tree's
    structure around new leaves)."""
    leaves: List[Any] = []

    def walk(node):
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            return lambda it: next(it)
        children, rebuild = kids
        subs = [walk(c) for c in children]
        return lambda it: rebuild([s(it) for s in subs])

    build = walk(tree)

    def unflatten(new: Sequence[Any]):
        new = list(new)
        if len(new) != len(leaves):
            raise ValueError(f"{len(new)} leaves for a tree of "
                             f"{len(leaves)}")
        return build(iter(new))

    return leaves, unflatten


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable[[Any], Any], tree):
    """The tree with fn applied to each leaf."""
    ls, unflatten = flatten(tree)
    return unflatten([fn(x) for x in ls])
