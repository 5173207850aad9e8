"""The port's state trees: NamedTuples, tuples and lists (the statistics
of a product family are a plain tuple) over tensor leaves. One copy of
each walk, for every layer from the mesh up."""

import torch


def tree_map(fn, tree):
    """fn over the tensor leaves of a tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    items = [tree_map(fn, t) for t in tree]
    return type(tree)(*items) if hasattr(tree, '_fields') else tuple(items)


def tree_map2(fn, a, b):
    """fn over the paired tensor leaves of two trees of one structure."""
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    items = [tree_map2(fn, x, y) for x, y in zip(a, b)]
    return type(a)(*items) if hasattr(a, '_fields') else tuple(items)


def tree_where(mask, a, b):
    """a where the chain's mask (C,) is set, else b, leaf by leaf."""
    return tree_map2(lambda x, y: torch.where(
        mask.view((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


def tree_leaves(tree):
    """The tensor leaves of a tree, in field order; raises TypeError on a
    leaf that is not a tensor."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    raise TypeError(f'a state leaf must be a tensor, not '
                    f'{type(tree).__name__}')


def first_leaf(tree):
    """The first tensor leaf of a tree."""
    while not isinstance(tree, torch.Tensor):
        tree = tree[0]
    return tree


def cast_floats(tree, dtype):
    """Cast the floating leaves of a tree to `dtype`."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def on_device(tree, device):
    """A tree of tensors on `device` (itself where it lies there)."""
    return tree_map(lambda t: t.to(device), tree)
