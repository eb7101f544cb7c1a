"""Walks over parameter trees: nested dicts and lists of tensors."""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import torch


def named_leaves(node, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor of a parameter tree, depth first in
    insertion order; list entries are named by their index."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif isinstance(node, torch.Tensor):
        yield prefix, node


def map_named(fn: Callable[[str, torch.Tensor], object], node, prefix: str = ""):
    """The tree with every tensor ``t`` at path ``p`` replaced by ``fn(p, t)``;
    dicts, lists and tuples keep their shape, anything else stays as it is."""
    if isinstance(node, dict):
        return {k: map_named(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(map_named(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(node))
    if isinstance(node, torch.Tensor):
        return fn(prefix, node)
    return node
