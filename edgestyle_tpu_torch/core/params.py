"""Parameter trees and the port's random init.

The port's models are plain functions over nested dicts of tensors, keyed
like the JAX package's Flax param trees (``down_blocks_0.resnets_0.conv1``
...), so ControlLoRA's tied trunk and LoRA merge keep their JAX meaning:
a tree can share tensors with another, and a merged tree is a new dict.

Every forward reads its params through :func:`param` and :func:`sub`.
Given an :class:`InitTree` instead of a dict, the same forward records each
param's shape and init rule on the ``meta`` device (no memory, no compute);
:func:`materialize` then draws the values from an explicit generator. So a
model's structure is written once, in its forward.

Layout of the leaves (see core/porting.py): conv weights OIHW in
``channels_last`` memory format, linear weights (out, in), norms fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


class InitTree(dict):
    """A param tree being recorded: leaves are meta tensors; ``rules`` maps
    each leaf name to (init rule, keep fp32)."""

    def __init__(self):
        super().__init__()
        self.rules: Dict[str, Tuple[str, bool]] = {}


def param(p, name: str, shape, init: str = "lecun", fp32: bool = False) -> torch.Tensor:
    """Read leaf ``name`` of ``p``; when recording, declare it.

    init: 'lecun' (normal, std 1/sqrt(fan_in), fan_in = prod(shape[1:])),
    'zeros', 'ones', 'embed' (normal, std 1/sqrt(shape[1])) or 'normal0.01'.
    ``fp32`` leaves stay fp32 whatever the compute dtype (norm affines).
    """
    if isinstance(p, InitTree):
        if name not in p:
            p[name] = torch.empty(tuple(shape), device="meta")
            p.rules[name] = (init, fp32)
        return p[name]
    return p[name]


def sub(p, name: str):
    """Child subtree ``name`` of ``p`` (created when recording)."""
    if isinstance(p, InitTree):
        if name not in p:
            p[name] = InitTree()
        return p[name]
    return p[name]


def _draw(shape, init: str, gen: torch.Generator, device) -> torch.Tensor:
    if init == "zeros":
        return torch.zeros(shape, device=device)
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "lecun":
        std = 1.0 / math.sqrt(max(1, math.prod(shape[1:])))
    elif init == "embed":
        std = 1.0 / math.sqrt(shape[1])
    elif init == "normal0.01":
        std = 0.01
    else:
        raise ValueError(f"unknown init rule {init!r}")
    return torch.randn(shape, generator=gen, device=device) * std


def materialize(tree: InitTree, gen: torch.Generator, dtype: torch.dtype) -> Dict:
    """Replace every recorded meta leaf with values drawn from ``gen`` (on
    the generator's device), in recording order: the same seed gives the
    same params."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, InitTree):
            out[k] = materialize(v, gen, dtype)
            continue
        init, fp32 = tree.rules[k]
        t = _draw(tuple(v.shape), init, gen, gen.device)
        t = t.to(torch.float32 if fp32 else dtype)
        if t.ndim == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        out[k] = t
    return out


def flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree
