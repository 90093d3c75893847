"""Carries generator weights between the JAX package's parameter trees and
the port's modules.

The port names its parameters and buffers after the JAX tree paths
(`edge2.conv_w1.kernel` [in, out], `edge1.bn_w1.mean`, ...), so the carry is
a rename with no transpose, both ways. This is not the reference `.pth`
layout, which comes in a later slice.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str, out: dict) -> None:
    for name, v in tree.items():
        key = f"{prefix}{name}"
        if isinstance(v, Mapping):
            _flatten(v, key + ".", out)
        else:
            out[key] = torch.from_numpy(np.array(v, dtype=np.float32))


def generator_state_from_jax(g_params: Mapping, g_stats: Mapping
                             ) -> "OrderedDict[str, torch.Tensor]":
    """State dict for `nn.Generator.load_state_dict(..., strict=True)` from
    the nested numpy dicts of the JAX `g_params` and `g_stats`
    (`batch_stats`) trees."""
    out: dict = {}
    _flatten(g_params, "", out)
    _flatten(g_stats, "", out)
    return OrderedDict(sorted(out.items()))


def generator_trees(generator: torch.nn.Module) -> Tuple[dict, dict]:
    """The inverse carry: nested numpy dicts (g_params, g_stats) in the JAX
    tree layout from a port `Generator`'s parameters and buffers."""
    def nest(named) -> dict:
        tree: dict = {}
        for name, t in named:
            *path, leaf = name.split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = t.detach().cpu().numpy().copy()
        return tree
    return (nest(generator.named_parameters()),
            nest(generator.named_buffers()))
