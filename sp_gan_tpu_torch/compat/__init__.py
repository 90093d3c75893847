"""Carries generator and discriminator weights between the JAX package's
parameter trees and the port's modules, and (`torch_export`,
`torch_import`) between those trees and the reference's PyTorch `.pth`
layout.

The port names its parameters and buffers after the JAX tree paths
(`edge2.conv_w1.kernel` [in, out], `edge1.bn_w1.mean`, ...), so the carry
here is a rename with no transpose, both ways. The reference layout
(`head.0.weight` [out, in, 1], `EdgeConv1.conv_out.weight` [out, in, 1, k],
BatchNorm `running_mean`, ...) is a rename with transposes: to write it,
`export_generator(*generator_trees(G), cfg)`; to read it,
`generator_state_from_jax(*convert_generator(sd, cfg))`.
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


def state_from_jax(params: Mapping, stats: Mapping
                   ) -> "OrderedDict[str, torch.Tensor]":
    """State dict for `load_state_dict(..., strict=True)` of a port module
    from the nested numpy dicts of a JAX `params` and `batch_stats`
    tree."""
    out: dict = {}
    _flatten(params, "", out)
    _flatten(stats, "", out)
    return OrderedDict(sorted(out.items()))


def nest(named) -> dict:
    """Nested numpy dicts in the JAX tree layout from (dotted name, tensor)
    pairs."""
    tree: dict = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return tree


def trees(module: torch.nn.Module) -> Tuple[dict, dict]:
    """The inverse carry: (params, batch_stats) nested numpy dicts in the
    JAX tree layout from a port module's parameters and buffers."""
    return nest(module.named_parameters()), nest(module.named_buffers())


# the generator's, the discriminator's and the point-network modules'
# (`nn.pointnet`) carries are the same rename
generator_state_from_jax = discriminator_state_from_jax = state_from_jax
pointnet_state_from_jax = state_from_jax
generator_trees = discriminator_trees = pointnet_trees = trees

from sp_gan_tpu_torch.compat.torch_export import (  # noqa: E402
    export_discriminator, export_generator, save_reference_checkpoint)
from sp_gan_tpu_torch.compat.torch_import import (  # noqa: E402
    convert_dgcnn, convert_discriminator, convert_generator,
    load_dgcnn_weights, load_reference_checkpoint)
