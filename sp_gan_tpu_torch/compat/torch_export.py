"""Writes the JAX-layout parameter trees of a generator and a discriminator
as reference PyTorch checkpoints, the port of
`sp_gan_tpu/compat/torch_export.py` (numpy, byte for byte the same state
dicts). The inverse of `torch_import`. The state dicts load into the
reference's `Generation/Generator.py` and `Discriminator.py` modules with
`strict=True`. The shape map:

  kernel [in, out]            -> Conv1d weight [out, in, 1]   (head, tail,
                                 adain style, attn, D mlps/fc2)
  kernel [in, out]            -> Conv2d 1x1 weight [out, in, 1, 1]
                                 (EdgeBlock conv_w / conv_x)
  out_kernel [k, in, out]     -> conv_out weight [out, in, 1, k]
  kernel [in, out]            -> Linear weight [out, in]      (global_conv,
                                 D head mlp)
  scale/bias + mean/var       -> BatchNorm weight/bias + running_mean/
                                 running_var (+ num_batches_tracked = 0)
  EqualDense kernel           -> `*.conv.weight_orig` / `*.linear.weight_orig`
                                 (EqualLR keeps the unscaled weight and
                                 rescales in its forward, as EqualDense does)

The file format is the reference saver's: {'G_model': state_dict,
'G_epoch': epoch} / {'D_model': ..., 'D_epoch': ...}. A port module's trees
are `compat.generator_trees(G)` / `compat.discriminator_trees(D)`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from sp_gan_tpu_torch.config import Config

Arr = np.ndarray


def _t(x) -> "Arr":
    return np.ascontiguousarray(np.asarray(x))


def _conv1d(out: Dict, prefix: str, entry: Dict, eql: bool = False) -> None:
    w = _t(entry["kernel"]).T[:, :, None]            # [out, in, 1]
    if eql:
        out[f"{prefix}.conv.weight_orig"] = w
        out[f"{prefix}.conv.bias"] = _t(entry["bias"])
    else:
        out[f"{prefix}.weight"] = w
        out[f"{prefix}.bias"] = _t(entry["bias"])


def _linear(out: Dict, prefix: str, entry: Dict, eql: bool = False) -> None:
    w = _t(entry["kernel"]).T                        # [out, in]
    if eql:
        out[f"{prefix}.linear.weight_orig"] = w
        out[f"{prefix}.linear.bias"] = _t(entry["bias"])
    else:
        out[f"{prefix}.weight"] = w
        out[f"{prefix}.bias"] = _t(entry["bias"])


def _conv2d_1x1(out: Dict, prefix: str, entry: Dict) -> None:
    out[f"{prefix}.weight"] = _t(entry["kernel"]).T[:, :, None, None]
    out[f"{prefix}.bias"] = _t(entry["bias"])


def _bn(out: Dict, prefix: str, params: Dict, stats: Dict) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _edge_block(out: Dict, prefix: str, params: Dict, stats: Dict) -> None:
    _conv2d_1x1(out, f"{prefix}.conv_w.0", params["conv_w1"])
    _bn(out, f"{prefix}.conv_w.1", params["bn_w1"], stats["bn_w1"])
    _conv2d_1x1(out, f"{prefix}.conv_w.3", params["conv_w2"])
    _bn(out, f"{prefix}.conv_w.4", params["bn_w2"], stats["bn_w2"])
    _conv2d_1x1(out, f"{prefix}.conv_x.0", params["conv_x"])
    _bn(out, f"{prefix}.conv_x.1", params["bn_x"], stats["bn_x"])
    # out_kernel [k, in, out] -> Conv2d [1, k] weight [out, in, 1, k]
    w = _t(params["out_kernel"]).transpose(2, 1, 0)[:, :, None, :]
    out[f"{prefix}.conv_out.weight"] = np.ascontiguousarray(w)
    out[f"{prefix}.conv_out.bias"] = _t(params["out_bias"])


def export_generator(params: Dict, stats: Dict, cfg: Config) -> Dict[str, Arr]:
    """(params, batch_stats) of our Generator -> reference G state_dict."""
    sd: Dict[str, Arr] = {}
    eql = cfg.eql
    _conv1d(sd, "head.0", params["head1"], eql)
    _conv1d(sd, "head.2", params["head2"], eql)
    if cfg.use_head:
        _conv1d(sd, "pc_head.0", params["pc_head1"], eql)
        _conv1d(sd, "pc_head.2", params["pc_head2"], eql)

    _edge_block(sd, "EdgeConv1", params["edge1"], stats["edge1"])
    _edge_block(sd, "EdgeConv2", params["edge2"], stats["edge2"])
    for name in ("adain1", "adain2"):
        # AdaptivePointNorm's style layer is always plain Conv1d (the
        # reference never passes use_eql into it, Generator.py:25-36)
        sd[f"{name}.style.weight"] = \
            _t(params[name]["style_kernel"]).T[:, :, None]
        sd[f"{name}.style.bias"] = _t(params[name]["style_bias"])

    _linear(sd, "global_conv.0", params["global1"], eql)
    _bn(sd, "global_conv.1", params["global_bn1"], stats["global_bn1"])
    _linear(sd, "global_conv.3", params["global2"], eql)
    _bn(sd, "global_conv.4", params["global_bn2"], stats["global_bn2"])

    if cfg.attn:
        for name in ("theta", "phi", "g", "o"):   # Conv1d, bias=False
            sd[f"attn.{name}.weight"] = \
                _t(params["attn"][name]["kernel"]).T[:, :, None]
        sd["attn.gamma"] = _t(params["attn"]["gamma"]).reshape(())

    _conv1d(sd, "tail.0", params["tail1"])        # tail is always plain
    _conv1d(sd, "tail.2", params["tail2"])
    _conv1d(sd, "tail.4", params["tail3"])
    return sd


def export_discriminator(params: Dict, stats: Dict, cfg: Config
                         ) -> Dict[str, Arr]:
    sd: Dict[str, Arr] = {}
    for i, idx in enumerate((0, 3, 6)):
        _conv1d(sd, f"mlps.{idx}", params[f"mlp{i + 1}"])
        _bn(sd, f"mlps.{idx + 1}", params[f"bn{i + 1}"], stats[f"bn{i + 1}"])
    _conv1d(sd, "fc2.0", params["fc2"])
    _bn(sd, "fc2.1", params["bn_fc2"], stats["bn_fc2"])
    for i, idx in enumerate((0, 2, 4, 6)):
        _linear(sd, f"mlp.{idx}", params[f"head{i + 1}"])
    return sd


def save_reference_checkpoint(g_path: str, g_params: Dict, g_stats: Dict,
                              cfg: Config, epoch: int = 0,
                              d_path: Optional[str] = None,
                              d_params: Optional[Dict] = None,
                              d_stats: Optional[Dict] = None) -> None:
    """Write reference-format `.pth` files (torch-cpu tensors)."""
    import torch

    def _tensors(sd: Dict[str, Arr]) -> Dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}

    torch.save({"G_model": _tensors(export_generator(g_params, g_stats, cfg)),
                "G_epoch": int(epoch)}, g_path)
    if d_path is not None:
        assert d_params is not None and d_stats is not None
        torch.save(
            {"D_model": _tensors(
                export_discriminator(d_params, d_stats, cfg)),
             "D_epoch": int(epoch)}, d_path)
