"""Reads reference PyTorch checkpoints into JAX-layout parameter trees,
the port of `sp_gan_tpu/compat/torch_import.py` (numpy, the same trees).
The reference saves `{'G_model': state_dict, ...}` / `{'D_model': ...}`;
its state dict keys map onto the trees so:

  torch Conv1d/Linear weight [out, in(,1)]    -> kernel [in, out]
  torch Conv2d 1x1 weight [out, in, 1, 1]     -> kernel [in, out]
  EdgeBlock conv_out weight [out, in, 1, k]   -> out_kernel [k, in, out]
  BatchNorm{1,2}d weight/bias                 -> scale/bias (params)
           running_mean/running_var           -> mean/var  (batch_stats)
  EqualConv1d/EqualLinear `*.conv.weight_orig` -> EqualDense kernel (the
  sqrt(2/fan_in) rescale happens in the forward, as in EqualLR's hook)

Key layout of the reference modules:
  G: head.{0,2}, pc_head.{0,2}?, EdgeConv{1,2}.{conv_w.{0,1,3,4},
     conv_x.{0,1}, conv_out}, adain{1,2}.style, global_conv.{0,1,3,4},
     attn.{theta,phi,g,o,gamma}?, tail.{0,2,4}
  D: mlps.{0,1,3,4,6,7}, fc2.{0,1}, mlp.{0,2,4,6}

A port module loads the trees through
`compat.generator_state_from_jax(params, stats)` with `strict=True`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from sp_gan_tpu_torch.config import Config


Arr = np.ndarray


def _np(t) -> Arr:
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _dense(sd: Dict, prefix: str, eql: bool = False) -> Dict[str, Arr]:
    """torch Conv1d/Linear (or EqualLR-wrapped) -> {kernel, bias}."""
    if eql:
        w = _np(sd[f"{prefix}.conv.weight_orig"]) if f"{prefix}.conv.weight_orig" in sd \
            else _np(sd[f"{prefix}.linear.weight_orig"])
        b_key = f"{prefix}.conv.bias" if f"{prefix}.conv.bias" in sd \
            else f"{prefix}.linear.bias"
        b = _np(sd[b_key])
    else:
        w = _np(sd[f"{prefix}.weight"])
        b = _np(sd[f"{prefix}.bias"])
    w = w.reshape(w.shape[0], -1)          # drop trailing 1s of conv kernels
    return {"kernel": w.T.copy(), "bias": b}


def _bn(sd: Dict, prefix: str) -> Tuple[Dict[str, Arr], Dict[str, Arr]]:
    params = {"scale": _np(sd[f"{prefix}.weight"]),
              "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def _edge_block(sd: Dict, prefix: str) -> Tuple[Dict, Dict]:
    params, stats = {}, {}
    params["conv_w1"] = _dense(sd, f"{prefix}.conv_w.0")
    params["bn_w1"], stats["bn_w1"] = _bn(sd, f"{prefix}.conv_w.1")
    params["conv_w2"] = _dense(sd, f"{prefix}.conv_w.3")
    params["bn_w2"], stats["bn_w2"] = _bn(sd, f"{prefix}.conv_w.4")
    params["conv_x"] = _dense(sd, f"{prefix}.conv_x.0")
    params["bn_x"], stats["bn_x"] = _bn(sd, f"{prefix}.conv_x.1")
    w = _np(sd[f"{prefix}.conv_out.weight"])        # [out, in, 1, k]
    params["out_kernel"] = w[:, :, 0, :].transpose(2, 1, 0).copy()  # [k,in,out]
    params["out_bias"] = _np(sd[f"{prefix}.conv_out.bias"])
    return params, stats


def _adain(sd: Dict, prefix: str) -> Dict[str, Arr]:
    w = _np(sd[f"{prefix}.style.weight"])
    b = _np(sd[f"{prefix}.style.bias"])
    return {"style_kernel": w.reshape(w.shape[0], -1).T.copy(), "style_bias": b}


def convert_generator(state_dict: Dict, cfg: Config) -> Tuple[Dict, Dict]:
    """Reference G state_dict -> (params, batch_stats) for our Generator."""
    sd = {k[7:] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    eql = cfg.eql
    params: Dict = {}
    stats: Dict = {}

    params["head1"] = _dense(sd, "head.0", eql)
    params["head2"] = _dense(sd, "head.2", eql)
    if cfg.use_head:
        params["pc_head1"] = _dense(sd, "pc_head.0", eql)
        params["pc_head2"] = _dense(sd, "pc_head.2", eql)

    params["edge1"], stats["edge1"] = _edge_block(sd, "EdgeConv1")
    params["edge2"], stats["edge2"] = _edge_block(sd, "EdgeConv2")
    params["adain1"] = _adain(sd, "adain1")
    params["adain2"] = _adain(sd, "adain2")

    params["global1"] = _dense(sd, "global_conv.0", eql)
    params["global_bn1"], stats["global_bn1"] = _bn(sd, "global_conv.1")
    params["global2"] = _dense(sd, "global_conv.3", eql)
    params["global_bn2"], stats["global_bn2"] = _bn(sd, "global_conv.4")

    if cfg.attn:
        a = {}
        for name in ("theta", "phi", "g", "o"):
            w = _np(sd[f"attn.{name}.weight"])
            a[name] = {"kernel": w.reshape(w.shape[0], -1).T.copy()}
        a["gamma"] = _np(sd["attn.gamma"]).reshape(())
        params["attn"] = a

    params["tail1"] = _dense(sd, "tail.0")   # tail is always plain Conv1d
    params["tail2"] = _dense(sd, "tail.2")
    params["tail3"] = _dense(sd, "tail.4")
    return params, stats


def convert_discriminator(state_dict: Dict, cfg: Config) -> Tuple[Dict, Dict]:
    sd = {k[7:] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    params: Dict = {}
    stats: Dict = {}
    for i, idx in enumerate((0, 3, 6)):
        params[f"mlp{i + 1}"] = _dense(sd, f"mlps.{idx}")
        params[f"bn{i + 1}"], stats[f"bn{i + 1}"] = _bn(sd, f"mlps.{idx + 1}")
    params["fc2"] = _dense(sd, "fc2.0")
    params["bn_fc2"], stats["bn_fc2"] = _bn(sd, "fc2.1")
    for i, idx in enumerate((0, 2, 4, 6)):
        params[f"head{i + 1}"] = _dense(sd, f"mlp.{idx}")
    return params, stats


def convert_dgcnn(state_dict: Dict) -> Dict:
    """DGCNN-cls encoder state_dict -> variables for `eval.dgcnn.DGCNNFeat` (its
    flax tree, which `compat.state_from_jax` carries into the port's module).

    The reference's FPD extractor (`GAN_metrics.load_evaluate_model`,
    `Common/GAN_metrics.py:125-182`) is the DGCNN-cls encoder of
    antao97/UnsupervisedPointCloudReconstruction, weights
    `Classify_dgcnn_cls_k40_1024_b32.pkl`. Key layout (after the reference's
    own `module.` strip, `GAN_metrics._load_pretrain`):

      encoder.conv{1..4}.0.weight  Conv2d [out, 2C, 1, 1], bias=False
      encoder.conv{1..4}.1.*       BatchNorm2d
      encoder.conv5.0.weight       Conv1d [feat, 512, 1], bias=False
      encoder.conv5.1.*            BatchNorm1d
      classifier.*                 dropped (the reference drops them too)

    The torch encoder's edge features are ordered (neighbor - central,
    central); ours are (central, neighbor - central), so the first half of
    every edge-conv kernel's input block is swapped with the second.
    """
    sd = {}
    for key, val in state_dict.items():
        k = key[7:] if key.startswith("module.") else key
        if k.startswith("classifier"):
            continue
        if k.startswith("encoder."):
            k = k[len("encoder."):]
        sd[k] = val

    params: Dict = {}
    stats: Dict = {}
    for i in range(1, 5):
        w = _np(sd[f"conv{i}.0.weight"])           # [out, 2C, 1, 1]
        w = w.reshape(w.shape[0], -1)              # [out, 2C]
        C = w.shape[1] // 2
        # torch input rows: (diff, central) -> ours: (central, diff)
        w = np.concatenate([w[:, C:], w[:, :C]], axis=1)
        params[f"conv{i}"] = {"kernel": w.T.copy(),
                              "bias": np.zeros(w.shape[0], np.float32)}
        params[f"bn{i}"], stats[f"bn{i}"] = _bn(sd, f"conv{i}.1")
    w5 = _np(sd["conv5.0.weight"]).reshape(_np(sd["conv5.0.weight"]).shape[0], -1)
    params["conv5"] = {"kernel": w5.T.copy(),
                       "bias": np.zeros(w5.shape[0], np.float32)}
    params["bn5"], stats["bn5"] = _bn(sd, "conv5.1")
    return {"params": params, "batch_stats": stats}


def load_dgcnn_weights(path: str) -> Dict:
    """Load the reference's external DGCNN `.pkl`/`.pth` weights file into
    DGCNNFeat variables (for checkpoint-comparable FPD)."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return convert_dgcnn(blob)


def load_reference_checkpoint(g_path: str, cfg: Config, d_path: str = None):
    """Load reference `.pth` files (torch-cpu) -> ((g_params, g_stats),
    (d_params, d_stats) or None, epoch)."""
    import torch

    blob = torch.load(g_path, map_location="cpu", weights_only=False)
    g = convert_generator(blob["G_model"], cfg)
    epoch = int(blob.get("G_epoch", 0))
    d = None
    if d_path:
        dblob = torch.load(d_path, map_location="cpu", weights_only=False)
        d = convert_discriminator(dblob["D_model"], cfg)
    return g, d, epoch
