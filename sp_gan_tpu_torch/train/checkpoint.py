"""Checkpoints in the JAX package's layout, the port's side of
`sp_gan_tpu/train/checkpoint.py`.

A checkpoint is a pickle of `{"state": ..., "epoch": int}` whose state
holds numpy trees under the JAX tree paths: `g_params`, `g_stats`,
`d_params`, `d_stats`, `g_ema` (None without `--ema`) and `step`. So
`load_generator` (and the port's serving, `manipulate.from_checkpoint`)
reads the JAX package's checkpoints and the port's alike. The port's
training checkpoints add one key of their own, `"torch"`: the two Adam
`state_dict`s and the step generator's state, on the CPU. Resuming from a
JAX checkpoint's optax state is not ported yet.

Writes are atomic (a temporary file, then `os.replace`). Unpickling runs
code from the file: read only checkpoints this project wrote.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from sp_gan_tpu_torch.compat import nest, state_from_jax, trees

CKPT_PREFIX = "ckpt_epoch_"


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The `ckpt_epoch_{n}.pkl` of highest n in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith(CKPT_PREFIX) and f.endswith(".pkl")]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len(CKPT_PREFIX):-4]))
    return os.path.join(ckpt_dir, cands[-1])


def load_generator(path: str, use_ema: bool = False) -> Tuple[dict, dict]:
    """(g_params, g_stats) nested numpy dicts of a checkpoint; with
    `use_ema` the EMA weights in place of g_params."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    state = blob["state"]
    params = state["g_params"]
    if use_ema:
        if state.get("g_ema") is None:
            raise ValueError(f"{path} holds no EMA weights "
                             "(trained without --ema)")
        params = state["g_ema"]
    return params, state["g_stats"]


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_cpu(v) for v in obj]
    return obj


def save_checkpoint(ckpt_dir: str, state, epoch: int, cfg=None,
                    filename: Optional[str] = None) -> str:
    """Writes `state` (a `train.state.TrainState`) as
    `ckpt_dir/ckpt_epoch_{epoch}.pkl` (or `filename`), and `config.json`
    beside it when `cfg` is given. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    g_params, g_stats = trees(state.G)
    d_params, d_stats = trees(state.D)
    blob = {
        "state": {
            "g_params": g_params, "g_stats": g_stats,
            "d_params": d_params, "d_stats": d_stats,
            "g_ema": (nest(state.g_ema.named_parameters())
                      if state.g_ema is not None else None),
            "step": np.int32(state.step),
        },
        "epoch": int(epoch),
        "torch": {"g_opt": _to_cpu(state.g_opt.state_dict()),
                  "d_opt": _to_cpu(state.d_opt.state_dict()),
                  "gen": state.gen.get_state()},
    }
    path = os.path.join(ckpt_dir, filename or f"{CKPT_PREFIX}{epoch}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)      # a crash never leaves a torn checkpoint
    if cfg is not None:
        tmp = os.path.join(ckpt_dir, "config.json.tmp")
        with open(tmp, "w") as f:
            f.write(cfg.to_json())
        os.replace(tmp, os.path.join(ckpt_dir, "config.json"))
    return path


def load_checkpoint(path: str, state) -> int:
    """Restores a checkpoint that `save_checkpoint` wrote into `state` in
    place (weights, statistics, EMA, step, both Adams and the step
    generator); returns its epoch."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    st = blob["state"]
    if "torch" not in blob:
        raise ValueError(f"{path} has no optimizer state of the port; "
                         "resuming from a JAX checkpoint is not ported yet")
    state.G.load_state_dict(state_from_jax(st["g_params"], st["g_stats"]))
    state.D.load_state_dict(state_from_jax(st["d_params"], st["d_stats"]))
    if state.g_ema is not None:
        ema = st["g_ema"] if st.get("g_ema") is not None else st["g_params"]
        _, g_stats = trees(state.G)
        state.g_ema.load_state_dict(state_from_jax(ema, g_stats))
    state.g_opt.load_state_dict(blob["torch"]["g_opt"])
    state.d_opt.load_state_dict(blob["torch"]["d_opt"])
    state.gen.set_state(blob["torch"]["gen"])
    state.step = int(st["step"])
    return int(blob["epoch"])
