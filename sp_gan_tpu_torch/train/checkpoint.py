"""Reads the JAX package's checkpoints, the port's side of
`sp_gan_tpu/train/checkpoint.py`.

A checkpoint is a pickle of `{"state": ..., "epoch": int}` whose state holds
numpy arrays only, so plain `pickle` reads it without JAX. Unpickling runs
code from the file: read only checkpoints this project wrote.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

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
    """(g_params, g_stats) nested numpy dicts of a JAX checkpoint; with
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
