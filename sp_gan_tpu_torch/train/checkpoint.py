"""Checkpoints in the JAX package's layout, the port's side of
`sp_gan_tpu/train/checkpoint.py`, both ways.

A checkpoint is a pickle of `{"state": ..., "epoch": int}` whose state
holds exactly the fields of the JAX `TrainState`, as numpy trees under the
JAX tree paths:

- `g_params`, `g_stats`, `d_params`, `d_stats`, `g_ema` (None without
  `--ema`) and `step` (int32);
- `g_opt`, `d_opt`: the optax `adam` state as flax's `to_state_dict` lays
  it out, `{"0": {"count": int32, "mu": tree, "nu": tree}, "1": {}}`, with
  `"1": {"count": int32}` (the schedule's step) under `--lr_decay`. torch
  Adam's `exp_avg` and `exp_avg_sq` are `mu` and `nu` under the
  parameters' tree paths, and `count` is the number of updates applied;
- `rng`: a uint32[2] key, the first 8 bytes of the SHA-256 of the step
  generator's state, so it moves with the generator.

So the JAX package restores the port's checkpoints, and the port resumes
from the JAX package's. The port adds one key of its own beside `state`,
`"torch": {"gen": ...}`, the step generator's exact state; a checkpoint
without it (one the JAX package wrote) seeds the generator from the `rng`
key instead, `(key[0] << 32) | key[1]`.

Writes are atomic (a temporary file, then `os.replace`). Unpickling runs
code from the file: read only checkpoints this project wrote.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from sp_gan_tpu_torch.compat import nest, state_from_jax, trees
from sp_gan_tpu_torch.train.state import updates_done

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


def optax_adam_state(opt: torch.optim.Adam, module: torch.nn.Module,
                     lr_decay: bool) -> dict:
    """The optax `adam` state tree of `opt`, which updates `module`."""
    count = np.int32(updates_done(opt))
    moments = {}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        moments[key] = nest(
            (name, opt.state[p][torch_key] if p in opt.state
             else torch.zeros_like(p))
            for name, p in module.named_parameters())
    return {"0": {"count": count, **moments},
            "1": {"count": count} if lr_decay else {}}


def load_optax_adam_state(opt: torch.optim.Adam, module: torch.nn.Module,
                          tree: dict) -> None:
    """Sets `opt`'s per-parameter state from an optax `adam` state tree."""
    adam = tree["0"]
    count = int(adam["count"])
    mu, nu = state_from_jax(adam["mu"], {}), state_from_jax(adam["nu"], {})
    opt.state.clear()
    if count == 0:
        return
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device)}


def rng_key(gen: torch.Generator) -> np.ndarray:
    """uint32[2] key from a generator's state (see the module docstring)."""
    digest = hashlib.sha256(gen.get_state().numpy().tobytes()).digest()
    return np.frombuffer(digest[:8], dtype=np.uint32).copy()


def save_checkpoint(ckpt_dir: str, state, epoch: int, cfg=None,
                    filename: Optional[str] = None) -> str:
    """Writes `state` (a `train.state.TrainState`) as
    `ckpt_dir/ckpt_epoch_{epoch}.pkl` (or `filename`), and `config.json`
    beside it when `cfg` is given (and the schedule's state with
    `cfg.lr_decay`). Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    lr_decay = cfg is not None and cfg.lr_decay
    g_params, g_stats = trees(state.G)
    d_params, d_stats = trees(state.D)
    blob = {
        "state": {
            "g_params": g_params, "g_stats": g_stats,
            "d_params": d_params, "d_stats": d_stats,
            "g_ema": (nest(state.g_ema.named_parameters())
                      if state.g_ema is not None else None),
            "g_opt": optax_adam_state(state.g_opt, state.G, lr_decay),
            "d_opt": optax_adam_state(state.d_opt, state.D, lr_decay),
            "step": np.int32(state.step),
            "rng": rng_key(state.gen),
        },
        "epoch": int(epoch),
        "torch": {"gen": state.gen.get_state()},
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
    """Restores a checkpoint of the port or of the JAX package into
    `state` in place (weights, statistics, EMA, step, both Adams and the
    step generator); returns its epoch."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    st = blob["state"]
    state.G.load_state_dict(state_from_jax(st["g_params"], st["g_stats"]))
    state.D.load_state_dict(state_from_jax(st["d_params"], st["d_stats"]))
    if state.g_ema is not None:
        ema = st["g_ema"] if st.get("g_ema") is not None else st["g_params"]
        _, g_stats = trees(state.G)
        state.g_ema.load_state_dict(state_from_jax(ema, g_stats))
    load_optax_adam_state(state.g_opt, state.G, st["g_opt"])
    load_optax_adam_state(state.d_opt, state.D, st["d_opt"])
    if "torch" in blob:
        state.gen.set_state(blob["torch"]["gen"])
    else:
        key = np.asarray(st["rng"], dtype=np.uint32)
        state.gen.manual_seed((int(key[0]) << 32) | int(key[1]))
    state.step = int(st["step"])
    return int(blob["epoch"])
