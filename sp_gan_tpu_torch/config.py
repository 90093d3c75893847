"""Typed experiment configuration and the training CLI's flags, the port's
own copy of `sp_gan_tpu/config.py` (`Config`, `build_argparser`,
`parse_args`).

Every field and default is the JAX package's, so a `config.json` written by
either package loads in the other, and the CLIs take the same flags. Fields that steer only the JAX/TPU
program (`remat`, `mesh_*`, `data_axis`, `points_axis`, `use_pallas`,
`fused_*`, `donate_state`, `steps_per_call`, `watchdog_secs`) are accepted
and ignored by the port; `knn_mode="approx"` is rejected where it would
change the result (see `nn/generator.py`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class Config:
    # --- data ---
    data_root: str = "data"
    choice: str = "Chair"
    np: int = 2048                     # points per cloud
    bs: int = 24
    scale: float = 1.0
    augment: bool = False
    workers: int = 2
    con: bool = False
    cls: int = 2
    template: Optional[str] = None     # .xyz sphere template; default fibonacci

    # --- model ---
    nk: int = 20                       # kNN graph size; generator uses nk//2
    nz: int = 128                      # latent dim
    nv: float = 0.2                    # latent noise std
    off: bool = False                  # output += sphere points
    attn: bool = False                 # self-attention on the 640-d features
    use_head: bool = False             # pc_head lift 3->128 before EdgeConv1
    eql: bool = False                  # equalized-lr head/global layers
    z_norm: bool = False               # z normalized to the unit sphere
    small_d: bool = False
    n_rand: bool = False               # per-point iid z instead of tiled
    n_mix: bool = False

    # --- GAN objective ---
    gan: str = "ls"
    flip_d: bool = False
    flip_g: bool = False
    lambda_gp: float = 10.0
    mix: bool = False
    mix_emd_iters: int = 50
    gp_mapping: bool = False
    gp_emd_iters: int = 300

    # --- optimization ---
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.99
    lr_decay: bool = False
    lr_decay_feq: int = 40
    lr_decay_rate: float = 0.7
    use_sgd: bool = False
    max_epoch: int = 6000
    ema: bool = False
    ema_rate: float = 0.999

    # --- bookkeeping ---
    log_dir: str = "log"
    snapshot: int = 50
    restore: bool = False
    pretrain_model_G: Optional[str] = None
    pretrain_model_D: Optional[str] = None
    save: bool = False
    seed: int = 123

    # --- precision and program knobs ---
    dtype: str = "mixed_edge"          # mixed_edge: bf16 only inside the
                                       # EdgeBlocks' [B,N,k,*] tensors
    remat: bool = False                # JAX only
    mesh_shape: Sequence[int] = (1,)   # JAX only
    mesh_axes: Sequence[str] = ("data",)  # JAX only
    data_axis: Optional[str] = None    # JAX only
    points_axis: Optional[str] = None  # JAX only
    use_pallas: bool = True            # JAX only
    fused_train: bool = False          # JAX only
    fused_dphase: bool = False         # JAX only
    fused_eval: bool = False           # JAX only
    edge1_b1: bool = True              # EdgeConv1 at batch 1, broadcast
    bn_stats: str = "global"
    pool_commute: bool = True
    nan_guard: bool = False
    watchdog_secs: int = 0             # JAX only
    donate_state: bool = True          # JAX only
    log_every: int = 10
    steps_per_call: int = 8            # JAX only
    steps_per_epoch: Optional[int] = None
    eval_every: int = 0
    eval_size: int = 64
    eval_emd: bool = False
    fpd_weights: Optional[str] = None
    fpd_stats: Optional[str] = None
    track_best: bool = True
    knn_mode: str = "exact"            # "approx" is not ported yet
    knn_window: int = 512

    def __post_init__(self):
        if self.bn_stats not in ("global", "per_shard"):
            raise ValueError(f"bn_stats must be global|per_shard, "
                             f"got {self.bn_stats!r}")
        if self.knn_mode not in ("exact", "approx"):
            raise ValueError(f"knn_mode must be exact|approx, "
                             f"got {self.knn_mode!r}")
        allowed = ("mixed_edge", "float32", "bfloat16", "bfloat16_g",
                   "bfloat16_d", "bfloat16_tail32")
        if self.dtype not in allowed:
            raise ValueError(f"dtype must be one of {allowed}, "
                             f"got {self.dtype!r}")

    @property
    def g_bf16(self) -> bool:
        """Generator trunk/head compute in bf16."""
        return self.dtype in ("bfloat16", "bfloat16_g", "bfloat16_tail32")

    @property
    def d_bf16(self) -> bool:
        """Discriminator trunk compute in bf16 (its head stays f32)."""
        return self.dtype in ("bfloat16", "bfloat16_d", "bfloat16_tail32")

    @property
    def g_tail_f32(self) -> bool:
        """The generator's output MLP stays f32 under bf16."""
        return self.dtype == "bfloat16_tail32"

    @property
    def bn_groups(self) -> int:
        """BatchNorm statistic groups: the JAX package's per-shard groups
        (`bn_stats="per_shard"` over a mesh). The one-card port trains
        with one group; `make_train_step` refuses more until the
        data-parallel slice."""
        if self.bn_stats == "per_shard" and self.data_axis is None:
            g = 1
            for d in self.mesh_shape:
                g *= int(d)
            return max(1, g)
        return 1

    @property
    def k(self) -> int:
        """Neighbors the generator uses."""
        return self.nk // 2

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(d["mesh_shape"])
        d["mesh_axes"] = list(d["mesh_axes"])
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        d["mesh_shape"] = tuple(d.get("mesh_shape", (1,)))
        d["mesh_axes"] = tuple(d.get("mesh_axes", ("data",)))
        known = {f.name for f in dataclasses.fields(Config)}
        return Config(**{k: v for k, v in d.items() if k in known})


def _add_bool(p: argparse.ArgumentParser, name: str, default: bool) -> None:
    p.add_argument(f"--{name}", action=argparse.BooleanOptionalAction,
                   default=default)


def build_argparser() -> argparse.ArgumentParser:
    """The training CLI's flags, one per `Config` field with the same name,
    type and default as the JAX package's (`--flag/--no-flag` for
    booleans). The JAX-only knobs (`steps_per_call`, `donate_state`,
    `use_pallas`, `remat`, `mesh_*`, `fused_*`, `watchdog_secs`) are
    accepted and have no effect in the port."""
    c = Config()
    p = argparse.ArgumentParser(description="sp_gan_tpu_torch")
    for f in dataclasses.fields(Config):
        default = getattr(c, f.name)
        if f.name in ("mesh_shape", "mesh_axes"):
            p.add_argument(f"--{f.name}", nargs="+", default=list(default),
                           type=int if f.name == "mesh_shape" else str)
        elif isinstance(default, bool):
            _add_bool(p, f.name, default)
        elif default is None:
            p.add_argument(f"--{f.name}", default=None)
        else:
            p.add_argument(f"--{f.name}", type=type(default), default=default)
    return p


def config_from_namespace(ns: argparse.Namespace) -> Config:
    """A `Config` from parsed flags; keys that are not fields are
    dropped."""
    known = {f.name for f in dataclasses.fields(Config)}
    d = {k: v for k, v in vars(ns).items() if k in known}
    d["mesh_shape"] = tuple(d["mesh_shape"])
    d["mesh_axes"] = tuple(d["mesh_axes"])
    if d.get("steps_per_epoch") is not None:
        d["steps_per_epoch"] = int(d["steps_per_epoch"])
    return Config(**d)


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    return config_from_namespace(build_argparser().parse_args(argv))
