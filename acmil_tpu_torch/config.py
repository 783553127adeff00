"""Typed configuration, the port of ``acmil_tpu/config.py``.

The same dataclass and the same YAML round trip, so the reference's configs
under ``config/*.yml`` are drop-in. ``yaml`` is imported only where a file is
read. ``mesh_shape`` (``{data, seq}``) lays out a Step3 run over processes;
``scan_epoch`` and ``scan_interleave`` are not fields here: a YAML that sets
them keeps them in ``extra``, where the Step3 trainer reads them.
``add_config_argument`` and ``load_config`` are the reference's YAML-then-CLI
loading for scripts of one's own.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

# (D_feat, D_inner) per pretrain tag; reference Step3_WSI_classification_ACMIL.py:69-87
PRETRAIN_DIMS: Dict[str, tuple] = {
    "medical_ssl": (384, 128),
    "natural_supervised": (512, 256),
    "natural_supervsied": (512, 256),  # reference typo variant (Step3_DTFD:266)
    "path-clip-B": (512, 256),
    "openai-clip-B": (512, 256),
    "plip": (512, 256),
    "quilt-net": (512, 256),
    "path-clip-B-AAAI": (512, 256),
    "biomedclip": (512, 256),
    "path-clip-L-336": (768, 384),
    "openai-clip-L-336": (768, 384),
    "UNI": (1024, 512),
    "GigaPath": (1536, 768),
}


@dataclass
class Config:
    """Flat config covering every knob the reference scripts read.

    Unknown YAML/CLI keys land in ``extra`` so arch-specific configs
    (heatmap args, transforms) still round-trip.
    """

    # --- optimisation (config/camelyon_medical_ssl_config.yml:1-8) ---
    train_epoch: int = 100
    B: int = 1                      # slides per batch
    warmup_epoch: int = 0
    wd: float = 1e-5
    lr: float = 1e-4
    min_lr: float = 0.0
    seed: int = 4

    # --- dataset ---
    dataset: str = "camelyon"
    n_class: int = 2
    data_dir: str = ""
    n_worker: int = 8
    pin_memory: bool = False
    n_shot: int = -1
    split_id: int = 1

    # --- encoder / features ---
    backbone: str = "ViT-S/16"
    pretrain: str = "medical_ssl"
    D_feat: int = 384
    D_inner: int = 128

    # --- MIL head ---
    arch: str = "ga"                # ga | abmil | dsmil in this port so far
    n_token: int = 1                # ACMIL attention branches
    n_masked_patch: int = 0         # STKIM top-k per branch
    mask_drop: float = 0.0          # STKIM random-drop fraction

    # --- bag shape policy ---
    max_patches: int = 65536        # hard cap on bag length
    min_bucket: int = 256           # smallest pad bucket
    feat_dtype: str = "float32"     # compute dtype for features

    # --- parallelism: one process per device (torchrun) ---
    mesh_shape: Optional[Dict[str, int]] = None   # e.g. {"data": 2, "seq": 2}

    # --- bookkeeping ---
    ckpt_dir: str = "./ckpt"
    log_dir: str = "./logs"
    wandb_mode: str = "disabled"
    pretrain_weights: str = ""      # torch checkpoint path for encoder weights

    extra: Dict[str, Any] = field(default_factory=dict)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in names and k != "extra"}
        extra = {k: v for k, v in d.items() if k not in names}
        cfg = cls(**known)
        cfg.extra.update(extra)
        return cfg

    @classmethod
    def from_yaml(cls, path: str, overrides: Optional[Dict[str, Any]] = None) -> "Config":
        import yaml

        with open(path, "r") as f:
            d = yaml.safe_load(f) or {}
        if overrides:
            d.update({k: v for k, v in overrides.items() if v is not None})
        cfg = cls.from_dict(d)
        cfg.resolve_dims()
        return cfg

    def resolve_dims(self) -> "Config":
        """Set (D_feat, D_inner) from the pretrain tag, like the reference does."""
        dims = PRETRAIN_DIMS.get(self.pretrain)
        if dims is not None:
            self.D_feat, self.D_inner = dims
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d

    def __getattr__(self, name: str) -> Any:
        # dataclass fields resolve normally; fall through to extra for
        # reference-style `conf.some_yaml_key` access.
        extra = object.__getattribute__(self, "extra")
        if name in extra:
            return extra[name]
        raise AttributeError(name)


def add_config_argument(parser) -> None:
    """The ``--config`` option of a script that reads a YAML config."""
    parser.add_argument("--config", type=str, required=True,
                        help="YAML config path")


def load_config(args) -> Config:
    """The reference's rule (`Step3_ACMIL:64-67`): the YAML is the base and
    every command-line value that is set (not None) wins."""
    overrides = {k: v for k, v in vars(args).items() if k != "config"}
    return Config.from_yaml(args.config, overrides)
