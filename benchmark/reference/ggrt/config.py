"""Unified configuration tree (dataclasses), field for field the same as the
JAX package's, so one YAML overlay configures both packages.

Defaults reproduce configs/pretrain_ggrt_stable.yaml and
configs/pixelsplat/encoder/epipolar.yaml of the reference; YAML/CLI overlays
are applied with `load_config` / `apply_overrides`.

One field differs: `DecoderCfg.backend` defaults to "cuda" (the hand-written
Hopper compositor). "pallas" is accepted as its synonym so configs written
for the JAX package load unchanged; "tiled" and "reference" are the plain
PyTorch backends, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ImageSelfAttentionCfg:
    patch_size: int = 4
    num_octaves: int = 10
    num_layers: int = 2
    num_heads: int = 4
    d_token: int = 128
    d_dot: int = 128
    d_mlp: int = 256


@dataclass
class EpipolarTransformerCfg:
    self_attention: ImageSelfAttentionCfg = field(default_factory=ImageSelfAttentionCfg)
    num_octaves: int = 10
    num_layers: int = 2
    num_heads: int = 4
    num_samples: int = 32
    num_context_views: int = 2
    d_dot: int = 128
    d_mlp: int = 256
    downscale: int = 4


@dataclass
class BackboneCfg:
    name: str = "resnet"
    model: str = "resnet50"  # dino_resnet50 shares the architecture
    num_layers: int = 5
    use_first_pool: bool = False
    d_out: int = 512
    # Converted torchvision/dino weights; None or a missing file trains the
    # trunk from scratch.
    pretrained_path: str | None = None


@dataclass
class GaussianAdapterCfg:
    gaussian_scale_min: float = 0.5
    gaussian_scale_max: float = 15.0
    sh_degree: int = 4


@dataclass
class OpacityMappingCfg:
    initial: float = 0.0
    final: float = 0.0
    warm_up: int = 1


@dataclass
class EncoderCfg:
    name: str = "epipolar"
    d_feature: int = 128
    num_monocular_samples: int = 32
    num_surfaces: int = 1
    predict_opacity: bool = False
    near_disparity: float = 3.0
    gaussians_per_pixel: int = 3
    use_epipolar_transformer: bool = True
    use_transmittance: bool = False
    apply_bounds_shim: bool = True
    backbone: BackboneCfg = field(default_factory=BackboneCfg)
    gaussian_adapter: GaussianAdapterCfg = field(default_factory=GaussianAdapterCfg)
    epipolar_transformer: EpipolarTransformerCfg = field(default_factory=EpipolarTransformerCfg)
    opacity_mapping: OpacityMappingCfg = field(default_factory=OpacityMappingCfg)


@dataclass
class DecoderCfg:
    name: str = "splatting"
    backend: str = "cuda"  # cuda (synonym: pallas) | tiled | reference
    max_dup: int = 32
    max_per_tile: int = 1024
    tile_chunk: int = 16


@dataclass
class IPONetCfg:
    pretrained_path: str | None = None  # imagenet resnet18 weights for the trunks
    iters: int = 12           # total GRU steps (outer x seq_len)
    seq_len: int = 4
    foutput_dim: int = 128
    feat_ratio: int = 8
    hidden_dim: int = 128
    context_dim: int = 32
    min_depth: float = 0.1
    max_depth: float = 100.0


@dataclass
class OptimizerCfg:
    lr: float = 1.5e-4
    warm_up_steps: int = 2000
    # Gradient global-norm clip (0 disables). The reference does not clip;
    # the JAX package clips against late gradient spikes.
    grad_clip_norm: float = 5.0


@dataclass
class TrainCfg:
    expname: str = "pretrain_llff"
    rootdir: str = "data/ibrnet/train"
    seed: int = 3407
    ckpt_path: Optional[str] = None

    train_dataset: str = "llff+ibrnet_collected"
    train_scenes: tuple = ()
    dataset_weights: tuple = (0.5, 0.5)
    eval_dataset: str = "llff_test"
    eval_scenes: tuple = ("trex", "fern", "flower", "leaves", "room", "fortress", "horns", "orchids")
    num_source_views: int = 5
    selection_rule: str = "pose"
    llffhold: int = 8
    testskip: int = 8

    n_iters: int = 6000
    lrate_pose: float = 2e-5
    lrate_decay_pose_steps: int = 50000
    lrate_decay_factor: float = 0.5
    use_pred_pose: bool = True
    use_depth_loss: bool = True
    # The pose-stage loss terms below are documented at the same fields of
    # the JAX package's config; all default off (reference parity).
    pose_depth_distill: float = 0.0
    sfm_valid_mask: bool = False
    sfm_oob_weight: float = 0.0
    pose_teacher_weight: float = 0.0
    pose_anchor_weight: float = 0.0
    pose_selfdistill_weight: float = 0.0
    sfm_weight: float = 1.0
    pose_render_grad: bool = False
    # State-machine schedule (train_ggrt_stable.py:83 runs 'joint' live).
    machine: str = "joint"
    # compose_joint_loss alpha = 2^(-coeff*step) (dgaussian.py:115-121).
    joint_coefficient: float = 1e-5
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)

    # finetune-specific
    crop_size: int = 2  # deferred-BP grid is crop_size x crop_size

    no_load_opt: bool = True
    no_load_scheduler: bool = True
    n_tensorboard: int = 2
    n_checkpoint: int = 500
    n_validation: int = 1000

    # Numerics: the reference traces in float32. The port's entry points
    # turn TF32 off in cuDNN and cuBLAS to honour it.
    matmul_precision: str = "float32"

    # Observability: when set, capture a profiler trace of steps
    # [profile_step, profile_step+3) into this directory.
    profile_dir: str = ""
    profile_step: int = 10

    # distribution
    data_parallel: int = 1    # target views split across devices
    tile_parallel: int = 1    # screen tiles split across devices


@dataclass
class GGRtConfig:
    train: TrainCfg = field(default_factory=TrainCfg)
    encoder: EncoderCfg = field(default_factory=EncoderCfg)
    decoder: DecoderCfg = field(default_factory=DecoderCfg)
    iponet: IPONetCfg = field(default_factory=IPONetCfg)


def _apply(obj: Any, overrides: dict) -> Any:
    for key, value in overrides.items():
        head, _, rest = key.partition(".")
        if not hasattr(obj, head):
            raise KeyError(f"unknown config key: {head}")
        if rest:
            _apply(getattr(obj, head), {rest: value})
        else:
            current = getattr(obj, head)
            if dataclasses.is_dataclass(current) and isinstance(value, dict):
                _apply(current, value)
            elif isinstance(current, bool) and isinstance(value, str):
                # bool("False") is True — parse CLI-style strings explicitly.
                low = value.strip().lower()
                if low in ("true", "1", "yes", "on"):
                    setattr(obj, head, True)
                elif low in ("false", "0", "no", "off"):
                    setattr(obj, head, False)
                else:
                    raise ValueError(f"can't parse bool override {head}={value!r}")
            else:
                setattr(obj, head, type(current)(value) if current is not None else value)
    return obj


def apply_overrides(cfg: GGRtConfig, overrides: dict) -> GGRtConfig:
    """Apply {'a.b.c': v} or nested-dict overrides in place."""
    return _apply(cfg, overrides)


def load_config(yaml_path: Optional[str] = None, overrides: Optional[dict] = None) -> GGRtConfig:
    cfg = GGRtConfig()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            _apply(cfg, yaml.safe_load(f) or {})
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def pretrain_config(**overrides) -> GGRtConfig:
    """configs/pretrain_ggrt_stable.yaml equivalents (the dataclass defaults)."""
    return apply_overrides(GGRtConfig(), overrides)


def finetune_config(**overrides) -> GGRtConfig:
    """configs/finetune_ggrt_stable.yaml equivalents: per-scene finetune with
    7 source views (6 context pairs), a lower learning rate, the dataset's
    poses and no depth loss; crop_size stays 2."""
    cfg = GGRtConfig()
    cfg.train.expname = "finetune_dgaussian_stable"
    cfg.train.train_dataset = "llff_test"
    cfg.train.dataset_weights = (1.0,)
    cfg.train.num_source_views = 7
    cfg.train.n_iters = 5000
    cfg.train.use_pred_pose = False
    cfg.train.use_depth_loss = False
    cfg.train.optimizer = OptimizerCfg(lr=5e-5, warm_up_steps=500)
    cfg.train.lrate_decay_pose_steps = 2000
    return apply_overrides(cfg, overrides)


def tiny_config() -> GGRtConfig:
    """The smoke-test widths of the scripts' --tiny (the JAX package's
    __graft_entry__._tiny_cfg), field for field, with the decoder's default
    "cuda" backend: the kernels on the card, their plain versions on the CPU."""
    return pretrain_config(**{
        "encoder.d_feature": 32,
        "encoder.num_monocular_samples": 8,
        "encoder.gaussians_per_pixel": 2,
        "encoder.backbone.model": "resnet18",
        "encoder.backbone.num_layers": 3,
        "encoder.backbone.d_out": 32,
        "encoder.gaussian_adapter.sh_degree": 1,
        "encoder.epipolar_transformer.num_samples": 4,
        "encoder.epipolar_transformer.num_octaves": 4,
        "encoder.epipolar_transformer.num_layers": 1,
        "encoder.epipolar_transformer.num_heads": 2,
        "encoder.epipolar_transformer.d_dot": 16,
        "encoder.epipolar_transformer.d_mlp": 32,
        "encoder.epipolar_transformer.downscale": 4,
        "encoder.epipolar_transformer.self_attention.patch_size": 2,
        "encoder.epipolar_transformer.self_attention.num_octaves": 4,
        "encoder.epipolar_transformer.self_attention.num_layers": 1,
        "encoder.epipolar_transformer.self_attention.num_heads": 2,
        "encoder.epipolar_transformer.self_attention.d_token": 16,
        "encoder.epipolar_transformer.self_attention.d_dot": 16,
        "encoder.epipolar_transformer.self_attention.d_mlp": 32,
        "decoder.max_per_tile": 128,
        "decoder.tile_chunk": 4,
        "iponet.iters": 4,
        "iponet.seq_len": 2,
        "iponet.foutput_dim": 32,
        "iponet.hidden_dim": 32,
        "iponet.context_dim": 8,
    })


def dryrun_config() -> GGRtConfig:
    """The multi-rank proof's widths (the JAX package's
    __graft_entry__._dryrun_cfg): tiny_config() with one GRU step, narrower
    encoder and IPO-Net, no depth loss and the predicted poses injected."""
    return apply_overrides(tiny_config(), {
        "iponet.iters": 1,
        "iponet.seq_len": 1,
        "iponet.foutput_dim": 16,
        "iponet.hidden_dim": 16,
        "encoder.d_feature": 16,
        "encoder.num_monocular_samples": 4,
        "encoder.gaussians_per_pixel": 1,
        "encoder.backbone.num_layers": 2,
        "encoder.backbone.d_out": 16,
        "encoder.epipolar_transformer.num_samples": 2,
        "train.use_depth_loss": False,
        "train.use_pred_pose": True,
    })
