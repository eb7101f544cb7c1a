"""Typed configuration for the PyTorch/CUDA port of OmniMamba.

The port's own copy of the dataclasses the text-to-image path needs; the
field names, defaults and derived properties equal those of
``omnimamba_tpu/config.py`` so one set of hyperparameters describes both
packages (the port imports nothing from the JAX package):

- ``Mamba2LayerConfig``  hyperparameters of the Mamba-2 mixer
- ``LoraConfig``         dual-task LoRA on every mixer's in_proj
- ``MambaConfig``        backbone (embeddings, 48 blocks, dual heads)
- ``VQConfig``           LlamaGen VQ-16 tokenizer
- ``ViTConfig``          one ViT featurizer (timm geometry)
- ``VisionConfig``       the fused DINOv2 + SigLIP towers, ``VISION_BACKBONES``
- ``SpecialTokens``      the ten tokens added to the GPT-NeoX vocabulary
- ``TrainConfig``        the YAML ``train:`` block and the trainer's defaults
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class Mamba2LayerConfig:
    """Per-layer Mamba-2 mixer hyperparameters (mamba_ssm 2.2.2 defaults)."""

    d_model: int = 2048
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk_size: int = 256
    norm_eps: float = 1e-5
    conv_bias: bool = True
    proj_bias: bool = False
    # A init range (uniform in [1, 16], stored as log)
    a_init_min: float = 1.0
    a_init_max: float = 16.0
    dt_min: float = 0.001
    dt_max: float = 0.1
    dt_init_floor: float = 1e-4
    dt_limit: Tuple[float, float] = (0.0, float("inf"))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def nheads(self) -> int:
        if self.d_inner % self.headdim != 0:
            raise ValueError("d_inner must be a multiple of headdim")
        return self.d_inner // self.headdim

    @property
    def d_conv_in(self) -> int:
        """Channels entering the depthwise causal conv: x ++ B ++ C."""
        return self.d_inner + 2 * self.ngroups * self.d_state

    @property
    def d_in_proj(self) -> int:
        """Output width of in_proj: [z, x, B, C, dt]."""
        return 2 * self.d_inner + 2 * self.ngroups * self.d_state + self.nheads


@dataclass(frozen=True)
class LoraConfig:
    """Dual-task LoRA on every mixer's in_proj (r=8, alpha=32)."""

    r: int = 8
    alpha: int = 32
    dropout: float = 0.05
    lora_nums: int = 1

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


@dataclass(frozen=True)
class MambaConfig:
    """Backbone config; defaults are the 1.3B model."""

    d_model: int = 2048
    d_intermediate: int = 0
    n_layer: int = 48

    # llamagen_t2i image-token vocabulary
    vqvae_vocab_size: int = 16384
    num_tokens: int = 256  # 16x16 grid at f16 on 256px images

    vocab_size: int = 50277
    pad_vocab_size_multiple: int = 16

    rms_norm: bool = True
    residual_in_fp32: bool = True
    norm_eps: float = 1e-5
    tie_embeddings: bool = True

    # dormant options kept for config-surface parity; the port refuses them
    # until the slice that brings attention layers and the gated MLP
    attn_layer_idx: Tuple[int, ...] = ()
    attn_num_heads: int = 16
    attn_rotary_dim: int = 0

    t2i_task: bool = True
    mmu_task: bool = True

    # pos table covers 72 caption slots + 256 image tokens + 1
    mmu_pos_len: int = 1500
    img_sq_len: int = 729

    mixer: Mamba2LayerConfig = field(default_factory=Mamba2LayerConfig)
    lora: LoraConfig = field(default_factory=LoraConfig)

    token_drop: float = 0.0
    mixer_drop: float = 0.0
    mlp_drop: float = 0.0

    @property
    def padded_vocab_size(self) -> int:
        return _round_up(self.vocab_size, self.pad_vocab_size_multiple)

    @property
    def t2i_pos_len(self) -> int:
        return self.num_tokens + 73

    def with_mixer(self, **kw) -> "MambaConfig":
        return dataclasses.replace(self, mixer=dataclasses.replace(self.mixer, **kw))

    def resized(self, new_vocab: int) -> "MambaConfig":
        """Vocab resize: the tokenizer grows by its specials, then the table
        pads to a multiple of ``pad_vocab_size_multiple``."""
        return dataclasses.replace(
            self, vocab_size=_round_up(new_vocab, self.pad_vocab_size_multiple)
        )


def omnimamba_l(**kw) -> MambaConfig:
    """OmniMamba-L: d_model=1024."""
    return MambaConfig(d_model=1024, **kw).with_mixer(d_model=1024)


def omnimamba_1_3b(**kw) -> MambaConfig:
    """OmniMamba-1.3B: d_model=2048."""
    return MambaConfig(d_model=2048, **kw).with_mixer(d_model=2048)


def omnimamba_tiny(**kw) -> MambaConfig:
    """Tiny debug model: the full architecture at toy width."""
    mixer = Mamba2LayerConfig(d_model=128, d_state=32, headdim=16, chunk_size=32)
    return MambaConfig(d_model=128, n_layer=4, mmu_pos_len=1500, mixer=mixer, **kw)


MODEL_REGISTRY = {
    "OmniMamba-L": omnimamba_l,
    "OmniMamba-1.3B": omnimamba_1_3b,
    "OmniMamba-Tiny": omnimamba_tiny,
}


@dataclass(frozen=True)
class VQConfig:
    """LlamaGen VQ-16 tokenizer config."""

    codebook_size: int = 16384
    codebook_embed_dim: int = 8
    codebook_l2_norm: bool = True
    commit_loss_beta: float = 0.25
    entropy_loss_ratio: float = 0.0
    ch: int = 128
    num_res_blocks: int = 2
    encoder_ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    decoder_ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    z_channels: int = 256
    dropout_p: float = 0.0

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.encoder_ch_mult) - 1)


def vq_16() -> VQConfig:
    return VQConfig()


def vq_8() -> VQConfig:
    return VQConfig(encoder_ch_mult=(1, 2, 2, 4), decoder_ch_mult=(1, 2, 2, 4))


VQ_MODELS = {"VQ-16": vq_16, "VQ-8": vq_8}


@dataclass(frozen=True)
class ViTConfig:
    """A single ViT featurizer (timm-compatible geometry)."""

    img_size: int = 384
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_reg_tokens: int = 0  # DINOv2 "reg4" uses 4
    use_cls_token: bool = True
    use_swiglu: bool = False  # DINOv2-L uses a plain MLP
    layerscale: bool = False  # DINOv2 uses LayerScale
    norm_eps: float = 1e-6
    # data preprocessing
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    interpolation: str = "bicubic"
    # eval-transform crop fraction; scale_size = floor(img_size / crop_pct)
    crop_pct: float = 1.0

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid


def dinov2_l_reg4_384() -> ViTConfig:
    """DINOv2-L/14 with 4 registers at 384 px (729 patches)."""
    return ViTConfig(
        img_size=384, patch_size=14, width=1024, depth=24, num_heads=16,
        num_reg_tokens=4, use_cls_token=True, layerscale=True,
        mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
    )


def siglip_so400m_384() -> ViTConfig:
    """SigLIP so400m/14 at 384 px (729 patches, no cls token)."""
    return ViTConfig(
        img_size=384, patch_size=14, width=1152, depth=27, num_heads=16,
        mlp_ratio=3.7362,  # so400m: mlp hidden 4304
        num_reg_tokens=0, use_cls_token=False, layerscale=False,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
    )


@dataclass(frozen=True)
class VisionConfig:
    """The fused DINOv2 + SigLIP backbone: two towers whose patch features
    are concatenated."""

    dino: ViTConfig = field(default_factory=dinov2_l_reg4_384)
    siglip: ViTConfig = field(default_factory=siglip_so400m_384)
    resize_strategy: str = "resize-naive"

    @property
    def embed_dim(self) -> int:
        """Concatenated feature width: 1024 + 1152 = 2176."""
        return self.dino.width + self.siglip.width

    @property
    def num_patches(self) -> int:
        if self.dino.num_patches != self.siglip.num_patches:
            raise ValueError("the two towers must give the same number of patches")
        return self.dino.num_patches


def _dinosiglip_tiny() -> VisionConfig:
    """Toy dual backbone for CPU runs."""
    return VisionConfig(
        dino=ViTConfig(
            img_size=56, patch_size=14, width=64, depth=2, num_heads=2,
            num_reg_tokens=4, layerscale=True,
        ),
        siglip=ViTConfig(
            img_size=56, patch_size=14, width=64, depth=2, num_heads=2,
            use_cls_token=False,
        ),
    )


def clip_vit_l_336() -> ViTConfig:
    """CLIP-L/14 at 336 px."""
    return ViTConfig(
        img_size=336, patch_size=14, width=1024, depth=24, num_heads=16,
        num_reg_tokens=0, use_cls_token=True, layerscale=False,
        mean=(0.4815, 0.4578, 0.4082), std=(0.2686, 0.2613, 0.2758),
    )


def in1k_vit_l() -> ViTConfig:
    """ViT-L/16 at 224 px, supervised on ImageNet-1k."""
    return ViTConfig(
        img_size=224, patch_size=16, width=1024, depth=24, num_heads=16,
        num_reg_tokens=0, use_cls_token=True, layerscale=False,
    )


def _dinoclip_336() -> VisionConfig:
    """DINOv2-L reg4 + CLIP-L, both at 336 px (576 patches a tower)."""
    return VisionConfig(
        dino=dataclasses.replace(dinov2_l_reg4_384(), img_size=336),
        siglip=clip_vit_l_336(),
    )


def _single(name_cfg):
    def make():
        # one featurizer in both slots
        return VisionConfig(dino=name_cfg(), siglip=name_cfg())

    return make


# the shipped model uses dinosiglip-vit-so-384px; the other entries are
# configurations only
VISION_BACKBONES = {
    "dinosiglip-vit-so-384px": VisionConfig,
    "dinosiglip-tiny": _dinosiglip_tiny,
    "dinoclip-vit-l-336px": _dinoclip_336,
    "clip-vit-l-336px": _single(clip_vit_l_336),
    "siglip-vit-so400m-384px": _single(siglip_so400m_384),
    "dinov2-vit-l-384px": _single(dinov2_l_reg4_384),
    "in1k-vit-l-224px": _single(in1k_vit_l),
}


@dataclass(frozen=True)
class SpecialTokens:
    """The tokens added to the GPT-NeoX tokenizer: ``[PAD]`` first, then the
    nine specials, so with a base vocabulary of 50277 the ids are
    50277..50286."""

    order: Tuple[str, ...] = (
        "<|soi|>", "<|eoi|>", "<|sot|>", "<|eot|>", "<|t2i|>",
        "<|mmu|>", "<|soc|>", "<|eoc|>", "<|lvg|>",
    )
    pad_token: str = "[PAD]"


@dataclass
class TrainConfig:
    """Mirrors the YAML ``train:`` block and the training script's defaults.
    The JAX package's ``scan_impl`` has no counterpart: a CUDA tensor takes
    the kernels, a CPU tensor their plain versions."""

    omnimamba_model: str = "OmniMamba-1.3B"
    image_backbone: str = "dinosiglip-vit-so-384px"
    dataset: str = "datasets/pretokenized_coco_train2014.jsonl"
    stage: str = "finetune"  # align | finetune | inference
    vq_ckpt: Optional[str] = None
    t2i_task: bool = True
    mmu_task: bool = True
    omnimamba_ckpt: Optional[str] = None
    mamba_pretrain: Optional[str] = None
    batch_size_t2i: int = 48
    batch_size_mmu: int = 3
    lr: float = 1e-4
    max_steps: int = 150000
    warmup_steps: int = 0
    resume_dir: Optional[str] = None
    output_dir: str = "logs/"
    logging_steps: int = 500
    bf16: bool = True
    # optimizer
    decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    grad_accum: int = 1
    min_lr_rate: float = 0.01
    scheduler: str = "cosine_with_min_lr"
    save_steps: int = 5000
    save_total_limit: int = 5
    # evaluate() every N optimizer steps when an eval loader is configured; 0 disables
    eval_steps: int = 0
    seed: int = 0
    num_workers: int = 16
    # kept for config-surface parity: the port runs on one card and refuses
    # any other mesh until parallel/ is ported
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"dp": 1, "tp": 1})
    # gradient checkpointing over the blocks. True: checkpoint every block;
    # False: keep every activation; "proj": choose between the two from the
    # tokens of a step (train/trainer.resolve_remat). The JAX package's
    # selective policies ("proj_xbd", "proj_ssd", "proj_conv_ssd", "dots")
    # are refused until they are ported.
    remat: Any = "proj"
    # the mmu flow's checkpointing in a mixed (stage-2) step: None checkpoints
    # every block of it (its 1,182-token rows); True / False as ``remat``
    remat_mmu: Any = None

    def __post_init__(self):
        if {k: v for k, v in self.mesh_shape.items() if v != 1}:
            raise NotImplementedError(
                f"mesh_shape={self.mesh_shape}: the port runs on one card; meshes arrive "
                "with parallel/ (ROADMAP: slice 6, multi-GPU)"
            )

    @classmethod
    def from_yaml(cls, path: str) -> "TrainConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)["train"]
        raw["lr"] = float(raw["lr"])
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in raw.items() if k in known})
        if not cfg.t2i_task:
            cfg.batch_size_t2i = 0
        if not cfg.mmu_task:
            cfg.batch_size_mmu = 0
        return cfg
