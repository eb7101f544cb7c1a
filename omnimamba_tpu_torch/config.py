"""Typed configuration for the PyTorch/CUDA port of OmniMamba.

The port's own copy of the dataclasses the text-to-image path needs; the
field names, defaults and derived properties equal those of
``omnimamba_tpu/config.py`` so one set of hyperparameters describes both
packages (the port imports nothing from the JAX package):

- ``Mamba2LayerConfig``  hyperparameters of the Mamba-2 mixer
- ``LoraConfig``         dual-task LoRA on every mixer's in_proj
- ``MambaConfig``        backbone (embeddings, 48 blocks, dual heads)
- ``VQConfig``           LlamaGen VQ-16 tokenizer
- ``TrainConfig``        the YAML ``train:`` block and the trainer's defaults

The ViT and vision configs arrive with the slice that uses them.
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
