"""Shared helpers (no tests of their own) of the tests that hold the PyTorch port
(``omnimamba_tpu_torch``) against the JAX package (``omnimamba_tpu``).

Inputs are made with numpy from a seed and handed to both sides; JAX
parameters are turned into numpy arrays here and go through the port's
bridge. Everything runs on the CPU: the port's kernel wrappers use their
plain versions there.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from omnimamba_tpu import config as jcfg
from omnimamba_tpu.models.omnimamba import OmniMambaModel as JaxModel
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel as TorchModel
from omnimamba_tpu_torch.utils.bridge import from_jax_params

# six xdist workers each hold a JAX and a PyTorch thread pool
torch.set_num_threads(1)

_MIXER = dict(d_model=32, d_state=16, headdim=8, expand=2, chunk_size=16)
_MAMBA = dict(d_model=32, n_layer=2, vocab_size=64, vqvae_vocab_size=32,
              num_tokens=16, mmu_pos_len=128, pad_vocab_size_multiple=16)
_VQ = dict(codebook_size=32, codebook_embed_dim=8, ch=16, num_res_blocks=1,
           encoder_ch_mult=(1, 2), decoder_ch_mult=(1, 2), z_channels=16)


def tiny_models():
    """The same tiny geometry as a model bundle of each package."""
    jm = JaxModel(
        cfg=jcfg.MambaConfig(mixer=jcfg.Mamba2LayerConfig(**_MIXER), **_MAMBA),
        vision_cfg=jcfg.VisionConfig(), vq_cfg=jcfg.VQConfig(**_VQ), sptids={},
    )
    tm = TorchModel(
        cfg=tcfg.MambaConfig(mixer=tcfg.Mamba2LayerConfig(**_MIXER), **_MAMBA),
        vq_cfg=tcfg.VQConfig(**_VQ), sptids={},
    )
    return jm, tm


# The geometries where the card's out_proj dispatch or K-split layout changes
# (out_pair_fits and tc_split_width in csrc/decode_fused.cu): d_inner 512 is
# one K split, 1,536 two of 768, and 2,560 three of 896, 896 and a short 768.
# All are whole tensor-core tiles (d_model and d_inner multiples of 64), so the
# card runs the pair out_proj at up to 96 rows a block, with bf16 or int8
# weights; 8, 32 and 64 heads (the JAX kernel's head tiles of 16 divide them).
# On the CPU the wrapper runs the plain version, the reference the card's
# kernels are held against.
_OUT_PROJ_MIXERS = {
    512: dict(d_model=256, d_state=16, headdim=64, expand=2, chunk_size=16),
    1536: dict(d_model=768, d_state=16, headdim=48, expand=2, chunk_size=16),
    2560: dict(d_model=1280, d_state=16, headdim=40, expand=2, chunk_size=16),
}


def to_numpy(tree):
    """Every leaf of a JAX pytree as a numpy array (bf16 widened to fp32)."""
    def leaf(a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return jax.tree.map(leaf, tree)


def fill_lora_b(mixer_params, rng, scale=0.05):
    """LoRA B factors are initialised to zero; fill them so the LoRA branch
    changes the output. Returns a new params dict (any leading layer axis)."""
    lora = dict(mixer_params["lora"])
    for k in sorted(lora):
        if "_B_" in k:
            lora[k] = jax.numpy.asarray(
                scale * rng.standard_normal(lora[k].shape), lora[k].dtype)
    return {**mixer_params, "lora": lora}


def decode_side(vq_params):
    """The VQ leaves the port has a place for."""
    return {k: vq_params[k] for k in ("decoder", "post_quant_conv", "codebook")}


def bridge(jax_params, torch_model, dtype=None):
    return from_jax_params(to_numpy(jax_params), torch_model, dtype=dtype, device="cpu")


def tt(a, dtype=None):
    """numpy / JAX array -> torch tensor on the CPU (always a copy: the port
    updates some tensors in place)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dtype or torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def nn(t):
    """torch tensor -> float32/int numpy array."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.detach().cpu().numpy()


def torch_config(jcfg):
    """The port's ``MambaConfig`` of a JAX ``MambaConfig`` (the fields the
    tiny test configs set)."""
    mixer = tcfg.Mamba2LayerConfig(**{f: getattr(jcfg.mixer, f) for f in (
        "d_model", "d_state", "d_conv", "expand", "headdim", "ngroups", "chunk_size", "dt_limit")})
    return tcfg.MambaConfig(mixer=mixer, **{f: getattr(jcfg, f) for f in (
        "d_model", "n_layer", "vocab_size", "vqvae_vocab_size", "num_tokens", "mmu_pos_len",
        "pad_vocab_size_multiple", "t2i_task", "mmu_task")})


def bridge_backbone(jax_backbone, cfg):
    """A JAX backbone tree (no ``"mamba"`` wrapper) through the bridge, for
    the port's config ``cfg``."""
    model = TorchModel(cfg=cfg, vq_cfg=tcfg.VQConfig(), sptids={})
    return from_jax_params({"mamba": to_numpy(jax_backbone)}, model, device="cpu")["mamba"]
