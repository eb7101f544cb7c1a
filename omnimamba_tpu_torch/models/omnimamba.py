"""OmniMamba top-level composition: the text-to-image path.

Counterpart of ``omnimamba_tpu/models/omnimamba.py``. One params dict:

    params = {
      "mamba": backbone (embeddings + 48 blocks + heads, backbone.py)
      "vq":    VQ-16 decode side                       (vq.py)
    }

The understanding path (vision towers, projector, ``mmu_generate``) and the
training losses arrive with their slices.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from omnimamba_tpu_torch.config import MambaConfig, VQConfig
from omnimamba_tpu_torch.models.backbone import caption_embed, embed_text, init_backbone
from omnimamba_tpu_torch.models.generation import generate
from omnimamba_tpu_torch.models.vq import init_vq, vq_decode_code
from omnimamba_tpu_torch.ops.sampling import SampleParams
from omnimamba_tpu_torch.utils.device import require_on, resolve_device


class OmniMambaModel(NamedTuple):
    """Static configuration bundle for the functional API."""

    cfg: MambaConfig
    vq_cfg: VQConfig
    sptids: Dict[str, int]


def init_omnimamba(
    generator: torch.Generator,
    model: OmniMambaModel,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    *,
    with_vq: bool = True,
) -> Dict:
    """Random parameters for the backbone and, for t2i, the VQ decode side."""
    params: Dict = {"mamba": init_backbone(generator, model.cfg, dtype, device)}
    if model.cfg.t2i_task and with_vq:
        params["vq"] = init_vq(generator, model.vq_cfg, dtype, device)
    return params


def t2i_generate(
    params: Dict,
    model: OmniMambaModel,
    text_ids,  # (B, 72) caption block ids: tensor, array or nested list
    *,
    sample: SampleParams = SampleParams(top_k=1),
    generator: Optional[torch.Generator] = None,
    cfg_scale: Optional[float] = None,
    dtype: torch.dtype = torch.bfloat16,
    decode_image: bool = True,
    cache_dtype="auto",
    text_lengths=None,  # (B,) ragged true caption-block lengths
    device="cuda",
):
    """Caption ids -> 256 VQ tokens -> image.

    With ``cfg_scale``, text_ids must be packed [cond; uncond] along batch.
    Returns (images (B,256,256,3) | None, tokens (B,256)).

    ``text_lengths`` (B,): ragged batching for caption blocks right-padded to
    a common length; row i's true block is its first text_lengths[i] ids and
    its stream is exactly its B=1 stream. Incompatible with ``cfg_scale``.

    Runs on ``device``; the parameters must already lie there.
    """
    device = resolve_device(device)
    cfg = model.cfg
    mamba = params["mamba"]
    require_on(device, embedding=mamba["embedding"])
    text_ids = torch.as_tensor(text_ids, device=device).long()
    emb = caption_embed(mamba, embed_text(mamba, text_ids, dtype))
    L0 = emb.shape[1]
    emb = emb + mamba["pos_embed"][:, :L0].to(dtype)
    if text_lengths is not None and cfg_scale is not None:
        raise ValueError("ragged t2i composes with plain sampling only")

    out = generate(
        mamba, cfg,
        input_ids=text_ids, input_embeddings=emb, task="t2i",
        max_length=L0 + cfg.num_tokens, sample=sample, generator=generator,
        cfg_scale=cfg_scale, cache_dtype=cache_dtype,
        prompt_lengths=text_lengths, device=device,
    )
    tokens = out.sequences[:, L0:]
    if cfg_scale is not None:
        tokens = tokens[: tokens.shape[0] // 2]
    if not decode_image:
        return None, tokens
    return vq_decode_code(params["vq"], tokens, model.vq_cfg), tokens
