"""OmniMamba top-level composition: the text-to-image path and the training
losses of the backbone.

Counterpart of ``omnimamba_tpu/models/omnimamba.py``. One params dict:

    params = {
      "mamba": backbone (embeddings + 48 blocks + heads, backbone.py)
      "vq":    VQ-16 decode side                       (vq.py)
    }

The understanding path (vision towers, projector, ``mmu_generate``,
``mmu_loss``) arrives with its slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.config import MambaConfig, VQConfig
from omnimamba_tpu_torch.models.backbone import (
    apply_head,
    backbone_forward,
    caption_embed,
    embed_image_tokens,
    embed_text,
    init_backbone,
)
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


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

IGNORE_INDEX = -100


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX
) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is not
    ``ignore_index``, computed in fp32; 0 where every label is ignored."""
    flat = labels.reshape(-1).long()
    total = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), flat,
        ignore_index=ignore_index, reduction="sum")
    return total / torch.clamp((flat != ignore_index).sum(), min=1)


def _shift_and_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shift-by-one language-model loss: position t predicts label t + 1."""
    return cross_entropy(logits[:, :-1], labels[:, 1:])


def t2i_loss(
    params: Dict,
    model: OmniMambaModel,
    image_ids: torch.Tensor,  # (B, 256) VQ token ids
    caption_ids: torch.Tensor,  # (B, 72): [<|t2i|> <|sot|> pad*/cap <|eot|> <|soi|>]
    *,
    dtype: torch.dtype = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Text-to-image training loss: the caption block without its last id,
    the image tokens, then that last id; only image positions carry labels.
    ``generator`` draws the LoRA dropout masks (None: no dropout); ``remat``:
    see ``backbone.backbone_forward``. The ids and the parameters must lie on
    one device."""
    cfg = model.cfg
    mamba = params["mamba"]
    image_ids, caption_ids = image_ids.long(), caption_ids.long()
    img_emb = embed_image_tokens(mamba, image_ids, dtype)  # (B, 256, d)
    txt = caption_embed(mamba, embed_text(mamba, caption_ids, dtype))
    emb = torch.cat([txt[:, :-1], img_emb, txt[:, -1:]], dim=1)

    B, n_cap = caption_ids.shape
    ignore = image_ids.new_full((B, 1), IGNORE_INDEX)
    labels = torch.cat([ignore.expand(B, n_cap - 1), image_ids, ignore], dim=1)
    L = emb.shape[1]
    emb = emb + mamba["pos_embed"][:, :L].to(dtype)
    hidden, _ = backbone_forward(mamba, emb, "t2i", cfg, generator=generator, remat=remat)
    return _shift_and_ce(apply_head(mamba, hidden, "t2i"), labels)


def mmu_loss(*args, **kwargs):
    """The understanding loss runs the vision towers and the projector."""
    raise NotImplementedError(
        "mmu_loss needs models/vit.py and models/projector.py, which arrive with the "
        "understanding slice (ROADMAP: slice 3, MMU inference); the stage-2 unified step follows it"
    )


def lm_loss(
    params: Dict,
    model: OmniMambaModel,
    input_ids: torch.Tensor,  # (B, T)
    labels: torch.Tensor,  # (B, T)
    *,
    dtype: torch.dtype = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Pure language-modelling loss: a text-only sequence through the mmu
    LoRA and head, no image splice, no mmu positional table."""
    mamba = params["mamba"]
    emb = embed_text(mamba, input_ids.long(), dtype)
    hidden, _ = backbone_forward(
        mamba, emb, "mmu", model.cfg, add_mmu_pos=False, generator=generator)
    return _shift_and_ce(apply_head(mamba, hidden, "mmu"), labels)


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------


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

    ``cache_dtype``: see ``generation.generate``. Parameters quantized by
    ``ops/quant.quantize_decode_params`` serve as they are.

    Runs on ``device``; the parameters must already lie there.
    """
    device = resolve_device(device)
    cfg = model.cfg
    mamba = params["mamba"]
    table = mamba["embedding"]
    require_on(device, embedding=table["q"] if isinstance(table, dict) else table)
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
