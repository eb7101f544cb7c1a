"""OmniMamba top-level composition: the text-to-image and understanding
paths and the training losses of the backbone.

Counterpart of ``omnimamba_tpu/models/omnimamba.py``. One params dict:

    params = {
      "mamba":     backbone (embeddings + 48 blocks + heads, backbone.py)
      "vision":    {"dino": ..., "siglip": ...}             (vit.py)
      "projector": vision -> d_model MLP                    (projector.py)
      "vq":        VQ-16 decode side                        (vq.py)
    }

The understanding (MMU) sequence: [emb(<|mmu|> <|soi|>) | 729 projected
patches | emb(<|eoi|> <|sot|> text)], decoded through the mmu LoRA and the
text head; ``mmu_loss`` trains on it (stage 2), with zero image features on
text-only rows.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.config import MambaConfig, VisionConfig, VQConfig
from omnimamba_tpu_torch.models.backbone import (
    apply_head,
    backbone_forward,
    caption_embed,
    embed_image_tokens,
    embed_text,
    gather_tables,
    init_backbone,
)
from omnimamba_tpu_torch.models.generation import generate
from omnimamba_tpu_torch.models.projector import apply_projector, init_projector
from omnimamba_tpu_torch.models.vit import dinosiglip_features, init_vit
from omnimamba_tpu_torch.models.vq import init_vq, vq_decode_code
from omnimamba_tpu_torch.ops.sampling import SampleParams
from omnimamba_tpu_torch.parallel.sharding import whole
from omnimamba_tpu_torch.utils.device import require_on, resolve_device


class OmniMambaModel(NamedTuple):
    """Static configuration bundle for the functional API. A bundle without
    ``vision_cfg`` has no vision towers and no projector."""

    cfg: MambaConfig
    vq_cfg: VQConfig
    sptids: Dict[str, int]
    vision_cfg: Optional[VisionConfig] = None
    projector_arch: str = "fused-gelu-mlp"


def init_omnimamba(
    generator: torch.Generator,
    model: OmniMambaModel,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    *,
    with_vision: bool = True,
    with_vq: bool = True,
) -> Dict:
    """Random parameters for the backbone; for mmu (where the bundle has a
    ``vision_cfg``) the two towers and the projector; for t2i the VQ decode
    side."""
    params: Dict = {"mamba": init_backbone(generator, model.cfg, dtype, device)}
    if model.cfg.mmu_task and with_vision and model.vision_cfg is not None:
        vcfg = model.vision_cfg
        params["vision"] = {"dino": init_vit(generator, vcfg.dino, dtype, device),
                            "siglip": init_vit(generator, vcfg.siglip, dtype, device)}
        params["projector"] = init_projector(
            generator, vcfg.embed_dim, model.cfg.d_model, model.projector_arch, dtype, device)
    if model.cfg.t2i_task and with_vq:
        params["vq"] = init_vq(generator, model.vq_cfg, dtype, device)
    return params


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

IGNORE_INDEX = -100


REDUCTIONS = ("mean", "sum_and_count")


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX,
    reduction: str = "mean",
):
    """Mean cross entropy over the positions whose label is not
    ``ignore_index``, computed in fp32; 0 where every label is ignored.
    ``reduction="sum_and_count"`` gives (the fp32 sum, the number of those
    positions) instead: ranks that each hold some rows divide their sums by
    the count over every rank, which the mean of their means is not where
    rows differ in their labels."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"reduction must be one of {REDUCTIONS}, not {reduction!r}")
    flat = labels.reshape(-1).long()
    total = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), flat,
        ignore_index=ignore_index, reduction="sum")
    count = (flat != ignore_index).sum()
    if reduction == "sum_and_count":
        return total, count
    return total / torch.clamp(count, min=1)


def _shift_and_ce(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean"):
    """Shift-by-one language-model loss: position t predicts label t + 1."""
    return cross_entropy(logits[:, :-1], labels[:, 1:], reduction=reduction)


def t2i_loss(
    params: Dict,
    model: OmniMambaModel,
    image_ids: torch.Tensor,  # (B, 256) VQ token ids
    caption_ids: torch.Tensor,  # (B, 72): [<|t2i|> <|sot|> pad*/cap <|eot|> <|soi|>]
    *,
    dtype: torch.dtype = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    remat=False,
    reduction: str = "mean",
):
    """Text-to-image training loss: the caption block without its last id,
    the image tokens, then that last id; only image positions carry labels.
    ``generator`` draws the LoRA dropout masks (None: no dropout); ``remat``:
    see ``backbone.backbone_forward``; ``reduction``: see ``cross_entropy``.
    The ids and the parameters must lie on one device."""
    cfg = model.cfg
    mamba = gather_tables(params["mamba"], "img_embeddings")  # the lookup and the tied head
    image_ids, caption_ids = image_ids.long(), caption_ids.long()
    img_emb = embed_image_tokens(mamba, image_ids, dtype)  # (B, 256, d)
    txt = caption_embed(mamba, embed_text(mamba, caption_ids, dtype))
    emb = torch.cat([txt[:, :-1], img_emb, txt[:, -1:]], dim=1)

    B, n_cap = caption_ids.shape
    ignore = image_ids.new_full((B, 1), IGNORE_INDEX)
    labels = torch.cat([ignore.expand(B, n_cap - 1), image_ids, ignore], dim=1)
    L = emb.shape[1]
    emb = emb + whole(mamba["pos_embed"])[:, :L].to(dtype)
    hidden, _ = backbone_forward(mamba, emb, "t2i", cfg, generator=generator, remat=remat)
    return _shift_and_ce(apply_head(mamba, hidden, "t2i"), labels, reduction)


def _mmu_wrap_ids(sptids: Dict[str, int], input_ids: torch.Tensor) -> torch.Tensor:
    """[<|mmu|> <|soi|> <|eoi|> <|sot|>] ++ text."""
    B = input_ids.shape[0]
    specials = torch.tensor(
        [sptids["<|mmu|>"], sptids["<|soi|>"], sptids["<|eoi|>"], sptids["<|sot|>"]],
        dtype=input_ids.dtype, device=input_ids.device)
    return torch.cat([specials.expand(B, 4), input_ids], dim=1)


def mmu_embed_sequence(
    params: Dict,
    model: OmniMambaModel,
    input_ids: torch.Tensor,  # (B, T) text ids, starting at the question
    image_features: torch.Tensor,  # (B, N, d_model) projected patches (or zeros)
    labels: Optional[torch.Tensor] = None,  # (B, T) text labels
    *,
    dtype: torch.dtype = torch.bfloat16,
):
    """The spliced training sequence: the four specials wrapped around the
    image span, then the text; labels ignore everything through <|sot|>.
    Returns (embeddings (B, 4 + N + T, d), labels or None)."""
    wrapped = _mmu_wrap_ids(model.sptids, input_ids.long())
    text_emb = embed_text(params["mamba"], wrapped, dtype)
    emb = torch.cat([text_emb[:, :2], image_features.to(dtype), text_emb[:, 2:]], dim=1)
    out_labels = None
    if labels is not None:
        B, n_img = input_ids.shape[0], image_features.shape[1]
        ignore = torch.full((B, 4 + n_img), IGNORE_INDEX, dtype=torch.long, device=labels.device)
        out_labels = torch.cat([ignore, labels.long()], dim=1)
    return emb, out_labels


def mmu_image_features(params: Dict, model: OmniMambaModel,
                       pixel_values: Dict[str, torch.Tensor], remat: bool = False) -> torch.Tensor:
    """The towers' concatenated features through the projector: (B, N,
    d_model), in the pixels' type. ``remat``: see ``vit.vit_features`` (it
    checkpoints only a tower that trains)."""
    if model.vision_cfg is None:
        raise ValueError("this model bundle has no vision_cfg: it has no towers")
    vision = whole(params["vision"])
    feats = dinosiglip_features(vision["dino"], vision["siglip"],
                                pixel_values, model.vision_cfg, remat=remat)
    return apply_projector(whole(params["projector"]), feats, model.projector_arch)


def mmu_loss(
    params: Dict,
    model: OmniMambaModel,
    pixel_values: Dict[str, torch.Tensor],  # {"dino", "siglip"}: (B, H, W, 3) normalised
    input_ids: torch.Tensor,  # (B, T) text ids, starting at the question
    labels: torch.Tensor,  # (B, T) text labels
    multimodal_mask: torch.Tensor,  # (B,) bool: the row has a real image
    *,
    dtype: torch.dtype = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    remat=False,
    reduction: str = "mean",
):
    """Understanding training loss (stage 2): the towers and the projector on
    every row, zero features where ``multimodal_mask`` is False (a text-only
    row's pixels are a dummy), the spliced sequence through the mmu LoRA and
    the text head, shift-by-one cross entropy on the text labels.
    ``generator`` draws the LoRA dropout masks (None: no dropout); ``remat``:
    True or a policy's name checkpoints every block of the backbone (see
    ``backbone.backbone_forward``) and every block of a tower that trains;
    ``reduction``: see ``cross_entropy``. The inputs and the parameters must
    lie on one device."""
    feats = mmu_image_features(params, model, pixel_values, remat=bool(remat))
    mask = torch.as_tensor(multimodal_mask, device=feats.device).bool()
    feats = torch.where(mask[:, None, None], feats, 0.0)
    mamba = gather_tables(params["mamba"], "embedding")  # the lookup and the tied head
    emb, full_labels = mmu_embed_sequence({"mamba": mamba}, model, input_ids, feats, labels,
                                          dtype=dtype)
    hidden, _ = backbone_forward(mamba, emb, "mmu", model.cfg, generator=generator, remat=remat)
    return _shift_and_ce(apply_head(mamba, hidden, "mmu"), full_labels, reduction)


def lm_loss(
    params: Dict,
    model: OmniMambaModel,
    input_ids: torch.Tensor,  # (B, T)
    labels: torch.Tensor,  # (B, T)
    *,
    dtype: torch.dtype = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    remat=False,
) -> torch.Tensor:
    """Pure language-modelling loss: a text-only sequence through the mmu
    LoRA and head, no image splice, no mmu positional table. ``remat``: see
    ``backbone.backbone_forward`` (the JAX function has no such argument)."""
    mamba = params["mamba"]
    emb = embed_text(mamba, input_ids.long(), dtype)
    hidden, _ = backbone_forward(
        mamba, emb, "mmu", model.cfg, add_mmu_pos=False, generator=generator, remat=remat)
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


def mmu_generate(
    params: Dict,
    model: OmniMambaModel,
    input_ids,  # (B, T0): [<|mmu|> <|soi|> <|eoi|> <|sot|>] ++ text
    image_features: torch.Tensor,  # (B, N, d_model) projected patches
    *,
    max_length: int = 2048,
    sample: SampleParams = SampleParams(top_k=1),
    eos_token_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.bfloat16,
    cache_dtype="auto",
    decode_impl: str = "auto",
    draft_params: Optional[Dict] = None,
    draft_layers: Optional[int] = None,
    draft_mode: str = "model",  # model | ngram
    k_draft: int = 8,
    text_lengths=None,  # (B,) ragged true text lengths, the 4 specials included
    return_logits: bool = False,
    device="cuda",
):
    """Visual question answering: embeddings [2 specials | N image | rest of
    the text], then ``generate(task="mmu")``. ``max_length`` counts the image
    span. Returns ``GenerateOutput`` (``SpecDecodeOutput`` on the speculative
    branch); ``sequences`` hold 0 at the image span.

    The image span's ids are placeholders, so they never enter the
    repetition penalty's set (the JAX package fills them with 0 and so
    penalises token 0 at every step).

    ``draft_params`` / ``draft_layers`` / ``draft_mode="ngram"`` take the
    speculative greedy path (``models/speculative.py``, B=1, no repetition
    penalty); in fp32 its stream is the plain greedy one.

    ``text_lengths`` (B,): ragged batching. ``input_ids`` are right-padded;
    row i's true text is its first text_lengths[i] ids, and its stream equals
    its B=1 stream.

    Runs on ``device``; the parameters and the features must lie there.
    """
    device = resolve_device(device)
    mamba = params["mamba"]
    table = mamba["embedding"]
    require_on(device, embedding=table["q"] if isinstance(table, dict) else table,
               image_features=image_features)
    input_ids = torch.as_tensor(input_ids, device=device).long()
    B, n_img = input_ids.shape[0], image_features.shape[1]
    text_emb = embed_text(mamba, input_ids, dtype)
    emb = torch.cat([text_emb[:, :2], image_features.to(dtype), text_emb[:, 2:]], dim=1)
    splice_ids = torch.cat([input_ids[:, :2], input_ids.new_zeros((B, n_img)), input_ids[:, 2:]],
                           dim=1)
    if draft_params is not None or draft_layers is not None or draft_mode != "model":
        from omnimamba_tpu_torch.models.speculative import speculative_generate

        if sample.top_k != 1 or sample.repetition_penalty != 1.0:
            raise ValueError("speculative decode is greedy, without a repetition penalty")
        if text_lengths is not None:
            raise ValueError("speculative decode takes no ragged text_lengths; use the plain path")
        if generator is not None:
            raise ValueError("speculative decode is deterministic (greedy); generator unused")
        if draft_params is not None and "mamba" in draft_params:
            draft_params = draft_params["mamba"]
        return speculative_generate(
            mamba, model.cfg, input_ids=splice_ids, input_embeddings=emb, task="mmu",
            max_length=max_length, draft_params=draft_params, draft_layers=draft_layers,
            draft_mode=draft_mode, k_draft=k_draft, eos_token_id=eos_token_id,
            cache_dtype=cache_dtype, device=device)
    penalty_mask = torch.ones((1, splice_ids.shape[1]), dtype=torch.bool, device=device)
    penalty_mask[:, 2:2 + n_img] = False
    return generate(
        mamba, model.cfg, input_ids=splice_ids, input_embeddings=emb, task="mmu",
        max_length=max_length, sample=sample, eos_token_id=eos_token_id, generator=generator,
        cache_dtype=cache_dtype, decode_impl=decode_impl,
        prompt_lengths=None if text_lengths is None
        else torch.as_tensor(text_lengths, device=device).long() + n_img,
        penalty_mask=penalty_mask, return_logits=return_logits, device=device,
    )
