"""Token samplers: top-k / top-p / min-p / temperature / repetition penalty,
with a greedy short-circuit at top_k == 1.

Counterpart of ``omnimamba_tpu/ops/sampling.py``. The filters and the penalty
are the same functions of the logits; the random draw comes from a
``torch.Generator`` and therefore gives other samples than a JAX key of the
same seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = float("-inf")


class SampleParams(NamedTuple):
    """Sampler configuration (the keyword arguments of ``generate``)."""

    top_k: int = 1
    top_p: float = 0.0
    min_p: float = 0.0
    temperature: float = 1.0
    repetition_penalty: float = 1.0


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit."""
    if top_k <= 0:
        return logits
    k = min(top_k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1, None]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: remove tokens whose ascending cumulative
    probability is <= 1 - top_p."""
    if top_p <= 0.0 or top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1).values  # ascending
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    keep_sorted = cum > (1.0 - top_p)
    # threshold = smallest kept logit
    thresh = torch.min(
        sorted_logits.masked_fill(~keep_sorted, float("inf")), dim=-1, keepdim=True
    ).values
    return logits.masked_fill(logits < thresh, NEG_INF)


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """Min-p filtering: drop tokens whose prob is below min_p * max_prob."""
    if min_p <= 0.0 or min_p >= 1.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    cutoff = torch.max(probs, dim=-1, keepdim=True).values * min_p
    return logits.masked_fill(probs < cutoff, NEG_INF)


def apply_repetition_penalty(
    logits: torch.Tensor,  # (B, V)
    prev_tokens: torch.Tensor,  # (B, T) token ids already emitted
    penalty: float,
    prev_mask: Optional[torch.Tensor] = None,  # (B, T) or (1, T) valid entries
) -> torch.Tensor:
    """CTRL-style repetition penalty: a seen token's logit is multiplied by
    the penalty when negative and divided by it when positive. Entries where
    ``prev_mask`` is false (padding of a fixed-size buffer) have no effect."""
    if penalty == 1.0:
        return logits
    prev_tokens = prev_tokens.long()
    scores = torch.gather(logits, 1, prev_tokens)  # (B, T)
    pen = torch.where(scores < 0, scores * penalty, scores / penalty)
    # every occurrence of a seen token writes the same penalized value, so a
    # min (penalty >= 1) or max (penalty < 1) scatter makes duplicates benign
    # and lets masked entries write the identity
    reduce, identity = ("amin", float("inf")) if penalty >= 1.0 else ("amax", NEG_INF)
    if prev_mask is not None:
        pen = torch.where(prev_mask, pen, torch.full_like(pen, identity))
    return logits.scatter_reduce(1, prev_tokens, pen, reduce=reduce, include_self=True)


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_token(
    generator: Optional[torch.Generator], logits: torch.Tensor, params: SampleParams
) -> torch.Tensor:
    """Sample next token ids (B,):

    - top_k == 1: greedy argmax (no temperature)
    - top_k  > 1: top-k filter, temperature, then top-p on the survivors
    - top_k == 0: min-p (if set) or temperature + top-p, then categorical
    """
    logits = logits.float()
    if params.top_k == 1:
        return torch.argmax(logits, dim=-1)
    if params.top_k > 0:
        filtered = apply_top_k(logits, params.top_k)
        if params.temperature != 1.0:
            filtered = filtered / params.temperature
        return _categorical(apply_top_p(filtered, params.top_p), generator)
    if params.min_p > 0.0:
        filtered = apply_min_p(logits, params.min_p)
        if params.temperature != 1.0:
            filtered = filtered / params.temperature
        return _categorical(filtered, generator)
    filtered = logits / params.temperature if params.temperature != 1.0 else logits
    return _categorical(apply_top_p(filtered, params.top_p), generator)
