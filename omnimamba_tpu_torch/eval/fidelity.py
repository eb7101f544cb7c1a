"""Greedy token-stream matching and logit margins: the stream-and-margin half
of ``omnimamba_tpu/eval/fidelity.py``.

- ``greedy_stream``: a deterministic greedy decode;
- ``compare_streams``: the first divergence between two token streams;
- ``teacher_forced_logits``: fp32 logits while feeding a given stream, so
  that two implementations are compared on the same prefix;
- ``logit_margin_report``: how close the argmax was to flipping at each step
  of a teacher-forced replay. A small margin marks a position where another
  rounding of the same arithmetic can change the greedy token.

The JAX functions take a ``scan_impl``; the port has one prefill scan (the
scan kernel, or its plain version for CPU tensors), so they take none. The
recorded packs of the JAX module (``record_pack`` and what reads them) are
not ported here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from omnimamba_tpu_torch.config import MambaConfig
from omnimamba_tpu_torch.models.backbone import apply_head, backbone_forward, backbone_step
from omnimamba_tpu_torch.models.generation import generate
from omnimamba_tpu_torch.ops.sampling import SampleParams
from omnimamba_tpu_torch.utils.device import require_on, resolve_device


class StreamDiff(NamedTuple):
    match: bool
    first_divergence: int  # -1 if identical
    n_compared: int
    mismatch_count: int


def greedy_stream(
    params: Dict,
    cfg: MambaConfig,
    input_ids: torch.Tensor,  # (B, L0)
    input_embeddings: torch.Tensor,  # (B, L0, d), positions already applied
    task: str,
    max_length: int,
    *,
    cache_dtype="auto",
    device="cuda",
) -> np.ndarray:
    """The greedy sequence (B, max_length), prompt ids included.
    ``cache_dtype``: the decode state's type, as ``generate`` takes it."""
    out = generate(
        params, cfg, input_ids=input_ids, input_embeddings=input_embeddings, task=task,
        max_length=max_length, sample=SampleParams(top_k=1), cache_dtype=cache_dtype,
        device=device,
    )
    return out.sequences.cpu().numpy()


def compare_streams(a: np.ndarray, b: np.ndarray) -> StreamDiff:
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    n = min(len(a), len(b))
    neq = a[:n] != b[:n]
    mismatches = int(neq.sum())
    first = int(np.argmax(neq)) if mismatches else -1
    return StreamDiff(
        match=mismatches == 0 and len(a) == len(b),
        first_divergence=first,
        n_compared=n,
        mismatch_count=mismatches,
    )


def _replay(params, cfg, input_embeddings, stream, prompt_len, steps, task, device):
    """Yields the fp32 logits (B, V) of the prompt's last position, then of
    each of the next ``steps - 1`` positions, each fed the stream's own token."""
    dev = resolve_device(device)
    require_on(dev, input_embeddings=input_embeddings)
    stream = torch.tensor(np.asarray(stream), device=input_embeddings.device)
    hidden, cache = backbone_forward(params, input_embeddings, task, cfg, return_cache=True)
    yield apply_head(params, hidden[:, -1], task)
    for t in range(prompt_len, prompt_len + steps - 1):
        hidden, cache = backbone_step(params, stream[:, t], t, cache, task, cfg,
                                      dtype=input_embeddings.dtype)
        yield apply_head(params, hidden, task)


def teacher_forced_logits(
    params: Dict,
    cfg: MambaConfig,
    input_embeddings: torch.Tensor,  # (B, L0, d)
    stream: np.ndarray,  # (B, T) token sequence incl. prompt, fed verbatim
    prompt_len: int,
    k_logits: int,
    task: str,
    *,
    device="cuda",
) -> np.ndarray:
    """fp32 logits (B, K, V) at the first ``k_logits`` generated positions
    while feeding the given stream's tokens (not this model's argmax): every
    position is conditioned on the same prefix as the stream's producer, so
    logit deltas isolate layer-level numerics from prefix divergence."""
    steps = min(k_logits, stream.shape[1] - prompt_len)
    logits = _replay(params, cfg, input_embeddings, stream, prompt_len, max(steps, 1), task, device)
    return np.stack([lg.float().cpu().numpy() for lg in logits], axis=1)


def logit_margin_report(
    params: Dict,
    cfg: MambaConfig,
    input_embeddings: torch.Tensor,  # (B, L0, d)
    token_stream: np.ndarray,  # (B, T) full sequence incl. prompt
    task: str,
    prompt_len: int,
    *,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Teacher-forced replay of a stream: per step, the margin between the
    top-2 logits (B, T - prompt_len) and whether the argmax is the stream's
    token."""
    token_stream = np.asarray(token_stream)
    margins, agrees = [], []
    steps = token_stream.shape[1] - prompt_len
    logits = _replay(params, cfg, input_embeddings, token_stream, prompt_len, steps, task, device)
    for t, lg in zip(range(prompt_len, token_stream.shape[1]), logits):
        top2 = torch.topk(lg, 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        agrees.append((lg.argmax(-1).cpu().numpy() == token_stream[:, t]))
    return {"margins": np.stack(margins, 1), "argmax_agrees": np.stack(agrees, 1)}
