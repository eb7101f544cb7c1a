"""Self-distil a shallow draft model for speculative decoding. Counterpart of
``omnimamba_tpu/train/distill.py``.

The layer-skip draft (the target's first M layers) predicts the target
poorly out of the box; this trains those M layers and the final norm to
follow the target's own greedy continuations. Speculative decoding checks
every drafted token against the target, so a draft moves only the speed,
never the stream.

1. Data: greedy ``generate`` of the target from random prompts (through the
   whole-model decode kernel wherever its limits are met).
2. Draft: the first ``m_layers`` and the final norm as fp32 copies that
   train; the embeddings and the tied head are the target's tensors,
   detached (shared and frozen).
3. Training: teacher-forced cross entropy against the target's next token
   over the generated region, AdamW on the draft's layers and norm; the
   draft's forward and backward run the scan kernels (K1 / K5) and the norms.
4. Evaluation: ``speculative_generate`` with the draft on held-out prompts
   against plain greedy decoding: acceptance, and whether the streams agree.

Prompts come from a ``torch.Generator`` (the JAX package derives them from a
PRNG key), or are given.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from omnimamba_tpu_torch.config import MambaConfig
from omnimamba_tpu_torch.models.backbone import apply_head, backbone_forward, embed_text
from omnimamba_tpu_torch.models.generation import generate
from omnimamba_tpu_torch.models.speculative import shallow_draft, speculative_generate
from omnimamba_tpu_torch.ops.sampling import SampleParams
from omnimamba_tpu_torch.utils.device import resolve_device

TRAINABLE = ("layers", "norm_f")


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v) for v in node]
    return fn(node)


def _leaves(node):
    if isinstance(node, dict):
        return [t for v in node.values() for t in _leaves(v)]
    if isinstance(node, list):
        return [t for v in node for t in _leaves(v)]
    return [node]


def make_draft(params: Dict, cfg: MambaConfig, m_layers: int) -> Tuple[Dict, MambaConfig]:
    """The trainable shallow draft of a backbone tree: fp32 copies of its
    first ``m_layers`` layers and of the final norm (``requires_grad``), so
    AdamW's steps do not round to bf16; every other leaf is the target's
    tensor, detached."""
    draft, draft_cfg = shallow_draft(params, cfg, m_layers)
    out = {}
    for k, v in draft.items():
        if k in TRAINABLE:
            out[k] = _map(lambda t: t.detach().float().clone().requires_grad_(), v)
        else:
            out[k] = _map(lambda t: t.detach(), v)
    return out, draft_cfg


def _split(draft: Dict) -> Tuple[Dict, Dict]:
    return ({k: draft[k] for k in TRAINABLE},
            {k: v for k, v in draft.items() if k not in TRAINABLE})


def as_draft(train: Dict, frozen: Dict, dtype: torch.dtype) -> Dict:
    """The draft for decoding: the trained leaves in the model's type."""
    return {**frozen, **_map(lambda t: t.detach().to(dtype), train)}


def _random_prompts(generator: torch.Generator, batch: int, prompt_len: int, vocab: int,
                    device: torch.device) -> torch.Tensor:
    ids = torch.randint(0, vocab, (batch, prompt_len), generator=generator,
                        device=generator.device)
    return ids.to(device)


@torch.no_grad()
def generate_streams(
    params: Dict,
    cfg: MambaConfig,
    generator: torch.Generator,
    *,
    n_batches: int,
    batch: int,
    prompt_len: int,
    gen_len: int,
    task: str = "mmu",
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> list:
    """``n_batches`` tensors (batch, prompt_len + gen_len) of the target's
    greedy continuations of random prompts drawn from ``generator``."""
    device = resolve_device(device)
    pool = []
    for _ in range(n_batches):
        ids = _random_prompts(generator, batch, prompt_len, cfg.vocab_size, device)
        out = generate(params, cfg, input_ids=ids, input_embeddings=embed_text(params, ids, dtype),
                       task=task, max_length=prompt_len + gen_len, sample=SampleParams(top_k=1),
                       device=device)
        pool.append(out.sequences)
    return pool


def make_distill_step(
    frozen: Dict,
    draft_cfg: MambaConfig,
    tx: torch.optim.Optimizer,
    *,
    prompt_len: int,
    task: str = "mmu",
    dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """step(train, tx, seqs) -> (train, tx, {"loss", "top1"}): one AdamW
    update of the trainable subtrees (in place) on the cross entropy of the
    draft's next-token logits against ``seqs`` over the generated region
    (position i predicts token i + 1, so the first supervised position is
    ``prompt_len - 1``); the metrics are 0-dim tensors."""

    def step(train: Dict, opt: torch.optim.Optimizer, seqs: torch.Tensor):
        draft = {**frozen, **_map(lambda t: t.to(dtype), train)}
        seqs = seqs.long()
        emb = embed_text(draft, seqs[:, :-1], dtype)
        hidden, _ = backbone_forward(draft, emb, task, draft_cfg)
        logits = apply_head(draft, hidden, task)  # (B, L - 1, V) fp32
        lp = torch.log_softmax(logits[:, prompt_len - 1:], dim=-1)
        tgt = seqs[:, 1:][:, prompt_len - 1:]
        loss = -torch.gather(lp, -1, tgt[..., None])[..., 0].mean()
        top1 = (torch.argmax(lp, dim=-1) == tgt).float().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return train, opt, {"loss": loss.detach(), "top1": top1}

    return step


def distill_draft(
    params: Dict,
    cfg: MambaConfig,
    *,
    m_layers: int = 4,
    steps: int = 200,
    batch: int = 16,
    prompt_len: int = 16,
    gen_len: int = 112,
    pool_batches: int = 4,
    lr: float = 3e-4,
    generator: Optional[torch.Generator] = None,
    task: str = "mmu",
    dtype: torch.dtype = torch.bfloat16,
    log_every: int = 25,
    log=print,
    device="cuda",
) -> Tuple[Dict, MambaConfig, Dict]:
    """The whole recipe; returns (draft params in ``dtype``, draft config,
    the last step's metrics as floats)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pool = generate_streams(params, cfg, generator, n_batches=pool_batches, batch=batch,
                            prompt_len=prompt_len, gen_len=gen_len, task=task, dtype=dtype,
                            device=device)
    log(f"distill pool: {pool_batches} x {tuple(pool[0].shape)} target streams")
    draft, draft_cfg = make_draft(params, cfg, m_layers)
    train, frozen = _split(draft)
    tx = torch.optim.AdamW(_leaves(train), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    step = make_distill_step(frozen, draft_cfg, tx, prompt_len=prompt_len, task=task, dtype=dtype)
    metrics: Dict = {}
    for i in range(steps):
        train, tx, metrics = step(train, tx, pool[i % pool_batches])
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"  step {i}: CE {float(metrics['loss']):.3f} "
                f"draft-top1 {float(metrics['top1']):.3f}")
    return as_draft(train, frozen, dtype), draft_cfg, {k: float(v) for k, v in metrics.items()}


@torch.no_grad()
def acceptance_eval(
    params: Dict,
    cfg: MambaConfig,
    draft_params: Dict,
    draft_cfg: MambaConfig,
    *,
    prompts=None,
    generator: Optional[torch.Generator] = None,
    n_prompts: int = 4,
    prompt_len: int = 16,
    gen_len: int = 112,
    k_draft: int = 8,
    task: str = "mmu",
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Dict:
    """Acceptance of the draft on held-out prompts (B=1 each): ``prompts``
    (n, prompt_len) ids, or ``n_prompts`` drawn from ``generator``. Each
    prompt runs ``speculative_generate`` with the draft and plain greedy
    ``generate``; ``stream_identical`` says whether every speculative stream
    equals its greedy one (in fp32 it must; in bf16 the verify pass sums a
    window where plain decoding takes a step a token, so a near-tie can
    part them). Returns acceptance, drafted, accepted, stream_identical and
    the streams."""
    device = resolve_device(device)
    if prompts is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        prompts = _random_prompts(generator, n_prompts, prompt_len, cfg.vocab_size, device)
    prompts = torch.as_tensor(prompts, device=device).long()
    drafted = accepted = 0
    identical = True
    streams = []
    for i in range(prompts.shape[0]):
        ids = prompts[i:i + 1]
        emb = embed_text(params, ids, dtype)
        L = ids.shape[1] + gen_len
        out = speculative_generate(params, cfg, input_ids=ids, input_embeddings=emb, task=task,
                                   max_length=L, draft_params=draft_params, draft_cfg=draft_cfg,
                                   k_draft=k_draft, device=device)
        ref = generate(params, cfg, input_ids=ids, input_embeddings=emb, task=task, max_length=L,
                       sample=SampleParams(top_k=1), device=device).sequences
        n = ids.shape[1] + out.num_generated
        identical = identical and torch.equal(out.sequences[0, :n].cpu(), ref[0, :n].cpu())
        drafted += out.drafted
        accepted += out.accepted
        streams.append(out.sequences[0, :n].cpu())
    return {"acceptance": accepted / max(drafted, 1), "drafted": drafted, "accepted": accepted,
            "stream_identical": identical, "streams": streams}

