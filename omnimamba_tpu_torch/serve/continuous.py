"""Continuous (in-flight) batching decode engine: slot-based serving.

Counterpart of ``omnimamba_tpu/serve/continuous.py`` (``SlotEngine``). The
SSM's recurrent state is constant in size, so admitting a request mid-flight
is one row write into the (n_layer, n_slots, ...) decode state:

- a fixed pool of ``n_slots`` decode slots; every slot advances together
  through one decode step a token. The step is the whole-model decode kernel
  (``backbone_step_fused``) with ONE plan for ``n_slots``, built once per
  engine, wherever its limits are met, and the layer loop (``backbone_step``)
  elsewhere;
- requests are admitted at chunk boundaries, BATCHED per length bucket: one
  (M, Lb) prefill (``backbone_forward`` with ``valid_len``, so bucket padding
  is an exact no-op for the state) per bucket, and the rows are written into
  the pool's existing conv and SSM tensors in place (``index_copy_``), so
  the plan's pointers stay valid and in-flight slots are untouched;
- finished slots (eos or budget) free at chunk boundaries and are reused at
  once; the tokens after eos are trimmed;
- ``cancel`` takes a request out of the queue at once, or frees its slot at
  the next chunk boundary; either way its ``done`` event is set, with an
  error;
- the host reads tokens once per ``chunk``-step CHUNK: the chunk's steps stay
  on the device, with no value read between them.

Greedy decode is the default. ``enable_sampling=True`` gives per-request
temperature / top-k / top-p / min-p and seed. The JAX engine draws with
``fold_in(PRNGKey(seed), seq_index)``, whose bits PyTorch cannot reproduce;
here a draw is a Gumbel-max over the filtered, temperature-scaled logits
with noise from a counter-based integer hash of (seed, sequence index, token
id), computed as one batched tensor expression a step, with no global RNG
state. So a sampled stream is deterministic given its (seed, prompt) and
independent of its batchmates and its slot, and a ``temperature=0`` request
inside a sampling pool takes the exact argmax. ``enable_rep_penalty=True``
applies the CTRL penalty over each request's GENERATED tokens (the engine
sees embeddings, not prompt ids). Inactive slots decode garbage into state
that is overwritten at admission: they cost device work, not correctness.

Differences from the JAX engine, deliberate: the state and the slot
vectors are updated in place (PyTorch runs eagerly, so there is no program
cache and ``warmup`` only runs each shape once); no ``scan_impl``; the
device is an argument (``device="cuda"`` unless the caller asks for the
CPU).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from omnimamba_tpu_torch.models.backbone import (
    BackboneCache,
    apply_head,
    backbone_forward,
    backbone_step,
    backbone_step_fused,
)
from omnimamba_tpu_torch.ops.decode_fused import fused_decode_limits, prepare_fused_decode
from omnimamba_tpu_torch.utils.device import resolve_device

_MASK32 = 0xFFFFFFFF


@dataclass(eq=False)  # compared by identity
class _Request:
    emb: np.ndarray  # (L, d) spliced input embeddings
    prompt_len: int
    max_new: int
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = no top-k restriction
    top_p: float = 0.0  # 0 = no nucleus filter
    min_p: float = 0.0  # applies only with top_k == 0, and then replaces top-p
    repetition_penalty: float = 1.0  # >= 1, over the request's generated tokens
    seed: int = 0
    done: threading.Event = field(default_factory=threading.Event)
    tokens: List[int] = field(default_factory=list)
    first_token: Optional[int] = None
    error: Optional[str] = None  # set by cancel: the request ended without its answer


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow: the
    product is taken on the two 16-bit halves of x."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xor-shift-multiply, the lowbias32 constants)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed: torch.Tensor, idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, vocab) fp32 standard Gumbel noise, a pure function of each row's
    (seed, sequence index) and the token id: a counter-based hash, so a
    row's draw depends on nothing else (not the batch, not the slot, no
    global RNG state)."""
    row = _mix32((_mix32(seed.long() & _MASK32) ^ (idx.long() & _MASK32)) & _MASK32)
    tok = torch.arange(vocab, device=seed.device, dtype=torch.int64)
    h = _mix32(row[:, None] ^ _mix32(tok * 2 + 1)[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))  # in (0, 1), exact in fp32
    return -torch.log(-torch.log(u))


class SlotEngine:
    """Fixed-slot continuous batching over the backbone decode step."""

    def __init__(
        self,
        params: Dict,  # backbone params (the {"mamba": ...} SUBTREE), dense or int8
        cfg,
        *,
        n_slots: int = 8,
        chunk: int = 16,
        task: str = "mmu",
        dtype=None,  # activation dtype (bf16 by default)
        eos_token_id: Optional[int] = None,
        prefill_bucket: int = 32,
        max_new_default: int = 256,
        state_dtype=None,  # pool SSM-state dtype: None = fp32, or torch.bfloat16
        enable_sampling: bool = False,
        max_top_k: int = 64,  # top-k width of the one topk a step; per-slot k <= this
        enable_rep_penalty: bool = False,
        history_len: int = 256,  # generated-token history per slot for the penalty
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.chunk = int(chunk)
        self.task = task
        self.dtype = dtype or torch.bfloat16
        self.eos = eos_token_id
        self.bucket = int(prefill_bucket)
        self.max_new_default = int(max_new_default)
        self.sampling = bool(enable_sampling)
        self.max_top_k = int(max_top_k)
        self.rep_penalty = bool(enable_rep_penalty)
        self.history_len = int(history_len) if enable_rep_penalty else 1
        if state_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported state_dtype {state_dtype}")

        # host-side slot bookkeeping
        self._active = np.zeros(self.n_slots, bool)
        self._budget = np.zeros(self.n_slots, np.int64)  # tokens still allowed
        self._req: List[Optional[_Request]] = [None] * self.n_slots
        self._queue: List[_Request] = []
        self._lock = threading.Lock()

        # device-side pool state; its tensors are never reallocated (the
        # fused step's plan points at them)
        mc, L, S, dev = cfg.mixer, cfg.n_layer, self.n_slots, self.device
        self._cache = BackboneCache(
            conv_state=torch.zeros((L, S, mc.d_conv - 1, mc.d_conv_in), dtype=self.dtype, device=dev),
            ssm_state=torch.zeros((L, S, mc.nheads, mc.headdim, mc.d_state),
                                  dtype=state_dtype or torch.float32, device=dev),
        )
        self._tok = torch.zeros((S,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((S,), dtype=torch.long, device=dev)
        self._temp = torch.zeros((S,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((S,), dtype=torch.long, device=dev)
        self._topp = torch.zeros((S,), dtype=torch.float32, device=dev)
        self._minp = torch.zeros((S,), dtype=torch.float32, device=dev)
        self._seed = torch.zeros((S,), dtype=torch.long, device=dev)
        self._pen = torch.ones((S,), dtype=torch.float32, device=dev)
        self._hist = torch.zeros((S, self.history_len), dtype=torch.long, device=dev)
        self._cnt = torch.zeros((S,), dtype=torch.long, device=dev)

        self.fused = fused_decode_limits(params["layers"], cfg.mixer, cfg.lora, self.dtype) is None
        self._plan = None
        if self.fused and dev.type == "cuda":
            self._plan = prepare_fused_decode(
                params["layers"], task, cfg.mixer, cfg.lora, S, self.dtype)
        # seconds spent in each engine piece (host clock, each ending in a host
        # read or synchronize): chunk, prefill, insert
        self.timings: Dict[str, List[float]] = {"chunk": [], "prefill": [], "insert": []}

    # --- device-side pieces -------------------------------------------------
    def _pick(self, logits, idx, temp, topk, topp, minp, seed):
        """Next tokens from fp32 ``logits`` (B, V): the argmax, or, where a
        row's ``temp > 0``, a draw keyed by (seed, idx), where ``idx`` is the
        sequence index of the token being produced (the prefill uses the
        prompt length, the chunk pos + 1, so the two never collide).

        Filter order as ``ops/sampling.sample_token``: top-k on the raw
        logits, temperature, then top-p on the scaled survivors; a row with
        top_k == 0 and min_p set takes min-p (on the raw logits) instead of
        top-p. The nucleus is resolved among the ``max_top_k`` candidates of
        one ``topk``, with probabilities normalised over the whole filtered
        distribution: exact when the nucleus fits, else cut to those
        candidates."""
        greedy = torch.argmax(logits, dim=-1)
        if not self.sampling:
            return greedy
        V = logits.shape[-1]
        maxk = min(self.max_top_k, V)
        vals = torch.topk(logits, maxk, dim=-1).values  # (B, maxk) descending
        kth = torch.gather(vals, 1, (torch.clamp(topk, 1, maxk) - 1)[:, None])[:, 0]
        use_k = (topk > 0)[:, None]
        use_minp = (~use_k) & ((minp > 0) & (minp < 1))[:, None]
        # prob >= min_p * max_prob  <=>  logit >= max_logit + log(min_p)
        minp_cut = logits.max(dim=-1, keepdim=True).values + torch.log(
            torch.clamp(minp, 1e-9, 1.0))[:, None]
        row_cut = torch.where(use_minp, minp_cut,
                              torch.where(use_k, kth[:, None], torch.full_like(minp_cut, -torch.inf)))
        keep = logits >= row_cut
        tclamp = torch.clamp(temp, min=1e-6)[:, None]
        scaled = torch.where(keep, logits, torch.full_like(logits, -torch.inf)) / tclamp
        svals = torch.where(use_k & (vals < kth[:, None]), torch.full_like(vals, -torch.inf),
                            vals) / tclamp
        lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
        p_sorted = torch.exp(svals - lse)
        cum = torch.cumsum(p_sorted, dim=-1)
        keep_p = (cum - p_sorted) < topp[:, None]  # the mass strictly above is < top_p
        cut = torch.where(keep_p, svals, torch.full_like(svals, torch.inf)).min(dim=-1).values
        use_p = ((topp > 0) & (topp < 1))[:, None] & ~use_minp
        nucleus = torch.where(use_p & (scaled < cut[:, None]),
                              torch.full_like(scaled, -torch.inf), scaled)
        sampled = torch.argmax(nucleus + gumbel_noise(seed, idx, V), dim=-1)
        return torch.where(temp > 0, sampled, greedy)

    def _penalize(self, logits, hist, cnt, pen):
        """CTRL penalty over each slot's generated tokens: entries past
        ``cnt`` write +inf, the identity of the min scatter; penalty 1 writes
        the unchanged score (an exact no-op)."""
        if not self.rep_penalty:
            return logits
        H = hist.shape[1]
        scores = torch.gather(logits, 1, hist)
        p = pen[:, None]
        pscores = torch.where(scores < 0, scores * p, scores / p)
        valid = torch.arange(H, device=logits.device)[None, :] < cnt[:, None]
        pscores = torch.where(valid, pscores, torch.full_like(pscores, torch.inf))
        return logits.scatter_reduce(1, hist, pscores, reduce="amin", include_self=True)

    def _step(self, tok, pos):
        if self.fused:
            hidden, _ = backbone_step_fused(self.params, tok, pos, self._cache, self.task, self.cfg,
                                            dtype=self.dtype, plan=self._plan)
        else:
            hidden, _ = backbone_step(self.params, tok, pos, self._cache, self.task, self.cfg,
                                      dtype=self.dtype)
        return apply_head(self.params, hidden, self.task).float()

    def _chunk(self) -> torch.Tensor:
        """``chunk`` decode steps of every slot, all on the device: (n_slots,
        chunk) tokens. The pool state and the slot vectors advance in place."""
        toks = torch.empty((self.n_slots, self.chunk), dtype=torch.long, device=self.device)
        H = self.history_len
        rows = torch.arange(self.n_slots, device=self.device)
        for i in range(self.chunk):
            logits = self._penalize(self._step(self._tok, self._pos), self._hist, self._cnt, self._pen)
            nxt = self._pick(logits, self._pos + 1, self._temp, self._topk, self._topp, self._minp,
                             self._seed)
            if self.rep_penalty:
                self._hist[rows, torch.clamp(self._cnt, 0, H - 1)] = nxt
                self._cnt = torch.clamp(self._cnt + 1, max=H)
            toks[:, i] = nxt
            self._tok = nxt
            self._pos = self._pos + 1
        return toks

    def _prefill(self, emb, vlen, temp, topk, topp, minp, seed):
        """Batched admission prefill of M rows of one bucket length: the rows'
        decode state (state in the pool's dtype) and first tokens."""
        hidden, cache = backbone_forward(self.params, emb, self.task, self.cfg,
                                         return_cache=True, valid_len=vlen)
        last = hidden[torch.arange(emb.shape[0], device=self.device), vlen - 1]
        logits = apply_head(self.params, last, self.task).float()
        first = self._pick(logits, vlen, temp, topk, topp, minp, seed)
        return cache._replace(ssm_state=cache.ssm_state.to(self._cache.ssm_state.dtype)), first

    def _insert(self, rows: BackboneCache, idx, slots, firsts, vals: Dict[str, torch.Tensor]):
        """Write prefill rows ``idx`` into pool slots ``slots``, in place."""
        self._cache.conv_state.index_copy_(1, slots, rows.conv_state.index_select(1, idx))
        self._cache.ssm_state.index_copy_(1, slots, rows.ssm_state.index_select(1, idx))
        first = firsts.index_select(0, idx)
        self._tok.index_copy_(0, slots, first)
        for name, v in vals.items():
            getattr(self, name).index_copy_(0, slots, v)
        # the history restarts with the prefill's token at position 0 (count 1)
        self._hist.index_fill_(0, slots, 0)
        self._hist[slots, 0] = first
        self._cnt.index_fill_(0, slots, 1)

    # --- host API -------------------------------------------------------
    def warmup(self, prompt_lens) -> None:
        """Run each shape that traffic with these prompt lengths reaches once
        (a chunk, the prefill of each bucket at each power-of-two admission
        width) on dummy inputs, so that the first requests do not pay the
        kernel build, library plans and allocator growth. Call before
        traffic: the chunk advances the (then all inactive) slots."""
        if self._active.any():
            raise RuntimeError("warmup runs before traffic, with every slot free")
        self._chunk()
        d = int(self.cfg.d_model)
        buckets = sorted({-(-max(int(L), 1) // self.bucket) * self.bucket for L in prompt_lens})
        M = 1
        while True:
            ones = torch.ones((M,), dtype=torch.long, device=self.device)
            zf = torch.zeros((M,), dtype=torch.float32, device=self.device)
            for Lb in buckets:
                self._prefill(torch.zeros((M, Lb, d), dtype=self.dtype, device=self.device),
                              ones, zf, ones * 0, zf, zf, ones * 0)
            if M >= self.n_slots:
                break
            M <<= 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(
        self, emb: np.ndarray, prompt_len: int, max_new: Optional[int] = None,
        *, temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
        min_p: float = 0.0, repetition_penalty: float = 1.0, seed: int = 0,
    ):
        """Queue one request (spliced (L, d) embeddings and the true length).
        Returns the ``_Request``; wait on ``.done``, then read ``.tokens``."""
        if temperature > 0 and not self.sampling:
            raise ValueError("temperature > 0 needs SlotEngine(enable_sampling=True)")
        if top_k > self.max_top_k:
            raise ValueError(f"top_k {top_k} > engine max_top_k {self.max_top_k}")
        if not 0.0 <= top_p < 1.0:
            raise ValueError(f"top_p {top_p} must be in [0, 1)")
        if not 0.0 <= min_p < 1.0:
            raise ValueError(f"min_p {min_p} must be in [0, 1)")
        if repetition_penalty != 1.0:
            if not self.rep_penalty:
                raise ValueError("repetition_penalty != 1 needs SlotEngine(enable_rep_penalty=True)")
            if repetition_penalty < 1.0:
                raise ValueError(f"repetition_penalty {repetition_penalty} must be >= 1")
            if int(max_new or self.max_new_default) > self.history_len:
                raise ValueError(
                    f"max_new {max_new} > history_len {self.history_len}: tokens past the "
                    "history would escape the penalty")
        req = _Request(
            emb=np.asarray(emb), prompt_len=int(prompt_len),
            max_new=int(max_new or self.max_new_default), temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p), min_p=float(min_p),
            repetition_penalty=float(repetition_penalty), seed=int(seed),
        )
        with self._lock:
            self._queue.append(req)
        return req

    def _admit(self):
        """Admit queued requests into free slots, batched per length bucket:
        one (M, Lb) prefill and one in-place insert a bucket, M padded to a
        power of two (padding rows carry valid_len 1 and are discarded)."""
        dev = self.device
        while True:
            with self._lock:
                free = [i for i in range(self.n_slots) if not self._active[i]]
                take = min(len(free), len(self._queue))
                if take == 0:
                    return
                batch = [self._queue.pop(0) for _ in range(take)]
                slots = free[:take]
                for s, r in zip(slots, batch):
                    self._active[s] = True
                    self._req[s] = r

            groups: Dict[int, list] = {}
            for s, r in zip(slots, batch):
                Lb = -(-max(r.emb.shape[0], 1) // self.bucket) * self.bucket
                groups.setdefault(Lb, []).append((s, r))

            any_finished = False
            for Lb, items in groups.items():
                M = len(items)
                Mb = 1 << (M - 1).bit_length()
                d = items[0][1].emb.shape[1]
                emb = np.zeros((Mb, Lb, d), np.float32)
                vlen = np.ones((Mb,), np.int64)
                knobs = {"temp": np.zeros(Mb, np.float32), "topk": np.zeros(Mb, np.int64),
                         "topp": np.zeros(Mb, np.float32), "minp": np.zeros(Mb, np.float32),
                         "seed": np.zeros(Mb, np.int64), "pen": np.ones(Mb, np.float32)}
                for j, (_, r) in enumerate(items):
                    emb[j, : r.emb.shape[0]] = r.emb
                    vlen[j] = r.prompt_len
                    knobs["temp"][j], knobs["topk"][j] = r.temperature, r.top_k
                    knobs["topp"][j], knobs["minp"][j] = r.top_p, r.min_p
                    knobs["seed"][j], knobs["pen"][j] = r.seed, r.repetition_penalty
                dk = {k: torch.as_tensor(v, device=dev) for k, v in knobs.items()}
                t0 = time.perf_counter()
                rows, firsts = self._prefill(
                    torch.as_tensor(emb, device=dev).to(self.dtype), torch.as_tensor(vlen, device=dev),
                    dk["temp"], dk["topk"], dk["topp"], dk["minp"], dk["seed"])
                firsts_h = firsts.cpu().numpy()  # one host read a group
                self.timings["prefill"].append(time.perf_counter() - t0)

                live = []
                for j, (s, r) in enumerate(items):
                    ft = int(firsts_h[j])
                    r.first_token = ft
                    r.tokens.append(ft)
                    self._budget[s] = r.max_new - 1
                    if (self.eos is not None and ft == self.eos) or self._budget[s] <= 0:
                        self._finish(s)
                        any_finished = True
                    else:
                        live.append(j)
                if live:
                    t0 = time.perf_counter()
                    idx = torch.as_tensor(live, device=dev)
                    lslots = torch.as_tensor([items[j][0] for j in live], device=dev)
                    self._pos.index_copy_(0, lslots, torch.as_tensor(
                        [items[j][1].prompt_len for j in live], device=dev))
                    vals = {f"_{k}": dk[k].index_select(0, idx) for k in knobs}
                    self._insert(rows, idx, lslots, firsts, vals)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    self.timings["insert"].append(time.perf_counter() - t0)
            if not any_finished:
                return  # no slot freed during admission: nothing more to admit

    def cancel(self, req: _Request, error: str = "cancelled") -> None:
        """End ``req`` with ``error``: a queued request leaves the queue, one
        that holds a slot frees it at the next chunk boundary. Its ``done``
        event is set at once. A request that has finished is left as it is."""
        with self._lock:
            if req.done.is_set():
                return
            req.error = error
            if req in self._queue:
                self._queue.remove(req)
        req.done.set()

    def pending(self) -> List[_Request]:
        """The queued requests and those that hold a slot."""
        with self._lock:
            return list(self._queue) + [r for r in self._req if r is not None]

    def _free_cancelled(self) -> None:
        for slot in range(self.n_slots):
            req = self._req[slot]
            if self._active[slot] and req is not None and req.error is not None:
                self._finish(slot)

    def _finish(self, slot: int):
        req = self._req[slot]
        self._active[slot] = False
        self._req[slot] = None
        if req is not None:
            req.done.set()

    def tick(self) -> int:
        """One engine iteration: admit, decode one chunk, harvest. Returns the
        number of ACTIVE slots that advanced (0 = idle)."""
        self._free_cancelled()
        self._admit()
        n_active = int(self._active.sum())
        if n_active == 0:
            return 0
        t0 = time.perf_counter()
        toks_h = self._chunk().cpu().numpy()  # ONE host read a chunk
        self.timings["chunk"].append(time.perf_counter() - t0)
        for slot in range(self.n_slots):
            if not self._active[slot]:
                continue
            req = self._req[slot]
            for t in toks_h[slot]:
                t = int(t)
                if self._budget[slot] <= 0:
                    break
                req.tokens.append(t)
                self._budget[slot] -= 1
                if self.eos is not None and t == self.eos:
                    break
            if self._budget[slot] <= 0 or (self.eos is not None and self.eos in req.tokens):
                if self.eos is not None and self.eos in req.tokens:
                    req.tokens[:] = req.tokens[: req.tokens.index(self.eos) + 1]
                self._finish(slot)
        return n_active

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            with self._lock:
                idle = not self._queue and not self._active.any()
            if idle:
                return
            self.tick()
        raise RuntimeError("engine did not drain")
