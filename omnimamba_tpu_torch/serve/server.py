"""Batched inference server: the serving front end of the port.

Counterpart of ``omnimamba_tpu/serve/server.py``, with its request formats,
routing and responses:

- one batching worker per task owns the card: requests queue up and are
  packed into the service's batch (short prompts pad, spare rows repeat the
  group's last row), amortising the weight-bound decode across concurrent
  requests;
- a standard-library ThreadingHTTPServer front end:
    POST /v1/t2i {"prompt": str}                          -> {"image_png_b64": ...}
    POST /v1/mmu {"image_png_b64": str, "question": str}  -> {"text": ...}
    GET  /healthz
- ``max_wait_ms`` bounds the wait for batchmates when traffic is sparse;
- t2i requests may set {"raw_caption": true} to skip the fixed 68-id
  left-padded caption block: such a batch decodes ragged (right-padded
  blocks with per-row lengths; each row's stream is its solo stream);
- mmu requests may set {"low_latency": true} to take a single-stream
  speculative lane (prompt-lookup drafts, greedy, the same stream) when it
  is idle, and the batcher otherwise; with ``continuous_mmu`` every mmu
  request joins a slot pool mid-flight (``serve/continuous.SlotEngine``).

Sampler settings are clamped as the JAX server clamps them (top_k to 0..64;
temperature to 0.1..4.0 on a 0.1 lattice; the repetition penalty to 1..2 on
a 0.05 lattice; NaN and junk take the default). Where the JAX server differs
from this one, it is at fault:

- it applies the first request's sampler settings to the whole batch; here a
  batch is split into groups of equal (snapped) settings, each one
  ``t2i_generate`` / ``mmu_generate`` call padded to the service's batch;
- its continuous lane dies with the first failed ``tick()`` and leaves every
  later mmu request waiting out its timeout; here the lane fails its queued
  and resident requests at once, marks itself dead (``/healthz`` says so)
  and the handler sends mmu requests to the static batcher;
- a request that timed out keeps its queue entry or slot; here the lane
  cancels it (``SlotEngine.cancel``), which frees the slot;
- its lane warms only three buckets near 729 image tokens; here warmup
  starts at the smallest bucket a request can reach (the model's image
  tokens + 4 specials + 1 id) and takes two more.

PNGs are encoded and decoded by ``serve/png.py`` (no PIL on the card's
machine); an image of another size than the towers' is resized by
``data/llava.resize_uint8`` (PIL's bicubic, within 2 levels). The handler
decodes and resizes an mmu request's image in its own thread before any
lane sees it, and answers an image it cannot read with a 400 to that
client alone; the JAX server decodes inside the batch, where one bad image
fails every request of its batch. A merged service takes params that are
already merged (``utils/lora.merge_lora``, before any quantization) and
keeps only the task guard. The service
runs on ``device`` (``"cuda"`` unless the caller asks for the CPU) and
falls back to nothing: no lane takes the CPU or a kernel's plain version.
Each batch function runs under ``torch.no_grad`` in its worker's thread.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from omnimamba_tpu_torch.data.conversation import conv_templates
from omnimamba_tpu_torch.data.coco import MAX_CAPTION_TOKENS
from omnimamba_tpu_torch.data.llava import resize_uint8
from omnimamba_tpu_torch.data.transforms import dinosiglip_transform, from_vq_range
from omnimamba_tpu_torch.models.backbone import embed_text
from omnimamba_tpu_torch.models.omnimamba import mmu_generate, mmu_image_features, t2i_generate
from omnimamba_tpu_torch.ops.sampling import SampleParams
from omnimamba_tpu_torch.scripts.inference_t2i import caption_block
from omnimamba_tpu_torch.serve.continuous import SlotEngine
from omnimamba_tpu_torch.serve.png import decode_png, encode_png
from omnimamba_tpu_torch.utils.device import resolve_device


@dataclass
class _Request:
    payload: Dict
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict] = None
    error: Optional[str] = None


class _Batcher(threading.Thread):
    def __init__(self, name: str, run_batch, max_batch: int, max_wait_ms: float):
        super().__init__(daemon=True, name=f"batcher-{name}")
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        # not `_stop`: threading.Thread.join() calls an internal self._stop()
        self._stop_evt = threading.Event()
        self._pending = 0  # submitted and not yet completed (in flight included)
        self._pending_lock = threading.Lock()

    def idle(self) -> bool:
        """True when nothing is queued or in flight (the worker dequeues at
        once, so an empty queue alone does not mean an idle lane)."""
        with self._pending_lock:
            return self._pending == 0

    def submit(self, payload: Dict, timeout: float = 120.0) -> Dict:
        with self._pending_lock:
            self._pending += 1
        return self._run(payload, timeout)

    def submit_if_idle(self, payload: Dict, timeout: float = 120.0) -> Optional[Dict]:
        """Atomic idle check and submit: None (the caller takes another lane)
        unless this lane had no queued or in-flight work."""
        with self._pending_lock:
            if self._pending:
                return None
            self._pending += 1
        return self._run(payload, timeout)

    def _run(self, payload: Dict, timeout: float) -> Dict:
        # the worker decrements _pending when the request finishes, not the
        # submitter on a timeout: a decode that outlives its client still
        # occupies the lane
        req = _Request(payload)
        self.queue.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("batch worker timeout")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def stop(self):
        self._stop_evt.set()

    def run(self):
        while not self._stop_evt.is_set():
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.time() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                results = self.run_batch([r.payload for r in batch])
                for r, res in zip(batch, results):
                    r.result = res
                    r.done.set()
            except Exception as e:  # noqa: BLE001 - the error goes to every request
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
                    r.done.set()
            finally:
                with self._pending_lock:
                    self._pending -= len(batch)
        # drain: a request still queued when the worker exits fails now
        while True:
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                break
            req.error = "RuntimeError: batch worker stopped"
            req.done.set()
            with self._pending_lock:
                self._pending -= 1


def _number(payload: Dict, key: str, default: float) -> float:
    """``payload[key]`` as a float; the default for junk and NaN."""
    try:
        v = float(payload.get(key, default))
    except (TypeError, ValueError):
        return default
    return default if v != v else v


def t2i_settings(payload: Dict):
    """(top_k, temperature) of a t2i request, clamped and snapped."""
    top_k = int(min(max(_number(payload, "top_k", 1), 0), 64))
    temperature = round(min(max(_number(payload, "temperature", 1.0), 0.1), 4.0), 1)
    return top_k, temperature


def mmu_penalty(payload: Dict) -> float:
    """The repetition penalty of an mmu request, clamped to [1, 2] and
    snapped to 0.05."""
    return round(min(max(_number(payload, "repetition_penalty", 1.0), 1.0), 2.0) * 20) / 20


def _groups(payloads: List[Dict], key: Callable) -> Dict:
    """Request indices by their sampler settings, in arrival order."""
    out: Dict = {}
    for i, p in enumerate(payloads):
        out.setdefault(key(p), []).append(i)
    return out


def _padded(rows: list, n: int) -> list:
    """``rows`` with its last entry repeated up to ``n``."""
    return list(rows) + [rows[-1]] * max(0, n - len(rows))


class OmniMambaService:
    """Owns the params; its batch functions are called by the lanes."""

    def __init__(self, model, params, uni, *, t2i_batch=8, mmu_batch=8, mmu_max_new=64,
                 dtype=None, cache_dtype="auto", merge_lora_task=None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.uni = uni
        # a single-task deployment is handed params with that task's LoRA
        # folded into in_proj; they are wrong for the other task, so its
        # endpoint is refused
        if merge_lora_task is not None and any(
                "lora" in layer["mixer"] for layer in params["mamba"]["layers"]):
            raise ValueError(f"merge_lora_task={merge_lora_task!r} takes params merged for that "
                             "task (utils/lora.merge_lora); these still hold LoRA")
        self.merged_task = merge_lora_task
        self.params = params
        self.dtype = dtype or torch.bfloat16
        self.cache_dtype = cache_dtype
        self.t2i_batch = t2i_batch
        self.mmu_batch = mmu_batch
        self.mmu_max_new = mmu_max_new
        self._rng = np.random.default_rng(0)  # seeds of the t2i samplers' generators

    def _require_task(self, task: str):
        if self.merged_task is not None and self.merged_task != task:
            raise RuntimeError(
                f"service was merged for task {self.merged_task!r}; "
                f"{task!r} requests need an unmerged deployment")

    # --- t2i ---------------------------------------------------------------
    def _t2i_block(self, payload: Dict) -> np.ndarray:
        if not payload.get("raw_caption", False):
            return caption_block(self.uni, payload.get("prompt", ""))
        # ragged raw-caption mode: the caption without its left padding
        sp = self.uni.sptids_dict
        ids = self.uni.text_tokenizer(payload.get("prompt", ""))["input_ids"]
        return np.asarray([sp["<|t2i|>"], sp["<|sot|>"], *ids[:MAX_CAPTION_TOKENS],
                           sp["<|eot|>"], sp["<|soi|>"]], np.int64)

    def t2i_inputs(self, payloads: List[Dict]):
        """The caption ids (B, L) and the ragged lengths (or None) of one
        group, as ``t2i_batch_fn`` hands them to ``t2i_generate``."""
        blocks = [self._t2i_block(p) for p in payloads]
        if not any(p.get("raw_caption", False) for p in payloads):
            return np.stack(blocks), None
        # fixed-block rows keep their whole block as their length; the
        # padded length is bucketed to a multiple of 8, as the JAX server does
        lens = np.asarray([len(b) for b in blocks], np.int64)
        L0 = -(-max(int(lens.max()), 8) // 8) * 8
        ids = np.full((len(blocks), L0), int(self.uni.pad_id), np.int64)
        for i, b in enumerate(blocks):
            ids[i, : len(b)] = b
        return ids, lens

    @torch.no_grad()
    def t2i_batch_fn(self, payloads: List[Dict]) -> List[Dict]:
        self._require_task("t2i")
        out: List[Optional[Dict]] = [None] * len(payloads)
        for (top_k, temperature), idx in _groups(payloads, t2i_settings).items():
            ids, lens = self.t2i_inputs(_padded([payloads[i] for i in idx], self.t2i_batch))
            gen = torch.Generator(device=self.device).manual_seed(int(self._rng.integers(1 << 31)))
            imgs, _ = t2i_generate(
                self.params, self.model, ids, sample=SampleParams(top_k=top_k, temperature=temperature),
                generator=gen, dtype=self.dtype, cache_dtype=self.cache_dtype,
                text_lengths=lens, device=self.device)
            pixels = from_vq_range(imgs[: len(idx)]).cpu().numpy()
            for i, img in zip(idx, pixels):
                out[i] = {"image_png_b64": base64.b64encode(encode_png(img)).decode()}
        return out

    # --- mmu ---------------------------------------------------------------
    def load_image(self, image_png_b64: str) -> np.ndarray:
        """A base64 image as uint8 (side, side, 3) for the towers."""
        img = decode_png(base64.b64decode(image_png_b64))
        side = self.model.vision_cfg.dino.img_size
        return img if img.shape[:2] == (side, side) else resize_uint8(img, side)

    def mmu_image(self, payload: Dict) -> np.ndarray:
        """The request's image for the towers: ``"image"``, where the HTTP
        handler has decoded it already, else ``"image_png_b64"`` decoded."""
        if "image" in payload:
            return payload["image"]
        return self.load_image(payload["image_png_b64"])

    def mmu_prompt(self, payload: Dict) -> List[int]:
        """[<|mmu|> <|soi|> <|eoi|> <|sot|>] ++ the question in the phi1.5 wrap."""
        conv = conv_templates["phi1.5"].copy()
        conv.append_message(conv.roles[0], payload.get("question", "Describe the image."))
        conv.append_message(conv.roles[1], None)
        ids = list(self.uni.text_tokenizer(conv.get_prompt().strip())["input_ids"])
        sp = self.model.sptids
        return [sp["<|mmu|>"], sp["<|soi|>"], sp["<|eoi|>"], sp["<|sot|>"]] + ids

    def mmu_features(self, raws: List[np.ndarray]) -> torch.Tensor:
        """The towers' projected features of uint8 (side, side, 3) images."""
        raw = torch.as_tensor(np.stack(raws), device=self.device)
        return mmu_image_features(self.params, self.model,
                                  dinosiglip_transform(raw, self.model.vision_cfg))

    def mmu_answer(self, tokens: np.ndarray) -> str:
        """Generated ids up to the first eos, decoded."""
        eos = int(self.uni.text_tokenizer.eos_token_id)
        toks = tokens.tolist()
        if eos in toks:
            toks = toks[: toks.index(eos)]
        return self.uni.text_tokenizer.decode(toks, skip_special_tokens=True)

    @torch.no_grad()
    def mmu_batch_fn(self, payloads: List[Dict]) -> List[Dict]:
        self._require_task("mmu")
        eos = int(self.uni.text_tokenizer.eos_token_id)
        raws = [self.mmu_image(p) for p in payloads]
        prompts = [self.mmu_prompt(p) for p in payloads]
        out: List[Optional[Dict]] = [None] * len(payloads)
        for pen, idx in _groups(payloads, mmu_penalty).items():
            rows = _padded(idx, self.mmu_batch)
            # right-padded to a multiple of 32; each row decodes from its own
            # length (ragged), so its stream is its solo stream
            lens = np.asarray([len(prompts[i]) for i in rows], np.int64)
            ids = np.full((len(rows), -(-int(lens.max()) // 32) * 32), int(self.uni.pad_id), np.int64)
            for j, i in enumerate(rows):
                ids[j, : lens[j]] = prompts[i]
            feats = self.mmu_features([raws[i] for i in rows])
            total = ids.shape[1] + feats.shape[1]
            gen = mmu_generate(
                self.params, self.model, ids, feats, max_length=total + self.mmu_max_new,
                sample=SampleParams(top_k=1, repetition_penalty=pen), eos_token_id=eos,
                dtype=self.dtype, cache_dtype=self.cache_dtype, text_lengths=lens,
                device=self.device)
            seqs = gen.sequences[:, total:total + int(gen.num_generated)].cpu().numpy()
            for j, i in enumerate(idx):
                out[i] = {"text": self.mmu_answer(seqs[j])}
        return out

    @torch.no_grad()
    def mmu_build_embedding(self, payload: Dict):
        """One request's spliced (L, d) input embeddings, as fp32 numpy, and
        L (no padding): what the continuous lane admits."""
        self._require_task("mmu")
        ids = torch.as_tensor([self.mmu_prompt(payload)], device=self.device)
        feats = self.mmu_features([self.mmu_image(payload)])
        text = embed_text(self.params["mamba"], ids, self.dtype)
        emb = torch.cat([text[:, :2], feats.to(self.dtype), text[:, 2:]], dim=1)
        return emb[0].float().cpu().numpy(), emb.shape[1]

    @torch.no_grad()
    def mmu_single_fn(self, payloads: List[Dict]) -> List[Dict]:
        """The low-latency lane: one request, greedy, prompt-lookup drafts
        (the plain path's stream), the exact prompt length."""
        self._require_task("mmu")
        (p,) = payloads
        ids = [self.mmu_prompt(p)]
        feats = self.mmu_features([self.mmu_image(p)])
        total = len(ids[0]) + feats.shape[1]
        gen = mmu_generate(
            self.params, self.model, ids, feats, max_length=total + self.mmu_max_new,
            eos_token_id=int(self.uni.text_tokenizer.eos_token_id), dtype=self.dtype,
            cache_dtype=self.cache_dtype, draft_mode="ngram", device=self.device)
        toks = gen.sequences[0, total:total + int(gen.num_generated)].cpu().numpy()
        return [{"text": self.mmu_answer(toks), "lane": "speculative"}]


def warmup_prompt_lens(n_image_tokens: int, bucket: int) -> List[int]:
    """Prompt lengths whose buckets the continuous lane warms: the smallest
    bucket a request reaches (image tokens, 4 specials and one id) and the
    two above it."""
    first = -(-(n_image_tokens + 5) // bucket) * bucket
    return [first + k * bucket for k in range(3)]


class ContinuousMMULane(threading.Thread):
    """Continuous-batching mmu lane: a ``SlotEngine`` on its own thread; the
    HTTP handlers submit (embedding, length) and wait on the request's event.

    A failed ``tick()`` fails every queued and resident request with its
    error and leaves the lane dead (``error`` set): ``submit`` then returns
    None and the handler takes the static batcher. A request that times out
    is cancelled, which frees its slot."""

    def __init__(self, service: OmniMambaService, n_slots: int, chunk: int, max_new: int):
        super().__init__(daemon=True, name="mmu-continuous")
        self.service = service
        self.eos = int(service.uni.text_tokenizer.eos_token_id)
        self.engine = SlotEngine(
            service.params["mamba"], service.model.cfg, n_slots=n_slots, chunk=chunk,
            task="mmu", dtype=service.dtype, eos_token_id=self.eos, max_new_default=max_new,
            enable_sampling=True,  # per-request temperature / top_k / top_p / min_p / seed
            enable_rep_penalty=True, history_len=max_new, device=service.device)
        self.warmup_lens = warmup_prompt_lens(service.model.vision_cfg.num_patches,
                                              self.engine.bucket)
        t0 = time.perf_counter()
        with torch.no_grad():
            self.engine.warmup(self.warmup_lens)
        self.warmup_s = time.perf_counter() - t0
        self.error: Optional[str] = None  # set when the lane died
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._work = threading.Event()

    @staticmethod
    def _sample_args(payload: Dict) -> Dict:
        """Per-request sampler settings, clamped; temperature 0 (the default)
        is exact greedy."""
        def num(key, lo, hi, default):
            return min(max(_number(payload, key, default), lo), hi)

        return {
            "temperature": num("temperature", 0.0, 4.0, 0.0),
            "top_k": int(num("top_k", 0, 64, 0)),
            "top_p": num("top_p", 0.0, 0.999, 0.0),
            "min_p": num("min_p", 0.0, 0.999, 0.0),
            "repetition_penalty": num("repetition_penalty", 1.0, 4.0, 1.0),
            "seed": int(num("seed", 0, 2**31 - 1, 0)),
        }

    def submit(self, payload: Dict, timeout: float = 300.0) -> Optional[Dict]:
        """The answer, or None when the lane is dead."""
        if self.error is not None:
            return None
        emb, plen = self.service.mmu_build_embedding(payload)
        with self._lock:  # a request admitted here is failed by _fail if the lane dies
            if self.error is not None:
                return None
            req = self.engine.submit(emb, plen, **self._sample_args(payload))
        self._work.set()
        if not req.done.wait(timeout):
            self.engine.cancel(req, "continuous lane timeout")  # frees its slot
            if req.error is not None:
                raise TimeoutError(req.error)
        if req.error is not None:
            raise RuntimeError(req.error)
        toks = req.tokens[:-1] if req.tokens and req.tokens[-1] == self.eos else req.tokens
        return {"text": self.service.uni.text_tokenizer.decode(toks, skip_special_tokens=True),
                "lane": "continuous"}

    def _fail(self, error: str) -> None:
        with self._lock:
            self.error = error
            for req in self.engine.pending():
                self.engine.cancel(req, error)

    def stop(self):
        self._stop_evt.set()
        self._work.set()

    def run(self):
        while not self._stop_evt.is_set():
            try:
                with torch.no_grad():
                    active = self.engine.tick()
            except Exception as e:  # noqa: BLE001 - fails the lane's requests, see _fail
                self._fail(f"{type(e).__name__}: {e}")
                return
            if active == 0:
                self._work.clear()
                self._work.wait(timeout=0.05)
        self._fail("RuntimeError: continuous lane stopped")


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: a burst of more connections than
    # that, while the accept loop waits for the GIL, loses SYNs, and each
    # such client resends one second later
    request_queue_size = 1024


def make_server(
    service: OmniMambaService,
    host: str = "0.0.0.0",
    port: int = 8000,
    max_wait_ms: float = 20.0,
    speculative_lane: bool = True,
    continuous_mmu: bool = False,
    continuous_slots: int = 8,
    continuous_chunk: int = 16,
) -> ThreadingHTTPServer:
    t2i_batcher = _Batcher("t2i", service.t2i_batch_fn, service.t2i_batch, max_wait_ms)
    mmu_batcher = _Batcher("mmu", service.mmu_batch_fn, service.mmu_batch, max_wait_ms)
    spec_lane = cont_lane = None
    if speculative_lane and not continuous_mmu:
        spec_lane = _Batcher("mmu-spec", service.mmu_single_fn, 1, 0.0)  # one stream, no wait
    if continuous_mmu:
        cont_lane = ContinuousMMULane(service, continuous_slots, continuous_chunk,
                                      service.mmu_max_new)
    lanes = {name: lane for name, lane in (
        ("t2i", t2i_batcher), ("mmu", mmu_batcher), ("speculative", spec_lane),
        ("continuous", cont_lane)) if lane is not None}
    for lane in lanes.values():
        lane.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: Dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._json(404, {"error": "not found"})
            elif cont_lane is not None and cont_lane.error is not None:
                self._json(200, {"status": "degraded", "continuous_lane": "dead",
                                 "error": cont_lane.error})
            else:
                self._json(200, {"status": "ok"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/v1/t2i":
                    self._json(200, t2i_batcher.submit(payload))
                elif self.path == "/v1/mmu":
                    try:  # here, so that a bad image fails its own request only
                        payload["image"] = service.load_image(payload["image_png_b64"])
                    except Exception as e:  # noqa: BLE001 - the client gets the error
                        self._json(400, {"error": f"{type(e).__name__}: {e}"})
                        return
                    # the continuous lane takes every mmu request while it
                    # lives; low_latency requests take the speculative lane
                    # only when it is idle; the batcher takes the rest
                    result = None
                    if cont_lane is not None:
                        result = cont_lane.submit(payload)
                    if result is None and spec_lane is not None and payload.get("low_latency", False):
                        result = spec_lane.submit_if_idle(payload)
                    if result is None:
                        result = mmu_batcher.submit(payload)
                    self._json(200, result)
                else:
                    self._json(404, {"error": "not found"})
            except Exception as e:  # noqa: BLE001 - the client gets the error
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    server = _HTTPServer((host, port), Handler)
    server.t2i_batcher = t2i_batcher  # type: ignore[attr-defined]
    server.mmu_batcher = mmu_batcher  # type: ignore[attr-defined]
    server.spec_lane = spec_lane  # type: ignore[attr-defined]
    server.cont_lane = cont_lane  # type: ignore[attr-defined]
    server.lanes = lanes  # type: ignore[attr-defined]

    def stop_batchers(join_timeout: float = 5.0) -> None:
        """Stop and join every lane's thread; call after ``server.shutdown()``."""
        for lane in lanes.values():
            lane.stop()
        for lane in lanes.values():
            lane.join(timeout=join_timeout)

    server.stop_batchers = stop_batchers  # type: ignore[attr-defined]
    return server
