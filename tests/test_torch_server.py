"""The serving front end: the port's ``serve/server.py`` over real sockets on
the tiny model (fp32, CPU), beside the JAX package's ``OmniMambaService``.

- T2I: the port's pixels over HTTP equal the port's direct ``t2i_generate``
  on the same padded block, bit for bit; its tokens equal JAX's; its images
  equal JAX's within ``test_torch_t2i.IMG_TOL`` (so the PNGs' uint8 pixels,
  which truncate, differ by at most one level).
- MMU: batch, ragged, solo, the speculative lane and the continuous lane
  give JAX's text. The images are sent at the towers' size, so neither
  side resizes.
- JAX's ``_Batcher`` tests, ported; the sampler clamps.
- The JAX server's faults, pinned here as divergences: per-request sampler
  settings in a mixed batch; a failed ``tick()`` fails the lane's requests
  at once and the handler routes to the batcher; a timed-out request frees
  its slot; warmup includes the smallest bucket a request reaches.

Every HTTP call has a timeout of 60 s or less; every server fixture shuts
the server down and joins its lanes.
"""

import base64
import concurrent.futures
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.data.prompting import UniversalPrompting as JaxPrompting
from omnimamba_tpu.data.tokenizer import OfflineTokenizer as JaxTokenizer
from omnimamba_tpu.models import omnimamba as jom
from omnimamba_tpu.ops.sampling import SampleParams as JSampleParams
from omnimamba_tpu.serve.server import OmniMambaService as JaxService
from omnimamba_tpu_torch.data.prompting import UniversalPrompting
from omnimamba_tpu_torch.data.tokenizer import OfflineTokenizer
from omnimamba_tpu_torch.data.transforms import from_vq_range
from omnimamba_tpu_torch.models.omnimamba import t2i_generate
from omnimamba_tpu_torch.ops import kernel_build
from omnimamba_tpu_torch.ops.sampling import SampleParams
from omnimamba_tpu_torch.serve import server as srv
from omnimamba_tpu_torch.serve.continuous import SlotEngine
from omnimamba_tpu_torch.serve.png import decode_png, encode_png
from omnimamba_tpu_torch.utils.lora import merge_lora
from tests.test_torch_helpers import bridge, decode_side, fill_lora_b, nn, tiny_mmu_models
from tests.test_torch_t2i import IMG_TOL

SIDE = 56  # the tiny towers' input side
MAX_NEW = 6
HTTP_TIMEOUT = 60


@pytest.fixture(scope="module")
def pair():
    """The tiny model with towers, projector and VQ decoder in each package
    (LoRA B filled so that the adapters count), and a service of each."""
    jmodel, tmodel = tiny_mmu_models()
    jp = jom.init_omnimamba(jax.random.PRNGKey(0), jmodel)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(0))
    jp = {**jp, "mamba": {**jp["mamba"], "layers": layers}}
    tp = bridge({"mamba": jp["mamba"], "vision": jp["vision"], "projector": jp["projector"],
                 "vq": decode_side(jp["vq"])}, tmodel)
    jsvc = JaxService(jmodel, jp, JaxPrompting(JaxTokenizer(base_vocab=49)), t2i_batch=2,
                      mmu_batch=2, mmu_max_new=MAX_NEW, dtype=jnp.float32, cache_dtype=None)
    tsvc = make_service(tmodel, tp)
    return jmodel, tmodel, jp, tp, jsvc, tsvc


def make_service(tmodel, tp, **kw):
    kw = {"t2i_batch": 2, "mmu_batch": 2, "mmu_max_new": MAX_NEW, "dtype": torch.float32,
          "cache_dtype": None, "device": "cpu", **kw}
    return srv.OmniMambaService(tmodel, tp, UniversalPrompting(OfflineTokenizer(base_vocab=49)),
                                **kw)


def start(service, **kw):
    server = srv.make_server(service, host="127.0.0.1", port=0, max_wait_ms=15, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def stop(server, thread):
    server.shutdown()
    server.server_close()
    server.stop_batchers()
    thread.join(timeout=5)
    assert not any(lane.is_alive() for lane in server.lanes.values())


@pytest.fixture(scope="module")
def url(pair):
    server, thread, base = start(pair[5])
    yield base
    stop(server, thread)


@pytest.fixture(scope="module")
def continuous_url(pair):
    server, thread, base = start(pair[5], continuous_mmu=True, continuous_slots=2,
                                 continuous_chunk=4)
    yield base
    stop(server, thread)


def post(url, obj, expect=200):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    assert code == expect, (code, body)
    return body


def get(url):
    with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
        return json.loads(r.read())


def png_b64(seed, shape=(SIDE, SIDE)):
    img = np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)
    return base64.b64encode(encode_png(img)).decode()


def pixels(body):
    return decode_png(base64.b64decode(body["image_png_b64"]))


def test_healthz_and_bad_route(url):
    assert get(url + "/healthz") == {"status": "ok"}
    assert post(url + "/nope", {}, expect=404) == {"error": "not found"}
    with pytest.raises(urllib.error.HTTPError) as e:
        get(url + "/nope")
    assert e.value.code == 404


def test_a_burst_of_connections_is_not_dropped(url):
    """32 clients connect at once while another thread holds the GIL (as a
    lane's decode loop does): none waits out the one-second SYN resend that
    socketserver's backlog of 5 causes."""
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            sum(range(1000))

    def one(_):
        t = time.perf_counter()
        get(url + "/healthz")
        return time.perf_counter() - t

    spinner = threading.Thread(target=busy)
    spinner.start()
    try:
        for _ in range(3):
            with concurrent.futures.ThreadPoolExecutor(32) as ex:
                worst = max(ex.map(one, range(32)))
            assert worst < 1.0, worst
    finally:
        stop.set()
        spinner.join(timeout=5)


# ---------------------------------------------------------------------------
# text to image
# ---------------------------------------------------------------------------

T2I_PAYLOADS = {"fixed": {"prompt": "a red cat on a mat"},
                "ragged": {"prompt": "a short dog", "raw_caption": True}}


@pytest.mark.parametrize("kind", sorted(T2I_PAYLOADS))
def test_t2i_matches_the_direct_call_and_jax(pair, url, kind):
    jmodel, tmodel, jp, tp, jsvc, tsvc = pair
    payload = T2I_PAYLOADS[kind]
    got = pixels(post(url + "/v1/t2i", payload))  # alone: a batch of one, padded to two
    assert got.shape == (8, 8, 3)
    ids, lens = tsvc.t2i_inputs([payload, payload])
    assert (lens is None) == (kind == "fixed")
    with torch.no_grad():
        img_t, tok_t = t2i_generate(tp, tmodel, ids, sample=SampleParams(top_k=1),
                                    dtype=torch.float32, cache_dtype=None, text_lengths=lens,
                                    device="cpu")
    np.testing.assert_array_equal(got, from_vq_range(img_t[0]).numpy())
    img_j, tok_j = jom.t2i_generate(
        jp, jmodel, jnp.asarray(ids), sample=JSampleParams(top_k=1), dtype=jnp.float32,
        cache_dtype=None, text_lengths=None if lens is None else jnp.asarray(lens))
    np.testing.assert_array_equal(nn(tok_t), np.asarray(tok_j))
    np.testing.assert_allclose(nn(img_t), np.asarray(img_j), rtol=IMG_TOL, atol=IMG_TOL)
    # the JAX service's PNG of the same request: uint8 of images within IMG_TOL
    want = jsvc.t2i_batch_fn([payload])[0]
    from PIL import Image

    jpx = np.asarray(Image.open(io.BytesIO(base64.b64decode(want["image_png_b64"]))))
    assert np.abs(got.astype(int) - jpx.astype(int)).max() <= 1


def test_t2i_concurrent_mixed_batch(url):
    """A fixed-block and a raw-caption request at once: both answer, each
    within one level of its solo image (a ragged row's stream is its solo
    stream; the VQ decoder's sums may round apart by batch)."""
    solo = {k: pixels(post(url + "/v1/t2i", p)) for k, p in T2I_PAYLOADS.items()}
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = {k: ex.submit(post, url + "/v1/t2i", p) for k, p in T2I_PAYLOADS.items()}
        both = {k: pixels(f.result(timeout=HTTP_TIMEOUT)) for k, f in futs.items()}
    for k in solo:
        assert np.abs(both[k].astype(int) - solo[k].astype(int)).max() <= 1, k


def test_t2i_sampler_settings_are_clamped(pair):
    assert {srv.t2i_settings({"temperature": t, "top_k": 2})[1]
            for t in (0.004, 0.051, 0.08, 1e9, -3.0)} == {0.1, 4.0}
    for junk in (float("nan"), "warm", None):
        assert srv.t2i_settings({"temperature": junk}) == (1, 1.0)
    assert srv.t2i_settings({"top_k": 500, "temperature": 0.26}) == (64, 0.3)
    assert srv.t2i_settings({"top_k": -4}) == (0, 1.0)
    assert srv.mmu_penalty({"repetition_penalty": 1.83}) == 1.85
    assert [srv.mmu_penalty({"repetition_penalty": v}) for v in ("nope", float("nan"), 9, 0.2)] == [
        1.0, 1.0, 2.0, 1.0]
    tsvc = pair[5]
    for t in (0.004, 1e9, float("nan")):
        out = tsvc.t2i_batch_fn([{"prompt": "a red square", "temperature": t, "top_k": 2}])
        assert pixels(out[0]).shape == (8, 8, 3)


def test_t2i_mixed_sampler_settings_take_their_own_group(pair):
    """R2: the JAX server samples a whole batch with the first request's
    settings; here a greedy request beside a sampled one keeps its greedy
    image, bit for bit."""
    tsvc = pair[5]
    greedy = {"prompt": "a blue bird"}
    sampled = {"prompt": "a blue bird", "top_k": 8, "temperature": 4.0}
    alone = tsvc.t2i_batch_fn([greedy])[0]
    mixed = tsvc.t2i_batch_fn([sampled, greedy])
    assert mixed[1] == alone


# ---------------------------------------------------------------------------
# image understanding
# ---------------------------------------------------------------------------

QUESTIONS = ["hi", "what exactly is shown in this particular image please"]


def test_mmu_batch_ragged_and_solo_match_jax(pair, url):
    jsvc = pair[4]
    reqs = [{"image_png_b64": png_b64(s), "question": q} for s, q in zip((1, 2), QUESTIONS)]
    want = [jsvc.mmu_batch_fn([r])[0]["text"] for r in reqs]
    solo = [post(url + "/v1/mmu", r)["text"] for r in reqs]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        both = [f.result(timeout=HTTP_TIMEOUT) for f in
                [ex.submit(post, url + "/v1/mmu", r) for r in reqs]]
    assert solo == want
    assert [b["text"] for b in both] == want
    assert pair[5].mmu_batch_fn(reqs) == [{"text": t} for t in want]  # one ragged batch


def test_mmu_speculative_lane_matches_jax(pair, url):
    jsvc = pair[4]
    req = {"image_png_b64": png_b64(3), "question": "what is here"}
    fast = post(url + "/v1/mmu", {**req, "low_latency": True})
    assert fast["lane"] == "speculative"
    assert fast["text"] == jsvc.mmu_single_fn([req])[0]["text"] == jsvc.mmu_batch_fn([req])[0]["text"]


def test_mmu_continuous_lane_matches_jax(pair, continuous_url):
    jsvc = pair[4]
    reqs = [{"image_png_b64": png_b64(s), "question": q} for s, q in zip((4, 5), QUESTIONS)]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        got = [f.result(timeout=HTTP_TIMEOUT) for f in
               [ex.submit(post, continuous_url + "/v1/mmu", r) for r in reqs]]
    assert [g["lane"] for g in got] == ["continuous"] * 2
    assert [g["text"] for g in got] == [jsvc.mmu_batch_fn([r])[0]["text"] for r in reqs]


def test_mmu_resizes_other_sizes(pair, url):
    """An image of another size than the towers' is resized (PIL's bicubic,
    ``resize_uint8``); one of the towers' size is taken as it is."""
    from omnimamba_tpu_torch.data.llava import resize_uint8

    tsvc = pair[5]
    img = np.random.default_rng(6).integers(0, 256, (40, 70, 3), dtype=np.uint8)
    req = {"image_png_b64": base64.b64encode(encode_png(img)).decode(), "question": "what"}
    np.testing.assert_array_equal(tsvc.mmu_image(req), resize_uint8(img, SIDE))
    same = {"image_png_b64": png_b64(7)}
    np.testing.assert_array_equal(tsvc.mmu_image(same), decode_png(base64.b64decode(same["image_png_b64"])))
    assert isinstance(post(url + "/v1/mmu", req)["text"], str)


def test_mmu_mixed_penalty_batch_gives_each_row_its_solo_stream(pair):
    """R2: the JAX server applies the first request's repetition penalty to
    every row (its row 1 answers as if it had no penalty); here each penalty
    takes its own group and each row answers as it does alone."""
    jsvc, tsvc = pair[4], pair[5]
    img = png_b64(8)
    plain = {"image_png_b64": img, "question": "describe please describe"}
    pen = {**plain, "repetition_penalty": 2.0}
    solo = [tsvc.mmu_batch_fn([r])[0]["text"] for r in (plain, pen)]
    assert solo[0] != solo[1], "the penalty must change this stream for the test to hold anything"
    assert tsvc.mmu_batch_fn([plain, pen]) == [{"text": t} for t in solo]
    assert jsvc.mmu_batch_fn([plain, pen])[1]["text"] == solo[0]  # the JAX fault


def test_bad_image_fails_its_own_request_only(pair, url, monkeypatch):
    """An image the server cannot read (a JPEG where PIL is missing, as on
    the card's machine; a PNG that fails its CRC; no image) gets a 400 of
    its own, and a good request sent beside them, which would share their
    batch, gets JAX's text. The JAX server decodes inside the batch, where
    one bad image fails every request of it."""
    from PIL import Image

    jsvc = pair[4]
    good = {"image_png_b64": png_b64(14), "question": "what"}
    want = jsvc.mmu_batch_fn([good])[0]["text"]  # the JAX service decodes through PIL
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(15).integers(0, 256, (SIDE, SIDE, 3), dtype=np.uint8)).save(
        buf, format="JPEG")
    damaged = bytearray(base64.b64decode(png_b64(16)))
    damaged[40] ^= 0xFF  # inside the IDAT chunk
    bad = [{"image_png_b64": base64.b64encode(b).decode(), "question": "what"}
           for b in (buf.getvalue(), bytes(damaged))]
    monkeypatch.setitem(sys.modules, "PIL", None)
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(post, url + "/v1/mmu", good)] + [
            ex.submit(post, url + "/v1/mmu", b, 400) for b in bad]
        got = [f.result(timeout=HTTP_TIMEOUT) for f in futs]
    assert got[0] == {"text": want}
    assert got[1]["error"].startswith("ImportError") and "needs PIL" in got[1]["error"]
    assert got[2]["error"].startswith("ValueError") and "CRC" in got[2]["error"]
    assert post(url + "/v1/mmu", {"question": "no image"}, expect=400)["error"].startswith("KeyError")


def test_merged_service_refuses_the_other_task(pair):
    """A merged service takes params already merged; it keeps the task
    guard, and refuses params that still hold LoRA."""
    _, tmodel, _, tp, _, _ = pair
    with pytest.raises(ValueError, match="still hold LoRA"):
        make_service(tmodel, tp, merge_lora_task="mmu")
    merged = make_service(tmodel, merge_lora(tp, "mmu", tmodel.cfg.lora), merge_lora_task="mmu")
    assert all("lora" not in layer["mixer"] for layer in merged.params["mamba"]["layers"])
    assert all("lora" in layer["mixer"] for layer in tp["mamba"]["layers"])  # input untouched
    out = merged.mmu_batch_fn([{"image_png_b64": png_b64(9), "question": "what color?"}])
    assert isinstance(out[0]["text"], str)
    with pytest.raises(RuntimeError, match="merged for task"):
        merged.t2i_batch_fn([{"prompt": "a red square"}])


# ---------------------------------------------------------------------------
# the continuous lane's faults (R2)
# ---------------------------------------------------------------------------


def test_failed_tick_fails_pending_requests_and_routes_to_the_batcher(pair):
    tsvc = pair[5]
    server, thread, base = start(tsvc, continuous_mmu=True, continuous_slots=2, continuous_chunk=4)
    try:
        engine = server.cont_lane.engine
        real_tick = engine.tick

        def tick():
            if engine.pending():
                raise RuntimeError("device lost")
            return real_tick()

        engine.tick = tick
        req = {"image_png_b64": png_b64(10), "question": "what"}
        t0 = time.time()
        assert "device lost" in post(base + "/v1/mmu", req, expect=500)["error"]
        assert time.time() - t0 < 30  # failed at once, not at the lane's 300-s timeout
        assert get(base + "/healthz")["continuous_lane"] == "dead"
        assert server.cont_lane.error == "RuntimeError: device lost"
        after = post(base + "/v1/mmu", req)  # the static batcher answers
        assert "lane" not in after and after["text"] == tsvc.mmu_batch_fn([req])[0]["text"]
    finally:
        stop(server, thread)


def test_cancel_frees_the_queue_entry_and_the_slot(pair):
    """A queued request leaves the queue at once; one that holds a slot
    frees it at the next chunk boundary, and the slot is reused there."""
    _, tmodel, _, tp, _, tsvc = pair
    engine = SlotEngine(tp["mamba"], tmodel.cfg, n_slots=1, chunk=2, task="mmu",
                        dtype=torch.float32, eos_token_id=None, max_new_default=40, device="cpu")
    emb, plen = tsvc.mmu_build_embedding({"image_png_b64": png_b64(11), "question": "a"})
    first, queued = engine.submit(emb, plen), engine.submit(emb, plen)
    engine.tick()  # first takes the slot
    assert engine.pending() == [queued, first]
    engine.cancel(queued, "gone")
    assert queued.done.is_set() and queued.error == "gone" and engine.pending() == [first]
    engine.cancel(first)
    assert first.done.is_set() and first.error == "cancelled"
    n_tokens = len(first.tokens)
    third = engine.submit(emb, plen, max_new=5)
    engine.tick()  # the boundary: first frees its slot, third takes it
    assert engine.pending() == [third] and len(first.tokens) == n_tokens
    engine.run_until_drained()
    assert third.done.is_set() and third.error is None and len(third.tokens) == 5
    engine.cancel(third)  # a finished request is left as it is
    assert third.error is None


def test_lane_timeout_cancels_the_request(pair):
    """The JAX lane leaves a timed-out request in its queue or slot; here
    the lane cancels it."""
    tsvc = pair[5]
    lane = srv.ContinuousMMULane(tsvc, n_slots=1, chunk=2, max_new=MAX_NEW)  # not started
    with pytest.raises(TimeoutError, match="timeout"):
        lane.submit({"image_png_b64": png_b64(12), "question": "a"}, timeout=0.05)
    assert lane.engine.pending() == []


def test_warmup_starts_at_the_smallest_reachable_bucket(pair, monkeypatch):
    _, tmodel, _, _, _, tsvc = pair
    n_img = tmodel.vision_cfg.num_patches
    assert n_img == 16
    assert srv.warmup_prompt_lens(729, 32) == [736, 768, 800]  # JAX warms 768, 800, 832
    seen = []
    real = SlotEngine.warmup
    monkeypatch.setattr(SlotEngine, "warmup", lambda self, lens: seen.append(lens) or real(self, lens))
    lane = srv.ContinuousMMULane(tsvc, n_slots=2, chunk=2, max_new=MAX_NEW)
    assert seen == [[32, 64, 96]] and lane.warmup_lens == [32, 64, 96] and lane.warmup_s > 0
    shortest = len(tsvc.mmu_prompt({"question": ""})) + n_img
    assert n_img + 5 <= shortest <= 32


# ---------------------------------------------------------------------------
# the batcher (JAX's tests, ported)
# ---------------------------------------------------------------------------


def _slow_batcher():
    started, release = threading.Event(), threading.Event()

    def slow_batch(payloads):
        started.set()
        release.wait(timeout=10)
        return [{"ok": True} for _ in payloads]

    lane = srv._Batcher("test", slow_batch, 1, 0.0)
    lane.start()
    return lane, started, release


def _wait_idle(lane):
    for _ in range(100):
        if lane.idle():
            break
        time.sleep(0.05)
    assert lane.idle()


def test_batcher_inflight_routing():
    """idle() and submit_if_idle count in-flight work, atomically: the
    worker dequeues at once, so an empty queue is not an idle lane."""
    lane, started, release = _slow_batcher()
    assert lane.idle()
    res = [None]
    t = threading.Thread(target=lambda: res.__setitem__(0, lane.submit({})))
    t.start()
    assert started.wait(timeout=10)
    assert lane.queue.empty() and not lane.idle()
    assert lane.submit_if_idle({}) is None
    release.set()
    t.join(timeout=10)
    assert res[0] == {"ok": True}
    _wait_idle(lane)
    assert lane.submit_if_idle({}) == {"ok": True}
    lane.stop()
    lane.join(timeout=5)


def test_batcher_timeout_keeps_lane_busy():
    """A decode that outlives its client's timeout still occupies the lane."""
    lane, started, release = _slow_batcher()
    with pytest.raises(TimeoutError):
        lane.submit({}, timeout=0.05)
    assert started.is_set() and not lane.idle()
    assert lane.submit_if_idle({}) is None
    release.set()
    _wait_idle(lane)
    lane.stop()
    lane.join(timeout=5)


def test_batcher_drains_queue_on_stop():
    """Requests still queued when the worker exits fail at once and release
    their count."""
    lane, _, release = _slow_batcher()
    results = []

    def bg():
        try:
            results.append(lane.submit({}, timeout=30))
        except RuntimeError as e:
            results.append(str(e))

    threads = [threading.Thread(target=bg) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)  # the worker holds one; the others queue behind it
    lane.stop()
    lane.join(timeout=5)
    release.set()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 3 and {"ok": True} in results
    assert "RuntimeError: batch worker stopped" in results
    _wait_idle(lane)


# ---------------------------------------------------------------------------
# the kernel library's first build, from two threads at once
# ---------------------------------------------------------------------------


def test_concurrent_first_builds_run_once(monkeypatch, tmp_path):
    """Eight threads ask for the library at once with nvcc absent: one build
    is tried; the others wait for it and get its failure, not a build."""
    attempts = []

    def no_nvcc():
        attempts.append(threading.get_ident())
        time.sleep(0.2)  # long enough for the other threads to arrive
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernel_build, "_find_nvcc", no_nvcc)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_build, "_LOADED", {})
    errors = []

    def load():
        try:
            kernel_build.load_kernels()
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(attempts) == 1
    assert sorted(errors) == ["nvcc not found"] + [
        "the kernel library failed to build or load earlier in this process "
        "(the first call raised the cause)"] * 7


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------


def test_serve_cli_merges_then_quantizes():
    from omnimamba_tpu_torch.scripts import serve
    from tests.test_torch_mmu import TINY_YAML

    args = serve.parse_args(["--config", TINY_YAML, "--device", "cpu", "--dtype", "float32",
                             "--merge-lora-task", "t2i", "--int8", "--int8-state",
                             "--t2i-batch", "2", "--port", "0"])
    service = serve.build_service(args)
    layers = service.params["mamba"]["layers"]
    assert all("lora" not in layer["mixer"] for layer in layers)
    assert all(layer["mixer"]["in_proj"]["kernel"]["q"].dtype == torch.int8 for layer in layers)
    assert service.merged_task == "t2i" and service.cache_dtype == "int8"
    server, thread, base = start(service)
    try:
        assert get(base + "/healthz") == {"status": "ok"}
        assert pixels(post(base + "/v1/t2i", {"prompt": "a cat"})).shape == (256, 256, 3)
        refused = post(base + "/v1/mmu", {"image_png_b64": png_b64(13), "question": "?"}, expect=500)
        assert "merged for task 't2i'" in refused["error"]
    finally:
        stop(server, thread)
    assert serve.parse_args(["--bf16-state"]).bf16_state and serve.parse_args([]).device == "cuda"
