"""The whole-model fused decode step of the PyTorch port against the JAX
package's, on the CPU, and against the port's own layer-by-layer path.

The JAX side runs ``fused_decode_step`` as its own tests do off the TPU: the
Pallas kernel in interpret mode (its default there). The port runs the plain
version of its CUDA kernel, which repeats the kernel's rounding points.
Everything is fp32 on the tiny geometry, LoRA B factors filled so the branch
counts. Tolerances are the JAX test's own (``tests/test_decode_fused.py``):
1e-5 for one step, 1e-4 for four consecutive steps.
"""

import dataclasses

import jax.numpy as jnp
import jax.random
import numpy as np
import pytest
import torch

from omnimamba_tpu.models import backbone as jbb
from omnimamba_tpu.models.generation import generate as j_generate
from omnimamba_tpu.models.omnimamba import init_omnimamba
from omnimamba_tpu.ops.decode_fused import to_fused_cache
from omnimamba_tpu.ops.sampling import SampleParams as JSampleParams
from omnimamba_tpu_torch import SampleParams, generate
from omnimamba_tpu_torch.config import LoraConfig
from omnimamba_tpu_torch.models import backbone as tbb
from omnimamba_tpu_torch.models import generation as tgen
from omnimamba_tpu_torch.models.blocks import block_step
from omnimamba_tpu_torch.models.mamba2 import Mamba2Cache
from omnimamba_tpu_torch.ops import kernel_build
from omnimamba_tpu_torch.ops.decode_fused import (
    fused_decode_limits, fused_decode_step, fused_decode_step_plain,
)
from omnimamba_tpu_torch.ops.quant import quantize_linear
from tests.test_torch_helpers import bridge, decode_side, fill_lora_b, nn, tiny_models, tt

L0 = 6  # prompt length


def close(got, want, tol):
    np.testing.assert_allclose(nn(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def pair():
    """(jax model, torch model, jax backbone params, bridged torch params), fp32."""
    jmodel, tmodel = tiny_models()
    jp = init_omnimamba(jax.random.PRNGKey(0), jmodel, with_vision=False)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(0))
    jp = {"mamba": {**jp["mamba"], "layers": layers}, "vq": decode_side(jp["vq"])}
    return jmodel, tmodel, jp["mamba"], bridge(jp, tmodel)["mamba"]


def prefill(pair, task, B, seed):
    """The same prefilled decode state on both sides (made by the JAX package),
    and a token per row."""
    jmodel, _, jm, _ = pair
    rng = np.random.default_rng(seed)
    emb = (0.5 * rng.standard_normal((B, L0, 32))).astype(np.float32)
    _, jcache = jbb.backbone_forward(jm, jnp.asarray(emb), task, jmodel.cfg,
                                     scan_impl="chunked", return_cache=True)
    tcache = tbb.BackboneCache(tt(jcache.conv_state), tt(jcache.ssm_state))
    tok = rng.integers(0, 32, (B,))
    return jcache, tcache, tok


def assert_caches_close(fcache, tcache, B, d_inner, tol):
    """JAX splits the conv window into x and bc and pads the batch to 8; the
    port keeps one fused window and the real rows."""
    close(tcache.conv_state[..., :d_inner], np.asarray(fcache.conv_x)[:, :B], tol)
    close(tcache.conv_state[..., d_inner:], np.asarray(fcache.conv_bc)[:, :B], tol)
    n_layer, _, H, P, N = tcache.ssm_state.shape
    close(tcache.ssm_state.reshape(n_layer, B, H * P, N), np.asarray(fcache.ssm)[:, :B], tol)


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("task", ["t2i", "mmu"])
def test_fused_step_matches_jax(pair, task, B):
    jmodel, tmodel, jm, tm = pair
    jcache, tcache, tok = prefill(pair, task, B, seed=B)
    d_inner = jmodel.cfg.mixer.d_inner
    hj, fcache = jbb.backbone_step_fused(
        jm, jnp.asarray(tok, jnp.int32), jnp.int32(L0), to_fused_cache(jcache, d_inner),
        task, jmodel.cfg, dtype=jnp.float32)
    ht, out = tbb.backbone_step_fused(tm, tt(tok), L0, tcache, task, tmodel.cfg, dtype=torch.float32)
    assert ht.shape == (B, 32) and fcache.ssm.shape[1] == 8  # no padding on the port's side
    close(ht, hj, 1e-5)
    assert_caches_close(fcache, out, B, d_inner, 1e-5)


@pytest.mark.parametrize("task", ["t2i", "mmu"])
def test_four_consecutive_fused_steps_match_jax(pair, task):
    jmodel, tmodel, jm, tm = pair
    jcache, tcache, tok = prefill(pair, task, 2, seed=7)
    d_inner = jmodel.cfg.mixer.d_inner
    fcache = to_fused_cache(jcache, d_inner)
    for i in range(4):
        hj, fcache = jbb.backbone_step_fused(
            jm, jnp.asarray(tok, jnp.int32), jnp.int32(L0 + i), fcache, task, jmodel.cfg,
            dtype=jnp.float32)
        ht, tcache = tbb.backbone_step_fused(
            tm, tt(tok), L0 + i, tcache, task, tmodel.cfg, dtype=torch.float32)
        close(ht, hj, 1e-4)
        tok = (tok + 7) % 32
    assert_caches_close(fcache, tcache, 2, d_inner, 1e-4)


@pytest.mark.parametrize("task", ["t2i", "mmu", None])
def test_fused_plain_step_matches_the_layer_loop(pair, task):
    """Inside the port: the fused step's plain version against ``block_step``
    layer by layer, hidden, residual, window and state; the cache object is
    updated in place."""
    _, tmodel, _, tm = pair
    cfg = tmodel.cfg
    _, cache, _ = prefill(pair, "t2i", 3, seed=11)
    ref = tbb.BackboneCache(cache.conv_state.clone(), cache.ssm_state.clone())
    before = cache.ssm_state.clone()
    h0 = tt((0.5 * np.random.default_rng(12).standard_normal((3, 32))).astype(np.float32))

    h, residual = h0, None
    for i, layer in enumerate(tm["layers"]):
        h, residual, _ = block_step(
            layer, h, residual, Mamba2Cache(ref.conv_state[i], ref.ssm_state[i]), task,
            cfg.mixer, cfg.lora, norm_eps=cfg.norm_eps)
    conv_obj, ssm_obj = cache.conv_state, cache.ssm_state
    hf, rf, out = fused_decode_step(tm["layers"], h0, None, cache, task, cfg.mixer, cfg.lora,
                                    cfg.norm_eps)
    close(hf, nn(h), 1e-5)
    close(rf, nn(residual), 1e-5)
    close(out.conv_state, nn(ref.conv_state), 1e-5)
    close(out.ssm_state, nn(ref.ssm_state), 1e-5)
    assert rf.dtype == torch.float32
    assert out.conv_state is conv_obj and out.ssm_state is ssm_obj
    assert not torch.equal(ssm_obj, before), "the caller's state tensor holds the new state"
    # an incoming residual is added before the first norm
    r0 = torch.ones(3, 32)
    c1 = tbb.BackboneCache(ref.conv_state.clone(), ref.ssm_state.clone())
    c2 = tbb.BackboneCache(ref.conv_state.clone(), ref.ssm_state.clone())
    a = fused_decode_step_plain(tm["layers"], h0, r0, c1, task, cfg.mixer, cfg.lora, cfg.norm_eps)
    b = fused_decode_step_plain(tm["layers"], h0 + 1.0, None, c2, task, cfg.mixer, cfg.lora,
                                cfg.norm_eps)
    close(a[0], nn(b[0]), 1e-6)


def embed(pair, task, ids):
    """(jax embeddings, torch embeddings) of a prompt, positions applied."""
    _, _, jm, tm = pair
    if task == "t2i":
        ej = jbb.caption_embed(jm, jbb.embed_text(jm, jnp.asarray(ids), jnp.float32))
        et = tbb.caption_embed(tm, tbb.embed_text(tm, tt(ids), torch.float32))
        n = ids.shape[1]
        return ej + jm["pos_embed"][:, :n], et + tm["pos_embed"][:, :n]
    return (jbb.embed_text(jm, jnp.asarray(ids), jnp.float32),
            tbb.embed_text(tm, tt(ids), torch.float32))


def port_generate(pair, task, ids, emb, new=12, **kw):
    _, tmodel, _, tm = pair
    kw.setdefault("cache_dtype", None)
    return generate(tm, tmodel.cfg, input_ids=tt(ids), input_embeddings=emb, task=task,
                    max_length=ids.shape[1] + new, sample=SampleParams(top_k=1),
                    device="cpu", **kw)


def jax_generate(pair, task, ids, emb, new=12, **kw):
    jmodel, _, jm, _ = pair
    return j_generate(jm, jmodel.cfg, input_ids=jnp.asarray(ids, jnp.int32), input_embeddings=emb,
                      task=task, max_length=ids.shape[1] + new, sample=JSampleParams(top_k=1),
                      scan_impl="chunked", cache_dtype=None, decode_impl="fused", **kw)


def assert_streams_equal(got, want, logits, what):
    """Equal token streams; where they differ, say how close the top two
    logits of the port's fused run were at the first differing step."""
    got, want = nn(got), np.asarray(want)
    if np.array_equal(got, want):
        return
    b, step = np.argwhere(got != want)[0]
    prompt = got.shape[1] - len(logits)  # one logits entry per generated position
    top2 = torch.topk(logits[step - prompt][b], 2).values
    raise AssertionError(
        f"{what}: streams differ first at row {b} position {step}: {got[b, step]} vs "
        f"{want[b, step]}; top-2 logit margin there {float(top2[0] - top2[1]):.3e}")


@pytest.mark.parametrize("task", ["t2i", "mmu"])
def test_generate_fused_streams(pair, task):
    ids = np.random.default_rng(21).integers(0, 32, (2, L0))
    ej, et = embed(pair, task, ids)
    fused = port_generate(pair, task, ids, et, decode_impl="fused", return_logits=True)
    scan = port_generate(pair, task, ids, et, decode_impl="scan")
    ref = jax_generate(pair, task, ids, ej)
    assert fused.num_generated == 12 and fused.sequences.shape == (2, L0 + 12)
    assert_streams_equal(fused.sequences, scan.sequences, fused.logits, "port fused vs port scan")
    assert_streams_equal(fused.sequences, ref.sequences, fused.logits, "port fused vs JAX fused")


def test_generate_fused_with_cfg(pair):
    cond = np.random.default_rng(22).integers(0, 32, (2, L0))
    ids = np.concatenate([cond, np.full_like(cond, 49)], axis=0)  # [cond; uncond]
    ej, et = embed(pair, "t2i", ids)
    fused = port_generate(pair, "t2i", ids, et, decode_impl="fused", cfg_scale=7.5,
                          return_logits=True)
    scan = port_generate(pair, "t2i", ids, et, decode_impl="scan", cfg_scale=7.5)
    ref = jax_generate(pair, "t2i", ids, ej, cfg_scale=7.5)
    assert_streams_equal(fused.sequences, scan.sequences, fused.logits, "port fused vs port scan")
    assert_streams_equal(fused.sequences, ref.sequences, fused.logits, "port fused vs JAX fused")
    assert torch.equal(fused.sequences[:2, L0:], fused.sequences[2:, L0:])  # one draw per image


def test_generate_fused_ragged(pair):
    ids = np.random.default_rng(23).integers(0, 32, (3, 10))
    lens = np.array([10, 6, 8], np.int32)
    ej, et = embed(pair, "mmu", ids)
    fused = port_generate(pair, "mmu", ids, et, decode_impl="fused", prompt_lengths=tt(lens),
                          return_logits=True)
    scan = port_generate(pair, "mmu", ids, et, decode_impl="scan", prompt_lengths=tt(lens))
    ref = jax_generate(pair, "mmu", ids, ej, prompt_lengths=jnp.asarray(lens))
    assert_streams_equal(fused.sequences, scan.sequences, fused.logits, "port fused vs port scan")
    assert_streams_equal(fused.sequences, ref.sequences, fused.logits, "port fused vs JAX fused")
    # each ragged row's stream is its solo stream
    _, et1 = embed(pair, "mmu", ids[1:2, :6])
    solo = port_generate(pair, "mmu", ids[1:2, :6], et1, decode_impl="fused")
    assert torch.equal(solo.sequences[0, 6:], fused.sequences[1, 10:])


def test_generate_fused_replay_callback_and_logits(pair):
    """``teacher_outputs``, ``token_callback`` and ``return_logits`` on the
    fused path: replayed logits equal the layer-by-layer path's (1e-4, fp32,
    another order of the same sums)."""
    ids = np.random.default_rng(24).integers(0, 32, (2, L0))
    _, et = embed(pair, "t2i", ids)
    teacher = torch.cat([tt(ids), tt(np.random.default_rng(25).integers(0, 32, (2, 12)))], dim=1)
    seen = []
    fused = port_generate(pair, "t2i", ids, et, decode_impl="fused", teacher_outputs=teacher,
                          token_callback=seen.append, return_logits=True)
    scan = port_generate(pair, "t2i", ids, et, decode_impl="scan", teacher_outputs=teacher,
                         return_logits=True)
    assert torch.equal(fused.sequences, teacher)
    np.testing.assert_array_equal(np.stack(seen, 1), nn(teacher[:, L0:]))
    close(torch.stack(fused.logits), nn(torch.stack(scan.logits)), 1e-4)


def test_generate_fused_bf16_state(pair):
    """``cache_dtype=torch.bfloat16`` on the fused path: the SSM state is
    rounded to bf16 on every store, so replayed logits agree with the fp32
    state's at bf16 scale (4 x 2^-7 of the largest logit, the bound the
    layer-by-layer path is held to), not at fp32 scale."""
    ids = np.random.default_rng(26).integers(0, 32, (2, L0))
    _, et = embed(pair, "t2i", ids)
    free = port_generate(pair, "t2i", ids, et, decode_impl="fused")
    common = dict(decode_impl="fused", teacher_outputs=free.sequences, return_logits=True)
    l32 = torch.stack(port_generate(pair, "t2i", ids, et, **common).logits)
    l16 = torch.stack(port_generate(pair, "t2i", ids, et, cache_dtype=torch.bfloat16, **common).logits)
    scale = float(l32.abs().max())
    err = float((l16 - l32).abs().max())
    assert 0 < err <= 2.0 ** -7 * scale * 4, (err, scale)
    scan16 = torch.stack(port_generate(pair, "t2i", ids, et, cache_dtype=torch.bfloat16,
                                       decode_impl="scan", teacher_outputs=free.sequences,
                                       return_logits=True).logits)
    assert float((l16 - scan16).abs().max()) <= 2.0 ** -7 * scale * 4


def _refusals(pair):
    _, tmodel, _, tm = pair
    cfg = tmodel.cfg
    # int8 projections are taken (tests/test_torch_quant.py); an int8 in_proj
    # beside a dense out_proj is not
    quantized = [{**layer, "mixer": {**layer["mixer"], "in_proj": {"kernel": quantize_linear(
        layer["mixer"]["in_proj"]["kernel"], (0,))}}} for layer in tm["layers"]]
    return {
        "ngroups": (tm["layers"], dataclasses.replace(cfg.mixer, ngroups=2), cfg.lora,
                    ValueError, "ngroups=1"),
        "lora_nums": (tm["layers"], cfg.mixer, LoraConfig(lora_nums=2), ValueError, "lora_nums=1"),
        "dt_limit": (tm["layers"], dataclasses.replace(cfg.mixer, dt_limit=(0.0, 0.1)), cfg.lora,
                     ValueError, "dt_limit"),
        "int8_weights": (quantized, cfg.mixer, cfg.lora, ValueError, "both int8 or both dense"),
        # fp32 activations (below) on bf16 weights: the kernel has no such instantiation
        "mixed_types": ([_to_bf16(layer) for layer in tm["layers"]], cfg.mixer, cfg.lora,
                        ValueError, "weights' type"),
    }


def _to_bf16(node):
    if isinstance(node, dict):
        return {k: _to_bf16(v) for k, v in node.items()}
    return node.to(torch.bfloat16)


@pytest.mark.parametrize("what", ["ngroups", "lora_nums", "dt_limit", "int8_weights", "mixed_types"])
def test_wrapper_refuses_what_the_kernel_does_not_take(pair, what):
    layers, mixer_cfg, lora_cfg, exc, match = _refusals(pair)[what]
    _, cache, _ = prefill(pair, "t2i", 2, seed=31)
    assert isinstance(fused_decode_limits(layers, mixer_cfg, lora_cfg, torch.float32), exc)
    with pytest.raises(exc, match=match):
        fused_decode_step(layers, torch.zeros(2, 32), None, cache, "t2i", mixer_cfg, lora_cfg)


def test_generate_refuses_fused_with_an_int8_state_and_an_unmet_limit(pair):
    _, tmodel, _, tm = pair
    ids = np.zeros((1, L0), np.int64)
    _, et = embed(pair, "t2i", ids)
    with pytest.raises(ValueError, match="scan path"):
        port_generate(pair, "t2i", ids, et, decode_impl="fused", cache_dtype="int8")
    limited = dataclasses.replace(
        tmodel.cfg, mixer=dataclasses.replace(tmodel.cfg.mixer, dt_limit=(0.0, 0.1)))
    with pytest.raises(ValueError, match="dt_limit"):
        generate(tm, limited, input_ids=tt(ids), input_embeddings=et, task="t2i",
                 max_length=L0 + 2, decode_impl="fused", device="cpu")


@pytest.mark.parametrize("limited", [False, True], ids=["limits_met", "dt_limit_set"])
def test_auto_takes_fused_where_the_limits_are_met(pair, limited, monkeypatch):
    """``decode_impl="auto"`` is decided from the model alone, on the CPU as
    on the card: the fused step wherever the kernel's limits are met, the
    layer-by-layer step elsewhere."""
    _, tmodel, _, tm = pair
    cfg = tmodel.cfg
    if limited:
        cfg = dataclasses.replace(cfg, mixer=dataclasses.replace(cfg.mixer, dt_limit=(0.0, 0.1)))
    calls = {"fused": 0, "scan": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tgen, "backbone_step_fused", counting("fused", tgen.backbone_step_fused))
    monkeypatch.setattr(tgen, "backbone_step", counting("scan", tgen.backbone_step))
    ids = np.zeros((1, L0), np.int64)
    _, et = embed(pair, "t2i", ids)
    generate(tm, cfg, input_ids=tt(ids), input_embeddings=et, task="t2i", max_length=L0 + 5,
             cache_dtype=None, device="cpu")
    assert calls == ({"fused": 0, "scan": 4} if limited else {"fused": 4, "scan": 0})


def test_cpu_tensors_take_the_plain_version(pair):
    """No build, no launch counted; the wrapper's source has no environment
    switch and no try/except around its launch."""
    import inspect
    import re

    from omnimamba_tpu_torch.ops import decode_fused

    _, tmodel, _, tm = pair
    _, cache, _ = prefill(pair, "t2i", 2, seed=41)
    before = fused_decode_step.launches
    fused_decode_step(tm["layers"], torch.zeros(2, 32), None, cache, "t2i", tmodel.cfg.mixer,
                      tmodel.cfg.lora)
    assert fused_decode_step.launches == before
    assert kernel_build.load_kernels.cache_info().currsize == 0
    src = inspect.getsource(decode_fused)
    assert "os.environ" not in src and "is_available" not in src
    assert not re.search(r"^\s*(try|except\b.*):", src, re.M)
    assert (kernel_build.CSRC_DIR / "decode_fused.cu").is_file()
    assert (kernel_build.CSRC_DIR / "ssd_step_row.cuh").is_file()


# A geometry whose step takes the tensor-core products on the card: d, d_inner
# and the in_proj width (2 * 128 + 2 * 28 + 8 = 320) are multiples of 64, so the
# bf16 in_proj there runs its two-block clusters. On the CPU the wrapper runs
# the plain version, the reference the card's kernel is held against.
_WIDE_MIXER = dict(d_model=64, d_state=28, headdim=16, expand=2, chunk_size=16)


@pytest.fixture(scope="module")
def wide_pair():
    """(jax model, torch model, jax backbone params, bridged torch params) at
    d_model 64, fp32, LoRA B factors filled."""
    from omnimamba_tpu import config as jcfg
    from omnimamba_tpu.models.omnimamba import OmniMambaModel as JaxModel
    from omnimamba_tpu_torch import config as tcfg
    from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel as TorchModel
    from tests.test_torch_helpers import _MAMBA, _VQ

    mamba = {**_MAMBA, "d_model": _WIDE_MIXER["d_model"]}
    jmodel = JaxModel(cfg=jcfg.MambaConfig(mixer=jcfg.Mamba2LayerConfig(**_WIDE_MIXER), **mamba),
                      vision_cfg=jcfg.VisionConfig(), vq_cfg=jcfg.VQConfig(**_VQ), sptids={})
    tmodel = TorchModel(cfg=tcfg.MambaConfig(mixer=tcfg.Mamba2LayerConfig(**_WIDE_MIXER), **mamba),
                        vq_cfg=tcfg.VQConfig(**_VQ), sptids={})
    jp = init_omnimamba(jax.random.PRNGKey(1), jmodel, with_vision=False)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(1))
    jp = {"mamba": {**jp["mamba"], "layers": layers}, "vq": decode_side(jp["vq"])}
    return jmodel, tmodel, jp["mamba"], bridge(jp, tmodel)["mamba"]


def _without_lora_jax(jm):
    mixer = {k: v for k, v in jm["layers"]["mixer"].items() if k != "lora"}
    return {**jm, "layers": {**jm["layers"], "mixer": mixer}}


def _without_lora_torch(tm):
    return {**tm, "layers": [{**layer, "mixer": {k: v for k, v in layer["mixer"].items()
                                                  if k != "lora"}} for layer in tm["layers"]]}


@pytest.mark.parametrize("lora", [True, False], ids=["lora", "no_lora"])
@pytest.mark.parametrize("B", [16, 17, 48, 96])
def test_fused_step_matches_jax_on_tensor_core_tiles(wide_pair, B, lora):
    """The fused step at the batches where the card's row tiling changes (16,
    17, 48, 96 rows), with and without the LoRA branch, against JAX's
    ``backbone_step_fused`` (Pallas in interpret mode), fp32, 1e-5."""
    jmodel, tmodel, jm, tm = wide_pair
    mixer = tmodel.cfg.mixer
    assert mixer.d_model % 64 == 0 and mixer.d_inner % 64 == 0 and mixer.d_in_proj % 64 == 0
    if not lora:
        jm, tm = _without_lora_jax(jm), _without_lora_torch(tm)
    rng = np.random.default_rng(100 + B)
    L, W = tmodel.cfg.n_layer, mixer.d_conv
    conv = (0.5 * rng.standard_normal((L, B, W - 1, mixer.d_conv_in))).astype(np.float32)
    ssm = (0.5 * rng.standard_normal(
        (L, B, mixer.nheads, mixer.headdim, mixer.d_state))).astype(np.float32)
    tok = rng.integers(0, 32, (B,))
    hj, fcache = jbb.backbone_step_fused(
        jm, jnp.asarray(tok, jnp.int32), jnp.int32(L0),
        to_fused_cache(jbb.BackboneCache(jnp.asarray(conv), jnp.asarray(ssm)), mixer.d_inner),
        "t2i", jmodel.cfg, dtype=jnp.float32)
    before = fused_decode_step.launches
    ht, out = tbb.backbone_step_fused(tm, tt(tok), L0, tbb.BackboneCache(tt(conv), tt(ssm)),
                                      "t2i", tmodel.cfg, dtype=torch.float32)
    assert fused_decode_step.launches == before  # CPU tensors: the plain version
    close(ht, hj, 1e-5)
    assert_caches_close(fcache, out, B, mixer.d_inner, 1e-5)


# The geometry of the card's SSM-phase tile: headdim 64 and d_state 128, so a
# (row, head) state tile is P x N = 64 x 128, as in every layer of the 1.3B.
_TILE_MIXER = dict(d_model=64, d_state=128, headdim=64, expand=2, chunk_size=16)


@pytest.fixture(scope="module")
def tile_pair():
    """(jax model, torch model, jax backbone params, bridged torch params) at
    d_model 64, headdim 64, d_state 128, fp32, LoRA B factors filled."""
    from omnimamba_tpu import config as jcfg
    from omnimamba_tpu.models.omnimamba import OmniMambaModel as JaxModel
    from omnimamba_tpu_torch import config as tcfg
    from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel as TorchModel
    from tests.test_torch_helpers import _MAMBA, _VQ

    mamba = {**_MAMBA, "d_model": _TILE_MIXER["d_model"]}
    jmodel = JaxModel(cfg=jcfg.MambaConfig(mixer=jcfg.Mamba2LayerConfig(**_TILE_MIXER), **mamba),
                      vision_cfg=jcfg.VisionConfig(), vq_cfg=jcfg.VQConfig(**_VQ), sptids={})
    tmodel = TorchModel(cfg=tcfg.MambaConfig(mixer=tcfg.Mamba2LayerConfig(**_TILE_MIXER), **mamba),
                        vq_cfg=tcfg.VQConfig(**_VQ), sptids={})
    jp = init_omnimamba(jax.random.PRNGKey(2), jmodel, with_vision=False)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(2))
    jp = {"mamba": {**jp["mamba"], "layers": layers}, "vq": decode_side(jp["vq"])}
    return jmodel, tmodel, jp["mamba"], bridge(jp, tmodel)["mamba"]


@pytest.mark.parametrize("state", ["fp32", "bf16"])
@pytest.mark.parametrize("B", [1, 5, 16, 48])
def test_fused_step_matches_jax_on_the_ssm_tile(tile_pair, B, state):
    """The fused step at the card's SSM tile (P x N = 64 x 128) against JAX's
    ``backbone_step_fused`` (Pallas in interpret mode), fp32 activations. With
    an fp32 state every output is held to 1e-5. With a bf16 state both sides
    update in fp32 (y from the unrounded state) and round only the stored
    state to bf16, so h and the conv windows are still held to 1e-5. The two
    fp32 values of a state element differ in their last bits (another exp,
    another order), and where they lie on either side of a bf16 rounding
    boundary the stored values are adjacent bf16 numbers: one unit in the last
    place, up to 2^-7 of the value (half a unit, 2^-8, cannot hold such a
    pair). So each state element is held to one bf16 unit of JAX's,
    ``2^-7 |ref| + 1e-5``, and at most 1e-4 of them may differ at all."""
    jmodel, tmodel, jm, tm = tile_pair
    mixer = tmodel.cfg.mixer
    assert (mixer.headdim, mixer.d_state) == (64, 128)
    rng = np.random.default_rng(200 + B)
    L, W = tmodel.cfg.n_layer, mixer.d_conv
    conv = (0.5 * rng.standard_normal((L, B, W - 1, mixer.d_conv_in))).astype(np.float32)
    ssm = (0.5 * rng.standard_normal(
        (L, B, mixer.nheads, mixer.headdim, mixer.d_state))).astype(np.float32)
    tok = rng.integers(0, 32, (B,))
    sj, st = (jnp.float32, torch.float32) if state == "fp32" else (jnp.bfloat16, torch.bfloat16)
    hj, fcache = jbb.backbone_step_fused(
        jm, jnp.asarray(tok, jnp.int32), jnp.int32(L0),
        to_fused_cache(jbb.BackboneCache(jnp.asarray(conv), jnp.asarray(ssm, sj)), mixer.d_inner),
        "t2i", jmodel.cfg, dtype=jnp.float32)
    before = fused_decode_step.launches
    ht, out = tbb.backbone_step_fused(tm, tt(tok), L0,
                                      tbb.BackboneCache(tt(conv), tt(ssm).to(st)),
                                      "t2i", tmodel.cfg, dtype=torch.float32)
    assert fused_decode_step.launches == before  # CPU tensors: the plain version
    assert out.ssm_state.dtype == st and np.asarray(fcache.ssm).dtype == np.dtype(sj)
    if state == "fp32":
        close(ht, hj, 1e-5)
        assert_caches_close(fcache, out, B, mixer.d_inner, 1e-5)
        return
    di = mixer.d_inner
    close(ht, hj, 1e-5)
    close(out.conv_state[..., :di], np.asarray(fcache.conv_x)[:, :B], 1e-5)
    close(out.conv_state[..., di:], np.asarray(fcache.conv_bc)[:, :B], 1e-5)
    got = nn(out.ssm_state.float()).reshape(L, B, di, mixer.d_state)
    want = np.asarray(fcache.ssm.astype(jnp.float32))[:, :B]
    err = np.abs(got - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 1e-5).all(), float(err.max())
    assert (err > 0).mean() <= 1e-4, int((err > 0).sum())


# The geometries where the card's pre-norm dispatch changes (prenorm_row_fits in
# csrc/decode_fused.cu): d_model 1,024 is a whole number of the early
# pre-norm's rows, 640 is not (the card runs k4_prenorm_kernel there). Both
# are whole tensor-core tiles (in_proj widths 4,160 and 2,624) with d_inner
# above 1,024, so the out_proj is summed in two K splits; LoRA rank 8 or
# none. On the CPU the wrapper runs the plain version, the reference the
# card's kernels are held against.
_PRENORM_MIXERS = {
    1024: dict(d_model=1024, d_state=16, headdim=64, expand=2, chunk_size=16),
    640: dict(d_model=640, d_state=16, headdim=40, expand=2, chunk_size=16),
}


@pytest.fixture(scope="module")
def prenorm_pairs():
    """d_model -> (jax model, torch model, jax backbone params, bridged torch
    params), fp32, LoRA B factors filled; each made on first use."""
    from omnimamba_tpu import config as jcfg
    from omnimamba_tpu.models.omnimamba import OmniMambaModel as JaxModel
    from omnimamba_tpu_torch import config as tcfg
    from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel as TorchModel
    from tests.test_torch_helpers import _MAMBA, _VQ

    made = {}

    def get(d_model):
        if d_model not in made:
            mixer = _PRENORM_MIXERS[d_model]
            mamba = {**_MAMBA, "d_model": d_model}
            jmodel = JaxModel(cfg=jcfg.MambaConfig(mixer=jcfg.Mamba2LayerConfig(**mixer), **mamba),
                              vision_cfg=jcfg.VisionConfig(), vq_cfg=jcfg.VQConfig(**_VQ),
                              sptids={})
            tmodel = TorchModel(cfg=tcfg.MambaConfig(mixer=tcfg.Mamba2LayerConfig(**mixer),
                                                     **mamba),
                                vq_cfg=tcfg.VQConfig(**_VQ), sptids={})
            jp = init_omnimamba(jax.random.PRNGKey(3), jmodel, with_vision=False)
            layers = dict(jp["mamba"]["layers"])
            layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(3))
            jp = {"mamba": {**jp["mamba"], "layers": layers}, "vq": decode_side(jp["vq"])}
            made[d_model] = jmodel, tmodel, jp["mamba"], bridge(jp, tmodel)["mamba"]
        return made[d_model]

    return get


@pytest.mark.parametrize("res_in", [False, True], ids=["no_residual", "residual"])
@pytest.mark.parametrize("B", [1, 48])
@pytest.mark.parametrize("lora", [True, False], ids=["lora8", "no_lora"])
@pytest.mark.parametrize("d_model", [1024, 640], ids=["d1024_early", "d640_parent"])
def test_fused_step_matches_jax_on_the_prenorm(prenorm_pairs, d_model, lora, B, res_in):
    """The fused step where the card's pre-norm dispatch changes (d_model, LoRA
    rank 8 or 0, 1 or 48 rows, K splits of two, an incoming residual or none)
    against JAX's fused step (Pallas in interpret mode), fp32: every output
    within 1e-5. Without a residual both sides run ``backbone_step_fused``
    (the embedding, the step and the final norm); with one, the step itself
    (``fused_decode_step``), which adds it before the first norm."""
    from omnimamba_tpu.ops.decode_fused import fused_decode_step as j_fused_decode_step

    jmodel, tmodel, jm, tm = prenorm_pairs(d_model)
    mixer = tmodel.cfg.mixer
    assert mixer.d_inner > 1024 and mixer.d_in_proj % 64 == 0
    if not lora:
        jm, tm = _without_lora_jax(jm), _without_lora_torch(tm)
    rng = np.random.default_rng(300 + B + 2 * res_in + 4 * lora + d_model)
    L, W = tmodel.cfg.n_layer, mixer.d_conv
    conv = (0.5 * rng.standard_normal((L, B, W - 1, mixer.d_conv_in))).astype(np.float32)
    ssm = (0.5 * rng.standard_normal(
        (L, B, mixer.nheads, mixer.headdim, mixer.d_state))).astype(np.float32)
    jcache = to_fused_cache(jbb.BackboneCache(jnp.asarray(conv), jnp.asarray(ssm)), mixer.d_inner)
    tcache = tbb.BackboneCache(tt(conv), tt(ssm))
    before = fused_decode_step.launches
    if not res_in:
        tok = rng.integers(0, 32, (B,))
        hj, fcache = jbb.backbone_step_fused(jm, jnp.asarray(tok, jnp.int32), jnp.int32(L0), jcache,
                                             "t2i", jmodel.cfg, dtype=jnp.float32)
        ht, out = tbb.backbone_step_fused(tm, tt(tok), L0, tcache, "t2i", tmodel.cfg,
                                          dtype=torch.float32)
    else:
        h = (0.5 * rng.standard_normal((B, mixer.d_model))).astype(np.float32)
        residual = (0.5 * rng.standard_normal((B, mixer.d_model))).astype(np.float32)
        lp = jm["layers"]["mixer"].get("lora")
        lora_args = ((lp["t2i_A"], {p: lp[f"t2i_B_{p}"] for p in ("z", "x", "bc", "dt")},
                      jmodel.cfg.lora.scaling) if lora else (None, None, 0.0))
        hj, rj, fcache = j_fused_decode_step(
            jm["layers"], jnp.asarray(h), jnp.asarray(residual), jcache, *lora_args,
            norm_eps=jmodel.cfg.norm_eps, gn_eps=mixer.norm_eps)
        ht, rt, out = fused_decode_step(tm["layers"], tt(h), tt(residual), tcache, "t2i", mixer,
                                        tmodel.cfg.lora, tmodel.cfg.norm_eps)
        close(rt, rj, 1e-5)
    assert fused_decode_step.launches == before  # CPU tensors: the plain version
    close(ht, hj, 1e-5)
    assert_caches_close(fcache, out, B, mixer.d_inner, 1e-5)


def test_prenorm_phase_refuses_a_layer_out_of_range(pair):
    """``fused_decode_prenorm``, like the in_proj and SSM phase wrappers,
    refuses a layer the stack does not have (before any plan or launch), and
    a missing running residual."""
    from omnimamba_tpu_torch.ops.decode_fused import fused_decode_prenorm

    _, tmodel, _, tm = pair
    cfg = tmodel.cfg
    _, cache, _ = prefill(pair, "t2i", 2, seed=51)
    h, residual = torch.zeros(2, 32), torch.zeros(2, 32)
    for layer in (-1, len(tm["layers"])):
        with pytest.raises(ValueError, match=f"layer {layer} of {len(tm['layers'])}"):
            fused_decode_prenorm(tm["layers"], h, residual, cache, "t2i", cfg.mixer, cfg.lora,
                                 plan=None, layer=layer)
    with pytest.raises(ValueError, match="running residual"):
        fused_decode_prenorm(tm["layers"], h, None, cache, "t2i", cfg.mixer, cfg.lora, plan=None,
                             layer=0)


@pytest.fixture(scope="module")
def out_proj_pairs():
    """(d_inner, int8) -> (jax model, torch model, jax backbone params, bridged
    torch params) of ``_OUT_PROJ_MIXERS[d_inner]``, fp32, LoRA B factors
    filled; with int8, the trees are JAX ``quantize_decode_params``'s; each
    made on first use."""
    from omnimamba_tpu import config as jcfg
    from omnimamba_tpu.models.omnimamba import OmniMambaModel as JaxModel
    from omnimamba_tpu.ops.quant import quantize_decode_params
    from omnimamba_tpu_torch import config as tcfg
    from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel as TorchModel
    from tests.test_torch_helpers import _MAMBA, _OUT_PROJ_MIXERS, _VQ

    made = {}

    def get(d_inner, int8=False):
        if (d_inner, int8) not in made:
            mixer = _OUT_PROJ_MIXERS[d_inner]
            mamba = {**_MAMBA, "d_model": mixer["d_model"]}
            jmodel = JaxModel(cfg=jcfg.MambaConfig(mixer=jcfg.Mamba2LayerConfig(**mixer), **mamba),
                              vision_cfg=jcfg.VisionConfig(), vq_cfg=jcfg.VQConfig(**_VQ),
                              sptids={})
            tmodel = TorchModel(cfg=tcfg.MambaConfig(mixer=tcfg.Mamba2LayerConfig(**mixer),
                                                     **mamba),
                                vq_cfg=tcfg.VQConfig(**_VQ), sptids={})
            jp = init_omnimamba(jax.random.PRNGKey(4), jmodel, with_vision=False)
            layers = dict(jp["mamba"]["layers"])
            layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(4))
            jp = {"mamba": {**jp["mamba"], "layers": layers}, "vq": decode_side(jp["vq"])}
            if int8:
                jp = quantize_decode_params(jp)
            made[d_inner, int8] = jmodel, tmodel, jp["mamba"], bridge(jp, tmodel)["mamba"]
        return made[d_inner, int8]

    return get


def check_out_proj_step(out_proj_pairs, d_inner, B, int8):
    """The port's fused step on ``out_proj_pairs(d_inner, int8)`` against
    JAX's ``backbone_step_fused`` (Pallas in interpret mode), fp32: every
    output within 1e-5, and no launch counted (CPU tensors: the plain
    version)."""
    from omnimamba_tpu_torch.ops.decode_fused import MAX_KSPLIT, TC_TILE
    from omnimamba_tpu_torch.ops.quant import is_quantized

    jmodel, tmodel, jm, tm = out_proj_pairs(d_inner, int8)
    mixer = tmodel.cfg.mixer
    ksplit = min(MAX_KSPLIT, -(-d_inner // 1024))
    per = -(-(-(-d_inner // ksplit)) // TC_TILE) * TC_TILE  # tc_split_width
    last = d_inner - (ksplit - 1) * per
    assert mixer.d_inner == d_inner and mixer.d_model % TC_TILE == 0
    assert (ksplit, per, last) == {512: (1, 512, 512), 1536: (2, 768, 768),
                                   2560: (3, 896, 768)}[d_inner]
    assert is_quantized(tm["layers"][0]["mixer"]["out_proj"]["kernel"]) == int8
    rng = np.random.default_rng(400 + B + d_inner)
    L, W = tmodel.cfg.n_layer, mixer.d_conv
    conv = (0.5 * rng.standard_normal((L, B, W - 1, mixer.d_conv_in))).astype(np.float32)
    ssm = (0.5 * rng.standard_normal(
        (L, B, mixer.nheads, mixer.headdim, mixer.d_state))).astype(np.float32)
    tok = rng.integers(0, 32, (B,))
    hj, fcache = jbb.backbone_step_fused(
        jm, jnp.asarray(tok, jnp.int32), jnp.int32(L0),
        to_fused_cache(jbb.BackboneCache(jnp.asarray(conv), jnp.asarray(ssm)), mixer.d_inner),
        "t2i", jmodel.cfg, dtype=jnp.float32)
    before = (fused_decode_step.launches, fused_decode_step.int8_launches)
    ht, out = tbb.backbone_step_fused(tm, tt(tok), L0, tbb.BackboneCache(tt(conv), tt(ssm)),
                                      "t2i", tmodel.cfg, dtype=torch.float32)
    assert (fused_decode_step.launches, fused_decode_step.int8_launches) == before
    close(ht, hj, 1e-5)
    assert_caches_close(fcache, out, B, mixer.d_inner, 1e-5)


@pytest.mark.parametrize("B", [1, 16, 17, 48, 96, 112])
@pytest.mark.parametrize("d_inner", [512, 1536, 2560], ids=["ksplit1", "ksplit2", "ksplit3_short"])
def test_fused_step_matches_jax_on_the_out_proj(out_proj_pairs, d_inner, B):
    """The fused step where the card's out_proj changes (one, two or three K
    splits, the last one short; 1 to 112 rows, the edges of the pair kernel's
    16-row fragments and 96-row tiles) against JAX's ``backbone_step_fused``
    (Pallas in interpret mode), fp32: every output within 1e-5."""
    check_out_proj_step(out_proj_pairs, d_inner, B, int8=False)


def test_out_proj_phase_refuses_a_layer_out_of_range(pair):
    """``fused_decode_out_proj``, like the other phase wrappers, refuses a
    layer the stack does not have (before any plan or launch)."""
    from omnimamba_tpu_torch.ops.decode_fused import fused_decode_out_proj

    _, tmodel, _, tm = pair
    cfg = tmodel.cfg
    _, cache, _ = prefill(pair, "t2i", 2, seed=52)
    h = torch.zeros(2, 32)
    for layer in (-1, len(tm["layers"])):
        with pytest.raises(ValueError, match=f"layer {layer} of {len(tm['layers'])}"):
            fused_decode_out_proj(tm["layers"], h, None, cache, "t2i", cfg.mixer, cfg.lora,
                                  plan=None, layer=layer)
