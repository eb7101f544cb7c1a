"""models of the PyTorch port against the JAX package, on the CPU.

Parameters come from the JAX ``init_*`` functions (LoRA B factors filled from
a seed: their init is zeros, which would leave the LoRA branch untested),
are turned into numpy arrays and go through ``utils/bridge.from_jax_params``.
Both sides run in fp32; 2e-5 covers the other summation order of the fused
in_proj product and of PyTorch's CPU kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.models import backbone as jbb
from omnimamba_tpu.models import blocks as jblocks
from omnimamba_tpu.models import mamba2 as jm2
from omnimamba_tpu.models import vq as jvq
from omnimamba_tpu.models.omnimamba import init_omnimamba
from omnimamba_tpu_torch.models import backbone as tbb
from omnimamba_tpu_torch.models import blocks as tblocks
from omnimamba_tpu_torch.models import mamba2 as tm2
from omnimamba_tpu_torch.models import vq as tvq
from omnimamba_tpu_torch.utils.bridge import from_jax_params
from tests.test_torch_helpers import (
    bridge, decode_side, fill_lora_b, nn, tiny_models, to_numpy, tt,
)

TOL = 2e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(nn(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def pair():
    """(jax model, torch model, jax params, bridged torch params), fp32."""
    jmodel, tmodel = tiny_models()
    jp = init_omnimamba(jax.random.PRNGKey(0), jmodel, with_vision=False)
    rng = np.random.default_rng(0)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], rng)
    jp = {"mamba": {**jp["mamba"], "layers": layers}, "vq": decode_side(jp["vq"])}
    return jmodel, tmodel, jp, bridge(jp, tmodel)


def jax_layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["mamba"]["layers"])


# the port has one scan for a fresh sequence; it is held against each of the
# three JAX scans (the ids name the JAX side: "kernel" is the interpreted
# Pallas kernel)
@pytest.mark.parametrize("task", ["t2i", "mmu", None])
@pytest.mark.parametrize("jax_scan", ["pallas", "chunked", "reference"],
                         ids=["kernel", "chunked", "reference"])
def test_mamba2_forward(pair, task, jax_scan):
    jmodel, tmodel, jp, tp = pair
    x = np.random.default_rng(1).standard_normal((2, 21, 32)).astype(np.float32)
    yj, cj = jm2.mamba2_forward(
        jax_layer(jp, 1)["mixer"], jnp.asarray(x), task, jmodel.cfg.mixer, jmodel.cfg.lora,
        scan_impl=jax_scan, return_cache=True)
    yt, ct = tm2.mamba2_forward(
        tp["mamba"]["layers"][1]["mixer"], tt(x), task, tmodel.cfg.mixer, tmodel.cfg.lora,
        return_cache=True)
    close(yt, yj)
    close(ct.conv_state, cj.conv_state)
    close(ct.ssm_state, cj.ssm_state)


def test_lora_branch_counts(pair):
    """The three tasks give three different outputs (the filled LoRA B is live)."""
    _, tmodel, _, tp = pair
    x = tt(np.random.default_rng(1).standard_normal((1, 5, 32)).astype(np.float32))
    mixer = tp["mamba"]["layers"][0]["mixer"]
    outs = [tm2.mamba2_forward(mixer, x, t, tmodel.cfg.mixer, tmodel.cfg.lora)[0]
            for t in ("t2i", "mmu", None)]
    assert not torch.allclose(outs[0], outs[1]) and not torch.allclose(outs[0], outs[2])


@pytest.mark.parametrize("task", ["t2i", "mmu", None])
def test_mamba2_prefill_then_steps(pair, task):
    """Prefill on one side, then steps from the other side's cache: the port
    continues from the JAX cache and tracks the JAX steps, and its own
    prefill + steps equal its full-sequence forward."""
    jmodel, tmodel, jp, tp = pair
    L, L1 = 20, 13
    x = np.random.default_rng(2).standard_normal((2, L, 32)).astype(np.float32)
    jmix, tmix = jax_layer(jp, 0)["mixer"], tp["mamba"]["layers"][0]["mixer"]
    jcfg, tcfg = jmodel.cfg, tmodel.cfg
    y_full, _ = tm2.mamba2_forward(tmix, tt(x), task, tcfg.mixer, tcfg.lora)
    _, cj = jm2.mamba2_forward(jmix, jnp.asarray(x[:, :L1]), task, jcfg.mixer, jcfg.lora,
                               scan_impl="pallas", return_cache=True)
    _, ct = tm2.mamba2_forward(tmix, tt(x[:, :L1]), task, tcfg.mixer, tcfg.lora, return_cache=True)
    from_jax = tm2.Mamba2Cache(tt(cj.conv_state), tt(cj.ssm_state))
    for t in range(L1, L):
        yj, cj = jm2.mamba2_step(jmix, jnp.asarray(x[:, t]), cj, task, jcfg.mixer, jcfg.lora)
        y1, from_jax = tm2.mamba2_step(tmix, tt(x[:, t]), from_jax, task, tcfg.mixer, tcfg.lora)
        y2, ct = tm2.mamba2_step(tmix, tt(x[:, t]), ct, task, tcfg.mixer, tcfg.lora)
        close(y1, yj)
        close(y2, nn(y_full[:, t]), 1e-4)
    close(from_jax.ssm_state, cj.ssm_state)
    close(from_jax.conv_state, cj.conv_state)


def test_steps_from_an_empty_cache_equal_the_forward(pair):
    _, tmodel, _, tp = pair
    x = tt(np.random.default_rng(9).standard_normal((2, 7, 32)).astype(np.float32))
    tmix, cfg = tp["mamba"]["layers"][1]["mixer"], tmodel.cfg
    y_full, c_full = tm2.mamba2_forward(tmix, x, "mmu", cfg.mixer, cfg.lora, return_cache=True)
    cache = tm2.init_cache(2, cfg.mixer, torch.float32, torch.device("cpu"))
    for t in range(7):
        y_t, cache = tm2.mamba2_step(tmix, x[:, t], cache, "mmu", cfg.mixer, cfg.lora)
        close(y_t, nn(y_full[:, t]), 1e-4)
    close(cache.ssm_state, nn(c_full.ssm_state), 1e-4)
    close(cache.conv_state, nn(c_full.conv_state), 0)


def test_mamba2_continuation_and_ragged(pair):
    """``initial_cache`` (continuation window) and per-row ``valid_len``."""
    jmodel, tmodel, jp, tp = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, 32)).astype(np.float32)
    jmix, tmix = jax_layer(jp, 0)["mixer"], tp["mamba"]["layers"][0]["mixer"]
    jcfg, tcfg = jmodel.cfg, tmodel.cfg
    lens = np.array([12, 5, 9], np.int32)
    yj, cj = jm2.mamba2_forward(jmix, jnp.asarray(x), "t2i", jcfg.mixer, jcfg.lora,
                                scan_impl="pallas", return_cache=True, valid_len=jnp.asarray(lens))
    yt, ct = tm2.mamba2_forward(tmix, tt(x), "t2i", tcfg.mixer, tcfg.lora,
                                return_cache=True, valid_len=tt(lens))
    for b, n in enumerate(lens):  # outputs at padded positions are garbage by contract
        close(yt[b, :n], yj[b, :n])
    close(ct.conv_state, cj.conv_state)
    close(ct.ssm_state, cj.ssm_state)
    # each ragged row's state equals running the row alone
    _, solo = tm2.mamba2_forward(tmix, tt(x[1:2, :5]), "t2i", tcfg.mixer, tcfg.lora, return_cache=True)
    close(ct.ssm_state[1], nn(solo.ssm_state[0]), 1e-6)
    close(ct.conv_state[1], nn(solo.conv_state[0]), 0)

    x2 = rng.standard_normal((3, 6, 32)).astype(np.float32)
    yj2, cj2 = jm2.mamba2_forward(jmix, jnp.asarray(x2), "t2i", jcfg.mixer, jcfg.lora,
                                  scan_impl="chunked", return_cache=True, initial_cache=cj)
    yt2, ct2 = tm2.mamba2_forward(tmix, tt(x2), "t2i", tcfg.mixer, tcfg.lora,
                                  return_cache=True, initial_cache=ct)
    close(yt2, yj2)
    close(ct2.ssm_state, cj2.ssm_state)
    close(ct2.conv_state, cj2.conv_state)


def test_block_forward_and_step(pair):
    jmodel, tmodel, jp, tp = pair
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 9, 32)).astype(np.float32)
    res = rng.standard_normal((2, 9, 32)).astype(np.float32)
    jl, tl = jax_layer(jp, 1), tp["mamba"]["layers"][1]
    oj, rj, cj = jblocks.block_forward(jl, jnp.asarray(h), jnp.asarray(res), "t2i",
                                       jmodel.cfg.mixer, jmodel.cfg.lora, scan_impl="pallas",
                                       return_cache=True)
    ot, rt, ct = tblocks.block_forward(tl, tt(h), tt(res), "t2i", tmodel.cfg.mixer,
                                       tmodel.cfg.lora, return_cache=True)
    close(ot, oj)
    close(rt, rj)
    assert rt.dtype == torch.float32
    # first block: no incoming residual
    ot0, rt0, _ = tblocks.block_forward(tl, tt(h), None, "t2i", tmodel.cfg.mixer, tmodel.cfg.lora)
    oj0, rj0, _ = jblocks.block_forward(jl, jnp.asarray(h), jnp.zeros_like(jnp.asarray(h)), "t2i",
                                        jmodel.cfg.mixer, jmodel.cfg.lora, scan_impl="pallas")
    close(ot0, oj0)
    close(rt0, rj0, 0)

    h1, r1 = h[:, 0], res[:, 0]
    oj1, rj1, cj1 = jblocks.block_step(jl, jnp.asarray(h1), jnp.asarray(r1), cj, "t2i",
                                       jmodel.cfg.mixer, jmodel.cfg.lora)
    ot1, rt1, ct1 = tblocks.block_step(tl, tt(h1), tt(r1), ct, "t2i", tmodel.cfg.mixer,
                                       tmodel.cfg.lora)
    close(ot1, oj1)
    close(rt1, rj1)
    close(ct1.ssm_state, cj1.ssm_state)
    close(ct1.conv_state, cj1.conv_state)
    assert ct1.ssm_state is ct.ssm_state, "the step updates its cache in place"


@pytest.mark.parametrize("task", ["t2i", "mmu"])
def test_backbone_forward_step_head(pair, task):
    jmodel, tmodel, jp, tp = pair
    rng = np.random.default_rng(5)
    emb = (0.5 * rng.standard_normal((2, 11, 32))).astype(np.float32)
    hj, cj = jbb.backbone_forward(jp["mamba"], jnp.asarray(emb), task, jmodel.cfg,
                                  scan_impl="pallas", return_cache=True)
    ht, ct = tbb.backbone_forward(tp["mamba"], tt(emb), task, tmodel.cfg, return_cache=True)
    close(ht, hj)
    close(ct.ssm_state, cj.ssm_state)
    close(ct.conv_state, cj.conv_state)
    assert ct.ssm_state.shape == (2, 2, 8, 8, 16)
    close(tbb.apply_head(tp["mamba"], ht, task), jbb.apply_head(jp["mamba"], hj, task))

    vocab = 32 if task == "t2i" else 64
    for step in range(3):
        tok = rng.integers(0, vocab, (2,))
        pos = 11 + step
        hj, cj = jbb.backbone_step(jp["mamba"], jnp.asarray(tok), pos, cj, task, jmodel.cfg,
                                   dtype=jnp.float32)
        ht, ct = tbb.backbone_step(tp["mamba"], tt(tok), pos, ct, task, tmodel.cfg,
                                   dtype=torch.float32)
        close(ht, hj)
    close(ct.ssm_state, cj.ssm_state)
    close(ct.conv_state, cj.conv_state)
    # ragged positions: one position per row
    pos = np.array([3, 7])
    hj, _ = jbb.backbone_step(jp["mamba"], jnp.asarray(tok), jnp.asarray(pos), cj, task,
                              jmodel.cfg, dtype=jnp.float32)
    ht, _ = tbb.backbone_step(tp["mamba"], tt(tok), tt(pos), ct, task, tmodel.cfg,
                              dtype=torch.float32)
    close(ht, hj)


def test_embeddings_two_gelus(pair):
    """project_in uses the exact (erf) GELU, caption_embed the tanh form."""
    _, _, jp, tp = pair
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 32, (2, 5))
    close(tbb.embed_image_tokens(tp["mamba"], tt(ids), torch.float32),
          jbb.embed_image_tokens(jp["mamba"], jnp.asarray(ids), jnp.float32), 1e-6)
    x = (3.0 * rng.standard_normal((2, 5, 32))).astype(np.float32)
    close(tbb.caption_embed(tp["mamba"], tt(x)), jbb.caption_embed(jp["mamba"], jnp.asarray(x)), 1e-6)
    close(tbb.embed_text(tp["mamba"], tt(ids), torch.float32),
          jbb.embed_text(jp["mamba"], jnp.asarray(ids), jnp.float32), 0)


def test_head_is_fp32_from_bf16(pair):
    _, tmodel, jp, tp = pair
    h = np.random.default_rng(7).standard_normal((2, 32)).astype(np.float32)
    bf = from_jax_params(to_numpy(jp), tmodel, dtype=torch.bfloat16, device="cpu")
    logits = tbb.apply_head(bf["mamba"], tt(h, torch.bfloat16), "t2i")
    assert logits.dtype == torch.float32
    jbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp["mamba"])
    # bf16 products are exact in fp32; only the order of the fp32 sum differs
    close(logits, jbb.apply_head(jbf, jnp.asarray(h, jnp.bfloat16), "t2i"), 1e-5)


def test_vq_decoder(pair):
    jmodel, tmodel, jp, tp = pair
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    close(tvq.decoder_forward(tp["vq"]["decoder"], tt(z), tmodel.vq_cfg),
          jvq.decoder_forward(jp["vq"]["decoder"], jnp.asarray(z), jmodel.vq_cfg), 1e-4)
    ids = rng.integers(0, 32, (2, 16))
    # vq_decode_code reads the dtype of quant_conv on the JAX side
    jfull = {**jp["vq"], "quant_conv": {"kernel": jnp.zeros((1, 1, 16, 8), jnp.float32)}}
    img_j = jvq.vq_decode_code(jfull, jnp.asarray(ids), jmodel.vq_cfg)
    img_t = tvq.vq_decode_code(tp["vq"], tt(ids), tmodel.vq_cfg)
    assert img_t.shape == (2, 8, 8, 3)
    close(img_t, img_j, 1e-4)
    close(tvq.codebook_lookup(tp["vq"], tt(ids), tmodel.vq_cfg),
          jvq._normalized_codebook(jp["vq"], jmodel.vq_cfg)[jnp.asarray(ids)], 1e-6)
    with pytest.raises(ValueError, match="square"):
        tvq.vq_decode_code(tp["vq"], tt(ids[:, :15]), tmodel.vq_cfg)


def test_bridge_consumes_every_leaf(pair):
    _, tmodel, jp, tp = pair
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))

    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, list):
            return sum(count(v) for v in node)
        return node.numel()

    assert count(tp) == n_jax  # fusing slices concatenates, it drops nothing
    mixer = tp["mamba"]["layers"][0]["mixer"]
    cfg = tmodel.cfg.mixer
    assert mixer["in_proj"]["kernel"].shape == (32, cfg.d_in_proj)
    assert mixer["lora"]["t2i_B"].shape == (1, 8, cfg.d_in_proj)
    assert mixer["conv"]["weight"].shape == (4, cfg.d_conv_in)
    # fused column order z | x | bc | dt
    jl = jax_layer(jp, 0)["mixer"]["in_proj"]
    want = np.concatenate([np.asarray(jl[p]) for p in ("z", "x", "bc", "dt")], axis=-1)
    np.testing.assert_array_equal(nn(mixer["in_proj"]["kernel"]), want)
    # HWIO -> OIHW
    k_j = np.asarray(jp["vq"]["decoder"]["conv_in"]["kernel"])
    np.testing.assert_array_equal(nn(tp["vq"]["decoder"]["conv_in"]["kernel"]),
                                  k_j.transpose(3, 2, 0, 1))

    extra = to_numpy(jp)
    # leaves of no parameter of the port (the VQ encoder has one)
    extra["vq"] = {**extra["vq"], "codebook_used": np.zeros((32,), np.float32)}
    extra["mamba"] = {**extra["mamba"], "lm_head": {"kernel": np.zeros((32, 64), np.float32)}}
    with pytest.raises(ValueError, match="2 parameter leaves"):
        from_jax_params(extra, tmodel, device="cpu")


def test_unported_options_raise(pair):
    import dataclasses

    _, tmodel, _, tp = pair
    x = torch.zeros(1, 3, 32)
    layer = tp["mamba"]["layers"][0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tblocks.block_forward(layer, x, None, "t2i", tmodel.cfg.mixer, tmodel.cfg.lora,
                              layer_type="mha")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tblocks.block_forward({**layer, "mlp": {}}, x, None, "t2i", tmodel.cfg.mixer, tmodel.cfg.lora)
    for bad in (dict(attn_layer_idx=(1,)), dict(d_intermediate=64)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tbb.backbone_forward(tp["mamba"], x, "t2i", dataclasses.replace(tmodel.cfg, **bad))
    # int8 {q, scale} projections, refused before the serving slice, now run: the
    # mixer on int8 in_proj and out_proj equals the mixer on their dequantized
    # weights up to the order of the scale multiply
    from omnimamba_tpu_torch.ops.quant import quantize_linear

    x = torch.randn(1, 3, 32, generator=torch.Generator().manual_seed(0))
    mixer = layer["mixer"]
    qin, qout = (quantize_linear(mixer[k]["kernel"], (0,)) for k in ("in_proj", "out_proj"))
    quantized = {**mixer, "in_proj": {"kernel": qin}, "out_proj": {"kernel": qout}}
    dequantized = {**mixer, "in_proj": {"kernel": qin["q"].float() * qin["scale"]},
                   "out_proj": {"kernel": qout["q"].float() * qout["scale"]}}
    got, _ = tm2.mamba2_forward(quantized, x, "t2i", tmodel.cfg.mixer, tmodel.cfg.lora)
    want, _ = tm2.mamba2_forward(dequantized, x, "t2i", tmodel.cfg.mixer, tmodel.cfg.lora)
    np.testing.assert_allclose(nn(got), nn(want), rtol=1e-5, atol=1e-5)
