"""The ported slice as a whole: ``t2i_generate`` of the PyTorch port against
``t2i_generate`` of the JAX package on the tiny model, on the CPU.

Greedy token streams must be equal in fp32. Random tiny weights can put two
logits closer together than the arithmetic noise of two frameworks, so where
a stream differs the assertion prints the top-2 margin at the first differing
step. Logits are compared under ``teacher_outputs`` replay with a tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.models import backbone as jbb
from omnimamba_tpu.models.omnimamba import init_omnimamba
from omnimamba_tpu.models.omnimamba import t2i_generate as j_t2i_generate
from omnimamba_tpu.ops.sampling import SampleParams as JSampleParams
from omnimamba_tpu_torch import SampleParams, generate, t2i_generate
from omnimamba_tpu_torch.models.backbone import caption_embed, embed_text
from tests.test_torch_helpers import bridge, decode_side, fill_lora_b, nn, tiny_models, tt

# images: fp32 decoder on both sides, a few dozen convolutions deep
IMG_TOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    jmodel, tmodel = tiny_models()
    jp = init_omnimamba(jax.random.PRNGKey(0), jmodel, with_vision=False)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(0))
    jp = {"mamba": {**jp["mamba"], "layers": layers}, "vq": jp["vq"]}
    tp = bridge({"mamba": jp["mamba"], "vq": decode_side(jp["vq"])}, tmodel)
    return jmodel, tmodel, jp, tp


def caption_ids(seed, B, L=8):
    return np.random.default_rng(seed).integers(0, 49, (B, L))


def replay_logits(tmodel, tp, ids, tokens, **kw):
    """The port's per-step logits when it replays ``tokens``."""
    mamba = tp["mamba"]
    idt = tt(ids)
    emb = caption_embed(mamba, embed_text(mamba, idt, torch.float32))
    emb = emb + mamba["pos_embed"][:, : idt.shape[1]]
    teacher = torch.cat([idt, tt(tokens)], dim=1)
    out = generate(mamba, tmodel.cfg, input_ids=idt, input_embeddings=emb, task="t2i",
                   max_length=idt.shape[1] + tmodel.cfg.num_tokens,
                   sample=SampleParams(top_k=1), teacher_outputs=teacher, cache_dtype=None,
                   return_logits=True, device="cpu", **kw)
    return torch.stack(out.logits, dim=1)  # (B, steps, V)


def assert_streams_equal(tok_t, tok_j, logits):
    tok_t, tok_j = nn(tok_t), np.asarray(tok_j)
    if np.array_equal(tok_t, tok_j):
        return
    b, step = np.argwhere(tok_t != tok_j)[0]
    top2 = torch.topk(logits[b, step], 2).values
    raise AssertionError(
        f"streams differ first at row {b} step {step}: port {tok_t[b, step]} vs JAX "
        f"{tok_j[b, step]}; top-2 logit margin there {float(top2[0] - top2[1]):.3e}")


@pytest.mark.parametrize("scan_impl", ["pallas", "chunked"])
def test_greedy_tokens_and_images(pair, scan_impl):
    jmodel, tmodel, jp, tp = pair
    ids = caption_ids(1, B=3)
    img_j, tok_j = j_t2i_generate(jp, jmodel, jnp.asarray(ids), sample=JSampleParams(top_k=1),
                                  dtype=jnp.float32, scan_impl=scan_impl, cache_dtype=None)
    img_t, tok_t = t2i_generate(tp, tmodel, ids, sample=SampleParams(top_k=1),
                                dtype=torch.float32, cache_dtype=None, device="cpu")
    assert tok_t.shape == (3, 16) and img_t.shape == (3, 8, 8, 3)
    assert_streams_equal(tok_t, tok_j, replay_logits(tmodel, tp, ids, np.asarray(tok_j)))
    np.testing.assert_allclose(nn(img_t), np.asarray(img_j), rtol=IMG_TOL, atol=IMG_TOL)


def test_cfg_packed_cond_uncond(pair):
    jmodel, tmodel, jp, tp = pair
    cond = caption_ids(2, B=2)
    ids = np.concatenate([cond, np.full_like(cond, 49)], axis=0)  # [cond; uncond]
    _, tok_j = j_t2i_generate(jp, jmodel, jnp.asarray(ids), sample=JSampleParams(top_k=1),
                              cfg_scale=7.5, dtype=jnp.float32, scan_impl="pallas",
                              cache_dtype=None, decode_image=False)
    img_t, tok_t = t2i_generate(tp, tmodel, ids, sample=SampleParams(top_k=1), cfg_scale=7.5,
                                dtype=torch.float32, cache_dtype=None, device="cpu")
    assert tok_t.shape == (2, 16) and img_t.shape[0] == 2  # the cond half is returned
    tok_full = np.concatenate([np.asarray(tok_j)] * 2, axis=0)
    logits = replay_logits(tmodel, tp, ids, tok_full, cfg_scale=7.5)
    assert_streams_equal(tok_t, tok_j, logits)
    # guidance changes the stream
    _, plain = t2i_generate(tp, tmodel, cond, dtype=torch.float32, cache_dtype=None,
                            decode_image=False, device="cpu")
    assert not torch.equal(plain, tok_t)


def test_ragged_text_lengths(pair):
    jmodel, tmodel, jp, tp = pair
    ids = caption_ids(3, B=3, L=10)
    lens = np.array([10, 6, 8], np.int32)
    _, tok_j = j_t2i_generate(jp, jmodel, jnp.asarray(ids), sample=JSampleParams(top_k=1),
                              dtype=jnp.float32, scan_impl="pallas", cache_dtype=None,
                              decode_image=False, text_lengths=jnp.asarray(lens))
    _, tok_t = t2i_generate(tp, tmodel, ids, dtype=torch.float32, cache_dtype=None,
                            decode_image=False, text_lengths=lens, device="cpu")
    assert np.array_equal(nn(tok_t), np.asarray(tok_j)), (nn(tok_t), np.asarray(tok_j))
    # each ragged row's stream is its solo stream
    for b, n in enumerate(lens):
        _, solo = t2i_generate(tp, tmodel, ids[b : b + 1, :n], dtype=torch.float32,
                               cache_dtype=None, decode_image=False, device="cpu")
        assert torch.equal(solo[0], tok_t[b])


def test_teacher_replay_logits(pair):
    """Per-step logits under teacher replay against a JAX replay of the same
    tokens (backbone_forward, then backbone_step per token). fp32 on both
    sides: 1e-4 absolute on logits of order 1."""
    jmodel, tmodel, jp, tp = pair
    ids = caption_ids(4, B=2)
    teacher = np.random.default_rng(4).integers(0, 32, (2, 16))
    logits_t = replay_logits(tmodel, tp, ids, teacher)

    jm = jp["mamba"]
    emb = jbb.caption_embed(jm, jbb.embed_text(jm, jnp.asarray(ids), jnp.float32))
    emb = emb + jm["pos_embed"][:, :8]
    hidden, cache = jbb.backbone_forward(jm, emb, "t2i", jmodel.cfg, scan_impl="pallas",
                                         return_cache=True)
    logits_j = [jbb.apply_head(jm, hidden[:, -1], "t2i")]
    step = jax.jit(lambda tok, pos, c: jbb.backbone_step(jm, tok, pos, c, "t2i", jmodel.cfg,
                                                         dtype=jnp.float32))
    for n in range(15):
        h, cache = step(jnp.asarray(teacher[:, n]), jnp.int32(8 + n), cache)
        logits_j.append(jbb.apply_head(jm, h, "t2i"))
    np.testing.assert_allclose(nn(logits_t), np.stack([np.asarray(l) for l in logits_j], 1),
                               rtol=1e-4, atol=1e-4)


def test_bf16_state_cache(pair):
    """``cache_dtype=torch.bfloat16``: the SSM state is rounded to bf16 after
    every step on both sides, so logits agree at bf16 scale (2^-7 of the
    largest logit) rather than fp32 scale, and the rule for "auto" is the
    JAX package's: bf16 from batch 16 on."""
    jmodel, tmodel, jp, tp = pair
    ids = caption_ids(5, B=2)
    _, tok_j = j_t2i_generate(jp, jmodel, jnp.asarray(ids), sample=JSampleParams(top_k=1),
                              dtype=jnp.float32, scan_impl="pallas", cache_dtype=jnp.bfloat16,
                              decode_image=False)
    mamba = tp["mamba"]
    idt = tt(ids)
    emb = caption_embed(mamba, embed_text(mamba, idt, torch.float32)) + mamba["pos_embed"][:, :8]
    common = dict(input_ids=idt, input_embeddings=emb, task="t2i", max_length=24,
                  teacher_outputs=torch.cat([idt, tt(np.asarray(tok_j))], 1),
                  return_logits=True, device="cpu")
    l16 = torch.stack(generate(mamba, tmodel.cfg, cache_dtype=torch.bfloat16, **common).logits)
    l32 = torch.stack(generate(mamba, tmodel.cfg, cache_dtype=None, **common).logits)
    scale = float(l32.abs().max())
    err = float((l16 - l32).abs().max())
    assert 0 < err <= 2.0 ** -7 * scale * 4, (err, scale)
    # where the bf16 run's own top-2 margin exceeds that noise it picks JAX's tokens
    top2 = torch.topk(l16, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2.0 ** -7 * scale * 4
    agree = l16.argmax(-1).T == tt(np.asarray(tok_j))
    assert bool(agree[decided.T].all())


def test_callback_eos_and_unported_options(pair):
    _, tmodel, _, tp = pair
    ids = caption_ids(6, B=2)
    mamba = tp["mamba"]
    idt = tt(ids)
    emb = caption_embed(mamba, embed_text(mamba, idt, torch.float32)) + mamba["pos_embed"][:, :8]
    common = dict(input_ids=idt, input_embeddings=emb, task="t2i", max_length=24,
                  cache_dtype=None, device="cpu")
    seen = []
    out = generate(mamba, tmodel.cfg, token_callback=seen.append, **common)
    assert out.num_generated == 16 and len(seen) == 16 and seen[0].dtype == np.int32
    np.testing.assert_array_equal(np.stack(seen, 1), nn(out.sequences[:, 8:]))
    # stop when every row emits eos: replay a teacher whose step 3 is all-eos
    teacher = out.sequences.clone()
    teacher[:, 8 + 3] = 5
    stopped = generate(mamba, tmodel.cfg, teacher_outputs=teacher, eos_token_id=5, **common)
    assert stopped.num_generated == 4
    # the scaled-int8 state, refused before the serving slice, now rides the scan path
    int8 = generate(mamba, tmodel.cfg, **{**common, "cache_dtype": "int8"})
    assert int8.num_generated == 16 and int8.sequences.shape == out.sequences.shape
    with pytest.raises(ValueError, match="unknown decode_impl"):
        generate(mamba, tmodel.cfg, decode_impl="pallas", **common)
