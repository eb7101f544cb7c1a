"""Speculative greedy decoding of the PyTorch port against the JAX package's,
on the CPU: sequences and the round / draft / accept counters must be equal
for the int8, shallow and ngram drafts, and the stream must be plain greedy's
(fp32, tiny model)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.models.backbone import embed_text as j_embed_text
from omnimamba_tpu.models.backbone import init_backbone as j_init_backbone
from omnimamba_tpu.models.speculative import speculative_generate as j_speculative
from omnimamba_tpu.ops import quant as jq
from omnimamba_tpu_torch import SampleParams, generate
from omnimamba_tpu_torch.models.backbone import embed_decode_window, embed_text
from omnimamba_tpu_torch.models.speculative import shallow_draft, speculative_generate
from omnimamba_tpu_torch.ops.quant import quantize_decode_params
from tests.test_backbone import tiny_config
from tests.test_torch_helpers import bridge_backbone, nn, torch_config, tt

MAX_LEN = 30


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_config(n_layer=3)
    jparams = j_init_backbone(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    cfg = torch_config(jcfg)
    params = bridge_backbone(jparams, cfg)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, 6))
    return jcfg, jparams, cfg, params, ids


def _pair(setup, ids, **kw):
    jcfg, jparams, cfg, params, _ = setup
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("int8_draft", False):
        jkw.pop("int8_draft"), tkw.pop("int8_draft")
        jkw["draft_params"] = jq.quantize_decode_params({"mamba": jparams})["mamba"]
        tkw["draft_params"] = quantize_decode_params(params)
    ref = j_speculative(jparams, jcfg, input_ids=jnp.asarray(ids, jnp.int32),
                        input_embeddings=j_embed_text(jparams, jnp.asarray(ids), jnp.float32),
                        task="mmu", max_length=MAX_LEN, scan_impl="chunked", **jkw)
    tids = tt(ids).long()
    got = speculative_generate(params, cfg, input_ids=tids,
                               input_embeddings=embed_text(params, tids, torch.float32),
                               task="mmu", max_length=MAX_LEN, device="cpu", **tkw)
    return got, ref


def _greedy(setup, ids, **kw):
    _, _, cfg, params, _ = setup
    tids = tt(ids).long()
    return generate(params, cfg, input_ids=tids, input_embeddings=embed_text(params, tids, torch.float32),
                    task="mmu", max_length=MAX_LEN, sample=SampleParams(top_k=1), cache_dtype=None,
                    device="cpu", **kw)


DRAFTS = {
    "self": dict(k_draft=4),
    "int8": dict(k_draft=4, int8_draft=True),
    "shallow": dict(k_draft=4, draft_layers=1),
    "shallow_k1": dict(k_draft=1, draft_layers=2),
    "shallow_k8": dict(k_draft=8, draft_layers=1),
    "ngram": dict(k_draft=4, draft_mode="ngram"),
}


@pytest.mark.parametrize("draft", sorted(DRAFTS))
def test_sequences_and_counters_match_jax(setup, draft):
    ids = setup[4]
    got, ref = _pair(setup, ids, **DRAFTS[draft])
    np.testing.assert_array_equal(nn(got.sequences), np.asarray(ref.sequences))
    assert (got.num_generated, got.rounds, got.drafted, got.accepted) == (
        int(ref.num_generated), int(ref.rounds), int(ref.drafted), int(ref.accepted))
    assert torch.equal(got.sequences, _greedy(setup, ids).sequences)
    if draft == "self":
        assert got.accepted == got.drafted


def test_ngram_repetitive_prompt_and_eos(setup):
    rep = np.asarray([[3, 9, 4, 3, 9, 4, 3, 9]])
    got, ref = _pair(setup, rep, k_draft=4, draft_mode="ngram")
    np.testing.assert_array_equal(nn(got.sequences), np.asarray(ref.sequences))
    assert (got.rounds, got.accepted) == (int(ref.rounds), int(ref.accepted))
    ids = setup[4]
    eos = int(nn(_greedy(setup, ids).sequences)[0, ids.shape[1] + 2])
    got, ref = _pair(setup, ids, k_draft=4, draft_layers=1, eos_token_id=eos)
    want = _greedy(setup, ids, eos_token_id=eos)
    np.testing.assert_array_equal(nn(got.sequences), np.asarray(ref.sequences))
    assert got.num_generated == want.num_generated == int(ref.num_generated)
    np.testing.assert_array_equal(nn(got.sequences)[0, : ids.shape[1] + got.num_generated],
                                  nn(want.sequences)[0, : ids.shape[1] + got.num_generated])


def test_embed_decode_window_and_shallow_draft(setup):
    jcfg, jparams, cfg, params, _ = setup
    from omnimamba_tpu.models.backbone import embed_decode_window as j_window

    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 5))
    ref = j_window(jparams, jnp.asarray(toks), 7, "mmu", jcfg, jnp.float32)
    got = embed_decode_window(params, tt(toks).long(), 7, "mmu", cfg, torch.float32)
    np.testing.assert_array_equal(nn(got), np.asarray(ref))
    draft, dcfg = shallow_draft(params, cfg, 2)
    assert dcfg.n_layer == 2 and len(draft["layers"]) == 2 and len(params["layers"]) == 3
    assert draft["layers"][0] is params["layers"][0]
    with pytest.raises(ValueError, match="B=1"):
        speculative_generate(params, cfg, input_ids=torch.zeros(2, 3, dtype=torch.long),
                             input_embeddings=torch.zeros(2, 3, 32), task="mmu", max_length=9,
                             device="cpu")
