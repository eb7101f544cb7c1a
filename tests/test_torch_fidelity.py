"""The port's stream-and-margin fidelity tools (``omnimamba_tpu_torch.eval.
fidelity``) against the JAX package's (``omnimamba_tpu.eval.fidelity``) on
the tiny model in fp32, on the CPU: equal greedy streams, equal
``StreamDiff``s, teacher-forced logits and top-2 margins within 1e-5 (fp32 on
both sides, two layers, logits of order 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.eval import fidelity as jfid
from omnimamba_tpu.models import backbone as jbb
from omnimamba_tpu.models.omnimamba import init_omnimamba
from omnimamba_tpu_torch.eval import fidelity as tfid
from omnimamba_tpu_torch.models.backbone import caption_embed, embed_text
from tests.test_torch_helpers import bridge, decode_side, fill_lora_b, tiny_models, tt

TOL = 1e-5
PROMPT, NEW = 8, 16


@pytest.fixture(scope="module")
def pair():
    jmodel, tmodel = tiny_models()
    jp = init_omnimamba(jax.random.PRNGKey(1), jmodel, with_vision=False)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(1))
    jm = {**jp["mamba"], "layers": layers}
    tm = bridge({"mamba": jm, "vq": decode_side(jp["vq"])}, tmodel)["mamba"]
    ids = np.random.default_rng(7).integers(0, 49, (3, PROMPT))
    jemb = jbb.caption_embed(jm, jbb.embed_text(jm, jnp.asarray(ids), jnp.float32))
    jemb = jemb + jm["pos_embed"][:, :PROMPT]
    temb = caption_embed(tm, embed_text(tm, tt(ids), torch.float32)) + tm["pos_embed"][:, :PROMPT]
    return jmodel.cfg, tmodel.cfg, jm, tm, ids, jemb, temb


@pytest.fixture(scope="module")
def streams(pair):
    jcfg, tcfg, jm, tm, ids, jemb, temb = pair
    js = jfid.greedy_stream(jm, jcfg, jnp.asarray(ids), jemb, "t2i", PROMPT + NEW)
    ts = tfid.greedy_stream(tm, tcfg, tt(ids), temb, "t2i", PROMPT + NEW, device="cpu")
    return js, ts


def test_greedy_stream_equal(streams):
    js, ts = streams
    assert ts.shape == (3, PROMPT + NEW) and isinstance(ts, np.ndarray)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("case", ["equal", "one_flip", "two_flips", "shorter"])
def test_compare_streams_equal_diff(streams, case):
    js, ts = streams
    other = np.array(ts)
    if case in ("one_flip", "two_flips"):
        other[1, PROMPT + 3] = (other[1, PROMPT + 3] + 1) % 32
    if case == "two_flips":
        other[2, PROMPT + 9] = (other[2, PROMPT + 9] + 1) % 32
    if case == "shorter":
        other = other[:, :-2]
    got = tfid.compare_streams(ts, other)
    assert isinstance(got, tfid.StreamDiff)
    assert tuple(got) == tuple(jfid.compare_streams(js, other))


def test_teacher_forced_logits(pair, streams):
    jcfg, tcfg, jm, tm, ids, jemb, temb = pair
    js, _ = streams
    want = jfid.teacher_forced_logits(jm, jcfg, jemb, js, PROMPT, 6, "t2i")
    got = tfid.teacher_forced_logits(tm, tcfg, temb, js, PROMPT, 6, "t2i", device="cpu")
    assert got.shape == want.shape == (3, 6, tcfg.vqvae_vocab_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_logit_margin_report(pair, streams):
    jcfg, tcfg, jm, tm, ids, jemb, temb = pair
    js, _ = streams
    other = np.array(js)
    other[0, PROMPT + 2] = (other[0, PROMPT + 2] + 1) % 32  # a replay off the greedy path
    want = jfid.logit_margin_report(jm, jcfg, jemb, jnp.asarray(other), "t2i", PROMPT)
    got = tfid.logit_margin_report(tm, tcfg, temb, other, "t2i", PROMPT, device="cpu")
    assert got["margins"].shape == (3, NEW) and not got["argmax_agrees"][0, 2]
    np.testing.assert_allclose(got["margins"], want["margins"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["argmax_agrees"], want["argmax_agrees"])
