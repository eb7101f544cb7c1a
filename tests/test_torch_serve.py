"""The continuous-batching slot engine of the PyTorch port, on the CPU.

Greedy streams must equal the JAX ``SlotEngine``'s and the port's own solo
``generate`` (mid-flight admission, batched admission and eos included), in
fp32 on the tiny model, on both decode paths of the pool. Sampling cannot
reproduce JAX's ``fold_in`` bits, so it is held to its own contract: a stream
is a function of (seed, prompt) alone, and every draw respects top-k / top-p
/ min-p under a teacher-forced replay. The repetition penalty must match the
teacher-forced oracle, as in ``tests/test_continuous_batching.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.models.backbone import embed_text as j_embed_text
from omnimamba_tpu.models.backbone import init_backbone as j_init_backbone
from omnimamba_tpu.serve.continuous import SlotEngine as JSlotEngine
from omnimamba_tpu_torch import SampleParams, generate
from omnimamba_tpu_torch.models.backbone import apply_head, backbone_forward, embed_text
from omnimamba_tpu_torch.ops.quant import quantize_decode_params
from omnimamba_tpu_torch.ops.sampling import apply_repetition_penalty, apply_top_p
from omnimamba_tpu_torch.serve.continuous import SlotEngine, gumbel_noise
from tests.test_backbone import tiny_config
from tests.test_torch_helpers import bridge_backbone, torch_config, tt


@pytest.fixture(scope="module")
def setup():
    """The JAX engine tests' model (tiny_config, PRNGKey(0)) on both sides,
    and their five prompts."""
    jcfg = tiny_config()
    jparams = j_init_backbone(jax.random.PRNGKey(0), jcfg)
    cfg = torch_config(jcfg)
    params = bridge_backbone(jparams, cfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (5, 9, 17, 3, 12)]
    return jcfg, jparams, cfg, params, prompts


def _row(params, p):
    return embed_text(params, tt(p[None]).long(), torch.float32)[0].numpy()


def _solo(params, cfg, p, max_new, **kw):
    ids = tt(p[None]).long()
    out = generate(params, cfg, input_ids=ids, input_embeddings=embed_text(params, ids, torch.float32),
                   task="mmu", max_length=len(p) + max_new, sample=SampleParams(top_k=1),
                   cache_dtype=None, device="cpu", **kw)
    return out.sequences[0, len(p):].tolist()


def _engine(params, cfg, **kw):
    kw = {"n_slots": 3, "chunk": 4, "task": "mmu", "dtype": torch.float32, "prefill_bucket": 8,
          "device": "cpu", **kw}
    return SlotEngine(params, cfg, **kw)


@pytest.mark.parametrize("decode_impl", ["fused", "scan"])
def test_streams_match_jax_engine_and_solo_generate(setup, decode_impl):
    """The pool steps through the whole-model step where its limits are met;
    a dt clamp (outside them, on both sides) sends it through the layer loop."""
    jcfg, jparams, cfg, params, prompts = setup
    if decode_impl == "scan":
        jcfg = dataclasses.replace(jcfg, mixer=dataclasses.replace(jcfg.mixer, dt_limit=(0.0, 0.5)))
        cfg = torch_config(jcfg)
    jeng = JSlotEngine(jparams, jcfg, n_slots=3, chunk=4, task="mmu", dtype=jnp.float32,
                       prefill_bucket=8, max_new_default=11, scan_impl="chunked")
    eng = _engine(params, cfg, max_new_default=11)
    assert eng.fused == (decode_impl == "fused")
    jreqs, reqs = [], []
    for p in prompts:
        jreqs.append(jeng.submit(np.asarray(j_embed_text(jparams, jnp.asarray(p[None]),
                                                        jnp.float32))[0], len(p), max_new=11))
        reqs.append(eng.submit(_row(params, p), len(p), max_new=11))
    jeng.run_until_drained()
    eng.run_until_drained()
    for p, r, jr in zip(prompts, reqs, jreqs):
        assert r.done.is_set() and len(r.tokens) == 11
        assert r.tokens == jr.tokens
        assert r.tokens == _solo(params, cfg, p, 11)


def test_midflight_admission_does_not_perturb(setup):
    _, _, cfg, params, prompts = setup
    eng = _engine(params, cfg, n_slots=2, chunk=3, max_new_default=13)
    r0 = eng.submit(_row(params, prompts[0]), len(prompts[0]), max_new=13)
    eng.tick()  # r0 admitted and 3 tokens decoded
    assert not r0.done.is_set() and len(r0.tokens) == 4
    r1 = eng.submit(_row(params, prompts[1]), len(prompts[1]), max_new=13)
    eng.run_until_drained()
    assert r0.tokens == _solo(params, cfg, prompts[0], 13)
    assert r1.tokens == _solo(params, cfg, prompts[1], 13)


def test_batched_admission_writes_the_pool_in_place(setup):
    """Four prompts of one length bucket admit as one (4, 8) prefill and one
    insert; the pool's state tensors are the ones the engine started with
    (the fused step's plan points at them)."""
    jcfg, _, cfg, params, _ = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (5, 3, 7, 2)]
    eng = _engine(params, cfg, n_slots=4, max_new_default=9)
    conv, ssm = eng._cache.conv_state, eng._cache.ssm_state
    reqs = [eng.submit(_row(params, p), len(p), max_new=9) for p in prompts]
    eng.run_until_drained()
    assert len(eng.timings["prefill"]) == 1 and len(eng.timings["insert"]) == 1
    assert eng._cache.conv_state is conv and eng._cache.ssm_state is ssm
    for p, r in zip(prompts, reqs):
        assert r.tokens == _solo(params, cfg, p, 9)


def test_int8_weights_and_bf16_state(setup):
    """int8 weights (fp32 activations) through the pool match the solo stream
    on the same weights; a bf16 pool state matches a bf16 solo state."""
    _, _, cfg, params, prompts = setup
    qparams = quantize_decode_params(params)
    for state_dtype in (None, torch.bfloat16):
        eng = _engine(qparams, cfg, max_new_default=10, state_dtype=state_dtype)
        reqs = [eng.submit(_row(qparams, p), len(p), max_new=10) for p in prompts[:3]]
        eng.run_until_drained()
        for p, r in zip(prompts, reqs):
            ids = tt(p[None]).long()
            out = generate(qparams, cfg, input_ids=ids, task="mmu", max_length=len(p) + 10,
                           input_embeddings=embed_text(qparams, ids, torch.float32),
                           sample=SampleParams(top_k=1), device="cpu",
                           cache_dtype=state_dtype)
            assert r.tokens == out.sequences[0, len(p):].tolist(), state_dtype


def test_eos_frees_slot_and_truncates(setup):
    _, _, cfg, params, prompts = setup
    want = _solo(params, cfg, prompts[0], 9)
    eos = want[2]
    eng = _engine(params, cfg, n_slots=2, eos_token_id=eos)
    r = eng.submit(_row(params, prompts[0]), len(prompts[0]), max_new=9)
    eng.run_until_drained()
    assert r.tokens == want[: want.index(eos) + 1] and r.tokens[-1] == eos
    assert not eng._active.any()


def test_sampling_pool_greedy_requests_stay_exact(setup):
    _, _, cfg, params, prompts = setup
    eng = _engine(params, cfg, max_new_default=9, enable_sampling=True)
    reqs = [eng.submit(_row(params, p), len(p), max_new=9) for p in prompts[:3]]
    eng.run_until_drained()
    for p, r in zip(prompts, reqs):
        assert r.tokens == _solo(params, cfg, p, 9)


def test_sampling_deterministic_per_seed_and_independent_of_slot(setup):
    _, _, cfg, params, prompts = setup

    def run(seeds, mates):
        eng = _engine(params, cfg, n_slots=4, max_new_default=12, enable_sampling=True)
        for m in mates:  # greedy traffic ahead in the queue: other slots, other batchmates
            eng.submit(_row(params, prompts[m]), len(prompts[m]), max_new=12)
        reqs = [eng.submit(_row(params, prompts[0]), len(prompts[0]), max_new=12,
                           temperature=2.0, seed=s) for s in seeds]
        eng.run_until_drained()
        return [r.tokens for r in reqs]

    a = run([5, 6], mates=[])
    b = run([5], mates=[1, 2, 3])
    assert a[0] == b[0], "the same seed must repeat whatever the batchmates and the slot"
    assert a[0] != a[1], "distinct seeds should diverge at temperature 2"


def test_gumbel_noise_is_a_function_of_seed_index_and_token():
    seed = torch.tensor([5, 5, 6, 5])
    idx = torch.tensor([9, 9, 9, 10])
    g = gumbel_noise(seed, idx, 1000)
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2]) and not torch.equal(g[0], g[3])
    assert torch.equal(gumbel_noise(seed[:1], idx[:1], 1000)[0], g[0])
    assert torch.isfinite(g).all()
    # standard Gumbel: mean 0.5772, variance pi^2 / 6
    big = gumbel_noise(torch.arange(64), torch.zeros(64, dtype=torch.long), 4096)
    assert abs(big.mean().item() - 0.5772) < 0.02 and abs(big.var().item() - 1.6449) < 0.05


def _replay_logits(params, cfg, p, tokens):
    full = np.concatenate([p, np.asarray(tokens, np.int32)])
    hid, _ = backbone_forward(params, embed_text(params, tt(full[None]).long(), torch.float32),
                              "mmu", cfg)
    return apply_head(params, hid, "mmu")[0]


@pytest.mark.parametrize("mode", ["top_k", "top_p", "min_p"])
def test_sampling_respects_the_filters(setup, mode):
    """Teacher-forced replay: every sampled token sits inside the filter of
    the logits at its position (top-k set; top-p nucleus after the
    temperature; min-p on the raw logits)."""
    _, _, cfg, params, prompts = setup
    p = prompts[{"top_k": 2, "top_p": 1, "min_p": 3}[mode]]
    knobs = {"top_k": dict(temperature=1.5, top_k=3, seed=9),
             "top_p": dict(temperature=1.5, top_p=0.6, seed=3),
             "min_p": dict(temperature=2.0, min_p=0.25, seed=11)}[mode]
    eng = _engine(params, cfg, n_slots=2, max_new_default=10, enable_sampling=True,
                  prefill_bucket=16)
    r = eng.submit(_row(params, p), len(p), max_new=10, **knobs)
    eng.run_until_drained()
    logits = _replay_logits(params, cfg, p, r.tokens)
    for i, t in enumerate(r.tokens):
        row = logits[len(p) - 1 + i]
        if mode == "top_k":
            assert t in torch.topk(row, 3).indices.tolist(), (i, t)
        elif mode == "top_p":
            kept = apply_top_p(row[None] / 1.5, 0.6)[0]
            assert torch.isfinite(kept[t]), (i, t)
        else:
            probs = torch.softmax(row, -1)
            assert probs[t] >= 0.25 * probs.max() - 1e-7, (i, t)


def test_rep_penalty_one_stays_exact_and_flags_validated(setup):
    _, _, cfg, params, prompts = setup
    eng = _engine(params, cfg, max_new_default=9, enable_rep_penalty=True, history_len=16)
    reqs = [eng.submit(_row(params, p), len(p), max_new=9) for p in prompts[:3]]
    eng.run_until_drained()
    for p, r in zip(prompts, reqs):
        assert r.tokens == _solo(params, cfg, p, 9)
    row = _row(params, prompts[0])
    with pytest.raises(ValueError):
        eng.submit(row, len(prompts[0]), repetition_penalty=0.9)
    with pytest.raises(ValueError):
        eng.submit(row, len(prompts[0]), max_new=17, repetition_penalty=1.3)
    plain = _engine(params, cfg, n_slots=2)
    with pytest.raises(ValueError):
        plain.submit(row, len(prompts[0]), repetition_penalty=1.3)
    with pytest.raises(ValueError):
        plain.submit(row, len(prompts[0]), temperature=1.0)
    sampler = _engine(params, cfg, n_slots=2, enable_sampling=True)
    with pytest.raises(ValueError):
        sampler.submit(row, len(prompts[0]), temperature=1.0, top_k=65)
    with pytest.raises(ValueError):
        sampler.submit(row, len(prompts[0]), temperature=1.0, top_p=1.0)


def test_rep_penalty_matches_teacher_forced_oracle(setup):
    """Greedy with penalty > 1: each step's logits penalised over the tokens
    generated so far (not the prompt: the engine sees embeddings)."""
    _, _, cfg, params, prompts = setup
    p, pen, n_new = prompts[0], 1.8, 10
    eng = _engine(params, cfg, n_slots=2, max_new_default=n_new, enable_rep_penalty=True,
                  history_len=16)
    r = eng.submit(_row(params, p), len(p), max_new=n_new, repetition_penalty=pen)
    eng.run_until_drained()
    got = []
    for _ in range(n_new):
        logits = _replay_logits(params, cfg, p, got)[-1:]
        if got:
            logits = apply_repetition_penalty(logits, torch.tensor([got]), pen)
        got.append(int(torch.argmax(logits, -1)[0]))
    assert r.tokens == got
    assert r.tokens != _solo(params, cfg, p, n_new)
