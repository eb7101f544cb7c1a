"""int8 serving in the PyTorch port against the JAX package, on the CPU.

Quantized trees must be bit-equal (the rounding points are the JAX ones);
the int8 product's plain version is held against the Pallas kernel in
interpret mode; the whole-model decode step on int8 weights against JAX
``fused_decode_step`` (the Pallas kernel in interpret mode); the scaled-int8
state step against JAX ``ssd_step`` (q and scale equal, y to 1e-5); greedy
token streams with int8 weights and with the int8 state against JAX's. Tiny
geometry (and a wide one whose int8 step takes the tensor-core tiles on the
card), fp32, LoRA B factors filled so the branch counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.models import backbone as jbb
from omnimamba_tpu.models.generation import generate as j_generate
from omnimamba_tpu.models.omnimamba import init_omnimamba
from omnimamba_tpu.models.omnimamba import t2i_generate as j_t2i_generate
from omnimamba_tpu.ops import quant as jq
from omnimamba_tpu.ops.decode_fused import to_fused_cache
from omnimamba_tpu.ops.quant_pallas import qmatmul_pallas
from omnimamba_tpu.ops.sampling import SampleParams as JSampleParams
from omnimamba_tpu.ops.ssd_reference import ssd_step as j_ssd_step
from omnimamba_tpu_torch import SampleParams, generate, t2i_generate
from omnimamba_tpu_torch.models import backbone as tbb
from omnimamba_tpu_torch.ops import quant as tq
from omnimamba_tpu_torch.ops.decode_fused import fused_decode_step
from omnimamba_tpu_torch.ops.quant_kernel import qmatmul, qmatmul_plain
from omnimamba_tpu_torch.ops.ssd_reference import ssd_step
from omnimamba_tpu_torch.ops.ssd_step_kernel import ssd_step_fused
from tests.test_torch_decode_fused import (  # out_proj_pairs: a fixture
    _without_lora_jax, _without_lora_torch, assert_caches_close, check_out_proj_step, close,
    out_proj_pairs)
from tests.test_torch_helpers import bridge, decode_side, fill_lora_b, nn, tiny_models, tt

L0 = 6


@pytest.fixture(scope="module")
def quantized():
    """(jax model, torch model, jax tree, jax int8 tree, bridged int8 tree, jax int8
    tree with the whole VQ model), fp32."""
    jmodel, tmodel = tiny_models()
    jp = init_omnimamba(jax.random.PRNGKey(0), jmodel, with_vision=False)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(0))
    full = jq.quantize_decode_params({"mamba": {**jp["mamba"], "layers": layers}, "vq": jp["vq"]})
    jp = {"mamba": {**jp["mamba"], "layers": layers}, "vq": decode_side(jp["vq"])}
    jq_p = {"mamba": full["mamba"], "vq": decode_side(full["vq"])}
    return jmodel, tmodel, jp, jq_p, bridge(jq_p, tmodel), full


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), path


@pytest.mark.parametrize("shape,axes", [((64, 48), (0,)), ((48, 64), (1,)), ((3, 40, 24), (1,)),
                                        ((7, 5), (0,))])
def test_quantize_linear_bit_equal(shape, axes):
    w = (0.1 * np.random.default_rng(1).standard_normal(shape)).astype(np.float32)
    w[0] = 0.0  # an all-zero channel takes the 1e-8 floor
    j = jq.quantize_linear(jnp.asarray(w), axes)
    t = tq.quantize_linear(tt(w), axes)
    assert t["q"].dtype == torch.int8 and t["scale"].dtype == torch.float32
    np.testing.assert_array_equal(nn(t["q"]), np.asarray(j["q"]))
    np.testing.assert_array_equal(nn(t["scale"]), np.asarray(j["scale"]))


def test_quantize_ssm_state_bit_equal():
    s = np.random.default_rng(2).standard_normal((2, 3, 4, 8, 16)).astype(np.float32)
    s[0, 0, 0, 0] = 0.0  # an all-zero row
    j = jq.quantize_ssm_state(jnp.asarray(s))
    t = tq.quantize_ssm_state(tt(s))
    assert t["scale"].shape == (2, 3, 4, 8)
    np.testing.assert_array_equal(nn(t["q"]), np.asarray(j["q"]))
    np.testing.assert_array_equal(nn(t["scale"]), np.asarray(j["scale"]))
    np.testing.assert_array_equal(nn(tq.dequantize_ssm_state(t)),
                                  np.asarray(jq.dequantize_ssm_state(j)))


@pytest.mark.parametrize("fused", [False, True])
def test_quantize_decode_params_matches_jax_leaf_for_leaf(quantized, fused):
    """The port quantizes its own (fused in_proj) tree; JAX quantizes the split
    parts. Bridged, the two are equal bit for bit, also after JAX
    ``fuse_in_proj``."""
    _, tmodel, jp, jq_p, _, _ = quantized
    mine = tq.quantize_decode_params(bridge(jp, tmodel))
    theirs = bridge(jq.fuse_in_proj(jq_p) if fused else jq_p, tmodel)
    assert_trees_equal(theirs, mine)
    layer = mine["mamba"]["layers"][0]["mixer"]
    assert tq.is_quantized(layer["in_proj"]["kernel"]) and tq.is_quantized(layer["out_proj"]["kernel"])
    assert tq.is_quantized(mine["mamba"]["embedding"])
    assert not tq.is_quantized(layer["lora"]["t2i_B"]) and "q" not in mine["mamba"]["caption_embed"]
    # bf16 weights are quantized from their own values; the scale stays fp32
    bf = tq.quantize_decode_params(bridge(jp, tmodel, dtype=torch.bfloat16))
    assert bf["mamba"]["embedding"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("O", [512, 200, 139])
@pytest.mark.parametrize("B", [1, 8, 13, 130, 257])
def test_qmatmul_plain_matches_the_pallas_kernel(B, O, transpose):
    rng = np.random.default_rng(B * 1000 + O)
    K = 48
    w = (0.05 * rng.standard_normal((O, K) if transpose else (K, O))).astype(np.float32)
    x = rng.standard_normal((B, K)).astype(np.float32)
    qe = jq.quantize_linear(jnp.asarray(w), (1,) if transpose else (0,))
    ref = np.asarray(qmatmul_pallas(jnp.asarray(x), qe["q"], qe["scale"], transpose=transpose,
                                    interpret=True))
    got = qmatmul(tt(x), tt(qe["q"]), tt(qe["scale"]), transpose=transpose)
    assert got.shape == (B, O) and got.dtype == torch.float32
    np.testing.assert_allclose(nn(got), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(nn(got), nn(qmatmul_plain(tt(x), tt(qe["q"]), tt(qe["scale"]),
                                                            transpose)))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("O", [128, 192])
@pytest.mark.parametrize("M", [1, 16, 48])
def test_qmatmul_bf16_whole_tiles_match_the_pallas_kernel(M, O, transpose):
    """bf16 activations on whole tiles below M_TILE rows, the shapes that take
    the decode path on the card: the wrapper on the CPU (the plain version)
    against the Pallas kernel in interpret mode, both returning x's type. The
    two sum in fp32 in other orders, so a result may round to the other of two
    neighbouring bf16 values: one bf16 rounding, 2^-7 of the value."""
    rng = np.random.default_rng(M * 1000 + O + transpose)
    K = 128
    w = (0.05 * rng.standard_normal((O, K) if transpose else (K, O))).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((M, K)), dtype=jnp.bfloat16)
    qe = jq.quantize_linear(jnp.asarray(w), (1,) if transpose else (0,))
    ref = np.asarray(qmatmul_pallas(x, qe["q"], qe["scale"], transpose=transpose,
                                    interpret=True)).astype(np.float32)
    got = qmatmul(tt(x), tt(qe["q"]), tt(qe["scale"]), transpose=transpose)
    assert got.shape == (M, O) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(nn(got), ref, rtol=2.0 ** -7, atol=2e-5 * np.abs(ref).max())


def test_matmul_any_and_lookup_any_match_jax():
    rng = np.random.default_rng(5)
    w = (0.05 * rng.standard_normal((40, 24))).astype(np.float32)
    x = rng.standard_normal((2, 3, 40)).astype(np.float32)
    table = rng.standard_normal((30, 40)).astype(np.float32)
    ids = np.array([[0, 7, 29], [3, 3, 11]])
    qw, qt = jq.quantize_linear(jnp.asarray(w), (0,)), jq.quantize_linear(jnp.asarray(table), (1,))
    tw, tq_t = tq.quantize_linear(tt(w), (0,)), tq.quantize_linear(tt(table), (1,))
    for entry_j, entry_t in ((qw, tw), ({"kernel": jnp.asarray(w)}, {"kernel": tt(w)}),
                             ({"kernel": qw}, {"kernel": tw})):
        ref = np.asarray(jq.matmul_any(jnp.asarray(x), entry_j))
        np.testing.assert_allclose(nn(tq.matmul_any(tt(x), entry_t)), ref, rtol=1e-6, atol=1e-6)
    # the weight-tied head: transposed table, fp32 out, from bf16 activations
    xb = jnp.asarray(x[0]).astype(jnp.bfloat16)
    ref = np.asarray(jq.matmul_any(xb, qt, transpose=True, out_dtype=jnp.float32))
    got = tq.matmul_any(tt(xb), tq_t, transpose=True, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nn(got), ref, rtol=1e-6, atol=1e-6)
    for dtype_j, dtype_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        for entry_j, entry_t in ((qt, tq_t), (jnp.asarray(table), tt(table))):
            ref = np.asarray(jq.lookup_any(entry_j, jnp.asarray(ids), dtype_j).astype(jnp.float32))
            got = tq.lookup_any(entry_t, tt(ids), dtype_t)
            assert got.dtype == dtype_t
            np.testing.assert_array_equal(nn(got), ref)


# (B, with D, decay, (H, P, G, N)): every case at (4, 8, 1, 16); with D and a
# random decay, three rows a warp with lanes past N (the tile kernel's shapes
# on the card) and N = 256 (the kernel it leaves to the row kernel)
_INT8_STEP_CASES = [
    pytest.param(B, with_d, decay, (4, 8, 1, 16), id=f"{with_d}-{B}-{decay}")
    for decay in ("one", "random") for B in (1, 3) for with_d in (True, False)
] + [
    pytest.param(B, True, "random", shape, id=f"True-{B}-random-{'x'.join(map(str, shape))}")
    for shape in ((6, 24, 2, 20), (4, 16, 1, 256)) for B in (1, 3)
]


@pytest.mark.parametrize("B, with_d, decay, shape", _INT8_STEP_CASES)
def test_int8_state_step_matches_jax(B, with_d, decay, shape):
    """With A = 0 the decay exp(dt A) is exactly 1 on both sides and q and
    scale must be bit-equal. With a random A the two frameworks' exp differ
    in the last bit, so the new state can too: the scale is held to 2 ulp and
    q may differ by one unit only where the value lies within 1e-4 of a
    rounding boundary."""
    rng = np.random.default_rng(B + 10 * with_d)
    H, P, G, N = shape
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)) - 1.0)).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    if decay == "one":
        A = np.zeros_like(A)
    Bm, Cm = (0.5 * rng.standard_normal((2, B, G, N))).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32) if with_d else None
    state = jq.quantize_ssm_state(jnp.asarray(rng.standard_normal((B, H, P, N)).astype(np.float32)))
    yj, sj = j_ssd_step(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
                        jnp.asarray(Cm), None if D is None else jnp.asarray(D), state)
    tstate = {k: tt(v) for k, v in state.items()}
    args = (tt(x), tt(dt), tt(A), tt(Bm), tt(Cm), None if D is None else tt(D))
    yt, st = ssd_step(*args, tstate)
    qj, scj = np.asarray(sj["q"]), np.asarray(sj["scale"])
    if decay == "one":
        np.testing.assert_array_equal(nn(st["q"]), qj)
        np.testing.assert_array_equal(nn(st["scale"]), scj)
    else:
        np.testing.assert_allclose(nn(st["scale"]), scj, rtol=2.5e-7, atol=0)
        value = nn(tq.dequantize_ssm_state(st)) / nn(st["scale"])[..., None]
        near = np.abs(np.abs(value - np.floor(value)) - 0.5) < 1e-4
        dq = np.abs(nn(st["q"]).astype(int) - qj.astype(int))
        assert dq.max() <= 1 and np.all(near[dq > 0])
    np.testing.assert_allclose(nn(yt), np.asarray(yj), rtol=1e-5, atol=1e-5 * np.abs(yj).max())
    # the kernel wrapper updates q and scale in place (its plain version on the CPU)
    q_obj = tstate["q"]
    yk, sk = ssd_step_fused(*args, tstate)
    assert sk is tstate and sk["q"] is q_obj
    assert torch.equal(sk["q"], st["q"]) and torch.equal(sk["scale"], st["scale"])
    assert torch.equal(yk, yt)


def test_quantize_ssm_state_by_layer_bit_equal():
    """The prefill state quantized one layer at a time (what generate does
    with cache_dtype="int8") gives the bits of the whole stack quantized at
    once, all-zero rows included."""
    rng = np.random.default_rng(5)
    s = rng.standard_normal((3, 2, 4, 8, 16)).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -30, 30, (3, 2, 4, 8, 1))
    s[1, 0, 2] = 0.0
    whole = tq.quantize_ssm_state(tt(s))
    by_layer = tq.quantize_ssm_state_by_layer(tt(s))
    assert by_layer["q"].dtype == torch.int8 and by_layer["scale"].dtype == torch.float32
    assert torch.equal(by_layer["q"], whole["q"])
    assert torch.equal(by_layer["scale"].view(torch.int32), whole["scale"].view(torch.int32))


@pytest.mark.parametrize("task", ["t2i", "mmu"])
@pytest.mark.parametrize("B", [1, 3])
def test_int8_fused_step_matches_jax(quantized, task, B):
    """K4's int8 branch (plain version) against JAX ``fused_decode_step`` on
    ``quantize_decode_params`` (the Pallas kernel in interpret mode), to the
    tolerance of one fused step in ``test_torch_decode_fused.py``."""
    jmodel, tmodel, _, jq_p, tq_p, _ = quantized
    rng = np.random.default_rng(40 + B)
    emb = (0.5 * rng.standard_normal((B, L0, 32))).astype(np.float32)
    _, jcache = jbb.backbone_forward(jq_p["mamba"], jnp.asarray(emb), task, jmodel.cfg,
                                     scan_impl="chunked", return_cache=True)
    tcache = tbb.BackboneCache(tt(jcache.conv_state), tt(jcache.ssm_state))
    tok = rng.integers(0, 32, (B,))
    d_inner = jmodel.cfg.mixer.d_inner
    hj, fcache = jbb.backbone_step_fused(
        jq_p["mamba"], jnp.asarray(tok, jnp.int32), jnp.int32(L0), to_fused_cache(jcache, d_inner),
        task, jmodel.cfg, dtype=jnp.float32)
    ht, out = tbb.backbone_step_fused(tq_p["mamba"], tt(tok), L0, tcache, task, tmodel.cfg,
                                      dtype=torch.float32)
    np.testing.assert_allclose(nn(ht), np.asarray(hj), rtol=1e-5, atol=1e-5)
    n_layer, _, H, P, N = out.ssm_state.shape
    np.testing.assert_allclose(nn(out.ssm_state.reshape(n_layer, B, H * P, N)),
                               np.asarray(fcache.ssm)[:, :B], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn(out.conv_state[..., :d_inner]), np.asarray(fcache.conv_x)[:, :B],
                               rtol=1e-5, atol=1e-5)


# The geometry of test_torch_decode_fused.py's ``wide_pair``: d_model, d_inner
# and the in_proj width (2 * 128 + 2 * 28 + 8 = 320) are multiples of 64, so an
# int8 step of bf16 activations there runs the in_proj's two-block clusters on
# the card, each int8 weight tile widened to bf16 in registers. On the CPU the
# wrapper runs the plain version, the reference the card's kernel is held against.
_WIDE_MIXER = dict(d_model=64, d_state=28, headdim=16, expand=2, chunk_size=16)


@pytest.fixture(scope="module")
def wide_quantized():
    """(jax model, torch model, jax int8 backbone params, bridged torch int8
    params) at d_model 64, fp32, LoRA B factors filled; the int8 trees are JAX
    ``quantize_decode_params``'s."""
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
    full = jq.quantize_decode_params({"mamba": {**jp["mamba"], "layers": layers}, "vq": jp["vq"]})
    jq_p = {"mamba": full["mamba"], "vq": decode_side(full["vq"])}
    return jmodel, tmodel, jq_p["mamba"], bridge(jq_p, tmodel)["mamba"]


@pytest.mark.parametrize("lora", [True, False], ids=["lora", "no_lora"])
@pytest.mark.parametrize("B", [16, 17, 48, 96, 112])
def test_int8_fused_step_matches_jax_on_tensor_core_tiles(wide_quantized, B, lora):
    """K4's int8 branch at the batches where the card's row tiling of the int8
    in_proj changes (16 and 17 rows: one m16 fragment and a partial second;
    48; 96, one 96-row tile; 112, two), with and without the LoRA branch: the
    plain version against JAX ``backbone_step_fused`` on
    ``quantize_decode_params`` (Pallas in interpret mode), fp32, 1e-5."""
    jmodel, tmodel, jm, tm = wide_quantized
    mixer = tmodel.cfg.mixer
    assert mixer.d_model % 64 == 0 and mixer.d_inner % 64 == 0 and mixer.d_in_proj % 64 == 0
    assert tq.is_quantized(tm["layers"][0]["mixer"]["in_proj"]["kernel"])
    if not lora:
        jm, tm = _without_lora_jax(jm), _without_lora_torch(tm)
    rng = np.random.default_rng(600 + B)
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
    # CPU tensors: the plain version, no launch counted
    assert (fused_decode_step.launches, fused_decode_step.int8_launches) == before
    close(ht, hj, 1e-5)
    assert_caches_close(fcache, out, B, mixer.d_inner, 1e-5)


@pytest.mark.parametrize("B", [1, 16, 17, 48, 96, 112])
@pytest.mark.parametrize("d_inner", [512, 1536, 2560], ids=["ksplit1", "ksplit2", "ksplit3_short"])
def test_int8_fused_step_matches_jax_on_the_out_proj(out_proj_pairs, d_inner, B):
    """K4's int8 branch where the card's int8 out_proj changes (one, two or
    three K splits, the last one short; 1 to 112 rows, the edges of the pair
    kernel's 16-row fragments and 96-row tiles): the plain version against
    JAX ``backbone_step_fused`` on ``quantize_decode_params`` (Pallas in
    interpret mode), fp32, every output within 1e-5, no launch counted."""
    check_out_proj_step(out_proj_pairs, d_inner, B, int8=True)


def _streams(quantized, task, ids, **kw):
    jmodel, tmodel, _, jq_p, tq_p, _ = quantized
    jm, tm = jq_p["mamba"], tq_p["mamba"]
    if task == "t2i":
        ej = jbb.caption_embed(jm, jbb.embed_text(jm, jnp.asarray(ids), jnp.float32))
        et = tbb.caption_embed(tm, tbb.embed_text(tm, tt(ids), torch.float32))
        ej, et = ej + jm["pos_embed"][:, :L0], et + tm["pos_embed"][:, :L0]
    else:
        ej, et = jbb.embed_text(jm, jnp.asarray(ids), jnp.float32), tbb.embed_text(tm, tt(ids), torch.float32)
    decode_impl, cache_dtype = kw.pop("decode_impl"), kw.pop("cache_dtype")
    ref = j_generate(jm, jmodel.cfg, input_ids=jnp.asarray(ids, jnp.int32), input_embeddings=ej,
                     task=task, max_length=L0 + 12, sample=JSampleParams(top_k=1),
                     scan_impl="chunked", cache_dtype=cache_dtype,
                     decode_impl="scan" if cache_dtype == "int8" else decode_impl)
    got = generate(tm, tmodel.cfg, input_ids=tt(ids), input_embeddings=et, task=task,
                   max_length=L0 + 12, sample=SampleParams(top_k=1), cache_dtype=cache_dtype,
                   decode_impl=decode_impl, return_logits=True, device="cpu")
    return got, ref


@pytest.mark.parametrize("path", [("fused", None), ("scan", None), ("auto", "int8")])
@pytest.mark.parametrize("task", ["t2i", "mmu"])
def test_int8_greedy_streams_match_jax(quantized, task, path):
    decode_impl, cache_dtype = path
    ids = np.random.default_rng(50).integers(0, 32, (2, L0))
    got, ref = _streams(quantized, task, ids, decode_impl=decode_impl, cache_dtype=cache_dtype)
    tok_t, tok_j = nn(got.sequences), np.asarray(ref.sequences)
    if not np.array_equal(tok_t, tok_j):
        b, step = np.argwhere(tok_t != tok_j)[0]
        top2 = torch.topk(got.logits[step - L0][b], 2).values
        raise AssertionError(f"streams differ at row {b} position {step}; top-2 margin "
                             f"{float(top2[0] - top2[1]):.3e}")


def test_int8_t2i_generate_matches_jax(quantized):
    """The slice as a whole: ``t2i_generate`` on quantized parameters, tokens
    equal and images close, on the fused path and on the scan path with the
    int8 state."""
    jmodel, tmodel, _, _, tq_p, jq_full = quantized
    ids = np.random.default_rng(51).integers(0, 49, (2, 8))
    img_j, tok_j = j_t2i_generate(jq_full, jmodel, jnp.asarray(ids), sample=JSampleParams(top_k=1),
                                  dtype=jnp.float32, scan_impl="chunked", cache_dtype=None)
    for kw in (dict(cache_dtype=None), dict(cache_dtype="int8")):
        img_t, tok_t = t2i_generate(tq_p, tmodel, ids, sample=SampleParams(top_k=1),
                                    dtype=torch.float32, device="cpu", **kw)
        if kw["cache_dtype"] is None:
            np.testing.assert_array_equal(nn(tok_t), np.asarray(tok_j))
            np.testing.assert_allclose(nn(img_t), np.asarray(img_j), rtol=2e-4, atol=2e-4)
        else:
            _, tok_j8 = j_t2i_generate(jq_full, jmodel, jnp.asarray(ids), dtype=jnp.float32,
                                       sample=JSampleParams(top_k=1), scan_impl="chunked",
                                       cache_dtype="int8", decode_image=False)
            np.testing.assert_array_equal(nn(tok_t), np.asarray(tok_j8))
