"""``utils/lora.merge_lora`` of the port against the JAX package's, on the
tiny backbone (fp32, CPU), and the two inference CLIs' merge.

The port folds ``scaling * A @ B`` into its one concatenated in_proj kernel
where JAX folds it into four column slices; both take the product and the
sum over ``lora_nums`` in fp32 and round once, so the merged kernels agree
to fp32 rounding: each element within MERGE_TOL of the largest |W|. The
merged forward equals the unmerged one to JAX's own ``rtol=atol=2e-5``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from omnimamba_tpu.config import LoraConfig as JLoraConfig
from omnimamba_tpu.models.backbone import init_backbone as j_init_backbone
from omnimamba_tpu.ops.quant import quantize_decode_params as j_quantize
from omnimamba_tpu.utils.lora import merge_lora as j_merge_lora
from omnimamba_tpu_torch.models.backbone import backbone_forward, embed_text, init_backbone
from omnimamba_tpu_torch.ops.decode_fused import fused_decode_limits, fused_decode_step
from omnimamba_tpu_torch.ops.quant import quantize_decode_params
from omnimamba_tpu_torch.utils.lora import merge_lora
from tests.test_backbone import tiny_config
from tests.test_torch_helpers import bridge_backbone, nn, torch_config

MERGE_TOL = 2.0 ** -22  # of the largest |W|: a few fp32 roundings of the fold
FWD_TOL = 2e-5  # tests/test_lora_merge.py


def make_setup(lora_nums):
    """The JAX tiny backbone with every adapter given weight (B is zero at
    init: a merge would be a no-op), as ``tests/test_lora_merge.py`` makes
    it, and its bridged copy."""
    jcfg = dataclasses.replace(tiny_config(), lora=JLoraConfig(lora_nums=lora_nums))
    jp = j_init_backbone(jax.random.PRNGKey(0), jcfg, dtype=jax.numpy.float32)
    lora = jp["layers"]["mixer"]["lora"]
    keys = jax.random.split(jax.random.PRNGKey(42), len(lora))
    jp["layers"]["mixer"]["lora"] = {
        k: 0.3 * jax.random.normal(kk, v.shape, v.dtype) for (k, v), kk in zip(lora.items(), keys)}
    base = torch_config(jcfg)
    cfg = dataclasses.replace(base, lora=dataclasses.replace(base.lora, lora_nums=lora_nums))
    tp = bridge_backbone(jp, cfg)
    emb = embed_text(tp, torch.arange(12)[None], torch.float32)
    return jcfg, cfg, jp, tp, emb


@pytest.fixture(scope="module")
def setup():
    return make_setup(1)


@pytest.fixture(scope="module")
def setup_two_adapters():
    """lora_nums 2: the fold sums the two adapters' products."""
    return make_setup(2)


def forward(params, emb, task, cfg):
    with torch.no_grad():
        return backbone_forward(params, emb, task, cfg)[0]


@pytest.mark.parametrize("lora_nums", [1, 2])
@pytest.mark.parametrize("task", ["t2i", "mmu"])
def test_merge_matches_jax(setup, setup_two_adapters, task, lora_nums):
    jcfg, cfg, jp, tp, _ = setup if lora_nums == 1 else setup_two_adapters
    got = merge_lora(tp, task, cfg.lora)
    want = bridge_backbone(j_merge_lora(jp, task, jcfg.lora), cfg)
    for g, w, base in zip(got["layers"], want["layers"], tp["layers"]):
        assert "lora" not in g["mixer"] and "lora" not in w["mixer"]
        gk, wk = g["mixer"]["in_proj"]["kernel"], w["mixer"]["in_proj"]["kernel"]
        assert gk.dtype == wk.dtype == torch.float32
        np.testing.assert_allclose(nn(gk), nn(wk), rtol=0, atol=MERGE_TOL * wk.abs().max().item())
        assert not torch.equal(gk, base["mixer"]["in_proj"]["kernel"])  # the adapters count


def test_merged_forward_matches(setup):
    """As ``tests/test_lora_merge.py``: the t2i forward. (On the mmu task
    these adapters, 0.3 x randn, put the port's fp32 forward, merged or not,
    further than 2e-5 from an fp64 one; the mmu merge is held by the kernels
    above.)"""
    _, cfg, _, tp, emb = setup
    task = "t2i"
    np.testing.assert_allclose(nn(forward(merge_lora(tp, task, cfg.lora), emb, task, cfg)),
                               nn(forward(tp, emb, task, cfg)), rtol=FWD_TOL, atol=FWD_TOL)


def test_merge_is_task_specific(setup):
    """Merging t2i drops every adapter: the tree is wrong for mmu."""
    _, cfg, _, tp, emb = setup
    merged = merge_lora(tp, "t2i", cfg.lora)
    assert (forward(merged, emb, "mmu", cfg) - forward(tp, emb, "mmu", cfg)).abs().max() > 1e-6


def test_every_tree_form_and_the_input_unchanged(setup):
    _, cfg, _, tp, _ = setup
    before = [layer["mixer"]["in_proj"]["kernel"].clone() for layer in tp["layers"]]
    backbone = merge_lora(tp, "t2i", cfg.lora)
    full = merge_lora({"mamba": tp, "extra": 1}, "t2i", cfg.lora)
    layers = merge_lora(tp["layers"], "t2i", cfg.lora)
    assert full["extra"] == 1 and isinstance(layers, list)
    for a, b, c, base, old in zip(backbone["layers"], full["mamba"]["layers"], layers,
                                  tp["layers"], before):
        k = a["mixer"]["in_proj"]["kernel"]
        assert torch.equal(k, b["mixer"]["in_proj"]["kernel"])
        assert torch.equal(k, c["mixer"]["in_proj"]["kernel"])
        assert "lora" in base["mixer"] and torch.equal(base["mixer"]["in_proj"]["kernel"], old)
        assert a["mixer"]["out_proj"]["kernel"] is base["mixer"]["out_proj"]["kernel"]
    assert backbone["embedding"] is tp["embedding"]


def test_merge_noop_without_lora(setup):
    _, cfg, _, _, _ = setup
    cfg_nl = dataclasses.replace(cfg, lora=None)
    p2 = init_backbone(torch.Generator().manual_seed(1), cfg_nl, torch.float32, "cpu")
    out = merge_lora(p2, "t2i", cfg.lora)
    assert all(a["mixer"] is b["mixer"] for a, b in zip(out["layers"], p2["layers"]))


def test_merge_then_quantize(setup):
    """An int8 in_proj is refused; merging first composes with
    ``quantize_decode_params``: q within one step of JAX's quantized merge
    (the merged kernels agree to fp32 rounding), no LoRA left, and the
    whole-model decode step takes its rank-0 branch."""
    jcfg, cfg, jp, tp, _ = setup
    with pytest.raises(ValueError, match="quantize_decode_params"):
        merge_lora(quantize_decode_params(tp), "t2i", cfg.lora)
    got = quantize_decode_params(merge_lora(tp, "t2i", cfg.lora))
    want = bridge_backbone(j_quantize(j_merge_lora(jp, "t2i", jcfg.lora)), cfg)
    for g, w in zip(got["layers"], want["layers"]):
        gq, wq = g["mixer"]["in_proj"]["kernel"], w["mixer"]["in_proj"]["kernel"]
        assert gq["q"].dtype == torch.int8 and "lora" not in g["mixer"]
        assert (gq["q"].int() - wq["q"].int()).abs().max() <= 1
        np.testing.assert_allclose(nn(gq["scale"]), nn(wq["scale"]), rtol=1e-6, atol=0)
    assert fused_decode_limits(got["layers"], cfg.mixer, cfg.lora, torch.float32) is None


def test_merged_decode_step_matches_the_lora_step(setup):
    """K4's plain version: the merged layers' step without LoRA (rank 0)
    against the unmerged layers' step with the t2i LoRA."""
    from omnimamba_tpu_torch.models.backbone import BackboneCache

    _, cfg, _, tp, _ = setup
    mc, g = cfg.mixer, torch.Generator().manual_seed(3)
    L, B = cfg.n_layer, 3

    def cache():
        g.manual_seed(4)
        return BackboneCache(
            torch.randn((L, B, mc.d_conv - 1, mc.d_conv_in), generator=g),
            torch.randn((L, B, mc.nheads, mc.headdim, mc.d_state), generator=g))

    h = torch.randn((B, cfg.d_model), generator=g)
    merged = merge_lora(tp, "t2i", cfg.lora)["layers"]
    with torch.no_grad():
        c0, c1 = cache(), cache()
        h0, r0, _ = fused_decode_step(tp["layers"], h, None, c0, "t2i", mc, cfg.lora)
        h1, r1, _ = fused_decode_step(merged, h, None, c1, "t2i", mc, cfg.lora)
    for got, want in ((h1, h0), (r1, r0), (c1.conv_state, c0.conv_state),
                      (c1.ssm_state, c0.ssm_state)):
        np.testing.assert_allclose(nn(got), nn(want), rtol=FWD_TOL, atol=FWD_TOL)


# ---------------------------------------------------------------------------
# the inference CLIs merge the task's LoRA unless --no-merge-lora
# ---------------------------------------------------------------------------


def _merges(monkeypatch):
    from omnimamba_tpu_torch.utils import lora

    calls = []  # the task of each merge of a whole model tree (not of its subtrees)
    real = lora.merge_lora

    def merge(p, task, c):
        if isinstance(p, dict) and "mamba" in p:
            calls.append(task)
        return real(p, task, c)

    monkeypatch.setattr(lora, "merge_lora", merge)
    return calls


def test_inference_t2i_cli_merges(monkeypatch, tmp_path):
    from omnimamba_tpu_torch.scripts import inference_t2i
    from tests.test_torch_mmu import TINY_YAML

    calls = _merges(monkeypatch)
    common = ["--prompt", "a corgi", "--config", TINY_YAML, "--device", "cpu", "--dtype", "float32",
              "--out", str(tmp_path / "g.npy")]
    merged = inference_t2i.main(common)
    assert calls == ["t2i"]
    plain = inference_t2i.main(common + ["--no-merge-lora"])
    assert calls == ["t2i"] and merged.shape == plain.shape == (256, 256, 3)


def test_inference_mmu_cli_merges(monkeypatch, tmp_path):
    from omnimamba_tpu_torch.scripts import inference_mmu
    from tests.test_torch_mmu import TINY_YAML, raw_images

    calls = _merges(monkeypatch)
    img = tmp_path / "img.npy"
    np.save(img, raw_images(21, 1)[0])
    common = ["--image_path", str(img), "--question", "What is it?", "--config", TINY_YAML,
              "--device", "cpu", "--max-length", "40", "--dtype", "float32"]
    merged = inference_mmu.main(common)
    assert calls == ["mmu"]
    plain = inference_mmu.main(common + ["--no-merge-lora"])
    assert calls == ["mmu"] and len(merged) == len(plain) == 1
