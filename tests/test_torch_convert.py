"""The port's checkpoint converters and VQ encoder against the JAX package's, on
the CPU.

Random state dicts in the published key names (a Mamba-2 LM with and without
its LoRA, the OmniMamba checkpoint, LlamaGen's VQ-16, timm ViTs with a
position table resampled) are converted by both packages; the JAX trees go
through the port's bridge and must equal the port's trees bit for bit, leaf
by leaf. ``encoder_forward`` is held to rtol 1e-5 of the JAX encoder (plus
1e-5 of the largest value: the two frameworks' convolutions sum in other
orders), and ``vq_encode``'s codes must be JAX's. ``build_model`` loads each
kind of ``.pth``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu import config as jcfg
from omnimamba_tpu.models import vq as jvq
from omnimamba_tpu.utils import convert as jconvert
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.factory import build_model
from omnimamba_tpu_torch.models import vq as tvq
from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel
from omnimamba_tpu_torch.train.optimizer import named_leaves
from omnimamba_tpu_torch.utils import convert as tconvert
from omnimamba_tpu_torch.utils.bridge import from_jax_params, to_jax_tree
from tests.test_convert_checkpoint import reference_style_state_dict, reference_style_vq_state_dict
from tests.test_factory_load import _full_omnimamba_sd
from tests.test_torch_helpers import nn, torch_config, tt
from tests.test_vit_convert import timm_style_sd

_MIXER = dict(d_model=32, d_state=16, headdim=8, expand=2, chunk_size=8)
_MAMBA = dict(d_model=32, n_layer=2, vocab_size=64, vqvae_vocab_size=32, num_tokens=8,
              mmu_pos_len=64, pad_vocab_size_multiple=16)
_VQ = dict(codebook_size=32, codebook_embed_dim=8, ch=16, num_res_blocks=1,
           encoder_ch_mult=(1, 2), decoder_ch_mult=(1, 2), z_channels=16)


def jax_cfg():
    return jcfg.MambaConfig(mixer=jcfg.Mamba2LayerConfig(**_MIXER), **_MAMBA)


def port_model(cfg=None, vq=None):
    return OmniMambaModel(cfg=cfg or torch_config(jax_cfg()), vq_cfg=vq or tcfg.VQConfig(**_VQ),
                          sptids={})


def assert_bits_equal(port_tree, jax_tree, model):
    """The JAX tree through the bridge equals the port's tree, leaf by leaf
    and bit for bit (paths, shapes, types, values)."""
    bridged = from_jax_params(jax_tree, model, device="cpu")
    got, want = dict(named_leaves(port_tree)), dict(named_leaves(bridged))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        w = want[path]
        assert t.dtype == w.dtype and t.shape == w.shape, path
        assert torch.equal(t, w), path


def sd_torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("lora", [True, False], ids=["with_lora", "pretrain"])
def test_convert_mamba_lm_bit_for_bit(lora):
    """A MambaLMHeadModel state dict, its table 16 rows short of the padded
    vocabulary (both packages grow it from numpy seed 0). Without LoRA keys
    (a pretrain checkpoint) each package draws a fresh LoRA: B is zero in
    both, A differs (the JAX draw depends on the process's string hash), so
    it is held to its kaiming bound and left out of the comparison."""
    jc = jax_cfg()
    sd = reference_style_state_dict(jc, np.random.default_rng(0))
    sd["backbone.embedding.weight"] = sd["backbone.embedding.weight"][:-16]
    if not lora:
        sd = {k: v for k, v in sd.items() if "lora" not in k}
    want = {"mamba": jconvert.convert_mamba_lm(sd, jc)}
    got = {"mamba": tconvert.convert_mamba_lm(sd_torch(sd), torch_config(jc))}
    assert got["mamba"]["embedding"].shape[0] == jc.padded_vocab_size
    if not lora:
        for layer in got["mamba"]["layers"]:
            for task in ("t2i", "mmu"):
                assert float(layer["mixer"]["lora"][f"{task}_B"].abs().max()) == 0.0
                A = layer["mixer"]["lora"][f"{task}_A"]
                assert float(A.abs().max()) <= 1.0 / np.sqrt(jc.d_model)
                layer["mixer"]["lora"][f"{task}_A"] = torch.zeros_like(A)
        want["mamba"]["layers"]["mixer"]["lora"] = {
            k: (np.zeros_like(v) if k.endswith("_A") else v)
            for k, v in want["mamba"]["layers"]["mixer"]["lora"].items()}
    assert_bits_equal(got, want, port_model())
    # and back: to_jax_tree of the port's tree is the JAX tree
    back = to_jax_tree(got, port_model())["mamba"]
    np.testing.assert_array_equal(back["layers"]["mixer"]["in_proj"]["bc"],
                                  want["mamba"]["layers"]["mixer"]["in_proj"]["bc"])


def test_convert_omnimamba_checkpoint_bit_for_bit():
    jc = jax_cfg()
    sd = _full_omnimamba_sd(jc, np.random.default_rng(1))
    want = jconvert.convert_omnimamba_checkpoint(sd, jc)
    got = tconvert.convert_omnimamba_checkpoint(sd_torch(sd), torch_config(jc))
    assert set(got) == set(want) == {"mamba", "projector"}
    assert_bits_equal(got, want, port_model())


def test_convert_vq_bit_for_bit():
    sd = reference_style_vq_state_dict(jcfg.VQConfig(**_VQ), np.random.default_rng(2))
    want = {"vq": jconvert.convert_vq(sd, jcfg.VQConfig(**_VQ))}
    got = {"vq": tconvert.convert_vq(sd_torch(sd), tcfg.VQConfig(**_VQ))}
    assert_bits_equal(got, want, port_model())
    back = to_jax_tree(got, port_model())["vq"]
    np.testing.assert_array_equal(back["encoder"]["levels"][0]["downsample"]["kernel"],
                                  want["vq"]["encoder"]["levels"][0]["downsample"]["kernel"])


@pytest.mark.parametrize("layout", ["dino_resampled", "siglip", "dino_embed_class"])
def test_convert_timm_vit_bit_for_bit(layout):
    """DINOv2 with cls + register tokens and LayerScale from a 3 x 3 grid
    resampled to 2 x 2 (the antialiased bicubic of both packages), SigLIP
    without prefix tokens, and a table whose cls row leads."""
    reg = layout != "siglip"
    kw = dict(img_size=28, patch_size=14, width=32, depth=3, num_heads=2,
              num_reg_tokens=4 if reg else 0, use_cls_token=reg, layerscale=reg)
    jv, tv = jcfg.ViTConfig(**kw), tcfg.ViTConfig(**kw)
    rng = np.random.default_rng(3)
    if layout == "dino_resampled":
        sd = timm_style_sd(jcfg.ViTConfig(**{**kw, "img_size": 42}), rng)
    else:
        sd = timm_style_sd(jv, rng, embed_class_pos=layout == "dino_embed_class")
    want = jconvert.convert_timm_vit(sd, jv)
    got = tconvert.convert_timm_vit(sd_torch(sd), tv)
    assert tuple(got["pos_embed"].shape) == (1, 4, 32)
    vis = tcfg.VisionConfig(dino=tv, siglip=tv)
    model = port_model()._replace(vision_cfg=vis)
    assert_bits_equal({"vision": {"dino": got}}, {"vision": {"dino": want}}, model)


def test_resample_abs_pos_embed_bit_for_bit():
    pos = np.random.default_rng(4).standard_normal((1, 37 * 37, 16)).astype(np.float32)
    want = jconvert.resample_abs_pos_embed(pos, 27)
    got = tconvert.resample_abs_pos_embed(torch.from_numpy(pos), 27)
    np.testing.assert_array_equal(nn(got), want)
    assert tconvert.resample_abs_pos_embed(torch.from_numpy(pos), 37).shape == (1, 1369, 16)


def test_load_torch_state_dict_unwraps_model(tmp_path):
    sd = {"a.weight": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
    torch.save({"model": sd, "optimizer": {}}, tmp_path / "vq.pth")
    torch.save(sd, tmp_path / "flat.pth")
    for name in ("vq.pth", "flat.pth"):
        got = tconvert.load_torch_state_dict(str(tmp_path / name))
        want = jconvert.load_torch_state_dict(str(tmp_path / name))
        assert set(got) == set(want) == {"a.weight"}
        assert got["a.weight"].dtype == torch.float32
        np.testing.assert_array_equal(nn(got["a.weight"]), want["a.weight"])


# ---------------------------------------------------------------------------
# the VQ encoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vq_pair():
    jvcfg, tvcfg = jcfg.VQConfig(**_VQ), tcfg.VQConfig(**_VQ)
    sd = reference_style_vq_state_dict(jvcfg, np.random.default_rng(5))
    # a published codebook is l2-normalised at use; keep the random one small
    jp = jconvert.convert_vq(sd, jvcfg)
    return jvcfg, tvcfg, jp, tconvert.convert_vq(sd_torch(sd), tvcfg)


def test_encoder_forward(vq_pair):
    jvcfg, tvcfg, jp, tp = vq_pair
    img = np.random.default_rng(6).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jvq.encoder_forward(jax_tree(jp["encoder"]), jnp.asarray(img), jvcfg))
    got = nn(tvq.encoder_forward(tp["encoder"], tt(img), tvcfg))
    assert got.shape == want.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("training", [False, True])
def test_vq_encode_codes_equal_jax(vq_pair, training):
    jvcfg, tvcfg, jp, tp = vq_pair
    img = np.random.default_rng(7).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    want = jvq.vq_encode(jax_tree(jp), jnp.asarray(img), jvcfg, training=training)
    got = tvq.vq_encode(tp, tt(img), tvcfg, training=training)
    np.testing.assert_array_equal(nn(got.indices), np.asarray(want.indices))
    np.testing.assert_allclose(nn(got.quant), np.asarray(want.quant), rtol=1e-6, atol=1e-6)
    for k in ("vq_loss", "commit_loss", "entropy_loss"):
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)), rtol=1e-5,
                                   atol=1e-7)
    # a decode of the codes goes back through the decoder of the same tree
    assert tvq.vq_decode_code(tp, got.indices.reshape(3, -1), tvcfg).shape == (3, 16, 16, 3)


def test_quantize_entropy_loss_and_straight_through():
    cfg = dataclasses.replace(tcfg.VQConfig(**_VQ), entropy_loss_ratio=0.1)
    jc = dataclasses.replace(jcfg.VQConfig(**_VQ), entropy_loss_ratio=0.1)
    cb = np.random.default_rng(8).standard_normal((32, 8)).astype(np.float32)
    z = np.random.default_rng(9).standard_normal((2, 3, 3, 8)).astype(np.float32)
    want = jvq.quantize({"codebook": jnp.asarray(cb)}, jnp.asarray(z), jc, training=True)
    zt = tt(z).requires_grad_()
    got = tvq.quantize({"codebook": tt(cb)}, zt, cfg, training=True)
    np.testing.assert_array_equal(nn(got.indices), np.asarray(want.indices))
    np.testing.assert_allclose(got.entropy_loss.item(), float(want.entropy_loss), rtol=1e-5)
    got.quant.sum().backward()
    assert zt.grad is not None and torch.isfinite(zt.grad).all()


def jax_tree(tree):
    """numpy leaves as JAX arrays (lists of levels kept)."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree(v) for v in tree]
    return jnp.asarray(tree)


# ---------------------------------------------------------------------------
# build_model loads each kind of .pth
# ---------------------------------------------------------------------------


def test_build_model_loads_each_pth(tmp_path):
    """vq_ckpt (LlamaGen VQ-16 nested under "model"), omnimamba_ckpt (backbone
    and projector) and mamba_pretrain (a MambaLMHeadModel without LoRA) into
    the tiny model; every converted leaf lands, cast to the model's type."""
    from omnimamba_tpu_torch.config import MODEL_REGISTRY, VQConfig

    base = MODEL_REGISTRY["OmniMamba-Tiny"]().resized(50287)
    jbase = jcfg.MODEL_REGISTRY["OmniMamba-Tiny"]().resized(50287)
    rng = np.random.default_rng(10)
    vq_sd = reference_style_vq_state_dict(jcfg.VQConfig(), rng)  # the published VQ-16 shapes
    torch.save({"model": sd_torch(vq_sd)}, tmp_path / "vq.pth")
    omni_sd = _full_omnimamba_sd(jbase, rng)
    torch.save(sd_torch(omni_sd), tmp_path / "omni.pth")
    lm_sd = {k: v for k, v in reference_style_state_dict(jbase, rng).items() if "lora" not in k}
    torch.save(sd_torch(lm_sd), tmp_path / "lm.pth")

    def cfg(**kw):
        return tcfg.TrainConfig(omnimamba_model="OmniMamba-Tiny", image_backbone="dinosiglip-tiny",
                                mmu_task=False, **kw)

    model, params, _ = build_model(cfg(vq_ckpt=str(tmp_path / "vq.pth"),
                                       omnimamba_ckpt=str(tmp_path / "omni.pth")),
                                   dtype=torch.bfloat16, device="cpu")
    want_vq = tconvert.convert_vq(sd_torch(vq_sd), VQConfig())
    want_mamba = tconvert.convert_mamba_lm(
        {k.removeprefix("llm_backbone.mamba."): v for k, v in sd_torch(omni_sd).items()},
        dataclasses.replace(base, mmu_task=False))
    for got, want in ((params["vq"], want_vq), (params["mamba"], want_mamba)):
        live = dict(named_leaves(got))
        for path, t in named_leaves(want):
            assert live[path].dtype == torch.bfloat16, path
            assert torch.equal(live[path], t.to(torch.bfloat16)), path
    assert "projector" not in params  # no mmu task: the checkpoint's projector is skipped

    _, params, _ = build_model(cfg(mamba_pretrain=str(tmp_path / "lm.pth")), device="cpu")
    assert torch.equal(params["mamba"]["norm_f"]["weight"],
                       torch.from_numpy(lm_sd["backbone.norm_f.weight"]))
    assert float(params["mamba"]["layers"][0]["mixer"]["lora"]["t2i_B"].abs().max()) == 0.0
    with pytest.raises(ValueError, match="shape"):
        bad = dict(lm_sd, **{"backbone.norm_f.weight": np.zeros(7, np.float32)})
        torch.save(sd_torch(bad), tmp_path / "bad.pth")
        build_model(cfg(mamba_pretrain=str(tmp_path / "bad.pth")), device="cpu")
