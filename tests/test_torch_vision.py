"""The vision side of the understanding path: the port's preprocessing,
ViT towers, projector and their parameter bridge against the JAX package,
on the CPU, on the tiny towers (``_dinosiglip_tiny``) and small projectors.

Parameters come from the JAX ``init_*`` functions and go through the bridge;
inputs are made with numpy from a seed. Tolerances (absolute, on values of
order 1 unless noted):

- ``vit_transform``: 1e-5 of the largest value (the same separable resize
  weights, products in another order);
- towers in fp32: 2e-5 of the largest feature; in bf16: 2^-7 of the value
  plus 2^-6 of the largest (two rounding points of a few ulp each per block,
  two blocks);
- projectors in fp32: 2e-5 of the largest output;
- the bridge: bit for bit both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu import config as jcfg
from omnimamba_tpu.data import transforms as jtr
from omnimamba_tpu.models import projector as jproj
from omnimamba_tpu.models import vit as jvit
from omnimamba_tpu.ops.norms import layer_norm as j_layer_norm
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.data import transforms as ttr
from omnimamba_tpu_torch.models import projector as tproj
from omnimamba_tpu_torch.models import vit as tvit
from omnimamba_tpu_torch.models.omnimamba import init_omnimamba as t_init_omnimamba
from omnimamba_tpu_torch.ops.norms import layer_norm
from omnimamba_tpu_torch.ops.resize import resize
from omnimamba_tpu_torch.utils.bridge import from_jax_params, to_jax_tree
from omnimamba_tpu.models.omnimamba import init_omnimamba as j_init_omnimamba
from tests.test_torch_helpers import nn, tiny_mmu_models, to_numpy, tt

TRANSFORM_TOL = 1e-5
TOWER_TOL = 2e-5
PROJ_TOL = 2e-5


def raw_images(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def close(got, want, tol):
    """|got - want| <= tol * max|want| element by element."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(nn(got), want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("strategy", ["resize-naive", "resize-crop", "letterbox"])
@pytest.mark.parametrize("shape", [(2, 40, 64, 3), (1, 90, 33, 3), (2, 20, 20, 3)])
def test_vit_transform(strategy, shape):
    """Shrinking (antialiased), growing and a square input, every strategy."""
    raw = raw_images(1, shape)
    for tower in ("dino", "siglip"):
        jc = getattr(jcfg._dinosiglip_tiny(), tower)
        tc = getattr(tcfg._dinosiglip_tiny(), tower)
        want = np.asarray(jtr.vit_transform(jnp.asarray(raw), jc, strategy))
        got = ttr.vit_transform(torch.from_numpy(raw), tc, strategy)
        assert got.dtype == torch.float32 and got.shape == want.shape
        close(got, want, TRANSFORM_TOL)


def test_dinosiglip_transform_at_384_and_host_path():
    raw = raw_images(2, (1, 61, 47, 3))
    want = jtr.dinosiglip_transform(jnp.asarray(raw), jcfg.VisionConfig())
    got = ttr.dinosiglip_transform(torch.from_numpy(raw), tcfg.VisionConfig())
    for k in ("dino", "siglip"):
        assert tuple(got[k].shape) == (1, 384, 384, 3)
        close(got[k], want[k], TRANSFORM_TOL)
    # the PIL path is numpy on both sides: equal
    for strategy in ("resize-naive", "letterbox"):
        h_want = jtr.host_dinosiglip_transform(raw[0], jcfg._dinosiglip_tiny(), strategy)
        h_got = ttr.host_dinosiglip_transform(raw[0], tcfg._dinosiglip_tiny(), strategy)
        for k in ("dino", "siglip"):
            np.testing.assert_array_equal(h_got[k], h_want[k])


@pytest.mark.parametrize("method,n_in,n_out", [
    ("bicubic", 37, 24), ("bicubic", 10, 24), ("linear", 27, 14), ("linear", 9, 4)])
def test_resize_weights_match_jax_image_resize(method, n_in, n_out):
    x = np.random.default_rng(3).standard_normal((2, n_in, n_in, 5)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, n_out, n_out, 5), method))
    got = resize(torch.from_numpy(x), (n_out, n_out), (1, 2), method)
    np.testing.assert_allclose(nn(got), want, rtol=0, atol=TRANSFORM_TOL * np.abs(x).max())


def test_vq_range_helpers():
    x = np.linspace(-1.3, 1.3, 97, dtype=np.float32)
    np.testing.assert_array_equal(nn(ttr.from_vq_range(torch.from_numpy(x))),
                                  np.asarray(jtr.from_vq_range(jnp.asarray(x))))
    raw = raw_images(4, (3, 5, 3))
    np.testing.assert_array_equal(nn(ttr.to_vq_range(torch.from_numpy(raw))),
                                  np.asarray(jtr.to_vq_range(jnp.asarray(raw))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(5)
    x = jnp.asarray(3 * rng.standard_normal((4, 7, 48)) + 1, dtype)
    w, b = jnp.asarray(rng.standard_normal(48), dtype), jnp.asarray(rng.standard_normal(48), dtype)
    want = np.asarray(j_layer_norm(x, w, b, 1e-6).astype(jnp.float32))
    got = layer_norm(tt(x), tt(w), tt(b), 1e-6)
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    tol = 2e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(nn(got), want, rtol=tol, atol=tol)


def tower_params(seed, tower, dtype=jnp.float32):
    """JAX init_vit parameters of one tiny tower and their bridged copy.
    LayerScale gammas of 1e-5 would hide the blocks: set them to 0.5."""
    jc = getattr(jcfg._dinosiglip_tiny(), tower)
    jp = jvit.init_vit(jax.random.PRNGKey(seed), jc, dtype)
    if "ls1" in jp["blocks"]:
        blocks = dict(jp["blocks"])
        for k in ("ls1", "ls2"):
            blocks[k] = {"gamma": jnp.full_like(blocks[k]["gamma"], 0.5)}
        jp = {**jp, "blocks": blocks}
    _, tm = tiny_mmu_models()
    tp = from_jax_params({"vision": {tower: to_numpy(jp)}}, tm, device="cpu")["vision"][tower]
    return jc, jp, tp


def pixels(seed, n, size=56):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("tower", ["dino", "siglip"])
def test_vit_features_fp32(tower):
    jc, jp, tp = tower_params(6, tower)
    tc = getattr(tcfg._dinosiglip_tiny(), tower)
    px = pixels(7, 2)
    want = np.asarray(jvit.vit_features(jp, jnp.asarray(px), jc))
    got = tvit.vit_features(tp, torch.from_numpy(px), tc)
    assert tuple(got.shape) == (2, tc.num_patches, tc.width) == want.shape
    close(got, want, TOWER_TOL)
    # one block less (out_offset=3): the prefix is stripped the same way
    want3 = np.asarray(jvit.vit_features(jp, jnp.asarray(px), jc, out_offset=3))
    close(tvit.vit_features(tp, torch.from_numpy(px), tc, out_offset=3), want3, TOWER_TOL)


@pytest.mark.parametrize("tower", ["dino", "siglip"])
def test_vit_features_bf16(tower):
    """bf16 weights and pixels on both sides: the same rounding points."""
    jc, jp, tp = tower_params(8, tower, jnp.bfloat16)
    tc = getattr(tcfg._dinosiglip_tiny(), tower)
    px = pixels(9, 2)
    want = np.asarray(jvit.vit_features(jp, jnp.asarray(px, jnp.bfloat16), jc).astype(jnp.float32))
    got = tvit.vit_features(tp, torch.from_numpy(px).bfloat16(), tc)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(nn(got), want, rtol=2.0 ** -7, atol=2.0 ** -6 * scale)


def test_dinosiglip_features():
    jc, jd, td = tower_params(10, "dino")
    _, js, ts = tower_params(11, "siglip")
    raw = raw_images(12, (2, 70, 50, 3))
    jpx = jtr.dinosiglip_transform(jnp.asarray(raw), jcfg._dinosiglip_tiny())
    tpx = ttr.dinosiglip_transform(torch.from_numpy(raw), tcfg._dinosiglip_tiny())
    want = np.asarray(jvit.dinosiglip_features(jd, js, jpx, jcfg._dinosiglip_tiny()))
    got = tvit.dinosiglip_features(td, ts, tpx, tcfg._dinosiglip_tiny())
    assert tuple(got.shape) == (2, 16, 128)
    close(got, want, TOWER_TOL)


ARCHS = ["linear", "gelu-mlp", "fused-gelu-mlp", "ldpnet", "fused-ldpnet"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grid", [27, 28])
def test_projector(arch, grid):
    """Every arch; for ldpnet a 27 x 27 grid (pooled by the linear resize,
    as at 384 px) and a 28 x 28 one (by window means)."""
    vdim, ldim = 24, 16
    jp = jproj.init_projector(jax.random.PRNGKey(13), vdim, ldim, arch)
    _, tm = tiny_mmu_models()
    tp = from_jax_params({"projector": to_numpy(jp)}, tm, device="cpu")["projector"]
    x = np.random.default_rng(14).standard_normal((2, grid * grid, vdim)).astype(np.float32)
    want = np.asarray(jproj.apply_projector(jp, jnp.asarray(x), arch))
    got = tproj.apply_projector(tp, torch.from_numpy(x), arch)
    assert tuple(got.shape) == want.shape
    close(got, want, PROJ_TOL)


def test_projector_rejects_unknown_arch_and_ragged_grid():
    with pytest.raises(ValueError, match="unsupported projector arch"):
        tproj.canonical_arch("mlp-3x")
    with pytest.raises(ValueError, match="square"):
        tproj._token_down(torch.zeros(1, 10, 4))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", ["fused-gelu-mlp", "fused-ldpnet"])
def test_bridge_round_trip_vision_and_projector(dtype, arch):
    """JAX tree -> port -> JAX tree, bit for bit: the towers' stacked blocks,
    the HWIO patch and position-conv kernels, the fused qkv, the backbone."""
    jm, tm = tiny_mmu_models()
    jm, tm = jm._replace(projector_arch=arch), tm._replace(projector_arch=arch)
    jp = j_init_omnimamba(jax.random.PRNGKey(15), jm, dtype, with_vq=False)
    src = to_numpy(jp)
    tp = from_jax_params(src, tm, device="cpu")
    d = tm.vision_cfg.dino
    assert tuple(tp["vision"]["dino"]["patch_embed"]["kernel"].shape) == (d.width, 3, 14, 14)
    assert len(tp["vision"]["siglip"]["blocks"]) == tm.vision_cfg.siglip.depth
    assert tuple(tp["vision"]["dino"]["blocks"][1]["attn"]["qkv"]["kernel"].shape) == (
        d.width, 3 * d.width)
    back = to_jax_tree(tp, tm)
    flat_src = dict(jax.tree_util.tree_leaves_with_path(src))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_src.keys() == flat_back.keys()
    for path, a in flat_src.items():
        assert a.dtype == flat_back[path].dtype and np.array_equal(a, flat_back[path]), path


def test_init_omnimamba_vision_distributions():
    """The port's own init: towers and projector shaped as the JAX tree, with
    the JAX init's distributions; a bundle without vision_cfg has none."""
    jm, tm = tiny_mmu_models()
    gen = torch.Generator().manual_seed(0)
    tp = t_init_omnimamba(gen, tm, device="cpu", with_vq=False)
    jp = to_numpy(j_init_omnimamba(jax.random.PRNGKey(0), jm, with_vq=False))
    shapes = {k: np.shape(v) for k, v in jax.tree_util.tree_leaves_with_path(to_jax_tree(
        {"vision": tp["vision"], "projector": tp["projector"]}, tm))}
    want = {k: np.shape(v) for k, v in jax.tree_util.tree_leaves_with_path(
        {"vision": jp["vision"], "projector": jp["projector"]})}
    assert shapes == want
    dino = tp["vision"]["dino"]
    assert float(dino["cls_token"].abs().max()) == 0.0 and float(dino["reg_tokens"].abs().max()) == 0.0
    assert float(dino["blocks"][0]["ls1"]["gamma"][0]) == pytest.approx(1e-5)
    fc1 = tp["projector"]["fc1"]["kernel"]
    assert float(fc1.abs().max()) <= 1.0 / np.sqrt(fc1.shape[0])
    assert abs(float(dino["pos_embed"].std()) - 0.02) < 0.004
    no_vision = t_init_omnimamba(gen, tm._replace(vision_cfg=None), device="cpu", with_vq=False)
    assert set(no_vision) == {"mamba"}
