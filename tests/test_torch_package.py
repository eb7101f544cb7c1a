"""Package-level contracts of the PyTorch port: what it imports, where it
runs, and when a kernel wrapper may use its plain version."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import omnimamba_tpu_torch
from omnimamba_tpu_torch import (
    MambaConfig, OmniMambaModel, VQConfig, from_jax_params, generate, init_omnimamba, t2i_generate,
)
from omnimamba_tpu_torch.config import TrainConfig
from omnimamba_tpu_torch.models.backbone import init_backbone
from omnimamba_tpu_torch.models.vq import init_vq
from omnimamba_tpu_torch.ops import kernel_build
from omnimamba_tpu_torch.ops.norms_kernel import (
    fused_add_rms_norm,
    fused_add_rms_norm_bwd,
    fused_gated_rms_norm,
    fused_gated_rms_norm_bwd,
)
from omnimamba_tpu_torch.ops.ssd_kernel import ssd_fused, ssd_fused_bwd
from omnimamba_tpu_torch.ops.quant import quantize_decode_params, quantize_linear, quantize_ssm_state
from omnimamba_tpu_torch.ops.quant_kernel import qmatmul
from omnimamba_tpu_torch.ops.ssd_step_kernel import ssd_step_fused
from omnimamba_tpu_torch.models.speculative import speculative_generate
from omnimamba_tpu_torch.serve.continuous import SlotEngine
from omnimamba_tpu_torch.train.trainer import Trainer, make_train_step

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        omnimamba_tpu_torch.__path__, prefix="omnimamba_tpu_torch."))


def test_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter: neither ``jax`` nor ``omnimamba_tpu`` ends up loaded, and
    importing needs no nvcc, no triton and no GPU."""
    mods = port_modules()
    assert "omnimamba_tpu_torch.ops.ssd_kernel" in mods and len(mods) >= 20
    # the serving slice's modules are among them
    assert {"omnimamba_tpu_torch.ops.quant", "omnimamba_tpu_torch.ops.quant_kernel",
            "omnimamba_tpu_torch.serve.continuous", "omnimamba_tpu_torch.models.speculative"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'triton' or m == 'omnimamba_tpu' "
        "or m.startswith('omnimamba_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.startswith("clean")


def port_sources():
    """The port's Python sources. ``omnimamba_tpu_torch/build/`` is where the
    kernels are built (ignored by git): whatever lies there is not the port's."""
    pkg = ROOT / "omnimamba_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if "build" not in p.relative_to(pkg).parts[:1]) + [ROOT / "chip_smoke.py"]


def test_sources_do_not_name_jax_imports():
    sources = port_sources()
    assert ROOT / "omnimamba_tpu_torch" / "train" / "trainer.py" in sources
    # a copy of the repository under the build directory is not searched
    stray = ROOT / "omnimamba_tpu_torch" / "build" / "_package_test_probe"
    stray.mkdir(parents=True, exist_ok=True)
    probe = stray / "probe.py"
    probe.write_text("import jax\n")
    try:
        assert probe not in port_sources()
    finally:
        probe.unlink()
        stray.rmdir()
    for path in sources:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax", "import omnimamba_tpu ",
                                            "from omnimamba_tpu.", "from omnimamba_tpu ")), (path, line)


def test_csrc_ships_as_package_data():
    names = {p.name for p in kernel_build.CSRC_DIR.iterdir()}
    assert {"common.cuh", "ssd_step_row.cuh", "norms.cu", "ssd_scan.cu", "ssd_scan_bwd.cu",
            "ssd_step.cu", "decode_fused.cu", "qmatmul.cu"} <= names
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert re.search(r'omnimamba_tpu_torch\s*=\s*\["csrc/\*\.cu", "csrc/\*\.cuh"\]', pyproject)


def test_build_lists_every_header_the_sources_include():
    """The library's hash covers the sources and ``kernel_build.HEADERS``: a
    header the sources include but the list misses would not rebuild it."""
    included = set()
    for path in kernel_build.CSRC_DIR.glob("*.cu*"):
        included |= set(re.findall(r'#include "([^"]+)"', path.read_text()))
    on_disk = {p.name for p in kernel_build.CSRC_DIR.glob("*.cuh")}
    assert included == on_disk == set(kernel_build.HEADERS)


def tiny():
    from omnimamba_tpu_torch.config import Mamba2LayerConfig

    mixer = Mamba2LayerConfig(d_model=32, d_state=16, headdim=8, chunk_size=16)
    cfg = MambaConfig(d_model=32, n_layer=2, vocab_size=64, vqvae_vocab_size=32, num_tokens=4,
                      mmu_pos_len=16, mixer=mixer)
    vq = VQConfig(codebook_size=32, ch=16, num_res_blocks=1, encoder_ch_mult=(1, 2),
                  decoder_ch_mult=(1, 2), z_channels=16)
    return OmniMambaModel(cfg=cfg, vq_cfg=vq, sptids={})


ENTRY_POINTS = {
    "init_backbone": lambda m, p: init_backbone(torch.Generator(), m.cfg),
    "init_vq": lambda m, p: init_vq(torch.Generator(), m.vq_cfg),
    "init_omnimamba": lambda m, p: init_omnimamba(torch.Generator(), m),
    "t2i_generate": lambda m, p: t2i_generate(p, m, np.zeros((1, 4), np.int64)),
    "generate": lambda m, p: generate(
        p["mamba"], m.cfg, input_ids=torch.zeros(1, 4, dtype=torch.long),
        input_embeddings=torch.zeros(1, 4, 32), task="t2i", max_length=8),
    "from_jax_params": lambda m, p: from_jax_params({"mamba": {}}, m),
    "make_train_step": lambda m, p: make_train_step(m, None, TrainConfig(mmu_task=False)),
    "Trainer": lambda m, p: Trainer(m, p, TrainConfig(mmu_task=False, stage="align"), []),
    "SlotEngine": lambda m, p: SlotEngine(quantize_decode_params(p["mamba"]), m.cfg),
    "speculative_generate": lambda m, p: speculative_generate(
        p["mamba"], m.cfg, input_ids=torch.zeros(1, 4, dtype=torch.long),
        input_embeddings=torch.zeros(1, 4, 32), task="t2i", max_length=8, draft_layers=1),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cuda_default_entry_point_raises_without_a_card(name):
    """Entry points default to device="cuda"; with no card they raise, they
    do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a CUDA device")
    model = tiny()
    params = init_omnimamba(torch.Generator().manual_seed(0), model, device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ENTRY_POINTS[name](model, params)


def test_cpu_runs_when_asked_and_random_init_is_seeded():
    model = tiny()
    a = init_omnimamba(torch.Generator().manual_seed(3), model, device="cpu")
    b = init_omnimamba(torch.Generator().manual_seed(3), model, device="cpu")
    assert torch.equal(a["mamba"]["layers"][1]["mixer"]["in_proj"]["kernel"],
                       b["mamba"]["layers"][1]["mixer"]["in_proj"]["kernel"])
    assert float(a["mamba"]["pos_embed"].abs().max()) <= 0.04 + 1e-6  # truncated at 2 std
    assert float(a["mamba"]["layers"][0]["mixer"]["lora"]["t2i_B"].abs().max()) == 0.0
    imgs, toks = t2i_generate(a, model, [[1, 2, 3, 4]], dtype=torch.float32, device="cpu")
    assert toks.shape == (1, 4) and imgs.shape == (1, 4, 4, 3) and torch.isfinite(imgs).all()
    with pytest.raises(ValueError, match="lies on"):
        generate(a["mamba"], model.cfg, input_ids=torch.zeros(1, 4, dtype=torch.long),
                 input_embeddings=torch.zeros(1, 4, 32, device="meta"), task="t2i",
                 max_length=8, device="cpu")


def test_wrappers_use_the_plain_version_only_on_the_cpu():
    """A CPU tensor takes the plain version: no build, no launch counted. The
    choice is made from the tensor's device alone: there is no environment
    switch and no size guard in the wrappers' sources."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 4, 8, generator=g)
    dt = torch.rand(2, 5, 4, generator=g)
    A = -torch.rand(4, generator=g)
    Bm, Cm = torch.randn(2, 5, 2, 16, generator=g), torch.randn(2, 5, 2, 16, generator=g)
    wrappers = (ssd_fused, ssd_step_fused, fused_add_rms_norm, fused_gated_rms_norm,
                ssd_fused_bwd, fused_add_rms_norm_bwd, fused_gated_rms_norm_bwd, qmatmul)
    before = [w.launches for w in wrappers] + [ssd_step_fused.int8_launches]
    ssd_fused(x, dt, A, Bm, Cm, None)
    # the backward wrappers, called directly and through autograd
    _, _, states = ssd_fused(x, dt, A, Bm, Cm, None, return_chunk_states=True)
    ssd_fused_bwd(x, dt, A, Bm, Cm, None, states, torch.ones_like(x), None)
    leaf = x.clone().requires_grad_()
    ssd_fused(leaf, dt, A, Bm, Cm, None)[0].sum().backward()
    rows = torch.randn(3, 32, generator=g)
    fused_add_rms_norm_bwd(rows, rows, torch.ones(32), None)
    fused_gated_rms_norm_bwd(rows, rows, rows, torch.ones(32))
    w_leaf = torch.ones(32, requires_grad=True)
    (fused_add_rms_norm(rows, rows, w_leaf)[0].sum()
     + fused_gated_rms_norm(rows, rows, w_leaf).sum()).backward()
    assert leaf.grad is not None and w_leaf.grad is not None
    ssd_step_fused(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], None, torch.zeros(2, 4, 8, 16))
    fused_add_rms_norm(torch.randn(3, 32, generator=g), None, torch.ones(32))
    fused_gated_rms_norm(torch.randn(3, 32, generator=g), torch.randn(3, 32, generator=g), torch.ones(32))
    qw = quantize_linear(torch.randn(32, 24, generator=g), (0,))
    qmatmul(rows, qw["q"], qw["scale"])
    qmatmul(rows, qw["q"].T.contiguous(), qw["scale"], transpose=True, out_dtype=torch.float32)
    ssd_step_fused(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], None,
                   quantize_ssm_state(torch.randn(2, 4, 8, 16, generator=g)))
    assert [w.launches for w in wrappers] + [ssd_step_fused.int8_launches] == before
    assert kernel_build.load_kernels.cache_info().currsize == 0, "a CPU call must not build or load"
    for mod in ("norms_kernel", "ssd_kernel", "ssd_step_kernel", "decode_fused", "norms",
                "kernel_build", "quant", "quant_kernel"):
        src = (ROOT / "omnimamba_tpu_torch" / "ops" / f"{mod}.py").read_text()
        assert "os.environ.get(\"OMNIMAMBA" not in src and "is_available" not in src
        assert not re.search(r"^\s*(try|except\b.*):", src, re.M), (
            f"{mod}: no try/except around a build or a launch")


_WIDE = torch.zeros(3, 5, 40)
ROW_LAYOUTS = {
    # name: (tensor, trailing dims of a row, expected row stride or None = copied)
    "contiguous": (_WIDE, 1, 40),
    "column_slice": (_WIDE[..., 8:24], 1, 40),
    "column_slice_as_heads": (_WIDE[..., 8:24].reshape(3, 5, 4, 4), 2, 40),
    "one_token": (_WIDE[:, 0, :8], 1, 200),
    "single_row": (_WIDE[0, 0], 1, 40),
    "uneven_rows": (_WIDE[:, ::2, :8], 1, None),
    "transposed": (_WIDE.transpose(0, 1)[..., :8], 1, None),
    "strided_columns": (_WIDE[..., ::2], 1, None),
}


@pytest.mark.parametrize("name", sorted(ROW_LAYOUTS))
def test_as_rows_passes_column_slices_without_a_copy(name):
    """The mixer hands the kernels column slices of the fused in_proj and conv
    outputs; they go in with a row stride. Only a layout that is not evenly
    spaced dense rows is copied."""
    t, inner, stride = ROW_LAYOUTS[name]
    rows, got = kernel_build.as_rows(t, inner)
    if stride is None:
        assert rows.is_contiguous() and rows.data_ptr() != t.data_ptr()
        assert got == int(np.prod(t.shape[-inner:])) and torch.equal(rows, t)
    else:
        assert rows is t and got == stride


def test_no_entry_point_chooses_the_scan():
    """One scan per case (kernel for a fresh sequence, chunked tensor code for
    a continuation): no argument of the model's functions picks another."""
    import inspect

    from omnimamba_tpu_torch.models import backbone, blocks, mamba2

    for fn in (t2i_generate, generate, backbone.backbone_forward, blocks.block_forward,
               mamba2.mamba2_forward):
        assert "scan_impl" not in inspect.signature(fn).parameters, fn


def test_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """With no nvcc the build raises; nothing carries on without the kernels."""
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernel_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernel_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_build.build_kernels()
    assert not (tmp_path / "build").exists()
