"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU and
nvcc and are skipped elsewhere. Run them on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

They reuse the checks of ``chip_smoke.py`` (main-path shapes and awkward
shapes, fp32 and bf16, with its stated tolerances), which raise on a
mismatch.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    # decided here, at run time, never while the module is imported
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize(
    "check", ["check_ssd_scan", "check_ssd_scan_bwd", "check_ssd_step", "check_norms",
              "check_norms_bwd", "check_decode_fused", "check_qmatmul", "check_decode_fused_int8",
              "check_ssd_step_int8"])
def test_kernel_against_plain_version(card, check):
    import chip_smoke

    results = {}
    getattr(chip_smoke, check)(card, results)
    assert results and all(r["ms"] > 0 for r in results.values())


def test_decode_engine_kernels_against_plain_versions(card):
    import chip_smoke

    chip_smoke.plain_vs_kernel()


def test_training_loss_and_gradients_kernels_against_plain_versions(card):
    import chip_smoke

    chip_smoke.train_plain_vs_kernel()
