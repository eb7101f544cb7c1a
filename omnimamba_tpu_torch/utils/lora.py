"""Merge a task's LoRA into the base in_proj weights for inference.

Counterpart of ``omnimamba_tpu/utils/lora.py``. For a FIXED task, add each
layer's ``scaling * sum_i A_i @ B_i`` into its in_proj kernel and drop the
``lora`` subtree: the mixer then runs no LoRA product, and the whole-model
decode step (``ops/decode_fused``) takes its rank-0 branch.

The port keeps in_proj as one ``(d, d_in_proj)`` kernel and ``{task}_B`` as
one ``(n, r, d_in_proj)`` factor over the same columns (``utils/bridge``),
where the JAX package keeps four column slices; so the fold is one product
over all the columns. The product and the sum over ``lora_nums`` are taken
in fp32 and the sum is rounded once to the weight's type. JAX's einsum may
add the fp32 terms in another order, so the two merged trees agree to fp32
rounding, not bit for bit (``tests/test_torch_lora.py`` states the
tolerance).

Inference applies no LoRA dropout, so the merged forward computes the same
function for that task; in bf16 the fold rounds ``W + scale * A @ B`` once
into the weight where the unmerged path rounds the LoRA term at the
activations, so outputs can differ at rounding scale. The result is
task-specific: the other task's adapters are gone and this task's delta is
baked in.

Merge BEFORE ``ops/quant.quantize_decode_params``: folding into int8 blocks
would re-quantize noise, and an int8 in_proj is refused.
"""

from __future__ import annotations

from typing import Dict

import torch

from omnimamba_tpu_torch.config import LoraConfig


def _merge_mixer(mixer: Dict, task: str, lora_cfg: LoraConfig) -> Dict:
    lp = mixer.get("lora")
    if lp is None or f"{task}_A" not in lp:
        return mixer
    kernel = mixer["in_proj"]["kernel"]
    if not isinstance(kernel, torch.Tensor) or not kernel.is_floating_point():
        raise ValueError(
            "merge_lora needs a dense in_proj kernel: merge before quantize_decode_params")
    with torch.no_grad():
        A = lp[f"{task}_A"].float()  # (n, d, r)
        B = lp[f"{task}_B"].float()  # (n, r, d_in_proj)
        delta = torch.einsum("idr,irp->dp", A, B)  # fp32, summed over lora_nums
        merged = (kernel.float() + lora_cfg.scaling * delta).to(kernel.dtype)
    out = {k: v for k, v in mixer.items() if k != "lora"}
    out["in_proj"] = {**mixer["in_proj"], "kernel": merged}
    return out


def merge_lora(params, task: str, lora_cfg: LoraConfig):
    """Return a params tree with ``task``'s LoRA folded into in_proj.

    Takes a full model tree (``{"mamba": ...}``), a backbone tree (with
    ``"layers"``) or its list of layers. Layers without LoRA pass through
    unchanged. New tensors are made for the merged kernels; the input is
    never changed in place.
    """
    if isinstance(params, (list, tuple)):
        return type(params)(
            {**layer, "mixer": _merge_mixer(layer["mixer"], task, lora_cfg)}
            if "mixer" in layer else layer
            for layer in params)
    if "mamba" in params:
        return {**params, "mamba": merge_lora(params["mamba"], task, lora_cfg)}
    return {**params, "layers": merge_lora(params["layers"], task, lora_cfg)}
