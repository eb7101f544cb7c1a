"""OmniMamba on PyTorch and CUDA: the port of ``omnimamba_tpu`` to one NVIDIA
H100, slice by slice. This package imports ``torch``, never ``jax``, and
nothing of the JAX package.

Layer map (bottom-up), same sub-packages and function names as the JAX
package so a reader finds the counterpart:

  csrc/    hand-written CUDA kernels (sm_90a), built at first use
  ops/     SSD scan (oracle / chunked / kernels, forward and backward),
           decode-step kernels, causal conv, norms and their kernels (forward
           and backward), int8 weight quantization and the int8 matmul
           kernel, samplers, the kernel build
  models/  Mamba-2 mixer, blocks, backbone + dual heads, decode engine,
           speculative decoding, VQ-16 decode side, the text-to-image
           composition and the losses
  serve/   the continuous-batching slot engine
  train/   schedule, stage freezing, AdamW; the training step and loop
  utils/   parameter bridge from and to the JAX pytree, checkpoints, device
           resolution

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; a kernel wrapper uses its plain tensor version only for a
tensor that lies on the CPU.
"""

__version__ = "0.1.0"

from omnimamba_tpu_torch.config import (  # noqa: F401
    MODEL_REGISTRY,
    VQ_MODELS,
    LoraConfig,
    Mamba2LayerConfig,
    MambaConfig,
    TrainConfig,
    VQConfig,
)
from omnimamba_tpu_torch.models.generation import GenerateOutput, generate  # noqa: F401
from omnimamba_tpu_torch.models.omnimamba import (  # noqa: F401
    OmniMambaModel,
    init_omnimamba,
    lm_loss,
    t2i_generate,
    t2i_loss,
)
from omnimamba_tpu_torch.models.speculative import (  # noqa: F401
    shallow_draft,
    speculative_generate,
)
from omnimamba_tpu_torch.ops.quant import (  # noqa: F401
    quantize_decode_params,
    quantize_linear,
    quantize_ssm_state,
)
from omnimamba_tpu_torch.ops.sampling import SampleParams  # noqa: F401
from omnimamba_tpu_torch.serve.continuous import SlotEngine  # noqa: F401
from omnimamba_tpu_torch.train.trainer import (  # noqa: F401
    Trainer,
    TrainState,
    create_train_state,
    make_train_step,
)
from omnimamba_tpu_torch.utils.bridge import from_jax_params, to_jax_tree  # noqa: F401
from omnimamba_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: F401
