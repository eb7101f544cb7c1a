"""OmniMamba on PyTorch and CUDA: the port of ``omnimamba_tpu`` to one NVIDIA
H100, slice by slice. This package imports ``torch``, never ``jax``, and
nothing of the JAX package.

Layer map (bottom-up), same sub-packages and function names as the JAX
package so a reader finds the counterpart:

  csrc/    hand-written CUDA kernels (sm_90a) and the native COCO reader
           (C++), built at first use
  ops/     SSD scan (oracle / chunked / kernels, forward and backward),
           decode-step kernels, causal conv, norms and their kernels (forward
           and backward), int8 weight quantization and the int8 matmul
           kernel, samplers, the kernel build, the image resize, the
           selective checkpoint policies
  models/  Mamba-2 mixer, blocks, backbone + dual heads, decode engine,
           speculative decoding, the VQ-16 tokenizer, the DINOv2 and SigLIP
           towers, the vision projector, the text-to-image and
           understanding compositions and the losses
  data/    tokenizer (offline and byte-level BPE), UniversalPrompting,
           conversation templates, prompt builders, image transforms, the
           COCO and LLaVA datasets, the loaders, the native COCO reader
  serve/   the continuous-batching slot engine, the HTTP front end
  parallel/ training across ranks (dp, fsdp) over torch.distributed, the
           sequence-parallel prefill, the launcher of rank processes
  train/   schedule, stage freezing, AdamW; the training step and loop, the
           metric sinks; draft distillation
  utils/   parameter bridge from and to the JAX pytree, checkpoints, device
           resolution, converters of the published torch state dicts, the
           rank-0 logger, tracing and timing
  factory  the model bundle, parameters and prompting from a TrainConfig
  scripts/ the understanding, text-to-image, training, serving and
           pretokenizing command lines

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; a kernel wrapper uses its plain tensor version only for a
tensor that lies on the CPU.
"""

__version__ = "0.1.0"

from omnimamba_tpu_torch.config import (  # noqa: F401
    MODEL_REGISTRY,
    VISION_BACKBONES,
    VQ_MODELS,
    LoraConfig,
    Mamba2LayerConfig,
    MambaConfig,
    TrainConfig,
    ViTConfig,
    VisionConfig,
    VQConfig,
)
from omnimamba_tpu_torch.factory import build_model  # noqa: F401
from omnimamba_tpu_torch.models.generation import GenerateOutput, generate  # noqa: F401
from omnimamba_tpu_torch.models.omnimamba import (  # noqa: F401
    OmniMambaModel,
    init_omnimamba,
    lm_loss,
    mmu_embed_sequence,
    mmu_generate,
    mmu_image_features,
    mmu_loss,
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
