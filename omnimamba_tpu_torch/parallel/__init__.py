"""Training and decoding across ranks (dp, fsdp, tp over heads) and the
sequence-parallel prefill, over ``torch.distributed``: counterpart of
``omnimamba_tpu/parallel/``."""

from omnimamba_tpu_torch.parallel.mesh import create_mesh, init_distributed  # noqa: F401
from omnimamba_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    param_shardings,
    shard_batch,
    shard_params,
)
