"""Data parallelism over ranks (port of ``jafpro_tpu/parallel``)."""
from jafpro_tpu_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    shard_batch,
    replicate,
    data_parallel_jit,
    initialize_distributed,
    spawn,
)
