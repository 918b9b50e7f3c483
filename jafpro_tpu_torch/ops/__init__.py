from jafpro_tpu_torch.ops.sampling import (  # noqa: F401
    grid_sample,
    resample2d,
    resize_bilinear,
    resize_nearest,
)
from jafpro_tpu_torch.ops.image import (  # noqa: F401
    avg_pool_3x3s2,
    max_pool_3x3s2,
    channel_norm,
)
from jafpro_tpu_torch.ops.correlation import correlation  # noqa: F401
