"""SMPL, projection, the rasterizer (a CUDA kernel, built at first use)
and the SMPL flow (port of ``jafpro_tpu/geometry``)."""
from jafpro_tpu_torch.geometry.smpl import (  # noqa: F401
    SMPLModel, batch_rodrigues)
from jafpro_tpu_torch.geometry.projection import (  # noqa: F401
    orthographic_proj_withz_idrot,
    look_at,
    default_eye,
)
from jafpro_tpu_torch.geometry.rasterizer import (  # noqa: F401
    rasterize_fim_wim)
from jafpro_tpu_torch.geometry.flow import (  # noqa: F401
    SMPLFlowEngine, cal_bc_transform)
