"""Training stages 1-4 (port of ``jafpro_tpu/train``)."""
from jafpro_tpu_torch.train.common import (  # noqa: F401
    TrainState,
    sample_reference_curriculum,
)
from jafpro_tpu_torch.train.stage1 import make_stage1_step  # noqa: F401
from jafpro_tpu_torch.train.stage2 import make_stage2_step  # noqa: F401
from jafpro_tpu_torch.train.stage34 import (  # noqa: F401
    make_stage3_step, make_stage4_step)
