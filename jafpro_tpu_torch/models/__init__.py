from jafpro_tpu_torch.models.accumulate import AccumulateLSTM  # noqa: F401
from jafpro_tpu_torch.models.crn import CRNSmaller  # noqa: F401
from jafpro_tpu_torch.models.inpainter import UNetInpainter  # noqa: F401
from jafpro_tpu_torch.models.propagation import (  # noqa: F401
    Propagation3DFlowNet)
