from jafpro_tpu_torch.models.conv_lstm import ConvLSTMCell, ConvLSTM  # noqa: F401
from jafpro_tpu_torch.models.accumulate import AccumulateLSTM  # noqa: F401
from jafpro_tpu_torch.models.inpainter import UNetInpainter  # noqa: F401
from jafpro_tpu_torch.models.crn import CRN, CRNSmall, CRNSmaller  # noqa: F401
from jafpro_tpu_torch.models.propagation import (  # noqa: F401
    Propagation3DFlowNet)
from jafpro_tpu_torch.models.discriminators import (  # noqa: F401
    ImageDiscriminator,
    FaceDiscriminator,
)
from jafpro_tpu_torch.models.vgg import VGG19Features  # noqa: F401
from jafpro_tpu_torch.models.flownet import FlowNetSD, FlowNetC  # noqa: F401
from jafpro_tpu_torch.models.hmr import (  # noqa: F401
    HumanModelRecovery, ThetaRegressor)
from jafpro_tpu_torch.models.ablations import (  # noqa: F401
    AccumulateAvgFusion,
    AccumulateMask,
    AccumulateMaxFusion,
    AccumulatePlain,
    AutoEncoder,
    BlendingModule,
    CRNAuto,
    EdgeGenerator,
    InpaintGenerator,
    MaxFusionModule,
    NLayerDiscriminator,
    PatchDiscriminator70,
    PixelDiscriminator,
    PredictiveModule,
    RRDB,
    SpatioTempoCRN,
    UNetGenerator,
    UNetSE,
    UNetTA,
)
