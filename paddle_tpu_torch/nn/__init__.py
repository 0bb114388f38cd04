"""paddle.nn of the port (`paddle_tpu/nn/__init__.py`; reference
`python/paddle/nn/__init__.py`): every layer class of the JAX package's
`nn`, the initializers, `utils`, `functional` and the `ClipGrad*` classes.
Layers are port `Layer`s over port Tensors (`nn/layer/layers.py`);
`RMSNorm` runs kernels B9/B10 and `MultiHeadAttention` B1-B3 on the card,
through `nn.functional`."""

from paddle_tpu_torch.nn.layer.layers import Layer, Parameter, ParamAttr  # noqa: F401
from paddle_tpu_torch.nn.layer.common import (  # noqa: F401
    Identity, Linear, Embedding, Dropout, Dropout2D, Dropout3D, AlphaDropout,
    Flatten, Upsample, UpsamplingNearest2D, UpsamplingBilinear2D,
    Pad1D, Pad2D, Pad3D, ZeroPad2D, CosineSimilarity, Bilinear,
    PixelShuffle, PixelUnshuffle, ChannelShuffle, Unfold, Fold,
)
from paddle_tpu_torch.nn.layer.conv import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose, Conv3DTranspose,
)
from paddle_tpu_torch.nn.layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, SyncBatchNorm,
    LayerNorm, RMSNorm, GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
    LocalResponseNorm, SpectralNorm,
)
from paddle_tpu_torch.nn.layer.pooling import (  # noqa: F401
    MaxPool1D, MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
)
from paddle_tpu_torch.nn.layer.activation import (  # noqa: F401
    ReLU, ReLU6, Sigmoid, Tanh, GELU, SiLU, Swish, Mish, LeakyReLU, ELU, SELU, CELU,
    Hardtanh, Hardshrink, Softshrink, Tanhshrink, Hardsigmoid, Hardswish,
    Softplus, Softsign, LogSigmoid, Softmax, LogSoftmax, ThresholdedReLU,
    Maxout, GLU, RReLU, PReLU,
)
from paddle_tpu_torch.nn.layer.container import (  # noqa: F401
    Sequential, LayerList, LayerDict, ParameterList,
)
from paddle_tpu_torch.nn.layer.loss import (  # noqa: F401
    CrossEntropyLoss, MSELoss, L1Loss, SmoothL1Loss, HuberLoss, NLLLoss,
    BCELoss, BCEWithLogitsLoss, KLDivLoss, MarginRankingLoss, HingeEmbeddingLoss,
    CosineEmbeddingLoss, TripletMarginLoss, CTCLoss,
)
from paddle_tpu_torch.nn.layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerEncoder, TransformerEncoderLayer,
    TransformerDecoder, TransformerDecoderLayer,
)
from paddle_tpu_torch.nn.layer.rnn import (  # noqa: F401
    SimpleRNN, LSTM, GRU, SimpleRNNCell, LSTMCell, GRUCell,
)
from paddle_tpu_torch.nn.layer.extras import *  # noqa: F401,F403

from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn import initializer  # noqa: F401
from paddle_tpu_torch.nn import utils  # noqa: F401


class ClipGradByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = clip_norm


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max
