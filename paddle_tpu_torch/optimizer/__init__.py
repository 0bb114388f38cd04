from paddle_tpu_torch.optimizer.optimizer import (  # noqa: F401
    ASGD, Adadelta, Adagrad, Adam, AdamW, Adamax, LBFGS, Lamb, Momentum,
    NAdam, Optimizer, RAdam, RMSProp, Rprop, SGD,
)
from paddle_tpu_torch.optimizer import lr  # noqa: F401
