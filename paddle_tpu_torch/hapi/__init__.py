"""paddle.hapi (`paddle_tpu/hapi/__init__.py`): `Model` with fit /
evaluate / predict / save / load, the callbacks, and `summary`."""

from paddle_tpu_torch.hapi.model import Model, InputSpec  # noqa: F401
from paddle_tpu_torch.hapi import callbacks  # noqa: F401
from paddle_tpu_torch.hapi.callbacks import Callback, ProgBarLogger, ModelCheckpoint, EarlyStopping  # noqa: F401


def summary(net, input_size=None, dtypes=None):
    n_params = sum(p.size for p in net.parameters())
    print(f"Total params: {n_params}")
    return {"total_params": n_params}
