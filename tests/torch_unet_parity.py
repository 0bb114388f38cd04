"""What the UNet test files share (`test_torch_unet.py`,
`test_torch_inference.py`): `unet_tiny` built in the JAX package from a
seed (its initializers drawing from numpy, `numpy_initializers`), its state
dict carried into the port's `unet_tiny` of the same arguments with
`layer_from_numpy`, both in eval(); and the inputs, from a seeded numpy
generator. CONFIGS: the tiny model as the JAX package defines it (level-1
attention at head_dim 16, off B1's gate: the port's plain attention), and
the gate variant (base 32, one head: head_dim 64, on B1's gate: the
port's B1 custom op, whose plain version runs on the CPU)."""

import numpy as np

import paddle_tpu
from paddle_tpu.models import unet as junet
from paddle_tpu_torch.models import unet as tunet
from paddle_tpu_torch.models.weights import layer_from_numpy
from torch_vision_parity import numpy_initializers

CONFIGS = {"tiny": {}, "gate": {"base_channels": 32, "num_heads": 1}}
SIZE = 16


def build(**kw):
    """(JAX unet_tiny, the port's, the JAX state as numpy) from seed 0."""
    paddle_tpu.seed(0)
    with numpy_initializers():
        ref = junet.unet_tiny(**kw)
    ref.eval()
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = layer_from_numpy(tunet.unet_tiny(**kw), state)
    port.eval()
    return ref, port, state


def inputs(batch, size=SIZE, seed=1):
    """(latents [batch, 4, size, size], timesteps [batch]) in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 4, size, size)).astype("float32")
    t = rng.uniform(0.0, 1000.0, (batch,)).astype("float32")
    return x, t
