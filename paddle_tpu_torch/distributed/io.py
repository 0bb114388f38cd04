"""paddle.distributed.io (`paddle_tpu/distributed/io.py`; reference
`python/paddle/distributed/io.py`): persistables save/load for distributed
programs. A program's persistables are a Layer's (or an Engine's) state
dict; these wrappers route to the port's `save`/`load` with the
reference's signatures."""

from __future__ import annotations

import os

__all__ = ["save_persistables", "load_persistables",
           "load_inference_model_distributed", "is_persistable"]


def is_persistable(var):
    from paddle_tpu_torch.nn.layer.layers import Parameter

    return isinstance(var, Parameter) or getattr(var, "persistable", False)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """`main_program` is a Layer (or anything with `state_dict()`)."""
    from paddle_tpu_torch.framework.io import save

    if main_program is None or not hasattr(main_program, "state_dict"):
        raise ValueError(
            "save_persistables needs a Layer/Engine with state_dict()")
    os.makedirs(dirname, exist_ok=True)
    save(main_program.state_dict(),
         os.path.join(dirname, filename or "persistables.pdparams"))


def load_persistables(executor, dirname, main_program=None, filename=None):
    from paddle_tpu_torch.framework.io import load

    sd = load(os.path.join(dirname, filename or "persistables.pdparams"))
    if main_program is not None and hasattr(main_program, "set_state_dict"):
        main_program.set_state_dict(sd)
    return sd


def load_inference_model_distributed(dirname, executor, model_filename=None,
                                     params_filename=None):
    from paddle_tpu_torch import static

    prefix = os.path.join(dirname, (model_filename or "model").replace(
        ".pdmodel", ""))
    return static.load_inference_model(prefix, executor)
