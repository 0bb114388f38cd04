"""paddle.Model high-level API (`paddle_tpu/hapi/model.py`; reference
`python/paddle/hapi/model.py:1472` fit).

Eager: the network's forward over port Tensors, torch's autograd, the
optimizer's step, each batch on the creation place (the card). `fit`
reports every step to the port's `TrainingMonitor` (wall time, samples/s,
the loss's NaN/inf action), as the JAX `fit` does. `save(training=False)`
writes the weights through `jit.save`, as the JAX package does. Losses and
predictions come back as numpy; a bf16 one as its float32 values.
"""

import time

import numpy as np

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.hapi.callbacks import config_callbacks
from paddle_tpu_torch.metric import Metric, _np as _host


class InputSpec:
    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = shape
        self.dtype = dtype
        self.name = name


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self._compiled_step = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        return self

    # -- single-step APIs ----------------------------------------------------
    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            raise RuntimeError("call prepare(loss=...) first")
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        lbls = labels if isinstance(labels, (list, tuple)) else [labels]
        if callable(self._loss) and not hasattr(self._loss, "forward"):
            return self._loss(*outs, *lbls)
        return self._loss(outs[0], lbls[0])

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        ins = [i if isinstance(i, Tensor) else Tensor(np.asarray(i)) for i in ins]
        outputs = self.network(*ins)
        loss = self._compute_loss(outputs, labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._eval_metrics(outputs, labels)
        return [_host(loss)], metrics if metrics else [_host(loss)]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        ins = [i if isinstance(i, Tensor) else Tensor(np.asarray(i)) for i in ins]
        outputs = self.network(*ins)
        loss = self._compute_loss(outputs, labels)
        metrics = self._eval_metrics(outputs, labels)
        return [_host(loss)], metrics

    def predict_batch(self, inputs):
        self.network.eval()
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        ins = [i if isinstance(i, Tensor) else Tensor(np.asarray(i)) for i in ins]
        outputs = self.network(*ins)
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        return [_host(o) for o in outs]

    def _eval_metrics(self, outputs, labels):
        res = []
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        lbls = labels if isinstance(labels, (list, tuple)) else [labels]
        for m in self._metrics:
            c = m.compute(outs[0], lbls[0])
            res.append(m.update(c))
        return res

    # -- fit loop ------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, nan_action="warn"):
        from paddle_tpu_torch.io import DataLoader, Dataset
        from paddle_tpu_torch.observability import TrainingMonitor

        # per-step telemetry (wall time, samples/sec, device memory
        # high-water, the NaN/inf loss action) into the shared registry;
        # train_batch already reads the loss back to host each step, so the
        # check adds no sync
        self._monitor = TrainingMonitor(source="hapi_fit",
                                        nan_action=nan_action)

        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                                      drop_last=drop_last, num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size, num_workers=num_workers)
        else:
            eval_loader = eval_data

        do_eval = eval_loader is not None
        steps = len(train_loader) if hasattr(train_loader, "__len__") else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs, steps=steps,
                                log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
                                verbose=verbose, metrics=self._metrics_name())

        self.stop_training = False
        cbks.on_begin("train")
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            logs = self._run_one_epoch(train_loader, cbks, "train", num_iters=num_iters)
            cbks.on_epoch_end(epoch, logs)

            if do_eval and epoch % eval_freq == 0:
                eval_steps = len(eval_loader) if hasattr(eval_loader, "__len__") else None
                cbks.on_begin("eval", {"steps": eval_steps, "metrics": self._metrics_name()})
                eval_logs = self._run_one_epoch(eval_loader, cbks, "eval")
                cbks.on_end("eval", eval_logs)
        cbks.on_end("train", logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2, num_workers=0,
                 callbacks=None, num_iters=None):
        from paddle_tpu_torch.io import DataLoader, Dataset

        if isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size, num_workers=num_workers)
        else:
            eval_loader = eval_data
        self._reset_metrics()
        cbks = config_callbacks(callbacks, model=self, log_freq=log_freq, verbose=verbose,
                                metrics=self._metrics_name())
        eval_steps = len(eval_loader) if hasattr(eval_loader, "__len__") else None
        cbks.on_begin("eval", {"steps": eval_steps, "metrics": self._metrics_name()})
        logs = self._run_one_epoch(eval_loader, cbks, "eval")
        cbks.on_end("eval", logs)
        result = {"loss": logs.get("loss")}
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), (list, tuple)) else [m.name()]
            vals = res if isinstance(res, (list, tuple)) else [res]
            for n, v in zip(names, vals):
                result[n] = v
        return result

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        from paddle_tpu_torch.io import DataLoader, Dataset

        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size, num_workers=num_workers)
        else:
            loader = test_data
        outputs = []
        n_in = len(self._inputs) if self._inputs else 1
        for data in loader:
            data = data if isinstance(data, (list, tuple)) else [data]
            outs = self.predict_batch(data[:n_in])
            outputs.append(outs)
        # transpose: list-of-batches-of-outputs -> list-of-outputs
        n_out = len(outputs[0])
        merged = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            merged = [np.vstack(m) for m in merged]
        return merged

    def _run_one_epoch(self, loader, cbks, mode, num_iters=None):
        logs = {}
        self._reset_metrics()
        # sample-weighted running mean, matching the reference ProgBarLogger's
        # averaged loss (reference python/paddle/hapi/model.py _run_one_epoch)
        loss_sum, seen = 0.0, 0
        for step, data in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            cbks.on_batch_begin(mode, step, logs)
            data = data if isinstance(data, (list, tuple)) else [data]
            n_in = len(self._inputs) if self._inputs else 1
            ins, lbls = data[:n_in], data[n_in:]
            monitor = getattr(self, "_monitor", None) if mode == "train" \
                else None
            if mode == "train":
                t0 = time.perf_counter() if monitor else None
                losses, metrics = self.train_batch(ins, lbls)
                step_wall = (time.perf_counter() - t0) if monitor else None
            elif mode == "eval":
                losses, metrics = self.eval_batch(ins, lbls)
            else:
                self.predict_batch(ins)
                losses, metrics = [np.zeros(1)], []
            batch0 = ins[0]
            bsz = batch0.shape[0] if hasattr(batch0, "shape") else 1
            batch_loss = float(np.asarray(losses[0]).reshape(-1)[0])
            if monitor is not None:
                monitor.record_step(step_wall, loss_value=batch_loss,
                                    samples=bsz)
            loss_sum += batch_loss * bsz
            seen += bsz
            logs["loss"] = loss_sum / max(seen, 1)
            logs["batch_loss"] = batch_loss
            logs["step"] = step
            logs["batch_size"] = bsz
            self._merge_metric_logs(logs)
            cbks.on_batch_end(mode, step, logs)
        return logs

    def _merge_metric_logs(self, logs):
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), (list, tuple)) else [m.name()]
            vals = res if isinstance(res, (list, tuple)) else [res]
            for n, v in zip(names, vals):
                logs[n] = v

    def _reset_metrics(self):
        for m in self._metrics:
            m.reset()

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names += n if isinstance(n, (list, tuple)) else [n]
        return names

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        from paddle_tpu_torch.framework.io import save as psave

        if training:
            psave(self.network.state_dict(), path + ".pdparams")
            if self._optimizer is not None:
                psave(self._optimizer.state_dict(), path + ".pdopt")
        else:
            from paddle_tpu_torch import jit

            jit.save(self.network, path)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from paddle_tpu_torch.framework.io import load as pload

        state = pload(path + ".pdparams")
        self.network.set_state_dict(state)
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.size for p in self.network.parameters())
        trainable = sum(p.size for p in self.network.parameters() if not p.stop_gradient)
        summary_str = (f"Total params: {n_params}\n"
                       f"Trainable params: {trainable}\n"
                       f"Non-trainable params: {n_params - trainable}\n")
        print(summary_str)
        return {"total_params": n_params, "trainable_params": trainable}
