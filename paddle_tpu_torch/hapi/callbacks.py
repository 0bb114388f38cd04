"""hapi callbacks (reference: `python/paddle/hapi/callbacks.py`)."""

import time

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda logs=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda logs=None: None)(logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin", lambda step, logs=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end", lambda step, logs=None: None)(step, logs)

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def append(self, cbk):
        self.callbacks.append(cbk)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            c.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            c.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_begin(mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_end(mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self.epochs = None
        self.epoch = 0

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and step % self.log_freq == 0:
            items = [f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                     for k, v in (logs or {}).items() if k not in ("step", "batch_size")]
            steps = self.params.get("steps")
            print(f"step {step + 1}/{steps if steps else '?'} - " + " - ".join(items))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self._start
            items = [f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                     for k, v in (logs or {}).items() if k not in ("step", "batch_size")]
            print(f"Epoch {epoch + 1} done ({dur:.1f}s) - " + " - ".join(items))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode

    def on_eval_end(self, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor)
        if current is None:
            return
        current = float(np.asarray(current).reshape(-1)[0])
        improved = (self.best is None or
                    (self.mode == "min" and current < self.best - self.min_delta) or
                    (self.mode == "max" and current > self.best + self.min_delta))
        if improved:
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from paddle_tpu_torch.optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        if opt and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None, metrics=None,
                     mode="train"):
    cbks = callbacks if isinstance(callbacks, (list, tuple)) else ([callbacks] if callbacks else [])
    cbks = list(cbks)
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    cbk_list.set_params({"batch_size": batch_size, "epochs": epochs, "steps": steps,
                         "verbose": verbose, "metrics": metrics or ["loss"]})
    return cbk_list
