"""hapi callbacks — counterpart of ``paddle_tpu.hapi.callbacks``, the
whole module: ``Callback``, ``CallbackList``, ``ProgBarLogger``,
``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler``,
``ReduceLROnPlateau``, ``VisualDL`` (scalars appended to a JSONL file),
``TelemetryLogger`` and ``config_callbacks``, with the reference's
semantics: ``EarlyStopping`` picks ``max`` for a monitor whose name holds
``acc`` (else ``min``), falls back to ``eval_<monitor>``, and stops after
``patience`` epochs without a ``min_delta`` improvement;
``LRScheduler`` steps the optimizer's scheduler after every batch by
default (``by_step=True``); ``ModelCheckpoint`` writes
``{save_dir}/{epoch}`` and ``{save_dir}/final``. They run on the host,
between steps.
"""
from __future__ import annotations

import numbers
import time

import numpy as np

__all__ = [
    "Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
    "EarlyStopping", "LRScheduler", "ReduceLROnPlateau", "VisualDL",
    "TelemetryLogger", "config_callbacks",
]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin", lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end", lambda s, l=None: None)(step, logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def on_begin(self, mode, logs=None):
        for cb in self.callbacks:
            cb.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for cb in self.callbacks:
            cb.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for cb in self.callbacks:
            cb.on_batch_begin(mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for cb in self.callbacks:
            cb.on_batch_end(mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose >= 2 and step % self.log_freq == 0:
            msg = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in (logs or {}).items() if k != "step"
            )
            print(f"  step {step}: {msg}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            msg = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in (logs or {}).items() if k != "step"
            )
            print(f"  epoch {epoch + 1} done in {dt:.1f}s: {msg}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = None

    def _better(self, cur, best):
        if best is None:
            return True
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            cur = (logs or {}).get(f"eval_{self.monitor}")
        if cur is None:
            return
        if self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class ReduceLROnPlateau(Callback):
    """Shrink the LR when a monitored metric plateaus — parity with
    hapi/callbacks.py ReduceLROnPlateau in the reference."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, mode="min",
                 min_delta=1e-4, min_lr=0.0, verbose=1, cooldown=0):
        super().__init__()
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.min_lr = min_lr
        self.verbose = verbose
        self.cooldown = cooldown
        self._cooldown_counter = 0
        self._wait = 0
        self._best = None

    def _better(self, cur):
        if self._best is None:
            return True
        if self.mode == "min":
            return cur < self._best - self.min_delta
        return cur > self._best + self.min_delta

    def on_eval_end(self, logs=None):
        self._check(logs or {})

    def on_epoch_end(self, epoch, logs=None):
        self._check(logs or {})

    def _check(self, logs):
        # fit() reports eval metrics in the epoch logs as 'eval_<name>'
        # (same fallback EarlyStopping uses): prefer the eval metric over
        # the noisy last-train-batch value when both exist
        cur = logs.get(f"eval_{self.monitor}", logs.get(self.monitor))
        if cur is None:
            return
        try:
            cur = float(np.asarray(cur).ravel()[0])
        except (TypeError, ValueError, IndexError):
            return
        if self._cooldown_counter > 0:
            self._cooldown_counter -= 1
            self._wait = 0
        if self._better(cur):
            self._best = cur
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is None:
                return
            old = float(opt.get_lr())
            new = max(old * self.factor, self.min_lr)
            if new < old:
                opt.set_lr(new)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {old:.3e} -> {new:.3e}")
            self._cooldown_counter = self.cooldown
            self._wait = 0


class VisualDL(Callback):
    """Scalar logging callback: each train batch's and eval's scalars
    appended to ``{log_dir}/scalars.jsonl`` (the reference's JSON writer,
    in place of the VisualDL service)."""

    def __init__(self, log_dir="./vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def _write(self, tag, logs):
        import json as _json
        import os as _os

        _os.makedirs(self.log_dir, exist_ok=True)
        rec = {"step": self._step, "tag": tag}
        for k, v in (logs or {}).items():
            try:
                rec[k] = float(np.asarray(v).ravel()[0])
            except (TypeError, ValueError, IndexError):
                continue
        with open(_os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            f.write(_json.dumps(rec) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)


class TelemetryLogger(Callback):
    """Stream the runtime telemetry during ``Model.fit``: every
    ``log_freq`` train batches, one JSONL record (``Telemetry.to_jsonl``)
    with the batch's logs (loss, metrics), the batch's time
    (``hapi/step_ms``, ``hapi/steps_per_s``) and the global telemetry
    snapshot lands in ``<log_dir>/<filename>``. A record is also written
    at every eval end and at train end, so short runs always produce at
    least one row; ``sample_memory`` adds the device-memory gauges."""

    def __init__(self, log_dir="./telemetry", filename="scalars.jsonl",
                 log_freq=1, sample_memory=False):
        super().__init__()
        import os

        self.path = os.path.join(log_dir, filename)
        self.log_freq = max(int(log_freq), 1)
        self.sample_memory = sample_memory
        self._step = 0
        self._t0 = None

    def _telemetry(self):
        from ..profiler.telemetry import get_telemetry

        return get_telemetry()

    def _write(self, tag, logs=None):
        tel = self._telemetry()
        if self.sample_memory:
            from ..profiler.telemetry import sample_device_memory

            sample_device_memory(tel)
        extra = {}
        for k, v in (logs or {}).items():
            if k != "step":
                extra[str(k)] = v  # to_jsonl drops non-coercible values
        tel.to_jsonl(self.path, step=self._step, tag=tag, extra=extra)

    def on_train_begin(self, logs=None):
        self._write("train_begin", logs)

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        tel = self._telemetry()
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            tel.observe("hapi/step_ms", dt * 1e3)
            if dt > 0:
                # steps/s, not samples/s: fit's nominal batch_size param
                # is a lie when train_data arrives pre-batched (list or
                # DataLoader) — scaling by it would misreport throughput
                # by the real batch-size factor
                tel.gauge("hapi/steps_per_s", 1.0 / dt)
        if self._step % self.log_freq == 0:
            self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)

    def on_train_end(self, logs=None):
        self._write("train_end", logs)


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = callbacks if isinstance(callbacks, (list, tuple)) else (
        [callbacks] if callbacks else []
    )
    cbks = list(cbks)
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or ["loss"],
    })
    return cl
