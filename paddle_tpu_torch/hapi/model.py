"""hapi ``Model`` — counterpart of ``paddle_tpu.hapi.model``: Keras-style
``prepare``, ``fit``, ``evaluate``, ``predict``, ``save`` and ``load``
over a network.

Training steps go through ``jit.train_step.TrainStep`` on the device of
the network's parameters; the network is built there (``device=``), and a
dataset given to ``fit``/``evaluate``/``predict`` is batched by a
``DataLoader`` built for that device. The reference's semantics hold:

- ``train_batch`` returns the loss as a host float (one sync a step, the
  API's contract); with metrics, they come from a second, eval-mode
  forward after the step, as in the reference;
- ``_split_batch`` takes a batch's last element as the label;
- ``fit`` steps the optimizer's ``LRScheduler`` once at every epoch end,
  whatever the callbacks do; ``num_iters`` counts steps over all epochs
  and ends an epoch's loop once reached (so each later epoch takes one
  step, as in the reference);
  ``save_dir`` gets ``{save_dir}/{epoch}`` every ``save_freq`` epochs;
  ``prefetch_depth`` > 0 wraps each epoch's loader in an
  ``io.DevicePrefetcher`` that is closed at the end of the epoch;
- between steps ``fit`` checks ``resilience.preemption_requested()``:
  when set it writes ``{save_dir}/preempt.pdparams`` / ``.pdopt`` and
  exits with ``EXIT_PREEMPTED``; a relaunch with the same ``save_dir``
  loads those files once and deletes them;
- ``save`` writes ``.pdparams`` (the network's state dict), plus
  ``.pdopt`` (the optimizer's) when ``training``; ``load`` copies them
  into the live parameters and optimizer state
  (``nn.set_state_dict``, ``Optimizer.set_state_dict``) and rebuilds the
  step's f32 masters from the loaded weights (``refresh_from_layer``).

``fit`` opens the reference's spans: ``fit`` → ``epoch`` → ``step`` →
{``h2d``, ``compute`` (the train step), ``metric`` (the metrics'
forward), ``callback``}, and ``checkpoint``.

``prepare(amp_configs=...)`` is taken and ignored by the reference; the
port raises on any value but None (mixed precision here is
``amp.auto_cast`` around the step, or the dygraph loop with
``amp.GradScaler``).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.utils.data as tud
from torch import nn

from ..core.place import resolve_device
from ..nn.layer_base import set_state_dict
from ..profiler import spans as _spans
from ..resilience import preemption as _preempt
from . import callbacks as callbacks_mod

__all__ = ["Model"]


class Model:
    def __init__(self, network: nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self.stop_training = False
        first = next(network.parameters(), None)
        self._device = first.device if first is not None \
            else resolve_device(None)

    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            raise NotImplementedError(
                "prepare(amp_configs=...): the reference takes and ignores "
                "it; use amp.auto_cast around the step, or amp.GradScaler")
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = (metrics if isinstance(metrics, (list, tuple))
                             else [metrics])
        if optimizer is not None:
            # the optimizer's state dict is keyed by these names
            optimizer.name_parameters(self.network.named_parameters())
        self._train_step = None  # built at the first train_batch
        return self

    def _ensure_train_step(self):
        if self._train_step is None and self._optimizer is not None \
                and self._loss is not None:
            from ..jit.train_step import TrainStep

            self._train_step = TrainStep(self.network, self._loss,
                                         self._optimizer,
                                         device=self._device)
        return self._train_step

    def _to_device(self, tensors):
        return [t.to(self._device, non_blocking=True)
                if isinstance(t, torch.Tensor) else t for t in tensors]

    # ------------------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        inputs = _as_list(inputs)
        labels = labels if labels is None else _as_list(labels)
        step = self._ensure_train_step()
        loss = step(tuple(inputs), tuple(labels or ()))
        metrics_out = []
        if self._metrics:
            with _spans.span("metric", cat="metric"):
                step.sync_to_layer()
                with torch.no_grad():
                    self.network.eval()
                    outs = self.network(*self._to_device(inputs))
                    self.network.train()
                for m in self._metrics:
                    res = (m.update(m.compute(outs, *self._to_device(
                        labels))) if labels else None)
                    metrics_out.append(res)
                step.refresh_from_layer()
        # the host float per call is train_batch's contract
        return (float(loss), metrics_out) if metrics_out else float(loss)

    def eval_batch(self, inputs, labels=None):
        inputs = self._to_device(_as_list(inputs))
        labels = labels if labels is None else self._to_device(
            _as_list(labels))
        self.network.eval()
        with torch.no_grad():
            outs = self.network(*inputs)
            loss = (self._loss(outs, *labels) if self._loss and labels
                    else None)
        self.network.train()
        metrics_out = [m.update(m.compute(outs, *labels))
                       for m in self._metrics]
        return (float(loss) if loss is not None else None), metrics_out

    def predict_batch(self, inputs):
        inputs = self._to_device(_as_list(inputs))
        self.network.eval()
        with torch.no_grad():
            outs = self.network(*inputs)
        self.network.train()
        return outs

    def _loader(self, data, batch_size, num_workers, **kw):
        if not isinstance(data, tud.Dataset):
            return data  # a DataLoader or another iterable of batches
        from ..io import DataLoader

        return DataLoader(data, batch_size=batch_size,
                          num_workers=num_workers, places=self._device, **kw)

    # ------------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            prefetch_depth=0, prefetch_buckets=None):
        """Train for ``epochs`` over ``train_data`` (a dataset or an
        iterable of batches); see the module's docstring. The ``fit`` span
        closes on every exit path."""
        with _spans.span("fit", cat="fit"):
            return self._fit_impl(
                train_data, eval_data, batch_size, epochs, eval_freq,
                log_freq, save_dir, save_freq, verbose, drop_last, shuffle,
                num_workers, callbacks, num_iters, prefetch_depth,
                prefetch_buckets)

    def _fit_impl(self, train_data, eval_data, batch_size, epochs,
                  eval_freq, log_freq, save_dir, save_freq, verbose,
                  drop_last, shuffle, num_workers, callbacks, num_iters,
                  prefetch_depth, prefetch_buckets):
        loader = self._loader(train_data, batch_size, num_workers,
                              shuffle=shuffle, drop_last=drop_last)
        eval_loader = None if eval_data is None else self._loader(
            eval_data, batch_size, num_workers)
        if save_dir and os.path.exists(f"{save_dir}/preempt.pdparams"):
            # a relaunch after a preemption exit: continue from the
            # emergency checkpoint, and consume it once, so that it cannot
            # override a later, unrelated run in the same save_dir
            self.load(f"{save_dir}/preempt")
            for suffix in (".pdparams", ".pdopt"):
                try:
                    os.remove(f"{save_dir}/preempt{suffix}")
                except FileNotFoundError:
                    pass
        cbks = callbacks_mod.config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            verbose=verbose, log_freq=log_freq, save_dir=save_dir,
            save_freq=save_freq,
            metrics=["loss"] + [n for m in self._metrics
                                for n in _as_list(m.name())])
        cbks.on_begin("train")
        it_count = 0
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            # exited after the epoch-end checkpoint below; an exception
            # skips the exit, and the span stack heals itself
            epoch_span = _spans.span("epoch", cat="epoch").__enter__()
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            data_iter = loader
            if prefetch_depth:
                from ..io.prefetch import DevicePrefetcher

                # a one-shot pipeline per epoch, closed below
                data_iter = DevicePrefetcher(loader, depth=prefetch_depth,
                                             buckets=prefetch_buckets,
                                             device=self._device)
            try:
                for step_i, batch in enumerate(data_iter):
                    if _preempt.preemption_requested():
                        _preempt.exit_for_relaunch(
                            (lambda: self.save(f"{save_dir}/preempt"))
                            if save_dir else None)
                    inputs, labels = _split_batch(batch)
                    with _spans.span("step", cat="step", step=it_count):
                        cbks.on_batch_begin("train", step_i, logs)
                        out = self.train_batch(inputs, labels)
                        loss_v, _ = out if isinstance(out, tuple) \
                            else (out, [])
                        logs = {"loss": loss_v, "step": step_i}
                        for m in self._metrics:
                            for n, v in zip(_as_list(m.name()),
                                            _as_list(m.accumulate())):
                                logs[n] = v
                        with _spans.span("callback", cat="callback"):
                            cbks.on_batch_end("train", step_i, logs)
                    it_count += 1
                    if num_iters is not None and it_count >= num_iters:
                        break
            finally:
                if prefetch_depth:
                    data_iter.close()
            if self._train_step is not None:
                self._train_step.sync_to_layer()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            lr = getattr(self._optimizer, "_learning_rate", None)
            if hasattr(lr, "step"):
                lr.step()
            if save_dir and (epoch + 1) % save_freq == 0:
                with _spans.span("checkpoint", cat="checkpoint"):
                    self.save(f"{save_dir}/{epoch}")
            epoch_span.__exit__(None, None, None)
        cbks.on_end("train", logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        if self._train_step is not None:
            self._train_step.sync_to_layer()
        loader = self._loader(eval_data, batch_size, num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for i, batch in enumerate(loader):
            inputs, labels = _split_batch(batch)
            loss_v, _ = self.eval_batch(inputs, labels)
            if loss_v is not None:
                losses.append(loss_v)
            if num_iters is not None and i + 1 >= num_iters:
                break
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            for n, v in zip(_as_list(m.name()), _as_list(m.accumulate())):
                logs[n] = v
        if verbose:
            print("Eval:", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """Each batch's outputs (device tensors), or with
        ``stack_outputs`` one numpy array per output over every batch. A
        labelled batch's last element is dropped, as in ``fit``."""
        if self._train_step is not None:
            self._train_step.sync_to_layer()
        loader = self._loader(test_data, batch_size, num_workers)
        outputs = []
        for batch in loader:
            inputs, _ = _split_batch(batch)
            outputs.append(self.predict_batch(inputs))
        if stack_outputs and outputs:
            if isinstance(outputs[0], torch.Tensor):
                return [np.concatenate([o.cpu().numpy() for o in outputs])]
            return [np.concatenate([o[i].cpu().numpy() for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # ------------------------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save

        if self._train_step is not None:
            self._train_step.sync_to_layer()
        save(self.network.state_dict(keep_vars=True), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load ``path.pdparams`` (or ``path`` itself when it ends so)
        into the network in place, ``path.pdopt`` into the optimizer when
        it exists (unless ``reset_optimizer``), and rebuild the step's f32
        masters from what was loaded."""
        from ..framework.io import load

        if self._train_step is not None:
            # master mode: the layer holds the f32 masters before the copy
            self._train_step.sync_to_layer()
        params = path if path.endswith(".pdparams") else path + ".pdparams"
        set_state_dict(self.network, load(params))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            self._optimizer.set_state_dict(load(opt_path))
        if self._train_step is not None:
            self._train_step.refresh_from_layer()

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as summary_fn

        return summary_fn(self.network, input_size, dtypes=dtype)


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _split_batch(batch, has_labels=True):
    if isinstance(batch, (list, tuple)):
        if len(batch) >= 2 and has_labels:
            *ins, lab = batch
            return list(ins), [lab]
        return list(batch), []
    return [batch], []
