"""``paddle.Model``, the high-level API, and ``summary``.

Counterpart of ``paddle_tpu/hapi/model.py``: ``prepare``, ``fit``,
``evaluate``, ``predict``, ``train_batch`` / ``eval_batch`` /
``predict_batch``, ``save`` / ``load`` and ``summary``, with JAX's loops,
callback order and logs.

``fit`` trains through ``incubate.jit_train_step(..., return_outputs=True)``
when the prepared configuration qualifies by JAX's conditions
(``_compiled_step``: a loss and an optimizer, no ``GradScaler``, AMP O0 or
bf16 O1, a clip the step takes).  On the card that is one CUDA graph per
input signature, captured at its first batch and replayed after; on the
CPU the same step runs eagerly.  An ineligible configuration warns once
and runs the eager loop, as in JAX, and so does gradient accumulation
(``update=False`` batches: the step cannot take grads accumulated
eagerly).  ``evaluate`` and ``predict`` run ``incubate.jit_eval_step``.

One departure from JAX (ROADMAP.md queue 3): JAX's ``train_batch`` and
``_eval_outputs`` catch an exception from the compiled step or forward
and drop to the eager loop with a warning.  Here eligibility is decided
before anything launches, from the configuration alone; a capture or a
replay that fails raises, so a fault on the card is never hidden behind a
slower loop.

``save(path)`` writes ``path.pdparams`` and ``path.pdopt`` with
``paddle.save`` (JAX's format); ``save(path, training=False)`` writes the
inference bundle with ``jit.save``.  ``prepare(jit=True)`` wraps the
network with ``jit.to_static``, as JAX does; ``fit``, ``evaluate`` and
``predict`` still build their steps over the Layer it wraps, so no graph
is captured inside another.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import List

import numpy as np
import torch

from ..io import DataLoader, Dataset
from ..metric import Metric
from ..nn.layer.layers import Layer
from ..tensor.tensor import Tensor, to_tensor
from .callbacks import config_callbacks

__all__ = ["Model", "summary"]


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _batch_len(ins, default):
    """The leading size of the first input, else ``default``."""
    first = ins[0] if isinstance(ins, (list, tuple)) and ins else ins
    shape = getattr(first, "shape", None)
    if shape is not None and len(shape) > 0:
        return int(shape[0])
    return default


def _as_tensors(xs):
    return [x if isinstance(x, Tensor) else to_tensor(x)
            for x in _to_list(xs)]


class _DynamicGraphAdapter:
    def __init__(self, model: "Model"):
        self.model = model
        self._jit_step = None
        self._jit_unavailable = False
        self._jit_eval = None
        self._loss_arity = None

    def reset_jit_eligibility(self) -> None:
        """At the top of each ``fit`` / ``evaluate`` / ``predict``: an
        earlier accumulation run does not pin the Model to the eager
        loop."""
        self._jit_unavailable = False

    def _eval_outputs(self, inputs):
        if self._jit_eval is None:
            from ..incubate.jit_train import jit_eval_step
            self._jit_eval = jit_eval_step(self.model.network)
        return _to_list(self._jit_eval(tuple(inputs)))

    def _compiled_step(self):
        """The one-program train step, built once when the configuration
        qualifies (JAX's conditions); None, with one warning, when it
        does not."""
        if self._jit_unavailable:
            return None
        if self._jit_step is not None:
            return self._jit_step
        m = self.model
        try:
            if m._loss is None or m._optimizer is None or \
                    m._scaler is not None or \
                    (m._amp_level == "O1" and
                     m._amp_dtype != "bfloat16") or \
                    m._amp_level not in ("O0", "O1"):
                raise NotImplementedError("configuration not eligible")
            from ..incubate.jit_train import jit_train_step

            def loss_fn(out, ys):
                outs = _to_list(out)
                ys = list(ys) if isinstance(ys, tuple) else [ys]
                losses = _to_list(m._loss(*(outs + ys)))
                total = losses[0]
                for loss in losses[1:]:
                    total = total + loss
                return total

            self._jit_step = jit_train_step(
                m.network, loss_fn, m._optimizer, amp_level=m._amp_level,
                amp_dtype=m._amp_dtype, return_outputs=True)
        except NotImplementedError as e:
            self._jit_unavailable = True
            warnings.warn(
                f"Model.fit: whole-program compiled training is not "
                f"available for this configuration ({e}); running the "
                f"eager loop", stacklevel=3)
            return None
        return self._jit_step

    def _metric_logs(self, loss_vals, outputs, labels):
        metrics = []
        for metric in self.model._metrics:
            res = metric.compute(*(outputs + labels))
            metrics.append(metric.update(*_to_list(res)))
        if metrics:
            return (loss_vals, metrics[0] if len(metrics) == 1 else metrics)
        return loss_vals

    def train_batch(self, inputs, labels=None, update=True):
        m = self.model
        net = m.network
        net.train()
        inputs, labels = _as_tensors(inputs), _as_tensors(labels)
        if not update:
            if not self._jit_unavailable:
                warnings.warn(
                    "Model.fit: gradient accumulation runs the eager "
                    "loop (the compiled step cannot consume eager-"
                    "accumulated grads)", stacklevel=2)
            self._jit_unavailable = True
        step = self._compiled_step() if update else None
        if step is not None:
            loss, outs = step(tuple(inputs), tuple(labels))
            outputs = _to_list(outs)
            # the step optimises the sum of a multi-part loss; the logs
            # keep the parts, recomputed from the outputs
            if self._loss_arity is None:
                with torch.no_grad():
                    self._loss_arity = len(_to_list(
                        m._loss(*(outputs + labels))))
            if self._loss_arity > 1:
                with torch.no_grad():
                    parts = _to_list(m._loss(*(outputs + labels)))
                loss_vals = [float(np.asarray(p.numpy()).ravel()[0])
                             for p in parts]
            else:
                loss_vals = [float(loss)]
            return self._metric_logs(loss_vals, outputs, labels)
        if m._amp_level != "O0":
            from .. import amp as amp_mod
            ctx = amp_mod.auto_cast(level=m._amp_level, dtype=m._amp_dtype)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            outputs = _to_list(net(*inputs))
            losses = m._loss(*(outputs + labels)) if m._loss else None
        losses_list = _to_list(losses)
        total = losses_list[0]
        for loss in losses_list[1:]:
            total = total + loss
        if m._scaler is not None:
            m._scaler.scale(total).backward()
            if update:
                m._scaler.step(m._optimizer)
                m._scaler.update()
                m._optimizer.clear_grad()
        else:
            total.backward()
            if update:
                m._optimizer.step()
                m._optimizer.clear_grad()
        loss_vals = [float(np.asarray(v.numpy()).ravel()[0])
                     for v in losses_list]
        return self._metric_logs(loss_vals, outputs, labels)

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        m = self.model
        m.network.eval()
        inputs, labels = _as_tensors(inputs), _as_tensors(labels)
        outputs = self._eval_outputs(inputs)
        loss_vals = None
        if m._loss:
            losses = _to_list(m._loss(*(outputs + labels)))
            loss_vals = [float(np.asarray(v.numpy()).ravel()[0])
                         for v in losses]
        out = self._metric_logs(loss_vals, outputs, labels)
        return out

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.model.network.eval()
        outputs = self._eval_outputs(_as_tensors(inputs))
        return [o.numpy() for o in outputs]


class Model:
    """Mirror of ``paddle.Model``: a network with its optimizer, loss and
    metrics, and the loops over them."""

    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics: List[Metric] = []
        self._scaler = None
        self._amp_level = "O0"
        self._amp_dtype = "bfloat16"
        self.stop_training = False
        self._adapter = _DynamicGraphAdapter(self)

    # -- setup --------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=False):
        self._optimizer = optimizer
        if loss is not None and not (isinstance(loss, Layer) or
                                     callable(loss)):
            raise TypeError("loss must be a Layer or callable")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m} is not a paddle Metric")
        if amp_configs is not None:
            if isinstance(amp_configs, str):
                self._amp_level = amp_configs
            else:
                self._amp_level = amp_configs.get("level", "O1")
                self._amp_dtype = amp_configs.get("dtype", "bfloat16")
            if self._amp_dtype == "float16" and self._amp_level != "O0":
                from ..amp import GradScaler
                self._scaler = GradScaler()
        if jit:
            from ..jit import to_static
            self.network = to_static(self.network)

    # -- batch-level --------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        return self._adapter.train_batch(inputs, labels, update)

    def eval_batch(self, inputs, labels=None):
        return self._adapter.eval_batch(inputs, labels)

    def predict_batch(self, inputs):
        return self._adapter.predict_batch(inputs)

    # -- loops --------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        self._adapter.reset_jit_eligibility()
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data
        try:
            steps = len(train_loader)
        except Exception:  # noqa: BLE001
            steps = None
        cbks = config_callbacks(callbacks, model=self,
                                batch_size=batch_size, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                verbose=verbose, save_freq=save_freq,
                                save_dir=save_dir,
                                metrics=self._metrics_name())
        self.stop_training = False
        cbks.on_train_begin()
        it_count = 0
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            accum = 0
            samples, t0 = 0, time.perf_counter()
            for step, data in enumerate(train_loader):
                cbks.on_train_batch_begin(step)
                ins, labels = self._split_data(data)
                accum += 1
                update = accum % accumulate_grad_batches == 0
                out = self.train_batch(ins, labels, update=update)
                logs = self._make_logs(out)
                n_samples = _batch_len(ins, batch_size)
                samples += n_samples
                logs["batch_size"] = n_samples
                logs["ips"] = samples / max(time.perf_counter() - t0, 1e-9)
                cbks.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    self.stop_training = True
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self._run_eval(eval_loader, cbks)
            if self.stop_training:
                break
        cbks.on_train_end(logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        self._adapter.reset_jit_eligibility()
        if isinstance(eval_data, Dataset):
            loader = DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = eval_data
        cbks = config_callbacks(callbacks, model=self, verbose=verbose,
                                metrics=self._metrics_name())
        return self._run_eval(loader, cbks, num_iters=num_iters)

    def _run_eval(self, loader, cbks, num_iters=None):
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        logs = {}
        for step, data in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, labels = self._split_data(data)
            logs = self._make_logs(self.eval_batch(ins, labels))
            cbks.on_eval_batch_end(step, logs)
            if num_iters is not None and step + 1 >= num_iters:
                break
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            for n, v in zip(names, vals):
                logs[n] = v
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        self._adapter.reset_jit_eligibility()
        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = test_data
        cbks = config_callbacks(callbacks, model=self, verbose=verbose)
        cbks.on_predict_begin()
        outputs = []
        for step, data in enumerate(loader):
            cbks.on_predict_batch_begin(step)
            ins, _ = self._split_data(data, has_labels=False)
            outputs.append(self.predict_batch(ins))
            cbks.on_predict_batch_end(step)
        cbks.on_predict_end()
        n_out = len(outputs[0]) if outputs else 0
        result = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            result = [np.concatenate(r, axis=0) for r in result]
        return result

    # -- save / load ----------------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save as fsave
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if training:
            fsave(self.network.state_dict(), path + ".pdparams")
            if self._optimizer is not None:
                fsave(self._optimizer.state_dict(), path + ".pdopt")
        else:
            from ..jit import save as jsave
            jsave(self.network, path)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as fload
        self.network.set_state_dict(fload(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(fload(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtypes=dtype)

    # -- helpers ------------------------------------------------------------
    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _split_data(self, data, has_labels=True):
        if isinstance(data, (list, tuple)):
            if not has_labels:
                # a labelled dataset's items still carry the label field
                if len(data) >= 2 and self._loss is not None:
                    return list(data[:-1]), None
                return list(data), None
            if len(data) == 2:
                return [data[0]], [data[1]]
            if len(data) > 2:
                return list(data[:-1]), [data[-1]]
            return list(data), None
        return [data], None

    def _make_logs(self, out, prefix=""):
        logs = {}
        if out is None:
            return logs
        if isinstance(out, tuple) and len(out) == 2 and isinstance(
                out[0], list):
            losses, met = out
            logs[prefix + "loss"] = losses
            mets = met if isinstance(met, list) else [met]
            for n, v in zip(self._metrics_name()[1:], mets):
                logs[prefix + n] = v
        else:
            logs[prefix + "loss"] = out
        return logs


def summary(net: Layer, input_size=None, dtypes=None, input=None):
    """Print a table of the sublayers and their parameter counts ->
    ``{"total_params", "trainable_params"}``."""
    rows = []
    for name, layer in net.named_sublayers(include_self=True):
        n_params = sum(p.size for p in layer._parameters.values()
                       if p is not None)
        rows.append((name or type(net).__name__, type(layer).__name__,
                     n_params))
    total_params = sum(p.size for p in net.parameters())
    trainable = sum(p.size for p in net.parameters() if not p.stop_gradient)
    line = "-" * 72
    print(line)
    print(f"{'Layer (type)':<40}{'Params':>12}")
    print(line)
    for name, tname, n in rows:
        print(f"{name + ' (' + tname + ')':<40}{n:>12,}")
    print(line)
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total_params - trainable:,}")
    print(line)
    return {"total_params": total_params, "trainable_params": trainable}
