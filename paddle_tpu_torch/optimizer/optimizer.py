"""Optimizers: ``Optimizer``, ``SGD``, ``Momentum``, ``Adam`` and ``AdamW``.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``.  Each optimizer has a
per-parameter rule ``_update(param, grad, state, lr) -> (new_param,
new_state)`` over torch tensors, JAX's rules term for term (Python-float
``beta_pow`` accumulators, AdamW's decoupled decay applied to the parameter
before the Adam update).  ``step`` runs under ``no_grad`` and writes the
results into the parameters' and the state's tensors in place, so a
parameter keeps its storage (and its version counter moves, which is how
``LlamaForCausalLM.generate_compiled`` sees the change).

``multi_precision=True`` keeps an f32 master copy of each bf16 / fp16
parameter: the rule runs on the master and f32 moments, and the parameter
takes the master rounded to its type.  As in JAX, AdamW does not call the
``fused_adamw`` kernel.  ``grad_clip`` (``nn.ClipGradBy*``) runs on the
``[(param, grad)]`` list before the rule, as in JAX.  ``state_dict()``
carries each parameter's state under ``"<name>.<key>"``, ``"@step"`` and,
with a scheduler, ``"LR_Scheduler"``; ``set_state_dict`` loads them (into
the state's own tensors where they exist, so a captured step reads the
loaded values).  ``learning_rate`` is a float or an
``optimizer.lr.LRScheduler``, whose ``scheduler()`` each step reads.

``incubate.jit_train_step`` runs the same rules inside a CUDA graph; there
the state's ``beta*_pow`` are device scalars (a Python float would freeze
at its capture-time value) and ``lr`` is a device scalar copied before
each replay.  The rules take either.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..tensor.tensor import Tensor, _to_torch, wrap_array
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is not None and isinstance(parameters, Tensor):
            raise TypeError("parameters must be a list of Tensors")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise NotImplementedError(
                "learning_rate must be a float or an optimizer.lr."
                "LRScheduler; other learning-rate objects are not ported "
                "(ROADMAP.md queue 1 item 10)")
        self._grad_clip = grad_clip
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        self._learning_rate = learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)
        self._multi_precision = multi_precision
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
        else:                                    # an L2Decay-like object
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
        self._states: Dict[int, Dict[str, Any]] = {}
        self._step_count = 0
        self._current_param: Optional[Tensor] = None

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler) -> None:
        self._learning_rate = scheduler

    def _params(self) -> List[Tensor]:
        if self._parameter_list is None:
            raise RuntimeError("optimizer created without parameters; pass "
                               "parameters=")
        return self._parameter_list

    def _needs_master(self, p: Tensor) -> bool:
        return self._multi_precision and p._data.dtype in (
            torch.float16, torch.bfloat16)

    def _init_state(self, p: Tensor) -> Dict[str, Any]:
        return {}

    def _get_state(self, p: Tensor) -> Dict[str, Any]:
        st = self._states.get(id(p))
        if st is None:
            st = self._init_state(p)
            if self._needs_master(p):
                st["master"] = p._data.detach().float()
            self._states[id(p)] = st
        return st

    def _moment(self, p: Tensor) -> torch.Tensor:
        dt = torch.float32 if self._needs_master(p) else p._data.dtype
        return torch.zeros_like(p._data, dtype=dt)

    def _update(self, param, grad, state, lr):
        raise NotImplementedError

    @torch.no_grad()
    def step(self) -> None:
        params_grads = [(p, wrap_array(p._data.grad)) for p in self._params()
                        if not p.stop_gradient and p._data.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        self._step_count += 1
        for p, g in params_grads:
            if g is None:
                continue
            g = g._data
            self._current_param = p
            state = self._get_state(p)
            master = state.get("master")
            param = p._data if master is None else master
            if master is not None:
                g = g.float()
            new_param, new_state = self._update(param, g, state, lr)
            for k, v in new_state.items():
                if isinstance(state.get(k), torch.Tensor):
                    state[k].copy_(v)
                else:
                    state[k] = v
            if master is not None:
                master.copy_(new_param)
            p._data.copy_(new_param)
        self._current_param = None

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._params():
            p.clear_grad()

    clear_gradients = clear_grad

    def state_dict(self) -> Dict[str, Any]:
        """Every parameter's state as ``"<param name>.<key>"`` (tensors as
        Tensors over the live state, numbers as they are) and ``"@step"``,
        the steps taken."""
        out: Dict[str, Any] = {}
        for p in self._params():
            for k, v in (self._states.get(id(p)) or {}).items():
                out[f"{p.name}.{k}"] = wrap_array(v) if isinstance(
                    v, torch.Tensor) else v
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        out["@step"] = self._step_count
        return out

    @torch.no_grad()
    def set_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a ``state_dict()`` (this package's or JAX's): a key whose
        state entry is already a tensor is copied into it (cast to its
        type, on its device), so a captured ``jit_train_step`` reads the
        loaded value; the rest replace the entry, tensors put on the
        parameter's device."""
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for p in self._params():
            prefix = p.name + "."
            st = self._get_state(p)
            for k, v in state.items():
                if not k.startswith(prefix):
                    continue
                key = k[len(prefix):]
                cur = st.get(key)
                if isinstance(v, Tensor):
                    v = v._data
                if isinstance(cur, torch.Tensor):
                    cur.copy_(_to_torch(v, None, None,
                                        device=cur.device).to(cur.dtype))
                elif isinstance(v, torch.Tensor):
                    st[key] = v.to(p._data.device)
                else:
                    st[key] = v

    set_dict = set_state_dict

    def _apply_decay(self, param, grad):
        """L2 regularisation folded into the gradient."""
        if self._weight_decay:
            return grad + self._weight_decay * param
        return grad


class SGD(Optimizer):
    def _update(self, param, grad, state, lr):
        grad = self._apply_decay(param, grad)
        return param - lr * grad, {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": self._moment(p)}

    def _update(self, param, grad, state, lr):
        grad = self._apply_decay(param, grad)
        v = self._momentum * state["velocity"] + grad
        if self._nesterov:
            return param - lr * (grad + self._momentum * v), {"velocity": v}
        return param - lr * v, {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = amsgrad

    def _init_state(self, p):
        st = {"moment1": self._moment(p), "moment2": self._moment(p),
              "beta1_pow": 1.0, "beta2_pow": 1.0}
        if self._amsgrad:
            st["moment2_max"] = self._moment(p)
        return st

    def _update(self, param, grad, state, lr):
        grad = self._apply_decay(param, grad)
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * state["moment1"] + (1 - b1) * grad
        v = b2 * state["moment2"] + (1 - b2) * grad * grad
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        new_state = {"moment1": m, "moment2": v, "beta1_pow": b1p,
                     "beta2_pow": b2p}
        if self._amsgrad:
            v = new_state["moment2_max"] = torch.maximum(
                state["moment2_max"], v)
        m_hat = m / (1 - b1p)
        v_hat = v / (1 - b2p)
        return param - lr * m_hat / (torch.sqrt(v_hat) + eps), new_state


class AdamW(Adam):
    """Decoupled weight decay: ``param * (1 - lr * coeff)`` before the
    Adam update; ``apply_decay_param_fun(name)`` False exempts a
    parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._coeff = float(getattr(weight_decay, "_coeff", weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update(self, param, grad, state, lr):
        p = self._current_param
        decay = self._coeff
        if p is not None and self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(p.name):
            decay = 0.0
        if p is not None and self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        param = param * (1.0 - lr * decay)
        return super()._update(param, grad, state, lr)
