"""A call captured into CUDA graphs: the port's counterpart of a program
that JAX compiles once per input signature.

:func:`capture` is the one capture routine of the port (the decode graphs
of ``models/graphed_step.py``, ``incubate.jit_train_step`` and the graphs
here): one run of ``warm`` on a warm-up stream (it builds the kernels and
fills the wrappers' plan caches), then ``body`` captured into a
``torch.cuda.CUDAGraph``, with the framework's generator registered when
the body draws.  It returns the kernel launches the wrappers counted while
capturing (:data:`COUNTERS`): every replay launches them again without
passing through the wrappers.

:class:`CapturedCall` holds ``fn(*inputs) -> [tensors]`` captured for one
input signature, over static input and output buffers (on the CPU there
is no graph: a replay runs ``fn`` eagerly on the same buffers).  A replay reads
and writes those fixed buffers, so concurrent callers must not share them:
:meth:`CapturedCall.run` holds the call's lock from the copy of the inputs
in, through the replay, to the copy of the outputs out.  :meth:`load`,
:meth:`replay` and :meth:`fetch` are the three steps, for a caller that
holds :attr:`lock` itself.

:class:`GradCall` adds a backward: a forward graph and a backward graph
(``torch.autograd.grad`` of the forward's outputs, captured), joined by an
``autograd.Function`` whose inputs are the call's tensors and the
parameters it reads, so ``.backward()`` through a replay fills the
parameters' gradients, as ``torch.cuda.make_graphed_callables`` does for a
module.  Its backward reads the activations its forward left, so a call
made while an earlier call's backward is pending raises.  A capture or a
replay that fails raises; nothing falls back.
"""

from __future__ import annotations

import sys
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..tensor.tensor import forbid_host_reads

__all__ = ["COUNTERS", "launch_counts", "capture", "CapturedCall",
           "GradCall"]

# the launch counters a captured call can bump: (name, module, attribute);
# a module not imported yet has launched nothing (and is not imported here:
# a process that serves an export loads no model code)
COUNTERS = (("paged_decode_attention", "paged_attention", "launches"),
            ("paged_decode_attention_q8", "paged_attention", "launches_q8"),
            ("int8_matmul", "int8_matmul", "launches"),
            ("int8_matmul_wave", "int8_matmul", "launches_wave"),
            ("rms_norm_fwd", "rms_norm", "launches"),
            ("rms_norm_bwd", "rms_norm", "launches_bwd"),
            ("swiglu_fwd", "swiglu", "launches"),
            ("swiglu_bwd", "swiglu", "launches_bwd"),
            ("rmsnorm_matmul", "rmsnorm_matmul", "launches"),
            ("fused_rope", "rope", "launches"),
            ("flash_attention_fwd", "flash_attention", "launches"),
            ("flash_attention_bwd_dq", "flash_attention", "launches_dq"),
            ("flash_attention_bwd_dkv", "flash_attention", "launches_dkv"),
            ("flash_attention_segmented", "flash_varlen", "launches"),
            ("segment_tile_ranges", "flash_varlen", "launches_ranges"),
            ("fused_adamw", "fused_adamw", "launches"))

# one warm-up stream per device: cuBLAS keeps a workspace for every stream
# it has run on (32 MiB on Hopper), so a fresh stream per capture would hold
# one more workspace after every capture
_warmup_streams: Dict[str, "torch.cuda.Stream"] = {}


def launch_counts() -> Dict[str, int]:
    out = {}
    for name, mod, attr in COUNTERS:
        m = sys.modules.get(f"paddle_tpu_torch.ops.{mod}")
        out[name] = getattr(m, attr) if m is not None else 0
    return out


def capture(device, warm: Callable, body: Callable, generator=None):
    """Capture ``body`` into a CUDA graph after one run of ``warm`` on the
    warm-up stream -> (graph, {kernel: launches recorded at capture}).  A
    failed capture raises, with the caller's stream put back."""
    cur = torch.cuda.current_stream(device)
    side = _warmup_streams.get(str(device))
    if side is None:
        side = _warmup_streams[str(device)] = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        warm()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = launch_counts()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
    except BaseException:
        # an aborted capture's context exit raises before it restores the
        # caller's stream: put it back, so that the next step (a quarantined
        # engine goes on serving) runs where it should
        torch.cuda.set_stream(cur)
        raise
    after = launch_counts()
    return graph, {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}


def _guarded_capture(device, warm, body, generator):
    """:func:`capture` with host reads forbidden (a read in a capture would
    sync the card), renewing the generator when it fails."""
    from ..framework import random as framework_random
    try:
        with forbid_host_reads("a CUDA graph capture"):
            return capture(device, warm, body, generator)
    except BaseException:
        if generator is not None:
            framework_random.renew_generator(device)
        raise


def _check_like(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]):
    if len(got) != len(want):
        raise ValueError(f"the captured call takes {len(want)} inputs, got "
                         f"{len(got)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            raise ValueError(
                f"input {i} is {g.dtype} {tuple(g.shape)}, the captured "
                f"call takes {w.dtype} {tuple(w.shape)}")


class CapturedCall:
    """``fn(*inputs) -> sequence of tensors``, captured into one CUDA graph
    over static input buffers of ``inputs``' shapes and types.  Tensors
    ``fn`` reads besides its inputs (parameters) are read at their
    addresses by every replay, so a caller keys the call on them.
    ``replays`` counts the replays and ``capture_launches`` the kernel
    launches each replay makes (none counted on the CPU)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 generator=None):
        self.device = inputs[0].device
        self.inputs = [torch.empty_like(x) for x in inputs]
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.outputs: List[torch.Tensor] = []
        self.replays = 0
        self.lock = threading.Lock()
        self._fn = fn
        self.graph, self.capture_launches = None, {}
        if self.device.type == "cuda":
            self.graph, self.capture_launches = _guarded_capture(
                self.device, lambda: fn(*self.inputs), self._body,
                generator)

    def _body(self):
        self.outputs = list(self._fn(*self.inputs))

    def load(self, inputs: Sequence[torch.Tensor]) -> None:
        """Copy ``inputs`` into the static input buffers."""
        _check_like(inputs, self.inputs)
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src, non_blocking=True)

    def replay(self) -> None:
        if self.graph is None:
            self._body()
        else:
            self.graph.replay()
        self.replays += 1

    def fetch(self) -> List[torch.Tensor]:
        """Copies of the static outputs (the next replay rewrites them)."""
        return [o.clone() for o in self.outputs]

    def run(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Load, replay and fetch under the call's lock."""
        with self.lock:
            self.load(inputs)
            self.replay()
            return self.fetch()


class _GradSlot:
    """One capture of a :class:`GradCall`'s function: its static inputs,
    the forward graph, and the backward graph that reads the activations
    the forward graph left in its pool.  ``gen`` counts the forward replays
    it has served; ``owner`` is a weak reference to the autograd node of
    the replay whose backward is still pending (None when the slot is
    free)."""

    def __init__(self, fn, inputs, params, generator):
        from ..framework import random as framework_random
        device = inputs[0].device if inputs else params[0].device
        self.inputs = [torch.empty_like(x).requires_grad_(x.requires_grad)
                       for x in inputs]
        with torch.no_grad():
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src.detach())
        targets = [t for t in self.inputs + list(params) if t.requires_grad]
        self.gen = 0
        self.owner = None
        box = {}

        def forward():
            outs = list(fn(*self.inputs))
            return outs, [o for o in outs if o.requires_grad]

        def backward(diff, grads):
            return torch.autograd.grad(diff, targets, grads,
                                       allow_unused=True)

        def warm():
            outs, diff = forward()
            if diff:
                backward(diff, [torch.ones_like(o) for o in diff])

        def fwd_body():
            box["outs"], box["diff"] = forward()

        with torch.enable_grad():
            self.fwd_graph, self.capture_launches = _guarded_capture(
                device, warm, fwd_body, generator)
        self.outputs = [o.detach() for o in box["outs"]]
        diff = box["diff"]
        self.diff_index = [i for i, o in enumerate(box["outs"])
                           if o.requires_grad]
        self.grad_outputs = [torch.zeros_like(o) for o in diff]
        grads: List[Optional[torch.Tensor]] = []
        self.bwd_graph = None
        if diff:
            self.bwd_graph = torch.cuda.CUDAGraph()
            cur = torch.cuda.current_stream(device)
            try:
                with forbid_host_reads("a CUDA graph capture"), \
                        torch.cuda.graph(self.bwd_graph,
                                         capture_error_mode="thread_local"):
                    grads = list(backward(diff, self.grad_outputs))
            except BaseException:
                torch.cuda.set_stream(cur)
                if generator is not None:
                    framework_random.renew_generator(device)
                raise
        grad_of = dict(zip(map(id, targets), grads))
        self.grad_slots = [grad_of.get(id(t)) for t in self.inputs +
                           list(params)]

    def free(self) -> bool:
        return self.owner is None or self.owner() is None


class _Busy:
    """The owner of a slot between its choice and its forward replay."""

    def __call__(self):
        return self


class GradCall:
    """``fn(*inputs) -> sequence of tensors`` with its backward, captured
    into two CUDA graphs: the forward over static inputs (each requiring
    grad as the example does), and ``torch.autograd.grad`` of the outputs
    that require grad with respect to the inputs and ``params`` (leaf
    tensors ``fn`` reads) that require it.  :meth:`run` returns the
    outputs joined to autograd: a backward through them replays the
    backward graph and hands the gradients to the inputs and the
    parameters.

    The backward graph reads the activations the forward replay left, so
    the capture (a :class:`_GradSlot`) serves one replay at a time, from
    its forward until its backward has run or its outputs are gone.  A call
    made while that backward is pending (two calls summed into one loss, a
    cell stepped over time) raises: a second capture made while the first
    call's autograd graph is alive fails on the card
    (``cudaErrorStreamCaptureImplicit``).  A backward whose capture a later
    forward has since taken (a second backward under ``retain_graph``)
    raises too; neither reads another call's activations."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 params: Sequence[torch.Tensor], generator=None):
        self.device = inputs[0].device if inputs else params[0].device
        self.params = list(params)
        self._capture = lambda xs: _GradSlot(fn, xs, self.params, generator)
        self._pool_lock = threading.Lock()
        self.replays = 0
        self.slots: List[_GradSlot] = [self._capture(inputs)]
        self.capture_launches = self.slots[0].capture_launches
        self.bwd_graph = self.slots[0].bwd_graph

        class _Replay(torch.autograd.Function):
            @staticmethod
            def forward(ctx, slot, *tensors):
                ctx.slot, ctx.gen = slot, slot.gen
                try:
                    with torch.no_grad():
                        _check_like(tensors[:len(slot.inputs)], slot.inputs)
                        for dst, src in zip(slot.inputs, tensors):
                            dst.copy_(src, non_blocking=True)
                    slot.fwd_graph.replay()
                    outs = [o.clone() for o in slot.outputs]
                finally:
                    slot.owner = (weakref.ref(ctx) if slot.bwd_graph
                                  is not None else None)
                ctx.mark_non_differentiable(*[
                    o for i, o in enumerate(outs)
                    if i not in slot.diff_index])
                return tuple(outs)

            @staticmethod
            @torch.autograd.function.once_differentiable
            def backward(ctx, *grads):
                slot = ctx.slot
                if slot.gen != ctx.gen:
                    raise RuntimeError(
                        "to_static: this backward's forward graph has since "
                        "been replayed for a later call, whose activations "
                        "replaced its own; run the backward before the "
                        "captured call runs again, or call the function "
                        "once more")
                for s, i in zip(slot.grad_outputs, slot.diff_index):
                    if grads[i] is None:
                        s.zero_()
                    else:
                        s.copy_(grads[i])
                slot.bwd_graph.replay()
                out = tuple(None if g is None else g.clone()
                            for g in slot.grad_slots)
                slot.owner = None
                return (None,) + out

        self._fn = _Replay

    def _acquire(self, inputs) -> _GradSlot:
        """The capture, marked busy; it raises while a backward through an
        earlier replay is pending."""
        with self._pool_lock:
            slot = next((s for s in self.slots if s.free()), None)
            if slot is None:
                raise RuntimeError(
                    "to_static: this signature's captured call was replayed "
                    "with grad and its backward has not run yet; the "
                    "backward graph reads that replay's activations, so "
                    "run the backward (or drop the outputs) before calling "
                    "it again, or call it under paddle.no_grad()")
            slot.owner = _Busy()
            slot.gen += 1
            self.replays += 1
            return slot

    def run(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        slot = self._acquire(inputs)
        try:
            return list(self._fn.apply(slot, *inputs, *self.params))
        except BaseException:
            slot.owner = None
            raise
