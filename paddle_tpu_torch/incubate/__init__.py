"""paddle.incubate: the fused functional ops this slice ports
(``incubate.nn.functional``).  ``jit_train_step`` and the rest wait
(ROADMAP.md queue 1 item 9(c) and item 10)."""

from . import nn  # noqa: F401
