"""paddle.optimizer: ``SGD``, ``Momentum``, ``Adam`` and ``AdamW``, and the
learning-rate schedulers of ``optimizer.lr`` (the other optimizers wait,
ROADMAP.md queue 1 item 10)."""

from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
