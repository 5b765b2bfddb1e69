"""paddle.optimizer: ``SGD``, ``Momentum``, ``Adam`` and ``AdamW``
(``optimizer/lr.py`` and the other optimizers wait, ROADMAP.md queue 1
item 10)."""

from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
