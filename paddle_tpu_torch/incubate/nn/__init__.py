"""paddle.incubate.nn: the fused functional ops this slice ports."""

from . import functional  # noqa: F401
