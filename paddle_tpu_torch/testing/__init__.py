"""Test support that ships with the package because production modules
consult it: the deterministic fault-injection plane (:mod:`.faults`)."""

from . import faults  # noqa: F401

__all__ = ["faults"]
