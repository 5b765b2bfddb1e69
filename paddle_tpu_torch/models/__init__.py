"""Model code of the port: LLaMA block math, paged decode, serving engine,
disaggregated prefill / decode."""

from .disagg import (DecodeEngine, DisaggCoordinator,  # noqa: F401
                     HandoffRecord, PrefillEngine)
