"""Model code of the port: LLaMA block math, paged decode, serving engine,
disaggregated prefill / decode, and LLaMA as Paddle Layers."""

from .disagg import (DecodeEngine, DisaggCoordinator,  # noqa: F401
                     HandoffRecord, PrefillEngine)
from .llama import (LlamaAttention, LlamaConfig,  # noqa: F401
                    LlamaDecoderLayer, LlamaForCausalLM, LlamaMLP,
                    LlamaModel)
