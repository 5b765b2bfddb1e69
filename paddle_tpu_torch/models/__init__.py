"""Model code of the port: LLaMA block math, paged decode, serving engine,
disaggregated prefill / decode, and LLaMA, BERT and GPT as Paddle Layers."""

from .bert import (BertConfig, BertForQuestionAnswering,  # noqa: F401
                   BertForSequenceClassification, BertModel,
                   bert_base_config)

from .disagg import (DecodeEngine, DisaggCoordinator,  # noqa: F401
                     HandoffRecord, PrefillEngine)
from .llama import (LlamaAttention, LlamaConfig,  # noqa: F401
                    LlamaDecoderLayer, LlamaForCausalLM, LlamaMLP,
                    LlamaModel)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTPretrainingCriterion, gpt3_1p3b_config)
