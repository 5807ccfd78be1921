from .ernie_moe import (ErnieMoEConfig, ErnieMoEForCausalLM,
                        ernie_moe_base_config, ernie_moe_tiny_config)
from .generation import (GenerationMixin, cached_attention, decode_step,
                         decode_step_logprobs, sample_logits)
from .llama import (LlamaConfig, LlamaForCausalLM, llama_7b_config,
                    llama_tiny_config)

__all__ = ["ErnieMoEConfig", "ErnieMoEForCausalLM", "GenerationMixin",
           "LlamaConfig", "LlamaForCausalLM", "cached_attention",
           "decode_step", "decode_step_logprobs", "ernie_moe_base_config",
           "ernie_moe_tiny_config", "llama_7b_config", "llama_tiny_config",
           "sample_logits"]
