from .gpt import (GPT, GPTConfig, GPTForCausalLM, gpt2_medium, gpt2_small,
                  gpt2_tiny, gpt_decode_fns)

__all__ = ["GPT", "GPTConfig", "GPTForCausalLM", "gpt2_medium", "gpt2_small",
           "gpt2_tiny", "gpt_decode_fns"]
