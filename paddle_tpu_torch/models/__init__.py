"""Models of the port."""
from .gpt import (GPTConfig, GPTForCausalLM, gpt2_124m_config,
                  gpt3_1p3b_config, gpt3_6p7b_config, gpt_test_config)

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt_test_config",
           "gpt2_124m_config", "gpt3_1p3b_config", "gpt3_6p7b_config"]
