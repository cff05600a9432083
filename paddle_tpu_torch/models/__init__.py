"""Models of the port."""
from .bert import (BertConfig, BertEmbeddings, BertForSequenceClassification,
                   BertModel, BertPooler, bert_base_config)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, gpt2_124m_config,
                  gpt3_1p3b_config, gpt3_6p7b_config, gpt_test_config)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion",
           "gpt_test_config", "gpt2_124m_config", "gpt3_1p3b_config",
           "gpt3_6p7b_config", "BertConfig", "BertEmbeddings", "BertPooler",
           "BertModel", "BertForSequenceClassification", "bert_base_config"]
