from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, ErnieModel,
                   bert_base, bert_large, bert_tiny, ernie_1_5b,
                   ernie_3_0_medium)
from .gpt import (GPT, GPTConfig, GPTForCausalLM, gpt2_medium, gpt2_small,
                  gpt2_tiny, gpt_decode_fns)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "ErnieModel",
           "bert_base", "bert_large", "bert_tiny", "ernie_1_5b",
           "ernie_3_0_medium", "GPT", "GPTConfig", "GPTForCausalLM",
           "gpt2_medium", "gpt2_small", "gpt2_tiny", "gpt_decode_fns"]
