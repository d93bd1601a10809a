"""Language models of the port: GPT, BERT and ERNIE."""
from .convert import load_jax_params  # noqa: F401
from .gpt import (  # noqa: F401
    GPT, GPTAttention, GPTBlock, GPTConfig, GPTForGeneration, GPTMLP,
    GPTStage, gpt_125m, gpt_1p3b, gpt_350m, gpt_6p7b, gpt_pipeline_stages,
    gpt_stage_ranges, gpt_tiny,
)
from .bert import Bert, BertConfig, BertForPretraining  # noqa: F401
from .ernie import (  # noqa: F401
    Ernie, ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification,
    ernie_3_base, ernie_3_base_config, ernie_pipeline_descs, ernie_tiny,
    ernie_tiny_config,
)

__all__ = ["GPT", "GPTAttention", "GPTBlock", "GPTConfig", "GPTForGeneration",
           "GPTMLP", "GPTStage", "gpt_125m", "gpt_350m", "gpt_1p3b",
           "gpt_6p7b", "gpt_pipeline_stages", "gpt_stage_ranges", "gpt_tiny",
           "load_jax_params", "Bert", "BertConfig", "BertForPretraining",
           "Ernie", "ErnieConfig", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ernie_3_base",
           "ernie_3_base_config", "ernie_pipeline_descs", "ernie_tiny",
           "ernie_tiny_config"]
