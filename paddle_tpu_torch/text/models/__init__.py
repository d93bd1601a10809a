"""Language models of the port."""
from .convert import load_jax_params  # noqa: F401
from .gpt import (  # noqa: F401
    GPT, GPTAttention, GPTBlock, GPTConfig, GPTForGeneration, GPTMLP,
    GPTStage, gpt_125m, gpt_pipeline_stages, gpt_stage_ranges, gpt_tiny,
)

__all__ = ["GPT", "GPTAttention", "GPTBlock", "GPTConfig", "GPTForGeneration",
           "GPTMLP", "GPTStage", "gpt_125m", "gpt_pipeline_stages",
           "gpt_stage_ranges", "gpt_tiny", "load_jax_params"]
