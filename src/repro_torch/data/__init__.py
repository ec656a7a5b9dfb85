"""The synthetic token pipeline of the LM training path."""
from repro_torch.data.pipeline import TokenPipeline, make_lm_batch

__all__ = ["TokenPipeline", "make_lm_batch"]
