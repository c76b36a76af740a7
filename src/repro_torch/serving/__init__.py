"""Serving engine of the port (contiguous slot pool or paged block pool)."""
from repro_torch.serving.engine import Engine, make_generate_step
from repro_torch.serving.paged import BlockPool
from repro_torch.serving.request import (GenerationResult, InferenceRequest,
                                         RequestState)
from repro_torch.serving.sampling import (GREEDY, SamplingParams, keep_mask,
                                          sample_tokens)
from repro_torch.serving.slots import SlotPool

__all__ = ["Engine", "make_generate_step", "BlockPool", "GenerationResult",
           "InferenceRequest", "RequestState", "GREEDY", "SamplingParams",
           "keep_mask", "sample_tokens", "SlotPool"]
