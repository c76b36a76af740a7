"""Serving engine of the port (contiguous slot-pool path)."""
from repro_torch.serving.engine import Engine, make_generate_step
from repro_torch.serving.request import (GenerationResult, InferenceRequest,
                                         RequestState)
from repro_torch.serving.sampling import (GREEDY, SamplingParams, keep_mask,
                                          sample_tokens)
from repro_torch.serving.slots import SlotPool

__all__ = ["Engine", "make_generate_step", "GenerationResult",
           "InferenceRequest", "RequestState", "GREEDY", "SamplingParams",
           "keep_mask", "sample_tokens", "SlotPool"]
