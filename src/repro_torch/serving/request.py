"""Request lifecycle types for the serving engine.

A request moves QUEUED -> PREFILL -> DECODE -> FINISHED (or CANCELLED
from any live state).  The engine stamps wall-clock times at each
transition and derives the serving metrics the load benchmark and
``repro_torch.core.telemetry.ServingTelemetry`` aggregate:

    queue_wait  time from submit to prefill start
    ttft        time to first token (submit -> first sampled token)
    tpot        time per output token over the decode phase
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serving.sampling import GREEDY, SamplingParams

# on_token callback signature: (rid, token_id, is_last)
TokenCallback = Callable[[int, int, bool], None]


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    CANCELLED = "cancelled"

    @property
    def is_terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.CANCELLED)


@dataclasses.dataclass
class RequestMetrics:
    t_submit: float = 0.0
    t_prefill_start: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    prompt_tokens: int = 0
    output_tokens: int = 0
    # paged-KV serving: how the request hit the cache / pool.
    # prefilled_tokens < prompt_tokens means a prefix-cache hit skipped
    # the difference; kv_allocated vs kv_used is the fragmentation
    # signal (contiguous slots allocate cache_len regardless of use).
    prefilled_tokens: Optional[int] = None
    prefix_cached_tokens: int = 0
    kv_allocated_bytes: Optional[int] = None
    kv_used_bytes: Optional[int] = None

    @property
    def queue_wait(self) -> Optional[float]:
        if self.t_prefill_start is None:
            return None
        return self.t_prefill_start - self.t_submit

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot(self) -> Optional[float]:
        """Mean inter-token latency over the decode phase (s/token).

        None for single-token outputs — there is no inter-token
        interval, and a 0.0 would skew percentile aggregation."""
        if self.t_finish is None or self.t_first_token is None \
                or self.output_tokens <= 1:
            return None
        return (self.t_finish - self.t_first_token) / (self.output_tokens - 1)

    def as_dict(self) -> dict:
        return {
            "prompt_tokens": self.prompt_tokens,
            "output_tokens": self.output_tokens,
            "queue_wait_s": self.queue_wait,
            "ttft_s": self.ttft,
            "tpot_s": self.tpot,
            "prefilled_tokens": self.prefilled_tokens,
            "prefix_cached_tokens": self.prefix_cached_tokens,
            "kv_allocated_bytes": self.kv_allocated_bytes,
            "kv_used_bytes": self.kv_used_bytes,
        }


@dataclasses.dataclass
class InferenceRequest:
    """One generation request.

    ``prompt`` is a 1-D int32 token array.  ``sampling`` carries the
    decode config including max_new_tokens and the eos token.
    """
    rid: int
    prompt: np.ndarray
    sampling: SamplingParams = GREEDY
    on_token: Optional[TokenCallback] = None

    # engine-managed state
    state: RequestState = RequestState.QUEUED
    generated: List[int] = dataclasses.field(default_factory=list)
    metrics: RequestMetrics = dataclasses.field(default_factory=RequestMetrics)

    def emit(self, token: int, is_last: bool):
        self.generated.append(int(token))
        self.metrics.output_tokens = len(self.generated)
        if self.on_token is not None:
            self.on_token(self.rid, int(token), is_last)

    @property
    def done_reason(self) -> Optional[str]:
        if self.state == RequestState.CANCELLED:
            return "cancelled"
        if self.state != RequestState.FINISHED:
            return None
        if self.generated and self.sampling.eos_token is not None \
                and self.generated[-1] == self.sampling.eos_token:
            return "eos"
        return "length"


@dataclasses.dataclass
class GenerationResult:
    """What ``Engine.run`` returns per finished/cancelled request."""
    rid: int
    tokens: List[int]
    state: RequestState
    done_reason: Optional[str]
    metrics: RequestMetrics
