"""Request-lifecycle inference engine over a fixed slot pool (port of
``repro.serving.engine.Engine``).

Submit requests (QUEUED); each joins a free cache slot through a batch=1
prefill (PREFILL); every tick decodes one token for all active slots
(DECODE) through the model's ``decode_step`` (the flash-decode kernel on
the card); a request finishes on EOS or max_new_tokens (FINISHED) or by
``cancel`` (CANCELLED).  Per-request queue wait, TTFT and TPOT land in a
``ServingTelemetry``.

With ``block_size`` the cache is paged: a global pool of blocks behind a
``BlockPool``, admission by free blocks, prompt prefixes shared across
requests (only the suffix is prefilled, through ``prefix_prefill``) and
the paged decode kernel on every tick.  ``kv_dtype="int8"`` or ``"fp8"``
stores the contiguous cache quantized (the quantized decode kernel on
every tick).  A paged quantized cache and the reference's parallelism
plans are not ported yet.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.telemetry import ServingTelemetry
from repro_torch.kernels import quant as Q
from repro_torch.serving.request import (GenerationResult, InferenceRequest,
                                         RequestState, TokenCallback)
from repro_torch.serving.paged import BlockPool
from repro_torch.serving.sampling import GREEDY, SamplingParams, sample_tokens
from repro_torch.serving.slots import SlotPool


def make_generate_step(model):
    """One decode tick for every slot plus per-slot sampling.  All
    per-slot state enters as (B,) arrays; ``positions`` is each slot's
    true length (its next write position)."""
    def generate_step(params, cache, tokens, positions, seeds, steps,
                      temperature, top_k, top_p, block_tables=None):
        dev = model.device
        pos = torch.as_tensor(positions, dtype=torch.int32, device=dev)
        batch = {"tokens": torch.as_tensor(tokens, device=dev).long()[:, None],
                 "positions": pos[:, None].contiguous(), "pos_row": pos}
        if block_tables is not None:      # paged: through the block pool
            batch["block_tables"] = torch.as_tensor(block_tables,
                                                    dtype=torch.int32,
                                                    device=dev)
        logits, cache = model.decode_step(params, batch, cache)
        return sample_tokens(logits, seeds, steps, temperature, top_k,
                             top_p), cache
    return generate_step


class Engine:
    """Continuous-batching inference engine over a fixed slot pool."""

    def __init__(self, model, params, *, slots: int = 4,
                 prefill_len: int = 64, cache_len: int = 256,
                 prefill_chunk: Optional[int] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 kv_dtype: Optional[str] = None,
                 telemetry: Optional[ServingTelemetry] = None,
                 plan=None, device="cuda", clock=time.monotonic):
        if plan is not None:
            raise NotImplementedError("parallelism plans are not ported yet "
                                      "(ROADMAP.md queue 1, item 13)")
        if resolve_device(device) != model.device:
            raise ValueError(f"Engine on {device} but the model lives on "
                             f"{model.device}")
        if prefill_len > cache_len:
            raise ValueError(f"prefill_len {prefill_len} exceeds "
                             f"cache_len {cache_len}")
        self.model, self.params, self.cfg = model, params, model.cfg
        self.device = model.device
        # an explicit kv_dtype overrides the model's, as in the reference
        self.kv_dtype = model.kv_dtype if kv_dtype is None else kv_dtype
        self.slots = slots
        self.prefill_len = prefill_len
        self.cache_len = cache_len
        self.prefill_chunk = prefill_chunk
        self.clock = clock
        self.telemetry = telemetry if telemetry is not None \
            else ServingTelemetry()
        self._generate = make_generate_step(model)
        self.paged = block_size is not None
        if self.paged:
            self.block_size = int(block_size)
            self.max_blocks = -(-cache_len // self.block_size)
            # default: the contiguous layout's memory, in whole blocks
            self.num_blocks = (int(num_blocks) if num_blocks is not None
                               else slots * self.max_blocks)
            self.cache = model.init_cache(
                slots, cache_len, paged=(self.num_blocks, self.block_size),
                kv_dtype=self.kv_dtype)
            self.pool = BlockPool(
                slots, num_blocks=self.num_blocks,
                block_size=self.block_size,
                max_blocks_per_slot=self.max_blocks,
                prefix_cache=prefix_cache, kv_dtype=self.kv_dtype)
        else:
            if num_blocks is not None:
                raise ValueError("num_blocks needs block_size")
            self.block_size = self.num_blocks = None
            self.cache = model.init_cache(slots, cache_len,
                                          kv_dtype=self.kv_dtype)
            self.pool = SlotPool(slots)
        # set once the cache is made (init_cache refuses what is not
        # ported): prefill quantizes by the model's kv_dtype
        model.kv_dtype = self.kv_dtype
        self.queue: List[InferenceRequest] = []
        self.requests: Dict[int, InferenceRequest] = {}
        self.finished: Dict[int, GenerationResult] = {}
        self._slot_req: List[Optional[InferenceRequest]] = [None] * slots
        self.last_tok = np.zeros(slots, np.int64)
        self._temp = np.zeros(slots, np.float32)
        self._top_k = np.zeros(slots, np.int64)
        self._top_p = np.ones(slots, np.float32)
        self._seeds = np.zeros(slots, np.uint32)
        self._steps = np.zeros(slots, np.int64)
        self._next_rid = 0
        self.ticks = 0

    # -- request intake ----------------------------------------------------
    def submit(self, prompt: Union[np.ndarray, Sequence[int],
                                   InferenceRequest],
               sampling: Optional[SamplingParams] = None, *,
               rid: Optional[int] = None,
               on_token: Optional[TokenCallback] = None) -> int:
        """Enqueue a request (QUEUED). Returns its rid."""
        if isinstance(prompt, InferenceRequest):
            req = prompt
        else:
            arr = np.asarray(prompt, np.int32).reshape(-1)
            if arr.size == 0:
                raise ValueError("empty prompt")
            req = InferenceRequest(
                rid=self._next_rid if rid is None else rid,
                prompt=arr, sampling=sampling or GREEDY, on_token=on_token)
        if req.rid in self.requests:
            raise ValueError(f"duplicate rid {req.rid}")
        if len(req.prompt) > self.prefill_len:
            warnings.warn(
                f"rid {req.rid}: prompt ({len(req.prompt)} tokens) exceeds "
                f"prefill_len ({self.prefill_len}); only the first "
                f"{self.prefill_len} tokens will be prefilled",
                UserWarning, stacklevel=2)
        self._next_rid = max(self._next_rid, req.rid + 1)
        req.state = RequestState.QUEUED
        req.metrics.t_submit = self.clock()
        req.metrics.prompt_tokens = int(len(req.prompt))
        self.requests[req.rid] = req
        self.queue.append(req)
        return req.rid

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request. Returns True if it was live."""
        req = self.requests.get(rid)
        if req is None or req.state.is_terminal:
            return False
        if req.state == RequestState.QUEUED:
            self.queue.remove(req)
        else:
            for slot, r in enumerate(self._slot_req):
                if r is req:
                    self._account(slot, req)
                    self._release(slot)
                    break
        self._finalize(req, RequestState.CANCELLED)
        return True

    # -- lifecycle internals ----------------------------------------------
    def _bucket_len(self, S: int) -> int:
        if self.prefill_chunk:
            c = self.prefill_chunk
            return min(self.prefill_len, -(-S // c) * c)
        return S

    def _join(self, slot: int, req: InferenceRequest):
        """Prefill at batch=1, sample the first token, scatter into slot."""
        req.state = RequestState.PREFILL
        req.metrics.t_prefill_start = self.clock()
        S = int(min(len(req.prompt), self.prefill_len))
        if self.paged:
            self._join_paged(slot, req, S)
            return
        Sp = self._bucket_len(S)
        toks = np.zeros(Sp, np.int64)
        toks[:S] = req.prompt[:S]
        batch = {"tokens": torch.as_tensor(toks, device=self.device)[None]}
        if Sp != S:
            pos = np.arange(Sp, dtype=np.int32)
            pos[S:] = -1                  # pads: masked keys
            batch["positions"] = torch.as_tensor(pos, device=self.device)[None]
            batch["length"] = torch.as_tensor([S], device=self.device)
        logits, cache1 = self.model.prefill(self.params, batch)
        self.pool.scatter_prefill(self.cache, cache1, slot)
        self.pool.acquire(slot, req.rid, S)
        req.metrics.prefilled_tokens = S
        self._finish_join(slot, req, logits)

    def _join_paged(self, slot: int, req: InferenceRequest, S: int):
        """Paged join: map blocks (prefix hits shared), prefill only the
        suffix THROUGH the pool, publish the new full blocks."""
        prompt = np.asarray(req.prompt[:S], np.int32)
        cached = self.pool.acquire_blocks(slot, req.rid, prompt,
                                          req.sampling.max_new_tokens)
        self._clear_fresh_blocks()
        Ssuf = S - cached
        Sp = self._bucket_len(Ssuf)
        toks = np.zeros(Sp, np.int64)
        toks[:Ssuf] = prompt[cached:]
        pos = np.arange(Sp, dtype=np.int32) + cached
        pos[Ssuf:] = -1                   # pads: no write, dead keys
        dev = self.device
        batch = {"tokens": torch.as_tensor(toks, device=dev)[None],
                 "positions": torch.as_tensor(pos, device=dev)[None],
                 "length": torch.as_tensor([Ssuf], device=dev),
                 "block_tables": torch.as_tensor(
                     self.pool.block_tables[slot:slot + 1], device=dev)}
        logits, self.cache = self.model.prefix_prefill(self.params, batch,
                                                       self.cache)
        self.pool.register_prefix(slot, prompt)
        req.metrics.prefix_cached_tokens = cached
        req.metrics.prefilled_tokens = Ssuf
        self._finish_join(slot, req, logits)

    def _clear_fresh_blocks(self):
        """Set the cache positions of newly allocated blocks to -1 before
        anything writes to them, so a recycled block shows none of its
        previous owner's keys (one indexed fill over all layers)."""
        fresh = self.pool.drain_fresh()
        if fresh:
            self.cache["pos"][:, torch.as_tensor(fresh, device=self.device)] \
                = -1

    def _finish_join(self, slot: int, req: InferenceRequest, logits):
        """Sample token 0 and arm the slot's decode state."""
        sp = req.sampling
        first = sample_tokens(logits, [sp.seed], [0], [sp.temperature],
                              [sp.top_k], [sp.top_p])
        self._slot_req[slot] = req
        tok = int(first[0])
        self.last_tok[slot] = tok
        self._temp[slot] = sp.temperature
        self._top_k[slot] = sp.top_k
        self._top_p[slot] = sp.top_p
        self._seeds[slot] = np.uint32(sp.seed & 0xFFFFFFFF)
        self._steps[slot] = 1
        req.state = RequestState.DECODE
        req.metrics.t_first_token = self.clock()
        last = self._is_last(req, tok) or self._at_capacity(slot)
        req.emit(tok, last)
        # the callback may have cancelled this request (reentrant cancel)
        if last and self._slot_req[slot] is req:
            self._retire(slot)

    def _is_last(self, req: InferenceRequest, tok: int) -> bool:
        sp = req.sampling
        return (sp.eos_token is not None and tok == sp.eos_token) \
            or len(req.generated) + 1 >= sp.max_new_tokens

    def _at_capacity(self, slot: int) -> bool:
        """Paged slots retire at cache_len (no ring wraparound: a shared
        block may hold another request's history)."""
        return self.paged and self.pool.lengths[slot] >= self.cache_len

    @property
    def kv_bytes_per_token(self) -> int:
        """K+V bytes one cached token costs over all layers, byte-true for
        the engine's kv_dtype: a quantized cache charges its narrow payload
        and the f32 scale of each (token, head) vector."""
        cfg = self.cfg
        return cfg.num_layers * 2 * cfg.num_kv_heads * Q.kv_bytes_per_vector(
            cfg.head_dim, self.kv_dtype)

    def _account(self, slot: int, req: InferenceRequest):
        bpt = self.kv_bytes_per_token
        req.metrics.kv_used_bytes = int(
            min(int(self.pool.lengths[slot]), self.cache_len)) * bpt
        if self.paged:
            req.metrics.kv_allocated_bytes = (
                self.pool.allocated_blocks(slot) * self.block_size * bpt)
        else:
            req.metrics.kv_allocated_bytes = self.cache_len * bpt

    def _release(self, slot: int):
        self.pool.release(slot)
        self._slot_req[slot] = None
        self._temp[slot] = 0.0
        self._steps[slot] = 0

    def _retire(self, slot: int):
        req = self._slot_req[slot]
        self._account(slot, req)
        self._release(slot)
        self._finalize(req, RequestState.FINISHED)

    def _finalize(self, req: InferenceRequest,
                  state: RequestState) -> GenerationResult:
        req.state = state
        req.metrics.t_finish = self.clock()
        res = GenerationResult(rid=req.rid, tokens=list(req.generated),
                               state=state, done_reason=req.done_reason,
                               metrics=req.metrics)
        self.finished[req.rid] = res
        self.telemetry.record_request(res)
        return res

    # -- scheduling tick ---------------------------------------------------
    def step(self) -> bool:
        """One tick: admit queued requests into free slots, decode once.
        Returns False when there is nothing to do."""
        admitted = 0
        while self.queue:
            # re-list free slots each join: a request finished by its first
            # token frees its slot inside _join
            free = self.pool.free_slots()
            if not free:
                break
            if self.paged:
                # admission blocks on free BLOCKS: the head request's
                # prompt and reserved growth must fit (FIFO, no reordering)
                head = self.queue[0]
                S = int(min(len(head.prompt), self.prefill_len))
                if not self.pool.can_admit(
                        np.asarray(head.prompt[:S], np.int32),
                        head.sampling.max_new_tokens):
                    break
            self._join(free[0], self.queue.pop(0))
            admitted += 1
        if self.pool.num_active == 0:
            return admitted > 0
        extra = {}
        if self.paged:
            # map the block of each active row's next write position
            for slot in range(self.slots):
                if self._slot_req[slot] is not None:
                    self.pool.ensure_block(slot)
            self._clear_fresh_blocks()
            extra["block_tables"] = self.pool.block_tables
        self.cache["len"] = int(self.pool.lengths.max())
        tok, self.cache = self._generate(
            self.params, self.cache, self.last_tok, self.pool.positions(),
            self._seeds, self._steps, self._temp, self._top_k, self._top_p,
            **extra)
        tok_host = tok.cpu().numpy()
        self.last_tok = tok_host.copy()
        self.ticks += 1
        for slot in range(self.slots):
            # read live: an on_token callback may have cancelled a later slot
            req = self._slot_req[slot]
            if req is None or req.state.is_terminal:
                continue
            t = int(tok_host[slot])
            self.pool.advance(slot)
            self._steps[slot] += 1
            last = self._is_last(req, t) or self._at_capacity(slot)
            req.emit(t, last)
            if last and self._slot_req[slot] is req:
                self._retire(slot)
        return True

    def run(self, max_ticks: int = 1000) -> Dict[int, GenerationResult]:
        """Drive ticks until idle (or max_ticks). Returns finished results."""
        ticks = 0
        while (self.queue or self.pool.num_active) and ticks < max_ticks:
            self.step()
            ticks += 1
        return dict(self.finished)

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingParams] = None,
                 max_ticks: int = 10_000) -> List[GenerationResult]:
        """Submit all, run to completion, return results in order."""
        rids = [self.submit(np.asarray(p, np.int32), sampling)
                for p in prompts]
        self.run(max_ticks)
        missing = [r for r in rids if r not in self.finished]
        if missing:
            raise RuntimeError(
                f"generate: {len(missing)} request(s) unfinished after "
                f"{max_ticks} ticks (rids {missing[:5]}...); raise max_ticks")
        return [self.finished[r] for r in rids]

    def stats(self) -> Dict:
        """Aggregate serving metrics (p50/p99 TTFT, TPOT, queue wait; with
        a paged cache, the pool and prefix-cache stats)."""
        out = self.telemetry.summary()
        out["kv_dtype"] = self.kv_dtype
        if self.paged:
            out["block_size"] = self.block_size
            out["num_blocks"] = self.num_blocks
            out["free_blocks"] = self.pool.free_blocks
            out["prefix"] = self.pool.prefix_stats()
        return out
