"""Fixed-size slot pool with true per-slot sequence lengths (port of
``repro.serving.slots``).

Every cache leaf has a batch axis of size ``slots`` and decode advances
all slots at once.  Mixed-length slots stay correct because each slot's
next write position is its own length, empty cache positions are -1 (so
attention masks other slots' history and a recycled slot's leftovers),
and joining a request overwrites the slot's whole cache row.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class SlotPool:
    def __init__(self, slots: int):
        self.slots = slots
        self.lengths = np.zeros(slots, np.int64)
        self.owner: List[Optional[int]] = [None] * slots

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.owner) if r is None]

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.owner)

    def acquire(self, slot: int, rid: int, prompt_len: int):
        if self.owner[slot] is not None:
            raise ValueError(f"slot {slot} is held by rid {self.owner[slot]}")
        self.owner[slot] = rid
        self.lengths[slot] = prompt_len

    def release(self, slot: int):
        self.owner[slot] = None
        self.lengths[slot] = 0

    def advance(self, slot: int):
        self.lengths[slot] += 1

    def positions(self) -> np.ndarray:
        """Per-slot next decode position (== current true length)."""
        return self.lengths.astype(np.int32).copy()

    def scatter_prefill(self, pool_cache: Dict, cache1: Dict,
                        slot: int) -> Dict:
        """Write a batch=1 prefill cache into row ``slot`` of the pool.

        Every leaf but ``len`` is copied (a quantized cache's scales with
        its K/V), as in the reference.  Unlike the reference, which builds
        a new pool, the row is written IN PLACE into the preallocated cache
        tensors: the prefill's columns, then, to the end of the row, -1 in
        integer leaves (positions, and int8 K/V as in the reference) and 0
        in the others."""
        for key, pool in pool_cache.items():
            if key == "len":
                continue
            one = cache1[key]
            S = one.shape[2]
            if S > pool.shape[2]:
                raise ValueError(f"prefill cache leaf {key!r} longer than "
                                 f"pool ({S} > {pool.shape[2]}); raise "
                                 "cache_len")
            pool[:, slot, :S] = one[:, 0]
            pool[:, slot, S:] = 0 if pool.dtype.is_floating_point else -1
        return pool_cache
