"""Paged KV block pool with refcounted prefix reuse (port of
``repro.serving.paged.BlockPool``).

The KV cache is a GLOBAL pool of ``block_size``-token blocks, and every
active request holds a block table (a row of pool block ids) instead of
a dedicated ``cache_len`` region, so a request pins only
ceil(len / block_size) blocks.  Admission blocks on free BLOCKS:
``can_admit`` counts the blocks a request will ever need (prompt +
max_new_tokens, capped at the table size) and reserves the growth up
front, so a mid-decode ``ensure_block`` never runs dry.

Prompt prefixes are indexed at block granularity with a CHAIN hash (each
block's digest folds in its predecessor's, seeded with the storage
dtype), so a hit on block j certifies that the whole prefix [0, (j+1)
block_size) matches token for token; with position-0-anchored RoPE the
cached K/V are then what a fresh prefill would write.  Hit blocks are
mapped read-only (refcount += 1); the partial tail block is never
registered, which is the copy-on-write boundary.  Released blocks with
index entries stay cached at refcount 0 and are reclaimed LRU-first.

One addition to the reference: every block ``_alloc`` hands out is also
appended to ``fresh``, which the engine drains (``drain_fresh``) to
clear the block's positions in the cache before anything is written to
it.  The reference never clears them, so a recycled block still shows
its previous owner's positions at the offsets the new owner has not
written yet, and the new owner attends the old owner's K/V.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.serving.slots import SlotPool


class BlockPool(SlotPool):
    """Slot bookkeeping + global block pool + prefix index.  Duck-types as
    a ``SlotPool`` for the engine, adding block tables and block-level
    admission."""

    def __init__(self, slots: int, *, num_blocks: int, block_size: int,
                 max_blocks_per_slot: int, prefix_cache: bool = True,
                 kv_dtype: str = "bf16"):
        super().__init__(slots)
        if block_size <= 0 or num_blocks <= 0:
            raise ValueError(f"bad pool geometry: {num_blocks}x{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_dtype = kv_dtype          # part of a prefix's identity
        self.max_blocks = max_blocks_per_slot
        self.block_tables = np.full((slots, max_blocks_per_slot), -1,
                                    np.int32)
        self.refcount = np.zeros(num_blocks, np.int32)
        # pop() takes from the end: low ids there, for determinism
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.fresh: List[int] = []        # allocated, positions not cleared
        self._reserved = np.zeros(slots, np.int64)
        self._total_reserved = 0
        self.prefix_cache_enabled = prefix_cache
        # digest -> (block id, its tokens); order is the LRU order
        self._index: "OrderedDict[bytes, Tuple[int, Tuple[int, ...]]]" = \
            OrderedDict()
        self._block_hash: Dict[int, bytes] = {}
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0

    # -- pool accounting ---------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Blocks on the free list (cached blocks excluded)."""
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks kept only by the prefix index (reclaimable)."""
        return sum(1 for blk, _ in self._index.values()
                   if self.refcount[blk] == 0)

    def available_blocks(self) -> int:
        """Blocks a NEW request may claim: free + reclaimable, minus the
        growth already promised to admitted requests."""
        return self.free_blocks + self.cached_blocks - self._total_reserved

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        total = prompt_len + max_new
        return min(-(-total // self.block_size), self.max_blocks)

    def allocated_blocks(self, slot: int) -> int:
        return int((self.block_tables[slot] >= 0).sum())

    # -- prefix hashing ----------------------------------------------------
    def _prefix_hashes(self, prompt: np.ndarray):
        """[(chain digest, block tokens)] of each FULL block of ``prompt``;
        digest j commits to blocks 0..j (the tokens guard collisions)."""
        BS = self.block_size
        out = []
        h = self.kv_dtype.encode()
        for j in range(len(prompt) // BS):
            toks = tuple(int(t) for t in prompt[j * BS:(j + 1) * BS])
            h = hashlib.blake2b(h + np.asarray(toks, np.int64).tobytes(),
                                digest_size=16).digest()
            out.append((h, toks))
        return out

    def probe_prefix(self, prompt: np.ndarray) -> int:
        """Leading full blocks of ``prompt`` in the index, capped at
        (S - 1) // block_size so at least one prompt token is prefilled
        (its logits give the first sampled token)."""
        if not self.prefix_cache_enabled:
            return 0
        cap = (len(prompt) - 1) // self.block_size
        hits = 0
        for h, toks in self._prefix_hashes(prompt)[:cap]:
            ent = self._index.get(h)
            if ent is None or ent[1] != toks:
                break
            hits += 1
        return hits

    # -- admission ---------------------------------------------------------
    def can_admit(self, prompt: np.ndarray, max_new: int) -> bool:
        need = self.blocks_needed(len(prompt), max_new)
        return need - self.probe_prefix(prompt) <= self.available_blocks()

    def acquire_blocks(self, slot: int, rid: int, prompt: np.ndarray,
                       max_new: int) -> int:
        """Map ``slot``'s table for ``prompt``: prefix hits SHARED
        (refcount += 1), fresh blocks for the rest of the prompt, and the
        growth for ``max_new`` tokens reserved (mapped lazily by
        ``ensure_block``).  Returns the prefix-cached tokens."""
        BS = self.block_size
        S = len(prompt)
        total = self.blocks_needed(S, max_new)
        nb_prompt = -(-S // BS)
        hits = self.probe_prefix(prompt)
        hashes = self._prefix_hashes(prompt)
        for j in range(hits):
            h = hashes[j][0]
            blk, _ = self._index[h]
            self.refcount[blk] += 1
            self._index.move_to_end(h)            # refresh LRU
            self.block_tables[slot, j] = blk
        for j in range(hits, nb_prompt):
            self.block_tables[slot, j] = self._alloc()
        grow = total - nb_prompt
        if grow > 0:
            self._reserved[slot] = grow
            self._total_reserved += grow
        super().acquire(slot, rid, S)
        if hits:
            self.prefix_hits += 1
            self.prefix_hit_tokens += hits * BS
        else:
            self.prefix_misses += 1
        return hits * BS

    def register_prefix(self, slot: int, prompt: np.ndarray):
        """Publish ``slot``'s FULL prompt blocks to the index, after the
        prefill wrote them.  The partial tail is never published, so
        shared blocks are immutable (decode writes land past them)."""
        if not self.prefix_cache_enabled:
            return
        for j, (h, toks) in enumerate(self._prefix_hashes(prompt)):
            blk = int(self.block_tables[slot, j])
            if blk < 0:
                break
            if h in self._index:
                self._index.move_to_end(h)
            else:
                self._index[h] = (blk, toks)
                self._block_hash[blk] = h

    # -- decode growth -----------------------------------------------------
    def ensure_block(self, slot: int) -> bool:
        """Map the block holding position ``lengths[slot]`` (the next
        decode write), drawing on the slot's reservation.  False past the
        table's capacity."""
        nb = int(self.lengths[slot]) // self.block_size
        if nb >= self.max_blocks:
            return False
        if self.block_tables[slot, nb] >= 0:
            return True
        self.block_tables[slot, nb] = self._alloc()
        if self._reserved[slot] > 0:
            self._reserved[slot] -= 1
            self._total_reserved -= 1
        return True

    # -- alloc / reclaim / release ----------------------------------------
    def _alloc(self) -> int:
        if not self._free:
            self._reclaim_one()
        blk = self._free.pop()
        self.refcount[blk] = 1
        self.fresh.append(blk)
        return blk

    def drain_fresh(self) -> List[int]:
        """Blocks allocated since the last drain, whose cache positions the
        caller must clear before writing to them."""
        out, self.fresh = self.fresh, []
        return out

    def _reclaim_one(self):
        """Evict the least-recently-used refcount-0 cached block."""
        for h in self._index:                     # front = LRU
            blk, _ = self._index[h]
            if self.refcount[blk] == 0:
                del self._index[h]
                del self._block_hash[blk]
                self._free.append(blk)
                return
        raise RuntimeError(
            "block pool exhausted: no free or reclaimable blocks "
            "(admission/reservation accounting bug)")

    def release(self, slot: int):
        """Return the slot's blocks: decref; a refcount-0 block stays
        cached if indexed, else goes back to the free list."""
        for blk in self.block_tables[slot]:
            blk = int(blk)
            if blk < 0:
                continue
            self.refcount[blk] -= 1
            assert self.refcount[blk] >= 0, (slot, blk)
            if self.refcount[blk] == 0 and blk not in self._block_hash:
                self._free.append(blk)
        self.block_tables[slot, :] = -1
        self._total_reserved -= int(self._reserved[slot])
        self._reserved[slot] = 0
        super().release(slot)

    # -- reporting ---------------------------------------------------------
    def prefix_stats(self) -> Dict:
        return {
            "hits": self.prefix_hits,
            "misses": self.prefix_misses,
            "hit_tokens": self.prefix_hit_tokens,
            "indexed_blocks": len(self._index),
            "cached_blocks": self.cached_blocks,
        }
