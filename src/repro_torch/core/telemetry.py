"""Request-level serving telemetry (the serving half of
``repro.core.telemetry``, copied): one record per finished or cancelled
request with queue wait, TTFT and TPOT, plus a percentile summary and,
where requests report them, KV-memory use (``kv_utilization``: used over
allocated bytes) and the prompt tokens served from the prefix cache."""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np


def percentile(xs: List[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]); nan when empty."""
    if not xs:
        return float("nan")
    return float(np.percentile(xs, q))


class ServingTelemetry:
    def __init__(self, path: Optional[str] = None):
        self.path = pathlib.Path(path) if path else None
        self._fh = self.path.open("a") if self.path else None
        self.records: List[Dict] = []

    def record_request(self, result) -> Dict:
        """Record a ``GenerationResult`` (duck-typed: needs .rid,
        .state.value, .done_reason, .metrics.as_dict())."""
        rec = {
            "rid": result.rid,
            "state": result.state.value,
            "done_reason": result.done_reason,
            "time": time.time(),
            **result.metrics.as_dict(),
        }
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def summary(self) -> Dict:
        """p50/p99 TTFT / TPOT / queue wait (ms) over finished requests."""
        fin = [r for r in self.records if r["state"] == "finished"]

        def pick(key):
            return [r[key] for r in fin if r.get(key) is not None]

        ttft, tpot, qw = pick("ttft_s"), pick("tpot_s"), pick("queue_wait_s")
        out = {
            "requests": len(self.records),
            "finished": len(fin),
            "cancelled": sum(r["state"] == "cancelled" for r in self.records),
            "output_tokens": sum(r["output_tokens"] for r in self.records),
            "ttft_p50_ms": percentile(ttft, 50) * 1e3,
            "ttft_p99_ms": percentile(ttft, 99) * 1e3,
            "tpot_p50_ms": percentile(tpot, 50) * 1e3,
            "tpot_p99_ms": percentile(tpot, 99) * 1e3,
            "queue_wait_p50_ms": percentile(qw, 50) * 1e3,
            "queue_wait_p99_ms": percentile(qw, 99) * 1e3,
        }
        alloc, used = pick("kv_allocated_bytes"), pick("kv_used_bytes")
        if alloc:
            out["kv_allocated_mb"] = sum(alloc) / 1e6
            out["kv_used_mb"] = sum(used) / 1e6
            out["kv_utilization"] = (sum(used) / sum(alloc)) if sum(alloc) \
                else 0.0
        pft = pick("prefilled_tokens")
        if pft:
            out["prefilled_tokens"] = sum(pft)
        pct = pick("prefix_cached_tokens")
        if any(pct):
            out["prefix_cached_tokens"] = sum(pct)
        return out

    def close(self):
        if self._fh:
            self._fh.close()
