"""Synthetic request mixes echoing the paper's §7 workload dynamics.

One canonical prompt-length distribution — request traffic dominated by
many SMALL interactive jobs with a heavy tail of long prompts — shared
by the serve CLI and the open-loop load benchmark so the mix cannot
drift between them.
"""
from __future__ import annotations

import numpy as np

SHORT_FRAC = 0.75      # §7 Obs. 2: small jobs dominate by count


def sample_prompt_len(rng: np.random.Generator, prefill_len: int,
                      short_frac: float = SHORT_FRAC) -> int:
    """Draw one prompt length: mostly short, a tail of near-max prompts."""
    if rng.random() < short_frac:
        return int(rng.integers(4, max(5, prefill_len // 4)))
    return int(rng.integers(prefill_len // 2, prefill_len + 1))
