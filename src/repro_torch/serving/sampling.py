"""Sampling for the serving engine (port of ``repro.serving.sampling``).

Greedy decoding is exact: the first maximal logit, as in the reference.
The top-k / top-p keep-mask is computed as the reference computes it.
The draw itself cannot repeat the reference's bits (JAX's PRNG): each
sampled row draws Gumbel noise from its own ``torch.Generator`` seeded
from (seed, step), so a request's stream depends only on its seed and
its own token counter, never on its slot or its neighbours.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding configuration.  temperature == 0 selects
    greedy argmax; top_k == 0 and top_p == 1.0 disable the filters."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new_tokens: int = 16
    eos_token: Optional[int] = 1

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


GREEDY = SamplingParams()


def _stream_seed(seed: int, step: int) -> int:
    """One generator seed per (request seed, step): splitmix64 of both,
    so that every bit of each reaches the low 32 bits (the CPU generator
    keeps only those)."""
    M = (1 << 64) - 1
    z = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= M
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M
    return z ^ (z >> 31)


def keep_mask(logits, temperature, top_k, top_p):
    """Temperature-scaled f32 logits (B, V) and the bool (B, V) mask of
    tokens that survive top-k and top-p, as ``repro.serving.sampling``
    computes them.  All filter args are (B,) tensors."""
    V = logits.shape[-1]
    t = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits.float() / t
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, torch.clamp(top_k, 1, V),
                    torch.full_like(top_k, V)).long()
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    keep = scaled >= kth
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p.float()[:, None]
    pth = torch.where(keep_sorted, sorted_desc,
                      torch.full_like(sorted_desc, float("inf"))).amin(-1)
    return scaled, keep & (scaled >= pth[:, None])


def sample_tokens(logits, seeds, steps, temperature, top_k, top_p):
    """Per-row sampling.  logits: (B, V); seeds, steps, temperature,
    top_k, top_p: (B,) host arrays or tensors.  Returns (B,) int64 token
    ids on the logits' device."""
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    out = torch.argmax(logits.float(), dim=-1)
    rows = torch.nonzero(temperature > 0).flatten().tolist()
    if not rows:
        return out
    top_k = torch.as_tensor(top_k, device=dev).long()
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    scaled, keep = keep_mask(logits[rows], temperature[rows], top_k[rows],
                             top_p[rows])
    masked = torch.where(keep, scaled, torch.full_like(scaled, -float("inf")))
    gen = torch.Generator(device=dev)
    for i, r in enumerate(rows):
        gen.manual_seed(_stream_seed(int(seeds[r]), int(steps[r])))
        u = torch.rand(masked.shape[-1], generator=gen, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[r] = torch.argmax(masked[i] + gumbel)
    return out
