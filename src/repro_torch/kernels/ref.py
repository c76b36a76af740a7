"""Plain PyTorch versions of the attention kernels on the serving path.

These are the CPU path of ``kernels.ops`` and the oracle that
``chip_smoke.py`` holds each CUDA kernel against on the card.  They
follow the reference twins in ``repro.kernels.ref`` (``flash_decode_ref``,
the forward of ``flash_attention_ref``, ``flash_decode_paged_ref``) and
``combine_partials`` of ``repro.kernels.flash_decode``, rounding to the input dtype at the same
points: scores and softmax statistics are f32, and ``p`` is cast to the
query's dtype before the PV product (in the decode; to V's in the
forward), so a decode over f32 dequantized K/V still rounds ``p`` to bf16,
as ``repro.kernels.quant.flash_decode_quant_ref`` does.

A query row with no valid key differs between the two on purpose, as in
the reference: decode returns zeros for it, the multi-token forward the
mean of V (its masked scores all equal ``NEG_INF``, so every column gets
p = exp(0) = 1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
BIG_WINDOW = 1 << 30


def _valid(q_pos, k_pos, causal: bool, window: Optional[int]):
    """q_pos (B, S), k_pos (B, T) -> bool (B, S, T)."""
    window = BIG_WINDOW if window is None else int(window)
    qp, kp = q_pos[:, :, None].long(), k_pos[:, None, :].long()
    valid = kp >= 0
    if causal:
        valid = valid & (qp >= kp)
    return valid & ((qp - kp) < window)


def _cap(s, softcap: Optional[float]):
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def flash_decode_partials(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                          softcap=None, splits: int = 1):
    """Per-split (acc, m, l) of grouped decode attention.

    q: (B, 1, H, d); k, v: (B, T, K, d) at the native kv-head count;
    q_pos: (B,) or (B, 1); k_pos: (B, T) with -1 = empty slot.  The key
    axis is cut into ``splits`` contiguous pieces of ceil(T / splits)
    keys.  Returns acc (B, K, splits, G, d), m and l (B, K, splits, G),
    all f32; a split with no valid key has m = NEG_INF and l = 0."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    if S != 1 or H % K:
        raise ValueError(f"decode takes one query token per row and H % K "
                         f"== 0 (got S={S}, H={H}, K={K})")
    G = H // K
    chunk = -(-T // splits)
    qg = q[:, 0].reshape(B, K, G, d).float()
    valid = _valid(q_pos.reshape(B, 1), k_pos, causal, window)[:, 0]   # (B,T)
    accs, ms, ls = [], [], []
    for si in range(splits):
        sl = slice(si * chunk, min(T, (si + 1) * chunk))
        kc, vc, ok = k[:, sl].float(), v[:, sl], valid[:, sl]
        s = torch.einsum("bkgd,btkd->bkgt", qg, kc) / math.sqrt(d)
        s = _cap(s, softcap)
        ok = ok[:, None, None, :]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        if s.shape[-1]:
            m = s.amax(-1)
        else:
            m = torch.full(s.shape[:-1], NEG_INF, dtype=s.dtype)
        p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p.to(q.dtype).float(),
                                 vc.float()))
        ms.append(m)
        ls.append(p.sum(-1))
    return torch.stack(accs, 2), torch.stack(ms, 2), torch.stack(ls, 2)


def combine_partials(o_part, m_part, l_part):
    """Log-sum-exp reduction over the split axis.

    o_part: (B, K, splits, G, d); m_part, l_part: (B, K, splits, G).
    Dead splits (m = NEG_INF, l = 0) contribute nothing; a row with no
    live key anywhere returns zeros.  Returns (B, K, G, d) f32."""
    m_star = m_part.amax(2)
    alpha = torch.exp(m_part - m_star[:, :, None])
    l_star = (l_part * alpha).sum(2)
    acc = (o_part * alpha[..., None]).sum(2)
    return acc / torch.clamp(l_star, min=1e-30)[..., None]


def flash_decode_ref(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                     softcap=None, splits: int = 1):
    """Grouped decode attention, plain PyTorch.  q: (B, 1, H, d);
    k, v: (B, T, K, d); returns (B, 1, H, d) in q's dtype."""
    B, _, H, d = q.shape
    parts = flash_decode_partials(q, k, v, q_pos, k_pos, causal=causal,
                                  window=window, softcap=softcap,
                                  splits=splits)
    return combine_partials(*parts).reshape(B, 1, H, d).to(q.dtype)


def gather_paged_kv(k_pool, v_pool, kp_pool, block_tables):
    """Per-row contiguous K/V views of a global block pool.

    k_pool, v_pool: (NB, BS, K, d); kp_pool: (NB, BS) int32;
    block_tables: (B, MAXB) int32 with -1 = unmapped.  Returns k, v
    (B, MAXB * BS, K, d) and positions (B, MAXB * BS): the contiguous
    cache the non-paged path would see.  An unmapped entry reads pool
    block 0 (its table entry is clamped for the read only) and its keys
    get position -1, so they are masked."""
    NB, BS, K, d = k_pool.shape
    B = block_tables.shape[0]
    bt = block_tables.long()
    safe = torch.clamp(bt, min=0)
    k = k_pool[safe].reshape(B, -1, K, d)
    v = v_pool[safe].reshape(B, -1, K, d)
    kp = torch.where(bt[..., None] >= 0, kp_pool[safe],
                     torch.full_like(kp_pool[safe], -1)).reshape(B, -1)
    return k, v, kp


def flash_decode_paged_ref(q, k_pool, v_pool, q_pos, kp_pool, block_tables,
                           *, causal=True, window=None, softcap=None):
    """Paged decode attention, plain PyTorch: gather each row's blocks
    (``gather_paged_kv``), then ``flash_decode_ref`` on that view, as the
    reference's ``flash_decode_paged_ref``.  q: (B, 1, H, d); pools
    (NB, BS, K, d); kp_pool (NB, BS); block_tables (B, MAXB)."""
    k, v, kp = gather_paged_kv(k_pool, v_pool, kp_pool, block_tables)
    return flash_decode_ref(q, k, v, q_pos, kp, causal=causal, window=window,
                            softcap=softcap)


def flash_attention_ref(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                        softcap=None, chunk: int = 1024):
    """Multi-token flash-attention forward, plain PyTorch.

    q: (B, S, H, d); k, v: (B, T, K, d) with H % K == 0 (head h reads kv
    head h // (H // K), the reference's ``_expand_kv`` grouping);
    q_pos: (B, S); k_pos: (B, T) with -1 = empty.  Online softmax over
    key chunks of ``chunk``; unlike the reference, the last chunk may be
    ragged, so any T works.  Returns (B, S, H, d) in q's dtype."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"q heads {H} not grouped over kv heads {K}")
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    q32 = q.float()
    scale = 1.0 / math.sqrt(d)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, d), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, chunk):
        kc, vc = k[:, t0:t0 + chunk], v[:, t0:t0 + chunk]
        s = torch.einsum("bshd,bthd->bhst", q32, kc.float()) * scale
        s = _cap(s, softcap)
        ok = _valid(q_pos, k_pos[:, t0:t0 + chunk], causal, window)[:, None]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(v.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
