"""Transformer layers of the dense decoder, on tensors.

Ports of ``repro.models.layers`` with the reference's layouts at every
public function (q is (B, S, H, d), ``wq`` is (D, H, hd)) and its
rounding points: statistics and scores in f32, data in the input dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import Activation, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.quant import dequantize_kv
from repro_torch.kernels.ref import gather_paged_kv  # noqa: F401 (re-export)

NEG_INF = -1e30
CHUNKED_THRESHOLD = 2048     # keys above which prefill takes the flash path


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with f32 statistics but a multiply in the input dtype, as
    ``repro.models.layers.rms_norm`` (not the f32 multiply of the
    reference's RMSNorm kernel oracle)."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, d); positions: (B, S).  bf16 x times f32 cos/sin
    promotes to f32 and the result is cast back; pad positions (-1) are
    rotated by the same formula."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = (positions[..., None].float() * freqs)[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _causal_mask(q_pos, k_pos):
    """q_pos: (B, S); k_pos: (B, T) -> bool (B, S, T): live, not ahead."""
    kp = k_pos[:, None, :]
    return (kp >= 0) & (q_pos[:, :, None] >= kp)


def _attend_dense(q, k, v, mask, softcap):
    """q: (B,S,H,hd); k, v: (B,T,H,hd); mask: (B,S,T).  Plain torch, as the
    reference's jnp: f32 scores and softmax, p cast to q's dtype."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", p, v)


def attention(p: Dict, x, cfg: ModelConfig, *, positions,
              cache_kv: Optional[Tuple] = None):
    """Causal global self-attention.  x: (B, S, D); positions: (B, S).

    Without a cache (prefill) K/V are projected from x; more keys than
    ``CHUNKED_THRESHOLD`` take the flash path (the CUDA kernel on the
    card), fewer the dense plain path, as in the reference.  With
    ``cache_kv = (k, v, k_pos)`` (decode; the new K/V already written)
    attention reads the cache at the native kv-head count through the
    decode kernel.  With ``cache_kv = (k, v, k_pos, k_scale, v_scale)``
    (an int8 or fp8 cache with f32 scales per (token, kv head)) one query
    token takes the quantized decode kernel, and more dequantize the cache
    to the compute dtype first, as in the reference.  With ``cache_kv =
    (k_pool, v_pool, kp_pool, block_tables)`` (paged; the new K/V already
    written) one query token takes the paged decode kernel, and more (a
    suffix prefill) the flash path over ``gather_paged_kv``'s contiguous
    view, whatever the length, as in the reference.

    Returns (y (B, S, D), (k, v)): the projected, rotated K/V of the
    no-cache path (what prefill stores), else None."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
    kv = k_scale = v_scale = None
    if cache_kv is None:
        k, v = project_kv(p, x, cfg, positions)
        kv, k_pos = (k, v), positions
    elif len(cache_kv) == 3:
        k, v, k_pos = cache_kv
    elif len(cache_kv) == 5:
        k, v, k_pos, k_scale, v_scale = cache_kv
        if q.shape[1] > 1:
            k = dequantize_kv(k, k_scale).to(q.dtype)
            v = dequantize_kv(v, v_scale).to(q.dtype)
            k_scale = v_scale = None
    elif q.shape[1] == 1:
        k_pool, v_pool, kp_pool, bt = cache_kv
        out = ops.flash_decode_paged(q, k_pool, v_pool, positions, kp_pool,
                                     bt, softcap=cfg.logit_softcap)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), None
    else:
        k, v, k_pos = gather_paged_kv(*cache_kv)
    T = k.shape[1]
    if cache_kv is not None or T > CHUNKED_THRESHOLD:
        out = ops.flash_attention(q, k, v, positions, k_pos,
                                  softcap=cfg.logit_softcap, k_scale=k_scale,
                                  v_scale=v_scale)
    else:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
        out = _attend_dense(q, k, v, _causal_mask(positions, k_pos),
                            cfg.logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), kv


def project_kv(p: Dict, x, cfg: ModelConfig, positions):
    """Project (and rotate) K/V: (B, S, K, hd) each."""
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if cfg.rope_theta > 0:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


_ACT = {Activation.SWIGLU: F.silu,
        Activation.GEGLU: lambda h: F.gelu(h, approximate="tanh"),
        Activation.GELU: lambda h: F.gelu(h, approximate="tanh")}


def mlp(p: Dict, x, cfg: ModelConfig):
    h = _ACT[cfg.activation](x @ p["w1"])
    if "w3" in p:
        h = h * (x @ p["w3"])
    return h @ p["w2"]


def embed(p: Dict, tokens, cfg: ModelConfig):
    """Gemma scales by sqrt(d_model) rounded to the table's dtype first,
    as the reference does."""
    x = p["embedding"][tokens]
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(p: Dict, x, cfg: ModelConfig):
    """Logits in the activation dtype.  The tied table is read with x
    scaled by d_model ** -0.5 rounded to that dtype, as in the reference."""
    if cfg.tie_embeddings:
        s = torch.tensor(cfg.d_model ** -0.5, dtype=x.dtype, device=x.device)
        logits = torch.einsum("bsd,vd->bsv", x * s, p["embedding"])
    else:
        logits = x @ p["unembed"]
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
