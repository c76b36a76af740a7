"""Quantized KV cache: quantize-on-write helpers and the plain version of
the quantized decode (port of ``repro.kernels.quant``).

K/V rows are stored in int8 or fp8 (e4m3) with one float32 scale per
(token, head) vector, dequantized inside the decode kernel, so the
decode reads about half the bytes of a bf16 cache while its math stays
f32.  Scale layout: k, v (B, T, K, hd) quantized; k_scale, v_scale
(B, T, K) f32 -- the data's leading axes with head_dim dropped.

Grids, bit-equal to the reference's:
  int8   scale = amax / 127,  q = clip(round(x / scale), -127, 127)
  fp8    scale = amax / 448,  q = float8_e4m3fn(x / scale), nearest-even
with amax floored at 1e-30, true divisions (not multiplies by a
reciprocal) for the scale and for x / scale, and ``torch.round``'s
half-to-even, as ``jnp.round``.  The scale's divisor is a tensor: PyTorch
on CUDA turns a division by a Python scalar into a multiply by its
reciprocal, which is one ulp off the division in a few percent of
vectors, so the card would store other scales than the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ref import flash_decode_ref

KV_DTYPES = ("bf16", "int8", "fp8")
QUANTIZED_KV_DTYPES = ("int8", "fp8")

_STORE = {"bf16": torch.bfloat16, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}
_INT8_MAX = 127.0
_FP8_MAX = 448.0
_SCALE_FLOOR = 1e-30


def kv_cache_dtype(kv_dtype: str) -> torch.dtype:
    """Storage dtype of the cache's k/v leaves for ``kv_dtype``."""
    if kv_dtype not in _STORE:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected one of "
                         f"{KV_DTYPES}")
    return _STORE[kv_dtype]


def kv_dtype_of(store: torch.dtype) -> str:
    """The ``kv_dtype`` name of a cache's k/v storage dtype."""
    for name, dt in _STORE.items():
        if dt == store:
            return name
    raise ValueError(f"{store} is not a KV cache storage dtype")


def kv_bytes_per_vector(head_dim: int, kv_dtype: str) -> int:
    """Device bytes one (token, head) K or V vector occupies, its scale
    included."""
    if kv_dtype == "bf16":
        return head_dim * 2
    return head_dim * kv_cache_dtype(kv_dtype).itemsize + 4


def _amax(x):
    return torch.clamp(x.float().abs().amax(-1), min=_SCALE_FLOOR)


def _scale(amax, grid_max: float):
    """amax / grid_max, a true division on every device."""
    return amax / torch.full_like(amax, grid_max)


def quantize_kv(x, kv_dtype: str):
    """Quantize K/V vectors ``x (..., head_dim)``.  Returns ``(q, scale)``:
    q of ``kv_cache_dtype(kv_dtype)``, scale (...,) float32."""
    if kv_dtype not in QUANTIZED_KV_DTYPES:
        raise ValueError(f"quantize_kv: kv_dtype {kv_dtype!r} is not a "
                         f"quantized dtype {QUANTIZED_KV_DTYPES}")
    xf = x.float()
    if kv_dtype == "int8":
        scale = _scale(_amax(xf), _INT8_MAX)
        q = torch.clamp(torch.round(xf / scale[..., None]), -_INT8_MAX,
                        _INT8_MAX).to(torch.int8)
        return q, scale
    scale = _scale(_amax(xf), _FP8_MAX)
    return (xf / scale[..., None]).to(torch.float8_e4m3fn), scale


def dequantize_kv(q, scale):
    """Inverse of :func:`quantize_kv`, float32 out."""
    return q.float() * scale[..., None].float()


def quant_error_bound(x, kv_dtype: str):
    """Per-vector bound on |x - dequantize(quantize(x))|: half the int8
    step (amax / 254), or 2^-4 relative for e4m3's 3 mantissa bits."""
    if kv_dtype == "int8":
        return _amax(x) / (2.0 * _INT8_MAX)
    return _amax(x) * 2.0 ** -4


def flash_decode_quant_ref(q, kq, vq, q_pos, k_pos, k_scale, v_scale, *,
                           causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           splits: int = 1):
    """Plain version of the quantized decode: dequantize to f32, then
    ``flash_decode_ref``.  q (B, 1, H, d); kq, vq (B, T, K, d) int8/fp8;
    k_scale, v_scale (B, T, K) f32.  Returns (B, 1, H, d) in q's dtype."""
    return flash_decode_ref(q, dequantize_kv(kq, k_scale),
                            dequantize_kv(vq, v_scale), q_pos, k_pos,
                            causal=causal, window=window, softcap=softcap,
                            splits=splits)
