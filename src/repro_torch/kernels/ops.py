"""Attention dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel, which launches or
raises; a CPU tensor goes to the kernel's plain PyTorch version in
``kernels.ref``.  There is no override and no fallback between the two.
"""
from __future__ import annotations

from repro_torch.kernels import quant as _quant
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_quant
from repro_torch.kernels.flash_decode import \
    flash_decode_paged as _flash_decode_paged


def _on_cuda(t) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def flash_attention(q, k, v, q_pos, k_pos, *, softcap=None, k_scale=None,
                    v_scale=None):
    """Causal global attention.  q: (B, S, H, d); k, v: (B, T, K, d) at
    the native kv-head count (H % K == 0); q_pos: (B, S); k_pos: (B, T)
    with -1 = empty.

    One query token per row (S == 1, the decode tick) takes the grouped
    split-KV decode; longer queries the flash forward.  With ``k_scale``,
    ``v_scale`` (B, T, K) k and v are an int8 or fp8 cache, dequantized
    inside the quantized decode; only S == 1 takes scales (a multi-token
    caller dequantizes first, as in the reference)."""
    if k_scale is not None:
        if q.shape[1] != 1:
            raise NotImplementedError(
                "quantized K/V reach flash_attention only on the S == 1 "
                "decode path; dequantize before multi-token attention")
        if _on_cuda(q):
            return flash_decode_quant(q, k, v, q_pos.reshape(-1), k_pos,
                                      k_scale, v_scale, softcap=softcap)
        return _quant.flash_decode_quant_ref(q, k, v, q_pos, k_pos, k_scale,
                                             v_scale, softcap=softcap)
    if q.shape[1] == 1:
        if _on_cuda(q):
            return flash_decode(q, k, v, q_pos.reshape(-1), k_pos,
                                softcap=softcap)
        return _ref.flash_decode_ref(q, k, v, q_pos, k_pos, softcap=softcap)
    if _on_cuda(q):
        return flash_attention_fwd(q, k, v, q_pos, k_pos, softcap=softcap)
    return _ref.flash_attention_ref(q, k, v, q_pos, k_pos, softcap=softcap)


def flash_decode_paged(q, k_pool, v_pool, q_pos, kp_pool, block_tables, *,
                       softcap=None):
    """Causal decode through block tables.  q: (B, 1, H, d); k_pool,
    v_pool: (NB, BS, K, d), the global pool; q_pos: (B,) or (B, 1);
    kp_pool: (NB, BS) with -1 = unwritten; block_tables: (B, MAXB) with
    -1 = unmapped."""
    if _on_cuda(q):
        return _flash_decode_paged(q, k_pool, v_pool, q_pos.reshape(-1),
                                   kp_pool, block_tables, softcap=softcap)
    return _ref.flash_decode_paged_ref(q, k_pool, v_pool, q_pos, kp_pool,
                                       block_tables, softcap=softcap)
