"""Wrapper of the multi-token flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``; replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``).

``flash_attention_fwd`` launches the kernel on CUDA tensors and raises on
anything else; ``kernels.ops`` sends CPU tensors to the plain version
``kernels.ref.flash_attention_ref``.  ``flash_attention_fwd.launches``
counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import HEAD_DIMS, _check

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.library("flash_attention")
        lib.repro_flash_attention_fwd_bf16.restype = ctypes.c_int
        lib.repro_flash_attention_fwd_bf16.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        lib.repro_flash_attention_key_tile.restype = ctypes.c_int
        lib.repro_flash_attention_key_tile.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def flash_attention_fwd(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                        softcap=None):
    """q: (B, S, H, d) bf16; k, v: (B, T, K, d) bf16 at the native kv-head
    count (H % K == 0); q_pos: (B, S), k_pos: (B, T) int32 with -1 =
    empty.  Returns (B, S, H, d) bf16."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fwd launches a CUDA kernel: tensors "
                         f"must be on a CUDA device, got {q.device}")
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    if H % K or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd takes H % K == 0 and d in "
                         f"{HEAD_DIMS} (got H={H}, K={K}, d={d})")
    dev, bf16, i32 = q.device, torch.bfloat16, torch.int32
    _check("q", q, bf16, (B, S, H, d), dev)
    _check("k", k, bf16, (B, T, K, d), dev)
    _check("v", v, bf16, (B, T, K, d), dev)
    _check("q_pos", q_pos, i32, (B, S), dev)
    _check("k_pos", k_pos, i32, (B, T), dev)
    window = (1 << 30) if window is None else int(window)
    if window <= 0 or (softcap is not None and softcap <= 0):
        raise ValueError(f"window must be > 0 and softcap > 0 "
                         f"(got {window}, {softcap})")
    lib = _kernel()
    tiles = -(-T // lib.repro_flash_attention_key_tile(d))
    tile_stats = torch.empty((B, tiles, 2), dtype=i32, device=dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = lib.repro_flash_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), tile_stats.data_ptr(), out.data_ptr(), B, S, T,
            H, K, d, int(causal), window, float(softcap or 0.0),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(
            f"flash_attention_fwd kernel launch failed: cudaError {rc}")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
