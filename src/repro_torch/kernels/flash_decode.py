"""Wrapper of the grouped split-KV flash-decode CUDA kernel
(``csrc/flash_decode.cu``; replaces the TPU kernel
``repro.kernels.flash_decode.flash_decode_pallas``).

``flash_decode`` launches the kernel on CUDA tensors and raises on
anything else; ``kernels.ops`` sends CPU tensors to the plain version
``kernels.ref.flash_decode_ref``.  ``flash_decode.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
MAX_CHUNK = 512
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.library("flash_decode").repro_flash_decode_bf16
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        _fn = f
    return _fn


def split_chunk(B: int, K: int, T: int, sms: int) -> int:
    """Keys per split: enough splits that B x K x splits fills the card
    about twice over, in multiples of 32 keys, at most ``MAX_CHUNK``."""
    per = -(-T * B * K // (2 * sms))
    return max(32, min(MAX_CHUNK, -(-per // 32) * 32))


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"flash_decode: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def flash_decode(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                 softcap=None):
    """q: (B, 1, H, d) bf16; k, v: (B, T, K, d) bf16; q_pos: (B,) int32;
    k_pos: (B, T) int32 with -1 = empty.  Returns (B, 1, H, d) bf16."""
    if q.device.type != "cuda":
        raise ValueError("flash_decode launches a CUDA kernel: tensors must "
                         f"be on a CUDA device, got {q.device}")
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    if S != 1 or H % K or d not in HEAD_DIMS or H // K not in GROUPS:
        raise ValueError(f"flash_decode takes S=1, d in {HEAD_DIMS} and "
                         f"H/K in {GROUPS} (got S={S}, H={H}, K={K}, d={d})")
    dev, bf16, i32 = q.device, torch.bfloat16, torch.int32
    _check("q", q, bf16, (B, 1, H, d), dev)
    _check("k", k, bf16, (B, T, K, d), dev)
    _check("v", v, bf16, (B, T, K, d), dev)
    _check("q_pos", q_pos, i32, (B,), dev)
    _check("k_pos", k_pos, i32, (B, T), dev)
    window = (1 << 30) if window is None else int(window)
    if window <= 0 or (softcap is not None and softcap <= 0):
        raise ValueError(f"window must be > 0 and softcap > 0 "
                         f"(got {window}, {softcap})")
    G = H // K
    chunk = split_chunk(
        B, K, T, torch.cuda.get_device_properties(dev).multi_processor_count)
    splits = -(-T // chunk)
    o_part = torch.empty((B, K, splits, G, d), dtype=torch.float32, device=dev)
    m_part = torch.empty((B, K, splits, G), dtype=torch.float32, device=dev)
    l_part = torch.empty((B, K, splits, G), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), out.data_ptr(), B, T, K, G, d, chunk, splits,
            int(causal), window, float(softcap or 0.0),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
