"""Wrappers of the grouped split-KV flash-decode CUDA kernel
(``csrc/flash_decode.cu``): contiguous, paged and quantized.

``flash_decode`` replaces the TPU kernel
``repro.kernels.flash_decode.flash_decode_pallas``; ``flash_decode_paged``
replaces ``flash_decode_paged``, the same decode read through per-row
block tables into a global block pool; ``flash_decode_quant`` replaces
``flash_decode_pallas_quant``, the contiguous decode over an int8 or fp8
cache with f32 scales per (token, kv head).  Each launches its kernel on
CUDA tensors and raises on anything else; ``kernels.ops`` sends CPU
tensors to the plain versions ``kernels.ref.flash_decode_ref``,
``flash_decode_paged_ref`` and ``kernels.quant.flash_decode_quant_ref``.
Each wrapper's ``.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
MAX_CHUNK = 512
_ARGTYPES = {  # pointers, ints, then softcap and the stream
    "repro_flash_decode_bf16": (9, 9),
    "repro_flash_decode_paged_bf16": (10, 10),
    "repro_flash_decode_quant_int8": (11, 9),
    "repro_flash_decode_quant_fp8": (11, 9)}
_QUANT_ENTRY = {torch.int8: "repro_flash_decode_quant_int8",
                torch.float8_e4m3fn: "repro_flash_decode_quant_fp8"}
_fns = {}


def _kernel(name="repro_flash_decode_bf16"):
    if name not in _fns:
        f = getattr(_build.library("flash_decode"), name)
        ptrs, ints = _ARGTYPES[name]
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [
            ctypes.c_float, ctypes.c_void_p]
        _fns[name] = f
    return _fns[name]


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
    window, chunk, splits, parts, out = _launch_args(q, K, T, window, softcap)
    with torch.cuda.device(dev):
        rc = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), *(t.data_ptr() for t in parts),
            out.data_ptr(), B, T, K, H // K, d, chunk, splits, int(causal),
            window, float(softcap or 0.0),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    flash_decode.launches += 1
    return out


def flash_decode_quant(q, kq, vq, q_pos, k_pos, k_scale, v_scale, *,
                       causal=True, window=None, softcap=None):
    """q: (B, 1, H, d) bf16; kq, vq: (B, T, K, d) int8 or float8_e4m3fn
    (the same dtype); k_pos: (B, T) int32 with -1 = empty; k_scale,
    v_scale: (B, T, K) f32, one scale per (token, kv head).  Returns
    (B, 1, H, d) bf16.  Same split length as ``flash_decode``, so with
    every scale 1 it is bit-equal to ``flash_decode`` on kq, vq widened to
    bf16."""
    if q.device.type != "cuda":
        raise ValueError("flash_decode_quant launches a CUDA kernel: tensors "
                         f"must be on a CUDA device, got {q.device}")
    B, S, H, d = q.shape
    T, K = kq.shape[1], kq.shape[2]
    if S != 1 or H % K or d not in HEAD_DIMS or H // K not in GROUPS:
        raise ValueError(f"flash_decode_quant takes S=1, d in {HEAD_DIMS} "
                         f"and H/K in {GROUPS} (got S={S}, H={H}, K={K}, "
                         f"d={d})")
    if kq.dtype not in _QUANT_ENTRY:
        raise ValueError(f"flash_decode_quant: kq must be int8 or "
                         f"float8_e4m3fn, got {kq.dtype}")
    dev, i32, f32 = q.device, torch.int32, torch.float32
    _check("q", q, torch.bfloat16, (B, 1, H, d), dev)
    _check("kq", kq, kq.dtype, (B, T, K, d), dev)
    _check("vq", vq, kq.dtype, (B, T, K, d), dev)
    _check("q_pos", q_pos, i32, (B,), dev)
    _check("k_pos", k_pos, i32, (B, T), dev)
    _check("k_scale", k_scale, f32, (B, T, K), dev)
    _check("v_scale", v_scale, f32, (B, T, K), dev)
    window, chunk, splits, parts, out = _launch_args(q, K, T, window, softcap)
    with torch.cuda.device(dev):
        rc = _kernel(_QUANT_ENTRY[kq.dtype])(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            *(t.data_ptr() for t in parts), out.data_ptr(), B, T, K, H // K,
            d, chunk, splits, int(causal), window, float(softcap or 0.0),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(
            f"flash_decode_quant kernel launch failed: cudaError {rc}")
    flash_decode_quant.launches += 1
    return out


def flash_decode_paged(q, k_pool, v_pool, q_pos, kp_pool, block_tables, *,
                       causal=True, window=None, softcap=None):
    """q: (B, 1, H, d) bf16; k_pool, v_pool: (NB, BS, K, d) bf16, the
    global block pool; q_pos: (B,) int32; kp_pool: (NB, BS) int32 with -1
    = unwritten; block_tables: (B, MAXB) int32 with -1 = unmapped, entry j
    holding row positions [j BS, (j + 1) BS); every other entry must be
    below NB (the kernel reads through the table unchecked; the model's
    ``paged_targets`` checks it).  Returns (B, 1, H, d) bf16.

    The split length is the contiguous kernel's at T = MAXB x BS, so the
    output is bit-equal to ``flash_decode`` on ``gather_paged_kv``'s view."""
    if q.device.type != "cuda":
        raise ValueError("flash_decode_paged launches a CUDA kernel: tensors "
                         f"must be on a CUDA device, got {q.device}")
    B, S, H, d = q.shape
    NB, BS, K = k_pool.shape[:3]
    MAXB = block_tables.shape[1]
    if S != 1 or H % K or d not in HEAD_DIMS or H // K not in GROUPS:
        raise ValueError(f"flash_decode_paged takes S=1, d in {HEAD_DIMS} "
                         f"and H/K in {GROUPS} (got S={S}, H={H}, K={K}, "
                         f"d={d})")
    dev, bf16, i32 = q.device, torch.bfloat16, torch.int32
    _check("q", q, bf16, (B, 1, H, d), dev)
    _check("k_pool", k_pool, bf16, (NB, BS, K, d), dev)
    _check("v_pool", v_pool, bf16, (NB, BS, K, d), dev)
    _check("q_pos", q_pos, i32, (B,), dev)
    _check("kp_pool", kp_pool, i32, (NB, BS), dev)
    _check("block_tables", block_tables, i32, (B, MAXB), dev)
    window, chunk, splits, parts, out = _launch_args(q, K, MAXB * BS, window,
                                                     softcap)
    with torch.cuda.device(dev):
        rc = _kernel("repro_flash_decode_paged_bf16")(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            q_pos.data_ptr(), kp_pool.data_ptr(), block_tables.data_ptr(),
            *(t.data_ptr() for t in parts), out.data_ptr(), B, MAXB, BS, K,
            H // K, d, chunk, splits, int(causal), window,
            float(softcap or 0.0),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(
            f"flash_decode_paged kernel launch failed: cudaError {rc}")
    flash_decode_paged.launches += 1
    return out


def _launch_args(q, K, T, window, softcap):
    """Window, split length and count, the f32 partials' scratch and the
    output of a decode over T keys per row."""
    window = (1 << 30) if window is None else int(window)
    if window <= 0 or (softcap is not None and softcap <= 0):
        raise ValueError(f"window must be > 0 and softcap > 0 "
                         f"(got {window}, {softcap})")
    B, _, H, d = q.shape
    G, dev = H // K, q.device
    chunk = split_chunk(
        B, K, T, torch.cuda.get_device_properties(dev).multi_processor_count)
    splits = -(-T // chunk)
    o_part = torch.empty((B, K, splits, G, d), dtype=torch.float32, device=dev)
    m_part = torch.empty((B, K, splits, G), dtype=torch.float32, device=dev)
    l_part = torch.empty((B, K, splits, G), dtype=torch.float32, device=dev)
    return window, chunk, splits, (o_part, m_part, l_part), \
        torch.empty_like(q)


flash_decode.launches = 0
flash_decode_paged.launches = 0
flash_decode_quant.launches = 0
