"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device   the card's name and power limit, torch and CUDA versions;
  2. build    nvcc builds the CUDA kernels from src/repro_torch/kernels/csrc;
  3. kernels  each kernel against its plain PyTorch version on seeded inputs
              at the serving shapes (and GQA, ragged, padded, window and
              softcap variants), with negative controls (a dropped split, a
              dropped key tile, a combine without rescaling) that the same
              tolerance must reject, then timed beside its plain version,
              one PyTorch library call and its bound;
  4. model    gemma-2b at full width, seeded weights: a 3072-token prompt
              right-padded to 3200 is prefilled (flash kernel), one token is
              decoded (decode kernel), and the decode logits are held against
              a prefill over prompt + token;
  5. serving  Engine(slots=4, prefill_len=3072, cache_len=3328) serves 6
              greedy requests; the kernels' launch counts must match the path,
              co-batched tokens must equal each request run alone, and
              TTFT / TPOT / decode tok/s are printed;
  6. paged    the same engine with block_size=16 serves 8 greedy requests,
              four of them sharing a 2048-token prompt: exact prefix-cache
              stats and launch counts (paged decode per tick, flash forward
              per join), no block held after the drain, tokens equal to the
              contiguous engine's on the same mix; then a request on a
              recycled block must equal the same request on a fresh engine.

  7. quant    the contiguous engine with kv_dtype int8, then fp8, serves the
              mix of phase 5: the quantized decode kernel 18 x ticks and the
              bf16 one never, byte-true KV accounting, a tick profile; tokens
              are compared with the bf16 engine's for information only.  Then
              bf16, int8 and fp8 engines serve the mix in turns (bf16, int8,
              fp8, fp8, int8, bf16) for TTFT / TPOT / decode tok/s side by
              side.

The kernel phase also holds the paged decode (flash_decode_paged) against
its plain version on pools read through shuffled tables (shared blocks, -1
entries, block sizes 8/16/64), requires it to be bit-equal to flash_decode
on the gathered view, and rejects two paged negative controls (an unmapped
entry read as block 0, a recycled block's stale positions left live).  It
holds the quantized decode (flash_decode_quant, int8 and fp8) against its
plain version on the decode cases, requires it with every scale 1 to be
bit-equal to flash_decode on the values widened to bf16, and rejects three
scale faults (every scale read as 1, key t+1's scales for key t, v_scale
ignored).  The model phase also checks the quantized cache at full width:
prefill logits bit-equal to bf16's, the decode step's cache write bit-equal
to quantize_kv on the CPU of the K/V it projected, in every layer, and its
logits within a bound of the same step on the CPU, the bound derived from
the bf16 step's card-vs-CPU difference in the same run.

Exits nonzero, uncaught, on any failed check, and when no CUDA device is
present.  The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
BF16_FLOPS = 989e12                # H100 SXM dense bf16, published
INT8_OPS = 1979e12                 # H100 SXM dense int8 and fp8, published
# Kernel vs plain, bf16 out, N(0,1) in: |out - ref| <= KERNEL_RTOL |ref| +
# min(KERNEL_ATOL, KERNEL_ATOL_RMS x RMS of the ref's head vector).  The
# relative term covers one bf16 ulp of rounding (2^-7); the RMS term scales
# the absolute slack to the row, since a row over ~3000 keys has outputs of
# RMS ~0.03, where a flat 1e-2 would pass a kernel that dropped a split.
KERNEL_RTOL = KERNEL_ATOL = 1e-2
KERNEL_ATOL_RMS = 0.1
KERNEL_TOL = (f"{KERNEL_RTOL}|ref| + min({KERNEL_ATOL}, "
              f"{KERNEL_ATOL_RMS} rms_row(ref))")
MODEL_ATOL = MODEL_RTOL = 5e-2     # decode vs prefill logits, 18 bf16 layers
MARGIN_TOL = 5e-2                  # top-2 logit margin below which ties may flip
SERVE_PROMPTS = (5, 17, 64, 300, 1000, 3072)
# paged serving: a shared 2048-token prompt ("sys", 128 blocks of 16) with
# its own tail, or unrelated tokens, in this order
PAGED_MIX = (("sys", 1000), ("sys", 5), (None, 17), (None, 64), ("sys", 300),
             (None, 3072), ("sys", 17), (None, 5))
SYS_LEN = 2048
QUANT_KV = ("int8", "fp8")
# The quantized decode step on the card against the same step on the CPU:
# within QUANT_MODEL_FACTOR x the bf16 step's card-vs-CPU max |delta logit|
# in the same run.  Both differences come from the same sources (cuBLAS vs
# CPU reduction order through 18 layers, kernel vs plain attention order),
# and the max over 256000 bf16 logits moves in steps of one ulp of the
# logit it lands on, so the factor lets it land two binades higher.
QUANT_MODEL_FACTOR = 4.0
DECODE_CASES = [  # (name, (B, H, K, d, T, row lengths), kw)
    ("engine B4 H8 K1 d256 T3328", (4, 8, 1, 256, 3328, [3328, 1000, 0, 17]),
     {}),
    ("ragged T3001 + ring holes", (4, 8, 1, 256, 3001, [3001, 2999, 5, 0]),
     {"holes": 64}),
    ("qwen3-32b B8 H64 K8 d128 T4096",
     (8, 64, 8, 128, 4096, [4096, 3000, 2048, 1024, 513, 100, 1, 0]), {}),
    ("window 64", (4, 8, 1, 256, 1024, [1024, 700, 40, 0]), {"window": 64}),
    ("softcap 30 MHA d128", (2, 4, 4, 128, 777, [777, 300]),
     {"softcap": 30.0}),
    ("GQA G2 d64", (3, 8, 4, 64, 515, [515, 200, 0]), {}),
]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(smi)
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    out = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s into {out}")
    for line in _build.compiler_report().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


# ---------------------------------------------------------------------------
def time_ms(fn, iters=20, flush_bytes=128 << 20):
    """Device ms per call: ``fn`` is captured once into a CUDA graph and
    each replay is timed with CUDA events after an L2 flush (the serving
    path meets every layer's K/V cold).  The graph keeps host overhead
    out; ``eager_ms`` measures it."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _events_ms(graph.replay, flush, iters)


def eager_ms(fn, iters=20, flush_bytes=128 << 20):
    """Ms per eager call, host overhead of the wrapper included."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    return _events_ms(fn, flush, iters)


def _events_ms(fn, flush, iters):
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def _mixed_kpos(B, T, lengths, holes=0, gen=None):
    pos = torch.arange(T, dtype=torch.int32).expand(B, T).clone()
    for b, n in enumerate(lengths):
        pos[b, n:] = -1
    if holes:
        idx = torch.randint(0, T, (B, holes), generator=gen)
        pos.scatter_(1, idx, -1)
    return pos


def _close(out, ref):
    """(within the kernel tolerance, max abs error, worst error / limit)."""
    o, r = out.float(), ref.float()
    rms = r.pow(2).mean(-1, keepdim=True).sqrt()
    tol = KERNEL_RTOL * r.abs() + torch.clamp(KERNEL_ATOL_RMS * rms,
                                              max=KERNEL_ATOL)
    diff = (o - r).abs()
    return (bool((diff <= tol).all()), float(diff.max()),
            float((diff / tol.clamp_min(1e-30)).max()))


def _reject(name, out, ref):
    """Negative control: a deliberately wrong result must fail the check."""
    ok, err, worst = _close(out, ref)
    print(f"negative control [{name}]: max_abs_err {err:.3e}, worst "
          f"err/limit {worst:.2f} -> {'FAIL: passed' if ok else 'rejected'}")
    check(not ok, f"the kernel tolerance accepts a wrong result ({name})")


def _decode_inputs(B, H, K, d, T, lengths, holes=0, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, H, d, generator=g).bfloat16()
    k = torch.randn(B, T, K, d, generator=g).bfloat16()
    v = torch.randn(B, T, K, d, generator=g).bfloat16()
    k_pos = _mixed_kpos(B, T, lengths, holes, g)
    q_pos = torch.tensor([max(n, 1) for n in lengths], dtype=torch.int32)
    return [t.cuda() for t in (q, k, v, q_pos, k_pos)]


def _fwd_inputs(B, S, H, K, d, T, pad_from=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, d, generator=g).bfloat16()
    k = torch.randn(B, T, K, d, generator=g).bfloat16()
    v = torch.randn(B, T, K, d, generator=g).bfloat16()
    q_pos = torch.arange(S, dtype=torch.int32).expand(B, S).clone()
    k_pos = torch.arange(T, dtype=torch.int32).expand(B, T).clone()
    if pad_from is not None:            # right-padded last row: -1 positions
        q_pos[-1, pad_from:] = -1
        k_pos[-1, pad_from:] = -1
    return [t.cuda() for t in (q, k, v, q_pos, k_pos)]


def _valid_pairs(q_pos, k_pos, causal, window):
    qp, kp = q_pos[:, :, None].long(), k_pos[:, None, :].long()
    ok = kp >= 0
    if causal:
        ok = ok & (qp >= kp)
    if window is not None:
        ok = ok & ((qp - kp) < window)
    return ok


def phase_kernels():
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import flash_decode, split_chunk
    F = torch.nn.functional
    results = {}

    # --- flash decode -----------------------------------------------------
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (B, H, K, d, T, lens), kw in DECODE_CASES:
        kw = dict(kw)
        holes = kw.pop("holes", 0)
        q, k, v, qp, kp = _decode_inputs(B, H, K, d, T, lens, holes)
        want = ref.flash_decode_ref(q, k, v, qp, kp, **kw)
        dead = ~_valid_pairs(qp[:, None], kp, True, kw.get("window")).any(-1)[:, 0]
        got = flash_decode(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        ok, err, worst = _close(got, want)
        print(f"kernel flash_decode [{name}] {split_chunk(B, K, T, sms)} keys "
              f"per split: max_abs_err {err:.3e}, worst err/limit {worst:.3f} "
              f"(limit {KERNEL_TOL}) {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_decode disagrees with plain: {name}")
        check(bool((got[dead] == 0).all()),
              f"flash_decode: a row with no valid key must be zeros ({name})")
        if name.startswith("engine"):
            main = (q, k, v, qp, kp, err)

    q, k, v, qp, kp, err = main
    B, _, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    want = ref.flash_decode_ref(q, k, v, qp, kp)
    # The kernel with one split of row 0 masked off, as if it dropped it.
    c = split_chunk(B, K, T, sms)
    kp_drop = kp.clone()
    kp_drop[0, 16 * c:17 * c] = -1
    _reject(f"flash_decode drops split 16 ({c} keys) of row 0",
            flash_decode(q, k, v, qp, kp_drop), want)
    # The kernel's split partials combined without the max rescaling.
    o_p, _, l_p = ref.flash_decode_partials(q, k, v, qp, kp,
                                            splits=-(-T // c))
    no_alpha = o_p.sum(2) / l_p.sum(2).clamp_min(1e-30)[..., None]
    _reject("combine without alpha", no_alpha.reshape(q.shape).bfloat16(),
            want)
    live = int((kp >= 0).sum())
    nbytes = (q.numel() * 2 + live * K * d * 2 * 2 + kp.numel() * 4
              + qp.numel() * 4 + q.numel() * 2)
    flops = 4 * H * live * d
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (kp >= 0)[:, None, None, :]
    results["flash_decode"] = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:129",
        "max_abs_err": err,
        "ms": time_ms(lambda: flash_decode(q, k, v, qp, kp)),
        "eager_ms": eager_ms(lambda: flash_decode(q, k, v, qp, kp)),
        "plain_ms": time_ms(lambda: ref.flash_decode_ref(q, k, v, qp, kp)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / BF16_FLOPS else "operations",
        "shape": f"B{B} H{H} K{K} d{d} T{T}, {live} live keys",
    }

    # --- flash attention forward -------------------------------------------
    cases = [
        ("engine prompt B1 S3072 H8 K1 d256 causal", (1, 3072, 8, 1, 256, 3072, None), {}),
        ("ragged S=T=3000", (1, 3000, 8, 1, 256, 3000, None), {}),
        ("-1 pad rows B2 S640", (2, 640, 8, 1, 256, 640, 500), {}),
        ("window 128", (1, 1000, 8, 1, 256, 1000, None), {"window": 128}),
        ("softcap 20", (1, 700, 8, 1, 256, 700, None), {"softcap": 20.0}),
        ("qwen3-32b H64 K8 d128", (1, 1100, 64, 8, 128, 1100, None), {}),
        ("MHA d64", (2, 300, 4, 4, 64, 300, 250), {}),
    ]
    for name, (B, S, H, K, d, T, pad), kw in cases:
        q, k, v, qp, kp = _fwd_inputs(B, S, H, K, d, T, pad)
        want = ref.flash_attention_ref(q, k, v, qp, kp, **kw)
        got = flash_attention_fwd(q, k, v, qp, kp, **kw)
        torch.cuda.synchronize()
        ok, err, worst = _close(got, want)
        print(f"kernel flash_attention_fwd [{name}]: max_abs_err {err:.3e}, "
              f"worst err/limit {worst:.3f} (limit {KERNEL_TOL}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention_fwd disagrees with plain: {name}")
        if name.startswith("engine"):
            main = (q, k, v, qp, kp, err, want)

    q, k, v, qp, kp, err, want = main
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    # The kernel with one 32-key tile masked off, as if it skipped it.
    kp_drop = kp.clone()
    kp_drop[:, 2048:2080] = -1
    _reject("flash_attention_fwd drops keys 2048-2079",
            flash_attention_fwd(q, k, v, qp, kp_drop), want)
    pairs = int(_valid_pairs(qp, kp, True, None).sum())
    flops = 4 * H * pairs * d
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
        + (qp.numel() + kp.numel()) * 4
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    results["flash_attention_fwd"] = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105",
        "max_abs_err": err,
        "ms": time_ms(lambda: flash_attention_fwd(q, k, v, qp, kp)),
        "eager_ms": eager_ms(lambda: flash_attention_fwd(q, k, v, qp, kp)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, qp, kp),
                            iters=5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True)),
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS
        >= nbytes / HBM_BYTES_PER_S else "bytes",
        "shape": f"B{B} S{S} H{H} K{K} d{d} T{T} causal, {pairs} valid pairs",
    }
    for r in results.values():
        print("kernel_timing " + json.dumps(r))
    return results


def _paged_inputs(B, H, K, d, BS, MAXB, lengths, *, share=0, unmap=(),
                  seed=0):
    """Random pools of NB = B x MAXB blocks behind tables drawn from a
    permutation of the pool: row b maps ceil(len / BS) blocks holding its
    positions 0..len-1 (-1 past len), and -1 past them.  Row 1's first
    ``share`` entries are row 0's blocks (a prefix hit); each (row, entry)
    of ``unmap`` is -1 inside a live range.  Pool block 0 is row 0's entry
    40, and the blocks no table maps hold random live positions."""
    g = torch.Generator().manual_seed(seed)
    NB = B * MAXB
    q = torch.randn(B, 1, H, d, generator=g).bfloat16()
    k_pool = torch.randn(NB, BS, K, d, generator=g).bfloat16()
    v_pool = torch.randn(NB, BS, K, d, generator=g).bfloat16()
    kp_pool = torch.randint(0, MAXB * BS, (NB, BS), generator=g,
                            dtype=torch.int32)
    perm = torch.randperm(NB, generator=g)
    i0 = int((perm == 0).nonzero())
    perm[i0], perm[40] = perm[40].clone(), 0
    bt = torch.full((B, MAXB), -1, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        nb = -(-n // BS)
        bt[b, :nb] = perm[used:used + nb]
        used += nb
        for j in range(nb):
            p = torch.arange(j * BS, (j + 1) * BS, dtype=torch.int32)
            kp_pool[bt[b, j]] = torch.where(p < n, p, -1)
    bt[1, :share] = bt[0, :share]
    for r, j in unmap:
        bt[r, j] = -1
    q_pos = torch.tensor([max(n, 1) for n in lengths], dtype=torch.int32)
    return [t.cuda() for t in (q, k_pool, v_pool, q_pos, kp_pool, bt)]


def _gather_sdpa(q, k_pool, v_pool, q_pos, kp_pool, bt):
    """Paged decode by library calls: an index_select gather of the tables'
    blocks, then scaled_dot_product_attention (no single PyTorch call
    computes attention through block tables)."""
    B, MAXB = bt.shape
    NB, BS, K, d = k_pool.shape
    flat = bt.reshape(-1).clamp(min=0)
    k = k_pool.index_select(0, flat).view(B, MAXB * BS, K, d).transpose(1, 2)
    v = v_pool.index_select(0, flat).view(B, MAXB * BS, K, d).transpose(1, 2)
    kp = kp_pool.index_select(0, flat).view(B, MAXB * BS)
    live = (bt.repeat_interleave(BS, 1) >= 0) & (kp >= 0) \
        & (kp <= q_pos[:, None])
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=live[:, None, None, :],
        enable_gqa=True)


def phase_paged_kernel():
    """flash_decode_paged against its plain version, bit-equal to
    flash_decode on the gathered view, two negative controls, timing."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged,
                                                  split_chunk)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    engine = (4, 8, 1, 256)
    cases = [  # (name, (B, H, K, d), BS, MAXB, lengths, inputs kw, kernel kw)
        ("engine B4 H8 K1 d256 BS16 MAXB208", engine, 16, 208,
         [3328, 1000, 0, 17], {}, {}),
        ("64 shared blocks, -1 inside row 2's live range", engine, 16, 208,
         [3328, 2000, 700, 17], {"share": 64, "unmap": [(2, 40)]}, {}),
        ("BS8 MAXB416", engine, 8, 416, [3328, 1000, 0, 17],
         {"share": 10}, {}),
        ("BS64 MAXB52", engine, 64, 52, [3328, 1000, 0, 17],
         {"share": 10, "unmap": [(1, 3)]}, {}),
        ("qwen3-32b B8 H64 K8 d128 BS16 MAXB256", (8, 64, 8, 128), 16, 256,
         [4096, 3000, 2048, 1024, 513, 100, 1, 0],
         {"share": 32, "unmap": [(3, 5)]}, {}),
        ("window 64", engine, 16, 64, [1024, 700, 40, 0], {"share": 2},
         {"window": 64}),
        ("softcap 30 MHA d128", (2, 4, 4, 128), 16, 49, [777, 300],
         {"share": 5}, {"softcap": 30.0}),
    ]
    for name, (B, H, K, d), BS, MAXB, lens, ikw, kw in cases:
        args = _paged_inputs(B, H, K, d, BS, MAXB, lens, **ikw)
        want = ref.flash_decode_paged_ref(*args, **kw)
        got = flash_decode_paged(*args, **kw)
        k, v, kp = ref.gather_paged_kv(*args[1:3], *args[4:])
        same = flash_decode(args[0], k.contiguous(), v.contiguous(), args[3],
                            kp.contiguous(), **kw)
        torch.cuda.synchronize()
        ok, err, worst = _close(got, want)
        bitwise = torch.equal(got, same)
        print(f"kernel flash_decode_paged [{name}] "
              f"{split_chunk(B, K, MAXB * BS, sms)} keys per split: "
              f"max_abs_err {err:.3e}, worst err/limit {worst:.3f} (limit "
              f"{KERNEL_TOL}) {'ok' if ok else 'FAIL'}; bit-equal to "
              f"flash_decode on the gathered view: {bitwise}")
        check(ok, f"flash_decode_paged disagrees with plain: {name}")
        check(bitwise, f"flash_decode_paged is not bit-equal to flash_decode "
              f"on the gathered view: {name}")
        if name.startswith("engine"):
            main = (args, err)
        if name.startswith("64 shared"):
            q, k_pool, v_pool, qp, kp_pool, bt = args
            # the -1 entry of row 2 read as block 0, which holds row 0's
            # positions 640..655, live for row 2
            bad = bt.clone()
            bad[2, 40] = 0
            _reject("flash_decode_paged reads row 2's unmapped entry as "
                    "block 0", flash_decode_paged(q, k_pool, v_pool, qp,
                                                  kp_pool, bad), want)

    args, err = main
    q, k_pool, v_pool, qp, kp_pool, bt = args
    want = ref.flash_decode_paged_ref(*args)
    # row 3 (17 keys) holds position 16 at offset 0 of its second block;
    # a recycled block whose previous owner's positions 1..15 were left in
    # offsets 1..15 makes those keys live
    stale = kp_pool.clone()
    stale[bt[3, 1], 1:] = torch.arange(1, 16, dtype=torch.int32,
                                       device="cuda")
    _reject("flash_decode_paged on a recycled block with stale positions",
            flash_decode_paged(q, k_pool, v_pool, qp, stale, bt), want)

    B, _, H, d = q.shape
    NB, BS, K = k_pool.shape[:3]
    MAXB = bt.shape[1]
    _, _, kp = ref.gather_paged_kv(k_pool, v_pool, kp_pool, bt)
    live = int(_valid_pairs(qp[:, None], kp, True, None).sum())
    mapped = int((bt >= 0).sum())
    nbytes = (q.numel() * 2 * 2 + live * K * d * 2 * 2 + bt.numel() * 4
              + mapped * BS * 4 + qp.numel() * 4)
    flops = 4 * H * live * d
    result = {
        "name": "flash_decode_paged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:270",
        "max_abs_err": err,
        "ms": time_ms(lambda: flash_decode_paged(*args)),
        "eager_ms": eager_ms(lambda: flash_decode_paged(*args)),
        "plain_ms": time_ms(lambda: ref.flash_decode_paged_ref(*args)),
        "library_ms": time_ms(lambda: _gather_sdpa(*args)),
        "library_call": "index_select gather + scaled_dot_product_attention",
        "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / BF16_FLOPS else "operations",
        "shape": f"B{B} H{H} K{K} d{d} NB{NB} BS{BS} MAXB{MAXB}, {live} live "
                 f"keys",
    }
    print("kernel_timing " + json.dumps(result))
    return {"flash_decode_paged": result}


def _dequant_sdpa(q, kq, vq, ks, vs, mask):
    """The quantized decode by library calls: dequantize to bf16, then
    scaled_dot_product_attention."""
    k = (kq.float() * ks[..., None]).bfloat16()
    v = (vq.float() * vs[..., None]).bfloat16()
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def phase_quant_kernel():
    """flash_decode_quant, int8 and fp8, against its plain version on the
    decode cases; with every scale 1, bit-equal to flash_decode on the
    values widened to bf16; three scale faults rejected; timing."""
    from repro_torch.kernels import quant
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_quant,
                                                  split_chunk)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for kv_dtype in QUANT_KV:
        for name, (B, H, K, d, T, lens), kw in DECODE_CASES:
            kw = dict(kw)
            holes = kw.pop("holes", 0)
            q, k, v, qp, kp = _decode_inputs(B, H, K, d, T, lens, holes)
            kq, ks = quant.quantize_kv(k, kv_dtype)
            vq, vs = quant.quantize_kv(v, kv_dtype)
            want = quant.flash_decode_quant_ref(q, kq, vq, qp, kp, ks, vs,
                                                **kw)
            got = flash_decode_quant(q, kq, vq, qp, kp, ks, vs, **kw)
            ones = torch.ones_like(ks)
            unit = flash_decode_quant(q, kq, vq, qp, kp, ones, ones, **kw)
            same = flash_decode(q, kq.bfloat16(), vq.bfloat16(), qp, kp, **kw)
            dead = ~_valid_pairs(qp[:, None], kp, True,
                                 kw.get("window")).any(-1)[:, 0]
            torch.cuda.synchronize()
            ok, err, worst = _close(got, want)
            bitwise = torch.equal(unit, same)
            print(f"kernel flash_decode_quant {kv_dtype} [{name}] "
                  f"{split_chunk(B, K, T, sms)} keys per split: max_abs_err "
                  f"{err:.3e}, worst err/limit {worst:.3f} (limit "
                  f"{KERNEL_TOL}) {'ok' if ok else 'FAIL'}; every scale 1: "
                  f"bit-equal to flash_decode on the values in bf16: "
                  f"{bitwise}")
            check(ok, f"flash_decode_quant {kv_dtype} disagrees with plain: "
                  f"{name}")
            check(bitwise, f"flash_decode_quant {kv_dtype} with unit scales "
                  f"is not bit-equal to flash_decode: {name}")
            check(bool((got[dead] == 0).all()), f"flash_decode_quant: a row "
                  f"with no valid key must be zeros ({name})")
            if name.startswith("engine"):
                main = (q, kq, vq, qp, kp, ks, vs, want, err)

        q, kq, vq, qp, kp, ks, vs, want, err = main
        ones = torch.ones_like(ks)
        tag = f"flash_decode_quant {kv_dtype}"
        _reject(f"{tag} reads every scale as 1",
                flash_decode_quant(q, kq, vq, qp, kp, ones, ones), want)
        _reject(f"{tag} takes key t+1's scales for key t",
                flash_decode_quant(q, kq, vq, qp, kp, ks.roll(-1, 1),
                                   vs.roll(-1, 1)), want)
        _reject(f"{tag} ignores v_scale",
                flash_decode_quant(q, kq, vq, qp, kp, ks, ones), want)
        B, _, H, d = q.shape
        T, K = kq.shape[1], kq.shape[2]
        live = int((kp >= 0).sum())
        nbytes = (q.numel() * 2 + live * K * (d * kq.element_size() + 4) * 2
                  + kp.numel() * 4 + qp.numel() * 4 + q.numel() * 2)
        ops = 4 * H * live * d + 2 * K * live * d       # + the dequantizing
        mask = (kp >= 0)[:, None, None, :]
        name = f"flash_decode_quant_{kv_dtype}"
        results[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:377",
            "max_abs_err": err,
            "ms": time_ms(lambda: flash_decode_quant(q, kq, vq, qp, kp, ks,
                                                     vs)),
            "eager_ms": eager_ms(lambda: flash_decode_quant(q, kq, vq, qp, kp,
                                                            ks, vs)),
            "plain_ms": time_ms(lambda: quant.flash_decode_quant_ref(
                q, kq, vq, qp, kp, ks, vs)),
            "library_ms": time_ms(lambda: _dequant_sdpa(q, kq, vq, ks, vs,
                                                        mask)),
            "library_call": "dequantize to bf16 + scaled_dot_product_attention",
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT8_OPS
            else "operations",
            "shape": f"B{B} H{H} K{K} d{d} T{T} {kv_dtype}, {live} live keys",
        }
        print("kernel_timing " + json.dumps(results[name]))
    return results


# ---------------------------------------------------------------------------
def phase_model(cfg, device, prompt_len, pad_len, seed=0):
    """Prefill a right-padded prompt, decode one token, and hold the decode
    logits against a prefill over prompt + token."""
    from repro_torch.models.model import build_model
    model = build_model(cfg, device=device)
    params = model.init(seed)
    g = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(2, cfg.vocab_size, (prompt_len,), generator=g)
    toks = torch.zeros(1, pad_len, dtype=torch.long)
    toks[0, :prompt_len] = prompt
    pos = torch.arange(pad_len, dtype=torch.int32)
    pos[prompt_len:] = -1
    logits_p, cache = model.prefill(params, {
        "tokens": toks.to(device), "positions": pos[None].to(device),
        "length": torch.tensor([prompt_len], device=device)})
    nxt = int(torch.argmax(logits_p[0].float()))
    logits_d, _ = model.decode_step(params, {
        "tokens": torch.tensor([[nxt]], device=device),
        "positions": torch.tensor([[prompt_len]], dtype=torch.int32,
                                  device=device),
        "pos_row": torch.tensor([prompt_len], dtype=torch.int32,
                                device=device)}, cache)
    full = torch.cat([prompt, torch.tensor([nxt])])[None].to(device)
    logits_f, _ = model.prefill(params, {"tokens": full})
    a, b = logits_d.float(), logits_f.float()
    diff = (a - b).abs()
    ok = bool((diff <= MODEL_ATOL + MODEL_RTOL * b.abs()).all())
    same_top = int(a.argmax()) == int(b.argmax())
    print(f"model {cfg.name} L{cfg.num_layers} D{cfg.d_model}: prefill "
          f"{prompt_len} padded to {pad_len}, decode vs prefill logits "
          f"max_abs_diff {float(diff.max()):.3e} (max |logit| "
          f"{float(b.abs().max()):.2f}; tol {MODEL_ATOL}+{MODEL_RTOL}|ref|), "
          f"same argmax {same_top}, finite {bool(torch.isfinite(a).all())} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok and bool(torch.isfinite(a).all()),
          "decode logits disagree with the prefill over prompt + token")
    return model, params


def _same_bits(a, b):
    """Same shape and bits (one-byte types compared as bytes)."""
    if a.element_size() == 1 and b.element_size() == 1:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return a.shape == b.shape and torch.equal(a, b)


def _to_device(tree, device):
    """A copy of a nested dict of tensors (a cache, the params) on
    ``device``; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return tree


def phase_quant_model(model, params, device, prompt_len, pad_len, seed=0):
    """The quantized cache at full width, for int8 and fp8: prefill logits
    bit-equal to bf16's and its cache equal to quantize_kv of bf16's; one
    decode step whose cache write is bit-equal, in every layer, to
    quantize_kv on the CPU of the K/V the step projected; its logits
    within QUANT_MODEL_FACTOR x the bf16 step's card-vs-CPU difference of
    the same step on the CPU (plain versions, the same params, the same
    cache); and a cache whose scales all read 1 rejected by that bound."""
    from repro_torch.kernels.quant import quantize_kv
    from repro_torch.models import layers as L
    from repro_torch.models.lm import DecoderModel
    cfg = model.cfg
    g = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(2, cfg.vocab_size, (prompt_len,), generator=g)
    toks = torch.zeros(1, pad_len, dtype=torch.long)
    toks[0, :prompt_len] = prompt
    pos = torch.arange(pad_len, dtype=torch.int32)
    pos[prompt_len:] = -1
    batch = {"tokens": toks.to(device), "positions": pos[None].to(device),
             "length": torch.tensor([prompt_len], device=device)}
    cpu = DecoderModel(cfg, device="cpu")
    cpu_params = _to_device(params, "cpu")

    def step(m, p, cache):
        dev = m.device
        logits, _ = m.decode_step(p, {
            "tokens": torch.tensor([[nxt]], device=dev),
            "positions": torch.tensor([[prompt_len]], dtype=torch.int32,
                                      device=dev),
            "pos_row": torch.tensor([prompt_len], dtype=torch.int32,
                                    device=dev)}, cache)
        return logits.float().cpu()

    logits_bf, cache_bf = model.prefill(params, batch)
    nxt = int(torch.argmax(logits_bf[0].float()))
    card = step(model, params, _to_device(cache_bf, device))
    delta_bf = float((card - step(cpu, cpu_params,
                                  _to_device(cache_bf, "cpu"))).abs().max())
    bound = QUANT_MODEL_FACTOR * delta_bf
    print(f"model {cfg.name} bf16 cache: decode step on the card vs on the "
          f"CPU max |delta logit| {delta_bf:.3e} (max |logit| "
          f"{float(card.abs().max()):.2f}) -> quantized bound "
          f"{QUANT_MODEL_FACTOR} x = {bound:.3e}")
    check(bound > 0, "the bf16 card-vs-CPU delta is 0: no bound to derive")
    out = {"bf16_card_vs_cpu": delta_bf, "bound": bound}
    for kv_dtype in QUANT_KV:
        model.kv_dtype = kv_dtype
        try:
            logits_q, cache_q = model.prefill(params, batch)
        finally:
            model.kv_dtype = "bf16"
        same_prefill = torch.equal(logits_q, logits_bf) and all(
            _same_bits(a, b) for key in ("k", "v") for a, b in zip(
                quantize_kv(cache_bf[key], kv_dtype),
                (cache_q[key], cache_q[key + "_scale"])))
        projected, orig = [], L.project_kv

        def capture(*a, **kw):
            projected.append(orig(*a, **kw))
            return projected[-1]
        card_cache = _to_device(cache_q, device)
        L.project_kv = capture
        try:
            card = step(model, params, card_cache)
        finally:
            L.project_kv = orig
        slot = prompt_len % pad_len
        writes_equal = len(projected) == cfg.num_layers and all(
            _same_bits(got.cpu(), want)
            for l, (k_new, v_new) in enumerate(projected)
            for key, new in (("k", k_new), ("v", v_new))
            for got, want in zip(
                (card_cache[key][l][:, slot],
                 card_cache[key + "_scale"][l][:, slot]),
                (t[:, 0] for t in quantize_kv(new.cpu(), kv_dtype))))
        cpu_logits = step(cpu, cpu_params, _to_device(cache_q, "cpu"))
        delta = float((card - cpu_logits).abs().max())
        bad = _to_device(cache_q, device)
        bad["k_scale"].fill_(1.0)
        bad["v_scale"].fill_(1.0)
        moved = float((step(model, params, bad) - cpu_logits).abs().max())
        ok = delta <= bound and bool(torch.isfinite(card).all())
        print(f"model {cfg.name} L{cfg.num_layers} D{cfg.d_model} {kv_dtype} "
              f"cache: prefill logits bit-equal to bf16 and cache == "
              f"quantize_kv(bf16 cache): {same_prefill}; decode-step cache "
              f"write == quantize_kv on the CPU of its projected K/V in all "
              f"{cfg.num_layers} layers: {writes_equal}; decode step card vs "
              f"CPU max |delta logit| {delta:.3e} (bound {bound:.3e}) "
              f"{'ok' if ok else 'FAIL'}")
        print(f"negative control [{kv_dtype} cache read with every scale 1]: "
              f"max |delta logit| {moved:.3e} (bound {bound:.3e}) -> "
              f"{'FAIL: passed' if moved <= bound else 'rejected'}")
        check(same_prefill, f"{kv_dtype} prefill differs from bf16's")
        check(writes_equal, f"{kv_dtype} decode-step cache write differs "
              "from quantize_kv")
        check(ok, f"{kv_dtype} decode step: card and CPU differ beyond the "
              "bound")
        check(moved > bound, f"the {kv_dtype} model bound accepts a cache "
              "whose scales are all 1")
        out[kv_dtype] = {"card_vs_cpu": delta, "control_moved": moved}
    return out


def _prompts(cfg, lens, seed=42):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(2, cfg.vocab_size, (n,), generator=g).numpy()
            for n in lens]


class _Margins:
    """Top-2 logit margin of every sampled step of every request an engine
    serves, keyed by rid, recorded around the model's calls (a prefill's
    row is the request in PREFILL; a decode row is its slot's request)."""

    def __init__(self, engine):
        from repro_torch.serving.request import RequestState
        self.by_rid, model = {}, engine.model

        def record(fn, joining):
            def wrapped(*a, **kw):
                logits, cache = fn(*a, **kw)
                top = torch.topk(logits.float(), 2).values
                m = (top[:, 0] - top[:, 1]).tolist()
                if joining:
                    reqs = [r for r in engine.requests.values()
                            if r.state == RequestState.PREFILL]
                else:
                    reqs = engine._slot_req
                for req, x in zip(reqs, m):
                    if req is not None:
                        self.by_rid.setdefault(req.rid, []).append(x)
                return logits, cache
            return wrapped
        self.model = model
        model.prefill = record(model.prefill, True)
        model.prefix_prefill = record(model.prefix_prefill, True)
        model.decode_step = record(model.decode_step, False)

    def close(self):
        for name in ("prefill", "prefix_prefill", "decode_step"):
            delattr(self.model, name)


def _run_alone(model, params, prompt, max_new, prefill_len, cache_len, device):
    """Tokens of one request in a 1-slot engine, with the top-2 logit
    margin of every sampled step."""
    from repro_torch.serving import Engine, SamplingParams
    e = Engine(model, params, slots=1, prefill_len=prefill_len,
               cache_len=cache_len, device=device)
    margins = _Margins(e)
    try:
        res = e.generate([prompt], SamplingParams(max_new_tokens=max_new,
                                                  eos_token=None))[0]
    finally:
        margins.close()
    return res.tokens, margins.by_rid[res.rid]


def _decode_rate(engine, device):
    """Time the engine's decode ticks (host clock around each tick, synced
    on the card); returns a function giving decoded rows per second."""
    secs, rows = [0.0], [0]
    orig = engine._generate

    def timed(*a, **kw):
        n = engine.pool.num_active
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        secs[0] += time.perf_counter() - t0
        rows[0] += n
        return out
    engine._generate = timed
    return lambda: rows[0] / secs[0]


def phase_serving(model, params, device, lens, max_new, prefill_len,
                  cache_len, alone_idx):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged)
    from repro_torch.serving import Engine, SamplingParams
    cfg = model.cfg
    prompts = _prompts(cfg, lens)
    sp = SamplingParams(max_new_tokens=max_new, eos_token=None)
    # warm-up (lazy CUDA and cuBLAS initialisation stays out of the numbers)
    Engine(model, params, slots=2, prefill_len=prefill_len,
           cache_len=cache_len, device=device).generate(
               [prompts[0], prompts[-1]], sp)

    e = Engine(model, params, slots=4, prefill_len=prefill_len,
               cache_len=cache_len, device=device)
    rate = _decode_rate(e, device)
    flash_decode.launches = flash_attention_fwd.launches = 0
    flash_decode_paged.launches = 0
    res = e.generate(prompts, sp)
    n_dec, n_fa = flash_decode.launches, flash_attention_fwd.launches
    check(flash_decode_paged.launches == 0,
          "the contiguous engine launched the paged decode kernel")
    long_prefills = sum(min(n, prefill_len) > 2048 for n in lens)
    want_dec = cfg.num_layers * e.ticks if device != "cpu" else 0
    want_fa = cfg.num_layers * long_prefills if device != "cpu" else 0
    print(f"serving launches: flash_decode {n_dec} (want {cfg.num_layers} x "
          f"{e.ticks} ticks = {want_dec}), flash_attention_fwd {n_fa} (want "
          f"{cfg.num_layers} x {long_prefills} long prefills = {want_fa})")
    check(n_dec == want_dec and n_fa == want_fa,
          "kernel launch counts do not match the serving path")
    check(all(len(r.tokens) == max_new for r in res),
          "every request must produce max_new tokens")

    compared = 0
    for i in alone_idx:
        toks, margins = _run_alone(model, params, prompts[i], max_new,
                                   prefill_len, cache_len, device)
        n = next((j for j, m in enumerate(margins) if m < MARGIN_TOL),
                 len(toks))
        check(res[i].tokens[:n] == toks[:n],
              f"request of {lens[i]} tokens: co-batched tokens differ from "
              f"the same request run alone in its first {n} steps")
        print(f"serving invariant: prompt {lens[i]}: co-batched == alone on "
              f"{n}/{len(toks)} tokens (compared up to the first step with a "
              f"top-2 margin < {MARGIN_TOL})")
        compared += n
    s = e.stats()
    busy = profile_ticks(model, params, device, prompts[:4], prefill_len,
                         cache_len) if device != "cpu" else None
    stats = {"device_busy_share": busy,
             "ttft_p50_ms": s["ttft_p50_ms"], "tpot_p50_ms": s["tpot_p50_ms"],
             "decode_tok_per_s": rate(),
             "ticks": e.ticks, "requests": len(res),
             "tokens_compared": compared, "launches": {
                 "flash_decode": n_dec, "flash_attention_fwd": n_fa}}
    return stats, [r.tokens for r in res]


def phase_quant_serving(model, params, device, kv_dtype, lens, max_new,
                        prefill_len, cache_len, bf16_tokens):
    """The contiguous engine with a quantized cache serves the mix of
    phase 5: launch counts (the quantized decode per tick, never the bf16
    one), byte-true KV accounting, latency and a tick profile; its tokens
    against the bf16 engine's are information, not a check."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged,
                                                  flash_decode_quant)
    from repro_torch.kernels.quant import kv_bytes_per_vector
    from repro_torch.serving import Engine, SamplingParams
    cfg = model.cfg
    prompts = _prompts(cfg, lens)
    sp = SamplingParams(max_new_tokens=max_new, eos_token=None)
    kw = dict(prefill_len=prefill_len, cache_len=cache_len,
              kv_dtype=kv_dtype, device=device)
    on_card = device != "cpu"
    try:
        # warm-up of the quantized path (first-call costs stay out)
        Engine(model, params, slots=2, **kw).generate([prompts[0]], sp)
        e = Engine(model, params, slots=4, **kw)
        rate = _decode_rate(e, device)
        flash_decode.launches = flash_decode_paged.launches = 0
        flash_decode_quant.launches = flash_attention_fwd.launches = 0
        res = e.generate(prompts, sp)
        n_q, n_fa = flash_decode_quant.launches, flash_attention_fwd.launches
        n_bf = flash_decode.launches + flash_decode_paged.launches
        long_prefills = sum(min(n, prefill_len) > 2048 for n in lens)
        L = cfg.num_layers
        print(f"quantized serving {kv_dtype} launches: flash_decode_quant "
              f"{n_q} (want {L} x {e.ticks} ticks), bf16 decode kernels "
              f"{n_bf} (want 0), flash_attention_fwd {n_fa} (want {L} x "
              f"{long_prefills} long prefills)")
        check(n_q == L * e.ticks * on_card and n_bf == 0
              and n_fa == L * long_prefills * on_card,
              f"quantized serving {kv_dtype}: kernel launch counts do not "
              "match the path")
        check(all(len(r.tokens) == max_new for r in res),
              "every request must produce max_new tokens")
        s = e.stats()
        bpt = e.kv_bytes_per_token
        want_bpt = L * 2 * cfg.num_kv_heads * kv_bytes_per_vector(
            cfg.head_dim, kv_dtype)
        print(f"quantized serving {kv_dtype}: kv_bytes_per_token {bpt} (want "
              f"{want_bpt}; bf16 {L * 2 * cfg.num_kv_heads * cfg.head_dim * 2}"
              f"), kv_utilization {s['kv_utilization']:.4f}, stats kv_dtype "
              f"{s['kv_dtype']}")
        check(bpt == want_bpt and s["kv_dtype"] == kv_dtype,
              f"quantized serving {kv_dtype}: KV accounting")
        same = sum(next((j for j, (a, b) in enumerate(zip(r.tokens, w))
                         if a != b), len(w)) for r, w in zip(res, bf16_tokens))
        print(f"quantized serving {kv_dtype} (information): tokens equal to "
              f"the bf16 engine's up to each request's first difference on "
              f"{same}/{sum(map(len, bf16_tokens))}")
        busy = profile_ticks(model, params, device, prompts[:4], prefill_len,
                             cache_len, kv_dtype=kv_dtype) if on_card \
            else None
    finally:
        model.kv_dtype = "bf16"
    return {"device_busy_share": busy,
            "ttft_p50_ms": s["ttft_p50_ms"], "tpot_p50_ms": s["tpot_p50_ms"],
            "decode_tok_per_s": rate(), "ticks": e.ticks,
            "requests": len(res), "tokens_equal_to_bf16": same,
            "kv_bytes_per_token": bpt,
            "kv_utilization": s["kv_utilization"],
            "launches": {f"flash_decode_quant_{kv_dtype}": n_q,
                         "flash_attention_fwd": n_fa}}


def serving_in_turns(model, params, device, lens, max_new, prefill_len,
                     cache_len, order=("bf16", "int8", "fp8", "fp8", "int8",
                                       "bf16")):
    """TTFT p50, TPOT p50 and decode tok/s of the contiguous engine on the
    mix of phase 5 with each kv_dtype, run in turns (bf16, int8, fp8, fp8,
    int8, bf16) so that drift of the host's speed over the call falls on
    every dtype alike.  Returns {kv_dtype: [one dict per run]}."""
    from repro_torch.serving import Engine, SamplingParams
    prompts = _prompts(model.cfg, lens)
    sp = SamplingParams(max_new_tokens=max_new, eos_token=None)
    runs = {}
    try:
        for kv_dtype in order:
            e = Engine(model, params, slots=4, prefill_len=prefill_len,
                       cache_len=cache_len, kv_dtype=kv_dtype, device=device)
            rate = _decode_rate(e, device)
            e.generate(prompts, sp)
            s = e.stats()
            runs.setdefault(kv_dtype, []).append(
                {"ttft_p50_ms": s["ttft_p50_ms"],
                 "tpot_p50_ms": s["tpot_p50_ms"], "decode_tok_per_s": rate()})
    finally:
        model.kv_dtype = "bf16"
    for kv_dtype, rs in runs.items():
        print(f"serving in turns, {kv_dtype}: TPOT p50 "
              + ", ".join(f"{r['tpot_p50_ms']:.3f}" for r in rs)
              + " ms; TTFT p50 "
              + ", ".join(f"{r['ttft_p50_ms']:.2f}" for r in rs)
              + " ms; decode "
              + ", ".join(f"{r['decode_tok_per_s']:.1f}" for r in rs)
              + " tok/s")
    return runs


def paged_mix(cfg, sys_len, parts, seed=43):
    """Prompts of the paged serving mix: ("sys", n) is one shared
    ``sys_len``-token prompt followed by n own tokens, (None, n) n
    unrelated tokens."""
    g = torch.Generator().manual_seed(seed)

    def draw(n):
        return torch.randint(2, cfg.vocab_size, (n,), generator=g).numpy()
    sys_prompt = draw(sys_len)
    return [np.concatenate([sys_prompt, draw(n)]) if kind == "sys"
            else draw(n) for kind, n in parts]


def phase_paged_serving(model, params, device, prompts, n_sys, sys_len,
                        max_new, prefill_len, cache_len, block_size,
                        trap_lens, trap_block):
    """The paged engine serves ``prompts`` (``n_sys`` of them share the
    ``sys_len``-token prefix): exact prefix stats, launch counts, no leaked
    block after the drain, and tokens equal to the contiguous engine's on
    the same mix up to the first step whose top-2 margin is under
    MARGIN_TOL.  Then the recycled-block case: A, then B, on a 1-slot
    engine without prefix reuse; B's tokens must equal B alone."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged)
    from repro_torch.serving import Engine, SamplingParams
    cfg = model.cfg
    sp = SamplingParams(max_new_tokens=max_new, eos_token=None)
    kw = dict(slots=4, prefill_len=prefill_len, cache_len=cache_len,
              device=device)
    # warm-up of the paged path (first-call costs stay out of the numbers)
    Engine(model, params, block_size=block_size, **kw).generate(
        [prompts[2], prompts[0]], sp)

    contig = Engine(model, params, **kw)
    contig_rate = _decode_rate(contig, device)
    margins = _Margins(contig)
    try:
        want = [r.tokens for r in contig.generate(prompts, sp)]
    finally:
        margins.close()
    e = Engine(model, params, block_size=block_size, **kw)
    rate = _decode_rate(e, device)
    flash_decode.launches = flash_decode_paged.launches = 0
    flash_attention_fwd.launches = 0
    res = e.generate(prompts, sp)
    n_paged, n_dec = flash_decode_paged.launches, flash_decode.launches
    n_fa = flash_attention_fwd.launches
    L, joins = cfg.num_layers, len(prompts)
    on_card = device != "cpu"
    print(f"paged serving launches: flash_decode_paged {n_paged} (want {L} x "
          f"{e.ticks} ticks), flash_decode {n_dec} (want 0), "
          f"flash_attention_fwd {n_fa} (want {L} x {joins} joins)")
    check(n_paged == L * e.ticks * on_card and n_dec == 0
          and n_fa == L * joins * on_card,
          "paged serving: kernel launch counts do not match the path")
    st = e.pool.prefix_stats()
    hit_blocks = sys_len // block_size
    print(f"paged prefix stats: {st}")
    check(st["hits"] == n_sys - 1 and st["misses"] == joins - n_sys + 1
          and st["hit_tokens"] == (n_sys - 1) * hit_blocks * block_size,
          "paged serving: prefix stats differ from the mix")
    hits = [r for r in res if r.metrics.prefix_cached_tokens]
    check(len(hits) == n_sys - 1 and all(
        r.metrics.prefilled_tokens == r.metrics.prompt_tokens
        - hit_blocks * block_size for r in hits),
        "paged serving: a prefix hit prefilled more than its suffix")
    check(all(len(r.tokens) == max_new for r in res),
          "every request must produce max_new tokens")
    pool = e.pool
    check(pool.free_blocks + pool.cached_blocks == pool.num_blocks
          and (pool.refcount == 0).all() and pool._total_reserved == 0,
          "paged serving: a block is still held after the drain")
    compared = 0
    for i, (r, w) in enumerate(zip(res, want)):
        m = margins.by_rid[i]
        n = next((j for j, x in enumerate(m) if x < MARGIN_TOL), len(w))
        check(r.tokens[:n] == w[:n],
              f"paged serving: request {i} ({len(prompts[i])} tokens) "
              f"differs from the contiguous engine in its first {n} steps")
        compared += n
    print(f"paged serving invariant: paged == contiguous tokens on "
          f"{compared}/{len(prompts) * max_new} (each request compared up to "
          f"its first step with a top-2 margin < {MARGIN_TOL})")

    # the recycled-block case: B lands on A's first block at table index 2
    a, b = paged_mix(cfg, 0, [(None, n) for n in trap_lens], seed=44)
    one = dict(slots=1, prefill_len=prefill_len, cache_len=cache_len,
               block_size=trap_block, prefix_cache=False, device=device)
    logits, tables = [], []

    def record(fn):
        def wrapped(*args, **kwargs):
            out, cache = fn(*args, **kwargs)
            logits.append(out.float())
            if "length" in args[1]:                     # a join
                tables.append(args[1]["block_tables"][0, :4].tolist())
            return out, cache
        return wrapped
    model.prefix_prefill = record(model.prefix_prefill)
    model.decode_step = record(model.decode_step)
    try:
        alone = Engine(model, params, **one).generate([b], sp)[0].tokens
        e1 = Engine(model, params, **one)
        e1.generate([a], SamplingParams(max_new_tokens=2, eos_token=None))
        n = len(logits)
        after = e1.generate([b], sp)[0].tokens
    finally:
        del model.prefix_prefill, model.decode_step
    first, second = logits[:max_new], logits[n:]
    diff = max(float((x - y).abs().max()) for x, y in zip(first, second))
    table = tables[-1]
    check(table[2] == 0, "the recycled-block case does not map A's first "
          "block at B's table index 2")
    print(f"paged recycled block: B's table after A starts {table}; "
          f"B after A == B alone on {max_new} tokens: {after == alone}, "
          f"max |delta logit| over its {len(second)} steps {diff:.3e}")
    check(after == alone and diff == 0.0,
          "paged serving: a recycled block leaks keys")

    s, c = e.stats(), contig.stats()
    busy = profile_ticks(model, params, device, prompts[:4], prefill_len,
                         cache_len, block_size=block_size) if on_card \
        else None
    return {"device_busy_share": busy,
            "ttft_p50_ms": s["ttft_p50_ms"], "tpot_p50_ms": s["tpot_p50_ms"],
            "decode_tok_per_s": rate(), "ticks": e.ticks,
            "contiguous_ttft_p50_ms": c["ttft_p50_ms"],
            "contiguous_tpot_p50_ms": c["tpot_p50_ms"],
            "contiguous_decode_tok_per_s": contig_rate(),
            "contiguous_ticks": contig.ticks,
            "requests": len(res), "tokens_compared": compared,
            "prefix": st, "kv_utilization": s.get("kv_utilization"),
            "launches": {"flash_decode_paged": n_paged,
                         "flash_decode": n_dec,
                         "flash_attention_fwd": n_fa}}


def profile_ticks(model, params, device, prompts, prefill_len, cache_len,
                  ticks=8, block_size=None, kv_dtype=None):
    """Share of wall time the card is busy over ``ticks`` decode ticks of a
    4-slot engine (torch.profiler), and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Engine, SamplingParams
    e = Engine(model, params, slots=4, prefill_len=prefill_len,
               cache_len=cache_len, block_size=block_size, kv_dtype=kv_dtype,
               device=device)
    for p in prompts:
        e.submit(p, SamplingParams(max_new_tokens=10 * ticks, eos_token=None))
    e.step()                                    # joins + first tick
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            e.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(ev.self_device_time_total for ev in kern)
    top = sorted(kern, key=lambda ev: -ev.self_device_time_total)[:6]
    print(f"profile{' (paged)' if block_size else ''}"
          f"{f' ({kv_dtype})' if kv_dtype else ''}: {ticks} decode ticks, "
          f"wall {wall_us / ticks:.0f} us/tick,"
          f" device busy {dev_us / ticks:.0f} us/tick "
          f"({dev_us / wall_us:.1%} of wall)")
    for ev in top:
        print(f"  {ev.self_device_time_total / ticks:9.1f} us/tick "
              f"x{ev.count // ticks:4d}  {ev.key[:90]}")
    return dev_us / wall_us


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    kernels.update(phase_paged_kernel())
    kernels.update(phase_quant_kernel())
    cfg = get_config("gemma-2b")
    model, params = phase_model(cfg, "cuda", 3072, 3200)
    print("quant_model_stats " + json.dumps(
        phase_quant_model(model, params, "cuda", 3072, 3200)))
    stats, bf16_tokens = phase_serving(model, params, "cuda", SERVE_PROMPTS,
                                       32, prefill_len=3072, cache_len=3328,
                                       alone_idx=(2, 5))
    print(f"serving {cfg.name} on {smi}: TTFT p50 {stats['ttft_p50_ms']:.2f} "
          f"ms, TPOT p50 {stats['tpot_p50_ms']:.3f} ms, decode "
          f"{stats['decode_tok_per_s']:.1f} tok/s")
    print("serving_stats " + json.dumps(stats))
    paged = phase_paged_serving(
        model, params, "cuda", paged_mix(cfg, SYS_LEN, PAGED_MIX),
        n_sys=sum(kind == "sys" for kind, _ in PAGED_MIX), sys_len=SYS_LEN,
        max_new=32, prefill_len=3072, cache_len=3328, block_size=16,
        trap_lens=(20, 20), trap_block=8)
    print(f"paged serving {cfg.name} on {smi}: TTFT p50 "
          f"{paged['ttft_p50_ms']:.2f} ms, TPOT p50 "
          f"{paged['tpot_p50_ms']:.3f} ms, decode "
          f"{paged['decode_tok_per_s']:.1f} tok/s; contiguous engine on the "
          f"same mix: TTFT p50 {paged['contiguous_ttft_p50_ms']:.2f} ms, "
          f"TPOT p50 {paged['contiguous_tpot_p50_ms']:.3f} ms, decode "
          f"{paged['contiguous_decode_tok_per_s']:.1f} tok/s")
    print("paged_serving_stats " + json.dumps(paged))
    quant = {kv_dtype: phase_quant_serving(
        model, params, "cuda", kv_dtype, SERVE_PROMPTS, 32, prefill_len=3072,
        cache_len=3328, bf16_tokens=bf16_tokens) for kv_dtype in QUANT_KV}
    turns = serving_in_turns(model, params, "cuda", SERVE_PROMPTS, 32,
                             prefill_len=3072, cache_len=3328)
    mean = {dt: {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
            for dt, rs in turns.items()}
    for kv_dtype in QUANT_KV:
        q, b = mean[kv_dtype], mean["bf16"]
        print(f"quantized serving {cfg.name} {kv_dtype} on {smi}, mean of "
              f"its two turns: TTFT p50 {q['ttft_p50_ms']:.2f} ms, TPOT p50 "
              f"{q['tpot_p50_ms']:.3f} ms, decode "
              f"{q['decode_tok_per_s']:.1f} tok/s; bf16 engine in the same "
              f"turns: TTFT p50 {b['ttft_p50_ms']:.2f} ms, TPOT p50 "
              f"{b['tpot_p50_ms']:.3f} ms, decode {b['decode_tok_per_s']:.1f} "
              f"tok/s")
    print("quant_serving_stats " + json.dumps({**quant, "turns": turns}))
    # each kernel's launches on the serving paths: the contiguous, paged,
    # int8 and fp8 engines' runs, each counted from 0
    for name, r in kernels.items():
        r["launches"] = sum(run["launches"].get(name, 0) for run in
                            (stats, paged, *quant.values()))
    line = [{k: r[k] for k in ("name", "route", "source", "replaces",
                               "launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")}
            for r in kernels.values()]
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
