"""Serving CLI of the port — a thin front-end over ``repro_torch.serving.Engine``.

Submits synthetic requests with mixed prompt lengths through the
continuous-batching engine and prints per-request and aggregate serving
metrics (queue wait / TTFT / TPOT).  Runs on the card unless
``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --requests 8 --slots 4 --max-new 32 [--no-reduced] [--device cpu] \
        [--kv-dtype {bf16,int8,fp8}] \
        [--block-size 16 [--num-blocks N] [--no-prefix-cache]]

``--reduced`` is on by default; ``--no-reduced`` serves the published
config at full width.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.telemetry import ServingTelemetry
from repro_torch.models.model import build_model
from repro_torch.serving import Engine, SamplingParams
from repro_torch.serving.mix import sample_prompt_len


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (default; --no-reduced = full size)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefill-len", type=int, default=64)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="bucket prompt lengths up to multiples of this")
    ap.add_argument("--block-size", type=int, default=None,
                    help="paged KV: tokens per cache block (enables the "
                         "paged block pool)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged KV: pool size in blocks (default: the "
                         "memory of slots x cache_len)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="paged KV: share prompt-prefix blocks across "
                         "requests (default on)")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["bf16", "int8", "fp8"],
                    help="KV cache storage: bf16, or int8/fp8 quantized with "
                         "f32 per-(token, head) scales (contiguous cache "
                         "only)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are sampled")
    ap.add_argument("--telemetry", default=None,
                    help="JSONL path for per-request records")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    telemetry = ServingTelemetry(args.telemetry)
    engine = Engine(model, params, slots=args.slots,
                    prefill_len=args.prefill_len, cache_len=args.cache_len,
                    prefill_chunk=args.prefill_chunk,
                    block_size=args.block_size, num_blocks=args.num_blocks,
                    prefix_cache=args.prefix_cache, kv_dtype=args.kv_dtype,
                    telemetry=telemetry, device=args.device)
    rng = np.random.default_rng(args.seed)
    on_token = None
    if args.stream:
        on_token = lambda rid, tok, last: print(
            f"  [rid {rid}] {tok}{' <eos/len>' if last else ''}", flush=True)
    for i in range(args.requests):
        S = sample_prompt_len(rng, args.prefill_len)
        prompt = rng.integers(2, cfg.vocab_size, S).astype(np.int32)
        engine.submit(prompt, SamplingParams(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            seed=args.seed + i, max_new_tokens=args.max_new), on_token=on_token)
    results = engine.run(max_ticks=100_000)
    print(f"{cfg.name} on {model.device}: {len(results)} requests, "
          f"slots={args.slots}, ticks={engine.ticks}, "
          f"kv_dtype={engine.kv_dtype} ({engine.kv_bytes_per_token} KV "
          f"B/token)")
    for rid in sorted(results):
        r = results[rid]
        m = r.metrics
        print(f"  rid {rid}: prompt {m.prompt_tokens:3d} -> "
              f"{m.output_tokens:3d} tok ({r.done_reason}); "
              f"wait {1e3 * (m.queue_wait or 0):.0f} ms, "
              f"ttft {1e3 * (m.ttft or 0):.0f} ms, "
              f"tpot {1e3 * (m.tpot or 0):.1f} ms")
    s = engine.stats()
    print(f"aggregate: {s['output_tokens']} tokens; "
          f"ttft p50/p99 {s['ttft_p50_ms']:.0f}/{s['ttft_p99_ms']:.0f} ms; "
          f"tpot p50/p99 {s['tpot_p50_ms']:.1f}/{s['tpot_p99_ms']:.1f} ms; "
          f"queue p50/p99 {s['queue_wait_p50_ms']:.0f}/"
          f"{s['queue_wait_p99_ms']:.0f} ms")
    if engine.paged:
        p = s["prefix"]
        print(f"paged pool: {s['num_blocks']} x {engine.block_size}-token "
              f"blocks, {s['free_blocks']} free; prefix hits "
              f"{p['hits']}/{p['hits'] + p['misses']} "
              f"({p['hit_tokens']} tokens served from cache); "
              f"kv util {s.get('kv_utilization', 0):.0%}")
    telemetry.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
