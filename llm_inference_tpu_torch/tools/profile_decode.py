"""Where a decode step's and a prefill chunk's time goes, on the card.

    python -m llm_inference_tpu_torch.tools.profile_decode [--steps 8]
        [--batch 1] [--prompt 128] [--seed 0] [--weights int8|int4]
        [--kv bf16|int8|int4] [--page-size 0]

Builds LLaMA-2-7B with random weights and lm_head on the GPU (`--weights`:
int8 per-channel, or int4 with groups of 128), over a bf16, int8 or int4
KV cache (`--kv`), dense or, with `--page-size`, a paged pool of pages of
that many tokens (each row's pages in order; the prompt a multiple of the
page size), prefills `--batch` prompts of `--prompt` tokens (the cache
holds the prompt and the steps, rounded up to a multiple of 128 and at
least 512 slots), then runs `--steps` decode steps (greedy, the
engine's forward) three ways:
  1. wall time per step (host clock, synchronised);
  2. the same steps under torch.profiler (CPU + CUDA activities): device
     busy time per step (union of kernel intervals), idle share, kernel
     launches per step, the top kernels by device time and the top host
     ops by self CPU time;
  3. one more step under torch.cuda.set_sync_debug_mode("warn"): the
     operations that made the host wait for the device (a decode step
     should have none until the chunk's tokens are read).
Then one 2048-row prefill chunk (the engine's largest default bucket) at
B = 1 over a 4096-slot cache under torch.profiler: wall and device busy
time, and the top device ops by time (K8 is `qmm_tiled`, K9
`flash_kernel`, the rest plain PyTorch). Prints one JSON line at the end
with the summary numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import warnings

import torch
from torch.autograd import DeviceType

from llm_inference_tpu_torch.config import QuantConfig, llama2_7b
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache, paged_kvcache, sampling


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weights", choices=("int8", "int4"), default="int8")
    ap.add_argument("--kv", choices=("bf16", "int8", "int4"), default="bf16")
    ap.add_argument("--page-size", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    cfg = llama2_7b()
    qcfg = QuantConfig(weights=args.weights, quantize_embedding=True,
                       group_size=128 if args.weights == "int4" else 0)
    params = llama.prepare_params(llama.init_params_quantized(
        cfg, qcfg, seed=args.seed, device=dev))
    B, T = args.batch, args.prompt
    S = max(512, -(-(T + args.steps + 8) // 128) * 128)
    kv = torch.bfloat16 if args.kv == "bf16" else args.kv
    ps = args.page_size
    if ps and (T % ps or S % ps):
        raise SystemExit(f"--prompt {T} and the {S} slots must be "
                         f"multiples of --page-size {ps}")
    step = decode_steps(cfg, params, B, T, S, kv, ps, args.seed, dev)
    r = profile_steps(step, args.steps)
    wall_ms, prof_wall_ms, prof = r["wall_ms"], r["prof_wall_ms"], r["prof"]

    torch.cuda.synchronize()
    with torch.no_grad(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]

    kernels = r["kernels"]
    busy_ms = r["busy_ms"]
    print(f"decode step wall {wall_ms:.3f} ms ({1e3 / wall_ms:.1f} tok/s "
          f"per row, B={B}); under the profiler {prof_wall_ms:.3f} ms")
    print(f"device busy {busy_ms:.3f} ms/step, idle share "
          f"{1 - busy_ms / wall_ms:.3f} of the unprofiled step; "
          f"{len(kernels) / args.steps:.0f} "
          f"kernels/step; host syncs in one step: {len(syncs)}")
    for msg in syncs[:5]:
        print(f"  sync: {msg}")
    print("top kernels by device time (per step):")
    by_kernel = {}
    for e in kernels:
        by_kernel.setdefault(e.name, [0.0, 0])
        by_kernel[e.name][0] += e.time_range.end - e.time_range.start
        by_kernel[e.name][1] += 1
    for name, (us, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]
                                )[:10]:
        print(f"  {us / 1e3 / args.steps:8.3f} ms  {n / args.steps:6.1f}x  "
              f"{name[:90]}")
    print("top host ops by self CPU time (per step):")
    avg = [k for k in prof.key_averages()
           if k.device_type == DeviceType.CPU]
    for k in sorted(avg, key=lambda k: -k.self_cpu_time_total)[:12]:
        print(f"  {k.self_cpu_time_total / 1e3 / args.steps:8.3f} ms  "
              f"{k.count / args.steps:6.1f}x  {k.key[:90]}")
    summary = {"card": smi, "batch": B, "prompt": T, "weights": args.weights,
               "kv": args.kv, "page_size": ps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
               "idle_share": 1 - busy_ms / wall_ms,
               "host_syncs_per_step": len(syncs),
               "kernels_per_step": len(kernels) / args.steps}
    del step
    summary.update(_prefill_profile(cfg, params, kv, args.seed, dev))
    print(json.dumps(summary))


def decode_steps(cfg, params, B, T, S, kv, ps, seed, dev):
    """Prefill B random prompts of T tokens over an S-slot cache (dense,
    or paged with pages of ps tokens when ps), and return step(): one
    greedy decode step through the engine's forward."""
    if ps:
        NB = S // ps
        cache = paged_kvcache.init_paged_cache(
            cfg.num_layers, B * NB + 1, cfg.num_kv_heads, ps, cfg.head_dim,
            B, NB, kv, device=dev)
        cache.page_table.copy_(1 + torch.arange(
            B * NB, device=dev, dtype=torch.int32).reshape(B, NB))
    else:
        cache = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                                   cfg.head_dim, kv, device=dev)
    rope = llama.rope_table(cfg, S, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(1, cfg.vocab_size, (B, T), generator=g, device=dev,
                        dtype=torch.int32)
    pos = torch.arange(T, device=dev, dtype=torch.int32)[None].repeat(B, 1)
    zeros = torch.zeros((B,), dtype=torch.long, device=dev)
    with torch.no_grad():
        logits, cache = llama.forward(cfg, params, ids, pos, cache,
                                      rope_tables=rope)
    tok = sampling.sample(logits, None, greedy=True)
    nxt = torch.full((B,), T, dtype=torch.int32, device=dev)

    def step():
        nonlocal tok, nxt, cache
        with torch.no_grad():
            out, cache = llama.forward(cfg, params, tok[:, None],
                                       nxt[:, None], cache, last_idx=zeros,
                                       rope_tables=rope)
        tok = sampling.sample(out, None, greedy=True)
        nxt = nxt + 1
    return step


def profile_steps(step, steps, warmup=3):
    """`warmup` steps, then `steps` timed on the host clock (synchronised),
    then `steps` more under torch.profiler: wall_ms and prof_wall_ms a
    step, the device's busy ms a step (the union of kernel intervals), the
    kernels' events and the profile."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels]) / 1e3 / steps
    return dict(wall_ms=wall_ms, prof_wall_ms=prof_wall_ms, busy_ms=busy_ms,
                kernels=kernels, prof=prof)


def _prefill_profile(cfg, params, kv, seed, dev, rows=2048, S=4096):
    """One prefill chunk of `rows` rows at B = 1, positions 0.., over an
    S-slot cache, under torch.profiler."""
    cache = kvcache.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, S,
                               cfg.head_dim, kv, device=dev)
    rope = llama.rope_table(cfg, S, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    ids = torch.randint(1, cfg.vocab_size, (1, rows), generator=g,
                        device=dev, dtype=torch.int32)
    pos = torch.arange(rows, device=dev, dtype=torch.int32)[None]

    def chunk():
        return llama.forward(cfg, params, ids, pos, cache, rope_tables=rope)
    with torch.no_grad():
        chunk()                              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            chunk()
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels]) / 1e3
    print(f"prefill chunk of {rows} rows over {S} slots: wall {wall_ms:.3f} "
          f"ms, device busy {busy_ms:.3f} ms, {len(kernels)} kernels")
    print("top device ops of the prefill chunk:")
    by_kernel = {}
    for e in kernels:
        by_kernel.setdefault(e.name, [0.0, 0])
        by_kernel[e.name][0] += e.time_range.end - e.time_range.start
        by_kernel[e.name][1] += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        print(f"  {us / 1e3:8.3f} ms  {n:5d}x  {name[:90]}")
    return {"prefill_rows": rows, "prefill_wall_ms": wall_ms,
            "prefill_device_busy_ms": busy_ms,
            "prefill_top_ops_ms": {name[:60]: us / 1e3
                                   for name, (us, _) in top[:8]}}


if __name__ == "__main__":
    main()
