"""Where a decode step's time goes, on the card.

    python -m llm_inference_tpu_torch.tools.profile_decode [--steps 8]
        [--batch 1] [--prompt N] [--seed 0]

Builds LLaMA-2-7B with random int8 weights and lm_head on the GPU,
prefills `--batch` prompts of `--prompt` tokens (default 128 // batch, so
the prefill's batch x prompt rows stay within K1's 128), then runs `--steps` decode steps (greedy, the engine's
forward) three ways:
  1. wall time per step (host clock, synchronised);
  2. the same steps under torch.profiler (CPU + CUDA activities): device
     busy time per step (union of kernel intervals), idle share, kernel
     launches per step, the top kernels by device time and the top host
     ops by self CPU time;
  3. one more step under torch.cuda.set_sync_debug_mode("warn"): the
     operations that made the host wait for the device (a decode step
     should have none until the chunk's tokens are read).
Prints one JSON line at the end with the summary numbers.
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
from llm_inference_tpu_torch.ops import kvcache, sampling


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
    ap.add_argument("--prompt", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    cfg = llama2_7b()
    params = llama.prepare_params(llama.init_params_quantized(
        cfg, QuantConfig(weights="int8", quantize_embedding=True),
        seed=args.seed, device=dev))
    B, S = args.batch, 512
    T = args.prompt or max(1, 128 // B)
    cache = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                               cfg.head_dim, torch.bfloat16, device=dev)
    rope = llama.rope_table(cfg, S, dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
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
            out, cache = llama.forward(cfg, params, tok[:, None],
                                       nxt[:, None], cache, last_idx=zeros,
                                       rope_tables=rope)
            tok = sampling.sample(out, None, greedy=True)
            nxt = nxt + 1

        for _ in range(3):                   # warm-up
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "called a synchronizing" in str(w.message)]

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels]) / 1e3 / args.steps
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
    print(json.dumps({"card": smi, "batch": B, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / wall_ms,
                      "host_syncs_per_step": len(syncs),
                      "kernels_per_step": len(kernels) / args.steps}))


if __name__ == "__main__":
    main()
