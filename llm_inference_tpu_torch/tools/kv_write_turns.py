"""The RoPE and KV write (`kv_write.rope_write`) against a baseline tree's
RoPE and KV writes, in turns, on the card.

    python -m llm_inference_tpu_torch.tools.kv_write_turns --baseline DIR
        [--parts calls,pdl,decode,prefill] [--seed 0]

DIR holds another tree's `csrc/kv_write.cu` as `kv_write.cu`, its
`ops/kernels/kv_write.py` as `kv_write.py` and its `ops/kernels/_build.py`
as `_build.py`, side by side (for a commit: `git show
REV:llm_inference_tpu_torch/csrc/kv_write.cu > DIR/kv_write.cu` and so
on). That `kv_write.cu` is built into a library of its own, typed by that
tree's `_build.SIGNATURES`, and its wrapper's source runs with that
library in place of its kernels. "baseline" is this tree's model with
the RoPE before the write (`llama._rope_in_write` false: the plain
`apply_rope_gathered`) and the baseline's wrapper as `kvcache.kv_write`:
at T = 1 its K3, K4, or the plain int4 quantizer, K3 on the packed rows
and its scale write; at T > 1 the plain quantizer and slice writes. "this"
is this tree as it stands. Parts (`--parts`, all by default), each in
turns baseline, this, this, baseline on LLaMA-2-7B widths:

  1. calls: one layer's RoPE and write over a bf16, int8 and int4 cache
     at B = 1 and 4 (T = 1, offsets up to one past the end), and at T =
     128 and 2048 (B = 1): device ms of the baseline's chain (the RoPE
     on q and k, then the write) and of this tree's one launch (CUDA
     events, the stream parked, as `chip_smoke.time_ms`), the kernels
     each launches (torch.profiler), the baseline's RoPE alone and, at
     T = 1, its K3 or K4 alone;
  2. pdl: this tree's kernel as built (a programmatic dependent launch)
     against a build of the same source without the launch attribute,
     in turns: behind K1 (wqkv at M = 1 with its prologue, int8 and int4
     g = 128, 32 layers of K1 then the write), behind K1's MMA branch at
     128 rows, and alone (back to back);
  3. decode: on full-depth LLaMA-2-7B, int8 weights over a bf16 cache,
     int4 g = 128 over an int8 and over an int4 cache (prompt 128, 512
     slots, B = 1), the decode step's device busy ms, kernels a step and
     the idle share of its wall (`profile_decode.profile_steps`), the
     baseline and this tree in turns, twice;
  4. prefill: on the same models, a 128-row prefill over 512 slots and a
     2048-row chunk over 4096 slots (B = 1): the wall (synchronised;
     minimum, median and maximum of 5), then under torch.profiler the
     device busy ms and the kernel count, in turns.

Prints the card (nvidia-smi name and power limit) first. Needs a card and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from llm_inference_tpu_torch.config import QuantConfig, llama2_7b
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache, rope
from llm_inference_tpu_torch.ops.kernels import _build, kv_write
from llm_inference_tpu_torch.ops.kernels import quant_matmul as k1
from llm_inference_tpu_torch.ops.quantization import QTensor
from llm_inference_tpu_torch.tools import k1_turns, ring_variants
from llm_inference_tpu_torch.tools.k1_turns import time_ms, turns

BF16 = torch.bfloat16
PARTS = ("calls", "pdl", "decode", "prefill")
KINDS = {"bf16": 16, "int8": 8, "int4": 4}
CFG = llama2_7b()
MODELS = (("int8", "bf16"), ("int4", "int8"), ("int4", "int4"))


def say(*a):
    print(*a, flush=True)


def baseline(src: Path):
    """The baseline's kv_write wrapper module, bound to a library of its
    kv_write.cu."""
    _, mod = k1_turns.baseline(src, ("kv_write.cu",), "kv_write.py",
                               "kv_baseline")
    # update_cache_layer's prefill write (T > 1), the plain ops the
    # baseline ran inline there
    mod.window_write_ref = kv_write.window_write_ref
    return mod


class Route:
    """The model's RoPE and write as the baseline (`base`) or this tree."""

    def __init__(self, base):
        self.base = base
        self.rope_in_write = llama._rope_in_write

    def use(self, tag):
        if tag == "baseline":
            llama._rope_in_write = lambda *a: False
            kvcache.kv_write = self.base
        else:
            llama._rope_in_write = self.rope_in_write
            kvcache.kv_write = kv_write


def kernels_of(fn) -> int:
    """Kernels fn() launches on the card (torch.profiler)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def layer_inputs(gen, kind, B, T, offs, S, depth=4):
    """q, k, v as column slices of one qkv projection, the RoPE rows at
    the write's slots, the offsets and a random `depth`-layer cache of
    `kind` (two copies: the baseline's and this tree's)."""
    H, Hkv, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    qkv = torch.randn((B, T, (H + 2 * Hkv) * D), generator=gen,
                      device="cuda").to(BF16)
    q, k, v = (qkv[..., lo * D:(lo + n) * D].reshape(B, T, n, D)
               for lo, n in ((0, H), (H, Hkv), (H + Hkv, Hkv)))
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    slots = (torch.clamp(off.long(), 0, S - T)[:, None]
             + torch.arange(T, device="cuda"))
    cos_t, sin_t = llama.rope_table(CFG, S, "cuda")
    caches = [kvcache.init_cache(depth, B, Hkv, S, D,
                                 BF16 if kind == "bf16" else kind,
                                 device="cuda") for _ in range(2)]
    return qkv, q, k, v, cos_t[slots], sin_t[slots], off, caches


def baseline_layer(base, cache, layer, qkv, v, cos, sin, off):
    """The baseline's layer: one RoPE pass over the adjacent q and k
    columns (as llama._fused_qkv_heads ran it), then its write."""
    B, T = qkv.shape[:2]
    H, Hkv, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    qk = rope.apply_rope_gathered(
        qkv[..., :(H + Hkv) * D].reshape(B, T, -1, D), cos, sin)
    saved = kvcache.kv_write
    kvcache.kv_write = base
    try:
        kvcache.update_cache_layer(cache, layer, qk[:, :, H:], v, off)
    finally:
        kvcache.kv_write = saved
    return qk[:, :, :H]


def part_calls(base, gen):
    H, Hkv, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    for kind, bits in KINDS.items():
        for B, T, offs, S in ((1, 1, [191], 512),
                              (4, 1, [0, 77, 511, 521], 512),
                              (1, 128, [0], 512), (1, 2048, [0], 4096)):
            qkv, q, k, v, cos, sin, off, (cb, cn) = layer_inputs(
                gen, kind, B, T, offs, S)

            def fb(i):
                return baseline_layer(base, cb, i % 4, qkv, v, cos, sin,
                                      off)

            def fn(i):
                return kvcache.rope_update_cache_layer(cn, i % 4, q, k, v,
                                                       cos, sin, off)
            qb, qn = fb(1), fn(1)
            torch.cuda.synchronize()
            same = torch.equal(qb, qn) and all(
                a is None or torch.equal(a, b) for a, b in zip(
                    (cb.k, cb.v, cb.k_scale, cb.v_scale),
                    (cn.k, cn.v, cn.k_scale, cn.v_scale)))
            reps = 20 if T == 1 else 5
            b_ms, n_ms = turns(fb, fn, reps)
            qk = qkv[..., :(H + Hkv) * D].reshape(B, T, -1, D)
            rope_ms = time_ms(lambda i: rope.apply_rope_gathered(qk, cos,
                                                                 sin), reps)
            alone = ""
            if T == 1 and bits != 4:
                kt, vt = k.transpose(1, 2), v.transpose(1, 2)
                if bits == 8:
                    one = time_ms(lambda i: base.quantize_write_token(
                        cb.k, cb.v, cb.k_scale, cb.v_scale, i % 4, kt, vt,
                        off))
                else:
                    one = time_ms(lambda i: base.write_token(
                        cb.k, cb.v, i % 4, kt, vt, off))
                alone = (f", its {'K4' if bits == 8 else 'K3'} alone "
                         f"{one:.4f}")
            say(f"calls {kind} B={B} T={T}: baseline {b_ms:.4f} ms in "
                f"{kernels_of(lambda: fb(0))} kernels (RoPE alone "
                f"{rope_ms:.4f}{alone}), this {n_ms:.4f} ms in "
                f"{kernels_of(lambda: fn(0))} ({n_ms / b_ms:.3f}x); "
                f"results equal {same}")
            del qkv, q, k, v, cb, cn
            torch.cuda.empty_cache()


def _weight(bits, K, N, gen, depth=4):
    if bits == 8:
        return QTensor(q=torch.randint(-128, 128, (depth, N, K), generator=gen,
                                       device="cuda", dtype=torch.int8),
                       scale=torch.rand((depth, 1, N), generator=gen,
                                        device="cuda") * 1e-3)
    return QTensor(q=torch.randint(-128, 128, (depth, N, K // 2),
                                   generator=gen, device="cuda",
                                   dtype=torch.int8),
                   scale=torch.rand((depth, N, K // 128), generator=gen,
                                    device="cuda") * 0.04 / 7 + 1e-4, bits=4)


def part_pdl(gen):
    main = _build.lib()
    plain = ring_variants.build(["kvnopdl"], {"kvnopdl": ("kv_write.cu", [
        ("kv_write.cu", "  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n")],
        True)})["kvnopdl"]
    libs = {"PDL": main, "no PDL": ring_variants._Swap(main, plain)}
    H, Hkv, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    K = CFG.hidden_size
    for bits, kind in ((8, "bf16"), (4, "int8")):
        wqkv = _weight(bits, K, (H + 2 * Hkv) * D, gen)
        gamma = (1 + 0.1 * torch.randn((K,), generator=gen,
                                       device="cuda")).to(BF16)
        for M, offs in ((1, [191]), (128, [0])):
            B, T = (1, 1) if M == 1 else (1, 128)
            _, _, _, _, cos, sin, off, (c, _) = layer_inputs(
                gen, kind, B, T, offs, 512)
            x = torch.randn((M, K), generator=gen, device="cuda").to(BF16)
            res = torch.randn((M, K), generator=gen, device="cuda").to(BF16)

            def pair(i):
                qkv, _ = k1.quant_matmul(x, wqkv, i % 4, norm_gamma=gamma,
                                         residual=res, want_x_out=True)
                qkv = qkv.reshape(B, T, -1)
                q, k, v = (qkv[..., lo * D:(lo + n) * D].reshape(B, T, n, D)
                           for lo, n in ((0, H), (H, Hkv), (H + Hkv, Hkv)))
                return kvcache.rope_update_cache_layer(c, i % 4, q, k, v,
                                                       cos, sin, off)
            qkv, _ = k1.quant_matmul(x, wqkv, 0, norm_gamma=gamma,
                                     residual=res, want_x_out=True)
            qkv = qkv.reshape(B, T, -1)
            q, k, v = (qkv[..., lo * D:(lo + n) * D].reshape(B, T, n, D)
                       for lo, n in ((0, H), (H, Hkv), (H + Hkv, Hkv)))

            def alone(i):
                return kvcache.rope_update_cache_layer(c, i % 4, q, k, v,
                                                       cos, sin, off)
            for what, f in (("behind K1", pair), ("alone", alone)):
                got = {}
                for tag in ("no PDL", "PDL", "PDL", "no PDL"):
                    _build._lib = libs[tag]
                    try:
                        got.setdefault(tag, []).append(time_ms(f, 32))
                    finally:
                        _build._lib = main
                say(f"pdl int{bits} weights, {kind} cache, M={M}, {what}: "
                    + ", ".join(f"{t} " + " / ".join(f"{x:.4f}" for x in v)
                                for t, v in got.items()) + " ms a layer")
        del wqkv
        torch.cuda.empty_cache()


def _params(weights, seed):
    qcfg = QuantConfig(weights=weights, quantize_embedding=True,
                       group_size=128 if weights == "int4" else 0)
    return llama.prepare_params(llama.init_params_quantized(
        CFG, qcfg, seed=seed, device="cuda"))


def part_decode(route, params, weights, kv, seed):
    from llm_inference_tpu_torch.tools.profile_decode import (decode_steps,
                                                              profile_steps)
    cache_kind = BF16 if kv == "bf16" else kv
    got = {}
    for _ in range(2):
        for tag in ("baseline", "this", "this", "baseline"):
            route.use(tag)
            step = decode_steps(CFG, params, 1, 128, 512, cache_kind, 0,
                                seed, torch.device("cuda"))
            r = profile_steps(step, 8)
            got.setdefault(tag, []).append(
                (r["busy_ms"], len(r["kernels"]) / 8,
                 1 - r["busy_ms"] / r["wall_ms"], r["wall_ms"]))
            del step
    route.use("this")
    for tag, v in got.items():
        say(f"decode {weights} + {kv} KV B=1 {tag}: busy " + " / ".join(
            f"{b:.3f}" for b, *_ in v) + " ms, kernels " + " / ".join(
            f"{k:.0f}" for _, k, *_ in v) + ", idle share " + " / ".join(
            f"{i:.3f}" for _, _, i, _ in v) + ", wall " + " / ".join(
            f"{w:.3f}" for *_, w in v) + " ms a step")


def _prefill(params, kv, rows, S, seed):
    cache = kvcache.init_cache(CFG.num_layers, 1, CFG.num_kv_heads, S,
                               CFG.head_dim, BF16 if kv == "bf16" else kv,
                               device="cuda")
    tables = llama.rope_table(CFG, S, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(1, CFG.vocab_size, (1, rows), generator=g,
                        device="cuda", dtype=torch.int32)
    pos = torch.arange(rows, device="cuda", dtype=torch.int32)[None]

    def run():
        with torch.no_grad():
            llama.forward(CFG, params, ids, pos, cache, rope_tables=tables)
    run()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans, busy, end = sorted((e.time_range.start, e.time_range.end)
                              for e in kernels), 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    walls.sort()
    return walls, busy / 1e3, len(kernels)


def part_prefill(route, params, weights, kv, seed):
    for rows, S in ((128, 512), (2048, 4096)):
        got = {}
        for tag in ("baseline", "this", "this", "baseline"):
            route.use(tag)
            got.setdefault(tag, []).append(_prefill(params, kv, rows, S,
                                                    seed))
            torch.cuda.empty_cache()
        route.use("this")
        for tag, v in got.items():
            say(f"prefill {weights} + {kv} KV, {rows} rows over {S} slots, "
                f"{tag}: wall min/median/max " + "; ".join(
                    f"{w[0]:.2f}/{w[2]:.2f}/{w[-1]:.2f}" for w, _, _ in v)
                + " ms, device busy " + " / ".join(
                    f"{b:.3f}" for _, b, _ in v) + " ms, kernels " + " / "
                .join(f"{n}" for *_, n in v))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("kv_write_turns needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(f"card: {smi}")
    _build.lib()
    base = baseline(args.baseline)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    if "calls" in parts:
        part_calls(base, gen)
        say(f"calls done at {time.perf_counter() - t0:.1f} s")
    if "pdl" in parts:
        part_pdl(gen)
        say(f"pdl done at {time.perf_counter() - t0:.1f} s")
    route = Route(base)
    weights_now, params = None, None
    for weights, kv in MODELS:
        if not {"decode", "prefill"} & set(parts):
            break
        if weights != weights_now:
            params = None
            torch.cuda.empty_cache()
            params, weights_now = _params(weights, args.seed), weights
        if "decode" in parts:
            part_decode(route, params, weights, kv, args.seed)
        if "prefill" in parts:
            part_prefill(route, params, weights, kv, args.seed)
        say(f"{weights} + {kv} done at {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
