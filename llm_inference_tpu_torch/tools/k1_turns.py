"""K1 (quant_matmul) against a baseline tree's K1, in turns, on the card.

    python -m llm_inference_tpu_torch.tools.k1_turns --baseline DIR
        [--parts gemv,gemv4,decode,k1,small,k8,host,ttft] [--seed 0]

DIR holds another tree's `quant_matmul.cu`, `quant_matmul_tiled.cu` and,
where the tree has it, `qmm4_gemv.cu`, the headers they include
(`int4_gemv.cuh`, `int8_gemv.cuh`, `mma.cuh`, `sm90.cuh`,
`weight_ring.cuh`), its `ops/kernels/quant_matmul.py` wrapper and its
`ops/kernels/_build.py`, side by side (for a commit: `git show
REV:llm_inference_tpu_torch/csrc/quant_matmul.cu > DIR/quant_matmul.cu`
and so on). The `.cu` files are built into a library of their own,
typed by that tree's own `_build.SIGNATURES`; the wrapper's source is run
with that library in place of its kernels (K8's `qmm_tiled_launch` is
called directly, with the arguments it has taken since it was written).
Both trees' `quant_matmul` are called on the same LLaMA-2-7B-width
weights (8 random layers; a layer a call in turn, so the codes come from
HBM) and rows, in these parts (`--parts`, all by default):

  1. gemv: the GEMVs (M = 1, 4, 8, fused prologue): int8 equal bits or
     not, int4 (whose sums may be taken in another order) x_out's bits and
     the largest difference against K1's tolerance (2^-7 of the largest
     output);
  2. gemv4: the int4 GEMV (M <= 8, groups of 128) on LLaMA-2-7B's wqkv and
     lm_head and one tp = 2 rank's wqkv and wo shards at M = 1, 2, 4, 8
     with the main path's prologue choice, in turns as in k1 below, beside
     `torch.matmul` and the bound; the decode step's entry (32 wqkv +
     lm_head at M = 1); wqkv in groups of 32, 16 and 8 at M = 1 and 8;
  3. decode: on full-depth LLaMA-2-7B int4 g=128 + int8 KV (prompt 128,
     512 slots), the decode step at B = 1 (the split route: K1 on wqkv and
     lm_head) and B = 8 with the baseline's `quant_matmul` and this tree's
     in turns, twice: device busy ms a step, kernels a step, the idle
     share of the step's wall and K1's device ms a step
     (`profile_decode.profile_steps`);
  4. k1: K1's MMA branch on wqkv, wo, w_gateup and w_down at M = 16, 64, 128,
     int8 and int4 in groups of 128, with the main path's prologue choice:
     device ms a call (CUDA events, the stream parked, as
     `chip_smoke.time_ms`) in turns baseline, this tree, this tree,
     baseline, beside `torch.matmul` on the bf16-dequantized weight and
     the bound (bytes at 3.35 TB/s or operations at 989 TFLOP/s), and the
     32 x 4 projections' chain;
  5. small: int4 groups of 8, 16 and 32 codes on wqkv at M = 16 and 128;
  6. k8: K8 (`qmm_tiled_launch`) at 2048 and 1024 rows, both libraries;
  7. host: the wrapper's host cost a call: 16 rounds of 64 calls each, the
     stream parked, the two trees' rounds in turn (minimum, median,
     maximum);
  8. ttft: on full-depth LLaMA-2-7B int8 + bf16 KV and int4 g=128 +
     int8 KV (512-slot cache, buckets 32 and 128), the baseline's
     `quant_matmul` and this tree's in turns, 10 rounds of each: the TTFT
     of `InferenceEngine.generate` for a 128-token prompt, a 100-token
     one and four of at most 32 tokens, and the wall of the 128-token
     prefill alone (the engine's prefill and the first token read back,
     synchronised), each as minimum, median and maximum; then that
     prefill once more with each tree under torch.profiler: its device
     busy time (the union of kernel intervals), the idle share of the
     median wall, the kernel count and the top device ops.

Prints the card (nvidia-smi name and power limit) first. Needs a card and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import time
import types
from pathlib import Path

import torch

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            QuantConfig, llama2_7b)
from llm_inference_tpu_torch.ops.kernels import _build
from llm_inference_tpu_torch.ops.kernels import quant_matmul as k1
from llm_inference_tpu_torch.ops.quantization import QTensor, dequantize

BF16 = torch.bfloat16
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
BF16_FLOPS = 989e12
DEPTH = 8
# (K, N) and the main path's prologue choice of LLaMA-2-7B's projections
SHAPES = {"wqkv": (4096, 12288, True), "wo": (4096, 4096, False),
          "w_gateup": (4096, 22016, True), "w_down": (11008, 4096, False)}
PARTS = ("gemv", "gemv4", "decode", "k1", "small", "k8", "host", "ttft")
# the int4 GEMV's decode shapes: (K, N, the main path's prologue choice)
GEMV4 = {"wqkv": (4096, 12288, True), "lm_head": (4096, 32000, False),
         "tp2 wqkv": (4096, 6144, True), "tp2 wo": (2048, 4096, False)}


def say(*a):
    print(*a, flush=True)


def time_ms(fn, reps=20, warmup=3, trials=5):
    """Device ms of one fn(i): the median over trials of `reps` calls
    enqueued behind a sleep kernel, so the events bracket device work."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    samples = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        a.record()
        for i in range(reps):
            fn(i)
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / reps)
    return sorted(samples)[len(samples) // 2]


def turns(fb, fn, reps=20):
    """Baseline, this tree, this tree, baseline: the two means."""
    b1, n1, n2, b2 = (time_ms(f, reps) for f in (fb, fn, fn, fb))
    return (b1 + b2) / 2, (n1 + n2) / 2


def baseline(src: Path, sources=("quant_matmul.cu", "quant_matmul_tiled.cu",
                                  "qmm4_gemv.cu"),
             wrapper="quant_matmul.py", into="k1_baseline"):
    """The baseline's library of `sources` (those DIR has; built beside
    this tree's kernels, into build/<into>) and its `wrapper` module
    bound to it."""
    out = _build.BUILD_DIR.parent / into
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs, procs = [], []
    for name in sources:
        if not (src / name).exists():
            continue
        obj = out / (name + ".o")
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [nvcc, *_build.ARCH_FLAGS, *_build.CFLAGS, "-c", str(src / name),
             "-o", str(obj)]))
    _build.lib()                      # this tree's build, meanwhile
    if any(p.wait() for p in procs):
        raise RuntimeError("the baseline's sources did not build")
    so = out / "libbaseline.so"
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", *objs, "-o",
                    str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    # the baseline's own C signatures, for the entries its library has
    sig = {"__file__": str((src / "_build.py").resolve()),
           "__name__": "baseline_build"}
    exec(compile((src / "_build.py").read_text(), "baseline_build.py",
                 "exec"), sig)
    for name, argtypes in sig["SIGNATURES"].items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int

    def check(code, what):
        if code != 0:
            raise RuntimeError(f"baseline {what}: CUDA error {code}")
    text = (src / wrapper).read_text().replace(
        "from llm_inference_tpu_torch.ops.kernels import _build",
        "_build = _BASELINE_BUILD")
    mod = types.ModuleType("baseline_" + wrapper[:-3])
    mod.__dict__["_BASELINE_BUILD"] = types.SimpleNamespace(
        lib=lambda: lib, check=check)
    exec(compile(text, "baseline_" + wrapper, "exec"), mod.__dict__)
    return lib, mod


def weight(bits, K, N, gen, gs=128, depth=DEPTH):
    if bits == 8:
        return QTensor(q=torch.randint(-128, 128, (depth, N, K), generator=gen,
                                       device="cuda", dtype=torch.int8),
                       scale=torch.rand((depth, 1, N), generator=gen,
                                        device="cuda") * 1e-3)
    return QTensor(q=torch.randint(-128, 128, (depth, N, K // 2),
                                   generator=gen, device="cuda",
                                   dtype=torch.int8),
                   scale=torch.rand((depth, N, K // gs), generator=gen,
                                    device="cuda") * 0.04 / 7 + 1e-4, bits=4)


def rows(M, K, prologue, gen):
    x = torch.randn((M, K), generator=gen, device="cuda").to(BF16)
    if not prologue:
        return x, {}
    return x, dict(norm_gamma=(1 + 0.1 * torch.randn(
        (K,), generator=gen, device="cuda")).to(BF16),
        residual=torch.randn((M, K), generator=gen, device="cuda").to(BF16),
        want_x_out=True)


def gemv_bits(base, gen):
    for bits in (8, 4):
        qt = weight(bits, 4096, 12288, gen, depth=2)
        for M in (1, 4, 8):
            x, kw = rows(M, 4096, True, gen)
            a = base.quant_matmul(x, qt, 1, **kw)
            b = k1.quant_matmul(x, qt, 1, **kw)
            torch.cuda.synchronize()
            same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            if bits == 8:
                say(f"GEMV int8 M={M}: equal bits {same}")
                continue
            err = (a[0].float() - b[0].float()).abs().max().item()
            tol = 2.0 ** -7 * a[0].float().abs().max().item()
            say(f"GEMV int4 M={M}: equal bits {same}, x_out equal "
                f"{torch.equal(a[1], b[1])}, max diff {err:.3g} against "
                f"the K1 tolerance {tol:.3g}: "
                f"{'within' if err <= tol else 'OUTSIDE'}")


def gemv_bound(qt, M, K, N, pro):
    """(bound ms, by) of one K1 call: one layer's codes and scales, the
    rows in and out (and the prologue's residual, gamma and x_out)."""
    nbytes = (qt.layer(0).q.numel() + qt.layer(0).scale.numel() * 4
              + M * K * 2 + M * N * 2 + (2 * M * K * 2 + K * 2 if pro
                                         else 0))
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = 2 * M * K * N / BF16_FLOPS * 1e3
    return max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def gemv4(base, gen):
    step = {}
    for name, (K, N, pro) in GEMV4.items():
        depth = 2 if name == "lm_head" else DEPTH   # past L2 either way
        qt = weight(4, K, N, gen, depth=depth)
        deq = [dequantize(qt.layer(i), BF16) for i in range(2)]
        for M in (1, 2, 4, 8):
            x, kw = rows(M, K, pro, gen)
            b, n = turns(lambda i: base.quant_matmul(x, qt, i % depth, **kw),
                         lambda i: k1.quant_matmul(x, qt, i % depth, **kw))
            lib = time_ms(lambda i: torch.matmul(x, deq[i % 2]))
            bound, by = gemv_bound(qt, M, K, N, pro)
            step[(name, M)] = (b, n, lib, bound)
            say(f"int4 GEMV {name:8s} M={M}: baseline {b:.4f} this {n:.4f} "
                f"ms ({n / b:.3f}x)  torch.matmul {lib:.4f}  bound "
                f"{bound:.4f} ({by}; {n / bound:.2f}x)")
        del qt, deq
        torch.cuda.empty_cache()
    for M in (1, 8):
        t = [32 * step[("wqkv", M)][j] + step[("lm_head", M)][j]
             for j in range(4)]
        say(f"int4 decode step's K1 (32 wqkv + lm_head) at M={M}: baseline "
            f"{t[0]:.4f} this {t[1]:.4f} torch.matmul {t[2]:.4f} bound "
            f"{t[3]:.4f} ms")
    K, N, _ = GEMV4["wqkv"]
    for gs in (32, 16, 8):
        qt = weight(4, K, N, gen, gs=gs, depth=4)
        for M in (1, 8):
            x, kw = rows(M, K, True, gen)
            b, n = turns(lambda i: base.quant_matmul(x, qt, i % 4, **kw),
                         lambda i: k1.quant_matmul(x, qt, i % 4, **kw))
            say(f"int4 GEMV g={gs} wqkv M={M}: baseline {b:.4f} this "
                f"{n:.4f} ms ({n / b:.3f}x)")


def decode(base, seed):
    from llm_inference_tpu_torch.models import llama
    from llm_inference_tpu_torch.tools.profile_decode import (decode_steps,
                                                              profile_steps)
    cfg = llama2_7b()
    qcfg = QuantConfig(weights="int4", group_size=128,
                       quantize_embedding=True)
    params = llama.prepare_params(llama.init_params_quantized(
        cfg, qcfg, seed=seed, device="cuda"))
    this = k1.quant_matmul
    try:
        for B in (1, 8):
            step = decode_steps(cfg, params, B, 128, 512, "int8", 0, seed,
                                torch.device("cuda"))
            got = {}
            for _ in range(2):
                for tag, fn in (("baseline", base.quant_matmul),
                                ("this", this), ("this", this),
                                ("baseline", base.quant_matmul)):
                    k1.quant_matmul = fn
                    r = profile_steps(step, 8)
                    k1_us = sum(e.time_range.end - e.time_range.start
                                for e in r["kernels"]
                                if "qmm" in e.name) / 8
                    got.setdefault(tag, []).append(
                        (r["busy_ms"], len(r["kernels"]) / 8,
                         1 - r["busy_ms"] / r["wall_ms"], k1_us / 1e3))
            for tag, v in got.items():
                say(f"decode int4 + int8 KV B={B} {tag}: busy " + " / ".join(
                    f"{b:.3f}" for b, *_ in v) + " ms, kernels " + " / ".join(
                    f"{k:.0f}" for _, k, *_ in v) + ", idle share "
                    + " / ".join(f"{i:.3f}" for _, _, i, _ in v)
                    + ", K1 (qmm*) " + " / ".join(
                    f"{q:.3f}" for *_, q in v) + " ms a step")
            del step
            torch.cuda.empty_cache()
    finally:
        k1.quant_matmul = this


def projections(base, gen):
    for bits in (8, 4):
        chain = {}
        for name, (K, N, pro) in SHAPES.items():
            qt = weight(bits, K, N, gen)
            deq = [dequantize(qt.layer(i), BF16) for i in range(4)]
            for M in (16, 64, 128):
                x, kw = rows(M, K, pro, gen)
                b, n = turns(lambda i: base.quant_matmul(x, qt, i % DEPTH,
                                                         **kw),
                             lambda i: k1.quant_matmul(x, qt, i % DEPTH,
                                                       **kw))
                lib = time_ms(lambda i: torch.matmul(x, deq[i % 4]))
                nbytes = (qt.layer(0).q.numel() + qt.layer(0).scale.numel()
                          * 4 + M * K * 2 + M * N * 2
                          + (2 * M * K * 2 + K * 2 if pro else 0))
                t_b = nbytes / HBM_BYTES_PER_S * 1e3
                t_f = 2 * M * K * N / BF16_FLOPS * 1e3
                bound = max(t_b, t_f)
                chain[(M, name)] = (b, n, lib, bound)
                say(f"int{bits} {name:8s} M={M:3d}: baseline {b:.4f} this "
                    f"{n:.4f} ms ({n / b:.3f}x)  torch.matmul {lib:.4f} "
                    f"({n / lib:.3f}x)  bound {bound:.4f} "
                    f"({'bytes' if t_b >= t_f else 'operations'}; "
                    f"{n / bound:.2f}x)")
            del qt, deq
            torch.cuda.empty_cache()
        for M in (16, 64, 128):
            t = [32 * sum(chain[(M, n)][j] for n in SHAPES) for j in range(4)]
            say(f"int{bits} chain 32 x 4 at M={M}: baseline {t[0]:.3f} this "
                f"{t[1]:.3f} torch.matmul {t[2]:.3f} bound {t[3]:.3f} ms")


def small_groups(base, gen):
    for gs in (8, 16, 32):
        qt = weight(4, 4096, 12288, gen, gs=gs, depth=4)
        for M in (16, 128):
            x, kw = rows(M, 4096, True, gen)
            b, n = turns(lambda i: base.quant_matmul(x, qt, i % 4, **kw),
                         lambda i: k1.quant_matmul(x, qt, i % 4, **kw), 10)
            say(f"int4 g={gs} wqkv M={M}: baseline {b:.4f} this {n:.4f} ms "
                f"({n / b:.3f}x)")


def k8(blib, gen):
    st = torch.cuda.current_stream().cuda_stream
    for bits, gs, name in ((8, 128, "wqkv"), (8, 128, "w_down"),
                           (4, 128, "wqkv"), (4, 128, "w_down"),
                           (4, 32, "w_gateup")):
        K, N, _ = SHAPES[name]
        qt = weight(bits, K, N, gen, gs=gs, depth=2)
        wb = N * (K // 2 if bits == 4 else K)
        for M in (2048, 1024):
            x = torch.randn((M, K), generator=gen, device="cuda").to(BF16)
            out = torch.empty((M, N), dtype=BF16, device="cuda")

            def call(lib, i):
                code = lib.qmm_tiled_launch(
                    x.data_ptr(), qt.q.data_ptr() + (i % 2) * wb,
                    qt.scale.data_ptr() + (i % 2) * N * qt.groups * 4,
                    None, None, out.data_ptr(), M, K, N, qt.groups, bits,
                    st)
                if code:
                    raise RuntimeError(f"qmm_tiled_launch: {code}")
            b, n = turns(lambda i: call(blib, i),
                         lambda i: call(_build.lib(), i), 10)
            say(f"K8 int{bits} g={gs} {name} M={M}: baseline {b:.4f} this "
                f"{n:.4f} ms ({n / b:.3f}x)")


def host(base, gen):
    for bits, name, M in ((8, "wqkv", 128), (4, "w_down", 128),
                          (8, "wo", 16), (4, "wqkv", 64),
                          (8, "w_gateup", 16), (8, "wqkv", 1)):
        K, N, pro = SHAPES[name]
        qt = weight(bits, K, N, gen, depth=2)
        x, kw = rows(M, K, pro, gen)
        fns = {"baseline": base.quant_matmul, "this": k1.quant_matmul}
        got = {t: [] for t in fns}
        for fn in fns.values():
            for _ in range(3):
                fn(x, qt, 1, **kw)
        torch.cuda.synchronize()
        for _ in range(16):
            for t, fn in fns.items():
                torch.cuda._sleep(60_000_000)
                t0 = time.perf_counter()
                for _c in range(64):
                    fn(x, qt, 1, **kw)
                got[t].append((time.perf_counter() - t0) / 64 * 1e6)
                torch.cuda.synchronize()
        say(f"host a call int{bits} {name} M={M}: " + "  ".join(
            f"{t} min {min(v):.1f} median {sorted(v)[8]:.1f} max "
            f"{max(v):.1f} us" for t, v in got.items()))


def ttft(base, seed):
    from llm_inference_tpu_torch.engine.engine import InferenceEngine
    from llm_inference_tpu_torch.models import llama
    cfg = llama2_7b()
    gen = torch.Generator().manual_seed(seed + 4)
    prompts = {n: [torch.randint(1, cfg.vocab_size, (m,), generator=gen
                                 ).tolist() for m in lens]
               for n, lens in (("128", [128]), ("100", [100]),
                               ("4 x <=32", [32, 17, 25, 9]))}
    this = k1.quant_matmul
    for qcfg, kv in ((QuantConfig(weights="int8", quantize_embedding=True),
                      BF16),
                     (QuantConfig(weights="int4", group_size=128,
                                  quantize_embedding=True), "int8")):
        params = llama.prepare_params(llama.init_params_quantized(
            cfg, qcfg, seed=seed, device="cuda"))
        eng = InferenceEngine(cfg, params, engine_cfg=EngineConfig(
            max_seq_len=512, prefill_buckets=(32, 128), decode_chunk=8),
            cache_dtype=kv, device="cuda")
        g = GenerationConfig(max_new_tokens=2, greedy=True, eos_token_ids=())
        res = {}
        try:
            for rep in range(6):
                for tag, fn in (("baseline", base.quant_matmul),
                                ("this", this), ("this", this),
                                ("baseline", base.quant_matmul)):
                    k1.quant_matmul = fn
                    got = {name: eng.generate(p, g)[0].ttft_s * 1e3
                           for name, p in prompts.items()}
                    got["128-row prefill alone"] = prefill_wall(
                        eng, prompts["128"])
                    if rep:                      # the first round warms up
                        for name, ms in got.items():
                            res.setdefault((name, tag), []).append(ms)
            names = [n for n, t in res if t == "this"]
            for name in names:
                say(f"TTFT {qcfg.weights} {name}: " + "  ".join(
                    f"{t} min {v[0]:.2f} median {v[len(v) // 2]:.2f} max "
                    f"{v[-1]:.2f}" for t, v in (
                        (t, sorted(res[(name, t)])) for t in ("baseline",
                                                              "this")))
                    + " ms (10 each)")
            for tag, fn in (("baseline", base.quant_matmul), ("this", this)):
                k1.quant_matmul = fn
                walls = sorted(res[("128-row prefill alone", tag)])
                prefill_profile(eng, prompts["128"], f"{qcfg.weights} {tag}",
                                walls[len(walls) // 2])
        finally:
            k1.quant_matmul = this
        del eng, params
        torch.cuda.empty_cache()


def prefill_wall(eng, prompt):
    """ms of the engine's prefill of `prompt` and its first token read
    back, the device idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = eng.prefill(prompt)
    logits.argmax(-1).cpu()
    return (time.perf_counter() - t0) * 1e3


def prefill_profile(eng, prompt, tag, wall):
    """The prefill of `prefill_wall` once under torch.profiler: device
    busy (union of kernel intervals), its idle share of `wall` (the
    median unprofiled wall), kernels, and the top device ops."""
    from torch.autograd import DeviceType

    from llm_inference_tpu_torch.tools.profile_decode import _union_us
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = prefill_wall(eng, prompt)
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in kern]) / 1e3
    say(f"prefill {len(prompt[0])} rows {tag}: device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall:.3f} of the median wall {wall:.2f} "
        f"ms (profiled {prof_wall:.2f}), {len(kern)} kernels")
    ops = {}
    for e in kern:
        o = ops.setdefault(e.name, [0.0, 0])
        o[0] += e.time_range.end - e.time_range.start
        o[1] += 1
    for name, (us, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:6]:
        say(f"    {us / 1e3:8.3f} ms {n:4d}x  {name[:80]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated, of " + ", ".join(PARTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise SystemExit(f"unknown parts {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("k1_turns needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    say(f"card: {smi}")
    blib, base = baseline(args.baseline)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if "gemv" in parts:
        gemv_bits(base, gen)
    if "gemv4" in parts:
        gemv4(base, gen)
    if "decode" in parts:
        decode(base, args.seed)
    if "k1" in parts:
        projections(base, gen)
    if "small" in parts:
        small_groups(base, gen)
    if "k8" in parts:
        k8(blib, gen)
    if "host" in parts:
        host(base, gen)
    if "ttft" in parts:
        ttft(base, args.seed)


if __name__ == "__main__":
    main()
