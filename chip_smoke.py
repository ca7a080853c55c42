"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from `llm_inference_tpu_torch/csrc/`, then:
  1. prints the card (nvidia-smi name and power limit), torch/CUDA versions
     and the build time;
  2. holds each kernel (K1 int8 fused-norm matmul, K2 decode attention,
     K3 KV write) against its plain PyTorch version on the card at
     LLaMA-2-7B shapes, and times kernel, plain version and a library call;
  3. runs a 2-layer LLaMA-2-7B-width model through `forward` on the CPU
     (plain versions) and on the card (kernels) and compares the logits of
     a prefill and 8 teacher-forced decode steps;
  4. serves three requests with `InferenceEngine.generate` on full-depth
     LLaMA-2-7B, int8 weights and lm_head (random, from a seed), bf16 KV
     cache, max_seq_len 512, greedy decoding: timed passes on the engine
     as shipped (launch counts, TTFT, tokens/s), then an untimed pass that
     checks every logit is finite and the tokens repeat.
Every check raises on failure. The line before the last is a JSON object
with one entry per kernel; the last is {"ok": true, "device": {...}}.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "runs the port on a GPU")

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            QuantConfig, llama2_7b)
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache
from llm_inference_tpu_torch.ops.kernels import _build
from llm_inference_tpu_torch.ops.kernels import decode_attention as k2
from llm_inference_tpu_torch.ops.kernels import kv_write as k3
from llm_inference_tpu_torch.ops.kernels import quant_matmul as k1

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
BF16_FLOPS = 989e12                 # dense bf16 tensor-core peak
BF16 = torch.bfloat16
SEED = 0
CFG = llama2_7b()
QCFG = QuantConfig(weights="int8", quantize_embedding=True)
MAX_SEQ = 512
L = CFG.num_layers


def say(*a):
    print(*a, flush=True)


def bound_ms(nbytes, flops):
    """Least time for the work: bytes over HBM rate vs flops over peak."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def time_ms(fn, reps=20, warmup=3, trials=5):
    """Device time of one fn(i) call (CUDA events): the median over trials
    of `reps` back-to-back calls. Each trial first parks the stream on a
    sleep kernel so the host enqueues all reps before the first runs —
    the events then bracket device work, not Python launch overhead."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    samples = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)        # ~20 ms of GPU clock
        a.record()
        for i in range(reps):
            fn(i)
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / reps)
    samples.sort()
    return samples[len(samples) // 2]


def check(ok, what):
    if not ok:
        raise AssertionError(what)


# ------------------------------------------------------------------ phase 1

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"card: {smi}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.lib()
    say(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds else 0:.1f} s)")
    return smi


# ------------------------------------------------------------------ phase 2

def k1_case(name, qt, M, prologue, gen, reps_layers):
    """Check and time K1 on weight `qt` (stacked [L, N, K]) at M rows."""
    K, N = qt.in_features, qt.out_features
    x = torch.randn((M, K), generator=gen, device=DEV).to(BF16)
    kw = {}
    if prologue:
        kw = dict(norm_gamma=(1 + 0.1 * torch.randn(
            (K,), generator=gen, device=DEV)).to(BF16),
            residual=torch.randn((M, K), generator=gen, device=DEV).to(BF16),
            want_x_out=True)
    layer = 1 if qt.stacked else None
    got = k1.quant_matmul(x, qt, layer, **kw)
    want = k1.quant_matmul_ref(x, qt, layer, **kw)
    torch.cuda.synchronize()
    if prologue:
        (got, got_x), (want, want_x) = got, want
        check(torch.equal(got_x, want_x), f"K1 {name}: x_out differs")
    err = (got.float() - want.float()).abs().max().item()
    # same products, float32 sums in another order: one bf16 step of the
    # largest output (at most 2^-7 of it)
    tol = 2.0 ** -7 * want.float().abs().max().item()
    check(err <= tol, f"K1 {name} M={M}: max err {err} > {tol}")
    lay = (lambda i: i % reps_layers) if qt.stacked else (lambda i: None)
    ms = time_ms(lambda i: k1.quant_matmul(x, qt, lay(i), **kw))
    plain = time_ms(lambda i: k1.quant_matmul_ref(x, qt, lay(i), **kw),
                    reps=4, warmup=1, trials=3)
    # library yardstick: torch.matmul against bf16 dequantized copies
    n_lib = 4 if qt.stacked else 1
    deq = [((qt.layer(i) if qt.stacked else qt).q.T.to(BF16)
            * qt.scale[i if qt.stacked else 0].to(BF16)).contiguous()
           for i in range(n_lib)]
    lib = time_ms(lambda i: torch.matmul(x, deq[i % n_lib]))
    del deq
    nbytes = N * K + N * 4 + M * K * 2 + M * N * 2
    if prologue:
        nbytes += 2 * M * K * 2 + K * 2
    bnd, by = bound_ms(nbytes, 2 * M * K * N)
    say(f"  K1 {name:8s} M={M:3d} {'norm+res' if prologue else 'plain   '} "
        f"err {err:.3g} (tol {tol:.3g})  kernel {ms:.4f} ms  bound "
        f"{bnd:.4f} ms ({by})  plain {plain:.3f} ms  torch.matmul(bf16) "
        f"{lib:.4f} ms")
    return dict(ms=ms, plain=plain, lib=lib, bound=bnd, err=err, by=by)


def phase_kernels(params):
    say("phase 2: kernels vs plain versions on the card, LLaMA-2-7B shapes")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    lay = params["layers"]
    step = {}                       # per-call numbers of one decode step
    k1_err = 0.0
    for name, prologue in (("wqkv", True), ("wo", False),
                           ("w_gateup", True), ("w_down", False)):
        r = k1_case(name, lay[name], 1, prologue, gen, L)
        step[name] = r                    # the main path's prologue choice
        k1_err = max(k1_err, r["err"])
    k1_err = max(k1_err, k1_case("wqkv", lay["wqkv"], 1, False, gen, L)["err"])
    step["lm_head"] = k1_case("lm_head", params["lm_head"], 1, False, gen, 1)
    k1_err = max(k1_err, step["lm_head"]["err"])
    # the batch-of-4 request decodes at M = 4 (w_down's 88 KB of rows take
    # the GEMV's large-shared-memory launch)
    for name, prologue in (("wqkv", True), ("wo", False),
                           ("w_gateup", True), ("w_down", False)):
        k1_err = max(k1_err, k1_case(name, lay[name], 4, prologue, gen,
                                     L)["err"])
    k1_err = max(k1_err, k1_case("lm_head", params["lm_head"], 4, False,
                                 gen, 1)["err"])
    for prologue in (True, False):
        r = k1_case("wqkv", lay["wqkv"], 128, prologue, gen, L)
        k1_err = max(k1_err, r["err"])

    # K2: decode attention over [L, B, 32, 512, 128] bf16 caches
    Hkv, D, S = CFG.num_kv_heads, CFG.head_dim, MAX_SEQ
    k2_err, k2_step = 0.0, None
    for B, G, positions in ((1, 1, [191]), (4, 1, [0, 77, 300, S - 1]),
                            (4, 4, [5, 128, 256, 400])):
        Hk = Hkv // G                       # GQA case: 8 kv heads of 4
        kc = torch.randn((L, B, Hk, S, D), generator=gen, device=DEV).to(BF16)
        vc = torch.randn((L, B, Hk, S, D), generator=gen, device=DEV).to(BF16)
        q = torch.randn((B, 1, Hk * G, D), generator=gen, device=DEV).to(BF16)
        pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
        got = k2.decode_attention(q, kc, vc, 3, pos)
        want = k2.decode_attention_ref(q, kc, vc, 3, pos, D ** -0.5)
        want = want.reshape(got.shape)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        # bf16 output; p is rounded to bf16 against a different running
        # max: a few bf16 steps (2^-8 relative) of the largest output
        tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
        check(err <= tol, f"K2 B={B} G={G}: max err {err} > {tol}")
        k2_err = max(k2_err, err)
        ms = time_ms(lambda i: k2.decode_attention(q, kc, vc, i % L, pos))
        plain = time_ms(lambda i: k2.decode_attention_ref(
            q, kc, vc, i % L, pos, D ** -0.5), reps=4, warmup=1, trials=3)
        live = [p + 1 for p in positions]
        gqa = {"enable_gqa": True} if G > 1 else {}
        if len(set(positions)) == 1:
            n = live[0]
            lib = time_ms(lambda i: torch.nn.functional.
                          scaled_dot_product_attention(
                              q.transpose(1, 2), kc[i % L][:, :, :n],
                              vc[i % L][:, :, :n], **gqa))
        else:
            slot = torch.arange(S, device=DEV)
            mask = (slot[None, :] <= pos[:, None].long())[:, None, None, :]
            lib = time_ms(lambda i: torch.nn.functional.
                          scaled_dot_product_attention(
                              q.transpose(1, 2), kc[i % L], vc[i % L],
                              attn_mask=mask, **gqa))
        nbytes = sum(2 * Hk * n * D * 2 for n in live) + 2 * q.numel() * 2
        flops = sum(4 * Hk * G * n * D for n in live)
        bnd, by = bound_ms(nbytes, flops)
        say(f"  K2 B={B} G={G} pos={positions} err {err:.3g} (tol {tol:.3g})  "
            f"kernel {ms:.4f} ms  bound {bnd:.5f} ms ({by})  plain "
            f"{plain:.3f} ms  sdpa {lib:.4f} ms")
        if k2_step is None:
            k2_step = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        del kc, vc

    # K3: KV write, B=4, one offset past the end (clamps to S-1)
    k3_err, k3_step = 0.0, None
    for B, offs in ((1, [128]), (4, [0, 77, S - 1, S + 9])):
        kc = torch.randn((L, B, Hkv, S, D), generator=gen, device=DEV).to(BF16)
        vc = torch.randn((L, B, Hkv, S, D), generator=gen, device=DEV).to(BF16)
        kr, vr = kc.clone(), vc.clone()
        kn = torch.randn((B, Hkv, 1, D), generator=gen, device=DEV).to(BF16)
        vn = torch.randn((B, Hkv, 1, D), generator=gen, device=DEV).to(BF16)
        off = torch.tensor(offs, dtype=torch.int32, device=DEV)
        k3.write_token(kc, vc, 2, kn, vn, off)
        k3.write_token_ref(kr, vr, 2, kn, vn, off)
        torch.cuda.synchronize()
        check(torch.equal(kc, kr) and torch.equal(vc, vr),
              f"K3 B={B}: caches differ from the plain version")
        ms = time_ms(lambda i: k3.write_token(kc, vc, i % L, kn, vn, off))
        plain = time_ms(lambda i: k3.write_token_ref(kr, vr, i % L, kn, vn,
                                                     off))
        rows = torch.arange(B, device=DEV)
        offl = torch.clamp(off.long(), 0, S - 1)

        def lib_write(i):
            kr[i % L][rows, :, offl] = kn[:, :, 0]
            vr[i % L][rows, :, offl] = vn[:, :, 0]
        lib = time_ms(lib_write)
        bnd, by = bound_ms(2 * 2 * B * Hkv * D * 2 + B * 4, 0)
        say(f"  K3 B={B} offsets={offs} exact  kernel {ms:.4f} ms  bound "
            f"{bnd:.6f} ms ({by})  plain {plain:.4f} ms  index_put "
            f"{lib:.4f} ms")
        if k3_step is None:
            k3_step = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        del kc, vc, kr, vr
    return step, k1_err, k2_step, k2_err, k3_step, k3_err


# ------------------------------------------------------------------ phase 3

def phase_parity():
    say("phase 3: 2-layer LLaMA-2-7B-width model, CPU plain vs GPU kernels")
    cfg = dataclasses.replace(CFG, num_layers=2)
    cpu = torch.device("cpu")
    p_cpu = llama.prepare_params(llama.init_params_quantized(
        cfg, QCFG, seed=SEED + 2, device=cpu))
    p_gpu = llama.params_to(p_cpu, DEV)
    B, T = 2, 64                          # M = 128 rows through K1
    lengths = [64, 41]
    gen = torch.Generator().manual_seed(SEED + 3)
    ids = torch.randint(1, cfg.vocab_size, (B, T), generator=gen,
                        dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    last = torch.tensor([n - 1 for n in lengths])

    def run(dev, p):
        c = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads, MAX_SEQ,
                               cfg.head_dim, BF16, device=dev)
        return c, llama.forward(cfg, p, ids.to(dev), pos.to(dev), c,
                                last_idx=last.to(dev))[0]

    finite = []

    def compare(l_cpu, l_gpu):
        finite.append(bool(torch.isfinite(l_cpu).all())
                      and bool(torch.isfinite(l_gpu).all()))
        return (l_gpu.cpu() - l_cpu).abs().max().item()

    with torch.no_grad():
        c_cpu, l_cpu = run(cpu, p_cpu)
        c_gpu, l_gpu = run(DEV, p_gpu)
        errs = [compare(l_cpu, l_gpu)]
        scale = l_cpu.abs().max().item()
        nxt = torch.tensor(lengths, dtype=torch.int32)[:, None]
        for _ in range(8):
            tok = l_cpu.argmax(-1).to(torch.int32)[:, None]
            l_cpu, _ = llama.forward(cfg, p_cpu, tok, nxt, c_cpu)
            l_gpu, _ = llama.forward(cfg, p_gpu, tok.to(DEV), nxt.to(DEV),
                                     c_gpu)
            errs.append(compare(l_cpu, l_gpu))
            scale = max(scale, l_cpu.abs().max().item())
            nxt = nxt + 1
    # bf16 activations through 2 layers: kernel and plain sums differ in
    # order, a bf16 rounding step upstream moves a logit by a few bf16
    # steps of |logit| (2^-8 relative); 4 such steps of the largest logit
    tol = 4 * 2.0 ** -8 * scale
    say(f"  logits max err per step {['%.4f' % e for e in errs]} "
        f"(tol {tol:.4f}, max |logit| {scale:.3f})")
    check(all(finite), "2-layer parity: non-finite logits")
    check(max(errs) <= tol, f"2-layer parity: {max(errs)} > {tol}")


# ------------------------------------------------------------------ phase 4

REQUESTS = (  # (name, prompt lengths, max_new_tokens)
    ("bench: 128-token prompt, 64 new", [128], 64),
    ("100-token prompt, 32 new", [100], 32),
    ("batch of 4 prompts <= 32 tokens, 16 new", [32, 17, 25, 9], 16),
)
REPEATS = 3       # timed passes over the three requests


def phase_main_path(params):
    say("phase 4: InferenceEngine.generate, LLaMA-2-7B int8, bf16 cache")
    eng = InferenceEngine(CFG, params, engine_cfg=EngineConfig(
        max_seq_len=MAX_SEQ, prefill_buckets=(32, 128), decode_chunk=8),
        device=DEV)
    gen = torch.Generator().manual_seed(SEED + 4)
    prompts = [[torch.randint(1, CFG.vocab_size, (n,), generator=gen
                              ).tolist() for n in lens]
               for _, lens, _ in REQUESTS]

    def serve(batch, new):
        return eng.generate(batch, GenerationConfig(
            max_new_tokens=new, greedy=True, eos_token_ids=()))
    # warm-up (allocator, first launches) outside the counts
    serve([prompts[0][0][:8]], 2)
    torch.cuda.synchronize()
    # timed passes on the engine as shipped
    k1.launches = k2.launches = k3.launches = 0
    tokens = {}
    for rep in range(REPEATS):
        for (name, lens, new), batch in zip(REQUESTS, prompts):
            before = (k1.launches, k2.launches, k3.launches)
            res = serve(batch, new)
            torch.cuda.synchronize()
            d = [a - b for a, b in zip(
                (k1.launches, k2.launches, k3.launches), before)]
            steps = new - 1                  # the first token is prefill's
            check(all(len(r.token_ids) == new for r in res),
                  f"{name}: length")
            check(all(0 <= t < CFG.vocab_size for r in res
                      for t in r.token_ids), f"{name}: token outside vocab")
            per_forward = 4 * L + 1
            check(d[0] == per_forward * (1 + steps),
                  f"{name}: K1 launches {d[0]} != {per_forward} x "
                  f"{1 + steps} forwards")
            check(d[1] == L * steps and d[2] == L * steps,
                  f"{name}: K2/K3 launches {d[1:]} != {L} x {steps} steps")
            ids = [r.token_ids for r in res]
            check(tokens.setdefault(name, ids) == ids,
                  f"{name}: greedy tokens differ between passes")
            r0 = res[0]
            say(f"  pass {rep}: {name}: TTFT {r0.ttft_s * 1e3:.2f} ms, "
                f"decode {r0.decode_tokens_per_s:.2f} tok/s (all rows), "
                f"launches K1 {d[0]} ({d[0] // (1 + steps)}/forward) "
                f"K2 {d[1]} K3 {d[2]}; tokens {r0.token_ids[:8]}...")
    counts = (k1.launches, k2.launches, k3.launches)
    check(all(c > 0 for c in counts), f"a kernel never ran: {counts}")

    # untimed pass: every logit of every forward is finite, and the
    # tokens repeat those of the timed passes
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    fwd = eng._forward

    def checked_forward(*args):
        logits, cache = fwd(*args)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache
    eng._forward = checked_forward
    for (name, lens, new), batch in zip(REQUESTS, prompts):
        ids = [r.token_ids for r in serve(batch, new)]
        check(ids == tokens[name], f"{name}: checked pass tokens differ")
    eng._forward = fwd
    check(bool(finite.item()), "a forward produced non-finite logits")
    say("  checked pass: all logits finite, tokens equal to the timed passes")
    return counts


def main():
    t_start = time.perf_counter()
    phase_card()
    say("building LLaMA-2-7B int8 weights on the card (seed "
        f"{SEED})")
    params = llama.prepare_params(llama.init_params_quantized(
        CFG, QCFG, seed=SEED, device=DEV))
    torch.cuda.synchronize()
    step, k1_err, k2_step, k2_err, k3_step, k3_err = phase_kernels(params)
    phase_parity()
    counts = phase_main_path(params)

    per_layer = ("wqkv", "wo", "w_gateup", "w_down")

    def k1_total(key):
        return (L * sum(step[n][key] for n in per_layer)
                + step["lm_head"][key])

    work_k1 = ("one decode step of LLaMA-2-7B at B=1: 32 x (wqkv, wo, "
               "w_gateup, w_down) + lm_head, M=1")
    kernels = [
        dict(name="K1 quant_matmul (int8 fused-norm GEMV/GEMM)",
             status="ported", route="cuda",
             source="llm_inference_tpu_torch/csrc/quant_matmul.cu",
             replaces="llm_inference_tpu/ops/pallas/quant_matmul.py:496",
             launches=counts[0], max_abs_err=k1_err, ms=k1_total("ms"),
             plain_ms=k1_total("plain"), bound_ms=k1_total("bound"),
             bound_by="bytes", library_ms=k1_total("lib"), work=work_k1),
        dict(name="K2 decode_attention", status="ported", route="cuda",
             source="llm_inference_tpu_torch/csrc/decode_attention.cu",
             replaces="llm_inference_tpu/ops/pallas/decode_attention.py:489",
             launches=counts[1], max_abs_err=k2_err, ms=L * k2_step["ms"],
             plain_ms=L * k2_step["plain"], bound_ms=L * k2_step["bound"],
             bound_by=k2_step["by"], library_ms=L * k2_step["lib"],
             work="32 layers of one decode step at B=1, pos 191, S=512"),
        dict(name="K3 kv_write", status="ported", route="cuda",
             source="llm_inference_tpu_torch/csrc/kv_write.cu",
             replaces="llm_inference_tpu/ops/pallas/kv_write.py:72",
             launches=counts[2], max_abs_err=k3_err, ms=L * k3_step["ms"],
             plain_ms=L * k3_step["plain"], bound_ms=L * k3_step["bound"],
             bound_by=k3_step["by"], library_ms=L * k3_step["lib"],
             work="32 layers of one decode step at B=1"),
    ]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
