"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from `llm_inference_tpu_torch/csrc/`, prints the
card (nvidia-smi name and power limit), torch/CUDA versions and the build
time, then runs the port's two serving paths in turn, each through:
  2. its kernels held against their plain PyTorch versions on the card at
     LLaMA-2-7B shapes, and timed beside the plain version and a library
     call;
  3. a 2-layer LLaMA-2-7B-width model through `forward` on the CPU (plain
     versions) and on the card (kernels): the logits of a prefill and 8
     teacher-forced decode steps;
  4. three requests served by `InferenceEngine.generate` on full-depth
     LLaMA-2-7B (random weights from a seed), max_seq_len 512, greedy:
     timed passes on the engine as shipped (launch counts against the
     configuration's, TTFT, tokens/s), then an untimed pass that checks
     every logit is finite and the tokens repeat.
The paths: int8 per-channel weights and lm_head over a bf16 KV cache
(K1 int8, K2 bf16, K3), then int4 g=128 weights and lm_head over an int8
KV cache (K1 int4, K2 int8, K4, K6). Every check raises on failure. The
line before the last is a JSON object with one entry per kernel; the last
is {"ok": true, "device": {...}}. Imports nothing of JAX or the JAX
package.
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
from llm_inference_tpu_torch.ops.quantization import dequantize

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
BF16_FLOPS = 989e12                 # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                  # float32 outside the tensor cores
BF16 = torch.bfloat16
SEED = 0
CFG = llama2_7b()
QCFG8 = QuantConfig(weights="int8", quantize_embedding=True)
QCFG4 = QuantConfig(weights="int4", group_size=128, quantize_embedding=True)
MAX_SEQ = 512
L = CFG.num_layers
TAIL_MAX_ROWS = 32                  # K6 takes up to 32 rows (else K1 chain)


def say(*a):
    print(*a, flush=True)


def bound_ms(nbytes, flops, peak=BF16_FLOPS):
    """Least time for the work: bytes over HBM rate vs flops over peak."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / peak
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


def plain_ms(fn):
    return time_ms(fn, reps=4, warmup=1, trials=3)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def qbytes(qt):
    """Bytes of one layer's codes and scales."""
    n = qt.layer(0) if qt.stacked else qt
    return n.q.numel() + n.scale.numel() * 4


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
    """Check and time K1 on weight `qt` (stacked over layers or not) at M
    rows."""
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
    err = max_err(got, want)
    # same products, float32 sums in another order (int4 M > 8: rows
    # rounded to bf16, a 2^-9 relative error per input that averages out
    # over K): one bf16 step of the largest output (at most 2^-7 of it)
    tol = 2.0 ** -7 * want.float().abs().max().item()
    check(err <= tol, f"K1 {name} M={M}: max err {err} > {tol}")
    lay = (lambda i: i % reps_layers) if qt.stacked else (lambda i: None)
    ms = time_ms(lambda i: k1.quant_matmul(x, qt, lay(i), **kw))
    plain = plain_ms(lambda i: k1.quant_matmul_ref(x, qt, lay(i), **kw))
    # library yardstick: torch.matmul against bf16 dequantized copies
    n_lib = 4 if qt.stacked else 1
    deq = [dequantize(qt.layer(i) if qt.stacked else qt, BF16)
           for i in range(n_lib)]
    lib = time_ms(lambda i: torch.matmul(x, deq[i % n_lib]))
    del deq
    nbytes = qbytes(qt) + M * K * 2 + M * N * 2
    if prologue:
        nbytes += 2 * M * K * 2 + K * 2
    bnd, by = bound_ms(nbytes, 2 * M * K * N)
    say(f"  K1 int{qt.bits} {name:8s} M={M:3d} "
        f"{'norm+res' if prologue else 'plain   '} err {err:.3g} (tol "
        f"{tol:.3g})  kernel {ms:.4f} ms  bound {bnd:.4f} ms ({by})  plain "
        f"{plain:.3f} ms  torch.matmul(bf16) {lib:.4f} ms")
    return dict(ms=ms, plain=plain, lib=lib, bound=bnd, err=err, by=by)


def k1_cases(params, gen, names):
    """K1 on each weight the main path sends it, with the main path's
    prologue choice, at M = 1 (one decode step at B = 1) and M = 4 (the
    batch request), then wqkv at M = 128 (prefill). Returns the M = 1
    numbers by weight and the largest error."""
    lay = params["layers"]
    prologue = {"wqkv": True, "wo": False, "w_gateup": True,
                "w_down": False, "lm_head": False}
    step, err = {}, 0.0
    for M in (1, 4):
        for name in names:
            qt = params["lm_head"] if name == "lm_head" else lay[name]
            r = k1_case(name, qt, M, prologue[name], gen,
                        L if qt.stacked else 1)
            err = max(err, r["err"])
            if M == 1:
                step[name] = r
    err = max(err, k1_case("wqkv", lay["wqkv"], 1, False, gen, L)["err"])
    for pro in (True, False):
        err = max(err, k1_case("wqkv", lay["wqkv"], 128, pro, gen, L)["err"])
    return step, err


def k2_cases(gen, int8_cache):
    """K2 over [L, B, Hkv, 512, 128] caches (bf16, or int8 codes with
    scales): B = 1 at pos 191, B = 4 at mixed positions, GQA G = 4."""
    Hkv, D, S = CFG.num_kv_heads, CFG.head_dim, MAX_SEQ
    err_max, first = 0.0, None
    for B, G, positions in ((1, 1, [191]), (4, 1, [0, 77, 300, S - 1]),
                            (4, 4, [5, 128, 256, 400])):
        Hk = Hkv // G                       # GQA case: 8 kv heads of 4
        shape = (L, B, Hk, S, D)
        if int8_cache:
            kc = torch.randint(-128, 128, shape, generator=gen, device=DEV,
                               dtype=torch.int8)
            vc = torch.randint(-128, 128, shape, generator=gen, device=DEV,
                               dtype=torch.int8)
            ks = torch.rand((L, B, S, Hk), generator=gen, device=DEV) * 0.02
            vs = torch.rand((L, B, S, Hk), generator=gen, device=DEV) * 0.02
        else:
            kc = torch.randn(shape, generator=gen, device=DEV).to(BF16)
            vc = torch.randn(shape, generator=gen, device=DEV).to(BF16)
            ks = vs = None
        q = torch.randn((B, 1, Hk * G, D), generator=gen, device=DEV).to(BF16)
        pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
        sc = dict(k_scale=ks, v_scale=vs)
        got = k2.decode_attention(q, kc, vc, 3, pos, **sc)
        want = k2.decode_attention_ref(q, kc, vc, 3, pos, D ** -0.5, **sc)
        want = want.reshape(got.shape)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # bf16 output; p (times the V scale) is rounded to bf16 against a
        # different running max: a few bf16 steps (2^-8 relative) of the
        # largest output
        tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
        kind = "int8" if int8_cache else "bf16"
        check(err <= tol, f"K2 {kind} B={B} G={G}: max err {err} > {tol}")
        err_max = max(err_max, err)
        ms = time_ms(lambda i: k2.decode_attention(q, kc, vc, i % L, pos,
                                                   **sc))
        plain = plain_ms(lambda i: k2.decode_attention_ref(
            q, kc, vc, i % L, pos, D ** -0.5, **sc))
        # library yardstick: SDPA over (dequantized) bf16 K and V
        n_lib = 2
        if int8_cache:
            kd = [(kc[i].float() * ks[i].transpose(1, 2)[..., None]).to(BF16)
                  for i in range(n_lib)]
            vd = [(vc[i].float() * vs[i].transpose(1, 2)[..., None]).to(BF16)
                  for i in range(n_lib)]
        else:
            kd = [kc[i] for i in range(n_lib)]
            vd = [vc[i] for i in range(n_lib)]
        live = [p + 1 for p in positions]
        gqa = {"enable_gqa": True} if G > 1 else {}
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if len(set(positions)) == 1:
            n = live[0]
            lib = time_ms(lambda i: sdpa(
                q.transpose(1, 2), kd[i % n_lib][:, :, :n],
                vd[i % n_lib][:, :, :n], **gqa))
        else:
            slot = torch.arange(S, device=DEV)
            mask = (slot[None, :] <= pos[:, None].long())[:, None, None, :]
            lib = time_ms(lambda i: sdpa(
                q.transpose(1, 2), kd[i % n_lib], vd[i % n_lib],
                attn_mask=mask, **gqa))
        row = D * (1 if int8_cache else 2) + (4 if int8_cache else 0)
        nbytes = sum(2 * Hk * n * row for n in live) + 2 * q.numel() * 2
        flops = sum(4 * Hk * G * n * D for n in live)
        bnd, by = bound_ms(nbytes, flops)
        say(f"  K2 {kind} B={B} G={G} pos={positions} err {err:.3g} (tol "
            f"{tol:.3g})  kernel {ms:.4f} ms  bound {bnd:.5f} ms ({by})  "
            f"plain {plain:.3f} ms  sdpa {lib:.4f} ms")
        if first is None:
            first = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        del kc, vc, ks, vs, kd, vd
    return first, err_max


def k3_cases(gen):
    """K3: KV write, B = 1 and B = 4 with one offset past the end."""
    Hkv, D, S = CFG.num_kv_heads, CFG.head_dim, MAX_SEQ
    first = None
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
        if first is None:
            first = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        del kc, vc, kr, vr
    return first, 0.0


def k4_cases(gen):
    """K4: int8 quantize + write, B = 1 and B = 4 with one offset past the
    end; codes and scales must equal the plain version's bit for bit."""
    Hkv, D, S = CFG.num_kv_heads, CFG.head_dim, MAX_SEQ
    first = None
    for B, offs in ((1, [128]), (4, [0, 77, S - 1, S + 9])):
        caches = [torch.randint(-128, 128, (L, B, Hkv, S, D), generator=gen,
                                device=DEV, dtype=torch.int8)
                  for _ in range(2)]
        caches += [torch.rand((L, B, S, Hkv), generator=gen, device=DEV)
                    for _ in range(2)]
        ref = [c.clone() for c in caches]
        # the new rows as the model hands them over: column slices of the
        # fused qkv projection's output
        qkv = torch.randn((B, 1, 3 * Hkv, D), generator=gen,
                          device=DEV).to(BF16)
        kn = qkv[:, :, Hkv:2 * Hkv].transpose(1, 2)
        vn = qkv[:, :, 2 * Hkv:].transpose(1, 2)
        off = torch.tensor(offs, dtype=torch.int32, device=DEV)
        k3.quantize_write_token(*caches, 2, kn, vn, off)
        k3.quantize_write_token_ref(*ref, 2, kn, vn, off)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(caches, ref)),
              f"K4 B={B}: codes or scales differ from the plain version")
        ms = time_ms(lambda i: k3.quantize_write_token(*caches, i % L, kn,
                                                       vn, off))
        plain = time_ms(lambda i: k3.quantize_write_token_ref(
            *ref, i % L, kn, vn, off))
        rows = torch.arange(B, device=DEV)
        offl = torch.clamp(off.long(), 0, S - 1)
        new = torch.stack([kn[:, :, 0], vn[:, :, 0]]).float()

        def lib_write(i):
            # torch quantize ops on K and V at once, then index writes
            s = torch.clamp(new.abs().amax(-1, keepdim=True) / 127.0,
                            min=1e-8)
            q = torch.clamp(torch.round(new / s), -128, 127).to(torch.int8)
            ref[0][i % L][rows, :, offl] = q[0]
            ref[1][i % L][rows, :, offl] = q[1]
            ref[2][i % L][rows, offl] = s[0, ..., 0]
            ref[3][i % L][rows, offl] = s[1, ..., 0]
        lib = time_ms(lib_write)
        # float32 |x|, max, divide, round, clamp per element
        bnd, by = bound_ms(2 * B * Hkv * D * (2 + 1) + 2 * B * Hkv * 4
                           + B * 4, 5 * 2 * B * Hkv * D, FP32_FLOPS)
        say(f"  K4 B={B} offsets={offs} exact  kernel {ms:.4f} ms  bound "
            f"{bnd:.6f} ms ({by})  plain {plain:.4f} ms  torch ops "
            f"{lib:.4f} ms")
        if first is None:
            first = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        del caches, ref
    return first, 0.0


def k6_cases(params, gen):
    """K6 on layer weights of the int4 model at M = 1 and M = 4."""
    lay = params["layers"]
    wo, gu, dn = lay["wo"], lay["w_gateup"], lay["w_down"]
    H, I = CFG.hidden_size, CFG.intermediate_size
    eps = CFG.rms_norm_eps
    n_lib = 2
    deq = [[dequantize(w.layer(i), BF16) for w in (wo, gu, dn)]
           for i in range(n_lib)]
    first, err_max = None, 0.0
    for M in (1, 4):
        h = torch.randn((M, H), generator=gen, device=DEV).to(BF16)
        attn = torch.randn((M, H), generator=gen, device=DEV).to(BF16)
        gamma = (1 + 0.1 * torch.randn((H,), generator=gen, device=DEV)
                 ).to(BF16)
        args = (h, attn, wo, gu, dn, gamma, eps)
        got = k1.layer_tail_fused(*args, 1)
        want = k1.layer_tail_fused_ref(*args, 1)
        torch.cuda.synchronize()
        err = 0.0
        for g, w, what in zip(got, want, ("y", "h2")):
            e = max_err(g, w)
            # float32 sums in another order through three products, one
            # bf16 rounding: one bf16 step of the largest output
            tol = 2.0 ** -7 * w.float().abs().max().item()
            check(e <= tol, f"K6 M={M} {what}: max err {e} > {tol}")
            err = max(err, e)
        err_max = max(err_max, err)
        ms = time_ms(lambda i: k1.layer_tail_fused(*args, i % L))
        plain = plain_ms(lambda i: k1.layer_tail_fused_ref(*args, i % L))

        def lib_tail(i):
            w_o, w_gu, w_d = deq[i % n_lib]
            x = h + torch.matmul(attn, w_o)
            xn = x * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True)
                                 + eps).to(BF16) * gamma
            gate, up = torch.matmul(xn, w_gu).chunk(2, dim=-1)
            return torch.matmul(torch.nn.functional.silu(gate) * up, w_d), x
        lib = time_ms(lib_tail)
        nbytes = (qbytes(wo) + qbytes(gu) + qbytes(dn) + 2 * M * H * 2
                  + H * 2 + 2 * M * H * 2)
        bnd, by = bound_ms(nbytes, 2 * M * (H * H + H * 2 * I + I * H))
        say(f"  K6 M={M} err {err:.3g}  kernel {ms:.4f} ms  bound "
            f"{bnd:.4f} ms ({by})  plain {plain:.3f} ms  torch.matmul(bf16) "
            f"chain {lib:.4f} ms")
        if first is None:
            first = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
    del deq
    return first, err_max


# ------------------------------------------------------------------ phase 3

def phase_parity(qcfg, cache_dtype):
    say(f"phase 3: 2-layer LLaMA-2-7B-width {qcfg.weights} model, "
        f"{cache_dtype} cache, CPU plain vs GPU kernels")
    cfg = dataclasses.replace(CFG, num_layers=2)
    cpu = torch.device("cpu")
    p_cpu = llama.prepare_params(llama.init_params_quantized(
        cfg, qcfg, seed=SEED + 2, device=cpu))
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
                               cfg.head_dim, cache_dtype, device=dev)
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
BUCKETS = (32, 128)
COUNTERS = ("K1", "K2", "K3", "K4", "K6")


def counts():
    return dict(K1=k1.launches, K2=k2.launches, K3=k3.launches,
                K4=k3.quant_launches, K6=k1.tail_launches)


def zero_counts():
    k1.launches = k1.tail_launches = k2.launches = 0
    k3.launches = k3.quant_launches = 0


def expected_launches(weights, cache_dtype, prefill_rows, steps):
    """Kernel launches of one generate call: a prefill forward over
    `prefill_rows` rows (batch x bucket), then `steps` decode forwards.
    Per forward, K1 runs wqkv in every layer and lm_head once; the layer
    tail is K6 for int4 weights at <= 32 rows, else K1 wo, gate-up and
    down. Decode steps also write the cache (K4 int8, K3 bf16) and attend
    with K2; prefill writes and attends in plain PyTorch."""
    def forward(rows):
        tail = weights == "int4" and rows <= TAIL_MAX_ROWS
        return dict(K1=(1 if tail else 4) * L + 1, K6=L if tail else 0)
    pre, dec = forward(prefill_rows), forward(1)
    want = {c: 0 for c in COUNTERS}
    for c in ("K1", "K6"):
        want[c] = pre[c] + steps * dec[c]
    want["K2"] = L * steps
    want["K4" if cache_dtype == "int8" else "K3"] = L * steps
    return want


def phase_main_path(params, weights, cache_dtype):
    say(f"phase 4: InferenceEngine.generate, LLaMA-2-7B {weights}, "
        f"{cache_dtype} cache")
    ecfg = EngineConfig(max_seq_len=MAX_SEQ, prefill_buckets=BUCKETS,
                        decode_chunk=8)
    eng = InferenceEngine(CFG, params, engine_cfg=ecfg,
                          cache_dtype=cache_dtype, device=DEV)
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
    zero_counts()
    tokens = {}
    for rep in range(REPEATS):
        for (name, lens, new), batch in zip(REQUESTS, prompts):
            before = counts()
            res = serve(batch, new)
            torch.cuda.synchronize()
            d = {c: n - before[c] for c, n in counts().items()}
            steps = new - 1                  # the first token is prefill's
            check(all(len(r.token_ids) == new for r in res),
                  f"{name}: length")
            check(all(0 <= t < CFG.vocab_size for r in res
                      for t in r.token_ids), f"{name}: token outside vocab")
            rows = len(batch) * eng._bucket(max(len(p) for p in batch))
            want = expected_launches(weights, cache_dtype, rows, steps)
            check(d == want, f"{name}: launches {d} != expected {want}")
            ids = [r.token_ids for r in res]
            check(tokens.setdefault(name, ids) == ids,
                  f"{name}: greedy tokens differ between passes")
            r0 = res[0]
            say(f"  pass {rep}: {name}: TTFT {r0.ttft_s * 1e3:.2f} ms, "
                f"decode {r0.decode_tokens_per_s:.2f} tok/s (all rows), "
                f"launches {d}; tokens {r0.token_ids[:8]}...")
    total = counts()
    used = [c for c, n in expected_launches(weights, cache_dtype, 128,
                                            1).items() if n]
    check(all(total[c] > 0 for c in used), f"a kernel never ran: {total}")

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
    return total


# -------------------------------------------------------------------- paths

def entry(name, source, replaces, launches, err, r, per_step, work):
    """One kernel of the JSON line: per-call numbers times the calls of
    one decode step at B = 1."""
    return dict(name=name, route="cuda",
                source=f"llm_inference_tpu_torch/csrc/{source}",
                replaces=f"llm_inference_tpu/ops/pallas/{replaces}",
                launches=launches, max_abs_err=err,
                ms=per_step * r["ms"], plain_ms=per_step * r["plain"],
                bound_ms=per_step * r["bound"], bound_by=r["by"],
                library_ms=per_step * r["lib"], work=work)


def k1_entry(bits, launches, err, step, names):
    def total(key):
        return sum((1 if n == "lm_head" else L) * step[n][key]
                   for n in names)
    r = {k: total(k) for k in ("ms", "plain", "lib", "bound")}
    r["by"] = "bytes"
    per_layer = ", ".join(n for n in names if n != "lm_head")
    return entry(f"K1 quant_matmul (int{bits} fused-norm GEMV/GEMM)",
                 "quant_matmul.cu", "quant_matmul.py:496", launches, err, r,
                 1, f"one decode step of LLaMA-2-7B int{bits} at B=1: "
                 f"{L} x ({per_layer}) + lm_head, M=1")


def path_int8(gen):
    say(f"building LLaMA-2-7B int8 weights on the card (seed {SEED})")
    params = llama.prepare_params(llama.init_params_quantized(
        CFG, QCFG8, seed=SEED, device=DEV))
    torch.cuda.synchronize()
    say("phase 2 (int8 weights, bf16 cache): kernels vs plain versions on "
        "the card, LLaMA-2-7B shapes")
    names = ("wqkv", "wo", "w_gateup", "w_down", "lm_head")
    step, k1_err = k1_cases(params, gen, names)
    k2_step, k2_err = k2_cases(gen, int8_cache=False)
    k3_step, k3_err = k3_cases(gen)
    phase_parity(QCFG8, BF16)
    total = phase_main_path(params, "int8", BF16)
    del params
    return [
        k1_entry(8, total["K1"], k1_err, step, names),
        entry("K2 decode_attention (bf16 cache)", "decode_attention.cu",
              "decode_attention.py:489", total["K2"], k2_err, k2_step, L,
              "32 layers of one decode step at B=1, pos 191, S=512"),
        entry("K3 kv_write", "kv_write.cu", "kv_write.py:72", total["K3"],
              k3_err, k3_step, L, "32 layers of one decode step at B=1"),
    ]


def path_int4(gen):
    say(f"building LLaMA-2-7B int4 g=128 weights on the card (seed {SEED})")
    params = llama.prepare_params(llama.init_params_quantized(
        CFG, QCFG4, seed=SEED, device=DEV))
    torch.cuda.synchronize()
    say("phase 2 (int4 g=128 weights, int8 cache): kernels vs plain "
        "versions on the card, LLaMA-2-7B shapes")
    # decode runs K1 on wqkv and lm_head (the tail is K6); the prefill
    # chain (M > 32 rows) also runs wo, w_gateup and w_down through K1
    step, k1_err = k1_cases(params, gen, ("wqkv", "wo", "w_gateup",
                                          "w_down", "lm_head"))
    k2_step, k2_err = k2_cases(gen, int8_cache=True)
    k4_step, k4_err = k4_cases(gen)
    k6_step, k6_err = k6_cases(params, gen)
    phase_parity(QCFG4, "int8")
    total = phase_main_path(params, "int4", "int8")
    del params
    return [
        k1_entry(4, total["K1"], k1_err, step, ("wqkv", "lm_head")),
        entry("K2 decode_attention (int8 cache)", "decode_attention.cu",
              "decode_attention.py:489", total["K2"], k2_err, k2_step, L,
              "32 layers of one decode step at B=1, pos 191, S=512"),
        entry("K4 quantize_write_token (int8 KV write)", "kv_write.cu",
              "kv_write.py:152", total["K4"], k4_err, k4_step, L,
              "32 layers of one decode step at B=1"),
        entry("K6 layer_tail_fused (int4 wo, gate-up, SwiGLU, down)",
              "layer_tail.cu", "quant_matmul.py:699", total["K6"], k6_err,
              k6_step, L, "32 layers of one decode step at B=1, M=1"),
    ]


def main():
    t_start = time.perf_counter()
    phase_card()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    kernels = path_int8(gen)
    torch.cuda.empty_cache()
    kernels += path_int4(gen)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
