"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from `llm_inference_tpu_torch/csrc/`, prints the
card (nvidia-smi name and power limit), torch/CUDA versions and the build
time, then runs the port's three serving paths in turn, each through:
  2. its kernels held against their plain PyTorch versions on the card at
     LLaMA-2-7B shapes (decode, and 2048-row prefill chunks over a
     4096-slot cache; K8 also at 1024 rows, the second chunk; K1's MMA
     branch on every projection at 16, 64 and 128 rows), and timed
     beside the plain version and a library call;
  3. a 2-layer LLaMA-2-7B-width model through `forward` on the CPU (plain
     versions) and on the card (kernels): the logits of a 128-row prefill
     and 4 teacher-forced decode steps over 512 slots, then of two 512-row
     prefill chunks over 2048 slots (the tiled GEMM and flash attention);
  4. requests served by `InferenceEngine.generate` on full-depth
     LLaMA-2-7B (random weights from a seed), greedy: a 3000-token prompt
     (two prefill chunks) and a batch of 1500 and 700 tokens over 4096
     slots with the default prefill buckets, and three short requests over
     512 slots; timed passes on the engine as shipped (launch counts
     against the configuration's, TTFT, tokens/s and their spread), then an
     untimed pass that checks every logit is finite and the tokens repeat.
The paths: (i) int8 per-channel weights and lm_head over a bf16 KV cache
(K1, K8 int8, K9 bf16, K2 bf16), (ii) int4 g=128 weights and lm_head
over an int8 KV cache (K1, K8 int4, K9 int8, K2 int8, K6), (iii) the
same weights over an int4 KV cache (K1, K8 int4, K9 int4, K5, K6); every
forward of the three rotates q and k and writes the dense cache in one
launch a layer (rope_write, the redesigned K3/K4), which phase 2 holds to
its plain version at decode (B = 1, and B = 4 with an offset past the
end), a 128-row prefill and a 2048-row chunk in each cache kind, beside
K3, K4 (and K3 on packed int4 rows, the scale write) as their own entry
points still run them; and (iv) the continuous-batching
schedulers on the weights of (ii): phase 2 holds K10a (bf16 and int8
pages), K10b (int4 pages) and K11 (three bodies) to their plain versions
over scattered pages; phase 3 runs a 2-layer model through the paged
forward (a fresh prefill, a chunk over history, decode steps) for each
pool kind; phase 4 serves 8 slots through ContinuousBatchingScheduler
(dense int8 KV) and PagedScheduler (paged int8 KV with and without the
prefix cache, on a full pool and on a 26-page one that forces
preemption, and paged int4 and bf16 KV), checks each run's launches
against the forwards it made and its streams against a reference run,
and prints tokens/s, TTFT, inter-token latency and the schedulers'
counters. Path (v), the B = 1 chat path with LLMI_LAYER_MEGA=1 on the
weights of (i) and (ii): phase 2 holds K12 (the whole-layer megakernel,
its four instantiations: int8 or int4 weights over a bf16 or int8 cache)
and its two row writes to their plain versions; phase 3 runs a 2-layer
model through the mega route, CPU plain vs card kernels and mega vs
split on the card; phase 4 chats three rounds through ChatSession with
penalties and a logit bias over a synthetic 32,000-piece vocabulary,
generates 64 tokens after a 3000-token prompt on both weight sets, each
with the megakernel on and off (streams compared, launches checked
against the mega route's, tokens/s printed), and runs the CLI REPL once
as a subprocess. Path (vi), tensor parallelism at tp = 2 with two ranks
sharing the card over gloo (parallel.run_ranks): phase 2 holds K7 (the
TP layer's FFN block) to its plain version at one rank's shard of
LLaMA-2-7B in groups of 128 and 32 codes, and K1 and K8 (groups of 8,
16, 32), K6 and K12 (8, 16) to theirs on 2-layer 7B-width models; phase 3
runs a 2-layer model through the TP forward against tp = 1 on the card
and on the CPU; phase 4 serves a 128- and a 3000-token prompt, 64 tokens
each, on full-depth int4 g=128 over an int8 cache at tp = 2 and at
tp = 1 (streams compared, launches checked, TTFT, tokens/s and a decode
step's busy and collective time printed), and runs the CLI at --tp 2.
Every check raises on failure. The line before the last
is a JSON object with one entry per kernel and path; the last is {"ok":
true, "device": {...}}. Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "runs the port on a GPU")

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            QuantConfig, llama2_7b)
from llm_inference_tpu_torch.engine import engine as engine_mod
from llm_inference_tpu_torch.engine import scheduler
from llm_inference_tpu_torch.engine.engine import ChatSession, InferenceEngine
from llm_inference_tpu_torch.engine.tokenizer import (BPETokenizer,
                                                      load_tokenizer)
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache, paged_kvcache
from llm_inference_tpu_torch.ops.kernels import _build
from llm_inference_tpu_torch.ops.kernels import decode_attention as k2
from llm_inference_tpu_torch.ops.kernels import flash_attention as k9
from llm_inference_tpu_torch.ops.kernels import kv_write as k3
from llm_inference_tpu_torch.ops.kernels import layer_fused as k12
from llm_inference_tpu_torch.ops.kernels import paged_attention as k10
from llm_inference_tpu_torch.ops.kernels import paged_flash as k11
from llm_inference_tpu_torch.ops.kernels import quant_matmul as k1
from llm_inference_tpu_torch.ops.quantization import (QTensor, dequantize,
                                                      unpack_kv4)
from llm_inference_tpu_torch.parallel import run_ranks
from llm_inference_tpu_torch.tools import tp_ranks

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
BF16_FLOPS = 989e12                 # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                  # float32 outside the tensor cores
BF16 = torch.bfloat16
SEED = 0
CFG = llama2_7b()
QCFG8 = QuantConfig(weights="int8", quantize_embedding=True)
QCFG4 = QuantConfig(weights="int4", group_size=128, quantize_embedding=True)
MAX_SEQ = 512                       # the short requests' cache
LONG_SEQ = 4096                     # the long requests' cache
CHUNK = 2048                        # the largest default prefill bucket
L = CFG.num_layers
TAIL_MAX_ROWS = 32                  # K6 takes up to 32 rows (else K1 chain)
K1_MAX_ROWS = 128                   # above, the projections run K8
# teacher-forced decode steps of the 2-layer parity phases of paths (i)-(v),
# few enough that the whole run stays well inside its time limit
PARITY_STEPS = 4


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
    n_lib = min(4, qt.q.shape[0]) if qt.stacked else 1
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
    return dict(ms=ms, plain=plain, lib=lib, bound=bnd, err=err, by=by,
                t_bytes=nbytes / HBM_BYTES_PER_S * 1e3,
                t_ops=2 * M * K * N / BF16_FLOPS * 1e3)


PROJECTIONS = ("wqkv", "wo", "w_gateup", "w_down")
PREFILL_ROWS = (16, 64, 128)        # K1's MMA branch: 8 < M <= 128


def k1_cases(params, gen, names):
    """K1 on each weight the main path sends it, with the main path's
    prologue choice, at M = 1 (one decode step at B = 1) and M = 4 (the
    batch request), int4's wqkv and lm_head also at M = 8 (the serving
    batch of path (iv)), then wqkv at M = 128 (prefill), then its MMA
    branch on each projection at each of PREFILL_ROWS. Returns the M = 1
    numbers by weight, the largest error and the MMA branch's numbers by
    (M, name)."""
    lay = params["layers"]
    prologue = {"wqkv": True, "wo": False, "w_gateup": True,
                "w_down": False, "lm_head": False}
    int4 = lay["wqkv"].bits == 4
    step, err, gemv = {}, 0.0, {}
    for M in (1, 4, 8):
        for name in names:
            if M == 8 and not (int4 and name in ("wqkv", "lm_head")):
                continue
            qt = params["lm_head"] if name == "lm_head" else lay[name]
            r = gemv[(M, name)] = k1_case(name, qt, M, prologue[name], gen,
                                          L if qt.stacked else 1)
            err = max(err, r["err"])
            if M == 1:
                step[name] = r
    if int4:
        for name in ("wqkv", "lm_head"):
            say(f"  K1 int4 GEMV {name} M = 1 / 4 / 8: kernel " + " / ".join(
                f"{gemv[(M, name)]['ms']:.4f}" for M in (1, 4, 8))
                + " ms, bound " + " / ".join(
                f"{gemv[(M, name)]['bound']:.4f}" for M in (1, 4, 8))
                + ", torch.matmul " + " / ".join(
                f"{gemv[(M, name)]['lib']:.4f}" for M in (1, 4, 8)))
    err = max(err, k1_case("wqkv", lay["wqkv"], 1, False, gen, L)["err"])
    for pro in (True, False):
        err = max(err, k1_case("wqkv", lay["wqkv"], 128, pro, gen, L)["err"])
    prefill = {}
    for M in PREFILL_ROWS:
        for name in PROJECTIONS:
            r = prefill[(M, name)] = k1_case(name, lay[name], M,
                                             prologue[name], gen, L)
            err = max(err, r["err"])
        t = prefill_chain(prefill, M)
        say(f"  K1 MMA branch, {L} x ({', '.join(PROJECTIONS)}) at M={M}: "
            f"kernel {t['ms']:.3f} ms, torch.matmul {t['lib']:.3f} ms, "
            f"bound {t['bound']:.3f} ms ({t['by']})")
    return step, err, prefill


def prefill_chain(prefill, M):
    """The MMA branch's numbers for one M-row prefill: L layers of the
    four projections; the bound is the sum of each call's."""
    r = {k: L * sum(prefill[(M, n)][k] for n in PROJECTIONS)
         for k in ("ms", "plain", "lib", "bound", "t_bytes", "t_ops")}
    r["by"] = "bytes" if r["t_bytes"] >= r["t_ops"] else "operations"
    return r


def k2_cases(gen, int8_cache):
    """K2 over [L, B, Hkv, S, 128] caches (bf16, or int8 codes with
    scales): B = 1 at pos 191, B = 4 at mixed positions and GQA G = 4 over
    512 slots, then B = 1 at pos 3060 over 4096 slots (the long request's
    decode, each head's slots split over 8 blocks). Returns the first
    case's numbers, the pos-3060 case's and the largest error."""
    Hkv, D = CFG.num_kv_heads, CFG.head_dim
    err_max, first, long = 0.0, None, None
    for B, G, positions, S in (
            (1, 1, [191], MAX_SEQ), (4, 1, [0, 77, 300, MAX_SEQ - 1], MAX_SEQ),
            (4, 4, [5, 128, 256, 400], MAX_SEQ), (1, 1, [3060], LONG_SEQ)):
        positions = [min(p, S - 1) for p in positions]
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
        say(f"  K2 {kind} B={B} G={G} S={S} pos={positions} err {err:.3g} "
            f"(tol {tol:.3g})  kernel {ms:.4f} ms  bound {bnd:.5f} ms ({by})  "
            f"plain {plain:.3f} ms  sdpa {lib:.4f} ms")
        r = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        if first is None:
            first = r
        if S == LONG_SEQ:
            long = r
        del kc, vc, ks, vs, kd, vd
    return first, long, err_max


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
    """K6 on layer weights of an int4 model at M = 1 (a decode step), 4
    and 8 (the schedulers' batch); returns the M = 1 case."""
    lay = params["layers"]
    wo, gu, dn = lay["wo"], lay["w_gateup"], lay["w_down"]
    depth = wo.q.shape[0]
    H, I = CFG.hidden_size, CFG.intermediate_size
    eps = CFG.rms_norm_eps
    n_lib = 2
    deq = [[dequantize(w.layer(i), BF16) for w in (wo, gu, dn)]
           for i in range(n_lib)]
    first, err_max = None, 0.0
    for M in (1, 4, 8):
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
        ms = time_ms(lambda i: k1.layer_tail_fused(*args, i % depth))
        plain = plain_ms(lambda i: k1.layer_tail_fused_ref(*args, i % depth))

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


PROLOGUE = {"wqkv": True, "wo": False, "w_gateup": True, "w_down": False}


def k8_cases(params, gen, Ms=(CHUNK, CHUNK // 2), names=tuple(PROLOGUE),
             route=1):
    """K8 on the layer weights `names` at each row count of `Ms` (the
    first and second chunk of a 3000-token prompt) with the main path's
    prologue choice, through the kernel `route` (qmm_tiled_route: 1 wgmma,
    0 mma.sync). The plain version and torch.matmul (bf16 dequantized) run
    on the same rows; the plain version is timed at the first M only.
    Returns the per-chunk totals at the first M."""
    lay = params["layers"]
    res, err_max = {}, 0.0
    for M in Ms:
        for name in names:
            pro = PROLOGUE[name]
            qt = lay[name]
            depth = qt.q.shape[0]
            K, N = qt.in_features, qt.out_features
            check(_build.lib().qmm_tiled_route(K, N, qt.groups, qt.bits)
                  == route, f"K8 {name}: not on route {route}")
            x = torch.randn((M, K), generator=gen, device=DEV).to(BF16)
            kw = {}
            if pro:
                kw = dict(norm_gamma=(1 + 0.1 * torch.randn(
                    (K,), generator=gen, device=DEV)).to(BF16),
                    residual=torch.randn((M, K), generator=gen,
                                         device=DEV).to(BF16),
                    want_x_out=True)
            got = k1.quant_matmul(x, qt, 1, **kw)
            want = k1.quant_matmul_ref(x, qt, 1, **kw)
            torch.cuda.synchronize()
            if pro:
                (got, got_x), (want, want_x) = got, want
                check(torch.equal(got_x, want_x), f"K8 {name}: x_out differs")
            err = max_err(got, want)
            # the same bf16 products, float32 sums in another order, and the
            # prologue's rsqrt may move a row by one bf16 rounding: one bf16
            # step of the largest output
            tol = 2.0 ** -7 * want.float().abs().max().item()
            check(err <= tol, f"K8 {name} M={M}: max err {err} > {tol}")
            err_max = max(err_max, err)
            del got, want
            ms = time_ms(lambda i: k1.quant_matmul(x, qt, i % depth, **kw),
                         reps=10)
            plain = float("nan")
            if M == Ms[0]:
                plain = plain_ms(lambda i: k1.quant_matmul_ref(
                    x, qt, i % depth, **kw))
            deq = [dequantize(qt.layer(i), BF16) for i in range(2)]
            lib = time_ms(lambda i: torch.matmul(x, deq[i % 2]), reps=10)
            del deq
            nbytes = qbytes(qt) + M * K * 2 + M * N * 2
            if pro:
                nbytes += 2 * M * K * 2 + K * 2
            bnd, by = bound_ms(nbytes, 2 * M * K * N)
            say(f"  K8 int{qt.bits} {name:8s} M={M} "
                f"{'norm+res' if pro else 'plain   '} err {err:.3g} (tol "
                f"{tol:.3g})  kernel {ms:.4f} ms  bound {bnd:.4f} ms ({by})  "
                f"plain {plain:.3f} ms  torch.matmul(bf16) {lib:.4f} ms "
                f"({2 * M * K * N / ms / 1e9:.0f} TFLOP/s)")
            res[(M, name)] = dict(ms=ms, plain=plain, lib=lib, bound=bnd,
                                  by=by, flops=2 * M * K * N)
    totals = {}
    for M in Ms:
        totals[M] = {k: L * sum(res[(M, n)][k] for n in names)
                     for k in ("ms", "plain", "lib", "bound", "flops")}
        t = totals[M]
        say(f"  K8 int{qt.bits} ({', '.join(names)}) x {L} layers, M={M}: "
            f"kernel {t['ms']:.2f} ms ({t['flops'] / t['ms'] / 1e9:.0f} "
            f"TFLOP/s), torch.matmul {t['lib']:.2f} ms, bound "
            f"{t['bound']:.2f} ms")
    total = totals[Ms[0]]
    total["by"] = "operations"
    return total, err_max


def random_cache(gen, kind, L_, B, S):
    """A random [L_, B, Hkv, S, Dc] cache of `kind` ("bf16", "int8",
    "int4"; every int8 byte is a valid packed int4 pair), with scales."""
    Hkv, D = CFG.num_kv_heads, CFG.head_dim
    Dc = D // 2 if kind == "int4" else D
    shape = (L_, B, Hkv, S, Dc)
    if kind == "bf16":
        return (torch.randn(shape, generator=gen, device=DEV).to(BF16),
                torch.randn(shape, generator=gen, device=DEV).to(BF16),
                None, None)
    codes = [torch.randint(-128, 128, shape, generator=gen, device=DEV,
                           dtype=torch.int8) for _ in range(2)]
    qmax = 7.0 if kind == "int4" else 127.0
    scales = [torch.rand((L_, B, S, Hkv), generator=gen, device=DEV)
              * 2.0 / qmax + 1e-3 for _ in range(2)]
    return codes[0], codes[1], scales[0], scales[1]


def dequant_layer(c, s, layer, kind):
    """One layer's K or V as bf16 [B, Hkv, S, D] (the library yardstick's
    input)."""
    if s is None:
        return c[layer]
    vals = unpack_kv4(c[layer]) if kind == "int4" else c[layer]
    return (vals.float() * s[layer].transpose(1, 2)[..., None]).to(BF16)


def attn_bytes(kind, Hkv, live):
    """Bytes of the K and V rows (and scales) of `live` slots."""
    D = CFG.head_dim
    row = {"bf16": 2 * D, "int8": D + 4, "int4": D // 2 + 4}[kind]
    return 2 * Hkv * live * row


def k9_cases(gen, kind):
    """K9 over a 4096-slot cache of `kind`: a first 2048-row chunk
    (positions 0-2047) and a second 1024-row chunk at positions 2048-3071
    over the first's slots. Library yardstick: scaled_dot_product_attention
    over the dequantized K and V (is_causal for the first chunk, a mask for
    the second)."""
    S, Hq, Hkv, D = LONG_SEQ, CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    L_ = 4
    kc, vc, ks, vs = random_cache(gen, kind, L_, 1, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    first, err_max = None, 0.0
    for T, start in ((CHUNK, 0), (CHUNK // 2, CHUNK)):
        q = torch.randn((1, T, Hq, D), generator=gen, device=DEV).to(BF16)
        pos = (start + torch.arange(T, device=DEV, dtype=torch.int32))[None]
        sc = dict(k_scale=ks, v_scale=vs)
        got = k9.flash_attention(q, kc, vc, 1, pos, **sc)
        want = k9.flash_attention_ref(q, kc, vc, 1, pos, D ** -0.5, **sc)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # bf16 output; the same 64-slot blocks and rounding points, float32
        # sums in another order (int4: p in two bf16 parts): a few bf16
        # steps (2^-8 relative) of the largest output
        tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
        check(err <= tol, f"K9 {kind} T={T} start={start}: max err {err} "
              f"> {tol}")
        err_max = max(err_max, err)
        del got, want
        ms = time_ms(lambda i: k9.flash_attention(q, kc, vc, i % L_, pos,
                                                  **sc), reps=10)
        plain = plain_ms(lambda i: k9.flash_attention_ref(
            q, kc, vc, i % L_, pos, D ** -0.5, **sc))
        live = start + T
        kd = [dequant_layer(kc, ks, i, kind)[:, :, :live] for i in range(2)]
        vd = [dequant_layer(vc, vs, i, kind)[:, :, :live] for i in range(2)]
        qt = q.transpose(1, 2)
        gqa = {"enable_gqa": True} if Hq != Hkv else {}
        if start == 0:
            lib = time_ms(lambda i: sdpa(qt, kd[i % 2], vd[i % 2],
                                         is_causal=True, **gqa), reps=10)
        else:
            mask = (torch.arange(live, device=DEV)[None, :]
                    <= pos[0, :, None].long())
            lib = time_ms(lambda i: sdpa(qt, kd[i % 2], vd[i % 2],
                                         attn_mask=mask, **gqa), reps=10)
        del kd, vd
        pairs = sum(range(start + 1, start + T + 1))     # visible (row, slot)
        nbytes = attn_bytes(kind, Hkv, live) + 2 * q.numel() * 2 + T * 4
        bnd, by = bound_ms(nbytes, 4 * Hq * D * pairs)
        say(f"  K9 {kind} T={T} positions {start}-{start + T - 1} err "
            f"{err:.3g} (tol {tol:.3g})  kernel {ms:.4f} ms  bound "
            f"{bnd:.4f} ms ({by})  plain {plain:.3f} ms  sdpa {lib:.4f} ms "
            f"({4 * Hq * D * pairs / ms / 1e9:.0f} TFLOP/s)")
        if first is None:
            first = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
    del kc, vc, ks, vs
    return first, err_max


def k5_cases(gen):
    """K5 over a 4096-slot int4 cache: B = 1 at pos 3060 (the 3000-token
    request's decode) and B = 2 at 1530 and 730 (the batch request's)."""
    S, Hkv, D = LONG_SEQ, CFG.num_kv_heads, CFG.head_dim
    sdpa = torch.nn.functional.scaled_dot_product_attention
    first, err_max = None, 0.0
    for B, positions in ((1, [3060]), (2, [1530, 730])):
        positions = [min(p, S - 1) for p in positions]
        kc, vc, ks, vs = random_cache(gen, "int4", L, B, S)
        q = torch.randn((B, 1, CFG.num_heads, D), generator=gen,
                        device=DEV).to(BF16)
        pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
        sc = dict(k_scale=ks, v_scale=vs)
        got = k2.decode_attention(q, kc, vc, 1, pos, **sc)
        want = k2.decode_attention_ref(q, kc, vc, 1, pos, D ** -0.5, **sc)
        want = want.reshape(got.shape)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # float32 p on both sides, float32 sums in another order, one bf16
        # rounding: a few bf16 steps of the largest output
        tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
        check(err <= tol, f"K5 B={B}: max err {err} > {tol}")
        err_max = max(err_max, err)
        ms = time_ms(lambda i: k2.decode_attention(q, kc, vc, i % L, pos,
                                                   **sc))
        plain = plain_ms(lambda i: k2.decode_attention_ref(
            q, kc, vc, i % L, pos, D ** -0.5, **sc))
        live = max(positions) + 1
        kd = [dequant_layer(kc, ks, i, "int4")[:, :, :live] for i in range(2)]
        vd = [dequant_layer(vc, vs, i, "int4")[:, :, :live] for i in range(2)]
        mask = (torch.arange(live, device=DEV)[None, :]
                <= pos[:, None].long())[:, None, None, :]
        gqa = {"enable_gqa": True} if CFG.num_heads != Hkv else {}
        lib = time_ms(lambda i: sdpa(q.transpose(1, 2), kd[i % 2],
                                     vd[i % 2], attn_mask=mask, **gqa))
        nbytes = (sum(attn_bytes("int4", Hkv, p + 1) for p in positions)
                  + 2 * q.numel() * 2)
        flops = sum(4 * CFG.num_heads * (p + 1) * D for p in positions)
        bnd, by = bound_ms(nbytes, flops)
        say(f"  K5 int4 B={B} pos={positions} err {err:.3g} (tol "
            f"{tol:.3g})  kernel {ms:.4f} ms  bound {bnd:.5f} ms ({by})  "
            f"plain {plain:.3f} ms  sdpa {lib:.4f} ms")
        if first is None:
            first = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        del kc, vc, ks, vs, kd, vd
    return first, err_max


def int4_write_cases(gen):
    """The int4 cache's decode write: K3 on the packed 64-byte rows and the
    scale write, B = 1 and B = 2 with one offset past the end; both exact
    against their plain versions."""
    Hkv, D, S = CFG.num_kv_heads, CFG.head_dim, LONG_SEQ
    out = {}
    for B, offs in ((1, [3000]), (2, [1500, S + 9])):
        kc, vc, ks, vs = random_cache(gen, "int4", 4, B, S)
        ref = [t.clone() for t in (kc, vc, ks, vs)]
        kn = torch.randint(-128, 128, (B, Hkv, 1, D // 2), generator=gen,
                           device=DEV, dtype=torch.int8)
        vn = torch.randint(-128, 128, (B, Hkv, 1, D // 2), generator=gen,
                           device=DEV, dtype=torch.int8)
        ksn = torch.rand((B, 1, Hkv), generator=gen, device=DEV)
        vsn = torch.rand((B, 1, Hkv), generator=gen, device=DEV)
        off = torch.tensor(offs, dtype=torch.int32, device=DEV)
        k3.write_token(kc, vc, 2, kn, vn, off)
        k3.write_token_ref(ref[0], ref[1], 2, kn, vn, off)
        k3.write_token_scales(ks, vs, 2, ksn, vsn, off)
        k3.write_token_scales_ref(ref[2], ref[3], 2, ksn, vsn, off)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((kc, vc, ks, vs), ref)),
              f"int4 cache write B={B}: differs from the plain version")
        rows = torch.arange(B, device=DEV)
        offl = torch.clamp(off.long(), 0, S - 1)
        for name, kern, plain_fn, lib_fn, nbytes in (
                ("K3 packed rows",
                 lambda i: k3.write_token(kc, vc, i % 4, kn, vn, off),
                 lambda i: k3.write_token_ref(ref[0], ref[1], i % 4, kn, vn,
                                              off),
                 lambda i: (ref[0][i % 4].__setitem__((rows, slice(None),
                                                       offl), kn[:, :, 0]),
                            ref[1][i % 4].__setitem__((rows, slice(None),
                                                       offl), vn[:, :, 0])),
                 2 * 2 * B * Hkv * D // 2 + B * 4),
                ("scale write",
                 lambda i: k3.write_token_scales(ks, vs, i % 4, ksn, vsn,
                                                 off),
                 lambda i: k3.write_token_scales_ref(ref[2], ref[3], i % 4,
                                                     ksn, vsn, off),
                 lambda i: (ref[2][i % 4].__setitem__((rows, offl),
                                                      ksn[:, 0]),
                            ref[3][i % 4].__setitem__((rows, offl),
                                                      vsn[:, 0])),
                 2 * 2 * B * Hkv * 4 + B * 4)):
            ms = time_ms(kern)
            plain = time_ms(plain_fn)
            lib = time_ms(lib_fn)
            bnd, by = bound_ms(nbytes, 0)
            say(f"  {name} B={B} offsets={offs} exact  kernel {ms:.4f} ms  "
                f"bound {bnd:.6f} ms ({by})  plain {plain:.4f} ms  "
                f"index_put {lib:.4f} ms")
            out.setdefault(name, dict(ms=ms, plain=plain, lib=lib,
                                      bound=bnd, by=by))
        del kc, vc, ks, vs, ref
    return out


KV_BITS = {"bf16": 16, "int8": 8, "int4": 4}
# (B, T, offsets, slots) of the RoPE-and-write cases: decode at B = 1 and
# at B = 4 with an offset past the end, a 128-row prefill and a 2048-row
# chunk
ROPE_WRITE_CASES = ((1, 1, [191], MAX_SEQ),
                    (4, 1, [0, 77, MAX_SEQ - 1, MAX_SEQ + 9], MAX_SEQ),
                    (1, 128, [0], MAX_SEQ), (1, CHUNK, [0], LONG_SEQ))


def rope_write_cases(gen, kind):
    """The RoPE and KV write (`rope_write`, the redesigned K3/K4) over a
    4-layer cache of `kind` at LLaMA-2-7B widths, q, k and v the column
    slices of one qkv projection, in ROPE_WRITE_CASES: the rotated q,
    codes or rows and scales equal to the plain version's bit for bit;
    timed beside the plain version and the torch chain the kernel
    replaces (the RoPE ops on q and k at once, the torch quantize ops for
    a quantized cache, then index writes). Returns the numbers by (B, T)."""
    H, Hkv, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    bits = KV_BITS[kind]
    half = D // 2
    out = {}
    for B, T, offs, S in ROPE_WRITE_CASES:
        kc, vc, ks, vs = random_cache(gen, kind, 4, B, S)
        ref = [None if t is None else t.clone() for t in (kc, vc, ks, vs)]
        qkv = torch.randn((B, T, (H + 2 * Hkv) * D), generator=gen,
                          device=DEV).to(BF16)
        q, k, v = (qkv[..., lo * D:(lo + n) * D].reshape(B, T, n, D)
                   for lo, n in ((0, H), (H, Hkv), (H + Hkv, Hkv)))
        off = torch.tensor(offs, dtype=torch.int32, device=DEV)
        start = torch.clamp(off.long(), 0, S - T)
        slots = start[:, None] + torch.arange(T, device=DEV)      # [B, T]
        cos_t, sin_t = llama.rope_table(CFG, S, DEV)
        cos, sin = cos_t[slots], sin_t[slots]
        got = k3.rope_write(q, k, v, cos, sin, off, kc, vc, 2, ks, vs, bits)
        want = k3.rope_write_ref(q, k, v, cos, sin, off, ref[0], ref[1], 2,
                                 ref[2], ref[3], bits)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and all(
            a is None or torch.equal(a, b)
            for a, b in zip((kc, vc, ks, vs), ref)),
            f"rope_write {kind} B={B} T={T}: differs from the plain version")
        ms = time_ms(lambda i: k3.rope_write(q, k, v, cos, sin, off, kc, vc,
                                             i % 4, ks, vs, bits))
        plain = plain_ms(lambda i: k3.rope_write_ref(
            q, k, v, cos, sin, off, ref[0], ref[1], i % 4, ref[2], ref[3],
            bits))
        rows = torch.arange(B, device=DEV)[:, None]
        c1, c2 = cos[:, :, None, :half], cos[:, :, None, half:]
        s1, s2 = sin[:, :, None, :half], sin[:, :, None, half:]

        def lib_chain(i):
            qk = qkv[..., :(H + Hkv) * D].reshape(B, T, H + Hkv, D).float()
            x1, x2 = qk[..., :half], qk[..., half:]
            rot = torch.cat([x1 * c1 - x2 * s1, x2 * c2 + x1 * s2],
                            -1).to(BF16)
            kv = torch.stack([rot[:, :, H:], v])       # [2, B, T, Hkv, D]
            if bits != 16:
                qmax = 127.0 if bits == 8 else 7.0
                x = kv.float()
                sc = torch.clamp(x.abs().amax(-1, keepdim=True)
                                 / torch.full_like(x[..., :1], qmax),
                                 min=1e-8)
                kv = torch.clamp(torch.round(x / sc), -qmax - 1, qmax)
                if bits == 4:
                    kv = kv[..., half:] * 16 + kv[..., :half] + 8
                kv = kv.to(torch.int8)
                ref[2][i % 4][rows, slots] = sc[0, ..., 0]
                ref[3][i % 4][rows, slots] = sc[1, ..., 0]
            ref[0][i % 4][rows, :, slots] = kv[0]
            ref[1][i % 4][rows, :, slots] = kv[1]
            return rot[:, :, :H]
        lib = time_ms(lib_chain, reps=4 if T > 1 else 20)
        dc = D // 2 if bits == 4 else D * (2 if bits == 16 else 1)
        nbytes = (B * T * (H + 2 * Hkv) * D * 2 + 2 * B * T * D * 4 + B * 4
                  + B * T * H * D * 2 + 2 * B * T * Hkv * dc
                  + (2 * B * T * Hkv * 4 if bits != 16 else 0))
        # float32 RoPE: two products and a sum per rotated value; the
        # quantizer's |x|, max, divide, round and clamp per K and V value
        flops = (3 * B * T * (H + Hkv) * D
                 + (5 * 2 * B * T * Hkv * D if bits != 16 else 0))
        bnd, by = bound_ms(nbytes, flops, FP32_FLOPS)
        say(f"  rope_write {kind} B={B} T={T} offsets={offs} exact  kernel "
            f"{ms:.4f} ms  bound {bnd:.6f} ms ({by})  plain {plain:.4f} ms  "
            f"torch chain {lib:.4f} ms")
        out[(B, T)] = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        del kc, vc, ks, vs, ref, qkv
    return out


def rope_write_entry(kind, launches, r, replaces):
    """The kernels line's entry of the RoPE and KV write over a `kind`
    cache: one decode step at B = 1 (32 calls), with the 128-row prefill
    and the 2048-row chunk beside it."""
    def chain(case, what):
        c = r[case]
        return dict(ms=L * c["ms"], plain_ms=L * c["plain"],
                    bound_ms=L * c["bound"], bound_by=c["by"],
                    library_ms=L * c["lib"], work=what)
    return dict(
        entry(f"K3/K4 rope_write (RoPE of q and k + {kind} KV write)",
              "kv_write.cu", replaces, launches, 0.0, r[(1, 1)], L,
              "32 layers of one decode step at B=1"),
        prefill128=chain((1, 128), "32 layers of a 128-row prefill, B=1"),
        chunk=chain((1, CHUNK), "32 layers of a 2048-row prefill chunk, "
                    "B=1"))


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

    def new_cache(dev, batch, slots):
        return kvcache.init_cache(cfg.num_layers, batch, cfg.num_kv_heads,
                                  slots, cfg.head_dim, cache_dtype,
                                  device=dev)

    finite = []

    def compare(l_cpu, l_gpu):
        finite.append(bool(torch.isfinite(l_cpu).all())
                      and bool(torch.isfinite(l_gpu).all()))
        return (l_gpu.cpu() - l_cpu).abs().max().item()

    with torch.no_grad():
        c_cpu, c_gpu = new_cache(cpu, B, MAX_SEQ), new_cache(DEV, B, MAX_SEQ)
        l_cpu = llama.forward(cfg, p_cpu, ids, pos, c_cpu, last_idx=last)[0]
        l_gpu = llama.forward(cfg, p_gpu, ids.to(DEV), pos.to(DEV), c_gpu,
                              last_idx=last.to(DEV))[0]
        errs = [compare(l_cpu, l_gpu)]
        scale = l_cpu.abs().max().item()
        nxt = torch.tensor(lengths, dtype=torch.int32)[:, None]
        for _ in range(PARITY_STEPS):
            tok = l_cpu.argmax(-1).to(torch.int32)[:, None]
            l_cpu, _ = llama.forward(cfg, p_cpu, tok, nxt, c_cpu)
            l_gpu, _ = llama.forward(cfg, p_gpu, tok.to(DEV), nxt.to(DEV),
                                     c_gpu)
            errs.append(compare(l_cpu, l_gpu))
            scale = max(scale, l_cpu.abs().max().item())
            nxt = nxt + 1
        del c_cpu, c_gpu
        # two 512-row chunks over 2048 slots (T·S = 2^20): the projections
        # take K8 and attention K9 on the card, the second chunk over the
        # first's slots
        S2, T2 = 2048, 512
        check(llama.attention_route((1, T2, cfg.num_heads, cfg.head_dim),
                                    S2, cache_dtype != BF16) == "flash",
              "phase 3: a 512-row chunk over 2048 slots must take K9")
        ids2 = torch.randint(1, cfg.vocab_size, (1, 2 * T2), generator=gen,
                             dtype=torch.int32)
        c_cpu, c_gpu = new_cache(cpu, 1, S2), new_cache(DEV, 1, S2)
        before = (k1.tiled_launches, k9.launches)
        for o in (0, T2):
            pos2 = (o + torch.arange(T2, dtype=torch.int32))[None]
            l_cpu = llama.forward(cfg, p_cpu, ids2[:, o:o + T2], pos2,
                                  c_cpu)[0]
            l_gpu = llama.forward(cfg, p_gpu, ids2[:, o:o + T2].to(DEV),
                                  pos2.to(DEV), c_gpu)[0]
            errs.append(compare(l_cpu, l_gpu))
            scale = max(scale, l_cpu.abs().max().item())
        check(k1.tiled_launches - before[0] == 2 * 4 * cfg.num_layers
              and k9.launches - before[1] == 2 * cfg.num_layers,
              "phase 3: the long chunks did not run K8 and K9")
    # bf16 activations through 2 layers: kernel and plain sums differ in
    # order, a bf16 rounding step upstream moves a logit by a few bf16
    # steps of |logit| (2^-8 relative); 4 such steps of the largest logit
    tol = 4 * 2.0 ** -8 * scale
    say(f"  logits max err per step (prefill, {PARITY_STEPS} decode steps, "
        f"2 long chunks) {['%.4f' % e for e in errs]} (tol {tol:.4f}, max "
        f"|logit| {scale:.3f})")
    check(all(finite), "2-layer parity: non-finite logits")
    check(max(errs) <= tol, f"2-layer parity: {max(errs)} > {tol}")


# ------------------------------------------------------------------ phase 4

REQUESTS = (  # (name, prompt lengths, max_new_tokens, long engine)
    ("3000-token prompt, 64 new", [3000], 64, True),
    ("batch of 1500 + 700 tokens, 32 new", [1500, 700], 32, True),
    ("bench: 128-token prompt, 64 new", [128], 64, False),
    ("100-token prompt, 32 new", [100], 32, False),
    ("batch of 4 prompts <= 32 tokens, 16 new", [32, 17, 25, 9], 16, False),
)
REPEATS = 3       # timed passes over the requests
BUCKETS = (32, 128)                 # the short requests' engine
COUNTERS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "KS",
            "K10a", "K10b", "K11", "K12", "RW", "QRW", "KR")


def counts():
    return dict(K1=k1.launches, K2=k2.launches, K3=k3.launches,
                K4=k3.quant_launches, K5=k2.int4_launches,
                K6=k1.tail_launches, K7=k1.ffn_launches,
                K8=k1.tiled_launches, K9=k9.launches,
                KS=k3.scale_launches, K10a=k10.launches,
                K10b=k10.int4_launches, K11=k11.launches, K12=k12.launches,
                RW=k3.rows_launches, QRW=k3.qrows_launches,
                KR=k3.rope_launches)


def zero_counts():
    k1.launches = k1.tail_launches = k1.tiled_launches = 0
    k1.mma_launches = 0
    k1.ffn_launches = 0
    k2.launches = k2.int4_launches = k9.launches = 0
    k3.launches = k3.quant_launches = k3.scale_launches = 0
    k3.rope_launches = 0
    k10.launches = k10.int4_launches = k11.launches = 0
    k12.launches = k3.rows_launches = k3.qrows_launches = 0


def prefill_chunks(eng, lens):
    """(batch, rows) of each prefill forward the engine runs for prompts
    of these lengths (engine.prefill's chunking)."""
    ecfg = eng.engine_cfg
    chunk = max(b for b in ecfg.prefill_buckets if b <= ecfg.max_seq_len)
    out = []
    for o in range(0, max(lens), chunk):
        need = max(max(min(n - o, chunk), 0) for n in lens)
        out.append((len(lens), min(eng._bucket(max(need, 1)),
                                    ecfg.max_seq_len - o)))
    return out


def forward_launches(want, weights, cache_dtype, batch, rows, S, ps=0,
                     history=False, mega=False, tp=False):
    """Add one forward's kernel launches to `want`: batch x rows tokens
    over an S-slot dense cache (ps = 0) or a paged one of page size ps
    (history: a chunk over earlier pages). The projections run K8 above
    128 rows and K1 below: wqkv in every layer, and wo, gate-up, down
    unless the layer tail is K6 (int4 weights, <= 32 rows); lm_head is K1
    on the batch's last rows; attention is K9, K2 or K5, K10a, K10b or K11
    where llama.attention_route says (plain otherwise). Every dense
    forward rotates q and k and writes the cache in one launch a layer
    (rope_write, "KR": the redesigned K3/K4, any cache kind, any rows);
    every paged write and its RoPE are plain PyTorch, and K3, K4 and the
    scale write run only in their own phase-2 cases. On the mega route (`mega`: llama.layer_route says "mega")
    every layer is K12 and its row write (write_rows over a bf16 cache,
    quantize_write_rows over an int8 one), and lm_head is K1. One rank of a
    tensor-parallel forward (`tp`) runs wo as K1 and the FFN block as K7
    where the single-card layer runs K6."""
    if mega:
        want["K12"] += L
        want["RW" if cache_dtype == BF16 else "QRW"] += L
        want["K1"] += 1
        return
    M = batch * rows
    tail = weights == "int4" and M <= TAIL_MAX_ROWS
    projections = 4 if not tail else 2 if tp else 1
    want["K8" if M > K1_MAX_ROWS else "K1"] += projections * L
    want["K7" if tp else "K6"] += L if tail else 0
    want["K1"] += 1
    int4 = cache_dtype == "int4"
    route = llama.attention_route(
        (batch, rows, CFG.num_heads, CFG.head_dim), S, cache_dtype != BF16,
        ps, history)
    kernel = {"flash": "K9", "decode": "K5" if int4 else "K2",
              "paged_flash": "K11",
              "paged_decode": "K10b" if int4 else "K10a"}.get(route)
    if kernel:
        want[kernel] += L
    if not ps:
        want["KR"] += L


def expected_mma_launches(weights, chunks):
    """Those of a generate call's K1 launches that take its MMA branch
    (k1.mma_launches): the projections of its prefill forwards of 8 < M <=
    128 rows (forward_launches' rule; lm_head and the decode steps of at
    most 8 rows whose rows fit the GEMV's shared memory run the GEMV)."""
    n = 0
    for batch, rows in chunks:
        M = batch * rows
        if 8 < M <= K1_MAX_ROWS:
            n += (1 if weights == "int4" and M <= TAIL_MAX_ROWS else 4) * L
    return n


def expected_launches(weights, cache_dtype, chunks, S, steps, mega=False,
                      tp=False):
    """Kernel launches of one generate call over an S-slot cache: prefill
    forwards of (batch, rows) `chunks`, then `steps` decode forwards (with
    `mega`, LLMI_LAYER_MEGA=1, a single sequence's steps take the mega
    route; with `tp`, one rank's launches)."""
    want = {c: 0 for c in COUNTERS}
    for batch, rows in chunks:
        forward_launches(want, weights, cache_dtype, batch, rows, S, tp=tp)
    for _ in range(steps):
        forward_launches(want, weights, cache_dtype, chunks[0][0], 1, S,
                         mega=mega and chunks[0][0] == 1, tp=tp)
    return want


def spread(xs):
    xs = sorted(xs)
    return f"{xs[0]:.2f} / {xs[len(xs) // 2]:.2f} / {xs[-1]:.2f}"


def phase_main_path(params, weights, cache_dtype):
    say(f"phase 4: InferenceEngine.generate, LLaMA-2-7B {weights}, "
        f"{cache_dtype} cache")
    engines = {
        False: InferenceEngine(CFG, params, engine_cfg=EngineConfig(
            max_seq_len=MAX_SEQ, prefill_buckets=BUCKETS, decode_chunk=8),
            cache_dtype=cache_dtype, device=DEV),
        True: InferenceEngine(CFG, params, engine_cfg=EngineConfig(
            max_seq_len=LONG_SEQ, decode_chunk=8), cache_dtype=cache_dtype,
            device=DEV)}
    check(max(engines[True].engine_cfg.prefill_buckets) == CHUNK,
          "the long engine's largest bucket is 2048")
    gen = torch.Generator().manual_seed(SEED + 4)
    prompts = [[torch.randint(1, CFG.vocab_size, (n,), generator=gen
                              ).tolist() for n in lens]
               for _, lens, _, _ in REQUESTS]

    def serve(eng, batch, new):
        return eng.generate(batch, GenerationConfig(
            max_new_tokens=new, greedy=True, eos_token_ids=()))
    # warm-up (allocator, first launches) outside the counts: a short
    # prompt on each engine, a 300-token one (K8, K9) on the long one
    serve(engines[False], [prompts[2][0][:8]], 2)
    serve(engines[True], [prompts[0][0][:300]], 2)
    torch.cuda.synchronize()
    # timed passes on the engine as shipped
    zero_counts()
    tokens, ttft, tps = {}, {}, {}
    for rep in range(REPEATS):
        for (name, lens, new, long), batch in zip(REQUESTS, prompts):
            eng = engines[long]
            before = counts()
            before_mma = k1.mma_launches
            res = serve(eng, batch, new)
            torch.cuda.synchronize()
            d = {c: n - before[c] for c, n in counts().items()}
            d_mma = k1.mma_launches - before_mma
            steps = new - 1                  # the first token is prefill's
            check(all(len(r.token_ids) == new for r in res),
                  f"{name}: length")
            check(all(0 <= t < CFG.vocab_size for r in res
                      for t in r.token_ids), f"{name}: token outside vocab")
            want = expected_launches(weights, cache_dtype,
                                     prefill_chunks(eng, lens),
                                     eng.engine_cfg.max_seq_len, steps)
            check(d == want, f"{name}: launches {d} != expected {want}")
            want_mma = expected_mma_launches(weights,
                                             prefill_chunks(eng, lens))
            check(d_mma == want_mma, f"{name}: K1 MMA branch launches "
                  f"{d_mma} != expected {want_mma}")
            ids = [r.token_ids for r in res]
            check(tokens.setdefault(name, ids) == ids,
                  f"{name}: greedy tokens differ between passes")
            r0 = res[0]
            ttft.setdefault(name, []).append(r0.ttft_s * 1e3)
            tps.setdefault(name, []).append(r0.decode_tokens_per_s)
            say(f"  pass {rep}: {name}: TTFT {r0.ttft_s * 1e3:.2f} ms, "
                f"decode {r0.decode_tokens_per_s:.2f} tok/s (all rows), "
                f"launches {d}; tokens {r0.token_ids[:8]}...")
    total = counts()
    total["K1 MMA"] = k1.mma_launches
    check(total["K1 MMA"] > 0, "K1's MMA branch never ran")
    for name, *_ in REQUESTS:
        say(f"  {name}: TTFT min/median/max {spread(ttft[name])} ms, "
            f"decode {spread(tps[name])} tok/s over {REPEATS} passes")
    used = [c for c, n in expected_launches(
        weights, cache_dtype, prefill_chunks(engines[True], [3000]),
        LONG_SEQ, 1).items() if n]
    check(all(total[c] > 0 for c in used), f"a kernel never ran: {total}")

    # untimed pass: every logit of every forward is finite, and the
    # tokens repeat those of the timed passes
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    for eng in engines.values():
        fwd = eng._forward

        def checked_forward(*args, _fwd=fwd):
            logits, cache = _fwd(*args)
            finite.logical_and_(torch.isfinite(logits).all())
            return logits, cache
        eng._forward = checked_forward
    for (name, lens, new, long), batch in zip(REQUESTS, prompts):
        ids = [r.token_ids for r in serve(engines[long], batch, new)]
        check(ids == tokens[name], f"{name}: checked pass tokens differ")
    check(bool(finite.item()), "a forward produced non-finite logits")
    say("  checked pass: all logits finite, tokens equal to the timed passes")
    del engines
    return total


# -------------------------------------------------------------------- paths

def entry(name, source, replaces, launches, err, r, per_step, work):
    """One kernel of the JSON line: per-call numbers times `per_step`
    calls of the unit `work` names."""
    return dict(name=name, route="cuda",
                source=f"llm_inference_tpu_torch/csrc/{source}",
                replaces=f"llm_inference_tpu/ops/pallas/{replaces}",
                launches=launches, max_abs_err=err,
                ms=per_step * r["ms"], plain_ms=per_step * r["plain"],
                bound_ms=per_step * r["bound"], bound_by=r["by"],
                library_ms=per_step * r["lib"], work=work)


def long_case(r):
    """The decode attention kernels' pos-3060 case beside their first:
    one decode step of 32 layers at B=1 over 4096 slots."""
    return dict(ms=L * r["ms"], plain_ms=L * r["plain"],
                bound_ms=L * r["bound"], bound_by=r["by"],
                library_ms=L * r["lib"],
                work="32 layers of one decode step at B=1, pos 3060, S=4096")


def k1_entry(bits, launches, err, step, names):
    def total(key):
        return sum((1 if n == "lm_head" else L) * step[n][key]
                   for n in names)
    r = {k: total(k) for k in ("ms", "plain", "lib", "bound")}
    r["by"] = "bytes"
    per_layer = ", ".join(n for n in names if n != "lm_head")
    return entry(f"K1 quant_matmul (int{bits} fused-norm GEMV/GEMM)",
                 "quant_matmul.cu" if bits == 8 else "qmm4_gemv.cu",
                 "quant_matmul.py:496", launches, err, r,
                 1, f"one decode step of LLaMA-2-7B int{bits} at B=1: "
                 f"{L} x ({per_layer}) + lm_head, M=1")


def k1_mma_entry(bits, launches, err, prefill):
    return entry(f"K1 quant_matmul MMA branch (int{bits}, 8 < M <= 128)",
                 "quant_matmul_tiled.cu", "quant_matmul.py:496", launches,
                 err, prefill_chain(prefill, 128), 1,
                 f"one 128-row prefill of LLaMA-2-7B int{bits}: {L} x "
                 f"({', '.join(PROJECTIONS)}), M=128")


def k8_entry(bits, launches, err, r):
    return entry(f"K8 quant_matmul tiled prefill GEMM (int{bits})",
                 "quant_matmul_tiled.cu", "quant_matmul.py:379", launches,
                 err, r, 1, f"one 2048-row prefill chunk of LLaMA-2-7B "
                 f"int{bits}: {L} x (wqkv, wo, w_gateup, w_down), M=2048")


def k9_entry(kind, launches, err, r):
    return entry(f"K9 flash_attention ({kind} cache)", "flash_attention.cu",
                 "flash_attention.py:251", launches, err, r, L,
                 f"32 layers of the first 2048-row causal prefill chunk "
                 f"over a 4096-slot {kind} cache, B=1")


def build_params(qcfg):
    params = llama.prepare_params(llama.init_params_quantized(
        CFG, qcfg, seed=SEED, device=DEV))
    torch.cuda.synchronize()
    return params


def path_int8(gen):
    """Path (i); returns its weights (path (v) reuses them) and entries."""
    say(f"path (i): LLaMA-2-7B int8 weights, bf16 cache (seed {SEED})")
    params = build_params(QCFG8)
    say("phase 2 (int8 weights, bf16 cache): kernels vs plain versions on "
        "the card, LLaMA-2-7B shapes")
    names = ("wqkv", "wo", "w_gateup", "w_down", "lm_head")
    step, k1_err, k1_pre = k1_cases(params, gen, names)
    k8_r, k8_err = k8_cases(params, gen)
    k9_r, k9_err = k9_cases(gen, "bf16")
    k2_step, k2_long, k2_err = k2_cases(gen, int8_cache=False)
    k3_step, k3_err = k3_cases(gen)
    kr = rope_write_cases(gen, "bf16")
    phase_parity(QCFG8, BF16)
    total = phase_main_path(params, "int8", BF16)
    return params, [
        k1_entry(8, total["K1"], k1_err, step, names),
        k1_mma_entry(8, total["K1 MMA"], k1_err, k1_pre),
        k8_entry(8, total["K8"], k8_err, k8_r),
        k9_entry("bf16", total["K9"], k9_err, k9_r),
        dict(entry("K2 decode_attention (bf16 cache)", "decode_attention.cu",
                   "decode_attention.py:489", total["K2"], k2_err, k2_step, L,
                   "32 layers of one decode step at B=1, pos 191, S=512"),
             pos3060=long_case(k2_long)),
        rope_write_entry("bf16", total["KR"], kr, "kv_write.py:72"),
        entry("K3 kv_write", "kv_write.cu", "kv_write.py:72", total["K3"],
              k3_err, k3_step, L, "32 layers of one decode step at B=1"),
    ]


def path_int4(gen):
    say(f"path (ii): LLaMA-2-7B int4 g=128 weights, int8 cache (seed "
        f"{SEED})")
    params = build_params(QCFG4)
    say("phase 2 (int4 g=128 weights, int8 cache): kernels vs plain "
        "versions on the card, LLaMA-2-7B shapes")
    # decode runs K1 on wqkv and lm_head (the tail is K6); the prefill
    # chain (32 < M <= 128 rows) also runs wo, w_gateup and w_down
    step, k1_err, k1_pre = k1_cases(params, gen, ("wqkv", "wo", "w_gateup",
                                                  "w_down", "lm_head"))
    k8_r, k8_err = k8_cases(params, gen)
    k9_r, k9_err = k9_cases(gen, "int8")
    k2_step, k2_long, k2_err = k2_cases(gen, int8_cache=True)
    k4_step, k4_err = k4_cases(gen)
    kr = rope_write_cases(gen, "int8")
    k6_step, k6_err = k6_cases(params, gen)
    phase_parity(QCFG4, "int8")
    total = phase_main_path(params, "int4", "int8")
    shared = dict(params=params, step=step, k1_err=k1_err, k1_pre=k1_pre,
                  k8_r=k8_r, k8_err=k8_err, k6_step=k6_step, k6_err=k6_err)
    return [
        k1_entry(4, total["K1"], k1_err, step, ("wqkv", "lm_head")),
        k1_mma_entry(4, total["K1 MMA"], k1_err, k1_pre),
        k8_entry(4, total["K8"], k8_err, k8_r),
        k9_entry("int8", total["K9"], k9_err, k9_r),
        dict(entry("K2 decode_attention (int8 cache)", "decode_attention.cu",
                   "decode_attention.py:489", total["K2"], k2_err, k2_step, L,
                   "32 layers of one decode step at B=1, pos 191, S=512"),
             pos3060=long_case(k2_long)),
        rope_write_entry("int8", total["KR"], kr, "kv_write.py:152"),
        entry("K4 quantize_write_token (int8 KV write)", "kv_write.cu",
              "kv_write.py:152", total["K4"], k4_err, k4_step, L,
              "32 layers of one decode step at B=1"),
        entry("K6 layer_tail_fused (int4 wo, gate-up, SwiGLU, down)",
              "layer_tail.cu", "quant_matmul.py:699", total["K6"], k6_err,
              k6_step, L, "32 layers of one decode step at B=1, M=1"),
    ], shared


def path_int4_kv4(gen, shared):
    """Path (iii): the int4 weights of path (ii) (their K1, K8 and K6 cases
    ran there) over an int4 cache."""
    say("path (iii): LLaMA-2-7B int4 g=128 weights, int4 cache (the weights "
        "of path (ii))")
    params = shared["params"]
    say("phase 2 (int4 cache): kernels vs plain versions on the card, "
        "LLaMA-2-7B shapes")
    k9_r, k9_err = k9_cases(gen, "int4")
    k5_r, k5_err = k5_cases(gen)
    writes = int4_write_cases(gen)
    kr = rope_write_cases(gen, "int4")
    phase_parity(QCFG4, "int4")
    total = phase_main_path(params, "int4", "int4")
    del params
    return [
        k1_entry(4, total["K1"], shared["k1_err"], shared["step"],
                 ("wqkv", "lm_head")),
        k1_mma_entry(4, total["K1 MMA"], shared["k1_err"],
                     shared["k1_pre"]),
        k8_entry(4, total["K8"], shared["k8_err"], shared["k8_r"]),
        k9_entry("int4", total["K9"], k9_err, k9_r),
        entry("K5 decode_attention (int4 cache)", "decode_attention.cu",
              "decode_attention.py:424", total["K5"], k5_err, k5_r, L,
              "32 layers of one decode step at B=1, pos 3060, S=4096"),
        rope_write_entry("int4", total["KR"], kr, "kv_write.py:72"),
        entry("K3 kv_write (int4 packed rows)", "kv_write.cu",
              "kv_write.py:72", total["K3"], 0.0, writes["K3 packed rows"],
              L, "32 layers of one decode step at B=1"),
        entry("write_token_scales (int4 cache scale write)", "kv_write.cu",
              "kv_write.py:343", total["KS"], 0.0, writes["scale write"], L,
              "32 layers of one decode step at B=1"),
        entry("K6 layer_tail_fused (int4 wo, gate-up, SwiGLU, down)",
              "layer_tail.cu", "quant_matmul.py:699", total["K6"],
              shared["k6_err"], shared["k6_step"], L,
              "32 layers of one decode step at B=1, M=1"),
    ]


# ---------------------------------------------------------------- path (iv)

PAGE = 128                    # the paged scheduler's default page size
NB_LONG = LONG_SEQ // PAGE    # table entries of a 4096-slot sequence
KV_DTYPE = {"bf16": BF16, "int8": "int8", "int4": "int4"}


def paged_pool(gen, kind, L_, P):
    """Random pools [L_, P, Hkv, PAGE, Dc] of `kind` with scales [L_, P,
    PAGE, Hkv] (as random_cache). Page 0, the null page that unallocated
    entries point at, holds NaN (codes or scales), as stale garbage may."""
    Hkv, D = CFG.num_kv_heads, CFG.head_dim
    Dc = D // 2 if kind == "int4" else D
    shape = (L_, P, Hkv, PAGE, Dc)
    if kind == "bf16":
        k = torch.randn(shape, generator=gen, device=DEV).to(BF16)
        v = torch.randn(shape, generator=gen, device=DEV).to(BF16)
        k[:, 0] = v[:, 0] = float("nan")
        return k, v, None, None
    codes = [torch.randint(-128, 128, shape, generator=gen, device=DEV,
                           dtype=torch.int8) for _ in range(2)]
    qmax = 7.0 if kind == "int4" else 127.0
    scales = [torch.rand((L_, P, PAGE, Hkv), generator=gen, device=DEV)
              * 2.0 / qmax + 1e-3 for _ in range(2)]
    for sc in scales:
        sc[:, 0] = float("nan")
    return codes[0], codes[1], scales[0], scales[1]


def scattered_table(B, NB, P, live_blocks, seed):
    """[B, NB] int32: row b's first live_blocks[b] entries are distinct
    pages of 1..P-1 in scattered order, the rest the null page."""
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    pt = torch.zeros((B, NB), dtype=torch.int32)
    o = 0
    for b, n in enumerate(live_blocks):
        pt[b, :n] = perm[o:o + n]
        o += n
    return pt


def gathered(c, s, pt, layer, kind):
    """The library yardstick's input: one layer's pages gathered densely
    through the table (as models.llama._gather_paged), dequantized to bf16
    [B, Hkv, NB x PAGE, D]."""
    codes = k10.gather_pages(c, pt, layer)
    if s is None:
        return codes
    vals = unpack_kv4(codes) if kind == "int4" else codes
    sc = k10.gather_scales(s, pt, layer)
    return (vals.float() * sc.transpose(1, 2)[..., None]).to(BF16)


def k10_cases(gen, kind):
    """K10a (bf16, int8 pages) or K10b (int4 pages) over 4096 slots (32
    table entries of 128) of scattered pages: B = 1 at pos 3060 (K2's and
    K5's long case, so the cost of paging shows) and B = 8 at mixed
    positions, one of them at the last slot. Library yardstick: the pages
    gathered and dequantized (models.llama._gather_paged), then
    scaled_dot_product_attention."""
    Hq, Hkv, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    sdpa = torch.nn.functional.scaled_dot_product_attention
    L_ = 4
    first, err_max = None, 0.0
    for B, positions in ((1, [3060]),
                         (8, [5, 130, 700, 1500, 2047, 2600, 3060, 4095])):
        live = [p // PAGE + 1 for p in positions]
        P = sum(live) + 1
        k, v, ks, vs = paged_pool(gen, kind, L_, P)
        pt = scattered_table(B, NB_LONG, P, live, SEED + B).to(DEV)
        q = torch.randn((B, 1, Hq, D), generator=gen, device=DEV).to(BF16)
        pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
        sc = dict(k_scale=ks, v_scale=vs)
        got = k10.paged_attention(q, k, v, pt, 1, pos, **sc)
        want = k10.paged_attention_ref(q, k, v, pt, 1, pos, D ** -0.5,
                                       **sc).reshape(got.shape)
        torch.cuda.synchronize()
        err = max_err(got, want)
        # as K2/K5: p rounds against another running max (int4: float32
        # p on both sides), float32 sums in another order; a few bf16
        # steps (2^-8 relative) of the largest output
        tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
        name = "K10b" if kind == "int4" else "K10a"
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"{name} {kind} B={B}: max err {err} > {tol} or non-finite")
        err_max = max(err_max, err)
        ms = time_ms(lambda i: k10.paged_attention(q, k, v, pt, i % L_, pos,
                                                   **sc))
        plain = plain_ms(lambda i: k10.paged_attention_ref(
            q, k, v, pt, i % L_, pos, D ** -0.5, **sc))
        n = max(positions) + 1
        mask = (torch.arange(n, device=DEV)[None, :]
                <= pos[:, None].long())[:, None, None, :]
        gqa = {"enable_gqa": True} if Hq != Hkv else {}
        lib = time_ms(lambda i: sdpa(
            q.transpose(1, 2), gathered(k, ks, pt, i % L_, kind)[:, :, :n],
            gathered(v, vs, pt, i % L_, kind)[:, :, :n], attn_mask=mask,
            **gqa))
        nbytes = (sum(attn_bytes(kind, Hkv, p + 1) for p in positions)
                  + 2 * q.numel() * 2 + pt.numel() * 4 + B * 4)
        flops = sum(4 * Hq * (p + 1) * D for p in positions)
        bnd, by = bound_ms(nbytes, flops)
        say(f"  {name} {kind} pages B={B} pos={positions} err {err:.3g} (tol "
            f"{tol:.3g})  kernel {ms:.4f} ms  bound {bnd:.5f} ms ({by})  "
            f"plain {plain:.3f} ms  gather+sdpa {lib:.4f} ms")
        if first is None:
            first = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        del k, v, ks, vs
    return first, err_max


def k11_cases(gen, kind):
    """K11 on a 1024-row chunk at positions 2048-3071 over paged history
    (the case of K9's second chunk; 24 scattered pages of a 32-entry
    table). Library yardstick: the pages gathered and dequantized, then
    scaled_dot_product_attention with the causal mask."""
    Hq, Hkv, D = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    sdpa = torch.nn.functional.scaled_dot_product_attention
    L_ = 4
    T, start = CHUNK // 2, CHUNK
    live = start + T
    P = live // PAGE + 1
    k, v, ks, vs = paged_pool(gen, kind, L_, P)
    pt = scattered_table(1, NB_LONG, P, [live // PAGE], SEED + 11).to(DEV)
    q = torch.randn((1, T, Hq, D), generator=gen, device=DEV).to(BF16)
    pos = (start + torch.arange(T, device=DEV, dtype=torch.int32))[None]
    sc = dict(k_scale=ks, v_scale=vs)
    got = k11.paged_flash_attention(q, k, v, pt, 1, pos, **sc)
    want = k11.paged_flash_ref(q, k, v, pt, 1, pos, D ** -0.5, **sc)
    torch.cuda.synchronize()
    err = max_err(got, want)
    # as K9: the same 64-slot blocks and rounding points, float32 sums in
    # another order (int4: p in two bf16 parts): a few bf16 steps
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"K11 {kind}: max err {err} > {tol} or non-finite")
    del got, want
    ms = time_ms(lambda i: k11.paged_flash_attention(q, k, v, pt, i % L_, pos,
                                                     **sc), reps=10)
    plain = plain_ms(lambda i: k11.paged_flash_ref(q, k, v, pt, i % L_, pos,
                                                   D ** -0.5, **sc))
    mask = torch.arange(live, device=DEV)[None, :] <= pos[0, :, None].long()
    gqa = {"enable_gqa": True} if Hq != Hkv else {}
    lib = time_ms(lambda i: sdpa(
        q.transpose(1, 2), gathered(k, ks, pt, i % L_, kind)[:, :, :live],
        gathered(v, vs, pt, i % L_, kind)[:, :, :live], attn_mask=mask,
        **gqa), reps=10)
    pairs = sum(range(start + 1, start + T + 1))
    nbytes = (attn_bytes(kind, Hkv, live) + 2 * q.numel() * 2 + T * 4
              + pt.numel() * 4)
    bnd, by = bound_ms(nbytes, 4 * Hq * D * pairs)
    say(f"  K11 {kind} pages T={T} positions {start}-{start + T - 1} err "
        f"{err:.3g} (tol {tol:.3g})  kernel {ms:.4f} ms  bound {bnd:.4f} ms "
        f"({by})  plain {plain:.3f} ms  gather+sdpa {lib:.4f} ms "
        f"({4 * Hq * D * pairs / ms / 1e9:.0f} TFLOP/s)")
    del k, v, ks, vs
    return dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by), err


def phase_paged_parity(qcfg, kinds):
    """A 2-layer LLaMA-2-7B-width model through the paged forward, CPU
    plain versions vs GPU kernels, over a pool of each kind with
    scattered pages: a 256-token fresh prefill at B = 4 (plain attention
    over the fresh rows), a 256-row chunk over those pages (K11; rows end
    at different lengths), then PARITY_STEPS decode steps at mixed
    positions (K10)."""
    cfg = dataclasses.replace(CFG, num_layers=2)
    cpu = torch.device("cpu")
    p_cpu = llama.prepare_params(llama.init_params_quantized(
        cfg, qcfg, seed=SEED + 2, device=cpu))
    p_gpu = llama.params_to(p_cpu, DEV)
    for kind in kinds:
        say(f"phase 3: 2-layer LLaMA-2-7B-width {qcfg.weights} model, "
            f"paged {kind} pool, CPU plain vs GPU kernels")
        paged_parity(cfg, {cpu: p_cpu, DEV: p_gpu}, kind)


def paged_parity(cfg, params, kind):
    cpu = torch.device("cpu")
    B, T, NB = 4, 256, 8
    P = B * NB + 1
    pt = scattered_table(B, NB, P, [NB] * B, SEED + 12)
    gen = torch.Generator().manual_seed(SEED + 13)
    ids = torch.randint(1, cfg.vocab_size, (B, 2 * T), generator=gen,
                        dtype=torch.int32)
    lengths = torch.tensor([256, 200, 131, 77])
    caches = {}
    for dev in (cpu, DEV):
        c = paged_kvcache.init_paged_cache(
            cfg.num_layers, P, cfg.num_kv_heads, PAGE, cfg.head_dim, B, NB,
            KV_DTYPE[kind], device=dev)
        caches[dev] = dataclasses.replace(c, page_table=pt.to(dev))
    check(llama.attention_route((B, T, cfg.num_heads, cfg.head_dim),
                                NB * PAGE, kind != "bf16", PAGE, True)
          == "paged_flash" and llama.attention_route(
              (B, 1, cfg.num_heads, cfg.head_dim), NB * PAGE,
              kind != "bf16", PAGE) == "paged_decode",
          "phase 3: the paged routes must take K11 and K10")
    errs, scale, finite = [], 0.0, []

    def step(ids_, pos_, last=None, hist=False):
        nonlocal scale
        out = {}
        for dev in (cpu, DEV):
            out[dev], caches[dev] = llama.forward(
                cfg, params[dev], ids_.to(dev), pos_.to(dev), caches[dev],
                last_idx=None if last is None else last.to(dev),
                paged_history=hist)
        finite.append(bool(torch.isfinite(out[cpu]).all())
                      and bool(torch.isfinite(out[DEV]).all()))
        errs.append((out[DEV].cpu() - out[cpu]).abs().max().item())
        scale = max(scale, out[cpu].abs().max().item())
        return out[cpu]

    with torch.no_grad():
        before = counts()
        pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
        step(ids[:, :T], pos)
        logits = step(ids[:, T:], pos + T, lengths - 1, hist=True)
        nxt = (T + lengths).to(torch.int32)[:, None]
        for _ in range(PARITY_STEPS):
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            logits = step(tok, nxt)
            nxt = nxt + 1
        d = {c: n - before[c] for c, n in counts().items()}
    k10_name = "K10b" if kind == "int4" else "K10a"
    check(d["K11"] == cfg.num_layers
          and d[k10_name] == PARITY_STEPS * cfg.num_layers,
          f"phase 3: the paged chunk and steps did not run K11 and K10: {d}")
    tol = 4 * 2.0 ** -8 * scale           # as phase 3 of the dense paths
    say(f"  logits max err per step (fresh prefill, history chunk, "
        f"{PARITY_STEPS} decode steps) {['%.4f' % e for e in errs]} (tol "
        f"{tol:.4f}, max |logit| {scale:.3f})")
    check(all(finite), "paged parity: non-finite logits")
    check(max(errs) <= tol, f"paged parity: {max(errs)} > {tol}")


SCHED_NEW = 64                        # new tokens of every served request
SMALL_POOL = 26                       # pages of run (b'): 25 usable, the
                                      # 3000-token request needs 24
GEN_SERVE = GenerationConfig(greedy=True, max_new_tokens=SCHED_NEW,
                             eos_token_ids=())


def serving_prompts():
    """16 distinct 128-token prompts, 16 that share a 256-token prefix and
    end in 128 distinct tokens, and one 3000-token prompt."""
    gen = torch.Generator().manual_seed(SEED + 5)

    def rand(n):
        return torch.randint(1, CFG.vocab_size, (n,), generator=gen).tolist()
    distinct = [rand(128) for _ in range(16)]
    shared = rand(256)
    return distinct, [shared + rand(128) for _ in range(16)], rand(3000)


def compare_streams(got, want, tol=2e-2):
    """(compared, total, largest |difference| of the compared tokens'
    logprobs): the greedy tokens of `got` equal those of `want` step by
    step. Two streams may part only at a near-tie, a step where want's
    top-2 logprob gap is below tol; the comparison of that request ends
    there. A near-tie where both picked the same token leaves them in
    step (the logits are bf16: exact ties are common), so the comparison
    goes on past it. Raises where the streams part at a wider gap."""
    compared = total = 0
    diff = 0.0
    for g, w in zip(got, want):
        check(len(g.output_ids) == len(w.output_ids) == SCHED_NEW,
              "served stream length")
        total += len(w.output_ids)
        for j, top in enumerate(w.output_top_logprobs):
            if g.output_ids[j] != w.output_ids[j]:
                gap = top[0][1] - top[1][1]
                check(gap < tol, f"request {w.req_id} step {j}: "
                      f"{g.output_ids[:j + 1]} vs {w.output_ids[:j + 1]} "
                      f"at a top-2 gap of {gap}")
                break
            diff = max(diff, abs(g.output_logprobs[j]
                                 - w.output_logprobs[j]))
            compared += 1
    return compared, total, diff


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100 * len(xs)))]


def serve_scheduler(name, eng, weights, kv, make, first, rest):
    """Serve `first` (admitted alone: one step), then `rest`, through the
    scheduler `make()` builds, greedy with top-2 logprobs; every count is
    zeroed just before and read just after. Checks the launches against
    the forwards the run made (each forward's shapes and route, recorded
    by a wrapper that also checks the logits are finite on the device),
    and that every logprob is finite. Returns (requests, counts, the
    scheduler's preemptions and prefix hit tokens)."""
    log = []
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    fwd = eng._forward

    def recorded(ids, positions, cache, last_idx, paged_history=False):
        logits, cache = fwd(ids, positions, cache, last_idx, paged_history)
        finite.logical_and_(torch.isfinite(logits).all())
        paged = isinstance(cache, paged_kvcache.PagedKVCache)
        log.append((ids.shape[0], ids.shape[1],
                    cache.max_blocks * cache.page_size if paged
                    else cache.max_seq_len,
                    cache.page_size if paged else 0, paged_history))
        return logits, cache
    eng._forward = recorded
    sched = make()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    reqs = [sched.submit(p, SCHED_NEW, top_logprobs=2) for p in first]
    if first:
        sched.step()
    reqs += [sched.submit(p, SCHED_NEW, top_logprobs=2) for p in rest]
    while sched.step():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    del eng._forward
    want = {c: 0 for c in COUNTERS}
    for rec in log:
        forward_launches(want, weights, kv, *rec)
    check(got == want, f"{name}: launches {got} != expected {want}")
    check(bool(finite.item()), f"{name}: a forward gave non-finite logits")
    check(all(math.isfinite(x) for r in reqs for x in r.output_logprobs)
          and all(math.isfinite(v) for r in reqs
                  for top in r.output_top_logprobs for _, v in top),
          f"{name}: non-finite logprobs")
    check(all(len(r.output_ids) == SCHED_NEW for r in reqs),
          f"{name}: stream length")
    tokens = sum(len(r.output_ids) for r in reqs)
    ttft = [r.ttft_s * 1e3 for r in reqs]
    itl = [(r.done_t - r.first_token_t) * 1e3 / (len(r.output_ids) - 1)
           for r in reqs]
    store = getattr(sched, "store", None)
    say(f"  {name}: {len(reqs)} requests, {tokens} tokens in {wall:.2f} s "
        f"= {tokens / wall:.1f} tok/s; TTFT p50 {pct(ttft, 50):.1f} / p95 "
        f"{pct(ttft, 95):.1f} ms; inter-token p50 {pct(itl, 50):.2f} ms; "
        f"phase_s {({k: round(v, 3) for k, v in sched.phase_s.items()})} "
        f"phase_n {sched.phase_n}; preemptions "
        f"{getattr(sched, 'preemptions', 0)}; prefix hit tokens "
        f"{store.hit_tokens if store else 0}; forwards {len(log)}; "
        f"launches { {c: n for c, n in got.items() if n} }")
    stats = dict(preemptions=getattr(sched, "preemptions", 0),
                 hits=store.hit_tokens if store else 0)
    del sched
    torch.cuda.empty_cache()
    return reqs, got, stats


def phase_serving(params):
    """Phase 4 of path (iv): full-depth LLaMA-2-7B int4 g=128, 8 slots,
    greedy with top-2 logprobs, 64 new tokens a request."""
    say("phase 4: ContinuousBatchingScheduler and PagedScheduler, "
        "LLaMA-2-7B int4 g=128, 8 slots")
    distinct, sharing, long = serving_prompts()

    def engine(kv, max_seq):
        return InferenceEngine(CFG, params, engine_cfg=EngineConfig(
            max_seq_len=max_seq, max_batch_size=8, page_size=PAGE),
            cache_dtype=KV_DTYPE[kv], device=DEV)

    def paged(eng, **kw):
        return lambda: scheduler.PagedScheduler(eng, GEN_SERVE, **kw)
    engines = {kv: engine(kv, LONG_SEQ) for kv in ("int8", "int4", "bf16")}
    # warm-up outside the counts: a long and a short prompt on each pool
    for eng in engines.values():
        s = scheduler.PagedScheduler(eng, dataclasses.replace(
            GEN_SERVE, max_new_tokens=4), prefix_cache=True)
        s.run([long[:300], distinct[0][:100], sharing[0]])
        del s
    torch.cuda.synchronize()
    total = {c: 0 for c in COUNTERS}
    by_kind = {kv: {c: 0 for c in COUNTERS} for kv in engines}

    def add(kv, got):
        for c, n in got.items():
            total[c] += n
            by_kind[kv][c] += n
    dense = engine("int8", MAX_SEQ)
    got_a, n, _ = serve_scheduler(
        "(a) ContinuousBatchingScheduler, dense int8 KV", dense, "int4",
        "int8", lambda: scheduler.ContinuousBatchingScheduler(dense,
                                                              GEN_SERVE),
        [], distinct)
    add("int8", n)
    del dense
    e8 = engines["int8"]
    ref, n, _ = serve_scheduler(
        "reference: paged int8 KV, no prefix cache, full pool", e8, "int4",
        "int8", paged(e8), [long], distinct + sharing)
    add("int8", n)
    got_b, n, st_b = serve_scheduler(
        "(b) paged int8 KV, prefix cache, full pool", e8, "int4", "int8",
        paged(e8, prefix_cache=True), [long], distinct + sharing)
    add("int8", n)
    got_b2, n, st_b2 = serve_scheduler(
        f"(b') paged int8 KV, prefix cache, {SMALL_POOL}-page pool", e8,
        "int4", "int8", paged(e8, prefix_cache=True, num_pages=SMALL_POOL),
        [long], distinct + sharing)
    add("int8", n)
    check(st_b["hits"] > 0 and st_b2["hits"] > 0,
          "(b), (b'): the prefix store reported no hit tokens")
    check(st_b2["preemptions"] > 0, "(b'): no request was preempted")
    gaps = sorted(top[0][1] - top[1][1] for r in ref
                  for top in r.output_top_logprobs)
    say(f"  reference top-2 logprob gaps: median {pct(gaps, 50):.4f}, "
        f"{sum(g < 2e-2 for g in gaps)} of {len(gaps)} below 0.02")
    for what, got, want in (("(b)", got_b, ref), ("(b')", got_b2, ref),
                            ("(a) dense", got_a, ref[1:17])):
        c, t, diff = compare_streams(got, want)
        say(f"  {what} vs reference: {c} of {t} tokens compared, equal; "
            f"their logprobs differ by at most {diff:.4f}")
        # the dense run differs in more than rounding (another attention
        # path, other batch shapes): its streams may part sooner
        check(2 * c >= t or what.startswith("(a)"),
              f"{what}: fewer than half the tokens compared")
    for kv in ("int4", "bf16"):
        eng = engines[kv]
        _, n, st = serve_scheduler(
            f"(c) paged {kv} KV, prefix cache", eng, "int4", kv,
            paged(eng, prefix_cache=True), [long],
            distinct[:4] + sharing[:4])
        add(kv, n)
        check(st["hits"] > 0, f"(c) {kv}: no prefix hit tokens")
    used = ("K1", "K2", "KR", "K6", "K8", "K10a", "K10b", "K11")
    check(all(total[c] > 0 for c in used), f"a kernel never ran: {total}")
    del engines
    return by_kind


def path_paged(gen, shared):
    """Path (iv): continuous batching over the paged KV cache on the int4
    weights of path (ii)."""
    say("path (iv): schedulers over paged KV pools, LLaMA-2-7B int4 g=128 "
        "(the weights of path (ii))")
    say("phase 2 (paged pools): K10a, K10b and K11 vs plain versions on the "
        "card, LLaMA-2-7B shapes")
    k10_r = {kind: k10_cases(gen, kind) for kind in ("bf16", "int8", "int4")}
    k11_r = {kind: k11_cases(gen, kind) for kind in ("bf16", "int8", "int4")}
    phase_paged_parity(QCFG4, ("int8", "int4", "bf16"))
    by_kind = phase_serving(shared["params"])
    out = []
    for kind in ("bf16", "int8", "int4"):
        name = "K10b" if kind == "int4" else "K10a"
        r, err = k10_r[kind]
        out.append(dict(entry(
            f"{name} paged_attention ({kind} pages)", "decode_attention.cu",
            "paged_attention.py:" + ("209" if kind == "int4" else "271"),
            by_kind[kind][name], err, r, L,
            f"32 layers of one decode step at B=1, pos 3060, over 32 "
            f"scattered pages of 128 slots"),
            library="gather of the pages (models.llama._gather_paged), "
                    "dequantize, scaled_dot_product_attention"))
    for kind in ("bf16", "int8", "int4"):
        r, err = k11_r[kind]
        out.append(dict(entry(
            f"K11 paged_flash_attention ({kind} pages)", "flash_attention.cu",
            "paged_flash.py:56", by_kind[kind]["K11"], err, r, L,
            "32 layers of a 1024-row chunk at positions 2048-3071 over 24 "
            "scattered pages of 128 slots, B=1"),
            library="gather of the pages (models.llama._gather_paged), "
                    "dequantize, scaled_dot_product_attention"))
    return out


# ----------------------------------------------------------------- path (v)

ROOT = Path(__file__).resolve().parent
# K12's four instantiations, (weights, cache kind)
MEGA_INSTANCES = (("int8", "bf16"), ("int8", "int8"), ("int4", "int8"),
                  ("int4", "bf16"))
# phase 2's K12 cases (weights, cache kind, position, slots); the pos-191
# case of each instantiation is its JSON entry
MEGA_CASES = (("int8", "bf16", 191, MAX_SEQ), ("int8", "bf16", 3060, LONG_SEQ),
              ("int4", "int8", 191, MAX_SEQ), ("int4", "int8", 3060, LONG_SEQ),
              ("int8", "int8", 191, MAX_SEQ), ("int4", "bf16", 191, MAX_SEQ))
CHAT_NEW = 24                         # new tokens of every chat round
CHAT_GEN = GenerationConfig(max_new_tokens=CHAT_NEW, greedy=True,
                            eos_token_ids=(), repetition_penalty=1.1,
                            presence_penalty=0.5, frequency_penalty=0.2,
                            logit_bias={100: 3.0, 2000: -100.0, 31999: 1.5})
CHAT_TURNS = ("Hello there, who are you?", "Tell me about the sea.",
              "And what of the mountains, then?")
GEN_NEW = 64                          # new tokens after the 3000-token prompt


@contextlib.contextmanager
def layer_mega(on):
    """LLMI_LAYER_MEGA=1 (on) or 0 in the environment while inside;
    llama.layer_route reads it at every forward."""
    old = os.environ.get("LLMI_LAYER_MEGA")
    os.environ["LLMI_LAYER_MEGA"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["LLMI_LAYER_MEGA"]
        else:
            os.environ["LLMI_LAYER_MEGA"] = old


def k12_case(params, weights, kind, pos, S, gen):
    """K12 on layer 1 of the full model at position `pos` over S slots of
    a random cache of `kind`, against layer_decode_fused_ref on the same
    inputs; then timed beside it, its bound and the library layer
    (torch.matmul on bf16 dequantized weights, scaled_dot_product_attention
    over the dequantized cache, F.silu and the norms in torch ops)."""
    H, Hq, Hkv, D = (CFG.hidden_size, CFG.num_heads, CFG.num_kv_heads,
                     CFG.head_dim)
    lay = params["layers"]
    depth = lay["wqkv"].q.shape[0]
    kc, vc, ks, vs = random_cache(gen, kind, depth, 1, S)
    cache = kvcache.KVCache(k=kc, v=vc, k_scale=ks, v_scale=vs,
                            bits=16 if kind == "bf16" else 8)
    check(k12.supports(CFG, (1, 1, H), lay, cache),
          f"K12 {weights}/{kind}: supports() declines the case")
    h = torch.randn((1, 1, H), generator=gen, device=DEV).to(BF16)
    res = torch.randn((1, 1, H), generator=gen, device=DEV).to(BF16)
    cos_t, sin_t = llama.rope_table(CFG, S, DEV)
    cos, sin = cos_t[pos][None, None], sin_t[pos][None, None]
    positions = torch.tensor([[pos]], dtype=torch.int32, device=DEV)
    args = (h, res, lay, cache)
    got = k12.layer_kernel(CFG, *args, 1, positions, cos, sin)
    want = k12.layer_decode_fused_ref(CFG, *args, 1, positions, cos, sin)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("h2", "down", "k_new", "v_new"), got, want):
        e = max_err(g, w)
        # float32 sums in another order; the kernel rounds p to bf16
        # against a running maximum, the plain version against the row
        # maximum: a few bf16 steps (2^-8 relative) of the largest value.
        # k_new/v_new round one float32 sum: one bf16 step (2^-7)
        tol = (2.0 ** -7 if name in ("k_new", "v_new") else 4 * 2.0 ** -8
               ) * w.float().abs().max().item()
        check(bool(torch.isfinite(g).all()) and e <= tol,
              f"K12 {weights}/{kind} pos={pos} {name}: max err {e} > {tol}")
        err = max(err, e)
    del got, want
    ms = time_ms(lambda i: k12.layer_kernel(CFG, *args, i % depth,
                                            positions, cos, sin))
    plain = plain_ms(lambda i: k12.layer_decode_fused_ref(
        CFG, *args, i % depth, positions, cos, sin))
    n_lib = 2
    deq = [[dequantize(lay[n].layer(i), BF16) for n in k12.WEIGHTS]
           for i in range(n_lib)]
    kd = [dequant_layer(kc, ks, i, kind)[:, :, :pos + 1] for i in range(n_lib)]
    vd = [dequant_layer(vc, vs, i, kind)[:, :, :pos + 1] for i in range(n_lib)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = {"enable_gqa": True} if Hq != Hkv else {}
    c16, s16 = cos.reshape(D).to(BF16), sin.reshape(D).to(BF16)
    eps = CFG.rms_norm_eps

    def norm(x, g):
        return x * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True)
                               + eps).to(BF16) * g

    def rope(x):
        return x * c16 + torch.cat([-x[..., D // 2:], x[..., :D // 2]],
                                   -1) * s16

    def lib_layer(i):
        # the same layer in library calls; attention reads the cache's
        # pos + 1 slots (the yardstick does not write the new row)
        wq, wo, wgu, wd = deq[i % n_lib]
        x = (h + res).reshape(1, H)
        qkv = torch.matmul(norm(x, lay["attn_norm"][i % n_lib]), wq)
        q = rope(qkv[:, :Hq * D].reshape(1, Hq, 1, D))
        k = rope(qkv[:, Hq * D:(Hq + Hkv) * D].reshape(1, Hkv, 1, D))
        a = sdpa(q, kd[i % n_lib], vd[i % n_lib], **gqa)
        x = x + torch.matmul(a.reshape(1, Hq * D), wo)
        gate, up = torch.matmul(norm(x, lay["ffn_norm"][i % n_lib]),
                                wgu).chunk(2, dim=-1)
        return torch.matmul(torch.nn.functional.silu(gate) * up, wd), x, k
    lib = time_ms(lib_layer)
    del deq, kd, vd, cache, kc, vc, ks, vs
    # each weight's codes and scales and the history's K and V rows (and
    # scales) read once; h, res, the two norms read and h2, down, k_new,
    # v_new written once; bf16 tensor-core peak for the products
    nbytes = (sum(qbytes(lay[n]) for n in k12.WEIGHTS)
              + attn_bytes(kind, Hkv, pos) + 6 * H * 2 + 2 * Hkv * D * 2
              + 2 * D * 4 + 4)
    flops = (2 * sum(lay[n].in_features * lay[n].out_features
                     for n in k12.WEIGHTS) + 4 * Hq * D * (pos + 1))
    bnd, by = bound_ms(nbytes, flops)
    say(f"  K12 int{lay['wqkv'].bits} weights, {kind} cache, pos={pos} S={S} "
        f"err {err:.3g}  kernel {ms:.4f} ms  bound {bnd:.4f} ms ({by})  "
        f"plain {plain:.3f} ms  library layer {lib:.4f} ms")
    return dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by, err=err)


def k12_cases(params8, params4, gen):
    """Every MEGA_CASES case: (the pos-191 numbers of each instantiation,
    the largest error of each)."""
    first, errs = {}, {}
    for weights, kind, pos, S in MEGA_CASES:
        r = k12_case(params8 if weights == "int8" else params4, weights,
                     kind, pos, S, gen)
        first.setdefault((weights, kind), r)
        errs[(weights, kind)] = max(errs.get((weights, kind), 0.0), r["err"])
    return first, errs


def row_write_cases(gen):
    """write_rows (bf16 cache) and quantize_write_rows (int8 cache) on the
    rows K12 hands over ([Hkv, D] bf16) at slots 191, 3060 and one past
    the end of 4096, exact against their plain versions; timed at slot 191
    beside the plain version and index assignment (after torch quantize
    ops for int8)."""
    Hkv, D, S = CFG.num_kv_heads, CFG.head_dim, LONG_SEQ
    L_, slot = 4, 191
    out = {}
    for kind, fn, ref_fn in (
            ("bf16", k3.write_rows, k3.write_rows_ref),
            ("int8", k3.quantize_write_rows, k3.quantize_write_rows_ref)):
        caches = [t for t in random_cache(gen, kind, L_, 1, S) if t is not None]
        ref = [t.clone() for t in caches]
        kn = (3 * torch.randn((Hkv, D), generator=gen, device=DEV)).to(BF16)
        vn = torch.randn((Hkv, D), generator=gen, device=DEV).to(BF16)
        for off in (slot, 3060, S + 5):
            o = torch.tensor([off], dtype=torch.int32, device=DEV)
            fn(*caches, 2, kn, vn, o)
            ref_fn(*ref, 2, kn, vn, o)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(caches, ref)),
                  f"{fn.__name__} at offset {off}: differs from the plain "
                  f"version")
        o = torch.tensor([slot], dtype=torch.int32, device=DEV)
        ms = time_ms(lambda i: fn(*caches, i % L_, kn, vn, o))
        plain = time_ms(lambda i: ref_fn(*ref, i % L_, kn, vn, o))
        new = torch.stack([kn, vn]).float()
        if kind == "bf16":
            def lib_write(i):
                ref[0][i % L_][0, :, slot] = kn
                ref[1][i % L_][0, :, slot] = vn
            bnd, by = bound_ms(2 * 2 * Hkv * D * 2 + 4, 0)
        else:
            def lib_write(i):
                s = torch.clamp(new.abs().amax(-1, keepdim=True) / 127.0,
                                min=1e-8)
                q = torch.clamp(torch.round(new / s), -128, 127).to(
                    torch.int8)
                ref[0][i % L_][0, :, slot] = q[0]
                ref[1][i % L_][0, :, slot] = q[1]
                ref[2][i % L_][0, slot] = s[0, :, 0]
                ref[3][i % L_][0, slot] = s[1, :, 0]
            # float32 |x|, max, divide, round, clamp per element
            bnd, by = bound_ms(2 * Hkv * D * (2 + 1) + 2 * Hkv * 4 + 4,
                               5 * 2 * Hkv * D, FP32_FLOPS)
        lib = time_ms(lib_write)
        say(f"  {fn.__name__} ({kind} cache) exact  kernel {ms:.4f} ms  "
            f"bound {bnd:.6f} ms ({by})  plain {plain:.4f} ms  index_put "
            f"{lib:.4f} ms")
        out[kind] = dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by)
        del caches, ref
    return out


def phase_mega_parity(qcfg, cache_dtype):
    """A 2-layer LLaMA-2-7B-width model at B = 1: a 128-row prefill (the
    split route) and PARITY_STEPS teacher-forced decode steps (the mega
    route) with
    LLMI_LAYER_MEGA=1 on the CPU (plain versions) and on the card
    (kernels), and the same steps on the card with the variable at 0 (the
    split route)."""
    say(f"phase 3: 2-layer LLaMA-2-7B-width {qcfg.weights} model, "
        f"{cache_dtype} cache, LLMI_LAYER_MEGA=1: CPU plain vs GPU kernels, "
        f"and mega vs split on the GPU")
    cfg = dataclasses.replace(CFG, num_layers=2)
    cpu = torch.device("cpu")
    p_cpu = llama.prepare_params(llama.init_params_quantized(
        cfg, qcfg, seed=SEED + 6, device=cpu))
    p_gpu = llama.params_to(p_cpu, DEV)
    T, steps = 128, PARITY_STEPS
    gen = torch.Generator().manual_seed(SEED + 7)
    ids = torch.randint(1, cfg.vocab_size, (1, T), generator=gen,
                        dtype=torch.int32)
    runs = {"cpu": (cpu, p_cpu, True), "mega": (DEV, p_gpu, True),
            "split": (DEV, p_gpu, False)}
    caches = {r: kvcache.init_cache(cfg.num_layers, 1, cfg.num_kv_heads,
                                    MAX_SEQ, cfg.head_dim, cache_dtype,
                                    device=dev)
              for r, (dev, _, _) in runs.items()}
    errs = {"mega vs cpu": [], "mega vs split": []}
    scale, finite, logits = 0.0, [], {}
    tok, nxt = ids, torch.arange(T, dtype=torch.int32)[None]
    with torch.no_grad():
        before = counts()
        for step in range(steps + 1):
            for r, (dev, p, on) in runs.items():
                with layer_mega(on):
                    route = llama.layer_route(cfg, p["layers"], *tok.shape,
                                              caches[r])
                    want = "mega" if on and step else "split"
                    check(route == want, f"phase 3 {r} step {step}: route "
                          f"{route}, not {want}")
                    out, caches[r] = llama.forward(cfg, p, tok.to(dev),
                                                   nxt.to(dev), caches[r])
                logits[r] = out.float().cpu()
            finite.append(all(bool(torch.isfinite(x).all())
                              for x in logits.values()))
            errs["mega vs cpu"].append(max_err(logits["mega"], logits["cpu"]))
            errs["mega vs split"].append(max_err(logits["mega"],
                                                 logits["split"]))
            scale = max(scale, logits["cpu"].abs().max().item())
            tok = logits["cpu"].argmax(-1).to(torch.int32)[:, None]
            nxt = torch.tensor([[T + step]], dtype=torch.int32)
        d = {c: n - before[c] for c, n in counts().items()}
    row = "RW" if cache_dtype == BF16 else "QRW"
    check(d["K12"] == d[row] == steps * cfg.num_layers,
          f"phase 3: K12 and its row write must run layers x steps "
          f"({steps * cfg.num_layers}) times: {d}")
    # as phase 3 of the other paths: 4 bf16 steps of the largest logit
    tol = 4 * 2.0 ** -8 * scale
    for what, e in errs.items():
        say(f"  logits max err per step (prefill, {steps} decode steps), "
            f"{what}: {['%.4f' % x for x in e]} (tol {tol:.4f}, max |logit| "
            f"{scale:.3f})")
        check(max(e) <= tol, f"mega parity, {what}: {max(e)} > {tol}")
    check(all(finite), "mega parity: non-finite logits")


@contextlib.contextmanager
def logged_forwards(eng, log):
    """While inside, every forward of `eng` is appended to `log` as
    (batch, rows, slots, 0, False, mega) — forward_launches' arguments,
    with mega the route llama.layer_route gave it — and its logits are
    checked finite on the device (the yielded flag)."""
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    fwd = eng._forward
    layers = eng.params["layers"]

    def logged(ids, positions, cache, *a, **k):
        mega = llama.layer_route(CFG, layers, ids.shape[0], ids.shape[1],
                                 cache) == "mega"
        logits, cache = fwd(ids, positions, cache, *a, **k)
        finite.logical_and_(torch.isfinite(logits).all())
        log.append((ids.shape[0], ids.shape[1], cache.max_seq_len, 0, False,
                    mega))
        return logits, cache
    eng._forward = logged
    try:
        yield finite
    finally:
        del eng._forward


@contextlib.contextmanager
def recorded_picks():
    """While inside, every token the engine picks (B = 1) is appended to
    the yielded list with the logits it was picked from (after the bias
    and the penalties), both left on the device."""
    picks = []
    sample = engine_mod.sampling.sample

    def recorded(logits, *a, **k):
        tok = sample(logits, *a, **k)
        picks.append((tok[0], logits[0].float().clone()))
        return tok
    engine_mod.sampling.sample = recorded
    try:
        yield picks
    finally:
        engine_mod.sampling.sample = sample


def compare_picks(got, want, what):
    """Two runs' picks step by step, under compare_streams' rule: equal
    tokens until the streams part, which they may only at a near-tie of
    the reference's logits, a top-2 gap below 2e-2 or below twice the two
    runs' largest logit difference at that step (the contexts are still
    equal there). While the tokens agree, the logits must agree within
    phase 3's 4 bf16 steps of the largest, grown with the depth as a sum
    of independent roundings grows, by sqrt(L / 2) (16 steps at 32
    layers). Returns (compared, total, the largest logit difference)."""
    check(len(got) == len(want), f"{what}: {len(got)} != {len(want)} picks")
    diff = 0.0
    for j, ((gt, gl), (wt, wl)) in enumerate(zip(got, want)):
        d = (gl - wl).abs().max().item()
        tol = 4 * math.sqrt(L / 2) * 2.0 ** -8 * wl.abs().max().item()
        check(d <= tol, f"{what} step {j}: logits differ by {d} > {tol}")
        diff = max(diff, d)
        if int(gt) != int(wt):
            top = wl.topk(2).values
            gap = (top[0] - top[1]).item()
            check(gap < max(2e-2, 2 * d), f"{what} step {j}: the streams "
                  f"part at a top-2 gap of {gap} (logits differ by {d})")
            return j, len(want), diff
    return len(want), len(want), diff


def chat_vocab():
    """A synthetic 32,000-piece BPE vocabulary: <unk>, <s>, </s>, the 256
    byte pieces, "▁", letters and punctuation, then the letters' 2- and
    3-letter strings with and without "▁" (scored by length, so merges
    build the longest piece), cut at LLaMA-2's 32,000."""
    vocab = {}

    def add(piece, score):
        if len(vocab) < CFG.vocab_size and piece.encode() not in vocab:
            vocab[piece.encode()] = (len(vocab), score)
    for t in ("<unk>", "<s>", "</s>"):
        add(t, 0.0)
    for i in range(256):
        add("<0x%02X>" % i, -1000.0)
    letters = "abcdefghijklmnopqrstuvwxyz"
    for p in ["▁"] + list(letters) + list(",.?!'"):
        add(p, 1.0)
    for c in letters:
        add("▁" + c, 2.0)
    for n in (2, 3):
        for combo in itertools.product(letters, repeat=n):
            s = "".join(combo)
            add("▁" + s, float(n + 1))
            add(s, float(n))
    return vocab


def phase_chat(params4):
    """Three ChatSession rounds on full-depth LLaMA-2-7B int4 g=128 over an
    int8 cache of 512 slots, greedy with the repetition, presence and
    frequency penalties and a logit bias, over a synthetic vocabulary
    written by save_binary and read back by load_tokenizer: with the
    megakernel on, then off. Launches checked against the forwards each
    run made; the two runs' streams compared (compare_picks). Returns the
    mega run's launches."""
    path = ROOT / "build" / "chip_smoke" / "tokenizer.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    BPETokenizer(chat_vocab(), kv={"bos_token_id": "1",
                                   "eos_token_id": "2"}).save_binary(str(path))
    tok = load_tokenizer(str(path))
    check(isinstance(tok, BPETokenizer) and tok.vocab_size == CFG.vocab_size,
          f"tokenizer round trip: {type(tok).__name__} {tok.vocab_size}")
    eng = InferenceEngine(CFG, params4, engine_cfg=EngineConfig(
        max_seq_len=MAX_SEQ, decode_chunk=8), tokenizer=tok,
        cache_dtype="int8", device=DEV)
    with layer_mega(True):                 # warm-up, outside the counts
        ChatSession(eng).ask("warm up", dataclasses.replace(
            CHAT_GEN, max_new_tokens=4))
    runs = {}
    for on in (True, False):
        log = []
        with layer_mega(on), logged_forwards(eng, log) as finite, \
                recorded_picks() as picks:
            session = ChatSession(eng)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            texts = [session.ask(t, CHAT_GEN) for t in CHAT_TURNS]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counts()
        want = {c: 0 for c in COUNTERS}
        for rec in log:
            forward_launches(want, "int4", "int8", *rec)
        check(got == want, f"chat (mega {on}): launches {got} != expected "
              f"{want}")
        check(bool(finite.item()), f"chat (mega {on}): non-finite logits")
        n_mega = sum(rec[-1] for rec in log)
        check(n_mega == (len(CHAT_TURNS) * (CHAT_NEW - 1) if on else 0),
              f"chat (mega {on}): {n_mega} forwards took the mega route")
        check(len(picks) == len(CHAT_TURNS) * CHAT_NEW
              and all(0 <= int(t) < CFG.vocab_size for t, _ in picks),
              f"chat (mega {on}): {len(picks)} picks")
        runs[on] = picks, got
        say(f"  chat, mega {'on' if on else 'off'}: {len(CHAT_TURNS)} rounds "
            f"of {CHAT_NEW} tokens in {wall:.2f} s ({len(log)} forwards, "
            f"{n_mega} on the mega route); launches "
            f"{ {c: n for c, n in got.items() if n} }; replies "
            f"{[t[:40] for t in texts]}")
    c, t, diff = compare_picks(runs[True][0], runs[False][0],
                               "chat, mega vs split")
    say(f"  chat, mega vs split: {c} of {t} tokens compared, equal; logits "
        f"differ by at most {diff:.4f}")
    del eng
    return runs[True][1]


def phase_mega_generate(params, weights, kv, prompt, compare):
    """generate on the 3000-token prompt, 64 new tokens, greedy, over 4096
    slots with the megakernel on (and, with `compare`, off): each run's
    launches against expected_launches of its route, TTFT, decode tokens/s
    and wall per step; then a second run of each route with its picks
    recorded (the same tokens) and the two routes' streams compared.
    Returns the mega run's launches."""
    eng = InferenceEngine(CFG, params, engine_cfg=EngineConfig(
        max_seq_len=LONG_SEQ, decode_chunk=8), cache_dtype=KV_DTYPE[kv],
        device=DEV)
    gen = GenerationConfig(max_new_tokens=GEN_NEW, greedy=True,
                           eos_token_ids=())
    with layer_mega(True):                 # warm-up, outside the counts
        eng.generate([prompt[:300]], dataclasses.replace(gen,
                                                         max_new_tokens=4))
    mega_counts, picks = None, {}
    for on in ((True, False) if compare else (True,)):
        with layer_mega(on):
            torch.cuda.synchronize()
            zero_counts()
            res = eng.generate([prompt], gen)[0]
            torch.cuda.synchronize()
            got = counts()
            want = expected_launches(weights, KV_DTYPE[kv],
                                     prefill_chunks(eng, [len(prompt)]),
                                     LONG_SEQ, GEN_NEW - 1, mega=on)
            check(got == want, f"generate {weights}/{kv} (mega {on}): "
                  f"launches {got} != expected {want}")
            check(len(res.token_ids) == GEN_NEW, "generate: length")
            if compare:
                with recorded_picks() as p:
                    again = eng.generate([prompt], gen)[0]
                check(again.token_ids == res.token_ids,
                      f"generate {weights}/{kv} (mega {on}): the recorded "
                      f"run's tokens differ")
                picks[on] = p
        if on:
            mega_counts = got
        tps = res.decode_tokens_per_s
        say(f"  generate, {weights} weights, {kv} cache, mega "
            f"{'on ' if on else 'off'}: TTFT {res.ttft_s * 1e3:.2f} ms, "
            f"decode {tps:.2f} tok/s = {1e3 / tps:.2f} ms a step; "
            f"launches {({c: n for c, n in got.items() if n})}")
    if compare:
        c, t, diff = compare_picks(picks[True], picks[False],
                                   f"generate {weights}/{kv}, mega vs split")
        say(f"  generate {weights}/{kv}, mega vs split: {c} of {t} tokens "
            f"compared, equal; logits differ by at most {diff:.4f}")
    del eng
    return mega_counts


def run_cli():
    """The CLI REPL as a user starts it, on dummy LLaMA-2-7B int4 g=128
    weights over an int8 cache with LLMI_LAYER_MEGA=1, two lines on stdin:
    it must exit 0 and echo two `ids>` lines, then `bye.`."""
    cmd = [sys.executable, "-m", "llm_inference_tpu_torch.cli", "--model",
           "llama2-7b", "--quant", "int4", "--group-size", "128",
           "--kv-cache", "int8", "--greedy", "--max-new-tokens", "8",
           "--max-seq-len", "512"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, input="hello\nhow are you\n",
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT), env=dict(os.environ,
                                                 LLMI_LAYER_MEGA="1"))
    ids = [line.split("ids> ", 1)[1] for line in out.stdout.splitlines()
           if "ids> " in line]
    check(out.returncode == 0 and len(ids) == 2
          and out.stdout.rstrip().endswith("bye."),
          f"CLI: rc {out.returncode}, stdout {out.stdout[-2000:]!r}, "
          f"stderr {out.stderr[-3000:]!r}")
    say(f"  CLI (python -m llm_inference_tpu_torch.cli, LLMI_LAYER_MEGA=1) "
        f"exit 0 in {time.perf_counter() - t0:.1f} s: ids> {ids}")


def path_chat(gen, params8, params4):
    """Path (v): the B = 1 chat path with LLMI_LAYER_MEGA=1 on the weights
    of paths (i) and (ii)."""
    t0 = time.perf_counter()
    say("path (v): the B = 1 chat path, LLMI_LAYER_MEGA=1, on the weights "
        "of paths (i) (int8) and (ii) (int4 g=128)")
    say("phase 2 (K12 and its row writes): kernels vs plain versions on the "
        "card, LLaMA-2-7B shapes")
    k12_r, k12_err = k12_cases(params8, params4, gen)
    rows_r = row_write_cases(gen)
    phase_mega_parity(QCFG8, BF16)
    phase_mega_parity(QCFG4, "int8")
    say("phase 4: ChatSession, generate and the CLI on full-depth "
        "LLaMA-2-7B")
    by_inst = {inst: {c: 0 for c in COUNTERS} for inst in MEGA_INSTANCES}

    def add(inst, got):
        for c, n in got.items():
            by_inst[inst][c] += n
    add(("int4", "int8"), phase_chat(params4))
    g = torch.Generator().manual_seed(SEED + 8)
    prompt = torch.randint(1, CFG.vocab_size, (3000,), generator=g).tolist()
    for weights, kv, compare in (("int8", "bf16", True),
                                 ("int4", "int8", True),
                                 ("int8", "int8", False),
                                 ("int4", "bf16", False)):
        add((weights, kv), phase_mega_generate(
            params8 if weights == "int8" else params4, weights, kv, prompt,
            compare))
    torch.cuda.empty_cache()
    run_cli()
    total = {c: sum(d[c] for d in by_inst.values()) for c in COUNTERS}
    check(all(d["K12"] > 0 for d in by_inst.values())
          and total["RW"] > 0 and total["QRW"] > 0,
          f"a kernel of path (v) never ran: {by_inst}")
    say(f"path (v) took {time.perf_counter() - t0:.1f} s")
    out = []
    for weights, kind in MEGA_INSTANCES:
        out.append(dict(entry(
            f"K12 layer_decode_fused ({weights} weights, {kind} cache)",
            "layer_fused.cu", "layer_fused.py:353",
            by_inst[(weights, kind)]["K12"], k12_err[(weights, kind)],
            k12_r[(weights, kind)], L,
            "32 layers of one decode step at B=1, pos 191, S=512"),
            library="torch.matmul on bf16 dequantized weights, "
                    "scaled_dot_product_attention over the dequantized "
                    "cache, F.silu, RMSNorm in torch ops"))
    out.append(entry("write_rows (K12's bf16 row write)", "kv_write.cu",
                     "kv_write.py:314", total["RW"], 0.0, rows_r["bf16"], L,
                     "32 layers of one decode step at B=1"))
    out.append(entry("quantize_write_rows (K12's int8 row write)",
                     "kv_write.cu", "kv_write.py:248", total["QRW"], 0.0,
                     rows_r["int8"], L, "32 layers of one decode step at B=1"))
    return out


# ---------------------------------------------------------------- path (vi)

TP = 2
TP_REQUESTS = ((128, 64), (3000, 64))   # (prompt tokens, new tokens)
TP_ENGINE = EngineConfig(max_seq_len=LONG_SEQ, decode_chunk=8)
TP_GEN = GenerationConfig(max_new_tokens=64, greedy=True, eos_token_ids=())
# the small-group cases: LLaMA-2-7B width, 2 layers, int4 in groups of gs
SMALL_GROUPS = (8, 16, 32)


def rand_int4(L_, N, K, gs, gen):
    """A random stacked int4 weight [L_, N, K/2] in groups of gs codes,
    scales of the dummy weights' order (0.02 / 7)."""
    return QTensor(q=torch.randint(-128, 128, (L_, N, K // 2), generator=gen,
                                   device=DEV, dtype=torch.int8),
                   scale=torch.rand((L_, N, K // gs), generator=gen,
                                    device=DEV) * 0.04 / 7 + 1e-4, bits=4)


def k7_case(gu, dn, M, gen):
    """K7 against ffn_fused_ref at M rows, timed beside it, its bound and
    the library chain (torch.matmul on bf16 dequantized weights, F.silu,
    the norm in torch ops)."""
    H, I = dn.out_features, dn.in_features
    eps = CFG.rms_norm_eps
    depth = gu.q.shape[0]
    x = torch.randn((M, H), generator=gen, device=DEV).to(BF16)
    res = torch.randn((M, H), generator=gen, device=DEV).to(BF16)
    gamma = (1 + 0.1 * torch.randn((H,), generator=gen, device=DEV)).to(BF16)
    args = (x, res, gamma, eps, gu, dn)
    (y, h2), (wy, wh2) = k1.ffn_fused(*args, 1), k1.ffn_fused_ref(*args, 1)
    torch.cuda.synchronize()
    check(torch.equal(h2, wh2), f"K7 g={gu.group_size} M={M}: h2 differs")
    err = max_err(y, wy)
    # float32 sums in another order through two products, one bf16
    # rounding: one bf16 step of the largest output
    tol = 2.0 ** -7 * wy.float().abs().max().item()
    check(err <= tol, f"K7 g={gu.group_size} M={M}: max err {err} > {tol}")
    ms = time_ms(lambda i: k1.ffn_fused(x, res, gamma, eps, gu, dn,
                                        i % depth))
    plain = plain_ms(lambda i: k1.ffn_fused_ref(x, res, gamma, eps, gu, dn,
                                                i % depth))
    deq = [(dequantize(gu.layer(i), BF16), dequantize(dn.layer(i), BF16))
           for i in range(2)]

    def lib_ffn(i):
        w_gu, w_d = deq[i % 2]
        h = x + res
        xn = h * torch.rsqrt(h.float().pow(2).mean(-1, keepdim=True)
                             + eps).to(BF16) * gamma
        gate, up = torch.matmul(xn, w_gu).chunk(2, dim=-1)
        return torch.matmul(torch.nn.functional.silu(gate) * up, w_d), h
    lib = time_ms(lib_ffn)
    del deq
    # both weights' codes and scales, x, res and gamma read once, y and h2
    # written once
    nbytes = qbytes(gu) + qbytes(dn) + 4 * M * H * 2 + H * 2
    bnd, by = bound_ms(nbytes, 2 * M * (H * 2 * I + I * H))
    say(f"  K7 int4 g={gu.group_size} M={M} H={H} I={I} err {err:.3g} (tol "
        f"{tol:.3g})  kernel {ms:.4f} ms  bound {bnd:.4f} ms ({by})  plain "
        f"{plain:.3f} ms  torch.matmul(bf16) chain {lib:.4f} ms")
    return dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by, err=err)


def k7_cases(gen):
    """K7 on one rank's shard of LLaMA-2-7B at tp = 2 (gate-up [2 x 5504,
    4096], down [4096, 5504], two layers of random codes) in groups of 128
    and of 32 codes, M = 1 (a decode step) and 8."""
    H, I = CFG.hidden_size, CFG.intermediate_size // TP
    out = {}
    for gs in (128, 32):
        gu, dn = rand_int4(2, 2 * I, H, gs, gen), rand_int4(2, H, I, gs, gen)
        for M in (1, 8):
            out[(gs, M)] = k7_case(gu, dn, M, gen)
        del gu, dn
    return out


def small_group_cases(gen):
    """K1 and K8 (g = 8, 16, 32), K6 and K12 (g = 8, 16) against their
    plain versions on a 2-layer LLaMA-2-7B-width int4 model of each group
    size, each timed beside its plain version, bound and library call: K1
    on wqkv at M = 1 (GEMV) and 16, 32 and 128 (MMA branch), K6 at M = 1, 4 and 8, K8 (its
    mma.sync kernel) on w_gateup at 2048 rows, K12 at pos 191 over an int8
    cache."""
    cfg2 = dataclasses.replace(CFG, num_layers=2)
    for gs in SMALL_GROUPS:
        say(f"  -- int4 groups of {gs} codes (2 layers, LLaMA-2-7B width)")
        params = llama.prepare_params(llama.init_params_quantized(
            cfg2, QuantConfig(weights="int4", group_size=gs), seed=SEED + gs,
            device=DEV))
        lay = params["layers"]
        for M in (1, 32, 16, 128):
            k1_case("wqkv", lay["wqkv"], M, True, gen, 2)
        # K8's mma.sync kernel takes groups of 8, 16 and 32 (its wgmma
        # kernel multiples of 64)
        k8_cases(params, gen, Ms=(CHUNK,), names=("w_gateup",), route=0)
        if gs < 32:                      # K6 and K12 took 32k before
            k6_cases(params, gen)
            k12_case(params, "int4", "int8", 191, MAX_SEQ, gen)
        del params, lay


def tp_prefill(gen, T):
    """[a prefill step]: ids [1, T], positions and last index T - 1."""
    ids = torch.randint(1, CFG.vocab_size, (1, T), generator=gen,
                        dtype=torch.int32).numpy()
    pos = torch.arange(T, dtype=torch.int32)[None].numpy()
    return [(ids, pos, torch.tensor([T - 1]).numpy())]


def phase_tp_parity():
    """A 2-layer LLaMA-2-7B-width int4 g=128 model over an int8 cache: a
    128-row prefill and 8 decode steps through 2 ranks (the TP forward,
    parallel.run_ranks) against tp = 1, on the card (kernels; both ranks
    share it over gloo) and on the CPU (plain versions). The decode steps
    are teacher-forced with the card's tp = 1 greedy tokens."""
    say("phase 3: 2-layer LLaMA-2-7B-width int4 g=128 model, int8 cache, "
        f"tp={TP} ranks vs tp=1, on the card and on the CPU")
    cfg2 = dataclasses.replace(CFG, num_layers=2)
    T, n_dec = 128, 8
    gen = torch.Generator().manual_seed(SEED + 10)
    steps = tp_prefill(gen, T)
    out = {}
    for dev in (DEV, torch.device("cpu")):
        # tp = 1 on this device (its own generator's weights)
        p1 = tp_ranks.build_from_seed(dev, 1, cfg2, QCFG4, SEED + 9)
        c = kvcache.init_cache(2, 1, CFG.num_kv_heads, MAX_SEQ, CFG.head_dim,
                               "int8", device=dev)
        want = []
        with torch.no_grad():
            for j in range(n_dec + 1):
                if j == len(steps):
                    tok = want[-1].argmax(-1).astype("int32")[:, None]
                    steps.append((tok, torch.tensor([[T + j - 1]],
                                                    dtype=torch.int32).numpy(),
                                  torch.tensor([0]).numpy()))
                ids, pos, last = (torch.from_numpy(a).to(dev)
                                  for a in steps[j])
                logits, c = llama.forward(cfg2, p1, ids, pos, c,
                                          last_idx=last)
                want.append(logits.float().cpu().numpy())
        del p1, c
        t0 = time.perf_counter()
        ranks = run_ranks(tp_ranks.run_jobs, TP, [(tp_ranks.forwards, dict(
            cfg=cfg2, build=(tp_ranks.build_from_seed, (cfg2, QCFG4,
                                                        SEED + 9)),
            cache=("int8", 1, MAX_SEQ), steps=steps))], device=dev)
        got = [r[0] for r in ranks]
        for j in range(n_dec + 1):
            check((got[0][0][j] == got[1][0][j]).all(),
                  f"phase 3 tp ({dev.type}) step {j}: the ranks' logits "
                  f"differ")
        errs = [float(abs(g - w).max()) for g, w in zip(got[0][0], want)]
        scale = max(float(abs(w).max()) for w in want)
        # as phase 3 of the other paths: 4 bf16 steps of the largest logit
        tol = 4 * 2.0 ** -8 * scale
        launches = got[0][1]
        say(f"  {dev.type}: {time.perf_counter() - t0:.1f} s for the ranks; "
            f"logits max err per step vs tp=1 {['%.4f' % e for e in errs]} "
            f"(tol {tol:.4f}, max |logit| {scale:.3f}); rank launches "
            f"{launches}; ranks bit-identical")
        check(max(errs) <= tol, f"tp parity ({dev.type}): {max(errs)} > {tol}")
        if dev.type == "cuda":
            check(launches["K7"] == n_dec * 2 and launches["K6"] == 0
                  and launches["K12"] == 0,
                  f"phase 3 tp: K7 must run layers x decode steps, K6 and "
                  f"K12 never: {launches}")
        out[dev.type] = max(errs)
    return out


def phase_tp_generate(params4):
    """generate on full-depth LLaMA-2-7B int4 g=128 over an int8 cache of
    4096 slots: a 128-token and a 3000-token prompt (two prefill chunks),
    64 greedy tokens each, at tp = 2 (two ranks on the card, each drawing
    the model from the seed of path (ii) and keeping its shard) and at
    tp = 1 (path (ii)'s weights in this process). Returns rank 0's K7
    launches."""
    say(f"phase 4: InferenceEngine.generate at tp={TP} vs tp=1, LLaMA-2-7B "
        f"int4 g=128, int8 cache, {TP_ENGINE.max_seq_len} slots")
    gen = torch.Generator().manual_seed(SEED + 11)
    requests = [[torch.randint(1, CFG.vocab_size, (n,), generator=gen
                               ).tolist()] for n, _ in TP_REQUESTS]
    eng = InferenceEngine(CFG, params4, engine_cfg=TP_ENGINE,
                          cache_dtype="int8", device=DEV)
    eng.generate([requests[0][0][:16]], dataclasses.replace(
        TP_GEN, max_new_tokens=2))                       # warm-up
    want = []
    for prompts in requests:
        picks = tp_ranks.record_picks(eng)
        res = eng.generate(prompts, TP_GEN)
        want.append((res[0].token_ids, picks, res[0]))
    expect = [expected_launches("int4", "int8",
                                prefill_chunks(eng, [n]), LONG_SEQ, new - 1,
                                tp=True) for n, new in TP_REQUESTS]
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(tp_ranks.run_jobs, TP, [(tp_ranks.generate, dict(
        cfg=CFG, build=(tp_ranks.build_from_seed, (CFG, QCFG4, SEED)),
        requests=requests, gen=TP_GEN, engine_cfg=TP_ENGINE, cache="int8",
        warmup=16)), (tp_ranks.collective_cost, dict(
            numel=CFG.hidden_size, reps=200))], device=DEV)
    cost = ranks[0][1]
    say(f"  ranks spawned, built and served in "
        f"{time.perf_counter() - t0:.1f} s; one all-reduce of a decode "
        f"step's {CFG.hidden_size} values alone: {cost['call_s'] * 1e3:.3f} "
        f"ms a call ({cost['collective_s'] * 1e3:.3f} ms in the collective)")
    per_rank = [r[0] for r in ranks]
    k7 = 0
    for i, ((n, new), (w_tokens, w_picks, w_res)) in enumerate(
            zip(TP_REQUESTS, want)):
        r0, r1 = per_rank[0][i], per_rank[1][i]
        check(r0["tokens"] == r1["tokens"],
              f"tp generate {n}: the ranks' tokens differ")
        scale = max(float(abs(p).max()) for p in w_picks)
        # phase 3's 4 bf16 steps of the largest logit, grown with the depth
        # by sqrt(L / 2) (compare_picks)
        tol = 4 * math.sqrt(L / 2) * 2.0 ** -8 * scale
        compared, diff = tp_ranks.compare_picks(
            r0["picks"], r0["tokens"], w_picks, [w_tokens], tol)
        la = r0["launches"]
        exp = {c: expect[i][c] for c in la}
        check(la == exp and la["K7"] == L * (new - 1),
              f"tp generate {n}: rank 0's launches {la} != expected {exp} "
              f"(K7: {L} x {new - 1} decode forwards, K6 and K12 never)")
        k7 += la["K7"]
        steps = r0["steps"]
        busy = (r0["step_s"] - r0["coll_s"]) / steps * 1e3
        coll = r0["coll_s"] / steps * 1e3
        say(f"  {n}-token prompt, {new} new, tp={TP} ({r0['backend']}, two "
            f"ranks share the card): TTFT {r0['ttft_s'] * 1e3:.2f} ms, decode "
            f"{r0['tokens_per_s']:.2f} tok/s; a decode step {busy:.3f} ms "
            f"busy + {coll:.3f} ms in {r0['colls'] / steps:.0f} collectives "
            f"(rank 0); launches {({k: v for k, v in la.items() if v})}; "
            f"tp=1: TTFT {w_res.ttft_s * 1e3:.2f} ms, decode "
            f"{w_res.decode_tokens_per_s:.2f} tok/s; streams: {compared} of "
            f"{new} tokens compared, equal; logits differ by at most "
            f"{diff:.4f} (tol {tol:.4f}); tokens {r0['tokens'][0][:8]}...")
    return k7


def run_cli_tp():
    """The CLI REPL at --tp 2 on dummy LLaMA-2-7B int4 g=128 weights over
    an int8 cache, "hello" then "exit": it must exit 0 and echo one
    `ids>` line, then `bye.`."""
    cmd = [sys.executable, "-m", "llm_inference_tpu_torch.cli", "--model",
           "llama2-7b", "--tp", str(TP), "--quant", "int4", "--group-size",
           "128", "--kv-cache", "int8", "--greedy", "--max-new-tokens", "8",
           "--max-seq-len", "512"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, input="hello\nexit\n", capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    ids = [line.split("ids> ", 1)[1] for line in out.stdout.splitlines()
           if "ids> " in line]
    check(out.returncode == 0 and len(ids) == 1
          and out.stdout.rstrip().endswith("bye."),
          f"CLI --tp {TP}: rc {out.returncode}, stdout "
          f"{out.stdout[-2000:]!r}, stderr {out.stderr[-3000:]!r}")
    say(f"  CLI (python -m llm_inference_tpu_torch.cli --tp {TP}) exit 0 in "
        f"{time.perf_counter() - t0:.1f} s: ids> {ids}")


def path_tp(gen, params4):
    """Path (vi): tensor parallelism at tp = 2, two ranks on the card."""
    t0 = time.perf_counter()
    say(f"path (vi): LLaMA-2-7B int4 g=128 at tp={TP} (two ranks on one "
        f"card, gloo), and int4 groups of 8, 16 and 32 codes")
    say("phase 2 (K7, and K1/K6/K8/K12 in small groups): kernels vs plain "
        "versions on the card")
    k7_r = k7_cases(gen)
    small_group_cases(gen)
    torch.cuda.empty_cache()
    say(f"  phase 2 done at {time.perf_counter() - t0:.1f} s")
    phase_tp_parity()
    say(f"  phase 3 done at {time.perf_counter() - t0:.1f} s")
    k7_launches = phase_tp_generate(params4)
    run_cli_tp()
    say(f"path (vi) took {time.perf_counter() - t0:.1f} s")
    k7_err = max(r["err"] for r in k7_r.values())
    return [entry("K7 ffn_fused (int4 norm, gate-up, SwiGLU, down; one tp=2 "
                  "shard)", "layer_tail.cu", "quant_matmul.py:800",
                  k7_launches, k7_err, k7_r[(128, 1)], L,
                  "32 layers of one decode step of one rank of LLaMA-2-7B "
                  "int4 g=128 at tp=2, M=1")]


def main():
    t_start = time.perf_counter()
    phase_card()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    params8, kernels = path_int8(gen)
    torch.cuda.empty_cache()
    say(f"path (i) done at {time.perf_counter() - t_start:.1f} s")
    more, shared = path_int4(gen)
    kernels += more
    say(f"path (ii) done at {time.perf_counter() - t_start:.1f} s")
    kernels += path_int4_kv4(gen, shared)
    say(f"path (iii) done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    kernels += path_paged(gen, shared)
    say(f"path (iv) done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    kernels += path_chat(gen, params8, shared["params"])
    say(f"path (v) done at {time.perf_counter() - t_start:.1f} s")
    del params8
    torch.cuda.empty_cache()
    kernels += path_tp(gen, shared["params"])
    del shared
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
