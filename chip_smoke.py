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
Path (vii), the HTTP server (engine/server.py `serve`, in a thread on
127.0.0.1, port 0, requests by urllib) over the schedulers on the int4
g=128 weights of (ii), an int8 cache of 8 slots x 2048 and path (v)'s
synthetic vocabulary: four concurrent greedy /generate requests (128 +
32 tokens, held to `generate` up to a near-tie), a penalised
/v1/completions (its picks held to `generate`'s under compare_picks'
rule), a forcing logit_bias, a token-id guided_choice, a response_format
json_schema (the text parses and fits), echo scoring of a 1500-token
prompt (one 2048-row chunk on K8 and K9, equal to engine.score; a greedy
continuation's decode logprobs within a stated tolerance of its scores),
/v1/embeddings (last, mean: unit vectors of 4096), an SSE completion
(its deltas are the completion) and /metrics with its Prometheus form,
with K1, K2, the RoPE-and-write kernel, K6, K8 and K9 counted; then a
paged run with the prefix cache serves a guided and a penalised request
on K10a. It prints the served tokens/s and TTFT beside the card.
Path (viii), speculative decoding (engine/speculative.py, γ = 4) and beam
search (engine/beam_search.py) on the same weights over an int8 cache,
every stream held to the plain ContinuousBatchingScheduler's (top-2
logprobs) under compare_streams' rule: SpeculativeDecoder and
DraftModelSpeculativeDecoder (a self-draft: a second engine over the same
parameters; accepted tokens and the backfill required) at B = 1 on a
cyclic 128-token prompt, 64 new tokens; SpeculativeBatchingScheduler at 8
slots of 2048 (cyclic and random 128-token prompts, 32 new) and at 2
slots of 256 (a 224-token prompt: the plain-chunk fallback required);
DraftSpeculativeBatchingScheduler (self-draft, 4 slots, admissions
staggered by a step); one /v1/completions through serve(speculative=
True); BeamSearchDecoder (W = 4 over 512 slots: sorted distinct
hypotheses, log_probs against engine.score within stated limits; W = 1
against greedy). It checks that K1 (its GEMV and MMA branch), K2, K6 and
the RoPE-and-write kernel ran, counts the verify windows' plain attend,
and prints tokens a verify step, each run's wall and tok/s beside the
plain route's, a beam step's wall and the cache reorder's share of it.
Path (ix), the families beyond LLaMA-2 through the model registry
(models/llama.py: llama3.1, mistral, qwen2, qwen3, phi3; models/gemma2.py:
gemma2, gemma3): phase 2 holds K1 to its plain version at the large
vocabularies' lm_heads (128256, 152064, gemma2's and gemma3's tied heads
quantized from the table, 256000 and 262208) and the families' qkv widths,
K8 at qwen2's and mistral's gate-up, K9, K2 and K10a at gemma2's D = 256
with its window, softcap and query scale (windows that mask a large part
of the slots, shown to move the output) and at G = 4 and 7, the RoPE and
KV write at phi3's D = 96 and qwen2's Hkv = 4, K6 at qwen2's widths, K12
at Llama-3.1-8B's G = 4; phase 3 runs 2 layers of mistral-7b, qwen2-7b
(int4 g=128, int8 cache), qwen3-8b, phi3-mini and gemma2-2b and 6 of
gemma3-4b at full width, CPU plain vs card kernels (a 128-row prefill and
4 decode steps), then mistral on a 4200-token prompt over 8192 slots (its
window binding in K9 and K2) against the same run on plain attention, and
checks that K12 refuses each of them; phase 4 serves full-depth
Llama-3.1-8B (int8, bf16 cache: generate 128 + 32 and 3000 + 32 with the
megakernel on and off, launches and streams checked) and Gemma-2-2B
(int8 with the tied head quantized, int8 cache: generate 4600 + 32 over
8192 slots, then the dense and the paged scheduler serving four requests,
the paged streams held to the dense ones), with TTFT and tok/s.
Path (x), the mixture-of-experts families (models/mixtral.py,
models/deepseek.py): phase 2 holds K3 and K4 at DeepSeek-V3's latent rows
(k 576, v 512 values, one kv head; B = 1 and B = 4 with an offset past
the end), K3 on the int4 latent cache's packed rows and the scale write
to their plain versions, exact; phase 3 runs 2 layers of Mixtral-8x7B
(int8 + bf16 KV, int4 g=128 + int8 KV) and of DeepSeek-V3 (a dense and a
MoE layer, int8 over bf16, int8 and int4 latent caches) at full width,
the kernels against their plain versions run on the card
(plain_kernels; rows whose router picked other experts on the two sides
counted and left out); phase 4 serves full-depth Mixtral-8x7B int4 g=128
over an int8 cache (K1 on the last layer's expert 7, generate 128 + 32
and 3000 + 32, the dense and paged schedulers) and DeepSeek-V3 at full
width over 5 layers, int8 codes (K1 on wkv_a, wq_b and an expert of the
last MoE layer, K8 at 2048 rows, generate over the bf16 and int8 latent
caches and 2500 + 32, both schedulers over the latent cache and pool),
with launches checked against the forwards and TTFT and tok/s printed.
Path (xi), multi-LoRA serving (models/lora.py), run after path (v) on
path (i)'s int8 weights over a bf16 cache: two random rank-16 adapters
on all seven targets beside the zero slot (lora.init_lora_stacks, scale
0.25); phase 3 runs the first two layers with the stacks at B = 3 on
slots 0, 1 and 2, CPU plain vs card kernels (a 32-row prefill and
teacher-forced decode steps); phase 4 runs `generate` 128 + 32 on the
base engine and on the LoRA engine's slots 0, 1 and 2 (slot 0 held to
the base stream under compare_streams' rule, slots 1 and 2 leaving it),
a 3000-token prompt on adapter 1 (K8, K9), the dense scheduler with
four requests on slots [0, 1, 2, 1] (each held to its adapter's
`generate` stream) and the paged scheduler with the prefix cache (one
3-page prompt on adapters 1, 2, 2: no hit, then every full page), with
the adapter route's launches counted (K1 with its MMA branch, K2, K8,
K9, K10a, K11 and the RoPE-and-write kernel ran; K6, K7 and K12 did
not) and the B = 1 tok/s, the scheduler's tok/s and a decode step's
profile (fused base, the unfused layer without deltas, the adapter
step) printed.
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
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "runs the port on a GPU")

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            QuantConfig, llama2_7b, preset)
from llm_inference_tpu_torch.engine import engine as engine_mod
from llm_inference_tpu_torch.engine import scheduler, server, speculative
from llm_inference_tpu_torch.engine.beam_search import (BeamSearchDecoder,
                                                        beam_search)
from llm_inference_tpu_torch.engine.engine import ChatSession, InferenceEngine
from llm_inference_tpu_torch.engine.tokenizer import (BPETokenizer,
                                                      load_tokenizer)
from llm_inference_tpu_torch.models import (deepseek, gemma2, get_model,
                                            llama, lora, mixtral)
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
from llm_inference_tpu_torch.tools import profile_decode, tp_ranks

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

def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_card():
    smi = card_line()
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


def compare_streams(got, want, tol=2e-2, new=SCHED_NEW):
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
        check(len(g.output_ids) == len(w.output_ids) == new,
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


def chat_tokenizer():
    """chat_vocab written by save_binary to build/chip_smoke/tokenizer.bin
    (once) and read back by load_tokenizer."""
    path = ROOT / "build" / "chip_smoke" / "tokenizer.bin"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        BPETokenizer(chat_vocab(), kv={"bos_token_id": "1",
                                       "eos_token_id": "2"}).save_binary(
            str(path))
    tok = load_tokenizer(str(path))
    check(isinstance(tok, BPETokenizer) and tok.vocab_size == CFG.vocab_size,
          f"tokenizer round trip: {type(tok).__name__} {tok.vocab_size}")
    return tok


def phase_chat(params4):
    """Three ChatSession rounds on full-depth LLaMA-2-7B int4 g=128 over an
    int8 cache of 512 slots, greedy with the repetition, presence and
    frequency penalties and a logit bias, over a synthetic vocabulary
    written by save_binary and read back by load_tokenizer: with the
    megakernel on, then off. Launches checked against the forwards each
    run made; the two runs' streams compared (compare_picks). Returns the
    mega run's launches."""
    tok = chat_tokenizer()
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


def phase_mega_generate(params, weights, kv, prompt, compare, new=GEN_NEW,
                        tally=None):
    """generate on the prompt (3000 tokens), `new` tokens (64), greedy,
    over 4096 slots with the megakernel on (and, with `compare`, off):
    each run's launches against expected_launches of its route (and added
    into the `tally` dict), TTFT, decode tokens/s and wall per step; then
    a second run of each route with its picks recorded (the same tokens)
    and the two routes' streams compared. Returns the mega run's
    launches."""
    eng = InferenceEngine(CFG, params, engine_cfg=EngineConfig(
        max_seq_len=LONG_SEQ, decode_chunk=8), cache_dtype=KV_DTYPE[kv],
        device=DEV)
    gen = GenerationConfig(max_new_tokens=new, greedy=True,
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
                                     LONG_SEQ, new - 1, mega=on)
            check(got == want, f"generate {weights}/{kv} (mega {on}): "
                  f"launches {got} != expected {want}")
            check(len(res.token_ids) == new, "generate: length")
            if tally is not None:
                for c, n in got.items():
                    tally[c] = tally.get(c, 0) + n
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


# ---------------------------------------------------------------- path (vii)

SERVE_SEQ = 2048                      # cache slots of one sequence
SERVE_NEW = 32                        # new tokens of the served requests
SCORE_LEN = 1500                      # the echo-scored prompt: one chunk
EOS = 2                               # chat_vocab's </s>
# engine.score over HTTP is engine.score itself: its numbers agree to
# float32 rounding. The decode steps' logprobs and a 2048-row chunk's
# differ by bf16 rounding, held to compare_picks' rule: 4 bf16 steps of a
# logit of 4 (random weights' logits stay below it), grown by sqrt(L / 2)
SCORE_HTTP_TOL = 1e-4
SCORE_DECODE_TOL = 4 * math.sqrt(L / 2) * 2.0 ** -8 * 4.0
JSON_SCHEMA = {"type": "object",
               "properties": {"ok": {"type": "boolean"},
                              "kind": {"enum": ["red", "green"]}}}
SERVE_USED = ("K1", "K2", "KR", "K6", "K8", "K9")


def http(base, path, body=None):
    """(status, body text) of one request to the server on the loopback;
    a GET without `body`."""
    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def post_ok(base, path, body):
    """The parsed answer of a request that must succeed (200)."""
    code, text = http(base, path, body)
    check(code == 200, f"{path} {sorted(body)}: HTTP {code}: {text[:600]}")
    return json.loads(text)


def strip_eos(ids):
    return ids[:-1] if ids and ids[-1] == EOS else ids


@contextlib.contextmanager
def recorded_row_picks(row=0):
    """While inside, every token the schedulers pick for `row` (the first
    token's B = 1 draw and the rows program's) is appended to the yielded
    list with the logits it was picked from (after the bias, the guided
    mask and the penalties), as recorded_picks does for generate."""
    picks = []
    sampling = engine_mod.sampling
    spr = sampling.sample_per_row

    def recorded(logits, noise, *a, penalties=None, bias=None, allowed=None,
                 **k):
        tok = spr(logits, noise, *a, penalties=penalties, bias=bias,
                  allowed=allowed, **k)
        shaped = logits.float()
        if bias is not None:
            shaped = shaped + bias
        if allowed is not None:
            shaped = torch.where(allowed, shaped, sampling.NEG_INF)
        if penalties is not None:
            shaped = sampling.apply_penalties(shaped, *penalties)
        picks.append((tok[row], shaped[row].clone()))
        return tok
    sampling.sample_per_row = recorded
    try:
        yield picks
    finally:
        sampling.sample_per_row = spr


def compare_served(got, want, top, what):
    """A served greedy stream `got` against generate's `want` (EOS cut
    from both): equal token by token until they part, which they may only
    at a near-tie, a top-2 logprob gap of the served step (`top`, its
    top_logprobs) below 2e-2. Returns the tokens compared."""
    for j, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gap = top[j][0]["logprob"] - top[j][1]["logprob"]
            check(gap < 2e-2, f"{what} step {j}: {got[:j + 1]} vs "
                  f"{want[:j + 1]} at a top-2 gap of {gap}")
            return j
    check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)} tokens")
    return len(want)


def serve_http(eng, **kw):
    """engine/server.serve on 127.0.0.1, port 0, in a thread: (the server,
    its base URL)."""
    httpd = server.serve(eng, host="127.0.0.1", port=0, gen=GenerationConfig(
        greedy=True, max_new_tokens=SERVE_NEW, eos_token_ids=(EOS,)), **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_http(httpd):
    httpd.shutdown()
    httpd.backend.shutdown()
    httpd.server_close()


def sse(base, body):
    """An SSE completion: (the chunks' choices, client-side seconds to
    the first chunk)."""
    req = urllib.request.Request(
        base + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first, out = None, []
    with urllib.request.urlopen(req, timeout=300) as r:
        check(r.status == 200 and r.headers["Content-Type"].startswith(
            "text/event-stream"), f"SSE: HTTP {r.status}")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if first is None:
                first = time.perf_counter() - t0
            if line == "data: [DONE]":
                break
            out.append(json.loads(line[6:])["choices"][0])
    return out, first


def phase_server(params4, tok, smi):
    """The dense run: requests 1-9 over HTTP with the launches counted,
    then the references they are held to. Returns (launches, numbers)."""
    eng = InferenceEngine(CFG, params4, engine_cfg=EngineConfig(
        max_seq_len=SERVE_SEQ, max_batch_size=8, page_size=PAGE),
        tokenizer=tok, cache_dtype="int8", device=DEV)
    httpd, base = serve_http(eng)
    g = torch.Generator().manual_seed(SEED + 9)

    def rand(n):
        return torch.randint(3, CFG.vocab_size, (n,), generator=g).tolist()
    prompts = [rand(128) for _ in range(4)]
    long = rand(SCORE_LEN)
    post_ok(base, "/generate", {"prompt": rand(100), "max_new_tokens": 4})
    post_ok(base, "/v1/completions", {      # the JSON constraint compiles
        "prompt": rand(8), "max_tokens": 1, "response_format": {
            "type": "json_schema", "json_schema": {"schema": JSON_SCHEMA}}})
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    # 1. four concurrent greedy /generate requests
    got = [None] * 4

    def one(i):
        got[i] = post_ok(base, "/generate", {
            "prompt": prompts[i], "max_new_tokens": SERVE_NEW,
            "logprobs": True, "top_logprobs": 2})
    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall_batch = time.perf_counter() - t0
    check(all(r is not None for r in got), "a /generate request failed")
    # 2. penalties, its picks recorded
    pen = dict(repetition_penalty=1.3, presence_penalty=0.5,
               frequency_penalty=0.3)
    with recorded_row_picks() as pen_picks:
        pen_out = post_ok(base, "/v1/completions", dict(
            pen, prompt=prompts[0], max_tokens=SERVE_NEW))
    # 3. logit bias
    bias_t = 12345
    bias_out = post_ok(base, "/v1/completions", {
        "prompt": prompts[1], "max_tokens": 16,
        "logit_bias": {str(bias_t): 100.0}})
    # 4. a guided choice of token-id lists
    choices = [[1000, 2000, 3000], [4000, 5000]]
    choice_out = post_ok(base, "/generate", {"prompt": prompts[2],
                                             "guided_choice": choices})
    # 5. a JSON schema
    json_out = post_ok(base, "/v1/completions", {
        "prompt": prompts[3], "max_tokens": 48, "response_format": {
            "type": "json_schema", "json_schema": {"schema": JSON_SCHEMA}}})
    # 6. scoring: echo with max_tokens 0 over one 2048-row chunk, and a
    # greedy continuation's logprobs to score after it
    score_out = post_ok(base, "/v1/completions", {
        "prompt": long, "max_tokens": 0, "echo": True, "logprobs": True})
    cont = post_ok(base, "/generate", {"prompt": long[:1400],
                                       "max_new_tokens": SERVE_NEW,
                                       "logprobs": True})
    # 7. embeddings
    emb = {p: post_ok(base, "/v1/embeddings", {
        "input": [prompts[0][:20], prompts[1][:60]], "pooling": p})
        for p in ("last", "mean")}
    # 8. SSE against the same completion unstreamed
    sse_body = {"prompt": prompts[1], "max_tokens": 16}
    chunks, sse_first = sse(base, dict(sse_body, stream=True))
    plain = post_ok(base, "/v1/completions", sse_body)
    # 9. metrics, JSON and Prometheus
    code, metrics = http(base, "/metrics")
    pcode, prom = http(base, "/metrics?format=prometheus")
    hcode, health = http(base, "/health")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    stop_http(httpd)

    # the references
    gen = GenerationConfig(greedy=True, max_new_tokens=SERVE_NEW,
                           eos_token_ids=(EOS,))
    compared = 0
    for i, p in enumerate(prompts):
        want = eng.generate([p], gen)[0].token_ids
        compared += compare_served(strip_eos(got[i]["token_ids"]), want,
                                   got[i]["top_logprobs"], f"/generate {i}")
    with recorded_picks() as want_picks:
        res = eng.generate([prompts[0]], dataclasses.replace(gen, **pen))[0]
    served = pen_out["choices"][0]["token_ids"]
    check(len(pen_picks) >= len(want_picks) >= len(res.token_ids)
          and served == [int(t) for t, _ in pen_picks[:len(served)]],
          f"penalties: {len(pen_picks)} picks recorded, {served} served")
    pc, pt, pdiff = compare_picks(pen_picks[:len(want_picks)], want_picks,
                                  "penalised /v1/completions vs generate")
    check(bias_out["choices"][0]["token_ids"] == [bias_t] * 16,
          f"logit_bias: {bias_out['choices'][0]['token_ids']}")
    ids = choice_out["token_ids"]
    check(ids[-1:] == [EOS] and ids[:-1] in choices and choice_out[
        "finished"], f"guided_choice: {ids}")
    text = json_out["choices"][0]["text"]
    obj = json.loads(text)
    check(set(obj) == {"ok", "kind"} and isinstance(obj["ok"], bool)
          and obj["kind"] in ("red", "green")
          and json_out["choices"][0]["finish_reason"] == "stop",
          f"response_format json_schema: {text!r}")
    lp = score_out["choices"][0]["logprobs"]["token_logprobs"]
    want_lp = eng.score([long])[0]
    check(len(lp) == SCORE_LEN and lp[0] is None and want_lp[0] is None,
          f"echo scoring: {len(lp)} logprobs")
    http_err = max(abs(a - b) for a, b in zip(lp[1:], want_lp[1:]))
    check(all(math.isfinite(x) and x <= 0 for x in lp[1:])
          and http_err <= SCORE_HTTP_TOL,
          f"echo scoring vs engine.score: {http_err} > {SCORE_HTTP_TOL}")
    ctoks = cont["token_ids"]
    scored = eng.score([long[:1400] + ctoks])[0][1400:]
    dec_err = max(abs(a - b) for a, b in zip(scored, cont["token_logprobs"]))
    check(dec_err <= SCORE_DECODE_TOL, f"scores of a greedy continuation "
          f"vs its decode logprobs: {dec_err} > {SCORE_DECODE_TOL}")
    for pool, out in emb.items():
        for d in out["data"]:
            v = torch.tensor(d["embedding"])
            check(v.shape == (CFG.hidden_size,) and bool(
                torch.isfinite(v).all()) and abs(v.norm().item() - 1) < 1e-3,
                  f"/v1/embeddings {pool}: {v.shape}, norm {v.norm()}")
    deltas = [c for c in chunks if c["finish_reason"] is None]
    ptoks = plain["choices"][0]["token_ids"]
    check([c["token_id"] for c in deltas] == ptoks[:len(deltas)]
          and len(deltas) == len(strip_eos(ptoks))
          and chunks[-1]["finish_reason"] in ("stop", "length"),
          f"SSE: {[c['token_id'] for c in deltas]} vs {ptoks}")
    joined = "".join(c["text"] for c in deltas)
    ptext = plain["choices"][0]["text"]
    text_same = (joined[1:] if joined.startswith(" ") else joined) == ptext
    check(text_same or not (joined.isascii() and ptext.isascii()),
          f"SSE text {joined!r} vs {ptext!r}")
    mjs = json.loads(metrics)
    check(code == pcode == hcode == 200 and "ttft_s_p50" in mjs
          and "# TYPE llmi_ttft_s gauge" in prom
          and json.loads(health)["status"] == "ok",
          f"/metrics {code} {sorted(mjs)[:8]}, prometheus {pcode}, "
          f"/health {hcode}")
    ttfts = sorted(r["ttft_s"] * 1e3 for r in got)
    tokens = sum(len(r["token_ids"]) for r in got)
    numbers = dict(requests_wall=wall, batch_wall=wall_batch,
                   tok_s=tokens / wall_batch, ttft_ms=ttfts,
                   sse_first_ms=sse_first * 1e3)
    say(f"  {smi}: dense int8 KV, 8 slots: 4 concurrent /generate of 128 + "
        f"{SERVE_NEW}: {tokens} tokens in {wall_batch:.3f} s = "
        f"{tokens / wall_batch:.1f} tok/s served; TTFT (server) "
        f"{[round(t, 1) for t in ttfts]} ms; SSE first chunk (client) "
        f"{sse_first * 1e3:.1f} ms; streams vs generate: {compared} of "
        f"{4 * SERVE_NEW} tokens compared, equal")
    say(f"  penalised completion vs generate: {pc} of {pt} picks compared, "
        f"equal; logits differ by at most {pdiff:.4f}; logit_bias, "
        f"guided_choice {ids}, json_schema {text!r}: ok; echo scoring of "
        f"{SCORE_LEN} tokens vs engine.score: {http_err:.2e}; a greedy "
        f"continuation's decode logprobs vs its scores: {dec_err:.4f} (tol "
        f"{SCORE_DECODE_TOL:.3f}); embeddings (last, mean) unit, width "
        f"{CFG.hidden_size}; SSE {len(deltas)} deltas = the completion "
        f"(text {'equal' if text_same else 'not ASCII: ids compared'}); "
        f"metrics and Prometheus ok; all requests in {wall:.2f} s")
    del eng
    return launches, numbers


def phase_server_paged(params4, tok):
    """The paged run: a guided and a penalised request through the paged
    scheduler with the prefix cache (K10a on int8 pages)."""
    eng = InferenceEngine(CFG, params4, engine_cfg=EngineConfig(
        max_seq_len=SERVE_SEQ, max_batch_size=8, page_size=PAGE),
        tokenizer=tok, cache_dtype="int8", device=DEV)
    httpd, base = serve_http(eng, paged=True, prefix_cache=True)
    g = torch.Generator().manual_seed(SEED + 10)
    prompts = [torch.randint(3, CFG.vocab_size, (300,), generator=g).tolist()
               for _ in range(2)]
    post_ok(base, "/generate", {"prompt": prompts[0][:50],
                                "max_new_tokens": 2})
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = [None, None]
    choices = [[1000, 2000, 3000], [4000, 5000]]

    def guided_one():
        out[0] = post_ok(base, "/generate", {"prompt": prompts[0],
                                             "guided_choice": choices})

    def penalised():
        out[1] = post_ok(base, "/v1/completions", {
            "prompt": prompts[1], "max_tokens": SERVE_NEW,
            "repetition_penalty": 1.3, "presence_penalty": 0.5,
            "frequency_penalty": 0.3, "logprobs": True})
    threads = [threading.Thread(target=f) for f in (guided_one, penalised)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    stop_http(httpd)
    check(out[0] is not None and out[1] is not None, "paged: a request "
          "failed")
    ids = out[0]["token_ids"]
    check(ids[-1:] == [EOS] and ids[:-1] in choices,
          f"paged guided_choice: {ids}")
    lps = out[1]["choices"][0]["logprobs"]["token_logprobs"]
    check(len(lps) == SERVE_NEW and all(math.isfinite(x) for x in lps),
          f"paged penalised: {len(lps)} logprobs")
    check(launches["K10a"] > 0, f"paged run: K10a never ran: {launches}")
    say(f"  paged int8 KV, prefix cache: a guided and a penalised request "
        f"in {wall:.2f} s; guided {ids}; launches "
        f"{ {c: n for c, n in launches.items() if n} }")
    del eng
    return launches


def path_server(params4):
    """Path (vii): the HTTP server over the schedulers, on the int4
    g=128 weights of path (ii) over an int8 cache."""
    t0 = time.perf_counter()
    smi = card_line()
    say("path (vii): the HTTP server (engine/server.py) over the "
        "schedulers, LLaMA-2-7B int4 g=128 (the weights of path (ii)), int8 "
        f"KV, 8 slots of {SERVE_SEQ}; card: {smi}")
    tok = chat_tokenizer()
    launches, numbers = phase_server(params4, tok, smi)
    check(all(launches[c] > 0 for c in SERVE_USED),
          f"path (vii): a kernel never ran: {launches}")
    say(f"  launches over HTTP (dense): "
        f"{ {c: n for c, n in launches.items() if n} }")
    torch.cuda.empty_cache()
    paged = phase_server_paged(params4, tok)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    say(f"path (vii) took {wall:.1f} s")
    return dict(launches=launches, paged_launches=paged, wall=wall,
                **numbers)


# --------------------------------------------------------------- path (viii)

SPEC_SEQ = 2048                       # cache slots of one sequence
SPEC_GAMMA = 4                        # proposed tokens a verify window
SPEC_B1_NEW = 64                      # new tokens of the B = 1 decoders
SPEC_NEW = 32                         # new tokens of the schedulers' requests
FALLBACK_SEQ = 256                    # the fallback run: 224 + 32 = 256 slots
FALLBACK_PROMPT = 224
BEAM_W = 4
BEAM_SEQ = 512
BEAM_NEW = 32
# a compared token's logprob against the reference's: the verify's plain
# attention over a T = 5 window against the decode kernel at T = 1, both
# bf16 (path (vii)'s SCORE_DECODE_TOL)
SPEC_LP_TOL = 0.25
# a beam's log_prob against engine.score's teacher-forced sum over its
# tokens (the decode kernel against the prefill's plain attention, bf16),
# a token: the mean over the hypotheses, and the largest
BEAM_MEAN_TOL = 0.05
BEAM_MAX_TOL = 0.25
SPEC_USED = ("K1", "K2", "K6", "KR")
GREEDY = dict(greedy=True, eos_token_ids=())


def spec_prompts():
    """Four 128-token prompts that are a 32-token cycle four times, then
    four random 128-token prompts."""
    g = torch.Generator().manual_seed(SEED + 11)

    def rand(n):
        return torch.randint(3, CFG.vocab_size, (n,), generator=g).tolist()
    return [rand(32) * 4 for _ in range(4)] + [rand(128) for _ in range(4)]


def compare_ref(got, ref, what, lps=None):
    """A greedy stream `got` (token ids, and their logprobs `lps`) against
    a plain scheduler's request `ref` (top_logprobs=2), under
    compare_streams' rule: equal tokens until they part, which they may
    only at a near-tie of the reference (top-2 gap below 2e-2); the
    compared tokens' logprobs within SPEC_LP_TOL. Returns (compared,
    largest logprob difference)."""
    check(len(got) <= len(ref.output_ids), f"{what}: {len(got)} tokens")
    diff, compared = 0.0, len(got)
    for j, t in enumerate(got):
        if t != ref.output_ids[j]:
            top = ref.output_top_logprobs[j]
            gap = top[0][1] - top[1][1]
            check(gap < 2e-2, f"{what} step {j}: {got[:j + 1]} vs "
                  f"{ref.output_ids[:j + 1]} at a top-2 gap of {gap}")
            compared = j
            break
        if lps is not None:
            diff = max(diff, abs(lps[j] - ref.output_logprobs[j]))
    check(diff <= SPEC_LP_TOL, f"{what}: logprobs differ by {diff}")
    return compared, diff


def run_sched(sched, prompts, new, stagger=False, **kw):
    """Submit (one a step with `stagger`) and step to the end: (requests,
    wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = []
    for p in prompts:
        reqs.append(sched.submit(p, new, **kw))
        if stagger:
            sched.step()
    while sched.step():
        pass
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def counted_attend(T):
    """While inside, counts the plain `attend` calls over T-row windows
    (the verify's attention) in the yielded one-entry list."""
    n = [0]
    attend = llama.attention.attend

    def counted(q, *a, **k):
        n[0] += q.shape[1] == T
        return attend(q, *a, **k)
    llama.attention.attend = counted
    try:
        yield n
    finally:
        llama.attention.attend = attend


def spec_line(name, st, wall, plain_wall, tokens):
    say(f"  {name}: steps {st['steps']}, accepted {st['accepted']}, "
        f"produced {st['produced']} = {st['produced'] / st['steps']:.2f} "
        f"tokens a verify step (all rows); {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tok/s (plain route {plain_wall:.3f} s = "
        f"{tokens / plain_wall:.1f} tok/s)")


def step_profile(name, step, steps=4):
    """profile_decode.profile_steps of one forward: wall and device busy
    ms a step, idle share, launches a step, the top device kernels."""
    r = profile_decode.profile_steps(step, steps)
    by = {}
    for e in r["kernels"]:
        by[e.name] = by.get(e.name, 0.0) + (e.time_range.end
                                            - e.time_range.start)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:3]
    idle = 1 - r["busy_ms"] / r["prof_wall_ms"]
    say(f"    {name}: wall {r['wall_ms']:.2f} ms, busy {r['busy_ms']:.2f} "
        f"ms, idle {idle:.2f}, {len(r['kernels']) / steps:.0f} launches; top "
        + ", ".join(f"{n[:40]} {t / 1e3 / steps:.3f}" for n, t in top))
    return dict(wall_ms=r["wall_ms"], busy_ms=r["busy_ms"], idle=idle)


def phase_forwards(eng, prompts):
    """Where a verify's time goes: one forward of a γ + 1 window at B = 1
    and at B = 8 beside one decode step at B = 1, at position 128 over
    the engine's cache."""
    W = SPEC_GAMMA + 1
    _, cache = eng.prefill([prompts[0]])
    cache8 = eng.new_cache(8)
    pos = torch.full((1, 1), 128, dtype=torch.int32, device=DEV)
    tok = torch.tensor([[prompts[0][0]]], dtype=torch.int32, device=DEV)
    win = torch.arange(W, dtype=torch.int32, device=DEV)[None] + pos
    ids = tok.expand(1, W).contiguous()
    zero = torch.zeros((1,), dtype=torch.long, device=DEV)
    ids8, win8 = (t.expand(8, W).contiguous() for t in (ids, win))
    say("  where a forward's time goes (the verify's attention is the plain "
        "attend over every slot: T = 5 is below the flash kernel's 8)")
    out = dict(
        decode=step_profile("decode step, B = 1", lambda: eng._forward(
            tok, pos, cache, zero)),
        verify=step_profile(f"verify, B = 1, T = {W}", lambda:
                            eng.window_forward(ids, win, cache)),
        verify8=step_profile(f"verify, B = 8, T = {W}", lambda:
                             eng.window_forward(ids8, win8, cache8)))
    del cache, cache8
    torch.cuda.empty_cache()
    return out


def phase_spec_b1(eng, prompts, ref):
    """1-2: the B = 1 decoders (n-gram; self-draft) on the cyclic prompt
    against `generate`'s wall and the reference stream."""
    gen = GenerationConfig(max_new_tokens=SPEC_B1_NEW, **GREEDY)
    _, plain_wall = timed(lambda: eng.generate([prompts[0]], gen))
    (out, st), wall = timed(lambda: speculative.SpeculativeDecoder(
        eng, gamma=SPEC_GAMMA).generate(prompts[0], gen))
    n, _ = compare_ref(out, ref[0], "SpeculativeDecoder")
    spec_line("SpeculativeDecoder, B = 1, n-gram", st, wall, plain_wall,
              len(out))
    say(f"    {n} of {len(out)} tokens compared, equal")
    draft = InferenceEngine(CFG, eng.params, engine_cfg=eng.engine_cfg,
                            cache_dtype="int8", device=DEV)
    (dout, dst), dwall = timed(lambda: speculative.DraftModelSpeculativeDecoder(
        eng, draft, gamma=SPEC_GAMMA).generate(prompts[0], gen))
    dn, _ = compare_ref(dout, ref[0], "DraftModelSpeculativeDecoder")
    check(dst["accepted"] > 0 and dst["backfills"] > 0,
          f"self-draft: {dst}")
    spec_line("DraftModelSpeculativeDecoder, self-draft", dst, dwall,
              plain_wall, len(dout))
    say(f"    backfills {dst['backfills']}; {dn} of {len(dout)} tokens "
        f"compared, equal")
    return dict(ngram=st, ngram_wall=wall, draft=dst, draft_wall=dwall,
                generate_wall=plain_wall)


def phase_spec_sched(eng, prompts, ref):
    """3-4: the batching schedulers against the plain scheduler's walls
    and the reference streams; the fallback near the cache end."""
    gen = GenerationConfig(max_new_tokens=SPEC_NEW, **GREEDY)
    _, plain_wall = run_sched(scheduler.ContinuousBatchingScheduler(
        eng, gen), prompts, SPEC_NEW)
    sched = speculative.SpeculativeBatchingScheduler(eng, gen,
                                                     gamma=SPEC_GAMMA)
    reqs, wall = run_sched(sched, prompts, SPEC_NEW)
    n = sum(compare_ref(r.output_ids, w, f"SpeculativeBatchingScheduler "
                        f"request {i}", r.output_logprobs)[0]
            for i, (r, w) in enumerate(zip(reqs, ref)))
    spec_line(f"SpeculativeBatchingScheduler, {eng.engine_cfg.max_batch_size}"
              f" slots", sched.spec_stats, wall, plain_wall,
              SPEC_NEW * len(reqs))
    say(f"    {n} of {SPEC_NEW * len(reqs)} tokens compared, equal")
    st = dict(sched.spec_stats)
    del sched
    torch.cuda.empty_cache()

    # rows that reach the cache end: the plain-chunk fallback
    small = InferenceEngine(CFG, eng.params, engine_cfg=EngineConfig(
        max_seq_len=FALLBACK_SEQ, max_batch_size=2), cache_dtype="int8",
        device=DEV)
    long = (prompts[1] * 2)[:FALLBACK_PROMPT]
    fref, fplain = run_sched(scheduler.ContinuousBatchingScheduler(
        small, gen), [long], SPEC_NEW, top_logprobs=2)
    fs = speculative.SpeculativeBatchingScheduler(small, gen,
                                                  gamma=SPEC_GAMMA)
    (fr,), fwall = run_sched(fs, [long], SPEC_NEW)
    check(fs.spec_stats["fallbacks"] > 0, f"fallback: {fs.spec_stats}")
    fn, _ = compare_ref(fr.output_ids, fref[0], "fallback run",
                        fr.output_logprobs)
    spec_line(f"SpeculativeBatchingScheduler, 2 slots of {FALLBACK_SEQ}, "
              f"{FALLBACK_PROMPT} + {SPEC_NEW}", fs.spec_stats, fwall,
              fplain, SPEC_NEW)
    say(f"    plain-chunk fallbacks {fs.spec_stats['fallbacks']}; {fn} of "
        f"{SPEC_NEW} tokens compared, equal")
    fst = dict(fs.spec_stats)
    del fs, small
    torch.cuda.empty_cache()

    # the self-draft scheduler, admissions staggered by a step
    four = prompts[:4]
    _, dplain = run_sched(scheduler.ContinuousBatchingScheduler(
        eng, gen, slots=4), four, SPEC_NEW, stagger=True)
    draft = InferenceEngine(CFG, eng.params, engine_cfg=eng.engine_cfg,
                            cache_dtype="int8", device=DEV)
    ds = speculative.DraftSpeculativeBatchingScheduler(
        eng, draft, gen, slots=4, gamma=SPEC_GAMMA)
    dreqs, dwall = run_sched(ds, four, SPEC_NEW, stagger=True)
    dn = sum(compare_ref(r.output_ids, w, f"DraftSpeculativeBatching"
                         f"Scheduler request {i}", r.output_logprobs)[0]
             for i, (r, w) in enumerate(zip(dreqs, ref)))
    check(ds.spec_stats["accepted"] > 0, f"self-draft: {ds.spec_stats}")
    spec_line("DraftSpeculativeBatchingScheduler, self-draft, 4 slots, "
              "staggered", ds.spec_stats, dwall, dplain, SPEC_NEW * 4)
    say(f"    catch-up forwards {ds.catchups}; {dn} of {SPEC_NEW * 4} "
        f"tokens compared, equal")
    dst = dict(ds.spec_stats, catchups=ds.catchups)
    del ds, draft
    torch.cuda.empty_cache()
    return dict(sched=st, sched_wall=wall, sched_plain_wall=plain_wall,
                fallback=fst, draft_sched=dst, draft_sched_wall=dwall,
                draft_sched_plain_wall=dplain)


def phase_spec_http(eng, prompts, ref):
    """5: one /v1/completions through serve(speculative=True, slots=4)."""
    httpd = server.serve(eng, host="127.0.0.1", port=0, gen=GenerationConfig(
        max_new_tokens=SPEC_NEW, **GREEDY), speculative=True, slots=4)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out, wall = timed(lambda: post_ok(base, "/v1/completions", {
            "prompt": prompts[2], "max_tokens": SPEC_NEW}))
        st = dict(httpd.backend.sched.spec_stats)
    finally:
        stop_http(httpd)
    ids = out["choices"][0]["token_ids"]
    check(len(ids) == SPEC_NEW, f"speculative HTTP: {len(ids)} tokens")
    n, _ = compare_ref(ids, ref[2], "speculative /v1/completions")
    say(f"  serve(speculative=True, slots=4): /v1/completions 200 in "
        f"{wall:.3f} s, {n} of {SPEC_NEW} tokens compared, equal; "
        f"spec_stats {st}")
    return dict(http_wall=wall, http_stats=st)


def phase_beam(params, prompts, ref):
    """6: BeamSearchDecoder, W = 4 over 512 slots: sorted distinct
    hypotheses whose log_probs match engine.score; W = 1 is greedy."""
    eng = InferenceEngine(CFG, params, engine_cfg=EngineConfig(
        max_seq_len=BEAM_SEQ), cache_dtype="int8", device=DEV)
    one = beam_search(eng, prompts[0], 1, BEAM_NEW, ())
    n, _ = compare_ref(one[0].token_ids, ref[0], "beam search W = 1")
    dec = BeamSearchDecoder(eng, BEAM_W, eos_token_ids=())
    step, walls, state = dec._step, [], {}

    def timed_step(cache, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(cache, *a)
        state.update(cache=out[0], parents=out[4])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out
    dec._step = timed_step
    hyps, wall = timed(lambda: dec.search(prompts[0], BEAM_NEW))
    del dec._step
    check(len(hyps) == BEAM_W and [h.score for h in hyps]
          == sorted((h.score for h in hyps), reverse=True)
          and len({tuple(h.token_ids) for h in hyps}) == BEAM_W
          and all(len(h.token_ids) == BEAM_NEW for h in hyps),
          f"beam hypotheses: {[(h.score, len(h.token_ids)) for h in hyps]}")
    scores = eng.score([prompts[0] + h.token_ids for h in hyps])
    per_tok = [abs(h.log_prob - sum(s[len(prompts[0]):])) / BEAM_NEW
               for h, s in zip(hyps, scores)]
    mean = sum(per_tok) / len(per_tok)
    check(mean <= BEAM_MEAN_TOL and max(per_tok) <= BEAM_MAX_TOL,
          f"beam log_probs vs engine.score a token: {per_tok}")
    cache, parents = state["cache"], state["parents"]
    tensors = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    idx = parents.long()
    # the engine's reorder (a gather of words) beside the same gather over
    # the tensors' own elements, in turns
    reorder = [time_ms(lambda i: engine_mod.reorder_cache(cache, parents),
                       reps=10) if j % 3 == 0 else time_ms(
        lambda i: [t.index_select(1, idx) for t in tensors], reps=10)
        for j in range(4)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    words, elems = (reorder[0] + reorder[3]) / 2, (reorder[1] + reorder[2]) / 2
    rb, _ = bound_ms(2 * nbytes, 0)
    step_ms = sorted(walls)[len(walls) // 2] * 1e3
    say(f"  BeamSearchDecoder W = {BEAM_W}, {BEAM_SEQ} slots, 128 + "
        f"{BEAM_NEW}: {wall:.3f} s, a step {step_ms:.2f} ms (median of "
        f"{len(walls)}); the reorder {words:.3f} ms on the card "
        f"({[round(x, 3) for x in reorder]} in turns with a gather of the "
        f"tensors' own elements; {nbytes / 2**30:.3f} GiB read and written "
        f"at {2 * nbytes / words / 1e6:.0f} GB/s, bound {rb:.3f} ms) = "
        f"{words / step_ms:.3f} of a step; log_prob vs engine.score a "
        f"token: mean {mean:.4f}, max {max(per_tok):.4f} (tol "
        f"{BEAM_MEAN_TOL} / {BEAM_MAX_TOL}); W = 1: {n} of {BEAM_NEW} "
        f"tokens compared with greedy, equal")
    del eng, cache, state, tensors
    torch.cuda.empty_cache()
    return dict(beam_wall=wall, beam_step_ms=step_ms, reorder_ms=words,
                reorder_elems_ms=elems)


def path_speculative(params4):
    """Path (viii): speculative decoding and beam search on the int4
    g=128 weights of path (ii) over an int8 cache, every stream held to
    the plain scheduler's."""
    t0 = time.perf_counter()
    smi = card_line()
    say("path (viii): speculative decoding (engine/speculative.py) and beam "
        "search (engine/beam_search.py), LLaMA-2-7B int4 g=128, int8 KV, "
        f"gamma {SPEC_GAMMA}; card: {smi}")
    eng = InferenceEngine(CFG, params4, engine_cfg=EngineConfig(
        max_seq_len=SPEC_SEQ, max_batch_size=8), cache_dtype="int8",
        device=DEV)
    prompts = spec_prompts()
    # the reference: the plain scheduler, top-2 logprobs for the rule
    ref, _ = run_sched(scheduler.ContinuousBatchingScheduler(
        eng, GenerationConfig(max_new_tokens=SPEC_B1_NEW, **GREEDY)),
        prompts, SPEC_B1_NEW, top_logprobs=2)
    torch.cuda.empty_cache()
    zero_counts()
    with counted_attend(SPEC_GAMMA + 1) as verify_attend:
        numbers = phase_forwards(eng, prompts)
        numbers.update(phase_spec_b1(eng, prompts, ref))
        torch.cuda.empty_cache()
        numbers.update(phase_spec_sched(eng, prompts, ref))
        numbers.update(phase_spec_http(eng, prompts, ref))
        del eng
        torch.cuda.empty_cache()
        numbers.update(phase_beam(params4, prompts, ref))
    torch.cuda.synchronize()
    launches = counts()
    mma = k1.mma_launches
    check(all(launches[c] > 0 for c in SPEC_USED) and mma > 0
          and verify_attend[0] > 0,
          f"path (viii): a kernel never ran: {launches}, K1's MMA branch "
          f"{mma}, verify attend {verify_attend[0]}")
    wall = time.perf_counter() - t0
    say(f"  launches: { {c: n for c, n in launches.items() if n} }, K1's "
        f"MMA branch {mma}; the verify's plain attend {verify_attend[0]} "
        f"calls")
    say(f"path (viii) took {wall:.1f} s ({smi})")
    return dict(numbers, launches=launches, mma=mma,
                verify_attend=verify_attend[0], wall=wall)


# ---------------------------------------------------------------- path (ix)

FAM_SEQ = 8192                  # the windowed runs' cache slots
FAM_NEW = 32                    # new tokens of phase 4's requests
FAM_NB = FAM_SEQ // PAGE        # table entries of an 8192-slot sequence
# phase 3: (preset, weights, cache kind, layers); gemma3-4b at 6 layers,
# so that layer 5 is a full-attention layer
FAMILIES = (("mistral-7b", QCFG8, "bf16", 2), ("qwen2-7b", QCFG4, "int8", 2),
            ("qwen3-8b", QCFG8, "bf16", 2), ("phi3-mini", QCFG8, "bf16", 2),
            ("gemma2-2b", QCFG8, "int8", 2), ("gemma3-4b", QCFG8, "bf16", 6))
MISTRAL_PROMPT = 4200           # past mistral's 4096 window
GEMMA_PROMPTS = (4600, 1500, 700, 128)   # gemma2-2b's served requests
FAM_USED = ("K1", "K2", "K6", "K8", "K9", "K10a", "K12", "KR")


# K1 and K8 at the families' widths: (name, K, N, bits, quantized from a
# random embedding table as a tied head, rows, norm prologue)
FAM_K1_CASES = (
    ("llama3.1 lm_head", 4096, 128256, 8, False, (1, 16), False),
    ("qwen2 lm_head", 3584, 152064, 4, False, (1, 16), False),
    ("gemma2 tied lm_head", 2304, 256000, 8, True, (1, 16), False),
    ("gemma3 tied lm_head", 2560, 262208, 8, True, (1,), False),
    ("qwen2 wqkv", 3584, 4608, 4, False, (1, 64), True),
    ("phi3 wqkv", 3072, 9216, 8, False, (1, 64), True),
    ("gemma2 wqkv", 2304, 4096, 8, False, (1, 64), True),
    ("gemma3 wqkv", 2560, 4096, 8, False, (1, 64), True),
    ("qwen2 w_gateup", 3584, 37888, 4, False, (CHUNK,), True),
    ("mistral w_gateup", 4096, 28672, 8, False, (CHUNK,), True),
    # N = 32064, a last band of 64 weight rows: K1's MMA branch and K8
    # (logits of every row, as engine.score asks for them)
    ("phi3 lm_head", 3072, 32064, 8, False, (16, CHUNK), False))


@contextlib.contextmanager
def model_cfg(cfg):
    """CFG and L are `cfg`'s while inside: the phase-2 helpers and the
    launch rules written for LLaMA-2-7B read the widths from them."""
    global CFG, L
    old = CFG, L
    CFG, L = cfg, cfg.num_layers
    try:
        yield
    finally:
        CFG, L = old


def fam_params(cfg, qcfg, seed):
    """A family's prepared random weights on the card (its module's
    init_params_quantized, through the registry), with random qkv biases
    and q/k norm weights, and for gemma random (1 + w) norm weights, so
    that each moves the logits."""
    model = get_model(cfg.name)
    p = model.init_params_quantized(cfg, qcfg, seed=seed, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(seed + 100)
    lay = p["layers"]
    gemma = model is gemma2
    for k in ("bq", "bk", "bv", "q_norm", "k_norm", "post_attn_norm",
              "post_ffn_norm") + (("attn_norm", "ffn_norm") if gemma else ()):
        if k in lay:
            base = 1.0 if k in ("q_norm", "k_norm") and not gemma else 0.0
            lay[k] = (base + 0.3 * torch.randn(lay[k].shape, generator=g,
                                               device=DEV)).to(lay[k].dtype)
    out = llama.prepare_params(p)
    torch.cuda.synchronize()
    return out


def fam_scale(cfg):
    return (cfg.query_pre_attn_scalar or cfg.head_dim) ** -0.5


def visible(pos, window):
    """Slots a query at `pos` attends: min(pos + 1, window)."""
    return min(pos + 1, window) if window else pos + 1


def window_mask(pos, n, window):
    """[.., n] bool: slot <= pos, and slot > pos - window with a window."""
    slot = torch.arange(n, device=DEV)
    p = pos.long()[..., None]
    m = slot <= p
    if window:
        m &= slot > p - window
    return m


def check_binds(want, nowin, tol, what):
    """The window masks enough of the case that a kernel ignoring it would
    fail the tolerance."""
    d = max_err(want, nowin)
    check(d > tol, f"{what}: the window moves the output by {d} <= {tol}: "
          "the case does not test it")
    return d


def fam_k1_cases(gen):
    """K1 at the families' widths: the large vocabularies' lm_heads (int8
    llama3.1 N = 128256, int4 g=128 qwen2 N = 152064, gemma2's tied head
    quantized from a random table in vocabulary chunks, N = 256000, and
    gemma3's, N = 262208), each at M = 1 (the GEMV) and M = 16 (the MMA
    branch, the last rows of a batch); the qkv projections of qwen2 (int4,
    K = 3584), phi3 (K = 3072, N = 9216), gemma2 (K = 2304) and gemma3
    (K = 2560) at M = 1 and 64, with the norm prologue; K8 on the gate-up
    of qwen2 (int4, N = 37888) and mistral (int8, N = 28672) at 2048
    rows. Codes random, scales random per column (group), so an index
    slip shows. Returns the numbers by case and the largest error."""
    def rand_qt(K, N, bits):
        q = torch.randint(-128, 128, (N, K * bits // 8), generator=gen,
                          device=DEV, dtype=torch.int8)
        qmax = 2 ** (bits - 1) - 1
        shape = (1, N) if bits == 8 else (N, K // 128)
        scale = (0.5 + torch.rand(shape, generator=gen, device=DEV)) \
            * 0.02 / qmax
        return QTensor(q=q, scale=scale, bits=bits)

    def make(K, N, bits, tied):
        if not tied:
            return rand_qt(K, N, bits)
        emb = (torch.randn((N, K), generator=gen, device=DEV) * 0.02).to(BF16)
        return llama.quantize_tied_head(emb, QCFG8)
    out, err = {}, 0.0
    for name, K, N, bits, tied, Ms, prologue in FAM_K1_CASES:
        qt = make(K, N, bits, tied)
        for M in Ms:
            r = out[(name, M)] = k1_case(name, qt, M, prologue, gen, 1)
            err = max(err, r["err"])
        del qt
        torch.cuda.empty_cache()
    return out, err


def fam_flash_case(gen, cfg, kind, T, start, S, window):
    """K9 on a [2, 1, Hkv, S] cache of `kind` at cfg's heads: T rows at
    positions start .. start + T - 1, with cfg's query scale and softcap
    and the window, against flash_attention_ref. Library yardstick (none
    with a softcap): scaled_dot_product_attention over the dequantized K
    and V under the same mask."""
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale, cap = fam_scale(cfg), cfg.attn_logit_softcap
    with model_cfg(cfg):
        kc, vc, ks, vs = random_cache(gen, kind, 2, 1, S)
    q = torch.randn((1, T, Hq, D), generator=gen, device=DEV).to(BF16)
    pos = (start + torch.arange(T, device=DEV, dtype=torch.int32))[None]
    sc = dict(k_scale=ks, v_scale=vs)
    got = k9.flash_attention(q, kc, vc, 1, pos, scale=scale,
                             logit_softcap=cap, sliding_window=window, **sc)
    want = k9.flash_attention_ref(q, kc, vc, 1, pos, scale, cap, window,
                                  **sc)
    torch.cuda.synchronize()
    err = max_err(got, want)
    # as K9's cases: a few bf16 steps (2^-8 relative) of the largest output
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    what = (f"K9 {cfg.name} {kind} D={D} G={Hq // Hkv} T={T} "
            f"start={start} window={window} cap={cap}")
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"{what}: max err {err} > {tol}")
    binds = ""
    if window and start + T > window:
        nowin = k9.flash_attention_ref(q, kc, vc, 1, pos, scale, cap, 0,
                                       **sc)
        binds = f", the window moves it {check_binds(want, nowin, tol, what):.3g}"
        del nowin
    del got, want
    ms = time_ms(lambda i: k9.flash_attention(
        q, kc, vc, i % 2, pos, scale=scale, logit_softcap=cap,
        sliding_window=window, **sc), reps=10)
    plain = plain_ms(lambda i: k9.flash_attention_ref(
        q, kc, vc, i % 2, pos, scale, cap, window, **sc))
    live = start + T
    lo = max(0, start + 1 - window) if window else 0
    lib = None
    if not cap:
        with model_cfg(cfg):
            kd = [dequant_layer(kc, ks, i, kind)[:, :, :live]
                  for i in range(2)]
            vd = [dequant_layer(vc, vs, i, kind)[:, :, :live]
                  for i in range(2)]
        mask = window_mask(pos[0], live, window)
        qt_ = q.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = time_ms(lambda i: sdpa(qt_, kd[i % 2], vd[i % 2],
                                     attn_mask=mask, scale=scale,
                                     enable_gqa=Hq != Hkv), reps=10)
        del kd, vd
    pairs = sum(visible(p, window) for p in range(start, start + T))
    with model_cfg(cfg):
        nbytes = (attn_bytes(kind, Hkv, live - lo) + 2 * q.numel() * 2
                  + T * 4)
    bnd, by = bound_ms(nbytes, 4 * Hq * D * pairs)
    say(f"  {what} err {err:.3g} (tol {tol:.3g}){binds}  kernel {ms:.4f} ms"
        f"  bound {bnd:.4f} ms ({by})  plain {plain:.3f} ms  sdpa "
        f"{'n/a (softcap)' if lib is None else f'{lib:.4f} ms'}")
    del kc, vc, ks, vs
    return dict(ms=ms, plain=plain, lib=lib, bound=bnd, by=by, err=err)


def fam_decode_case(gen, cfg, kind, positions, S, window, paged=False):
    """K2 (or K10a with `paged`, over scattered 128-slot pages and a NaN
    null page) at cfg's heads over S slots of `kind`: one query a sequence
    at `positions`, with cfg's query scale and softcap and the window,
    against its plain version. Library yardstick (none with a softcap):
    scaled_dot_product_attention over the dequantized K and V (the pages
    gathered first) under the same mask."""
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale, cap = fam_scale(cfg), cfg.attn_logit_softcap
    B = len(positions)
    with model_cfg(cfg):
        if paged:
            live = [p // PAGE + 1 for p in positions]
            P = sum(live) + 1
            kc, vc, ks, vs = paged_pool(gen, kind, 2, P)
            pt = scattered_table(B, S // PAGE, P, live, SEED + B).to(DEV)
        else:
            kc, vc, ks, vs = random_cache(gen, kind, 2, B, S)
    q = torch.randn((B, 1, Hq, D), generator=gen, device=DEV).to(BF16)
    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    sc = dict(k_scale=ks, v_scale=vs)
    if paged:
        def kernel(layer, w=window):
            return k10.paged_attention(q, kc, vc, pt, layer, pos, scale=scale,
                                       logit_softcap=cap, window=w, **sc)

        def plain(layer, w=window):
            return k10.paged_attention_ref(q, kc, vc, pt, layer, pos, scale,
                                           cap, w, **sc)
    else:
        def kernel(layer, w=window):
            return k2.decode_attention(q, kc, vc, layer, pos, scale=scale,
                                       logit_softcap=cap, window=w, **sc)

        def plain(layer, w=window):
            return k2.decode_attention_ref(q, kc, vc, layer, pos, scale,
                                           cap, w, **sc)
    got = kernel(1)
    want = plain(1).reshape(got.shape)
    torch.cuda.synchronize()
    err = max_err(got, want)
    # as K2's and K10a's cases: a few bf16 steps of the largest output
    tol = 4 * 2.0 ** -8 * want.float().abs().max().item()
    what = (f"{'K10a' if paged else 'K2'} {cfg.name} {kind} D={D} "
            f"G={Hq // Hkv} S={S} pos={positions} window={window} cap={cap}")
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"{what}: max err {err} > {tol}")
    binds = ""
    if window and max(positions) >= window:
        d = check_binds(want, plain(1, 0).reshape(got.shape), tol, what)
        binds = f", the window moves it {d:.3g}"
    ms = time_ms(lambda i: kernel(i % 2))
    plain_t = plain_ms(lambda i: plain(i % 2))
    lib = None
    if not cap:
        n = max(positions) + 1
        with model_cfg(cfg):
            if paged:
                kd = [gathered(kc, ks, pt, i, kind)[:, :, :n]
                      for i in range(2)]
                vd = [gathered(vc, vs, pt, i, kind)[:, :, :n]
                      for i in range(2)]
            else:
                kd = [dequant_layer(kc, ks, i, kind)[:, :, :n]
                      for i in range(2)]
                vd = [dequant_layer(vc, vs, i, kind)[:, :, :n]
                      for i in range(2)]
        mask = window_mask(pos, n, window)[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = time_ms(lambda i: sdpa(q.transpose(1, 2), kd[i % 2],
                                     vd[i % 2], attn_mask=mask, scale=scale,
                                     enable_gqa=Hq != Hkv))
        del kd, vd
    seen = [visible(p, window) for p in positions]
    with model_cfg(cfg):
        nbytes = (sum(attn_bytes(kind, Hkv, v) for v in seen)
                  + 2 * q.numel() * 2 + B * 4
                  + (B * (S // PAGE) * 4 if paged else 0))
    bnd, by = bound_ms(nbytes, sum(4 * Hq * D * v for v in seen))
    say(f"  {what} err {err:.3g} (tol {tol:.3g}){binds}  kernel {ms:.4f} ms"
        f"  bound {bnd:.5f} ms ({by})  plain {plain_t:.3f} ms  sdpa "
        f"{'n/a (softcap)' if lib is None else f'{lib:.4f} ms'}")
    del kc, vc, ks, vs
    return dict(ms=ms, plain=plain_t, lib=lib, bound=bnd, by=by, err=err)


def fam_attention_cases(gen):
    """K9, K2 and K10a at the families' shapes: gemma2's D = 256, G = 2,
    query scale 256^-0.5, softcap 50 and 4096 window (a 2048-row chunk at
    positions 6144-8191 and a 512-row one at 4096-4607 over 8192 int8
    slots; decode at 8191, and at four positions of which two are past the
    window, whose start falls inside a tile, dense and over pages);
    mistral's G = 4 with its 4096 window (bf16); qwen2's G = 7 (int8),
    without one."""
    g2 = preset("gemma2-2b")
    mi = preset("mistral-7b")
    qw = preset("qwen2-7b")
    r = {}
    r["k9 gemma2"] = fam_flash_case(gen, g2, "int8", CHUNK, FAM_SEQ - CHUNK,
                                    FAM_SEQ, g2.sliding_window)
    fam_flash_case(gen, g2, "int8", 512, 4096, FAM_SEQ, g2.sliding_window)
    r["k9 mistral"] = fam_flash_case(gen, mi, "bf16", CHUNK, FAM_SEQ - CHUNK,
                                     FAM_SEQ, mi.sliding_window)
    r["k9 qwen2"] = fam_flash_case(gen, qw, "int8", CHUNK, 0, LONG_SEQ, 0)
    r["k2 gemma2"] = fam_decode_case(gen, g2, "int8", [FAM_SEQ - 1], FAM_SEQ,
                                     g2.sliding_window)
    fam_decode_case(gen, g2, "int8", [100, 3000, 4631, FAM_SEQ - 1], FAM_SEQ,
                    g2.sliding_window)
    r["k2 mistral"] = fam_decode_case(gen, mi, "bf16", [FAM_SEQ - 1],
                                      FAM_SEQ, mi.sliding_window)
    r["k2 qwen2"] = fam_decode_case(gen, qw, "int8", [3060], LONG_SEQ, 0)
    r["k10a gemma2"] = fam_decode_case(
        gen, g2, "int8", [100, 3000, 4631, FAM_SEQ - 1], FAM_SEQ,
        g2.sliding_window, paged=True)
    torch.cuda.empty_cache()
    return r


def fam_parity(name, qcfg, kind, n_layers):
    """Phase 3 of one family: a n_layers model at the preset's full width
    (random weights, biases and norms) through its module's forward on
    the CPU (plain versions) and on the card (kernels): the logits of a
    128-row prefill (B = 2, T = 64) and PARITY_STEPS decode steps over
    MAX_SEQ slots of `kind`, at path (i)'s phase-3 tolerance. Returns the
    card's weights."""
    cfg = preset(name)
    # cut to n_layers; gemma3's layer kinds with it
    cfg = dataclasses.replace(cfg, num_layers=n_layers, layer_types=(
        None if cfg.layer_types is None else cfg.layer_types[:n_layers]))
    model = get_model(cfg.name)
    cpu = torch.device("cpu")
    p_gpu = fam_params(cfg, qcfg, SEED + 20)
    p_cpu = llama.params_to(p_gpu, cpu)
    B, T = 2, 64
    lengths = [64, 41]
    gen = torch.Generator().manual_seed(SEED + 21)
    ids = torch.randint(1, cfg.vocab_size, (B, T), generator=gen,
                        dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    last = torch.tensor([n - 1 for n in lengths])

    def new_cache(dev):
        return kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads,
                                  MAX_SEQ, cfg.head_dim, KV_DTYPE[kind],
                                  device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        c_cpu, c_gpu = new_cache(cpu), new_cache(DEV)
        l_cpu = model.forward(cfg, p_cpu, ids, pos, c_cpu, last_idx=last)[0]
        l_gpu = model.forward(cfg, p_gpu, ids.to(DEV), pos.to(DEV), c_gpu,
                              last_idx=last.to(DEV))[0]
        errs, finite = [], []
        scale = 0.0
        nxt = torch.tensor(lengths, dtype=torch.int32)[:, None]
        for step in range(PARITY_STEPS + 1):
            finite.append(bool(torch.isfinite(l_cpu).all())
                          and bool(torch.isfinite(l_gpu).all()))
            errs.append((l_gpu.cpu() - l_cpu).abs().max().item())
            scale = max(scale, l_cpu.abs().max().item())
            if step == PARITY_STEPS:
                break
            tok = l_cpu.argmax(-1).to(torch.int32)[:, None]
            l_cpu, _ = model.forward(cfg, p_cpu, tok, nxt, c_cpu)
            l_gpu, _ = model.forward(cfg, p_gpu, tok.to(DEV), nxt.to(DEV),
                                     c_gpu)
            nxt = nxt + 1
    del p_cpu, c_cpu, c_gpu
    # path (i)'s phase-3 rule: 4 bf16 steps of the largest logit
    tol = 4 * 2.0 ** -8 * scale
    say(f"  {name} ({n_layers} layers, {qcfg.weights}"
        f"{'' if qcfg.group_size == 0 else f' g={qcfg.group_size}'}, {kind} "
        f"cache, module {model.__name__.rsplit('.', 1)[1]}): logits max err "
        f"(prefill, {PARITY_STEPS} decode steps) "
        f"{['%.4f' % e for e in errs]} (tol {tol:.4f}, max |logit| "
        f"{scale:.3f}) in {time.perf_counter() - t0:.1f} s")
    check(all(finite), f"{name} parity: non-finite logits")
    check(max(errs) <= tol, f"{name} parity: {max(errs)} > {tol}")
    return cfg, p_gpu


@contextlib.contextmanager
def plain_attention():
    """Every llama forward's attention takes the plain `attend` (with the
    window's mask) while inside."""
    route = llama.attention_route
    llama.attention_route = lambda *a, **k: "attend"
    try:
        yield
    finally:
        llama.attention_route = route


def fam_mistral_long(cfg, params):
    """mistral (2 layers) on a 4200-token prompt over 8192 slots, then
    PARITY_STEPS decode steps: chunks of 2048, 2048 and 128 rows, the last
    past the 4096 window, through K9, and decode steps through K2, all
    windowed; held to the same run with attention on the plain path
    (attend under the window's mask) on the card, at phase 3's
    tolerance, and shown to differ from the run without the window."""
    gen = torch.Generator().manual_seed(SEED + 22)
    prompt = torch.randint(1, cfg.vocab_size, (MISTRAL_PROMPT,),
                           generator=gen).tolist()
    steps = torch.randint(1, cfg.vocab_size, (PARITY_STEPS,),
                          generator=gen).tolist()

    def run(c):
        eng = InferenceEngine(c, params, engine_cfg=EngineConfig(
            max_seq_len=FAM_SEQ), cache_dtype=BF16, device=DEV)
        out = []
        with torch.no_grad():
            logits, cache = eng.prefill([prompt])
            out.append(logits)
            zeros = torch.zeros((1,), dtype=torch.long, device=DEV)
            for j, t in enumerate(steps):
                logits, cache = eng._forward(
                    torch.tensor([[t]], dtype=torch.int32, device=DEV),
                    torch.tensor([[MISTRAL_PROMPT + j]], dtype=torch.int32,
                                 device=DEV), cache, zeros)
                out.append(logits)
        torch.cuda.synchronize()
        del eng, cache
        return out
    before = counts()
    got = run(cfg)
    ran = {c: n - before[c] for c, n in counts().items()}
    check(ran["K9"] == 3 * cfg.num_layers
          and ran["K2"] == PARITY_STEPS * cfg.num_layers,
          f"mistral 4200: K9/K2 launches {ran}")
    with plain_attention():
        want = run(cfg)
    nowin = run(dataclasses.replace(cfg, sliding_window=0))
    scale = max(w.abs().max().item() for w in want)
    tol = 4 * 2.0 ** -8 * scale
    errs = [max_err(g, w) for g, w in zip(got, want)]
    moved = max(max_err(g, n) for g, n in zip(got, nowin))
    say(f"  mistral-7b (2 layers) 4200-token prompt over {FAM_SEQ} slots, "
        f"window {cfg.sliding_window}: kernels vs plain attention, logits "
        f"max err (prefill, {PARITY_STEPS} steps) "
        f"{['%.4f' % e for e in errs]} (tol {tol:.4f}); without the window "
        f"the logits move {moved:.4f}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "mistral 4200: non-finite logits")
    check(max(errs) <= tol, f"mistral 4200: {max(errs)} > {tol}")
    check(moved > 0, "mistral 4200: the window changed nothing")


def k12_refusals(parity):
    """K12 keeps refusing what it lacks: the qkv bias (qwen2), a window
    (mistral, gemma2), a softcap and D = 256 (gemma2), qk-norm (qwen3,
    gemma3), D = 96 (phi3)."""
    for name, (cfg, params) in parity.items():
        cache = kvcache.init_cache(cfg.num_layers, 1, cfg.num_kv_heads,
                                   MAX_SEQ, cfg.head_dim, BF16, device=DEV)
        check(not k12.supports(cfg, (1, 1, cfg.hidden_size),
                               params["layers"], cache),
              f"K12 takes {name}, which it cannot serve")
    say(f"  K12 refuses {sorted(parity)} (bias, window, softcap, qk-norm, "
        "head_dim)")


def fam_llama31(gen, tally):
    """Llama-3.1-8B at full depth, int8 weights and lm_head, bf16 cache:
    phase 2's K12 (G = 4) and RoPE-and-write (Hkv = 8) cases, then
    generate 128 + 32 and 3000 + 32 over 4096 slots with the megakernel on
    and off (phase_mega_generate: launches, streams). Returns its
    entries' numbers."""
    cfg = preset("llama3.1-8b")
    say(f"  Llama-3.1-8B ({cfg.num_layers} layers, int8, bf16 cache, "
        f"vocabulary {cfg.vocab_size})")
    params = fam_params(cfg, QCFG8, SEED)
    r = {}
    with model_cfg(cfg):
        r["k12"] = k12_case(params, "int8", "bf16", 191, MAX_SEQ, gen)
        k12_case(params, "int8", "bf16", 3060, LONG_SEQ, gen)
        r["kr llama3.1"] = rope_write_cases(gen, "bf16")
        torch.cuda.empty_cache()
        pg = torch.Generator().manual_seed(SEED + 23)
        for n in (128, 3000):
            prompt = torch.randint(1, cfg.vocab_size, (n,),
                                   generator=pg).tolist()
            phase_mega_generate(params, "int8", "bf16", prompt, True,
                                new=FAM_NEW, tally=tally)
    del params
    torch.cuda.empty_cache()
    return r


def fam_gemma2(tally, smi):
    """Gemma-2-2B at full depth, int8 weights with the tied lm_head
    quantized from the table, int8 cache: generate a 4600-token prompt
    over 8192 slots and FAM_NEW tokens (launches against the rule, the
    window binding on the even layers), then the dense scheduler (the
    reference) and the paged one (K10a) serving GEMMA_PROMPTS, greedy,
    the paged streams and generate's held to the reference."""
    cfg = preset("gemma2-2b")
    params = fam_params(cfg, QCFG8, SEED)
    check(isinstance(params.get("lm_head"), QTensor),
          "gemma2: no quantized tied lm_head")
    eng = InferenceEngine(cfg, params, engine_cfg=EngineConfig(
        max_seq_len=FAM_SEQ, max_batch_size=4, page_size=PAGE),
        cache_dtype="int8", device=DEV)
    check(eng._model is gemma2, "gemma2: the registry gave another module")
    pg = torch.Generator().manual_seed(SEED + 24)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=pg).tolist()
               for n in GEMMA_PROMPTS]
    gen = GenerationConfig(max_new_tokens=FAM_NEW, greedy=True,
                           eos_token_ids=())
    eng.generate([prompts[0][:300]], dataclasses.replace(
        gen, max_new_tokens=2))                         # warm-up
    torch.cuda.synchronize()
    zero_counts()
    res = eng.generate([prompts[0]], gen)[0]
    torch.cuda.synchronize()
    got = counts()
    with model_cfg(cfg):
        want = expected_launches("int8", "int8",
                                 prefill_chunks(eng, [GEMMA_PROMPTS[0]]),
                                 FAM_SEQ, FAM_NEW - 1)
    check(got == want, f"gemma2 generate: launches {got} != {want}")
    for c, n in got.items():
        tally[c] = tally.get(c, 0) + n
    say(f"  gemma2-2b generate {GEMMA_PROMPTS[0]} + {FAM_NEW} over {FAM_SEQ}"
        f" slots (int8, tied int8 head, int8 cache): TTFT "
        f"{res.ttft_s * 1e3:.2f} ms, decode {res.decode_tokens_per_s:.2f} "
        f"tok/s; launches {({c: n for c, n in got.items() if n})} ({smi})")
    zero_counts()
    ref, wall_ref = run_sched(scheduler.ContinuousBatchingScheduler(
        eng, gen), prompts, FAM_NEW, top_logprobs=2)
    paged, wall = run_sched(scheduler.PagedScheduler(eng, gen), prompts,
                            FAM_NEW, top_logprobs=2)
    torch.cuda.synchronize()
    got = counts()
    check(got["K10a"] > 0 and got["K2"] > 0,
          f"gemma2 schedulers: K10a / K2 never ran: {got}")
    for c, n in got.items():
        tally[c] = tally.get(c, 0) + n
    c0, d0 = compare_ref(res.token_ids, ref[0], "gemma2 generate vs dense "
                         "scheduler")
    compared, diff = c0, d0
    for p, r in zip(paged, ref):
        c, d = compare_ref(p.output_ids, r, f"gemma2 paged request "
                           f"{r.req_id}", p.output_logprobs)
        compared, diff = compared + c, max(diff, d)
    n_tok = len(prompts) * FAM_NEW
    say(f"  gemma2-2b schedulers, {len(prompts)} requests "
        f"{list(GEMMA_PROMPTS)} + {FAM_NEW}: dense {n_tok / wall_ref:.1f} "
        f"tok/s in {wall_ref:.2f} s, paged {n_tok / wall:.1f} tok/s in "
        f"{wall:.2f} s; {compared} of {n_tok + FAM_NEW} tokens compared, "
        f"equal, logprobs within {diff:.4f}; launches "
        f"{({c: n for c, n in got.items() if n})} ({smi})")
    del eng, params
    torch.cuda.empty_cache()


def fam_entry(name, source, replaces, launches, r, per_step, work):
    e = entry(name, source, replaces, launches, r["err"],
              dict(r, lib=0.0 if r["lib"] is None else r["lib"]), per_step,
              work)
    if r["lib"] is None:
        e["library_ms"] = None
    return e


def path_families(gen):
    """Path (ix): the model registry and the dense families beyond
    LLaMA-2 (models/llama.py's llama3/3.1, mistral, qwen2, qwen3, phi3;
    models/gemma2.py's gemma2 and gemma3)."""
    t0 = time.perf_counter()
    smi = card_line()
    say(f"path (ix): the families (registry, models/llama.py, "
        f"models/gemma2.py); card: {smi}")
    say("phase 2: the kernels at the families' shapes vs their plain "
        "versions on the card")
    k1r, k1_err = fam_k1_cases(gen)
    att = fam_attention_cases(gen)
    kr = {}
    for name, kind in (("phi3-mini", "bf16"), ("qwen2-7b", "int8")):
        with model_cfg(preset(name)):
            kr[name] = rope_write_cases(gen, kind)
    say("phase 3: 2 layers at each family's full width (gemma3-4b: 6), CPU "
        "plain vs card kernels")
    tally = {}
    zero_counts()
    parity = {}
    for name, qcfg, kind, n in FAMILIES:
        parity[name] = fam_parity(name, qcfg, kind, n)
        torch.cuda.empty_cache()
    fam_mistral_long(*parity["mistral-7b"])
    for c, n in counts().items():
        tally[c] = tally.get(c, 0) + n
    k12_refusals(parity)
    cfg_q, p_q = parity["qwen2-7b"]
    with model_cfg(cfg_q):
        k6_r, k6_err = k6_cases(p_q, gen)
    del parity, p_q
    torch.cuda.empty_cache()
    say(f"phase 4: full depth ({smi})")
    zero_counts()
    big = fam_llama31(gen, tally)
    zero_counts()
    fam_gemma2(tally, smi)
    check(all(tally.get(c, 0) > 0 for c in FAM_USED),
          f"path (ix): a kernel never ran: {tally}")
    wall = time.perf_counter() - t0
    say(f"  launches (phases 3-4): { {c: n for c, n in tally.items() if n} }")
    say(f"path (ix) took {wall:.1f} s ({smi})")
    t = tally
    k1w = "one call, M={M}: {n}"
    out = []
    for (name, M), r in k1r.items():
        if M == CHUNK:
            out.append(fam_entry(
                f"K8 quant_matmul tiled prefill GEMM ({name}, "
                f"int{'4' if 'qwen2' in name else '8'})",
                "quant_matmul_tiled.cu", "quant_matmul.py:379", t["K8"], r,
                1, k1w.format(M=M, n=name)))
        elif M == 1 or "lm_head" in name:
            out.append(fam_entry(
                f"K1 quant_matmul {'GEMV' if M == 1 else 'MMA branch'} "
                f"({name})", "quant_matmul.cu" if M == 1 else
                "quant_matmul_tiled.cu", "quant_matmul.py:496", t["K1"], r,
                1, k1w.format(M=M, n=name)))
    for key, label, src, rep, launches in (
            ("k9 gemma2", "K9 flash_attention (gemma2: int8 cache, D=256, "
             "window 4096, softcap 50)", "flash_attention.cu",
             "flash_attention.py:251", t["K9"]),
            ("k9 mistral", "K9 flash_attention (mistral: bf16 cache, G=4, "
             "window 4096)", "flash_attention.cu", "flash_attention.py:251",
             t["K9"]),
            ("k9 qwen2", "K9 flash_attention (qwen2: int8 cache, G=7)",
             "flash_attention.cu", "flash_attention.py:251", t["K9"]),
            ("k2 gemma2", "K2 decode_attention (gemma2: int8 cache, D=256, "
             "window 4096, softcap 50, scale 256^-0.5)",
             "decode_attention.cu", "decode_attention.py:489", t["K2"]),
            ("k2 mistral", "K2 decode_attention (mistral: bf16 cache, G=4, "
             "window 4096)", "decode_attention.cu",
             "decode_attention.py:489", t["K2"]),
            ("k2 qwen2", "K2 decode_attention (qwen2: int8 cache, G=7)",
             "decode_attention.cu", "decode_attention.py:489", t["K2"]),
            ("k10a gemma2", "K10a paged_attention (gemma2: int8 pages, "
             "D=256, window 4096, softcap 50)", "decode_attention.cu",
             "paged_attention.py:271", t["K10a"])):
        out.append(fam_entry(label, src, rep, launches, att[key], 1,
                             "one layer's call"))
    for name, kind, rep in (("phi3-mini", "bf16", "kv_write.py:72"),
                            ("qwen2-7b", "int8", "kv_write.py:152")):
        r = kr[name][(1, 1)]
        out.append(fam_entry(
            f"K3/K4 rope_write ({name}: {kind} cache, D="
            f"{preset(name).head_dim}, Hkv={preset(name).num_kv_heads})",
            "kv_write.cu", rep, t["KR"], dict(r, err=0.0), 1,
            "one layer's call at B=1, T=1"))
    r = big["kr llama3.1"][(1, 1)]
    out.append(fam_entry("K3/K4 rope_write (llama3.1-8b: bf16 cache, Hkv=8)",
                         "kv_write.cu", "kv_write.py:72", t["KR"],
                         dict(r, err=0.0), 1, "one layer's call at B=1"))
    out.append(fam_entry("K12 layer_decode_fused (llama3.1-8b int8, bf16 "
                         "cache, G=4)", "layer_fused.cu", "layer_fused.py:353",
                         t["K12"], big["k12"], 1, "one layer at pos 191"))
    out.append(fam_entry("K6 layer_tail_fused (qwen2-7b int4 g=128, K=3584, "
                         "I=18944)", "layer_tail.cu", "quant_matmul.py:699",
                         t["K6"], dict(k6_r, err=k6_err), 1,
                         "one layer's tail at M=1"))
    return out



# ------------------------------------------------------------- path (x)

MOE_NEW = 32                     # new tokens of phase 4's requests
MIXTRAL_SEQ = 4096               # Mixtral's cache: a 3000-token prompt + 32
DS_SEQ = 3072                    # DeepSeek's: a 2500-token prompt + 32
DS_LONG = 2500
MOE_SERVED = (600, 300, 128, 64)  # the schedulers' four requests
LATENT = (576, 512)              # DeepSeek-V3's k and v rows (one kv head)
# Mixtral's int4 g=128 weights drawn as codes; its lm_head stays dense, as
# the JAX package's mixtral.init_params_quantized leaves it
QCFG4_MOE = QuantConfig(weights="int4", group_size=128)
QCFG8_MOE = QuantConfig(weights="int8")
MOE_USED = ("K1", "K2", "K3", "K4", "K8", "K9", "K10a", "KR", "KS")


def moe_preset(name, **kw):
    """A preset at its published widths, its depth cut by `kw`."""
    return dataclasses.replace(preset(name), **kw)


@contextlib.contextmanager
def plain_kernels():
    """While inside, the wrappers of the mixture-of-experts paths run their
    plain versions on the card's tensors: K1 and K8 (quant_matmul_ref), the
    RoPE and KV write, K3, K4 and the scale write (the *_ref writes), and
    attention the plain `attend` (llama.attention_route). Phase 3's
    reference for path (x): on the CPU the plain versions would take
    minutes a layer at these widths (256 experts of 7168 x 2048, or 8 of
    4096 x 14336, dequantized per call)."""
    swaps = ((k1, "quant_matmul", k1.quant_matmul_ref),
             (k3, "rope_write", k3.rope_write_ref),
             (k3, "write_token", k3.write_token_ref),
             (k3, "quantize_write_token", k3.quantize_write_token_ref),
             (k3, "write_token_scales", k3.write_token_scales_ref),
             (llama, "attention_route", lambda *a, **k: "attend"))
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def latent_write_cases(gen):
    """K3 and K4 at DeepSeek-V3's latent rows (k 576, v 512 values, one kv
    head) over a 5-layer 3072-slot cache, B = 1 and B = 4 with an offset
    past the end, and K3 on the int4 latent cache's packed rows (288 and
    256 bytes) with the scale write: each bit for bit its plain version,
    timed beside its bound (the rows read and written over the HBM rate;
    K4's quantize ops over the float32 rate), the plain version and a
    library yardstick (index writes; K4 with the torch quantize ops).
    Returns the B = 1 numbers by entry."""
    kD, vD = LATENT
    Lc, S = 5, DS_SEQ
    out = {}
    for B, offs in ((1, [2600]), (4, [0, 77, S - 1, S + 9])):
        off = torch.tensor(offs, dtype=torch.int32, device=DEV)
        rows = torch.arange(B, device=DEV)
        offl = torch.clamp(off.long(), 0, S - 1)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=DEV).to(BF16)

        def codes(*shape):
            return torch.randint(-128, 128, shape, generator=gen,
                                 device=DEV, dtype=torch.int8)

        def scales():
            return torch.rand((Lc, B, S, 1), generator=gen, device=DEV)
        kn, vn = randn(B, 1, 1, kD), randn(B, 1, 1, vD)
        pk, pv = codes(B, 1, 1, kD // 2), codes(B, 1, 1, vD // 2)
        ksn = torch.rand((B, 1, 1), generator=gen, device=DEV)
        vsn = torch.rand((B, 1, 1), generator=gen, device=DEV)
        cases = {
            "K3": ([randn(Lc, B, 1, S, kD), randn(Lc, B, 1, S, vD)],
                   lambda c, i: k3.write_token(*c, i, kn, vn, off),
                   lambda c, i: k3.write_token_ref(*c, i, kn, vn, off),
                   2 * B * (kD + vD) * 2, 0),
            "K4": ([codes(Lc, B, 1, S, kD), codes(Lc, B, 1, S, vD),
                    scales(), scales()],
                   lambda c, i: k3.quantize_write_token(*c, i, kn, vn, off),
                   lambda c, i: k3.quantize_write_token_ref(*c, i, kn, vn,
                                                            off),
                   B * (kD + vD) * 3 + 2 * B * 4, 5 * B * (kD + vD)),
            "K3 int4": ([codes(Lc, B, 1, S, kD // 2),
                         codes(Lc, B, 1, S, vD // 2)],
                        lambda c, i: k3.write_token(*c, i, pk, pv, off),
                        lambda c, i: k3.write_token_ref(*c, i, pk, pv, off),
                        2 * B * (kD + vD) // 2, 0),
            "scale write": ([scales(), scales()],
                            lambda c, i: k3.write_token_scales(
                                *c, i, ksn, vsn, off),
                            lambda c, i: k3.write_token_scales_ref(
                                *c, i, ksn, vsn, off), 2 * 2 * B * 4, 0)}
        lib_fns = {
            "K3": lambda c, i: (
                c[0][i].__setitem__((rows, slice(None), offl), kn[:, :, 0]),
                c[1][i].__setitem__((rows, slice(None), offl), vn[:, :, 0])),
            "K3 int4": lambda c, i: (
                c[0][i].__setitem__((rows, slice(None), offl), pk[:, :, 0]),
                c[1][i].__setitem__((rows, slice(None), offl), pv[:, :, 0])),
            "scale write": lambda c, i: (
                c[0][i].__setitem__((rows, offl), ksn[:, 0]),
                c[1][i].__setitem__((rows, offl), vsn[:, 0]))}

        def quant_lib(c, i):
            # the torch quantize ops on k and v apart, then index writes
            for codes_all, scales_all, new in ((c[0], c[2], kn),
                                               (c[1], c[3], vn)):
                x = new[:, :, 0].float()
                sc = torch.clamp(x.abs().amax(-1, keepdim=True) / 127.0,
                                 min=1e-8)
                codes_all[i][rows, :, offl] = torch.clamp(
                    torch.round(x / sc), -128, 127).to(torch.int8)
                scales_all[i][rows, offl] = sc[..., 0]
        lib_fns["K4"] = quant_lib
        for name, (caches, kern, plain, nbytes, ops) in cases.items():
            ref = [c.clone() for c in caches]
            kern(caches, 2)
            plain(ref, 2)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(caches, ref)),
                  f"latent {name} B={B}: differs from the plain version")
            ms = time_ms(lambda i: kern(caches, i % Lc))
            pl = time_ms(lambda i: plain(ref, i % Lc))
            lib = time_ms(lambda i: lib_fns[name](ref, i % Lc))
            bnd, by = bound_ms(nbytes + B * 4, ops, FP32_FLOPS)
            say(f"  latent {name} k {kD} / v {vD} B={B} offsets={offs} "
                f"exact  kernel {ms:.4f} ms  bound {bnd:.6f} ms ({by})  "
                f"plain {pl:.4f} ms  library {lib:.4f} ms")
            if B == 1:
                out[name] = dict(ms=ms, plain=pl, lib=lib, bound=bnd, by=by,
                                 err=0.0)
            del caches, ref
    return out


def stack_k1_case(name, qt, M, idx, gen):
    """K1 (M <= 128: its GEMV up to 8 rows, its MMA branch above) or K8
    (M > 128) on weight idx of a stack [n, N, K'] (an expert of the last
    layer's block, or a layer of a stack), against its plain version;
    timed over the 8 weights up to idx in turn, so that each call reads
    its codes from HBM as the main path does (an expert is 14.7 MB, the L2
    50 MB)."""
    K, N = qt.in_features, qt.out_features
    x = torch.randn((M, K), generator=gen, device=DEV).to(BF16)
    got = k1.quant_matmul(x, qt, idx)
    want = k1.quant_matmul_ref(x, qt, idx)
    torch.cuda.synchronize()
    err = max_err(got, want)
    # as k1_case and k8_cases: one bf16 step of the largest output
    tol = 2.0 ** -7 * want.float().abs().max().item()
    check(err <= tol, f"{name} M={M}: max err {err} > {tol}")
    span = min(8, idx + 1)

    def lay(i):
        return idx - i % span
    reps = 10 if M > K1_MAX_ROWS else 20
    ms = time_ms(lambda i: k1.quant_matmul(x, qt, lay(i)), reps=reps)
    plain = plain_ms(lambda i: k1.quant_matmul_ref(x, qt, lay(i)))
    deq = [dequantize(qt.layer(lay(i)), BF16) for i in range(2)]
    lib = time_ms(lambda i: torch.matmul(x, deq[i % 2]), reps=reps)
    del deq
    nbytes = qbytes(qt) + M * K * 2 + M * N * 2
    bnd, by = bound_ms(nbytes, 2 * M * K * N)
    say(f"  {'K8' if M > K1_MAX_ROWS else 'K1'} int{qt.bits} {name} "
        f"[{K} x {N}] M={M} err {err:.3g} (tol {tol:.3g})  kernel "
        f"{ms:.4f} ms  bound {bnd:.4f} ms ({by})  plain {plain:.3f} ms  "
        f"torch.matmul(bf16) {lib:.4f} ms")
    return dict(ms=ms, plain=plain, lib=lib, bound=bnd, err=err, by=by)


def moe_forward_launches(want, cfg, cache_dtype, batch, rows, S, ps=0,
                         history=False):
    """Add one forward's kernel launches to `want` (forward_launches' rule
    for the two families). Every projection is K1 up to 128 rows and K8
    above; the lm_head is dense (no kernel). Mixtral: 4 + 3 E projections
    a layer (wq, wk, wv, wo; every expert's gate, up and down: the
    dense-masked mixture), the RoPE and write of a dense cache (KR) a
    layer, attention where llama.attention_route says. DeepSeek: 7 a dense
    layer (wq_a, wq_b, wkv_a, wo, w_gate, w_up, w_down), 4 + 3 E + 3 a MoE
    layer (the shared expert too); a decode step's latent write K3 (bf16),
    K4 (int8), or K3 and the scale write (int4) a layer (a prefill's and
    the pool's writes are plain); attention plain."""
    M = batch * rows
    mm = "K8" if M > K1_MAX_ROWS else "K1"
    E, Lx = cfg.num_experts, cfg.num_layers
    if deepseek.is_deepseek(cfg):
        Ld = cfg.first_k_dense
        want[mm] += 7 * Ld + (4 + 3 * E + 3) * (Lx - Ld)
        if rows == 1 and not ps:
            if cache_dtype == "int8":
                want["K4"] += Lx
            else:
                want["K3"] += Lx
                want["KS"] += Lx if cache_dtype == "int4" else 0
        return
    want[mm] += (4 + 3 * E) * Lx
    route = llama.attention_route((batch, rows, cfg.num_heads, cfg.head_dim),
                                  S, cache_dtype != BF16, ps, history)
    kernel = {"flash": "K9", "decode": "K5" if cache_dtype == "int4" else
              "K2", "paged_flash": "K11",
              "paged_decode": "K10b" if cache_dtype == "int4" else
              "K10a"}.get(route)
    if kernel:
        want[kernel] += Lx
    if not ps:
        want["KR"] += Lx


def moe_expected(eng, lens, steps):
    want = {c: 0 for c in COUNTERS}
    S = eng.engine_cfg.max_seq_len
    chunks = prefill_chunks(eng, lens)
    for batch, rows in chunks:
        moe_forward_launches(want, eng.cfg, eng.cache_dtype, batch, rows, S)
    for _ in range(steps):
        moe_forward_launches(want, eng.cfg, eng.cache_dtype, chunks[0][0], 1,
                             S)
    return want


@contextlib.contextmanager
def recorded_routing(log):
    """While inside, the experts each router call picks (bool [.., E])
    are appended to `log`."""
    saved = (mixtral.router_weights, deepseek.router_weights)

    def recording(f):
        def g(*a, **k):
            sel = f(*a, **k)
            log.append(sel != 0)
            return sel
        return g
    mixtral.router_weights, deepseek.router_weights = map(recording, saved)
    try:
        yield
    finally:
        mixtral.router_weights, deepseek.router_weights = saved


def moe_parity(name, cfg, params, kind, plain_prefill=False):
    """Phase 3 of one configuration: its 2-layer model through its
    module's forward, the kernels against their plain versions on the card
    (plain_kernels): the logits of every row of a 128-row prefill (B = 2,
    T = 64) and of PARITY_STEPS decode steps, at path (i)'s phase-3
    tolerance. A token whose router picked other experts on the two sides
    in any layer (a near-tie of its scores, which the projections'
    rounding decides; 8 of 256 experts leave narrow gaps) is left out of
    the comparison and counted; at most half the rows may be. With
    `plain_prefill` both sides prefill on the plain route (the same
    cache) and only the decode steps compare: DeepSeek's int4 latent
    cache, whose quantizer turns the projections' one-ulp differences into
    whole int4 steps of 576-wide rows; its prefill runs the kernels of
    the int8 variant, held there."""
    model = get_model(cfg.name)
    B, T = 2, 64
    g = torch.Generator().manual_seed(SEED + 31)
    ids = torch.randint(1, cfg.vocab_size, (B, T), generator=g,
                        dtype=torch.int32).to(DEV)
    pos = torch.arange(T, dtype=torch.int32, device=DEV)[None].repeat(B, 1)

    def cache():
        if hasattr(model, "new_cache"):
            return model.new_cache(cfg, B, MAX_SEQ, KV_DTYPE[kind],
                                   device=DEV)
        return kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads,
                                  MAX_SEQ, cfg.head_dim, KV_DTYPE[kind],
                                  device=DEV)

    def both(tok, p, caches, mode):
        logs = ([], [])
        with recorded_routing(logs[0]):
            l_k = model.forward(cfg, params, tok, p, caches[0],
                                logits_mode=mode)[0]
        with plain_kernels(), recorded_routing(logs[1]):
            l_p = model.forward(cfg, params, tok, p, caches[1],
                                logits_mode=mode)[0]
        same = torch.stack([(a == b).all(-1) for a, b in zip(*logs)]
                           ).all(0).reshape(B, -1)
        return l_k.reshape(B, -1, l_k.shape[-1]), \
            l_p.reshape(B, -1, l_p.shape[-1]), same
    t0 = time.perf_counter()
    errs, scale, finite, kept, rows = [], 0.0, True, 0, 0
    with torch.no_grad():
        caches = (cache(), cache())
        if plain_prefill:
            with plain_kernels():
                l_p = model.forward(cfg, params, ids, pos, caches[1],
                                    logits_mode="all")[0]
            for f in ("k", "v", "k_scale", "v_scale"):
                if getattr(caches[1], f) is not None:
                    getattr(caches[0], f).copy_(getattr(caches[1], f))
            l_k, same = l_p, torch.ones((B, T), dtype=torch.bool, device=DEV)
        else:
            l_k, l_p, same = both(ids, pos, caches, "all")
        nxt = torch.full((B, 1), T, dtype=torch.int32, device=DEV)
        for step in range(PARITY_STEPS + 1):
            finite &= bool(torch.isfinite(l_k).all()) and bool(
                torch.isfinite(l_p).all())
            kept += int(same.sum())
            rows += same.numel()
            errs.append(max_err(l_k[same], l_p[same]) if same.any()
                        else 0.0)
            scale = max(scale, l_p[same].abs().max().item()
                        if same.any() else 0.0)
            if step == PARITY_STEPS:
                break
            tok = l_p[:, -1].argmax(-1).to(torch.int32)[:, None]
            l_k, l_p, same = both(tok, nxt, caches, "last")
            nxt = nxt + 1
    del caches
    tol = 4 * 2.0 ** -8 * scale
    say(f"  {name} (2 layers, {kind} cache): logits max err (prefill"
        f"{' on the plain route, both sides' if plain_prefill else ''}, "
        f"{PARITY_STEPS} decode steps) {['%.4f' % e for e in errs]} (tol "
        f"{tol:.4f}, max |logit| {scale:.3f}) over {kept} of {rows} rows "
        f"(the others' routers picked other experts on the two sides); "
        f"plain side on the card, in {time.perf_counter() - t0:.1f} s")
    check(finite, f"{name} parity: non-finite logits")
    check(kept * 2 >= rows, f"{name} parity: routing differs in "
          f"{rows - kept} of {rows} rows")
    check(max(errs) <= tol, f"{name} parity: {max(errs)} > {tol}")


def ds_params(cfg, seed):
    """DeepSeek-V3 weights drawn on the card as int8 per-channel codes
    (mixtral.code_drawer: random bytes, every scale 0.02/127), in
    deepseek.quantize_params' layout (each stack's projections [Lx, ...],
    the experts [Lm·E, ...]); the norms at one, w_uk / w_uv, the routers,
    embed and lm_head dense bf16 N(0, 0.02), a zero correction bias. The
    JAX package has no quantized init for this family, and a dense bf16
    draw of one MoE layer is 22.5 GB."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    qrnd = mixtral.code_drawer(QCFG8_MOE, g, DEV)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=DEV) * 0.02).to(BF16)
    params = {}
    for sk, (Lx, moe) in zip(deepseek._STACKS, deepseek._stack_sizes(cfg)):
        d = {k: torch.ones(sh, dtype=BF16, device=DEV)
             for k, sh in deepseek._norm_shapes(cfg, Lx).items()}
        for k, sh in deepseek._attn_shapes(cfg, Lx).items():
            d[k] = rnd(*sh) if k in ("w_uk", "w_uv") else qrnd(*sh)
        for k, sh in deepseek._ffn_shapes(cfg, Lx, moe).items():
            d[k] = qrnd(Lx * sh[1], *sh[2:]) if k.startswith("e_") \
                else qrnd(*sh)
        if moe:
            d["router"] = rnd(Lx, cfg.hidden_size, cfg.num_experts)
            d["router_bias"] = torch.zeros((Lx, cfg.num_experts), device=DEV)
        params[sk] = d
    H, V = cfg.hidden_size, cfg.vocab_size
    params.update(embed=rnd(V, H), lm_head=rnd(H, V),
                  final_norm=torch.ones((H,), dtype=BF16, device=DEV))
    torch.cuda.synchronize()
    return params


def moe_generate(eng, prompt, tally, what, smi):
    """generate(prompt) + MOE_NEW greedy tokens: launches against
    moe_expected, every logit finite; prints TTFT, tok/s, launches a
    decode step and the decode step's wall."""
    gen = GenerationConfig(max_new_tokens=MOE_NEW, greedy=True,
                           eos_token_ids=())
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    fwd = eng._forward

    def checked(*a, **k):
        logits, cache = fwd(*a, **k)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache
    eng._forward = checked
    torch.cuda.synchronize()
    before = counts()
    t0 = time.perf_counter()
    res = eng.generate([prompt], gen)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng._forward = fwd
    got = {c: n - before[c] for c, n in counts().items()}
    want = moe_expected(eng, [len(prompt)], MOE_NEW - 1)
    check(got == want, f"{what}: launches {got} != expected {want}")
    check(bool(finite.item()), f"{what}: non-finite logits")
    check(len(res.token_ids) == MOE_NEW, f"{what}: length")
    for c, n in got.items():
        tally[c] = tally.get(c, 0) + n
    step = moe_expected(eng, [1], 1)
    one = {c: step[c] - n for c, n in moe_expected(eng, [1], 0).items()}
    say(f"  {what}: {len(prompt)} + {MOE_NEW} tokens, TTFT "
        f"{res.ttft_s * 1e3:.2f} ms, decode {res.decode_tokens_per_s:.2f} "
        f"tok/s ({1e3 / res.decode_tokens_per_s:.2f} ms a step), wall "
        f"{wall:.2f} s; launches a decode step "
        f"{ {c: n for c, n in one.items() if n} }; tokens "
        f"{res.token_ids[:6]}... ({smi})")
    return res


def moe_schedulers(eng, prompts, tally, what, smi):
    """The dense scheduler (the reference) and the paged one serving
    `prompts`, greedy, the paged streams held to the dense ones
    (compare_ref)."""
    gen = GenerationConfig(max_new_tokens=MOE_NEW, greedy=True,
                           eos_token_ids=())
    before = counts()
    ref, wall_ref = run_sched(scheduler.ContinuousBatchingScheduler(
        eng, gen), prompts, MOE_NEW, top_logprobs=2)
    paged_sched = scheduler.PagedScheduler(eng, gen)
    paged, wall = run_sched(paged_sched, prompts, MOE_NEW, top_logprobs=2)
    torch.cuda.synchronize()
    got = {c: n - before[c] for c, n in counts().items()}
    for c, n in got.items():
        tally[c] = tally.get(c, 0) + n
    compared, diff = 0, 0.0
    for p, r in zip(paged, ref):
        c, d = compare_ref(p.output_ids, r, f"{what} paged request "
                           f"{r.req_id}", p.output_logprobs)
        compared, diff = compared + c, max(diff, d)
    check(compared >= len(prompts) * MOE_NEW // 2,
          f"{what}: {compared} tokens compared")
    n_tok = len(prompts) * MOE_NEW
    say(f"  {what} schedulers, {len(prompts)} requests {list(MOE_SERVED)} "
        f"+ {MOE_NEW}: dense {n_tok / wall_ref:.1f} tok/s in "
        f"{wall_ref:.2f} s, paged {n_tok / wall:.1f} tok/s in {wall:.2f} s "
        f"(pool of {paged_sched.cache.k_pages.shape[1]} pages, k / v page "
        f"rows {paged_sched.cache.k_pages.shape[-1]} / "
        f"{paged_sched.cache.v_pages.shape[-1]}); {compared} of {n_tok} "
        f"tokens compared, equal, logprobs within {diff:.4f}; launches "
        f"{ {c: n for c, n in got.items() if n} } ({smi})")
    return got


def moe_prompts(cfg, seed, lens):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
            for n in lens]


def moe_mixtral(gen, tally, smi):
    """Full-depth Mixtral-8x7B, int4 g=128 weights drawn as codes, int8
    cache: K1 on the last layer's expert 7 (stack index 31·8 + 7), then
    generate 128 + 32 and 3000 + 32 (2048- and 1024-row chunks: K8, K9),
    then the dense and paged schedulers. Returns phase 2's numbers."""
    cfg = moe_preset("mixtral-8x7b")
    t0 = time.perf_counter()
    params = mixtral.init_params_quantized(cfg, QCFG4_MOE, seed=SEED,
                                           device=DEV)
    torch.cuda.synchronize()
    lay = params["layers"]
    nbytes = sum(qbytes(lay[k]) * lay[k].q.shape[0] for k in
                 ("wq", "wk", "wv", "wo", "e_gate", "e_up", "e_down"))
    head_b = sum(t.numel() * t.element_size() for t in
                 (params["lm_head"], lay["router"]))
    say(f"  Mixtral-8x7B ({cfg.num_layers} layers, int4 g=128 codes, "
        f"int8 cache): {nbytes / 1e9:.2f} GB of codes and scales, lm_head "
        f"and routers {head_b / 1e9:.2f} GB dense, embed "
        f"{params['embed'].numel() * 2 / 1e9:.2f} GB, drawn in "
        f"{time.perf_counter() - t0:.1f} s; a B = 1 decode step's bound "
        f"{(nbytes + head_b) / HBM_BYTES_PER_S * 1e3:.2f} ms (every layer "
        f"weight, the routers and the lm_head read once)")
    E = cfg.num_experts
    idx = (cfg.num_layers - 1) * E + E - 1
    r = {}
    for key in ("e_gate", "e_down"):
        for M in (1, 8, 128):
            r[("mixtral " + key, M)] = stack_k1_case(
                f"mixtral {key}[{idx}]", lay[key], M, idx, gen)
    eng = InferenceEngine(cfg, params, engine_cfg=EngineConfig(
        max_seq_len=MIXTRAL_SEQ, max_batch_size=4, page_size=PAGE),
        cache_dtype="int8", device=DEV)
    check(eng._model is mixtral, "mixtral: the registry gave another module")
    p128, p3000 = moe_prompts(cfg, SEED + 32, (128, 3000))
    eng.generate([p128[:16]], GenerationConfig(max_new_tokens=2,
                                                greedy=True))   # warm-up
    for p in (p128, p3000):
        moe_generate(eng, p, tally, "mixtral-8x7b generate", smi)
    got = moe_schedulers(eng, moe_prompts(cfg, SEED + 33, MOE_SERVED), tally,
                         "mixtral-8x7b", smi)
    check(got["K10a"] > 0 and got["K2"] > 0,
          f"mixtral schedulers: K10a / K2 never ran: {got}")
    del eng, params, lay
    torch.cuda.empty_cache()
    return r


def moe_deepseek(gen, tally, smi):
    """DeepSeek-V3 at full width over 5 layers (the 3 dense and 2 MoE
    layers), int8 weights drawn as codes: K1 on wkv_a (N = 576), wq_b and
    an expert of the last MoE layer's block (stack index 1·256 + 255) at
    M = 1 / 8 / 128, K8 on the expert and wq_b at 2048 rows; generate 128
    + 32 over the bf16 and the int8 latent cache, 2500 + 32 over the int8
    one (a 2048- and a 512-row chunk, written at T > 1); the dense and
    paged schedulers over the latent cache and pool. Returns phase 2's
    numbers."""
    cfg = moe_preset("deepseek-v3", num_layers=5)
    t0 = time.perf_counter()
    params = ds_params(cfg, SEED)
    q_bytes = d_bytes = 0
    for sk in deepseek._STACKS:
        for t in params[sk].values():
            if isinstance(t, QTensor):
                q_bytes += t.q.numel() + t.scale.numel() * 4
            else:
                d_bytes += t.numel() * t.element_size()
    head = params["lm_head"].numel() * 2
    say(f"  DeepSeek-V3 ({cfg.num_layers} layers: {cfg.first_k_dense} dense,"
        f" {cfg.num_layers - cfg.first_k_dense} MoE; int8 codes): "
        f"{q_bytes / 1e9:.2f} GB of codes and scales, {d_bytes / 1e9:.2f} GB "
        f"dense in the layers, embed + lm_head {2 * head / 1e9:.2f} GB, "
        f"drawn in {time.perf_counter() - t0:.1f} s; a B = 1 decode step's "
        f"bound {(q_bytes + d_bytes + head) / HBM_BYTES_PER_S * 1e3:.2f} ms "
        f"(every layer weight and the lm_head read once)")
    moe = params["moe_layers"]
    E = cfg.num_experts
    idx = E + E - 1
    r = {}
    for key, qt, i in (("wkv_a", moe["wkv_a"], 1), ("wq_b", moe["wq_b"], 1),
                       ("e_gate", moe["e_gate"], idx),
                       ("e_down", moe["e_down"], idx)):
        for M in (1, 8, 128):
            r[("deepseek " + key, M)] = stack_k1_case(
                f"deepseek-v3 {key}[{i}]", qt, M, i, gen)
    for key, qt, i in (("e_gate", moe["e_gate"], idx),
                       ("wq_b", moe["wq_b"], 1)):
        r[("deepseek " + key, CHUNK)] = stack_k1_case(
            f"deepseek-v3 {key}[{i}]", qt, CHUNK, i, gen)
    torch.cuda.empty_cache()
    p128, plong = moe_prompts(cfg, SEED + 34, (128, DS_LONG))
    for kind in (BF16, "int8"):
        eng = InferenceEngine(cfg, params, engine_cfg=EngineConfig(
            max_seq_len=DS_SEQ, max_batch_size=4, page_size=PAGE),
            cache_dtype=kind, device=DEV)
        check(eng._model is deepseek, "deepseek: another module")
        c = eng.new_cache(1)
        check(c.k.shape[-1] == deepseek.latent_dim(cfg)
              and c.v.shape[-1] == cfg.kv_lora_rank,
              "deepseek: the engine's cache is not the latent cache")
        del c
        eng.generate([p128[:16]], GenerationConfig(max_new_tokens=2,
                                                    greedy=True))
        name = f"deepseek-v3 generate ({'bf16' if kind == BF16 else kind} " \
               f"latent cache)"
        moe_generate(eng, p128, tally, name, smi)
        if kind == "int8":
            moe_generate(eng, plong, tally, name, smi)
            got = moe_schedulers(eng, moe_prompts(cfg, SEED + 35, MOE_SERVED),
                                 tally, "deepseek-v3 (int8 latent)", smi)
            check(got["K4"] > 0, f"deepseek schedulers: K4 never ran: {got}")
        del eng
        torch.cuda.empty_cache()
    del params, moe
    torch.cuda.empty_cache()
    return r


def moe_entries(t, lat, k1r):
    """Path (x)'s kernel entries: the latent-width writes, K1 and K8 at
    the two families' shapes."""
    out = []
    for key, label, rep, c in (
            ("K3", "K3 write_token (DeepSeek-V3 latent rows, bf16, k 576 / "
             "v 512, Hkv 1)", "kv_write.py:72", "K3"),
            ("K4", "K4 quantize_write_token (DeepSeek-V3 latent rows, int8, "
             "k 576 / v 512, Hkv 1)", "kv_write.py:152", "K4"),
            ("K3 int4", "K3 write_token (DeepSeek-V3 int4 latent cache, "
             "packed 288 / 256 B)", "kv_write.py:72", "K3"),
            ("scale write", "kv_scale_write (DeepSeek-V3 int4 latent cache, "
             "Hkv 1)", "kv_write.py:343", "KS")):
        out.append(fam_entry(label, "kv_write.cu", rep, t[c], lat[key], 1,
                             "one layer's call at B=1"))
    for (name, M), r in k1r.items():
        if M == 8:
            continue
        bits = 4 if name.startswith("mixtral") else 8
        if M == CHUNK:
            out.append(fam_entry(
                f"K8 quant_matmul tiled prefill GEMM ({name}, int{bits})",
                "quant_matmul_tiled.cu", "quant_matmul.py:379", t["K8"], r,
                1, f"one call, M={M}"))
            continue
        src = ("quant_matmul_tiled.cu" if M > 8 else "quant_matmul.cu"
               if bits == 8 else "qmm4_gemv.cu")
        out.append(fam_entry(
            f"K1 quant_matmul {'GEMV' if M == 1 else 'MMA branch'} ({name}, "
            f"int{bits})", src, "quant_matmul.py:496", t["K1"], r, 1,
            f"one call, M={M}"))
    return out


def path_moe(gen):
    """Path (x): the mixture-of-experts families, Mixtral-8x7B
    (models/mixtral.py) and DeepSeek-V3 (models/deepseek.py: MLA over the
    latent cache, the sigmoid-routed MoE)."""
    t0 = time.perf_counter()
    smi = card_line()
    say(f"path (x): the MoE families (models/mixtral.py, "
        f"models/deepseek.py); card: {smi}")
    say("phase 2: K3 / K4 and the scale write at the latent rows vs their "
        "plain versions on the card")
    lat = latent_write_cases(gen)
    say("phase 3: 2 layers at full width, the kernels vs their plain "
        "versions on the card")
    tally = {}
    zero_counts()
    mix2 = moe_preset("mixtral-8x7b", num_layers=2)
    ds2 = moe_preset("deepseek-v3", num_layers=2, first_k_dense=1)
    for qcfg, kind in ((QCFG8_MOE, "bf16"), (QCFG4_MOE, "int8")):
        p = mixtral.init_params_quantized(mix2, qcfg, seed=SEED + 30,
                                          device=DEV)
        moe_parity(f"mixtral-8x7b {qcfg.weights}"
                   f"{' g=128' if qcfg.group_size else ''}", mix2, p, kind)
        del p
    p = ds_params(ds2, SEED + 30)
    for kind in ("bf16", "int8", "int4"):
        moe_parity("deepseek-v3 int8", ds2, p, kind,
                   plain_prefill=kind == "int4")
    del p
    torch.cuda.empty_cache()
    for c, n in counts().items():
        tally[c] = tally.get(c, 0) + n
    say(f"phase 4: serving ({smi})")
    zero_counts()
    k1r = moe_mixtral(gen, tally, smi)
    zero_counts()
    k1r.update(moe_deepseek(gen, tally, smi))
    check(all(tally.get(c, 0) > 0 for c in MOE_USED),
          f"path (x): a kernel never ran: {tally}")
    say(f"  launches (phases 3-4): { {c: n for c, n in tally.items() if n} }")
    say(f"path (x) took {time.perf_counter() - t0:.1f} s ({smi})")
    return moe_entries(tally, lat, k1r)


# --------------------------------------------------------------- path (xi)

LORA_RANK = 16
# A and B scaled so that each delta is a few percent of its projection's
# output on these random weights: the adapters' streams leave the base
# stream within LORA_NEW tokens and every logit stays finite
LORA_SCALE = 0.25
LORA_NEW = 32                         # greedy tokens of every request
LORA_PROMPT = 128
LORA_LONG = 3000                      # two prefill chunks: K8 and K9
LORA_PAGES = 3                        # full pages of the prefix-cache prompt
LORA_SLOTS = (0, 1, 2, 1)             # the dense scheduler's requests
LORA_GEN = GenerationConfig(max_new_tokens=LORA_NEW, **GREEDY)
LORA_USED = ("K1", "K2", "K8", "K9", "K10a", "K11", "KR")
LORA_OFF = ("K6", "K7", "K12")        # the fused routes, off under LoRA


def first_layers(params, n):
    """The first n layers of stacked params and of their LoRA stacks
    (views), with the same embedding, final norm and lm_head."""
    def cut(v):
        if isinstance(v, QTensor):
            return dataclasses.replace(v, q=v.q[:n], scale=v.scale[:n])
        return v[:n]
    out = dict(params, layers={k: cut(v)
                               for k, v in params["layers"].items()})
    if "lora" in params:
        out["lora"] = {t: {k: v[:n] for k, v in st.items()}
                       for t, st in params["lora"].items()}
    return out


def lora_parity(params):
    """Phase 3: the first two layers of LoRA-stacked int8 LLaMA-2-7B, B = 3
    with rows on slots 0, 1 and 2, CPU plain vs card kernels: a 32-row
    prefill (96 rows through K1's MMA branch) and PARITY_STEPS
    teacher-forced decode steps over 512 slots, under phase_parity's
    tolerance."""
    say("phase 3: 2 layers of LLaMA-2-7B int8 with LoRA stacks, rows on "
        "slots 0/1/2, CPU plain vs GPU kernels")
    cfg = dataclasses.replace(CFG, num_layers=2)
    cpu = torch.device("cpu")
    p_gpu = first_layers(params, 2)
    p_cpu = llama.params_to(p_gpu, cpu)
    B, T = 3, 32
    gen = torch.Generator().manual_seed(SEED + 40)
    ids = torch.randint(1, cfg.vocab_size, (B, T), generator=gen,
                        dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    aidx = torch.tensor([0, 1, 2])

    def new_cache(dev):
        return kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads,
                                  MAX_SEQ, cfg.head_dim, BF16, device=dev)
    errs, finite = [], []
    before = counts()
    with torch.no_grad():
        c_cpu, c_gpu = new_cache(cpu), new_cache(DEV)
        l_cpu = llama.forward(cfg, p_cpu, ids, pos, c_cpu,
                              adapter_idx=aidx)[0]
        l_gpu = llama.forward(cfg, p_gpu, ids.to(DEV), pos.to(DEV), c_gpu,
                              adapter_idx=aidx.to(DEV))[0]
        scale = 0.0
        nxt = torch.full((B, 1), T, dtype=torch.int32)
        for step in range(PARITY_STEPS + 1):
            finite.append(bool(torch.isfinite(l_cpu).all())
                          and bool(torch.isfinite(l_gpu).all()))
            errs.append((l_gpu.cpu() - l_cpu).abs().max().item())
            scale = max(scale, l_cpu.abs().max().item())
            if step == PARITY_STEPS:
                break
            tok = l_cpu.argmax(-1).to(torch.int32)[:, None]
            l_cpu = llama.forward(cfg, p_cpu, tok, nxt, c_cpu,
                                  adapter_idx=aidx)[0]
            l_gpu = llama.forward(cfg, p_gpu, tok.to(DEV), nxt.to(DEV),
                                  c_gpu, adapter_idx=aidx.to(DEV))[0]
            nxt = nxt + 1
    d = {c: n - before[c] for c, n in counts().items()}
    tol = 4 * 2.0 ** -8 * scale
    say(f"  logits max err per step (prefill, {PARITY_STEPS} decode steps) "
        f"{['%.4f' % e for e in errs]} (tol {tol:.4f}, max |logit| "
        f"{scale:.3f}); card launches { {c: n for c, n in d.items() if n} }")
    check(all(finite), "LoRA parity: non-finite logits")
    check(max(errs) <= tol, f"LoRA parity: {max(errs)} > {tol}")
    check(all(d[c] == 0 for c in LORA_OFF) and d["K1"] > 0 and d["KR"] > 0
          and d["K2"] > 0, f"LoRA parity: launches {d}")


def lora_stream(eng, prompt, adapter, req_id):
    """generate's B = 1 greedy stream on `adapter` as a scheduler Request
    (tokens, their logprobs and the top-2 logprobs of every step, from the
    logits each token was picked from), its decode tok/s and its largest
    |logit|."""
    with recorded_picks() as picks:
        res = eng.generate([prompt], LORA_GEN, adapter=adapter)[0]
    req = scheduler.Request(req_id=req_id, prompt_ids=prompt,
                            max_new_tokens=LORA_NEW)
    for tok, logits in picks:
        check(bool(torch.isfinite(logits).all()),
              f"LoRA generate on {adapter}: non-finite logits")
        lp = torch.log_softmax(logits, -1)
        top = lp.topk(2)
        req.output_ids.append(int(tok))
        req.output_logprobs.append(lp[int(tok)].item())
        req.output_top_logprobs.append(list(zip(top.indices.tolist(),
                                                top.values.tolist())))
    check(req.output_ids == res.token_ids and len(res.token_ids) == LORA_NEW,
          f"LoRA generate on {adapter}: stream")
    return req, res.decode_tokens_per_s, max(
        logits.abs().max().item() for _, logits in picks)


def lora_run(sched, prompts, adapters):
    """Submit one request a prompt on its adapter (greedy, top-2
    logprobs) and step to the end: (requests, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [sched.submit(p, LORA_NEW, top_logprobs=2, adapter=a)
            for p, a in zip(prompts, adapters)]
    while sched.step():
        pass
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def lora_schedulers(eng, prompt, ref, tie):
    """The dense scheduler with requests on LORA_SLOTS, admitted one at a
    time (a 128-row prefill each, as generate's), each held to its
    adapter's generate stream; then the paged scheduler with the prefix
    cache: one 3-page prompt under adapters 1, 2 and 2 again (no hit, then
    every full page; the repeat's stream held to the second's). Streams
    may part at a top-2 gap below `tie`."""
    sched = scheduler.ContinuousBatchingScheduler(eng, LORA_GEN, slots=4)
    sched.wave_admission = False
    reqs, wall = lora_run(sched, [prompt] * 4, LORA_SLOTS)
    same = [compare_streams([r], [ref[a]], tol=tie, new=LORA_NEW)[0]
            for r, a in zip(reqs, LORA_SLOTS)]
    check(not sched.aidx_host.any(), "retired slots keep an adapter")
    tokens = sum(len(r.output_ids) for r in reqs)
    say(f"  dense scheduler, 4 slots on adapters {list(LORA_SLOTS)}: "
        f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s; "
        f"tokens equal to generate's on each adapter {same} of {LORA_NEW}")
    del sched
    g = torch.Generator().manual_seed(SEED + 41)
    long_prompt = torch.randint(1, CFG.vocab_size, (LORA_PAGES * PAGE + 16,),
                                generator=g).tolist()
    sched = scheduler.PagedScheduler(eng, LORA_GEN, slots=2, num_pages=16,
                                     prefix_cache=True)
    hits, out = [], []
    for a in (1, 2, 2):
        before = sched.store.hit_tokens
        out += lora_run(sched, [long_prompt], (a,))[0]
        hits.append(sched.store.hit_tokens - before)
    check(hits == [0, 0, LORA_PAGES * PAGE],
          f"prefix cache across adapters: hit tokens {hits}")
    check(out[0].output_ids != out[1].output_ids,
          "adapters 1 and 2 gave one stream on the paged scheduler")
    c, t, _ = compare_streams([out[2]], [out[1]], tol=tie, new=LORA_NEW)
    say(f"  paged scheduler + prefix cache, a {len(long_prompt)}-token "
        f"prompt on adapters 1, 2, 2: hit tokens {hits}; the repeat's "
        f"stream equals the second's ({c}/{t} tokens compared)")
    del sched


def path_lora(params8):
    """Path (xi): multi-LoRA serving on the int8 weights of path (i), two
    random rank-16 adapters on all seven targets beside the zero slot."""
    t0 = time.perf_counter()
    smi = card_line()
    say(f"path (xi): multi-LoRA on LLaMA-2-7B int8 (path (i)'s weights), "
        f"bf16 cache; card: {smi}")
    g = torch.Generator(device=DEV).manual_seed(SEED + 42)
    stacks = lora.init_lora_stacks(CFG, LORA_RANK, 2, g,
                                   targets=tuple(lora._DIMS),
                                   scale=LORA_SCALE)
    nbytes = sum(v.numel() * 4 for st in stacks.values()
                 for v in st.values())
    say(f"  stacks: rank {LORA_RANK}, 3 slots, {len(stacks)} targets, "
        f"{nbytes / 1e9:.3f} GB float32")
    lparams = dict(params8, lora=stacks)
    lora_parity(lparams)
    say("phase 4: generate, the dense and the paged scheduler on full-depth "
        "LLaMA-2-7B int8 with the stacks")
    ecfg = EngineConfig(max_seq_len=LONG_SEQ, decode_chunk=8, page_size=PAGE)
    base = InferenceEngine(CFG, params8, engine_cfg=ecfg, cache_dtype=BF16,
                           device=DEV)
    eng = InferenceEngine(CFG, lparams, engine_cfg=ecfg, cache_dtype=BF16,
                          device=DEV, adapter_names=["a1", "a2"])
    g = torch.Generator().manual_seed(SEED + 43)
    prompt = torch.randint(1, CFG.vocab_size, (LORA_PROMPT,),
                           generator=g).tolist()
    long_prompt = torch.randint(1, CFG.vocab_size, (LORA_LONG,),
                                generator=g).tolist()
    base.generate([prompt[:8]], GenerationConfig(max_new_tokens=2, **GREEDY))
    ref_base, base_tps, top = lora_stream(base, prompt, None, -1)
    torch.cuda.synchronize()
    zero_counts()
    ref, tps = {}, {}
    for slot in (0, 1, 2):
        ref[slot], tps[slot], t_ = lora_stream(eng, prompt, slot, slot)
        top = max(top, t_)
    # two routes over bf16 activations (B = 1 against B = 4, the fused
    # layer against the unfused one) give logits that differ by phase 3's
    # tolerance, 4 bf16 steps of 2^-8 of the largest logit, and may break
    # a tie within that distance either way (compare_streams' default
    # 2e-2 is two such steps of a logit of 2.5)
    tie = max(2e-2, 4 * 2.0 ** -8 * top)
    c, t, diff = compare_streams([ref[0]], [ref_base], tol=tie,
                                 new=LORA_NEW)
    check(ref[1].output_ids != ref_base.output_ids
          and ref[2].output_ids != ref_base.output_ids,
          "an adapter's stream equals the base stream")
    parted = [next((j for j, (x, y) in enumerate(zip(
        ref[s].output_ids, ref_base.output_ids)) if x != y), None)
        for s in (1, 2)]
    say(f"  generate {LORA_PROMPT} + {LORA_NEW}: slot 0 vs the base engine "
        f"{c}/{t} tokens compared (logprob diff {diff:.4f}, near-tie gap "
        f"{tie:.4f}, max |logit| {top:.3f}); slots 1 and 2 leave the base "
        f"stream at tokens {parted}")
    long = eng.generate([long_prompt], dataclasses.replace(
        LORA_GEN, max_new_tokens=8), adapter="a1")[0]
    check(len(long.token_ids) == 8, "LoRA long prompt: stream length")
    say(f"  generate {LORA_LONG} + 8 on a1: TTFT {long.ttft_s * 1e3:.1f} ms")
    lora_schedulers(eng, prompt, ref, tie)
    torch.cuda.synchronize()
    got = counts()
    got["K1 MMA"] = k1.mma_launches
    say(f"  launches (phase 4): { {c: n for c, n in got.items() if n} }")
    check(all(got[c] > 0 for c in LORA_USED) and got["K1 MMA"] > 0,
          f"path (xi): a kernel of the adapter route never ran: {got}")
    check(all(got[c] == 0 for c in LORA_OFF),
          f"path (xi): a fused route ran under LoRA: {got}")
    say(f"  B = 1 decode ({smi}): LoRA engine on a1 {tps[1]:.1f} tok/s, "
        f"on slot 0 {tps[0]:.1f} tok/s; base engine {base_tps:.1f} tok/s")
    # where a step's time goes: the fused base step, the unfused layer with
    # no delta (stacks present but empty), the adapter step
    cache = eng.new_cache(1)
    tok = torch.tensor([[prompt[0]]], dtype=torch.int32, device=DEV)
    pos = torch.full((1, 1), LORA_PROMPT, dtype=torch.int32, device=DEV)
    last = torch.zeros((1,), dtype=torch.long, device=DEV)
    one = torch.ones((1,), dtype=torch.long, device=DEV)
    nodelta = dict(params8, lora={})

    def step(p, **kw):
        return lambda: llama.forward(CFG, p, tok, pos, cache, last_idx=last,
                                     rope_tables=eng._rope, **kw)
    say("  where a B = 1 decode step's time goes:")
    prof = dict(fused=step_profile("base, fused route", step(params8)),
                plain=step_profile("unfused layer, no delta",
                                   step(nodelta)),
                lora=step_profile("LoRA on a1", step(lparams,
                                                     adapter_idx=one)))
    delta = prof["lora"]["busy_ms"] - prof["plain"]["busy_ms"]
    say(f"  the deltas' share of the LoRA step's device time: "
        f"{delta / prof['lora']['busy_ms']:.3f} ({delta:.3f} of "
        f"{prof['lora']['busy_ms']:.3f} ms)")
    del cache, eng, base, stacks, lparams
    torch.cuda.empty_cache()
    say(f"path (xi) took {time.perf_counter() - t0:.1f} s ({smi})")


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
    torch.cuda.empty_cache()
    path_lora(params8)
    say(f"path (xi) done at {time.perf_counter() - t_start:.1f} s")
    del params8
    torch.cuda.empty_cache()
    kernels += path_tp(gen, shared["params"])
    say(f"path (vi) done at {time.perf_counter() - t_start:.1f} s")
    path_server(shared["params"])
    say(f"path (vii) done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    path_speculative(shared["params"])
    del shared
    torch.cuda.empty_cache()
    say(f"path (viii) done at {time.perf_counter() - t_start:.1f} s")
    kernels += path_families(gen)
    say(f"path (ix) done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    kernels += path_moe(gen)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
