"""Rank-side work of the tensor-parallel checks: functions that run on
every rank of a `parallel.run_ranks` group and return host objects.
tests/test_torch_tp.py holds the port's TP forward and generate against
the JAX package's sharded forward and the port's tp = 1 run with them on
the CPU; chip_smoke.py does the same on the card.

    run_ranks(run_jobs, tp, [(forwards, dict(cfg=..., build=..., ...)),
                             (generate, dict(...))], device="cpu")

A job's `build` is (function, args): function(device, tp_size, *args)
returns the FULL model's prepared parameters (llama.prepare_params with
tp_size) on the rank's device; the rank keeps its shard. `build_from_npz`
reads weights saved by `save_tree` (the JAX weight bridge's nested dicts
of numpy arrays, llama.params_from_numpy); `build_from_seed` draws
random quantized weights from a seed, as every rank of a served model
does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            ModelConfig, QuantConfig)
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache
from llm_inference_tpu_torch.ops.kernels import decode_attention
from llm_inference_tpu_torch.ops.kernels import flash_attention, kv_write
from llm_inference_tpu_torch.ops.kernels import layer_fused
from llm_inference_tpu_torch.ops.kernels import quant_matmul as qm
from llm_inference_tpu_torch.parallel import sharding

_BF16_SUFFIX = "@bf16"
CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": "int8", "int4": "int4"}


def save_tree(path, tree) -> None:
    """A nested dict of numpy arrays (and ints) → one .npz. bf16 arrays
    (ml_dtypes) are stored as their bits, so reading needs no ml_dtypes."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
                continue
            a = np.asarray(v)
            if a.dtype.name == "bfloat16":
                flat[f"{prefix}{k}{_BF16_SUFFIX}"] = a.view(np.uint16)
            else:
                flat[f"{prefix}{k}"] = a
    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path) -> dict:
    """Inverse of save_tree: numpy arrays, bf16 leaves as torch tensors."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            leaf = z[key]
            if key.endswith(_BF16_SUFFIX):
                key = key[:-len(_BF16_SUFFIX)]
                leaf = torch.from_numpy(leaf.copy()).view(torch.bfloat16)
            node = tree
            *parents, name = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = leaf
    return tree


def build_from_npz(device, tp_size: int, path, cfg: ModelConfig,
                   qcfg: QuantConfig = None):
    """Weights from `path`. Without qcfg they are the JAX package's
    prepared weights (fused per shard at tp_size); with qcfg they are
    dense, and the port pads, quantizes and prepares them itself."""
    params = llama.params_from_numpy(load_tree(path), cfg, device)
    if qcfg is None:
        return params
    params = llama.pad_params_for_tp(params, cfg, tp_size)
    params = llama.quantize_params(params, qcfg, row_shards=tp_size)
    return llama.prepare_params(params, tp_size=tp_size)


def build_from_seed(device, tp_size: int, cfg: ModelConfig,
                    qcfg: QuantConfig, seed: int):
    """Random quantized weights drawn on `device` from `seed`."""
    return llama.prepare_params(
        llama.init_params_quantized(cfg, qcfg, seed=seed, device=device),
        tp_size=tp_size)


def _params(group, cfg, build):
    fn, args = build
    full = fn(group.device, group.size, *args)
    sharding.validate_tp(cfg, group.size)
    return sharding.shard_params(full, group.rank, group.size)


def counters() -> dict:
    """The kernel launch counts a dense-cache forward can move."""
    return dict(K1=qm.launches, K2=decode_attention.launches,
                K3=kv_write.launches, K4=kv_write.quant_launches,
                K5=decode_attention.int4_launches, K6=qm.tail_launches,
                K7=qm.ffn_launches, K8=qm.tiled_launches,
                K9=flash_attention.launches, KS=kv_write.scale_launches,
                K12=layer_fused.launches, KR=kv_write.rope_launches)


@torch.no_grad()
def forwards(group, cfg: ModelConfig, build, cache, steps):
    """Each step (ids, positions, last_idx) of numpy arrays through
    llama.forward on this rank over one cache (a kind of CACHE_DTYPES,
    batch, slots) of its kv heads. Returns (the steps' logits as float32
    arrays, the kernel launches they made)."""
    kind, batch, slots = cache
    params = _params(group, cfg, build)
    c = kvcache.init_cache(cfg.num_layers, batch,
                           sharding.local_kv_heads(cfg, group.size), slots,
                           cfg.head_dim, CACHE_DTYPES[kind],
                           device=group.device)
    before = counters()
    out = []
    for ids, pos, last in steps:
        logits, c = llama.forward(
            cfg, params, torch.from_numpy(ids).to(group.device),
            torch.from_numpy(pos).to(group.device), c,
            last_idx=torch.from_numpy(last).to(group.device), tp=group)
        out.append(logits.float().cpu().numpy())
    return out, {k: n - before[k] for k, n in counters().items()}


@torch.no_grad()
def generate(group, cfg: ModelConfig, build, requests, gen: GenerationConfig,
             engine_cfg: EngineConfig, cache: str, warmup: int = 0):
    """InferenceEngine.generate on this rank's engine (tp=group), once for
    each request (a list of prompts). With `warmup`, a first request of
    that many tokens of the first prompt and 2 new ones runs outside the
    counts. Returns a dict for each request: the token ids of each
    prompt, TTFT s, decode tokens/s, the decode steps' wall time and the
    collectives' host time and count over them, the backend, the kernel
    launches and the logits of every pick (record_picks)."""
    eng = InferenceEngine(cfg, build[0](group.device, group.size,
                                        *build[1]),
                          engine_cfg=engine_cfg,
                          cache_dtype=CACHE_DTYPES[cache],
                          device=group.device, tp=group)
    sync = (torch.cuda.synchronize if group.device.type == "cuda"
            else (lambda *a: None))
    if warmup:
        eng.generate([requests[0][0][:warmup]], GenerationConfig(
            max_new_tokens=2, greedy=True, eos_token_ids=()))
    sync()
    # each decode step's collectives, timed between two syncs; prefill
    # forwards are told apart by their rows
    fwd = eng._forward
    stats = {}

    def timed(ids, positions, cache_, *a, **k):
        if ids.shape[1] != 1:
            return fwd(ids, positions, cache_, *a, **k)
        sync()
        c0, n0, t0 = group.collective_s, group.collectives, time.perf_counter()
        out = fwd(ids, positions, cache_, *a, **k)
        sync()
        stats["step_s"] += time.perf_counter() - t0
        stats["coll_s"] += group.collective_s - c0
        stats["colls"] += group.collectives - n0
        stats["steps"] += 1
        return out
    eng._forward = timed
    results = []
    for prompts in requests:
        stats.update(step_s=0.0, coll_s=0.0, colls=0, steps=0)
        picks = record_picks(eng)
        before = counters()
        res = eng.generate(prompts, gen)
        sync()
        launches = {k: n - before[k] for k, n in counters().items()}
        results.append(dict(
            tokens=[r.token_ids for r in res], ttft_s=res[0].ttft_s,
            tokens_per_s=res[0].decode_tokens_per_s, backend=group.backend,
            launches=launches, picks=picks, **stats))
    return results


def record_picks(eng) -> list:
    """From now on, the logits [B, V] of every token `eng` picks are
    appended (float32, on the host) to the returned list."""
    picks = []
    eng.__dict__.pop("_pick", None)      # an earlier recording stops
    pick = eng._pick

    def recorded(logits, *a, **k):
        picks.append(logits.float().cpu().numpy())
        return pick(logits, *a, **k)
    eng._pick = recorded
    return picks


def _require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def compare_picks(got, got_tokens, want, want_tokens, tol: float):
    """Two runs' greedy streams step by step: while a row's tokens agree,
    its logits must agree within `tol`; the tokens may part only where the
    reference's top-2 gap is at most twice the runs' logit difference at
    that step (the contexts are still equal there), and the row is not
    compared after. Raises AssertionError where they do not; returns
    (tokens compared, the largest difference)."""
    compared, diff = 0, 0.0
    for b in range(len(want_tokens)):
        for j, (g, w) in enumerate(zip(got, want)):
            d = float(np.abs(g[b] - w[b]).max())
            _require(d <= tol, (b, j, d, tol))
            diff = max(diff, d)
            if got_tokens[b][j] != want_tokens[b][j]:
                top = np.sort(w[b])[-2:]
                _require(top[1] - top[0] <= 2 * d, (b, j, top, d))
                break
            compared += 1
    return compared, diff


def collective_cost(group, numel: int, reps: int):
    """Host time of one all_reduce_sum of numel float32 values on the
    rank's device with no other work in flight: (wall seconds a call, the
    share TPGroup counts as collective time)."""
    sync = (torch.cuda.synchronize if group.device.type == "cuda"
            else (lambda *a: None))
    x = torch.ones(numel, device=group.device)
    for _ in range(3):
        group.all_reduce_sum(x)
    sync()
    c0, t0 = group.collective_s, time.perf_counter()
    for _ in range(reps):
        group.all_reduce_sum(x)
    sync()
    return dict(call_s=(time.perf_counter() - t0) / reps,
                collective_s=(group.collective_s - c0) / reps)


def run_jobs(group, jobs):
    """[fn(group, **kwargs) for fn, kwargs in jobs]: several checks on one
    group of ranks (a spawn and rendezvous per group, not per check)."""
    return [fn(group, **kw) for fn, kw in jobs]
