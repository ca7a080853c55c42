"""LLaMA-family decoder in PyTorch (counterpart of
`llm_inference_tpu/models/llama.py`). The registry maps llama, llama2,
llama3 (and llama3.1), mistral, qwen2, qwen3, phi3 and tiny onto it: they
differ by config only (a sliding window, qkv biases, qk-norm, RoPE
scaling, a tied head, head_dim 96).

One `forward` serves prefill (T > 1) and decode (T == 1). Layers are
stacked along a leading axis, as in the JAX package, and walked by a
Python loop; quantized weights stay stacked and K1 picks a layer by
pointer offset. With fused quantized weights (prepare_params) the loop
runs the JAX package's pair-carry protocol (llama.py:930-953): each
layer's down-projection delta folds into the next layer's qkv prologue,
so every layer is

    wqkv (norm + residual fused) → RoPE + KV write → attention
    → layer tail

The projections are K1 up to 128 rows and K8 above. Over a dense cache
the RoPE of q and k and the KV write are one launch a layer for every T
(kvcache.rope_update_cache_layer: kv_write.rope_write, the redesigned
K3/K4, which quantizes for an int8 or int4 cache); with qk-norm, float32
activations or a paged cache the RoPE is plain PyTorch before the write
(`_rope_in_write`). Attention is K2 (K5 over an int4 cache) at decode, K9
for prefills that flash_attention.supports takes, else the plain `attend`
(`attention_route`). Over a paged cache (ops/paged_kvcache.py) the write
is plain indexing into the pool and attention is K10a/K10b at decode, K11
for a chunk over earlier pages (paged_history), the plain `attend` over
the fresh rows for a first chunk, else a dense gather of the pages and
the plain `attend`. The layer tail is K6, one launch, for grouped int4
weights at M ≤ 32 rows (llama.py:802-816), else wo then K7 (the FFN
block in one launch, where ffn_fused takes the case), else the matmul
chain

    wo → gate-up (norm + residual fused) → SwiGLU → down

With LLMI_LAYER_MEGA=1 in the environment, a single-sequence decode step
over a dense cache runs each whole layer as K12 and its row write
(`layer_route`, llama.py:719-731).

Multi-LoRA (models/lora.py, llama.py:783-786, 844-857, 907-930): with
adapter stacks in params["lora"] every row, the base rows of slot 0
included, takes the unfused layer (`_layer_plain`: no pair carry, no K6,
K7 or K12), and each target's delta is added to its projection's output:
on q, k and v after the projection and its split, before the qk-norm and
the RoPE (and so before the dense cache's RoPE-and-write launch), on wo's
output before the residual, on gate and up after the split, on down's
output before the residual.

Tensor parallelism (`forward(..., tp=group)`, llama.py:817-860, 990-996):
each rank of a parallel.TPGroup holds its shard of the weights
(parallel.sharding.shard_params of params prepared with tp_size) and a
cache of its kv heads, and runs the same forward. The embedding rows
are summed across ranks (each rank holds a vocab slice), the wo product
is summed before the residual add, the FFN block is K7 (ffn_fused) where
it takes the case, else the K1 chain, and its down product is summed;
the logits are gathered across ranks and un-padded to the vocabulary.
K6 and K12 are never called under TP.

Weight dict layout (dense tensors or QTensor):
  embed [V, H]; final_norm [H]; lm_head [H, V] (absent if tied, unless
  quantized from the table: quantize_tied_head);
  layers/attn_norm, ffn_norm [L, H]; wq [L, H, Hq·D]; wk, wv [L, H, Hkv·D];
  wo [L, Hq·D, H]; w_gate, w_up [L, H, I]; w_down [L, I, H];
  with qkv_bias bq [L, Hq·D], bk, bv [L, Hkv·D]; with qk_norm q_norm,
  k_norm [L, D];
  after fuse_params: wqkv [L, H, (Hq+2Hkv)·D], w_gateup [L, H, 2I], bqkv.
  lora (optional): {target: {"a" [L, N, d_in, r], "b" [L, N, r, d_out]}}
  float32 adapter stacks (models/lora.py), slot 0 the zero adapter.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import ModelConfig, QuantConfig
from llm_inference_tpu_torch.models import lora
from llm_inference_tpu_torch.ops import activations, attention, embedding
from llm_inference_tpu_torch.ops import kvcache, norms, paged_kvcache, rope
from llm_inference_tpu_torch.ops.kernels import decode_attention
from llm_inference_tpu_torch.ops.kernels import flash_attention
from llm_inference_tpu_torch.ops.kernels import kv_write
from llm_inference_tpu_torch.ops.kernels import layer_fused
from llm_inference_tpu_torch.ops.kernels import paged_attention
from llm_inference_tpu_torch.ops.kernels import paged_flash
from llm_inference_tpu_torch.ops.kernels import quant_matmul as qm
from llm_inference_tpu_torch.ops.linear import matmul, norm_matmul
from llm_inference_tpu_torch.ops.quantization import (QTensor, cat_columns,
                                                      from_split_half,
                                                      quantize)
from llm_inference_tpu_torch.parallel.mesh import TPGroup

Params = Dict[str, Any]

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


# ---------------------------------------------------------------------------
# Parameter init / quantization / layout
# ---------------------------------------------------------------------------

def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device=None) -> Params:
    """Random dense weights N(0, 0.02), norms at one."""
    device = resolve_device(device)
    dtype = dtype or act_dtype(cfg)
    g = _generator(seed, device)
    H, L = cfg.hidden_size, cfg.num_layers
    I, V = cfg.intermediate_size, cfg.vocab_size
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=device) * 0.02
                ).to(dtype)

    layers = {
        "attn_norm": torch.ones((L, H), dtype=dtype, device=device),
        "wq": rnd(L, H, Hq * D), "wk": rnd(L, H, Hkv * D),
        "wv": rnd(L, H, Hkv * D), "wo": rnd(L, Hq * D, H),
        "ffn_norm": torch.ones((L, H), dtype=dtype, device=device),
        "w_gate": rnd(L, H, I), "w_up": rnd(L, H, I), "w_down": rnd(L, I, H),
    }
    _bias_and_qk_norm(cfg, layers, dtype, device)
    params: Params = {"embed": rnd(V, H), "layers": layers,
                      "final_norm": torch.ones((H,), dtype=dtype,
                                               device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rnd(H, V)
    return params


def _bias_and_qk_norm(cfg: ModelConfig, layers, dtype, device) -> None:
    """Zero qkv biases (qkv_bias) and unit q/k norm weights (qk_norm)
    added to `layers`, as the JAX init_params draws them
    (llama.py:106-111)."""
    L, D = cfg.num_layers, cfg.head_dim
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                        ("bv", cfg.num_kv_heads)):
            layers[name] = torch.zeros((L, n * D), dtype=dtype,
                                       device=device)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            layers[name] = torch.ones((L, D), dtype=dtype, device=device)


def _stack_quantize(w: torch.Tensor, qcfg: QuantConfig) -> QTensor:
    bits = {"int8": 8, "int4": 4}[qcfg.weights]
    qts = [quantize(m, bits, qcfg.group_size, qcfg.asymmetric) for m in w]
    return QTensor(q=torch.stack([t.q for t in qts]),
                   scale=torch.stack([t.scale for t in qts]), bits=bits)


# vocabulary rows of the embedding table quantized at a time for a tied
# lm_head (llama.py:420): a float32 copy of the whole table would not fit
# beside the layers' transients
_TIED_HEAD_CHUNK = 32768


def quantize_tied_head(embed: torch.Tensor, qcfg: QuantConfig) -> QTensor:
    """The quantized lm_head [H, V] of a tied model, quantized from the
    embedding table [V, H] in vocabulary chunks (llama.py:404-433): scales
    are per (group, column), so the chunks are exact. The table stays for
    the input gather, and `forward` prefers "lm_head" when it is there."""
    bits = {"int8": 8, "int4": 4}[qcfg.weights]
    V = embed.shape[0]
    return cat_columns([
        quantize(embed[c:c + _TIED_HEAD_CHUNK].T.to(torch.float32), bits,
                 qcfg.group_size, qcfg.asymmetric)
        for c in range(0, V, _TIED_HEAD_CHUNK)])


def quantize_params(params: Params, qcfg: QuantConfig,
                    row_shards: int = 1) -> Params:
    """Quantize the per-layer matmul weights (and lm_head when
    qcfg.quantize_embedding; a tied model's from its table) to QTensors
    stacked over layers. Other keys (norms, biases, gemma's sandwich
    norms) pass through.

    `row_shards`: the tensor-parallel degree the weights will be served
    at. The JAX package lays the row-sharded weights' (wo, w_down) int4
    codes out in one pack block per shard (llama.py:384-399); the port's
    codes pack two K-adjacent rows per byte, so any slice at a shard
    boundary is already self-contained, and row_shards only checks that
    the boundaries fall between bytes."""
    if not qcfg.enabled:
        return params
    out = dict(params)
    layers = dict(params["layers"])
    bits = {"int8": 8, "int4": 4}[qcfg.weights]
    for name in _QUANT_KEYS:
        if name in ("wo", "w_down"):
            K = layers[name].shape[-2]
            if K % ((2 if bits == 4 else 1) * row_shards):
                raise ValueError(f"{name}: {K} input rows do not split into "
                                 f"{row_shards} shards of whole int{bits} "
                                 f"code bytes")
        layers[name] = _stack_quantize(layers[name], qcfg)
    out["layers"] = layers
    if qcfg.quantize_embedding:
        out["lm_head"] = (
            quantize(params["lm_head"], bits, qcfg.group_size,
                     qcfg.asymmetric) if "lm_head" in params
            else quantize_tied_head(params["embed"], qcfg))
    return out


def init_params_quantized(cfg: ModelConfig, qcfg: QuantConfig, seed: int = 0,
                          dtype=None, device=None) -> Params:
    """Random quantized weights drawn directly as codes on the device — a
    dense copy of the model never exists. As the JAX package's dummy
    weights: random bytes, so int8 codes are uniform in [-128, 127] and
    int4 codes (two nibbles per byte) in [-8, 7], every scale 0.02/qmax
    (per column, or per group and column for grouped int4). Zero qkv
    biases and unit q/k norms where the config has them; a tied model
    with qcfg.quantize_embedding gets its lm_head quantized from the
    random table (quantize_tied_head)."""
    if not qcfg.enabled:
        return init_params(cfg, seed, dtype, device)
    bits = {"int8": 8, "int4": 4}[qcfg.weights]
    if qcfg.asymmetric or (bits == 8 and qcfg.group_size > 0):
        raise NotImplementedError("only symmetric int8 per-channel and int4 "
                                  "weights are ported")
    device = resolve_device(device)
    dtype = dtype or act_dtype(cfg)
    g = _generator(seed, device)
    H, L = cfg.hidden_size, cfg.num_layers
    I, V = cfg.intermediate_size, cfg.vocab_size
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    scale_val = 0.02 / (2 ** (bits - 1) - 1)

    def qrnd(K, N, lead=(L,)):
        q = torch.randint(-128, 128, (*lead, N, K * bits // 8), generator=g,
                          dtype=torch.int8, device=device)
        gs = qcfg.group_size
        groups = K // gs if 0 < gs < K else 1
        sshape = (*lead, 1, N) if bits == 8 else (*lead, N, groups)
        scale = torch.full(sshape, scale_val, dtype=torch.float32,
                           device=device)
        return QTensor(q=q, scale=scale, bits=bits)

    layers = {
        "attn_norm": torch.ones((L, H), dtype=dtype, device=device),
        "wq": qrnd(H, Hq * D), "wk": qrnd(H, Hkv * D), "wv": qrnd(H, Hkv * D),
        "wo": qrnd(Hq * D, H),
        "ffn_norm": torch.ones((L, H), dtype=dtype, device=device),
        "w_gate": qrnd(H, I), "w_up": qrnd(H, I), "w_down": qrnd(I, H),
    }
    _bias_and_qk_norm(cfg, layers, dtype, device)
    embed = (torch.randn((V, H), generator=g, device=device) * 0.02).to(dtype)
    params: Params = {"embed": embed, "layers": layers,
                      "final_norm": torch.ones((H,), dtype=dtype,
                                               device=device)}
    if not cfg.tie_word_embeddings:
        if qcfg.quantize_embedding:
            params["lm_head"] = qrnd(H, V, lead=())
        else:
            params["lm_head"] = (torch.randn((H, V), generator=g,
                                             device=device) * 0.02).to(dtype)
    elif qcfg.quantize_embedding:
        params["lm_head"] = quantize_tied_head(embed, qcfg)
    return params


def _column_slice(w, s: int, n: int):
    """Output-column block s of n of a dense weight [..., N] or a QTensor
    (codes [.., N, K'], scales [.., 1, N] or [.., N, G])."""
    if isinstance(w, QTensor):
        N = w.out_features
        sdim = -2 if w.bits == 4 else -1
        return QTensor(q=w.q.narrow(-2, s * N // n, N // n),
                       scale=w.scale.narrow(sdim, s * N // n, N // n),
                       bits=w.bits)
    N = w.shape[-1]
    return w.narrow(-1, s * N // n, N // n)


def _interleave_cols(ws, tp_size: int):
    """Concat along the output columns, shard-locally (llama.py:124-137):
    column block s of the result is [w0_s | w1_s | ...], so a contiguous
    1/tp_size column slice of the fused weight is the fusion of each
    input's shard-s slice. tp_size=1 is a plain concat."""
    parts = [_column_slice(w, s, tp_size) for s in range(tp_size)
             for w in ws]
    if isinstance(ws[0], QTensor):
        return cat_columns(parts)
    return torch.cat(parts, dim=-1)


def fuse_params(params: Params, tp_size: int = 1) -> Params:
    """wq|wk|wv → wqkv and w_gate|w_up → w_gateup along the output
    columns, interleaved per tensor-parallel shard (_interleave_cols), so
    each rank's slice is [q_s | k_s | v_s] and [gate_s | up_s]."""
    layers = dict(params["layers"])

    def fuse(keys, out_key):
        ws = [layers.pop(k) for k in keys]
        for w in ws:
            n = w.out_features if isinstance(w, QTensor) else w.shape[-1]
            if n % tp_size:
                raise ValueError(f"{keys}: {n} columns do not split over "
                                 f"tp={tp_size}")
        layers[out_key] = _interleave_cols(ws, tp_size)

    if "wq" in layers:
        fuse(("wq", "wk", "wv"), "wqkv")
        if "bq" in layers:
            fuse(("bq", "bk", "bv"), "bqkv")
    if "w_gate" in layers:
        fuse(("w_gate", "w_up"), "w_gateup")
    out = dict(params)
    out["layers"] = layers
    return out


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def pad_params_for_tp(params: Params, cfg: ModelConfig,
                      tp_size: int) -> Params:
    """Zero-pad the FFN intermediate and vocab dims of DENSE params
    (before quantization) so every shard is a multiple of 128 columns
    (llama.py:304-339). Exact: padded gate/up columns give silu(0)·0 = 0
    through the padded down rows; padded vocab rows are ids no prompt
    holds, and `forward` cuts the logits back to cfg.vocab_size."""
    if tp_size <= 1:
        return params
    quantum = 128 * tp_size
    I, V = cfg.intermediate_size, cfg.vocab_size
    I_pad, V_pad = _round_up(I, quantum), _round_up(V, quantum)
    if I_pad == I and V_pad == V:
        return params

    def pad_axis(a, axis, new):
        if a.shape[axis] == new:
            return a
        shape = list(a.shape)
        shape[axis] = new - a.shape[axis]
        return torch.cat([a, a.new_zeros(shape)], dim=axis)

    layers = dict(params["layers"])
    if I_pad != I:
        for k in ("w_gate", "w_up"):
            layers[k] = pad_axis(layers[k], 2, I_pad)          # [L, H, I]
        layers["w_down"] = pad_axis(layers["w_down"], 1, I_pad)  # [L, I, H]
    out = dict(params)
    out["layers"] = layers
    if V_pad != V:
        out["embed"] = pad_axis(params["embed"], 0, V_pad)
        if "lm_head" in params:
            out["lm_head"] = pad_axis(params["lm_head"], 1, V_pad)
    return out


def prepare_params(params: Params, tp_size: int = 1) -> Params:
    """Serving layout: qkv and gate-up fused, interleaved per shard at
    tp_size (the JAX package's prepare_params without its TPU column
    blocking)."""
    return fuse_params(params, tp_size)


def params_to(params: Params, device) -> Params:
    """A copy of the parameter dict with every tensor on `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def _from_numpy(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # JAX bf16 arrives as ml_dtypes.bfloat16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> Params:
    """The weight bridge: the JAX package's parameters as nested dicts of
    numpy arrays → the port's parameters on `device`.

    A quantized weight is a dict {"q", "scale", "bits"} (the JAX QTensor
    after quantization.from_blocked): int8 codes [..., K, N] row-major
    with float32 scales [..., 1, N], or (bits 4) split-half packed int4
    codes [..., K/2, N] with float32 scales [..., G, N], in pack blocks of
    "block_rows" packed rows (absent or 0: one block; in a block, row r
    sits in the low nibble and row r + block_rows in the high one). The codes are re-laid into the
    port's transposed layouts (ops/quantization.py); every other leaf is
    an array: norms, qkv biases (bq/bk/bv, or bqkv), q_norm/k_norm,
    gemma's post_attn_norm/post_ffn_norm. Fused keys (wqkv, w_gateup)
    pass through as they are; a tied model has no lm_head, or the
    quantized one quantize_params made from its table. The trees of the
    other families pass the same way: mixtral's and DeepSeek's expert
    stacks flattened [L·E, ...], DeepSeek's dense_layers / moe_layers
    stacks (dense_layers possibly empty) with their dense w_uk, w_uv,
    router and router_bias. A "lora" subtree {target: {"a", "b"}} of
    float32 adapter stacks passes as it is. Call the family's
    prepare_params on the result before serving."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict) and "q" in node and "scale" in node:
            q = _from_numpy(node["q"], device).to(torch.int8)
            scale = _from_numpy(node["scale"], device).to(torch.float32)
            bits = int(node.get("bits", 8))
            if bits == 4:
                return from_split_half(q, scale,
                                       int(node.get("block_rows", 0)))
            if bits != 8 or scale.shape[-2:] != (1, q.shape[-1]):
                raise NotImplementedError(
                    f"bits {bits}, scales {tuple(scale.shape)} for codes "
                    f"{tuple(q.shape)}: only int8 per-channel and int4 are "
                    "ported")
            return QTensor(q=q.transpose(-1, -2).contiguous(), scale=scale)
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _from_numpy(node, device)

    params = conv(tree)
    V, H = params["embed"].shape
    if (V, H) != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(f"embed is {(V, H)}, config says "
                         f"{(cfg.vocab_size, cfg.hidden_size)}")
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def attention_route(q_shape, S: int, quantized: bool, page_size: int = 0,
                    paged_history: bool = False) -> str:
    """Which attention a layer runs, in the JAX package's order
    (llama.py:609-690). Over an S-slot dense cache (page_size 0):
    "decode" (K2, or K5 over an int4 cache) for a single step
    decode_attention.supports takes, else "flash" (K9) where
    flash_attention.supports takes the prefill, else "attend" (the plain
    path over a mask). Over a paged cache of that page size: a single step
    is "paged_decode" (K10a, or K10b over int4 pages) where
    paged_attention.supports takes it; a chunk over earlier pages
    (paged_history) is "paged_flash" (K11) where paged_flash.supports
    takes it; either falls back to "paged_gather" (the pages gathered
    densely, then the plain path); a first chunk is "paged_prefill" (the
    plain path over the fresh rows only)."""
    if page_size:
        if q_shape[1] == 1:
            return ("paged_decode"
                    if paged_attention.supports(q_shape, page_size)
                    else "paged_gather")
        if paged_history:
            return ("paged_flash" if paged_flash.supports(q_shape, page_size)
                    else "paged_gather")
        return "paged_prefill"
    if q_shape[1] == 1 and decode_attention.supports(q_shape, S):
        return "decode"
    if flash_attention.supports(q_shape, S, quantized):
        return "flash"
    return "attend"


def layer_route(cfg: ModelConfig, layers, batch: int, rows: int,
                cache, tp: Optional[TPGroup] = None, lora_stacks=None) -> str:
    """Which layer a forward runs, under the JAX package's gate
    (llama.py:719-731): "mega" (K12 and its row write, a whole layer in
    two launches) when LLMI_LAYER_MEGA=1 is set at call time, the step is
    a single token of a single sequence (B·T = 1) over a dense cache, not
    tensor-parallel, with no LoRA stacks, the four weights are fused
    quantized ones and layer_fused.supports takes the layer; else "split"
    (the K1/attention/K6 or K7 chain, or with LoRA stacks the unfused
    layer)."""
    if (os.environ.get("LLMI_LAYER_MEGA", "0") == "1" and batch * rows == 1
            and lora_stacks is None
            and (tp is None or tp.size == 1)
            and isinstance(cache, kvcache.KVCache)
            and layer_fused.supports(cfg, (batch, rows, cfg.hidden_size),
                                     layers, cache)):
        return "mega"
    return "split"


def _gather_paged(cache: paged_kvcache.PagedKVCache, layer: int):
    """Every sequence's pages, densely: K/V [B, Hkv, NB·ps, Dc] and, for a
    quantized pool, scales [B, NB·ps, Hkv] (the paged fallbacks)."""
    pt = cache.page_table
    kd = paged_attention.gather_pages(cache.k_pages, pt, layer)
    vd = paged_attention.gather_pages(cache.v_pages, pt, layer)
    if not cache.quantized:
        return kd, vd, None, None
    return (kd, vd, paged_attention.gather_scales(cache.k_scale, pt, layer),
            paged_attention.gather_scales(cache.v_scale, pt, layer))


def _paged_attention(cfg: ModelConfig, q, k, v,
                     cache: paged_kvcache.PagedKVCache, layer: int,
                     positions, write_offsets, mask, route: str):
    """The paged branch of cached_attention (llama.py:609-666): write the
    rows into the pool, then attend as `route` says. `mask` is the plain
    path's: over the T fresh rows for "paged_prefill", over the NB·ps slots
    for "paged_gather"."""
    B, T = q.shape[:2]
    ps = cache.page_size
    if T == 1:
        paged_kvcache.write_token(cache, layer, k, v, positions[:, 0])
    else:
        # a first chunk starts at position 0 (scheduler invariant); a chunk
        # over earlier pages writes at its block offset
        start = None if route == "paged_prefill" else write_offsets // ps
        paged_kvcache.write_prompt_batch(cache, layer, k, v, T // ps,
                                         start_blocks=start)
    softcap = cfg.attn_logit_softcap
    if route == "paged_decode":
        return paged_attention.paged_attention(
            q, cache.k_pages, cache.v_pages, cache.page_table, layer,
            positions[:, -1], logit_softcap=softcap,
            window=cfg.sliding_window, k_scale=cache.k_scale,
            v_scale=cache.v_scale)
    if route == "paged_flash":
        return paged_flash.paged_flash_attention(
            q, cache.k_pages, cache.v_pages, cache.page_table, layer,
            positions, logit_softcap=softcap,
            sliding_window=cfg.sliding_window, k_scale=cache.k_scale,
            v_scale=cache.v_scale)
    if route == "paged_prefill":
        return attention.attend(q, k.transpose(1, 2), v.transpose(1, 2),
                                mask, logit_softcap=softcap)
    kd, vd, ksd, vsd = _gather_paged(cache, layer)
    return attention.attend(q, kd, vd, mask, logit_softcap=softcap,
                            k_scale=ksd, v_scale=vsd)


def cached_attention(cfg: ModelConfig, q, k, v, cache, layer: int,
                     positions, write_offsets, mask,
                     route: Optional[str] = None, rope_rows=None):
    """Write this layer's K/V into the dense or paged cache, then attend
    as `route` says (by default attention_route's choice for a dense cache
    or a first paged chunk), with a quantized cache's scales; `mask` (from
    make_attention_mask) is needed on the plain routes only. q/k/v:
    [B, T, H*, D], post-RoPE; with rope_rows, the (cos, sin) rows [B, T,
    D] at the positions, q and k come unrotated and the dense cache's
    write rotates them (kvcache.rope_update_cache_layer). Returns
    [B, T, Hq, D]."""
    paged = isinstance(cache, paged_kvcache.PagedKVCache)
    if route is None:
        route = attention_route(
            q.shape, cache.max_blocks * cache.page_size if paged
            else cache.max_seq_len, cache.quantized,
            cache.page_size if paged else 0)
    if paged:
        return _paged_attention(cfg, q, k, v, cache, layer, positions,
                                write_offsets, mask, route)
    if rope_rows is not None:
        q = kvcache.rope_update_cache_layer(cache, layer, q, k, v,
                                            *rope_rows, write_offsets)
    else:
        kvcache.update_cache_layer(cache, layer, k, v, write_offsets)
    if route == "decode":
        return decode_attention.decode_attention(
            q, cache.k, cache.v, layer, positions[:, -1],
            logit_softcap=cfg.attn_logit_softcap, window=cfg.sliding_window,
            k_scale=cache.k_scale, v_scale=cache.v_scale)
    if route == "flash":
        return flash_attention.flash_attention(
            q, cache.k, cache.v, layer, positions,
            logit_softcap=cfg.attn_logit_softcap,
            sliding_window=cfg.sliding_window, k_scale=cache.k_scale,
            v_scale=cache.v_scale)
    ks, vs = cache.k_scale, cache.v_scale
    return attention.attend(q, cache.k[layer], cache.v[layer], mask,
                            logit_softcap=cfg.attn_logit_softcap,
                            k_scale=None if ks is None else ks[layer],
                            v_scale=None if vs is None else vs[layer])


def _rope_in_write(cfg: ModelConfig, cache, dtype) -> bool:
    """Whether the layer's KV write applies the RoPE too, one launch for q
    and k's rotation and the write (kvcache.rope_update_cache_layer): over
    a dense cache, without qk-norm, where kv_write.rope_supports takes the
    rows (bf16) and the cache. Else `_rope_heads` rotates q and k in plain
    PyTorch before the write."""
    return (isinstance(cache, kvcache.KVCache) and not cfg.qk_norm
            and kv_write.rope_supports(dtype, cfg.head_dim, cache.k,
                                       cache.bits))


def _rope_heads(cfg: ModelConfig, layers, l, q, k, cos, sin):
    """The optional qk-norm, then RoPE, on q/k [B, T, H*, D]; cos/sin are
    the tables gathered at the positions, [B, T, D]."""
    if cfg.qk_norm:
        q = norms.rms_norm(q, layers["q_norm"][l], cfg.rms_norm_eps)
        k = norms.rms_norm(k, layers["k_norm"][l], cfg.rms_norm_eps)
    return (rope.apply_rope_gathered(q, cos, sin),
            rope.apply_rope_gathered(k, cos, sin))


def _fused_qkv_heads(cfg: ModelConfig, layers, l, qkv, cos, sin, rotate):
    """q, k and v [B, T, H*, D] from a fused [q|k|v] projection: column
    views of it, with q and k rotated when `rotate` (else the KV write
    rotates them). q and k are adjacent columns, so without qk-norm one
    RoPE pass covers both (the same elementwise math, half the
    launches)."""
    B, T, n = qkv.shape
    D = cfg.head_dim
    nq = n * cfg.num_heads // (cfg.num_heads + 2 * cfg.num_kv_heads)
    nkv = (n - nq) // 2
    v = qkv[..., nq + nkv:].reshape(B, T, -1, D)
    if not rotate or cfg.qk_norm:
        q = qkv[..., :nq].reshape(B, T, -1, D)
        k = qkv[..., nq:nq + nkv].reshape(B, T, -1, D)
        if rotate:
            q, k = _rope_heads(cfg, layers, l, q, k, cos, sin)
        return q, k, v
    qk = rope.apply_rope_gathered(qkv[..., :nq + nkv].reshape(B, T, -1, D),
                                  cos, sin)
    return qk[:, :, :nq // D], qk[:, :, nq // D:], v


def _attend_block(cfg, l, q, k, v, cache, positions, write_offsets, mask,
                  route, rope_rows=None):
    B, T = q.shape[:2]
    attn = cached_attention(cfg, q, k, v, cache, l, positions, write_offsets,
                            mask, route, rope_rows)
    return attn.reshape(B, T, -1)


def _psum(x, tp: Optional[TPGroup]):
    """Σ over the ranks of x under tensor parallelism, else x
    (llama.py:518)."""
    return x if tp is None else tp.all_reduce_sum(x)


def _sharded_embedding_lookup(table, ids, tp: Optional[TPGroup]):
    """Vocab-sharded gather (llama.py:522-533): the rank's rows cover
    [lo, lo + V_local); ids outside contribute zero rows, and the sum over
    the ranks restores every row."""
    if tp is None:
        return embedding.embedding_lookup(table, ids)
    v_local = table.shape[0]
    local = ids.long() - tp.rank * v_local
    in_shard = (local >= 0) & (local < v_local)
    rows = embedding.embedding_lookup(table, torch.clamp(local, 0,
                                                         v_local - 1))
    rows = torch.where(in_shard[..., None], rows, torch.zeros_like(rows))
    return _psum(rows, tp)


def _layer_pair(cfg, layers, l, h, d, cache, positions, write_offsets, mask,
                route, cos, sin, mega=False, tp=None):
    """Pair-carry layer: returns (h2, delta) with the residual stream
    h2 and this layer's down-projection output, which the next layer's
    wqkv prologue adds. With `mega` the whole layer is K12 (layer_route);
    else the tail is K6 where it takes the case (never under TP), then
    K7 after the wo product (summed across ranks under TP), then the K1
    chain (llama.py:802-842)."""
    if mega:
        return layer_fused.layer_decode_fused(cfg, h, d, layers, cache, l,
                                              positions, cos, sin)
    B, T, _ = h.shape
    eps = cfg.rms_norm_eps
    bqkv = layers.get("bqkv")
    qkv, h = norm_matmul(h, layers["wqkv"], layers["attn_norm"][l], eps,
                         bias=None if bqkv is None else bqkv[l], layer=l,
                         residual=d, want_x_out=True)
    fused = _rope_in_write(cfg, cache, qkv.dtype)
    q, k, v = _fused_qkv_heads(cfg, layers, l, qkv, cos, sin, not fused)
    attn2d = _attend_block(cfg, l, q, k, v, cache, positions, write_offsets,
                           mask, route, (cos, sin) if fused else None)
    gamma = layers["ffn_norm"][l]
    if tp is None:
        tail = qm.layer_tail_fused(h, attn2d, layers["wo"],
                                   layers["w_gateup"], layers["w_down"],
                                   gamma, eps, l)
        if tail is not None:
            down_out, h2 = tail
            return h2, down_out
    attn_out = _psum(matmul(attn2d, layers["wo"], layer=l), tp)
    ffn = qm.ffn_fused(h, attn_out, gamma, eps, layers["w_gateup"],
                       layers["w_down"], l)
    if ffn is not None:
        down_out, h2 = ffn
        return h2, _psum(down_out, tp)
    gateup, h2 = norm_matmul(h, layers["w_gateup"], gamma, eps,
                             residual=attn_out, layer=l, want_x_out=True)
    gate, up = torch.chunk(gateup, 2, dim=-1)
    act = activations.swiglu_split(gate, up)
    return h2, _psum(matmul(act, layers["w_down"], layer=l), tp)


def _layer_plain(cfg, layers, l, h, cache, positions, write_offsets, mask,
                 route, cos, sin, tp=None, lora_l=None, adapter_idx=None):
    """Unfused layer (separate or dense weights, or any weights under
    LoRA): norm, projections and residual adds as separate ops, the wo and
    down products summed across ranks under TP (llama.py:844-860). With
    `lora_l` (lora.layer_view) each target's per-row delta is added to its
    projection's output (llama.py:783-786, 844-857)."""
    B, T, _ = h.shape
    eps = cfg.rms_norm_eps

    def mm(name, x, bias=None):
        b = layers.get(bias)
        return matmul(x, layers[name], bias=None if b is None else b[l],
                      layer=l)

    def ld(name, x, out):
        return lora.apply_delta(name, lora_l, x, out, adapter_idx)

    normed = norms.rms_norm(h, layers["attn_norm"][l], eps)
    if "wqkv" in layers:
        qkv = mm("wqkv", normed, "bqkv")
        if lora_l is not None:
            # the deltas go on the split, unrotated q, k and v
            n = qkv.shape[-1]
            nq = n * cfg.num_heads // (cfg.num_heads + 2 * cfg.num_kv_heads)
            nkv = (n - nq) // 2
            qkv = torch.cat([ld("wq", normed, qkv[..., :nq]),
                             ld("wk", normed, qkv[..., nq:nq + nkv]),
                             ld("wv", normed, qkv[..., nq + nkv:])], dim=-1)
        fused = _rope_in_write(cfg, cache, qkv.dtype)
        q, k, v = _fused_qkv_heads(cfg, layers, l, qkv, cos, sin, not fused)
    else:
        D = cfg.head_dim
        q = ld("wq", normed, mm("wq", normed, "bq")).reshape(B, T, -1, D)
        k = ld("wk", normed, mm("wk", normed, "bk")).reshape(B, T, -1, D)
        v = ld("wv", normed, mm("wv", normed, "bv")).reshape(B, T, -1, D)
        fused = _rope_in_write(cfg, cache, q.dtype)
        if not fused:
            q, k = _rope_heads(cfg, layers, l, q, k, cos, sin)
    attn2d = _attend_block(cfg, l, q, k, v, cache, positions, write_offsets,
                           mask, route, (cos, sin) if fused else None)
    h = h + _psum(ld("wo", attn2d, mm("wo", attn2d)), tp)
    normed = norms.rms_norm(h, layers["ffn_norm"][l], eps)
    if "w_gateup" in layers:
        gate, up = torch.chunk(mm("w_gateup", normed), 2, dim=-1)
    else:
        gate, up = mm("w_gate", normed), mm("w_up", normed)
    act = activations.swiglu_split(ld("w_gate", normed, gate),
                                   ld("w_up", normed, up))
    return h + _psum(ld("w_down", act, mm("w_down", act)), tp)


def rope_table(cfg: ModelConfig, cache_len: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables `forward` needs for a cache of cache_len slots."""
    return rope.make_rope_table(min(cfg.max_position_embeddings, cache_len),
                                cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling, device=device)


def lm_logits(h: torch.Tensor, params: Params) -> torch.Tensor:
    """float32 logits of the final hidden states h [..., H]: lm_head (a
    QTensor through K1/K8, or dense), else the tied embedding table [V, H].
    The tied product reads the table as it is stored, with no float32 copy
    of it (a 256000 x 2304 bf16 table would be a 2.36 GB copy a call):
    the products of bf16 values are exact and summed in float32 as in the
    JAX float32 dot (llama.py:979-983), and only the logit is rounded to
    the table's type before it widens, one rounding (2^-9 relative for
    bf16; none for a float32 table)."""
    lm_head = params.get("lm_head")
    if lm_head is not None:
        return matmul(h, lm_head).to(torch.float32)
    embed = params["embed"]
    return torch.nn.functional.linear(h.to(embed.dtype), embed).to(
        torch.float32)


def forward(cfg: ModelConfig, params: Params, ids: torch.Tensor,
            positions: torch.Tensor, cache, *, logits_mode: str = "last",
            last_idx: Optional[torch.Tensor] = None,
            rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            paged_history: bool = False, tp: Optional[TPGroup] = None,
            adapter_idx: Optional[torch.Tensor] = None
            ) -> Tuple[Optional[torch.Tensor], Any]:
    """Run the decoder over T tokens per sequence, writing the dense
    (kvcache.KVCache) or paged (paged_kvcache.PagedKVCache) cache in place.
    ids/positions: [B, T] int. Returns (logits, cache): logits [B, V]
    float32 for "last" (at last_idx, default T-1), [B, T, V] for "all",
    the final-norm hidden states for "hidden", None for "none".
    `rope_tables` (from rope_table) saves rebuilding them per call. Over a
    paged cache, a prefill chunk (T > 1, a multiple of the page size) is
    a first chunk from position 0, or with `paged_history` a chunk at a
    block offset over the sequence's earlier pages. With `tp` (a
    parallel.TPGroup of more than one rank) `params` are this rank's
    shard and `cache` holds its kv heads (module docstring); every rank
    returns the same full logits. With LoRA stacks in params["lora"],
    `adapter_idx` [B] is each row's adapter slot (None: slot 0, the base
    model, for every row; llama.py:907-909)."""
    B, T = ids.shape
    paged = isinstance(cache, paged_kvcache.PagedKVCache)
    if tp is not None and tp.size == 1:
        tp = None
    if tp is not None and paged:
        raise NotImplementedError("tensor parallelism over a paged cache "
                                  "is not ported yet")
    lora_stacks = params.get("lora")
    if lora_stacks is not None:
        if tp is not None:
            raise NotImplementedError("LoRA under tensor parallelism is not "
                                      "ported yet")
        adapter_idx = (torch.zeros((B,), dtype=torch.long, device=ids.device)
                       if adapter_idx is None else adapter_idx.long())
    ps = cache.page_size if paged else 0
    # slots a position may address; the RoPE tables need no more
    S = cache.max_blocks * ps if paged else cache.max_seq_len
    dtype = act_dtype(cfg)
    layers = params["layers"]
    L = layers["attn_norm"].shape[0]

    h = _sharded_embedding_lookup(params["embed"], ids, tp).to(dtype)
    route = attention_route((B, T, cfg.num_heads, cfg.head_dim), S,
                            cache.quantized, ps, paged_history)
    # the plain routes' mask: over the fresh rows for a first paged chunk
    # (llama.py:886), over every slot otherwise
    mask = None
    if route in ("attend", "paged_gather", "paged_prefill"):
        mask = attention.make_attention_mask(
            positions, T if route == "paged_prefill" else S,
            cfg.sliding_window)
    write_offsets = positions[:, 0]
    cos, sin = rope_tables or rope_table(cfg, S, ids.device)
    # a retired slot's position keeps growing: clamp the gather, as JAX's
    # does (its writes and reads clamp at the cache edge)
    idx = torch.clamp(positions.long(), 0, cos.shape[0] - 1)
    cos, sin = cos[idx], sin[idx]          # gathered once for every layer

    if (lora_stacks is None and isinstance(layers.get("wqkv"), QTensor)
            and isinstance(layers.get("w_gateup"), QTensor)):
        d = torch.zeros_like(h)
        mega = layer_route(cfg, layers, B, T, cache, tp) == "mega"
        for l in range(L):
            h, d = _layer_pair(cfg, layers, l, h, d, cache, positions,
                               write_offsets, mask, route, cos, sin, mega,
                               tp)
        h = h + d
    else:
        for l in range(L):
            h = _layer_plain(cfg, layers, l, h, cache, positions,
                             write_offsets, mask, route, cos, sin, tp,
                             lora.layer_view(lora_stacks, l), adapter_idx)

    return forward_output(cfg, params, h, logits_mode, last_idx, tp), cache


def forward_output(cfg: ModelConfig, params: Params, h: torch.Tensor,
                   logits_mode: str, last_idx: Optional[torch.Tensor],
                   tp: Optional[TPGroup] = None) -> Optional[torch.Tensor]:
    """The end of a forward over the last layer's output h [B, T, H]:
    None for "none"; the final norm, then the hidden states for "hidden",
    else the float32 logits of every row ("all") or of row last_idx[b]
    (default T - 1) of each sequence ("last"), gathered across the ranks
    under tensor parallelism, cut to the vocabulary and soft-capped where
    the config says (llama.py:962-990)."""
    if logits_mode == "none":
        return None
    B, T = h.shape[:2]
    h = norms.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if logits_mode == "hidden":
        return h
    if logits_mode == "last":
        if last_idx is None:
            last_idx = torch.full((B,), T - 1, dtype=torch.long,
                                  device=h.device)
        h = h[torch.arange(B, device=h.device), last_idx.long()]
    logits = lm_logits(h, params)
    if tp is not None:
        # vocab-sharded logits → the full logits on every rank
        logits = tp.all_gather_last(logits)
    if logits.shape[-1] > cfg.vocab_size:
        # the vocabulary was padded for the shards (pad_params_for_tp)
        logits = logits[..., :cfg.vocab_size]
    if cfg.final_logit_softcap > 0.0:
        logits = (torch.tanh(logits / cfg.final_logit_softcap)
                  * cfg.final_logit_softcap)
    return logits


# register with the registry: the families that differ from llama by
# config only (llama.py:1006-1014); "llama3.1" too, which the JAX
# package's resolution misses ("llama3.1-8b" → "llama3.1")
from llm_inference_tpu_torch.models import registry as _registry  # noqa: E402
import sys as _sys  # noqa: E402
for _name in ("llama", "llama2", "llama3", "llama3.1", "mistral", "qwen2",
              "qwen3", "phi3", "tiny"):
    _registry.register_model(_name, _sys.modules[__name__])
