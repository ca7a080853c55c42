"""LLaMA-family decoder in PyTorch (counterpart of
`llm_inference_tpu/models/llama.py`).

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
  embed [V, H]; final_norm [H]; lm_head [H, V] (absent if tied);
  layers/attn_norm, ffn_norm [L, H]; wq [L, H, Hq·D]; wk, wv [L, H, Hkv·D];
  wo [L, Hq·D, H]; w_gate, w_up [L, H, I]; w_down [L, I, H];
  after fuse_params: wqkv [L, H, (Hq+2Hkv)·D], w_gateup [L, H, 2I].
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import ModelConfig, QuantConfig
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
    params: Params = {"embed": rnd(V, H), "layers": layers,
                      "final_norm": torch.ones((H,), dtype=dtype,
                                               device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rnd(H, V)
    return params


def _stack_quantize(w: torch.Tensor, qcfg: QuantConfig) -> QTensor:
    bits = {"int8": 8, "int4": 4}[qcfg.weights]
    qts = [quantize(m, bits, qcfg.group_size, qcfg.asymmetric) for m in w]
    return QTensor(q=torch.stack([t.q for t in qts]),
                   scale=torch.stack([t.scale for t in qts]), bits=bits)


def quantize_params(params: Params, qcfg: QuantConfig,
                    row_shards: int = 1) -> Params:
    """Quantize the per-layer matmul weights (and lm_head when
    qcfg.quantize_embedding) to QTensors stacked over layers.

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
        if "lm_head" not in params:
            raise NotImplementedError("a quantized tied lm_head is not "
                                      "ported yet")
        out["lm_head"] = quantize(params["lm_head"], bits, qcfg.group_size,
                                  qcfg.asymmetric)
    return out


def init_params_quantized(cfg: ModelConfig, qcfg: QuantConfig, seed: int = 0,
                          dtype=None, device=None) -> Params:
    """Random quantized weights drawn directly as codes on the device — a
    dense copy of the model never exists. As the JAX package's dummy
    weights: random bytes, so int8 codes are uniform in [-128, 127] and
    int4 codes (two nibbles per byte) in [-8, 7], every scale 0.02/qmax
    (per column, or per group and column for grouped int4)."""
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
    an array. Fused keys (wqkv, w_gateup) pass through as they are. Call
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
                cache, tp: Optional[TPGroup] = None) -> str:
    """Which layer a forward runs, under the JAX package's gate
    (llama.py:719-731): "mega" (K12 and its row write, a whole layer in
    two launches) when LLMI_LAYER_MEGA=1 is set at call time, the step is
    a single token of a single sequence (B·T = 1) over a dense cache, not
    tensor-parallel, the four weights are fused quantized ones and
    layer_fused.supports takes the layer; else "split" (the K1/attention/
    K6 or K7 chain). The port has no LoRA, the other part of the JAX
    gate."""
    if (os.environ.get("LLMI_LAYER_MEGA", "0") == "1" and batch * rows == 1
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
                 route, cos, sin, tp=None):
    """Unfused layer (separate or dense weights): norm, projections and
    residual adds as separate ops, the wo and down products summed across
    ranks under TP (llama.py:844-860)."""
    B, T, _ = h.shape
    eps = cfg.rms_norm_eps

    def mm(name, x, bias=None):
        b = layers.get(bias)
        return matmul(x, layers[name], bias=None if b is None else b[l],
                      layer=l)

    normed = norms.rms_norm(h, layers["attn_norm"][l], eps)
    if "wqkv" in layers:
        qkv = mm("wqkv", normed, "bqkv")
        fused = _rope_in_write(cfg, cache, qkv.dtype)
        q, k, v = _fused_qkv_heads(cfg, layers, l, qkv, cos, sin, not fused)
    else:
        D = cfg.head_dim
        q = mm("wq", normed, "bq").reshape(B, T, -1, D)
        k = mm("wk", normed, "bk").reshape(B, T, -1, D)
        v = mm("wv", normed, "bv").reshape(B, T, -1, D)
        fused = _rope_in_write(cfg, cache, q.dtype)
        if not fused:
            q, k = _rope_heads(cfg, layers, l, q, k, cos, sin)
    attn2d = _attend_block(cfg, l, q, k, v, cache, positions, write_offsets,
                           mask, route, (cos, sin) if fused else None)
    h = h + _psum(mm("wo", attn2d), tp)
    normed = norms.rms_norm(h, layers["ffn_norm"][l], eps)
    if "w_gateup" in layers:
        gate, up = torch.chunk(mm("w_gateup", normed), 2, dim=-1)
    else:
        gate, up = mm("w_gate", normed), mm("w_up", normed)
    return h + _psum(mm("w_down", activations.swiglu_split(gate, up)), tp)


def rope_table(cfg: ModelConfig, cache_len: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables `forward` needs for a cache of cache_len slots."""
    return rope.make_rope_table(min(cfg.max_position_embeddings, cache_len),
                                cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling, device=device)


def forward(cfg: ModelConfig, params: Params, ids: torch.Tensor,
            positions: torch.Tensor, cache, *, logits_mode: str = "last",
            last_idx: Optional[torch.Tensor] = None,
            rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            paged_history: bool = False, tp: Optional[TPGroup] = None
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
    returns the same full logits."""
    B, T = ids.shape
    paged = isinstance(cache, paged_kvcache.PagedKVCache)
    if tp is not None and tp.size == 1:
        tp = None
    if tp is not None and paged:
        raise NotImplementedError("tensor parallelism over a paged cache "
                                  "is not ported yet")
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

    if (isinstance(layers.get("wqkv"), QTensor)
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
                             write_offsets, mask, route, cos, sin, tp)

    if logits_mode == "none":
        return None, cache
    h = norms.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if logits_mode == "hidden":
        return h, cache
    if logits_mode == "last":
        if last_idx is None:
            last_idx = torch.full((B,), T - 1, dtype=torch.long,
                                  device=h.device)
        h = h[torch.arange(B, device=h.device), last_idx.long()]
    lm_head = params.get("lm_head")
    if lm_head is None:
        logits = h.to(torch.float32) @ params["embed"].to(torch.float32).T
    else:
        logits = matmul(h, lm_head).to(torch.float32)
    if tp is not None:
        # vocab-sharded logits → the full logits on every rank
        logits = tp.all_gather_last(logits)
    if logits.shape[-1] > cfg.vocab_size:
        # the vocabulary was padded for the shards (pad_params_for_tp)
        logits = logits[..., :cfg.vocab_size]
    if cfg.final_logit_softcap > 0.0:
        logits = (torch.tanh(logits / cfg.final_logit_softcap)
                  * cfg.final_logit_softcap)
    return logits, cache
