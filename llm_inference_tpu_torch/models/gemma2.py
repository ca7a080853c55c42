"""Gemma-2 and Gemma-3 decoders in PyTorch (counterpart of
`llm_inference_tpu/models/gemma2.py`), registered as "gemma2" and
"gemma3". They differ from llama in the layer, not only in the config:

- sandwich norms: a pre- and a post-norm around both the attention and
  the FFN block, each the Gemma RMSNorm that scales by (1 + w) in float32
  before it casts (`gemma_rms_norm`);
- a GeGLU FFN: gelu_tanh(gate) in float32, cast, times up;
- the query scale query_pre_attn_scalar^-0.5 instead of head_dim^-0.5,
  an attention logit softcap and a final one (gemma2);
- a per-layer sliding window (`layer_windows`): even layers windowed and
  odd ones global for gemma2, the config's layer_types for gemma3, whose
  windowed layers also rotate with a local RoPE theta and no scaling
  (`rope_table` returns the global and the local tables);
- gemma3's per-head (1 + w) q/k norm before the RoPE;
- embeddings scaled by sqrt(hidden) and a tied lm_head (a quantized one
  where quantize_params or init_params_quantized made it from the table).

The projections are llama's: K1 up to 128 rows and K8 above, on the same
layer keys, fused by llama.prepare_params into wqkv and w_gateup (the
separate keys of the JAX layout are served too). Attention takes the JAX
package's routes (gemma2.py:153-205) with the layer's window, the query
scale and the softcap: over a paged cache K10a (or K10b over int4 pages)
for a decode step, else the pages gathered densely and the plain `attend`;
over a dense cache K2 (K5 over int4) for a decode step, K9 for a prefill
flash_attention.supports takes, else the plain `attend` under the
window's mask. The dense write rotates q and k in the same launch
(kvcache.rope_update_cache_layer, the redesigned K3/K4) where
llama._rope_in_write says (bf16 rows, no qk-norm: gemma2); gemma3's
qk-norm takes the plain RoPE and kvcache.update_cache_layer. Tensor
parallelism over this family is not ported: `forward(tp=)` raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import ModelConfig, QuantConfig
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import attention, embedding, kvcache
from llm_inference_tpu_torch.ops import paged_kvcache, rope
from llm_inference_tpu_torch.ops.kernels import decode_attention
from llm_inference_tpu_torch.ops.kernels import flash_attention
from llm_inference_tpu_torch.ops.kernels import paged_attention
from llm_inference_tpu_torch.ops.linear import matmul
from llm_inference_tpu_torch.parallel.mesh import TPGroup

Params = Dict[str, Any]

_NORMS = ("attn_norm", "post_attn_norm", "ffn_norm", "post_ffn_norm")


def gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Gemma RMSNorm: normalise and scale by (1 + w) in float32, then cast
    (llama's norm casts before the weight's product)."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.to(torch.float32))).to(dtype)


def _gemma_norms(cfg: ModelConfig, layers, dtype, device) -> None:
    """The four sandwich norms (and gemma3's q/k norms) at zero, the
    identity of the (1 + w) norm, set in `layers`."""
    L, H = cfg.num_layers, cfg.hidden_size
    for name in _NORMS:
        layers[name] = torch.zeros((L, H), dtype=dtype, device=device)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            layers[name] = torch.zeros((L, cfg.head_dim), dtype=dtype,
                                       device=device)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device=None) -> Params:
    """Random dense weights N(0, 0.02), norms at zero (gemma2.py:58-93);
    the lm_head is the tied table."""
    device = resolve_device(device)
    dtype = dtype or llama.act_dtype(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    H, L = cfg.hidden_size, cfg.num_layers
    I, V = cfg.intermediate_size, cfg.vocab_size
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=device) * 0.02
                ).to(dtype)

    layers = {"wq": rnd(L, H, Hq * D), "wk": rnd(L, H, Hkv * D),
              "wv": rnd(L, H, Hkv * D), "wo": rnd(L, Hq * D, H),
              "w_gate": rnd(L, H, I), "w_up": rnd(L, H, I),
              "w_down": rnd(L, I, H)}
    _gemma_norms(cfg, layers, dtype, device)
    return {"embed": rnd(V, H), "layers": layers,
            "final_norm": torch.zeros((H,), dtype=dtype, device=device)}


def init_params_quantized(cfg: ModelConfig, qcfg: QuantConfig, seed: int = 0,
                          dtype=None, device=None) -> Params:
    """Random quantized weights drawn as codes (llama.init_params_quantized
    on the same layer keys, with its tied quantized head), norms at zero."""
    if not qcfg.enabled:
        return init_params(cfg, seed, dtype, device)
    device = resolve_device(device)
    dtype = dtype or llama.act_dtype(cfg)
    params = llama.init_params_quantized(cfg, qcfg, seed, dtype, device)
    _gemma_norms(cfg, params["layers"], dtype, device)
    params["final_norm"] = torch.zeros((cfg.hidden_size,), dtype=dtype,
                                       device=device)
    return params


def layer_windows(cfg: ModelConfig) -> Tuple[int, ...]:
    """Each layer's sliding window (0 = global attention), gemma2.py:96-110:
    gemma3's layer_types, else gemma2's alternating pattern (even layers
    windowed), else the window on every layer."""
    L = cfg.num_layers
    if cfg.layer_types is not None:
        return tuple(cfg.sliding_window if t == "sliding_attention" else 0
                     for t in cfg.layer_types)
    if cfg.sliding_window <= 0:
        return (0,) * L
    if cfg.sliding_pattern == "alternating":
        return tuple(cfg.sliding_window if i % 2 == 0 else 0
                     for i in range(L))
    return (cfg.sliding_window,) * L


def rope_table(cfg: ModelConfig, cache_len: int, device):
    """The global (cos, sin) tables and the local ones of gemma3's windowed
    layers (rope_local_theta, no scaling; the global tables again when the
    config has one RoPE), for a cache of cache_len slots."""
    P = min(cfg.max_position_embeddings, cache_len)
    glob = rope.make_rope_table(P, cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling, device=device)
    if cfg.rope_local_theta <= 0:
        return glob, glob
    return glob, rope.make_rope_table(P, cfg.head_dim, cfg.rope_local_theta,
                                      device=device)


def _attention(cfg: ModelConfig, q, k, v, cache, l: int, positions,
               write_offsets, mask_for, window: int, scale: float,
               rope_rows=None):
    """Write layer l's K/V into the cache, then attend with the layer's
    window, the query scale and the softcap on the JAX routes
    (gemma2.py:153-205). q/k/v [B, T, H*, D]; with rope_rows (cos, sin)
    q and k come unrotated and the dense write rotates them. mask_for
    (window) gives the plain path's mask. Returns [B, T, Hq·D]."""
    B, T = q.shape[:2]
    cap = cfg.attn_logit_softcap
    if isinstance(cache, paged_kvcache.PagedKVCache):
        ps = cache.page_size
        if T == 1:
            paged_kvcache.write_token(cache, l, k, v, positions[:, 0])
        else:
            paged_kvcache.write_prompt_batch(cache, l, k, v, T // ps,
                                             start_blocks=write_offsets // ps)
        if T == 1 and paged_attention.supports(q.shape, ps):
            out = paged_attention.paged_attention(
                q, cache.k_pages, cache.v_pages, cache.page_table, l,
                positions[:, -1], scale=scale, logit_softcap=cap,
                window=window, k_scale=cache.k_scale, v_scale=cache.v_scale)
        else:
            kd, vd, ksd, vsd = llama._gather_paged(cache, l)
            out = attention.attend(q, kd, vd, mask_for(window), scale=scale,
                                   logit_softcap=cap, k_scale=ksd,
                                   v_scale=vsd)
        return out.reshape(B, T, -1)
    if rope_rows is not None:
        q = kvcache.rope_update_cache_layer(cache, l, q, k, v, *rope_rows,
                                            write_offsets)
    else:
        kvcache.update_cache_layer(cache, l, k, v, write_offsets)
    S = cache.max_seq_len
    sc = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
    if T == 1 and decode_attention.supports(q.shape, S):
        out = decode_attention.decode_attention(
            q, cache.k, cache.v, l, positions[:, -1], scale=scale,
            logit_softcap=cap, window=window, **sc)
    elif T > 1 and flash_attention.supports(q.shape, S, cache.quantized):
        out = flash_attention.flash_attention(
            q, cache.k, cache.v, l, positions, scale=scale,
            logit_softcap=cap, sliding_window=window, **sc)
    else:
        ks, vs = sc["k_scale"], sc["v_scale"]
        out = attention.attend(
            q, cache.k[l], cache.v[l], mask_for(window), scale=scale,
            logit_softcap=cap, k_scale=None if ks is None else ks[l],
            v_scale=None if vs is None else vs[l])
    return out.reshape(B, T, -1)


def _layer(cfg: ModelConfig, layers, l: int, h, cache, positions,
           write_offsets, mask_for, cos, sin, window: int, scale: float):
    """One layer: sandwich-normed attention, then the GeGLU FFN
    (gemma2.py:113-216)."""
    B, T, _ = h.shape
    D, eps = cfg.head_dim, cfg.rms_norm_eps

    def mm(name, x):
        return matmul(x, layers[name], layer=l)

    normed = gemma_rms_norm(h, layers["attn_norm"][l], eps)
    if "wqkv" in layers:
        qkv = mm("wqkv", normed)
        nq = cfg.num_heads * D
        nkv = cfg.num_kv_heads * D
        q, k, v = (qkv[..., a:a + n].reshape(B, T, -1, D)
                   for a, n in ((0, nq), (nq, nkv), (nq + nkv, nkv)))
    else:
        q, k, v = (mm(n, normed).reshape(B, T, -1, D)
                   for n in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q = gemma_rms_norm(q, layers["q_norm"][l], eps)
        k = gemma_rms_norm(k, layers["k_norm"][l], eps)
    fused = llama._rope_in_write(cfg, cache, q.dtype)
    if not fused:
        q = rope.apply_rope_gathered(q, cos, sin)
        k = rope.apply_rope_gathered(k, cos, sin)
    attn = _attention(cfg, q, k, v, cache, l, positions, write_offsets,
                      mask_for, window, scale, (cos, sin) if fused else None)
    h = h + gemma_rms_norm(mm("wo", attn), layers["post_attn_norm"][l], eps)
    normed = gemma_rms_norm(h, layers["ffn_norm"][l], eps)
    if "w_gateup" in layers:
        gate, up = torch.chunk(mm("w_gateup", normed), 2, dim=-1)
    else:
        gate, up = mm("w_gate", normed), mm("w_up", normed)
    act = torch.nn.functional.gelu(gate.to(torch.float32),
                                   approximate="tanh").to(h.dtype) * up
    return h + gemma_rms_norm(mm("w_down", act), layers["post_ffn_norm"][l],
                              eps)


def forward(cfg: ModelConfig, params: Params, ids: torch.Tensor,
            positions: torch.Tensor, cache, *, logits_mode: str = "last",
            last_idx: Optional[torch.Tensor] = None, rope_tables=None,
            paged_history: bool = False, tp: Optional[TPGroup] = None):
    """llama.forward's contract (gemma2.py:219-307): T tokens a sequence
    over a dense or paged cache, written in place; logits [B, V] float32
    for "last", [B, T, V] for "all", the final-norm hidden states in
    float32 for "hidden", None for "none". `rope_tables` is rope_table's
    pair. A paged chunk (T > 1, a multiple of the page size) writes at its
    block offset and attends over the gathered pages, with or without
    earlier pages (`paged_history` changes nothing here)."""
    if tp is not None and tp.size > 1:
        raise NotImplementedError("tensor parallelism over the gemma2 "
                                  "family is not ported yet")
    B, T = ids.shape
    paged = isinstance(cache, paged_kvcache.PagedKVCache)
    S = cache.max_blocks * cache.page_size if paged else cache.max_seq_len
    dtype = llama.act_dtype(cfg)
    layers = params["layers"]
    h = embedding.embedding_lookup(params["embed"], ids).to(dtype)
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.hidden_size ** 0.5, dtype=dtype,
                             device=h.device)
    write_offsets = positions[:, 0]
    glob, local = rope_tables or rope_table(cfg, S, ids.device)
    # gathered once at the positions, clamped as llama.forward's
    idx = torch.clamp(positions.long(), 0, glob[0].shape[0] - 1)
    rows = {id(t): (t[0][idx], t[1][idx]) for t in (glob, local)}
    masks = {}

    def mask_for(window):
        if window not in masks:
            masks[window] = attention.make_attention_mask(positions, S,
                                                          window)
        return masks[window]

    scale = (cfg.query_pre_attn_scalar or cfg.head_dim) ** -0.5
    for l, window in enumerate(layer_windows(cfg)):
        cos, sin = rows[id(local if window > 0 else glob)]
        h = _layer(cfg, layers, l, h, cache, positions, write_offsets,
                   mask_for, cos, sin, window, scale)

    if logits_mode == "none":
        return None, cache
    h = gemma_rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if logits_mode == "hidden":
        return h.to(torch.float32), cache
    if logits_mode == "last":
        if last_idx is None:
            last_idx = torch.full((B,), T - 1, dtype=torch.long,
                                  device=h.device)
        h = h[torch.arange(B, device=h.device), last_idx.long()]
    logits = llama.lm_logits(h, params)[..., :cfg.vocab_size]
    if cfg.final_logit_softcap > 0.0:
        logits = (torch.tanh(logits / cfg.final_logit_softcap)
                  * cfg.final_logit_softcap)
    return logits, cache


# register with the registry (gemma2.py:310-313)
from llm_inference_tpu_torch.models import registry as _registry  # noqa: E402
import sys as _sys  # noqa: E402
_registry.register_model("gemma2", _sys.modules[__name__])
_registry.register_model("gemma3", _sys.modules[__name__])
