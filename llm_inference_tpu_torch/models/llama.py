"""LLaMA-family decoder in PyTorch (counterpart of
`llm_inference_tpu/models/llama.py`).

One `forward` serves prefill (T > 1) and decode (T == 1). Layers are
stacked along a leading axis, as in the JAX package, and walked by a
Python loop; quantized weights stay stacked and K1 picks a layer by
pointer offset. With fused quantized weights (prepare_params) the loop
runs the JAX package's pair-carry protocol (llama.py:930-953): each
layer's down-projection delta folds into the next layer's qkv prologue,
so every layer is

    K1 wqkv (norm + residual fused) → RoPE → K3 KV write → K2 attention
    → K1 wo → K1 gate-up (norm + residual fused) → SwiGLU → K1 down

Weight dict layout (dense tensors or QTensor):
  embed [V, H]; final_norm [H]; lm_head [H, V] (absent if tied);
  layers/attn_norm, ffn_norm [L, H]; wq [L, H, Hq·D]; wk, wv [L, H, Hkv·D];
  wo [L, Hq·D, H]; w_gate, w_up [L, H, I]; w_down [L, I, H];
  after fuse_params: wqkv [L, H, (Hq+2Hkv)·D], w_gateup [L, H, 2I].
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import ModelConfig, QuantConfig
from llm_inference_tpu_torch.ops import activations, attention, embedding
from llm_inference_tpu_torch.ops import kvcache, norms, rope
from llm_inference_tpu_torch.ops.kernels import decode_attention
from llm_inference_tpu_torch.ops.linear import matmul, norm_matmul
from llm_inference_tpu_torch.ops.quantization import QTensor, quantize

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
                   scale=torch.stack([t.scale for t in qts]))


def quantize_params(params: Params, qcfg: QuantConfig) -> Params:
    """Quantize the per-layer matmul weights (and lm_head when
    qcfg.quantize_embedding) to QTensors stacked over layers."""
    if not qcfg.enabled:
        return params
    out = dict(params)
    layers = dict(params["layers"])
    for name in _QUANT_KEYS:
        layers[name] = _stack_quantize(layers[name], qcfg)
    out["layers"] = layers
    if qcfg.quantize_embedding:
        if "lm_head" not in params:
            raise NotImplementedError("a quantized tied lm_head is not "
                                      "ported yet")
        bits = {"int8": 8, "int4": 4}[qcfg.weights]
        out["lm_head"] = quantize(params["lm_head"], bits, qcfg.group_size,
                                  qcfg.asymmetric)
    return out


def init_params_quantized(cfg: ModelConfig, qcfg: QuantConfig, seed: int = 0,
                          dtype=None, device=None) -> Params:
    """Random int8 weights drawn directly as codes on the device — a
    dense copy of the model never exists. Codes are uniform in
    [-128, 127] with scale 0.02/127, as the JAX package's dummy weights."""
    if not qcfg.enabled:
        return init_params(cfg, seed, dtype, device)
    if qcfg.weights != "int8" or qcfg.group_size > 0 or qcfg.asymmetric:
        raise NotImplementedError("only int8 per-channel weights are ported")
    device = resolve_device(device)
    dtype = dtype or act_dtype(cfg)
    g = _generator(seed, device)
    H, L = cfg.hidden_size, cfg.num_layers
    I, V = cfg.intermediate_size, cfg.vocab_size
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    scale_val = 0.02 / 127

    def qrnd(K, N, lead=(L,)):
        q = torch.randint(-128, 128, (*lead, N, K), generator=g,
                          dtype=torch.int8, device=device)
        scale = torch.full((*lead, 1, N), scale_val, dtype=torch.float32,
                           device=device)
        return QTensor(q=q, scale=scale)

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


def fuse_params(params: Params) -> Params:
    """wq|wk|wv → wqkv and w_gate|w_up → w_gateup, concatenated along the
    output columns (the JAX package's _interleave_cols at tp_size=1)."""
    layers = dict(params["layers"])

    def fuse(keys, out_key):
        ws = [layers.pop(k) for k in keys]
        if isinstance(ws[0], QTensor):
            # codes are [.., N, K]: output columns are the rows
            layers[out_key] = QTensor(
                q=torch.cat([w.q for w in ws], dim=-2),
                scale=torch.cat([w.scale for w in ws], dim=-1))
        else:
            layers[out_key] = torch.cat(ws, dim=-1)

    if "wq" in layers:
        fuse(("wq", "wk", "wv"), "wqkv")
        if "bq" in layers:
            fuse(("bq", "bk", "bv"), "bqkv")
    if "w_gate" in layers:
        fuse(("w_gate", "w_up"), "w_gateup")
    out = dict(params)
    out["layers"] = layers
    return out


def prepare_params(params: Params) -> Params:
    """Serving layout: qkv and gate-up fused (the JAX package's
    prepare_params without its TPU column blocking)."""
    return fuse_params(params)


def params_to(params: Params, device) -> Params:
    """A copy of the parameter dict with every tensor on `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def _from_numpy(a, device) -> torch.Tensor:
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

    A quantized weight is a dict {"q": int8 [..., K, N] row-major codes,
    "scale": float32 [..., 1, N]} (the JAX QTensor after
    quantization.from_blocked), whose codes are stored transposed here;
    every other leaf is an array. Fused keys (wqkv, w_gateup) pass through
    as they are. Call prepare_params on the result before serving."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict) and "q" in node and "scale" in node:
            q = _from_numpy(node["q"], device).to(torch.int8)
            scale = _from_numpy(node["scale"], device).to(torch.float32)
            if scale.shape[-2:] != (1, q.shape[-1]):
                raise NotImplementedError(
                    f"scales {tuple(scale.shape)} for codes "
                    f"{tuple(q.shape)}: only int8 per-channel is ported")
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

def cached_attention(cfg: ModelConfig, q, k, v, cache: kvcache.KVCache,
                     layer: int, positions, write_offsets, mask):
    """Write this layer's K/V into the dense cache, then attend: K2 for a
    decode step (mask None), the plain `attend` over `mask` otherwise.
    q/k/v: [B, T, H*, D] (post-RoPE). Returns [B, T, Hq, D]."""
    kvcache.update_cache_layer(cache, layer, k, v, write_offsets)
    if mask is None:
        return decode_attention.decode_attention(
            q, cache.k, cache.v, layer, positions[:, -1],
            logit_softcap=cfg.attn_logit_softcap, window=cfg.sliding_window)
    return attention.attend(q, cache.k[layer], cache.v[layer], mask,
                            logit_softcap=cfg.attn_logit_softcap)


def _rope_heads(cfg: ModelConfig, layers, l, q, k, cos, sin):
    """The optional qk-norm, then RoPE, on q/k [B, T, H*, D]; cos/sin are
    the tables gathered at the positions, [B, T, D]."""
    if cfg.qk_norm:
        q = norms.rms_norm(q, layers["q_norm"][l], cfg.rms_norm_eps)
        k = norms.rms_norm(k, layers["k_norm"][l], cfg.rms_norm_eps)
    return (rope.apply_rope_gathered(q, cos, sin),
            rope.apply_rope_gathered(k, cos, sin))


def _fused_qkv_heads(cfg: ModelConfig, layers, l, qkv, cos, sin):
    """Post-RoPE q, k and v [B, T, H*, D] from a fused [q|k|v] projection.
    q and k are adjacent columns, so without qk-norm one RoPE pass covers
    both (the same elementwise math, half the launches)."""
    B, T, n = qkv.shape
    D = cfg.head_dim
    nq = n * cfg.num_heads // (cfg.num_heads + 2 * cfg.num_kv_heads)
    nkv = (n - nq) // 2
    v = qkv[..., nq + nkv:].reshape(B, T, -1, D)
    if cfg.qk_norm:
        q, k = _rope_heads(cfg, layers, l,
                           qkv[..., :nq].reshape(B, T, -1, D),
                           qkv[..., nq:nq + nkv].reshape(B, T, -1, D),
                           cos, sin)
        return q, k, v
    qk = rope.apply_rope_gathered(qkv[..., :nq + nkv].reshape(B, T, -1, D),
                                  cos, sin)
    return qk[:, :, :nq // D], qk[:, :, nq // D:], v


def _attend_block(cfg, l, q, k, v, cache, positions, write_offsets, mask):
    B, T = q.shape[:2]
    attn = cached_attention(cfg, q, k, v, cache, l, positions, write_offsets,
                            mask)
    return attn.reshape(B, T, -1)


def _layer_pair(cfg, layers, l, h, d, cache, positions, write_offsets, mask,
                cos, sin):
    """Pair-carry layer: returns (h2, delta) with the residual stream
    h2 and this layer's down-projection output, which the next layer's
    wqkv prologue adds."""
    B, T, _ = h.shape
    eps = cfg.rms_norm_eps
    bqkv = layers.get("bqkv")
    qkv, h = norm_matmul(h, layers["wqkv"], layers["attn_norm"][l], eps,
                         bias=None if bqkv is None else bqkv[l], layer=l,
                         residual=d, want_x_out=True)
    q, k, v = _fused_qkv_heads(cfg, layers, l, qkv, cos, sin)
    attn2d = _attend_block(cfg, l, q, k, v, cache, positions, write_offsets,
                           mask)
    attn_out = matmul(attn2d, layers["wo"], layer=l)
    gateup, h2 = norm_matmul(h, layers["w_gateup"], layers["ffn_norm"][l],
                             eps, residual=attn_out, layer=l,
                             want_x_out=True)
    gate, up = torch.chunk(gateup, 2, dim=-1)
    act = activations.swiglu_split(gate, up)
    return h2, matmul(act, layers["w_down"], layer=l)


def _layer_plain(cfg, layers, l, h, cache, positions, write_offsets, mask,
                 cos, sin):
    """Unfused layer (separate or dense weights): norm, projections and
    residual adds as separate ops."""
    B, T, _ = h.shape
    eps = cfg.rms_norm_eps

    def mm(name, x, bias=None):
        b = layers.get(bias)
        return matmul(x, layers[name], bias=None if b is None else b[l],
                      layer=l)

    normed = norms.rms_norm(h, layers["attn_norm"][l], eps)
    if "wqkv" in layers:
        q, k, v = _fused_qkv_heads(cfg, layers, l,
                                   mm("wqkv", normed, "bqkv"), cos, sin)
    else:
        D = cfg.head_dim
        q, k = _rope_heads(cfg, layers, l,
                           mm("wq", normed, "bq").reshape(B, T, -1, D),
                           mm("wk", normed, "bk").reshape(B, T, -1, D),
                           cos, sin)
        v = mm("wv", normed, "bv").reshape(B, T, -1, D)
    attn2d = _attend_block(cfg, l, q, k, v, cache, positions, write_offsets,
                           mask)
    h = h + mm("wo", attn2d)
    normed = norms.rms_norm(h, layers["ffn_norm"][l], eps)
    if "w_gateup" in layers:
        gate, up = torch.chunk(mm("w_gateup", normed), 2, dim=-1)
    else:
        gate, up = mm("w_gate", normed), mm("w_up", normed)
    return h + mm("w_down", activations.swiglu_split(gate, up))


def rope_table(cfg: ModelConfig, cache_len: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables `forward` needs for a cache of cache_len slots."""
    return rope.make_rope_table(min(cfg.max_position_embeddings, cache_len),
                                cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling, device=device)


def forward(cfg: ModelConfig, params: Params, ids: torch.Tensor,
            positions: torch.Tensor, cache: kvcache.KVCache, *,
            logits_mode: str = "last", last_idx: Optional[torch.Tensor] = None,
            rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Tuple[Optional[torch.Tensor], kvcache.KVCache]:
    """Run the decoder over T tokens per sequence, writing the cache in
    place. ids/positions: [B, T] int. Returns (logits, cache): logits
    [B, V] float32 for "last" (at last_idx, default T-1), [B, T, V] for
    "all", the final-norm hidden states for "hidden", None for "none".
    `rope_tables` (from rope_table) saves rebuilding them per call."""
    B, T = ids.shape
    S = cache.max_seq_len
    dtype = act_dtype(cfg)
    layers = params["layers"]
    L = layers["attn_norm"].shape[0]

    h = embedding.embedding_lookup(params["embed"], ids).to(dtype)
    hd = cfg.head_dim
    decode = T == 1 and decode_attention.supports((B, T, cfg.num_heads, hd), S)
    mask = (None if decode else
            attention.make_attention_mask(positions, S, cfg.sliding_window))
    write_offsets = positions[:, 0]
    cos, sin = rope_tables or rope_table(cfg, S, ids.device)
    idx = positions.long()
    cos, sin = cos[idx], sin[idx]          # gathered once for every layer

    if (isinstance(layers.get("wqkv"), QTensor)
            and isinstance(layers.get("w_gateup"), QTensor)):
        d = torch.zeros_like(h)
        for l in range(L):
            h, d = _layer_pair(cfg, layers, l, h, d, cache, positions,
                               write_offsets, mask, cos, sin)
        h = h + d
    else:
        for l in range(L):
            h = _layer_plain(cfg, layers, l, h, cache, positions,
                             write_offsets, mask, cos, sin)

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
    if logits.shape[-1] > cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    if cfg.final_logit_softcap > 0.0:
        logits = (torch.tanh(logits / cfg.final_logit_softcap)
                  * cfg.final_logit_softcap)
    return logits, cache
