"""Mixtral (sparse mixture of experts) in PyTorch (counterpart of
`llm_inference_tpu/models/mixtral.py`), registered as "mixtral".

The attention is llama's (GQA and RoPE, through llama.cached_attention
and its routes: K2/K5 at decode, K9 for the prefills it takes, K10a/K10b
and K11 over pages; over a dense cache the RoPE of q and k and the KV
write are one launch a layer, kv_write.rope_write). The FFN is a top-k
routed mixture of SwiGLU experts with HF MixtralSparseMoeBlock semantics
(`moe_ffn`, mixtral.py:131-181):

    probs = softmax(x @ router)           over all E experts, float32
    top-k = the k largest probs, ties to the lower index, renormalised
    y     = Σ_e sel_e · SwiGLU_e(x)       summed in float32, e = 0 .. E-1

and, as the JAX package runs it, dense-masked: every expert runs on every
token and the router weights zero the terms of the experts not selected.
The projections are K1 up to 128 rows and K8 above; quantized expert
weights are one stack [L·E, K, N] a projection (`quantize_params`), and
K1/K8 pick expert e of layer l at stack index l·E + e by pointer offset.
Expert parallelism (the JAX package's expert_axis) is not ported:
`forward(tp=)` raises.

Weight dict layout (dense tensors or QTensor):
  embed [V, H]; final_norm [H]; lm_head [H, V];
  layers/attn_norm, ffn_norm [L, H]; wq [L, H, Hq·D]; wk, wv [L, H,
  Hkv·D]; wo [L, Hq·D, H]; router [L, H, E] (always dense);
  e_gate, e_up [L, E, H, I] and e_down [L, E, I, H] dense, or QTensors
  stacked [L·E, ...] once quantized.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import ModelConfig, QuantConfig
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import activations, attention, embedding
from llm_inference_tpu_torch.ops import norms, paged_kvcache
from llm_inference_tpu_torch.ops.linear import matmul
from llm_inference_tpu_torch.ops.quantization import QTensor
from llm_inference_tpu_torch.parallel.mesh import TPGroup
from llm_inference_tpu_torch.parallel.sharding import EP_NOT_PORTED

Params = Dict[str, Any]

_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_EXPERT_KEYS = ("e_gate", "e_up", "e_down")


def refuse_tp(tp: Optional[TPGroup]) -> None:
    """Raise where a forward of a mixture-of-experts family is asked to
    run over more than one rank."""
    if tp is not None and tp.size > 1:
        raise NotImplementedError(EP_NOT_PORTED)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device=None) -> Params:
    """Random dense weights N(0, 0.02), norms at one."""
    if cfg.num_experts <= 0:
        raise ValueError("mixtral needs num_experts > 0")
    device = resolve_device(device)
    dtype = dtype or llama.act_dtype(cfg)
    g = llama._generator(seed, device)
    H, L, E = cfg.hidden_size, cfg.num_layers, cfg.num_experts
    I, V = cfg.intermediate_size, cfg.vocab_size
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=device) * 0.02
                ).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": ones(L, H), "wq": rnd(L, H, Hq * D),
        "wk": rnd(L, H, Hkv * D), "wv": rnd(L, H, Hkv * D),
        "wo": rnd(L, Hq * D, H), "ffn_norm": ones(L, H),
        "router": rnd(L, H, E), "e_gate": rnd(L, E, H, I),
        "e_up": rnd(L, E, H, I), "e_down": rnd(L, E, I, H),
    }
    return {"embed": rnd(V, H), "layers": layers,
            "final_norm": ones(H), "lm_head": rnd(H, V)}


def init_params_quantized(cfg: ModelConfig, qcfg: QuantConfig, seed: int = 0,
                          dtype=None, device=None) -> Params:
    """Random quantized weights drawn directly as codes on the device
    (mixtral.py:47-128): a dense bf16 copy of Mixtral-8x7B would need 93
    GB. As llama.init_params_quantized: random bytes as codes, every scale
    0.02/qmax (zero points half a scale where qcfg is asymmetric); the
    attention weights stacked [L, ...], the experts [L·E, ...]; router,
    embed and lm_head dense."""
    if not qcfg.enabled:
        return init_params(cfg, seed, dtype, device)
    device = resolve_device(device)
    dtype = dtype or llama.act_dtype(cfg)
    g = llama._generator(seed, device)
    H, L, E = cfg.hidden_size, cfg.num_layers, cfg.num_experts
    I, V = cfg.intermediate_size, cfg.vocab_size
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    qrnd = code_drawer(qcfg, g, device)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=device) * 0.02
                ).to(dtype)

    layers = {
        "attn_norm": torch.ones((L, H), dtype=dtype, device=device),
        "wq": qrnd(L, H, Hq * D), "wk": qrnd(L, H, Hkv * D),
        "wv": qrnd(L, H, Hkv * D), "wo": qrnd(L, Hq * D, H),
        "ffn_norm": torch.ones((L, H), dtype=dtype, device=device),
        "router": rnd(L, H, E),
        "e_gate": qrnd(L * E, H, I), "e_up": qrnd(L * E, H, I),
        "e_down": qrnd(L * E, I, H),
    }
    return {"embed": rnd(V, H), "layers": layers,
            "final_norm": torch.ones((H,), dtype=dtype, device=device),
            "lm_head": rnd(H, V)}


def code_drawer(qcfg: QuantConfig, g: torch.Generator, device):
    """f(n, K, N) → a QTensor stack of n random [K, N] weights drawn as
    codes (llama.code_drawer: random bytes, every scale 0.02/qmax, zero
    points half a scale where qcfg is asymmetric), as the JAX package's
    qrnd."""
    draw = llama.code_drawer(qcfg, g, device)

    def qrnd(n, K, N):
        return draw(K, N, (n,))
    return qrnd


def quantize_params(params: Params, qcfg: QuantConfig, row_shards: int = 1,
                    ep_shards: int = 1) -> Params:
    """The attention weights quantized stacked [L, ...], the experts
    flattened to [L·E, K, N] stacks (mixtral.py:184-231); the router,
    embed and lm_head stay dense. ep_shards > 1 (the expert-block-major
    stacks of expert parallelism) is not ported."""
    if not qcfg.enabled:
        return params
    if ep_shards > 1 or row_shards > 1:
        raise NotImplementedError(EP_NOT_PORTED)
    layers = dict(params["layers"])
    for name in _ATTN_KEYS:
        layers[name] = llama._stack_quantize(layers[name], qcfg)
    for name in _EXPERT_KEYS:
        w = layers[name]                                   # [L, E, K, N]
        layers[name] = llama._stack_quantize(w.reshape(-1, *w.shape[2:]),
                                             qcfg)
    out = dict(params)
    out["layers"] = layers
    return out


def prepare_params(params: Params, tp_size: int = 1) -> Params:
    """The serving layout: the weights as they are (the JAX package keeps
    mixtral's layer keys unfused, cli.py:80-93)."""
    if tp_size > 1:
        raise NotImplementedError(EP_NOT_PORTED)
    return params


def swiglu_mlp(x, gate, up, down, layer=None):
    """SwiGLU MLP: down(silu(x gate) · x up), each weight a dense [K, N]
    or a QTensor stack indexed at `layer`."""
    act = activations.swiglu_split(matmul(x, gate, layer=layer),
                                   matmul(x, up, layer=layer))
    return matmul(act, down, layer=layer)


def top_k_lower_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of x along its last
    dim, ties to the lower index as jax.lax.top_k breaks them (torch.topk
    does not order ties): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_weights(cfg: ModelConfig, x: torch.Tensor,
                   router_w: torch.Tensor) -> torch.Tensor:
    """float32 mixture weights [.., E]: softmax over all experts of the
    router logits, the top experts_per_token kept (ties to the lower
    index), renormalised to sum 1, zero elsewhere (mixtral.py:151-160)."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = top_k_lower_index(probs, cfg.experts_per_token)
    sel = torch.zeros_like(probs).scatter(-1, idx, vals)
    return sel / torch.clamp(sel.sum(dim=-1, keepdim=True), min=1e-9)


def moe_ffn(cfg: ModelConfig, x: torch.Tensor, router_w, e_gate, e_up,
            e_down, layer_idx: int) -> torch.Tensor:
    """The routed mixture over tokens x [B, T, H]: every expert runs on
    every token and its output, in float32, is added times its router
    weight, in expert order (mixtral.py:131-181). Quantized experts are
    [L·E] stacks indexed at layer_idx·E + e; dense ones are this layer's
    [E, K, N] slices."""
    sel = router_weights(cfg, x, router_w)
    quantized = isinstance(e_gate, QTensor)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        if quantized:
            y = swiglu_mlp(x, e_gate, e_up, e_down,
                           layer_idx * cfg.num_experts + e)
        else:
            y = swiglu_mlp(x, e_gate[e], e_up[e], e_down[e])
        out += sel[..., e:e + 1] * y.to(torch.float32)
    return out.to(x.dtype)


def _layer(cfg: ModelConfig, layers, l: int, h, cache, positions,
           write_offsets, mask, route, cos, sin):
    """One decoder layer (mixtral.py:234-276): llama's attention block,
    then the expert mixture."""
    B, T, _ = h.shape
    D, eps = cfg.head_dim, cfg.rms_norm_eps
    normed = norms.rms_norm(h, layers["attn_norm"][l], eps)
    q, k, v = (matmul(normed, layers[n], layer=l).reshape(B, T, -1, D)
               for n in ("wq", "wk", "wv"))
    fused = llama._rope_in_write(cfg, cache, q.dtype)
    if not fused:
        q, k = llama._rope_heads(cfg, layers, l, q, k, cos, sin)
    attn2d = llama._attend_block(cfg, l, q, k, v, cache, positions,
                                 write_offsets, mask, route,
                                 (cos, sin) if fused else None)
    h = h + matmul(attn2d, layers["wo"], layer=l)
    normed = norms.rms_norm(h, layers["ffn_norm"][l], eps)
    if isinstance(layers["e_gate"], QTensor):
        experts = [layers[n] for n in _EXPERT_KEYS]
    else:
        experts = [layers[n][l] for n in _EXPERT_KEYS]
    return h + moe_ffn(cfg, normed, layers["router"][l], *experts, l)


def rope_table(cfg: ModelConfig, cache_len: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables `forward` needs for a cache of cache_len
    slots (llama's)."""
    return llama.rope_table(cfg, cache_len, device)


def forward(cfg: ModelConfig, params: Params, ids: torch.Tensor,
            positions: torch.Tensor, cache, *, logits_mode: str = "last",
            last_idx: Optional[torch.Tensor] = None,
            rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            paged_history: bool = False, tp: Optional[TPGroup] = None
            ) -> Tuple[Optional[torch.Tensor], Any]:
    """llama.forward's contract (dense or paged cache, logits_mode last /
    all / hidden / none, paged_history for a chunk over earlier pages)
    over mixtral's layers."""
    refuse_tp(tp)
    B, T = ids.shape
    paged = isinstance(cache, paged_kvcache.PagedKVCache)
    ps = cache.page_size if paged else 0
    S = cache.max_blocks * ps if paged else cache.max_seq_len
    layers = params["layers"]
    h = embedding.embedding_lookup(params["embed"], ids).to(
        llama.act_dtype(cfg))
    route = llama.attention_route((B, T, cfg.num_heads, cfg.head_dim), S,
                                  cache.quantized, ps, paged_history)
    mask = None
    if route in ("attend", "paged_gather", "paged_prefill"):
        mask = attention.make_attention_mask(
            positions, T if route == "paged_prefill" else S,
            cfg.sliding_window)
    cos, sin = rope_tables or rope_table(cfg, S, ids.device)
    idx = torch.clamp(positions.long(), 0, cos.shape[0] - 1)
    cos, sin = cos[idx], sin[idx]
    for l in range(layers["attn_norm"].shape[0]):
        h = _layer(cfg, layers, l, h, cache, positions, positions[:, 0],
                   mask, route, cos, sin)
    return llama.forward_output(cfg, params, h, logits_mode, last_idx), cache


# register with the registry (mixtral.py:336-338)
from llm_inference_tpu_torch.models import registry as _registry  # noqa: E402
import sys as _sys  # noqa: E402
_registry.register_model("mixtral", _sys.modules[__name__])
