"""DeepSeek-V3/R1 in PyTorch (counterpart of
`llm_inference_tpu/models/deepseek.py`): multi-head latent attention
(MLA) over a latent cache, and the sigmoid-routed mixture of experts;
registered as "deepseek" (HF's "deepseek_v3" resolves to it) and
"tiny-deepseek".

- The cache holds the latent, one kv head: k rows [c_kv | RoPE'd k_rot]
  (kv_lora_rank + qk_rope_head_dim = 576 values at V3 width) and v rows
  c_kv (512), in bf16, int8 codes or packed int4 codes, each with
  per-(slot, head) scales over its own width (`new_cache`,
  `new_paged_cache`). The decode write is K3 (bf16; int4 after the plain
  quantize_kv4, with the scale write) or K4 (int8) at the two widths
  (kvcache.update_cache_layer); a prefill's is the plain slice write.
- Attention runs absorbed (deepseek.py:165-264): q_eff[h] = [q_nope[h]
  W_uk[h] | q_rot[h]] attends over the latent rows as one 576-wide MQA
  head, then out[h] = latent_out[h] W_uv[h]. The JAX package gates its
  fused attention kernels off at D = 576 (deepseek.py:21-24) and runs
  XLA; the port runs the plain `attend` there, over the dense cache or
  the pages gathered densely. The RoPE rotates the 64-wide q_rot and
  k_rot in plain PyTorch before the write.
- The MoE (`v3_moe`, deepseek.py:273-331): sigmoid scores plus
  e_score_correction_bias, group-limited routing (each group scored by
  the sum of its top 2, topk_group groups kept), the top-k weights taken
  from the raw sigmoid, normalised (norm_topk_prob) and scaled
  (routed_scaling_factor); dense-masked (every expert on every token) as
  the JAX package runs it, then the shared expert added after the
  mixture. The first first_k_dense layers have a dense FFN: the layers
  are two stacks, "dense_layers" and "moe_layers", each weight indexed
  by its stack-relative layer (w_idx) and the cache by the absolute one.
- The projections are K1 up to 128 rows and K8 above. Quantized expert
  weights are one stack [Lm·E, K, N] a projection, expert e of MoE layer
  w_idx at stack index w_idx·E + e; w_uk, w_uv, the router and the norms
  stay dense.
- YaRN RoPE with the mscale² fold of the score scale (`score_scale`);
  a checkpoint with rope_interleave has its RoPE pairs de-interleaved
  into the projection columns at conversion (`convert_hf_state_dict`).
Expert parallelism is not ported: `forward(tp=)` raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import ModelConfig, QuantConfig
from llm_inference_tpu_torch.models import llama, mixtral
from llm_inference_tpu_torch.models.mixtral import swiglu_mlp
from llm_inference_tpu_torch.ops import attention, embedding, kvcache, norms
from llm_inference_tpu_torch.ops import paged_kvcache, rope
from llm_inference_tpu_torch.ops.linear import matmul
from llm_inference_tpu_torch.ops.quantization import QTensor
from llm_inference_tpu_torch.parallel.mesh import TPGroup
from llm_inference_tpu_torch.parallel.sharding import EP_NOT_PORTED

Params = Dict[str, Any]

_STACKS = ("dense_layers", "moe_layers")
# 2-D matmul weights of a stack (quantizable); norms, the router and the
# per-head w_uk / w_uv stay dense (deepseek.py:619-624)
_QUANT_KEYS = ("wq", "wq_a", "wq_b", "wkv_a", "wo",
               "w_gate", "w_up", "w_down", "s_gate", "s_up", "s_down")
_EXPERT_KEYS = ("e_gate", "e_up", "e_down")


def is_deepseek(cfg: ModelConfig) -> bool:
    return cfg.kv_lora_rank > 0


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    """float32 for a float32 config, else bf16 (deepseek.py:67-68)."""
    return torch.float32 if cfg.dtype == "float32" else torch.bfloat16


def qk_head_dim(cfg: ModelConfig) -> int:
    return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim


def latent_dim(cfg: ModelConfig) -> int:
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def score_scale(cfg: ModelConfig) -> float:
    """HF DeepseekV3Attention.scaling: qk_head_dim^-0.5, times the yarn
    mscale(factor, mscale_all_dim)^2 when that key is set."""
    s = qk_head_dim(cfg) ** -0.5
    rs = cfg.rope_scaling or {}
    mad = rs.get("mscale_all_dim", 0)
    factor = rs.get("factor", 1.0)
    if mad and factor > 1:
        m = 0.1 * float(mad) * math.log(float(factor)) + 1.0
        s = s * m * m
    return s


def _latent_shapes(cfg: ModelConfig, lead, bits: int):
    """(k, v) shapes of latent rows after the leading dims `lead`: the
    values, or their packed bytes for int4."""
    div = 2 if bits == 4 else 1
    return ((*lead, latent_dim(cfg) // div),
            (*lead, cfg.kv_lora_rank // div))


def _kind(dtype) -> int:
    return 8 if dtype in (torch.int8, "int8") else 4 if dtype == "int4" \
        else 16


def new_cache(cfg: ModelConfig, batch: int, max_seq: int,
              dtype=torch.bfloat16, device=None) -> kvcache.KVCache:
    """The latent cache (deepseek.py:92-122): one kv head; k rows [c_kv |
    k_rot] latent_dim wide, v rows c_kv kv_lora_rank wide; dtype a float
    dtype, torch.int8 / "int8" (codes and per-(slot, head) float32 scales)
    or "int4" (packed codes, the same scales)."""
    device = resolve_device(device)
    L, bits = cfg.num_layers, _kind(dtype)
    ks, vs = _latent_shapes(cfg, (L, batch, 1, max_seq), bits)
    if bits == 16:
        return kvcache.KVCache(
            k=torch.zeros(ks, dtype=dtype, device=device),
            v=torch.zeros(vs, dtype=dtype, device=device))
    sshape = (L, batch, max_seq, 1)
    return kvcache.KVCache(
        k=torch.zeros(ks, dtype=torch.int8, device=device),
        v=torch.zeros(vs, dtype=torch.int8, device=device),
        k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        bits=bits)


def new_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                    batch: int, max_blocks: int, dtype=torch.bfloat16,
                    device=None) -> paged_kvcache.PagedKVCache:
    """The paged latent pool (deepseek.py:125-158), the schedulers' pool
    of this family: one kv head, k pages latent_dim wide and v pages
    kv_lora_rank wide, in new_cache's kinds."""
    device = resolve_device(device)
    L, bits = cfg.num_layers, _kind(dtype)
    ks, vs = _latent_shapes(cfg, (L, num_pages, 1, page_size), bits)
    pt = torch.zeros((batch, max_blocks), dtype=torch.int32, device=device)
    if bits == 16:
        return paged_kvcache.PagedKVCache(
            k_pages=torch.zeros(ks, dtype=dtype, device=device),
            v_pages=torch.zeros(vs, dtype=dtype, device=device),
            page_table=pt)
    sshape = (L, num_pages, page_size, 1)
    return paged_kvcache.PagedKVCache(
        k_pages=torch.zeros(ks, dtype=torch.int8, device=device),
        v_pages=torch.zeros(vs, dtype=torch.int8, device=device),
        page_table=pt,
        k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        bits=bits)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _mm(lp, name, x, w_idx):
    """x @ the stack's weight `name` at stack-relative layer w_idx."""
    return matmul(x, lp[name], layer=w_idx)


def _per_head(x, w):
    """einsum "bthi,hio->btho" with products of x.dtype values summed in
    float32, as the JAX einsum with preferred_element_type (w cast to
    x.dtype first), rounded to x.dtype."""
    f32 = torch.float32
    return torch.einsum("bthi,hio->btho", x.to(f32),
                        w.to(x.dtype).to(f32)).to(x.dtype)


def _mla_attention(cfg: ModelConfig, h, lp, w_idx: int, cache, layer: int,
                   positions, write_offsets, mask, cos, sin,
                   paged_history: bool):
    """Absorbed MLA over the latent cache (deepseek.py:165-264): `layer`
    indexes the cache, w_idx the stack's weights. cos/sin are the RoPE
    rows gathered at the positions, [B, T, qk_rope_head_dim]."""
    B, T, _ = h.shape
    Hh = lp["w_uk"].shape[1]
    nope, kvr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    eps = cfg.rms_norm_eps
    normed = norms.rms_norm(h, lp["attn_norm"][w_idx], eps)
    if cfg.q_lora_rank > 0:
        qa = norms.rms_norm(_mm(lp, "wq_a", normed, w_idx),
                            lp["q_a_norm"][w_idx], eps)
        q = _mm(lp, "wq_b", qa, w_idx)
    else:
        q = _mm(lp, "wq", normed, w_idx)
    q = q.reshape(B, T, Hh, qk_head_dim(cfg))
    q_nope, q_rot = q[..., :nope], q[..., nope:]
    ckv = _mm(lp, "wkv_a", normed, w_idx)                 # [B, T, kvr + r]
    c = norms.rms_norm(ckv[..., :kvr], lp["kv_a_norm"][w_idx], eps)
    q_rot = rope.apply_rope_gathered(q_rot, cos, sin)
    k_rot = rope.apply_rope_gathered(ckv[..., None, kvr:], cos, sin)
    # scores = q_nope·(W_uk c) = (q_nope W_uk)·c
    q_eff = torch.cat([_per_head(q_nope, lp["w_uk"][w_idx]), q_rot], dim=-1)
    k_eff = torch.cat([c, k_rot[:, :, 0]], dim=-1)[:, :, None, :]
    v_eff = c[:, :, None, :]
    scale = score_scale(cfg)
    if isinstance(cache, paged_kvcache.PagedKVCache):
        if T == 1:
            paged_kvcache.write_token(cache, layer, k_eff, v_eff,
                                      positions[:, 0])
        else:
            start = (write_offsets // cache.page_size if paged_history
                     else None)
            paged_kvcache.write_prompt_batch(cache, layer, k_eff, v_eff,
                                             T // cache.page_size,
                                             start_blocks=start)
        kd, vd, ksd, vsd = llama._gather_paged(cache, layer)
        out_lat = attention.attend(q_eff, kd, vd, mask, scale=scale,
                                   k_scale=ksd, v_scale=vsd)
    else:
        kvcache.update_cache_layer(cache, layer, k_eff, v_eff, write_offsets)
        ks, vs = cache.k_scale, cache.v_scale
        out_lat = attention.attend(
            q_eff, cache.k[layer], cache.v[layer], mask, scale=scale,
            k_scale=None if ks is None else ks[layer],
            v_scale=None if vs is None else vs[layer])
    out = _per_head(out_lat, lp["w_uv"][w_idx]).to(h.dtype)
    return _mm(lp, "wo", out.reshape(B, T, Hh * cfg.v_head_dim), w_idx)


def router_weights(cfg: ModelConfig, x: torch.Tensor, router_w,
                   router_bias) -> torch.Tensor:
    """float32 mixture weights [.., E] of V3's routing (deepseek.py:
    279-300): sigmoid scores plus the correction bias; each of n_group
    groups scored by the sum of its 2 best, the topk_group best groups
    kept; the top experts_per_token of the kept experts (the others at
    0.0) chosen on the biased scores, ties to the lower index; their RAW
    sigmoid scores normalised (norm_topk_prob) and scaled by
    routed_scaling_factor."""
    E, G = cfg.num_experts, cfg.n_group
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    scores = torch.sigmoid(logits)                           # [.., E]
    biased = scores + router_bias.to(torch.float32)
    lead = biased.shape[:-1]
    group_scores = torch.topk(biased.reshape(*lead, G, E // G), 2,
                              dim=-1).values.sum(dim=-1)     # [.., G]
    _, gidx = mixtral.top_k_lower_index(group_scores, cfg.topk_group)
    gmask = torch.zeros_like(group_scores, dtype=torch.bool).scatter(
        -1, gidx, True)
    emask = gmask.repeat_interleave(E // G, dim=-1)          # [.., E]
    choice = torch.where(emask, biased, torch.zeros_like(biased))
    _, tidx = mixtral.top_k_lower_index(choice, cfg.experts_per_token)
    w = torch.gather(scores, -1, tidx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * cfg.routed_scaling_factor
    return torch.zeros_like(scores).scatter(-1, tidx, w)


def v3_moe(cfg: ModelConfig, x, lp, w_idx: int) -> torch.Tensor:
    """The routed mixture (dense-masked, float32 in expert order) plus the
    shared expert (deepseek.py:273-331)."""
    sel = router_weights(cfg, x, lp["router"][w_idx],
                         lp["router_bias"][w_idx])
    E = cfg.num_experts
    quantized = isinstance(lp["e_gate"], QTensor)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        if quantized:
            y = swiglu_mlp(x, lp["e_gate"], lp["e_up"], lp["e_down"],
                     w_idx * E + e)
        else:
            y = swiglu_mlp(x, lp["e_gate"][w_idx][e], lp["e_up"][w_idx][e],
                     lp["e_down"][w_idx][e])
        out += sel[..., e:e + 1] * y.to(torch.float32)
    out = out.to(x.dtype)
    return out + swiglu_mlp(x, lp["s_gate"], lp["s_up"], lp["s_down"], w_idx)


def _layer(cfg: ModelConfig, h, lp, w_idx: int, layer: int, moe: bool,
           cache, positions, write_offsets, mask, cos, sin, paged_history):
    h = h + _mla_attention(cfg, h, lp, w_idx, cache, layer, positions,
                           write_offsets, mask, cos, sin, paged_history)
    normed = norms.rms_norm(h, lp["ffn_norm"][w_idx], cfg.rms_norm_eps)
    if moe:
        return h + v3_moe(cfg, normed, lp, w_idx)
    return h + swiglu_mlp(normed, lp["w_gate"], lp["w_up"], lp["w_down"],
                          w_idx)


def rope_table(cfg: ModelConfig, cache_len: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables of the rotated qk_rope_head_dim dims, yarn
    scaled as the config says, for a cache of cache_len slots."""
    return rope.make_rope_table(min(cfg.max_position_embeddings, cache_len),
                                cfg.qk_rope_head_dim, cfg.rope_theta,
                                cfg.rope_scaling, device=device)


def forward(cfg: ModelConfig, params: Params, ids: torch.Tensor,
            positions: torch.Tensor, cache, *, logits_mode: str = "last",
            last_idx: Optional[torch.Tensor] = None,
            rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            paged_history: bool = False, tp: Optional[TPGroup] = None
            ) -> Tuple[Optional[torch.Tensor], Any]:
    """llama.forward's contract over the latent cache (dense: new_cache;
    paged: new_paged_cache): the dense stack, then the MoE stack
    (deepseek.py:357-426)."""
    mixtral.refuse_tp(tp)
    paged = isinstance(cache, paged_kvcache.PagedKVCache)
    S = cache.max_blocks * cache.page_size if paged else cache.max_seq_len
    h = embedding.embedding_lookup(params["embed"], ids).to(act_dtype(cfg))
    mask = attention.make_attention_mask(positions, S)
    write_offsets = positions[:, 0]
    cos, sin = rope_tables or rope_table(cfg, S, ids.device)
    idx = torch.clamp(positions.long(), 0, cos.shape[0] - 1)
    cos, sin = cos[idx], sin[idx]
    layer = 0
    for stack, moe in zip(_STACKS, (False, True)):
        lp = params.get(stack) or {}
        n = lp["attn_norm"].shape[0] if lp else 0
        for w_idx in range(n):
            h = _layer(cfg, h, lp, w_idx, layer, moe, cache, positions,
                       write_offsets, mask, cos, sin, paged_history)
            layer += 1
    return llama.forward_output(cfg, params, h, logits_mode, last_idx), cache


# ---------------------------------------------------------------------------
# params: random init, HF conversion, quantization
# ---------------------------------------------------------------------------

def _attn_shapes(cfg: ModelConfig, L: int) -> Dict[str, tuple]:
    """Shapes of a stack's attention weights (deepseek.py:456-472)."""
    H, Hh = cfg.hidden_size, cfg.num_heads
    nope, rdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kvr, vd = cfg.kv_lora_rank, cfg.v_head_dim
    d = {"wkv_a": (L, H, kvr + rdim), "w_uk": (L, Hh, nope, kvr),
         "w_uv": (L, Hh, kvr, vd), "wo": (L, Hh * vd, H)}
    if cfg.q_lora_rank > 0:
        d["wq_a"] = (L, H, cfg.q_lora_rank)
        d["wq_b"] = (L, cfg.q_lora_rank, Hh * (nope + rdim))
    else:
        d["wq"] = (L, H, Hh * (nope + rdim))
    return d


def _norm_shapes(cfg: ModelConfig, L: int) -> Dict[str, tuple]:
    d = {"attn_norm": (L, cfg.hidden_size), "kv_a_norm": (L, cfg.kv_lora_rank),
         "ffn_norm": (L, cfg.hidden_size)}
    if cfg.q_lora_rank > 0:
        d["q_a_norm"] = (L, cfg.q_lora_rank)
    return d


def _ffn_shapes(cfg: ModelConfig, L: int, moe: bool) -> Dict[str, tuple]:
    H = cfg.hidden_size
    if not moe:
        I = cfg.intermediate_size
        return {"w_gate": (L, H, I), "w_up": (L, H, I), "w_down": (L, I, H)}
    mi, E = cfg.moe_intermediate_size, cfg.num_experts
    si = mi * cfg.n_shared_experts
    return {"e_gate": (L, E, H, mi), "e_up": (L, E, H, mi),
            "e_down": (L, E, mi, H), "s_gate": (L, H, si),
            "s_up": (L, H, si), "s_down": (L, si, H)}


def _stack_sizes(cfg: ModelConfig):
    Ld = cfg.first_k_dense
    return ((Ld, False), (cfg.num_layers - Ld, True))


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device=None) -> Params:
    """Random dense weights N(0, 0.02), norms at one, a zero router bias
    (deepseek.py:443-505)."""
    device = resolve_device(device)
    dtype = dtype or act_dtype(cfg)
    g = llama._generator(seed, device)

    def rnd(shape):
        return (torch.randn(shape, generator=g, device=device) * 0.02
                ).to(dtype)

    params: Params = {}
    for sk, (L, moe) in zip(_STACKS, _stack_sizes(cfg)):
        if not L:
            params[sk] = {}
            continue
        d = {k: torch.ones(s, dtype=dtype, device=device)
             for k, s in _norm_shapes(cfg, L).items()}
        d.update({k: rnd(s) for k, s in _attn_shapes(cfg, L).items()})
        d.update({k: rnd(s) for k, s in _ffn_shapes(cfg, L, moe).items()})
        if moe:
            d["router"] = rnd((L, cfg.hidden_size, cfg.num_experts))
            d["router_bias"] = torch.zeros((L, cfg.num_experts),
                                           dtype=torch.float32, device=device)
        params[sk] = d
    V, H = cfg.vocab_size, cfg.hidden_size
    params["embed"] = rnd((V, H))
    params["final_norm"] = torch.ones((H,), dtype=dtype, device=device)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rnd((H, V))
    return params


def init_params_quantized(cfg: ModelConfig, qcfg: QuantConfig, seed: int = 0,
                          dtype=None, device=None) -> Params:
    """Random quantized weights: the JAX package has none for this family
    (its dummy weights are dense, deepseek.py:443), so this quantizes
    init_params' draw with quantize_params (a dense copy exists while it
    runs: small configs)."""
    params = init_params(cfg, seed, dtype, device)
    return quantize_params(params, qcfg)


def _deinterleave_cols(w: torch.Tensor) -> torch.Tensor:
    """RoPE pairs de-interleaved on the last axis: [x0, x1, x2, x3, ..] →
    [x0, x2, .. | x1, x3, ..] (deepseek.py:507-512)."""
    return torch.cat([w[..., 0::2], w[..., 1::2]], dim=-1)


def convert_hf_state_dict(cfg: ModelConfig, sd: Dict[str, Any], dtype=None,
                          device=None) -> Params:
    """An HF DeepseekV3 state dict (name → torch tensor or numpy array,
    keys with or without "model.") → the two-stack params in `dtype`
    (default cfg.dtype) on `device`, the router and its bias in float32
    (deepseek.py:515-616): kv_b_proj split per head into w_uk [Hh, nope,
    kvr] and w_uv [Hh, kvr, vd]; with rope_interleave the RoPE columns of
    q_b_proj (or q_proj) and kv_a_proj_with_mqa de-interleaved."""
    from llm_inference_tpu_torch.utils.checkpoint import (_TORCH_DTYPES,
                                                          _as_float_tensor,
                                                          _dtype_name)
    device = resolve_device(device)
    tdt = _TORCH_DTYPES[_dtype_name(dtype or cfg.dtype)]
    sd = {(k[6:] if k.startswith("model.") else k): v for k, v in sd.items()}

    def get(name):
        if name not in sd:
            raise KeyError(f"missing weight {name!r}; have e.g. "
                           f"{sorted(sd)[:5]}")
        t = _as_float_tensor(sd[name])
        return t if t.dtype == torch.float16 else t.to(torch.float32)

    Hh, nope, rdim = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kvr, vd = cfg.kv_lora_rank, cfg.v_head_dim
    qk = nope + rdim

    def attn_entries(i, acc):
        p = f"layers.{i}."

        def add(k, t):
            acc.setdefault(k, []).append(t)
        add("attn_norm", get(p + "input_layernorm.weight"))
        if cfg.q_lora_rank > 0:
            add("wq_a", get(p + "self_attn.q_a_proj.weight").T)
            add("q_a_norm", get(p + "self_attn.q_a_layernorm.weight"))
            wqb = get(p + "self_attn.q_b_proj.weight").T     # [qr, Hh·qk]
        else:
            wqb = get(p + "self_attn.q_proj.weight").T       # [H, Hh·qk]
        wkva = get(p + "self_attn.kv_a_proj_with_mqa.weight").T
        if cfg.rope_interleave:
            w3 = wqb.reshape(wqb.shape[0], Hh, qk)
            w3 = torch.cat([w3[..., :nope],
                            _deinterleave_cols(w3[..., nope:])], dim=-1)
            wqb = w3.reshape(wqb.shape[0], Hh * qk)
            wkva = torch.cat([wkva[:, :kvr],
                              _deinterleave_cols(wkva[:, kvr:])], dim=-1)
        add("wq_b" if cfg.q_lora_rank > 0 else "wq", wqb)
        add("wkv_a", wkva)
        add("kv_a_norm", get(p + "self_attn.kv_a_layernorm.weight"))
        wkvb = get(p + "self_attn.kv_b_proj.weight").reshape(Hh, nope + vd,
                                                             kvr)
        add("w_uk", wkvb[:, :nope, :])
        add("w_uv", wkvb[:, nope:, :].transpose(1, 2))
        add("wo", get(p + "self_attn.o_proj.weight").T)
        add("ffn_norm", get(p + "post_attention_layernorm.weight"))

    def experts(p, proj):
        return torch.stack([get(p + f"mlp.experts.{e}.{proj}.weight").T
                            for e in range(cfg.num_experts)])

    accs = ({}, {})
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        moe = i >= cfg.first_k_dense
        acc = accs[moe]
        attn_entries(i, acc)
        if not moe:
            for ours, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
                acc.setdefault(ours, []).append(get(p + f"mlp.{hf}.weight").T)
            continue
        acc.setdefault("router", []).append(get(p + "mlp.gate.weight").T)
        acc.setdefault("router_bias", []).append(
            get(p + "mlp.gate.e_score_correction_bias"))
        for ours, hf in (("e_gate", "gate_proj"), ("e_up", "up_proj"),
                         ("e_down", "down_proj")):
            acc.setdefault(ours, []).append(experts(p, hf))
        for ours, hf in (("s_gate", "gate_proj"), ("s_up", "up_proj"),
                         ("s_down", "down_proj")):
            acc.setdefault(ours, []).append(
                get(p + f"mlp.shared_experts.{hf}.weight").T)

    def fin(acc):
        return {k: torch.stack(v).to(
            torch.float32 if k in ("router", "router_bias") else tdt
        ).contiguous().to(device) for k, v in acc.items()}

    params: Params = {
        "embed": get("embed_tokens.weight").to(tdt).to(device),
        "dense_layers": fin(accs[0]) if cfg.first_k_dense else {},
        "moe_layers": fin(accs[1]),
        "final_norm": get("norm.weight").to(tdt).to(device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight").T.to(tdt).contiguous().to(
            device)
    return params


def quantize_params(params: Params, qcfg: QuantConfig, ep_shards: int = 1,
                    **_ignored) -> Params:
    """Weight-only int8 / int4 over the two stacks (deepseek.py:627-665):
    each stack's 2-D matmul weights become QTensors stacked over its
    layers, the expert stacks [Lm, E, K, N] flatten to [Lm·E, K, N];
    norms, the router, w_uk / w_uv, embed and lm_head stay dense.
    ep_shards > 1 (expert parallelism) is not ported."""
    if not qcfg.enabled:
        return params
    if ep_shards > 1:
        raise NotImplementedError(EP_NOT_PORTED)
    out = dict(params)
    for sk in _STACKS:
        stack = dict(params.get(sk) or {})
        for name in _QUANT_KEYS:
            if name in stack:
                stack[name] = llama._stack_quantize(stack[name], qcfg)
        for name in _EXPERT_KEYS:
            if name in stack:
                w = stack[name]                          # [Lm, E, K, N]
                stack[name] = llama._stack_quantize(
                    w.reshape(-1, *w.shape[2:]), qcfg)
        out[sk] = stack
    return out


def prepare_params(params: Params, tp_size: int = 1, **_ignored) -> Params:
    """The serving layout: the weights as they are (the JAX package's
    prepare_params only re-lays the codes into its TPU column blocks,
    deepseek.py:668-700)."""
    if tp_size > 1:
        raise NotImplementedError(EP_NOT_PORTED)
    return params


# register with the registry (deepseek.py:703-707)
from llm_inference_tpu_torch.models import registry as _registry  # noqa: E402
import sys as _sys  # noqa: E402
_registry.register_model("deepseek", _sys.modules[__name__])
_registry.register_model("tiny-deepseek", _sys.modules[__name__])
