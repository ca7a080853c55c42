"""Checkpoint loading: HuggingFace safetensors directories and the
reference engine's raw per-tensor .bin directories (counterpart of
`llm_inference_tpu/utils/checkpoint.py`): llama (llama2/3/3.1), mistral,
qwen2, qwen3 and phi3 (whose fused qkv_proj and gate_up_proj are split),
gemma2 and gemma3 (sandwich-norm keys), mixtral (the block_sparse_moe
router and experts) and DeepSeek-V3 (models/deepseek.py's two stacks).

Layout conventions (models/llama.py): every matmul weight is stored
[in, out] (HF stores [out, in], so it is transposed) and stacked over
layers; the loaders return dense weights in the config's dtype on the
device (the card unless one is named). Serving quantized weights is
the family's `quantize_params` then its `prepare_params` on the result
(llama's for the families without their own).

safetensors files are read by a reader of the port's own (`read_safetensors`:
an 8-byte little-endian header length, a JSON header, then the raw
little-endian tensors), so no `safetensors` package is needed. DeepSeek
V2 and the VL variants (another router), and gemma-1, raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import ModelConfig

Params = Dict[str, Any]

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


def _dtype_name(dtype) -> str:
    """A dtype given as a string or a torch dtype → "bfloat16" etc."""
    name = str(dtype).replace("torch.", "")
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


# ---------------------------------------------------------------------------
# HF config → ModelConfig
# ---------------------------------------------------------------------------

def _gemma3_layer_types(g):
    """Gemma-3's per-layer attention kinds (checkpoint.py:52-70): newer HF
    configs carry `layer_types`; older ones only `sliding_window_pattern`
    N, every Nth layer full attention. Neither raises: reading the config
    as all-sliding would cap every layer at the window."""
    lt = g("layer_types")
    if lt:
        return tuple(lt)
    pat = g("sliding_window_pattern")
    if pat:
        L = g("num_hidden_layers")
        return tuple("full_attention" if (i + 1) % int(pat) == 0
                     else "sliding_attention" for i in range(L))
    raise ValueError(
        "gemma3 config carries neither layer_types nor "
        "sliding_window_pattern: cannot derive the sliding/full layout")


def model_config_from_hf(hf_cfg) -> ModelConfig:
    """A ModelConfig from a transformers config object or its dict
    (checkpoint.py:72-174). The name is the HF model_type, which the
    registry resolves ("gemma3_text" → gemma3, "deepseek_v3" →
    deepseek). DeepSeek V2 and the VL variants, and gemma-1, raise
    NotImplementedError."""
    def g(k, d=None):
        if isinstance(hf_cfg, dict):
            return hf_cfg.get(k, d)
        return getattr(hf_cfg, k, d)
    family = str(g("model_type", "llama"))
    if family.startswith("deepseek") and family != "deepseek_v3":
        # V2's router is a softmax without the correction bias, and the VL
        # variants are no text decoders (checkpoint.py:106-114)
        raise NotImplementedError(
            f"model_type {family!r} is not ported: only deepseek_v3 is "
            "served")
    gemma3 = family in ("gemma3", "gemma3_text")
    if family.startswith("gemma") and family != "gemma2" and not gemma3:
        raise NotImplementedError(
            f"model_type {family!r}: gemma2/gemma3 are wired (gemma-1 "
            f"lacks the sandwich norms)")
    gemma = family == "gemma2" or gemma3
    num_heads = g("num_attention_heads")
    hidden = g("hidden_size")
    rope_scaling = g("rope_scaling")
    if rope_scaling is not None and not isinstance(rope_scaling, dict):
        rope_scaling = dict(rope_scaling)
    if rope_scaling and (rope_scaling.get("type")
                         or rope_scaling.get("rope_type")) == "longrope":
        # phi3 keeps the longrope magnitude inputs at the top level of the
        # config: fold them into the scaling dict ops/rope.py reads
        rope_scaling = dict(rope_scaling)
        rope_scaling.setdefault("max_position_embeddings",
                                g("max_position_embeddings", 4096))
        rope_scaling.setdefault(
            "original_max_position_embeddings",
            g("original_max_position_embeddings", 4096))
    moe_kw = {}
    if family == "mixtral":
        moe_kw = dict(num_experts=g("num_local_experts", 8),
                      experts_per_token=g("num_experts_per_tok", 2))
    if family == "deepseek_v3":
        moe_kw = dict(
            num_experts=g("n_routed_experts", 0) or 0,
            experts_per_token=g("num_experts_per_tok", 8) or 8,
            q_lora_rank=g("q_lora_rank") or 0,
            kv_lora_rank=g("kv_lora_rank"),
            qk_nope_head_dim=g("qk_nope_head_dim"),
            qk_rope_head_dim=g("qk_rope_head_dim"),
            v_head_dim=g("v_head_dim"),
            rope_interleave=bool(g("rope_interleave", False)),
            n_shared_experts=g("n_shared_experts", 0) or 0,
            moe_intermediate_size=g("moe_intermediate_size", 0) or 0,
            n_group=g("n_group", 1) or 1,
            topk_group=g("topk_group", 1) or 1,
            routed_scaling_factor=g("routed_scaling_factor", 1.0) or 1.0,
            norm_topk_prob=bool(g("norm_topk_prob", True)),
            first_k_dense=g("first_k_dense_replace", 0) or 0)
        if rope_scaling and (rope_scaling.get("rope_type")
                             or rope_scaling.get("type")) == "yarn":
            # HF yarn falls back to max_position_embeddings when the
            # original length is absent: the resolved value goes in
            rope_scaling = dict(rope_scaling)
            rope_scaling.setdefault("original_max_position_embeddings",
                                    g("max_position_embeddings", 4096))
    return ModelConfig(
        name=family,
        vocab_size=g("vocab_size"),
        hidden_size=hidden,
        intermediate_size=g("intermediate_size"),
        num_layers=g("num_hidden_layers"),
        num_heads=num_heads,
        num_kv_heads=g("num_key_value_heads") or num_heads,
        head_dim=g("head_dim") or hidden // num_heads,
        rope_theta=g("rope_theta", 10000.0),
        max_position_embeddings=g("max_position_embeddings", 4096),
        rms_norm_eps=g("rms_norm_eps", 1e-5),
        tie_word_embeddings=bool(g("tie_word_embeddings", gemma)),
        rope_scaling=rope_scaling,
        # qwen2-style configs carry a window behind use_sliding_window
        sliding_window=(g("sliding_window") or 0)
        if g("use_sliding_window", True) else 0,
        sliding_pattern="alternating" if (gemma and not gemma3) else "all",
        layer_types=_gemma3_layer_types(g) if gemma3 else None,
        rope_local_theta=(g("rope_local_base_freq") or 0.0) if gemma3
        else 0.0,
        # HF Qwen2 has q/k/v biases and no attention_bias key; Qwen3 has
        # the key, default False
        qkv_bias=bool(g("attention_bias", family.startswith("qwen2"))),
        qk_norm=family == "qwen3" or gemma3,
        attn_logit_softcap=g("attn_logit_softcapping") or 0.0,
        final_logit_softcap=g("final_logit_softcapping") or 0.0,
        query_pre_attn_scalar=g("query_pre_attn_scalar") or 0.0,
        scale_embeddings=gemma,
        **moe_kw,
    )


# ---------------------------------------------------------------------------
# HF state dict → params
# ---------------------------------------------------------------------------

def _as_float_tensor(x) -> torch.Tensor:
    """A torch tensor or numpy array → a CPU torch tensor; float16/32 and
    bfloat16 stay as they are, other types become float32."""
    t = x.detach().cpu() if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x))
    if t.dtype not in (torch.float16, torch.float32, torch.bfloat16):
        t = t.to(torch.float32)
    return t


def convert_hf_state_dict(cfg: ModelConfig, sd: Dict[str, Any], dtype=None,
                          device=None) -> Params:
    """An HF state dict (name → torch tensor or numpy array, keys with or
    without a leading "model.") → the port's dense params in `dtype`
    (default cfg.dtype) on `device` (checkpoint.py:187-297): phi3's fused
    qkv_proj and gate_up_proj split into wq/wk/wv and w_gate/w_up, qwen2's
    q/k/v biases, qwen3's and gemma3's q_norm and k_norm, gemma's sandwich
    norms (post_attention_layernorm is the post norm of the attention,
    pre_feedforward_layernorm the FFN's norm), mixtral's router [L, H, E]
    and experts (w1/w3/w2 → e_gate/e_up/e_down [L, E, K, N]); a DeepSeek
    config goes to deepseek.convert_hf_state_dict."""
    from llm_inference_tpu_torch.models import deepseek
    if deepseek.is_deepseek(cfg):
        return deepseek.convert_hf_state_dict(cfg, sd, dtype, device)
    device = resolve_device(device)
    tdt = _TORCH_DTYPES[_dtype_name(dtype or cfg.dtype)]
    sd = {(k[6:] if k.startswith("model.") else k): v for k, v in sd.items()}

    def get(name):
        if name not in sd:
            raise KeyError(f"missing weight {name!r}; have e.g. "
                           f"{sorted(sd)[:5]}")
        return _as_float_tensor(sd[name])

    head = cfg.name.split("-")[0]
    gemma = head.startswith("gemma")
    phi3 = head == "phi3"
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    I = cfg.intermediate_size
    # ours → (HF key, rows [a, b) of the [out, in] tensor, or None)
    moe = cfg.num_experts > 0
    keys = {"attn_norm": ("input_layernorm.weight", None),
            "wo": ("self_attn.o_proj.weight", None)}
    if not moe:
        keys["w_down"] = ("mlp.down_proj.weight", None)
    if phi3:
        qkv = "self_attn.qkv_proj.weight"
        keys.update(wq=(qkv, (0, nq)), wk=(qkv, (nq, nq + nkv)),
                    wv=(qkv, (nq + nkv, nq + 2 * nkv)),
                    w_gate=("mlp.gate_up_proj.weight", (0, I)),
                    w_up=("mlp.gate_up_proj.weight", (I, 2 * I)))
    else:
        keys.update({w: (f"self_attn.{p}_proj.weight", None)
                     for w, p in (("wq", "q"), ("wk", "k"), ("wv", "v"))})
        if not moe:
            keys.update(w_gate=("mlp.gate_proj.weight", None),
                        w_up=("mlp.up_proj.weight", None))
    if moe:
        keys["router"] = ("block_sparse_moe.gate.weight", None)
    if cfg.qkv_bias:
        keys.update({b: (f"self_attn.{p}_proj.bias", None)
                     for b, p in (("bq", "q"), ("bk", "k"), ("bv", "v"))})
    if cfg.qk_norm:
        keys.update(q_norm=("self_attn.q_norm.weight", None),
                    k_norm=("self_attn.k_norm.weight", None))
    if gemma:
        keys.update(post_attn_norm=("post_attention_layernorm.weight", None),
                    ffn_norm=("pre_feedforward_layernorm.weight", None),
                    post_ffn_norm=("post_feedforward_layernorm.weight", None))
    else:
        keys["ffn_norm"] = ("post_attention_layernorm.weight", None)

    def stacked(hf, rows):
        out = []
        for i in range(cfg.num_layers):
            t = get(f"layers.{i}.{hf}")
            if rows is not None:
                t = t[rows[0]:rows[1]]
            out.append(t.T if t.dim() == 2 else t)   # [out, in] → [in, out]
        return torch.stack(out).to(tdt).contiguous().to(device)

    layers = {ours: stacked(hf, rows) for ours, (hf, rows) in keys.items()}
    if moe:
        # mixtral's sparse MoE block: per-expert w1 (gate), w3 (up), w2
        # (down), [out, in] each → [L, E, in, out]
        for ours, w in (("e_gate", "w1"), ("e_up", "w3"), ("e_down", "w2")):
            layers[ours] = torch.stack([torch.stack([
                get(f"layers.{i}.block_sparse_moe.experts.{e}.{w}.weight").T
                for e in range(cfg.num_experts)])
                for i in range(cfg.num_layers)]).to(tdt).contiguous().to(
                    device)
    params: Params = {
        "embed": get("embed_tokens.weight").to(tdt).to(device),
        "layers": layers,
        "final_norm": get("norm.weight").to(tdt).to(device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight").T.to(tdt).contiguous().to(
            device)
    return params


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file as a CPU torch tensor: an
    8-byte little-endian header length N, N bytes of JSON naming each
    tensor's dtype, shape and [begin, end) byte range after the header,
    then the raw little-endian data."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, "
                             "which the reader does not take")
        begin, end = meta["data_offsets"]
        np_dt = np.dtype(_ST_DTYPES[meta["dtype"]]).newbyteorder("<")
        arr = np.frombuffer(data[begin:end], dtype=np_dt).reshape(
            meta["shape"]).astype(np_dt.newbyteorder("="))   # a copy
        t = torch.from_numpy(arr)
        if meta["dtype"] == "BF16":
            t = t.view(torch.bfloat16)
        out[name] = t
    return out


def load_hf_checkpoint(path: str, dtype=None,
                       device=None) -> Tuple[ModelConfig, Params]:
    """config.json and every *.safetensors file of an HF model directory →
    (config, dense params in `dtype` on `device`). An explicit dtype is
    also the config's activation dtype."""
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = model_config_from_hf(json.load(f))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=_dtype_name(dtype))
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    sd: Dict[str, torch.Tensor] = {}
    for fn in files:
        sd.update(read_safetensors(os.path.join(path, fn)))
    return cfg, convert_hf_state_dict(cfg, sd, dtype, device)


# ---------------------------------------------------------------------------
# The reference engine's raw .bin directory (one row-major file a tensor)
# ---------------------------------------------------------------------------

_REF_DTYPES = {"fp32": np.float32, "fp16": np.float16}


def load_reference_bin_dir(cfg: ModelConfig, path: str, dtype=None,
                           file_dtype: str = "fp32", device=None) -> Params:
    """The reference engine's weight directory: raw row-major files named
    by HF key, [out, in] each, qkv and gate-up fused
    (model.layers.N.self_attn.qkv.weight.bin, ...mlp.gate_up_proj...).
    Returns dense params in `dtype` (default cfg.dtype) on `device`."""
    device = resolve_device(device)
    np_dt = _REF_DTYPES[file_dtype]
    tdt = _TORCH_DTYPES[_dtype_name(dtype or cfg.dtype)]
    H, I = cfg.hidden_size, cfg.intermediate_size
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim

    def rd(name, shape):
        fn = os.path.join(path, name + ".bin")
        arr = np.fromfile(fn, dtype=np_dt)
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{fn}: got {arr.size} elements, want {shape}")
        return torch.from_numpy(arr.reshape(shape).astype(np.float32))

    layers = {k: [] for k in ("attn_norm", "wq", "wk", "wv", "wo",
                              "ffn_norm", "w_gate", "w_up", "w_down")}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layers["attn_norm"].append(rd(p + "input_layernorm.weight", (H,)))
        qkv = rd(p + "self_attn.qkv.weight", (cfg.qkv_out_dim, H)).T
        layers["wq"].append(qkv[:, :hq])
        layers["wk"].append(qkv[:, hq:hq + hkv])
        layers["wv"].append(qkv[:, hq + hkv:])
        layers["wo"].append(rd(p + "self_attn.o_proj.weight", (H, hq)).T)
        layers["ffn_norm"].append(
            rd(p + "post_attention_layernorm.weight", (H,)))
        gate_up = rd(p + "mlp.gate_up_proj.weight", (2 * I, H)).T
        layers["w_gate"].append(gate_up[:, :I])
        layers["w_up"].append(gate_up[:, I:])
        layers["w_down"].append(rd(p + "mlp.down_proj.weight", (H, I)).T)

    def put(t):
        return t.to(tdt).contiguous().to(device)

    params: Params = {
        "embed": put(rd("model.embed_tokens.weight", (cfg.vocab_size, H))),
        "layers": {k: put(torch.stack(v)) for k, v in layers.items()},
        "final_norm": put(rd("model.norm.weight", (H,))),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(rd("lm_head.weight", (cfg.vocab_size, H)).T)
    return params


def save_reference_bin_dir(cfg: ModelConfig, params: Params, path: str,
                           file_dtype: str = "fp32") -> None:
    """Dense params (unfused wq/wk/wv, w_gate/w_up) in the reference
    engine's .bin directory format, the inverse of
    load_reference_bin_dir."""
    np_dt = _REF_DTYPES[file_dtype]
    os.makedirs(path, exist_ok=True)

    def wr(name, t):
        t.detach().to(torch.float32).cpu().contiguous().numpy().astype(
            np_dt).tofile(os.path.join(path, name + ".bin"))

    lay = params["layers"]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        wr(p + "input_layernorm.weight", lay["attn_norm"][i])
        qkv = torch.cat([lay["wq"][i], lay["wk"][i], lay["wv"][i]], dim=1)
        wr(p + "self_attn.qkv.weight", qkv.T)
        wr(p + "self_attn.o_proj.weight", lay["wo"][i].T)
        wr(p + "post_attention_layernorm.weight", lay["ffn_norm"][i])
        gate_up = torch.cat([lay["w_gate"][i], lay["w_up"][i]], dim=1)
        wr(p + "mlp.gate_up_proj.weight", gate_up.T)
        wr(p + "mlp.down_proj.weight", lay["w_down"][i].T)
    wr("model.embed_tokens.weight", params["embed"])
    wr("model.norm.weight", params["final_norm"])
    if "lm_head" in params:
        wr("lm_head.weight", params["lm_head"].T)
