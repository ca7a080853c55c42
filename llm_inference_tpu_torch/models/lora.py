"""Multi-LoRA serving: batched low-rank adapters over the llama family
(counterpart of `llm_inference_tpu/models/lora.py`).

N adapters stay resident at once and every batch row may use a different
one. Each target projection gets stacked adapter factors

    A: [L, N, d_in, r]     B: [L, N, r, d_out]     (float32)

and inside a layer each row gathers its adapter by `adapter_idx` [B]; the
delta is two small batched products on top of the base projection:

    delta = (x @ A[idx_b]) @ B[idx_b]          # [B,T,d] → [B,T,r] → [B,T,o]

computed in float32, cast to the base output's dtype, then added to it.
Slot 0 is the zero adapter (the base model): a request without an
adapter indexes 0, with no row-level branching. The peft alpha / rank
scaling is baked into B at load time. The delta is plain PyTorch, as
the JAX package computes it outside any Pallas kernel (two einsums).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.config import ModelConfig
from llm_inference_tpu_torch.utils.checkpoint import read_safetensors

# target projections (HF peft naming → the parameter names)
TARGETS = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}
_DIMS = {
    "wq": lambda c: (c.hidden_size, c.num_heads * c.head_dim),
    "wk": lambda c: (c.hidden_size, c.num_kv_heads * c.head_dim),
    "wv": lambda c: (c.hidden_size, c.num_kv_heads * c.head_dim),
    "wo": lambda c: (c.num_heads * c.head_dim, c.hidden_size),
    "w_gate": lambda c: (c.hidden_size, c.intermediate_size),
    "w_up": lambda c: (c.hidden_size, c.intermediate_size),
    "w_down": lambda c: (c.intermediate_size, c.hidden_size),
}


def init_lora_stacks(cfg: ModelConfig, rank: int, n_adapters: int,
                     generator: torch.Generator,
                     targets: Sequence[str] = ("wq", "wv"),
                     scale: float = 1.0) -> Dict:
    """Random adapter stacks on the generator's device: n_adapters live
    adapters in slots 1..n, slot 0 the zero adapter. Both factors are
    random (the usual B = 0 init would make every delta vanish): A is
    N(0, 1)·scale/√d_in, B is N(0, 1)·scale/√rank."""
    L, N = cfg.num_layers, n_adapters + 1
    dev = generator.device
    stacks = {}
    for name in targets:
        d_in, d_out = _DIMS[name](cfg)
        a = torch.randn((L, N, d_in, rank), generator=generator, device=dev)
        a *= scale / np.sqrt(d_in)
        b = torch.randn((L, N, rank, d_out), generator=generator, device=dev)
        b *= scale / np.sqrt(rank)
        a[:, 0] = 0.0                    # slot 0 = the base model
        b[:, 0] = 0.0
        stacks[name] = {"a": a, "b": b}
    return stacks


def stack_adapters(cfg: ModelConfig,
                   adapters: List[Dict[str, Tuple[np.ndarray, np.ndarray]]],
                   scaling: Optional[List[float]] = None,
                   device=None) -> Dict:
    """Per-adapter factors {target: (A [L, d_in, r], B [L, r, d_out])}
    → serving stacks on `device`, slot j + 1 for adapter j and slot 0 the
    zero adapter. Ranks pad with zeros to the largest; `scaling` (peft
    alpha / r of each adapter) is baked into B."""
    device = resolve_device(device)
    names = sorted({n for ad in adapters for n in ad})
    L, N = cfg.num_layers, len(adapters) + 1
    stacks = {}
    for name in names:
        r = max(np.asarray(ad[name][0]).shape[-1]
                for ad in adapters if name in ad)
        d_in, d_out = _DIMS[name](cfg)
        a = np.zeros((L, N, d_in, r), np.float32)
        b = np.zeros((L, N, r, d_out), np.float32)
        for j, ad in enumerate(adapters):
            if name not in ad:
                continue
            aj = np.asarray(ad[name][0], np.float32)   # [L, d_in, rj]
            bj = np.asarray(ad[name][1], np.float32)   # [L, rj, d_out]
            rj = aj.shape[-1]
            a[:, j + 1, :, :rj] = aj
            b[:, j + 1, :rj, :] = bj * (scaling[j] if scaling else 1.0)
        stacks[name] = {"a": torch.from_numpy(a).to(device),
                        "b": torch.from_numpy(b).to(device)}
    return stacks


def load_peft_adapter(cfg: ModelConfig, path: str) -> Tuple[Dict, float]:
    """One HF peft directory (adapter_model.safetensors and
    adapter_config.json) → ({target: (A [L, d_in, r], B [L, r, d_out])}
    as float32 numpy, its alpha / r scaling). Keys look like
    base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight, in
    torch's [out, in] orientation (A [r, d_in], B [d_out, r]). Keys outside
    the decoder layers (modules_to_save: lm_head, embeddings) are skipped;
    the layers an adapter lacks (layers_to_transform) get zero factors."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    scaling = acfg.get("lora_alpha", 1.0) / acfg.get("r", 1)
    raw: Dict[str, dict] = {}
    tensors = read_safetensors(os.path.join(path,
                                            "adapter_model.safetensors"))
    for k, t in tensors.items():
        parts = k.split(".")
        proj = next((p for p in parts if p in TARGETS), None)
        if proj is None or "layers" not in parts:
            continue
        li = int(parts[parts.index("layers") + 1])
        which = "a" if "lora_A" in k else "b"
        raw.setdefault(TARGETS[proj], {}).setdefault(li, {})[which] = (
            t.to(torch.float32).numpy())
    out = {}
    for name, per_layer in raw.items():
        any_li = next(iter(per_layer))
        r_eff, d_in = per_layer[any_li]["a"].shape
        d_out = per_layer[any_li]["b"].shape[0]
        a_l, b_l = [], []
        for i in range(cfg.num_layers):
            if i in per_layer:
                a_l.append(per_layer[i]["a"].T)
                b_l.append(per_layer[i]["b"].T)
            else:
                a_l.append(np.zeros((d_in, r_eff), np.float32))
                b_l.append(np.zeros((r_eff, d_out), np.float32))
        out[name] = (np.stack(a_l), np.stack(b_l))
    return out, scaling


def merge_into_params(cfg: ModelConfig, params, stacks: Dict, adapter: int):
    """The dense oracle: unfused dense params with W += A·B of `adapter`
    merged into each target (the tests hold the batched deltas to it)."""
    merged = dict(params)
    layers = dict(merged["layers"])
    for name, st in stacks.items():
        w = layers[name]                       # [L, d_in, d_out] dense
        delta = torch.einsum("ldr,lro->ldo", st["a"][:, adapter],
                             st["b"][:, adapter])
        layers[name] = w + delta.to(device=w.device, dtype=w.dtype)
    merged["layers"] = layers
    return merged


def layer_view(stacks: Optional[Dict], layer: int) -> Optional[Dict]:
    """One layer's factors {target: {"a": [N, d_in, r], "b": [N, r,
    d_out]}} (views), the form apply_delta takes."""
    if stacks is None:
        return None
    return {n: {"a": st["a"][layer], "b": st["b"][layer]}
            for n, st in stacks.items()}


def apply_delta(name: str, lora_l: Optional[Dict], x: torch.Tensor,
                base_out: torch.Tensor,
                adapter_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """base_out + each row's delta of target `name`: `lora_l` is one
    layer's factors (layer_view), rows gather their adapter by
    `adapter_idx` [B]. The delta is float32 and cast to base_out's dtype
    before the add, as the JAX package adds it."""
    if lora_l is None or name not in lora_l or adapter_idx is None:
        return base_out
    a = lora_l[name]["a"][adapter_idx]                 # [B, d_in, r]
    b = lora_l[name]["b"][adapter_idx]                 # [B, r, d_out]
    B = x.shape[0]
    x3 = x.reshape(B, -1, x.shape[-1]).to(torch.float32)
    delta = torch.bmm(torch.bmm(x3, a.to(torch.float32)),
                      b.to(torch.float32))
    return base_out + delta.reshape(base_out.shape).to(base_out.dtype)
