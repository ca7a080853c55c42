"""Dense KV cache: layout, init and in-place update (counterpart of
`llm_inference_tpu/ops/kvcache.py`).

Both caches are [layers, batch, kv_heads, max_seq, head_dim]. An int8
cache holds codes there and per-(slot, head) float32 scales SLOT-MAJOR,
[layers, batch, max_seq, kv_heads], as the JAX package does, so the two
compare element for element. An int4 cache (bits 4) holds the packed
codes of quantization.quantize_kv4, [layers, batch, kv_heads, max_seq,
head_dim / 2], with the same scales. Where the JAX package threads the
cache functionally and relies on buffer donation, the port writes the
tensors in place: a decode step (T == 1) is one launch for the whole batch
(K3, or K4 which quantizes too; an int4 cache quantizes in plain PyTorch,
as XLA does in the JAX package, then writes the packed rows with K3 and
the scales with `write_token_scales`); a prefill write (T > 1) is one
in-place slice write per sequence, of codes and scales after the plain
quantizer for a quantized cache. Offsets are per sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.ops.kernels import kv_write
from llm_inference_tpu_torch.ops.quantization import (quantize_kv,
                                                      quantize_kv4)


@dataclasses.dataclass
class KVCache:
    """k, v: [layers, batch, kv_heads, max_seq, head_dim]; an int8 cache
    (bits 8) adds k_scale, v_scale [layers, batch, max_seq, kv_heads]; an
    int4 cache (bits 4) holds packed codes [..., head_dim / 2] with the
    same scales."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    bits: int = 16

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(num_layers: int, batch: int, num_kv_heads: int, max_seq: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> KVCache:
    """A zeroed cache on `device` (the card unless a device is named);
    dtype is a float dtype, torch.int8 / "int8" for int8 codes with float32
    scales, or "int4" for packed int4 codes with float32 scales."""
    device = resolve_device(device)
    shape = (num_layers, batch, num_kv_heads, max_seq, head_dim)
    if dtype in (torch.int8, "int8", "int4"):
        bits = 4 if dtype == "int4" else 8
        if bits == 4:
            if head_dim % 2:
                raise ValueError(f"an int4 cache packs two dims per byte; "
                                 f"head_dim {head_dim} is odd")
            shape = shape[:-1] + (head_dim // 2,)
        sshape = (num_layers, batch, max_seq, num_kv_heads)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            bits=bits)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def update_cache_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                       v_new: torch.Tensor, offsets: torch.Tensor) -> KVCache:
    """Write T new tokens per sequence (k_new/v_new [B, T, Hkv, D]) into
    ONE layer of the stacked cache at offsets[b], in place."""
    B, T = k_new.shape[:2]
    quantize = quantize_kv4 if cache.bits == 4 else quantize_kv
    if T == 1:
        kt, vt = k_new.transpose(1, 2), v_new.transpose(1, 2)
        if cache.bits == 8:
            kv_write.quantize_write_token(cache.k, cache.v, cache.k_scale,
                                          cache.v_scale, layer, kt, vt,
                                          offsets)
        elif cache.bits == 4:
            # K and V rows quantized together (one set of launches)
            q, s = quantize(torch.stack([kt, vt]))
            kv_write.write_token(cache.k, cache.v, layer, q[0], q[1],
                                 offsets)
            # scales [B, Hkv, 1, 1] → one slot-major row [B, 1, Hkv]
            kv_write.write_token_scales(cache.k_scale, cache.v_scale, layer,
                                        s[0, ..., 0].transpose(1, 2),
                                        s[1, ..., 0].transpose(1, 2),
                                        offsets)
        else:
            kv_write.write_token(cache.k, cache.v, layer, kt, vt, offsets)
        return cache
    S = cache.max_seq_len
    # dynamic_update_slice semantics: the window start clamps to [0, S - T]
    start = torch.clamp(offsets.reshape(B).long(), 0, S - T)
    steps = torch.arange(T, device=offsets.device)
    kn = k_new.transpose(1, 2)                                # [B, Hkv, T, D]
    vn = v_new.transpose(1, 2)
    if cache.quantized:
        (kn, ks), (vn, vs) = quantize(kn), quantize(vn)
        # scales [B, Hkv, T, 1] → slot-major [B, T, Hkv]
        for s_all, s_new in ((cache.k_scale, ks), (cache.v_scale, vs)):
            s_new = s_new[..., 0].transpose(1, 2)
            for b in range(B):
                s_all[layer, b].index_copy_(0, start[b] + steps, s_new[b])
    for c_all, new in ((cache.k, kn), (cache.v, vn)):
        new = new.to(c_all.dtype)
        for b in range(B):
            c_all[layer, b].index_copy_(1, start[b] + steps, new[b])
    return cache
