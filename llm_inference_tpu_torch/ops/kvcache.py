"""Dense KV cache: layout, init and in-place update (counterpart of
`llm_inference_tpu/ops/kvcache.py`).

Both caches are [layers, batch, kv_heads, max_seq, head_dim] (a family
may give k and v rows different widths: DeepSeek's latent cache,
models/deepseek.new_cache). An int8
cache holds codes there and per-(slot, head) float32 scales SLOT-MAJOR,
[layers, batch, max_seq, kv_heads], as the JAX package does, so the two
compare element for element. An int4 cache (bits 4) holds the packed
codes of quantization.quantize_kv4, [layers, batch, kv_heads, max_seq,
head_dim / 2], with the same scales. Where the JAX package threads the
cache functionally and relies on buffer donation, the port writes the
tensors in place. The model's layers write through
`rope_update_cache_layer`: the RoPE of q and k and the write of k and v
in any kind, quantized where the cache is, in one launch for every T
(kv_write.rope_write). `update_cache_layer` writes rows that are already
rotated (a model with qk-norm, or float32 activations): a decode step
(T == 1) is one launch for the whole batch (K3, or K4 which quantizes
too; an int4 cache quantizes in plain PyTorch, as XLA does in the JAX
package, then writes the packed rows with K3 and the scales with
`write_token_scales`); a prefill write (T > 1) is one in-place slice
write per sequence, of codes and scales after the plain quantizer for a
quantized cache. Offsets are per sequence."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.ops.kernels import kv_write
from llm_inference_tpu_torch.ops.quantization import quantize_kv4


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
    """Write T new tokens per sequence (k_new [B, T, Hkv, Dk], v_new [B,
    T, Hkv, Dv]) into ONE layer of the stacked cache at offsets[b], in
    place. k and v rows may differ in width (DeepSeek's latent cache:
    576-wide k rows, 512-wide v rows); each is quantized over its own."""
    if k_new.shape[1] == 1:
        kt, vt = k_new.transpose(1, 2), v_new.transpose(1, 2)
        if cache.bits == 8:
            kv_write.quantize_write_token(cache.k, cache.v, cache.k_scale,
                                          cache.v_scale, layer, kt, vt,
                                          offsets)
        elif cache.bits == 4:
            # K and V quantized apart, as the JAX package does
            # (kvcache.py:160-162): their rows may differ in width
            (kq, ks), (vq, vs) = quantize_kv4(kt), quantize_kv4(vt)
            kv_write.write_token(cache.k, cache.v, layer, kq, vq, offsets)
            # scales [B, Hkv, 1, 1] → one slot-major row [B, 1, Hkv]
            kv_write.write_token_scales(cache.k_scale, cache.v_scale, layer,
                                        ks[..., 0].transpose(1, 2),
                                        vs[..., 0].transpose(1, 2),
                                        offsets)
        else:
            kv_write.write_token(cache.k, cache.v, layer, kt, vt, offsets)
        return cache
    kv_write.window_write_ref(cache.k, cache.v, cache.k_scale, cache.v_scale,
                              layer, k_new, v_new, offsets, cache.bits)
    return cache


def rope_update_cache_layer(cache: KVCache, layer: int, q: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor,
                            offsets: torch.Tensor) -> torch.Tensor:
    """The RoPE on q [B, T, H, D] and k_new [B, T, Hkv, D], both unrotated,
    at the rows cos/sin [B, T, D] gathered at the positions, then
    update_cache_layer's write of the rotated k_new and of v_new into ONE
    layer, in place, in one launch for every T (kv_write.rope_write;
    kv_write.rope_supports says which rows and caches it takes). Returns
    the rotated q [B, T, H, D]."""
    return kv_write.rope_write(q, k_new, v_new, cos, sin, offsets, cache.k,
                               cache.v, layer, cache.k_scale, cache.v_scale,
                               cache.bits)
