"""Dense KV cache: layout, init and in-place update (counterpart of
`llm_inference_tpu/ops/kvcache.py`).

Both caches are [layers, batch, kv_heads, max_seq, head_dim]. Where the JAX
package threads the cache functionally and relies on buffer donation, the
port writes the tensors in place: a decode step (T == 1) is one K3 launch
for the whole batch; a prefill write (T > 1) is one in-place slice write
per sequence. Offsets are per sequence.
"""

from __future__ import annotations

import dataclasses

import torch

from llm_inference_tpu_torch.ops.kernels import kv_write


@dataclasses.dataclass
class KVCache:
    """k, v: [layers, batch, kv_heads, max_seq, head_dim]."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]


def init_cache(num_layers: int, batch: int, num_kv_heads: int, max_seq: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> KVCache:
    if dtype in (torch.int8, "int8", "int4"):
        raise NotImplementedError("int8/int4 KV caches are not ported yet")
    shape = (num_layers, batch, num_kv_heads, max_seq, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def update_cache_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                       v_new: torch.Tensor, offsets: torch.Tensor) -> KVCache:
    """Write T new tokens per sequence (k_new/v_new [B, T, Hkv, D]) into
    ONE layer of the stacked cache at offsets[b], in place."""
    B, T = k_new.shape[:2]
    if T == 1:
        kv_write.write_token(cache.k, cache.v, layer,
                             k_new.transpose(1, 2), v_new.transpose(1, 2),
                             offsets)
        return cache
    S = cache.max_seq_len
    # dynamic_update_slice semantics: the window start clamps to [0, S - T]
    start = torch.clamp(offsets.reshape(B).long(), 0, S - T)
    steps = torch.arange(T, device=offsets.device)
    kn = k_new.transpose(1, 2).to(cache.k.dtype)             # [B, Hkv, T, D]
    vn = v_new.transpose(1, 2).to(cache.v.dtype)
    for b in range(B):
        idx = start[b] + steps
        cache.k[layer, b].index_copy_(1, idx, kn[b])
        cache.v[layer, b].index_copy_(1, idx, vn[b])
    return cache
