"""Paged KV cache: fixed-size token pages in one pool per tensor, and a
page table per sequence (counterpart of
`llm_inference_tpu/ops/paged_kvcache.py`).

- Pools [L, P, Hkv, page_size, D] (packed int4: [.., D/2] int8): a page
  holds page_size consecutive tokens of one sequence for every kv head.
  The k and v pools may differ in width (DeepSeek's latent pool,
  models/deepseek.new_paged_cache); every write and gather here takes
  each at its own.
  A quantized pool keeps float32 scales slot-major, [L, P, page_size,
  Hkv], as the JAX package does.
- page_table [B, max_blocks] int32 maps each sequence's token blocks to
  pool pages. Page 0 is the null page: the allocator never hands it out,
  unallocated entries point at it, and it absorbs the writes of retired
  decode slots.
- Allocation is host-side (PageAllocator, a free-list stack).

The JAX package writes the pools with jnp scatters (no Pallas); the port
writes them in place with plain torch indexing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from llm_inference_tpu_torch import resolve_device
from llm_inference_tpu_torch.ops.quantization import (quantize_kv,
                                                      quantize_kv4)


@dataclasses.dataclass
class PagedKVCache:
    """k_pages, v_pages: [L, P, Hkv, page_size, D] (bits 4: [.., D/2]);
    page_table: [B, max_blocks] int32; k_scale, v_scale: [L, P,
    page_size, Hkv] float32 for a quantized pool (bits 8 or 4)."""
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    bits: int = 16

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def head_dim(self) -> int:
        return self.k_pages.shape[4] * (2 if self.bits == 4 else 1)

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def max_blocks(self) -> int:
        return self.page_table.shape[1]


def init_paged_cache(num_layers: int, num_pages: int, num_kv_heads: int,
                     page_size: int, head_dim: int, batch: int,
                     max_blocks: int, dtype=torch.bfloat16,
                     device=None) -> PagedKVCache:
    """Zeroed pools and an all-null page table on `device` (the card
    unless a device is named); dtype as for kvcache.init_cache."""
    device = resolve_device(device)
    shape = (num_layers, num_pages, num_kv_heads, page_size, head_dim)
    sshape = (num_layers, num_pages, page_size, num_kv_heads)
    pt = torch.zeros((batch, max_blocks), dtype=torch.int32, device=device)
    if dtype in (torch.int8, "int8", "int4"):
        bits = 4 if dtype == "int4" else 8
        if bits == 4:
            if head_dim % 2:
                raise ValueError(f"an int4 pool packs two dims per byte; "
                                 f"head_dim {head_dim} is odd")
            shape = shape[:-1] + (head_dim // 2,)

        def zeros(s, dt):
            return torch.zeros(s, dtype=dt, device=device)
        return PagedKVCache(k_pages=zeros(shape, torch.int8),
                            v_pages=zeros(shape, torch.int8), page_table=pt,
                            k_scale=zeros(sshape, torch.float32),
                            v_scale=zeros(sshape, torch.float32), bits=bits)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device), page_table=pt)


class PageAllocator:
    """Host-side free-list page allocator (one per pool). The first
    `reserve` pages are never handed out: page 0 is the null page."""

    def __init__(self, num_pages: int, reserve: int = 1):
        self._free: List[int] = list(range(num_pages - 1, reserve - 1, -1))
        self.num_pages = num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: Sequence[int]) -> None:
        self._free.extend(int(p) for p in pages)


def _quantize(cache: PagedKVCache, k, v):
    """K and V rows → (codes, codes, scales, scales) in the pool's kind;
    the scales drop their last unit dim. K and V quantize apart, each over
    its own width (k and v pages may differ in width: DeepSeek's latent
    pool, paged_kvcache.py:226)."""
    if not cache.quantized:
        return k.to(cache.k_pages.dtype), v.to(cache.v_pages.dtype), None, None
    qfn = quantize_kv4 if cache.bits == 4 else quantize_kv
    (kq, ks), (vq, vs) = qfn(k), qfn(v)
    return kq, vq, ks[..., 0], vs[..., 0]


def write_token(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                v_new: torch.Tensor, positions: torch.Tensor) -> PagedKVCache:
    """Decode write of one token per sequence, in place. k_new/v_new
    [B, 1, Hkv, D]; positions [B]. The block index clamps to max_blocks - 1
    (a retired slot's growing position then lands on its row's last entry,
    the null page), and non-finite values become finite BEFORE quantizing
    (paged_kvcache.py:143-158): the null page is read, masked, by live
    rows, and 0 x Inf would poison them."""
    ps = cache.page_size
    pos = positions.reshape(-1).long()
    block = torch.clamp(pos // ps, max=cache.max_blocks - 1)
    rows = pos % ps
    pages = torch.gather(cache.page_table.long(), 1, block[:, None])[:, 0]
    kq, vq, ks, vs = _quantize(cache, torch.nan_to_num(k_new[:, 0]),
                               torch.nan_to_num(v_new[:, 0]))
    cache.k_pages[layer][pages, :, rows] = kq                 # [B, Hkv, D']
    cache.v_pages[layer][pages, :, rows] = vq
    if cache.quantized:
        cache.k_scale[layer][pages, rows] = ks                # [B, Hkv]
        cache.v_scale[layer][pages, rows] = vs
    return cache


def write_prompt_batch(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                       v_new: torch.Tensor, num_blocks: int,
                       start_blocks: Optional[torch.Tensor] = None
                       ) -> PagedKVCache:
    """Prefill write, in place. k_new/v_new [B, T, Hkv, D] with T =
    num_blocks · page_size go to each sequence's table entries [start,
    start + num_blocks) (start_blocks [B], default 0: a prefix-cache suffix
    or a later chunk starts past its shared or earlier pages)."""
    B, T, H = k_new.shape[:3]
    ps = cache.page_size
    kq, vq, ks, vs = _quantize(cache, k_new, v_new)
    cols = torch.arange(num_blocks, device=k_new.device)[None]
    if start_blocks is not None:
        cols = start_blocks.reshape(B, 1).long() + cols
    pages = torch.gather(cache.page_table.long(), 1,
                         cols.expand(B, num_blocks))              # [B, nb]
    for pool, q in ((cache.k_pages, kq), (cache.v_pages, vq)):
        pool[layer][pages] = q.reshape(B, num_blocks, ps, H, -1).transpose(
            2, 3)
    if cache.quantized:
        for pool, s in ((cache.k_scale, ks), (cache.v_scale, vs)):
            pool[layer][pages] = s.reshape(B, num_blocks, ps, H)
    return cache


def gather_dense(cache: PagedKVCache, layer: int, seq: int,
                 length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A sequence's first `length` tokens of K and V as dense [Hkv,
    length, D'] tensors (codes as stored)."""
    ps = cache.page_size
    nb = (length + ps - 1) // ps
    pages = cache.page_table[seq, :nb].long()
    out = []
    for pool in (cache.k_pages, cache.v_pages):
        g = pool[layer][pages]                             # [nb, Hkv, ps, D']
        out.append(g.transpose(0, 1).reshape(g.shape[1], nb * ps,
                                             -1)[:, :length])
    return out[0], out[1]
