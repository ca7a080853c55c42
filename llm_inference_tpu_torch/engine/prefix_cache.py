"""Automatic prefix caching: content-addressed sharing of prompt KV pages
(counterpart of `llm_inference_tpu/engine/prefix_cache.py`, the same
hashes byte for byte).

- Every full page of a prompt gets a chain hash over all tokens from
  position 0, so equal hashes mean equal full prefixes.
- At admission the scheduler maps the longest run of cached pages into
  the request's page table, read-only, and prefills only the suffix.
- Pages stay in the store after their requests retire (refcount 0) and
  are evicted least recently used under pool pressure.

The page holding a prompt's last token is never shared: at least one
token is recomputed to give the first-token logits. The hash is 128-bit
blake2b over the token bytes, so a collision is negligible.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np


def chunk_hashes(tokens: Sequence[int], page_size: int,
                 salt: int = 0) -> List[bytes]:
    """Chain hash per full prompt page, excluding the last token's page.
    `salt` partitions the key space: the schedulers salt with the
    request's LoRA adapter slot (0, no salt, for the base model), so that
    pages are shared within one adapter and never across two."""
    aligned = ((len(tokens) - 1) // page_size) * page_size
    out: List[bytes] = []
    h = salt.to_bytes(4, "little", signed=False) if salt else b""
    for i in range(0, aligned, page_size):
        chunk = np.asarray(tokens[i:i + page_size], np.int32).tobytes()
        h = hashlib.blake2b(h + chunk, digest_size=16).digest()
        out.append(h)
    return out


class PrefixStore:
    """Hash → page-id map with per-page request refcounts and LRU
    eviction. A page is in exactly one of three places: the allocator's
    free list, privately owned by a slot, or registered here; registered
    pages with refcount 0 are reclaimable (evict)."""

    def __init__(self) -> None:
        self._by_hash: "OrderedDict[bytes, int]" = OrderedDict()  # LRU order
        self._hash_of: Dict[int, bytes] = {}
        self._refs: Dict[int, int] = {}
        self.hit_tokens = 0
        self.miss_tokens = 0

    def __len__(self) -> int:
        return len(self._by_hash)

    def owns(self, page: int) -> bool:
        return int(page) in self._hash_of

    def lookup(self, hashes: Sequence[bytes], page_size: int) -> List[int]:
        """Longest run of cached pages for this hash chain; increfs each
        returned page (the caller owns one reference until release)."""
        pages: List[int] = []
        for h in hashes:
            p = self._by_hash.get(h)
            if p is None:
                break
            self._by_hash.move_to_end(h)
            self._refs[p] += 1
            pages.append(p)
        self.hit_tokens += len(pages) * page_size
        self.miss_tokens += (len(hashes) - len(pages)) * page_size
        return pages

    def insert(self, h: bytes, page: int) -> bool:
        """Register a freshly prefilled page under its chain hash. False
        (no ownership transfer) when the hash is already present: the
        page stays private and is freed at its request's retirement."""
        page = int(page)
        if h in self._by_hash:
            return False
        self._by_hash[h] = page
        self._hash_of[page] = h
        self._refs[page] = self._refs.get(page, 0) + 1
        return True

    def release(self, page: int) -> None:
        """Drop one request reference (the page stays cached)."""
        self._refs[int(page)] -= 1
        assert self._refs[int(page)] >= 0

    def evict(self, want: int) -> List[int]:
        """Pop up to `want` least recently used unreferenced pages; the
        caller returns them to the allocator."""
        victims: List[int] = []
        for h, p in list(self._by_hash.items()):
            if len(victims) >= want:
                break
            if self._refs.get(p, 0) == 0:
                del self._by_hash[h]
                del self._hash_of[p]
                del self._refs[p]
                victims.append(p)
        return victims
