"""Test helper (not collected): hands the JAX package's parameters,
KV caches and arrays to the PyTorch port through numpy.

JAX QTensors become {"q", "scale", "bits"} (un-blocked with
quantization.from_blocked): int8 row-major codes [..., K, N] with float32
scales [..., G, N] (G = 1 per channel), or split-half packed int4 codes
[..., K/2, N] with float32 scales [..., G, N] and "block_rows", the packed
rows of a pack block (one block, or one per rank of
quantize_params(row_shards=)); an asymmetric weight adds "zbias" in the
scales' shape — the form
`llm_inference_tpu_torch.models.llama.params_from_numpy` takes. A JAX
KVCache (bf16, int8, or packed int4 codes with slot-major float32 scales)
becomes the port's KVCache in the same layout (`cache_to_torch`), and a
PagedKVCache the port's PagedKVCache (`paged_cache_to_torch`).
`assert_streams_agree` compares two schedulers' greedy streams, and
`engine_pair` builds a JAX and a port engine on the same tiny weights.
"""

from __future__ import annotations

import numpy as np
import torch

from llm_inference_tpu.ops.quantization import QTensor, from_blocked


def to_numpy_tree(params):
    """JAX params pytree → nested dicts of numpy arrays."""
    if isinstance(params, QTensor):
        qt = from_blocked(params)
        out = {"q": np.asarray(qt.q), "scale": np.asarray(qt.scale),
               "bits": qt.bits}
        if qt.zbias is not None:
            out["zbias"] = np.asarray(qt.zbias)
        if qt.bits == 4:
            out["block_rows"] = qt.block_rows or qt.q.shape[-2]
        return out
    if isinstance(params, dict):
        return {k: to_numpy_tree(v) for k, v in params.items()}
    return np.asarray(params)


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array → CPU torch tensor (bf16 by bit view)."""
    a = np.array(a)                      # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor → float32 numpy (bf16 widened exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def cache_to_torch(cache):
    """The JAX package's dense KVCache → the port's KVCache on the CPU:
    codes (packed int8 pairs for bits 4) and scales as they are."""
    from llm_inference_tpu_torch.ops.kvcache import KVCache
    scales = [None if a is None else to_torch(a)
              for a in (cache.k_scale, cache.v_scale)]
    return KVCache(k=to_torch(cache.k), v=to_torch(cache.v),
                   k_scale=scales[0], v_scale=scales[1], bits=cache.bits)


def paged_cache_to_torch(cache):
    """The JAX package's PagedKVCache → the port's on the CPU: pools, page
    table and scales as they are."""
    from llm_inference_tpu_torch.ops.paged_kvcache import PagedKVCache
    scales = [None if a is None else to_torch(a)
              for a in (cache.k_scale, cache.v_scale)]
    return PagedKVCache(k_pages=to_torch(cache.k_pages),
                        v_pages=to_torch(cache.v_pages),
                        page_table=to_torch(cache.page_table),
                        k_scale=scales[0], v_scale=scales[1], bits=cache.bits)


def assert_streams_agree(got, want, tol=2e-2):
    """Two runs' requests (each with top_logprobs >= 2) emitted the same
    greedy tokens up to the first step where the reference run's top-2
    logprob gap is within `tol` (a near-tie, where the streams may part);
    at least half of all tokens are compared."""
    compared = total = 0
    for g, w in zip(got, want):
        assert len(g.output_ids) == len(w.output_ids)
        total += len(w.output_ids)
        for j, top in enumerate(w.output_top_logprobs):
            if top[0][1] - top[1][1] <= tol:
                break
            assert g.output_ids[j] == w.output_ids[j], (
                j, g.output_ids, w.output_ids)
            compared += 1
    assert compared >= total // 2, (compared, total)


def engine_pair(weights="int8", kv="bf16", head_scale=64.0, seed=21,
                tokenizer=None, **ecfg):
    """A JAX InferenceEngine and the port's (on the CPU) over the same
    tiny_llama(head_dim=64) weights drawn from `seed`: "int8" (per-channel
    int8 weights and lm_head, float32 activations) or "bf16" (dense bf16
    weights). lm_head (its int8 scales, or the dense matrix) is sharpened
    `head_scale` times so that greedy streams stay far from ties. `ecfg`:
    EngineConfig fields of both; kv "bf16", "int8" or "int4"; `tokenizer`
    goes to both. Returns (jax engine, port engine)."""
    import jax
    import jax.numpy as jnp
    from llm_inference_tpu.config import EngineConfig as JEngineConfig
    from llm_inference_tpu.config import QuantConfig as JQuantConfig
    from llm_inference_tpu.config import tiny_llama as j_tiny_llama
    from llm_inference_tpu.engine.engine import InferenceEngine as JEngine
    from llm_inference_tpu.models import llama as j_llama
    from llm_inference_tpu_torch.config import EngineConfig, tiny_llama
    from llm_inference_tpu_torch.engine.engine import InferenceEngine
    from llm_inference_tpu_torch.models import llama

    kw = dict(head_dim=64)
    if weights == "bf16":
        kw["dtype"] = "bfloat16"
    jcfg, cfg = j_tiny_llama(**kw), tiny_llama(**kw)
    dense = j_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    if weights == "int8":
        qp = j_llama.quantize_params(dense, JQuantConfig(
            weights="int8", quantize_embedding=True))
        qp = dict(qp, lm_head=qp["lm_head"].replace(
            scale=qp["lm_head"].scale * head_scale))
        jprep = j_llama.prepare_params(qp, donate=False)
    else:
        jprep = j_llama.prepare_params(dict(
            dense, lm_head=dense["lm_head"] * head_scale), donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    jdt = jnp.bfloat16 if kv == "bf16" else kv
    tdt = torch.bfloat16 if kv == "bf16" else kv
    jeng = JEngine(jcfg, jprep, engine_cfg=JEngineConfig(**ecfg),
                   cache_dtype=jdt, tokenizer=tokenizer)
    teng = InferenceEngine(cfg, tprep, engine_cfg=EngineConfig(**ecfg),
                           cache_dtype=tdt, tokenizer=tokenizer,
                           device="cpu")
    return jeng, teng
