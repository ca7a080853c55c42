"""The parameters and KV cache of one tensor-parallel rank (counterpart of
`llm_inference_tpu/parallel/sharding.py`: validate_tp :317, the per-leaf
rule of _spec_for_tp :64-126, shard_params :298 and cache_pspec :285).

Megatron-style, as the JAX package lays it out:
- column-sharded weights (wq, wk, wv, w_gate, w_up, their fused wqkv and
  w_gateup, and lm_head) keep the rank's slice of the output columns:
  rows of the port's codes [.., N, K'] and of the scales (int8 [.., 1, N]
  on their last axis, int4 [.., N, G] on their rows). Fused weights must
  come from fuse_params(tp_size=tp) (models/llama.py), whose columns are
  interleaved per rank, so a contiguous slice is [q_r | k_r | v_r] or
  [gate_r | up_r];
- row-sharded weights (wo, w_down) keep the rank's slice of the input
  rows: the last axis of the codes (whole bytes of int4 codes), and the
  group axis of grouped int4 scales, which raises when the group count
  does not divide tp (replicated scales would meet the wrong rows,
  sharding.py:113-122); per-channel scales replicate;
- embed keeps its vocab rows, biases and dense weights their column or row
  axis as above;
- norms and anything else replicate.
The rank's KV cache holds num_kv_heads // tp heads (`local_kv_heads`).
Each slice is a contiguous copy, so the kernels see the layouts they take
and the full parameters can be dropped.
"""

from __future__ import annotations

from llm_inference_tpu_torch.config import ModelConfig
from llm_inference_tpu_torch.ops.quantization import QTensor

_COL_SHARDED = {"wq", "wk", "wv", "w_gate", "w_up", "wqkv", "w_gateup"}
_ROW_SHARDED = {"wo", "w_down"}
_BIASES = {"bq", "bk", "bv", "bqkv"}


# the refusal of every entry point that would shard a mixture-of-experts
# model (mixtral, DeepSeek) over ranks
EP_NOT_PORTED = ("expert parallelism (--tp > 1 on a mixture-of-experts "
                 "model) is not ported yet (ROADMAP.md queue 1, item 10)")


def validate_tp(cfg: ModelConfig, tp_size: int) -> None:
    """The divisibility the sharding rules assume (sharding.py:317-336).
    A mixture-of-experts model (mixtral, DeepSeek) at tp_size > 1 raises
    NotImplementedError: its expert parallelism is not ported."""
    if tp_size > 1 and (cfg.num_experts > 0 or cfg.kv_lora_rank > 0):
        raise NotImplementedError(f"{cfg.name}: {EP_NOT_PORTED}")
    checks = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
              "vocab_size": cfg.vocab_size,
              "intermediate_size": cfg.intermediate_size}
    for name, v in checks.items():
        if v % tp_size:
            raise ValueError(f"{name}={v} not divisible by tp={tp_size}")


def local_kv_heads(cfg: ModelConfig, tp_size: int) -> int:
    """KV heads of one rank's cache (cache_pspec: heads over tensor)."""
    return cfg.num_kv_heads // tp_size


def _slice(t, dim: int, rank: int, size: int, what: str):
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"{what}: axis {dim} of {tuple(t.shape)} does not "
                         f"split over tp={size}")
    return t.narrow(dim, rank * (n // size), n // size).contiguous()


def _shard_qtensor(name: str, qt: QTensor, rank: int, size: int) -> QTensor:
    if name in _ROW_SHARDED:
        G = qt.groups
        scale = qt.scale
        if qt.bits == 4 and G > 1:
            if G % size:
                raise ValueError(
                    f"{name}: {G} quant groups do not divide tp={size} for "
                    f"a row-sharded weight — pick a group_size giving a "
                    f"tp-divisible group count")
            scale = _slice(scale, -1, rank, size, name)
        return QTensor(q=_slice(qt.q, -1, rank, size, name), scale=scale,
                       bits=qt.bits)
    # column-sharded: output columns are the codes' rows
    sdim = -2 if qt.bits == 4 else -1
    return QTensor(q=_slice(qt.q, -2, rank, size, name),
                   scale=_slice(qt.scale, sdim, rank, size, name),
                   bits=qt.bits)


def _shard_leaf(name: str, leaf, rank: int, size: int):
    col = name in _COL_SHARDED or name == "lm_head"
    if isinstance(leaf, QTensor):
        if col or name in _ROW_SHARDED:
            return _shard_qtensor(name, leaf, rank, size)
        return leaf
    if name == "embed":
        return _slice(leaf, 0, rank, size, name)        # vocab rows
    if col or name in _BIASES:
        return _slice(leaf, -1, rank, size, name)       # columns
    if name in _ROW_SHARDED:
        return _slice(leaf, -2, rank, size, name)       # [L, K, H] rows
    return leaf                                         # norms: replicated


def shard_params(params, rank: int, size: int):
    """This rank's parameters: every leaf of the model's parameter dict
    (module docstring) sliced for rank `rank` of `size`."""
    if size == 1:
        return params
    out = {}
    for name, leaf in params.items():
        if name == "layers":
            out[name] = {k: _shard_leaf(k, v, rank, size)
                         for k, v in leaf.items()}
        else:
            out[name] = _shard_leaf(name, leaf, rank, size)
    return out
