"""The port's LLaMA forward against the JAX package's, on the CPU: the
slice's configuration at tiny width (int8 weights with an int8 lm_head,
head_dim 64 and a 128-slot bf16 cache, so the JAX side runs its K1-K3
Pallas kernels in interpret mode and the port its plain versions)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.config import QuantConfig as JQuantConfig
from llm_inference_tpu.config import tiny_llama as j_tiny_llama
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.ops import kvcache as j_kv

from llm_inference_tpu_torch.config import QuantConfig, tiny_llama
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache
from llm_inference_tpu_torch.ops.quantization import QTensor

from torch_bridge import to_numpy_tree

S = 128
# logits leave the lm_head kernel as bf16: one bf16 step of |logit| ≲ 1 is
# 2^-8, and inputs that differ by a rounding step upstream may move a
# logit by a few such steps
LOGIT_ATOL = 1e-2


@pytest.fixture(scope="module")
def models():
    jcfg = j_tiny_llama(head_dim=64)
    cfg = tiny_llama(head_dim=64)
    for f in dataclasses.fields(cfg):           # the port's config copy
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    dense = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    qp = j_llama.quantize_params(
        dense, JQuantConfig(weights="int8", quantize_embedding=True))
    jprep = j_llama.prepare_params(qp, donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    return jcfg, cfg, dense, qp, jprep, tprep


def _inputs(cfg, B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    last = np.array([T - 1, T // 2], np.int32)[:B]
    return ids, pos, last


def test_prefill_and_teacher_forced_decode_match_jax(models):
    jcfg, cfg, _, _, jprep, tprep = models
    ids, pos, last = _inputs(cfg)
    B, T = ids.shape
    jc = j_kv.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                         cfg.head_dim, jnp.bfloat16)
    tc = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                            cfg.head_dim, torch.bfloat16)
    jlog, jc = j_llama.forward(jcfg, jprep, jnp.asarray(ids),
                               jnp.asarray(pos), jc,
                               last_idx=jnp.asarray(last))
    tlog, tc = llama.forward(cfg, tprep, torch.from_numpy(ids),
                             torch.from_numpy(pos), tc,
                             last_idx=torch.from_numpy(last))
    assert tlog.shape == (B, cfg.vocab_size) and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tc.k.float().numpy(),
                               np.asarray(jc.k, np.float32), atol=2e-2)
    # 8 decode steps, both fed JAX's greedy tokens; rows at different
    # positions (per-row offsets through K2 and K3)
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    nxt = (last + 1).astype(np.int32)
    for _ in range(8):
        jlog, jc = j_llama.forward(jcfg, jprep, jnp.asarray(tok[:, None]),
                                   jnp.asarray(nxt[:, None]), jc)
        tlog, tc = llama.forward(cfg, tprep, torch.from_numpy(tok[:, None]),
                                 torch.from_numpy(nxt[:, None]), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        nxt = nxt + 1


def test_dense_weights_forward_matches_jax(models):
    """Unquantized weights take the unfused layer path on both sides."""
    jcfg, cfg, dense, _, _, _ = models
    tparams = llama.params_from_numpy(to_numpy_tree(dense), cfg, "cpu")
    ids, pos, _ = _inputs(cfg, B=1, T=8, seed=1)
    jc = j_kv.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, S,
                         cfg.head_dim, jnp.bfloat16)
    tc = kvcache.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, S,
                            cfg.head_dim, torch.bfloat16)
    jlog, jc = j_llama.forward(jcfg, dense, jnp.asarray(ids),
                               jnp.asarray(pos), jc)
    tlog, tc = llama.forward(cfg, tparams, torch.from_numpy(ids),
                             torch.from_numpy(pos), tc)
    # float32 activations over a bf16 cache: float32 summation order only,
    # plus the odd bf16 rounding step of a cached K/V
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-3)
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    jlog, _ = j_llama.forward(jcfg, dense, jnp.asarray(tok),
                              jnp.full((1, 1), 8, jnp.int32), jc)
    tlog, _ = llama.forward(cfg, tparams, torch.from_numpy(tok),
                            torch.full((1, 1), 8, dtype=torch.int32), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-3)


def test_quantize_and_fuse_params_match_jax(models):
    """The port's quantize_params + prepare_params give the JAX package's
    codes and scales, in the fused column order [q|k|v], [gate|up]."""
    _, cfg, dense, _, jprep, _ = models
    tparams = llama.params_from_numpy(to_numpy_tree(dense), cfg, "cpu")
    tq = llama.quantize_params(tparams, QuantConfig(
        weights="int8", quantize_embedding=True))
    tprep = llama.prepare_params(tq)
    want = to_numpy_tree(jprep)
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        got = tprep["layers"][name]
        np.testing.assert_array_equal(got.q.transpose(1, 2).numpy(),
                                      want["layers"][name]["q"])
        np.testing.assert_array_equal(got.scale.numpy(),
                                      want["layers"][name]["scale"])
    np.testing.assert_array_equal(tprep["lm_head"].q.T.numpy(),
                                  want["lm_head"]["q"])


def test_init_params_quantized_serves(models):
    _, cfg, _, _, _, _ = models
    qcfg = QuantConfig(weights="int8", quantize_embedding=True)
    p = llama.init_params_quantized(cfg, qcfg, seed=3, device="cpu")
    wq = p["layers"]["wq"]
    assert isinstance(wq, QTensor) and wq.q.is_contiguous()
    assert wq.q.dtype == torch.int8 and wq.shape == (
        cfg.hidden_size, cfg.num_heads * cfg.head_dim)
    assert p["lm_head"].shape == (cfg.hidden_size, cfg.vocab_size)
    prep = llama.prepare_params(p)
    assert prep["layers"]["wqkv"].shape == (cfg.hidden_size, cfg.qkv_out_dim)
    c = kvcache.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, S,
                           cfg.head_dim, torch.bfloat16)
    ids = torch.arange(5, dtype=torch.int32)[None]
    logits, _ = llama.forward(cfg, prep, ids, ids, c)
    assert logits.shape == (1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    with pytest.raises(NotImplementedError):
        llama.init_params_quantized(cfg, QuantConfig(weights="int4"),
                                    device="cpu")


def test_params_from_numpy_bf16_bits():
    import ml_dtypes
    a = (np.arange(12, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16)
    cfg = tiny_llama(vocab_size=3, hidden_size=4)
    p = llama.params_from_numpy({"embed": a.reshape(3, 4)}, cfg, "cpu")
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["embed"].float().numpy(),
                                  a.astype(np.float32).reshape(3, 4))


@pytest.mark.parametrize("variant", [
    dict(qkv_bias=True), dict(qk_norm=True), dict(sliding_window=8),
    dict(attn_logit_softcap=20.0, final_logit_softcap=5.0),
    dict(tie_word_embeddings=True)],
    ids=["qkv_bias", "qk_norm", "window", "softcaps", "tied"])
def test_config_variants_match_jax(variant):
    """The LLaMA-family switches the forward reads, int8 weights, all-token
    logits for the prefill, then two decode steps past the prompt."""
    jcfg = j_tiny_llama(head_dim=64, **variant)
    cfg = tiny_llama(head_dim=64, **variant)
    rng = np.random.default_rng(9)
    dense = j_llama.init_params(jcfg, jax.random.PRNGKey(2))
    layers = dict(dense["layers"])
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in layers:     # zeros/ones at init: make them count
            shape = layers[name].shape
            base = 1.0 if "norm" in name else 0.0
            layers[name] = jnp.asarray(
                base + 0.1 * rng.standard_normal(shape), jnp.float32)
    dense = dict(dense, layers=layers)
    qp = j_llama.quantize_params(dense, JQuantConfig(
        weights="int8", quantize_embedding=not cfg.tie_word_embeddings))
    jprep = j_llama.prepare_params(qp, donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    ids, pos, _ = _inputs(cfg, seed=4)
    B, T = ids.shape
    jc = j_kv.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                         cfg.head_dim, jnp.bfloat16)
    tc = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                            cfg.head_dim, torch.bfloat16)
    jlog, jc = j_llama.forward(jcfg, jprep, jnp.asarray(ids),
                               jnp.asarray(pos), jc, logits_mode="all")
    tlog, tc = llama.forward(cfg, tprep, torch.from_numpy(ids),
                             torch.from_numpy(pos), tc, logits_mode="all")
    assert tlog.shape == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=0)
    tok = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)
    for step in range(2):
        p = np.full((B, 1), T + step, np.int32)
        jlog, jc = j_llama.forward(jcfg, jprep, jnp.asarray(tok[:, None]),
                                   jnp.asarray(p), jc)
        tlog, tc = llama.forward(cfg, tprep, torch.from_numpy(tok[:, None]),
                                 torch.from_numpy(p), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
