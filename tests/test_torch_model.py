"""The port's LLaMA forward against the JAX package's, on the CPU, in the
port's configurations at tiny width: int8 weights with an int8 lm_head
over a 128-slot bf16 cache (K1-K3), int4 g=128 weights with an int4
lm_head over a 256-slot int8 cache (K1 int4, K4, K2 int8, K6) and over an
int4 cache prefilled by the JAX package (K5, the int4 decode write), and
the attention dispatch (decode kernel, flash or plain attend). The JAX
side runs its Pallas kernels in interpret mode and the port its plain
versions."""

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
from llm_inference_tpu.ops import quantization as j_quant

from llm_inference_tpu_torch.config import QuantConfig, tiny_llama
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache, quantization
from llm_inference_tpu_torch.ops.quantization import QTensor

from torch_bridge import cache_to_torch, to_numpy_tree

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
                            cfg.head_dim, torch.bfloat16, device="cpu")
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
                            cfg.head_dim, torch.bfloat16, device="cpu")
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
                           cfg.head_dim, torch.bfloat16, device="cpu")
    ids = torch.arange(5, dtype=torch.int32)[None]
    logits, _ = llama.forward(cfg, prep, ids, ids, c)
    assert logits.shape == (1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    # asymmetric int4: zero points drawn beside the scales (half a scale,
    # as the JAX package's dummy weights), served through the same forward
    pa = llama.init_params_quantized(cfg, QuantConfig(
        weights="int4", group_size=32, asymmetric=True), seed=3,
        device="cpu")
    wq = pa["layers"]["wq"]
    assert wq.zbias is not None and wq.zbias.shape == wq.scale.shape
    assert torch.equal(wq.zbias, wq.scale * 0.5)
    c = kvcache.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, S,
                           cfg.head_dim, torch.bfloat16, device="cpu")
    logits, _ = llama.forward(cfg, llama.prepare_params(pa), ids, ids, c)
    assert logits.shape == (1, cfg.vocab_size)
    assert torch.isfinite(logits).all()


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
                            cfg.head_dim, torch.bfloat16, device="cpu")
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


# ------------------------------------- int4 g=128 weights + int8 KV cache

S4 = 256
# every kernel of the path engages on the JAX side at this size: K = 256
# gives two scale groups (w_down four), the N-pair blocks need multiples
# of 256 columns, vocab 320 takes the lm_head pad, head_dim 64 over a
# 128-multiple cache takes the decode kernel
TINY4 = dict(hidden_size=256, intermediate_size=512, num_heads=4,
             num_kv_heads=2, head_dim=64, vocab_size=320, dtype="bfloat16")
QCFG4 = dict(weights="int4", group_size=128, quantize_embedding=True)


@pytest.fixture(scope="module")
def models4():
    jcfg, cfg = j_tiny_llama(**TINY4), tiny_llama(**TINY4)
    qp = j_llama.init_params_quantized(jcfg, jax.random.PRNGKey(5),
                                       JQuantConfig(**QCFG4))
    jprep = j_llama.prepare_params(qp, donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    return jcfg, cfg, jprep, tprep


@pytest.mark.parametrize("T", [16, 64], ids=["tail_kernel", "k1_chain"])
def test_int4_int8kv_prefill_and_decode_match_jax(models4, T):
    """B = 2 prompts of T tokens: 32 rows take the layer-tail kernel (K6)
    at prefill, 128 rows the K1 chain; then 8 teacher-forced decode steps
    (K1 int4, K4, K2 int8, K6) at per-row positions."""
    jcfg, cfg, jprep, tprep = models4
    ids, pos, last = _inputs(cfg, B=2, T=T, seed=7)
    B = 2
    jc = j_kv.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S4,
                         cfg.head_dim, "int8")
    tc = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S4,
                            cfg.head_dim, "int8", device="cpu")
    jlog, jc = j_llama.forward(jcfg, jprep, jnp.asarray(ids),
                               jnp.asarray(pos), jc,
                               last_idx=jnp.asarray(last))
    tlog, tc = llama.forward(cfg, tprep, torch.from_numpy(ids),
                             torch.from_numpy(pos), tc,
                             last_idx=torch.from_numpy(last))
    assert tlog.shape == (B, cfg.vocab_size) and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=0)
    # int8 codes of bf16 K rows that may differ by a rounding step: the
    # element (≤ 2^-8 of 127 steps) and the row's absmax (the scale) each
    # move a code by at most half a step, so with rounding by at most two
    assert np.abs(tc.k.numpy().astype(np.int32)
                  - np.asarray(jc.k, np.int32)).max() <= 2
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


def test_decode_over_a_bridged_int4_cache_matches_jax(models4):
    """A prompt prefilled by the JAX package into an int4 cache, carried
    across with the test bridge: two decode steps (K5 and the int4 decode
    write, plain versions here, Pallas in interpret mode there) from the
    same cache agree, and so do the caches they leave."""
    jcfg, cfg, jprep, tprep = models4
    ids, pos, last = _inputs(cfg, B=2, T=16, seed=8)
    jc = j_kv.init_cache(cfg.num_layers, 2, cfg.num_kv_heads, S4,
                         cfg.head_dim, "int4")
    jlog, jc = j_llama.forward(jcfg, jprep, jnp.asarray(ids),
                               jnp.asarray(pos), jc,
                               last_idx=jnp.asarray(last))
    tc = cache_to_torch(jc)
    assert tc.bits == 4 and tc.k.shape[-1] == cfg.head_dim // 2
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    nxt = (last + 1).astype(np.int32)
    for _ in range(2):
        jlog, jc = j_llama.forward(jcfg, jprep, jnp.asarray(tok[:, None]),
                                   jnp.asarray(nxt[:, None]), jc)
        tlog, tc = llama.forward(cfg, tprep, torch.from_numpy(tok[:, None]),
                                 torch.from_numpy(nxt[:, None]), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        nxt = nxt + 1
    # the decode writes: int4 codes of bf16 K rows that may differ by a
    # rounding step move by at most one code (of 15 steps), scales alike
    rows = np.arange(2)
    for name in ("k", "v"):
        got = quantization.unpack_kv4(getattr(tc, name)).numpy()
        want = np.asarray(j_quant.unpack_kv4(getattr(jc, name)))
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    np.testing.assert_allclose(tc.k_scale.numpy()[:, rows, nxt - 1],
                               np.asarray(jc.k_scale)[:, rows, nxt - 1],
                               rtol=2e-2)


def test_quantize_params_int4_matches_jax():
    """int4 g=128 quantize_params + prepare_params give the JAX package's
    codes and scales, fused columns [q|k|v] and [gate|up] included."""
    jcfg, cfg = j_tiny_llama(**TINY4), tiny_llama(**TINY4)
    dense = j_llama.init_params(jcfg, jax.random.PRNGKey(6))
    jprep = j_llama.prepare_params(j_llama.quantize_params(
        dense, JQuantConfig(**QCFG4)), donate=False)
    tprep = llama.prepare_params(llama.quantize_params(
        llama.params_from_numpy(to_numpy_tree(dense), cfg, "cpu"),
        QuantConfig(**QCFG4)))
    want = llama.params_from_numpy(to_numpy_tree(jprep), cfg, "cpu")
    for got, exp in [(tprep["layers"][n], want["layers"][n])
                     for n in ("wqkv", "wo", "w_gateup", "w_down")] + [
                         (tprep["lm_head"], want["lm_head"])]:
        assert got.bits == exp.bits == 4
        # JAX pads lm_head's columns (32-multiple → 512) for its N-pair
        # blocks; the padded columns are zero codes
        n = got.out_features
        assert torch.equal(got.q, exp.q[..., :n, :])
        assert torch.equal(got.scale, exp.scale[..., :n, :])
        assert not exp.q[..., n:, :].any()


def test_init_params_quantized_int4_serves():
    cfg = tiny_llama(**TINY4)
    p = llama.prepare_params(llama.init_params_quantized(
        cfg, QuantConfig(**QCFG4), seed=3, device="cpu"))
    w = p["layers"]["w_down"]
    assert w.bits == 4 and w.q.shape == (cfg.num_layers, 256, 256)
    assert w.scale.shape == (cfg.num_layers, 256, 4) and w.group_size == 128
    assert p["lm_head"].shape == (cfg.hidden_size, cfg.vocab_size)
    c = kvcache.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, S4,
                           cfg.head_dim, torch.int8, device="cpu")
    ids = torch.arange(5, dtype=torch.int32)[None]
    logits, _ = llama.forward(cfg, p, ids, ids, c)
    assert logits.shape == (1, cfg.vocab_size)
    assert torch.isfinite(logits).all() and c.k_scale[:, 0, :5].all()


# --------------------------------------- attention dispatch, long prompts

@pytest.mark.parametrize("B,T,Hq,D,S,quantized", [
    (2, 1, 4, 64, 256, False), (1, 1, 4, 64, 200, False),
    (1, 1, 4, 32, 256, True), (1, 128, 32, 128, 512, False),
    (1, 512, 4, 64, 2048, True), (2, 1024, 32, 128, 4096, False),
    (1, 8, 4, 128, 1 << 17, False), (1, 7, 4, 128, 1 << 18, True),
    (1, 512, 4, 64, 2000, False), (1, 2048, 4, 256, 4096, True)])
def test_attention_route_matches_jax_dispatch(B, T, Hq, D, S, quantized):
    """decode_attention (K2/K5), flash (K9) or the plain attend exactly
    where the JAX package's cached_attention (llama.py:670-690) picks its
    decode kernel, its flash kernel or its jnp path."""
    from llm_inference_tpu.ops.pallas import decode_attention as j_dec
    from llm_inference_tpu.ops.pallas import flash_attention as j_flash
    q = (B, T, Hq, D)
    if T == 1 and j_dec.supports(q, S):
        want = "decode"
    elif j_flash.supports(q, S, quantized):
        want = "flash"
    else:
        want = "attend"
    assert llama.attention_route(q, S, quantized) == want


@pytest.mark.parametrize("T,S,want", [(1, 256, "decode"), (16, 256, "attend"),
                                      (512, 2048, "flash")])
def test_cached_attention_calls_the_routed_path(monkeypatch, T, S, want):
    from llm_inference_tpu_torch.ops import attention
    from llm_inference_tpu_torch.ops.kernels import decode_attention
    from llm_inference_tpu_torch.ops.kernels import flash_attention
    cfg = tiny_llama(head_dim=64)
    called = []
    for mod, name, route in ((decode_attention, "decode_attention",
                              "decode"),
                             (flash_attention, "flash_attention", "flash"),
                             (attention, "attend", "attend")):
        monkeypatch.setattr(mod, name, lambda *a, _r=route, **k:
                            called.append(_r) or a[0])
    B = 1
    q = torch.zeros((B, T, cfg.num_heads, 64))
    kv = torch.zeros((B, T, cfg.num_kv_heads, 64))
    cache = kvcache.init_cache(1, B, cfg.num_kv_heads, S, 64, "int4",
                               device="cpu")
    pos = torch.arange(T, dtype=torch.int32)[None]
    mask = (attention.make_attention_mask(pos, S) if want == "attend"
            else None)
    llama.cached_attention(cfg, q, kv, kv, cache, 0, pos, pos[:, 0], mask)
    assert called == [want]

