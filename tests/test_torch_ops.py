"""PyTorch port vs the JAX package: quantization, norms, RoPE, attention,
activations, embedding, sampling filters and the KV cache, on the CPU,
with inputs made from a numpy seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.ops import attention as j_attention
from llm_inference_tpu.ops import activations as j_act
from llm_inference_tpu.ops import kvcache as j_kv
from llm_inference_tpu.ops import norms as j_norms
from llm_inference_tpu.ops import quantization as j_quant
from llm_inference_tpu.ops import rope as j_rope
from llm_inference_tpu.ops import sampling as j_sampling

from llm_inference_tpu_torch.ops import activations, attention, embedding
from llm_inference_tpu_torch.ops import kvcache, norms, quantization, rope
from llm_inference_tpu_torch.ops import sampling

from torch_bridge import to_numpy, to_torch


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- quantize

@pytest.mark.parametrize("shape,spread", [((64, 48), 1.0), ((128, 256), 0.02),
                                          ((96, 32), 30.0)])
def test_quantize_int8_bit_identical(shape, spread):
    w = (_rng(1).standard_normal(shape) * spread).astype(np.float32)
    w[3, :] = 0.0                                   # exact-zero rows
    w[:, 5] = 0.0                                   # all-zero column → 1e-8
    jq = j_quant.quantize(jnp.asarray(w), 8)
    tq = quantization.quantize(torch.from_numpy(w), 8)
    # the port stores the codes transposed, [N, K]
    np.testing.assert_array_equal(np.asarray(jq.q), tq.q.T.numpy())
    np.testing.assert_array_equal(np.asarray(jq.scale), tq.scale.numpy())


def test_quantize_rounds_half_to_even():
    # codes that land exactly on .5 after the division
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]],
                 np.float32).T @ np.ones((1, 4), np.float32)
    jq = j_quant.quantize(jnp.asarray(w), 8)
    tq = quantization.quantize(torch.from_numpy(w), 8)
    np.testing.assert_array_equal(np.asarray(jq.q), tq.q.T.numpy())


def test_dequantize_matches_jax():
    w = _rng(2).standard_normal((64, 32)).astype(np.float32)
    jq = j_quant.quantize(jnp.asarray(w), 8)
    tq = quantization.quantize(torch.from_numpy(w), 8)
    assert tq.q.shape == (32, 64) and tq.shape == (64, 32)
    np.testing.assert_array_equal(
        np.asarray(j_quant.dequantize(jq, jnp.float32)),
        quantization.dequantize(tq).numpy())


def test_qmatmul_ref_matches_jax():
    rng = _rng(3)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    jq = j_quant.quantize(jnp.asarray(w), 8)
    tq = quantization.quantize(torch.from_numpy(w), 8)
    want = np.asarray(j_quant.qmatmul_ref(jnp.asarray(x), jq))
    got = quantization.qmatmul_ref(torch.from_numpy(x), tq).numpy()
    # same bf16-operand products; only the float32 summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(bits=4), dict(group_size=32),
                                dict(asymmetric=True)])
def test_quantize_unported_formats_raise(kw):
    w = torch.zeros((64, 16))
    with pytest.raises(NotImplementedError):
        quantization.quantize(w, **{"bits": 8, **kw})


# ------------------------------------------------------------------- norms

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = _rng(4)
    x = rng.standard_normal((3, 7, 128)).astype(np.float32) * 3
    g = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    want = np.asarray(j_norms.rms_norm(jx, jg, 1e-5), np.float32)
    got = norms.rms_norm(to_torch(jx), to_torch(jg), 1e-5)
    # float32: reduction order only; bf16: at most one rounding step apart
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(to_numpy(got), want, rtol=tol, atol=tol)


# -------------------------------------------------------------------- rope

_SCALINGS = [
    None,
    {"type": "linear", "factor": 4.0},
    {"type": "ntk", "factor": 2.0},
    {"type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    {"type": "yarn", "factor": 40.0, "original_max_position_embeddings": 64,
     "beta_fast": 32.0, "beta_slow": 1.0, "mscale": 1.0,
     "mscale_all_dim": 1.0},
    {"rope_type": "longrope", "original_max_position_embeddings": 64,
     "max_position_embeddings": 256,
     "short_factor": [1.0 + 0.1 * i for i in range(16)],
     "long_factor": [2.0 + 0.1 * i for i in range(16)]},
]


@pytest.mark.parametrize("scaling", _SCALINGS,
                         ids=["none", "linear", "ntk", "llama3", "yarn",
                              "longrope"])
def test_rope_table_matches_jax(scaling):
    jc, js = j_rope.make_rope_table(256, 32, 10000.0, scaling)
    tc, ts = rope.make_rope_table(256, 32, 10000.0, scaling)
    # float32 pow/cos/sin implementations differ by ulps; angles reach 255
    # rad, so an ulp of the frequency moves the table by ~1e-5
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)


def test_apply_rope_matches_jax():
    rng = _rng(6)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 200, (2, 5)).astype(np.int32)
    jc, js = j_rope.make_rope_table(256, 32)
    want = np.asarray(j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        jc, js))
    # same (JAX) tables on both sides: the rotation itself must agree to
    # float32 rounding
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          to_torch(jc), to_torch(js))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("window,softcap,G", [(0, 0.0, 1), (0, 0.0, 2),
                                              (6, 0.0, 2), (0, 20.0, 4)])
def test_attend_matches_jax(window, softcap, G):
    rng = _rng(7)
    B, T, Hkv, S, D = 2, 5, 2, 24, 16
    q = rng.standard_normal((B, T, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v[:, :, -3:] = np.nan                  # never attendable: must not leak
    pos = np.stack([np.arange(T) + 3, np.arange(T) + 10]).astype(np.int32)
    jm = j_attention.make_attention_mask(jnp.asarray(pos), S, window)
    tm = attention.make_attention_mask(torch.from_numpy(pos), S, window)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    want = np.asarray(j_attention.attend(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jm,
                                         logit_softcap=softcap))
    got = attention.attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), tm, logit_softcap=softcap)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_attend_quantized_cache_raises():
    q = torch.zeros((1, 1, 2, 16))
    k = torch.zeros((1, 2, 8, 16), dtype=torch.int8)
    mask = torch.ones((1, 1, 1, 8), dtype=torch.bool)
    with pytest.raises(NotImplementedError):
        attention.attend(q, k, k, mask)


# ------------------------------------------------- activations, embedding

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_jax(dtype):
    rng = _rng(8)
    g, u = (jnp.asarray(rng.standard_normal((3, 64)) * 3, dtype)
            for _ in range(2))
    want = np.asarray(j_act.swiglu_split(g, u), np.float32)
    got = activations.swiglu_split(to_torch(g), to_torch(u))
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(to_numpy(got), want, rtol=tol, atol=tol)


def test_embedding_lookup():
    table = _rng(9).standard_normal((50, 8)).astype(np.float32)
    ids = np.array([[0, 49, 7], [7, 7, 1]], np.int32)
    got = embedding.embedding_lookup(torch.from_numpy(table),
                                     torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), table[ids])


# ---------------------------------------------------------------- sampling

def _logits(seed=10):
    return _rng(seed).standard_normal((3, 100)).astype(np.float32) * 3


@pytest.mark.parametrize("k", [1, 5, 40])
def test_top_k_filter_matches_jax(k):
    x = _logits()
    want = np.asarray(j_sampling.apply_top_k(jnp.asarray(x), k))
    np.testing.assert_array_equal(
        sampling.apply_top_k(torch.from_numpy(x), k).numpy(), want)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_top_p_filter_matches_jax(p):
    x = _logits()
    want = np.asarray(j_sampling.apply_top_p(jnp.asarray(x), p))
    got = sampling.apply_top_p(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_array_equal(got[got > -1e29], want[want > -1e29])


@pytest.mark.parametrize("mp", [0.05, 0.3])
def test_min_p_filter_matches_jax(mp):
    x = _logits()
    want = np.asarray(j_sampling.apply_min_p(jnp.asarray(x), mp))
    got = sampling.apply_min_p(torch.from_numpy(x), mp).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)


def test_greedy_and_chosen_logprob_match_jax():
    x = _logits(11)
    x[1, 3] = x[1, 4] = x[1].max() + 1.0            # a tie: first index wins
    want = np.asarray(j_sampling.sample(jnp.asarray(x), None, greedy=True))
    got = sampling.sample(torch.from_numpy(x), None, greedy=True)
    np.testing.assert_array_equal(got.numpy(), want)
    lp_j = np.asarray(j_sampling.chosen_logprob(jnp.asarray(x),
                                                jnp.asarray(want)))
    lp_t = sampling.chosen_logprob(torch.from_numpy(x), got).numpy()
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-6, atol=1e-6)


def test_sample_draws_inside_filtered_support():
    x = torch.from_numpy(_logits(12))
    g = torch.Generator().manual_seed(0)
    kept = sampling.filter_logits(x, 0.7, top_k=10, top_p=0.8) > -1e29
    for _ in range(20):
        tok = sampling.sample(x, g, temperature=0.7, top_k=10, top_p=0.8)
        assert kept[torch.arange(3), tok.long()].all()
    a = sampling.sample(x, torch.Generator().manual_seed(5), temperature=1.0)
    b = sampling.sample(x, torch.Generator().manual_seed(5), temperature=1.0)
    assert torch.equal(a, b)


# ---------------------------------------------------------------- kv cache

def test_prefill_cache_write_matches_jax():
    rng = _rng(13)
    L, B, Hkv, S, D, T = 2, 3, 2, 16, 8, 5
    kn = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    off = np.array([0, 4, 14], np.int32)     # the last clamps to S - T
    jc = j_kv.init_cache(L, B, Hkv, S, D, jnp.float32)
    jc = j_kv.update_cache_layer(jc, jnp.int32(1), jnp.asarray(kn),
                                 jnp.asarray(vn), jnp.asarray(off))
    tc = kvcache.init_cache(L, B, Hkv, S, D, torch.float32)
    kvcache.update_cache_layer(tc, 1, torch.from_numpy(kn),
                               torch.from_numpy(vn), torch.from_numpy(off))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


def test_quantized_cache_raises():
    with pytest.raises(NotImplementedError):
        kvcache.init_cache(1, 1, 1, 8, 8, "int8")
