"""PyTorch port vs the JAX package: quantization, norms, RoPE, attention,
activations, embedding, sampling filters and the KV cache (bf16, int8 and
int4), on the CPU, with inputs made from a numpy seed."""

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


@pytest.mark.parametrize("shape,group_size,spread", [
    ((256, 64), 128, 0.02), ((256, 96), 32, 1.0), ((128, 48), 0, 30.0),
    ((512, 32), 256, 0.05)])
def test_quantize_int4_bit_identical(shape, group_size, spread):
    w = (_rng(21).standard_normal(shape) * spread).astype(np.float32)
    w[:group_size or shape[0], 5] = 0.0          # an all-zero group → 1e-8
    w[7, :] = 0.0
    jq = j_quant.quantize(jnp.asarray(w), 4, group_size)
    tq = quantization.quantize(torch.from_numpy(w), 4, group_size)
    # the port packs K-adjacent codes of a column ([N, K/2]); JAX packs
    # split halves of a column block ([K/2, N]): compare the codes
    assert tq.bits == 4 and tq.q.shape == (shape[1], shape[0] // 2)
    np.testing.assert_array_equal(
        np.asarray(j_quant._unpack_int4(jq.q, jq.block_rows)),
        quantization.unpack_int4(tq.q).T.numpy())
    np.testing.assert_array_equal(np.asarray(jq.scale), tq.scale.T.numpy())
    assert tq.group_size == (group_size or shape[0])


def test_int4_pack_round_trip():
    codes = torch.from_numpy(
        _rng(22).integers(-8, 8, (3, 64)).astype(np.int8))
    packed = quantization.pack_int4(codes)
    assert packed.dtype == torch.int8 and packed.shape == (3, 32)
    assert torch.equal(quantization.unpack_int4(packed), codes)
    # code 2j in the low nibble, 2j+1 in the high nibble
    assert int(packed[0, 0]) & 0xF == int(codes[0, 0]) & 0xF


@pytest.mark.parametrize("group_size", [0, 64])
def test_int4_dequantize_and_qmatmul_ref_match_jax(group_size):
    rng = _rng(23)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    x = rng.standard_normal((5, 128)).astype(np.float32)
    jq = j_quant.quantize(jnp.asarray(w), 4, group_size)
    tq = quantization.quantize(torch.from_numpy(w), 4, group_size)
    np.testing.assert_array_equal(
        np.asarray(j_quant.dequantize(jq, jnp.float32)),
        quantization.dequantize(tq).numpy())
    want = np.asarray(j_quant.qmatmul_ref(jnp.asarray(x), jq))
    got = quantization.qmatmul_ref(torch.from_numpy(x), tq).numpy()
    # the same products (bf16 x per-channel, float32 x grouped); only the
    # float32 summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(bits=4, asymmetric=True),
                                dict(group_size=32),
                                dict(asymmetric=True)])
def test_quantize_unported_formats_raise(kw):
    # the three formats this test once saw refused (asymmetric int4,
    # grouped int8, asymmetric int8) are served: codes, scales and zero
    # points bit-identical to JAX quantize, and dequantize equal to its
    rng = _rng(31)
    # skewed columns, where the zero points matter
    w = (rng.standard_normal((64, 16)) * 0.05 + rng.uniform(
        -0.1, 0.1, (1, 16))).astype(np.float32)
    kw = {"bits": 8, **kw}
    jq = j_quant.quantize(jnp.asarray(w), kw["bits"],
                          kw.get("group_size", 0),
                          asymmetric=kw.get("asymmetric", False))
    tq = quantization.quantize(torch.from_numpy(w), **kw)
    jcodes = (jq.q if kw["bits"] == 8
              else j_quant._unpack_int4(jq.q, jq.block_rows))
    np.testing.assert_array_equal(quantization.codes(tq).T.numpy(),
                                  np.asarray(jcodes))
    lay = (lambda t: t.T) if tq.grouped else (lambda t: t)
    np.testing.assert_array_equal(lay(tq.scale).numpy(),
                                  np.asarray(jq.scale))
    if kw.get("asymmetric"):
        np.testing.assert_array_equal(lay(tq.zbias).numpy(),
                                      np.asarray(jq.zbias))
    else:
        assert tq.zbias is None and jq.zbias is None
    np.testing.assert_array_equal(
        quantization.dequantize(tq).numpy(),
        np.asarray(j_quant.dequantize(jq, jnp.float32)))


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


def test_quantize_kv_bit_identical():
    x = (_rng(24).standard_normal((2, 5, 3, 64)) * 4).astype(np.float32)
    x[0, 1, 2] = 0.0                                  # scale 1e-8, codes 0
    x[1, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]          # ties round to even
    jq, js = j_quant.quantize_kv(jnp.asarray(x))
    tq, ts = quantization.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quantization.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(j_quant.dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("window,softcap,G", [(0, 0.0, 2), (6, 0.0, 1),
                                              (0, 20.0, 4)])
def test_attend_int8_cache_matches_jax(window, softcap, G):
    rng = _rng(25)
    B, T, Hkv, S, D = 2, 5, 2, 24, 16
    q = jnp.asarray(rng.standard_normal((B, T, Hkv * G, D)), jnp.bfloat16)
    kq, ks = j_quant.quantize_kv(jnp.asarray(
        rng.standard_normal((B, S, Hkv, D)), jnp.float32))
    vq, vs = j_quant.quantize_kv(jnp.asarray(
        rng.standard_normal((B, S, Hkv, D)), jnp.float32))
    k, v = kq.transpose(0, 2, 1, 3), vq.transpose(0, 2, 1, 3)
    ks, vs = ks[..., 0], vs[..., 0]                   # [B, S, Hkv]
    vs = vs.at[:, -3:].set(jnp.inf)                   # never attendable
    pos = np.stack([np.arange(T) + 3, np.arange(T) + 10]).astype(np.int32)
    mask = j_attention.make_attention_mask(jnp.asarray(pos), S, window)
    want = j_attention.attend(q, k, v, mask, logit_softcap=softcap,
                              k_scale=ks, v_scale=vs)
    got = attention.attend(to_torch(q), to_torch(k), to_torch(v),
                           to_torch(mask), logit_softcap=softcap,
                           k_scale=to_torch(ks), v_scale=to_torch(vs))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    # bf16 output of the same products; float32 sums in another order may
    # move a result by one bf16 step (2^-8 of |out| <= ~2)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=1e-2, rtol=0)


def test_attend_quantized_cache_raises():
    # codes that are neither D (int8) nor D/2 (packed int4) wide, and codes
    # without their scales, are refused
    q = torch.zeros((1, 1, 2, 16))
    k = torch.zeros((1, 2, 8, 4), dtype=torch.int8)
    s = torch.ones((1, 8, 2))
    mask = torch.ones((1, 1, 1, 8), dtype=torch.bool)
    with pytest.raises(ValueError):
        attention.attend(q, k, k, mask, k_scale=s, v_scale=s)
    codes = torch.zeros((1, 2, 8, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        attention.attend(q, codes, codes, mask)


def test_quantize_kv4_bit_identical():
    x = (_rng(27).standard_normal((2, 5, 3, 64)) * 4).astype(np.float32)
    x[0, 1, 2] = 0.0                                  # scale 1e-8, codes 0
    x[1, 0, 0, :4] = [7.0, 0.5, 1.5, -2.5]            # ties round to even
    x[1, 0, 0, 32:34] = [-7.0, 3.5]                   # high half too
    jq, js = j_quant.quantize_kv4(jnp.asarray(x))
    tq, ts = quantization.quantize_kv4(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tq.shape == (2, 5, 3, 32)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(quantization.unpack_kv4(tq).numpy(),
                                  np.asarray(j_quant.unpack_kv4(jq)))
    np.testing.assert_array_equal(
        quantization.dequantize_kv4(tq, ts, torch.float32).numpy(),
        np.asarray(j_quant.dequantize_kv4(jq, js, jnp.float32)))


@pytest.mark.parametrize("window,softcap,G", [(0, 0.0, 2), (6, 0.0, 1),
                                              (0, 20.0, 4)])
def test_attend_int4_cache_matches_jax(window, softcap, G):
    rng = _rng(28)
    B, T, Hkv, S, D = 2, 5, 2, 24, 16
    q = jnp.asarray(rng.standard_normal((B, T, Hkv * G, D)), jnp.bfloat16)
    kq, ks = j_quant.quantize_kv4(jnp.asarray(
        rng.standard_normal((B, S, Hkv, D)), jnp.float32))
    vq, vs = j_quant.quantize_kv4(jnp.asarray(
        rng.standard_normal((B, S, Hkv, D)), jnp.float32))
    k, v = kq.transpose(0, 2, 1, 3), vq.transpose(0, 2, 1, 3)   # [B,H,S,D/2]
    ks, vs = ks[..., 0], vs[..., 0]
    vs = vs.at[:, -3:].set(jnp.inf)                   # never attendable
    pos = np.stack([np.arange(T) + 3, np.arange(T) + 10]).astype(np.int32)
    mask = j_attention.make_attention_mask(jnp.asarray(pos), S, window)
    want = j_attention.attend(q, k, v, mask, logit_softcap=softcap,
                              k_scale=ks, v_scale=vs)
    got = attention.attend(to_torch(q), to_torch(k), to_torch(v),
                           to_torch(mask), logit_softcap=softcap,
                           k_scale=to_torch(ks), v_scale=to_torch(vs))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    # as the int8 cache: bf16 output of the same products, float32 sums in
    # another order (one bf16 step of |out| <= ~2)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=1e-2, rtol=0)


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
    tc = kvcache.init_cache(L, B, Hkv, S, D, torch.float32,
                            device="cpu")
    kvcache.update_cache_layer(tc, 1, torch.from_numpy(kn),
                               torch.from_numpy(vn), torch.from_numpy(off))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("T", [5, 1])
def test_int8_cache_write_matches_jax(T):
    """Prefill (T > 1: plain quantize_kv and slice writes) and decode
    (T = 1: K4's plain version) into an int8 cache give the JAX package's
    codes and slot-major scales."""
    rng = _rng(26)
    L, B, Hkv, S, D = 2, 3, 2, 16, 64
    kn = (rng.standard_normal((B, T, Hkv, D)) * 2).astype(np.float32)
    vn = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    off = np.array([0, 4, 14], np.int32)     # the last clamps
    jc = j_kv.init_cache(L, B, Hkv, S, D, "int8")
    jc = j_kv.update_cache_layer(jc, jnp.int32(1), jnp.asarray(kn),
                                 jnp.asarray(vn), jnp.asarray(off))
    tc = kvcache.init_cache(L, B, Hkv, S, D, torch.int8,
                            device="cpu")
    assert tc.quantized and tc.bits == 8 and tc.k.dtype == torch.int8
    kvcache.update_cache_layer(tc, 1, torch.from_numpy(kn),
                               torch.from_numpy(vn), torch.from_numpy(off))
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    for name in ("k_scale", "v_scale"):
        # bit for bit at T > 1 (quantize_kv on both sides); at T = 1 JAX
        # runs its Pallas kernel, whose identity dot that moves the scale
        # column into a lane row rounds it by up to one float32 ulp in
        # interpret mode (the codes are computed before it, and agree)
        np.testing.assert_array_max_ulp(getattr(tc, name).numpy(),
                                        np.asarray(getattr(jc, name)),
                                        maxulp=0 if T > 1 else 1)


def test_quantized_cache_raises():
    # an int4 cache packs two dims per byte: an odd head_dim is refused
    with pytest.raises(ValueError):
        kvcache.init_cache(1, 1, 1, 8, 7, "int4", device="cpu")


def test_init_cache_int4_matches_jax():
    """Packed codes [L, B, Hkv, S, D/2] int8 and slot-major float32 scales
    [L, B, S, Hkv], bits 4 (kvcache.py:99-104)."""
    jc = j_kv.init_cache(2, 3, 4, 16, 64, "int4")
    tc = kvcache.init_cache(2, 3, 4, 16, 64, "int4", device="cpu")
    assert tc.bits == jc.bits == 4 and tc.quantized and tc.max_seq_len == 16
    for name in ("k", "v", "k_scale", "v_scale"):
        t, j = getattr(tc, name), np.asarray(getattr(jc, name))
        assert t.shape == j.shape and str(t.dtype)[6:] == str(j.dtype)
        assert not t.any()


@pytest.mark.parametrize("T", [5, 1])
def test_int4_cache_write_matches_jax(T):
    """Prefill (T > 1: quantize_kv4 and slice writes) and decode (T = 1:
    quantize_kv4, K3 on the packed rows and the scale write, plain
    versions) into an int4 cache give the JAX package's codes and scales
    bit for bit (its decode path runs write_token and write_token_scales
    in interpret mode)."""
    rng = _rng(29)
    L, B, Hkv, S, D = 2, 3, 2, 16, 64
    kn = (rng.standard_normal((B, T, Hkv, D)) * 2).astype(np.float32)
    vn = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    off = np.array([0, 4, 14], np.int32)     # the last clamps
    jc = j_kv.init_cache(L, B, Hkv, S, D, "int4")
    jc = j_kv.update_cache_layer(jc, jnp.int32(1), jnp.asarray(kn),
                                 jnp.asarray(vn), jnp.asarray(off))
    tc = kvcache.init_cache(L, B, Hkv, S, D, "int4", device="cpu")
    kvcache.update_cache_layer(tc, 1, torch.from_numpy(kn),
                               torch.from_numpy(vn), torch.from_numpy(off))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    assert tc.k[1].any() and tc.k_scale[1].any() and not tc.k[0].any()
