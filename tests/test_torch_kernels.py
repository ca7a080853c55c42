"""The port's kernels — K1 fused-norm matmul (int8 and int4) and K8 its
tiled prefill GEMM, K2 decode attention (bf16 and int8 cache) and K5 (int4
cache), K3 KV write and the int4 scale write, K4 int8 quantize-write, K6
layer tail, K9 flash prefill attention (bf16, int8, int4 caches) — against
the JAX package's Pallas kernels (run in interpret mode, as the JAX tests
run them on the CPU), through the plain PyTorch versions that CPU tensors
take. tests/test_torch_cuda.py holds the CUDA kernels to those plain
versions on a card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.ops import quantization as j_quant
from llm_inference_tpu.ops.pallas import decode_attention as j_dec
from llm_inference_tpu.ops.pallas import flash_attention as j_flash
from llm_inference_tpu.ops.pallas import kv_write as j_kvw
from llm_inference_tpu.ops.pallas import quant_matmul as j_qm

from llm_inference_tpu_torch.ops.kernels import decode_attention as t_dec
from llm_inference_tpu_torch.ops.kernels import flash_attention as t_flash
from llm_inference_tpu_torch.ops.kernels import kv_write as t_kvw
from llm_inference_tpu_torch.ops.kernels import quant_matmul as t_qm
from llm_inference_tpu_torch.ops.quantization import QTensor, from_split_half

from torch_bridge import to_numpy, to_torch, to_numpy_tree


def _bf16_ulps(got, want):
    """|got - want| in units of one bf16 ulp of want (≥ the smallest
    normal's ulp)."""
    want = np.asarray(want, np.float32)
    exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100)))
    return np.abs(np.asarray(got, np.float32) - want) / 2.0 ** (exp - 7)


def _weights(L=2, K=128, N=256, seed=0):
    w = np.random.default_rng(seed).standard_normal((L, K, N)) * 0.05
    qt = jax.vmap(lambda m: j_quant.quantize(m, 8))(
        jnp.asarray(w, jnp.float32))
    jqt = j_quant.to_blocked(qt, j_quant.choose_block_n(K, N))
    tree = to_numpy_tree(jqt)
    return jqt, QTensor(q=to_torch(tree["q"]).transpose(1, 2).contiguous(),
                        scale=to_torch(tree["scale"]))


# ---------------------------------------------------------------- K1

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("prologue", ["none", "norm", "norm_res_xout",
                                      "res_xout"])
def test_k1_plain_matches_jax_kernel(prologue, M, dtype):
    rng = np.random.default_rng(M)
    K, N = 128, 256
    jqt, tqt = _weights(K=K, N=N)
    x = jnp.asarray(rng.standard_normal((M, K)), dtype)
    res = jnp.asarray(rng.standard_normal((M, K)), dtype)
    gamma = jnp.asarray(1 + 0.1 * rng.standard_normal(K), dtype)
    kw = {}
    if "norm" in prologue:
        kw["norm_gamma"] = gamma
    if "res" in prologue:
        kw["residual"] = res
    want_x_out = "xout" in prologue
    want = j_qm.quant_matmul(x, jqt, layer=1, norm_eps=1e-5,
                             want_x_out=want_x_out, **kw)
    tkw = {k: to_torch(v) for k, v in kw.items()}
    got = t_qm.quant_matmul(to_torch(x), tqt, 1, norm_eps=1e-5,
                            want_x_out=want_x_out, **tkw)
    if want_x_out:
        (want, want_x), (got, got_x) = want, got
        assert got_x.dtype == to_torch(want_x).dtype
        # x + residual, rounded to bf16 once on both sides: exact
        np.testing.assert_array_equal(to_numpy(got_x),
                                      np.asarray(want_x, np.float32))
    assert got.dtype == to_torch(want).dtype and got.shape == want.shape
    # bf16 outputs of the same products; the float32 sum order differs, so
    # a result may land one bf16 rounding step away
    assert _bf16_ulps(to_numpy(got), want).max() <= 1.0


def test_k1_plain_prefill_path_matches_jax():
    """M > 128 follows the TPU package's tiled prefill path (prologue
    outside the kernel, in the caller's dtype)."""
    rng = np.random.default_rng(5)
    K, N, M = 128, 256, 136
    jqt, tqt = _weights(K=K, N=N, seed=1)
    x = jnp.asarray(rng.standard_normal((2, M // 2, K)), jnp.float32)
    res = jnp.asarray(rng.standard_normal((2, M // 2, K)), jnp.float32)
    g = jnp.ones((K,), jnp.float32)
    want, want_x = j_qm.quant_matmul(x, jqt, layer=0, norm_gamma=g,
                                     residual=res, want_x_out=True)
    got, got_x = t_qm.quant_matmul(to_torch(x), tqt, 0,
                                   norm_gamma=to_torch(g),
                                   residual=to_torch(res), want_x_out=True)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-6, atol=1e-6)
    assert _bf16_ulps(got.numpy(), want).max() <= 1.0


# ---------------------------------------------------------------- K2

@pytest.mark.parametrize("S,Hkv,G,window,softcap", [
    (128, 2, 2, 0, 0.0),      # GQA
    (128, 4, 1, 16, 0.0),     # sliding window
    (128, 2, 2, 0, 30.0),     # logit softcap
    (256, 2, 4, 0, 0.0),      # two slot blocks in the TPU kernel
])
def test_k2_plain_matches_jax_kernel(S, Hkv, G, window, softcap):
    rng = np.random.default_rng(S + G)
    L, B, D = 2, 3, 64
    q = jnp.asarray(rng.standard_normal((B, 1, Hkv * G, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((L, B, Hkv, S, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((L, B, Hkv, S, D)), jnp.bfloat16)
    pos = np.array([0, 77, S - 1], np.int32)
    assert j_dec.supports(q.shape, S) and t_dec.supports(q.shape, S)
    want = j_dec.decode_attention(q, k, v, jnp.int32(1), jnp.asarray(pos),
                                  logit_softcap=softcap, window=window)
    vt = to_torch(v)
    vt[1, 1, :, 78:] = float("nan")        # beyond pos: never read
    got = t_dec.decode_attention(to_torch(q), to_torch(k), vt, 1,
                                 torch.from_numpy(pos),
                                 logit_softcap=softcap, window=window)
    assert got.shape == (B, 1, Hkv * G, D) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    # bf16 output; the TPU kernel's online softmax rounds p to bf16
    # against each slot block's running max, the plain version against
    # the row max: a few bf16 steps of |out| <= ~3
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


# ---------------------------------------------------------------- K3

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k3_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(3)
    L, B, Hkv, S, D = 2, 4, 2, 16, 64
    k_all = jnp.asarray(rng.standard_normal((L, B, Hkv, S, D)), dtype)
    v_all = jnp.asarray(rng.standard_normal((L, B, Hkv, S, D)), dtype)
    kn = jnp.asarray(rng.standard_normal((B, Hkv, 1, D)), dtype)
    vn = jnp.asarray(rng.standard_normal((B, Hkv, 1, D)), dtype)
    off = np.array([0, 5, S - 1, S + 7], np.int32)      # last one clamps
    tk, tv = to_torch(k_all), to_torch(v_all)
    jk, jv = j_kvw.write_token(k_all, v_all, jnp.int32(1), kn, vn,
                               jnp.asarray(off))
    ok, ov = t_kvw.write_token(tk, tv, 1, to_torch(kn), to_torch(vn),
                               torch.from_numpy(off))
    assert ok is tk and ov is tv                        # in place
    np.testing.assert_array_equal(to_numpy(tk), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv, np.float32))


# ------------------------------------------------- int4 weights (K1, K6)

def _int4_weights(L=2, K=256, N=512, gsize=128, seed=0):
    """JAX int4 weights in the TPU serving layout (grouped, N-pair
    blocked, as prepare_params lays them) and the same weights in the
    port's layout, through the test bridge."""
    w = np.random.default_rng(seed).standard_normal((L, K, N)) * 0.05
    qt = jax.vmap(lambda m: j_quant.quantize(m, 4, gsize))(
        jnp.asarray(w, jnp.float32))
    bn = j_quant.choose_block_n(K // 2, N, (3 << 20) // 2, quantum=256)
    jqt = j_quant.to_blocked_npair(qt, bn)
    tree = to_numpy_tree(jqt)
    return jqt, from_split_half(to_torch(tree["q"]), to_torch(tree["scale"]))


def _assert_bf16_close(got, want):
    """Within one bf16 step of each value (the same products summed in
    float32 in another order, then one rounding), plus 2^-16 of the
    largest: the TPU kernel's difference of dots d_lo = d1 - 16 d_hi -
    8 xsum cancels terms up to 16x the result in float32."""
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want)
    assert (err <= 2.0 ** -7 * np.abs(want)
            + 2.0 ** -16 * np.abs(want).max()).all(), err.max()


@pytest.mark.parametrize("M", [1, 4, 128])
@pytest.mark.parametrize("prologue", ["none", "norm", "norm_res_xout"])
def test_k1_int4_plain_matches_jax_kernel(prologue, M):
    rng = np.random.default_rng(40 + M)
    K, N = 256, 512
    jqt, tqt = _int4_weights(K=K, N=N)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    kw = {}
    if "norm" in prologue:
        kw["norm_gamma"] = jnp.asarray(1 + 0.1 * rng.standard_normal(K),
                                       jnp.bfloat16)
    if "res" in prologue:
        kw["residual"] = jnp.asarray(rng.standard_normal((M, K)),
                                     jnp.bfloat16)
    want_x_out = "xout" in prologue
    want = j_qm.quant_matmul(x, jqt, layer=1, norm_eps=1e-5,
                             want_x_out=want_x_out, **kw)
    got = t_qm.quant_matmul(to_torch(x), tqt, 1, norm_eps=1e-5,
                            want_x_out=want_x_out,
                            **{k: to_torch(v) for k, v in kw.items()})
    if want_x_out:
        (want, want_x), (got, got_x) = want, got
        np.testing.assert_array_equal(to_numpy(got_x),
                                      np.asarray(want_x, np.float32))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _assert_bf16_close(to_numpy(got), want)


def test_k1_int4_plain_prefill_path_matches_jax():
    """M > 128 follows the TPU package's tiled kernel (K8): prologue
    outside, in the caller's dtype, then bf16 rows."""
    rng = np.random.default_rng(41)
    K, N, M = 256, 512, 136
    jqt, tqt = _int4_weights(K=K, N=N, seed=1)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    res = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    g = jnp.asarray(1 + 0.1 * rng.standard_normal(K), jnp.bfloat16)
    want, want_x = j_qm.quant_matmul(x, jqt, layer=0, norm_gamma=g,
                                     residual=res, want_x_out=True)
    got, got_x = t_qm.quant_matmul(to_torch(x), tqt, 0,
                                   norm_gamma=to_torch(g),
                                   residual=to_torch(res), want_x_out=True)
    np.testing.assert_array_equal(to_numpy(got_x),
                                  np.asarray(want_x, np.float32))
    _assert_bf16_close(to_numpy(got), want)


def _tail_weights(H=256, I=512, seed=3, gsize=128):
    wo = _int4_weights(K=H, N=H, gsize=gsize, seed=seed)
    # [gate | up] columns
    gu = _int4_weights(K=H, N=2 * I, gsize=gsize, seed=seed + 1)
    dn = _int4_weights(K=I, N=H, gsize=gsize, seed=seed + 2)
    return [w[0] for w in (wo, gu, dn)], [w[1] for w in (wo, gu, dn)]


@pytest.mark.parametrize("M", [1, 4, 8, 32])
def test_k6_plain_matches_jax_kernel(M):
    _k6_against_jax(M, 128, 60 + M)


@pytest.mark.parametrize("gsize", [32, 64])
@pytest.mark.parametrize("M", [1, 8, 32])
def test_k6_plain_matches_jax_kernel_groups(M, gsize):
    # smaller groups: each group's partial sum takes its own scale
    _k6_against_jax(M, gsize, 600 + gsize + M)


def _k6_against_jax(M, gsize, seed):
    rng = np.random.default_rng(seed)
    H = 256
    jw, tw = _tail_weights(gsize=gsize)
    h = jnp.asarray(rng.standard_normal((M, H)), jnp.bfloat16)
    attn = jnp.asarray(rng.standard_normal((M, H)), jnp.bfloat16)
    gamma = jnp.asarray(1 + 0.1 * rng.standard_normal(H), jnp.bfloat16)
    want_y, want_h2 = j_qm.layer_tail_fused(h, attn, *jw, gamma, 1e-5,
                                            jnp.int32(1))
    got_y, got_h2 = t_qm.layer_tail_fused(to_torch(h), to_torch(attn), *tw,
                                          to_torch(gamma), 1e-5, 1)
    assert got_y.dtype == torch.bfloat16 and got_y.shape == want_y.shape
    # h2 = bf16(h + wo_out) and y: float32 sums in another order before
    # one bf16 rounding each (the float32 intermediates are not rounded)
    _assert_bf16_close(to_numpy(got_h2), want_h2)
    _assert_bf16_close(to_numpy(got_y), want_y)


def test_k6_declines_what_jax_declines():
    """More than 32 rows, or weights that are not grouped int4, go to the
    K1 chain in both packages."""
    jw, tw = _tail_weights()
    h = jnp.zeros((33, 256), jnp.bfloat16)
    g = jnp.ones((256,), jnp.bfloat16)
    assert j_qm.layer_tail_fused(h, h, *jw, g, 1e-5, 0) is None
    assert t_qm.layer_tail_fused(to_torch(h), to_torch(h), *tw,
                                 to_torch(g), 1e-5, 0) is None
    _, int8_wo = _weights(K=256, N=256)
    assert t_qm.layer_tail_fused(to_torch(h[:4]), to_torch(h[:4]), int8_wo,
                                 *tw[1:], to_torch(g), 1e-5, 0) is None


# --------------------------------------------------- int8 KV cache (K4, K2)

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k4_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(4)
    L, B, Hkv, S, D = 2, 4, 2, 16, 64
    k_all = jnp.asarray(rng.integers(-128, 128, (L, B, Hkv, S, D)), jnp.int8)
    v_all = jnp.asarray(rng.integers(-128, 128, (L, B, Hkv, S, D)), jnp.int8)
    ks_all = jnp.asarray(rng.random((L, B, S, Hkv)), jnp.float32)
    vs_all = jnp.asarray(rng.random((L, B, S, Hkv)), jnp.float32)
    kn = jnp.asarray(rng.standard_normal((B, Hkv, 1, D)) * 3, dtype)
    vn = jnp.asarray(rng.standard_normal((B, Hkv, 1, D)), dtype)
    kn = kn.at[2, 1].set(0.0)                           # scale 1e-8
    off = np.array([0, 5, S - 1, S + 7], np.int32)      # the last clamps
    want = j_kvw.quantize_write_token(k_all, v_all, ks_all, vs_all,
                                      jnp.int32(1), kn, vn, jnp.asarray(off))
    tc = [to_torch(a) for a in (k_all, v_all, ks_all, vs_all)]
    got = t_kvw.quantize_write_token(*tc, 1, to_torch(kn), to_torch(vn),
                                     torch.from_numpy(off))
    assert all(g is t for g, t in zip(got, tc))         # in place
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tc[1].numpy(), np.asarray(want[1]))
    # scales: bit for bit the JAX package's quantize_kv of the same rows;
    # the Pallas kernel's identity dot (a lane relayout) rounds its copy by
    # up to one float32 ulp in interpret mode
    rows = np.arange(B)
    slot = np.minimum(off, S - 1)
    for new, scales, jax_scales in ((kn, tc[2], want[2]),
                                    (vn, tc[3], want[3])):
        _, s = j_quant.quantize_kv(new[:, :, 0])
        np.testing.assert_array_equal(scales.numpy()[1, rows, slot],
                                      np.asarray(s[..., 0]))
        np.testing.assert_array_max_ulp(scales.numpy(),
                                        np.asarray(jax_scales), maxulp=1)


@pytest.mark.parametrize("S,Hkv,G,window,softcap", [
    (128, 2, 2, 0, 0.0),      # GQA
    (128, 4, 1, 16, 0.0),     # sliding window
    (128, 2, 2, 0, 30.0),     # logit softcap
    (256, 2, 4, 0, 0.0),      # two slot blocks in the TPU kernel
])
def test_k2_int8_plain_matches_jax_kernel(S, Hkv, G, window, softcap):
    rng = np.random.default_rng(S + G + 7)
    L, B, D = 2, 3, 64
    q = jnp.asarray(rng.standard_normal((B, 1, Hkv * G, D)), jnp.bfloat16)
    k = jnp.asarray(rng.integers(-128, 128, (L, B, Hkv, S, D)), jnp.int8)
    v = jnp.asarray(rng.integers(-128, 128, (L, B, Hkv, S, D)), jnp.int8)
    ks = jnp.asarray(rng.random((L, B, S, Hkv)) * 0.03, jnp.float32)
    vs = jnp.asarray(rng.random((L, B, S, Hkv)) * 0.03, jnp.float32)
    pos = np.array([0, 77, S - 1], np.int32)
    want = j_dec.decode_attention(q, k, v, jnp.int32(1), jnp.asarray(pos),
                                  logit_softcap=softcap, k_scale=ks,
                                  v_scale=vs, window=window)
    vst = to_torch(vs)
    vst[1, 1, 78:] = float("inf")          # beyond pos: never read
    got = t_dec.decode_attention(to_torch(q), to_torch(k), to_torch(v), 1,
                                 torch.from_numpy(pos),
                                 logit_softcap=softcap, window=window,
                                 k_scale=to_torch(ks), v_scale=vst)
    assert got.shape == (B, 1, Hkv * G, D) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    # as the bf16 cache: bf16 output, p · v_scale rounded to bf16 against
    # each slot block's running max on the TPU, the row max here: a few
    # bf16 steps of |out| <= ~3
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


# ------------------------------------- int4 KV cache (scale write, K5)

def test_write_token_scales_plain_matches_jax_kernel():
    rng = np.random.default_rng(5)
    L, B, S, Hkv = 2, 4, 16, 3
    ks_all = jnp.asarray(rng.random((L, B, S, Hkv)), jnp.float32)
    vs_all = jnp.asarray(rng.random((L, B, S, Hkv)), jnp.float32)
    ksn = jnp.asarray(rng.random((B, 1, Hkv)), jnp.float32)
    vsn = jnp.asarray(rng.random((B, 1, Hkv)), jnp.float32)
    off = np.array([0, 5, S - 1, S + 7], np.int32)      # the last clamps
    want = j_kvw.write_token_scales(ks_all, vs_all, jnp.int32(1), ksn, vsn,
                                    jnp.asarray(off))
    tks, tvs = to_torch(ks_all), to_torch(vs_all)
    got = t_kvw.write_token_scales(tks, tvs, 1, to_torch(ksn), to_torch(vsn),
                                   torch.from_numpy(off))
    assert got[0] is tks and got[1] is tvs              # in place
    # a copy through a one-hot blend on the TPU: exact
    np.testing.assert_array_equal(tks.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tvs.numpy(), np.asarray(want[1]))


def _int4_cache(rng, L, B, Hkv, S, D):
    """Packed int4 codes [L, B, Hkv, S, D/2] and slot-major scales
    [L, B, S, Hkv] of random K/V rows, from the JAX package's quantizer."""
    out = []
    for _ in range(2):
        q, s = j_quant.quantize_kv4(jnp.asarray(
            rng.standard_normal((L, B, S, Hkv, D)), jnp.float32))
        out += [q.transpose(0, 1, 3, 2, 4), s[..., 0]]
    return out                                          # k, ks, v, vs


@pytest.mark.parametrize("S,Hkv,G,window,softcap", [
    (128, 2, 2, 0, 0.0),      # GQA
    (128, 4, 1, 16, 0.0),     # sliding window
    (128, 2, 2, 0, 30.0),     # logit softcap
    (256, 2, 4, 0, 0.0),      # two slot blocks in the TPU kernel
])
def test_k5_plain_matches_jax_kernel(S, Hkv, G, window, softcap):
    rng = np.random.default_rng(S + G + 11)
    L, B, D = 2, 3, 64
    q = jnp.asarray(rng.standard_normal((B, 1, Hkv * G, D)), jnp.bfloat16)
    k, ks, v, vs = _int4_cache(rng, L, B, Hkv, S, D)
    pos = np.array([0, 77, S - 1], np.int32)
    want = j_dec.decode_attention(q, k, v, jnp.int32(1), jnp.asarray(pos),
                                  logit_softcap=softcap, k_scale=ks,
                                  v_scale=vs, window=window)
    vst = to_torch(vs)
    vst[1, 1, 78:] = float("inf")          # beyond pos: never read
    got = t_dec.decode_attention(to_torch(q), to_torch(k), to_torch(v), 1,
                                 torch.from_numpy(pos),
                                 logit_softcap=softcap, window=window,
                                 k_scale=to_torch(ks), v_scale=vst)
    assert got.shape == (B, 1, Hkv * G, D) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    # float32 q and p on both sides (the TPU kernel folds the -8 of the low
    # nibbles into row sums, the plain version unpacks): float32 sums in
    # another order, then one bf16 rounding of |out| <= ~2
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=1e-2, rtol=0)


# ------------------------------------------- K2/K5/K10 split rule

@pytest.mark.parametrize("B,Hkv,S", [
    (1, 32, 512), (1, 32, 4096), (8, 32, 512), (4, 8, 128), (1, 1, 16384),
    (2, 4, 1024), (64, 32, 2048), (1, 8, 64), (3, 5, 640), (2, 32, 16384)])
def test_decode_split_rule_fills_the_card(B, Hkv, S):
    """The CUDA kernels' split of each head's slots (the same rule for the
    dense and the paged wrapper): one wave of the card's resident blocks
    (_BLOCKS_PER_SM an SM) filled to within one head's splits where S
    allows it, a second wave begun only so that no block walks more than
    _MAX_SHARE slots, no split shorter than two tiles, and the scratch the
    wrapper allocates covering the kernel's states and no more than the
    larger of one wave of them and the share cap's."""
    # the kernel's tiles (csrc/decode_attention.cu, decode_attn_tile_slots)
    for D, tile in ((64, 64), (128, 32), (128, 64), (256, 32), (256, 64)):
        for sms in (1, 78, 132, 144):
            n = t_dec.splits(B, Hkv, S, tile, sms)
            wave = t_dec._BLOCKS_PER_SM * sms
            capped = -(-S // t_dec._MAX_SHARE)
            assert n >= 1
            if S >= 2 * tile:
                assert S // n >= 2 * tile
            if S // (2 * tile) >= capped:
                assert -(-S // n) <= t_dec._MAX_SHARE
            if n > max(1, capped):
                assert B * Hkv * n <= wave
            if S // (2 * tile) * B * Hkv >= wave:
                assert B * Hkv * n > wave - B * Hkv
            # the kernel's last scratch index is inside the allocation,
            # and the allocation within the larger bound
            G = 8
            state = G * (D + 2)
            last = ((B * Hkv - 1) * n + n - 1) * state + state - 1
            floats = t_dec.scratch_floats(B, Hkv, G, D, n)
            assert last < floats
            assert floats <= max(B * Hkv * capped, wave) * state


# ------------------------------------------------ K8 (M > 128 rows)

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("prologue", ["none", "norm_res_xout"])
def test_k8_plain_matches_jax_kernel(bits, prologue):
    """M = 300 rows take the TPU package's tiled kernel (two 256-row m
    tiles, the second partial) and the port's K8 path."""
    rng = np.random.default_rng(80 + bits)
    K, N, M = 256, 512, 300
    jqt, tqt = (_int4_weights(K=K, N=N, seed=2) if bits == 4
                else _weights(K=K, N=N, seed=2))
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    kw = {}
    if prologue != "none":
        kw = dict(norm_gamma=jnp.asarray(1 + 0.1 * rng.standard_normal(K),
                                         jnp.bfloat16),
                  residual=jnp.asarray(rng.standard_normal((M, K)),
                                       jnp.bfloat16))
    want_x_out = prologue != "none"
    want = j_qm.quant_matmul(x, jqt, layer=1, norm_eps=1e-5,
                             want_x_out=want_x_out, **kw)
    got = t_qm.quant_matmul(to_torch(x), tqt, 1, norm_eps=1e-5,
                            want_x_out=want_x_out,
                            **{k: to_torch(v) for k, v in kw.items()})
    if want_x_out:
        (want, want_x), (got, got_x) = want, got
        np.testing.assert_array_equal(to_numpy(got_x),
                                      np.asarray(want_x, np.float32))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # the same bf16 products summed in float32 in another order, then one
    # bf16 rounding (int4: plus the TPU's N-pair difference of dots)
    _assert_bf16_close(to_numpy(got), want)


# ------------------------------------------------ K9 (flash prefill)

FLASH_CASES = {
    # B, T, Hq, Hkv, S, D, starts, window, softcap
    "gqa_tail": (2, 40, 4, 2, 256, 64, (0, 37), 0, 0.0),
    "window_history": (1, 64, 2, 1, 256, 64, (100,), 50, 0.0),
    "softcap": (1, 32, 4, 4, 256, 128, (10,), 0, 20.0),
}


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_k9_plain_matches_jax_kernel(case, kv):
    """GQA (Hkv < Hq), a window, a softcap, history offsets and a partial
    tail tile (T = 40 over 32-row blocks), over each cache kind, called as
    tests/test_flash_attention.py calls the TPU kernel."""
    B, T, Hq, Hkv, S, D, starts, window, softcap = FLASH_CASES[case]
    rng = np.random.default_rng(len(case) + len(kv))
    L = 2
    q = jnp.asarray(rng.standard_normal((B, T, Hq, D)), jnp.bfloat16)
    ks = vs = None
    if kv == "int4":
        k, ks, v, vs = _int4_cache(rng, L, B, Hkv, S, D)
    elif kv == "int8":
        kq, ks = j_quant.quantize_kv(jnp.asarray(
            rng.standard_normal((L, B, Hkv, S, D)), jnp.float32))
        vq, vs = j_quant.quantize_kv(jnp.asarray(
            rng.standard_normal((L, B, Hkv, S, D)), jnp.float32))
        k, v = kq, vq
        ks, vs = ks[..., 0].transpose(0, 1, 3, 2), vs[..., 0].transpose(
            0, 1, 3, 2)                                 # [L, B, S, Hkv]
    else:
        k = jnp.asarray(rng.standard_normal((L, B, Hkv, S, D)), jnp.bfloat16)
        v = jnp.asarray(rng.standard_normal((L, B, Hkv, S, D)), jnp.bfloat16)
    pos = np.stack([s + np.arange(T) for s in starts]).astype(np.int32)
    want = j_flash.flash_attention(q, k, v, 1, jnp.asarray(pos),
                                   logit_softcap=softcap,
                                   sliding_window=window, k_scale=ks,
                                   v_scale=vs, block_t=32, block_s=128)
    opt = lambda a: None if a is None else to_torch(a)   # noqa: E731
    got = t_flash.flash_attention(to_torch(q), to_torch(k), to_torch(v), 1,
                                  torch.from_numpy(pos),
                                  logit_softcap=softcap,
                                  sliding_window=window, k_scale=opt(ks),
                                  v_scale=opt(vs))
    assert got.shape == (B, T, Hq, D) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    # bf16 output; p (times the V scale) rounds to bf16 against the
    # running max of 128-slot blocks on the TPU and of 64-slot blocks
    # here (float32 p over an int4 cache): a few bf16 steps of |out| <= ~3
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)
