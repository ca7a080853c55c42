"""The port's three kernels — K1 int8 fused-norm matmul, K2 decode
attention, K3 KV write — against the JAX package's Pallas kernels (run in
interpret mode, as the JAX tests run them on the CPU), through the plain
PyTorch versions that CPU tensors take. tests/test_torch_cuda.py holds
the CUDA kernels to those plain versions on a card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.ops import quantization as j_quant
from llm_inference_tpu.ops.pallas import decode_attention as j_dec
from llm_inference_tpu.ops.pallas import kv_write as j_kvw
from llm_inference_tpu.ops.pallas import quant_matmul as j_qm

from llm_inference_tpu_torch.ops.kernels import decode_attention as t_dec
from llm_inference_tpu_torch.ops.kernels import kv_write as t_kvw
from llm_inference_tpu_torch.ops.kernels import quant_matmul as t_qm
from llm_inference_tpu_torch.ops.quantization import QTensor

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
