"""K7's plain version (`ffn_fused_ref`, what `ffn_fused` runs on CPU
tensors) against the JAX package's `ffn_fused` in interpret mode, on the
same N-pair int4 weights (tests/test_ops_quantization.py:406-445 shapes:
K = I = 512, two layers), and the cases both decline. The CUDA kernel
against this plain version is tests/test_torch_cuda.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.ops import quantization as j_quant
from llm_inference_tpu.ops.pallas import quant_matmul as j_qm

from llm_inference_tpu_torch.ops.kernels import quant_matmul as t_qm
from llm_inference_tpu_torch.ops.quantization import (QTensor,
                                                      from_split_half)

from torch_bridge import to_numpy, to_numpy_tree, to_torch

K, I = 512, 512


def _weights(Kw, N, gsize, bits=4, seed=0):
    """A stacked two-layer weight [2, Kw, N] in the JAX serving layout
    (N-pair blocked int4, or column-blocked int8) and in the port's."""
    w = np.random.default_rng(seed).standard_normal((2, Kw, N)) * 0.05
    qt = jax.vmap(lambda m: j_quant.quantize(m, bits, gsize))(
        jnp.asarray(w, jnp.float32))
    if bits == 8:
        jqt = j_quant.to_blocked(qt, 256)
        tree = to_numpy_tree(jqt)
        return jqt, QTensor(q=to_torch(tree["q"]).transpose(-1, -2)
                            .contiguous(), scale=to_torch(tree["scale"]))
    bn = j_quant.choose_block_n(Kw // 2, N, (3 << 20) // 2, quantum=256)
    jqt = j_quant.to_blocked_npair(qt, bn)
    tree = to_numpy_tree(jqt)
    return jqt, from_split_half(to_torch(tree["q"]), to_torch(tree["scale"]),
                                tree["block_rows"])


def _inputs(M, dtype, seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((1, M, K)) * 0.3, dtype)
    res = jnp.asarray(rng.standard_normal((1, M, K)) * 0.3, dtype)
    gamma = jnp.asarray(1 + 0.1 * rng.standard_normal(K), dtype)
    return x, res, gamma


def _assert_close(got, want):
    """Within one bf16 step of each value plus 2^-16 of the largest (the
    same float32 products summed in another order, one rounding; the TPU
    kernel's difference of dots cancels terms up to 16x the result)."""
    want = np.asarray(want, np.float32)
    err = np.abs(to_numpy(got) - want)
    assert (err <= 2.0 ** -7 * np.abs(want)
            + 2.0 ** -16 * np.abs(want).max()).all(), err.max()


@pytest.mark.parametrize("gsize,M,dtype", [
    (32, 1, jnp.bfloat16), (32, 4, jnp.bfloat16), (32, 4, jnp.float32),
    (8, 1, jnp.bfloat16), (8, 4, jnp.bfloat16), (128, 1, jnp.bfloat16),
    (128, 8, jnp.bfloat16), (16, 8, jnp.bfloat16)])
def test_k7_plain_matches_jax_kernel(gsize, M, dtype):
    jgu, tgu = _weights(K, 2 * I, gsize, seed=1)
    jdn, tdn = _weights(I, K, gsize, seed=2)
    x, res, gamma = _inputs(M, dtype, seed=10 * gsize + M)
    for layer in range(2):
        want = j_qm.ffn_fused(x, res, gamma, 1e-5, jgu, jdn, layer)
        assert want is not None, "the TPU kernel takes these weights"
        got = t_qm.ffn_fused(to_torch(x), to_torch(res), to_torch(gamma),
                             1e-5, tgu, tdn, layer)
        assert got is not None
        for g, w in zip(got, want):
            assert g.dtype == to_torch(x).dtype and g.shape == w.shape
        # h2 = x32 in x's dtype: the same float32 sum, rounded once
        np.testing.assert_array_equal(to_numpy(got[1]),
                                      np.asarray(want[1], np.float32))
        _assert_close(got[0], want[0])


def test_k7_declines_what_jax_declines():
    """More than 32 rows, int8 weights and per-channel int4 weights return
    None in both packages (the caller runs the K1 chain)."""
    jgu, tgu = _weights(K, 2 * I, 32, seed=3)
    jdn, tdn = _weights(I, K, 32, seed=4)
    g = jnp.ones((K,), jnp.bfloat16)

    def both(x, gu, dn):
        return (j_qm.ffn_fused(x, x, g, 1e-5, gu[0], dn[0], 0),
                t_qm.ffn_fused(to_torch(x), to_torch(x), to_torch(g), 1e-5,
                               gu[1], dn[1], 0))
    x33 = jnp.zeros((33, K), jnp.bfloat16)
    assert both(x33, (jgu, tgu), (jdn, tdn)) == (None, None)
    x4 = jnp.zeros((4, K), jnp.bfloat16)
    int8 = (_weights(K, 2 * I, 0, bits=8, seed=5),
            _weights(I, K, 0, bits=8, seed=6))
    assert both(x4, *int8) == (None, None)
    per_channel = (_weights(K, 2 * I, 0, seed=7), _weights(I, K, 0, seed=8))
    assert both(x4, *per_channel) == (None, None)


def test_k7_plain_path_counts_no_launch():
    """CPU tensors run the plain version; only a kernel launch counts."""
    _, tgu = _weights(K, 2 * I, 32, seed=9)
    _, tdn = _weights(I, K, 32, seed=10)
    x = torch.zeros((1, K), dtype=torch.bfloat16)
    before = t_qm.ffn_launches
    y, h2 = t_qm.ffn_fused(x, x, torch.ones(K, dtype=torch.bfloat16), 1e-5,
                           tgu, tdn, 1)
    assert t_qm.ffn_launches == before
    assert y.shape == h2.shape == (1, K) and not y.any()
