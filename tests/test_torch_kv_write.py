"""The dense cache's RoPE-and-write (`kv_write.rope_write`, the redesigned
K3/K4) against the JAX package, and the model's route through it.

On the CPU `rope_write` runs its plain version: the port's
`apply_rope_gathered` on q and k, then `update_cache_layer`'s write. The
JAX side is `apply_rope_gathered` and `update_cache_layer`, whose T = 1
write is its Pallas kernel in interpret mode. The card cases (the kernel
against this plain version, bit for bit) are in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_inference_tpu.ops import kvcache as j_kv
from llm_inference_tpu.ops import rope as j_rope

from llm_inference_tpu_torch.config import QuantConfig, tiny_llama
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache, paged_kvcache
from llm_inference_tpu_torch.ops.kernels import kv_write

from torch_bridge import to_numpy, to_torch

KINDS = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": ("int8", "int8"),
         "int4": ("int4", "int4")}


@pytest.mark.parametrize("T", [1, 16])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rope_write_plain_matches_jax(kind, T):
    """q, k, v as the model hands them over (column slices of one qkv
    projection, bf16), B = 2 with the second offset past the end of a
    128-slot cache: the rotated q and bf16 rows within 1e-6, codes and
    scales exact (an int8 scale at T = 1 within one float32 ulp, as
    test_int8_cache_write_matches_jax: JAX's Pallas kernel moves it with
    an identity dot)."""
    jdt, tdt = KINDS[kind]
    rng = np.random.default_rng(31 + T)
    L, B, H, Hkv, S, D = 2, 2, 4, 2, 128, 64
    off = np.array([5, S + 7], np.int32)
    qkv = (rng.standard_normal((B, T, (H + 2 * Hkv) * D)) * 2).astype(
        np.float32)
    qkv[1, 0, H * D:(H + 1) * D] = 0.0              # an all-zero k row
    jqkv = jnp.asarray(qkv).astype(jnp.bfloat16)
    tqkv = to_torch(jqkv)
    jc_t, js_t = j_rope.make_rope_table(S, D)
    pos = np.minimum(off[:, None] + np.arange(T), S - 1)
    cos, sin = np.asarray(jc_t)[pos], np.asarray(js_t)[pos]

    def heads(x, lo, n):
        return x[..., lo * D:(lo + n) * D].reshape(B, T, n, D)

    jq = j_rope.apply_rope_gathered(heads(jqkv, 0, H), jnp.asarray(cos),
                                    jnp.asarray(sin))
    jk = j_rope.apply_rope_gathered(heads(jqkv, H, Hkv), jnp.asarray(cos),
                                    jnp.asarray(sin))
    jc = j_kv.update_cache_layer(j_kv.init_cache(L, B, Hkv, S, D, jdt),
                                 jnp.int32(1), jk, heads(jqkv, H + Hkv, Hkv),
                                 jnp.asarray(off))
    tc = kvcache.init_cache(L, B, Hkv, S, D, tdt, device="cpu")
    tq = kvcache.rope_update_cache_layer(
        tc, 1, heads(tqkv, 0, H), heads(tqkv, H, Hkv),
        heads(tqkv, H + Hkv, Hkv), torch.from_numpy(cos),
        torch.from_numpy(sin), torch.from_numpy(off))
    assert tq.shape == (B, T, H, D) and tq.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(tq), np.asarray(jq, np.float32),
                               rtol=1e-6, atol=1e-6)
    for name in ("k", "v"):
        got, want = getattr(tc, name), np.asarray(getattr(jc, name))
        if kind == "bf16":
            np.testing.assert_allclose(to_numpy(got), want.astype(np.float32),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    if kind != "bf16":
        for name in ("k_scale", "v_scale"):
            np.testing.assert_array_max_ulp(
                getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                maxulp=1 if kind == "int8" and T == 1 else 0)
    # the window the writes landed in: the second sequence's clamps
    start = np.minimum(off, S - T)
    assert to_numpy(tc.k[1, 1, :, start[1]:start[1] + T]).any()
    assert not to_numpy(tc.k[1, 0, :, :start[0]]).any()


def _model(weights, **kw):
    cfg = tiny_llama(dtype="bfloat16", **kw)
    if weights == "dense":
        params = llama.init_params(cfg, seed=3, device="cpu")
    else:
        params = llama.prepare_params(llama.init_params_quantized(
            cfg, QuantConfig(weights="int8", quantize_embedding=True),
            seed=3, device="cpu"))
    if cfg.qk_norm:
        g = torch.Generator().manual_seed(4)
        for name in ("q_norm", "k_norm"):
            params["layers"][name] = (1 + 0.1 * torch.randn(
                (cfg.num_layers, cfg.head_dim), generator=g)).to(
                torch.bfloat16)
    return cfg, params


def _run(cfg, params, cache, T=16):
    """A T-row prefill of two sequences, then two decode steps: the
    logits of each forward."""
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(1, cfg.vocab_size, (2, T), generator=g,
                        dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(2, 1)
    out = []
    with torch.no_grad():
        logits, cache = llama.forward(cfg, params, ids, pos, cache)
        out.append(logits)
        for step in range(2):
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            logits, cache = llama.forward(cfg, params, tok,
                                          torch.full((2, 1), T + step,
                                                     dtype=torch.int32),
                                          cache)
            out.append(logits)
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("weights", ["dense", "int8"])
def test_forward_routes_the_dense_write_through_rope_write(
        monkeypatch, weights, kv):
    """Over a dense cache every layer of every forward calls rope_write
    once (prefill and decode; the unfused layer and the pair-carry one),
    and the logits and cache equal those of the plain RoPE and write it
    replaces, bit for bit (the same elementwise math on the CPU)."""
    cfg, params = _model(weights)
    calls = []
    real = kv_write.rope_write

    def counted(*a, **k):
        calls.append(a[2].shape[1])
        return real(*a, **k)
    monkeypatch.setattr(kv_write, "rope_write", counted)

    def cache():
        return kvcache.init_cache(cfg.num_layers, 2, cfg.num_kv_heads, 64,
                                  cfg.head_dim, KINDS[kv][1], device="cpu")
    fused_cache = cache()
    fused = _run(cfg, params, fused_cache)
    assert calls == [16] * cfg.num_layers + [1] * (2 * cfg.num_layers)
    monkeypatch.setattr(llama, "_rope_in_write", lambda *a: False)
    plain_cache = cache()
    plain = _run(cfg, params, plain_cache)
    assert len(calls) == 3 * cfg.num_layers
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(fused_cache, name), getattr(plain_cache, name)
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("case", ["paged", "qk_norm", "float32"])
def test_forward_keeps_the_plain_rope_where_rope_write_does_not_apply(
        monkeypatch, case):
    """A paged cache, a model with qk-norm and float32 activations keep
    the plain RoPE before the write: rope_write is never called."""
    if case == "float32":
        cfg = tiny_llama()
        params = llama.init_params(cfg, seed=3, device="cpu")
    else:
        cfg, params = _model("int8", qk_norm=case == "qk_norm")
    calls = []
    monkeypatch.setattr(kv_write, "rope_write",
                        lambda *a, **k: calls.append(1))
    if case == "paged":
        ps, NB = 16, 4
        cache = paged_kvcache.init_paged_cache(
            cfg.num_layers, 2 * NB + 1, cfg.num_kv_heads, ps, cfg.head_dim,
            2, NB, torch.bfloat16, device="cpu")
        cache.page_table.copy_(1 + torch.arange(2 * NB, dtype=torch.int32
                                                ).reshape(2, NB))
    else:
        cache = kvcache.init_cache(cfg.num_layers, 2, cfg.num_kv_heads, 64,
                                   cfg.head_dim, torch.bfloat16,
                                   device="cpu")
    out = _run(cfg, params, cache)
    assert not calls
    assert all(torch.isfinite(x).all() for x in out)


def test_rope_supports():
    bf16 = torch.zeros((1, 1, 1, 1, 2), dtype=torch.bfloat16)
    codes = torch.zeros((1, 1, 1, 1, 2), dtype=torch.int8)
    f32 = torch.zeros((1, 1, 1, 1, 2))
    assert kv_write.rope_supports(torch.bfloat16, 128, bf16, 16)
    assert kv_write.rope_supports(torch.bfloat16, 64, codes, 8)
    assert kv_write.rope_supports(torch.bfloat16, 256, codes, 4)
    assert not kv_write.rope_supports(torch.float32, 128, bf16, 16)
    assert not kv_write.rope_supports(torch.bfloat16, 128, f32, 16)
    assert not kv_write.rope_supports(torch.bfloat16, 80, bf16, 16)
    assert not kv_write.rope_supports(torch.bfloat16, 288, codes, 8)
