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


# ------------------------------------------- k and v rows of two widths

LATENT = (576, 512)     # DeepSeek-V3's latent rows: [c_kv | k_rot], c_kv


@pytest.mark.parametrize("entry", ["K3", "K4", "K3 int4 + scales"])
def test_latent_width_writes_plain_match_jax(entry):
    """The decode writes at DeepSeek-V3's k and v widths (576, 512; one kv
    head; B = 2 with the second offset past the end), the port's plain
    versions against JAX's Pallas kernels in interpret mode: K3 copies bf16
    rows (kv_write.write_token), K4 quantizes each row over its own width
    (quantize_write_token: codes exact, scales within one float32 ulp, as
    test_rope_write_plain_matches_jax), and an int4 cache's packed rows
    (288 and 256 bytes, each quantized by quantize_kv4 apart) go through
    K3 and the scale write (write_token_scales)."""
    from llm_inference_tpu.ops.pallas import kv_write as j_kw
    from llm_inference_tpu.ops import quantization as j_q
    from llm_inference_tpu_torch.ops import quantization as t_q
    rng = np.random.default_rng(41)
    L, B, S = 2, 2, 16
    kD, vD = LATENT
    off = np.array([3, S + 5], np.int32)
    kn = jnp.asarray(rng.normal(0, 2, (B, 1, 1, kD)), jnp.bfloat16)
    vn = jnp.asarray(rng.normal(0, 2, (B, 1, 1, vD)), jnp.bfloat16)
    kn = kn.at[1].set(0.0)                       # an all-zero k row
    t = to_torch
    if entry == "K3":
        ka = jnp.asarray(rng.normal(size=(L, B, 1, S, kD)), jnp.bfloat16)
        va = jnp.asarray(rng.normal(size=(L, B, 1, S, vD)), jnp.bfloat16)
        want = j_kw.write_token(ka, va, 1, kn, vn, jnp.asarray(off))
        got = kv_write.write_token(t(ka), t(va), 1, t(kn), t(vn), t(off))
    elif entry == "K4":
        ka = jnp.asarray(rng.integers(-128, 128, (L, B, 1, S, kD)), jnp.int8)
        va = jnp.asarray(rng.integers(-128, 128, (L, B, 1, S, vD)), jnp.int8)
        ks, vs = (jnp.asarray(rng.random((L, B, S, 1)), jnp.float32)
                  for _ in range(2))
        want = j_kw.quantize_write_token(ka, va, ks, vs, 1, kn, vn,
                                         jnp.asarray(off))
        got = kv_write.quantize_write_token(t(ka), t(va), t(ks), t(vs), 1,
                                            t(kn), t(vn), t(off))
    else:
        ka = jnp.asarray(rng.integers(-128, 128, (L, B, 1, S, kD // 2)),
                         jnp.int8)
        va = jnp.asarray(rng.integers(-128, 128, (L, B, 1, S, vD // 2)),
                         jnp.int8)
        ks, vs = (jnp.asarray(rng.random((L, B, S, 1)), jnp.float32)
                  for _ in range(2))
        (jkq, jks), (jvq, jvs) = j_q.quantize_kv4(kn), j_q.quantize_kv4(vn)
        (tkq, tks), (tvq, tvs) = (t_q.quantize_kv4(t(kn)),
                                  t_q.quantize_kv4(t(vn)))
        want = (*j_kw.write_token(ka, va, 1, jkq, jvq, jnp.asarray(off)),
                *j_kw.write_token_scales(ks, vs, 1, jks[..., 0, 0][:, None],
                                         jvs[..., 0, 0][:, None],
                                         jnp.asarray(off)))
        got = (*kv_write.write_token(t(ka), t(va), 1, tkq, tvq, t(off)),
               *kv_write.write_token_scales(
                   t(ks), t(vs), 1, tks[..., 0, 0][:, None],
                   tvs[..., 0, 0][:, None], t(off)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.dtype == torch.float32 and entry == "K4":
            np.testing.assert_array_max_ulp(g.numpy(), w, maxulp=1)
        else:
            np.testing.assert_array_equal(to_numpy(g), w.astype(
                np.float32) if g.dtype == torch.bfloat16 else w)


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_writes_take_k_and_v_at_their_own_widths(cache, kind):
    """update_cache_layer (an 8-row prefill, then two decode steps) and the
    paged pool's writes (write_prompt_batch, write_token) quantize k and v
    apart, each over its own width (k 48, v 32: the int4 decode route
    once stacked them into one tensor, which unequal widths refuse), as
    JAX's update_cache_layer does: the same codes and scales."""
    rng = np.random.default_rng(43)
    L, B, S, ps, kD, vD = 2, 2, 16, 8, 48, 32
    div = 2 if kind == "int4" else 1
    bits = 4 if kind == "int4" else 8

    def zeros(*lead):
        return (np.zeros((*lead, kD // div), np.int8),
                np.zeros((*lead, vD // div), np.int8),
                np.zeros((L, lead[1], lead[3], 1), np.float32),
                np.zeros((L, lead[1], lead[3], 1), np.float32))
    jc = j_kv.KVCache(*map(jnp.asarray, zeros(L, B, 1, S)), bits=bits)
    if cache == "dense":
        tc = kvcache.KVCache(*map(torch.from_numpy, zeros(L, B, 1, S)),
                             bits=bits)
    else:
        tc = paged_kvcache.PagedKVCache(
            *map(torch.from_numpy, zeros(L, 2 * B + 1, 1, ps)[:2]),
            page_table=torch.tensor([[3, 1], [2, 4]], dtype=torch.int32),
            k_scale=torch.zeros((L, 2 * B + 1, ps, 1)),
            v_scale=torch.zeros((L, 2 * B + 1, ps, 1)), bits=bits)
    for T, start in ((ps, 0), (1, ps), (1, ps + 1)):
        kn, vn = (torch.from_numpy(rng.normal(0, 2, (B, T, 1, d)).astype(
            np.float32)) for d in (kD, vD))
        off = torch.full((B,), start, dtype=torch.int32)
        jc = j_kv.update_cache_layer(jc, jnp.int32(1), jnp.asarray(kn),
                                     jnp.asarray(vn), jnp.asarray(off))
        if cache == "dense":
            kvcache.update_cache_layer(tc, 1, kn, vn, off)
        elif T == 1:
            paged_kvcache.write_token(tc, 1, kn, vn, off)
        else:
            paged_kvcache.write_prompt_batch(tc, 1, kn, vn, 1)
    n = ps + 2
    for b in range(B):
        if cache == "dense":
            got = [tc.k[1, b, :, :n], tc.v[1, b, :, :n],
                   tc.k_scale[1, b, :n], tc.v_scale[1, b, :n]]
        else:
            got = list(paged_kvcache.gather_dense(tc, 1, b, n))
            pages = tc.page_table[b].long()
            got += [s_[1][pages].reshape(-1, 1)[:n]
                    for s_ in (tc.k_scale, tc.v_scale)]
        want = [np.asarray(jc.k[1, b, :, :n]), np.asarray(jc.v[1, b, :, :n]),
                np.asarray(jc.k_scale[1, b, :n]),
                np.asarray(jc.v_scale[1, b, :n])]
        for g, w in zip(got, want):
            if g.dtype == torch.float32:
                np.testing.assert_array_max_ulp(g.numpy(), w, maxulp=1)
            else:
                np.testing.assert_array_equal(g.numpy(), w)
