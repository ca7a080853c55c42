"""The port's whole-layer decode megakernel (K12) and its row writes
against the JAX package's, on the CPU: `layer_decode_fused_ref` (with the
plain row writes) vs `llm_inference_tpu.ops.pallas.layer_fused.
layer_decode_fused` in interpret mode on the same numpy-seeded inputs and
bridged weights, in the four (weights, KV) cases; the None cases; the row
writes bit for bit; and `llama.forward` with LLMI_LAYER_MEGA=1 against the
JAX forward with it. Sizes follow tests/test_layer_fused.py: hidden 256,
intermediate 512, 4 heads, 2 or 4 kv heads, head_dim 128, 2 layers."""

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
from llm_inference_tpu.ops import rope as j_rope
from llm_inference_tpu.ops.pallas import kv_write as j_kvw
from llm_inference_tpu.ops.pallas import layer_fused as j_lf
from llm_inference_tpu.ops.quantization import (QTensor as JQTensor,
                                                to_blocked, to_blocked_npair)

from llm_inference_tpu_torch.config import tiny_llama
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache, paged_kvcache
from llm_inference_tpu_torch.ops.kernels import kv_write, layer_fused

from torch_bridge import cache_to_torch, to_numpy, to_numpy_tree, to_torch

BF16 = torch.bfloat16


def _cfgs(kv_heads, head_dim=128):
    kw = dict(hidden_size=256, intermediate_size=512, num_layers=2,
              num_heads=4, num_kv_heads=kv_heads, head_dim=head_dim,
              vocab_size=128, max_position_embeddings=512, dtype="bfloat16")
    return j_tiny_llama(**kw), tiny_llama(**kw)


def _params(jcfg, cfg, bits, gs, seed=0):
    """The JAX megakernel's blocked weights (as tests/test_layer_fused.py
    builds them; norms random bf16) and the same weights in the port."""
    dense = j_llama.init_params(jcfg, jax.random.PRNGKey(seed),
                                dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    layers = dict(dense["layers"])
    for name in ("attn_norm", "ffn_norm"):
        layers[name] = jnp.asarray(
            1 + 0.1 * rng.standard_normal(layers[name].shape), jnp.bfloat16)
    dense = dict(dense, layers=layers)
    q = j_llama.fuse_params(j_llama.quantize_params(
        dense, JQuantConfig(weights=bits, group_size=gs)))
    layers = dict(q["layers"])
    for name in layer_fused.WEIGHTS:
        layers[name] = (to_blocked_npair(layers[name], 256) if bits == "int4"
                        else to_blocked(layers[name], 256))
    jparams = dict(q, layers=layers)
    tparams = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jparams), cfg, device="cpu"))
    return jparams, tparams


def _random_cache(kv, L, Hkv, S, D, seed):
    """A JAX cache of random contents (bf16 rows, or int8 codes with
    scales) for the history the megakernel reads."""
    rng = np.random.default_rng(seed)
    shape, sshape = (L, 1, Hkv, S, D), (L, 1, S, Hkv)
    if kv == "bf16":
        return j_kv.KVCache(
            k=jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
            v=jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    return j_kv.KVCache(
        k=jnp.asarray(rng.integers(-128, 128, shape), jnp.int8),
        v=jnp.asarray(rng.integers(-128, 128, shape), jnp.int8),
        k_scale=jnp.asarray(rng.uniform(0.005, 0.03, sshape), jnp.float32),
        v_scale=jnp.asarray(rng.uniform(0.005, 0.03, sshape), jnp.float32),
        bits=8)


def _port_cache(jcache, pos):
    """The same cache in the port, with NaN where the megakernel must not
    read: the V rows (bf16) or V scales (int8) of slots >= pos (slot pos
    is the new token's: it is seeded, then written)."""
    c = cache_to_torch(jcache)
    if c.quantized:
        c.v_scale[:, :, pos:] = float("nan")
    else:
        c.v[:, :, :, pos:] = float("nan")
    return c


def _layer_args(jparams, layer):
    qw = {k: v for k, v in jparams["layers"].items()
          if isinstance(v, JQTensor)}
    lp = {k: v[layer] for k, v in jparams["layers"].items()
          if not isinstance(v, JQTensor)}
    return lp, qw


def _rope_rows(cfg, S, pos):
    cos, sin = llama.rope_table(cfg, S, "cpu")
    return cos[pos][None, None], sin[pos][None, None]


# the four (weights, KV) cases; the last two cross a 128-slot block
CASES = [("int8", 0, "bf16", 4, 128, 9),
         ("int8", 0, "int8", 2, 256, 130),
         ("int4", 64, "bf16", 2, 128, 9),
         ("int4", 64, "int8", 4, 256, 131)]


@pytest.mark.parametrize("bits,gs,kv,kv_heads,S,pos", CASES)
def test_layer_decode_fused_matches_jax(bits, gs, kv, kv_heads, S, pos):
    jcfg, cfg = _cfgs(kv_heads)
    jparams, tparams = _params(jcfg, cfg, bits, gs, seed=kv_heads)
    rng = np.random.default_rng(pos)
    H, D, layer = cfg.hidden_size, cfg.head_dim, 1
    h = jnp.asarray(rng.standard_normal((1, 1, H)), jnp.bfloat16)
    res = jnp.asarray(rng.standard_normal((1, 1, H)), jnp.bfloat16)
    jcache = _random_cache(kv, cfg.num_layers, kv_heads, S, D, seed=pos)
    cos_tab, sin_tab = j_rope.make_rope_table(S, D, jcfg.rope_theta)
    lp, qw = _layer_args(jparams, layer)
    out = j_lf.layer_decode_fused(jcfg, h, res, lp, qw, jcache,
                                  jnp.int32(layer),
                                  jnp.full((1, 1), pos, jnp.int32),
                                  cos_tab, sin_tab)
    assert out is not None
    jh2, jdn, jnew = out

    tcache = _port_cache(jcache, pos)
    positions = torch.full((1, 1), pos, dtype=torch.int32)
    assert layer_fused.supports(cfg, (1, 1, H), tparams["layers"], tcache)
    cos, sin = _rope_rows(cfg, S, pos)
    th2, tdn = layer_fused.layer_decode_fused(
        cfg, to_torch(h), to_torch(res), tparams["layers"], tcache, layer,
        positions, cos, sin)
    for got, want in ((th2, jh2), (tdn, jdn)):
        got, want = to_numpy(got), np.asarray(want, np.float32)
        assert np.isfinite(got).all()
        # the same math; float32 sums in another order, and p rounded to
        # bf16 against the row maximum where the TPU kernel uses each slot
        # block's running one: a few bf16 steps (2^-8) of the largest value
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=4 * 2.0 ** -8 * np.abs(want).max())
    # the rows written at slot pos: bf16 rows within one bf16 step (the
    # qkv sums round differently), int8 codes within one code
    k_got = to_numpy(tcache.k[layer, 0, :, pos])
    k_want = np.asarray(jnew.k[layer, 0, :, pos], np.float32)
    if kv == "int8":
        assert np.abs(k_got - k_want).max() <= 1
        for got, want in ((tcache.k_scale, jnew.k_scale),
                          (tcache.v_scale, jnew.v_scale)):
            np.testing.assert_allclose(
                to_numpy(got[layer, 0, pos]),
                np.asarray(want[layer, 0, pos]), rtol=2.0 ** -7)
    else:
        np.testing.assert_allclose(k_got, k_want, rtol=0,
                                   atol=2.0 ** -7 * np.abs(k_want).max())
    # nothing else of the cache moved
    untouched = torch.ones(S, dtype=torch.bool)
    untouched[pos] = False
    assert torch.equal(tcache.k[0], cache_to_torch(jcache).k[0])
    assert torch.equal(tcache.k[layer, :, :, untouched],
                       cache_to_torch(jcache).k[layer, :, :, untouched])


def _declines(jcfg, cfg, jparams, tparams, jh, jcache, tcache):
    """The JAX function returns None, and the port's supports() says no and
    its layer_decode_fused returns None (the split path runs)."""
    lp, qw = _layer_args(jparams, 0)
    D = cfg.head_dim
    tab = jnp.ones((64, D), jnp.float32)
    assert j_lf.layer_decode_fused(jcfg, jh, jh, lp, qw, jcache, 0,
                                   jnp.array([[5]], jnp.int32), tab,
                                   tab) is None
    th, layers = to_torch(jh), tparams["layers"]
    assert not layer_fused.supports(cfg, th.shape, layers, tcache)
    rows = torch.ones((1, 1, D))
    assert layer_fused.layer_decode_fused(
        cfg, th, th, layers, tcache, 0, torch.tensor([[5]]), rows,
        rows) is None


def test_layer_decode_fused_declines_what_jax_declines():
    """B = 2, an int4 cache, D != 128; then the port's own: a paged pool
    and per-channel int4 weights."""
    jcfg, cfg = _cfgs(2)
    jparams, tparams = _params(jcfg, cfg, "int4", 64)
    H, D = cfg.hidden_size, cfg.head_dim
    h1 = jnp.zeros((1, 1, H), jnp.bfloat16)
    _declines(jcfg, cfg, jparams, tparams, jnp.zeros((2, 1, H), jnp.bfloat16),
              j_kv.init_cache(2, 2, 2, 256, D, "int8"),
              kvcache.init_cache(2, 2, 2, 256, D, "int8", device="cpu"))
    _declines(jcfg, cfg, jparams, tparams, h1,
              j_kv.init_cache(2, 1, 2, 256, D, "int4"),
              kvcache.init_cache(2, 1, 2, 256, D, "int4", device="cpu"))
    jcfg64, cfg64 = _cfgs(2, head_dim=64)
    jp64, tp64 = _params(jcfg64, cfg64, "int4", 64)
    _declines(jcfg64, cfg64, jp64, tp64, h1,
              j_kv.init_cache(2, 1, 2, 256, 64, "int8"),
              kvcache.init_cache(2, 1, 2, 256, 64, "int8", device="cpu"))
    layers = tparams["layers"]
    dense = kvcache.init_cache(2, 1, 2, 256, D, "int8", device="cpu")
    assert layer_fused.supports(cfg, (1, 1, H), layers, dense)
    pool = paged_kvcache.init_paged_cache(2, 4, 2, 128, D, 1, 2, "int8",
                                          device="cpu")
    assert not layer_fused.supports(cfg, (1, 1, H), layers, pool)
    per_channel = dict(layers)
    for name in layer_fused.WEIGHTS:
        w = layers[name]
        per_channel[name] = dataclasses.replace(
            w, scale=w.scale[..., :1].contiguous())
    assert not layer_fused.supports(cfg, (1, 1, H), per_channel, dense)


# (H, Hq, Hkv, I): LLaMA-2-7B, the card tests' model at G = 1 and G = 8,
# and this file's
@pytest.mark.parametrize("H,Hq,Hkv,I", [(4096, 32, 32, 11008),
                                        (1024, 8, 8, 2816),
                                        (1024, 8, 1, 2816),
                                        (256, 4, 2, 512)])
def test_k12_scratch_covers_the_kernel(H, Hq, Hkv, I):
    """The wrapper's K12 scratch (kept per device, grown): the header and
    the heads' merge counters, then every part the kernel writes, each
    part's start a multiple of 32 floats, and room for the shares' states
    of any split count the kernel picks (at most sms // Hkv a head, at
    least one)."""
    D = 128
    for sms in (1, 78, 132, 144):
        n = layer_fused.scratch_floats(H, Hq, Hkv, I, sms)
        max_split = max(1, sms // Hkv)
        parts = [Hkv, sms * 32, (Hq + 2 * Hkv) * D,
                 Hkv * max_split * (Hq // Hkv) * (D + 2), Hq * D, H, I]
        assert n == 64 + sum(-(-p // 32) * 32 for p in parts)
        assert n >= 64 + sum(parts) and n % 32 == 0
    # more SMs never shrink it (the buffer is grown, never cut)
    sizes = [layer_fused.scratch_floats(H, Hq, Hkv, I, s)
             for s in range(1, 200)]
    assert sizes == sorted(sizes)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_row_writes_match_jax(kv):
    """write_rows: bit for bit the JAX kernel. quantize_write_rows: codes
    and scales bit for bit the JAX package's quantize_kv of the same rows
    at the clamped slot, the rest of the cache untouched; against the
    Pallas kernel in interpret mode, whose absmax / 127 can land one
    float32 ulp off the IEEE quotient on the CPU (so a code at a rounding
    tie may move by one), scales within one ulp and codes within one."""
    rng = np.random.default_rng(7)
    L, Hkv, S, D = 2, 4, 256, 128
    jcache = _random_cache(kv, L, Hkv, S, D, seed=8)
    for off in (0, 130, S + 5):                   # the last clamps to S - 1
        kn = jnp.asarray(rng.standard_normal((Hkv, D)) * 3, jnp.bfloat16)
        vn = jnp.asarray(rng.standard_normal((Hkv, D)), jnp.bfloat16)
        tcache = cache_to_torch(jcache)
        if kv == "bf16":
            want = j_kvw.write_rows(jcache.k, jcache.v, jnp.int32(1), kn, vn,
                                    jnp.int32(off))
            got = kv_write.write_rows(tcache.k, tcache.v, 1, to_torch(kn),
                                      to_torch(vn), off)
            assert all(torch.equal(g, to_torch(w)) for g, w in zip(got, want))
            continue
        want = j_kvw.quantize_write_rows(
            jcache.k, jcache.v, jcache.k_scale, jcache.v_scale,
            jnp.int32(1), kn, vn, jnp.int32(off))
        got = kv_write.quantize_write_rows(
            tcache.k, tcache.v, tcache.k_scale, tcache.v_scale, 1,
            to_torch(kn), to_torch(vn), torch.tensor([off]))
        slot = min(off, S - 1)
        expect = cache_to_torch(jcache)
        for i, new in enumerate((kn, vn)):
            q, sc = j_quant.quantize_kv(new)
            (expect.k, expect.v)[i][1, 0, :, slot] = to_torch(q)
            (expect.k_scale, expect.v_scale)[i][1, 0, slot] = to_torch(
                sc[:, 0])
        assert all(torch.equal(g, e) for g, e in zip(
            got, (expect.k, expect.v, expect.k_scale, expect.v_scale)))
        for g, w in zip(got[:2], want[:2]):
            assert (g.int() - to_torch(w).int()).abs().max() <= 1
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_max_ulp(to_numpy(g), np.asarray(w),
                                            maxulp=1)


@pytest.mark.parametrize("bits,gs,kv", [("int8", 0, "bf16"),
                                        ("int4", 64, "int8")])
def test_forward_with_layer_mega_matches_jax(monkeypatch, bits, gs, kv):
    jcfg, cfg = _cfgs(2)
    jparams, tparams = _params(jcfg, cfg, bits, gs, seed=3)
    S = 128
    jdt = "int8" if kv == "int8" else jnp.bfloat16
    jcache = j_kv.init_cache(2, 1, 2, S, 128, jdt)
    tcache = kvcache.init_cache(2, 1, 2, S, 128, "int8" if kv == "int8"
                                else BF16, device="cpu")
    monkeypatch.setenv("LLMI_LAYER_MEGA", "1")
    steps = [(np.array([[3, 5, 7, 11]], np.int32),
              np.arange(4, dtype=np.int32)[None])]
    steps += [(np.array([[17 + 3 * t]], np.int32),
               np.array([[4 + t]], np.int32)) for t in range(3)]
    calls = []
    ref = layer_fused.layer_decode_fused_ref

    def counted(*a, **k):
        calls.append(1)
        return ref(*a, **k)
    monkeypatch.setattr(layer_fused, "layer_decode_fused_ref", counted)
    for i, (ids, pos) in enumerate(steps):
        jlog, jcache = j_llama.forward(jcfg, jparams, jnp.asarray(ids),
                                       jnp.asarray(pos), jcache)
        want_route = "mega" if ids.shape[1] == 1 else "split"
        assert llama.layer_route(cfg, tparams["layers"], *ids.shape,
                                 tcache) == want_route
        tlog, tcache = llama.forward(cfg, tparams, torch.from_numpy(ids),
                                     torch.from_numpy(pos), tcache)
        # bf16 activations through 2 layers and an f32 lm_head over bf16
        # rows: sums in another order move a logit by a few bf16 steps
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=2e-2, rtol=0, err_msg=f"step {i}")
    assert len(calls) == 3 * cfg.num_layers     # every decode layer ran K12
    monkeypatch.setenv("LLMI_LAYER_MEGA", "0")
    assert llama.layer_route(cfg, tparams["layers"], 1, 1, tcache) == "split"
