"""The port's paged KV cache against the JAX package's, on the CPU: the
pool init and writes bit for bit (bf16, int8 and int4 pools), the page
allocator and gather_dense; K10a/K10b's and K11's plain versions against
the JAX package's paged_decode_attention and paged_flash_attention (Pallas
in interpret mode); and the paged forward's logits against the JAX
package's llama.forward over a paged cache (a first chunk, a chunk over
history, decode steps)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.config import QuantConfig as JQuantConfig
from llm_inference_tpu.config import tiny_llama as j_tiny_llama
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.ops import paged_kvcache as j_pk
from llm_inference_tpu.ops import quantization as j_quant
from llm_inference_tpu.ops.pallas import paged_attention as j_pa
from llm_inference_tpu.ops.pallas import paged_flash as j_pf

from llm_inference_tpu_torch.config import tiny_llama
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import paged_kvcache as t_pk
from llm_inference_tpu_torch.ops.kernels import paged_attention as t_pa
from llm_inference_tpu_torch.ops.kernels import paged_flash as t_pf

from torch_bridge import (paged_cache_to_torch, to_numpy, to_numpy_tree,
                          to_torch)

KINDS = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": ("int8", "int8"),
         "int4": ("int4", "int4")}
# as K2/K5/K9 against their TPU kernels (test_torch_kernels.py)
ATOL = {"bf16": 2e-2, "int8": 2e-2, "int4": 1e-2}


def _table(rng, B, NB, P, live):
    """[B, NB] int32: row b's first live[b] entries are distinct pages of
    1..P-1 in scattered order, the rest the null page."""
    perm = rng.permutation(P - 1) + 1
    pt = np.zeros((B, NB), np.int32)
    o = 0
    for b, n in enumerate(live):
        pt[b, :n] = perm[o:o + n]
        o += n
    return pt


def _assert_cache_equal(tc, jc):
    for name in ("k_pages", "v_pages", "page_table", "k_scale", "v_scale"):
        j = getattr(jc, name)
        t = getattr(tc, name)
        assert (j is None) == (t is None), name
        if j is not None:
            np.testing.assert_array_equal(to_numpy(t), np.asarray(
                j, np.float32 if t.dtype == torch.bfloat16 else None),
                err_msg=name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_init_paged_cache_matches_jax(kind):
    jdt, tdt = KINDS[kind]
    jc = j_pk.init_paged_cache(2, 5, 2, 8, 64, 3, 4, jdt)
    tc = t_pk.init_paged_cache(2, 5, 2, 8, 64, 3, 4, tdt, device="cpu")
    assert (tc.bits, tc.quantized, tc.head_dim, tc.page_size, tc.num_pages,
            tc.max_blocks) == (jc.bits, jc.quantized, jc.head_dim,
                               jc.page_size, jc.num_pages, jc.max_blocks)
    assert str(tc.k_pages.dtype).split(".")[-1] == str(jc.k_pages.dtype)
    _assert_cache_equal(tc, jc)


def _caches(kind, rng, L=2, P=12, Hkv=2, ps=8, D=64, B=3, NB=4):
    jdt, tdt = KINDS[kind]
    pt = _table(rng, B, NB, P, [NB - 1, 2, NB])
    jc = j_pk.init_paged_cache(L, P, Hkv, ps, D, B, NB, jdt).replace(
        page_table=jnp.asarray(pt))
    tc = t_pk.init_paged_cache(L, P, Hkv, ps, D, B, NB, tdt, device="cpu")
    tc.page_table.copy_(torch.from_numpy(pt))
    return jc, tc


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_write_token_matches_jax_bit_for_bit(kind):
    """Codes and scales equal the JAX package's, with NaN and Inf in the
    new rows (sanitized before quantizing) and one position past its
    table (the block clamps to the last entry)."""
    rng = np.random.default_rng(3)
    jc, tc = _caches(kind, rng)
    B, Hkv, D = 3, 2, 64
    for step, pos in enumerate(([5, 9, 31], [6, 15, 8 * 4 + 3])):
        k = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
        k[0, 0, 1, 3] = np.nan
        v[1, 0, 0, 7] = np.inf
        k[2, 0, 0, 0] = -np.inf
        kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        p = np.asarray(pos, np.int32)
        jc = j_pk.write_token(jc, jnp.int32(1), kj, vj, jnp.asarray(p))
        t_pk.write_token(tc, 1, to_torch(kj), to_torch(vj),
                         torch.from_numpy(p))
    _assert_cache_equal(tc, jc)
    assert torch.isfinite(tc.k_pages.float()).all()
    if tc.quantized:
        assert torch.isfinite(tc.k_scale).all() and tc.k_scale[1].any()


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("start", [None, (1, 0, 2)])
def test_write_prompt_batch_matches_jax_bit_for_bit(kind, start):
    rng = np.random.default_rng(4)
    jc, tc = _caches(kind, rng)
    B, T, Hkv, D = 3, 16, 2, 64                    # two blocks of 8 slots
    k = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    sb = None if start is None else np.asarray(start, np.int32)
    jc = j_pk.write_prompt_batch(jc, jnp.int32(0), k, v, 2,
                                 None if sb is None else jnp.asarray(sb))
    t_pk.write_prompt_batch(tc, 0, to_torch(k), to_torch(v), 2,
                            None if sb is None else torch.from_numpy(sb))
    _assert_cache_equal(tc, jc)
    for seq in range(B):
        for got, want in zip(t_pk.gather_dense(tc, 0, seq, 21),
                             j_pk.gather_dense(jc, 0, seq, 21)):
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(
                to_numpy(got), np.asarray(want, np.float32
                                          if kind == "bf16" else None))


def test_page_allocator_matches_jax():
    j, t = j_pk.PageAllocator(7), t_pk.PageAllocator(7)
    assert t.free_pages == j.free_pages == 6
    for n in (2, 3):
        assert t.allocate(n) == j.allocate(n)
    t.release([4, 1])
    j.release([4, 1])
    assert t.allocate(3) == j.allocate(3)
    assert t.free_pages == j.free_pages == 0
    with pytest.raises(MemoryError):
        t.allocate(1)
    assert 0 not in j_pk.PageAllocator(3).allocate(2)
    assert 0 not in t_pk.PageAllocator(3).allocate(2)


def _pools(kind, rng, L, P, Hkv, ps, D, nan_null=True):
    """JAX pools [L, P, Hkv, ps, Dc] and scales [L, P, ps, Hkv] of random
    rows in `kind`; the null page holds NaN where it can."""
    shape = (L, P, Hkv, ps, D)
    if kind == "bf16":
        k = np.asarray(rng.standard_normal(shape), np.float32)
        v = np.asarray(rng.standard_normal(shape), np.float32)
        if nan_null:
            k[:, 0] = v[:, 0] = np.nan
        return jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), \
            None, None
    qfn = j_quant.quantize_kv4 if kind == "int4" else j_quant.quantize_kv
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((L, P, ps, Hkv, D)), jnp.float32)
        q, s = qfn(x)
        s = np.array(s[..., 0])
        if nan_null:
            s[:, 0] = np.nan
        out += [q.transpose(0, 1, 3, 2, 4), jnp.asarray(s)]
    return out[0], out[2], out[1], out[3]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
def test_k10_plain_matches_jax_kernel(kind, window, softcap):
    """Page size 8 over scattered tables, GQA (Hkv 2, G 2), NaN in the
    null page that unallocated entries point at, and a row past its
    table's end (the port clamps it to the last slot; the TPU kernel
    would read past the row, so that row is held to the clamp)."""
    rng = np.random.default_rng(window + int(softcap) + len(kind))
    L, Hkv, G, D, ps, NB, B = 2, 2, 2, 64, 8, 8, 4
    S = NB * ps
    pos = np.array([0, 20, S - 1, S + 40], np.int32)
    live = [min(p // ps + 1, NB) for p in pos]
    P = sum(live) + 2
    k, v, ks, vs = _pools(kind, rng, L, P, Hkv, ps, D)
    pt = _table(rng, B, NB, P, live)
    q = jnp.asarray(rng.standard_normal((B, 1, Hkv * G, D)), jnp.bfloat16)
    opt = lambda a: None if a is None else to_torch(a)   # noqa: E731
    args = (to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(pt), 1)
    kw = dict(logit_softcap=softcap, window=window, k_scale=opt(ks),
              v_scale=opt(vs))
    got = t_pa.paged_attention(*args, torch.from_numpy(pos), **kw)
    assert got.shape == (B, 1, Hkv * G, D) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    n = B - 1                              # rows within their tables
    want = j_pa.paged_decode_attention(
        q[:n], k, v, jnp.asarray(pt[:n]), jnp.int32(1),
        jnp.asarray(pos[:n]), logit_softcap=softcap, k_scale=ks,
        v_scale=vs, window=window)
    np.testing.assert_allclose(to_numpy(got[:n]), np.asarray(want,
                                                             np.float32),
                               atol=ATOL[kind], rtol=0)
    clamped = t_pa.paged_attention(*args, torch.from_numpy(
        np.minimum(pos, S - 1)), **kw)
    assert torch.equal(got, clamped)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 20.0)])
def test_k11_plain_matches_jax_kernel(kind, window, softcap):
    """Page size 128: rows of fresh tokens at history offsets (one row's
    chunk starts at 0, one's over two earlier pages), GQA, a partial last
    page; NaN in the null page past each row's frontier."""
    rng = np.random.default_rng(60 + window + len(kind))
    L, Hq, Hkv, D, ps, NB, T = 2, 4, 2, 64, 128, 4, 96
    starts = (0, 256)
    B = len(starts)
    live = [(s + T - 1) // ps + 1 for s in starts]
    P = sum(live) + 2
    k, v, ks, vs = _pools(kind, rng, L, P, Hkv, ps, D)
    pt = _table(rng, B, NB, P, live)
    q = jnp.asarray(rng.standard_normal((B, T, Hq, D)), jnp.bfloat16)
    pos = np.stack([s + np.arange(T) for s in starts]).astype(np.int32)
    want = j_pf.paged_flash_attention(
        q, k, v, jnp.asarray(pt), jnp.int32(1), jnp.asarray(pos),
        logit_softcap=softcap, sliding_window=window, k_scale=ks,
        v_scale=vs)
    opt = lambda a: None if a is None else to_torch(a)   # noqa: E731
    got = t_pf.paged_flash_attention(
        to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(pt), 1,
        torch.from_numpy(pos), logit_softcap=softcap, sliding_window=window,
        k_scale=opt(ks), v_scale=opt(vs))
    assert got.shape == (B, T, Hq, D) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               atol=ATOL[kind], rtol=0)


def test_paged_routes_match_jax_dispatch():
    """K10 where the JAX package's paged decode kernel takes a step, K11
    where its paged flash kernel takes a chunk over history, else the
    gather path; a first chunk attends over its fresh rows."""
    for q, ps, hist in (((2, 1, 4, 64), 8, False), ((2, 1, 4, 32), 8, False),
                        ((1, 1, 4, 128), 12, False),
                        ((1, 128, 4, 64), 128, True),
                        ((1, 128, 4, 64), 8, True), ((1, 4, 4, 64), 128, True),
                        ((1, 128, 4, 64), 128, False)):
        if q[1] == 1:
            want = ("paged_decode" if j_pa.supports(q, ps)
                    else "paged_gather")
        elif hist:
            want = ("paged_flash" if j_pf.supports(q, ps)
                    else "paged_gather")
        else:
            want = "paged_prefill"
        assert llama.attention_route(q, 1024, False, ps, hist) == want


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_paged_forward_matches_jax(kind):
    """int8 weights (tiny_llama, head_dim 64) over a paged pool of page
    size 128 with scattered pages: a 128-row first chunk, a 128-row chunk
    over it (paged_history: K11 on both sides), then three decode steps
    (K10). Logits within 1e-2 (as test_torch_model)."""
    jdt, tdt = KINDS[kind]
    kw = dict(head_dim=64, max_position_embeddings=512)
    jcfg, cfg = j_tiny_llama(**kw), tiny_llama(**kw)
    qp = j_llama.quantize_params(
        j_llama.init_params(jcfg, jax.random.PRNGKey(5)),
        JQuantConfig(weights="int8", quantize_embedding=True))
    jprep = j_llama.prepare_params(qp, donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    rng = np.random.default_rng(9)
    B, ps, NB, P = 2, 128, 3, 8
    pt = np.array([[5, 2, 7], [1, 6, 3]], np.int32)
    jc = j_pk.init_paged_cache(jcfg.num_layers, P, jcfg.num_kv_heads, ps,
                               jcfg.head_dim, B, NB, jdt).replace(
        page_table=jnp.asarray(pt))
    tc = paged_cache_to_torch(jc)
    lengths = np.array([128, 100], np.int32)
    errs = []
    for c, hist in enumerate((False, True)):
        ids = rng.integers(1, cfg.vocab_size, (B, 128)).astype(np.int32)
        pos = (c * 128 + np.arange(128, dtype=np.int32))[None].repeat(B, 0)
        last = lengths - 1 if hist else np.full((B,), 127, np.int32)
        jl, jc = j_llama.forward(jcfg, jprep, jnp.asarray(ids),
                                 jnp.asarray(pos), jc,
                                 last_idx=jnp.asarray(last),
                                 paged_history=hist)
        tl, tc = llama.forward(cfg, tprep, torch.from_numpy(ids),
                               torch.from_numpy(pos), tc,
                               last_idx=torch.from_numpy(last),
                               paged_history=hist)
        errs.append(np.abs(tl.numpy() - np.asarray(jl)).max())
    nxt = 128 + lengths
    for _ in range(3):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = j_llama.forward(jcfg, jprep, jnp.asarray(tok),
                                 jnp.asarray(nxt[:, None]), jc)
        tl, tc = llama.forward(cfg, tprep, torch.from_numpy(tok),
                               torch.from_numpy(nxt[:, None]), tc)
        errs.append(np.abs(tl.numpy() - np.asarray(jl)).max())
        nxt = nxt + 1
    assert max(errs) <= 1e-2, errs
    assert np.isfinite(tl.numpy()).all()
