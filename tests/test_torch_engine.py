"""The port's InferenceEngine.generate against the JAX package's, on the
CPU: greedy token streams of the port's configurations at tiny width
(int8 weights and lm_head over a 128-slot bf16 cache; int4 g=128 weights
and lm_head over a 256-slot int8 cache), and a 1000-token prompt over a
2048-slot bf16, int8 or int4 cache (two prefill chunks through the tiled
GEMM and flash attention)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.config import EngineConfig as JEngineConfig
from llm_inference_tpu.config import GenerationConfig as JGenerationConfig
from llm_inference_tpu.config import QuantConfig as JQuantConfig
from llm_inference_tpu.config import tiny_llama as j_tiny_llama
from llm_inference_tpu.engine.engine import InferenceEngine as JEngine
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.ops import kvcache as j_kv

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            tiny_llama)
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.models import llama

from torch_bridge import to_numpy_tree

S = 128
BUCKETS = (16, 32)
NEW = 6
# the port's logits agree with the JAX package's within 1e-2
# (test_torch_model); where JAX's top-2 gap is wider, argmax must agree
GAP_TOL = 2e-2
REQUESTS = [[[1, 17, 103, 42, 7]],
            [[1, 3, 7], [1, 200, 150, 90, 2, 9, 11, 60, 5]]]


@pytest.fixture(scope="module")
def setup():
    jcfg = j_tiny_llama(head_dim=64)
    cfg = tiny_llama(head_dim=64)
    qp = j_llama.quantize_params(
        j_llama.init_params(jcfg, jax.random.PRNGKey(1)),
        JQuantConfig(weights="int8", quantize_embedding=True))
    jprep = j_llama.prepare_params(qp, donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    jeng = JEngine(jcfg, jprep, engine_cfg=JEngineConfig(
        max_seq_len=S, decode_chunk=4, prefill_buckets=BUCKETS))
    teng = InferenceEngine(cfg, tprep, engine_cfg=EngineConfig(
        max_seq_len=S, decode_chunk=4, prefill_buckets=BUCKETS),
        device="cpu")
    return jcfg, jprep, jeng, teng


def _jax_gaps(jcfg, jprep, prompts, streams, S=S, cache_dtype=jnp.bfloat16):
    """JAX top-2 logit gap before each token of JAX's greedy streams."""
    B = len(prompts)
    T = max(BUCKETS)
    ids = np.zeros((B, T), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    last = np.array([len(p) - 1 for p in prompts], np.int32)
    cache = j_kv.init_cache(jcfg.num_layers, B, jcfg.num_kv_heads, S,
                            jcfg.head_dim, cache_dtype)
    logits, cache = j_llama.forward(jcfg, jprep, jnp.asarray(ids),
                                    jnp.asarray(pos), cache,
                                    last_idx=jnp.asarray(last))
    gaps = []
    nxt = last + 1
    for step in range(NEW):
        top2 = np.sort(np.asarray(logits), -1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        if step == NEW - 1:
            break
        tok = np.array([s[step] for s in streams], np.int32)[:, None]
        logits, cache = j_llama.forward(jcfg, jprep, jnp.asarray(tok),
                                        jnp.asarray(nxt[:, None]), cache)
        nxt = nxt + 1
    return np.stack(gaps, 1)                               # [B, NEW]


def _check_streams(jcfg, jprep, jeng, teng, prompts, **cache):
    want = [r.token_ids for r in jeng.generate(
        prompts, JGenerationConfig(max_new_tokens=NEW, greedy=True,
                                   eos_token_ids=()))]
    got = teng.generate(prompts, GenerationConfig(
        max_new_tokens=NEW, greedy=True, eos_token_ids=()))
    assert all(len(w) == NEW for w in want)
    gaps = _jax_gaps(jcfg, jprep, prompts, want, **cache)
    compared = 0
    for i, r in enumerate(got):
        assert len(r.token_ids) == NEW and not r.finished
        assert r.ttft_s > 0 and r.decode_tokens_per_s > 0
        for j in range(NEW):
            if gaps[i, j] <= GAP_TOL:
                break           # a near-tie: the streams may part here
            assert r.token_ids[j] == want[i][j], (i, j, r.token_ids, want[i])
            compared += 1
    assert compared >= NEW * len(prompts) // 2, gaps


@pytest.mark.parametrize("req", range(len(REQUESTS)))
def test_greedy_streams_match_jax(setup, req):
    _check_streams(*setup, REQUESTS[req])


S4 = 256
TINY4 = dict(hidden_size=256, intermediate_size=512, num_heads=4,
             num_kv_heads=2, head_dim=64, vocab_size=320, dtype="bfloat16")


@pytest.fixture(scope="module")
def setup4():
    """int4 g=128 weights and lm_head, int8 KV cache: decode runs K1 int4,
    K4, K2 int8 and K6 (and their TPU kernels on the JAX side)."""
    jcfg, cfg = j_tiny_llama(**TINY4), tiny_llama(**TINY4)
    qp = j_llama.init_params_quantized(
        jcfg, jax.random.PRNGKey(6), JQuantConfig(
            weights="int4", group_size=128, quantize_embedding=True))
    jprep = j_llama.prepare_params(qp, donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    ecfg = dict(max_seq_len=S4, decode_chunk=4, prefill_buckets=BUCKETS)
    jeng = JEngine(jcfg, jprep, engine_cfg=JEngineConfig(**ecfg),
                   cache_dtype="int8")
    teng = InferenceEngine(cfg, tprep, engine_cfg=EngineConfig(**ecfg),
                           cache_dtype="int8", device="cpu")
    return jcfg, jprep, jeng, teng


@pytest.mark.parametrize("req", range(len(REQUESTS)))
def test_greedy_streams_int4_int8kv_match_jax(setup4, req):
    _check_streams(*setup4, REQUESTS[req], S=S4, cache_dtype="int8")
    assert setup4[3].new_cache(1).k.dtype == torch.int8


def test_generate_records_the_jax_engines_metrics(setup):
    """One generate call observes the series the JAX engine observes
    (ttft_s and decode_tokens_per_s, engine.py:806, 843), once each:
    the snapshots have the same keys and the series the same number of
    observations."""
    jcfg, jprep, _, teng = setup
    jeng = JEngine(jcfg, jprep, engine_cfg=JEngineConfig(
        max_seq_len=S, decode_chunk=4, prefill_buckets=BUCKETS))
    teng = InferenceEngine(teng.cfg, teng.params, engine_cfg=teng.engine_cfg,
                           device="cpu")
    jeng.generate(REQUESTS[1], JGenerationConfig(max_new_tokens=NEW,
                                                 greedy=True))
    teng.generate(REQUESTS[1], GenerationConfig(max_new_tokens=NEW,
                                                greedy=True))
    jsnap, tsnap = jeng.metrics.snapshot(), teng.metrics.snapshot()
    assert set(tsnap) == set(jsnap)
    assert {"ttft_s_last", "decode_tokens_per_s_last"} <= set(tsnap)
    assert ({k: len(v) for k, v in teng.metrics._series.items()}
            == {k: len(v) for k, v in jeng.metrics._series.items()})
    assert tsnap["ttft_s_last"] > 0 and tsnap["decode_tokens_per_s_last"] > 0


def test_buckets_match_jax(setup):
    jcfg, jprep, jeng, teng = setup
    for n in (1, 15, 16, 17, 32, 33, 64, 100):
        assert teng._bucket(n) == jeng._bucket(n)
        assert teng.prefill_cache_len(n) == jeng.prefill_cache_len(n)
    # the default buckets over 4096 slots: a 3000-token prompt runs 2048 +
    # 1024-row chunks (engine.py:526-575)
    jeng = JEngine(jcfg, jprep, engine_cfg=JEngineConfig(max_seq_len=4096))
    teng = InferenceEngine(teng.cfg, teng.params, engine_cfg=EngineConfig(
        max_seq_len=4096), device="cpu")
    for n in (1000, 2047, 2048, 2049, 3000, 4000, 4096):
        assert teng._bucket(n) == jeng._bucket(n)
        assert teng.prefill_cache_len(n) == jeng.prefill_cache_len(n)
    assert teng.prefill_cache_len(3000) == 2048 + 1024


def test_cache_extent_off_128_warns_and_attends_plain(setup):
    """As the JAX engine (engine.py:66-80): a cache extent that is not a
    multiple of 128 warns, and attention then takes the plain path."""
    _, _, _, teng = setup
    with pytest.warns(UserWarning, match="multiple of 128"):
        InferenceEngine(teng.cfg, teng.params, engine_cfg=EngineConfig(
            max_seq_len=600), device="cpu")
    cfg = teng.cfg
    for T in (1, 512):
        assert llama.attention_route((1, T, cfg.num_heads, cfg.head_dim),
                                     600, False) == "attend"


def test_long_prompt_prefills_in_chunks(setup):
    """A prompt longer than the largest bucket runs as bucket-sized chunks
    over one cache; its logits equal one whole-prompt forward's."""
    _, _, _, teng = setup
    prompt = list(np.random.default_rng(2).integers(1, 200, 45))
    logits, _ = teng.prefill([prompt])
    cfg = teng.cfg
    cache = teng.new_cache(1)
    ids = torch.tensor([prompt], dtype=torch.int32)
    ref, _ = llama.forward(cfg, teng.params, ids,
                           torch.arange(45, dtype=torch.int32)[None], cache)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=1e-2)


def test_eos_and_stream_callback(setup):
    _, _, _, teng = setup
    free = teng.generate([[1, 17, 103]], GenerationConfig(
        max_new_tokens=5, greedy=True, eos_token_ids=()))[0].token_ids
    seen = []
    res = teng.generate([[1, 17, 103]], GenerationConfig(
        max_new_tokens=5, greedy=True, eos_token_ids=(free[2],)),
        stream=lambda row, tok, text: seen.append((row, tok)))[0]
    cut = free.index(free[2])
    assert res.finished and res.token_ids == free[:cut]
    assert seen == [(0, t) for t in free[:cut]]


def test_sampled_generation_is_seeded(setup):
    _, _, _, teng = setup
    gen = GenerationConfig(max_new_tokens=5, temperature=0.8, top_k=20,
                           top_p=0.9, seed=7, eos_token_ids=())
    a = teng.generate([[1, 2, 3]], gen)[0].token_ids
    b = teng.generate([[1, 2, 3]], gen)[0].token_ids
    assert a == b and all(0 <= t < teng.cfg.vocab_size for t in a)


def test_unported_sampling_knobs_raise(setup):
    """The penalties and logit_bias, once refused by the schedulers, are
    ported for their per-request sampling as for generate (both held to
    the JAX package: tests/test_torch_chat.py and
    tests/test_torch_scheduler_sampling.py): submit takes them, and a
    forcing bias gives generate's tokens."""
    from llm_inference_tpu_torch.engine.scheduler import (
        ContinuousBatchingScheduler)
    _, _, _, teng = setup
    sched = ContinuousBatchingScheduler(teng, GenerationConfig(
        max_new_tokens=4, eos_token_ids=()))
    for knobs in (dict(repetition_penalty=1.2), dict(logit_bias={3: 100.0})):
        res = teng.generate([[1, 2]], GenerationConfig(
            max_new_tokens=4, eos_token_ids=(), **knobs))[0]
        assert len(res.token_ids) == 4
        req = sched.submit([1, 2], 4, **knobs)
        while sched.step():
            pass
        assert len(req.output_ids) == 4
    assert res.token_ids == req.output_ids == [3] * 4


# ------------------------------------------ long prompts, three caches

LONG = 1000          # prompt tokens: two 512-row chunks over 2048 slots
LONG_S = 2048
LONG_BUCKETS = (128, 256, 512)
LONG_NEW = 5         # the first token, then one 4-step decode chunk
# prompt seeds: random int4 weights give flat logits, so the int4 cache's
# prompt is one whose first JAX top-2 gaps are not near-ties
LONG_SEED = {"bf16": 13, "int8": 13, "int4": 20}


def _long_engines(cache_dtype):
    """int8 weights over a bf16 cache (tiny_llama(head_dim=64)); int4 g=128
    weights over the int8 and int4 caches (the TINY4 widths); positions up
    to 2048."""
    if cache_dtype == "bf16":
        kw = dict(head_dim=64, max_position_embeddings=LONG_S)
        jcfg, cfg = j_tiny_llama(**kw), tiny_llama(**kw)
        qp = j_llama.quantize_params(
            j_llama.init_params(jcfg, jax.random.PRNGKey(11)),
            JQuantConfig(weights="int8", quantize_embedding=True))
    else:
        kw = dict(TINY4, max_position_embeddings=LONG_S)
        jcfg, cfg = j_tiny_llama(**kw), tiny_llama(**kw)
        qp = j_llama.init_params_quantized(jcfg, jax.random.PRNGKey(12),
                                           JQuantConfig(
                                               weights="int4",
                                               group_size=128,
                                               quantize_embedding=True))
    jprep = j_llama.prepare_params(qp, donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    ecfg = dict(max_seq_len=LONG_S, decode_chunk=4,
                prefill_buckets=LONG_BUCKETS)
    jdt = jnp.bfloat16 if cache_dtype == "bf16" else cache_dtype
    tdt = torch.bfloat16 if cache_dtype == "bf16" else cache_dtype
    jeng = JEngine(jcfg, jprep, engine_cfg=JEngineConfig(**ecfg),
                   cache_dtype=jdt)
    teng = InferenceEngine(cfg, tprep, engine_cfg=EngineConfig(**ecfg),
                           cache_dtype=tdt, device="cpu")
    return jprep, jeng, teng


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8", "int4"])
def test_long_prompt_prefill_and_greedy_stream_match_jax(cache_dtype):
    """A 1000-token prompt prefills in two 512-row chunks (the second at
    positions 512-1023 over the first's slots): the tiled GEMM (K8) and
    flash attention (K9) on both sides, the JAX package's in interpret
    mode. The prefill logits agree, and so do the greedy tokens wherever
    JAX's top-2 gap exceeds GAP_TOL (its gaps from its own forward,
    teacher-forced along its stream)."""
    jprep, jeng, teng = _long_engines(cache_dtype)
    cfg = teng.cfg
    prompt = [int(t) for t in np.random.default_rng(
        LONG_SEED[cache_dtype]).integers(1, cfg.vocab_size, LONG)]
    assert llama.attention_route((1, 512, cfg.num_heads, cfg.head_dim),
                                 LONG_S, cache_dtype != "bf16") == "flash"
    jlog, jc = jeng.prefill([prompt])
    tlog, tc = teng.prefill([prompt])
    assert tc.bits == {"bf16": 16, "int8": 8, "int4": 4}[cache_dtype]
    # as test_torch_model: logits within 1e-2
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-2,
                               rtol=0)
    want = jeng.generate([prompt], JGenerationConfig(
        max_new_tokens=LONG_NEW, greedy=True, eos_token_ids=()))[0].token_ids
    gaps = []
    logits, zeros = jlog, jnp.zeros((1,), jnp.int32)
    for j in range(LONG_NEW):
        top2 = np.sort(np.asarray(logits), -1)[0, -2:]
        gaps.append(top2[1] - top2[0])
        logits, jc = jeng._prefill_jit(
            jprep, jnp.asarray([[want[j]]], jnp.int32),
            jnp.asarray([[LONG + j]], jnp.int32), jc, zeros)
    got = teng.generate([prompt], GenerationConfig(
        max_new_tokens=LONG_NEW, greedy=True, eos_token_ids=()))[0].token_ids
    compared = 0
    for j in range(LONG_NEW):
        if gaps[j] <= GAP_TOL:
            break               # a near-tie: the streams may part here
        assert got[j] == want[j], (j, got, want)
        compared += 1
    assert compared >= LONG_NEW // 2, gaps
