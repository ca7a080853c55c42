"""The port's InferenceEngine.generate against the JAX package's, on the
CPU: greedy token streams of the slice's configuration at tiny width
(int8 weights and lm_head, head_dim 64, a 128-slot bf16 cache)."""

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


def _jax_gaps(jcfg, jprep, prompts, streams):
    """JAX top-2 logit gap before each token of JAX's greedy streams."""
    B = len(prompts)
    T = max(BUCKETS)
    ids = np.zeros((B, T), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    last = np.array([len(p) - 1 for p in prompts], np.int32)
    cache = j_kv.init_cache(jcfg.num_layers, B, jcfg.num_kv_heads, S,
                            jcfg.head_dim, jnp.bfloat16)
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


@pytest.mark.parametrize("req", range(len(REQUESTS)))
def test_greedy_streams_match_jax(setup, req):
    jcfg, jprep, jeng, teng = setup
    prompts = REQUESTS[req]
    want = [r.token_ids for r in jeng.generate(
        prompts, JGenerationConfig(max_new_tokens=NEW, greedy=True,
                                   eos_token_ids=()))]
    got = teng.generate(prompts, GenerationConfig(
        max_new_tokens=NEW, greedy=True, eos_token_ids=()))
    assert all(len(w) == NEW for w in want)
    gaps = _jax_gaps(jcfg, jprep, prompts, want)
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


def test_buckets_match_jax(setup):
    _, _, jeng, teng = setup
    for n in (1, 15, 16, 17, 32, 33, 64, 100):
        assert teng._bucket(n) == jeng._bucket(n)
        assert teng.prefill_cache_len(n) == jeng.prefill_cache_len(n)


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
    _, _, _, teng = setup
    for gen in (GenerationConfig(repetition_penalty=1.2),
                GenerationConfig(logit_bias={3: 1.0})):
        with pytest.raises(NotImplementedError):
            teng.generate([[1, 2]], gen)
