"""InferenceEngine.score and .embed of the port against the JAX package's,
on the CPU (tiny int8 and bf16 models): per-token prompt logprobs, with a
prompt longer than the largest prefill bucket so that its chunks continue
one cache, and L2-normalised embeddings pooled at the last token or over
the prompt."""

import copy

import numpy as np
import pytest

from llm_inference_tpu_torch.config import GenerationConfig
from llm_inference_tpu_torch.engine import scheduler as t_sched

from torch_bridge import engine_pair

# buckets of 8 and 16 rows: the 40-token prompt scores in chunks of
# 16 + 16 + 8 over one 64-slot cache
ECFG = dict(max_seq_len=64, decode_chunk=4, max_batch_size=2,
            prefill_buckets=(8, 16))
# the port's logits agree with the JAX package's within 1e-2
# (test_torch_model): so do logprobs, to within twice that; the unit
# embeddings agree to 5e-3 in each coordinate
SCORE_TOL = 2e-2
EMBED_TOL = 5e-3


@pytest.fixture(scope="module")
def engines():
    return {w: engine_pair(w, head_scale=1.0, **ECFG)
            for w in ("int8", "bf16")}


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(3, 256, n).tolist() for n in (40, 7, 16, 1)]


@pytest.mark.parametrize("weights", ["int8", "bf16"])
def test_score_matches_jax(engines, weights):
    jeng, teng = engines[weights]
    prompts = _prompts()
    want = jeng.score(prompts)
    got = teng.score(prompts)
    assert [len(g) for g in got] == [len(p) for p in prompts]
    for g, w in zip(got, want):
        assert g[0] is None and w[0] is None
        np.testing.assert_allclose(g[1:], w[1:], atol=SCORE_TOL)
        assert all(x <= 0.0 for x in g[1:])


@pytest.mark.parametrize("pooling", ["last", "mean"])
@pytest.mark.parametrize("weights", ["int8", "bf16"])
def test_embed_matches_jax(engines, weights, pooling):
    jeng, teng = engines[weights]
    prompts = _prompts()
    want = np.asarray(jeng.embed(prompts, pooling=pooling))
    got = np.asarray(teng.embed(prompts, pooling=pooling))
    assert got.shape == (len(prompts), teng.cfg.hidden_size)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(got, want, atol=EMBED_TOL)


def test_score_agrees_with_the_decoded_logprobs(engines):
    """The logprobs a greedy scheduler reports for its own continuation
    are the scores of that continuation after the prompt: the decode
    steps and the all-logits prefill chunks compute one distribution."""
    teng = engines["int8"][1]
    prompt = _prompts()[0][:20]
    sched = t_sched.ContinuousBatchingScheduler(teng, GenerationConfig(
        greedy=True, max_new_tokens=12, eos_token_ids=()))
    (req,) = sched.run([prompt])
    scored = teng.score([prompt + req.output_ids])[0][len(prompt):]
    np.testing.assert_allclose(scored, req.output_logprobs, atol=1e-3)


def test_score_and_embed_refusals(engines):
    teng = engines["int8"][1]
    with pytest.raises(ValueError):
        teng.embed([[5, 6], []])
    with pytest.raises(ValueError):
        teng.embed([[5, 6]], pooling="max")
    with pytest.raises(ValueError):
        teng.score([list(range(3, 70))])            # 67 > 64 slots
    assert teng.score([[]]) == [[]] and teng.adapter_slots == {}
    tp = copy.copy(teng)
    tp.tp = object()                                # one rank of a TP model
    for call in (tp.score, tp.embed):
        with pytest.raises(NotImplementedError):
            call([[5, 6, 7]])
