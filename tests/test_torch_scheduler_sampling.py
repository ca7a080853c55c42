"""Per-request penalties and logit_bias in the port's schedulers, against
the JAX package on the CPU: sample_per_row's shaping of the logits (bias,
guided mask, penalties, then the greedy argmax and the filtered draw),
and the greedy streams of ContinuousBatchingScheduler and PagedScheduler
with penalised and biased requests mixed with plain ones, dense, paged
and through preemption (tiny int8 model over a bf16 cache)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.config import GenerationConfig as JGenerationConfig
from llm_inference_tpu.engine import scheduler as j_sched
from llm_inference_tpu.ops import sampling as j_sampling

from llm_inference_tpu_torch.config import GenerationConfig
from llm_inference_tpu_torch.engine import scheduler as t_sched
from llm_inference_tpu_torch.ops import sampling as t_sampling

from torch_bridge import engine_pair, to_torch

ECFG = dict(max_seq_len=64, decode_chunk=4, max_batch_size=2,
            prefill_buckets=(8, 16), page_size=8)
NEW = 12


# ------------------------------------------------------------ sampling

KNOBS = dict(temperature=[0.0, 1.3, 0.7, 1.0, 0.9, 2.0],
             top_k=[0, 0, 5, 40, 0, 0], top_p=[1.0, 0.9, 1.0, 0.95, 1.0, 1.0],
             greedy=[True, False, False, False, True, False],
             min_p=[0.0, 0.05, 0.0, 0.0, 0.0, 0.1])


def _shaping(rng, B, V, stages):
    """Random inputs of the stages named: a bias [B, V], an allowed mask
    [B, V] (at least 3 tokens a row), penalties (counts, seen, rep, pres,
    freq)."""
    out = {}
    if "bias" in stages:
        bias = np.zeros((B, V), np.float32)
        for b in range(B):
            ids = rng.choice(V, 6, replace=False)
            bias[b, ids] = rng.choice([-100.0, -3.0, 2.5, 8.0], 6)
        out["bias"] = bias
    if "allowed" in stages:
        allowed = rng.random((B, V)) < 0.3
        allowed[:, :3] = True
        out["allowed"] = allowed
    if "penalties" in stages:
        counts = rng.integers(0, 3, (B, V)).astype(np.int32)
        counts[rng.random((B, V)) < 0.8] = 0
        seen = (counts > 0) | (rng.random((B, V)) < 0.1)
        out["penalties"] = (counts, seen,
                            np.array([1.0, 1.3, 0.8, 1.5, 2.0, 1.1],
                                     np.float32)[:B],
                            np.array([0.0, 0.5, 1.0, 0.0, 2.0, 0.3],
                                     np.float32)[:B],
                            np.array([0.0, 0.2, 0.0, 0.7, 1.0, 0.1],
                                     np.float32)[:B])
    return out


@pytest.mark.parametrize("stages", [("bias",), ("allowed",), ("penalties",),
                                    ("bias", "allowed", "penalties")])
def test_sample_per_row_shaping_matches_jax(stages):
    """Bias, then the guided mask, then the penalties, in the JAX order:
    fed the Gumbel noise that JAX's seeded mode draws, every row (greedy
    and sampled) picks JAX's token, so the greedy argmax and the filtered
    supports agree; no row picks a token outside its mask."""
    rng = np.random.default_rng(len(stages))
    B, V = 6, 96
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    shp = _shaping(rng, B, V, stages)
    jk = {k: jnp.asarray(v) for k, v in KNOBS.items()}
    tk = {k: torch.tensor(v) for k, v in KNOBS.items()}
    jx = {k: (tuple(jnp.asarray(a) for a in v) if k == "penalties"
              else jnp.asarray(v)) for k, v in shp.items()}
    tx = {k: (tuple(torch.from_numpy(np.asarray(a)) for a in v)
              if k == "penalties" else torch.from_numpy(v))
          for k, v in shp.items()}
    for trial in range(16):
        seeds = np.arange(B, dtype=np.int32) * 5 + trial
        pos = np.full((B,), 40 + trial, np.int32)
        keys = j_sampling.row_keys(jnp.asarray(seeds), jnp.asarray(pos))
        gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (V,),
                                                      jnp.float32))(keys)
        want = np.asarray(j_sampling.sample_per_row(
            jnp.asarray(logits), keys, jk["temperature"], jk["top_k"],
            jk["top_p"], jk["greedy"], 64, True, min_p=jk["min_p"], **jx))
        got = t_sampling.sample_per_row(
            torch.from_numpy(logits), to_torch(gumbel), tk["temperature"],
            tk["top_k"], tk["top_p"], tk["greedy"], 64, True,
            min_p=tk["min_p"], **tx).numpy()
        assert got.tolist() == want.tolist(), trial
        if "allowed" in shp:
            assert shp["allowed"][np.arange(B), got].all()


def test_greedy_argmax_comes_after_bias_mask_and_penalties():
    """A greedy row's pick is the argmax of the shaped logits, not of the
    raw ones: a bias, a mask and a presence penalty each move it."""
    V = 16
    logits = torch.zeros((3, V))
    logits[:, 0] = 5.0                     # the raw argmax of every row
    logits[:, 1] = 4.0
    knob = dict(temperature=torch.zeros(3), top_k=torch.zeros(3, dtype=int),
                top_p=torch.ones(3), greedy=torch.ones(3, dtype=torch.bool))
    noise = torch.zeros((3, V))
    bias = torch.zeros((3, V))
    bias[0, 7] = 10.0                      # row 0: biased onto token 7
    allowed = torch.ones((3, V), dtype=torch.bool)
    allowed[1, 0] = False                  # row 1: token 0 masked out
    counts = torch.zeros((3, V), dtype=torch.int32)
    counts[2, 0] = 1                       # row 2: token 0 already emitted
    pen = (counts, counts > 0, torch.ones(3), torch.tensor([0.0, 0.0, 3.0]),
           torch.zeros(3))
    got = t_sampling.sample_per_row(logits, noise, **knob, max_top_k=0,
                                    use_top_p=False, penalties=pen,
                                    bias=bias, allowed=allowed)
    assert got.tolist() == [7, 1, 1]


# ------------------------------------------------- schedulers vs JAX

@pytest.fixture(scope="module")
def engines():
    return engine_pair("int8", **ECFG)


def _requests(vocab):
    """Six requests over two slots: penalised (each knob alone and all
    three), biased (a forced token, a banned one), and plain ones; the
    first prompts take two prefill chunks."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, vocab, n).tolist()
               for n in (21, 18, 5, 9, 12, 4)]
    knobs = [dict(repetition_penalty=1.3, presence_penalty=0.6,
                  frequency_penalty=0.4),
             {},
             dict(logit_bias={17: 100.0, 40: -100.0}),
             dict(repetition_penalty=2.0),
             dict(presence_penalty=1.5, logit_bias={5: 3.0}),
             dict(frequency_penalty=0.8)]
    return prompts, knobs


def _serve(sched, prompts, knobs, streams=None):
    reqs = []
    for p, kw in zip(prompts, knobs):
        kw = dict(kw)
        if streams is not None:
            kw["stream"] = lambda rid, t: streams.setdefault(rid, []).append(t)
        reqs.append(sched.submit(list(p), **kw))
    while sched.step():
        pass
    return reqs


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_penalties_and_bias_match_jax_schedulers(engines, kind):
    """Penalised and biased requests mixed with plain ones, admitted in
    waves into two slots (a retired biased slot is reused by a plain
    request): the port's greedy streams are the JAX scheduler's, dense,
    and paged on an 8-page pool that preempts and replays. (The JAX
    package's own dense and paged runs differ in bf16 rounding, which a
    near-tie of the penalised logits can turn into another token: these
    prompts meet none.)"""
    jeng, teng = engines
    prompts, knobs = _requests(teng.cfg.vocab_size)
    kw = {} if kind == "dense" else {"num_pages": 8}
    name = ("ContinuousBatchingScheduler" if kind == "dense"
            else "PagedScheduler")
    js = getattr(j_sched, name)(jeng, JGenerationConfig(
        greedy=True, max_new_tokens=NEW, eos_token_ids=()), **kw)
    ts = getattr(t_sched, name)(teng, GenerationConfig(
        greedy=True, max_new_tokens=NEW, eos_token_ids=()), **kw)
    want = _serve(js, prompts, knobs)
    got = _serve(ts, prompts, knobs)
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    assert all(len(r.output_ids) == NEW for r in got)
    assert got[2].output_ids == [17] * NEW           # the bias bites
    if kind == "paged":
        assert ts.preemptions > 0


def test_penalised_sampled_request_replays_after_preemption(engines):
    """A sampled request with penalties and a bias draws the same tokens
    on the paged scheduler alone, with batch-mates, and on a pool so small
    that it is preempted and replayed; its client is streamed every token
    once."""
    teng = engines[1]
    prompts, knobs = _requests(teng.cfg.vocab_size)
    knobs = [dict(kw, temperature=1.0, top_p=0.95, seed=300 + i)
             for i, kw in enumerate(knobs)]
    gen = GenerationConfig(max_new_tokens=NEW, eos_token_ids=())
    alone = [_serve(t_sched.PagedScheduler(teng, gen), [p], [kw])[0]
             .output_ids for p, kw in zip(prompts, knobs)]
    streams = {}
    tight = t_sched.PagedScheduler(teng, gen, num_pages=8)
    replay = _serve(tight, prompts, knobs, streams)
    assert tight.preemptions > 0
    assert [r.output_ids for r in replay] == alone
    assert [streams[r.req_id] for r in replay] == alone
    batch = _serve(t_sched.PagedScheduler(teng, gen), prompts, knobs)
    assert [r.output_ids for r in batch] == alone
