"""The port's schedulers against the JAX package's, on the CPU: prefix
hashes and the prefix store, per-row sampling (the same filtered
distributions: equal draws under equal Gumbel noise), top logprobs, and
the greedy streams of ContinuousBatchingScheduler and PagedScheduler on
tiny models (int8 weights over a bf16 cache, int4 g=128 weights over an
int8 and an int4 cache), compared up to the first near-tie of the JAX
run's top-2 logprobs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.config import EngineConfig as JEngineConfig
from llm_inference_tpu.config import GenerationConfig as JGenerationConfig
from llm_inference_tpu.config import QuantConfig as JQuantConfig
from llm_inference_tpu.config import tiny_llama as j_tiny_llama
from llm_inference_tpu.engine import prefix_cache as j_prefix
from llm_inference_tpu.engine import scheduler as j_sched
from llm_inference_tpu.engine.engine import InferenceEngine as JEngine
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.ops import sampling as j_sampling

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            QuantConfig, tiny_llama)
from llm_inference_tpu_torch.engine import prefix_cache as t_prefix
from llm_inference_tpu_torch.engine import scheduler as t_sched
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import sampling as t_sampling

from torch_bridge import assert_streams_agree, to_numpy_tree, to_torch

# the port's logits agree with the JAX package's within 1e-2
# (test_torch_model); where JAX's top-2 gap is wider, argmax must agree
GAP_TOL = 2e-2


# ------------------------------------------------------- prefix cache

@pytest.mark.parametrize("n,ps,salt", [(1, 8, 0), (8, 8, 0), (9, 8, 0),
                                       (300, 128, 0), (257, 128, 3),
                                       (40, 16, 1)])
def test_chunk_hashes_match_jax_bytes(n, ps, salt):
    toks = np.random.default_rng(n).integers(0, 32000, n).tolist()
    assert (t_prefix.chunk_hashes(toks, ps, salt)
            == j_prefix.chunk_hashes(toks, ps, salt))


def test_prefix_store_matches_jax():
    """The same operations give the same pages, counters and evictions."""
    stores = (j_prefix.PrefixStore(), t_prefix.PrefixStore())
    a = j_prefix.chunk_hashes(list(range(40)), 8)
    b = j_prefix.chunk_hashes(list(range(16)) + [7] * 24, 8)
    log = []
    for s in stores:
        out = [s.insert(a[0], 11), s.insert(a[1], 12), s.insert(a[0], 99),
               s.lookup(a, 8), s.lookup(b, 8), s.owns(11), s.owns(99)]
        s.insert(b[2], 13)
        s.release(11)
        s.release(12)
        out += [s.evict(1), s.lookup(a, 8), s.evict(5), len(s),
                s.hit_tokens, s.miss_tokens]
        log.append(out)
    assert log[0] == log[1]


# ------------------------------------------------------------ sampling

KNOBS = dict(temperature=[0.7, 1.3, 0.0, 1.0, 0.5],
             top_k=[5, 0, 3, 64, 0], top_p=[0.9, 0.5, 1.0, 1.0, 0.8],
             greedy=[False, False, False, True, False],
             min_p=[0.0, 0.05, 0.0, 0.1, 0.2])


@pytest.mark.parametrize("max_top_k,use_top_p,use_min_p", [
    (8, True, True), (0, True, False), (8, False, False)])
def test_sample_per_row_matches_jax_under_equal_noise(max_top_k, use_top_p,
                                                      use_min_p):
    """sample_per_row's filters (temperature, min-p, top-k clamped to
    max_top_k, top-p, greedy rows) in the JAX order: fed the Gumbel noise
    that JAX's seeded mode draws from row_keys, every draw is the same
    token, so the filtered distributions agree."""
    rng = np.random.default_rng(max_top_k + use_top_p)
    B, V = 5, 96
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    jk = {k: jnp.asarray(v) for k, v in KNOBS.items()}
    tk = {k: torch.tensor(v) for k, v in KNOBS.items()}
    draws = 0
    for trial in range(40):
        seeds = np.arange(B, dtype=np.int32) * 7 + trial
        pos = np.full((B,), 100 + trial, np.int32)
        keys = j_sampling.row_keys(jnp.asarray(seeds), jnp.asarray(pos))
        gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (V,),
                                                      jnp.float32))(keys)
        want = j_sampling.sample_per_row(
            jnp.asarray(logits), keys, jk["temperature"], jk["top_k"],
            jk["top_p"], jk["greedy"], max_top_k, use_top_p,
            min_p=jk["min_p"] if use_min_p else None)
        got = t_sampling.sample_per_row(
            torch.from_numpy(logits), to_torch(gumbel), tk["temperature"],
            tk["top_k"], tk["top_p"], tk["greedy"], max_top_k, use_top_p,
            min_p=tk["min_p"] if use_min_p else None)
        assert got.tolist() == np.asarray(want).tolist(), trial
        draws += len(set(np.asarray(want)[0:2].tolist()))
    assert draws > 40          # the sampled rows do vary between trials


def test_top_logprobs_match_jax():
    logits = np.random.default_rng(1).standard_normal((3, 50)).astype(
        np.float32)
    jv, ji = j_sampling.top_logprobs(jnp.asarray(logits), 4)
    tv, ti = t_sampling.top_logprobs(torch.from_numpy(logits), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def test_row_noise_depends_on_seed_and_position_only():
    seeds = torch.tensor([3, 9, 3, 1])
    pos = torch.tensor([10, 10, 10, 11])
    batch = t_sampling.row_noise(seeds, pos, 200)
    for b in range(4):
        alone = t_sampling.row_noise(seeds[b:b + 1], pos[b:b + 1], 200)
        assert torch.equal(alone[0], batch[b])
    assert torch.equal(batch[0], batch[2])
    assert not torch.equal(batch[0], batch[1])
    assert not torch.equal(batch[0], t_sampling.row_noise(
        torch.tensor([3]), torch.tensor([11]), 200)[0])
    # Gumbel(0, 1): mean 0.577, finite
    assert torch.isfinite(batch).all()
    assert abs(t_sampling.row_noise(torch.arange(64), torch.zeros(64),
                                    500).mean().item() - 0.5772) < 0.02


# ---------------------------------------------- greedy streams vs JAX

TINY4 = dict(hidden_size=256, intermediate_size=512, num_heads=4,
             num_kv_heads=2, head_dim=64, vocab_size=320, dtype="bfloat16")
CONFIGS = {"int8-bf16kv": ("int8", "bf16"), "int4-int8kv": ("int4", "int8"),
           "int4-int4kv": ("int4", "int4")}
ECFG = dict(max_seq_len=64, decode_chunk=4, max_batch_size=2,
            prefill_buckets=(8, 16), page_size=8)
NEW = 8


def _engines(weights, kv):
    """Tiny engines of both packages on the same weights. Random weights
    give near-flat logits, so lm_head's scales are raised (the same
    weights on both sides) to leave most steps comparable: 64x for the
    float32 int8 model; 2x for the bf16 int4 model, whose logits are bf16
    and must stay below 2 so that two bf16 steps stay below GAP_TOL."""
    if weights == "int8":
        kw = dict(head_dim=64)
        jcfg, cfg = j_tiny_llama(**kw), tiny_llama(**kw)
        qp = j_llama.quantize_params(
            j_llama.init_params(jcfg, jax.random.PRNGKey(21)),
            JQuantConfig(weights="int8", quantize_embedding=True))
    else:
        jcfg, cfg = j_tiny_llama(**TINY4), tiny_llama(**TINY4)
        qp = j_llama.init_params_quantized(
            jcfg, jax.random.PRNGKey(22), JQuantConfig(
                weights="int4", group_size=128, quantize_embedding=True))
    qp = dict(qp, lm_head=qp["lm_head"].replace(
        scale=qp["lm_head"].scale * (64 if weights == "int8" else 2)))
    jprep = j_llama.prepare_params(qp, donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    jdt = jnp.bfloat16 if kv == "bf16" else kv
    tdt = torch.bfloat16 if kv == "bf16" else kv
    jeng = JEngine(jcfg, jprep, engine_cfg=JEngineConfig(**ECFG),
                   cache_dtype=jdt)
    teng = InferenceEngine(cfg, tprep, engine_cfg=EngineConfig(**ECFG),
                           cache_dtype=tdt, device="cpu")
    return jeng, teng


def _prompts(vocab, seed=5):
    """Five requests over two slots: a shared 17-token prefix (two full
    pages of 8), a 21-token prompt that prefills in two chunks, short
    ones."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(3, vocab, 17).tolist()
    return [shared + rng.integers(3, vocab, 5).tolist(),
            rng.integers(3, vocab, 21).tolist(),
            shared + rng.integers(3, vocab, 3).tolist(),
            rng.integers(3, vocab, 4).tolist(),
            rng.integers(3, vocab, 11).tolist()]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_greedy_streams_match_jax_schedulers(config):
    """Both schedulers over the same requests: wave admission, chunked
    admission (interleaved with decode), the paged scheduler with its
    prefix cache; logprobs and top-2 logprobs come along."""
    jeng, teng = _engines(*CONFIGS[config])
    prompts = _prompts(teng.cfg.vocab_size)
    jgen = JGenerationConfig(greedy=True, max_new_tokens=NEW,
                             eos_token_ids=())
    gen = GenerationConfig(greedy=True, max_new_tokens=NEW, eos_token_ids=())
    for name, kw in (("ContinuousBatchingScheduler", {}),
                     ("PagedScheduler", {"prefix_cache": True})):
        js = getattr(j_sched, name)(jeng, jgen, **kw)
        ts = getattr(t_sched, name)(teng, gen, **kw)
        want = [js.submit(list(p), top_logprobs=2) for p in prompts]
        got = [ts.submit(list(p), top_logprobs=2) for p in prompts]
        while js.step():
            pass
        while ts.step():
            pass
        assert_streams_agree(got, want, GAP_TOL)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.output_logprobs[:2],
                                       w.output_logprobs[:2], atol=2e-2)
        if kw:
            assert ts.store.hit_tokens == js.store.hit_tokens > 0
            assert ts.alloc.free_pages == js.alloc.free_pages
        assert ts.phase_n["chunks"] > 0 and ts.phase_n["admit"] >= 5


# ------------------------------------ the port's schedulers on their own

@pytest.fixture(scope="module")
def tiny_engine():
    """A tiny int8 model over a bf16 cache on the CPU (the ECFG knobs:
    2 slots, page size 8, chunks of at most 16 rows); lm_head is sharpened
    64x so that greedy streams stay far from ties."""
    cfg = tiny_llama(head_dim=64)
    p = llama.prepare_params(llama.init_params_quantized(
        cfg, QuantConfig(weights="int8", quantize_embedding=True), seed=7,
        device="cpu"))
    p["lm_head"].scale.mul_(64)
    return InferenceEngine(cfg, p, engine_cfg=EngineConfig(**ECFG),
                           cache_dtype=torch.bfloat16, device="cpu")


def _serve(sched, prompts, knobs=None, streams=None):
    """Submit every prompt (knobs[i]: its submit keywords; streams: a dict
    that collects each request's streamed tokens) and step to the end."""
    reqs = []
    for i, p in enumerate(prompts):
        kw = dict(knobs[i]) if knobs else {}
        if streams is not None:
            kw["stream"] = lambda rid, t: streams.setdefault(rid, []).append(t)
        reqs.append(sched.submit(list(p), **kw))
    while sched.step():
        pass
    return reqs


GEN12 = GenerationConfig(max_new_tokens=12, eos_token_ids=())
GREEDY12 = GenerationConfig(greedy=True, max_new_tokens=12, eos_token_ids=())


def test_seeded_draws_replay_alone_with_batchmates_and_after_preemption(
        tiny_engine):
    """A sampled request's tokens depend only on its seed and positions:
    served alone, with batch-mates, and through a pool so small that
    requests are preempted and replayed, it draws the same tokens; each
    client is streamed every token exactly once. (A request preempted in
    the step that admitted it replays without its unread first token; the
    reference's replay starts with that token twice.)"""
    prompts = _prompts(tiny_engine.cfg.vocab_size)
    knobs = [dict(temperature=1.0, top_p=0.95, top_k=40, seed=100 + i)
             for i in range(len(prompts))]
    alone = [_serve(t_sched.PagedScheduler(tiny_engine, GEN12), [p],
                    [kw])[0].output_ids for p, kw in zip(prompts, knobs)]
    batch = _serve(t_sched.PagedScheduler(tiny_engine, GEN12), prompts,
                   knobs)
    assert [r.output_ids for r in batch] == alone
    streams = {}
    tight = t_sched.PagedScheduler(tiny_engine, GEN12, num_pages=8)
    replay = _serve(tight, prompts, knobs, streams)
    assert tight.preemptions > 0
    assert [r.output_ids for r in replay] == alone
    assert [streams[r.req_id] for r in replay] == alone
    greedy = _serve(t_sched.PagedScheduler(tiny_engine, GREEDY12), prompts)
    assert [r.output_ids for r in greedy] != alone     # the draws do sample


def test_prefix_hits_and_pages_released(tiny_engine):
    """With the prefix cache the shared prompt pages are mapped, not
    prefilled, the streams agree with the uncached run, and every page is
    back in the pool or the store at the end."""
    prompts = _prompts(tiny_engine.cfg.vocab_size)
    top2 = [dict(top_logprobs=2)] * len(prompts)
    want = _serve(t_sched.PagedScheduler(tiny_engine, GREEDY12), prompts,
                  top2)
    sched = t_sched.PagedScheduler(tiny_engine, GREEDY12, prefix_cache=True)
    got = _serve(sched, prompts, top2)
    assert_streams_agree(got, want, GAP_TOL)
    assert sched.store.hit_tokens >= 16          # two shared pages of 8
    assert not any(sched.slot_pages)
    assert not sched.pt_host.any()
    assert (sched.alloc.free_pages + len(sched.store)
            == sched.alloc.num_pages - 1)


@pytest.mark.parametrize("prefix", [False, True])
def test_interleaved_chunked_admission_matches_serial(tiny_engine,
                                                      monkeypatch, prefix):
    """A 40-token prompt admits in three chunks (16 + 16 + 8 rows); with
    interleaving, the active request decodes between them with the
    admitting row parked on the null page. Neither stream changes."""
    rng = np.random.default_rng(3)
    long_prompt = rng.integers(3, 256, 40).tolist()
    calls = []
    orig = t_sched.PagedScheduler._interleave_decode
    monkeypatch.setattr(t_sched.PagedScheduler, "_interleave_decode",
                        lambda self, s: (calls.append(s), orig(self, s)))

    def run(interleave):
        sched = t_sched.PagedScheduler(tiny_engine, GREEDY12,
                                       prefix_cache=prefix,
                                       interleave_prefill=interleave)
        a = sched.submit([5, 6, 7], temperature=2.0, seed=11)
        sched.step()                     # a admitted, one decode chunk
        b = sched.submit(list(long_prompt))
        while sched.step():
            pass
        return a.output_ids, b.output_ids

    serial = run(False)
    assert not calls
    assert run(True) == serial
    assert len(calls) == 2 and len(serial[1]) == 12


@pytest.mark.parametrize("name", ["ContinuousBatchingScheduler",
                                  "PagedScheduler"])
def test_wave_admission_matches_serial(tiny_engine, name):
    """A burst admitted as one wave (one padded prefill per chunk) gives
    the streams of one-by-one admission."""
    prompts = _prompts(tiny_engine.cfg.vocab_size, seed=8)
    top2 = [dict(top_logprobs=2)] * len(prompts)
    runs = []
    for wave in (True, False):
        sched = getattr(t_sched, name)(tiny_engine, GREEDY12)
        sched.wave_admission = wave
        runs.append(_serve(sched, prompts, top2))
    assert_streams_agree(runs[0], runs[1], GAP_TOL)


@pytest.mark.parametrize("name", ["ContinuousBatchingScheduler",
                                  "PagedScheduler"])
def test_cancel_queued_and_active(tiny_engine, name):
    sched = getattr(t_sched, name)(tiny_engine, GREEDY12)
    a, b, c = (sched.submit(p) for p in ([5, 6, 7], [8, 9], [10, 11, 12]))
    assert sched.cancel(c) and c not in sched.queue     # queued: dropped
    sched.step()
    assert sched.slot_req[:2] == [a, b]
    assert sched.cancel(a)                               # active: flagged
    while sched.step():
        pass
    assert c.output_ids == [] and c.cancelled
    assert 1 <= len(a.output_ids) < 12 and a.done_t > 0
    assert len(b.output_ids) == 12
    assert sched.slot_req == [None, None]
    if name == "PagedScheduler":
        assert sched.alloc.free_pages == sched.alloc.num_pages - 1


@pytest.mark.parametrize("name", ["ContinuousBatchingScheduler",
                                  "PagedScheduler"])
def test_drain_inflight_then_adopt_replays(tiny_engine, name):
    """Requests drained mid-flight from one scheduler and adopted by
    another (with the first's queue) finish with the undisturbed run's
    tokens, and no client sees a token twice."""
    prompts = _prompts(tiny_engine.cfg.vocab_size, seed=9)
    knobs = [dict(temperature=0.8, seed=40 + i) for i in range(len(prompts))]
    want = _serve(getattr(t_sched, name)(tiny_engine, GEN12), prompts, knobs)
    streams = {}
    first = getattr(t_sched, name)(tiny_engine, GEN12)
    reqs = [first.submit(list(p), stream=lambda rid, t: streams.setdefault(
        rid, []).append(t), **kw) for p, kw in zip(prompts, knobs)]
    for _ in range(3):
        first.step()
    assert any(r.output_ids for r in reqs)
    drained = first.drain_inflight()
    assert drained and all(r.output_ids == [] for r in drained)
    assert first.slot_req == [None, None]
    moved = list(first.queue)
    first.queue.clear()
    second = getattr(t_sched, name)(tiny_engine, GEN12)
    second.adopt(moved)
    while second.step():
        pass
    assert [r.output_ids for r in reqs] == [r.output_ids for r in want]
    assert [streams[r.req_id] for r in reqs] == [r.output_ids for r in want]
    if name == "PagedScheduler":
        assert first.alloc.free_pages == first.alloc.num_pages - 1


def test_stop_token_ids(tiny_engine):
    """A stop id ends its request at that token: recorded, not streamed."""
    prompt = _prompts(tiny_engine.cfg.vocab_size)[1]
    ref = _serve(t_sched.PagedScheduler(tiny_engine, GREEDY12),
                 [prompt])[0].output_ids
    j = next(i for i in range(2, 12) if ref[i] not in ref[:i])
    streams = {}
    sched = t_sched.PagedScheduler(tiny_engine, GREEDY12)
    (got,) = _serve(sched, [prompt], [dict(stop_token_ids=[ref[j]])],
                    streams)
    assert got.output_ids == ref[:j + 1] and got.finished
    assert streams[got.req_id] == ref[:j]


def test_admit_batch_resyncs_table_when_every_row_fails(tiny_engine):
    """Two 40-token prompts admit as one wave; the second chunk finds no
    pages for either row. Both rows are undone and requeued, and the
    device table no longer maps the pages they freed (the reference leaves
    them mapped for the idle slots' garbage decode, scheduler.py:1392)."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 256, 40).tolist() for _ in range(2)]
    sched = t_sched.PagedScheduler(tiny_engine, GREEDY12, prefix_cache=True)
    reqs = [sched.submit(p) for p in prompts]
    orig, calls = sched._ensure_blocks, []

    def starve(slot, n):
        calls.append(slot)
        return orig(slot, n) if len(calls) <= 2 else (False, False)
    sched._ensure_blocks = starve
    sched.step()
    assert len(calls) == 4 and list(sched.queue) == reqs
    assert not sched.pt_host.any() and not any(sched.slot_pages)
    assert torch.equal(sched.cache.page_table,
                       torch.zeros_like(sched.cache.page_table))
    del sched._ensure_blocks                  # pages again: both complete
    while sched.step():
        pass
    assert all(len(r.output_ids) == 12 for r in reqs)


def test_page_table_snapshot_is_a_copy(tiny_engine):
    """Every sync hands the device a fresh copy of the host table: later
    host edits (parking, growth) do not reach queued work."""
    sched = t_sched.PagedScheduler(tiny_engine, GREEDY12)
    sched.pt_host[0, :3] = [4, 5, 6]
    sched._sync_table()
    before = sched.cache.page_table.clone()
    sched.pt_host[0, :3] = 0
    sched.pt_host[1, 0] = 9
    assert torch.equal(sched.cache.page_table, before)
    assert sched.cache.page_table[0, :3].tolist() == [4, 5, 6]
    rows = sched._table_snapshot(sched.pt_host[1:2, :2])
    sched.pt_host[1, 0] = 3
    assert rows.tolist() == [[9, 0]]


def test_submit_refuses_what_is_not_ported(tiny_engine):
    """An adapter on an engine without LoRA stacks raises JAX's ValueError
    (engine.py:193-194); penalties, logit_bias and guided decoding are
    ported, and submit refuses only bad values of them."""
    sched = t_sched.PagedScheduler(tiny_engine, GREEDY12, num_pages=4)
    with pytest.raises(ValueError, match="no LoRA"):
        sched.submit([5, 6, 7], adapter="x")
    for kw in (dict(repetition_penalty=0.0),
               dict(logit_bias={tiny_engine.cfg.vocab_size: 1.0}),
               dict(guided_regex="a+"),                 # no tokenizer
               dict(guided_choice=["a", "b"]),          # no tokenizer
               dict(guided_choice=[[5]], guided_regex="a+")):
        with pytest.raises(ValueError):
            sched.submit([5, 6, 7], **kw)
    with pytest.raises(ValueError):
        sched.submit([5, 6, 7], top_logprobs=t_sched.TOP_LOGPROBS_CAP + 1)
    with pytest.raises(ValueError):            # above max_top_k (64)
        sched.submit([5, 6, 7], top_k=65)
    with pytest.raises(ValueError):            # 4 pages of 8 > 3 usable
        sched.submit(list(range(3, 23)), max_new_tokens=12)
    with pytest.raises(ValueError):
        sched.submit([5, 6, 7], stop=["x"])          # no tokenizer
    assert not sched.queue
    ok = sched.submit([5, 6, 7], repetition_penalty=1.2, logit_bias={3: 1.0},
                      guided_choice=[[5, 6]], stop_token_ids=[2])
    assert list(sched.queue) == [ok] and ok.constraint is not None


def _engine_like(eng, **kw):
    """A second CPU engine on eng's weights (engine knobs in kw: EngineConfig
    fields, or tokenizer)."""
    tok = kw.pop("tokenizer", None)
    return InferenceEngine(eng.cfg, eng.params, engine_cfg=EngineConfig(
        **dict(ECFG, **kw)), tokenizer=tok, cache_dtype=eng.cache_dtype,
        device="cpu")


@pytest.mark.parametrize("name", ["ContinuousBatchingScheduler",
                                  "PagedScheduler"])
def test_synchronous_harvest_matches_pipelined(tiny_engine, name):
    """pipeline_harvest=False reads each chunk before the next dispatch:
    the same tokens, one sync per chunk and admission."""
    prompts = _prompts(tiny_engine.cfg.vocab_size, seed=6)
    knobs = [dict(temperature=0.9, seed=70 + i) for i in range(len(prompts))]
    runs = []
    for eng in (tiny_engine, _engine_like(tiny_engine,
                                          pipeline_harvest=False)):
        sched = getattr(t_sched, name)(eng, GEN12)
        runs.append(([r.output_ids for r in _serve(sched, prompts, knobs)],
                     sched.pipeline_harvest))
    assert runs[0][0] == runs[1][0] and runs[0][1] and not runs[1][1]


class _LetterTokenizer:
    """Token t reads as one letter, chr(97 + t % 26)."""

    @staticmethod
    def decode_token(t):
        return chr(97 + t % 26)


def test_stop_strings_with_a_tokenizer(tiny_engine):
    """A stop string ends its request at the token that completes it: the
    output keeps that token, final_text is cut before the match, and the
    stream halts before the completing token."""
    eng = _engine_like(tiny_engine, tokenizer=_LetterTokenizer())
    prompt = _prompts(eng.cfg.vocab_size)[4]
    ref = _serve(t_sched.PagedScheduler(eng, GREEDY12),
                 [prompt])[0].output_ids
    text = "".join(_LetterTokenizer.decode_token(t) for t in ref)
    j = next(i for i in range(2, 10) if text.find(text[i:i + 2]) == i)
    streams = {}
    (got,) = _serve(t_sched.PagedScheduler(eng, GREEDY12), [prompt],
                    [dict(stop=text[j:j + 2])], streams)
    assert got.finished and got.stop_hit == text[j:j + 2]
    assert got.final_text == text[:j] and got.output_ids == ref[:j + 2]
    assert streams[got.req_id] == ref[:j + 1]
