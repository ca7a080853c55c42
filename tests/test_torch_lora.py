"""Multi-LoRA serving in the port (models/lora.py through llama.forward,
generate, ChatSession, both schedulers, the prefix cache, the CLI and the
server) against the JAX package's, on the CPU at tiny_llama width.

The stacks come from one numpy seed and go to both packages as the same
float32 arrays. The model-level cases compare logits with JAX's
`llama.forward(adapter_idx=)`; the serving cases compare greedy streams
with JAX's `generate` / `ChatSession`, or with the port's own merged-weight
oracle (`lora.merge_into_params`: each adapter's A·B folded into dense
weights)."""

import json
import threading
import types
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.config import EngineConfig as JEngineConfig
from llm_inference_tpu.config import GenerationConfig as JGenerationConfig
from llm_inference_tpu.config import QuantConfig as JQuantConfig
from llm_inference_tpu.config import tiny_llama as j_tiny_llama
from llm_inference_tpu.engine.engine import ChatSession as JChatSession
from llm_inference_tpu.engine.engine import InferenceEngine as JEngine
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.models import lora as j_lora
from llm_inference_tpu.ops import kvcache as j_kv

from llm_inference_tpu_torch import cli
from llm_inference_tpu_torch import config as C
from llm_inference_tpu_torch.engine import prefix_cache, server, speculative
from llm_inference_tpu_torch.engine.engine import ChatSession, InferenceEngine
from llm_inference_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler, PagedScheduler)
from llm_inference_tpu_torch.models import gemma2, llama, lora, mixtral
from llm_inference_tpu_torch.ops import kvcache

from torch_bridge import to_numpy_tree

CFG = C.tiny_llama()
RANK = 4
# float32 weights, activations and cache: the same arithmetic up to the
# order of float32 sums
F32_ATOL = 1e-4
# int8 weights: the projections round to bf16 in both packages
# (test_torch_model.py's LOGIT_ATOL)
INT8_ATOL = 1e-2
GEN = C.GenerationConfig(greedy=True, max_new_tokens=8, eos_token_ids=())
ECFG = dict(max_seq_len=64, decode_chunk=4, max_batch_size=2,
            prefill_buckets=(8, 16), page_size=8)


def _np_stacks(seed=9, scale=1.0):
    """Stacks for every target from one numpy seed: slots 1 and 2 live,
    slot 0 the zero adapter (lora.init_lora_stacks' scaling)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, dims in lora._DIMS.items():
        d_in, d_out = dims(CFG)
        a = rng.standard_normal((CFG.num_layers, 3, d_in, RANK)).astype(
            np.float32) * (scale / np.sqrt(d_in))
        b = rng.standard_normal((CFG.num_layers, 3, RANK, d_out)).astype(
            np.float32) * (scale / np.sqrt(RANK))
        a[:, 0] = 0.0
        b[:, 0] = 0.0
        out[name] = {"a": a, "b": b}
    return out


@pytest.fixture(scope="module")
def setup():
    """JAX's dense float32 weights (seed 0) and the stacks, on both sides:
    the port's as unfused dense params (`dense`) and prepared (`prep`),
    each with and without the stacks."""
    jcfg = j_tiny_llama()
    jdense = j_llama.init_params(jcfg, jax.random.PRNGKey(0))
    st = _np_stacks()
    jstacks = {n: {k: jnp.asarray(v) for k, v in s.items()}
               for n, s in st.items()}
    dense = llama.params_from_numpy(to_numpy_tree(jdense), CFG, "cpu")
    tstacks = llama.params_from_numpy(
        dict(to_numpy_tree(jdense), lora=st), CFG, "cpu")["lora"]
    return types.SimpleNamespace(
        jcfg=jcfg, jdense=jdense, jstacks=jstacks, dense=dense,
        stacks=tstacks, prep=llama.prepare_params(dense),
        jlora=dict(jdense, lora=jstacks),
        lora_prep=dict(llama.prepare_params(dense), lora=tstacks))


def _engine(params, **kw):
    return InferenceEngine(CFG, params, engine_cfg=C.EngineConfig(**ECFG),
                           device="cpu", **kw)


# --------------------------------------------------------------- lora.py

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_delta_matches_jax(setup, dtype):
    """Rows on slots [0, 1, 2]: the float32 delta, cast to the base
    output's dtype before the add (a bf16 base output gets a bf16 add)."""
    rng = np.random.default_rng(3)
    d_in, d_out = lora._DIMS["w_up"](CFG)
    x = rng.standard_normal((3, 5, d_in)).astype(np.float32)
    base = rng.standard_normal((3, 5, d_out)).astype(np.float32)
    idx = np.array([0, 1, 2], np.int32)
    jdt = jnp.dtype(dtype)
    jlp = {"w_up": {k: v[1] for k, v in setup.jstacks["w_up"].items()}}
    want = np.asarray(j_lora.apply_delta(
        "w_up", jlp, jnp.asarray(x).astype(jdt), jnp.asarray(base).astype(jdt),
        jnp.asarray(idx)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = lora.apply_delta(
        "w_up", lora.layer_view(setup.stacks, 1),
        torch.from_numpy(x).to(tdt), torch.from_numpy(base).to(tdt),
        torch.from_numpy(idx).long())
    assert got.dtype == tdt
    # bf16: the sums differ in order only, so a result may sit one bf16
    # step (2^-8 relative) away from JAX's
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)
    # slot 0 adds an exact zero
    torch.testing.assert_close(got[0], torch.from_numpy(base[0]).to(tdt),
                               atol=0, rtol=0)
    # no stacks, or no adapter_idx: the base output itself
    b = torch.from_numpy(base)
    assert lora.apply_delta("w_up", None, torch.from_numpy(x), b,
                            torch.from_numpy(idx).long()) is b
    assert lora.apply_delta("w_up", lora.layer_view(setup.stacks, 0),
                            torch.from_numpy(x), b, None) is b


# ------------------------------------------------------------- forward

_JAX_LOGITS = {}


def _jax_forward(setup, kind, ids, pos, steps):
    """JAX's logits of a prefill and teacher-forced decode steps with the
    stacks, rows on slots [0, 1, 2] (computed once a kind)."""
    if kind in _JAX_LOGITS:
        return _JAX_LOGITS[kind]
    B, T = ids.shape
    if kind == "int8":
        qp = j_llama.quantize_params(setup.jdense,
                                     JQuantConfig(weights="int8"))
        jp = dict(j_llama.prepare_params(qp, donate=False),
                  lora=setup.jstacks)
        cdt = jnp.bfloat16
    else:
        jp, cdt = setup.jlora, jnp.float32
    cache = j_kv.init_cache(CFG.num_layers, B, CFG.num_kv_heads, 32,
                            CFG.head_dim, cdt)
    aidx = jnp.asarray([0, 1, 2], jnp.int32)
    out = []
    logits, cache = j_llama.forward(setup.jcfg, jp, jnp.asarray(ids),
                                    jnp.asarray(pos), cache, adapter_idx=aidx)
    out.append(np.asarray(logits))
    for s in steps:
        logits, cache = j_llama.forward(
            setup.jcfg, jp, jnp.asarray(s[:, None]),
            jnp.full((B, 1), T + len(out) - 1, jnp.int32), cache,
            adapter_idx=aidx)
        out.append(np.asarray(logits))
    _JAX_LOGITS[kind] = (out, jp)
    return _JAX_LOGITS[kind]


@pytest.mark.parametrize("kind", ["float32", "float32-fused", "int8"])
def test_forward_mixed_rows_matches_jax(setup, kind, monkeypatch):
    """A 6-token prefill and a teacher-forced decode step at B = 3, rows on
    slots [0, 1, 2]: float32 dense weights unfused and fused (wqkv,
    w_gateup) over a float32 cache within F32_ATOL, and int8 weights with
    fused QTensors over a bf16 cache (JAX in interpret mode) within
    INT8_ATOL. The base row 0 on the LoRA model is held to JAX's base row
    on its LoRA model too; with stacks the port never takes the pair-carry
    layer (JAX turns it off: llama.py:925-930)."""
    rng = np.random.default_rng(4)
    ids = rng.integers(2, CFG.vocab_size, (3, 6)).astype(np.int32)
    pos = np.tile(np.arange(6, dtype=np.int32), (3, 1))
    steps = [rng.integers(2, CFG.vocab_size, 3).astype(np.int32)]
    jk = "int8" if kind == "int8" else "float32"
    want, jp = _jax_forward(setup, jk, ids, pos, steps)
    if kind == "int8":
        p = dict(llama.prepare_params(llama.params_from_numpy(
            to_numpy_tree({k: v for k, v in jp.items() if k != "lora"}),
            CFG, "cpu")), lora=setup.stacks)
        assert isinstance(p["layers"]["wqkv"], llama.QTensor)
        cdt, tol = torch.bfloat16, INT8_ATOL
    else:
        p = (setup.lora_prep if kind == "float32-fused"
             else dict(setup.dense, lora=setup.stacks))
        cdt, tol = torch.float32, F32_ATOL
    assert ("wqkv" in p["layers"]) == (kind != "float32")

    def no_pair(*a, **k):
        raise AssertionError("the pair-carry layer ran with LoRA stacks")
    monkeypatch.setattr(llama, "_layer_pair", no_pair)
    assert llama.layer_route(CFG, p["layers"], 1, 1, None,
                             lora_stacks=p["lora"]) == "split"
    cache = kvcache.init_cache(CFG.num_layers, 3, CFG.num_kv_heads, 32,
                               CFG.head_dim, cdt, device="cpu")
    aidx = torch.tensor([0, 1, 2])
    logits, cache = llama.forward(CFG, p, torch.from_numpy(ids),
                                  torch.from_numpy(pos), cache,
                                  adapter_idx=aidx)
    got = [logits.numpy()]
    for j, s in enumerate(steps):
        logits, cache = llama.forward(
            CFG, p, torch.from_numpy(s[:, None]),
            torch.full((3, 1), 6 + j, dtype=torch.int32), cache,
            adapter_idx=aidx)
        got.append(logits.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    # the adapters move the logits far beyond the tolerance
    assert np.abs(want[0][1] - want[0][0]).max() > 10 * tol


def test_forward_without_adapter_idx_is_the_base_model(setup):
    """Stacks present, no adapter_idx: every row on slot 0, the base
    model's logits (llama.py:907-909)."""
    ids = torch.tensor([[5, 6, 7, 8, 9]])
    pos = torch.arange(5)[None]

    def run(p):
        c = kvcache.init_cache(CFG.num_layers, 1, CFG.num_kv_heads, 16,
                               CFG.head_dim, torch.float32, device="cpu")
        return llama.forward(CFG, p, ids, pos, c)[0]
    torch.testing.assert_close(run(setup.lora_prep), run(setup.prep),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------- engine

class _Tok:
    """A character tokenizer both packages' ChatSession can use."""
    def encode(self, text, add_bos=True):
        return ([1] if add_bos else []) + [3 + ord(c) % 200 for c in text]

    def decode(self, ids):
        return "".join(f"{t} " for t in ids)

    def decode_token(self, t):
        return f"{t} "


def test_generate_and_chat_match_jax(setup):
    """generate(adapter=name) and a two-round ChatSession(adapter=) give
    JAX's greedy streams on the same stacks (B = 1 throughout, so that the
    JAX side compiles few programs)."""
    jeng = JEngine(setup.jcfg, setup.jlora,
                   engine_cfg=JEngineConfig(**ECFG), tokenizer=_Tok(),
                   adapter_names=["alpha", "beta"])
    teng = _engine(setup.lora_prep, tokenizer=_Tok(),
                   adapter_names=["alpha", "beta"])
    gen = C.GenerationConfig(greedy=True, max_new_tokens=9,
                             eos_token_ids=())
    jgen = JGenerationConfig(greedy=True, max_new_tokens=9,
                             eos_token_ids=())
    want = jeng.generate([[5, 6, 7]], jgen, adapter="alpha")[0].token_ids
    got = teng.generate([[5, 6, 7]], gen, adapter="alpha")[0].token_ids
    assert got == want
    assert got != teng.generate([[5, 6, 7]], gen)[0].token_ids

    def plain(text, round_idx):
        return text
    jchat = JChatSession(jeng, template=plain, adapter="beta")
    tchat = ChatSession(teng, template=plain, adapter="beta")
    for turn in ("hi", "yo"):
        assert tchat.ask(turn, gen) == jchat.ask(turn, jgen)
    assert tchat.pos == jchat.pos


def test_generate_mixed_rows_match_merged_oracle(setup):
    """generate(adapter=[name, None, slot]): each row's stream is its
    adapter's merged-weight stream."""
    eng = _engine(setup.lora_prep, adapter_names=["alpha", "beta"])
    prompts = [[5, 6, 7], [9, 10, 11, 12], [40, 41]]
    got = [r.token_ids for r in eng.generate(prompts, GEN,
                                             adapter=["alpha", None, 2])]
    assert got == [_oracle(setup, p, s) for p, s in zip(prompts, (1, 0, 2))]


@pytest.mark.parametrize("make,call,match", [
    ("base", lambda e: e.resolve_adapter("x"), "no LoRA stacks"),
    ("lora", lambda e: e.resolve_adapter("nope"), "unknown adapter"),
    ("lora", lambda e: e.resolve_adapter(7), "out of range"),
    ("lora", lambda e: e.generate([[5], [6]], GEN, adapter=["alpha"]),
     "1 adapters for 2 prompts"),
    ("names", None, "3 adapter names but only 2 live slots"),
])
def test_adapter_errors(setup, make, call, match):
    """resolve_adapter's, _adapter_rows' and the constructor's ValueErrors
    (JAX engine.py:135-137, 189-218)."""
    with pytest.raises(ValueError, match=match):
        if make == "names":
            _engine(setup.lora_prep, adapter_names=["a", "b", "c"])
        eng = (_engine(setup.prep) if make == "base" else
               _engine(setup.lora_prep, adapter_names=["alpha"]))
        call(eng)


# ------------------------------------------------------------ schedulers

_ORACLE = {}


def _oracle(setup, prompt, adapter, new=GEN.max_new_tokens):
    """The merged-weight oracle: a B = 1 generate on dense weights with
    the adapter's A·B folded in (no stacks)."""
    key = (tuple(prompt), adapter, new)
    if key not in _ORACLE:
        mp = llama.prepare_params(lora.merge_into_params(
            CFG, setup.dense, setup.stacks, adapter))
        gen = C.GenerationConfig(greedy=True, max_new_tokens=new,
                                 eos_token_ids=())
        _ORACLE[key] = _engine(mp).generate([prompt], gen)[0].token_ids
    return _ORACLE[key]


@pytest.mark.parametrize("paged", [False, True])
def test_mixed_adapter_schedulers_match_merged_oracle(setup, paged):
    """Four requests on slots [1, 2, base, 1] (by name and by number) in
    two decode slots, admitted as waves and one at a time: each stream
    equals its adapter's merged-weight stream."""
    eng = _engine(setup.lora_prep, adapter_names=["alpha", "beta"])
    sched = (PagedScheduler(eng, GEN, slots=2, num_pages=40) if paged
             else ContinuousBatchingScheduler(eng, GEN, slots=2))
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13, 14, 15, 16, 17, 18], [3, 4],
               [30, 31, 32]]
    adapters = ["alpha", 2, None, 1]
    reqs = [sched.submit(p, adapter=a) for p, a in zip(prompts, adapters)]
    while sched.step():
        pass
    slots = [eng.resolve_adapter(a) for a in adapters]
    for r, p, s in zip(reqs, prompts, slots):
        assert r.output_ids == _oracle(setup, p, s)
    assert not sched.aidx_host.any()


def test_prefix_cache_salted_by_adapter(setup):
    """The same 3-page prompt under adapter 1, then 2, then 2 again: the
    second request hits no page, the third hits all three, and every
    stream is its adapter's merged-weight stream."""
    prompt = list(range(2, 2 + 3 * 8 + 3))
    h = [prefix_cache.chunk_hashes(prompt, 8, salt=s) for s in (0, 1, 2)]
    assert len(h[1]) == 3 and len({x[0] for x in h}) == 3
    eng = _engine(setup.lora_prep)
    sched = PagedScheduler(eng, GEN, slots=2, prefix_cache=True)
    hits, out = [], []
    for a in (1, 2, 2):
        before = sched.store.hit_tokens
        r = sched.submit(list(prompt), adapter=a)
        while sched.step():
            pass
        hits.append(sched.store.hit_tokens - before)
        out.append(r.output_ids)
    assert hits == [0, 0, 24]
    assert out[0] == _oracle(setup, prompt, 1)
    assert out[1] == out[2] == _oracle(setup, prompt, 2)


def test_retired_slot_returns_to_the_base_model(setup):
    """A slot whose adapter request retired is back on slot 0, so a base
    request admitted there later runs the base model."""
    eng = _engine(setup.lora_prep)
    sched = ContinuousBatchingScheduler(eng, GEN, slots=1)
    a = sched.submit([5, 6, 7], adapter=2)
    sched.step()
    assert sched.aidx_host.tolist() == [2]
    while sched.step():
        pass
    assert sched.aidx_host.tolist() == [0]
    b = sched.submit([5, 6, 7])
    while sched.step():
        pass
    assert a.output_ids == _oracle(setup, [5, 6, 7], 2)
    assert b.output_ids == _oracle(setup, [5, 6, 7], 0)
    assert a.output_ids != b.output_ids


# ----------------------------------------------------------- the refusals

def _refuse(setup, what):
    if what == "gemma2":
        cfg = C.ModelConfig(
            name="gemma2-tiny", vocab_size=128, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, tie_word_embeddings=True,
            sliding_window=8, sliding_pattern="alternating", dtype="float32")
        p = gemma2.init_params(cfg, seed=0, device="cpu")
    elif what == "mixtral":
        cfg = C.ModelConfig(
            name="mixtral-tiny", vocab_size=128, hidden_size=64,
            intermediate_size=96, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, num_experts=4, experts_per_token=2, dtype="float32")
        p = mixtral.init_params(cfg, seed=0, device="cpu")
    if what in ("gemma2", "mixtral"):
        g = torch.Generator().manual_seed(0)
        InferenceEngine(cfg, dict(p, lora=lora.init_lora_stacks(
            cfg, 2, 1, g)), device="cpu")
    elif what == "tp":
        tp = types.SimpleNamespace(size=2, rank=0,
                                   device=torch.device("cpu"))
        InferenceEngine(CFG, setup.lora_prep, device="cpu", tp=tp)
    else:
        sched = speculative.SpeculativeBatchingScheduler(
            _engine(setup.lora_prep), GEN, slots=2)
        sched.submit([5, 6, 7], adapter=1)


@pytest.mark.parametrize("what,exc,match", [
    ("gemma2", NotImplementedError, "llama family only"),
    ("mixtral", NotImplementedError, "llama family only"),
    ("tp", NotImplementedError, "tensor parallelism"),
    ("speculative", ValueError, "does not support adapters"),
])
def test_refusals(setup, what, exc, match):
    """Stacks on a family whose forward takes no adapter_idx (gemma2,
    mixtral) and LoRA over tensor parallelism are refused when the
    engine is built; the speculative scheduler refuses adapters."""
    with pytest.raises(exc, match=match):
        _refuse(setup, what)


# ------------------------------------------------- peft, the CLI, server

def _write_peft(path, layers, targets, r, alpha, seed):
    """A synthetic HF peft directory: lora_A/lora_B of `targets` in
    `layers`, plus modules_to_save keys outside the decoder layers."""
    from safetensors.numpy import save_file
    rng = np.random.default_rng(seed)
    t = {"base_model.model.lm_head.weight":
         np.ones((CFG.vocab_size, CFG.hidden_size), np.float32),
         "base_model.model.model.embed_tokens.weight":
         np.ones((CFG.vocab_size, CFG.hidden_size), np.float32)}
    hf = {v: k for k, v in lora.TARGETS.items()}
    for li in layers:
        for name in targets:
            d_in, d_out = lora._DIMS[name](CFG)
            block = "mlp" if name.startswith("w_") else "self_attn"
            base = f"base_model.model.model.layers.{li}.{block}.{hf[name]}"
            t[f"{base}.lora_A.weight"] = (
                rng.standard_normal((r, d_in)) * 0.3).astype(np.float32)
            t[f"{base}.lora_B.weight"] = (
                rng.standard_normal((d_out, r)) * 0.3).astype(np.float32)
    path.mkdir()
    save_file(t, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(
        json.dumps({"r": r, "lora_alpha": alpha}))
    return str(path)


@pytest.fixture(scope="module")
def peft_dirs(tmp_path_factory):
    """Two adapters: one over every target of every layer (rank 4), one
    partial (layer 1 only, q and down projections, rank 2)."""
    d = tmp_path_factory.mktemp("peft")
    return (_write_peft(d / "full", range(CFG.num_layers), tuple(lora._DIMS),
                        4, 8.0, 5),
            _write_peft(d / "part", [1], ("wq", "w_down"), 2, 4.0, 6))


def test_peft_round_trip_matches_jax(peft_dirs):
    """load_peft_adapter through the port's own safetensors reader, then
    stack_adapters (scaling baked into B, ranks padded), give JAX's
    arrays; non-layer keys are skipped, missing layers zero-filled."""
    jcfg = j_tiny_llama()
    ads, scs, jads, jscs = [], [], [], []
    for d in peft_dirs:
        ad, sc = lora.load_peft_adapter(CFG, d)
        jad, jsc = j_lora.load_peft_adapter(jcfg, d)
        assert sc == jsc and sorted(ad) == sorted(jad)
        for name in ad:
            for got, want in zip(ad[name], jad[name]):
                np.testing.assert_array_equal(got, want)
        ads.append(ad)
        scs.append(sc)
        jads.append(jad)
        jscs.append(jsc)
    assert scs == [2.0, 2.0]
    a, b = ads[1]["wq"]
    assert a.shape == (CFG.num_layers, CFG.hidden_size, 2)
    assert not a[0].any() and not b[0].any() and a[1].any()
    got = lora.stack_adapters(CFG, ads, scaling=scs, device="cpu")
    want = j_lora.stack_adapters(jcfg, jads, scaling=jscs)
    assert sorted(got) == sorted(want) == sorted(lora._DIMS)
    for name in got:
        for k in ("a", "b"):
            np.testing.assert_array_equal(got[name][k].numpy(),
                                          np.asarray(want[name][k]))
    assert got["wq"]["a"].shape == (CFG.num_layers, 3, CFG.hidden_size, 4)


def test_cli_lora_and_adapter_command(peft_dirs, monkeypatch, capsys):
    """cli --lora NAME=DIR (twice) loads both adapters; the REPL's
    `adapter NAME` switches (an unknown name is reported and changes
    nothing) and `adapter base` switches back."""
    import io
    import sys
    lines = ["hi", "adapter full", "hi", "adapter nope", "hi",
             "adapter base", "hi", "exit"]
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(x + "\n" for x in lines)))
    cli.main(["--device", "cpu", "--greedy", "--max-new-tokens", "6",
              "--max-seq-len", "128", "--lora", f"full={peft_dirs[0]}",
              "--lora", f"part={peft_dirs[1]}"])
    out = capsys.readouterr().out
    ids = [json.loads(x.split("ids> ", 1)[1]) for x in out.splitlines()
           if "ids> " in x]
    assert "adapter: full (history reset)" in out
    assert "unknown adapter 'nope'" in out
    assert "adapter: base (history reset)" in out
    assert len(ids) == 4 and ids[0] == ids[3] and ids[1] == ids[2]
    assert ids[0] != ids[1]


def test_server_lora_models_and_routing(peft_dirs):
    """server --lora: /v1/models lists the adapters, and a completion
    whose `model` names one runs on it (engine.generate's stream on that
    adapter, not the base model's)."""
    httpd = server.make_server(
        ["--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--max-seq-len", "128", "--max-new-tokens", "6",
         "--lora", f"full={peft_dirs[0]}", "--lora", f"part={peft_dirs[1]}"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = "http://%s:%d" % httpd.server_address[:2]

    def post(body):
        req = urllib.request.Request(
            base + "/v1/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.load(r)["choices"][0]["token_ids"]
    try:
        with urllib.request.urlopen(base + "/v1/models", timeout=60) as r:
            ids = [m["id"] for m in json.load(r)["data"]]
        assert ids == [CFG.name, "full", "part"]
        eng = httpd.backend.engine
        gen = C.GenerationConfig(greedy=True, max_new_tokens=6,
                                 eos_token_ids=())
        prompt = [5, 6, 7]
        on_full = post({"prompt": prompt, "max_tokens": 6, "model": "full"})
        on_base = post({"prompt": prompt, "max_tokens": 6})
        assert on_full == eng.generate([prompt], gen,
                                       adapter="full")[0].token_ids
        assert on_base == eng.generate([prompt], gen)[0].token_ids
        assert on_full != on_base
    finally:
        httpd.shutdown()
        httpd.backend.shutdown()
        httpd.server_close()
