"""The port's gemma2 and gemma3 (llm_inference_tpu_torch/models/gemma2.py)
on the CPU against the JAX package's models/gemma2.py: tests/test_gemma2.py's
tiny_gemma2 and gemma3 cases (not the sharded ones) on the port. The same
numpy-seeded weights (norms included, so the (1 + w) norm is exercised)
through JAX gemma2.forward and the port's: dense prefill past the window
and decode steps (float32, the separate and the fused layer keys), the
decode kernels' routes at head_dim 64 over 128 slots (JAX's Pallas kernel
in interpret mode, the port's plain version, with the window, the query
scale and the softcap), int8 weights and the tied quantized lm_head, and
gemma3's qk-norm, layer types and dual RoPE. Then the port alone, as
test_gemma2.py runs JAX: a paged first token equal to the dense one, the
prefix cache, the scheduler, beam search and speculative decoding on a
gemma engine (registry-dispatched), gemma3's layer-type fallback, and HF
parity through transformers (imported only by those tests)."""

import ast
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu import config as JC
from llm_inference_tpu.models import gemma2 as j_gemma2
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.ops import kvcache as j_kv

from llm_inference_tpu_torch import config as C
from llm_inference_tpu_torch.engine import scheduler
from llm_inference_tpu_torch.engine.beam_search import beam_search
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.engine.speculative import SpeculativeDecoder
from llm_inference_tpu_torch.models import gemma2, llama
from llm_inference_tpu_torch.ops import kvcache
from llm_inference_tpu_torch.utils import checkpoint

from torch_bridge import to_numpy_tree

# float32 weights and activations: the same arithmetic up to the order
# of float32 sums (and of tanh in the softcaps)
F32_ATOL = 1e-4
# int8 weights: the projections round to bf16 in both packages
# (test_torch_model.py's LOGIT_ATOL)
LOGIT_ATOL = 1e-2
# a bf16 or int8 cache through the decode kernel (JAX, interpret) and its
# plain version (the port): the same rounding points, float32 sums in
# another order; logits under the final softcap of 30
KERNEL_ATOL = 2e-2
ECFG = dict(max_seq_len=64, decode_chunk=4, max_batch_size=2,
            prefill_buckets=(8, 16))
GREEDY = dict(greedy=True, eos_token_ids=(1,))


def tiny_gemma2(**kw):
    """tests/test_gemma2.py's tiny_gemma2: JAX's config and the port's."""
    d = dict(name="gemma2-tiny", vocab_size=128, hidden_size=64,
             intermediate_size=128, num_layers=4, num_heads=4,
             num_kv_heads=2, head_dim=16, rms_norm_eps=1e-6,
             rope_theta=10000.0, max_position_embeddings=256,
             tie_word_embeddings=True, attn_logit_softcap=50.0,
             final_logit_softcap=30.0, sliding_window=8,
             sliding_pattern="alternating", query_pre_attn_scalar=32.0,
             scale_embeddings=True, dtype="float32")
    d.update(kw)
    return JC.ModelConfig(**d), C.ModelConfig(**d)


def tiny_gemma3(**kw):
    """gemma3's differences on tiny_gemma2: no softcaps, qk-norm, explicit
    layer types with a local RoPE theta, linear scaling on the global
    tables only."""
    lt = ("sliding_attention", "sliding_attention", "full_attention",
          "sliding_attention")
    d = dict(name="gemma3-tiny", attn_logit_softcap=0.0,
             final_logit_softcap=0.0, sliding_pattern="all",
             layer_types=lt, qk_norm=True, rope_theta=100000.0,
             rope_local_theta=10000.0,
             rope_scaling={"type": "linear", "factor": 8.0})
    d.update(kw)
    return tiny_gemma2(**d)


def weights(jcfg, seed=0, quant=None):
    """JAX gemma2 params with random norms (and q/k norms), quantized and
    laid out (unfused) with `quant`; the port's copy on the CPU."""
    jp = j_gemma2.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    layers = dict(jp["layers"])
    for k in ("attn_norm", "post_attn_norm", "ffn_norm", "post_ffn_norm",
              "q_norm", "k_norm"):
        if k in layers:
            layers[k] = jnp.asarray(rng.normal(0, 0.3, layers[k].shape),
                                    layers[k].dtype)
    jp = dict(jp, layers=layers, final_norm=jnp.asarray(
        rng.normal(0, 0.3, jp["final_norm"].shape), jp["final_norm"].dtype))
    if quant is not None:
        jp = j_llama.prepare_params(j_llama.quantize_params(jp, quant),
                                    fuse=False, donate=False)
    return jp, llama.params_from_numpy(to_numpy_tree(jp),
                                       C.ModelConfig.from_dict(
                                           dataclasses.asdict(jcfg)),
                                       device="cpu")


def run_both(jcfg, cfg, jp, tp, T=12, steps=3, S=32, B=2, cache="float32",
             seed=0):
    """A T-token prefill ("all" logits), then `steps` teacher-forced decode
    steps at per-row positions, through JAX and the port; returns the
    logits of each call (port's, JAX's)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(cache,
                                                                      cache)
    jc = j_kv.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                         cfg.head_dim, cache)
    tc = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                            cfg.head_dim, tdt, device="cpu")
    # jitted with the config closed over: an eager call recompiles its
    # layer scan every time
    prefill = jax.jit(lambda *a: j_gemma2.forward(jcfg, *a,
                                                  logits_mode="all"))
    decode = jax.jit(lambda *a: j_gemma2.forward(jcfg, *a))
    jl, jc = prefill(jp, jnp.asarray(ids), jnp.asarray(pos), jc)
    tl, tc = gemma2.forward(cfg, tp, torch.from_numpy(ids),
                            torch.from_numpy(pos), tc, logits_mode="all")
    got, want = [tl.numpy()], [np.asarray(jl)]
    for s in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        p = np.array([[T + s], [T + 2 * s]], np.int32)[:B]
        jl, jc = decode(jp, jnp.asarray(tok), jnp.asarray(p), jc)
        tl, tc = gemma2.forward(cfg, tp, torch.from_numpy(tok),
                                torch.from_numpy(p), tc)
        got.append(tl.numpy())
        want.append(np.asarray(jl))
    return got, want


def assert_close(got, want, atol):
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("make", (tiny_gemma2, tiny_gemma3))
def test_config_and_layer_windows_match_jax(make):
    jcfg, cfg = make()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert list(gemma2.layer_windows(cfg)) == list(
        np.asarray(j_gemma2._layer_windows(jcfg)))
    assert gemma2.layer_windows(tiny_gemma2()[1]) == (8, 0, 8, 0)
    assert gemma2.layer_windows(tiny_gemma3()[1]) == (8, 8, 0, 8)
    # neither pattern: the window on every layer, or none
    assert gemma2.layer_windows(tiny_gemma2(sliding_pattern="all")[1]) == (
        8,) * 4
    assert gemma2.layer_windows(tiny_gemma2(sliding_window=0)[1]) == (0,) * 4


@pytest.mark.parametrize("make,fused", [(tiny_gemma2, False),
                                        (tiny_gemma2, True),
                                        (tiny_gemma3, True)])
def test_forward_matches_jax_float32(make, fused):
    """A 12-token prefill past the window of 8 and three decode steps:
    sandwich norms, GeGLU, softcaps, the query scale 32^-0.5, the
    alternating window, scaled tied embeddings (gemma3: qk-norm, layer
    types, the local RoPE table on windowed layers); the port's fused
    wqkv / w_gateup (prepare_params) and JAX's separate keys agree."""
    jcfg, cfg = make()
    jp, tp = weights(jcfg)
    if fused:
        tp = llama.prepare_params(tp)
        assert "wqkv" in tp["layers"] and "w_gateup" in tp["layers"]
    got, want = run_both(jcfg, cfg, jp, tp)
    assert_close(got, want, F32_ATOL)


@pytest.mark.parametrize("make,cache", [(tiny_gemma2, "bfloat16"),
                                        (tiny_gemma2, "int8"),
                                        (tiny_gemma3, "bfloat16")])
def test_decode_kernel_route_matches_jax(make, cache):
    """At head_dim 64 over 128 slots a decode step takes JAX's decode
    kernel (interpret mode) and the port's K2 route (its plain version
    here), each with the layer's window, the query scale and the
    softcap; the prefill's plain attend writes the cache first."""
    jcfg, cfg = make(hidden_size=128, intermediate_size=256, head_dim=64)
    from llm_inference_tpu.ops.pallas import decode_attention as j_dec
    from llm_inference_tpu_torch.ops.kernels import decode_attention
    assert j_dec.supports((2, 1, 4, 64), 128)
    assert decode_attention.supports((2, 1, 4, 64), 128)
    jp, tp = weights(jcfg, seed=6)
    got, want = run_both(jcfg, cfg, jp, llama.prepare_params(tp), T=10,
                         steps=2, S=128, cache=cache)
    assert_close(got, want, KERNEL_ATOL)


def test_int8_weights_match_jax():
    """llama.quantize_params on gemma params (the same layer keys), int8:
    JAX's blocked unfused weights and the port's fused ones."""
    jcfg, cfg = tiny_gemma2(hidden_size=128, intermediate_size=256,
                            head_dim=32)
    jp, tp = weights(jcfg, quant=JC.QuantConfig(weights="int8"))
    got, want = run_both(jcfg, cfg, jp, llama.prepare_params(tp), steps=2)
    assert_close(got, want, LOGIT_ATOL)


def test_tied_quantized_head_matches_jax():
    """quantize_embedding on a tied gemma: lm_head quantized from the
    table (JAX's codes and scales); the forward through K1's plain
    version on it against JAX's, and near the dense tied head."""
    jcfg, cfg = tiny_gemma2()
    qcfg = JC.QuantConfig(weights="int8", quantize_embedding=True)
    jp, tp = weights(jcfg, quant=qcfg)
    assert "lm_head" in jp and "lm_head" in tp
    _, dense = weights(jcfg)
    mine = llama.quantize_params(dense, C.QuantConfig(
        weights="int8", quantize_embedding=True))["lm_head"]
    assert torch.equal(mine.q, tp["lm_head"].q)
    assert torch.equal(mine.scale, tp["lm_head"].scale)
    got, want = run_both(jcfg, cfg, jp, llama.prepare_params(tp), steps=1)
    assert_close(got, want, LOGIT_ATOL)
    ref, _ = run_both(jcfg, cfg, weights(jcfg)[0], dense, steps=1)
    assert_close(got, ref, 0.15)


def test_tensor_parallel_raises():
    from llm_inference_tpu_torch.parallel.mesh import TPGroup
    jcfg, cfg = tiny_gemma2()
    tp = TPGroup.__new__(TPGroup)
    tp.size = 2
    with pytest.raises(NotImplementedError, match="gemma2"):
        gemma2.forward(cfg, {}, torch.zeros((1, 1), dtype=torch.int32),
                       torch.zeros((1, 1), dtype=torch.int32), None, tp=tp)


# ------------------------------------------------------ the port's engine

@pytest.fixture(scope="module")
def engine():
    _, cfg = tiny_gemma2()
    params = llama.prepare_params(gemma2.init_params(cfg, seed=0,
                                                     device="cpu"))
    return InferenceEngine(cfg, params, engine_cfg=C.EngineConfig(**ECFG),
                           device="cpu")


@pytest.fixture(scope="module")
def paged_engine(engine):
    return InferenceEngine(engine.cfg, engine.params,
                           engine_cfg=C.EngineConfig(**ECFG, page_size=8),
                           device="cpu")


def test_engine_takes_gemma_from_the_registry(engine):
    assert engine._model is gemma2
    glob, local = engine._rope
    assert glob is local                      # gemma2: one RoPE
    _, cfg3 = tiny_gemma3()
    g3, l3 = gemma2.rope_table(cfg3, 64, "cpu")
    assert not torch.equal(g3[0], l3[0])      # gemma3: two tables


def test_scheduler_serves_gemma_as_generate(engine):
    gen = C.GenerationConfig(max_new_tokens=5, **GREEDY)
    prompts = [[5, 6, 7], [9, 10]]
    reqs = scheduler.ContinuousBatchingScheduler(engine, gen, slots=2).run(
        prompts)
    for r, p in zip(reqs, prompts):
        assert r.output_ids == engine.generate([p], gen)[0].token_ids


def test_paged_first_token_matches_dense(paged_engine):
    gen = C.GenerationConfig(max_new_tokens=4, **GREEDY)
    prompts = [[5, 6, 7, 8, 9], [20, 21]]
    dense = scheduler.ContinuousBatchingScheduler(paged_engine, gen, slots=2)
    want = [r.output_ids[0] for r in dense.run(
        [list(p) for p in prompts], max_new_tokens=1)]
    paged = scheduler.PagedScheduler(paged_engine, gen, slots=2)
    got = [r.output_ids[0] for r in paged.run(
        [list(p) for p in prompts], max_new_tokens=1)]
    assert got == want


def test_paged_prefix_cache_gemma(paged_engine):
    gen = C.GenerationConfig(max_new_tokens=5, **GREEDY)
    prompt = list(np.random.default_rng(4).integers(2, 120, 19))
    golden = scheduler.PagedScheduler(paged_engine, gen, slots=2)
    want = [r.output_ids for r in golden.run([list(prompt)] * 2)]
    sched = scheduler.PagedScheduler(paged_engine, gen, slots=2,
                                     prefix_cache=True)
    got = [r.output_ids for r in sched.run([list(prompt)] * 2)]
    assert got == want
    assert sched.store.hit_tokens > 0


def test_beam_and_speculative_equal_greedy(engine):
    gen = C.GenerationConfig(max_new_tokens=8, **GREEDY)
    want = engine.generate([[5, 6, 7, 8]], gen)[0].token_ids
    hyps = beam_search(engine, [5, 6, 7, 8], beam_width=1, max_new_tokens=8,
                       eos_token_ids=(1,))
    assert hyps[0].token_ids == want
    got, _ = SpeculativeDecoder(engine, gamma=3).generate([5, 6, 7, 8], gen)
    if 1 in got:
        got = got[:got.index(1)]
    assert got == want


# ------------------------------------------------------ HF configs

def test_gemma3_layer_types_from_sliding_window_pattern():
    cfg = checkpoint.model_config_from_hf({
        "model_type": "gemma3_text", "vocab_size": 128, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 12,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "rope_theta": 1e6, "rope_local_base_freq": 1e4,
        "sliding_window": 512, "sliding_window_pattern": 6})
    assert cfg.layer_types == tuple(
        "full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
        for i in range(12))


def test_gemma3_config_without_layer_kinds_raises():
    with pytest.raises(ValueError, match="sliding_window_pattern"):
        checkpoint.model_config_from_hf({
            "model_type": "gemma3_text", "vocab_size": 128,
            "hidden_size": 64, "intermediate_size": 128,
            "num_hidden_layers": 12, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 16,
            "sliding_window": 512})


def _hf_gemma2_checkpoint(path, seed=3):
    """A transformers Gemma2ForCausalLM of tiny_gemma2's widths with
    random norm weights (so (1 + w) is exercised), saved with
    save_pretrained under `path`; returns (the HF model, the port's
    config)."""
    transformers = pytest.importorskip("transformers")
    _, cfg = tiny_gemma2()
    torch.manual_seed(seed)
    hf = transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        max_position_embeddings=cfg.max_position_embeddings,
        attn_logit_softcapping=cfg.attn_logit_softcap,
        final_logit_softcapping=cfg.final_logit_softcap,
        sliding_window=cfg.sliding_window,
        query_pre_attn_scalar=cfg.query_pre_attn_scalar,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
        attn_implementation="eager")).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.normal_(0, 0.3)
    hf.save_pretrained(str(path), safe_serialization=True)
    return hf, cfg


def test_gemma2_hf_checkpoint_roundtrip(tmp_path):
    """A transformers Gemma2ForCausalLM saved with save_pretrained loads
    through the port's load_hf_checkpoint (the sandwich-norm keys, the
    tied table) and reproduces HF's logits past the window."""
    hf, cfg = _hf_gemma2_checkpoint(tmp_path / "ck")
    lcfg, params = checkpoint.load_hf_checkpoint(str(tmp_path / "ck"),
                                                 dtype="float32",
                                                 device="cpu")
    assert lcfg.name == "gemma2" and lcfg.sliding_pattern == "alternating"
    assert lcfg.scale_embeddings and lcfg.tie_word_embeddings
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
    cache = kvcache.init_cache(lcfg.num_layers, 1, lcfg.num_kv_heads, 16,
                               lcfg.head_dim, torch.float32, device="cpu")
    got, _ = gemma2.forward(lcfg, llama.prepare_params(params),
                            torch.from_numpy(ids).int(),
                            torch.arange(12)[None], cache, logits_mode="all")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


def test_cli_serves_a_gemma2_checkpoint(tmp_path, monkeypatch, capsys):
    """cli --checkpoint of an HF gemma2 directory, int8 weights: the
    registry hands the engine models/gemma2.py and the REPL echoes the
    sampled ids."""
    import io
    import sys
    from llm_inference_tpu_torch import cli
    _hf_gemma2_checkpoint(tmp_path / "ck")
    monkeypatch.setattr(sys, "stdin", io.StringIO("hello\nexit\n"))
    cli.main(["--device", "cpu", "--checkpoint", str(tmp_path / "ck"),
              "--quant", "int8", "--greedy", "--max-new-tokens", "4",
              "--max-seq-len", "64"])
    out = capsys.readouterr().out
    ids = [line.split("ids>", 1)[1] for line in out.splitlines()
           if "ids>" in line]
    assert len(ids) == 1 and len(ast.literal_eval(ids[0].strip())) == 4
    assert out.rstrip().endswith("bye.")


def test_gemma3_hf_parity_mixed_layers():
    """transformers Gemma3ForCausalLM (qk-norm, mixed layer types, dual
    RoPE) through the port's converter and forward, 12 tokens past the
    window of 8."""
    transformers = pytest.importorskip("transformers")
    lt = ["sliding_attention", "sliding_attention", "full_attention",
          "sliding_attention"]
    torch.manual_seed(0)
    hf = transformers.Gemma3ForCausalLM(transformers.Gemma3TextConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, rms_norm_eps=1e-6, rope_theta=100000.0,
        rope_local_base_freq=10000.0, max_position_embeddings=64,
        sliding_window=8, layer_types=lt, query_pre_attn_scalar=32,
        tie_word_embeddings=True, pad_token_id=0, attention_bias=False,
        torch_dtype="float32")).eval()
    cfg = dataclasses.replace(checkpoint.model_config_from_hf(hf.config),
                              dtype="float32")
    assert cfg.qk_norm and cfg.layer_types == tuple(lt)
    params = checkpoint.convert_hf_state_dict(cfg, hf.state_dict(),
                                              dtype="float32", device="cpu")
    ids = np.random.default_rng(2).integers(2, 120, (2, 12))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
    cache = kvcache.init_cache(4, 2, 2, 16, 16, torch.float32, device="cpu")
    got, _ = gemma2.forward(cfg, params, torch.from_numpy(ids).int(),
                            torch.arange(12)[None].repeat(2, 1), cache,
                            logits_mode="all")
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3, rtol=3e-3)
