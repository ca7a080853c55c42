"""DeepSeek-V3 on the port (llm_inference_tpu_torch/models/deepseek.py)
against the JAX package's models/deepseek.py on the CPU: the presets field
for field; tiny-deepseek (q_lora 32, and 0: a full q projection) and a
yarn config in float32 within 1e-4 of deepseek.forward on the same
numpy-seeded weights; the bf16, int8 and int4 latent caches, dense and
paged (the JAX package's paged forward over the same pool); int8 and
int4 weights from JAX's quantize_params within LOGIT_ATOL; generate and
score over the latent cache against JAX's engine, the paged scheduler
(prefix cache on) against the dense one; a tie in the group-limited
routing; model_config_from_hf and the HF conversion with rope_interleave
equal to JAX's; expert parallelism refused."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu import config as JC
from llm_inference_tpu.engine.engine import InferenceEngine as JEngine
from llm_inference_tpu.models import deepseek as j_ds
from llm_inference_tpu.utils import checkpoint as j_ckpt

from llm_inference_tpu_torch import config as C
from llm_inference_tpu_torch.engine import scheduler
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.models import deepseek, get_model, llama
from llm_inference_tpu_torch.parallel import sharding
from llm_inference_tpu_torch.utils import checkpoint

from torch_bridge import (assert_streams_agree, cache_to_torch, to_numpy,
                          to_numpy_tree, to_torch)

F32_ATOL = 1e-4
# bf16 latent rows, or quantized weights or rows: one bf16 rounding of a
# value, then sums of a few hundred products (test_torch_model.py's
# LOGIT_ATOL)
LOGIT_ATOL = 1e-2
YARN = {"type": "yarn", "factor": 4.0, "original_max_position_embeddings":
        16, "beta_fast": 32.0, "beta_slow": 1.0, "mscale": 1.0,
        "mscale_all_dim": 1.0}
KV = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16),
      "int8": ("int8", "int8"), "int4": ("int4", "int4")}


def _cfg(jcfg):
    return C.ModelConfig.from_dict(dataclasses.asdict(jcfg))


def _np_params(jcfg, seed, head_std=0.02):
    """float32 weights drawn with numpy in the JAX init's layout (the two
    stacks, deepseek.py:443-505): matmul weights N(0, 0.02) (lm_head
    N(0, head_std)), norms 1 + N(0, 0.1), the router's correction bias
    U(-0.05, 0.05)."""
    rng = np.random.default_rng(seed)
    shapes = deepseek.init_params(_cfg(jcfg), device="cpu")

    def draw(k, t):
        if isinstance(t, dict):
            return {n: draw(n, v) for n, v in t.items()}
        if k.endswith("norm"):
            return (1 + rng.normal(0, 0.1, t.shape)).astype(np.float32)
        if k == "router_bias":
            return rng.uniform(-0.05, 0.05, t.shape).astype(np.float32)
        std = head_std if k == "lm_head" else 0.02
        return rng.normal(0, std, t.shape).astype(np.float32)
    return draw("", shapes)


def _pair(jcfg, seed=0, qcfg=None, head_std=0.02):
    """JAX weights from a numpy seed (quantized by JAX's quantize_params
    with qcfg), and the port's through the bridge."""
    jp = jax.tree.map(jnp.asarray, _np_params(jcfg, seed, head_std))
    if qcfg is not None:
        jp = jax.jit(lambda p: j_ds.quantize_params(p, qcfg))(jp)
    return jp, llama.params_from_numpy(to_numpy_tree(jp), _cfg(jcfg),
                                          "cpu")


@pytest.fixture(scope="module")
def tiny():
    jcfg = JC.tiny_deepseek()
    return (jcfg, *_pair(jcfg))


_JITS = {}


def _jit(jcfg, mode):
    """JAX's forward, jitted once per config and logits mode (an eager call
    recompiles its layer scans every time)."""
    key = (repr(jcfg), mode)
    if key not in _JITS:
        _JITS[key] = jax.jit(
            lambda *a, **k: j_ds.forward(jcfg, *a, logits_mode=mode, **k),
            static_argnames=("paged_history",))
    return _JITS[key]


def _run_both(jcfg, jp, tp, kv="f32", T=8, steps=3, S=32, B=2, seed=0):
    """A T-token prefill (logits of every row) and `steps` decode steps at
    per-row positions over new_cache's latent cache of kind `kv`."""
    cfg = _cfg(jcfg)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    jc = j_ds.new_cache(jcfg, B, S, KV[kv][0])
    tc = deepseek.new_cache(cfg, B, S, KV[kv][1], device="cpu")
    jl, jc = _jit(jcfg, "all")(jp, jnp.asarray(ids), jnp.asarray(pos), jc)
    tl, tc = deepseek.forward(cfg, tp, torch.from_numpy(ids),
                              torch.from_numpy(pos), tc, logits_mode="all")
    got, want = [to_numpy(tl)], [np.asarray(jl, np.float32)]
    decode = _jit(jcfg, "last")
    for s in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        p = np.array([[T + s], [T + 2 * s]], np.int32)[:B]
        jl, jc = decode(jp, jnp.asarray(tok), jnp.asarray(p), jc)
        tl, tc = deepseek.forward(cfg, tp, torch.from_numpy(tok),
                                  torch.from_numpy(p), tc)
        got.append(to_numpy(tl))
        want.append(np.asarray(jl, np.float32))
    return got, want, tc, jc


def _assert_close(got, want, atol):
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("name", ("deepseek-v3", "tiny-deepseek"))
def test_presets_and_registry(name):
    cfg, jcfg = C.preset(name), JC.PRESETS[name]()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert get_model(name) is deepseek
    assert get_model("deepseek_v3") is deepseek


@pytest.mark.parametrize("q_lora", (32, 0))
def test_forward_matches_jax_float32(tiny, q_lora):
    if q_lora == 32:
        jcfg, jp, tp = tiny
    else:
        jcfg = JC.tiny_deepseek(q_lora_rank=0)
        jp, tp = _pair(jcfg, seed=1)
        assert "wq" in tp["moe_layers"] and "wq_a" not in tp["moe_layers"]
    got, want, _, _ = _run_both(jcfg, jp, tp)
    _assert_close(got, want, F32_ATOL)


def test_forward_matches_jax_yarn():
    """yarn RoPE past its 16-token original context, the mscale² fold in
    the score scale, and the tables the engine takes from the family."""
    jcfg = JC.tiny_deepseek(rope_scaling=YARN)
    cfg = _cfg(jcfg)
    assert deepseek.score_scale(cfg) == j_ds.score_scale(jcfg) != \
        deepseek.qk_head_dim(cfg) ** -0.5
    cos, _ = deepseek.rope_table(cfg, 64, "cpu")
    assert cos.shape == (64, cfg.qk_rope_head_dim)
    jp, tp = _pair(jcfg, seed=2)
    got, want, _, _ = _run_both(jcfg, jp, tp, T=24, S=64)
    _assert_close(got, want, F32_ATOL)


@pytest.mark.parametrize("kv", ("bf16", "int8", "int4"))
def test_latent_caches_match_jax(tiny, kv):
    """k rows 48 wide ([c_kv | k_rot]), v rows 32 (c_kv): written, in the
    int8 and int4 kinds quantized each over its own width, as JAX writes
    them (codes and scales equal), and attended to the same logits."""
    jcfg, jp, tp = tiny
    got, want, tc, jc = _run_both(jcfg, jp, tp, kv=kv)
    assert tc.k.shape[-1] != tc.v.shape[-1]
    _assert_close(got, want, F32_ATOL if kv != "bf16" else LOGIT_ATOL)
    want_c = cache_to_torch(jc)
    for f in ("k", "v", "k_scale", "v_scale"):
        g, w = getattr(tc, f), getattr(want_c, f)
        if w is None:
            assert g is None
        elif kv == "bf16":
            np.testing.assert_allclose(to_numpy(g), to_numpy(w),
                                       atol=2 ** -7, rtol=2 ** -7)
        else:
            # a code may move by one where a float32 row rounds across .5
            assert (g.to(torch.float32) - w.to(torch.float32)).abs().max() \
                <= (1 if f in ("k", "v") else 1e-6), f


@pytest.mark.parametrize("kv", ("bf16", "int8", "int4"))
def test_paged_latent_pool_matches_jax(tiny, kv):
    """A 16-token first chunk (two pages of 8, scattered), a chunk of 8
    over history, and decode steps over new_paged_cache's latent pool: the
    port against JAX on the same page table (int8), and against its dense
    latent cache of the same kind (every kind)."""
    from llm_inference_tpu.ops import paged_kvcache as j_pk
    jcfg, jp, tp = tiny
    cfg = _cfg(jcfg)
    B, ps, nb = 2, 8, 6
    table = np.array([[3, 7, 1, 5, 9, 10], [2, 8, 4, 6, 11, 12]], np.int32)
    jc = j_ds.new_paged_cache(jcfg, 13, ps, B, nb, KV["int8"][0])
    jc = j_pk.PagedKVCache(**{**{f.name: getattr(jc, f.name) for f in
                                 dataclasses.fields(jc)},
                              "page_table": jnp.asarray(table)})
    tc = deepseek.new_paged_cache(cfg, 13, ps, B, nb, KV[kv][1],
                                  device="cpu")
    assert tc.k_pages.shape[-1] != tc.v_pages.shape[-1]
    tc.page_table[:] = torch.from_numpy(table)
    dc = deepseek.new_cache(cfg, B, nb * ps, KV[kv][1], device="cpu")
    rng = np.random.default_rng(4)
    calls = [(16, 0, False, "all"), (8, 16, True, "all")] + [
        (1, 24 + s, False, "last") for s in range(3)]
    for T, start, hist, mode in calls:
        ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        pos = np.tile(np.arange(start, start + T, dtype=np.int32), (B, 1))
        tl, tc = deepseek.forward(cfg, tp, torch.from_numpy(ids),
                                  torch.from_numpy(pos), tc,
                                  logits_mode=mode, paged_history=hist)
        dl, dc = deepseek.forward(cfg, tp, torch.from_numpy(ids),
                                  torch.from_numpy(pos), dc,
                                  logits_mode=mode)
        _assert_close([to_numpy(tl)], [to_numpy(dl)], 1e-5)
        if kv == "int8":
            jl, jc = _jit(jcfg, mode)(jp, jnp.asarray(ids),
                                      jnp.asarray(pos), jc,
                                      paged_history=hist)
            _assert_close([to_numpy(tl)], [np.asarray(jl, np.float32)],
                          F32_ATOL)


@pytest.mark.parametrize("weights,group", [("int8", 0), ("int4", 16)])
def test_quantized_weights_match_jax(weights, group):
    """Each stack's projections [Lx, ...] and the flattened expert stacks
    [Lm·E, ...] (index w_idx·E + e) quantized by JAX, through the bridge:
    the logits of every row of a prefill (the decode steps' projections
    are the same K1 plain version at M = B); the port's quantize_params
    gives the same codes, and the scales to the last bit. Two layers
    (one dense, one MoE) of four experts: JAX's interpret-mode quantized
    products are slow to trace."""
    jcfg = JC.tiny_deepseek(num_layers=2, num_experts=4)
    qcfg = JC.QuantConfig(weights=weights, group_size=group)
    jq, tq = _pair(jcfg, seed=3, qcfg=qcfg)
    moe = tq["moe_layers"]
    assert moe["e_gate"].q.shape[0] == (jcfg.num_layers
                                        - jcfg.first_k_dense) * 4
    got, want, _, _ = _run_both(jcfg, jq, tq, steps=0)
    _assert_close(got, want, LOGIT_ATOL)
    _, dense = _pair(jcfg, seed=3)
    own = deepseek.quantize_params(dense, C.QuantConfig(weights=weights,
                                                        group_size=group))
    for sk, k in (("dense_layers", "w_gate"), ("moe_layers", "wq_b"),
                  ("moe_layers", "e_down"), ("moe_layers", "s_up")):
        assert torch.equal(own[sk][k].q, tq[sk][k].q), (sk, k)
        # jitted, XLA may divide by qmax as a product with its reciprocal:
        # a scale may differ in its last bit
        torch.testing.assert_close(own[sk][k].scale, tq[sk][k].scale,
                                   rtol=2.5e-7, atol=0)


def _engines(jcfg, jp, tp, kv, **ecfg):
    jeng = JEngine(jcfg, jp, engine_cfg=JC.EngineConfig(**ecfg),
                   cache_dtype=KV[kv][0])
    teng = InferenceEngine(_cfg(jcfg), tp, engine_cfg=C.EngineConfig(**ecfg),
                           cache_dtype=KV[kv][1], device="cpu")
    return jeng, teng


def test_generate_and_score_match_jax(tiny):
    """generate over the int8 latent cache (the family's new_cache), and
    score (logits of every row over the latent cache) against JAX's."""
    jcfg, jp, tp = tiny
    jeng, teng = _engines(jcfg, jp, tp, "int8", max_seq_len=64,
                          prefill_buckets=(8, 16), decode_chunk=4)
    assert teng._model is deepseek
    c = teng.new_cache(1)
    assert c.bits == 8 and c.k.shape[-1] == deepseek.latent_dim(teng.cfg)
    prompts = [[5, 9, 11, 3, 7, 2, 40, 41], [8, 1, 2]]
    gen = dict(greedy=True, max_new_tokens=5, eos_token_ids=())
    want = [r.token_ids for r in jeng.generate(
        prompts, JC.GenerationConfig(**gen))]
    got = [r.token_ids for r in teng.generate(
        prompts, C.GenerationConfig(**gen))]
    assert got == want
    js, ts = jeng.score(prompts), teng.score(prompts)
    for j, t in zip(js, ts):
        assert t[0] is None and len(t) == len(j)
        np.testing.assert_allclose(np.asarray(t[1:]), np.asarray(j[1:]),
                                   atol=F32_ATOL, rtol=0)


def test_paged_scheduler_over_the_latent_pool():
    """The paged scheduler (its pool from new_paged_cache, with the prefix
    cache) serves the dense scheduler's greedy streams over the int8
    latent cache (whose forwards test_generate_and_score_match_jax holds
    to JAX's)."""
    jcfg = JC.tiny_deepseek()
    # a sharp head keeps the greedy streams away from near-ties
    _, tp = _pair(jcfg, seed=6, head_std=0.5)
    teng = InferenceEngine(_cfg(jcfg), tp, engine_cfg=C.EngineConfig(
        max_seq_len=64, decode_chunk=4, max_batch_size=2,
        prefill_buckets=(8, 16), page_size=8), cache_dtype="int8",
        device="cpu")
    gen = C.GenerationConfig(greedy=True, max_new_tokens=5,
                             eos_token_ids=())
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(2, 250, n)) for n in (17, 9, 5)]
    prompts.append(prompts[0][:16] + [3])

    def run(sched):
        reqs = [sched.submit(p, top_logprobs=2) for p in prompts]
        while sched.step():
            pass
        return reqs
    want = run(scheduler.ContinuousBatchingScheduler(teng, gen, slots=2))
    paged = scheduler.PagedScheduler(teng, gen, slots=2, prefix_cache=True)
    got = run(paged)
    assert paged.cache.k_pages.shape[-1] == deepseek.latent_dim(teng.cfg)
    assert paged.cache.v_pages.shape[-1] == teng.cfg.kv_lora_rank
    assert paged.store.hit_tokens > 0
    assert_streams_agree(got, want)


def test_group_routing_tie_goes_to_the_lower_expert():
    """Experts 2 and 5 with equal router columns tie in the biased scores;
    JAX's lax.top_k and the port take expert 2: the routed mixtures
    agree."""
    jcfg = JC.tiny_deepseek(topk_group=2, experts_per_token=3)
    cfg = _cfg(jcfg)
    rng = np.random.default_rng(8)
    H, E = jcfg.hidden_size, jcfg.num_experts
    router = rng.normal(0, 0.02, (H, E)).astype(np.float32)
    router[:, 5] = router[:, 2]
    bias = np.zeros(E, np.float32)
    x = rng.normal(0, 1, (2, 6, H)).astype(np.float32)
    jp, tp = _pair(jcfg, seed=5)
    lp = {k: v[0] for k, v in jp["moe_layers"].items()}
    lp.update(router=jnp.asarray(router), router_bias=jnp.asarray(bias))
    want = np.asarray(jax.jit(lambda x_, lp_: j_ds._v3_moe(
        jcfg, x_, lp_, {}, 0))(jnp.asarray(x), lp))
    tlp = dict(tp["moe_layers"], router=to_torch(router)[None],
               router_bias=to_torch(bias)[None])
    sel = deepseek.router_weights(cfg, to_torch(x), tlp["router"][0],
                                  tlp["router_bias"][0])
    assert ((sel[..., 2] > 0) | (sel[..., 5] == 0)).all()
    got = deepseek.v3_moe(cfg, to_torch(x), tlp, 0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _hf_dict(rng, q_lora):
    """A random HF DeepseekV3 config and state dict: 2 layers, the first
    dense, rope_interleave on."""
    H, Hh, nope, rdim, kvr, vd, E, mi, I, V = (64, 4, 32, 16, 32, 32, 8, 48,
                                               128, 256)
    d = {"model_type": "deepseek_v3", "vocab_size": V, "hidden_size": H,
         "intermediate_size": I, "moe_intermediate_size": mi,
         "num_hidden_layers": 2, "num_attention_heads": Hh,
         "num_key_value_heads": Hh, "n_shared_experts": 1,
         "n_routed_experts": E, "routed_scaling_factor": 2.5,
         "kv_lora_rank": kvr, "q_lora_rank": q_lora,
         "qk_rope_head_dim": rdim, "v_head_dim": vd,
         "qk_nope_head_dim": nope, "n_group": 2, "topk_group": 1,
         "num_experts_per_tok": 2, "first_k_dense_replace": 1,
         "norm_topk_prob": True, "max_position_embeddings": 128,
         "rope_theta": 10000.0, "rope_interleave": True,
         "rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                          "mscale_all_dim": 1.0},
         "tie_word_embeddings": False, "rms_norm_eps": 1e-6}

    def w(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)
    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": w(H),
          "lm_head.weight": w(V, H)}
    for i in range(2):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        sd.update({p + "input_layernorm.weight": w(H),
                   p + "post_attention_layernorm.weight": w(H),
                   a + "kv_a_proj_with_mqa.weight": w(kvr + rdim, H),
                   a + "kv_a_layernorm.weight": w(kvr),
                   a + "kv_b_proj.weight": w(Hh * (nope + vd), kvr),
                   a + "o_proj.weight": w(H, Hh * vd)})
        if q_lora:
            sd.update({a + "q_a_proj.weight": w(q_lora, H),
                       a + "q_a_layernorm.weight": w(q_lora),
                       a + "q_b_proj.weight": w(Hh * (nope + rdim), q_lora)})
        else:
            sd[a + "q_proj.weight"] = w(Hh * (nope + rdim), H)
        m = p + "mlp."
        if i == 0:
            sd.update({m + "gate_proj.weight": w(I, H),
                       m + "up_proj.weight": w(I, H),
                       m + "down_proj.weight": w(H, I)})
            continue
        sd.update({m + "gate.weight": w(E, H),
                   m + "gate.e_score_correction_bias": w(E),
                   m + "shared_experts.gate_proj.weight": w(mi, H),
                   m + "shared_experts.up_proj.weight": w(mi, H),
                   m + "shared_experts.down_proj.weight": w(H, mi)})
        for e in range(E):
            q = m + f"experts.{e}."
            sd.update({q + "gate_proj.weight": w(mi, H),
                       q + "up_proj.weight": w(mi, H),
                       q + "down_proj.weight": w(H, mi)})
    return d, sd


@pytest.mark.parametrize("q_lora", (32, 0))
def test_hf_conversion_matches_jax(q_lora):
    """model_config_from_hf (yarn's original length filled in) and
    convert_hf_state_dict with rope_interleave (the RoPE columns
    de-interleaved, kv_b_proj split into w_uk / w_uv) equal JAX's; V2
    raises in both."""
    d, sd = _hf_dict(np.random.default_rng(9), q_lora)
    cfg, jcfg = checkpoint.model_config_from_hf(d), \
        j_ckpt.model_config_from_hf(d)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.rope_interleave and cfg.rope_scaling[
        "original_max_position_embeddings"] == 128
    cfg = dataclasses.replace(cfg, dtype="float32")
    got = checkpoint.convert_hf_state_dict(cfg, sd, device="cpu")
    want = to_numpy_tree(j_ckpt.convert_hf_state_dict(
        dataclasses.replace(jcfg, dtype="float32"), sd))

    def cmp(g, w_, path=""):
        if isinstance(w_, dict):
            assert set(g) == set(w_), path
            for k in w_:
                cmp(g[k], w_[k], path + "/" + k)
            return
        assert tuple(g.shape) == w_.shape, path
        np.testing.assert_array_equal(g.numpy(), w_, err_msg=path)
    cmp(got, want)
    for mod in (checkpoint, j_ckpt):
        with pytest.raises(NotImplementedError):
            mod.model_config_from_hf(dict(d, model_type="deepseek_v2"))


def test_expert_parallelism_is_refused(tiny):
    jcfg, _, tp = tiny
    cfg = _cfg(jcfg)

    class Two:
        size = 2
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        sharding.validate_tp(cfg, 2)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        deepseek.forward(cfg, tp, torch.zeros((1, 1), dtype=torch.int32),
                         torch.zeros((1, 1), dtype=torch.int32), None,
                         tp=Two)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        deepseek.quantize_params(tp, C.QuantConfig(weights="int8"),
                                 ep_shards=2)
