"""Mixtral on the port (llm_inference_tpu_torch/models/mixtral.py) against
the JAX package's models/mixtral.py on the CPU: the preset field for
field; float32 prefill and decode logits of tests/test_mixtral.py's tiny
config on the same numpy-seeded weights within 1e-4; int8 and int4
expert stacks quantized by JAX's quantize_params within LOGIT_ATOL; the
paged forward against the dense one; a routing tie resolved to the
lower expert as jax.lax.top_k resolves it; generate, the schedulers and
the prefix cache; model_config_from_hf and convert_hf_state_dict equal
to JAX's on one synthetic HF dict; expert parallelism refused."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu import config as JC
from llm_inference_tpu.engine.engine import InferenceEngine as JEngine
from llm_inference_tpu.models import mixtral as j_mixtral
from llm_inference_tpu.ops import kvcache as j_kv
from llm_inference_tpu.utils import checkpoint as j_ckpt

from llm_inference_tpu_torch import config as C
from llm_inference_tpu_torch.engine import scheduler
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.models import get_model, llama, mixtral
from llm_inference_tpu_torch.ops import kvcache, paged_kvcache
from llm_inference_tpu_torch.parallel import sharding
from llm_inference_tpu_torch.utils import checkpoint

from torch_bridge import to_numpy_tree

F32_ATOL = 1e-4
# quantized weights: the projections round their outputs to bf16 in both
# packages (test_torch_model.py's LOGIT_ATOL)
LOGIT_ATOL = 1e-2


def tiny_mixtral(**kw):
    """tests/test_mixtral.py:18's config."""
    d = dict(name="mixtral-tiny", vocab_size=128, hidden_size=64,
             intermediate_size=96, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16, rms_norm_eps=1e-5,
             rope_theta=10000.0, max_position_embeddings=256,
             num_experts=4, experts_per_token=2, dtype="float32")
    d.update(kw)
    return JC.ModelConfig(**d)


def _cfg(jcfg):
    return C.ModelConfig.from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def dense():
    """JAX's dense float32 weights from a PRNG seed, and the port's."""
    jcfg = tiny_mixtral()
    jp = j_mixtral.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, llama.params_from_numpy(to_numpy_tree(jp),
                                               _cfg(jcfg), "cpu")


def _run_both(jcfg, jp, tp, T=12, steps=3, S=32, B=2, seed=0):
    """A T-token prefill (logits of every row), then `steps` decode steps
    at per-row positions: (port logits, JAX logits) of each call."""
    cfg = _cfg(jcfg)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    jc = j_kv.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                         cfg.head_dim, jnp.float32)
    tc = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                            cfg.head_dim, torch.float32, device="cpu")
    prefill = jax.jit(lambda *a: j_mixtral.forward(jcfg, *a,
                                                   logits_mode="all"))
    decode = jax.jit(lambda *a: j_mixtral.forward(jcfg, *a))
    jl, jc = prefill(jp, jnp.asarray(ids), jnp.asarray(pos), jc)
    tl, tc = mixtral.forward(cfg, tp, torch.from_numpy(ids),
                             torch.from_numpy(pos), tc, logits_mode="all")
    got, want = [tl.numpy()], [np.asarray(jl)]
    for s in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        p = np.array([[T + s], [T + 2 * s]], np.int32)[:B]
        jl, jc = decode(jp, jnp.asarray(tok), jnp.asarray(p), jc)
        tl, tc = mixtral.forward(cfg, tp, torch.from_numpy(tok),
                                 torch.from_numpy(p), tc)
        got.append(tl.numpy())
        want.append(np.asarray(jl))
    return got, want


def _assert_close(got, want, atol):
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def test_preset_and_registry():
    cfg, jcfg = C.preset("mixtral-8x7b"), JC.PRESETS["mixtral-8x7b"]()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert get_model("mixtral-8x7b") is mixtral
    assert get_model("mixtral") is mixtral


def test_forward_matches_jax_float32(dense):
    jcfg, jp, tp = dense
    got, want = _run_both(jcfg, jp, tp)
    _assert_close(got, want, F32_ATOL)


@pytest.mark.parametrize("weights,group", [("int8", 0), ("int4", 32)])
def test_forward_matches_jax_quantized(dense, weights, group):
    """Attention stacks [L, ...] and the flattened expert stacks [L·E,
    ...] quantized by JAX, carried across by the bridge, indexed at
    l·E + e by the port's K1 plain version."""
    jcfg, jp, _ = dense
    qcfg = JC.QuantConfig(weights=weights, group_size=group)
    jq = j_mixtral.quantize_params(jp, qcfg)
    tq = llama.params_from_numpy(to_numpy_tree(jq), _cfg(jcfg), "cpu")
    E, L = jcfg.num_experts, jcfg.num_layers
    assert tq["layers"]["e_gate"].q.shape[0] == L * E
    got, want = _run_both(jcfg, jq, tq)
    _assert_close(got, want, LOGIT_ATOL)
    # the port's own quantize_params gives the bridge's codes and scales
    own = mixtral.quantize_params(
        llama.params_from_numpy(to_numpy_tree(jp), _cfg(jcfg), "cpu"),
        C.QuantConfig(weights=weights, group_size=group))
    for k in ("wq", "wo", "e_gate", "e_down"):
        assert torch.equal(own["layers"][k].q, tq["layers"][k].q), k
        assert torch.equal(own["layers"][k].scale, tq["layers"][k].scale), k


def test_paged_forward_matches_dense(dense):
    """A 16-token prefill (two pages of 8, the pages scattered) and decode
    steps over a paged pool give the dense cache's logits."""
    jcfg, _, tp = dense
    cfg = _cfg(jcfg)
    rng = np.random.default_rng(3)
    B, T, ps, nb = 2, 16, 8, 4
    ids = torch.from_numpy(rng.integers(0, 128, (B, T)).astype(np.int32))
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    dc = kvcache.init_cache(2, B, 2, nb * ps, 16, torch.float32,
                            device="cpu")
    pc = paged_kvcache.init_paged_cache(2, 2 * B * nb + 1, 2, ps, 16, B, nb,
                                        torch.float32, device="cpu")
    pc.page_table[:] = torch.tensor([[3, 7, 1, 5], [2, 8, 4, 6]],
                                    dtype=torch.int32)
    want, _ = mixtral.forward(cfg, tp, ids, pos, dc, logits_mode="all")
    got, _ = mixtral.forward(cfg, tp, ids, pos, pc, logits_mode="all")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    for s in range(3):
        tok = torch.from_numpy(rng.integers(0, 128, (B, 1)).astype(np.int32))
        p = torch.full((B, 1), T + s, dtype=torch.int32)
        want, _ = mixtral.forward(cfg, tp, tok, p, dc)
        got, _ = mixtral.forward(cfg, tp, tok, p, pc)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)


def test_routing_tie_goes_to_the_lower_expert():
    """Router columns 1 and 3 equal, below column 0 and above column 2:
    probs[1] == probs[3] tie for the second place. jax.lax.top_k takes
    expert 1, and so does the port (torch.topk orders no ties)."""
    jcfg = tiny_mixtral(num_layers=1)
    cfg = _cfg(jcfg)
    rng = np.random.default_rng(7)
    H, E, I = jcfg.hidden_size, jcfg.num_experts, jcfg.intermediate_size
    router = np.tile(np.array([0.012, 0.01, -0.01, 0.01], np.float32),
                     (H, 1))
    x = np.abs(rng.normal(0, 1, (2, 5, H))).astype(np.float32)
    eg, eu = (rng.normal(0, 0.1, (E, H, I)).astype(np.float32)
              for _ in range(2))
    ed = rng.normal(0, 0.1, (E, I, H)).astype(np.float32)
    want = np.asarray(j_mixtral.moe_ffn(
        jcfg, jnp.asarray(x), jnp.asarray(router), jnp.asarray(eg),
        jnp.asarray(eu), jnp.asarray(ed)))
    t = torch.from_numpy
    sel = mixtral.router_weights(cfg, t(x), t(router))
    assert (sel[..., 1] > 0).all() and (sel[..., 3] == 0).all()
    got = mixtral.moe_ffn(cfg, t(x), t(router), t(eg), t(eu), t(ed), 0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the tie is real: expert 3 in place of expert 1 moves the output
    swapped = mixtral.moe_ffn(cfg, t(x), t(router), t(eg[[0, 3, 2, 1]]),
                              t(eu[[0, 3, 2, 1]]), t(ed[[0, 3, 2, 1]]), 0)
    assert np.abs(swapped.numpy() - want).max() > 1e-3


def test_generate_matches_jax(dense):
    jcfg, jp, tp = dense
    ecfg = dict(max_seq_len=64, prefill_buckets=(8, 16), decode_chunk=4)
    jeng = JEngine(jcfg, jp, engine_cfg=JC.EngineConfig(**ecfg),
                   cache_dtype=jnp.float32)
    teng = InferenceEngine(_cfg(jcfg), tp, engine_cfg=C.EngineConfig(**ecfg),
                           cache_dtype=torch.float32, device="cpu")
    assert teng._model is mixtral
    prompts = [[5, 9, 11, 3, 7, 2, 40, 41, 17], [8, 1, 2]]
    gen = dict(greedy=True, max_new_tokens=6, eos_token_ids=())
    want = [r.token_ids for r in jeng.generate(
        prompts, JC.GenerationConfig(**gen))]
    got = [r.token_ids for r in teng.generate(
        prompts, C.GenerationConfig(**gen))]
    assert got == want


def test_schedulers_and_prefix_cache(dense):
    """tests/test_mixtral.py:157-177 on the port: the paged scheduler with
    the prefix cache serves what it serves without, and the dense
    scheduler the same tokens."""
    jcfg, _, tp = dense
    eng = InferenceEngine(_cfg(jcfg), tp, engine_cfg=C.EngineConfig(
        max_seq_len=64, decode_chunk=4, max_batch_size=2,
        prefill_buckets=(8, 16), page_size=8), cache_dtype=torch.float32,
        device="cpu")
    gen = C.GenerationConfig(greedy=True, max_new_tokens=5,
                             eos_token_ids=(1,))
    prompt = list(np.random.default_rng(5).integers(2, 120, 17))
    want = [r.output_ids for r in scheduler.PagedScheduler(
        eng, gen, slots=2).run([list(prompt)] * 2)]
    sched = scheduler.PagedScheduler(eng, gen, slots=2, prefix_cache=True)
    got = [r.output_ids for r in sched.run([list(prompt)] * 2)]
    assert got == want
    assert sched.store.hit_tokens > 0
    dense_sched = scheduler.ContinuousBatchingScheduler(eng, gen, slots=2)
    assert [r.output_ids for r in dense_sched.run([list(prompt)] * 2)] == \
        want


def _hf_config():
    return {"model_type": "mixtral", "vocab_size": 128, "hidden_size": 64,
            "intermediate_size": 96, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 16, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
            "max_position_embeddings": 256, "num_local_experts": 4,
            "num_experts_per_tok": 2, "sliding_window": None}


def test_hf_config_and_state_dict_match_jax():
    d = _hf_config()
    cfg, jcfg = checkpoint.model_config_from_hf(d), \
        j_ckpt.model_config_from_hf(d)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    rng = np.random.default_rng(2)
    H, I, V, E = 64, 96, 128, 4

    def w(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)
    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": w(H),
          "lm_head.weight": w(V, H)}
    for i in range(2):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": w(H),
                   p + "post_attention_layernorm.weight": w(H),
                   p + "self_attn.q_proj.weight": w(64, H),
                   p + "self_attn.k_proj.weight": w(32, H),
                   p + "self_attn.v_proj.weight": w(32, H),
                   p + "self_attn.o_proj.weight": w(H, 64),
                   p + "block_sparse_moe.gate.weight": w(E, H)})
        for e in range(E):
            q = p + f"block_sparse_moe.experts.{e}."
            sd.update({q + "w1.weight": w(I, H), q + "w3.weight": w(I, H),
                       q + "w2.weight": w(H, I)})
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


def test_expert_parallelism_is_refused(dense):
    jcfg, _, tp = dense
    cfg = _cfg(jcfg)

    class Two:
        size = 2
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        sharding.validate_tp(cfg, 2)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        mixtral.forward(cfg, tp, torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros((1, 1), dtype=torch.int32), None, tp=Two)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        mixtral.quantize_params(tp, C.QuantConfig(weights="int8"),
                                ep_shards=2)


def test_init_params_quantized_draws_expert_stacks():
    cfg = _cfg(tiny_mixtral())
    p = mixtral.init_params_quantized(
        cfg, C.QuantConfig(weights="int4", group_size=32), seed=1,
        device="cpu")
    lay = p["layers"]
    assert lay["e_gate"].q.shape == (2 * 4, 96, 32)
    assert lay["e_down"].scale.shape == (2 * 4, 64, 3)
    assert lay["wq"].q.shape == (2, 64, 32)
    c = kvcache.init_cache(2, 1, 2, 16, 16, torch.float32, device="cpu")
    logits, _ = mixtral.forward(cfg, p, torch.tensor([[1, 2, 3]]),
                                torch.tensor([[0, 1, 2]]), c)
    assert torch.isfinite(logits).all()
