"""The families that the port serves on models/llama.py beside LLaMA-2
(llama3/3.1, mistral, qwen2, qwen3, phi3), on the CPU against the JAX
package: tests/test_model_families.py's cases on the port. Every new
preset equals JAX's field for field; the registry resolves the names and
refuses the families not ported; the forward with a binding sliding
window, qkv biases, qk-norm, head_dim 96, llama3.1's and longrope's RoPE
tables and a tied lm_head (with a final softcap) matches JAX's logits on
the same numpy-seeded weights (float32 tiny configs, dense and int8);
model_config_from_hf and convert_hf_state_dict equal JAX's on the same
HF dicts, phi3's fused keys included; the quantized tied lm_head has
JAX's codes and scales."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu import config as JC
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.models import registry as j_registry
from llm_inference_tpu.ops import kvcache as j_kv
from llm_inference_tpu.ops import rope as j_rope
from llm_inference_tpu.utils import checkpoint as j_ckpt

from llm_inference_tpu_torch import config as C
from llm_inference_tpu_torch.models import gemma2, get_model, llama
from llm_inference_tpu_torch.ops import kvcache, rope
from llm_inference_tpu_torch.utils import checkpoint

from torch_bridge import to_numpy_tree

NEW_PRESETS = ("llama3-8b", "llama3.1-8b", "llama3.1-70b", "mistral-7b",
               "qwen2-7b", "qwen3-8b", "phi3-mini", "gemma2-2b",
               "gemma2-9b", "gemma3-4b")
# float32 activations and weights on both sides: the same arithmetic up
# to the order of float32 sums over at most a few hundred terms
F32_ATOL = 1e-4
# int8 weights: test_torch_model.py's LOGIT_ATOL (the projections round
# their outputs to bf16 in both packages)
LOGIT_ATOL = 1e-2


def _cfgs(jcfg):
    """The port's copy of a JAX ModelConfig."""
    return C.ModelConfig.from_dict(dataclasses.asdict(jcfg))


def assert_same_config(cfg, jcfg):
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


# ---------------------------------------------------------------- presets

@pytest.mark.parametrize("name", NEW_PRESETS)
def test_preset_equals_jax_field_for_field(name):
    cfg, jcfg = C.preset(name), JC.PRESETS[name]()
    assert_same_config(cfg, jcfg)
    assert cfg.q_per_kv == jcfg.q_per_kv
    assert cfg.qkv_out_dim == jcfg.qkv_out_dim


# every preset of the JAX package is served since the mixture-of-experts
# slice (tests/test_torch_mixtral.py, test_torch_deepseek.py): names that
# neither package has still raise, naming themselves
@pytest.mark.parametrize("name", ("mixtral-8x22b", "deepseek-v2-lite",
                                  "gemma-7b"))
def test_unported_presets_raise(name):
    assert name not in JC.PRESETS
    with pytest.raises(NotImplementedError, match=name):
        C.preset(name)


# ---------------------------------------------------------------- registry

@pytest.mark.parametrize("name,module", [
    ("llama", llama), ("llama2-7b", llama), ("llama3-8b", llama),
    ("llama3.1-8b", llama), ("mistral-7b", llama), ("qwen2-7b", llama),
    ("qwen3", llama), ("phi3-mini", llama), ("tiny-llama", llama),
    ("tiny", llama), ("gemma2-2b", gemma2), ("gemma3-4b", gemma2),
    ("gemma3_text", gemma2), ("Gemma2", gemma2)])
def test_registry_resolves_names(name, module):
    assert get_model(name) is module
    if not name.startswith("llama3.1"):
        # JAX resolves the same names to the same family
        assert j_registry.get_model(name).__name__.rsplit(".", 1)[1] == \
            module.__name__.rsplit(".", 1)[1]


def test_registry_llama31_resolves_where_jax_does_not():
    """JAX's resolution tries "llama3.1-8b", "llama3.1" and the name again,
    none registered (llama.py:1006-1014): its engine cannot serve the
    preset. The port registers "llama3.1"."""
    with pytest.raises(KeyError):
        j_registry.get_model("llama3.1-8b")
    assert get_model(C.preset("llama3.1-70b").name) is llama


@pytest.mark.parametrize("name", ("mixtral-8x7b", "mixtral", "deepseek-v3",
                                  "deepseek_v3", "tiny-deepseek"))
def test_registry_unported_families_raise_not_implemented(monkeypatch, name):
    """The port serves these names (test_torch_mixtral.py,
    test_torch_deepseek.py) and keeps _NOT_PORTED empty; a family listed
    there and not registered raises NotImplementedError naming it."""
    from llm_inference_tpu_torch.models import registry
    assert registry._NOT_PORTED == ()
    assert get_model(name).__name__.rsplit(".", 1)[1] == \
        j_registry.get_model(name).__name__.rsplit(".", 1)[1]
    family = get_model(name)
    monkeypatch.setattr(registry, "_REGISTRY", {
        k: v for k, v in registry._REGISTRY.items() if v is not family})
    monkeypatch.setattr(registry, "_NOT_PORTED",
                        ("mixtral", "deepseek", "tiny-deepseek"))
    with pytest.raises(NotImplementedError, match="not ported"):
        get_model(name)


def test_registry_unknown_name_is_a_key_error():
    with pytest.raises(KeyError):
        get_model("bloom-7b")


# ---------------------------------------------------------------- forwards

def _jax_and_port_params(jcfg, seed=0, edit=None, quant=None, prepare=True):
    """JAX dense params from a PRNG seed (edited by `edit(layers, rng)`
    with numpy draws), int8-quantized with `quant`; the same weights as
    the port's params on the CPU, prepared (fused) unless told not to."""
    jp = j_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    if edit is not None:
        layers = dict(jp["layers"])
        edit(layers, np.random.default_rng(seed + 1))
        jp = dict(jp, layers=layers)
    if quant is not None:
        jp = j_llama.prepare_params(j_llama.quantize_params(jp, quant),
                                    donate=False)
    tp = llama.params_from_numpy(to_numpy_tree(jp), _cfgs(jcfg),
                                 device="cpu")
    return jp, llama.prepare_params(tp) if prepare else tp


def _run_both(jcfg, jp, tp, T=12, steps=3, S=32, B=2, seed=0):
    """A T-token prefill (logits of every row) and `steps` teacher-forced
    decode steps at per-row positions, JAX then the port; returns the
    logits of each call, JAX's and the port's."""
    cfg = _cfgs(jcfg)
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    dt = jnp.dtype(jcfg.dtype)
    jc = j_kv.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                         cfg.head_dim, dt)
    tc = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads, S,
                            cfg.head_dim, llama.act_dtype(cfg), device="cpu")
    # jitted with the config closed over: an eager call recompiles its
    # layer scan every time
    prefill = jax.jit(lambda *a: j_llama.forward(jcfg, *a, logits_mode="all"))
    decode = jax.jit(lambda *a: j_llama.forward(jcfg, *a))
    jl, jc = prefill(jp, jnp.asarray(ids), jnp.asarray(pos), jc)
    tl, tc = llama.forward(cfg, tp, torch.from_numpy(ids),
                           torch.from_numpy(pos), tc, logits_mode="all")
    got, want = [tl.numpy()], [np.asarray(jl)]
    for s in range(steps):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        p = np.array([[T + s], [T + 2 * s]], np.int32)[:B]
        jl, jc = decode(jp, jnp.asarray(tok), jnp.asarray(p), jc)
        tl, tc = llama.forward(cfg, tp, torch.from_numpy(tok),
                               torch.from_numpy(p), tc)
        got.append(tl.numpy())
        want.append(np.asarray(jl))
    return got, want


def _assert_close(got, want, atol):
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _random_biases(layers, rng):
    for k in ("bq", "bk", "bv"):
        layers[k] = jnp.asarray(rng.normal(0, 0.3, layers[k].shape),
                                layers[k].dtype)


def _random_qk_norms(layers, rng):
    for k in ("q_norm", "k_norm"):
        layers[k] = jnp.asarray(1 + rng.normal(0, 0.3, layers[k].shape),
                                layers[k].dtype)


LONGROPE = {"type": "longrope", "short_factor": [1.0 + 0.1 * i
                                                  for i in range(16)],
            "long_factor": [2.0 + 0.5 * i for i in range(16)],
            "original_max_position_embeddings": 16,
            "max_position_embeddings": 64}

FAMILY_CASES = {
    # mistral: the window (3) binds from the fourth token on
    "mistral-window": (dict(num_kv_heads=2, sliding_window=3), None),
    # qwen2: q/k/v biases, nonzero
    "qwen2-bias": (dict(num_kv_heads=2, qkv_bias=True), _random_biases),
    # qwen3: per-head qk-norm with non-unit weights
    "qwen3-qk-norm": (dict(num_kv_heads=2, qk_norm=True), _random_qk_norms),
    # phi3: MHA at head_dim 96 (three 32-lane chunks; no attention kernel
    # takes it, JAX's gates neither)
    "phi3-d96": (dict(num_heads=2, num_kv_heads=2, head_dim=96), None),
    # llama3.1's piecewise RoPE scaling over a short original context
    "llama3.1-rope": (dict(num_kv_heads=2, rope_theta=500000.0,
                           rope_scaling={"type": "llama3", "factor": 8.0,
                                         "low_freq_factor": 1.0,
                                         "high_freq_factor": 4.0,
                                         "original_max_position_embeddings":
                                         8}), None),
    # phi3's longrope past its 16-token original context
    "longrope": (dict(num_kv_heads=2, rope_scaling=LONGROPE), None),
    # a tied head with a final softcap (no lm_head in the params)
    "tied-softcap": (dict(num_kv_heads=2, tie_word_embeddings=True,
                          final_logit_softcap=3.0), None),
}


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_family_forward_matches_jax_float32(case):
    kw, edit = FAMILY_CASES[case]
    jcfg = JC.tiny_llama(**kw)
    jp, tp = _jax_and_port_params(jcfg, edit=edit)
    if jcfg.tie_word_embeddings:
        assert "lm_head" not in tp
    got, want = _run_both(jcfg, jp, tp, T=20 if "rope" in case else 12)
    _assert_close(got, want, F32_ATOL)


@pytest.mark.parametrize("case", ("qwen2-bias", "qwen3-qk-norm",
                                  "mistral-window"))
def test_family_forward_matches_jax_int8(case):
    """int8 weights and lm_head, prepared on both sides: the fused qkv
    bias (bqkv) and qk-norm on the port's pair-carry layer. Over a
    128-slot bf16 cache at head_dim 64 the decode steps take JAX's K2
    (interpret mode) and the port's plain version of it, with the
    window."""
    kw, edit = FAMILY_CASES[case]
    jcfg = JC.tiny_llama(head_dim=64, **kw)
    jp, tp = _jax_and_port_params(
        jcfg, edit=edit, quant=JC.QuantConfig(weights="int8",
                                              quantize_embedding=True))
    assert "bqkv" in tp["layers"] if jcfg.qkv_bias else True
    got, want = _run_both(jcfg, jp, tp, T=16, S=128)
    _assert_close(got, want, LOGIT_ATOL)


def test_mistral_window_binds_and_only_past_the_window():
    """Within the window (T = 2 < 3) the windowed model equals the full
    one; past it (the decode step at position 8) it does not."""
    base = JC.tiny_llama(num_kv_heads=2)
    win = JC.tiny_llama(num_kv_heads=2, sliding_window=3)
    _, tp = _jax_and_port_params(base)

    def run(jcfg, T):
        cfg = _cfgs(jcfg)
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(rng.integers(0, 256, (1, T)).astype(np.int32))
        cache = kvcache.init_cache(2, 1, 2, 32, cfg.head_dim, torch.float32,
                                   device="cpu")
        l0, cache = llama.forward(cfg, tp, ids, torch.arange(T)[None], cache)
        l1, _ = llama.forward(cfg, tp, l0.argmax(-1)[:, None].int(),
                              torch.tensor([[T]]), cache)
        return l0, l1
    (s0, _), (w0, _) = run(base, 2), run(win, 2)
    torch.testing.assert_close(s0, w0, atol=1e-6, rtol=0)
    (_, a1), (_, b1) = run(base, 8), run(win, 8)
    assert (a1 - b1).abs().max() > 1e-3


def test_rope_tables_match_jax():
    """llama3.1's and longrope's tables (the magnitude factor past the
    original context included) equal JAX's make_rope_table."""
    for P, D, theta, sc in ((64, 16, 500000.0,
                             JC.llama3_1_8b().rope_scaling),
                            (8, 32, 10000.0, LONGROPE),
                            (64, 32, 10000.0, LONGROPE)):
        jc, js = j_rope.make_rope_table(P, D, theta, sc)
        tc, ts = rope.make_rope_table(P, D, theta, sc, device="cpu")
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


# ---------------------------------------------------------------- HF config

HF_CONFIGS = {
    "llama3.1": {"model_type": "llama", "vocab_size": 128256,
                 "hidden_size": 4096, "intermediate_size": 14336,
                 "num_hidden_layers": 32, "num_attention_heads": 32,
                 "num_key_value_heads": 8, "rope_theta": 500000.0,
                 "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
                 "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                  "low_freq_factor": 1.0,
                                  "high_freq_factor": 4.0,
                                  "original_max_position_embeddings":
                                  8192}},
    "mistral": {"model_type": "mistral", "vocab_size": 32000,
                "hidden_size": 4096, "intermediate_size": 14336,
                "num_hidden_layers": 32, "num_attention_heads": 32,
                "num_key_value_heads": 8, "sliding_window": 4096,
                "max_position_embeddings": 32768},
    # no attention_bias key: HF Qwen2 has the biases; the window is off
    "qwen2": {"model_type": "qwen2", "vocab_size": 152064,
              "hidden_size": 3584, "intermediate_size": 18944,
              "num_hidden_layers": 28, "num_attention_heads": 28,
              "num_key_value_heads": 4, "rope_theta": 1e6,
              "rms_norm_eps": 1e-6, "sliding_window": 131072,
              "use_sliding_window": False, "tie_word_embeddings": False},
    "qwen3": {"model_type": "qwen3", "vocab_size": 151936,
              "hidden_size": 4096, "intermediate_size": 12288,
              "num_hidden_layers": 36, "num_attention_heads": 32,
              "num_key_value_heads": 8, "head_dim": 128,
              "attention_bias": False, "use_sliding_window": False,
              "sliding_window": None},
    # longrope: the magnitude inputs at the top level fold in
    "phi3": {"model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072,
             "intermediate_size": 8192, "num_hidden_layers": 32,
             "num_attention_heads": 32, "max_position_embeddings": 131072,
             "original_max_position_embeddings": 4096,
             "rope_scaling": {"type": "longrope",
                              "short_factor": [1.0] * 48,
                              "long_factor": [2.0] * 48}},
    "gemma2": {"model_type": "gemma2", "vocab_size": 256000,
               "hidden_size": 2304, "intermediate_size": 9216,
               "num_hidden_layers": 26, "num_attention_heads": 8,
               "num_key_value_heads": 4, "head_dim": 256,
               "sliding_window": 4096, "attn_logit_softcapping": 50.0,
               "final_logit_softcapping": 30.0,
               "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-6},
    "gemma3": {"model_type": "gemma3_text", "vocab_size": 262208,
               "hidden_size": 2560, "intermediate_size": 10240,
               "num_hidden_layers": 6, "num_attention_heads": 8,
               "num_key_value_heads": 4, "head_dim": 256,
               "rope_theta": 1e6, "rope_local_base_freq": 10000.0,
               "sliding_window": 1024, "query_pre_attn_scalar": 256,
               "rope_scaling": {"rope_type": "linear", "factor": 8.0},
               "layer_types": ["sliding_attention"] * 5
               + ["full_attention"]},
    "gemma3-pattern": {"model_type": "gemma3_text", "vocab_size": 128,
                       "hidden_size": 64, "intermediate_size": 128,
                       "num_hidden_layers": 12, "num_attention_heads": 4,
                       "num_key_value_heads": 2, "head_dim": 16,
                       "sliding_window": 512, "sliding_window_pattern": 6},
}


@pytest.mark.parametrize("family", sorted(HF_CONFIGS))
def test_model_config_from_hf_matches_jax(family):
    d = HF_CONFIGS[family]
    assert_same_config(checkpoint.model_config_from_hf(d),
                       j_ckpt.model_config_from_hf(d))


# mixtral and deepseek_v3 are served (test_torch_mixtral.py,
# test_torch_deepseek.py); DeepSeek-V2 and its VL variant are not
@pytest.mark.parametrize("model_type,err", [
    ("deepseek_v2", NotImplementedError),
    ("deepseek_vl_v2", NotImplementedError),
    ("gemma", NotImplementedError)])
def test_model_config_from_hf_refuses_unported(model_type, err):
    d = dict(HF_CONFIGS["mistral"], model_type=model_type)
    with pytest.raises(err):
        checkpoint.model_config_from_hf(d)


def _hf_state_dict(cfg, rng, phi3=False, gemma=False, tied=False):
    """A random HF-named state dict ([out, in] tensors, "model." keys) of a
    config: phi3's fused projections, qwen2's biases, q/k norms, gemma's
    sandwich norms, an lm_head unless tied."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def r(*shape):
        return rng.normal(0, 0.05, shape).astype(np.float32)
    sd = {"model.embed_tokens.weight": r(cfg.vocab_size, H),
          "model.norm.weight": r(H)}
    if not tied:
        sd["lm_head.weight"] = r(cfg.vocab_size, H)
    for i in range(L):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = r(H)
        sd[p + "post_attention_layernorm.weight"] = r(H)
        sd[p + "self_attn.o_proj.weight"] = r(H, nq)
        sd[p + "mlp.down_proj.weight"] = r(H, I)
        if phi3:
            sd[p + "self_attn.qkv_proj.weight"] = r(nq + 2 * nkv, H)
            sd[p + "mlp.gate_up_proj.weight"] = r(2 * I, H)
        else:
            for n, w in (("q", nq), ("k", nkv), ("v", nkv)):
                sd[p + f"self_attn.{n}_proj.weight"] = r(w, H)
            sd[p + "mlp.gate_proj.weight"] = r(I, H)
            sd[p + "mlp.up_proj.weight"] = r(I, H)
        if cfg.qkv_bias:
            for n, w in (("q", nq), ("k", nkv), ("v", nkv)):
                sd[p + f"self_attn.{n}_proj.bias"] = r(w)
        if cfg.qk_norm:
            sd[p + "self_attn.q_norm.weight"] = r(cfg.head_dim)
            sd[p + "self_attn.k_norm.weight"] = r(cfg.head_dim)
        if gemma:
            sd[p + "pre_feedforward_layernorm.weight"] = r(H)
            sd[p + "post_feedforward_layernorm.weight"] = r(H)
    return sd


@pytest.mark.parametrize("name,kw", [
    ("phi3", dict(num_heads=4, num_kv_heads=2, head_dim=16)),
    ("qwen2", dict(num_kv_heads=2, qkv_bias=True)),
    ("qwen3", dict(num_kv_heads=2, qk_norm=True)),
    ("gemma2", dict(num_kv_heads=2, tie_word_embeddings=True)),
    ("gemma3", dict(num_kv_heads=2, qk_norm=True,
                    tie_word_embeddings=True))])
def test_convert_hf_state_dict_matches_jax(name, kw):
    """The same HF state dict through both converters: every array equal
    (phi3's fused qkv_proj / gate_up_proj split; qwen2's biases; q/k
    norms; gemma's sandwich norms, the pre-FFN norm as ffn_norm)."""
    jcfg = JC.tiny_llama(name=name, intermediate_size=96, **kw)
    sd = _hf_state_dict(jcfg, np.random.default_rng(3), phi3=name == "phi3",
                        gemma=name.startswith("gemma"),
                        tied=jcfg.tie_word_embeddings)
    want = j_ckpt.convert_hf_state_dict(jcfg, sd, dtype="float32")
    got = checkpoint.convert_hf_state_dict(_cfgs(jcfg), sd, dtype="float32",
                                           device="cpu")

    def flat(tree, pre=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + "/")
            else:
                yield pre + k, v
    want, got = dict(flat(want)), dict(flat(got))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_phi3_hf_parity():
    """Phi3ForCausalLM's logits (transformers, imported only here) against
    the port's forward on its converted state dict, and JAX's on its."""
    torch_tf = pytest.importorskip("transformers")
    hf_cfg = torch_tf.Phi3Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, pad_token_id=0, torch_dtype="float32")
    torch.manual_seed(0)
    hf = torch_tf.Phi3ForCausalLM(hf_cfg).eval()
    cfg = dataclasses.replace(checkpoint.model_config_from_hf(hf.config),
                              dtype="float32")
    params = llama.prepare_params(checkpoint.convert_hf_state_dict(
        cfg, hf.state_dict(), dtype="float32", device="cpu"))
    ids = np.random.default_rng(1).integers(2, 120, (2, 6))
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
    cache = kvcache.init_cache(2, 2, cfg.num_kv_heads, 16, cfg.head_dim,
                               torch.float32, device="cpu")
    got, _ = llama.forward(cfg, params, torch.from_numpy(ids).int(),
                           torch.arange(6)[None].repeat(2, 1), cache,
                           logits_mode="all")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------- tied head

@pytest.mark.parametrize("bits,gs", [(8, 0), (4, 32)])
def test_quantized_tied_head_equals_jax(bits, gs, monkeypatch):
    """quantize_params on a tied model quantizes lm_head from the table:
    the same codes and scales as JAX's (llama.py:404-433), whatever the
    vocabulary chunk (the port's cut to 48 rows here, JAX's 32768); the
    int8 forward then runs K1's plain version on it within LOGIT_ATOL of
    JAX."""
    monkeypatch.setattr(llama, "_TIED_HEAD_CHUNK", 48)
    jcfg = JC.tiny_llama(num_kv_heads=2, tie_word_embeddings=True,
                         final_logit_softcap=30.0)
    jq = JC.QuantConfig(weights=f"int{bits}", group_size=gs,
                        quantize_embedding=True)
    dense = j_llama.init_params(jcfg, jax.random.PRNGKey(4))
    jqp = j_llama.quantize_params(dense, jq)
    assert "lm_head" in jqp
    tdense = llama.params_from_numpy(to_numpy_tree(dense), _cfgs(jcfg),
                                     device="cpu")
    tqp = llama.quantize_params(tdense, C.QuantConfig(
        weights=f"int{bits}", group_size=gs, quantize_embedding=True))
    want = llama.params_from_numpy(to_numpy_tree(
        {"embed": jqp["embed"], "lm_head": jqp["lm_head"]}), _cfgs(jcfg),
        device="cpu")["lm_head"]
    assert torch.equal(tqp["lm_head"].q, want.q)
    assert torch.equal(tqp["lm_head"].scale, want.scale)
    if bits == 4:
        return
    jprep = j_llama.prepare_params(jqp, donate=False)
    got, ref = _run_both(jcfg, jprep, llama.prepare_params(tqp), steps=2)
    _assert_close(got, ref, LOGIT_ATOL)


def test_init_params_quantized_builds_tied_head_and_family_keys():
    cfg = C.tiny_llama(num_kv_heads=2, tie_word_embeddings=True,
                       qkv_bias=True, qk_norm=True)
    p = llama.init_params_quantized(cfg, C.QuantConfig(
        weights="int4", group_size=32, quantize_embedding=True),
        device="cpu")
    head = p["lm_head"]
    assert (head.in_features, head.out_features) == (128, 256)
    assert head.bits == 4 and head.group_size == 32
    assert p["layers"]["bq"].shape == (2, 128)
    assert torch.equal(p["layers"]["q_norm"], torch.ones(2, 32))


def test_tied_bf16_head_within_one_rounding_of_the_jax_f32_dot():
    """A bf16 tied table: lm_logits reads it as it is (no float32 copy),
    the products exact and summed in float32, the logit rounded once to
    bf16 before it widens: within 2^-8 of each |logit| (one rounding is at
    most 2^-9) of JAX's float32 dot (llama.py:979-983)."""
    rng = np.random.default_rng(9)
    h = rng.normal(0, 1, (3, 64)).astype(np.float32)
    emb = rng.normal(0, 0.05, (300, 64)).astype(np.float32)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    eb = torch.from_numpy(emb).to(torch.bfloat16)
    got = llama.lm_logits(hb, {"embed": eb})
    assert got.dtype == torch.float32
    want = np.asarray(jnp.dot(jnp.asarray(hb.float().numpy()),
                              jnp.asarray(eb.float().numpy()).T))
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -8, atol=1e-6)
    # a float32 table takes no rounding
    got32 = llama.lm_logits(torch.from_numpy(h),
                            {"embed": torch.from_numpy(emb)})
    np.testing.assert_allclose(got32.numpy(), h @ emb.T, rtol=1e-5,
                               atol=1e-6)
