"""The weight formats beyond symmetric int8 per-channel and int4 against
the JAX package, on the CPU: grouped int8, zero points (asymmetric int8
and int4) and the split-half int4 route (prepare_params(int4_npair=
False), the CLI's --no-int4-npair).

- quantize, dequantize and qmatmul_ref bit for bit, or within float32
  summation order;
- K1 and K8's plain version (quant_matmul_ref) against JAX quant_matmul
  run in interpret mode, at M = 1, 8 and 130, with and without the
  prologue, each format on its JAX route (int4 N-pair or split-half);
- the routes: K6, K7 and K12 take no zero points and no split-half int4
  (their plain versions counted through a forward);
- greedy streams of the three LLaMA-2-7B slices cut to a tiny width:
  (a) int8 g=128 + bf16 KV, (b) asymmetric int4 g=128 + int8 KV, (c) int4
  g=128 on the split-half route, through generate and the dense
  scheduler against JAX's dense scheduler;
- forward logits of gemma2, mixtral and DeepSeek-V3 on asymmetric
  weights.

tests/test_torch_cuda.py holds the CUDA kernels to the plain versions on
a card.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu import config as JC
from llm_inference_tpu.engine import scheduler as j_sched
from llm_inference_tpu.engine.engine import InferenceEngine as JEngine
from llm_inference_tpu.models import deepseek as j_ds
from llm_inference_tpu.models import gemma2 as j_gemma2
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.models import mixtral as j_mixtral
from llm_inference_tpu.ops import kvcache as j_kv
from llm_inference_tpu.ops import quantization as j_quant
from llm_inference_tpu.ops.pallas import quant_matmul as j_qm

from llm_inference_tpu_torch import config as C
from llm_inference_tpu_torch.engine import scheduler as t_sched
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.models import deepseek, gemma2, llama, mixtral
from llm_inference_tpu_torch.ops import kvcache, quantization
from llm_inference_tpu_torch.ops.kernels import layer_fused
from llm_inference_tpu_torch.ops.kernels import quant_matmul as t_qm

from torch_bridge import (assert_streams_agree, to_numpy, to_numpy_tree,
                          to_torch)

# (bits, group size (0: per channel), zero points)
FORMATS = [(8, 128, False), (8, 128, True), (8, 0, True), (4, 128, True),
           (4, 0, True), (4, 32, True)]


def _fmt_id(f):
    bits, gs, asym = f
    return f"int{bits}-g{gs}-{'asym' if asym else 'sym'}"


def _skewed(rng, shape):
    """Weights whose columns sit off zero, where zero points matter."""
    return (rng.standard_normal(shape) * 0.05
            + rng.uniform(-0.1, 0.1, shape[:-2] + (1, shape[-1]))
            ).astype(np.float32)


# ------------------------------------------------------- quantization

@pytest.mark.parametrize("fmt", FORMATS, ids=_fmt_id)
def test_quantize_dequantize_qmatmul_ref_match_jax(fmt):
    bits, gs, asym = fmt
    rng = np.random.default_rng(bits + gs + asym)
    w = _skewed(rng, (256, 64))
    x = rng.standard_normal((3, 256)).astype(np.float32)
    jq = j_quant.quantize(jnp.asarray(w), bits, gs, asymmetric=asym)
    tq = quantization.quantize(torch.from_numpy(w), bits, gs, asym)
    assert tq.grouped == (bits == 4 or gs > 0)
    jcodes = jq.q if bits == 8 else j_quant._unpack_int4(jq.q,
                                                         jq.block_rows)
    np.testing.assert_array_equal(quantization.codes(tq).T.numpy(),
                                  np.asarray(jcodes))
    lay = (lambda t: t.T) if tq.grouped else (lambda t: t)
    np.testing.assert_array_equal(lay(tq.scale).numpy(),
                                  np.asarray(jq.scale))
    if asym:
        np.testing.assert_array_equal(lay(tq.zbias).numpy(),
                                      np.asarray(jq.zbias))
    np.testing.assert_array_equal(
        quantization.dequantize(tq).numpy(),
        np.asarray(j_quant.dequantize(jq, jnp.float32)))
    want = np.asarray(j_quant.qmatmul_ref(jnp.asarray(x), jq))
    got = quantization.qmatmul_ref(torch.from_numpy(x), tq).numpy()
    # the same products; the float32 summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cat_columns_keeps_one_format():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(_skewed(rng, (128, 64)))
    a = quantization.quantize(w, 8, 0, True)
    b = quantization.quantize(w, 8, 0, False)
    with pytest.raises(ValueError, match="symmetric and asymmetric"):
        quantization.cat_columns([a, b])
    with pytest.raises(ValueError, match="layouts"):
        quantization.cat_columns([quantization.quantize(w, 8, 64), b])
    both = quantization.cat_columns([a, a])
    assert both.zbias.shape == (1, 128)
    np.testing.assert_array_equal(
        quantization.dequantize(both).numpy(),
        np.concatenate([quantization.dequantize(a).numpy()] * 2, axis=1))


# ------------------------------------------------------------- K1, K8

def _jax_weight(fmt, npair, L=2, K=256, N=256, seed=0):
    """A stacked JAX weight in its serving layout (int4: N-pair or
    split-half blocked) and the port's copy through the bridge."""
    bits, gs, asym = fmt
    w = _skewed(np.random.default_rng(seed), (L, K, N))
    qt = jax.vmap(lambda m: j_quant.quantize(m, bits, gs,
                                             asymmetric=asym))(
        jnp.asarray(w))
    if bits == 4 and npair:
        jqt = j_quant.to_blocked_npair(
            qt, j_quant.choose_block_n(K // 2, N, quantum=256))
    else:
        jqt = j_quant.to_blocked(qt, j_quant.choose_block_n(
            K // 2 if bits == 4 else K, N))
    tqt = llama.qtensor_from_numpy(to_numpy_tree(jqt), "cpu")
    return jqt, tqt


# grouped int8, zero points on int8 per channel and on grouped int4 (the
# N-pair route), and the split-half route
K1_FORMATS = [((8, 128, False), True), ((8, 0, True), True),
              ((4, 128, True), True), ((4, 128, False), False)]


@pytest.mark.parametrize("fmt,npair", K1_FORMATS,
                         ids=["int8-g128", "int8-asym", "int4-g128-asym",
                              "int4-g128-split-half"])
@pytest.mark.parametrize("M", [1, 8, 130])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_k8_plain_match_jax_kernels(fmt, npair, M, prologue):
    rng = np.random.default_rng(M + prologue)
    K = 256
    jqt, tqt = _jax_weight(fmt, npair, K=K, seed=fmt[1] + fmt[2])
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    kw = {}
    if prologue:
        kw = dict(norm_gamma=jnp.asarray(1 + 0.1 * rng.standard_normal(K),
                                         jnp.bfloat16),
                  residual=jnp.asarray(rng.standard_normal((M, K)),
                                       jnp.bfloat16), want_x_out=True)
    want = j_qm.quant_matmul(x, jqt, layer=1, norm_eps=1e-5, **kw)
    got = t_qm.quant_matmul(to_torch(x), tqt, 1, norm_eps=1e-5,
                            **{k: (to_torch(v) if k != "want_x_out" else v)
                               for k, v in kw.items()})
    if prologue:
        (want, want_x), (got, got_x) = want, got
        np.testing.assert_array_equal(to_numpy(got_x),
                                      np.asarray(want_x, np.float32))
    want = np.asarray(want, np.float32)
    # bf16 outputs of the same products and sums taken in another float32
    # order (int4: the groups' lo and hi halves); the normalised rows may
    # land a bf16 rounding apart where the norm's mean is summed in
    # another order: one bf16 step of the largest output
    err = np.abs(to_numpy(got) - want).max()
    assert err <= 2.0 ** -8 * np.abs(want).max(), err


# ------------------------------------------------------------ routes

def _tiny(**kw):
    d = dict(hidden_size=256, intermediate_size=512, num_heads=4,
             num_kv_heads=2, head_dim=128, vocab_size=320)
    d.update(kw)
    return C.tiny_llama(**d)


@pytest.mark.parametrize("case,fused", [("int4-npair", True),
                                        ("int4-asym", False),
                                        ("int4-split-half", False),
                                        ("int8-asym", False)])
def test_fused_layer_kernels_skip_zero_points_and_split_half(
        case, fused, monkeypatch):
    """A decode step at B = 1 with LLMI_LAYER_MEGA=1: K12 (and without
    it K6) take the symmetric N-pair int4 layer, and neither takes zero
    points or split-half int4 (their plain versions counted); the K7 and
    K6 checks refuse zero points outright, and split-half int4 (the same
    weights, prepare_params' mark) is the forward's choice."""
    cfg = _tiny()
    bits = 8 if case.startswith("int8") else 4
    qcfg = C.QuantConfig(weights=f"int{bits}", group_size=128,
                         asymmetric="asym" in case)
    if bits == 8:
        qcfg = dataclasses.replace(qcfg, group_size=0)
    prep = llama.prepare_params(
        llama.init_params_quantized(cfg, qcfg, seed=4, device="cpu"),
        int4_npair=case != "int4-split-half")
    calls = {"k6": 0, "k12": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(t_qm, "layer_tail_fused_ref",
                        counted("k6", t_qm.layer_tail_fused_ref))
    monkeypatch.setattr(layer_fused, "layer_decode_fused_ref",
                        counted("k12", layer_fused.layer_decode_fused_ref))
    L = prep["layers"]
    for mega in ("1", "0"):
        monkeypatch.setenv("LLMI_LAYER_MEGA", mega)
        c = kvcache.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, 128,
                               cfg.head_dim, torch.bfloat16, device="cpu")
        ids = torch.tensor([[5]], dtype=torch.int32)
        llama.forward(cfg, prep, ids, ids, c)
    want = cfg.num_layers if fused else 0
    assert calls == {"k6": want, "k12": want}
    h = torch.zeros((1, 1, cfg.hidden_size))
    attn = torch.zeros((1, 1, cfg.num_heads * cfg.head_dim))
    args = (L["wo"], L["w_gateup"], L["w_down"])
    assert (llama.SPLIT_HALF in prep) == (case == "int4-split-half")
    takes = fused or case == "int4-split-half"
    assert (t_qm._tail_shapes(h, attn, *args) is not None) == takes
    assert (t_qm._ffn_shapes(h, *args[1:]) is not None) == takes


# ----------------------------------------------------- greedy streams

# (a), (b), (c) of the slice: (weights, group size, zero points, int4
# N-pair route, KV cache)
SLICES = {"a-int8-g128": ("int8", 128, False, True, "bf16"),
          "b-int4-g128-asym": ("int4", 128, True, True, "int8"),
          "c-int4-g128-split-half": ("int4", 128, False, False, "bf16")}
ECFG = dict(max_seq_len=64, decode_chunk=4, max_batch_size=2,
            prefill_buckets=(8, 16))
NEW = 8


@pytest.mark.parametrize("name", sorted(SLICES))
def test_greedy_streams_match_jax(name):
    """The JAX package's dense scheduler against the port's generate (B =
    1 a request) and its dense scheduler, on JAX's random codes of a
    tiny LLaMA (float32 activations, lm_head sharpened 16x so that most
    steps are far from ties), with the streams compared up to a JAX top-2
    logprob gap within 2e-2 (assert_streams_agree)."""
    weights, gs, asym, npair, kv = SLICES[name]
    kw = dict(hidden_size=256, intermediate_size=512, num_heads=4,
              num_kv_heads=2, head_dim=64, vocab_size=320)
    jcfg, cfg = JC.tiny_llama(**kw), C.tiny_llama(**kw)
    qp = j_llama.init_params_quantized(
        jcfg, jax.random.PRNGKey(7), JC.QuantConfig(
            weights=weights, group_size=gs, asymmetric=asym,
            quantize_embedding=True))
    qp = dict(qp, lm_head=qp["lm_head"].replace(
        scale=qp["lm_head"].scale * 16))
    jprep = j_llama.prepare_params(qp, donate=False, int4_npair=npair)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"), int4_npair=npair)
    assert (tprep["layers"]["wqkv"].zbias is not None) == asym
    jdt = jnp.bfloat16 if kv == "bf16" else kv
    tdt = torch.bfloat16 if kv == "bf16" else kv
    jeng = JEngine(jcfg, jprep, engine_cfg=JC.EngineConfig(**ECFG),
                   cache_dtype=jdt)
    teng = InferenceEngine(cfg, tprep, engine_cfg=C.EngineConfig(**ECFG),
                           cache_dtype=tdt, device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 320, 11).tolist(),
               rng.integers(3, 320, 5).tolist()]
    js = j_sched.ContinuousBatchingScheduler(jeng, JC.GenerationConfig(
        greedy=True, max_new_tokens=NEW, eos_token_ids=()))
    want = [js.submit(list(p), top_logprobs=2) for p in prompts]
    while js.step():
        pass
    gen = C.GenerationConfig(greedy=True, max_new_tokens=NEW,
                             eos_token_ids=())
    ts = t_sched.ContinuousBatchingScheduler(teng, gen)
    got = [ts.submit(list(p)) for p in prompts]
    while ts.step():
        pass
    assert_streams_agree(got, want)

    @dataclasses.dataclass
    class Stream:
        output_ids: list
    assert_streams_agree([Stream(teng.generate([p], gen)[0].token_ids)
                          for p in prompts], want)


# ------------------------------------------------------------ families

# quantized weights: the projections round their outputs to bf16 in both
# packages (test_torch_model.py's LOGIT_ATOL)
LOGIT_ATOL = 1e-2


def _np_init(init, jcfg, seed=0):
    """The family's parameter tree drawn with numpy, as its init_params
    shapes it (the JAX draw takes seconds a tree on the CPU), as
    test_torch_deepseek.py draws it: norms near 1, router biases in
    ±0.05 (DeepSeek's sigmoid router then leaves no near-ties between
    its experts), everything else N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init(jcfg, jax.random.PRNGKey(0)))

    def draw(path, t):
        name = str(path[-1])
        if "norm" in name:
            v = 1 + rng.normal(0, 0.1, t.shape)
        elif "router_bias" in name:
            v = rng.uniform(-0.05, 0.05, t.shape)
        else:
            v = rng.normal(0, 0.02, t.shape)
        return jnp.asarray(v, t.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _prefill_logits(forward_t, forward_j, cfg, tp, jp, cache_t, cache_j,
                    T=12, B=2):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    jl, _ = jax.jit(lambda *a: forward_j(*a, logits_mode="all"))(
        jp, jnp.asarray(ids), jnp.asarray(pos), cache_j)
    tl, _ = forward_t(cfg, tp, torch.from_numpy(ids), torch.from_numpy(pos),
                      cache_t, logits_mode="all")
    return to_numpy(tl), np.asarray(jl, np.float32)


def _family(name):
    """(port logits, JAX logits) of a 12-token prefill of a tiny model of
    the family on JAX's asymmetrically quantized weights."""
    if name == "gemma2":
        d = dict(name="gemma2-tiny", vocab_size=128, hidden_size=64,
                 intermediate_size=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, head_dim=16, rms_norm_eps=1e-6,
                 rope_theta=10000.0, max_position_embeddings=256,
                 tie_word_embeddings=True, attn_logit_softcap=50.0,
                 final_logit_softcap=30.0, sliding_window=8,
                 sliding_pattern="alternating", query_pre_attn_scalar=32.0,
                 scale_embeddings=True, dtype="float32")
        jcfg = JC.ModelConfig(**d)
        # unblocked: the JAX projections take qmatmul_ref (its kernels
        # are held to the port's in test_k1_k8_plain_match_jax_kernels)
        jp = j_llama.quantize_params(
            _np_init(j_gemma2.init_params, jcfg),
            JC.QuantConfig(weights="int4", group_size=32, asymmetric=True,
                           quantize_embedding=True))
        mod_t, fwd_j = gemma2, lambda *a, **k: j_gemma2.forward(jcfg, *a,
                                                               **k)
    elif name == "mixtral":
        jcfg = JC.ModelConfig(
            name="mixtral-tiny", vocab_size=128, hidden_size=64,
            intermediate_size=96, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, rms_norm_eps=1e-5, rope_theta=10000.0,
            max_position_embeddings=256, num_experts=4, experts_per_token=2,
            dtype="float32")
        jp = j_mixtral.quantize_params(
            _np_init(j_mixtral.init_params, jcfg),
            JC.QuantConfig(weights="int4", group_size=32, asymmetric=True))
        mod_t, fwd_j = mixtral, lambda *a, **k: j_mixtral.forward(jcfg, *a,
                                                                 **k)
    else:
        jcfg = JC.tiny_deepseek()
        jp = jax.jit(lambda p: j_ds.quantize_params(p, JC.QuantConfig(
            weights="int8", asymmetric=True)))(
            _np_init(j_ds.init_params, jcfg))
        mod_t, fwd_j = deepseek, lambda *a, **k: j_ds.forward(jcfg, *a, **k)
    cfg = C.ModelConfig.from_dict(dataclasses.asdict(jcfg))
    tp = llama.params_from_numpy(to_numpy_tree(jp), cfg, "cpu")
    if name == "deepseek":
        ct = deepseek.new_cache(cfg, 2, 32, torch.float32, device="cpu")
        cj = j_ds.new_cache(jcfg, 2, 32, jnp.float32)
    else:
        ct = kvcache.init_cache(cfg.num_layers, 2, cfg.num_kv_heads, 32,
                                cfg.head_dim, torch.float32, device="cpu")
        cj = j_kv.init_cache(cfg.num_layers, 2, cfg.num_kv_heads, 32,
                             cfg.head_dim, jnp.float32)
    assert any(isinstance(v, quantization.QTensor) and v.zbias is not None
               for v in tp["layers"].values()) if "layers" in tp else True
    return _prefill_logits(mod_t.forward, fwd_j, cfg, tp, jp, ct, cj)


@pytest.mark.parametrize("name", ["gemma2", "mixtral", "deepseek"])
def test_family_forward_on_asymmetric_weights_matches_jax(name):
    got, want = _family(name)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
