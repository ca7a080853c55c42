"""The port's B = 1 chat path against the JAX package's, on the CPU: the
sampling penalties and logit bias, `generate` with them, ChatSession over
two rounds, the chat templates, the tokenizers, the checkpoint loaders
(HF safetensors, the reference .bin directory), the LLaMA-2 presets and
the CLI REPL. Weights cross through tests/torch_bridge.py."""

import copy
import dataclasses
import io
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu import config as j_config
from llm_inference_tpu.config import EngineConfig as JEngineConfig
from llm_inference_tpu.config import GenerationConfig as JGenerationConfig
from llm_inference_tpu.config import QuantConfig as JQuantConfig
from llm_inference_tpu.engine import engine as j_engine
from llm_inference_tpu.engine import tokenizer as j_tok
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.ops import kvcache as j_kv
from llm_inference_tpu.ops import sampling as j_sampling
from llm_inference_tpu.utils import checkpoint as j_ckpt

from llm_inference_tpu_torch import cli
from llm_inference_tpu_torch import config as t_config
from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            QuantConfig, tiny_llama)
from llm_inference_tpu_torch.engine import engine as t_engine
from llm_inference_tpu_torch.engine import tokenizer as t_tok
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache, sampling
from llm_inference_tpu_torch.utils import checkpoint as t_ckpt

from torch_bridge import to_numpy, to_numpy_tree

S = 128
BUCKETS = (16, 32)
# the port's logits agree with the JAX package's within 1e-2
# (test_torch_model): two greedy streams may part only where JAX's top-2
# gap of the biased, penalized logits is narrower
GAP_TOL = 2e-2
PENALIZED = dict(repetition_penalty=1.3, presence_penalty=0.5,
                 frequency_penalty=0.3, logit_bias={5: 2.0, 7: -100.0,
                                                    60: 0.75})


# ------------------------------------------------------------- sampling

def test_apply_penalties_and_bias_match_jax():
    rng = np.random.default_rng(0)
    B, V = 3, 64
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    seen = (rng.random((B, V)) < 0.3) | (counts > 0)
    rep = np.array([1.0, 1.3, 0.7], np.float32)
    pres = np.array([0.0, 0.5, 1.5], np.float32)
    freq = np.array([0.2, 0.0, 0.3], np.float32)
    want = j_sampling.apply_penalties(*map(jnp.asarray, (
        logits, counts, seen, rep, pres, freq)))
    got = sampling.apply_penalties(*map(torch.from_numpy, (
        logits, counts, seen, rep, pres, freq)))
    # the same float32 ops; XLA may fuse a product into its subtraction
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the bias row: as the JAX engine's _bias_row_np, ids validated
    jeng = type("E", (), {"cfg": j_config.tiny_llama()})()
    bias = {3: 1.5, "7": -2.0, 255: 0.1}
    np.testing.assert_array_equal(
        sampling.bias_row(bias, 256).numpy(),
        j_engine.InferenceEngine._bias_row_np(jeng, bias))
    for bad in ({256: 1.0}, {-1: 1.0}):
        with pytest.raises(ValueError):
            sampling.bias_row(bad, 256)
        with pytest.raises(ValueError):
            j_engine.InferenceEngine._bias_row_np(jeng, bad)


# ------------------------------------------------- generate, ChatSession

@pytest.fixture(scope="module")
def engines():
    jcfg = j_config.tiny_llama(head_dim=64)
    cfg = tiny_llama(head_dim=64)
    qp = j_llama.quantize_params(
        j_llama.init_params(jcfg, jax.random.PRNGKey(2)),
        JQuantConfig(weights="int8", quantize_embedding=True))
    jprep = j_llama.prepare_params(qp, donate=False)
    tprep = llama.prepare_params(llama.params_from_numpy(
        to_numpy_tree(jprep), cfg, device="cpu"))
    jeng = j_engine.InferenceEngine(jcfg, jprep, engine_cfg=JEngineConfig(
        max_seq_len=S, decode_chunk=4, prefill_buckets=BUCKETS))
    teng = t_engine.InferenceEngine(cfg, tprep, engine_cfg=EngineConfig(
        max_seq_len=S, decode_chunk=4, prefill_buckets=BUCKETS),
        device="cpu")
    return jcfg, jprep, jeng, teng


def _jax_gaps(jcfg, jprep, history, stream, pen, seen_ids=None):
    """JAX's top-2 gap of the biased, penalized logits before each token of
    its greedy `stream` after `history` (the repetition scope is
    seen_ids, default the history)."""
    cache = j_kv.init_cache(jcfg.num_layers, 1, jcfg.num_kv_heads, S,
                            jcfg.head_dim, jnp.bfloat16)
    n = len(history)
    logits, cache = j_llama.forward(
        jcfg, jprep, jnp.asarray([history], jnp.int32),
        jnp.arange(n, dtype=jnp.int32)[None], cache)
    V = jcfg.vocab_size
    seen = np.zeros((1, V), bool)
    seen[0, list(seen_ids or history)] = True
    counts = np.zeros((1, V), np.int32)
    bias = np.zeros((V,), np.float32)
    for t, b in pen["logit_bias"].items():
        bias[t] = b

    def knob(name):
        return jnp.full((1,), pen[name], jnp.float32)
    gaps = []
    for j, tok in enumerate(stream):
        pl = np.asarray(j_sampling.apply_penalties(
            logits + bias, jnp.asarray(counts), jnp.asarray(seen),
            knob("repetition_penalty"), knob("presence_penalty"),
            knob("frequency_penalty")))[0]
        top2 = np.sort(pl)[-2:]
        gaps.append(top2[1] - top2[0])
        counts[0, tok] += 1
        seen[0, tok] = True
        logits, cache = j_llama.forward(
            jcfg, jprep, jnp.asarray([[tok]], jnp.int32),
            jnp.asarray([[n + j]], jnp.int32), cache)
    return gaps


def _agree(got, want, gaps):
    """The tokens compared equal before the streams part, which they may
    only at a near-tie of JAX's logits (random weights give near-flat
    logits: a tie where both picked the same token leaves the streams in
    step, so the comparison goes on past it)."""
    assert len(got) == len(want)
    for j, gap in enumerate(gaps):
        if got[j] != want[j]:
            assert gap < GAP_TOL, (j, gap, got, want)
            return j
    return len(want)


@pytest.mark.parametrize("pen", [PENALIZED,
                                 dict(PENALIZED, repetition_penalty=1.0,
                                      logit_bias=None)])
def test_generate_with_penalties_matches_jax(engines, pen):
    jcfg, jprep, jeng, teng = engines
    prompt = [1, 17, 103, 42, 7, 17, 5]
    new = 10
    kw = dict(greedy=True, max_new_tokens=new, eos_token_ids=(), **pen)
    want = jeng.generate([prompt], JGenerationConfig(**kw))[0].token_ids
    got = teng.generate([prompt], GenerationConfig(**kw))[0].token_ids
    gaps = _jax_gaps(jcfg, jprep, prompt, want,
                     dict(pen, logit_bias=pen["logit_bias"] or {}))
    assert _agree(got, want, gaps) >= new // 2
    # the penalties and bias act: without them the stream differs
    plain = teng.generate([prompt], GenerationConfig(
        greedy=True, max_new_tokens=new, eos_token_ids=()))[0].token_ids
    assert plain != got
    if pen["logit_bias"]:
        assert 7 not in got                    # biased by -100


class TokStub:
    """Space-separated integers as a tokenizer (both packages' sessions)."""
    def encode(self, text, add_bos=True):
        return ([1] if add_bos else []) + [int(t) for t in text.split()]

    def decode(self, ids):
        return " ".join(map(str, ids))

    def decode_token(self, tid):
        return f"{tid} "


def test_chat_session_two_rounds_match_jax(engines):
    jcfg, jprep, jeng, teng = engines
    jeng.tokenizer, teng.tokenizer = TokStub(), TokStub()
    try:
        js = j_engine.ChatSession(jeng, template=lambda text, r: text)
        ts = t_engine.ChatSession(teng, template=lambda text, r: text)
        kw = dict(greedy=True, max_new_tokens=6, eos_token_ids=(),
                  **PENALIZED)
        streamed = []
        history, seen_ids = [], set()
        for turn in ("5 9 33 17", "70 3"):
            want = [int(t) for t in js.ask(turn,
                                           JGenerationConfig(**kw)).split()]
            got = [int(t) for t in ts.ask(
                turn, GenerationConfig(**kw),
                stream=lambda s: streamed.append(int(s))).split()]
            # the turn follows the previous round's carried last token
            history += ([1] if not history else [history_last]) + [
                int(t) for t in turn.split()]
            seen_ids |= set(history)
            gaps = _jax_gaps(jcfg, jprep, history, want,
                             dict(PENALIZED), seen_ids)
            assert _agree(got, want, gaps) >= 3
            assert got == want
            history += want[:-1]
            history_last = want[-1]
            seen_ids |= set(want)
            assert (ts.pos, ts.round, ts._pending) == (js.pos, js.round,
                                                       js._pending)
        assert streamed[-6:] == got
    finally:
        jeng.tokenizer = teng.tokenizer = None


@pytest.mark.parametrize("name", ["llama2-7b", "llama3-8b", "qwen2-7b",
                                  "gemma2-2b", "phi3-mini", "mistral-7b"])
def test_chat_templates_match_jax(name):
    assert (t_engine.chat_template_for(name)("hi there", 1)
            == j_engine.chat_template_for(name)("hi there", 1))
    for msgs in ([{"role": "user", "content": "a"}],
                 [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": "q1"},
                  {"role": "assistant", "content": "r1"},
                  {"role": "user", "content": "q2"},
                  {"role": "user", "content": "q3"}]):
        assert (t_engine.format_chat_messages(msgs, name)
                == j_engine.format_chat_messages(msgs, name))


# ------------------------------------------------------------ tokenizers

def _vocab(with_bytes=True):
    vocab, tid = {}, 0
    for t in ("<unk>", "<s>", "</s>"):
        vocab[t.encode()] = (tid, 0.0)
        tid += 1
    if with_bytes:
        for i in range(256):
            vocab[b"<0x%02X>" % i] = (tid, -1000.0)
            tid += 1
    pieces = ["▁", "a", "b", "c", "h", "e", "l", "o", "w", "r", "d",
              "ab", "abc", "▁ab", "▁h", "▁he", "ll", "llo", "▁hello",
              "▁w", "▁wo", "or", "orl", "orld", "▁world", "!"]
    for p in pieces:
        vocab[p.encode()] = (tid, float(len(p)))
        tid += 1
    return vocab


TEXTS = ["hello world!", "abc ab c", "x y z", "héllo wörld", "  two  spaces",
         ""]


def test_bpe_tokenizer_matches_jax(tmp_path):
    kv = {"bos_token_id": "1", "eos_token_id": "2"}
    jt = j_tok.BPETokenizer(_vocab(), kv=kv)
    tt = t_tok.BPETokenizer(_vocab(), kv=kv)
    for text in TEXTS:
        for bos in (True, False):
            assert tt.encode(text, add_bos=bos) == jt.encode(text, add_bos=bos)
        ids = tt.encode(text)
        assert tt.decode(ids) == jt.decode(ids) == text
        assert ([tt.decode_token(i) for i in ids]
                == [jt.decode_token(i) for i in ids])
    # the binary format: the port writes what the JAX package reads, and
    # reads back what it wrote
    path = tmp_path / "tokenizer.bin"
    tt.save_binary(str(path))
    back = t_tok.load_tokenizer(str(path))
    assert isinstance(back, t_tok.BPETokenizer)
    jback = j_tok.BPETokenizer.from_binary(str(path))
    assert back.vocab_size == jback.vocab_size == tt.vocab_size
    assert (back.bos_id, back.eos_id) == (jback.bos_id, jback.eos_id) == (1, 2)
    for text in TEXTS:
        assert back.encode(text) == jback.encode(text) == jt.encode(text)
    assert isinstance(t_tok.load_tokenizer(str(tmp_path)), t_tok.BPETokenizer)


def test_hf_tokenizer_matches_jax(tmp_path, monkeypatch):
    tokenizers = pytest.importorskip("tokenizers")
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "hello": 3, "world": 4, "!": 5}
    tk = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        vocab=vocab, unk_token="<unk>"))
    tk.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    path = tmp_path / "tokenizer.json"
    tk.save(str(path))
    jt = j_tok.HFTokenizer(str(path))
    tt = t_tok.load_tokenizer(str(tmp_path))
    assert isinstance(tt, t_tok.HFTokenizer)
    for text in ("hello world !", "world hello", "what"):
        ids = tt.encode(text)
        assert ids == jt.encode(text)
        assert tt.decode(ids) == jt.decode(ids)
    assert (tt.bos_id, tt.eos_id, tt.vocab_size) == (jt.bos_id, jt.eos_id,
                                                     jt.vocab_size)
    # where the package is missing (the card's machine), a clear error
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="tokenizers"):
        t_tok.HFTokenizer(str(path))


# ----------------------------------------------------------- checkpoints

@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attention_bias=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    path = tmp_path_factory.mktemp("hf")
    model.save_pretrained(str(path), safe_serialization=True)
    bf16 = tmp_path_factory.mktemp("hf_bf16")
    copy.deepcopy(model).to(torch.bfloat16).save_pretrained(
        str(bf16), safe_serialization=True)
    return model, str(path), str(bf16)


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
        return
    w = np.asarray(want, np.float32)
    assert tuple(got.shape) == w.shape
    np.testing.assert_array_equal(to_numpy(got), w)


@pytest.mark.parametrize("dtype", ["float32", None])
def test_load_hf_checkpoint_matches_jax_and_hf(hf_dir, dtype):
    model, path, _ = hf_dir
    jcfg, jparams = j_ckpt.load_hf_checkpoint(path, dtype=dtype)
    cfg, params = t_ckpt.load_hf_checkpoint(path, dtype=dtype, device="cpu")
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    _assert_trees_equal(params, jparams)
    if dtype != "float32":
        return
    # logits of the dense float32 model against HF's own forward
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    cache = kvcache.init_cache(cfg.num_layers, 2, cfg.num_kv_heads, 64,
                               cfg.head_dim, torch.float32, device="cpu")
    logits, _ = llama.forward(cfg, params, torch.from_numpy(ids),
                              torch.from_numpy(pos), cache,
                              logits_mode="all")
    with torch.no_grad():
        golden = model(torch.from_numpy(ids).long()).logits.numpy()
    # float32 both sides, sums in another order (the JAX package's own
    # HF test holds the same tolerance)
    np.testing.assert_allclose(logits.numpy(), golden, atol=2e-4, rtol=2e-3)
    # and the serving layout: quantized, fused, a forward that runs
    qp = llama.prepare_params(llama.quantize_params(
        params, QuantConfig(weights="int8")))
    cache = kvcache.init_cache(cfg.num_layers, 2, cfg.num_kv_heads, 64,
                               cfg.head_dim, torch.float32, device="cpu")
    q_logits, _ = llama.forward(cfg, qp, torch.from_numpy(ids),
                                torch.from_numpy(pos), cache)
    assert torch.isfinite(q_logits).all()


def test_safetensors_reader_matches_the_package(hf_dir):
    st = pytest.importorskip("safetensors.torch")
    _, path, bf16 = hf_dir
    for d in (path, bf16):
        want = st.load_file(f"{d}/model.safetensors")
        got = t_ckpt.read_safetensors(f"{d}/model.safetensors")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k


def test_model_config_from_hf_llama_only(hf_dir):
    model, _, _ = hf_dir
    cfg = t_ckpt.model_config_from_hf(model.config)
    jcfg = j_ckpt.model_config_from_hf(model.config)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert t_ckpt.model_config_from_hf(model.config.to_dict()) == cfg
    # mixtral and deepseek_v3 are served (test_torch_mixtral.py,
    # test_torch_deepseek.py); DeepSeek-V2's router is not
    with pytest.raises(NotImplementedError, match="not ported"):
        t_ckpt.model_config_from_hf(dict(model.config.to_dict(),
                                         model_type="deepseek_v2"))


def test_reference_bin_dir_round_trip(hf_dir, tmp_path):
    _, path, _ = hf_dir
    cfg, params = t_ckpt.load_hf_checkpoint(path, dtype="float32",
                                            device="cpu")
    jcfg, jparams = j_ckpt.load_hf_checkpoint(path, dtype="float32")
    t_ckpt.save_reference_bin_dir(cfg, params, str(tmp_path / "port"))
    back = t_ckpt.load_reference_bin_dir(cfg, str(tmp_path / "port"),
                                         dtype="float32", device="cpu")
    _assert_trees_equal(back, jparams)
    # a directory the JAX package wrote, in fp16, loads as its loader does
    j_ckpt.save_reference_bin_dir(jcfg, jparams, str(tmp_path / "jax"),
                                  file_dtype="fp16")
    got = t_ckpt.load_reference_bin_dir(cfg, str(tmp_path / "jax"),
                                        file_dtype="fp16", device="cpu")
    want = j_ckpt.load_reference_bin_dir(jcfg, str(tmp_path / "jax"),
                                         file_dtype="fp16")
    _assert_trees_equal(got, want)


# --------------------------------------------------------------- presets

def test_presets_match_jax():
    for name in ("llama2-7b", "llama2-13b", "llama2-70b", "tiny-llama"):
        cfg, jcfg = t_config.preset(name), j_config.PRESETS[name]()
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name,
                                                                    f.name)
    assert t_config.preset("tiny") == t_config.tiny_llama()
    # every preset of the JAX package is served (mixtral-8x7b, deepseek-v3
    # and tiny-deepseek since the mixture-of-experts slice); other names
    # are not
    assert set(t_config.PRESETS) - {"tiny"} == set(j_config.PRESETS)
    for name in ("mixtral-8x22b", "deepseek-v2-lite", "no-such-model"):
        with pytest.raises(NotImplementedError, match="not ported"):
            t_config.preset(name)


# ------------------------------------------------------------------- CLI

def _run_cli(monkeypatch, capsys, argv, lines):
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(
        line + "\n" for line in lines)))
    cli.main(argv)
    return capsys.readouterr().out


def test_cli_dummy_weights_echo_ids(monkeypatch, capsys):
    out = _run_cli(monkeypatch, capsys,
                   ["--device", "cpu", "--quant", "int8", "--greedy",
                    "--max-new-tokens", "5", "--max-seq-len", "128"],
                   ["hello", "", "reset", "again", "exit", "never read"])
    ids = [json.loads(line.split("ids> ", 1)[1])
           for line in out.splitlines() if "ids> " in line]
    assert len(ids) == 2 and ids[0] == ids[1] and len(ids[0]) == 5
    assert out.rstrip().endswith("bye.")


def test_cli_chats_with_a_tokenizer(monkeypatch, capsys, tmp_path):
    path = tmp_path / "tokenizer.bin"
    t_tok.BPETokenizer(_vocab(with_bytes=False),
                       kv={"bos_token_id": "1",
                           "eos_token_id": "2"}).save_binary(str(path))
    out = _run_cli(monkeypatch, capsys,
                   ["--device", "cpu", "--quant", "int4", "--group-size",
                    "32", "--kv-cache", "int8", "--greedy",
                    "--max-new-tokens", "4", "--max-seq-len", "256",
                    "--tokenizer", str(path), "--repetition-penalty", "1.2"],
                   ["hello world", "abc"])
    assert out.count("bot> ") == 2 and out.rstrip().endswith("bye.")


# --tp alone is served (tests/test_torch_tp.py); under --tp the ranks
# still refuse --dp, and the refusal reaches the caller. mixtral is served
# (tests/test_torch_mixtral.py), but not over --tp 2 (expert parallelism),
# which is refused before any rank starts. --lora, --asym and
# --no-int4-npair are served on one device (tests/test_torch_lora.py,
# test_cli_serves_weight_formats below), and refused with --tp 2 before
# any rank starts
@pytest.mark.parametrize("argv", [["--tp", "2", "--dp", "2"], ["--dp", "2"],
                                  ["--lora", "a=b", "--tp", "2"],
                                  ["--asym", "--tp", "2"],
                                  ["--no-int4-npair", "--tp", "2"],
                                  ["--model", "mixtral-8x7b", "--tp", "2"]])
def test_cli_refuses_what_is_not_ported(monkeypatch, capsys, argv):
    with pytest.raises(NotImplementedError, match="not ported"):
        _run_cli(monkeypatch, capsys, ["--device", "cpu"] + argv, ["exit"])


@pytest.mark.parametrize("argv", [["--quant", "int4", "--group-size", "32",
                                   "--asym"],
                                  ["--quant", "int4", "--group-size", "32",
                                   "--no-int4-npair"]])
def test_cli_serves_weight_formats(monkeypatch, capsys, argv):
    # asymmetric int4 and the split-half int4 route chat on one device
    out = _run_cli(monkeypatch, capsys,
                   ["--device", "cpu", "--greedy", "--max-new-tokens", "4",
                    "--max-seq-len", "128"] + argv, ["hello", "exit"])
    ids = [json.loads(line.split("ids> ", 1)[1])
           for line in out.splitlines() if "ids> " in line]
    assert len(ids) == 1 and len(ids[0]) == 4
    assert out.rstrip().endswith("bye.")
