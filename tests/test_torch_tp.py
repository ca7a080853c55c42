"""The port's tensor-parallel forward and generate on the CPU, ranks in
processes of their own (parallel.run_ranks over gloo), against the JAX
package's sharded_forward on its CPU mesh: int8 weights at tp = 2 and 4,
int4 g = 32 at tp = 2 (K7's path: the JAX side runs ffn_fused in interpret
mode, the port its plain version), and int8 weights whose FFN and vocab
need pad_params_for_tp; then generate at tp = 2 against the port's tp = 1
stream, the CLI at --tp 2, the sharding rules and the weight bridge of
quantize_params(row_shards=). The ranks import only torch and the port:
weights reach them as an .npz (tools/tp_ranks.save_tree)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llm_inference_tpu.config import QuantConfig as JQuantConfig
from llm_inference_tpu.config import ShardingConfig
from llm_inference_tpu.config import tiny_llama as j_tiny_llama
from llm_inference_tpu.models import llama as j_llama
from llm_inference_tpu.ops import kvcache as j_kv
from llm_inference_tpu.parallel import (make_mesh, shard_cache, shard_params,
                                        sharded_forward)

from llm_inference_tpu_torch.config import (EngineConfig, GenerationConfig,
                                            QuantConfig, tiny_llama)
from llm_inference_tpu_torch.engine.engine import InferenceEngine
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache
from llm_inference_tpu_torch.ops.quantization import QTensor
from llm_inference_tpu_torch.parallel import run_ranks, sharding
from llm_inference_tpu_torch.tools import tp_ranks

from torch_bridge import to_numpy_tree

ROOT = Path(__file__).resolve().parents[1]
S = 64                     # cache slots
B, T, DECODE = 2, 8, 3     # a prefill of 2 x 8 rows, then 3 decode steps
# the tolerance of JAX's own sharded int4 parity (test_sharding.py:110-113):
# bf16 matmul outputs and psum order at these widths
TOL = 2e-2
JAX_CACHE = {"bf16": jnp.bfloat16, "int8": jnp.int8}

# (name, config overrides, weights, group size, tp values, cache, port-side
# preparation): "bridge" hands the JAX package's prepared weights over;
# "pad" hands its dense weights over and the port pads, quantizes and
# prepares them itself, as the JAX side does.
CASES = {
    "int8": (dict(num_kv_heads=4), "int8", 0, (2, 4), "bf16", "bridge"),
    "int4_g32": (dict(num_kv_heads=4, num_heads=8, head_dim=64,
                      hidden_size=512, intermediate_size=512,
                      vocab_size=512), "int4", 32, (2,), "int8", "bridge"),
    "int8_pad": (dict(num_kv_heads=4, intermediate_size=320,
                      vocab_size=272), "int8", 0, (2,), "bf16", "pad"),
}


def _jax_steps(jcfg, jparams, tp, cache):
    """The JAX sharded forward over a prefill and DECODE greedy steps:
    (the steps' port inputs, their logits)."""
    rng = np.random.default_rng(tp)
    ids = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    last = np.array([T - 1, T - 3], np.int32)
    mesh = make_mesh(ShardingConfig(data=1, tensor=tp))
    sp = shard_params(jparams, mesh)
    jc = shard_cache(j_kv.init_cache(jcfg.num_layers, B, jcfg.num_kv_heads,
                                     S, jcfg.head_dim, JAX_CACHE[cache]),
                     mesh)
    fwd = sharded_forward(jcfg, mesh, sp,
                          cache_bits=8 if cache == "int8" else 16)
    steps, logits = [], []
    for j in range(DECODE + 1):
        out, jc = fwd(sp, jnp.asarray(ids), jnp.asarray(pos), jc,
                      jnp.asarray(last))
        steps.append((ids, pos, last))
        logits.append(np.asarray(out, np.float32))
        ids = np.argmax(logits[-1], -1).astype(np.int32)[:, None]
        pos = np.array([[T + j], [T - 2 + j]], np.int32)
        last = np.zeros((B,), np.int32)
    return steps, logits


def _case(name, tp, tmp):
    """(a forwards job for the port's ranks, the JAX logits) of a case."""
    over, weights, gs, _, cache, prep = CASES[name]
    jcfg, cfg = j_tiny_llama(**over), tiny_llama(**over)
    dense = j_llama.init_params(jcfg, jax.random.PRNGKey(len(name)))
    jq = JQuantConfig(weights=weights, group_size=gs, quantize_embedding=True)
    jdense = j_llama.pad_params_for_tp(dense, jcfg, tp) if prep == "pad" \
        else dense
    jprep = j_llama.prepare_params(
        j_llama.quantize_params(jdense, jq, row_shards=tp), tp_size=tp,
        donate=False)
    steps, want = _jax_steps(jcfg, jprep, tp, cache)
    path = str(tmp / f"{name}_tp{tp}.npz")
    if prep == "pad":
        tp_ranks.save_tree(path, to_numpy_tree(dense))
        build = (tp_ranks.build_from_npz,
                 (path, cfg, QuantConfig(weights=weights, group_size=gs,
                                         quantize_embedding=True)))
    else:
        tp_ranks.save_tree(path, to_numpy_tree(jprep))
        build = (tp_ranks.build_from_npz, (path, cfg))
    job = (tp_ranks.forwards, dict(cfg=cfg, build=build,
                                   cache=(cache, B, S), steps=steps))
    return job, want


# generate at tp = 2 against tp = 1: int4 g = 32 weights (K7's path at
# decode) over an int8 cache
GEN_CFG = tiny_llama(num_kv_heads=4, hidden_size=256, intermediate_size=512,
                     vocab_size=512)
GEN_QCFG = QuantConfig(weights="int4", group_size=32, quantize_embedding=True)
GEN_PROMPTS = [[1, 17, 103, 42, 7, 9, 30, 2], [1, 3, 7, 11, 250]]
GEN_NEW = 10
GEN_ENGINE = EngineConfig(max_seq_len=128, decode_chunk=4,
                          prefill_buckets=(16, 32))
GEN = GenerationConfig(max_new_tokens=GEN_NEW, greedy=True,
                       eos_token_ids=())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's JAX logits and the port ranks' results: one group of
    2 ranks for the tp = 2 cases and generate, one of 4 for tp = 4."""
    tmp = tmp_path_factory.mktemp("tp")
    jobs, want = {2: [], 4: []}, {}
    for name, (*_, tps, _, _) in CASES.items():
        for tp in tps:
            job, want[(name, tp)] = _case(name, tp, tmp)
            jobs[tp].append(((name, tp), job))
    gen_job = ("generate", (tp_ranks.generate, dict(
        cfg=GEN_CFG, build=(tp_ranks.build_from_seed, (GEN_CFG, GEN_QCFG, 5)),
        requests=[GEN_PROMPTS], gen=GEN, engine_cfg=GEN_ENGINE,
        cache="int8")))
    jobs[2].append(gen_job)
    got = {}
    for tp, named in jobs.items():
        results = run_ranks(tp_ranks.run_jobs, tp, [j for _, j in named],
                            device="cpu")
        for i, (key, _) in enumerate(named):
            got[key] = [r[i] for r in results]          # one per rank
    return want, got


@pytest.mark.parametrize("name,tp", [(n, tp) for n, c in CASES.items()
                                     for tp in c[3]])
def test_tp_forward_matches_jax_sharded(ranks, name, tp):
    want, got = ranks
    per_rank = got[(name, tp)]
    logits0, launches = per_rank[0]
    assert len(per_rank) == tp
    for r in range(1, tp):                  # every rank: the same logits
        for a, b in zip(per_rank[r][0], logits0):
            np.testing.assert_array_equal(a, b)
    assert not any(launches.values())       # the CPU runs plain versions
    for step, (g, w) in enumerate(zip(logits0, want[(name, tp)])):
        assert g.shape == w.shape == (B, tiny_llama(**CASES[name][0])
                                      .vocab_size), step
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                   err_msg=f"step {step}")


def test_tp_generate_matches_tp1(ranks):
    """generate at tp = 2 emits the same tokens on both ranks, and the
    port's tp = 1 stream until the streams part at a near-tie
    (tp_ranks.compare_picks: logits within TOL while the tokens agree)."""
    _, got = ranks
    results = [r[0] for r in got["generate"]]          # the one request
    assert results[0]["tokens"] == results[1]["tokens"]   # every rank
    assert results[0]["backend"] == "gloo"
    params = tp_ranks.build_from_seed("cpu", 1, GEN_CFG, GEN_QCFG, 5)
    eng = InferenceEngine(GEN_CFG, params, engine_cfg=GEN_ENGINE,
                          cache_dtype="int8", device="cpu")
    picks = tp_ranks.record_picks(eng)
    want = [r.token_ids for r in eng.generate(GEN_PROMPTS, GEN)]
    assert len(picks) == len(results[0]["picks"]) == GEN_NEW
    compared, _ = tp_ranks.compare_picks(results[0]["picks"],
                                         results[0]["tokens"], picks, want,
                                         TOL)
    assert compared >= 1
    # the decode steps' collectives: 2 a layer + the embedding + logits
    per_step = 2 * GEN_CFG.num_layers + 2
    assert results[0]["colls"] == per_step * results[0]["steps"]


def test_cli_tp2_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "llm_inference_tpu_torch.cli", "--device",
         "cpu", "--tp", "2", "--quant", "int4", "--group-size", "32",
         "--kv-cache", "int8", "--greedy", "--max-new-tokens", "6",
         "--max-seq-len", "128"], input="hello\nexit\n", capture_output=True,
        text=True, timeout=300, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    ids = [ln for ln in out.stdout.splitlines() if "ids> " in ln]
    assert len(ids) == 1 and out.stdout.rstrip().endswith("bye."), out.stdout


def _int4_layers(I, gs):
    g = torch.Generator().manual_seed(0)
    H, L = 128, 1
    return {"w_down": QTensor(
        q=torch.randint(-128, 128, (L, H, I // 2), generator=g,
                        dtype=torch.int8),
        scale=torch.rand((L, H, I // gs), generator=g), bits=4)}


def test_shard_params_raises_on_a_non_dividing_group_count():
    """A row-sharded weight's group count must divide tp (as JAX's
    test_non_divisible_group_count_raises): 3 groups over 2 ranks raise,
    4 groups split into 2 each."""
    with pytest.raises(ValueError, match="quant groups"):
        sharding.shard_params({"layers": _int4_layers(96, 32)}, 0, 2)
    wd = sharding.shard_params({"layers": _int4_layers(128, 32)}, 1, 2)
    full = _int4_layers(128, 32)["w_down"]
    got = wd["layers"]["w_down"]
    assert got.groups == 2 and torch.equal(got.q, full.q[..., 32:])
    assert torch.equal(got.scale, full.scale[..., 2:])


@pytest.mark.parametrize("row_shards", [1, 2])
def test_bridge_reads_int4_pack_blocks(row_shards):
    """JAX quantize_params(row_shards=) packs wo and w_down in one block
    per shard; the bridge and params_from_numpy read them back to the
    same codes as the port's own quantization of the same weights."""
    jcfg, cfg = j_tiny_llama(), tiny_llama()
    dense = j_llama.init_params(jcfg, jax.random.PRNGKey(3))
    jq = j_llama.quantize_params(dense, JQuantConfig(weights="int4",
                                                     group_size=32),
                                 row_shards=row_shards)
    tree = to_numpy_tree(jq)
    assert tree["layers"]["w_down"]["block_rows"] == (
        cfg.intermediate_size // 2 // row_shards)
    got = llama.params_from_numpy(tree, cfg, "cpu")
    want = llama.quantize_params(
        llama.params_from_numpy(to_numpy_tree(dense), cfg, "cpu"),
        QuantConfig(weights="int4", group_size=32), row_shards=row_shards)
    for k in ("wq", "wo", "w_gate", "w_down"):
        assert torch.equal(got["layers"][k].q, want["layers"][k].q), k
        assert torch.equal(got["layers"][k].scale,
                           want["layers"][k].scale), k
