"""The PyTorch port stands alone: it imports no JAX, flax, ml_dtypes or
anything of the JAX package; importing it builds no kernel; and its entry
points refuse to fall back to the CPU when no device was asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "llm_inference_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "llm_inference_tpu")


def _port_sources():
    files = sorted(PKG.rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif (isinstance(node, ast.ImportFrom) and node.module
              and not node.level):
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_port_runs_with_jax_blocked():
    """A fresh interpreter in which jax, flax, ml_dtypes and the JAX
    package cannot be imported runs a CPU forward of the port."""
    code = """
import sys
for name in ("jax", "jaxlib", "flax", "ml_dtypes", "llm_inference_tpu"):
    sys.modules[name] = None
import llm_inference_tpu_torch
assert "llm_inference_tpu_torch.ops.kernels._build" not in sys.modules
assert "triton" not in sys.modules
import torch
from llm_inference_tpu_torch.config import QuantConfig, tiny_llama
from llm_inference_tpu_torch.models import llama
from llm_inference_tpu_torch.ops import kvcache
cfg = tiny_llama(head_dim=64)
p = llama.prepare_params(llama.init_params_quantized(
    cfg, QuantConfig(weights="int8", quantize_embedding=True), device="cpu"))
cache = kvcache.init_cache(cfg.num_layers, 1, cfg.num_kv_heads, 128,
                           cfg.head_dim, torch.bfloat16, device="cpu")
ids = torch.arange(4, dtype=torch.int32)[None]
logits, cache = llama.forward(cfg, p, ids, ids, cache)
logits, cache = llama.forward(cfg, p, ids[:, :1], torch.tensor([[4]]), cache)
assert torch.isfinite(logits).all() and logits.shape == (1, cfg.vocab_size)
assert "llm_inference_tpu_torch.ops.kernels._build" not in sys.modules
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_device_means_cuda(monkeypatch):
    from llm_inference_tpu_torch import resolve_device
    from llm_inference_tpu_torch.config import (EngineConfig, QuantConfig,
                                                tiny_llama)
    from llm_inference_tpu_torch.engine.engine import InferenceEngine
    from llm_inference_tpu_torch.models import llama
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_llama(head_dim=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params_quantized(cfg, QuantConfig(weights="int8"))
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, {}, engine_cfg=EngineConfig(max_seq_len=128))
    assert resolve_device("cpu") == torch.device("cpu")
