"""Test helper (not collected): hands the JAX package's parameters and
arrays to the PyTorch port through numpy.

JAX QTensors become {"q": row-major int8 codes [..., K, N], "scale":
float32 [..., 1, N]} (un-blocked with quantization.from_blocked), the
form `llm_inference_tpu_torch.models.llama.params_from_numpy` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from llm_inference_tpu.ops.quantization import QTensor, from_blocked


def to_numpy_tree(params):
    """JAX params pytree → nested dicts of numpy arrays."""
    if isinstance(params, QTensor):
        qt = from_blocked(params)
        if qt.bits != 8 or qt.zbias is not None or qt.scale.shape[-2] != 1:
            raise NotImplementedError("the port takes int8 per-channel "
                                      "symmetric weights")
        return {"q": np.asarray(qt.q), "scale": np.asarray(qt.scale)}
    if isinstance(params, dict):
        return {k: to_numpy_tree(v) for k, v in params.items()}
    return np.asarray(params)


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array → CPU torch tensor (bf16 by bit view)."""
    a = np.array(a)                      # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor → float32 numpy (bf16 widened exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
