"""PyTorch/CUDA port of the inference engine, for NVIDIA Hopper (H100).

The JAX package `llm_inference_tpu` is the reference this package is held
to; nothing here imports it (or JAX). Module names mirror it: `config`,
`ops/*`, `models/llama`, `engine/engine`. The Pallas TPU kernels become
CUDA C++ kernels under `csrc/`, built at first use by `ops/kernels/_build`
and wrapped in `ops/kernels/*`, each beside a plain PyTorch version that
serves CPU tensors.

Importing the package builds and loads nothing.
"""

import torch

# float32 matmuls and convolutions on the card run in full float32: the
# plain versions are the kernels' references, and TF32 keeps only about
# three decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    card. There is no silent CPU fallback: without CUDA a caller must ask
    for the CPU by name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")
