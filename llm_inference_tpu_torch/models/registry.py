"""Model registry (counterpart of `llm_inference_tpu/models/registry.py`):
a family name → the module that serves it (init_params,
init_params_quantized, rope_table, forward). The engine dispatches
through it, so every family a module registers runs through the same
engine, schedulers, speculative decoding and beam search.

Names resolve as in the JAX package: the name itself, then its part
before the first "-", then before the first "_" ("qwen2-7b" → "qwen2",
"gemma3_text" → "gemma3", "deepseek_v3" → "deepseek"). Every family of
the JAX package is served; a name listed in `_NOT_PORTED` (none today)
would raise NotImplementedError naming it.
"""

from __future__ import annotations

from typing import Dict

_REGISTRY: Dict[str, object] = {}
# registered names of the JAX package that the port does not serve
_NOT_PORTED: tuple = ()


def register_model(name: str, module) -> None:
    _REGISTRY[name] = module


def get_model(name: str):
    """The model module of a family or config name."""
    key = name.lower()
    candidates = (key, key.split("-")[0], key.split("_")[0])
    for c in candidates:
        if c in _REGISTRY:
            return _REGISTRY[c]
        if c in _NOT_PORTED:
            raise NotImplementedError(
                f"model family {c!r} ({name!r}) is not ported yet; the port "
                f"serves {sorted(_REGISTRY)}")
    raise KeyError(f"unknown model family {name!r}; known: "
                   f"{sorted(_REGISTRY)}")
