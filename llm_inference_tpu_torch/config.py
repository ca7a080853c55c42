"""Configuration dataclasses of the PyTorch port.

The port's own copy of the parts of the JAX package's
`llm_inference_tpu/config.py` that the port reads (ModelConfig,
QuantConfig, EngineConfig, GenerationConfig, the LLaMA-2 presets and
tiny_llama): the port imports nothing of the JAX package. Field names and
defaults match it; fields of families and features not ported yet are
added with them. `PRESETS` holds only the models the port serves;
`preset` raises for the JAX package's other names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of a LLaMA-family decoder."""

    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    # Activation dtype policy ("bfloat16" or "float32").
    dtype: str = "bfloat16"
    # Attention / final logit soft-capping; 0 disables.
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # None, or {"type": "linear"|"ntk"|"llama3"|"yarn"|"longrope", ...}
    rope_scaling: Optional[dict] = None
    # Sliding-window attention size; 0 = full attention.
    sliding_window: int = 0
    # Bias terms on the qkv projection.
    qkv_bias: bool = False
    # Per-head RMSNorm on q and k before RoPE.
    qk_norm: bool = False

    @property
    def qkv_out_dim(self) -> int:
        return (self.num_heads + 2 * self.num_kv_heads) * self.head_dim


def llama2_7b(**kw) -> ModelConfig:
    return ModelConfig(name="llama2-7b", vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_layers=32, num_heads=32,
                       num_kv_heads=32, head_dim=128, rms_norm_eps=1e-5,
                       max_position_embeddings=4096, **kw)


def llama2_13b(**kw) -> ModelConfig:
    return ModelConfig(name="llama2-13b", vocab_size=32000, hidden_size=5120,
                       intermediate_size=13824, num_layers=40, num_heads=40,
                       num_kv_heads=40, head_dim=128, rms_norm_eps=1e-5,
                       max_position_embeddings=4096, **kw)


def llama2_70b(**kw) -> ModelConfig:
    return ModelConfig(name="llama2-70b", vocab_size=32000, hidden_size=8192,
                       intermediate_size=28672, num_layers=80, num_heads=64,
                       num_kv_heads=8, head_dim=128, rms_norm_eps=1e-5,
                       max_position_embeddings=4096, **kw)


def tiny_llama(**kw) -> ModelConfig:
    """Small config for tests."""
    defaults = dict(name="tiny-llama", vocab_size=256, hidden_size=128,
                    intermediate_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=32, rms_norm_eps=1e-5,
                    max_position_embeddings=512, dtype="float32")
    defaults.update(kw)
    return ModelConfig(**defaults)


# the presets the port serves; "tiny" is the CLI's default name for
# tiny_llama (the JAX CLI falls back to it for names it does not know)
PRESETS = {
    "llama2-7b": llama2_7b,
    "llama2-13b": llama2_13b,
    "llama2-70b": llama2_70b,
    "tiny-llama": tiny_llama,
    "tiny": tiny_llama,
}


def preset(name: str) -> ModelConfig:
    """The config of a preset the port serves; other names (the JAX
    package's other families) raise NotImplementedError."""
    if name not in PRESETS:
        raise NotImplementedError(
            f"preset {name!r} is not ported; the port serves "
            f"{sorted(PRESETS)}")
    return PRESETS[name]()


@dataclass(frozen=True)
class QuantConfig:
    """Weight quantization. The port serves int8 symmetric per-channel and
    int4 symmetric (per-channel or grouped) weights; int8 grouped and
    asymmetric weights raise NotImplementedError where they would be
    used."""

    # "none" | "int8" | "int4"  (weight-only)
    weights: str = "none"
    # Sub-channel group size along the contraction dim; 0 = per-channel.
    group_size: int = 0
    asymmetric: bool = False
    # Quantize lm_head too.
    quantize_embedding: bool = False

    @property
    def enabled(self) -> bool:
        return self.weights != "none"


@dataclass(frozen=True)
class EngineConfig:
    """Serving-engine knobs."""

    max_seq_len: int = 2048
    # Decode slots of the continuous-batching schedulers.
    max_batch_size: int = 8
    # Prefill length buckets (token counts).
    prefill_buckets: Sequence[int] = (128, 256, 512, 1024, 2048)
    # Decode steps run on the device between two host syncs.
    decode_chunk: int = 8
    # Paged KV cache page size in tokens; 0 = the scheduler's default, 128.
    page_size: int = 0
    # Requests the schedulers queue before submit refuses more.
    max_queued_requests: int = 256
    # Largest per-request top-k of the batched decode (its sort width).
    max_top_k: int = 64
    # Dispatch decode chunk k + 1 before fetching chunk k's tokens.
    pipeline_harvest: bool = True


@dataclass(frozen=True)
class GenerationConfig:
    """Per-request sampling parameters."""

    max_new_tokens: int = 256
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    min_p: float = 0.0      # 0.0 = disabled
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    greedy: bool = False
    eos_token_ids: Sequence[int] = (2,)
    seed: int = 0
    logit_bias: Optional[dict] = None
