"""Configuration dataclasses of the PyTorch port.

The port's own copy of the parts of the JAX package's
`llm_inference_tpu/config.py` that the port reads (ModelConfig,
QuantConfig, EngineConfig, GenerationConfig, the presets of the dense
families and tiny_llama): the port imports nothing of the JAX package.
Field names and defaults match it, the mixture-of-experts fields
(mixtral) and DeepSeek's latent-attention fields among them. `PRESETS`
holds the models the port serves, every preset of the JAX package;
`preset` raises for other names.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of a decoder (the llama, gemma2,
    mixtral and DeepSeek families)."""

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
    # Which layers use the window: "all" (mistral) or "alternating"
    # (gemma2: even layers windowed, odd global).
    sliding_pattern: str = "all"
    # Bias terms on the qkv projection.
    qkv_bias: bool = False
    # Per-head RMSNorm on q and k before RoPE (qwen3: llama's norm; gemma3:
    # the (1 + w) norm), weight [head_dim] a layer.
    qk_norm: bool = False
    # gemma3's dual RoPE: sliding layers rotate with this local theta and
    # full-attention layers with rope_theta (0 = one RoPE).
    rope_local_theta: float = 0.0
    # Per-layer attention kinds ("sliding_attention" / "full_attention"),
    # gemma3's 5:1 pattern; None = sliding_pattern.
    layer_types: Optional[Tuple[str, ...]] = None
    # Gemma: the query scale is query_pre_attn_scalar^-0.5 (0 → head_dim),
    # and the embeddings are scaled by sqrt(hidden_size).
    query_pre_attn_scalar: float = 0.0
    scale_embeddings: bool = False
    # Mixture-of-experts (mixtral, DeepSeek): 0 = dense FFN.
    num_experts: int = 0
    experts_per_token: int = 2
    # DeepSeek V3 (multi-head latent attention and its MoE); kv_lora_rank
    # > 0 turns the family on. q low rank (0 = a full q projection), the
    # shared compressed-KV rank, the nope/rope split of a query head, the
    # value width, and interleaved RoPE pairs in the checkpoint.
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_interleave: bool = False
    # The MoE block: shared experts (an always-on MLP n_shared_experts x
    # moe_intermediate_size wide), the experts' width, group-limited
    # routing (n_group groups, topk_group kept), the routed weights'
    # normalisation and scale, and the first layers that stay dense.
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    first_k_dense: int = 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def qkv_out_dim(self) -> int:
        return (self.num_heads + 2 * self.num_kv_heads) * self.head_dim

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """A config from a dict; keys that are not fields are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


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


def llama3_8b(**kw) -> ModelConfig:
    return ModelConfig(name="llama3-8b", vocab_size=128256, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, head_dim=128, rms_norm_eps=1e-5,
                       rope_theta=500000.0, max_position_embeddings=8192, **kw)


_LLAMA31_SCALING = {"type": "llama3", "factor": 8.0,
                    "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                    "original_max_position_embeddings": 8192}


def llama3_1_8b(**kw) -> ModelConfig:
    """Llama-3.1-8B: llama3-8b + 128k context via piecewise RoPE scaling."""
    return ModelConfig(name="llama3.1-8b", vocab_size=128256,
                       hidden_size=4096, intermediate_size=14336,
                       num_layers=32, num_heads=32, num_kv_heads=8,
                       head_dim=128, rms_norm_eps=1e-5, rope_theta=500000.0,
                       max_position_embeddings=131072,
                       rope_scaling=dict(_LLAMA31_SCALING), **kw)


def llama3_1_70b(**kw) -> ModelConfig:
    return ModelConfig(name="llama3.1-70b", vocab_size=128256,
                       hidden_size=8192, intermediate_size=28672,
                       num_layers=80, num_heads=64, num_kv_heads=8,
                       head_dim=128, rms_norm_eps=1e-5, rope_theta=500000.0,
                       max_position_embeddings=131072,
                       rope_scaling=dict(_LLAMA31_SCALING), **kw)


def mistral_7b(**kw) -> ModelConfig:
    """Mistral-7B-v0.1: llama architecture + sliding-window attention."""
    return ModelConfig(name="mistral-7b", vocab_size=32000, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, head_dim=128, rms_norm_eps=1e-5,
                       max_position_embeddings=32768, sliding_window=4096,
                       **kw)


def qwen2_7b(**kw) -> ModelConfig:
    """Qwen2-7B: llama architecture + qkv biases + large vocab."""
    return ModelConfig(name="qwen2-7b", vocab_size=152064, hidden_size=3584,
                       intermediate_size=18944, num_layers=28, num_heads=28,
                       num_kv_heads=4, head_dim=128, rms_norm_eps=1e-6,
                       rope_theta=1000000.0, max_position_embeddings=32768,
                       qkv_bias=True, tie_word_embeddings=False, **kw)


def qwen3_8b(**kw) -> ModelConfig:
    """Qwen3-8B: llama architecture + per-head QK-norm (no qkv biases)."""
    return ModelConfig(name="qwen3-8b", vocab_size=151936, hidden_size=4096,
                       intermediate_size=12288, num_layers=36, num_heads=32,
                       num_kv_heads=8, head_dim=128, rms_norm_eps=1e-6,
                       rope_theta=1000000.0, max_position_embeddings=40960,
                       qk_norm=True, tie_word_embeddings=False, **kw)


def gemma3_4b(**kw) -> ModelConfig:
    """Gemma-3-4B (text): gemma2's sandwich norms + QK-norm, no softcaps,
    a 5:1 sliding:full layer pattern with dual RoPE (local theta 10k)."""
    L = 34
    lt = tuple("full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
               for i in range(L))
    return ModelConfig(name="gemma3-4b", vocab_size=262208,
                       hidden_size=2560, intermediate_size=10240,
                       num_layers=L, num_heads=8, num_kv_heads=4,
                       head_dim=256, rms_norm_eps=1e-6,
                       rope_theta=1000000.0, rope_local_theta=10000.0,
                       max_position_embeddings=131072,
                       # linear interpolation on the global RoPE only (the
                       # local tables take no scaling)
                       rope_scaling={"type": "linear", "factor": 8.0},
                       sliding_window=1024, layer_types=lt,
                       qk_norm=True, query_pre_attn_scalar=256.0,
                       scale_embeddings=True, tie_word_embeddings=True,
                       **kw)


def phi3_mini(**kw) -> ModelConfig:
    """Phi-3-mini-4k: llama architecture (MHA, fused checkpoint keys)."""
    return ModelConfig(name="phi3-mini", vocab_size=32064, hidden_size=3072,
                       intermediate_size=8192, num_layers=32, num_heads=32,
                       num_kv_heads=32, head_dim=96, rms_norm_eps=1e-5,
                       rope_theta=10000.0, max_position_embeddings=4096,
                       tie_word_embeddings=False, **kw)


def mixtral_8x7b(**kw) -> ModelConfig:
    """Mixtral-8x7B: llama attention and the top 2 of 8 experts a token."""
    return ModelConfig(name="mixtral-8x7b", vocab_size=32000,
                       hidden_size=4096, intermediate_size=14336,
                       num_layers=32, num_heads=32, num_kv_heads=8,
                       head_dim=128, rms_norm_eps=1e-5,
                       rope_theta=1000000.0, max_position_embeddings=32768,
                       num_experts=8, experts_per_token=2, **kw)


def gemma2_2b(**kw) -> ModelConfig:
    """Gemma-2-2B: sandwich norms, GeGLU, logit softcaps, alternating
    sliding-window attention, tied and scaled embeddings."""
    return ModelConfig(name="gemma2-2b", vocab_size=256000,
                       hidden_size=2304, intermediate_size=9216,
                       num_layers=26, num_heads=8, num_kv_heads=4,
                       head_dim=256, rms_norm_eps=1e-6,
                       rope_theta=10000.0, max_position_embeddings=8192,
                       tie_word_embeddings=True, attn_logit_softcap=50.0,
                       final_logit_softcap=30.0, sliding_window=4096,
                       sliding_pattern="alternating",
                       query_pre_attn_scalar=256.0, scale_embeddings=True,
                       **kw)


def gemma2_9b(**kw) -> ModelConfig:
    return ModelConfig(name="gemma2-9b", vocab_size=256000,
                       hidden_size=3584, intermediate_size=14336,
                       num_layers=42, num_heads=16, num_kv_heads=8,
                       head_dim=256, rms_norm_eps=1e-6,
                       rope_theta=10000.0, max_position_embeddings=8192,
                       tie_word_embeddings=True, attn_logit_softcap=50.0,
                       final_logit_softcap=30.0, sliding_window=4096,
                       sliding_pattern="alternating",
                       query_pre_attn_scalar=256.0, scale_embeddings=True,
                       **kw)


def deepseek_v3(**kw) -> ModelConfig:
    """DeepSeek-V3/R1: MLA (kv_lora 512, q_lora 1536, a 128 + 64 nope/rope
    split), 256 sigmoid-routed experts with one shared expert,
    group-limited routing, the first 3 layers dense, yarn RoPE to 128k."""
    defaults = dict(
        name="deepseek-v3", vocab_size=129280, hidden_size=7168,
        intermediate_size=18432, num_layers=61, num_heads=128,
        num_kv_heads=128, head_dim=192,           # qk_head_dim (nope+rope)
        rope_theta=10000.0, max_position_embeddings=163840,
        rms_norm_eps=1e-6,
        rope_scaling={"type": "yarn", "factor": 40.0,
                      "original_max_position_embeddings": 4096,
                      "beta_fast": 32.0, "beta_slow": 1.0,
                      "mscale": 1.0, "mscale_all_dim": 1.0},
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, rope_interleave=True,
        num_experts=256, experts_per_token=8, n_shared_experts=1,
        moe_intermediate_size=2048, n_group=8, topk_group=4,
        routed_scaling_factor=2.5, norm_topk_prob=True, first_k_dense=3)
    defaults.update(kw)
    return ModelConfig(**defaults)


def tiny_deepseek(**kw) -> ModelConfig:
    """A small MLA + MoE config for tests (V3 semantics, toy widths)."""
    defaults = dict(
        name="tiny-deepseek", vocab_size=256, hidden_size=64,
        intermediate_size=128, num_layers=3, num_heads=4, num_kv_heads=4,
        head_dim=48, rms_norm_eps=1e-6, max_position_embeddings=256,
        dtype="float32",
        q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=32,
        qk_rope_head_dim=16, v_head_dim=32,
        num_experts=8, experts_per_token=2, n_shared_experts=1,
        moe_intermediate_size=48, n_group=2, topk_group=1,
        routed_scaling_factor=2.5, norm_topk_prob=True, first_k_dense=1)
    defaults.update(kw)
    return ModelConfig(**defaults)


def tiny_llama(**kw) -> ModelConfig:
    """Small config for tests."""
    defaults = dict(name="tiny-llama", vocab_size=256, hidden_size=128,
                    intermediate_size=256, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=32, rms_norm_eps=1e-5,
                    max_position_embeddings=512, dtype="float32")
    defaults.update(kw)
    return ModelConfig(**defaults)


# the presets the port serves; "tiny" is the CLI's default name for
# tiny_llama (the JAX CLI falls back to it for names it does not know).
PRESETS = {
    "llama2-7b": llama2_7b,
    "llama2-13b": llama2_13b,
    "llama2-70b": llama2_70b,
    "llama3-8b": llama3_8b,
    "llama3.1-8b": llama3_1_8b,
    "llama3.1-70b": llama3_1_70b,
    "mistral-7b": mistral_7b,
    "qwen2-7b": qwen2_7b,
    "qwen3-8b": qwen3_8b,
    "phi3-mini": phi3_mini,
    "mixtral-8x7b": mixtral_8x7b,
    "gemma2-2b": gemma2_2b,
    "gemma2-9b": gemma2_9b,
    "gemma3-4b": gemma3_4b,
    "deepseek-v3": deepseek_v3,
    "tiny-llama": tiny_llama,
    "tiny-deepseek": tiny_deepseek,
    "tiny": tiny_llama,
}


def preset(name: str) -> ModelConfig:
    """The config of a preset the port serves; other names raise
    NotImplementedError."""
    if name not in PRESETS:
        raise NotImplementedError(
            f"preset {name!r} is not ported; the port serves "
            f"{sorted(PRESETS)}")
    return PRESETS[name]()


@dataclass(frozen=True)
class QuantConfig:
    """Weight quantization: int8 or int4, per-channel or grouped, symmetric
    or asymmetric (zero points); the asymmetric and grouped int8 formats
    on one device (tensor parallelism refuses them)."""

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
