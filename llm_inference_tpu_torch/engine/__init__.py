"""Serving engine of the port (counterpart of `llm_inference_tpu/engine/`)."""

from llm_inference_tpu_torch.engine.beam_search import (  # noqa: F401
    BeamSearchDecoder, beam_search)
from llm_inference_tpu_torch.engine.speculative import (  # noqa: F401
    DraftModelSpeculativeDecoder, SpeculativeDecoder)
