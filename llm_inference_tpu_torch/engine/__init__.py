"""Serving engine of the port (counterpart of `llm_inference_tpu/engine/`)."""
